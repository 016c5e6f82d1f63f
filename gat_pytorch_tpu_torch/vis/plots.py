"""The three attention plots (matplotlib; no igraph dependency).

Counterpart of gat_pytorch_tpu/vis/plots.py, the same figures from the
same statistics (vis/attention.py), re-expressing the reference plotters:
  * entropy dual histogram (reference:
    visualisation/entropy_histograms.py:13-120)
  * neighbourhood star plot (reference:
    visualisation/neighbourhood_attention_weights.py:17-110; igraph star
    layout redone in matplotlib)
  * degree-scaled weight histogram (reference:
    visualisation/weight_histograms.py:14-97)

Each returns the matplotlib Figure (caller saves/shows); `out` saves a PNG.
matplotlib is imported inside `_fig()` only, when a figure is drawn:
importing this module (or the vis CLI) does not need it.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..graph.graph import Graph
from . import attention as A

_BLUE, _ORANGE = "#1f77b4", "#ff7f0e"


def _fig(*args, **kw):
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def draw_entropy_histogram(attention: Sequence[np.ndarray],
                           graph: Graph,
                           dataset: str = "",
                           out: Optional[str] = None,
                           skip_last_layer: bool = True):
    """Per-layer, per-head dual histogram: attention entropy vs uniform.

    `skip_last_layer=True` reproduces the reference's off-by-one
    (entropy_histograms.py:90 iterates range(len(attention)-1), silently
    dropping the last layer); set False for all layers.
    """
    plt = _fig()
    n_layers = len(attention) - 1 if skip_last_layer and len(attention) > 1 \
        else len(attention)
    n_heads = max(a.shape[1] for a in attention[:n_layers])
    fig, axes = plt.subplots(n_layers, n_heads, squeeze=False,
                             figsize=(3 * n_heads, 2.5 * n_layers))
    for li in range(n_layers):
        alpha = attention[li]
        for h in range(alpha.shape[1]):
            ents, unis = A.attention_entropies(alpha, graph, head=h)
            ax = axes[li][h]
            bins = np.linspace(0, max(float(unis.max(initial=1.0)), 1.0), 30)
            ax.hist(unis, bins=bins, color=_ORANGE, alpha=0.5,
                    label="uniform")
            ax.hist(ents, bins=bins, color=_BLUE, alpha=0.5,
                    label="attention")
            ax.set_title(f"L{li} H{h}", fontsize=8)
            if li == 0 and h == 0:
                ax.legend(fontsize=6)
        for h in range(alpha.shape[1], n_heads):
            axes[li][h].axis("off")
    fig.suptitle(f"{dataset} attention entropy vs uniform")
    fig.tight_layout()
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        fig.savefig(out, dpi=120)
    return fig


def draw_neighbour_attention_distribution(attention: Sequence[np.ndarray],
                                          graph: Graph,
                                          node: int,
                                          layer: int = 0,
                                          head: int = 0,
                                          dataset: str = "",
                                          out: Optional[str] = None):
    """Star plot: `node` at the centre, in-neighbours on a circle, edge
    width proportional to attention weight (normalised by the max weight,
    scaled 60/deg — reference neighbourhood_attention_weights.py:58-60),
    vertex colour = class label."""
    plt = _fig()
    info = A.node_neighbourhood(attention[layer], graph, node, head)
    nbrs, w, labels = info["neighbours"], info["weights"], info["labels"]
    deg = len(nbrs)
    widths = (w / max(float(w.max()), 1e-12)) * (60.0 / max(deg, 1)) / 4.0

    fig, ax = plt.subplots(figsize=(5, 5))
    angles = np.linspace(0, 2 * np.pi, deg, endpoint=False)
    xs, ys = np.cos(angles), np.sin(angles)
    cmap = plt.get_cmap("tab10")
    for k in range(deg):
        if nbrs[k] == node:           # self-loop: short arc marker
            ax.plot([0.0], [0.12], marker="o", ms=2, color="grey")
            continue
        ax.plot([0, xs[k]], [0, ys[k]], lw=max(widths[k], 0.2),
                color="grey", zorder=1)
    colors = [cmap(int(labels[k]) % 10) if labels is not None else _BLUE
              for k in range(deg)]
    ax.scatter(xs, ys, s=300, c=colors, zorder=2, edgecolors="k")
    centre_color = colors[int(np.nonzero(nbrs == node)[0][0])] \
        if (nbrs == node).any() else _BLUE
    ax.scatter([0], [0], s=500, c=[centre_color], zorder=3, edgecolors="k")
    for k in range(deg):
        ax.annotate(str(int(nbrs[k])), (xs[k], ys[k]),
                    ha="center", va="center", fontsize=6, zorder=4)
    ax.annotate(str(node), (0, 0), ha="center", va="center", fontsize=7,
                zorder=4)
    ax.set_title(f"{dataset} node {node} in-neighbourhood "
                 f"(L{layer} H{head}, deg {deg})")
    ax.set_aspect("equal")
    ax.axis("off")
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        fig.savefig(out, dpi=120)
    return fig


def draw_weights_histogram(attention: Sequence[np.ndarray],
                           graph: Graph,
                           dataset: str = "",
                           out: Optional[str] = None,
                           log_y: Optional[bool] = None,
                           epoch_label: str = ""):
    """Histogram of degree-scaled attention weights (alpha * deg; 1.0
    under uniform) vs the uniform baseline — head 0 only, weights >= 5
    dropped (reference weight_histograms.py:67,86); log-y for PPI/PATTERN
    (:27-29)."""
    plt = _fig()
    if log_y is None:
        log_y = dataset in ("PPI", "PATTERN")
    n_layers = len(attention)
    fig, axes = plt.subplots(1, n_layers, squeeze=False,
                             figsize=(3.2 * n_layers, 2.8))
    for li in range(n_layers):
        w, uni = A.degree_scaled_weights(attention[li], graph, head=0)
        ax = axes[0][li]
        bins = np.linspace(0, 5, 40)
        ax.hist(uni, bins=bins, color=_ORANGE, alpha=0.5, label="uniform")
        ax.hist(w, bins=bins, color=_BLUE, alpha=0.5, label="attention")
        if log_y:
            ax.set_yscale("log")
        ax.set_title(f"layer {li}", fontsize=8)
        if li == 0:
            ax.legend(fontsize=6)
    title = f"{dataset} degree-scaled attention weights"
    if epoch_label:
        title += f" ({epoch_label})"
    fig.suptitle(title)
    fig.tight_layout()
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        fig.savefig(out, dpi=120)
    return fig
