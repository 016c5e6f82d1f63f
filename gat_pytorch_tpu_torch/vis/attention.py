"""Attention-coefficient extraction and statistics (compute layer).

Counterpart of gat_pytorch_tpu/vis/attention.py: the numeric core behind
the three reference visualisation tools (reference:
visualisation/entropy_histograms.py, neighbourhood_attention_weights.py,
weight_histograms.py), apart from the plotting.

`extract_attention` runs the eval forward on the graph's device and
returns numpy copies. The statistics take that (E, NH) alpha of a layer
and the padded Graph, and run in numpy on the host: each takes the
graph's tensors to the CPU once (a Graph on the card holds CUDA tensors,
which np.asarray refuses).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from scipy.stats import entropy as _scipy_entropy

from ..graph.graph import Graph
from ..models import gat


def extract_attention(params, cfg: gat.GATConfig, graph: Graph
                      ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Eval-mode forward returning (logits, [alpha_l (E, NH_l)]) as numpy
    (reference: GATModel.forward_and_return_attention, :153-187), on the
    kernel path of the graph's device."""
    with torch.no_grad():
        out, att = gat.gat_model_apply(params, cfg, graph,
                                       device=graph.device, training=False,
                                       return_attention=True)
    return out.cpu().numpy(), [a.cpu().numpy() for a in att]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def neighbourhood_slices(graph: Graph) -> Dict[int, np.ndarray]:
    """node -> indices of its real in-edges (positions into the edge axis).
    Receivers are dst-sorted, so each value is a contiguous range."""
    recv = _host(graph.receivers)
    idx = np.nonzero(_host(graph.edge_mask))[0]
    out: Dict[int, np.ndarray] = {}
    if idx.size == 0:
        return out
    r = recv[idx]
    nodes = np.arange(int(graph.node_mask.sum()))
    starts = np.searchsorted(r, nodes, side="left")
    ends = np.searchsorted(r, nodes, side="right")
    for n, (s, e) in enumerate(zip(starts, ends)):
        if e > s:
            out[n] = idx[s:e]
    return out


def attention_entropies(alpha: np.ndarray,
                        graph: Graph,
                        head: Optional[int] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Per (node, head) [or one head]: entropy of the attention
    distribution over the in-neighbourhood, and the uniform-baseline
    entropy log(deg) for the same node (reference:
    entropy_histograms.py:13-76).

    Returns (entropies, uniform_entropies), flattened over nodes x heads,
    nodes with degree 0 excluded.
    """
    nbrs = neighbourhood_slices(graph)
    heads = range(alpha.shape[1]) if head is None else [head]
    ents, unis = [], []
    for n, idx in nbrs.items():
        deg = idx.size
        uni = _scipy_entropy(np.full(deg, 1.0 / deg))
        for h in heads:
            p = alpha[idx, h]
            s = p.sum()
            if s <= 0:
                continue
            ents.append(_scipy_entropy(p / s))
            unis.append(uni)
    return np.asarray(ents), np.asarray(unis)


def degree_scaled_weights(alpha: np.ndarray,
                          graph: Graph,
                          head: int = 0,
                          clip_above: float = 5.0
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """alpha * in-degree per real edge for one head (expect 1.0 under
    uniform attention), plus the all-ones uniform baseline (reference:
    weight_histograms.py:51-97 -- head 0 only, weights >= `clip_above`
    dropped)."""
    recv = _host(graph.receivers)
    emask = _host(graph.edge_mask)
    deg = np.zeros(graph.num_nodes)
    np.add.at(deg, recv[emask], 1.0)
    w = alpha[emask, head] * deg[recv[emask]]
    w = w[w < clip_above]
    return w, np.ones_like(w)


def node_neighbourhood(alpha: np.ndarray,
                       graph: Graph,
                       node: int,
                       head: int = 0) -> Dict[str, np.ndarray]:
    """One node's in-neighbourhood for the star plot: neighbour ids,
    attention weights (head `head`), labels if present (reference:
    neighbourhood_attention_weights.py:17-110)."""
    nbrs = neighbourhood_slices(graph)
    if node not in nbrs:
        raise ValueError(f"node {node} has no in-edges")
    idx = nbrs[node]
    send = _host(graph.senders)[idx]
    w = alpha[idx, head]
    labels = None
    if graph.y is not None:
        y = _host(graph.y)
        labels = y[send] if y.ndim == 1 else y[send].argmax(-1)
    return {"neighbours": send, "weights": w, "labels": labels,
            "edge_indices": idx}


def nodes_of_degree(graph: Graph, degree: int, limit: int = 10
                    ) -> np.ndarray:
    """Node ids with the given in-degree (self-loop included) -- replaces
    the reference's hard-coded per-dataset degree-10 node lists
    (reference: neighbourhood_attention_weights.py:27-33)."""
    recv = _host(graph.receivers)
    emask = _host(graph.edge_mask)
    deg = np.zeros(graph.num_nodes, dtype=np.int64)
    np.add.at(deg, recv[emask], 1)
    ids = np.nonzero((deg == degree) & _host(graph.node_mask))[0]
    return ids[:limit]
