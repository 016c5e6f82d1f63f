"""Deterministic synthetic stand-ins for the five datasets.

Counterpart of gat_pytorch_tpu/data/synthetic.py:21-175: the same numpy
generator calls in the same order, so a seed gives bit-identical arrays
in both packages. Used when the real raw files are absent.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import List, Optional, Tuple

import numpy as np

SPECS = {
    #            nodes  avg_deg feats classes  train  val  test
    "Cora":     (2708,  3.9,    1433, 7,       140,   500, 1000),
    "Citeseer": (3327,  2.8,    3703, 6,       120,   500, 1000),
    "Pubmed":   (19717, 4.5,    500,  3,       60,    500, 1000),
}


@dataclasses.dataclass
class RawGraph:
    """Host-side unpadded graph (pre-canonicalisation)."""
    x: np.ndarray
    senders: np.ndarray
    receivers: np.ndarray
    y: np.ndarray
    train_mask: Optional[np.ndarray] = None
    val_mask: Optional[np.ndarray] = None
    test_mask: Optional[np.ndarray] = None

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.senders.shape[0])


def _sbm_edges(rng: np.random.Generator, labels: np.ndarray,
               avg_degree: float, homophily: float = 0.88
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Undirected homophilous edges, returned in both directions."""
    n = labels.shape[0]
    m = int(n * avg_degree / 2)
    src = rng.integers(0, n, size=3 * m)
    # partner: same class with prob `homophily`, else uniform
    same = rng.random(3 * m) < homophily
    by_class = [np.where(labels == c)[0] for c in range(labels.max() + 1)]
    partner = rng.integers(0, n, size=3 * m)
    for c, members in enumerate(by_class):
        pick = same & (labels[src] == c)
        partner[pick] = members[rng.integers(0, len(members), size=pick.sum())]
    keep = src != partner
    src, partner = src[keep][:m], partner[keep][:m]
    pairs = np.unique(np.stack([np.minimum(src, partner),
                                np.maximum(src, partner)], 1), axis=0)
    s = np.concatenate([pairs[:, 0], pairs[:, 1]])
    r = np.concatenate([pairs[:, 1], pairs[:, 0]])
    return s.astype(np.int64), r.astype(np.int64)


def _class_features(rng: np.random.Generator, labels: np.ndarray,
                    num_features: int, active: int = 20,
                    signal: float = 0.7) -> np.ndarray:
    """Sparse binary bag-of-words with a per-class signature block."""
    n = labels.shape[0]
    c = int(labels.max()) + 1
    x = (rng.random((n, num_features)) < active / num_features).astype(
        np.float32)
    block = max(4, num_features // (2 * c))
    for cls in range(c):
        rows = labels == cls
        mask = rng.random((rows.sum(), block)) < signal * active / block
        x[np.where(rows)[0][:, None],
          np.arange(cls * block, (cls + 1) * block)[None, :]] += mask
    return np.minimum(x, 1.0)


def make_planetoid_like(name: str, seed: int = 0) -> RawGraph:
    """Transductive citation-style graph with the named dataset's shape."""
    n, deg, f, c, n_train, n_val, n_test = SPECS[name]
    # zlib.crc32 is process-stable (python's hash() is salted per process)
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 2**16)
    labels = rng.integers(0, c, size=n).astype(np.int64)
    s, r = _sbm_edges(rng, labels, deg)
    x = _class_features(rng, labels, f)
    perm = rng.permutation(n)
    train_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask = np.zeros(n, bool)
    train_mask[perm[:n_train]] = True
    val_mask[perm[n_train:n_train + n_val]] = True
    test_mask[perm[n_train + n_val:n_train + n_val + n_test]] = True
    return RawGraph(x=x, senders=s, receivers=r, y=labels,
                    train_mask=train_mask, val_mask=val_mask,
                    test_mask=test_mask)


def make_ppi_like(split: str, seed: int = 0,
                  num_graphs: Optional[int] = None) -> List[RawGraph]:
    """Inductive multi-label graphs: 20 train / 2 val / 2 test graphs,
    about 1000 nodes each, 50 features, 121 labels (real PPI averages
    about 2372 nodes a graph)."""
    counts = {"train": 20, "val": 2, "test": 2}
    offs = {"train": 0, "val": 20, "test": 22}
    k = num_graphs if num_graphs is not None else counts[split]
    # the latent->label and latent->feature maps are shared across graphs
    # (label semantics are global in real PPI); only node latents and
    # edges vary per graph
    shared = np.random.default_rng(seed + 555)
    proto = shared.standard_normal((8, 121)).astype(np.float32)
    w = shared.standard_normal((8, 50)).astype(np.float32)
    graphs = []
    for gi in range(k):
        rng = np.random.default_rng(seed + 1000 + offs[split] + gi)
        n = int(rng.integers(900, 1200))
        z = rng.standard_normal((n, 8)).astype(np.float32)
        logits = z @ proto
        y = (logits > np.quantile(logits, 0.78, axis=0)).astype(np.float32)
        # edges between latent-similar nodes
        comm = np.argmax(z[:, :6], axis=1)
        s, r = _sbm_edges(rng, comm.astype(np.int64), avg_degree=28.0,
                          homophily=0.8)
        x = (z @ w + 0.3 * rng.standard_normal((n, 50))).astype(np.float32)
        graphs.append(RawGraph(x=x, senders=s, receivers=r, y=y))
    return graphs


def make_pattern_like(split: str, seed: int = 0,
                      num_graphs: Optional[int] = None) -> List[RawGraph]:
    """PATTERN-style binary node classification: detect the nodes of a
    planted pattern; about 118 nodes, 3 features, positive fraction about
    0.1765. The real dataset has 10000/2000/2000 train/val/test graphs;
    the stand-in's default is 256/64/64."""
    counts = {"train": 256, "val": 64, "test": 64}
    offs = {"train": 0, "val": 10000, "test": 12000}
    k = num_graphs if num_graphs is not None else counts[split]
    graphs = []
    for gi in range(k):
        rng = np.random.default_rng(seed + 7000 + offs[split] + gi)
        n = int(rng.integers(90, 140))
        n_pos = max(2, int(round(0.1765 * n)))
        y = np.zeros(n, np.int64)
        pos = rng.choice(n, size=n_pos, replace=False)
        y[pos] = 1
        # pattern nodes form a denser clique-ish subgraph
        s, r = _sbm_edges(rng, np.zeros(n, np.int64), avg_degree=10.0,
                          homophily=0.0)
        extra = []
        for i in pos:
            for j in pos:
                if i < j and rng.random() < 0.45:
                    extra.append((i, j))
        if extra:
            ex = np.array(extra, np.int64)
            s = np.concatenate([s, ex[:, 0], ex[:, 1]])
            r = np.concatenate([r, ex[:, 1], ex[:, 0]])
        x = rng.integers(0, 3, size=(n, 1)).astype(np.float32)
        x = np.concatenate([x == 0, x == 1, x == 2], axis=1).astype(np.float32)
        # leak a noisy hint of membership so the task is learnable
        x[:, 0] += 0.55 * y + 0.1 * rng.standard_normal(n)
        graphs.append(RawGraph(x=x, senders=s, receivers=r, y=y))
    return graphs
