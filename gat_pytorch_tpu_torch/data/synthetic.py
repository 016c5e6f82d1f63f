"""Deterministic synthetic Planetoid stand-ins.

Counterpart of gat_pytorch_tpu/data/synthetic.py:21-108: the same numpy
generator calls in the same order, so a seed gives bit-identical arrays
in both packages. Used when the real raw files are absent.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Tuple

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
