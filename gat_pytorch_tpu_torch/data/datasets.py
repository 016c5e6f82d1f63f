"""Planetoid datasets: the real raw files when present, else the stand-in.

Counterpart of gat_pytorch_tpu/data/datasets.py for the Planetoid family
(Cora, Citeseer, Pubmed). If `GAT_TPU_DATA` points at a directory with
the Kipf/GCN pickles (`<root>/<Name>/raw/ind.<name>.{x,y,tx,ty,allx,ally,
graph,test.index}`), they are parsed; otherwise the shape-faithful
synthetic stand-in (data/synthetic.py) is generated. PPI and PATTERN wait
for ROADMAP queue A item 9.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np

from . import synthetic
from .synthetic import RawGraph

PLANETOID = ("Cora", "Citeseer", "Pubmed")


def data_root() -> Optional[str]:
    return os.environ.get("GAT_TPU_DATA")


def _planetoid_available(name: str) -> bool:
    root = data_root()
    if not root:
        return False
    return os.path.exists(os.path.join(root, name, "raw",
                                       f"ind.{name.lower()}.x"))


def _load_planetoid(name: str) -> RawGraph:
    """Parse the Kipf/GCN pickle format (what PyG's Planetoid reads)."""
    import scipy.sparse as sp
    d = os.path.join(data_root(), name, "raw")
    low = name.lower()

    def load(part):
        with open(os.path.join(d, f"ind.{low}.{part}"), "rb") as f:
            return pickle.load(f, encoding="latin1")

    x, y, tx, ty, allx, ally, graph = (load(p) for p in
                                       ("x", "y", "tx", "ty", "allx",
                                        "ally", "graph"))
    with open(os.path.join(d, f"ind.{low}.test.index")) as f:
        test_idx = np.array([int(line.strip()) for line in f], np.int64)
    test_sorted = np.sort(test_idx)

    # Citeseer has isolated test nodes missing from tx/ty: re-index tx/ty
    # over range(min, max+1) with zero-fill (the Kipf/GCN fix PyG applies)
    t_min, t_max = int(test_sorted[0]), int(test_sorted[-1])
    full = t_max - t_min + 1
    if full != len(test_sorted):
        tx_ext = sp.lil_matrix((full, allx.shape[1]), dtype=np.float32)
        tx_ext[test_sorted - t_min, :] = tx
        tx = tx_ext
        ty_ext = np.zeros((full, ally.shape[1]), dtype=ally.dtype)
        ty_ext[test_sorted - t_min, :] = ty
        ty = ty_ext

    features = sp.vstack((allx, tx)).tolil()
    features[test_idx, :] = features[test_sorted, :]
    labels = np.vstack((ally, ty))
    labels[test_idx, :] = labels[test_sorted, :]
    n = features.shape[0]
    senders, receivers = [], []
    for v, nbrs in graph.items():
        for u in nbrs:
            if v < n and u < n:
                senders += [u, v]
                receivers += [v, u]
    edges = np.unique(np.stack([np.array(senders), np.array(receivers)], 1),
                      axis=0)
    n_train = {"Cora": 140, "Citeseer": 120, "Pubmed": 60}[name]
    train_mask = np.zeros(n, bool)
    train_mask[:n_train] = True
    val_mask = np.zeros(n, bool)
    val_mask[n_train:n_train + 500] = True
    test_mask = np.zeros(n, bool)
    test_mask[test_sorted] = True
    return RawGraph(x=np.asarray(features.todense(), np.float32),
                    senders=edges[:, 0], receivers=edges[:, 1],
                    y=labels.argmax(1).astype(np.int64),
                    train_mask=train_mask, val_mask=val_mask,
                    test_mask=test_mask)


def load_planetoid(name: str, synthetic_override: Optional[bool] = None,
                   seed: int = 0) -> RawGraph:
    use_real = _planetoid_available(name) if synthetic_override is None \
        else not synthetic_override
    if use_real:
        return _load_planetoid(name)
    return synthetic.make_planetoid_like(name, seed=seed)


def is_synthetic(dataset: str) -> bool:
    """True when the named Planetoid dataset would be served synthetically."""
    if dataset not in PLANETOID:
        raise ValueError(dataset)
    return not _planetoid_available(dataset)
