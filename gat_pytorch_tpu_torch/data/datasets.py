"""The five datasets: the real raw files when present, else the stand-in.

Counterpart of gat_pytorch_tpu/data/datasets.py. If `GAT_TPU_DATA` points
at a directory with the raw files, they are parsed; otherwise the
shape-faithful synthetic stand-in (data/synthetic.py) is generated.
  Planetoid (Cora, Citeseer, Pubmed): the Kipf/GCN pickles
    `<root>/<Name>/raw/ind.<name>.{x,y,tx,ty,allx,ally,graph,test.index}`;
  PPI: the GraphSAGE files `<root>/PPI/raw/{train,valid,test}_{graph.json,
    feats.npy,labels.npy,graph_id.npy}`;
  PATTERN: `<root>/PATTERN/{train,val,test}.pt`, lists of dicts or objects
    with x, edge_index, y (written by torch.save).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List, Optional

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


def _ppi_available() -> bool:
    root = data_root()
    return bool(root) and os.path.exists(
        os.path.join(root, "PPI", "raw", "train_graph.json"))


def _load_ppi(split: str) -> List[RawGraph]:
    d = os.path.join(data_root(), "PPI", "raw")
    tag = {"train": "train", "val": "valid", "test": "test"}[split]
    with open(os.path.join(d, f"{tag}_graph.json")) as f:
        g = json.load(f)
    feats = np.load(os.path.join(d, f"{tag}_feats.npy")).astype(np.float32)
    labels = np.load(os.path.join(d, f"{tag}_labels.npy")).astype(np.float32)
    gids = np.load(os.path.join(d, f"{tag}_graph_id.npy")).astype(np.int64)
    links = np.array([[ln["source"], ln["target"]] for ln in g["links"]],
                     np.int64)
    graphs = []
    for gid in np.unique(gids):
        nodes = np.where(gids == gid)[0]
        lo, hi = nodes.min(), nodes.max()
        sel = (links[:, 0] >= lo) & (links[:, 0] <= hi)
        e = links[sel] - lo
        s = np.concatenate([e[:, 0], e[:, 1]])
        r = np.concatenate([e[:, 1], e[:, 0]])
        graphs.append(RawGraph(x=feats[nodes], senders=s, receivers=r,
                               y=labels[nodes]))
    return graphs


def _pattern_available() -> bool:
    root = data_root()
    return bool(root) and os.path.exists(
        os.path.join(root, "PATTERN", "train.pt"))


def _load_pattern(split: str) -> List[RawGraph]:
    import torch
    path = os.path.join(data_root(), "PATTERN", f"{split}.pt")
    # the files hold pickled graph objects, not only tensors
    blob = torch.load(path, map_location="cpu", weights_only=False)
    graphs = []
    for item in blob:
        def field(name):
            return item[name] if isinstance(item, dict) else getattr(item,
                                                                     name)
        ei = np.asarray(field("edge_index"), np.int64)
        graphs.append(RawGraph(x=np.asarray(field("x"), np.float32),
                               senders=ei[0], receivers=ei[1],
                               y=np.asarray(field("y"), np.int64)))
    return graphs


# -- public API -------------------------------------------------------------

def _use_real(available: bool, synthetic_override: Optional[bool]) -> bool:
    return available if synthetic_override is None else not synthetic_override


def load_planetoid(name: str, synthetic_override: Optional[bool] = None,
                   seed: int = 0) -> RawGraph:
    if _use_real(_planetoid_available(name), synthetic_override):
        return _load_planetoid(name)
    return synthetic.make_planetoid_like(name, seed=seed)


def load_ppi(split: str, synthetic_override: Optional[bool] = None,
             seed: int = 0, num_graphs: Optional[int] = None
             ) -> List[RawGraph]:
    if _use_real(_ppi_available(), synthetic_override):
        return _load_ppi(split)
    return synthetic.make_ppi_like(split, seed=seed, num_graphs=num_graphs)


def load_pattern(split: str, synthetic_override: Optional[bool] = None,
                 seed: int = 0, num_graphs: Optional[int] = None
                 ) -> List[RawGraph]:
    if _use_real(_pattern_available(), synthetic_override):
        return _load_pattern(split)
    return synthetic.make_pattern_like(split, seed=seed,
                                       num_graphs=num_graphs)


def is_synthetic(dataset: str) -> bool:
    """True when the named dataset would be served synthetically."""
    if dataset in PLANETOID:
        return not _planetoid_available(dataset)
    if dataset == "PPI":
        return not _ppi_available()
    if dataset == "PATTERN":
        return not _pattern_available()
    raise ValueError(dataset)
