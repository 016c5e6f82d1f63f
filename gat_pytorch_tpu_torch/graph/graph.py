"""Statically-shaped padded graph container, as torch tensors.

Counterpart of gat_pytorch_tpu/graph/graph.py:Graph. The invariants are
the same (established by graph/transforms.canonicalize):
  * edges are COO (src, dst) sorted by dst ascending (stable);
  * arrays are padded: `node_mask` / `edge_mask` mark real entries, and
    padding edges are (sink, sink) with sink = num_nodes - 1 and
    edge_mask False, appended after the real edges;
  * `src_order` is the stable permutation sorting edges by sender.

Index arrays are int32, as in the JAX Graph; the CUDA kernels take them
as they are, and the plain torch paths widen them to int64.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Graph:
    x: torch.Tensor                  # (N_pad, F) float32
    senders: torch.Tensor            # (E_pad,) int32
    receivers: torch.Tensor          # (E_pad,) int32, sorted ascending
    edge_mask: torch.Tensor          # (E_pad,) bool
    node_mask: torch.Tensor          # (N_pad,) bool
    y: Optional[torch.Tensor]        # (N_pad,) int64 labels
    train_mask: Optional[torch.Tensor]
    val_mask: Optional[torch.Tensor]
    test_mask: Optional[torch.Tensor]
    graph_ids: Optional[torch.Tensor]
    src_order: Optional[torch.Tensor]  # (E_pad,) int32 sender-sort perm
    num_nodes: int                   # padded node count N_pad
    num_edges: int                   # padded edge count E_pad
    num_real_edges: int              # real edges: the prefix [0, E_real)

    @property
    def device(self) -> torch.device:
        return self.x.device

    def to(self, device) -> "Graph":
        """Copy every tensor field to `device`."""
        kw = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        for k, v in kw.items():
            if isinstance(v, torch.Tensor):
                kw[k] = v.to(device)
        return Graph(**kw)

    def validate(self) -> None:
        """Host-side invariant check; raises ValueError on a violation."""
        recv = self.receivers.cpu().numpy()
        send = self.senders.cpu().numpy()
        emask = self.edge_mask.cpu().numpy()
        if self.x.shape[0] != self.num_nodes:
            raise ValueError("x/node padding mismatch")
        if recv.shape != (self.num_edges,):
            raise ValueError("receivers length != num_edges")
        if not (np.diff(recv) >= 0).all():
            raise ValueError("receivers must be dst-sorted")
        if not ((send < self.num_nodes).all() and (send >= 0).all()):
            raise ValueError("sender out of range")
        if not (emask[:self.num_real_edges].all()
                and not emask[self.num_real_edges:].any()):
            raise ValueError("real edges must be the prefix [0, E_real)")
        if (~emask).any() and not (recv[~emask] == self.num_nodes - 1).all():
            raise ValueError("padding edges must target the sink node")


def from_numpy(x: np.ndarray,
               senders: np.ndarray,
               receivers: np.ndarray,
               *,
               y: Optional[np.ndarray] = None,
               train_mask: Optional[np.ndarray] = None,
               val_mask: Optional[np.ndarray] = None,
               test_mask: Optional[np.ndarray] = None,
               edge_mask: Optional[np.ndarray] = None,
               node_mask: Optional[np.ndarray] = None,
               graph_ids: Optional[np.ndarray] = None,
               src_order: Optional[np.ndarray] = None) -> Graph:
    """Wrap host arrays (already canonicalised/padded) into a CPU Graph;
    `Graph.to(device)` moves it."""
    n, e = int(x.shape[0]), int(senders.shape[0])
    if edge_mask is None:
        edge_mask = np.ones(e, dtype=bool)
    if node_mask is None:
        node_mask = np.ones(n, dtype=bool)
    if graph_ids is None:
        graph_ids = np.zeros(n, dtype=np.int32)

    def t(a, dtype=None):
        if a is None:
            return None
        a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
        return torch.from_numpy(a)

    return Graph(
        x=t(x, np.float32), senders=t(senders, np.int32),
        receivers=t(receivers, np.int32),
        edge_mask=t(edge_mask, bool), node_mask=t(node_mask, bool),
        y=None if y is None else t(y, np.int64 if np.asarray(y).ndim == 1
                                     else np.float32),
        train_mask=t(train_mask, bool), val_mask=t(val_mask, bool),
        test_mask=t(test_mask, bool), graph_ids=t(graph_ids, np.int32),
        src_order=t(src_order, np.int32),
        num_nodes=n, num_edges=e,
        num_real_edges=int(np.asarray(edge_mask).sum()))
