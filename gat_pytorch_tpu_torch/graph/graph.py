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

`BlockLayout` is the counterpart of gat_pytorch_tpu/graph/graph.py:
BlockLayout, the hybrid split-locality layout's remainder (`rem_send`,
`rem_recv`, `rem_order`, `rem_e`) included, plus the index arrays the
Hopper kernels walk. `rem_count`, the per-shard remainder counts of the
sharded layouts, waits for ROADMAP queue A item 13.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def _to_device(obj, device):
    """A copy of the dataclass `obj` with every tensor field on `device`
    (nested dataclasses with a `to` method included)."""
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    for k, v in kw.items():
        if isinstance(v, (torch.Tensor, BlockLayout)):
            kw[k] = v.to(device)
    return type(obj)(**kw)


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """Block-local window layout of the windowed attention op
    (ops/cuda/window_attention.py), built by
    graph/transforms.compute_block_layout.

    The real edges are regrouped per `nb`-row destination tile, sorted by
    sender within each tile, and every tile is padded to a multiple of
    `eb` slots. A pad slot has recv == -1 and a harmless in-window sender.
    `send`..`tile_base` and the ints equal the JAX package's arrays for
    the same graph; `wb`, `window` and `dmax` size the TPU kernel's
    streamed windows and are carried as part of the layout.

    The last four arrays serve the CUDA kernels, which walk one
    destination row per warp and reduce d(h) by sender:
      dst_perm  the slots ordered by destination (stable, so still
                sender-sorted within a row), pad slots last;
      dst_ptr   row r's slots are dst_perm[dst_ptr[r]:dst_ptr[r+1]];
      src_perm  the real slots ordered by sender (stable);
      src_ptr   sender s's slots are src_perm[src_ptr[s]:src_ptr[s+1]].

    A hybrid split-locality layout (graph/transforms.
    compute_hybrid_layout) holds only the in-window edges in its slots
    and carries the out-of-window remainder as a second, dst-sorted edge
    list for the v5 parts op (models/gat.py sums the two ops' parts):
    `rem_send`, `rem_recv`, `rem_order` and `rem_e` equal the JAX
    package's; `rem_dst_ptr` and `rem_src_ptr` are its CSR offsets for
    the CUDA kernels, built once here instead of per call. All are None
    (rem_e 0) on a plain layout.
    """
    send: torch.Tensor       # (E7,) int32 senders, tile-grouped, src-sorted
    recv: torch.Tensor       # (E7,) int32 receivers, -1 on pad slots
    base: torch.Tensor       # (G,) int32 128-aligned per-block window base
    tile_ptr: torch.Tensor   # (T+1,) int32 eb-aligned per-tile slot offsets
    tile_base: torch.Tensor  # (T,) int32 128-aligned per-tile window base
    dst_perm: torch.Tensor   # (E7,) int32
    dst_ptr: torch.Tensor    # (N_pad+1,) int32
    src_perm: torch.Tensor   # (num_real,) int32
    src_ptr: torch.Tensor    # (N_pad+1,) int32
    wb: int                  # block window rows (multiple of 128)
    window: int              # tile window rows (multiple of 128)
    nb: int                  # destination rows per tile
    eb: int                  # slots per block
    dmax: int                # 8-aligned bound on consecutive tile-base
    #                          deltas when monotone, else -1
    num_real: int            # real (non-pad) slots
    rem_send: Optional[torch.Tensor] = None   # (Er,) int32, dst-sorted,
    #                          padded to a multiple of 128 with sink edges
    rem_recv: Optional[torch.Tensor] = None   # (Er,) int32, ascending
    rem_order: Optional[torch.Tensor] = None  # (Er,) int32: stable sender
    #                          sort of the padded remainder
    rem_dst_ptr: Optional[torch.Tensor] = None  # (N_pad+1,) int32 offsets
    #                          of rem_recv (all Er edges)
    rem_src_ptr: Optional[torch.Tensor] = None  # (N_src+1,) int32: sender
    #                          s's real remainder edges are
    #                          rem_order[rem_src_ptr[s]:rem_src_ptr[s+1]]
    rem_e: int = 0           # real (unpadded) remainder edges

    @property
    def num_slots(self) -> int:
        return int(self.send.shape[0])

    def to(self, device) -> "BlockLayout":
        return _to_device(self, device)


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
    # -- locality metadata (canonicalize(..., src_windows=True)) ----------
    # tile_lo: (ceil(N_pad/128),) int32, the min sender id over the real
    #   edges of each 128-row destination tile (INT32_MAX if empty).
    # node_order: (N_pad,) int32, the old node id at each new position
    #   when canonicalize reordered the nodes; maps outputs back.
    # src_band: max over 512-row destination tiles of
    #   max_src - align8(min_src) + 1 on real edges; 0 = not computed.
    # block_layout: see BlockLayout; a graph that carries one takes the
    #   windowed op on the kernel path.
    tile_lo: Optional[torch.Tensor] = None
    node_order: Optional[torch.Tensor] = None
    src_band: int = 0
    block_layout: Optional[BlockLayout] = None

    @property
    def device(self) -> torch.device:
        return self.x.device

    def to(self, device) -> "Graph":
        """Copy every tensor field (the block layout's too) to `device`."""
        return _to_device(self, device)

    def replace(self, **kw) -> "Graph":
        return dataclasses.replace(self, **kw)

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
               src_order: Optional[np.ndarray] = None,
               tile_lo: Optional[np.ndarray] = None,
               node_order: Optional[np.ndarray] = None,
               src_band: int = 0) -> Graph:
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
        num_real_edges=int(np.asarray(edge_mask).sum()),
        tile_lo=t(tile_lo, np.int32), node_order=t(node_order, np.int32),
        src_band=int(src_band))
