"""Destination-owned edge partitioning: the boundary-free edge layout.

Counterpart of gat_pytorch_tpu/parallel/partition.py. The edges are
re-bucketed so that shard j's contiguous slice [j*eps, (j+1)*eps) holds
exactly the in-edges of its node rows [j*N/K, (j+1)*N/K). The segment
softmax and the aggregation are then local to a shard, and a layer's only
collective over the edge axis is one tiled all_gather of the (N/K, nh*f)
output slices (models/gat.py, dst_owned), where the cut-neighbourhood
layout sums (N, nh*f) partials over the shards.

Shards hold unequal edge counts, so every slice is padded to the largest
(one bucket, `eps`). A padding edge has edge_mask False, sender N-1 and
receiver the last row of its shard, so that each slice stays dst-sorted
and each shard's sender order keeps its padding last. Receivers stay
global ids; `src_order` holds each shard's local permutation (the real
edges by sender, then the padding edges).

With src_windows=True a per-shard block layout of the windowed op is
built (shard-local receivers, global senders) and the K layouts are
stacked along axis 0 with common statics: shard j's part of every layout
array is its j-th equal slice. hybrid=True builds per-shard
split-locality layouts, whose remainders stack padded to one bucket with
the real counts in `rem_count`. The stacked layout also carries the
Hopper index arrays of each shard (graph/transforms.layout_index_arrays
over the shard's rows and the N senders), stacked the same way;
parallel/sharding.dst_shard cuts a rank's layout out of it.

The arrays equal the JAX package's for the same graph, with one
exception: repad_block_layout pads a remainder with sink edges (sender
N-1, receiver the shard's last row) and re-derives `rem_order` by a
stable argsort, where the JAX package pads with the last dst-sorted edge
and appends an identity order, which leaves the padded remainder
unsorted by sender when a remainder filled its bucket.

Host work in numpy; the results are the port's CPU Graph and BlockLayout
(`Graph.to` moves them). The block sizes follow the JAX package's
environment knobs, read when a layout is built: GAT_TPU_V7_NB (else the
cost model's choice of 256 or 512 on shard 0; 512 for a hybrid layout),
GAT_TPU_V7_EB (1024), GAT_TPU_V7_HYBRID_EB (256) and GAT_TPU_V7_COST_K
(2560).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graph import graphcore_binding as _core
from ..graph.graph import BlockLayout, Graph, from_numpy
from ..graph.transforms import (compute_block_layout, compute_hybrid_layout,
                                layout_index_arrays, round_up)


def _np(t) -> Optional[np.ndarray]:
    """A tensor's values on the host (the graph may lie on the card)."""
    return None if t is None else t.detach().cpu().numpy()


def _t32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def partition_edges_by_dst(graph: Graph, k: int, pad_multiple: int = 256,
                           eps: Optional[int] = None,
                           src_windows: bool = False,
                           nb: Optional[int] = None,
                           eb: Optional[int] = None,
                           hybrid: bool = False) -> Tuple[Graph, int]:
    """(graph2, eps): a canonicalised graph's edges re-bucketed for k
    dst-owner shards, graph2.num_edges == k * eps; slice [j*eps,
    (j+1)*eps) is shard j's (dst-sorted, receivers in [j*N/k,
    (j+1)*N/k), padding masked). eps defaults to the largest shard's edge
    count rounded up to pad_multiple; a given eps below it raises.
    graph.num_nodes must divide by k. src_windows: attach the stacked
    per-shard block layouts (hybrid: split-locality ones); nb, eb:
    explicit block sizes (module doc for the defaults)."""
    n = graph.num_nodes
    if n % k != 0:
        raise ValueError(f"num_nodes {n} not divisible by k={k} (pick a "
                         f"node bucket divisible by the edge-axis size)")
    rows = n // k
    emask = _np(graph.edge_mask)
    send = _np(graph.senders).astype(np.int64)[emask]
    recv = _np(graph.receivers).astype(np.int64)[emask]
    owner = recv // rows
    counts = np.bincount(owner, minlength=k)
    if eps is None:
        eps = round_up(max(int(counts.max()), 1), pad_multiple)
    elif int(counts.max()) > eps:
        raise ValueError(f"per-shard bucket {eps} < max shard edge count "
                         f"{int(counts.max())}")
    out_s = np.full(k * eps, n - 1, dtype=np.int64)
    out_r = np.empty(k * eps, dtype=np.int64)
    out_m = np.zeros(k * eps, dtype=bool)
    out_order = np.zeros(k * eps, dtype=np.int64)
    for j in range(k):
        sel = np.nonzero(owner == j)[0]          # already dst-sorted
        c, base = sel.size, j * eps
        out_s[base:base + c] = send[sel]
        out_r[base:base + c] = recv[sel]
        out_m[base:base + c] = True
        out_r[base + c:base + eps] = (j + 1) * rows - 1
        out_order[base:base + eps] = np.concatenate(
            [np.argsort(out_s[base:base + c], kind="stable"),
             np.arange(c, eps)])
    g2 = from_numpy(
        _np(graph.x), out_s, out_r, y=_np(graph.y),
        train_mask=_np(graph.train_mask), val_mask=_np(graph.val_mask),
        test_mask=_np(graph.test_mask), edge_mask=out_m,
        node_mask=_np(graph.node_mask),
        graph_ids=_np(graph.graph_ids), src_order=out_order)
    if src_windows:
        g2 = g2.replace(block_layout=_shard_block_layouts(
            out_s, out_r, out_m, k, eps, rows, n, nb=nb, eb=eb,
            hybrid=hybrid))
    return g2, eps


def _sizes(nb: Optional[int], eb: Optional[int], hybrid: bool):
    """(nb, eb, nb given) as the JAX package reads its knobs."""
    explicit_nb = nb is not None or "GAT_TPU_V7_NB" in os.environ
    nb = nb or int(os.environ.get("GAT_TPU_V7_NB", "512"))
    eb = eb or int(os.environ.get(
        "GAT_TPU_V7_HYBRID_EB" if hybrid else "GAT_TPU_V7_EB",
        "256" if hybrid else "1024"))
    return nb, eb, explicit_nb


def _shard_block_layouts(out_s, out_r, out_m, k: int, eps: int, rows: int,
                         n: int, nb: Optional[int] = None,
                         eb: Optional[int] = None,
                         hybrid: bool = False) -> BlockLayout:
    """The per-shard layouts (local receivers, global senders), stacked
    with common statics (module doc). Without a given nb (and not
    hybrid), one nb for every shard by the cost model slots * (nb + wb +
    K) on shard 0: shards must share statics, so the choice is global."""
    nb, eb, explicit_nb = _sizes(nb, eb, hybrid)
    if not explicit_nb and not hybrid:
        cost_k = float(os.environ.get("GAT_TPU_V7_COST_K", "2560"))
        c0 = int(out_m[:eps].sum())
        best = None
        for nbx in (256, 512):
            bl0 = compute_block_layout(out_s[:c0], out_r[:c0], c0, rows,
                                       nb=nbx, eb=eb, n_src=n)
            cost = bl0.num_slots * (nbx + bl0.wb + cost_k)
            if best is None or cost < best[0]:
                best = (cost, nbx)
        nb = best[1]
    build = compute_hybrid_layout if hybrid else compute_block_layout
    layouts = []
    for j in range(k):
        sl = slice(j * eps, (j + 1) * eps)
        c = int(out_m[sl].sum())
        layouts.append(build(out_s[sl][:c], out_r[sl][:c] - j * rows, c,
                             rows, nb=nb, eb=eb, n_src=n))
    t = layouts[0].tile_base.shape[0]
    assert all(lay.tile_base.shape[0] == t for lay in layouts)
    slots = max(max(lay.num_slots for lay in layouts), eb)
    gmax = slots // eb
    dmax = (-1 if any(lay.dmax < 0 for lay in layouts)
            else max(lay.dmax for lay in layouts))

    def pad_to(a, size, fill):
        a = np.asarray(a)
        return np.concatenate([a, np.full(size - a.shape[0], fill, a.dtype)])

    rem = None
    ers = [0 if lay.rem_send is None else lay.rem_send.shape[0]
           for lay in layouts]
    if hybrid and max(ers) > 0:
        # one common bucket; a shard whose layout degenerated to plain
        # (too little locality) gets an empty remainder (count 0). Pad
        # edges are sinks: the global last sender, the shard's last row.
        er_pad = max(128, round_up(max(ers), 128))
        rs = np.full((k, er_pad), n - 1, np.int64)
        rr = np.full((k, er_pad), rows - 1, np.int64)
        for j, lay in enumerate(layouts):
            if lay.rem_send is not None:
                rs[j, :ers[j]] = np.asarray(lay.rem_send)
                rr[j, :ers[j]] = np.asarray(lay.rem_recv)
        counts = [0 if lay.rem_send is None else lay.rem_e
                  for lay in layouts]
        rem = (rs, rr, np.asarray(counts, np.int64))
    return _stacked(
        k, rows, n,
        send=np.stack([pad_to(lay.send, slots, 0) for lay in layouts]),
        recv=np.stack([pad_to(lay.recv, slots, -1) for lay in layouts]),
        base=np.stack([pad_to(lay.base, gmax, 0) for lay in layouts]),
        tile_ptr=np.stack([np.asarray(lay.tile_ptr) for lay in layouts]),
        tile_base=np.stack([np.asarray(lay.tile_base) for lay in layouts]),
        wb=max(lay.wb for lay in layouts),
        window=max(lay.window for lay in layouts), nb=nb, eb=eb, dmax=dmax,
        rem=rem)


def _stacked(k: int, rows: int, n: int, *, send, recv, base, tile_ptr,
             tile_base, wb: int, window: int, nb: int, eb: int, dmax: int,
             rem=None) -> BlockLayout:
    """A stacked layout from (k, ...) per-shard arrays: each shard's
    Hopper index arrays (layout_index_arrays over its rows and the n
    senders; src_perm padded to the slots with the pad slots in order),
    and where `rem` = (rem_send, rem_recv, rem_count) the remainder with
    its stable sender order (the sinks sort last) and CSR offsets."""
    idx = [layout_index_arrays(send[j], recv[j], rows, n_src=n)
           for j in range(k)]
    slots = send.shape[1]
    src_perm = [np.concatenate([p[2], np.setdiff1d(
        np.arange(slots), p[2], assume_unique=True)]) for p in idx]
    kw = {}
    if rem is not None:
        rs, rr, counts = rem
        order = np.stack([np.argsort(r, kind="stable") for r in rs])
        kw = dict(
            rem_send=_t32(rs.reshape(-1)), rem_recv=_t32(rr.reshape(-1)),
            rem_order=_t32(order.reshape(-1)),
            rem_dst_ptr=_t32(np.concatenate(
                [_core.csr_offsets(r, rows) for r in rr])),
            rem_src_ptr=_t32(np.concatenate(
                [_core.csr_offsets(s[o][:c], n)
                 for s, o, c in zip(rs, order, counts)])),
            rem_count=_t32(counts), rem_e=int(counts.max()))
    return BlockLayout(
        send=_t32(send.reshape(-1)), recv=_t32(recv.reshape(-1)),
        base=_t32(base.reshape(-1)), tile_ptr=_t32(tile_ptr.reshape(-1)),
        tile_base=_t32(tile_base.reshape(-1)),
        dst_perm=_t32(np.concatenate([p[0] for p in idx])),
        dst_ptr=_t32(np.concatenate([p[1] for p in idx])),
        src_perm=_t32(np.concatenate(src_perm)),
        src_ptr=_t32(np.concatenate([p[3] for p in idx])),
        wb=int(wb), window=int(window), nb=int(nb), eb=int(eb),
        dmax=int(dmax), num_real=sum(p[4] for p in idx), **kw)


def stacked_dims(bl: BlockLayout, k: int) -> Tuple[int, int]:
    """(rows, n): the destination rows of each shard and the senders of a
    stacked layout over k shards (from its stacked CSR offsets)."""
    return bl.dst_ptr.shape[0] // k - 1, bl.src_ptr.shape[0] // k - 1


def repad_block_layout(bl: BlockLayout, k: int, slots: Optional[int] = None,
                       wb: Optional[int] = None,
                       window: Optional[int] = None,
                       dmax: Optional[int] = None,
                       rem_slots: Optional[int] = None,
                       rem_e: Optional[int] = None) -> BlockLayout:
    """A stacked layout over k shards re-padded to larger common sizes,
    so that a batch of partitioned graphs shares one shape: pad slots
    carry recv -1; wb, window and dmax only grow. A remainder is padded
    with sink edges and its sender order re-derived (module doc)."""
    rows, n = stacked_dims(bl, k)
    cur = bl.num_slots // k
    slots = max(slots or cur, cur)
    gmax = slots // bl.eb

    def pad2(a, width, fill):
        a = np.asarray(a).reshape(k, -1)
        return np.pad(a, ((0, 0), (0, width - a.shape[1])),
                      constant_values=fill)

    new_dmax = bl.dmax
    if dmax is not None:
        new_dmax = -1 if (dmax < 0 or bl.dmax < 0) else max(dmax, bl.dmax)
    rem = None
    if bl.rem_send is not None:
        rcur = bl.rem_send.shape[0] // k
        rsl = max(rem_slots or rcur, rcur)
        rem = (pad2(bl.rem_send, rsl, n - 1), pad2(bl.rem_recv, rsl, rows - 1),
               np.asarray(bl.rem_count).astype(np.int64))
    out = _stacked(
        k, rows, n, send=pad2(bl.send, slots, 0),
        recv=pad2(bl.recv, slots, -1), base=pad2(bl.base, gmax, 0),
        tile_ptr=np.asarray(bl.tile_ptr).reshape(k, -1),
        tile_base=np.asarray(bl.tile_base).reshape(k, -1),
        wb=max(wb or 0, bl.wb), window=max(window or 0, bl.window),
        nb=bl.nb, eb=bl.eb, dmax=new_dmax, rem=rem)
    if rem is not None:
        out = dataclasses.replace(out, rem_e=max(rem_e or 0, bl.rem_e))
    return out


def _without_remainder(bl: BlockLayout) -> BlockLayout:
    return dataclasses.replace(
        bl, rem_send=None, rem_recv=None, rem_order=None, rem_dst_ptr=None,
        rem_src_ptr=None, rem_count=None, rem_e=0)


def _unify_batch_layouts(graphs: Sequence[Graph], k: int) -> List[Graph]:
    """The batch's stacked layouts re-padded to common (slots, wb,
    window, dmax) and remainder sizes; a batch that mixes hybrid and
    plain layouts drops the remainders (as the JAX package does)."""
    bls = [g.block_layout for g in graphs]
    slots = max(b.num_slots // k for b in bls)
    wb = max(b.wb for b in bls)
    window = max(b.window for b in bls)
    dmax = (-1 if any(b.dmax < 0 for b in bls)
            else max(b.dmax for b in bls))
    kw = {}
    if all(b.rem_send is not None for b in bls):
        kw = dict(rem_slots=max(b.rem_send.shape[0] // k for b in bls),
                  rem_e=max(b.rem_e for b in bls))
    elif any(b.rem_send is not None for b in bls):
        bls = [_without_remainder(b) for b in bls]
    return [g.replace(block_layout=repad_block_layout(
                b, k, slots=slots, wb=wb, window=window, dmax=dmax, **kw))
            for g, b in zip(graphs, bls)]


def partition_batches(graphs: Sequence[Graph], k: int,
                      pad_multiple: int = 256, eps: Optional[int] = None,
                      src_windows: bool = False,
                      hybrid: bool = False) -> Tuple[List[Graph], int]:
    """(partitioned graphs, eps): same-bucket graphs partitioned with one
    shared per-shard edge bucket, so that they batch together; pass eps
    back on later epochs to keep one shape. src_windows: with the stacked
    layouts, unified across the batch."""
    if eps is not None:
        out = [partition_edges_by_dst(g, k, pad_multiple, eps=eps,
                                      src_windows=src_windows,
                                      hybrid=hybrid)[0] for g in graphs]
    else:
        parts = [partition_edges_by_dst(g, k, pad_multiple,
                                        src_windows=src_windows,
                                        hybrid=hybrid) for g in graphs]
        eps = max(e for _, e in parts)
        out = [g if e == eps
               else partition_edges_by_dst(g0, k, pad_multiple, eps=eps,
                                           src_windows=src_windows,
                                           hybrid=hybrid)[0]
               for (g, e), g0 in zip(parts, graphs)]
    return (_unify_batch_layouts(out, k) if src_windows else out), eps
