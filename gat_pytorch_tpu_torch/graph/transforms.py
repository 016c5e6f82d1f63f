"""Host-side graph canonicalisation: self-loops, dst-sort, static padding,
and the locality layout of the windowed attention op.

Counterpart of gat_pytorch_tpu/graph/transforms.py:26-462. Given the same
inputs it yields the same padded arrays, `src_order`, sink node, node
order, window metadata and block-layout arrays as the JAX package. The
block sizes the JAX package reads from its GAT_TPU_V7_* environment knobs
are the constants below (its defaults). `reorder="cluster"` and
`hybrid=True` (the split-locality layout) wait for ROADMAP queue A item
12.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import graphcore_binding as _core
from .graph import BlockLayout, Graph, from_numpy

# compute_block_layout's defaults
V7_NB = 512               # destination rows per tile
V7_EB = 1024              # slots per block
V7_AUTOEB_MAX_E = 500000  # up to here eb/2 is also tried
V7_COST_K = 2560.0        # per-slot fixed cost, in window rows


def add_remaining_self_loops(senders: np.ndarray, receivers: np.ndarray,
                             num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Drop existing self-loops and append (i, i) for every node i."""
    keep = senders != receivers
    loop = np.arange(num_nodes, dtype=senders.dtype)
    return (np.concatenate([senders[keep], loop]),
            np.concatenate([receivers[keep], loop]))


def sort_by_destination(senders: np.ndarray, receivers: np.ndarray,
                        *extra: np.ndarray):
    """Stable sort edges by receiver (destination). Returns sorted arrays."""
    order = np.argsort(receivers, kind="stable")
    return (senders[order], receivers[order]) + tuple(a[order] for a in extra)


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def pad_bucket(n: int, multiple: int = 128, strategy: str = "multiple") -> int:
    """Static bucket size for n: round up to `multiple`, or to the next
    power of two (at least `multiple`) with strategy 'pow2'."""
    if strategy == "pow2":
        return max(multiple, 1 << math.ceil(math.log2(max(n, 1))))
    return max(multiple, round_up(n, multiple))


def canonicalize(x: np.ndarray,
                 senders: np.ndarray,
                 receivers: np.ndarray,
                 *,
                 y: Optional[np.ndarray] = None,
                 train_mask: Optional[np.ndarray] = None,
                 val_mask: Optional[np.ndarray] = None,
                 test_mask: Optional[np.ndarray] = None,
                 graph_ids: Optional[np.ndarray] = None,
                 add_self_loops: bool = True,
                 node_bucket: Optional[int] = None,
                 edge_bucket: Optional[int] = None,
                 pad_multiple: int = 128,
                 pad_strategy: str = "multiple",
                 reorder: Optional[str] = None,
                 src_windows: bool = False,
                 hybrid: bool = False) -> Graph:
    """[Reorder ->] self-loops -> dst-sort -> pad -> CPU Graph.

    One extra padding node is always added so padding edges have a
    dedicated sink; padding edges are (N_pad-1, N_pad-1) with edge_mask
    False, appended after the sorted real edges.

    reorder="rcm" relabels the nodes by reverse Cuthill-McKee before
    sorting, so each destination tile's senders fall in a narrow id
    window; features, labels, masks and graph ids are permuted with the
    nodes, and Graph.node_order maps outputs back to the input ids.
    src_windows=True also computes the window metadata (Graph.tile_lo,
    Graph.src_band) and Graph.block_layout, which puts the kernel path on
    the windowed attention op."""
    if reorder == "cluster" or hybrid:
        raise NotImplementedError(
            "reorder='cluster' and hybrid=True need the split-locality "
            "layout (ROADMAP queue A item 12, not ported)")
    if reorder not in (None, "rcm"):
        raise ValueError(f"unknown reorder {reorder!r} "
                         f"(expected 'rcm' or 'cluster')")
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    n = int(x.shape[0])

    node_order = None
    if reorder == "rcm":
        order = _core.rcm_order(senders, receivers, n)  # old id at new pos
        rank = np.empty(n, dtype=np.int64)
        rank[order] = np.arange(n)
        senders, receivers = rank[senders], rank[receivers]

        def take(a):
            return None if a is None else np.asarray(a)[order]
        x = take(x)
        y, train_mask, val_mask, test_mask, graph_ids = (
            take(y), take(train_mask), take(val_mask), take(test_mask),
            take(graph_ids))
        node_order = order

    if add_self_loops:
        senders, receivers = _core.add_remaining_self_loops(
            senders, receivers, n)
    senders, receivers = _core.sort_by_destination(senders, receivers)

    e = int(senders.shape[0])
    n_pad = node_bucket if node_bucket else pad_bucket(
        n + 1, pad_multiple, pad_strategy)
    e_pad = edge_bucket if edge_bucket else pad_bucket(
        e, pad_multiple, pad_strategy)
    if n_pad < n + 1:
        raise ValueError(f"node_bucket {n_pad} < num_nodes+1 {n + 1}")
    if e_pad < e:
        raise ValueError(f"edge_bucket {e_pad} < num_edges {e}")

    def pad_nodes(a, fill=0):
        if a is None:
            return None
        pad_shape = (n_pad - a.shape[0],) + a.shape[1:]
        return np.concatenate([a, np.full(pad_shape, fill, dtype=a.dtype)])

    sink = n_pad - 1
    senders_p = np.concatenate(
        [senders, np.full(e_pad - e, sink, dtype=np.int64)]).astype(np.int32)
    receivers_p = np.concatenate(
        [receivers, np.full(e_pad - e, sink, dtype=np.int64)]).astype(np.int32)
    # the backward's d(h) reduction walks edges in sender order
    src_order = np.argsort(senders_p, kind="stable").astype(np.int32)

    tile_lo, src_band, block_layout = None, 0, None
    if src_windows:
        tile_lo, src_band = compute_src_windows(senders_p, receivers_p, e,
                                                n_pad)
        block_layout = compute_block_layout(senders_p, receivers_p, e,
                                            n_pad)

    graph = from_numpy(
        pad_nodes(np.asarray(x)),
        senders_p, receivers_p,
        y=pad_nodes(None if y is None else np.asarray(y)),
        train_mask=pad_nodes(train_mask, False),
        val_mask=pad_nodes(val_mask, False),
        test_mask=pad_nodes(test_mask, False),
        edge_mask=np.arange(e_pad) < e,
        node_mask=np.arange(n_pad) < n,
        graph_ids=pad_nodes(
            np.zeros(n, np.int32) if graph_ids is None
            else np.asarray(graph_ids, np.int32), fill=-1),
        src_order=src_order, tile_lo=tile_lo,
        node_order=None if node_order is None
        else np.concatenate([node_order, np.arange(n, n_pad)]),
        src_band=src_band)
    return graph.replace(block_layout=block_layout)


def compute_src_windows(senders: np.ndarray, receivers: np.ndarray,
                        num_real_edges: int, n_pad: int,
                        granule: int = 128) -> Tuple[np.ndarray, int]:
    """Window metadata (Graph.tile_lo, Graph.src_band) over the real prefix
    of the dst-sorted edge list: per 128-row destination tile the min
    sender id (INT32_MAX if the tile has no edge), and the max over
    512-row tiles of max_src - align8(min_src) + 1."""
    i32max = np.int32(2 ** 31 - 1)
    s = np.asarray(senders[:num_real_edges], dtype=np.int64)
    r = np.asarray(receivers[:num_real_edges], dtype=np.int64)
    t128 = (n_pad + granule - 1) // granule
    lo = np.full(t128, i32max, dtype=np.int64)
    hi = np.full(t128, -1, dtype=np.int64)
    tid = r // granule
    np.minimum.at(lo, tid, s)
    np.maximum.at(hi, tid, s)
    k = 512 // granule
    pad = (-t128) % k
    lo5 = np.pad(lo, (0, pad), constant_values=i32max).reshape(-1, k).min(1)
    hi5 = np.pad(hi, (0, pad), constant_values=-1).reshape(-1, k).max(1)
    occupied = hi5 >= 0
    if not occupied.any():
        return lo.astype(np.int32), 0
    span = hi5[occupied] - (lo5[occupied] // 8) * 8 + 1
    return lo.astype(np.int32), int(span.max())


def layout_index_arrays(send: np.ndarray, recv: np.ndarray, n_pad: int):
    """(dst_perm, dst_ptr, src_perm, src_ptr, num_real) of a block layout's
    slot arrays: the index arrays BlockLayout documents, int32."""
    send = np.asarray(send, dtype=np.int64)
    recv = np.asarray(recv, dtype=np.int64)
    real = recv >= 0
    num_real = int(real.sum())
    # pad slots (recv == -1) sort last
    dst_perm = np.argsort(np.where(real, recv, n_pad), kind="stable")
    real_slots = np.flatnonzero(real)
    src_perm = real_slots[np.argsort(send[real_slots], kind="stable")]
    i32 = np.int32
    return (dst_perm.astype(i32),
            _core.csr_offsets(recv[real], n_pad).astype(i32),
            src_perm.astype(i32),
            _core.csr_offsets(send[real], n_pad).astype(i32), num_real)


def compute_block_layout(senders: np.ndarray, receivers: np.ndarray,
                         num_real_edges: int, n_pad: int,
                         nb: Optional[int] = None,
                         eb: Optional[int] = None) -> BlockLayout:
    """The block layout (Graph.block_layout) of the windowed attention op.

    Over the real prefix of the dst-sorted edge list: group the edges by
    nb-row destination tile, sort each tile's edges by sender, cut them
    into blocks of at most eb edges, pad every block to eb slots (pad
    slots: recv = -1, sender = the block's window base), and record per
    block its 128-aligned min-sender window base. `wb` is the largest
    block span rounded to 128; a span cap (chosen from span quantiles)
    splits outlier blocks when that lowers the JAX package's cost model
    slots x (nb + wb + K). Without explicit sizes, nb in {256, 512} and
    (up to V7_AUTOEB_MAX_E edges) eb in {eb, eb/2} are tried and the
    cheapest layout by the same model is kept."""
    explicit_nb, explicit_eb = nb is not None, eb is not None
    nb, eb = nb or V7_NB, eb or V7_EB
    if nb % 128 or eb % 128:
        raise ValueError(f"block sizes must be 128-multiples, "
                         f"got nb={nb} eb={eb}")
    small = num_real_edges <= V7_AUTOEB_MAX_E
    nb_cands = (nb,) if explicit_nb else (256, 512)
    eb_cands = ((eb,) if (explicit_eb or not small or eb <= 128)
                else (eb, eb // 2))
    if len(nb_cands) * len(eb_cands) > 1:
        best, best_cost = None, None
        for nbx in nb_cands:
            for ebx in eb_cands:
                cand = compute_block_layout(senders, receivers,
                                            num_real_edges, n_pad,
                                            nb=nbx, eb=ebx)
                cost = cand.num_slots * (cand.nb + cand.wb + V7_COST_K)
                if best is None or cost < best_cost:
                    best, best_cost = cand, cost
        return best

    s = np.asarray(senders[:num_real_edges], dtype=np.int64)
    r = np.asarray(receivers[:num_real_edges], dtype=np.int64)
    t = -(-n_pad // nb)
    tid = r // nb
    order = np.lexsort((s, tid))                  # by tile, then sender
    ss, rr = s[order], r[order]
    m = np.bincount(tid, minlength=t).astype(np.int64)   # edges per tile
    off = np.zeros(t + 1, np.int64)
    off[1:] = np.cumsum(m)

    def boundaries(target):
        """Greedy per-tile blocking over the src-sorted edges: close a
        block at eb edges, or when the next edge would push the block's
        128-aligned sender span past `target` (None: eb-chunking only).
        Returns (starts, ends, bases, blocks per tile)."""
        starts, ends, bases = [], [], []
        counts = np.zeros(t, np.int64)
        for ti in range(t):
            lo, hi = int(off[ti]), int(off[ti + 1])
            tile = ss[lo:hi]
            i = lo
            while i < hi:
                b = (int(ss[i]) // 128) * 128
                j = min(i + eb, hi)
                if target is not None:
                    j = min(j, lo + int(np.searchsorted(
                        tile, b + target, side="left")))
                    j = max(j, i + 1)
                starts.append(i)
                ends.append(j)
                bases.append(b)
                counts[ti] += 1
                i = j
        return (np.asarray(starts, np.int64), np.asarray(ends, np.int64),
                np.asarray(bases, np.int64), counts)

    def wb_of(st, en, ba):
        if st.shape[0] == 0:
            return 128
        return int(round_up(int((ss[en - 1] - ba + 1).max()), 128))

    st, en, ba, cnt = boundaries(None)
    wb = wb_of(st, en, ba)
    if st.shape[0]:
        spans = ss[en - 1] - ba + 1
        cands = sorted(
            {int(round_up(int(q), 128)) for q in
             np.quantile(spans, [0.25, 0.4, 0.55, 0.7, 0.85])}
            | {int(round_up(max(wb // d, 128), 128)) for d in (2, 3)})
        wb_naive = wb
        best = (st, en, ba, cnt, wb)
        best_cost = st.shape[0] * eb * (nb + wb + V7_COST_K)
        for tg in cands:
            if tg >= wb_naive:     # a cap >= the naive wb never binds
                continue
            st2, en2, ba2, cnt2 = boundaries(tg)
            wb2 = wb_of(st2, en2, ba2)
            cost2 = st2.shape[0] * eb * (nb + wb2 + V7_COST_K)
            if cost2 < best_cost:
                best = (st2, en2, ba2, cnt2, wb2)
                best_cost = cost2
        st, en, ba, cnt, wb = best

    g = st.shape[0]
    e7 = g * eb
    tile_ptr = np.zeros(t + 1, np.int64)
    tile_ptr[1:] = np.cumsum(cnt * eb)
    if g == 0:
        base = np.zeros(1, np.int64)
        wb = 128
        tile_base = np.zeros(t, np.int64)
        window = 128
        send7 = np.zeros(0, np.int64)
        recv7 = np.zeros(0, np.int64)
    else:
        base = ba
        send7 = np.empty(e7, np.int64)
        recv7 = np.full(e7, -1, np.int64)
        for k in range(g):
            nk = int(en[k] - st[k])
            send7[k * eb:k * eb + nk] = ss[st[k]:en[k]]
            recv7[k * eb:k * eb + nk] = rr[st[k]:en[k]]
            send7[k * eb + nk:(k + 1) * eb] = ba[k]
        # per-tile window covering all of the tile's blocks
        bmax = ss[en - 1]
        blk_tile = np.repeat(np.arange(t), cnt)
        tmin = np.full(t, np.iinfo(np.int64).max)
        tmax = np.full(t, -1, np.int64)
        np.minimum.at(tmin, blk_tile, base)
        np.maximum.at(tmax, blk_tile, bmax)
        has_t = m > 0
        tile_base = np.where(has_t, np.minimum(tmin, n_pad), 0)
        window = int(round_up(
            max(int(np.where(has_t, tmax - tile_base + 1, 1).max()), wb),
            128))
        # make non-monotone bases monotone by suffix-min when the window
        # grows only modestly (lowering a base only widens its window)
        occ_base = np.where(has_t, tile_base, np.int64(2 ** 62))
        if has_t.any() and not (np.diff(tile_base[has_t]) >= 0).all():
            cand = np.minimum.accumulate(occ_base[::-1])[::-1]
            cand = np.where(has_t, cand, 0)
            window2 = int(round_up(
                max(int(np.where(has_t, tmax - cand + 1, 1).max()), wb),
                128))
            if window2 <= window + max(window // 3, 1024):
                tile_base, window = cand, window2
        # forward-fill the bases of empty tiles, which have no blocks
        last = np.maximum.accumulate(np.where(has_t, np.arange(t), -1))
        tile_base = np.where(last >= 0, tile_base[np.maximum(last, 0)], 0)
    dmax = -1
    if t >= 1:
        deltas = np.diff(tile_base) if t > 1 else np.zeros(1, np.int64)
        if (deltas >= 0).all():
            dmax = int(round_up(max(int(deltas.max()), 0) + 8, 8))

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))

    dst_perm, dst_ptr, src_perm, src_ptr, num_real = layout_index_arrays(
        send7, recv7, n_pad)
    return BlockLayout(
        send=t32(send7), recv=t32(recv7), base=t32(base),
        tile_ptr=t32(tile_ptr), tile_base=t32(tile_base),
        dst_perm=t32(dst_perm), dst_ptr=t32(dst_ptr),
        src_perm=t32(src_perm), src_ptr=t32(src_ptr),
        wb=int(wb), window=int(window), nb=int(nb), eb=int(eb),
        dmax=int(dmax), num_real=num_real)
