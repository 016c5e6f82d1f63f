"""Host-side graph canonicalisation: self-loops, dst-sort, static padding.

Counterpart of gat_pytorch_tpu/graph/transforms.py:26-189, without the
locality layouts (`reorder`, `src_windows`, `hybrid`), which wait for the
windowed kernels (ROADMAP queue A item 8). Given the same inputs it
yields the same padded arrays, `src_order` and sink node as the JAX
`canonicalize`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

from . import graphcore_binding as _core
from .graph import Graph, from_numpy


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
                 pad_strategy: str = "multiple") -> Graph:
    """Self-loops -> dst-sort -> pad -> CPU Graph.

    One extra padding node is always added so padding edges have a
    dedicated sink; padding edges are (N_pad-1, N_pad-1) with edge_mask
    False, appended after the sorted real edges."""
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    n = int(x.shape[0])

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

    return from_numpy(
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
        src_order=src_order)
