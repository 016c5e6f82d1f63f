"""Host graph primitives with the semantics of csrc/graphcore.cpp.

Counterpart of gat_pytorch_tpu/graph/graphcore_binding.py:63-108 and
:134-179, in its numpy form (the spec the C++ library is tested against).
The port does not load the native library: at the sizes of its main path
these run in milliseconds, except `rcm_order`, whose per-node Python loop
takes about a second at Pubmed size (once per graph).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def add_remaining_self_loops(senders: np.ndarray, receivers: np.ndarray,
                             num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Drop existing (i, i) edges and append one self-loop per node."""
    senders, receivers = _i64(senders), _i64(receivers)
    keep = senders != receivers
    loop = np.arange(num_nodes, dtype=np.int64)
    return (np.concatenate([senders[keep], loop]),
            np.concatenate([receivers[keep], loop]))


def sort_by_destination(senders: np.ndarray, receivers: np.ndarray,
                        return_perm: bool = False):
    """Stable sort of the edges by receiver."""
    senders, receivers = _i64(senders), _i64(receivers)
    perm = np.argsort(receivers, kind="stable")
    out = (senders[perm], receivers[perm])
    return out + (perm,) if return_perm else out


def csr_offsets(receivers: np.ndarray, num_nodes: int) -> np.ndarray:
    """(num_nodes + 1,) offsets of each node's run in sorted `receivers`."""
    counts = np.bincount(_i64(receivers), minlength=num_nodes)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)


def rcm_order(senders: np.ndarray, receivers: np.ndarray,
              num_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the symmetrised adjacency:
    order[i] = old node id at new position i. BFS from a min-degree root
    per component, neighbours in ascending-degree order (stable sorts),
    labelling reversed. It narrows the edge bandwidth, so each destination
    tile reads its sender rows from a narrow id window."""
    senders, receivers = _i64(senders), _i64(receivers)
    nonloop = senders != receivers
    s, r = senders[nonloop], receivers[nonloop]
    src = np.concatenate([s, r])
    dst = np.concatenate([r, s])
    deg = np.bincount(src, minlength=num_nodes)
    adj = dst[np.argsort(src, kind="stable")]
    off = np.concatenate([[0], np.cumsum(deg)])
    seen = np.zeros(num_nodes, dtype=bool)
    out = np.empty(num_nodes, dtype=np.int64)
    w = 0
    for root in np.argsort(deg, kind="stable"):
        if seen[root]:
            continue
        seen[root] = True
        queue = [int(root)]
        head = 0
        while head < len(queue):
            v = queue[head]
            head += 1
            out[w] = v
            w += 1
            nb = adj[off[v]:off[v + 1]]
            nb = np.unique(nb[~seen[nb]])    # multi-edges count once
            nb = nb[np.argsort(deg[nb], kind="stable")]
            seen[nb] = True
            queue.extend(int(u) for u in nb)
    return out[::-1].copy()
