"""Host graph primitives with the semantics of csrc/graphcore.cpp.

Counterpart of gat_pytorch_tpu/graph/graphcore_binding.py:63-108, in its
numpy form (the spec the C++ library is tested against). The port does
not load the native library: at the sizes of its main path these run in
milliseconds.
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
