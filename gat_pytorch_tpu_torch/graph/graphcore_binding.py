"""Host graph primitives: the native graphcore library (csrc/graphcore.cpp)
through ctypes, and its numpy form.

Counterpart of gat_pytorch_tpu/graph/graphcore_binding.py. The library is
compiled from the repository's `csrc/graphcore.cpp`, unedited, at first
use, with `$CXX` (or `g++`) and csrc/Makefile's flags

    -O3 -march=native -fPIC -std=c++17 -Wall -shared

into `build/graphcore/libgraphcore-<hash>.so` at the repository root
(gitignored), the hash taken over the source, the compiler, the flags and
the host's CPU (model and feature flags): an edited source is rebuilt,
and a library that -march=native built for another CPU is never loaded.
A build writes a temporary file and renames it into place, so processes
that build at once never load a half-written library.

Where no compiler is found the numpy form runs, as the JAX package's does
without its library, and `native_available()` is False. A compiler that
is found but fails raises: there is no quiet fallback. Each function's
numpy form is the spec its C entry is held to (tests/test_torch_graphcore.py).
Arguments that would make a C entry index out of bounds (ids past the
node count or negative, counts or CSR offsets that do not fit the arrays)
take the numpy form, which raises or answers as numpy does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "csrc" / "graphcore.cpp"
BUILD_DIR = _ROOT / "build" / "graphcore"
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
            "-shared"]

_lib: Optional[ctypes.CDLL] = None
_searched = False       # True once _load found no compiler


def compiler() -> Optional[str]:
    """The C++ compiler: `$CXX` where set, else g++; None if not found."""
    return shutil.which(os.environ.get("CXX") or "g++")


def _host() -> str:
    """What -march=native compiles for: the CPU's model and feature flags
    (the first processor's lines of /proc/cpuinfo), else the machine
    type."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f.read().split("\n\n")[0].splitlines()
                     if ln.startswith(("model name", "flags", "Features"))]
    except OSError:
        lines = []
    return "\n".join(lines) or platform.machine()


def lib_path(cxx: str) -> Path:
    """The library file built from SOURCE by `cxx` with CXXFLAGS on this
    host's CPU."""
    key = hashlib.sha256(SOURCE.read_bytes() + "\0".join(
        [cxx, _host()] + CXXFLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libgraphcore-{key}.so"


def build(cxx: str) -> Path:
    """Compile SOURCE with `cxx` unless built; the library's path.
    RuntimeError with the compiler's output if the build fails."""
    out = lib_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed to build {SOURCE} (rc "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None without a
    compiler."""
    global _lib, _searched
    if _lib is not None or _searched:
        return _lib
    cxx = compiler()
    if cxx is None:
        _searched = True
        return None
    lib = ctypes.CDLL(str(build(cxx)))
    i64p = ctypes.POINTER(ctypes.c_int64)
    i64 = ctypes.c_int64
    lib.gc_add_remaining_self_loops.restype = i64
    lib.gc_add_remaining_self_loops.argtypes = [i64p, i64p, i64, i64, i64p,
                                                i64p]
    lib.gc_sort_by_destination.restype = None
    lib.gc_sort_by_destination.argtypes = [i64p, i64p, i64, i64, i64p, i64p,
                                           i64p]
    lib.gc_csr_offsets.restype = None
    lib.gc_csr_offsets.argtypes = [i64p, i64, i64, i64p]
    lib.gc_block_diagonal.restype = None
    lib.gc_block_diagonal.argtypes = [i64p, i64p, i64p, i64p, i64, i64p,
                                      i64p, i64p]
    lib.gc_sample_neighbors.restype = i64
    lib.gc_sample_neighbors.argtypes = [i64p, i64p, i64p, i64, i64,
                                        ctypes.c_uint64, i64p, i64p]
    lib.gc_rcm_order.restype = None
    lib.gc_rcm_order.argtypes = [i64p, i64p, i64, i64, i64p]
    _lib = lib
    return lib


def native_available() -> bool:
    """True where the native library is loaded (or could be built)."""
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _in_range(ids: np.ndarray, n: int) -> bool:
    return ids.size == 0 or (int(ids.min()) >= 0 and int(ids.max()) < n)


def _csr(offsets: np.ndarray, num_slots: int) -> bool:
    """Offsets that only read slots [0, num_slots), in order."""
    return offsets.size >= 1 and int(offsets[0]) >= 0 and \
        int(offsets[-1]) <= num_slots and bool((np.diff(offsets) >= 0).all())


def add_remaining_self_loops(senders: np.ndarray, receivers: np.ndarray,
                             num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Drop existing (i, i) edges and append one self-loop per node."""
    lib = _load()
    senders, receivers = _i64(senders), _i64(receivers)
    if lib is None or receivers.shape != senders.shape:
        keep = senders != receivers
        loop = np.arange(num_nodes, dtype=np.int64)
        return (np.concatenate([senders[keep], loop]),
                np.concatenate([receivers[keep], loop]))
    e = senders.shape[0]
    out_s = np.empty(e + num_nodes, dtype=np.int64)
    out_r = np.empty(e + num_nodes, dtype=np.int64)
    k = lib.gc_add_remaining_self_loops(
        _ptr(senders), _ptr(receivers), e, num_nodes, _ptr(out_s), _ptr(out_r))
    return out_s[:k], out_r[:k]


def sort_by_destination(senders: np.ndarray, receivers: np.ndarray,
                        return_perm: bool = False):
    """Stable sort of the edges by receiver (the C entry: a counting
    sort)."""
    lib = _load()
    senders, receivers = _i64(senders), _i64(receivers)
    e = senders.shape[0]
    if lib is None or e == 0 or receivers.shape != senders.shape \
            or int(receivers.min()) < 0:
        perm = np.argsort(receivers, kind="stable")
        out = (senders[perm], receivers[perm])
        return out + (perm,) if return_perm else out
    n = int(receivers.max()) + 1
    out_s = np.empty(e, dtype=np.int64)
    out_r = np.empty(e, dtype=np.int64)
    perm = np.empty(e, dtype=np.int64)
    lib.gc_sort_by_destination(_ptr(senders), _ptr(receivers), e, n,
                               _ptr(out_s), _ptr(out_r), _ptr(perm))
    return (out_s, out_r, perm) if return_perm else (out_s, out_r)


def csr_offsets(receivers: np.ndarray, num_nodes: int) -> np.ndarray:
    """(num_nodes + 1,) offsets of each node's run in sorted `receivers`."""
    lib = _load()
    receivers = _i64(receivers)
    if lib is None or not _in_range(receivers, num_nodes):
        counts = np.bincount(receivers, minlength=num_nodes)
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    out = np.empty(num_nodes + 1, dtype=np.int64)
    lib.gc_csr_offsets(_ptr(receivers), receivers.shape[0], num_nodes,
                       _ptr(out))
    return out


def block_diagonal(senders: np.ndarray, receivers: np.ndarray,
                   node_counts: np.ndarray, edge_counts: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Offset concatenated per-graph edge lists into one big graph.
    Returns (senders, receivers, graph_ids_per_node)."""
    lib = _load()
    senders, receivers = _i64(senders), _i64(receivers)
    node_counts, edge_counts = _i64(node_counts), _i64(edge_counts)
    if lib is None or int(edge_counts.sum()) != senders.shape[0] \
            or receivers.shape != senders.shape \
            or not (_in_range(edge_counts, senders.shape[0] + 1)
                    and _in_range(node_counts, 2 ** 62)):
        node_off = np.concatenate([[0], np.cumsum(node_counts)[:-1]])
        offs = np.repeat(node_off, edge_counts)
        gids = np.repeat(np.arange(len(node_counts), dtype=np.int64),
                         node_counts)
        return senders + offs, receivers + offs, gids
    out_s = np.empty_like(senders)
    out_r = np.empty_like(receivers)
    gids = np.empty(int(node_counts.sum()), dtype=np.int64)
    lib.gc_block_diagonal(_ptr(senders), _ptr(receivers), _ptr(node_counts),
                          _ptr(edge_counts), len(node_counts),
                          _ptr(out_s), _ptr(out_r), _ptr(gids))
    return out_s, out_r, gids


def rcm_order(senders: np.ndarray, receivers: np.ndarray,
              num_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee ordering of the symmetrised adjacency:
    order[i] = old node id at new position i. BFS from a min-degree root
    per component, neighbours in ascending-degree order (stable sorts),
    labelling reversed. It narrows the edge bandwidth, so each destination
    tile reads its sender rows from a narrow id window."""
    lib = _load()
    senders, receivers = _i64(senders), _i64(receivers)
    if lib is not None and receivers.shape == senders.shape \
            and _in_range(senders, num_nodes) \
            and _in_range(receivers, num_nodes):
        out = np.empty(num_nodes, dtype=np.int64)
        lib.gc_rcm_order(_ptr(senders), _ptr(receivers), senders.shape[0],
                         num_nodes, _ptr(out))
        return out
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


def sample_neighbors(offsets: np.ndarray, senders: np.ndarray,
                     seeds: np.ndarray, k: int, seed: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Uniform in-neighbour sampling without replacement on the CSR view
    (offsets, senders): exactly min(k, degree) distinct in-edge slots a
    seed, every k-subset equally likely (the C entry: Floyd's algorithm on
    std::mt19937_64(seed); the numpy form: np.random.default_rng(seed),
    another draw). Returns (src, dst) edge arrays."""
    lib = _load()
    offsets, senders, seeds = _i64(offsets), _i64(senders), _i64(seeds)
    if lib is None or k < 0 or not _csr(offsets, senders.shape[0]) \
            or not _in_range(seeds, offsets.shape[0] - 1):
        rng = np.random.default_rng(seed)
        src_list, dst_list = [], []
        for v in seeds:
            lo, hi = offsets[v], offsets[v + 1]
            deg = hi - lo
            if deg <= 0:
                continue
            if deg <= k:
                idx = np.arange(lo, hi)
            else:
                idx = lo + rng.choice(deg, size=k, replace=False)
            src_list.append(senders[idx])
            dst_list.append(np.full(len(idx), v, dtype=np.int64))
        if not src_list:
            return (np.empty(0, np.int64), np.empty(0, np.int64))
        return np.concatenate(src_list), np.concatenate(dst_list)
    cap = len(seeds) * k
    out_src = np.empty(cap, dtype=np.int64)
    out_dst = np.empty(cap, dtype=np.int64)
    w = lib.gc_sample_neighbors(_ptr(offsets), _ptr(senders), _ptr(seeds),
                                len(seeds), k, seed, _ptr(out_src),
                                _ptr(out_dst))
    return out_src[:w], out_dst[:w]
