"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/<name>.cu` has a plain C interface (the `csrc/*.cuh` headers
are shared) and is compiled on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/torch_kernels/lib<name>-<hash>.so

at first use, into `build/torch_kernels/` at the repository root (listed
in .gitignore). The file name carries a hash of the source, the headers
and the flags, so an edited source is rebuilt and a stale library is never
loaded.
`build_all()` starts one nvcc per source at once.

Nothing here runs at import: the CPU tests import every module, and this
machine-independent module only touches nvcc when a kernel is launched
or a build is asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("v5_attention", "segment_sum", "window_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# Launches per kernel wrapper: each wrapper adds one where it launches its
# kernel on a CUDA tensor, and nowhere else (chip_smoke.py reads these).
LAUNCHES: Dict[str, int] = {"v5_forward": 0, "v5_backward": 0,
                            "segment_sum_rows": 0, "window_forward": 0,
                            "window_backward": 0}

_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or $CUDA_HOME/bin)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that is not built yet, all nvcc
    processes at once. Returns the compiler's output per source built.
    Raises RuntimeError naming the source if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}.cu (rc {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (its cudaGetLastError())."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed: cudaError {err}")


# -- shared by the kernel wrappers -------------------------------------------

WARPS_PER_BLOCK = 8     # kWarps in every csrc/*.cu
MAX_BLOCKS = 264        # two blocks per H100 SM; a fixed grid keeps the
#                         order of every cross-block partial sum fixed


def grid_blocks(rows: int) -> int:
    """Blocks for a one-warp-per-row kernel over `rows` rows."""
    return max(1, min(-(-rows // WARPS_PER_BLOCK), MAX_BLOCKS))


def require(t: torch.Tensor, name: str, device: torch.device,
            dtype: torch.dtype, shape: tuple) -> None:
    """Raise ValueError unless `t` is a contiguous `dtype` tensor of
    `shape` (None entries match any size) on `device`."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: expected a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def csr_offsets(sorted_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(num_segments + 1,) int32 offsets of each id's run in the sorted
    int32 `sorted_ids`, on their device (ids >= num_segments fall past
    the last offset)."""
    bounds = torch.arange(num_segments + 1, dtype=torch.int32,
                          device=sorted_ids.device)
    return torch.searchsorted(sorted_ids, bounds, out_int32=True)


def ptr(t) -> Optional[int]:
    """Device address for a C argument (None -> NULL)."""
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
