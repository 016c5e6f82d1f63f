"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each `csrc/<name>.cu` has a plain C interface (the `csrc/*.cuh` headers
are shared) and is compiled on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/torch_kernels/lib<name>-<hash>.so

at first use, into `build/torch_kernels/` at the repository root (listed
in .gitignore). The attention sources are compiled a second time with
-DGAT_BF16_TABLE, into lib<name>_bf16table-<hash>.so: the same entries
for a bfloat16 h table (the table modes of rounding.py), each library
holding the kernels of one element type, so that the two builds run side
by side. The file name carries a hash of the source, the headers and the
flags, so an edited source is rebuilt and a stale library is never
loaded. `build_all()` starts one nvcc per library at once.

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
SOURCES = ("v5_attention", "segment_sum", "window_attention",
           "table_attention", "segment_attention")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# the sources built again for a bfloat16 h table, and the libraries
_BF16_TABLE = "_bf16table"
TABLE_SOURCES = ("v5_attention", "window_attention", "table_attention")
LIBRARIES = SOURCES + tuple(s + _BF16_TABLE for s in TABLE_SOURCES)

# Launches per kernel wrapper: each wrapper adds one where it launches its
# kernel on a CUDA tensor, and nowhere else (chip_smoke.py reads these).
# An entry's bfloat16 modes count apart, under "<entry>_bf16"
# (rounding.Rounding.counter); the cap passes have no such mode, and of
# the v2 entries only the forward has one.
_ENTRIES = ("v5_forward", "v5_backward", "window_forward", "window_backward",
            "table_forward", "table_backward", "v5_backward_parts",
            "window_backward_parts", "v5_cap", "v5_forward_two_phase",
            "v5_backward_two_phase", "window_forward_two_phase",
            "window_backward_two_phase")
LAUNCHES: Dict[str, int] = dict.fromkeys(
    _ENTRIES + ("segment_sum_rows", "segment_sum_sorted", "window_cap",
                "segment_sum_rows_t", "v2_forward", "v2_backward",
                "v2_forward_bf16", "v5_dasrc")
    + tuple(k + "_bf16" for k in _ENTRIES), 0)

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


def library(source: str, bf16_table: bool = False) -> str:
    """The library of `source` for a float32 or a bfloat16 h table."""
    return source + _BF16_TABLE if bf16_table else source


def _source_and_flags(name: str):
    if name.endswith(_BF16_TABLE):
        return name[:-len(_BF16_TABLE)], NVCC_FLAGS + ["-DGAT_BF16_TABLE"]
    return name, NVCC_FLAGS


def _lib_path(name: str) -> Path:
    source, flags = _source_and_flags(name)
    src = (CSRC / f"{source}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    key = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build_all(names: Iterable[str] = LIBRARIES) -> Dict[str, str]:
    """Compile every named library that is not built yet, all nvcc
    processes at once. Returns the compiler's output per library built.
    Raises RuntimeError naming the library if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        source, flags = _source_and_flags(name)
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{source}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def resource_usage(name: str):
    """[(kernel symbol, registers, local bytes, stack bytes)] of the built
    library `name`, as `cuobjdump -res-usage` reports them (LOCAL is the
    per-thread local memory: spilled registers and local arrays)."""
    tool = str(Path(_nvcc()).with_name("cuobjdump"))
    text = subprocess.run([tool, "-res-usage", str(_lib_path(name))],
                          capture_output=True, text=True, check=True).stdout
    found, symbol = [], None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function ") and line.endswith(":"):
            symbol = line[len("Function "):-1]
        elif symbol is not None and line.startswith("REG:"):
            fields = dict(f.split(":", 1) for f in line.split()
                          if ":" in f)
            found.append((symbol, int(fields["REG"]),
                          int(fields.get("LOCAL", 0)),
                          int(fields.get("STACK", 0))))
            symbol = None
    return found


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name` (of LIBRARIES), built first if needed."""
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


def require_cpu(t: torch.Tensor) -> None:
    """Raise unless `t` lies on the CPU: a kernel wrapper takes its plain
    version there, and only there (a CUDA tensor launches the kernel)."""
    if t.device.type != "cpu":
        raise ValueError(f"no kernel for device {t.device}")


def csr_offsets(sorted_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(num_segments + 1,) int32 offsets of each id's run in the sorted
    int32 `sorted_ids`, on their device (ids >= num_segments fall past
    the last offset)."""
    bounds = torch.arange(num_segments + 1, dtype=torch.int32,
                          device=sorted_ids.device)
    return torch.searchsorted(sorted_ids, bounds, out_int32=True)


def row_offsets(receivers: torch.Tensor, n: int,
                dst_ptr: Optional[torch.Tensor]) -> torch.Tensor:
    """The CSR offsets of the dst-sorted edges over n rows: the caller's
    (Graph.dst_ptr, built once with the graph), checked, or computed here
    (csr_offsets, two launches)."""
    if dst_ptr is None:
        return csr_offsets(receivers, n)
    require(dst_ptr, "dst_ptr", receivers.device, torch.int32, (n + 1,))
    return dst_ptr


def ptr(t) -> Optional[int]:
    """Device address for a C argument (None -> NULL)."""
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
