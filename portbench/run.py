"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the port (`gat_pytorch_tpu_torch`).
The last line of standard output is the result's JSON object (its
"metrics": the cell's end-to-end metrics, or with --trace 1 its per-layer
ones); the last lines of standard error give each number the correctness
check compared, beside its limit. The run needs as many CUDA devices as
the cell asks for, and exits with another code than 0, printing no
result, without them, or where a module of JAX, jaxlib, flax or the JAX
package was loaded. The port's kernels are built into `build/` inside the
checkout on the first run and loaded from there after; the caches torch
may use are pointed there too.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _point_caches() -> None:
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"not read ({err})"
    return out or "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _point_caches()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness, spec
    cell = spec.load_cell(args.workload)
    seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if seen < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees {seen}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}: the run must not "
              f"load JAX or the JAX package", file=sys.stderr)
        return 3
    print(f"card and power limit: {_power_limit()}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    for name, row in result["checks"].items():
        print(f"{name} {row['value']} limit {row['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
