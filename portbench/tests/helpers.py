"""A small copy of the benchmark's data for the CPU tests: the cells'
configurations, forms, metrics and reference as they are, the traffic
mixes at a reduced scale (the same generators and every other
parameter)."""

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
REPO = BENCH.parent

SMALL = {
    "arxiv_like": {"nodes": 700, "citations": 3000, "train": 300,
                   "val": 100, "test": 200},
    "arxiv_powerlaw": {"nodes": 700, "citations": 3000, "train": 300,
                       "val": 100, "test": 200},
}
# every cell with a file (test_portbench_files: each is listed)
WORKLOADS = sorted(p.stem for p in (BENCH / "workloads").glob("*.json"))


def small_root(tmp: Path) -> Path:
    """A data root under `tmp` with the traffic mixes at reduced scale."""
    root = tmp / "data"
    for sub in ("configs", "forms", "workloads", "traffic", "metrics",
                "reference"):
        shutil.copytree(BENCH / sub, root / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for name, params in SMALL.items():
        path = root / "traffic" / f"{name}.json"
        spec = json.loads(path.read_text())
        spec["params"].update(params)
        path.write_text(json.dumps(spec))
    return root


def benchmark() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())
