"""Finding a cell's files by name.

A cell (`BENCHMARK.json` "workloads", and `workloads/<cell>.json`) names a
configuration (`configs/<config>.json`, which names its model form,
`forms/<form>.py`, "gat" where it names none) and a traffic mix
(`traffic/<traffic>.json`, which names its generator,
`traffic/<generator>.py`). Its metrics are the `BENCHMARK.json` entries that
list it under "workloads", or that list no cells at all; each per-layer
metric is read by `metrics/<metric>.py`. `data_root` is the folder that
holds those sub-folders (this one by default, another in the tests), and
`benchmark` the path of `BENCHMARK.json`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
BENCHMARK = REPO / "BENCHMARK.json"
DEFAULT_FORM = "gat"


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path) -> ModuleType:
    """The Python file at `path` as a module of its own (its file name
    need not be an identifier)."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_{path.parent.name}_{path.stem}".replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Config(dict):
    """A configuration as loaded (configs/<config>.json), and the data root
    it was found under, where its form is found too."""

    def __init__(self, values: dict, root: Path = HERE):
        super().__init__(values)
        self.root = Path(root)


def form_of(config: dict) -> ModuleType:
    """The model form module that `config` names: forms/<form>.py under
    the data root a Config was found under, this folder for a plain
    dict. The one lookup of a form, for the port's set-up and the
    reference alike."""
    root = getattr(config, "root", HERE)
    return load_module(root / "forms"
                       / f"{config.get('form', DEFAULT_FORM)}.py")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict          # workloads/<cell>.json
    config: Config          # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    end_to_end: List[dict]  # BENCHMARK.json metrics this cell reports
    per_layer: List[dict]
    data_root: Path

    @property
    def chips(self) -> int:
        return int(self.workload.get("chips", 1))

    @property
    def limits(self) -> dict:
        """The limit of each number the correctness check compares."""
        return self.workload["limits"]

    def form(self) -> ModuleType:
        return form_of(self.config)

    def generator(self) -> ModuleType:
        return load_module(self.data_root / "traffic"
                           / f"{self.traffic['generator']}.py")

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(self.data_root / "metrics" / f"{name}.py")


def _applies(metric: dict, cell: str) -> bool:
    cells = metric.get("workloads")
    return cells is None or cell in cells


def load_cell(name: str, data_root: Optional[Path] = None,
              benchmark: Optional[Path] = None) -> Cell:
    """The cell `name`, with its configuration, traffic mix and metrics.
    FileNotFoundError if it has no workload file."""
    root = Path(data_root) if data_root is not None else HERE
    bench = _json(Path(benchmark) if benchmark is not None else BENCHMARK)
    workload = _json(root / "workloads" / f"{name}.json")
    config = Config(_json(root / "configs" / f"{workload['config']}.json"),
                    root)
    traffic = _json(root / "traffic" / f"{workload['traffic']}.json")
    return Cell(name=name, workload=workload, config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)],
                data_root=root)
