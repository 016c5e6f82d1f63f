"""Every file BENCHMARK.json names loads by its name, and the file keeps
to the benchmark's contract on names, units, bounds and links."""

import json
import re

import pytest

from portbench import spec
from portbench.tests.helpers import BENCH, REPO, WORKLOADS, benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH_JSON = benchmark()
CELLS = [w["name"] for w in BENCH_JSON["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH_JSON) == {"command", "paths", "run_seconds", "configs",
                               "workloads", "end_to_end", "per_layer"}
    assert BENCH_JSON["command"] == ["python3", "portbench/run.py"]
    assert BENCH_JSON["paths"] == ["portbench"]
    assert 1 <= BENCH_JSON["run_seconds"] <= 51


def test_cells_and_workload_files_are_the_same():
    assert set(CELLS) == set(WORKLOADS)


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_loads_by_name(name):
    cell = spec.load_cell(name)
    for entry in BENCH_JSON["workloads"]:
        if entry["name"] == name:
            for key in ("config", "traffic", "why", "chips"):
                assert cell.workload[key] == entry[key]
    assert cell.chips == 1
    assert len(cell.workload["why"]) <= 200
    assert set(cell.limits) == {"loss_gap", "grad_gap", "change_gap"}
    cell.generator()
    assert (BENCH / "reference" / f"{cell.config['reference']}.py").exists()
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert cell.per_layer


FORM_API = ("port_args", "leaf_shapes", "attention_forward",
            "attention_backward", "outside_ops")


def test_forms_are_found_and_used():
    """Each configuration's form (forms/<form>.py, "gat" where it names
    none) loads by its name and gives what set-up and counting take; each
    form file is some configuration's."""
    used = set()
    for c in BENCH_JSON["configs"]:
        config = json.loads((REPO / c["file"]).read_text())
        name = config.get("form", spec.DEFAULT_FORM)
        used.add(name)
        form = spec.form_of(config)
        for attr in FORM_API:
            assert callable(getattr(form, attr)), (name, attr)
        args = form.port_args(config)
        for key in ("num_layers", "num_heads_per_layer",
                    "head_output_features_per_layer", "num_classes"):
            assert args[key] == config[key]
    files = {p.stem for p in (BENCH / "forms").glob("*.py")} - {"__init__"}
    assert files == used


def test_configs_are_their_files_and_used():
    used = {w["config"] for w in BENCH_JSON["workloads"]}
    for c in BENCH_JSON["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert (REPO / c["file"]).exists()
        assert c["name"] in used
        assert c["reduced"] == []


@pytest.mark.parametrize("metric", BENCH_JSON["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_names_its_layer(metric):
    reader = spec.load_module(BENCH / "metrics" / f"{metric['name']}.py")
    assert reader.LAYER == metric["layer"]
    assert reader.MOVES == metric["moves"]
    assert callable(reader.read)
    e2e = {m["name"] for m in BENCH_JSON["end_to_end"]}
    assert metric["moves"] in e2e


def test_names_units_and_bounds():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH_JSON[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"])
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
    assert len(names) == len(set(names))
    for m in BENCH_JSON["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH_JSON["end_to_end"])
    for m in BENCH_JSON["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m.get("workloads", []):
            assert cell in CELLS
