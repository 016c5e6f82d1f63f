"""A cell, a configuration or a per-layer metric is added by adding files
alone: each is found by its name, with no edit to a file that is there.
Shown here on the CPU (the port's plain versions) at a small size."""

import json
import time

import torch

from portbench import harness, spec
from portbench.tests.helpers import REPO, benchmark, small_root

CPU = torch.device("cpu")


def run(cell, traced=False, seed=21):
    return harness.run_cell(cell, seed, 0.2, traced, CPU,
                            time.perf_counter())


def limits():
    return json.loads((REPO / "portbench" / "workloads"
                       / "arxiv-full-v5.json").read_text())["limits"]


def write(path, obj):
    path.write_text(json.dumps(obj))


def test_a_workload_file_alone_is_a_cell(tmp_path):
    root = small_root(tmp_path)
    write(root / "workloads" / "arxiv-extra.json", {
        "config": "gat-transductive", "traffic": "arxiv_like", "chips": 1,
        "why": "a cell added as a file", "trace_steps": 2,
        "limits": limits()})
    cell = spec.load_cell("arxiv-extra", data_root=root)
    res = run(cell)
    assert res["correct"], res["checks"]
    e2e = [m["name"] for m in benchmark()["end_to_end"]]
    assert list(res["metrics"]) == e2e
    assert list(res)[-1] == "checks"
    traced = run(cell, traced=True)
    assert traced["correct"]
    # the device's metrics read nothing on the CPU; these are counted
    assert {"host_enqueue_ms", "port_kernel_calls_per_step"} <= set(
        traced["metrics"])
    assert "attn_fwd_roofline" not in traced["metrics"]


def test_a_configuration_file_alone_is_a_configuration(tmp_path):
    root = small_root(tmp_path)
    cfg = json.loads((root / "configs" / "gat-transductive.json")
                     .read_text())
    cfg.update(num_layers=3, num_heads_per_layer=[8, 8, 8],
               heads_concat_per_layer=[True, True, False],
               head_output_features_per_layer=[128, 8, 8, 40],
               add_skip_connection=[False, True, False])
    write(root / "configs" / "gat-three-layers.json", cfg)
    write(root / "workloads" / "arxiv-three.json", {
        "config": "gat-three-layers", "traffic": "arxiv_like", "chips": 1,
        "why": "a configuration added as a file", "trace_steps": 2,
        "limits": limits()})
    res = run(spec.load_cell("arxiv-three", data_root=root))
    assert res["correct"], res["checks"]


def test_a_metric_file_alone_is_a_metric(tmp_path):
    root = small_root(tmp_path)
    (root / "metrics" / "traced_steps.py").write_text(
        'LAYER = "trainer"\nMOVES = "train_edges_per_s"\n\n\n'
        'def read(ctx):\n    return float(ctx["steps"])\n')
    bench = benchmark()
    bench["per_layer"].append({
        "name": "traced_steps", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "trainer",
        "moves": "train_edges_per_s"})
    write(tmp_path / "BENCHMARK.json", bench)
    cell = spec.load_cell("arxiv-full-v5", data_root=root,
                          benchmark=tmp_path / "BENCHMARK.json")
    res = run(cell, traced=True)
    assert res["metrics"]["traced_steps"] == {
        "value": float(cell.workload["trace_steps"]), "unit": "steps"}
