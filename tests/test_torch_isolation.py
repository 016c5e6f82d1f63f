"""The port stands alone: it imports neither jax nor the JAX package,
and its entry points refuse to run on the CPU unless asked to."""

import ast
import os
import pkgutil
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import setuptools
import torch

import gat_pytorch_tpu_torch
from gat_pytorch_tpu_torch.cli import train as cli
from gat_pytorch_tpu_torch.graph import transforms as TT
from gat_pytorch_tpu_torch.models import gat
from gat_pytorch_tpu_torch.train.tasks import make_task
from gat_pytorch_tpu_torch.train.trainer import Trainer
from gat_pytorch_tpu_torch.utils.convert import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(gat_pytorch_tpu_torch.__file__)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="gat_pytorch_tpu_torch."))


def test_every_module_imports_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['gat_pytorch_tpu'] = None\n"
            "import importlib\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.')\n"
            "               for k, v in sys.modules.items() if v)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imported_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_jax_package_import_in_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG_DIR):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "gat_pytorch_tpu",
                               "optax", "flax"), f"{path}: {name}"


def test_packaging_finds_the_port():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        find = tomllib.load(f)["tool"]["setuptools"]["packages"]["find"]
    found = setuptools.find_packages(ROOT, include=find["include"])
    assert {m.rsplit(".", 1)[0] for m in _modules()} | \
        {"gat_pytorch_tpu_torch"} <= set(found)


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny():
    cfg = gat.GATConfig(num_input_node_features=4, num_layers=1,
                        num_heads_per_layer=[1],
                        heads_concat_per_layer=[False],
                        head_output_features_per_layer=[4, 3],
                        num_classes=3, add_skip_connection=[False])
    rng = np.random.default_rng(0)
    g = TT.canonicalize(rng.random((10, 4)).astype(np.float32),
                        rng.integers(0, 10, 30), rng.integers(0, 10, 30),
                        y=rng.integers(0, 3, 10),
                        train_mask=np.ones(10, bool),
                        val_mask=np.ones(10, bool))
    return cfg, g


def test_entry_points_refuse_cpu_unless_asked(no_gpu):
    cfg, g = _tiny()
    params = gat.init_gat_model(cfg, device="cpu")
    trainer = Trainer(cfg=cfg, task=make_task("Cora"), learning_rate=0.01,
                      max_epochs=1)
    with pytest.raises(RuntimeError, match="cuda"):
        gat.gat_model_apply(params, cfg, g)
    with pytest.raises(RuntimeError, match="cuda"):
        gat.init_gat_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        trainer.fit(g)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_jax({"layers": [{"W": np.zeros((4, 3))}]})
    with pytest.raises(RuntimeError, match="cuda"):
        trainer.fit_epochs([g], [g])
    for dataset in ("Cora", "PPI", "PATTERN"):
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["--dataset", dataset, "--num_epochs", "1"])
    # asked for by name, the CPU runs
    out = gat.gat_model_apply(params, cfg, g, device="cpu")
    assert out.shape == (g.num_nodes, 3) and torch.isfinite(out).all()


def test_cli_refuses_unported_flags():
    with pytest.raises(NotImplementedError, match="full graph"):
        cli.main(["--device", "cpu", "--dataset", "PPI", "--reorder",
                  "cluster"])
    for flags in (["--dataset", "PPI", "--attention_penalty", "0.1"],
                  ["--dataset", "Cora", "--attention_reward", "0.1"],
                  ["--dataset", "Cora", "--sampling_fanouts", "8,8"],
                  ["--dataset", "PPI", "--exec_type", "load"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cli.main(["--device", "cpu"] + flags)
    with pytest.raises(NotImplementedError, match="full graph"):
        cli.main(["--device", "cpu", "--dataset", "PATTERN", "--reorder",
                  "rcm"])


def test_new_wrappers_count_no_launch_on_cpu_tensors():
    """The parts backward modes and the sorted segment sum have their own
    counters, and the plain versions touch none of them."""
    from gat_pytorch_tpu_torch.ops import segment as seg
    from gat_pytorch_tpu_torch.ops.cuda import build
    from gat_pytorch_tpu_torch.ops.cuda import segment_sum as ss
    assert {"v5_backward_parts", "window_backward_parts",
            "segment_sum_sorted"} <= set(build.LAUNCHES)
    before = dict(build.LAUNCHES)
    ids = torch.tensor([0, 0, 2, 5], dtype=torch.int32)
    vals = torch.arange(8, dtype=torch.float32).reshape(4, 2)
    out = ss.segment_sum_sorted(vals, ids, 4)       # id 5 is dropped
    assert torch.equal(out, torch.tensor([[2., 4.], [0., 0.], [4., 5.],
                                          [0., 0.]]))
    table = torch.ones((4, 2), requires_grad=True)
    seg.gather_rows_sorted_grad(table, ids[:3], 4).sum().backward()
    assert torch.equal(table.grad[:, 0], torch.tensor([2., 0., 1., 0.]))
    assert build.LAUNCHES == before


def test_table_op_wrapper_launches_or_raises_on_a_cuda_tensor():
    """A wrapper takes its plain version only for a CPU tensor: the
    dispatch reads the tensor's device and nothing else."""
    from gat_pytorch_tpu_torch.ops.cuda import build
    from gat_pytorch_tpu_torch.ops.cuda import table_attention as ta
    assert "table_attention" in build.SOURCES
    assert {"table_forward", "table_backward"} <= set(build.LAUNCHES)
    before = dict(build.LAUNCHES)
    logits = torch.zeros((4, 2))
    h = torch.ones((3, 6))
    ids = torch.tensor([0, 1, 1, 2], dtype=torch.int32)
    out, den = ta.table_forward(logits, h, None, ids, ids, 3, 4, 0.0)
    assert torch.equal(den, torch.tensor([[1., 1.], [2., 2.], [1., 1.]]))
    assert torch.allclose(out, torch.ones((3, 6)))
    assert build.LAUNCHES == before          # the plain version counts none
