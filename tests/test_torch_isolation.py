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
        cli.main(["--dataset", "Cora", "--num_epochs", "1"])
    # asked for by name, the CPU runs
    out = gat.gat_model_apply(params, cfg, g, device="cpu")
    assert out.shape == (g.num_nodes, 3) and torch.isfinite(out).all()


def test_cli_refuses_unported_flags():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["--device", "cpu", "--reorder", "cluster"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["--device", "cpu", "--dataset", "PPI"])
