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


def test_ops_and_models_import_nothing_of_parallel():
    """The layers sit in order: ops/ (the collectives among them) and
    models/ import nothing of parallel/, which imports the model; no
    function-level import gets round that."""
    for sub in ("ops", "models"):
        for dirpath, _, names in os.walk(os.path.join(PKG_DIR, sub)):
            for n in names:
                if not n.endswith(".py"):
                    continue
                path = os.path.join(dirpath, n)
                for node in ast.walk(ast.parse(open(path).read(), path)):
                    mods = ([a.name for a in node.names]
                            if isinstance(node, ast.Import) else
                            [node.module or ""]
                            if isinstance(node, ast.ImportFrom) else [])
                    assert not any("parallel" in m.split(".")
                                   for m in mods), f"{path}: {mods}"
    code = ("import sys\n"
            "import gat_pytorch_tpu_torch.models.gat\n"
            "import gat_pytorch_tpu_torch.ops.segment\n"
            "assert not any(k.startswith('gat_pytorch_tpu_torch.parallel')\n"
            "               for k in sys.modules), sorted(sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


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
    for flags in (["--dataset", "Cora", "--sampling_fanouts", "8,8"],
                  ["--dataset", "Cora", "--checkpoint_dir", "ckpt"],
                  ["--dataset", "Cora", "--metrics_file", "m.jsonl"],
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


def test_parallel_and_v2_modules_are_among_the_checked():
    """The jax-free import check above walks every module of the port:
    the sharded path's too."""
    mods = set(_modules())
    assert {"gat_pytorch_tpu_torch.parallel.mesh",
            "gat_pytorch_tpu_torch.ops.collectives",
            "gat_pytorch_tpu_torch.parallel.sharding",
            "gat_pytorch_tpu_torch.parallel.train",
            "gat_pytorch_tpu_torch.parallel.multihost",
            "gat_pytorch_tpu_torch.ops.cuda.segment_attention"} <= mods


def test_sharded_entry_points_refuse_cpu_unless_asked(no_gpu, tmp_path):
    from gat_pytorch_tpu_torch.parallel import multihost
    cfg, g = _tiny()
    trainer = Trainer(cfg=cfg, task=make_task("Cora"), learning_rate=0.01,
                      max_epochs=1)
    with pytest.raises(RuntimeError, match="cuda"):
        trainer.fit_sharded(None, [g], [g])
    with pytest.raises(RuntimeError, match="cuda"):
        multihost.initialize(f"file://{tmp_path}/store", 1, 0)
    # one process and no group asked for: nothing to join
    assert multihost.initialize() is False


def _mesh_here(data=1, edge=1):
    """A Mesh value as rank 0 sees it, without process groups (for what
    is checked before any collective)."""
    from gat_pytorch_tpu_torch.parallel import Axis, Mesh
    return Mesh(data=Axis("data", data, 0, None),
                edge=Axis("edge", edge, 0, None))


def test_sharded_path_refuses_what_is_not_ported():
    from gat_pytorch_tpu_torch.parallel import make_sharded_train_step
    cfg, g = _tiny()
    mesh = _mesh_here()
    params = gat.init_gat_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_sharded_train_step(cfg, make_task("Cora"), mesh,
                                dst_owned=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_sharded_train_step(
            cfg, make_task("Cora", attention_reward=0.1), mesh,
            dst_owned=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        gat.gat_model_apply(params, cfg, g, device="cpu",
                            edge_axis=mesh.edge, dst_owned=True)


def test_edge_shards_cut_the_dst_sorted_edges():
    """Each shard is a contiguous E/K slice with its own real-edge count
    and stable sender order; E must divide, and a batch over the data
    axis too."""
    from gat_pytorch_tpu_torch.parallel import edge_shard, shard_batch
    _, g = _tiny()
    k = 4
    assert g.num_edges % k == 0 and g.num_edges % 3 != 0
    s = g.num_edges // k
    shards = [edge_shard(g, i, k) for i in range(k)]
    assert torch.equal(torch.cat([sh.receivers for sh in shards]),
                       g.receivers)
    assert sum(sh.num_real_edges for sh in shards) == g.num_real_edges
    for i, sh in enumerate(shards):
        assert sh.num_edges == s
        assert sh.num_real_edges == min(max(g.num_real_edges - i * s, 0), s)
        assert bool(sh.edge_mask[:sh.num_real_edges].all())
        assert not bool(sh.edge_mask[sh.num_real_edges:].any())
        assert torch.equal(sh.senders[sh.src_order.long()],
                           torch.sort(sh.senders, stable=True).values)
        # the real edges first: the sharded layer gathers them alone
        real = sh.src_order[:sh.num_real_edges].long()
        assert bool((real < sh.num_real_edges).all())
        assert sh.x is g.x and sh.block_layout is None
    with pytest.raises(ValueError, match="divide"):
        edge_shard(g, 0, 3)
    with pytest.raises(ValueError, match="divide"):
        shard_batch([g, g, g], _mesh_here(data=2))


def test_v2_wrappers_count_no_launch_on_cpu_tensors():
    """The v2 entries have their counters (the forward's bfloat16 mode
    apart), and their plain versions, which a CPU tensor takes, touch
    none of them."""
    from gat_pytorch_tpu_torch.ops.cuda import build
    from gat_pytorch_tpu_torch.ops.cuda import segment_attention as sa
    from gat_pytorch_tpu_torch.ops.cuda.rounding import V2_BF16
    assert "segment_attention" in build.SOURCES
    assert {"v2_forward", "v2_backward", "v2_forward_bf16"} <= \
        set(build.LAUNCHES)
    before = dict(build.LAUNCHES)
    logits = torch.zeros((4, 2))
    h_src = torch.ones((4, 6))
    rcv = torch.tensor([0, 1, 1, 2], dtype=torch.int32)
    for rnd in (V2_BF16, sa.v2_rounding()):
        num, den = sa.v2_forward(logits, h_src, None, rcv, 4, 4, 0.0, False,
                                 rnd)
        assert torch.equal(den, torch.tensor([[1., 1.], [2., 2.], [1., 1.],
                                              [0., 0.]]))
        assert torch.equal(num[:, 0], torch.tensor([1., 2., 1., 0.]))
    d_logits, d_h, d_drop = sa.v2_backward(
        logits, h_src, None, rcv, 4, 0.0, torch.ones((4, 6)), None,
        torch.zeros((4, 2)), False, False)
    assert torch.equal(d_logits, torch.full((4, 2), 3.0)) and d_drop is None
    assert build.LAUNCHES == before
