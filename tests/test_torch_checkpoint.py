"""Checkpoints and resume (Trainer.save_checkpoint, load_checkpoint,
resume_state, the fit's best and epoch-<E> files) on the CPU.

  * a resumed run continues to the same bits as the run that was never
    interrupted (the Adam state and the dropout generator's state
    restored, not re-seeded), dropout on;
  * inference restore, from a file or from a directory holding "best";
  * epoch-<E> snapshots every N epochs (1-based), none between;
  * an interrupted save leaves the previous checkpoint whole;
  * the JAX Trainer.fit and the port's fit on one problem (dropout 0, the
    JAX initial parameters carried over) pick the same best epoch, and
    the port's saved best parameters are within 1e-5 of the ones the JAX
    package's load_checkpoint restores from its own Orbax files;
  * a fit_sharded on two gloo ranks writes its checkpoints once, on
    rank 0.
"""

import os

import jax
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.models import gat as jgat
from gat_pytorch_tpu.train.tasks import make_task as jmake_task
from gat_pytorch_tpu.train.trainer import Trainer as JTrainer
from gat_pytorch_tpu_torch.graph import transforms as TT
from gat_pytorch_tpu_torch.models import gat as tgat
from gat_pytorch_tpu_torch.train import optim as O
from gat_pytorch_tpu_torch.train.tasks import make_task
from gat_pytorch_tpu_torch.train.trainer import Trainer, TrainState
from gat_pytorch_tpu_torch.utils.convert import params_from_jax

from . import torch_ranks as R
from .test_parallel import tiny_batch
from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_model import build
from .test_torch_parallel import CFG, graph_at, np_tree


@pytest.fixture()
def problem():
    rng = np.random.default_rng(1)
    n = 64
    senders = np.repeat(np.arange(n), 4)
    receivers = rng.integers(0, n, n * 4)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    y = rng.integers(0, 3, n).astype(np.int32)
    m = np.ones(n, bool)
    graph = TT.canonicalize(x, senders, receivers, y=y, train_mask=m,
                            val_mask=m, test_mask=m)
    cfg = tgat.GATConfig(
        num_input_node_features=8, num_layers=2,
        num_heads_per_layer=[2, 1], heads_concat_per_layer=[True, False],
        head_output_features_per_layer=[8, 8, 3], num_classes=3,
        add_skip_connection=[False, False], dropout=0.5)
    return graph, cfg


def _trainer(cfg, tmp_path, **kw):
    return Trainer(cfg=cfg, task=make_task("Cora"), learning_rate=1e-2,
                   weight_decay=5e-4, checkpoint_dir=str(tmp_path), seed=3,
                   device="cpu", **kw)


def _state(tr):
    """A fresh run's TrainState, as fit_epochs starts it."""
    params = tr.init_params()
    return TrainState(params, O.adam_l2(tgat.parameters(params),
                                        tr.learning_rate, tr.weight_decay),
                      tr.dropout_generator())


def test_full_state_resume_continues_to_the_same_bits(problem, tmp_path):
    graph, cfg = problem
    tr = _trainer(cfg, tmp_path, max_epochs=5)
    state = _state(tr)
    for _ in range(4):
        tr.train_step(state.params, state.opt, graph, state.generator)
    tr.save_checkpoint(state, epoch=3, best_val=0.5)
    assert sorted(os.listdir(tmp_path)) == ["best"]    # no temporary left

    losses_direct = [tr.train_step(state.params, state.opt, graph,
                                   state.generator)[0] for _ in range(3)]
    resumed = tr.resume_state()
    assert resumed.step == 4 and state.step == 7
    assert resumed.opt.param_groups[0]["lr"] == 1e-2
    losses_resumed = [tr.train_step(resumed.params, resumed.opt, graph,
                                    resumed.generator)[0] for _ in range(3)]
    assert all(torch.equal(a, b)
               for a, b in zip(losses_direct, losses_resumed))
    for a, b in zip(tgat.parameters(state.params),
                    tgat.parameters(resumed.params)):
        assert torch.equal(a, b)
    # a re-seeded generator draws other masks: the restored state counts
    reseeded = tr.resume_state()
    reseeded.generator = tr.dropout_generator()
    tr.train_step(reseeded.params, reseeded.opt, graph, reseeded.generator)
    assert not torch.equal(tgat.parameters(reseeded.params)[0],
                           tgat.parameters(tr.resume_state().params)[0])


def test_inference_restore_and_payload(problem, tmp_path):
    graph, cfg = problem
    tr = _trainer(cfg, tmp_path)
    state = _state(tr)
    params = state.params
    tr.save_checkpoint(state, epoch=0, best_val=1.0)
    for where in (str(tmp_path), str(tmp_path / "best")):
        restored = Trainer.load_checkpoint(where, device="cpu")
        assert restored["epoch"] == 0 and restored["step"] == 0
        assert restored["best_val_loss"] == 1.0
        out_a = tgat.gat_model_apply(params, cfg, graph, device="cpu")
        out_b = tgat.gat_model_apply(restored["params"], cfg, graph,
                                     device="cpu")
        assert torch.equal(out_a, out_b)
        assert not any(p.requires_grad
                       for p in tgat.parameters(restored["params"]))
    with pytest.raises(FileNotFoundError):
        Trainer.load_checkpoint(str(tmp_path / "nothing"), device="cpu")


def test_epoch_snapshots_written_and_loadable(problem, tmp_path):
    graph, cfg = problem
    tr = _trainer(cfg, tmp_path, max_epochs=6, checkpoint_every_n_epochs=2)
    res = tr.fit(graph)
    assert len(res.history) == 6
    assert sorted(os.listdir(tmp_path)) == ["best", "epoch-2", "epoch-4",
                                            "epoch-6"]
    for e in (2, 4, 6):
        restored = Trainer.load_checkpoint(str(tmp_path / f"epoch-{e}"),
                                           device="cpu")
        assert restored["epoch"] == e - 1 and restored["step"] == e
    best = Trainer.load_checkpoint(str(tmp_path), device="cpu")
    assert best["epoch"] == res.best_epoch
    assert best["best_val_loss"] == pytest.approx(res.best_val_loss)
    for a, b in zip(tgat.parameters(best["params"]),
                    tgat.parameters(res.params)):
        assert torch.equal(a, b)
    final = Trainer.load_checkpoint(str(tmp_path / "epoch-6"), device="cpu")
    for a, b in zip(tgat.parameters(final["params"]),
                    tgat.parameters(res.final_params)):
        assert torch.equal(a, b)


def test_an_interrupted_save_leaves_the_checkpoint_whole(problem, tmp_path,
                                                         monkeypatch):
    graph, cfg = problem
    tr = _trainer(cfg, tmp_path)
    state = _state(tr)
    tr.save_checkpoint(state, epoch=0, best_val=1.0)
    save = torch.save

    def torn(obj, path):
        save({"torn": True}, path)      # a partial file, then the failure
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn)
    with pytest.raises(OSError, match="disk full"):
        tr.save_checkpoint(state, epoch=5, best_val=0.1)
    assert sorted(os.listdir(tmp_path)) == ["best"]
    assert Trainer.load_checkpoint(str(tmp_path), device="cpu")["epoch"] == 0


def test_best_checkpoint_matches_the_jax_fit(tmp_path):
    jcfg, tcfg, jg, tg, _, _ = build("cora")
    common = dict(learning_rate=0.005, max_epochs=5, patience=100, seed=0)
    jtr = JTrainer(cfg=jcfg, task=jmake_task("Cora"),
                   checkpoint_dir=str(tmp_path / "jax"), **common)
    jres = jtr.fit([jg], [jg])
    _, init_rng = jax.random.split(jax.random.key(0))
    jparams = jgat.init_gat_model(init_rng, jcfg)
    ttr = Trainer(cfg=tcfg, task=make_task("Cora"),
                  checkpoint_dir=str(tmp_path / "torch"), device="cpu",
                  **common)
    tres = ttr.fit(tg, params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu"))
    assert tres.best_epoch == jres.best_epoch
    want = JTrainer.load_checkpoint(str(tmp_path / "jax"), jparams)
    got = Trainer.load_checkpoint(str(tmp_path / "torch"), device="cpu")
    assert got["epoch"] == int(np.asarray(want["epoch"]))
    np.testing.assert_allclose(got["best_val_loss"],
                               float(np.asarray(want["best_val_loss"])),
                               rtol=1e-5)
    for group in ("layers", "skips"):
        for i, (t, j) in enumerate(zip(got["params"][group],
                                       want["params"][group])):
            assert sorted(t) == sorted(j)
            for k in t:
                np.testing.assert_allclose(
                    t[k].numpy(), np.asarray(j[k]), rtol=1e-5, atol=1e-5,
                    err_msg=f"{group}[{i}].{k}")


def test_sharded_fit_writes_once(tmp_path_factory):
    """Two gloo ranks on a (1, 2) mesh, every rank asked to write to a
    directory of its own: only rank 0's holds checkpoints, best and
    epoch-2 and -4, equal to the fit's final parameters."""
    tmp = tmp_path_factory.mktemp("ckpt2")
    _, init_rng = jax.random.split(jax.random.key(0))
    params = np_tree(jgat.init_gat_model(init_rng, jgat.GATConfig(**CFG)))
    graphs = [R.numpy_graph(graph_at(tiny_batch(1, seed=i), 0))
              for i in range(5)]
    job = dict(kind="fit", name="ckpt", mesh=(1, 2), cfg=CFG, task="PPI",
               lr=1e-2, epochs=4, n_train=4, backend="kernel", graphs=graphs,
               params=params, every=2,
               checkpoint_dir=str(tmp / "rank{rank}"))
    got = R.spawn([job], 2, str(tmp))
    assert got[0]["ckpt"]["files"] == ["best", "epoch-2", "epoch-4"]
    assert got[1]["ckpt"]["files"] == []
    assert not os.path.exists(tmp / "rank1")
    final = Trainer.load_checkpoint(str(tmp / "rank0" / "epoch-4"),
                                    device="cpu")
    for a, b in zip(tgat.parameters(final["params"]),
                    got[0]["ckpt"]["params"]):
        assert torch.equal(a, b)
    tr = Trainer(cfg=tgat.GATConfig(**CFG), task=make_task("PPI"),
                 learning_rate=1e-2, device="cpu")
    with pytest.raises(ValueError, match="rank 0"):
        tr.resume_state(str(tmp / "rank0" / "epoch-4"))
