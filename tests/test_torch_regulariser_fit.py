"""The attention regulariser in training: the port's Trainer and its
edge-sharded step and fit, against the JAX package on the CPU.

  * Trainer.fit, dropout 0, attention_reward 0.1, from the JAX Trainer's
    own initial parameters: every epoch's train_loss (the total, the
    regulariser included), train_attention_norm and val_loss against the
    JAX Trainer.fit's rows, rtol 1e-4 (the port's kernel path, v5 and
    under paper_faithful the table op; the JAX package's "auto" backend
    is "xla" on the CPU);
  * one sharded train step with attention_penalty 0.05 on two gloo ranks
    (tests/torch_ranks.py, a (1, 2) mesh: the edge axis cut in two)
    against the JAX package's make_sharded_train_step on its (1, 2) mesh
    (tests/test_parallel.py test_sharded_train_step_matches_unsharded)
    and against the single-device port: the loss and the norm rtol 1e-5,
    the parameters after SGD 0.1 rtol 1e-4 / atol 1e-6, the gradients
    rtol 1e-4 / atol 1e-6, bit for bit equal on both ranks;
  * Trainer.fit_sharded with attention_penalty on the two ranks against
    the single-device port's fit_epochs, rows rtol 1e-4.
The CLI's new flags: tests/test_torch_regulariser_cli.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gat_pytorch_tpu import parallel as jpar
from gat_pytorch_tpu.models import gat as jgat
from gat_pytorch_tpu.train.tasks import make_task as jmake_task
from gat_pytorch_tpu.train.trainer import Trainer as JTrainer
from gat_pytorch_tpu.train.trainer import TrainState
from gat_pytorch_tpu_torch.models import gat as tgat
from gat_pytorch_tpu_torch.train.tasks import make_task as tmake_task
from gat_pytorch_tpu_torch.train.trainer import Trainer as TTrainer
from gat_pytorch_tpu_torch.utils.convert import params_from_jax

from . import torch_ranks as R
from .test_parallel import tiny_batch
from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_model import build
from .test_torch_parallel import CFG, flat, graph_at, np_tree

PENALTY = 0.05
STEP_LR, FIT_LR, FIT_EPOCHS = 0.1, 1e-2, 4


@pytest.mark.parametrize("extra,path", [({}, "v5"),
                                        ({"paper_faithful": True},
                                         "v4_table")])
def test_fit_with_attention_reward_matches_jax_fit(extra, path):
    jcfg, tcfg, jg, tg, _, _ = build("cora", **extra)
    common = dict(learning_rate=0.005, max_epochs=4, patience=100, seed=0)
    jtr = JTrainer(cfg=jcfg, task=jmake_task("Cora", attention_reward=0.1),
                   **common)
    want = jtr.fit([jg], [jg]).history
    # the parameters the JAX Trainer drew (init_state)
    _, init_rng = jax.random.split(jax.random.key(0))
    params = params_from_jax(np_tree(jgat.init_gat_model(init_rng, jcfg)),
                             device="cpu")
    ttr = TTrainer(cfg=tcfg, task=tmake_task("Cora", attention_reward=0.1),
                   device="cpu", **common)
    tgat.PATH_TRACE.clear()
    got = ttr.fit(tg, params=params).history
    assert set(tgat.PATH_TRACE) == {path}
    assert len(got) == len(want) == 4
    for jrow, trow in zip(want, got):
        assert trow["train_attention_norm"] > 0.0
        for k in ("train_loss", "train_attention_norm", "val_loss"):
            np.testing.assert_allclose(trow[k], jrow[k], rtol=1e-4,
                                       err_msg=k)
    assert got[-1]["train_loss"] < got[0]["train_loss"]
    # without the regulariser the row's norm is 0
    plain = dataclasses.replace(ttr, task=tmake_task("Cora"), max_epochs=1)
    assert plain.fit(tg, params=params).history[0][
        "train_attention_norm"] == 0.0


def single_device_step(cfg, graphs, params, task):
    """The port's unsharded regularised loss over the batch (the mean of
    the per-graph losses) and its gradients, on the full graphs."""
    trainer = TTrainer(cfg=cfg, task=task, learning_rate=0.0, device="cpu")
    loss, norm = 0.0, 0.0
    for g in graphs:
        total, _, n = trainer.train_loss(params, g, training=False)
        loss, norm = loss + total, norm + n.detach()
    loss = loss / len(graphs)
    loss.backward()
    return (float(loss.detach()), float(norm) / len(graphs),
            [p.grad.numpy() for p in tgat.parameters(params)])


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """(JAX inputs, each rank's results) of the step and the fit on a
    (1, 2) mesh of two gloo ranks."""
    cfg = jgat.GATConfig(**CFG)
    batch = tiny_batch(2, seed=3)
    step_params = jgat.init_gat_model(jax.random.key(1), cfg)
    fit_graphs = [graph_at(tiny_batch(1, seed=i), 0) for i in range(6)]
    _, init_rng = jax.random.split(jax.random.key(0))
    fit_params = jgat.init_gat_model(init_rng, cfg)
    task_kw = {"attention_penalty": PENALTY}
    jobs = [
        dict(name="step", kind="step", mesh=(1, 2), cfg=CFG, task="PPI",
             task_kw=task_kw, lr=STEP_LR,
             graphs=[R.numpy_graph(graph_at(batch, i)) for i in range(2)],
             params=np_tree(step_params)),
        dict(name="fit", kind="fit", mesh=(1, 2), cfg=CFG, task="PPI",
             task_kw=task_kw, lr=FIT_LR, epochs=FIT_EPOCHS, n_train=4,
             backend="kernel",
             graphs=[R.numpy_graph(g) for g in fit_graphs],
             params=np_tree(fit_params))]
    got = R.spawn(jobs, 2, str(tmp_path_factory.mktemp("world2")))
    return dict(cfg=cfg, batch=batch, step_params=step_params,
                fit_graphs=fit_graphs, fit_params=fit_params), got


def test_sharded_step_with_penalty_matches_jax_and_single_device(cases):
    inp, got = cases
    cfg, batch, params = inp["cfg"], inp["batch"], inp["step_params"]
    task = jmake_task("PPI", attention_penalty=PENALTY)
    tx = optax.sgd(STEP_LR)
    mesh = jpar.make_mesh(data=1, edge=2, devices=jax.devices()[:2])
    step = jpar.make_sharded_train_step(cfg, task, tx, mesh)
    state = TrainState(params=params, opt_state=tx.init(params),
                       rng=jax.random.key(2), step=jnp.int32(0))
    state_s, mets_s = step(jpar.replicated(state, mesh),
                           jpar.put_batch(batch, mesh))
    assert float(mets_s["train_attention_norm"]) > 0.0
    graphs = [R.graph_of(R.numpy_graph(graph_at(batch, i)))
              for i in range(2)]
    loss1, norm1, grads1 = single_device_step(
        tgat.GATConfig(**CFG), graphs, R.params_of(np_tree(params)),
        tmake_task("PPI", attention_penalty=PENALTY))
    np.testing.assert_allclose(loss1, float(mets_s["train_loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(norm1, float(mets_s["train_attention_norm"]),
                               rtol=1e-5)
    want_params = flat(state_s.params)
    for backend in ("kernel", "segment"):
        for rank in got:
            run = rank["step"][backend][0]
            np.testing.assert_allclose(float(run["loss"]), loss1, rtol=1e-5)
            np.testing.assert_allclose(
                float(run["metrics"]["attention_norm"]),
                float(mets_s["train_attention_norm"]), rtol=1e-5)
            for i, (a, b) in enumerate(zip(run["params"], want_params)):
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                           atol=1e-6, err_msg=f"param {i}")
            for i, (a, b) in enumerate(zip(run["grads"], grads1)):
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                           atol=1e-6,
                                           err_msg=f"{backend} grad {i}")
        first = got[0]["step"][backend][0]
        for rank in got[1:]:
            run = rank["step"][backend][0]
            assert torch.equal(run["loss"], first["loss"])
            for a, b in zip(run["grads"] + run["params"],
                            first["grads"] + first["params"]):
                assert torch.equal(a, b)


def test_fit_sharded_with_penalty_matches_the_single_device_fit(cases):
    inp, got = cases
    graphs = [R.graph_of(R.numpy_graph(g)) for g in inp["fit_graphs"]]
    trainer = TTrainer(cfg=tgat.GATConfig(**CFG),
                       task=tmake_task("PPI", attention_penalty=PENALTY),
                       learning_rate=FIT_LR, max_epochs=FIT_EPOCHS,
                       patience=100, seed=0, device="cpu")
    want = trainer.fit_epochs(
        graphs[:4], graphs[4:],
        params=R.params_of(np_tree(inp["fit_params"]))).history
    for rank in got:
        hist = rank["fit"]["history"]
        assert len(hist) == FIT_EPOCHS
        for k in ("train_loss", "train_attention_norm", "val_loss",
                  "train_f1", "val_f1"):
            np.testing.assert_allclose([r[k] for r in hist],
                                       [r[k] for r in want], rtol=1e-4,
                                       err_msg=k)
        assert hist[0]["train_attention_norm"] > 0.0
        assert hist == got[0]["fit"]["history"]
