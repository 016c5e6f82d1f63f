"""Metrics logging (train/logging.py, the Trainer's histograms) against
the JAX package on the CPU.

  * the JSONL stream holds one {"step": epoch, **row} line per history row;
  * TensorBoard event files hold the scalar and the histogram tags;
  * through a recording logger, with dropout 0 and the JAX initial
    parameters carried over: the gradient histograms (tags grad/<tree
    path>) equal the JAX Trainer's at 1e-5, and the attention histograms
    (alpha x in-degree over the real edges, and that minus 1) its
    _log_attention_histograms's tags and values at 1e-5;
  * a fit with track_grads gives the bits of one without (the histogram's
    dropout masks come from a clone of the fit's generator).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.models import gat as jgat
from gat_pytorch_tpu.train.tasks import make_task as jmake_task
from gat_pytorch_tpu.train.trainer import Trainer as JTrainer
from gat_pytorch_tpu_torch.models import gat as tgat
from gat_pytorch_tpu_torch.train.logging import MetricsLogger
from gat_pytorch_tpu_torch.train.tasks import make_task
from gat_pytorch_tpu_torch.train.trainer import Trainer
from gat_pytorch_tpu_torch.utils.convert import params_from_jax

from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_model import build


class Recorder:
    """A logger that keeps what it is given."""

    def __init__(self):
        self.rows, self.hist = [], {}

    def log_scalars(self, step, row):
        self.rows.append((step, dict(row)))

    def log_histogram(self, step, tag, values):
        self.hist[(step, tag)] = np.asarray(values)

    def close(self):
        pass


def _recorded(monkeypatch, cls):
    rec = Recorder()
    monkeypatch.setattr(cls, "_logger", lambda self: rec)
    return rec


def test_jsonl_rows_equal_the_history(tmp_path):
    _, tcfg, _, tg, _, tparams = build("cora")
    path = tmp_path / "m.jsonl"
    tr = Trainer(cfg=tcfg, task=make_task("Cora"), learning_rate=5e-3,
                 max_epochs=3, metrics_file=str(path), device="cpu")
    res = tr.fit(tg, params=tparams)
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert rows == [{"step": r["epoch"], **r} for r in res.history]
    # a second run appends
    Trainer(cfg=tcfg, task=make_task("Cora"), learning_rate=5e-3,
            max_epochs=1, metrics_file=str(path), device="cpu").fit(tg)
    assert len(path.read_text().splitlines()) == 4


def test_tensorboard_events_hold_scalars_and_histograms(tmp_path):
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    _, tcfg, _, tg, _, tparams = build("cora")
    tr = Trainer(cfg=tcfg, task=make_task("Cora"), learning_rate=5e-3,
                 max_epochs=2, tensorboard_dir=str(tmp_path),
                 track_grads=True, device="cpu")
    res = tr.fit(tg, params=tparams)
    acc = EventAccumulator(str(tmp_path), size_guidance={"histograms": 0,
                                                         "scalars": 0})
    acc.Reload()
    tags = acc.Tags()
    assert {"train_loss", "val_loss", "val_acc", "lr"} <= \
        set(tags["scalars"])
    assert "epoch" not in tags["scalars"]
    want_hist = {"grad/layers/0/W", "grad/layers/0/a", "grad/layers/1/W",
                 "grad/layers/1/a", "unnormalised_attention_layer_0",
                 "attention_minus_const_layer_1"}
    assert want_hist <= set(tags["histograms"])
    losses = [ev.value for ev in acc.Scalars("train_loss")]
    np.testing.assert_allclose(losses,
                               [r["train_loss"] for r in res.history],
                               rtol=1e-6)
    assert [ev.step for ev in acc.Histograms("grad/layers/0/W")] == [0, 1]
    with MetricsLogger() as nothing:       # neither stream: a no-op
        nothing.log_scalars(0, {"a": 1.0})
        nothing.log_histogram(0, "h", [1.0])


def test_histograms_match_the_jax_trainer(tmp_path, monkeypatch):
    """One epoch: the histograms are taken after its Adam step, where the
    two packages' parameters still agree to float32 rounding (each later
    step carries the difference on, as the fit tests' rtol 1e-4 allows)."""
    jcfg, tcfg, jg, tg, _, _ = build("cora")
    common = dict(learning_rate=5e-3, max_epochs=1, patience=100, seed=0,
                  tensorboard_dir=str(tmp_path), track_grads=True)
    jrec = _recorded(monkeypatch, JTrainer)
    JTrainer(cfg=jcfg, task=jmake_task("Cora"), **common).fit([jg], [jg])
    _, init_rng = jax.random.split(jax.random.key(0))
    jparams = jgat.init_gat_model(init_rng, jcfg)
    trec = _recorded(monkeypatch, Trainer)
    Trainer(cfg=tcfg, task=make_task("Cora"), device="cpu", **common).fit(
        tg, params=params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                                   device="cpu"))
    assert sorted(trec.hist) == sorted(jrec.hist)
    tags = {tag for _, tag in trec.hist}
    assert {"grad/layers/0/W", "grad/layers/1/a",
            "unnormalised_attention_layer_0",
            "attention_minus_const_layer_1"} <= tags
    for key, want in jrec.hist.items():
        got = trec.hist[key]
        assert got.shape == want.shape, key
        scale = max(1.0, float(np.abs(want).max())) if \
            key[1].startswith(("unnormalised", "attention")) else \
            float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                                   err_msg=str(key))
    # unnormalised attention of a real graph averages about 1 an edge
    vals = trec.hist[(0, "unnormalised_attention_layer_0")]
    assert vals.size > 0 and 0.2 < float(vals.mean()) < 5.0
    assert [s for s, _ in trec.rows] == [0]


def test_track_grads_leaves_the_fit_bits_unchanged(tmp_path, monkeypatch):
    """Dropout 0.6 on: the gradient histograms run the model in training
    mode every epoch, from a clone of the fit's generator."""
    _, tcfg, _, tg, _, tparams = build("cora")
    tcfg = dataclasses.replace(tcfg, dropout=0.6)
    rec = _recorded(monkeypatch, Trainer)
    runs = []
    for track in (True, False):
        tr = Trainer(cfg=tcfg, task=make_task("Cora"), learning_rate=5e-3,
                     max_epochs=3, seed=0, device="cpu",
                     tensorboard_dir=str(tmp_path), track_grads=track)
        params = {g: [{k: v.detach().clone().requires_grad_(True)
                       for k, v in d.items()} for d in tparams[g]]
                  for g in tparams}
        runs.append(tr.fit(tg, params=params))
    assert any(tag.startswith("grad/") for _, tag in rec.hist)
    a, b = runs
    assert a.history == b.history
    for x, y in zip(tgat.parameters(a.final_params),
                    tgat.parameters(b.final_params)):
        assert torch.equal(x, y)
