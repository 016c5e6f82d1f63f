"""The inductive training path (PPI, PATTERN) against the JAX package.

The same numpy inputs go through both packages:
  * data: the stand-in graphs, block_diagonal and an epoch of
    InductiveBatcher batches must be array-equal (ragged last batch and
    buckets included);
  * metrics and tasks: to 1e-6;
  * the epoch-batched fit: dropout is 0 on PPI and PATTERN, so with the
    parameters carried over by params_from_jax two epochs over four small
    graphs must give the JAX fit_scanned_epochs history to rtol 1e-4
    (float32 sums in another order, carried through Adam steps);
  * the plateau schedule halves the rate at the same epoch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.data import datasets as jdatasets
from gat_pytorch_tpu.data import loader as jloader
from gat_pytorch_tpu.data import synthetic as jsyn
from gat_pytorch_tpu.graph import graphcore_binding as jcore
from gat_pytorch_tpu.models import gat as jgat
from gat_pytorch_tpu.train import metrics as jM
from gat_pytorch_tpu.train import optim as jopt
from gat_pytorch_tpu.train import tasks as jtasks
from gat_pytorch_tpu.train.trainer import Trainer as JTrainer
from gat_pytorch_tpu.utils import config as jconfig
from gat_pytorch_tpu_torch.data import datasets as tdatasets
from gat_pytorch_tpu_torch.data import loader as tloader
from gat_pytorch_tpu_torch.data import synthetic as tsyn
from gat_pytorch_tpu_torch.graph import graphcore_binding as tcore
from gat_pytorch_tpu_torch.models import gat as tgat
from gat_pytorch_tpu_torch.train import metrics as tM
from gat_pytorch_tpu_torch.train import optim as topt
from gat_pytorch_tpu_torch.train import tasks as ttasks
from gat_pytorch_tpu_torch.train.trainer import Trainer as TTrainer
from gat_pytorch_tpu_torch.utils import config as tconfig
from gat_pytorch_tpu_torch.utils.convert import params_from_jax

from .test_torch_knobs import default_knobs  # noqa: F401

RAW_FIELDS = ("x", "senders", "receivers", "y")
GRAPH_FIELDS = ("x", "senders", "receivers", "edge_mask", "node_mask", "y",
                "graph_ids", "src_order")


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("maker,split,k", [
    ("make_ppi_like", "train", 2), ("make_ppi_like", "val", 2),
    ("make_pattern_like", "train", 5), ("make_pattern_like", "test", 3)])
def test_stand_in_graphs_are_bit_identical(maker, split, k):
    js = getattr(jsyn, maker)(split, seed=3, num_graphs=k)
    ts = getattr(tsyn, maker)(split, seed=3, num_graphs=k)
    assert len(js) == len(ts) == k
    for a, b in zip(js, ts):
        for field in RAW_FIELDS:
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and np.array_equal(x, y), field


def test_block_diagonal_matches_jax():
    rng = np.random.default_rng(0)
    node_counts = np.array([5, 1, 7])
    edge_counts = np.array([9, 0, 4])
    s = np.concatenate([rng.integers(0, n, e)
                        for n, e in zip(node_counts, edge_counts)])
    r = np.concatenate([rng.integers(0, n, e)
                        for n, e in zip(node_counts, edge_counts)])
    want = jcore.block_diagonal(s, r, node_counts, edge_counts)
    got = tcore.block_diagonal(s, r, node_counts, edge_counts)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert got[0].max() < node_counts.sum() and got[2].tolist() == (
        [0] * 5 + [1] + [2] * 7)


@pytest.mark.parametrize("maker,batch", [("make_ppi_like", 2),
                                         ("make_pattern_like", 3)])
def test_batches_equal_the_jax_package_s(maker, batch):
    """Five graphs: the last batch is ragged. Two epochs of shuffles from
    the same seed, then the unshuffled order."""
    graphs = getattr(tsyn, maker)("train", seed=1, num_graphs=5)
    jb = jloader.InductiveBatcher(getattr(jsyn, maker)("train", seed=1,
                                                       num_graphs=5),
                                  batch, seed=7)
    tb = tloader.InductiveBatcher(graphs, batch, seed=7)
    assert (tb.node_bucket, tb.edge_bucket) == (jb.node_bucket,
                                                jb.edge_bucket)
    assert len(tb) == len(jb) == -(-5 // batch)
    for epoch in range(2):
        jbs, tbs = jb.epoch(epoch), tb.epoch(epoch)
        assert len(jbs) == len(tbs) == len(tb)
        for jg, tg in zip(jbs, tbs):
            assert (tg.num_nodes, tg.num_edges) == (tb.node_bucket,
                                                    tb.edge_bucket)
            assert tg.num_real_edges == int(np.asarray(jg.edge_mask).sum())
            assert tg.train_mask is None and jg.train_mask is None
            for field in GRAPH_FIELDS:
                assert np.array_equal(getattr(tg, field).numpy(),
                                      np.asarray(getattr(jg, field))), field
            tg.validate()
    # the last batch holds fewer graphs than the others
    assert tbs[-1].node_mask.sum() < tbs[0].node_mask.sum()
    plain = tloader.InductiveBatcher(graphs, batch, shuffle=False).epoch()
    assert int(plain[0].node_mask.sum()) == sum(
        g.num_nodes for g in graphs[:batch])


def test_real_file_loaders_refuse_when_files_are_absent(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("GAT_TPU_DATA", str(tmp_path))
    for name in ("Cora", "PPI", "PATTERN"):
        assert tdatasets.is_synthetic(name) and jdatasets.is_synthetic(name)
    assert not tdatasets._ppi_available()
    assert not tdatasets._pattern_available()
    with pytest.raises(FileNotFoundError):
        tdatasets.load_ppi("train", synthetic_override=False)
    with pytest.raises(FileNotFoundError):
        tdatasets.load_pattern("val", synthetic_override=False)
    with pytest.raises(ValueError):
        tdatasets.is_synthetic("Reddit")
    assert len(tdatasets.load_pattern("val", num_graphs=2)) == 2


def test_pattern_loader_reads_torch_files(tmp_path, monkeypatch):
    """The real-file format, written here: a list of dicts."""
    rng = np.random.default_rng(0)
    items = [{"x": torch.tensor(rng.random((6, 3)), dtype=torch.float32),
              "edge_index": torch.tensor(rng.integers(0, 6, (2, 9))),
              "y": torch.tensor(rng.integers(0, 2, 6))} for _ in range(3)]
    (tmp_path / "PATTERN").mkdir()
    for split in ("train", "val", "test"):
        torch.save(items, tmp_path / "PATTERN" / f"{split}.pt")
    monkeypatch.setenv("GAT_TPU_DATA", str(tmp_path))
    assert not tdatasets.is_synthetic("PATTERN")
    got = tdatasets.load_pattern("train")
    want = jdatasets.load_pattern("train")
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        for field in RAW_FIELDS:
            assert np.array_equal(getattr(a, field), getattr(b, field))


def test_reference_configurations_equal_the_jax_package_s():
    assert sorted(tconfig.DATA_CONFIG) == sorted(jconfig.DATA_CONFIG)
    for name, tc in tconfig.DATA_CONFIG.items():
        jc = dataclasses.asdict(jconfig.DATA_CONFIG[name])
        for field, value in dataclasses.asdict(tc).items():
            if field in jc and field != "backend":   # kernel | segment here
                assert jc[field] == value, (name, field)
        assert dataclasses.asdict(tc.gat_config()) == dataclasses.asdict(
            jconfig.DATA_CONFIG[name].gat_config())


# -- metrics and tasks ----------------------------------------------------------

def _metric_inputs(seed=0, n=50, c=6):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.8
    mask[-4:] = False
    return dict(logits2=rng.normal(size=(n, c)).astype(np.float32),
                labels2=(rng.random((n, c)) < 0.3).astype(np.float32),
                logits1=rng.normal(size=n).astype(np.float32),
                labels1=rng.integers(0, 2, n).astype(np.int64), mask=mask)


def _close(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pos_weight", [1.0, 1.0 / 0.1765])
def test_bce_matches_jax_in_both_mask_forms(pos_weight):
    d = _metric_inputs()
    t = {k: torch.tensor(v) for k, v in d.items()}
    # (N, C) logits with an (N,) mask: the mean runs over rows x classes
    _close(tM.masked_bce_with_logits(t["logits2"], t["labels2"], t["mask"],
                                     pos_weight),
           jM.masked_bce_with_logits(d["logits2"], d["labels2"], d["mask"],
                                     pos_weight))
    # (N,) logits
    _close(tM.masked_bce_with_logits(t["logits1"], t["labels1"], t["mask"],
                                     pos_weight),
           jM.masked_bce_with_logits(d["logits1"], d["labels1"], d["mask"],
                                     pos_weight))
    # torch's own loss on the masked rows
    ref = torch.nn.functional.binary_cross_entropy_with_logits(
        t["logits1"][t["mask"]], t["labels1"][t["mask"]].float(),
        pos_weight=torch.tensor(pos_weight))
    _close(tM.masked_bce_with_logits(t["logits1"], t["labels1"], t["mask"],
                                     pos_weight), ref)
    nothing = torch.zeros_like(t["mask"])
    assert float(tM.masked_bce_with_logits(t["logits1"], t["labels1"],
                                           nothing)) == 0.0


def test_micro_f1_matches_jax():
    d = _metric_inputs(1)
    _close(tM.micro_f1(torch.tensor(d["logits2"]), torch.tensor(d["labels2"]),
                       torch.tensor(d["mask"])),
           jM.micro_f1(d["logits2"], d["labels2"], d["mask"]))
    zeros = torch.zeros((5, 3))
    assert float(tM.micro_f1(zeros - 1, zeros, torch.ones(5, dtype=bool))) == 0


@pytest.mark.parametrize("case", ["both", "no_positive", "no_negative",
                                  "all_predicted_positive"])
def test_balanced_accuracy_matches_jax(case):
    """Weights keyed on the prediction; a class absent from y drops out of
    the mean."""
    d = _metric_inputs(2)
    y, lg = d["labels1"], d["logits1"]
    if case == "no_positive":
        y = np.zeros_like(y)
    elif case == "no_negative":
        y = np.ones_like(y)
    elif case == "all_predicted_positive":
        lg = np.abs(lg) + 0.1
    got = tM.balanced_accuracy_predweighted(
        torch.tensor(lg), torch.tensor(y), torch.tensor(d["mask"]), 0.1765)
    want = jM.balanced_accuracy_predweighted(lg, y, d["mask"], 0.1765)
    _close(got, want)
    assert 0.0 <= float(got) <= 1.0


def _task_graphs(name):
    maker = "make_ppi_like" if name == "PPI" else "make_pattern_like"
    jb = jloader.InductiveBatcher(getattr(jsyn, maker)("val", num_graphs=2),
                                  2, shuffle=False).epoch()[0]
    tb = tloader.InductiveBatcher(getattr(tsyn, maker)("val", num_graphs=2),
                                  2, shuffle=False).epoch()[0]
    return jb, tb


@pytest.mark.parametrize("name", ["PPI", "PATTERN"])
def test_tasks_match_jax(name):
    jb, tb = _task_graphs(name)
    jt, tt = jtasks.make_task(name), ttasks.make_task(name)
    assert (tt.name, tt.squeeze_output) == (jt.name, jt.squeeze_output)
    shape = (tb.num_nodes, 121) if name == "PPI" else (tb.num_nodes,)
    logits = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    for phase in ("train", "val", "test"):
        _close(tt.loss(torch.tensor(logits), tb, phase),
               jt.loss(jnp.asarray(logits), jb, phase))
        tm = tt.metrics(torch.tensor(logits), tb, phase)
        jm = jt.metrics(jnp.asarray(logits), jb, phase)
        assert sorted(tm) == sorted(jm)
        for k in tm:
            _close(tm[k], jm[k])


def test_make_task_covers_the_five_datasets():
    for name in ("Cora", "Citeseer", "Pubmed", "PPI", "PATTERN"):
        assert ttasks.make_task(name).name == jtasks.make_task(name).name
    with pytest.raises(ValueError):
        ttasks.make_task("Reddit")
    # the regulariser's coefficient passes through as in the JAX package
    for name, kw in (("PPI", dict(attention_penalty=0.1)),
                     ("Cora", dict(attention_reward=0.1))):
        assert (ttasks.make_task(name, **kw).attention_coef
                == jtasks.make_task(name, **kw).attention_coef == 0.1)
    assert ttasks.make_task("PATTERN").attention_coef == 0.0


# -- the plateau schedule ------------------------------------------------------------

def test_plateau_schedule_matches_jax():
    """A fixed loss sequence: both halve at the same epochs, down to
    min_lr, and an improvement below the relative threshold counts as
    none."""
    seq = [1.0, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9, 0.9, 0.89999, 0.9, 0.9, 0.9,
           0.9, 0.9, 0.5, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6]
    kw = dict(factor=0.5, patience=5, min_lr=2e-3)
    j, t = jopt.ReduceLROnPlateau(**kw), topt.ReduceLROnPlateau(**kw)
    lr_j = lr_t = 0.005
    rates = []
    for v in seq:
        lr_j, lr_t = j.step(v, lr_j), t.step(v, lr_t)
        assert lr_j == lr_t
        rates.append(lr_t)
    assert rates[6] == 0.005 and rates[7] == 0.0025
    assert rates[13] == 0.002 and rates[-1] == 0.002    # min_lr holds
    p = torch.zeros(3, requires_grad=True)
    opt = topt.adam_l2([p], 0.005)
    topt.set_learning_rate(opt, 0.0025)
    assert [g["lr"] for g in opt.param_groups] == [0.0025]


# -- the epoch-batched fit -------------------------------------------------------------

FIT_CONFIGS = {
    # the PPI configuration at narrow width: skip on layer 2, mean last
    "PPI": dict(num_input_node_features=50, num_layers=3,
                num_heads_per_layer=[4, 4, 6],
                heads_concat_per_layer=[True, True, False],
                head_output_features_per_layer=[50, 16, 16, 121],
                num_classes=121, add_skip_connection=[False, True, False]),
    # the PATTERN configuration as it is
    "PATTERN": dict(num_input_node_features=3, num_layers=4,
                    num_heads_per_layer=[4, 4, 4, 1],
                    heads_concat_per_layer=[True, True, True, False],
                    head_output_features_per_layer=[3, 12, 24, 12, 1],
                    num_classes=1, add_skip_connection=[True] * 4),
}


def _small(graphs, n=60):
    """The first `n` nodes of each stand-in graph (PPI's have about 1000)."""
    out = []
    for g in graphs:
        keep = (g.senders < n) & (g.receivers < n)
        out.append(dataclasses.replace(
            g, x=g.x[:n], y=g.y[:n], senders=g.senders[keep],
            receivers=g.receivers[keep]))
    return out


@pytest.mark.parametrize("name,paper_faithful", [
    ("PPI", False), ("PPI", True), ("PATTERN", False)])
def test_fit_epochs_matches_jax_fit_scanned_epochs(name, paper_faithful):
    maker = "make_ppi_like" if name == "PPI" else "make_pattern_like"
    kw = dict(FIT_CONFIGS[name], dropout=0.0, paper_faithful=paper_faithful)
    jcfg, tcfg = jgat.GATConfig(**kw), tgat.GATConfig(**kw)
    common = dict(learning_rate=0.005, max_epochs=2, patience=100, seed=0)
    histories = []
    for pkg_syn, pkg_loader in ((jsyn, jloader), (tsyn, tloader)):
        train = _small(getattr(pkg_syn, maker)("train", num_graphs=4))
        val = _small(getattr(pkg_syn, maker)("val", num_graphs=2))
        batcher = pkg_loader.InductiveBatcher(train, 2, seed=0)
        val_data = pkg_loader.InductiveBatcher(val, 2, shuffle=False).epoch()
        if pkg_syn is jsyn:
            trainer = JTrainer(cfg=jcfg, task=jtasks.make_task(name),
                               plateau=jopt.ReduceLROnPlateau(), **common)
            result = trainer.fit_scanned_epochs(
                batcher.epoch(0), val_data, reshuffle=batcher.epoch)
            # the parameters JTrainer.init_state drew
            _, init_rng = jax.random.split(jax.random.key(0))
            jparams = jgat.init_gat_model(init_rng, jcfg)
        else:
            trainer = TTrainer(cfg=tcfg, task=ttasks.make_task(name),
                               plateau=topt.ReduceLROnPlateau(),
                               device="cpu", **common)
            tgat.PATH_TRACE.clear()
            result = trainer.fit_epochs(
                batcher.epoch(0), val_data, reshuffle=batcher.epoch,
                params=params_from_jax(
                    jax.tree_util.tree_map(np.asarray, jparams),
                    device="cpu"))
            assert set(tgat.PATH_TRACE) == {
                "v4_table" if paper_faithful else "v5"}
        assert len(result.history) == 2 and result.best_epoch in (0, 1)
        histories.append(result.history)
    jh, th = histories
    metric = "f1" if name == "PPI" else "weighted_acc"
    for jrow, trow in zip(jh, th):
        assert trow["epoch"] == jrow["epoch"] and trow["lr"] == jrow["lr"]
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(trow[k], jrow[k], rtol=1e-4, err_msg=k)
        for k in (f"train_{metric}", f"val_{metric}"):
            # a count of thresholded predictions: a logit within rounding
            # of 0 may flip one of some thousands
            np.testing.assert_allclose(trow[k], jrow[k], atol=2e-3, err_msg=k)
    assert th[1]["train_loss"] < th[0]["train_loss"]


def test_fit_epochs_plateau_early_stop_and_best_params():
    """lr 0 freezes the model: the validation loss never improves, so the
    plateau schedule halves the rate after 6 epochs, early stopping ends
    the run at its patience, and the best parameters are the first."""
    cfg = tgat.GATConfig(**FIT_CONFIGS["PATTERN"])
    graphs = _small(tsyn.make_pattern_like("train", num_graphs=3), n=30)
    batcher = tloader.InductiveBatcher(graphs, 2, seed=0)
    val = tloader.InductiveBatcher(graphs[:1], 1, shuffle=False).epoch()
    trainer = TTrainer(cfg=cfg, task=ttasks.make_task("PATTERN"),
                       learning_rate=0.0, max_epochs=50, patience=8,
                       plateau=topt.ReduceLROnPlateau(min_lr=-1.0),
                       device="cpu")
    result = trainer.fit_epochs(batcher.epoch(0), val,
                                reshuffle=batcher.epoch)
    assert result.stopped_early and len(result.history) == 9
    assert result.best_epoch == 0
    assert [r["lr"] for r in result.history] == [0.0] * 9
    for a, b in zip(tgat.parameters(result.params),
                    tgat.parameters(result.final_params)):
        assert torch.equal(a, b) and a is not b
    metrics = trainer.evaluate(result.params, val)
    np.testing.assert_allclose(metrics["test_loss"],
                               result.history[0]["val_loss"], rtol=1e-6)
    assert sorted(metrics) == ["test_loss", "test_weighted_acc"]


# -- parameters carried over -------------------------------------------------------------

@pytest.mark.parametrize("name,paper_faithful", [
    ("PPI", True), ("PPI", False), ("PATTERN", False)])
def test_params_from_jax_carries_per_head_a_and_skips(name, paper_faithful):
    kw = dict(FIT_CONFIGS[name], paper_faithful=paper_faithful)
    jcfg, tcfg = jgat.GATConfig(**kw), tgat.GATConfig(**kw)
    jparams = jgat.init_gat_model(jax.random.key(3), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    like = tgat.init_gat_model(tcfg, device="cpu")
    for group in ("layers", "skips"):
        assert len(tparams[group]) == len(like[group]) == len(jparams[group])
        for tp, lp, jp in zip(tparams[group], like[group], jparams[group]):
            assert sorted(tp) == sorted(lp) == sorted(jp)
            for k in tp:
                assert tp[k].shape == lp[k].shape and tp[k].requires_grad
                assert np.array_equal(tp[k].detach().numpy(),
                                      np.asarray(jp[k]))
    heads, feats = kw["num_heads_per_layer"], kw[
        "head_output_features_per_layer"]
    if paper_faithful:
        assert tparams["layers"][0]["a"].shape == (heads[0], 2 * feats[1])
    if name == "PPI":
        assert tparams["skips"] == [{}]          # 64 -> 64: identity
    else:
        assert [sorted(d) for d in tparams["skips"]] == [["w"]] * 4
