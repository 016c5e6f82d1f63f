"""Neighbour-sampled minibatches (data/sampling.py) against the JAX package.

Both samplers are pinned to one branch a test, which edits no file of the
JAX package: the numpy branch (the port's native library hidden, the JAX
binding's `native_available` patched to False), where the port draws the
same np.random.Generator calls in the same order; or the native branch
(the JAX binding's `_LIB_PATH` pointed at the port's built library), where
both draw one seed a hop for the same C entry. From one seed both give the
same subgraphs, array for array, in every epoch. A sampled fit (the
batcher as `reshuffle`, dropout 0, the JAX parameters carried over) then
follows the JAX fit's history (numpy branch).
"""

import jax
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.data import sampling as jS
from gat_pytorch_tpu.graph import graphcore_binding as jcore
from gat_pytorch_tpu.models import gat as jgat
from gat_pytorch_tpu.train import tasks as jtasks
from gat_pytorch_tpu.train.trainer import Trainer as JTrainer
from gat_pytorch_tpu_torch.data import sampling as tS
from gat_pytorch_tpu_torch.graph import graphcore_binding as tcore
from gat_pytorch_tpu_torch.models import gat as tgat
from gat_pytorch_tpu_torch.train import tasks as ttasks
from gat_pytorch_tpu_torch.train.trainer import Trainer as TTrainer
from gat_pytorch_tpu_torch.utils.convert import params_from_jax

from .test_torch_knobs import default_knobs  # noqa: F401

GRAPH_FIELDS = ("x", "senders", "receivers", "edge_mask", "node_mask", "y",
                "train_mask", "graph_ids", "src_order")


def pin_branch(monkeypatch, branch):
    """Put both packages' samplers on `branch` ("numpy" or "native")."""
    if branch == "numpy":
        monkeypatch.setattr(tcore, "_load", lambda: None)
        monkeypatch.setattr(jcore, "native_available", lambda: False)
        return
    lib = tcore._load()
    assert lib is not None, "no C++ compiler: the native branch cannot run"
    monkeypatch.setattr(jcore, "_LIB_PATH", lib._name)
    monkeypatch.setattr(jcore, "_lib", None)
    assert jcore.native_available()


@pytest.fixture(params=["numpy", "native"])
def branch(request, monkeypatch):
    pin_branch(monkeypatch, request.param)
    return request.param


def random_graph(n=60, deg=4, nf=6, nc=3, seed=0, isolated=()):
    """A random multigraph (repeated edges included); the nodes in
    `isolated` have no in-edge."""
    rng = np.random.default_rng(seed)
    senders = np.repeat(np.arange(n), deg)
    receivers = rng.integers(0, n, n * deg)
    keep = ~np.isin(receivers, list(isolated))
    x = rng.normal(size=(n, nf)).astype(np.float32)
    y = rng.integers(0, nc, n).astype(np.int32)
    return x, senders[keep], receivers[keep], y


def assert_graphs_equal(tg, jg, label):
    assert (tg.num_nodes, tg.num_edges) == (jg.num_nodes, jg.num_edges), \
        label
    assert tg.num_real_edges == int(np.asarray(jg.edge_mask).sum()), label
    for k in GRAPH_FIELDS:
        want = getattr(jg, k)
        got = getattr(tg, k)
        assert (got is None) == (want is None), (label, k)
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{label}: {k}")
    # the port's CSR offsets describe the JAX package's edges
    rcv = np.asarray(jg.receivers)
    np.testing.assert_array_equal(
        tg.dst_ptr.numpy(),
        np.searchsorted(rcv, np.arange(jg.num_nodes + 1), side="left"),
        err_msg=f"{label}: dst_ptr")


@pytest.mark.parametrize("fanouts", [(2, 3), (10, 10), (0, 4), (3,)])
def test_sample_subgraph_draws_as_the_jax_numpy_branch(fanouts, branch):
    """Fanouts below and above the degrees, and 0; a seed without
    in-edges (node 7) and a repeated seed; on either branch."""
    x, s, r, y = random_graph(isolated=(7,))
    seeds = np.array([3, 7, 11, 3, 42])
    out = []
    for S in (jS, tS):
        csr = S.CSRGraph(s, r, x.shape[0])
        out.append(S.sample_subgraph(csr, seeds, fanouts,
                                     np.random.default_rng(5)))
    for got, want in zip(*out[::-1]):
        np.testing.assert_array_equal(got, want)
    nodes, ss, rr, seed_local = out[1]
    assert list(nodes[:4]) == [3, 7, 11, 42]     # the distinct seeds first
    assert list(seed_local) == [0, 1, 2, 0, 3]
    assert not (rr == 1).any()                   # node 7: no in-edge
    if fanouts[0] == 0:
        assert ss.size == 0 and nodes.size == 4


@pytest.mark.parametrize("fanouts,batch", [((2, 3), 8), ((10, 10), 16),
                                           ((0, 2), 5)])
def test_batcher_epochs_equal_the_jax_batcher(fanouts, batch, branch):
    """Three epochs of padded subgraphs, field for field, with the ragged
    last batch, from one seed, on either branch."""
    x, s, r, y = random_graph(seed=2, isolated=(4, 9))
    seeds = np.array([4, 9, 1, 2, 3, 5, 6, 8, 10, 12, 14, 16, 18, 20, 22,
                      24, 26, 28, 30, 4])
    batchers = [S.NeighborSampledBatcher(x, s, r, y, seeds, batch, fanouts,
                                         seed=3) for S in (jS, tS)]
    jb, tb = batchers
    assert (tb.node_bucket, tb.edge_bucket, len(tb)) == \
        (jb.node_bucket, jb.edge_bucket, len(jb))
    for epoch in range(3):
        jep, tep = jb.epoch(epoch), tb.epoch(epoch)
        assert len(tep) == len(jep) == len(tb)
        for i, (tg, jg) in enumerate(zip(tep, jep)):
            assert_graphs_equal(tg, jg, f"epoch {epoch} batch {i}")
            tg.validate()
        assert sum(int(g.train_mask.sum()) for g in tep) <= seeds.size


def test_sampled_fit_matches_the_jax_fit(monkeypatch):
    """fit_epochs on the port's batcher (prefetch thread on) against JAX
    Trainer.fit on the JAX batcher, both from the JAX initial parameters:
    dropout 0, three epochs of three sampled batches, validation on the
    full graph (numpy branch)."""
    pin_branch(monkeypatch, "numpy")
    from gat_pytorch_tpu.graph import transforms as jT
    from gat_pytorch_tpu_torch.graph import transforms as tT
    x, s, r, y = random_graph(n=80, deg=5, nf=8, nc=4, seed=7)
    y = x[:, :4].argmax(1).astype(np.int32)
    seeds = np.arange(0, 40)
    val_mask = np.zeros(80, bool)
    val_mask[40:] = True
    kw = dict(num_input_node_features=8, num_layers=2,
              num_heads_per_layer=[2, 1],
              heads_concat_per_layer=[True, False],
              head_output_features_per_layer=[8, 8, 4], num_classes=4,
              add_skip_connection=[False, False], dropout=0.0)
    common = dict(learning_rate=0.01, max_epochs=3, patience=100, seed=0)
    histories = []
    for S, T in ((jS, jT), (tS, tT)):
        batcher = S.NeighborSampledBatcher(x, s, r, y, seeds, 16, (4, 3),
                                           seed=1)
        val = [T.canonicalize(x, s, r, y=y, val_mask=val_mask)]
        if S is jS:
            cfg = jgat.GATConfig(**kw)
            trainer = JTrainer(cfg=cfg, task=jtasks.make_task("Cora"),
                               **common)
            result = trainer.fit(batcher.epoch(0), val,
                                 reshuffle=batcher.epoch)
            _, init_rng = jax.random.split(jax.random.key(0))
            jparams = jgat.init_gat_model(init_rng, cfg)
        else:
            trainer = TTrainer(cfg=tgat.GATConfig(**kw),
                               task=ttasks.make_task("Cora"), device="cpu",
                               **common)
            tgat.PATH_TRACE.clear()
            result = trainer.fit_epochs(
                batcher.epoch(0), val, reshuffle=batcher.epoch,
                params=params_from_jax(
                    jax.tree_util.tree_map(np.asarray, jparams),
                    device="cpu"))
            # 2 layers x (3 epochs x (3 sampled + 1 validation) batches)
            assert len(tgat.PATH_TRACE) == 2 * 3 * 4
        histories.append(result.history)
    jh, th = histories
    assert len(th) == len(jh) == 3
    for jrow, trow in zip(jh, th):
        for k in ("train_loss", "val_loss", "val_acc"):
            np.testing.assert_allclose(trow[k], jrow[k], rtol=1e-4,
                                       err_msg=k)
    assert th[-1]["train_loss"] < th[0]["train_loss"]
    assert all(torch.isfinite(torch.tensor(r["train_acc"])) for r in th)
