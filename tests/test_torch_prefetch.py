"""The prefetch thread (data/prefetch.py) and the fits that use it.

The JAX package's cases (tests/test_sampling.py: every batch delivered in
order, errors reach the consumer, the build runs ahead of the consumer,
fit and fit_sharded route their epochs through the iterator), and the
port's own: both fits build a reshuffled fit's epochs in the thread with
put=False (the copies stay on the consumer's thread), close() and early
stopping leave no thread running, an error inside an epoch closes the
iterator, and a fit gives the same bits with the thread as without it.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.models import gat as jgat
from gat_pytorch_tpu_torch.data import loader as tloader
from gat_pytorch_tpu_torch.data import sampling as tS
from gat_pytorch_tpu_torch.data import synthetic as tsyn
from gat_pytorch_tpu_torch.data.prefetch import (PrefetchIterator,
                                                 prefetch_epochs)
from gat_pytorch_tpu_torch.models import gat as tgat
from gat_pytorch_tpu_torch.train import trainer as T
from gat_pytorch_tpu_torch.train.tasks import make_task

from . import torch_ranks as R
from .test_torch_inductive import FIT_CONFIGS, _small
from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_parallel import CFG, graph_at, np_tree
from .test_parallel import tiny_batch

CPU = torch.device("cpu")


def random_graph(n=120, deg=6, nf=10, nc=4, seed=0):
    rng = np.random.default_rng(seed)
    senders = np.repeat(np.arange(n), deg)
    receivers = rng.integers(0, n, n * deg)
    x = rng.normal(size=(n, nf)).astype(np.float32)
    y = rng.integers(0, nc, n).astype(np.int32)
    return x, senders, receivers, y


def batcher(seed=0):
    x, s, r, y = random_graph(seed=8)
    return tS.NeighborSampledBatcher(x, s, r, y, np.arange(64),
                                     batch_size=16, fanouts=(4,), seed=seed)


@pytest.fixture
def spy(monkeypatch):
    """Every PrefetchIterator the trainer builds, with its put flag."""
    made = []

    class Spy(PrefetchIterator):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append((kw.get("put", True), self))

    monkeypatch.setattr(T, "PrefetchIterator", Spy)
    return made


def test_prefetch_iterator_delivers_all_batches_in_order():
    direct = batcher().epoch(0)
    fetched = list(PrefetchIterator(batcher().epoch(0), depth=2,
                                    device=CPU))
    assert len(fetched) == len(direct) == 4
    for a, c in zip(fetched, direct):
        for k in ("x", "senders", "receivers", "train_mask"):
            assert torch.equal(getattr(a, k), getattr(c, k)), k
    # put=False hands the items over as they are
    items = [object() for _ in range(5)]
    assert list(PrefetchIterator(items, depth=1, put=False)) == items


def test_prefetch_iterator_propagates_errors_after_the_items_before():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("boom")

    it = PrefetchIterator(gen(), depth=1, put=False)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="boom"):
        next(it)
    with pytest.raises(StopIteration):      # the error is raised once
        next(it)
    assert not it.alive


def test_prefetch_iterator_overlaps_build_with_consumption():
    """The worker runs ahead: with depth 2 it builds item 1 while the
    consumer still holds item 0."""
    second_built = threading.Event()

    def gen():
        for i in range(3):
            if i == 1:
                second_built.set()
            yield torch.zeros(2)

    it = PrefetchIterator(gen(), depth=2, device=CPU)
    first = next(it)
    assert second_built.wait(timeout=10), \
        "the worker never built item 1 while item 0 was held"
    assert first.shape == (2,)
    assert len(list(it)) == 2
    assert not it.alive


def test_close_stops_a_worker_blocked_on_a_full_queue():
    built = []

    def endless():
        i = 0
        while True:
            built.append(i)
            yield i
            i += 1

    it = PrefetchIterator(endless(), depth=2, put=False)
    assert next(it) == 0
    it.close(timeout=10)
    assert not it.alive
    assert len(built) <= 5          # it stopped, and dropped what it held
    assert it._q.empty()
    with pytest.raises(StopIteration):
        next(it)
    with PrefetchIterator(endless(), depth=1, put=False) as it2:
        next(it2)
    assert not it2.alive


def test_prefetch_epochs_closes_each_epoch_stream():
    streams = []
    for i, stream in enumerate(prefetch_epochs(
            lambda e: [torch.full((2,), float(e))] * 3, 3, device=CPU)):
        streams.append(stream)
        assert [float(t[0]) for t in stream] == [float(i)] * 3
    assert len(streams) == 3 and not any(s.alive for s in streams)


def _tiny_cfg(nf, nc, dropout=0.0):
    return tgat.GATConfig(
        num_input_node_features=nf, num_layers=2,
        num_heads_per_layer=[2, 1], heads_concat_per_layer=[True, False],
        head_output_features_per_layer=[nf, 8, nc], num_classes=nc,
        add_skip_connection=[False, False], dropout=dropout)


def test_fit_epochs_builds_reshuffled_epochs_in_the_thread(spy):
    """One iterator a fit, put=False (the copies stay on the consumer's
    thread), whose worker calls the reshuffle; static data takes none."""
    import threading as th
    b = batcher()
    callers = []

    def reshuffle(epoch):
        callers.append(th.current_thread())
        return b.epoch(epoch)

    tr = T.Trainer(cfg=_tiny_cfg(10, 7), task=make_task("Cora"),
                   learning_rate=1e-2, max_epochs=2, seed=0, device="cpu")
    val = b.epoch(999)[:1]
    tr.fit_epochs(b.epoch(0), val, reshuffle=reshuffle)
    assert [put for put, _ in spy] == [False]
    assert not spy[0][1].alive
    assert len(callers) == 2 and th.main_thread() not in callers
    spy.clear()
    tr.fit_epochs(val * 2, val)                         # static batches
    assert spy == []


def test_early_stop_and_errors_leave_no_thread(spy, monkeypatch):
    """lr 0: the validation loss never improves, so patience 2 stops the
    fit after 3 of 20 epochs, and its thread, which builds ahead, does not
    outlive it; a step that raises mid-epoch closes the iterator too."""
    b = batcher()
    tr = T.Trainer(cfg=_tiny_cfg(10, 7), task=make_task("Cora"),
                   learning_rate=0.0, max_epochs=20, patience=2, seed=0,
                   device="cpu")
    val = b.epoch(999)[:1]
    res = tr.fit_epochs(b.epoch(0), val, reshuffle=b.epoch)
    assert res.stopped_early and len(res.history) == 3
    assert len(spy) == 1 and not spy[0][1].alive
    spy.clear()

    calls = []
    step = T.Trainer.train_step

    def failing_step(self, *a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("step failed")
        return step(self, *a, **kw)

    monkeypatch.setattr(T.Trainer, "train_step", failing_step)
    with pytest.raises(RuntimeError, match="step failed"):
        tr.fit_epochs(b.epoch(0), val, reshuffle=b.epoch)
    assert len(spy) == 1 and not spy[0][1].alive


def test_ppi_like_fit_gives_the_same_bits_with_and_without_prefetch():
    """Five-batch epochs of small PPI-like graphs, dropout 0.3 (the
    generator is drawn in every step): histories and parameters equal to
    the bits."""
    graphs = _small(tsyn.make_ppi_like("train", num_graphs=5))
    val = _small(tsyn.make_ppi_like("val", num_graphs=2))
    cfg = tgat.GATConfig(**{**FIT_CONFIGS["PPI"], "dropout": 0.3})
    runs = []
    for prefetch in (True, False):
        bt = tloader.InductiveBatcher(graphs, 1, seed=0)
        val_data = tloader.InductiveBatcher(val, 1, shuffle=False).epoch()
        tr = T.Trainer(cfg=cfg, task=make_task("PPI"), learning_rate=5e-3,
                       max_epochs=3, seed=0, device="cpu",
                       prefetch=prefetch)
        res = tr.fit_epochs(bt.epoch(0), val_data, reshuffle=bt.epoch)
        runs.append(res)
    a, b = runs
    assert a.history == b.history and len(a.history) == 3
    for x, y in zip(tgat.parameters(a.final_params),
                    tgat.parameters(b.final_params)):
        assert torch.equal(x, y)


def test_fit_sharded_prefetches_epoch_groups_without_a_copy(
        tmp_path_factory):
    """Two gloo ranks, a (1, 2) mesh, a reshuffle each epoch: the fit
    builds its groups in a PrefetchIterator with put=False, stops early
    (lr 0, patience 2) and leaves no thread running, on each rank; its
    history equals the fit without the thread."""
    _, init_rng = jax.random.split(jax.random.key(0))
    params = np_tree(jgat.init_gat_model(init_rng, jgat.GATConfig(**CFG)))
    graphs = [R.numpy_graph(graph_at(tiny_batch(1, seed=i), 0))
              for i in range(5)]
    base = dict(kind="fit", mesh=(1, 2), cfg=CFG, task="PPI", lr=0.0,
                epochs=10, patience=2, n_train=4, backend="kernel",
                graphs=graphs, params=params, reshuffle=True,
                spy_prefetch=True)
    jobs = [dict(base, name="stop"),
            dict(base, name="stop_plain", prefetch=False)]
    got = R.spawn(jobs, 2, str(tmp_path_factory.mktemp("prefetch2")))
    for rank in got:
        run = rank["stop"]
        assert run["stopped_early"] and len(run["history"]) == 3
        assert run["prefetch"] == [(False, False)]
        assert rank["stop_plain"]["prefetch"] == []
        assert run["history"] == rank["stop_plain"]["history"]
        assert run["history"] == got[0]["stop"]["history"]
