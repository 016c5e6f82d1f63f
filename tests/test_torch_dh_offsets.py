"""The CSR offsets carried on the port's Graph, and the d(h) reduce by them.

`Graph.src_ptr` (each sender's run of real edges in src_order) and
`Graph.dst_ptr` (each destination's run of edges) are built once with the
graph; the kernel ops take them in place of deriving them per call (the
backwards by sender as their sender runs, dh_reduce as one launch on the
card). Held here, on the CPU:
  * the offsets of the Cora stand-in, of a PPI batch of InductiveBatcher
    and of each shard of a 4-way edge_shard equal np.searchsorted over the
    JAX package's canonicalize output (senders[src_order[:E_real]] and
    receivers; a shard's slice with its padding edges last);
  * Graph.replace never returns offsets of other edges;
  * dh_reduce with the offsets gives the bits of dh_reduce without them,
    in both forms, and matches JAX `_dh_reduce` in interpret mode at
    1e-6 of the scale (the tolerance of tests/test_torch_dh_reduce_nt.py:
    float32 sums in another order, the one-hot product against
    index_add);
  * a 2-layer Cora-shaped model that carries the offsets matches the JAX
    package's logits and gradients at tests/test_torch_model.py's
    tolerance, and the model without them bit for bit.
The CUDA kernels need the card: chip_smoke.py holds them there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.data import datasets as jdatasets
from gat_pytorch_tpu.data import loader as jloader
from gat_pytorch_tpu.data import synthetic as jsyn
from gat_pytorch_tpu.ops.pallas import segment_attention as jfsa
from gat_pytorch_tpu_torch.data import datasets as tdatasets
from gat_pytorch_tpu_torch.data import loader as tloader
from gat_pytorch_tpu_torch.data import synthetic as tsyn
from gat_pytorch_tpu_torch.graph.graph import from_numpy
from gat_pytorch_tpu_torch.models import gat as tgat
from gat_pytorch_tpu_torch.ops.cuda import segment_sum as tss
from gat_pytorch_tpu_torch.ops.cuda import v5_attention as tv5
from gat_pytorch_tpu_torch.parallel import edge_shard

from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_model import (assert_same, build, jax_loss_and_grads,
                               torch_loss_and_grads)

SHARDS = 4


def expected_offsets(senders, receivers, src_order, e_real, n):
    """np.searchsorted over the arrays as the JAX package holds them."""
    senders, receivers = np.asarray(senders), np.asarray(receivers)
    bounds = np.arange(n + 1)
    src_ids = senders[np.asarray(src_order)[:e_real]]
    return (np.searchsorted(src_ids, bounds).astype(np.int32),
            np.searchsorted(receivers, bounds).astype(np.int32))


def assert_offsets(tg, jg):
    e_real = int(np.asarray(jg.edge_mask).sum())
    src_ptr, dst_ptr = expected_offsets(jg.senders, jg.receivers,
                                        jg.src_order, e_real, tg.num_nodes)
    assert tg.src_ptr.dtype == tg.dst_ptr.dtype == torch.int32
    np.testing.assert_array_equal(tg.src_ptr.numpy(), src_ptr)
    np.testing.assert_array_equal(tg.dst_ptr.numpy(), dst_ptr)
    assert int(tg.src_ptr[-1]) == tg.num_real_edges == e_real
    tg.validate()


def cora_pair():
    jg = jloader.transductive_graph(
        jdatasets.load_planetoid("Cora", synthetic_override=True, seed=0))
    tg = tloader.transductive_graph(
        tdatasets.load_planetoid("Cora", synthetic_override=True, seed=0))
    return jg, tg


def test_cora_offsets_equal_searchsorted_over_the_jax_arrays():
    assert_offsets(*reversed(cora_pair()))


def test_ppi_batch_offsets_equal_searchsorted_over_the_jax_arrays():
    jb = jloader.InductiveBatcher(jsyn.make_ppi_like("train", seed=1,
                                                     num_graphs=4), 2, seed=3)
    tb = tloader.InductiveBatcher(tsyn.make_ppi_like("train", seed=1,
                                                     num_graphs=4), 2, seed=3)
    for jg, tg in zip(jb.epoch(1), tb.epoch(1)):
        assert tg.num_edges > tg.num_real_edges       # padding edges
        assert_offsets(tg, jg)


@pytest.mark.parametrize("k", range(SHARDS))
def test_edge_shard_offsets_equal_searchsorted_over_the_jax_slice(k):
    """A shard's offsets over its own slice of the JAX arrays: its real
    edges first, in sender order, the padding edges last."""
    jg, tg = cora_pair()
    shard = edge_shard(tg, k, SHARDS)
    s = tg.num_edges // SHARDS
    sl = slice(k * s, (k + 1) * s)
    senders = np.asarray(jg.senders)[sl]
    mask = np.asarray(jg.edge_mask)[sl]
    order = np.argsort(np.where(mask, senders, tg.num_nodes), kind="stable")
    src_ptr, dst_ptr = expected_offsets(senders, np.asarray(jg.receivers)[sl],
                                        order, int(mask.sum()), tg.num_nodes)
    np.testing.assert_array_equal(shard.src_order.numpy(), order)
    np.testing.assert_array_equal(shard.src_ptr.numpy(), src_ptr)
    np.testing.assert_array_equal(shard.dst_ptr.numpy(), dst_ptr)
    shard.validate()


@pytest.mark.parametrize("field", ["senders", "receivers", "src_order",
                                   "edge_mask", "num_real_edges"])
def test_replace_never_returns_stale_offsets(field):
    _, tg = cora_pair()
    n_keep = tg.num_real_edges - 100
    new = {"senders": tg.senders.flip(0), "receivers": tg.receivers.flip(0),
           "src_order": tg.src_order.flip(0),
           "edge_mask": torch.arange(tg.num_edges) < n_keep,
           "num_real_edges": n_keep}[field]
    moved = tg.replace(**{field: new})
    src_from = field != "receivers"
    assert (moved.src_ptr is None) == src_from
    assert (moved.dst_ptr is None) == (not src_from)
    for name in ("src_ptr", "dst_ptr"):
        kept = getattr(moved, name)
        if kept is not None:
            assert kept is getattr(tg, name)
    # other fields keep them; new offsets given with the edges are taken
    assert tg.replace(block_layout=None, tile_lo=None).src_ptr is tg.src_ptr
    given = torch.zeros_like(tg.src_ptr)
    assert tg.replace(src_order=tg.src_order, src_ptr=given).src_ptr is given


def test_from_numpy_carries_no_src_ptr_for_an_order_that_is_not_real_first():
    _, tg = cora_pair()
    order = tg.src_order.flip(0).numpy()           # padding edges first
    g = from_numpy(tg.x.numpy(), tg.senders.numpy(), tg.receivers.numpy(),
                   edge_mask=tg.edge_mask.numpy(), src_order=order)
    assert g.src_ptr is None and g.dst_ptr is not None


def dh_case(d, seed=0):
    """The Cora stand-in's edges with seeded per-edge rows, zero on the
    padding edges (as the attention backward writes them)."""
    _, tg = cora_pair()
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(tg.num_edges, d)).astype(np.float32)
    rows[tg.num_real_edges:] = 0.0
    return tg, torch.tensor(rows)


@pytest.mark.parametrize("d", [7, 64])
@pytest.mark.parametrize("transposed", [False, True])
def test_dh_reduce_with_offsets_gives_the_bits_without(d, transposed):
    tg, rows = dh_case(d)
    args = (rows, tg.src_order, tg.senders, tg.num_nodes, tg.num_real_edges,
            transposed)
    carried = tss.dh_reduce(*args, src_ptr=tg.src_ptr)
    assert carried.shape == (tg.num_nodes, d)
    assert torch.equal(carried, tss.dh_reduce(*args))
    with pytest.raises(ValueError, match="src_ptr"):
        tss.dh_reduce(*args, src_ptr=tg.src_ptr[:-1])


@pytest.mark.parametrize("nt", ["1", "0"])
def test_dh_reduce_with_offsets_matches_jax_dh_reduce(nt, monkeypatch):
    """JAX `_dh_reduce` reads the rows through src_order with a zero
    overrun of eb rows past the E edges, as its backward hands them over,
    in the form GAT_TPU_DH_REDUCE_NT picks (its rows are 128 lanes wide)."""
    monkeypatch.setenv("GAT_TPU_DH_REDUCE_NT", nt)
    d, eb = 128, 256
    tg, rows = dh_case(d, seed=1)
    e = tg.num_edges
    padded = np.zeros((e + eb, d), np.float32)
    padded[:e] = rows.numpy()
    want = np.asarray(jfsa._dh_reduce(
        jnp.asarray(padded), jnp.asarray(tg.src_order.numpy()),
        jnp.asarray(tg.senders.numpy()), e, eb, tg.num_nodes, True))
    got = tss.dh_reduce(rows, tg.src_order, tg.senders, tg.num_nodes,
                        tg.num_real_edges, tss.dh_transposed(),
                        src_ptr=tg.src_ptr).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_model_with_carried_offsets_matches_jax(monkeypatch):
    """The port's kernel path (plain versions on the CPU) reads the
    graph's offsets in every layer's forward and backward; the JAX v5
    path (interpret mode) has none. Without the offsets the port gives
    the same bits."""
    monkeypatch.setenv("GAT_TPU_V5", "1")
    jcfg, tcfg, jg, tg, jparams, tparams = build("cora")
    assert tg.src_ptr is not None and tg.dst_ptr is not None
    jlogits, jgrads = jax_loss_and_grads(jcfg, jg, jparams, "pallas")
    by_offsets = []
    runs = tv5.sender_runs

    def counted(senders, e_real, n_src, src_order=None, src_ptr=None):
        by_offsets.append(src_ptr is tg.src_ptr)
        return runs(senders, e_real, n_src, src_order, src_ptr)

    # the backward by sender takes the sender runs of its d(h) sums once
    monkeypatch.setattr(tv5, "sender_runs", counted)
    tgat.PATH_TRACE.clear()
    tlogits = torch_loss_and_grads(tcfg, tg, tparams, "kernel")
    assert tgat.PATH_TRACE == ["v5", "v5"]
    assert by_offsets == [True, True]       # each layer's backward
    assert_same(jlogits, jgrads, tlogits, tparams)
    grads = [p.grad.clone() for p in tgat.parameters(tparams)]
    for p in tgat.parameters(tparams):
        p.grad = None
    bare = tg.replace(src_ptr=None, dst_ptr=None)
    assert np.array_equal(
        torch_loss_and_grads(tcfg, bare, tparams, "kernel"), tlogits)
    # the bare graph's reductions go by offsets derived per call
    assert by_offsets == [True, True, False, False]
    for a, p in zip(grads, tgat.parameters(tparams)):
        assert torch.equal(a, p.grad)
