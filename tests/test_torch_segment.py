"""The port's plain segment ops, its d(h) reduction and its sorted segment
sum against the JAX package: gat_pytorch_tpu.ops.segment, and
segment_sum_pallas_rows and segment_sum_pallas in interpret mode for the
sorted sums (tolerance 1e-6: float32 sums of a few terms, taken in
another order); the sorted-gradient gather against gather_rows_sorted_grad
in value and gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.ops import segment as jseg
from gat_pytorch_tpu.ops.pallas import segment_attention as jfsa
from gat_pytorch_tpu.ops.pallas import segment_sum as jss
from gat_pytorch_tpu_torch.ops import segment as tseg
from gat_pytorch_tpu_torch.ops.cuda import segment_sum as tss

TOL = dict(rtol=1e-6, atol=1e-6)


def _edges(seed, n, e, pad=20):
    rng = np.random.default_rng(seed)
    recv = np.concatenate([np.sort(rng.integers(0, n, e)),
                           np.full(pad, n)])      # padding ids == n: dropped
    return rng, recv.astype(np.int32)


def test_segment_sum_max_gather_degree():
    rng, recv = _edges(0, 64, 400)
    vals = rng.normal(size=(recv.shape[0], 3)).astype(np.float32)
    t_recv = torch.tensor(recv)
    np.testing.assert_allclose(
        tseg.segment_sum(torch.tensor(vals), t_recv, 64).numpy(),
        np.asarray(jseg.segment_sum(jnp.asarray(vals), jnp.asarray(recv),
                                    64)), **TOL)
    np.testing.assert_array_equal(
        tseg.segment_max(torch.tensor(vals), t_recv, 64).numpy(),
        np.asarray(jseg.segment_max(jnp.asarray(vals), jnp.asarray(recv),
                                    64)))
    idx = rng.integers(0, 64, 50).astype(np.int32)
    table = rng.normal(size=(64, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tseg.gather_rows(torch.tensor(table), torch.tensor(idx)).numpy(),
        np.asarray(jseg.gather_rows(jnp.asarray(table), jnp.asarray(idx))))
    mask = rng.random(recv.shape[0]) > 0.3
    np.testing.assert_array_equal(
        tseg.in_degree(t_recv, 64, edge_mask=torch.tensor(mask)).numpy(),
        np.asarray(jseg.in_degree(jnp.asarray(recv), 64,
                                  edge_mask=jnp.asarray(mask))))


@pytest.mark.parametrize("subtract_max,eps", [(False, 1e-8), (True, 0.0)])
def test_segment_softmax(subtract_max, eps):
    rng, recv = _edges(1, 50, 300)
    recv = np.minimum(recv, 49)            # padding edges at the last node
    logits = rng.normal(size=(recv.shape[0], 4)).astype(np.float32)
    mask = np.arange(recv.shape[0]) < 300
    got = tseg.segment_softmax(torch.tensor(logits), torch.tensor(recv), 50,
                               edge_mask=torch.tensor(mask), eps=eps,
                               subtract_segment_max=subtract_max)
    want = jseg.segment_softmax(jnp.asarray(logits), jnp.asarray(recv), 50,
                                edge_mask=jnp.asarray(mask), eps=eps,
                                subtract_segment_max=subtract_max)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n,e,d", [(256, 1500, 128), (300, 700, 256)])
def test_segment_sum_rows_matches_pallas(n, e, d):
    rng = np.random.default_rng(2)
    ids = np.sort(rng.integers(0, n, e)).astype(np.int32)
    eb = 256
    vals = np.zeros((e + eb, d), np.float32)        # the over-read is zeros
    vals[:e] = rng.normal(size=(e, d))
    want = jss.segment_sum_pallas_rows(
        jnp.asarray(vals), jnp.asarray(ids), n, eb=eb, nb=128,
        interpret=True, no_transpose=True)
    got = tss.segment_sum_rows(torch.tensor(vals), torch.tensor(ids), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dh_reduce_matches_pallas():
    """The fused permute-and-reduce against the JAX `_dh_reduce` (take by
    src_order, then the sorted rows kernel)."""
    rng = np.random.default_rng(3)
    n, e_real, pad, d, op_eb = 200, 1000, 24, 128, 256
    e = e_real + pad
    send = np.concatenate([rng.integers(0, n - 1, e_real),
                           np.full(pad, n - 1)]).astype(np.int32)
    order = np.argsort(send, kind="stable").astype(np.int32)
    rows = np.zeros((e + op_eb, d), np.float32)
    rows[:e_real] = rng.normal(size=(e_real, d))
    want = jfsa._dh_reduce(jnp.asarray(rows), jnp.asarray(order),
                           jnp.asarray(send), e, op_eb, n, True)
    got = tss.dh_reduce(torch.tensor(rows[:e]), torch.tensor(order),
                        torch.tensor(send), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d", [1, 3, 8, 24, 64])
def test_segment_sum_sorted_matches_pallas(d):
    """Every width, not only multiples of the lane count; empty segments
    and ids >= num_segments (dropped) included."""
    rng = np.random.default_rng(5)
    n, e = 200, 1300
    ids = np.sort(np.concatenate([rng.integers(0, n - 40, e),
                                  np.full(20, n)])).astype(np.int32)
    vals = rng.normal(size=(ids.shape[0], d)).astype(np.float32)
    want = jss.segment_sum_pallas(jnp.asarray(vals), jnp.asarray(ids), n,
                                  interpret=True)
    got = tss.segment_sum_sorted(torch.tensor(vals), torch.tensor(ids), n)
    assert got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[n - 40:] == 0.0)


@pytest.mark.parametrize("with_order", [False, True])
def test_gather_rows_sorted_grad_matches_jax(with_order):
    """Value and gradient: sorted indices (the receivers) without `order`,
    unsorted ones (the senders) through their stable sort."""
    rng = np.random.default_rng(6)
    n, e, d = 120, 900, 4
    idx = rng.integers(0, n, e).astype(np.int32)
    order = None
    if with_order:
        order = np.argsort(idx, kind="stable").astype(np.int32)
    else:
        idx = np.sort(idx)
    table = rng.normal(size=(n, d)).astype(np.float32)
    weight = rng.normal(size=(e, d)).astype(np.float32)

    def jloss(t):
        rows = jseg.gather_rows_sorted_grad(
            t, jnp.asarray(idx), n,
            None if order is None else jnp.asarray(order))
        return jnp.sum(jnp.sin(rows) * weight), rows

    (_, jrows), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(table))
    t = torch.tensor(table, requires_grad=True)
    rows = tseg.gather_rows_sorted_grad(
        t, torch.tensor(idx), n,
        None if order is None else torch.tensor(order))
    (torch.sin(rows) * torch.tensor(weight)).sum().backward()
    np.testing.assert_array_equal(rows.detach().numpy(), np.asarray(jrows))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-5)
    # the same gradient as the plain gather's
    t2 = torch.tensor(table, requires_grad=True)
    (torch.sin(tseg.gather_rows(t2, torch.tensor(idx)))
     * torch.tensor(weight)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), t2.grad.numpy(), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="num_segments"):
        tseg.gather_rows_sorted_grad(t, torch.tensor(idx), n + 1)


def test_segment_mean_matches_jax():
    rng, recv = _edges(7, 40, 200)
    vals = rng.normal(size=(recv.shape[0], 3)).astype(np.float32)
    got = tseg.segment_mean(torch.tensor(vals), torch.tensor(recv), 48)
    want = jseg.segment_mean(jnp.asarray(vals), jnp.asarray(recv), 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[41:] == 0.0)          # empty segments
