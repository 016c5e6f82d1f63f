"""The port's plain segment ops and its d(h) reduction against the JAX
package: gat_pytorch_tpu.ops.segment, and segment_sum_pallas_rows in
interpret mode for the sorted row segment sum (tolerance 1e-6: float32
sums of a few terms, taken in another order)."""

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
