"""The port's v4 table attention op against the JAX package's
fused_segment_attention_table, run in interpret mode as its own tests run
it.

On CPU tensors the port's op runs its kernels' plain versions. Forward:
rtol/atol 1e-5 (float32 sums in another order). Cotangents of the logits,
h and the dropout mask: atol 2e-5 after dividing by max(|ref|, 1), as
tests/test_torch_v5_attention.py does. The logits are of the three kinds
the model hands the op: per-destination max-subtracted (paper_faithful,
eps 0), zeros (const_attention) and capped (<= 0, eps 1e-8); padding
edges carry NEG_INF.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.ops.pallas import segment_attention as jfsa
from gat_pytorch_tpu_torch.ops.cuda import table_attention as tta

from .test_torch_knobs import default_knobs  # noqa: F401


def make_case(nh, f, seed=3, n=256, e_real=700, pad=36, dropout=False,
              eps=1e-8, kind="capped", with_order=True, recv_nodes=None):
    rng = np.random.default_rng(seed)
    e = e_real + pad
    pool = np.arange(n - 1) if recv_nodes is None else recv_nodes
    recv = np.concatenate([np.sort(rng.choice(pool, e_real)),
                           np.full(pad, n - 1)]).astype(np.int32)
    send = np.concatenate([rng.integers(0, n - 1, e_real),
                           np.full(pad, n - 1)]).astype(np.int32)
    logits = rng.normal(size=(e, nh)).astype(np.float32)
    if kind == "capped":
        logits -= logits[:e_real].max()
    elif kind == "segmax":
        seg_max = np.full((n, nh), -np.inf, np.float32)
        np.maximum.at(seg_max, recv[:e_real], logits[:e_real])
        logits -= np.where(np.isfinite(seg_max), seg_max, 0.0)[recv]
    elif kind == "zeros":
        logits[:] = 0.0
    logits[e_real:] = tta.NEG_INF
    assert tta.NEG_INF == jfsa.NEG_INF
    return dict(
        n=n, nh=nh, f=f, send=send, recv=recv, eps=eps, logits=logits,
        order=(np.argsort(send, kind="stable").astype(np.int32)
               if with_order else None),
        h=rng.normal(size=(n, nh * f)).astype(np.float32),
        drop=((rng.random((e, nh)) > 0.4).astype(np.float32) / 0.6
              if dropout else None))


def run_jax(c):
    sd, rc = jnp.asarray(c["send"]), jnp.asarray(c["recv"])
    od = None if c["order"] is None else jnp.asarray(c["order"])
    args = [jnp.asarray(c["logits"]), jnp.asarray(c["h"])]
    if c["drop"] is not None:
        args.append(jnp.asarray(c["drop"]))

    def loss(ll, hh, dd=None):
        out = jfsa.fused_segment_attention_table(
            ll, hh, sd, rc, dd, od, c["n"], c["nh"], c["f"], c["eps"],
            256, 128, True)
        return jnp.sum(jnp.sin(out)), out

    (_, out), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(args))), has_aux=True)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def run_torch(c, num_real_edges=None):
    leaves = [torch.tensor(c[k], requires_grad=True)
              for k in ("logits", "h")]
    if c["drop"] is not None:
        leaves.append(torch.tensor(c["drop"], requires_grad=True))
    out = tta.fused_segment_attention_table(
        leaves[0], leaves[1], torch.tensor(c["send"]),
        torch.tensor(c["recv"]), leaves[2] if c["drop"] is not None else None,
        None if c["order"] is None else torch.tensor(c["order"]),
        c["n"], c["nh"], c["f"], c["eps"], num_real_edges)
    torch.sin(out).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def assert_same(c, num_real_edges=None):
    out_j, grads_j = run_jax(c)
    out_t, grads_t = run_torch(c, num_real_edges)
    assert np.isfinite(out_t).all()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)
    assert len(grads_t) == len(grads_j)
    for a, b, nm in zip(grads_t, grads_j, ("logits", "h", "drop")):
        assert np.isfinite(a).all(), nm
        scale = max(float(np.abs(b).max()), 1.0)
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=2e-5,
                                   err_msg=nm)
    return out_t, grads_t


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("nh,f", [(8, 8), (4, 32), (6, 11), (1, 7)])
def test_table_op_matches_jax(nh, f, dropout):
    """The reference-quirk form: capped logits, eps 1e-8."""
    assert_same(make_case(nh, f, dropout=dropout))


@pytest.mark.parametrize("kind", ["segmax", "zeros"])
@pytest.mark.parametrize("nh,f", [(4, 32), (6, 11)])
def test_table_op_matches_jax_at_eps_zero(nh, f, kind):
    """paper_faithful hands the op max-subtracted logits and eps = 0;
    const_attention zeros."""
    assert_same(make_case(nh, f, seed=5, eps=0.0, kind=kind, dropout=True))


@pytest.mark.parametrize("dropout", [False, True])
def test_table_op_without_src_order(dropout):
    """No src_order: the JAX op scatter-adds d(h) unsorted, the port sorts
    the senders itself; the same sums in another order."""
    assert_same(make_case(8, 8, seed=11, with_order=False, dropout=dropout))


@pytest.mark.parametrize("with_order", [True, False])
def test_table_op_told_the_number_of_real_edges(with_order):
    """A caller that knows how many leading edges are real passes it, and
    the padding edges are not walked: the same result, also where their
    logits are not NEG_INF, and zero cotangents on them."""
    c = make_case(6, 11, seed=9, dropout=True, with_order=with_order)
    _, grads = assert_same(c, num_real_edges=700)
    c["logits"][700:] = 0.5
    _, again = run_torch(c, num_real_edges=700)
    for a, b in zip(grads, again):
        assert np.array_equal(a, b)
    assert np.all(again[0][700:] == 0.0) and np.all(again[2][700:] == 0.0)
    with pytest.raises(ValueError, match="num_real_edges"):
        run_torch(c, num_real_edges=737)


@pytest.mark.parametrize("eps", [0.0, 1e-8])
def test_table_op_rows_without_a_real_edge(eps):
    """Odd nodes receive no edge and the sink only padding edges (exp of
    NEG_INF is 0): den = 0 there, so the output rows are 0 and nothing
    flows back, with no NaN even at eps = 0."""
    c = make_case(4, 32, seed=7, dropout=True, eps=eps, kind="segmax",
                  recv_nodes=np.arange(0, 255, 2))
    out, grads = assert_same(c)
    assert np.all(out[1:255:2] == 0.0) and np.all(out[255] == 0.0)
    pad = c["logits"][:, 0] == tta.NEG_INF
    assert pad.sum() == 36
    assert np.all(grads[0][pad] == 0.0) and np.all(grads[2][pad] == 0.0)


def test_table_plain_backward_is_the_forward_s_gradient():
    """table_backward_plain against autograd through table_forward_plain,
    edges past the last row (receiver >= num_nodes) included; 4 of the 8
    are also past e_real."""
    c = make_case(6, 11, seed=13, dropout=True, n=64, e_real=300, pad=8)
    c["recv"][-8:] = 64                      # no row of this call
    lg, h, dr = (torch.tensor(c[k], requires_grad=True)
                 for k in ("logits", "h", "drop"))
    send, recv = torch.tensor(c["send"]), torch.tensor(c["recv"])
    out, den = tta.table_forward_plain(lg, h, dr, send, recv, 64, 304, 1e-8)
    g = torch.tensor(np.random.default_rng(1).normal(
        size=out.shape).astype(np.float32))
    (out * g).sum().backward()
    with torch.no_grad():
        rows, d_lg, d_dr = tta.table_backward_plain(
            lg, h, dr, send, recv, 304, 1e-8, g, out, den, True)
        d_h = torch.zeros_like(h).index_add_(0, send.long(), rows)
    for got, want in ((d_lg, lg.grad), (d_dr, dr.grad), (d_h, h.grad)):
        # d(logits) is a sum of cancelling terms: float32 rounding only
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=2e-5)
    assert torch.all(rows[-8:] == 0) and torch.all(d_lg[-8:] == 0)


def test_wrappers_refuse_other_devices_and_shapes():
    c = make_case(1, 7, e_real=100, pad=4)
    meta = {k: torch.tensor(c[k]).to("meta")
            for k in ("logits", "h", "send", "recv")}
    with pytest.raises(ValueError, match="no kernel"):
        tta.table_forward(meta["logits"], meta["h"], None, meta["send"],
                          meta["recv"], c["n"], 104, 0.0)
    with pytest.raises(ValueError, match="no kernel"):
        tta.table_backward(meta["logits"], meta["h"], None, meta["send"],
                           meta["recv"], 104, 0.0, meta["h"], meta["h"],
                           meta["h"], False)
    with pytest.raises(ValueError, match="do not match"):
        tta.fused_segment_attention_table(
            torch.tensor(c["logits"]), torch.tensor(c["h"]),
            torch.tensor(c["send"]), torch.tensor(c["recv"]), None, None,
            c["n"], 1, 8)
