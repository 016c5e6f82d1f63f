"""The port's v5 whole-attention op against the JAX package's
fused_gat_table_autocap, run in interpret mode as its own tests run it.

On CPU tensors the port's op runs its kernels' plain versions. Forward:
rtol/atol 1e-5 (float32 sums in another order). Gradients of h, a_src,
s_dst and the dropout mask: atol 2e-5 after dividing by max(|ref|, 1),
as tests/test_pallas_kernel.py does, since some of them (d(s_dst)) are
structurally about 0 and a relative test would only amplify noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.ops.pallas import segment_attention as jfsa
from gat_pytorch_tpu_torch.ops.cuda import v5_attention as tv5

from .test_torch_knobs import default_knobs  # noqa: F401

SLOPE = 0.01


def make_case(nh, f, seed=3, n=256, e_real=1500, pad=36, dropout=False,
              recv_nodes=None):
    rng = np.random.default_rng(seed)
    e = e_real + pad
    pool = np.arange(n - 1) if recv_nodes is None else recv_nodes
    recv = np.concatenate([np.sort(rng.choice(pool, e_real)),
                           np.full(pad, n - 1)]).astype(np.int32)
    send = np.concatenate([rng.integers(0, n - 1, e_real),
                           np.full(pad, n - 1)]).astype(np.int32)
    return dict(
        n=n, nh=nh, f=f, e_real=e_real, send=send, recv=recv, eps=1e-8,
        order=np.argsort(send, kind="stable").astype(np.int32),
        h=rng.normal(size=(n, nh * f)).astype(np.float32),
        a_src=(rng.normal(size=(nh * f, nh))
               / np.sqrt(nh * f)).astype(np.float32),
        s_dst=rng.normal(size=(n, nh)).astype(np.float32),
        drop=((rng.random((e, nh)) > 0.4).astype(np.float32) / 0.6
              if dropout else None))


def run_jax(c):
    sd, rc, od = (jnp.asarray(c[k]) for k in ("send", "recv", "order"))
    args = [jnp.asarray(c[k]) for k in ("h", "a_src", "s_dst")]
    with_drop = c["drop"] is not None
    if with_drop:
        args.append(jnp.asarray(c["drop"]))

    def loss(hh, aa, ss, dd=None):
        out = jfsa.fused_gat_table_autocap(
            hh, aa, ss, dd, sd, rc, od, jnp.int32(c["e_real"]), None,
            c["n"], c["nh"], c["f"], c["eps"], SLOPE, 256, 128, True)
        return jnp.sum(jnp.sin(out)), out

    (_, out), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(args))), has_aux=True)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def run_torch(c):
    leaves = [torch.tensor(c[k], requires_grad=True)
              for k in ("h", "a_src", "s_dst")]
    drop = (None if c["drop"] is None
            else torch.tensor(c["drop"], requires_grad=True))
    out = tv5.fused_gat_table_autocap(
        leaves[0], leaves[1], leaves[2], drop, torch.tensor(c["send"]),
        torch.tensor(c["recv"]), torch.tensor(c["order"]), c["e_real"],
        None, c["n"], c["nh"], c["f"], c["eps"], SLOPE)
    torch.sin(out).sum().backward()
    grads = [t.grad.numpy() for t in leaves]
    if drop is not None:
        grads.append(drop.grad.numpy())
    return out.detach().numpy(), grads


def assert_same(c):
    out_j, grads_j = run_jax(c)
    out_t, grads_t = run_torch(c)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)
    assert len(grads_t) == len(grads_j)
    for a, b, nm in zip(grads_t, grads_j, ("h", "a_src", "s_dst", "drop")):
        scale = max(float(np.abs(b).max()), 1.0)
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=2e-5,
                                   err_msg=nm)


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("nh,f", [(8, 8), (1, 7), (2, 8)])
def test_v5_op_matches_jax(nh, f, dropout):
    assert_same(make_case(nh, f, dropout=dropout))


@pytest.mark.parametrize("nh,f", [(4, 32), (6, 11)])
def test_v5_op_matches_jax_at_wide_rows(nh, f):
    """The PPI layer shapes (4 x 256, 6 x 121) scaled down: several
    features per lane, one even and one odd width, so a lane's features
    span more than one head."""
    assert_same(make_case(nh, f, seed=4, e_real=700, dropout=True))


def test_v5_op_cap_tie_goes_to_lowest_code():
    """Every head scores alike and the top edge is duplicated, so the
    global cap is attained at several (edge, head) codes; both packages
    must route its cotangent to the lowest one."""
    c = make_case(2, 8, seed=5, dropout=True)
    c["a_src"][:, 1] = c["a_src"][:, 0]
    c["s_dst"][:, 1] = c["s_dst"][:, 0]
    c["s_dst"][c["recv"][10]] += 6.0         # its in-edges take the cap
    dup = np.insert(np.arange(c["send"].shape[0]), 10, 10)[:-1]
    c["send"], c["recv"] = c["send"][dup], c["recv"][dup]
    c["order"] = np.argsort(c["send"], kind="stable").astype(np.int32)
    _, _, cap, code = tv5.v5_forward_plain(
        torch.tensor(c["h"]), torch.tensor(c["a_src"]),
        torch.tensor(c["s_dst"]), None, torch.tensor(c["send"]),
        torch.tensor(c["recv"]), c["e_real"], SLOPE)
    raw = (c["h"][c["send"][:c["e_real"]]] @ c["a_src"]
           + c["s_dst"][c["recv"][:c["e_real"]]])
    assert (raw == raw.max()).sum() >= 2        # a real tie
    assert int(code) == int(np.argmax(raw.reshape(-1)))
    assert_same(c)


def test_v5_op_cap_cotangent():
    """The cap enters only through eps' = eps*exp(slope*cap'), so at the
    reference's eps = 1e-8 its cotangent is far below any tolerance. With
    eps = 1 it is of order 1 and pins the closed-form route to the argmax
    (edge, head): src*, the head's a_src column and dst*."""
    c = make_case(2, 8, seed=9, dropout=True)
    c["eps"] = 1.0
    assert_same(c)


def test_v5_op_empty_segments():
    """Odd nodes receive no edges: their output is 0 (inv = 0 where
    den == 0) and nothing flows back from them."""
    c = make_case(8, 8, seed=7, dropout=True,
                  recv_nodes=np.arange(0, 255, 2))
    assert_same(c)
    out, _ = run_torch(c)
    assert np.all(out[1:255:2] == 0.0)


def test_wrapper_refuses_other_devices():
    c = make_case(1, 7, e_real=100, pad=4)
    args = [torch.tensor(c[k]).to("meta") for k in ("h", "a_src", "s_dst")]
    with pytest.raises(ValueError, match="no kernel"):
        tv5.v5_forward(*args, None, torch.tensor(c["send"]).to("meta"),
                       torch.tensor(c["recv"]).to("meta"), c["e_real"],
                       SLOPE)
