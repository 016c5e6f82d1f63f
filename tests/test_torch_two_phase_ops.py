"""The port's 2-phase (cap, then attention) ops against the JAX package's,
run in interpret mode (the windowed ones with float32 contractions,
GAT_TPU_V6_DTYPE=float32):
  * v5_local_cap against segment_attention.v5_local_cap, also with an h
    table of more rows than destinations;
  * fused_gat_table (explicit cap, differentiable in it) against
    segment_attention.fused_gat_table, with a cap below the largest logit
    so that the full LeakyReLU's positive branch is taken, and with
    num_src_nodes;
  * fused_gat_table_autocap(two_phase=True) against the JAX autocap op in
    its merged (GAT_TPU_V10=0) and unmerged (GAT_TPU_V5_MERGED=0) 2-phase
    modes;
  * fused_gat_window_v7(two_phase=True) against the JAX v7 op under
    GAT_TPU_V10=0;
  * fused_gat_window, the v6 form, against the JAX fused_gat_window.
On CPU tensors the port runs its kernels' plain versions. The loss is
sum(sin(output)). Tolerances are those of tests/test_torch_parts.py for
the v5 ops (outputs 1e-5, cotangents 2e-5, each after dividing by
max(|ref|, 1): float32 sums in another order, and d(s_dst) is a sum of
cancelling terms that a relative test would only amplify) and of
tests/test_torch_window_attention.py for the windowed ones (outputs
rtol/atol 3e-5, cotangents 2e-5 after the same scaling). d(cap) of the
explicit-cap op is held at 2e-5 of its own magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.graph import transforms as JT
from gat_pytorch_tpu.ops.pallas import segment_attention as jfsa
from gat_pytorch_tpu.ops.pallas import segment_attention_window as jfsw
from gat_pytorch_tpu_torch.graph import transforms as TT
from gat_pytorch_tpu_torch.ops.cuda import v5_attention as tv5
from gat_pytorch_tpu_torch.ops.cuda import window_attention as tw

from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_parts import assert_close, v5_case
from .test_torch_window_attention import banded_edges, make_case

SLOPE = 0.01
EPS = 1e-8
NAMES = ("h", "a_src", "s_dst", "cap", "drop")


def run_both(args, jfn, tfn):
    """((out, grads) of the JAX function, (out, grads) of the port's) for
    the loss sum(sin(out)), every array of `args` differentiated."""
    def loss(*xs):
        out = jfn(*xs)
        return jnp.sum(jnp.sin(out)), out

    (_, jout), jgrads = jax.value_and_grad(
        loss, argnums=tuple(range(len(args))), has_aux=True)(
            *[jnp.asarray(a) for a in args])
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    tout = tfn(*leaves)
    torch.sin(tout).sum().backward()
    return ((np.asarray(jout), [np.asarray(g) for g in jgrads]),
            (tout.detach().numpy(), [t.grad.numpy() for t in leaves]))


def edge_arrays(c):
    return [torch.tensor(c[k]) for k in ("send", "recv", "order")]


def jax_edges(c):
    return [jnp.asarray(c[k]) for k in ("send", "recv", "order")]


@pytest.mark.parametrize("n_src", [256, 320])
def test_v5_local_cap_matches_jax(n_src):
    """The cap is the largest raw logit of the real edges; its cotangent
    reaches h[src*], a_src[:, k*] and the one s_dst element of the argmax
    (edge, head)."""
    c = v5_case(8, 8, False, seed=7, n_src=n_src)
    sd, rc, _ = jax_edges(c)
    send, recv, _ = edge_arrays(c)
    er = c["e_real"]
    (jout, jg), (tout, tg) = run_both(
        [c["h"], c["a_src"], c["s_dst"]],
        lambda h, a, s: jfsa.v5_local_cap(h, a, s, sd, rc, jnp.int32(er),
                                          256, 8, 8, 256, 128, True),
        lambda h, a, s: tv5.v5_local_cap(h, a, s, send, recv, er, 256, 8, 8))
    raw = (c["h"][c["send"][:er]] @ c["a_src"]
           + c["s_dst"][c["recv"][:er]])
    assert float(tout) == float(jout)
    np.testing.assert_allclose(float(tout), raw.max(), rtol=1e-6)
    assert_close(tg, jg, 2e-5, NAMES)
    assert tg[0].shape == (n_src, 64)
    assert np.count_nonzero(tg[2]) == 1


@pytest.mark.parametrize("dropout,eps,n_src", [(False, EPS, 256),
                                               (True, 1.0, 320)])
def test_fused_gat_table_matches_jax(dropout, eps, n_src):
    """An explicit cap below 1% of the logits: those take LeakyReLU's
    positive branch (and the slope 1 in the backward). It sits halfway
    between two logits, far from every one of them in float32."""
    c = v5_case(8, 8, dropout, seed=8, n_src=n_src)
    er = c["e_real"]
    raw = np.sort((c["h"][c["send"][:er]].astype(np.float64) @ c["a_src"]
                   + c["s_dst"][c["recv"][:er]]).reshape(-1))
    i = int(raw.size * 0.99)
    cap = np.float32((raw[i] + raw[i + 1]) / 2)
    pre = raw - cap
    assert (pre > 0).sum() > 10 and np.abs(pre).min() > 1e-5
    args = [c["h"], c["a_src"], c["s_dst"], np.asarray(cap)]
    if dropout:
        args.append(c["drop"])
    sd, rc, od = jax_edges(c)
    send, recv, order = edge_arrays(c)
    n_src_arg = None if n_src == 256 else n_src

    def jfn(h, a, s, cp, dd=None):
        return jfsa.fused_gat_table(h, a, s, cp, dd, sd, rc, od,
                                    jnp.int32(er), 256, 8, 8, eps, SLOPE,
                                    256, 128, True, n_src_arg)

    def tfn(h, a, s, cp, dd=None):
        return tv5.fused_gat_table(h, a, s, cp, dd, send, recv, order, er,
                                   256, 8, 8, eps, SLOPE, n_src_arg)

    (jout, jg), (tout, tg) = run_both(args, jfn, tfn)
    assert_close([tout], [jout], 1e-5, ("out",))
    assert_close(tg, jg, 2e-5, NAMES)
    d_cap_scale = abs(float(jg[3]))
    assert d_cap_scale > 1e-3
    np.testing.assert_allclose(float(tg[3]) / d_cap_scale,
                               float(jg[3]) / d_cap_scale, atol=2e-5)
    assert tg[0].shape == (n_src, 64)


@pytest.mark.parametrize("knob", ["GAT_TPU_V10", "GAT_TPU_V5_MERGED"])
@pytest.mark.parametrize("nh,f,dropout,eps", [(8, 8, True, 1.0),
                                              (1, 7, False, EPS)])
def test_autocap_two_phase_matches_jax(knob, nh, f, dropout, eps,
                                       monkeypatch):
    """The JAX autocap op's merged (one launch) and unmerged (cap kernel,
    then forward kernel) 2-phase modes give one function; the port's
    two_phase form serves both. At eps = 1 the cap's cotangent is of
    order 1, so a wrong route would show."""
    monkeypatch.setenv(knob, "0")
    c = v5_case(nh, f, dropout, seed=9)
    er = c["e_real"]
    args = [c["h"], c["a_src"], c["s_dst"]]
    if dropout:
        args.append(c["drop"])
    sd, rc, od = jax_edges(c)
    send, recv, order = edge_arrays(c)

    def jfn(h, a, s, dd=None):
        return jfsa.fused_gat_table_autocap(
            h, a, s, dd, sd, rc, od, jnp.int32(er), None, 256, nh, f, eps,
            SLOPE, 256, 128, True)

    def tfn(h, a, s, dd=None):
        return tv5.fused_gat_table_autocap(
            h, a, s, dd, send, recv, order, er, None, 256, nh, f, eps, SLOPE,
            two_phase=True)

    (jout, jg), (tout, tg) = run_both(args, jfn, tfn)
    assert_close([tout], [jout], 1e-5, ("out",))
    assert_close(tg, jg, 2e-5, ("h", "a_src", "s_dst", "drop"))


def window_pair(c, eps):
    bl = c["jbl"]

    def jfn(h, a, s, dd=None):
        return jfsw.fused_gat_window_v7(
            h, a, s, dd, bl.send, bl.recv, bl.base, bl.tile_ptr,
            bl.tile_base, None, c["n"], c["nh"], c["f"], bl.window, bl.wb,
            eps, SLOPE, bl.eb, bl.nb, True, bl.dmax)

    def tfn(h, a, s, dd=None):
        return tw.fused_gat_window_v7(h, a, s, dd, c["tbl"], None, c["n"],
                                      c["nh"], c["f"], eps, SLOPE,
                                      two_phase=True)

    return jfn, tfn


def assert_window_close(got, want):
    (tout, tg), (jout, jg) = got, want
    np.testing.assert_allclose(tout, jout, rtol=3e-5, atol=3e-5)
    assert_close(tg, jg, 2e-5, ("h", "a_src", "s_dst", "drop"))


@pytest.mark.parametrize("nh,f,dropout,eps", [(8, 8, True, 1.0),
                                              (8, 3, False, EPS)])
def test_window_v7_two_phase_matches_jax(nh, f, dropout, eps, monkeypatch):
    monkeypatch.setenv("GAT_TPU_V10", "0")
    send, recv = banded_edges(1, n=800, e=4000, band=300)
    c = make_case(nh, f, send, recv, 800, dropout=dropout, eps=eps)
    args = [c[k] for k in ("h", "a_src", "s_dst")]
    if dropout:
        args.append(c["drop"])
    want, got = run_both(args, *window_pair(c, eps))
    assert_window_close(got, want)
    if dropout:     # pad slots get a zero dropout cotangent
        assert np.all(got[1][3][c["tbl"].recv.numpy() < 0] == 0.0)


def test_fused_gat_window_matches_jax():
    """The v6 form on a banded graph's own edge list, with the graph's
    tile_lo and the window its src_band certifies, at eps = 1."""
    n, nh, f, eps = 800, 8, 8, 1.0
    send, recv = banded_edges(3, n=n, e=4000, band=300)
    x = np.zeros((n, 1), np.float32)
    jg = JT.canonicalize(x, send, recv, src_windows=True)
    tg = TT.canonicalize(x, send, recv, src_windows=True)
    n_pad, e = tg.num_nodes, tg.num_edges
    window = min(-(-tg.src_band // 8) * 8, -(-n_pad // 8) * 8)
    assert window < n_pad                   # a window, not the whole table
    rng = np.random.default_rng(4)
    args = [(rng.normal(size=(n_pad, nh * f)) * 0.5).astype(np.float32),
            (rng.normal(size=(nh * f, nh)) / np.sqrt(nh * f)
             ).astype(np.float32),
            rng.normal(size=(n_pad, nh)).astype(np.float32),
            (rng.random((e, nh)) > 0.4).astype(np.float32) / 0.6]
    er = tg.num_real_edges

    def jfn(h, a, s, dd):
        return jfsw.fused_gat_window(h, a, s, dd, jg.senders, jg.receivers,
                                     jnp.int32(er), jg.tile_lo, n_pad, nh, f,
                                     window, eps, SLOPE, 256, 128, True)

    def tfn(h, a, s, dd):
        return tw.fused_gat_window(h, a, s, dd, tg.senders, tg.receivers, er,
                                   tg.tile_lo, n_pad, nh, f, window, eps,
                                   SLOPE)

    want, got = run_both(args, jfn, tfn)
    assert_window_close(got, want)
    with pytest.raises(ValueError, match="tile_lo"):
        tw.fused_gat_window(*[torch.tensor(a) for a in args], tg.senders,
                            tg.receivers, er, tg.tile_lo[:-1], n_pad, nh, f,
                            window)


def test_two_phase_wrappers_refuse_other_devices():
    c = v5_case(1, 7, False, e_real=100, pad=4)
    h, a, s = (torch.tensor(c[k]).to("meta") for k in ("h", "a_src",
                                                       "s_dst"))
    send, recv, _ = edge_arrays(c)
    cap = torch.zeros((), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tv5.v5_cap(h, a, s, send, recv, 100)
    with pytest.raises(ValueError, match="no kernel"):
        tv5.v5_forward_two_phase(h, a, s, cap, None, send, recv, 100, EPS,
                                 SLOPE)
    with pytest.raises(ValueError, match="do not match"):
        tv5.fused_gat_table(torch.tensor(c["h"])[:-1],
                            torch.tensor(c["a_src"]),
                            torch.tensor(c["s_dst"]), 0.0, None, send, recv,
                            torch.tensor(c["order"]), 100, 256, 1, 7)
