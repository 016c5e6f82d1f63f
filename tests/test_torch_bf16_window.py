"""The windowed op's default bfloat16 payload mode against the JAX
package's (GAT_TPU_V6_DTYPE unset, interpret mode).

Under an empty environment the JAX windowed kernels round the gathered h
rows, each edge's [weighted h | ex] before the float32 sums, each
destination's backward payload [g | 1/(den+eps) | d(den)], the d(h) rows
and d(raw) in d(a_src) (and, in the block-layout forms, in d(s_dst)) to
bfloat16; where a single-sweep layer's nh*f fits the packed window
(pair), the logits come from the rounded rows. The port's plain versions
(CPU tensors) round at the same points. Covered: fused_gat_window_v7 in
its single sweep with pair (8x8, 8x3) and without it (GAT_TPU_V12=0, and
nh*f = 128), in its 2-phase form (GAT_TPU_V10=0, no pair); v7_sweep1_parts
on the hybrid layout; and fused_gat_window, the v6 form. The model on
each of these paths is tests/test_torch_bf16_model.py's, with the
helpers below.

Tolerance: 1e-2 of each output's scale (max(|ref|, 1) for the ops, the
output's own largest magnitude for the model): both sides round the
same float32 values, but those differ in their last bits (sums in
another order), and one such bit moves a bfloat16 rounding by 2^-8 of
one term. Each case also shows that the mode is live: the port's result
in the bfloat16 mode differs from its own float32 result by more than
10x the float32 tolerance of tests/test_torch_window_attention.py (3e-5
at the same scale; the model: 10x its 1e-4 relative tolerance). And it
shows that the rounding points are the JAX package's: for every output
that the mode moves by more than that (d(s_dst) at eps = 1e-8 is a sum
of cancelling terms of the size of eps', float32 noise either way), the
port's bfloat16 result is at least 10x nearer the JAX result (root mean
square) than the port's float32 result is (measured: 0-1%).
"""

import jax
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.graph import transforms as JT
from gat_pytorch_tpu.ops.pallas import segment_attention_window as jfsw
from gat_pytorch_tpu_torch.graph import transforms as TT
from gat_pytorch_tpu_torch.models import gat as tgat
from gat_pytorch_tpu_torch.ops.cuda import window_attention as tw

from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_model import torch_loss_and_grads
from .test_torch_parts import assert_close, hybrid_case
from .test_torch_two_phase_ops import run_both
from .test_torch_window_attention import banded_edges, make_case

SLOPE = 0.01
BF16_TOL = 1e-2
F32_TOL = 3e-5
NAMES = ("h", "a_src", "s_dst", "drop")


@pytest.fixture
def bf16_payload(monkeypatch):
    """The JAX package's default contraction dtype: GAT_TPU_V6_DTYPE
    unset (default_knobs pins float32)."""
    monkeypatch.delenv("GAT_TPU_V6_DTYPE")


def rel_diff(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1.0)


def rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def assert_bf16_mode(got, want, f32, names=("out",) + NAMES):
    """got, the port's (out, grads) in the bfloat16 mode, against want,
    the JAX package's, and f32, the port's in the float32 mode: within
    BF16_TOL, live, and 10x nearer the JAX result than f32 is wherever
    the mode moves an output beyond float32 noise."""
    assert_close([got[0]], [want[0]], BF16_TOL, names[:1])
    assert_close(got[1], want[1], BF16_TOL, names[1:])
    for name, a, b in (("out", got[0], f32[0]), ("d(h)", got[1][0],
                                                 f32[1][0])):
        assert rel_diff(a, b) > 10 * F32_TOL, f"{name}: the mode is not live"
    for name, a, b, c in zip(names, [got[0]] + got[1], [want[0]] + want[1],
                             [f32[0]] + f32[1]):
        if rel_diff(c, b) > 10 * F32_TOL:
            assert rms(a, b) <= 0.1 * rms(c, b), (name, rms(a, b), rms(c, b))


def port_in_float32(monkeypatch, args, tfn):
    """The port's (out, grads) under GAT_TPU_V6_DTYPE=float32."""
    monkeypatch.setenv("GAT_TPU_V6_DTYPE", "float32")
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = tfn(*leaves)
    torch.sin(out).sum().backward()
    monkeypatch.delenv("GAT_TPU_V6_DTYPE")
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def window_case(nh, f, dropout, seed=1):
    """A banded graph's layouts and op inputs of magnitude 1 (the
    rounding is then of the order of 1e-3 of every output)."""
    send, recv = banded_edges(seed, n=800, e=4000, band=300)
    c = make_case(nh, f, send, recv, 800, seed=seed, dropout=dropout)
    rng = np.random.default_rng(seed + 20)
    c["h"] = rng.normal(size=c["h"].shape).astype(np.float32)
    c["s_dst"] = rng.normal(size=c["s_dst"].shape).astype(np.float32)
    return c


def v7_pair(c, eps):
    bl = c["jbl"]

    def jfn(h, a, s, dd=None):
        return jfsw.fused_gat_window_v7(
            h, a, s, dd, bl.send, bl.recv, bl.base, bl.tile_ptr,
            bl.tile_base, None, c["n"], c["nh"], c["f"], bl.window, bl.wb,
            eps, SLOPE, bl.eb, bl.nb, True, bl.dmax)

    def tfn(h, a, s, dd=None, two_phase=False):
        return tw.fused_gat_window_v7(h, a, s, dd, c["tbl"], None, c["n"],
                                      c["nh"], c["f"], eps, SLOPE,
                                      two_phase=two_phase)

    return jfn, tfn


def args_of(c):
    args = [c[k] for k in ("h", "a_src", "s_dst")]
    if c["drop"] is not None:
        args.append(c["drop"])
    return args


@pytest.mark.parametrize("nh,f,dropout,eps,knobs,pair", [
    (8, 8, True, 1e-8, {}, True),
    (8, 3, False, 1.0, {}, True),
    (8, 8, True, 1.0, {"GAT_TPU_V12": "0"}, False),
    (4, 32, False, 1e-8, {}, False),
], ids=["8x8-pair", "8x3-pair", "8x8-V12=0", "4x32"])
def test_v7_single_sweep_bf16_matches_jax(nh, f, dropout, eps, knobs, pair,
                                          bf16_payload, monkeypatch):
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    assert tw.window_rounding(nh, f).table == pair
    c = window_case(nh, f, dropout)
    args = args_of(c)
    jfn, tfn = v7_pair(c, eps)
    want, got = run_both(args, jfn, tfn)
    assert_bf16_mode(got, want, port_in_float32(monkeypatch, args, tfn))


def test_v7_two_phase_bf16_matches_jax(bf16_payload, monkeypatch):
    """GAT_TPU_V10=0: no packed window, so the logits (and the cap pass)
    read the float32 rows and d(cap) sums the float32 d(raw)."""
    monkeypatch.setenv("GAT_TPU_V10", "0")
    c = window_case(8, 8, True, seed=2)
    args = args_of(c)
    jfn, tfn = v7_pair(c, 1.0)

    def tfn2(*a):
        return tfn(*a, two_phase=True)

    want, got = run_both(args, jfn, tfn2)
    assert_bf16_mode(got, want, port_in_float32(monkeypatch, args, tfn2))


def test_v7_parts_bf16_matches_jax(bf16_payload, monkeypatch):
    """The sweep-1 parts op on the hybrid layout's in-window edges, pair
    mode, its three outputs and raw cotangents."""
    c = hybrid_case(8, 8, True)
    rng = np.random.default_rng(30)
    c["h"] = rng.normal(size=c["h"].shape).astype(np.float32)
    bl = c["jbl"]

    def jfn(hh, aa, ss, dd):
        num, den, cap, _ = jfsw.v7_sweep1_parts(
            hh, aa, ss, dd, bl.send, bl.recv, bl.base, bl.tile_ptr,
            bl.tile_base, c["n"], 8, 8, bl.window, bl.wb, 1e-8, SLOPE,
            bl.eb, bl.nb, True, bl.dmax)
        return jax.numpy.concatenate([num.reshape(-1), den.reshape(-1),
                                      cap.reshape(1)])

    def tfn(hh, aa, ss, dd):
        num, den, cap, _ = tw.v7_sweep1_parts(hh, aa, ss, dd, c["tbl"],
                                              c["n"], 8, 8, 1e-8, SLOPE)
        return torch.cat([num.reshape(-1), den.reshape(-1), cap.reshape(1)])

    args = args_of(c)
    want, got = run_both(args, jfn, tfn)
    assert_bf16_mode(got, want, port_in_float32(monkeypatch, args, tfn),
                     ("num|den|cap",) + NAMES)


def test_v6_form_bf16_matches_jax(bf16_payload, monkeypatch):
    """fused_gat_window on a banded graph's own edges: rows and [weighted
    h | ex] rounded, the payload and d(s_dst) not, d(a_src) from rounded
    rows and d(raw)."""
    n, nh, f, eps = 800, 8, 8, 1.0
    send, recv = banded_edges(3, n=n, e=4000, band=300)
    x = np.zeros((n, 1), np.float32)
    jg = JT.canonicalize(x, send, recv, src_windows=True)
    tg = TT.canonicalize(x, send, recv, src_windows=True)
    n_pad, e = tg.num_nodes, tg.num_edges
    window = min(-(-tg.src_band // 8) * 8, -(-n_pad // 8) * 8)
    rng = np.random.default_rng(5)
    args = [rng.normal(size=(n_pad, nh * f)).astype(np.float32),
            (rng.normal(size=(nh * f, nh)) / np.sqrt(nh * f)
             ).astype(np.float32),
            rng.normal(size=(n_pad, nh)).astype(np.float32),
            (rng.random((e, nh)) > 0.4).astype(np.float32) / 0.6]
    er = tg.num_real_edges

    def jfn(h, a, s, dd):
        return jfsw.fused_gat_window(h, a, s, dd, jg.senders, jg.receivers,
                                     jax.numpy.int32(er), jg.tile_lo, n_pad,
                                     nh, f, window, eps, SLOPE, 256, 128,
                                     True)

    def tfn(h, a, s, dd):
        return tw.fused_gat_window(h, a, s, dd, tg.senders, tg.receivers, er,
                                   tg.tile_lo, n_pad, nh, f, window, eps,
                                   SLOPE)

    want, got = run_both(args, jfn, tfn)
    assert_bf16_mode(got, want, port_in_float32(monkeypatch, args, tfn))


def model_outputs(tlogits, tparams):
    """The logits, then every parameter gradient, as numpy arrays in the
    JAX parameter tree's order."""
    return [np.asarray(tlogits)] + [
        tp[k].grad.numpy().copy() for group in ("layers", "skips")
        for tp in tparams[group] for k in sorted(tp)]


def jax_model_outputs(jlogits, jgrads, tparams):
    return [np.asarray(jlogits)] + [
        np.asarray(jgr[k]) for group in ("layers", "skips")
        for tp, jgr in zip(tparams[group], jgrads[group]) for k in sorted(tp)]


def rel_own(a, b):
    return float(np.abs(a - b).max()) / float(np.abs(b).max())


def assert_bf16_model(got, want, f32):
    """Model outputs (model_outputs order): each within BF16_TOL of its
    own magnitude, the logits live (10x the float32 tests' 1e-4), and
    each that the mode moves that far 10x nearer the JAX result than the
    float32 mode's (RMS)."""
    errs = [rel_own(a, b) for a, b in zip(got, want)]
    assert max(errs) <= BF16_TOL, errs
    assert rel_own(got[0], f32[0]) > 10 * 1e-4, "the mode is not live"
    for i, (a, b, c) in enumerate(zip(got, want, f32)):
        if rel_own(c, b) > 10 * 1e-4:
            assert rms(a, b) <= 0.1 * rms(c, b), (i, rms(a, b), rms(c, b))


def port_model(tcfg, tg, tparams):
    for p in tgat.parameters(tparams):
        p.grad = None
    tgat.PATH_TRACE.clear()
    return model_outputs(torch_loss_and_grads(tcfg, tg, tparams, "kernel"),
                         tparams)
