"""The windowed op's backward by sender: d(h) summed by sender inside the
op, returned per node, in every mode.

The backward entries (window_backward in its normalised and parts modes,
window_backward_two_phase) return d(h) as (N, D): each sender's slots'
d(h) terms summed in ascending position of its run of the layout's
src_perm, from 0. On CPU tensors they run their plain versions, which the
card's kernel is held to (chip_smoke.py). Here the plain versions are
held:
  - to the route they replace, the per-slot rows of the TPU kernel's
    contract (window_backward_rows_plain) reduced by sender through
    dh_reduce_ptr: equal bits, and equal bits in the other outputs;
  - through the ops (fused_gat_window_v7 in its single sweep and its
    2-phase form, v7_sweep1_parts on the hybrid layout), to the JAX
    package's VJP in interpret mode, as its own tests run it: float32
    (GAT_TPU_V6_DTYPE=float32) within 2e-5 of max(|ref|, 1) for the
    gradients and 3e-5 for the outputs (float32 sums in another order,
    tests/test_torch_window_attention.py's tolerances), and the bfloat16
    payload mode (the JAX default) within 1e-2 of the scale (one float32
    bit moves a bfloat16 rounding by 2^-8 of one term,
    tests/test_torch_bf16_window.py's tolerance);
  - on the layout's edge cases: pad slots (zero d(drop)), padded rows
    without edges (zero d(h) and d(s_dst)), at 8x8, 8x3 (a head starting
    mid-vector), 1x7 and a 1024-wide row (8x128).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.ops.pallas import segment_attention_window as jfsw
from gat_pytorch_tpu_torch.ops.cuda import v5_attention as tv5
from gat_pytorch_tpu_torch.ops.cuda import window_attention as tw
from gat_pytorch_tpu_torch.ops.cuda.rounding import FLOAT32
from gat_pytorch_tpu_torch.ops.cuda.segment_sum import dh_reduce_ptr

from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_parts import assert_close, hybrid_case
from .test_torch_two_phase_ops import run_both
from .test_torch_window_attention import banded_edges, make_case

SLOPE = 0.01
EPS = 1e-8
BF16_TOL = 1e-2
SHAPES = [(8, 8), (8, 3), (1, 7), (8, 128)]
MODES = ["normalised", "parts", "two_phase"]


def small_case(nh, f, dropout=True, seed=1):
    """A banded graph of 300 nodes (padded past them: rows without edges)
    and inputs of magnitude 1."""
    send, recv = banded_edges(seed, n=300, e=1500, band=120)
    c = make_case(nh, f, send, recv, 300, seed=seed, dropout=dropout)
    rng = np.random.default_rng(seed + 30)
    c["h"] = rng.normal(size=c["h"].shape).astype(np.float32)
    c["s_dst"] = rng.normal(size=c["s_dst"].shape).astype(np.float32)
    return c


def rounding_of(nh, f, mode, bf16):
    if not bf16:
        return FLOAT32
    return tw.window_rounding(nh, f, sweep1=mode != "two_phase")


def entry_args(c, mode, rnd, eps=EPS, seed=2):
    """(the backward entry, its plain rows version, its arguments) of one
    mode, with random cotangents; the forward's outputs from its plain
    version."""
    t = {k: torch.tensor(c[k]) for k in ("h", "a_src", "s_dst")}
    drop = None if c["drop"] is None else torch.tensor(c["drop"])
    bl, n, nh, f = c["tbl"], c["n"], c["nh"], c["f"]
    h = rnd.table_of(t["h"])
    rng = np.random.default_rng(seed)
    g = torch.tensor(rng.normal(size=(n, nh * f)).astype(np.float32))
    if mode == "two_phase":
        cap = torch.tensor(0.3)
        fa = (h, t["a_src"], t["s_dst"], cap, drop, bl, eps, SLOPE)
        out, den = tw.window_forward_two_phase_plain(*fa, rounding=rnd)
        args = fa + (g, out, den, drop is not None)
        return (lambda *a: tw.window_backward_two_phase_plain(
                    *a, rounding=rnd),
                lambda *a: tw.window_backward_two_phase_rows_plain(
                    *a, rounding=rnd), args)
    fa = (h, t["a_src"], t["s_dst"], drop, bl, SLOPE)
    num, den, cap, _ = tw.window_forward_plain(*fa, rounding=rnd)
    norm = mode == "normalised"
    if norm:
        out, epsp = tv5.normalise(num, den, cap, eps, SLOPE, nh)
        co = (g, out, den, epsp)
    else:
        d_den = torch.tensor(rng.normal(size=(n, nh)).astype(np.float32))
        co = (g, None, d_den, None)
    args = fa + co + (drop is not None,)
    return (lambda *a: tw.window_backward_plain(*a, normalize=norm,
                                                rounding=rnd),
            lambda *a: tw.window_backward_rows_plain(*a, normalize=norm,
                                                     rounding=rnd), args)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nh,f", SHAPES)
def test_by_sender_has_the_bits_of_the_per_slot_route(nh, f, mode, bf16,
                                                       monkeypatch):
    """d(h) by sender against the per-slot rows reduced by dh_reduce_ptr
    (the route before: equal bits), the other outputs unchanged; rows
    without edges get zero d(h) and d(s_dst), pad slots zero d(drop)."""
    if bf16:
        monkeypatch.delenv("GAT_TPU_V6_DTYPE")
    c = small_case(nh, f)
    rnd = rounding_of(nh, f, mode, bf16)
    by_sender, rows_route, args = entry_args(c, mode, rnd)
    got = by_sender(*args)
    rows, *rest = rows_route(*args)
    bl = c["tbl"]
    want = dh_reduce_ptr(rows, bl.src_perm, bl.src_ptr)
    assert got[0].shape == (c["n"], nh * f)
    assert torch.equal(got[0], want)
    for x, y in zip(got[1:], rest):
        assert torch.equal(x, y)
    # the padded rows past the graph's 300 nodes have no slot
    assert c["n"] > 300 and int(bl.dst_ptr[300]) == int(bl.dst_ptr[-1])
    assert int(bl.src_ptr[300]) == int(bl.src_ptr[-1])
    assert bool((got[0][300:] == 0).all()) and bool((got[2][300:] == 0).all())
    assert bool((got[1][bl.recv < 0] == 0).all())
    assert bool(got[0][:300].abs().sum(1).gt(0).all())


def v7_fns(c, eps, two_phase):
    bl = c["jbl"]

    def jfn(h, a, s, dd):
        return jfsw.fused_gat_window_v7(
            h, a, s, dd, bl.send, bl.recv, bl.base, bl.tile_ptr,
            bl.tile_base, None, c["n"], c["nh"], c["f"], bl.window, bl.wb,
            eps, SLOPE, bl.eb, bl.nb, True, bl.dmax)

    def tfn(h, a, s, dd):
        return tw.fused_gat_window_v7(h, a, s, dd, c["tbl"], None, c["n"],
                                      c["nh"], c["f"], eps, SLOPE,
                                      two_phase=two_phase)

    return jfn, tfn


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("two_phase", [False, True])
@pytest.mark.parametrize("nh,f", SHAPES)
def test_v7_op_by_sender_matches_jax(nh, f, two_phase, bf16, monkeypatch):
    """The single-sweep and 2-phase op, whose backward is the plain
    version by sender, against the JAX VJP (interpret mode), with dropout
    and eps = 1 (so that every cotangent term is of order 1)."""
    if two_phase:
        monkeypatch.setenv("GAT_TPU_V10", "0")
    if bf16:
        monkeypatch.delenv("GAT_TPU_V6_DTYPE")
    c = small_case(nh, f, seed=3)
    args = [c[k] for k in ("h", "a_src", "s_dst", "drop")]
    (jout, jg), (tout, tg) = run_both(args, *v7_fns(c, 1.0, two_phase))
    out_tol, grad_tol = (BF16_TOL, BF16_TOL) if bf16 else (3e-5, 2e-5)
    assert_close([tout], [jout], out_tol, ("out",))
    assert_close(tg, jg, grad_tol, ("h", "a_src", "s_dst", "drop"))
    assert np.all(tg[3][c["tbl"].recv.numpy() < 0] == 0.0)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("nh,f", [(8, 8), (8, 3)])
def test_v7_parts_by_sender_matches_jax(nh, f, bf16, monkeypatch):
    """The parts op on the hybrid layout's in-window slots against the
    JAX package's, the loss taking all three parts (so that d(num), d(den)
    and d(cap) are all live)."""
    if bf16:
        monkeypatch.delenv("GAT_TPU_V6_DTYPE")
    c = hybrid_case(nh, f, True)
    bl = c["jbl"]
    w = np.random.default_rng(7).normal(size=(c["n"], nh)).astype(np.float32)

    def jfn(hh, aa, ss, dd):
        num, den, cap, _ = jfsw.v7_sweep1_parts(
            hh, aa, ss, dd, bl.send, bl.recv, bl.base, bl.tile_ptr,
            bl.tile_base, c["n"], nh, f, bl.window, bl.wb, EPS, SLOPE,
            bl.eb, bl.nb, True, bl.dmax)
        return jnp.concatenate([num, den * w, jnp.full((1, nh), cap)
                                + jnp.zeros((c["n"], nh))], axis=1)

    def tfn(hh, aa, ss, dd):
        num, den, cap, _ = tw.v7_sweep1_parts(hh, aa, ss, dd, c["tbl"],
                                              c["n"], nh, f, EPS, SLOPE)
        return torch.cat([num, den * torch.tensor(w),
                          cap.expand(c["n"], nh)], dim=1)

    args = [c[k] for k in ("h", "a_src", "s_dst", "drop")]
    (jout, jg), (tout, tg) = run_both(args, jfn, tfn)
    out_tol, grad_tol = (BF16_TOL, BF16_TOL) if bf16 else (1e-5, 2e-5)
    assert_close([tout], [jout], out_tol, ("parts",))
    assert_close(tg, jg, grad_tol, ("h", "a_src", "s_dst", "drop"))
