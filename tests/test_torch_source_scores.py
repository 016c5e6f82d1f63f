"""The source-score pass and the v5 and windowed ops that read it.

Every v5 and windowed kernel takes its raw logit from one table of its op
call, s_src = h @ a_src (ops/cuda/v5_attention.source_scores), which the
op's autograd Function computes once in its forward, hands to its cap
pass and saves for its backward. On CPU tensors the port runs the plain
versions of its kernels, which read the same table. Held here:
  * source_scores_plain against jnp.dot(h, a_src) at 1e-5 of
    max(|ref|, 1), the v5 op's output tolerance (two float32 products in
    the orders of two BLAS builds), from a float32 table and from a
    bfloat16-rounded one;
  * the v5 ops (sweep-1, parts, 2-phase) and the windowed ops (sweep-1,
    2-phase) against the JAX package's, run as its own tests run them
    (Pallas in interpret mode; the windowed ones with float32
    contractions), at 8x8, 8x3, 1x7 and 4x256: outputs at 1e-5 and every
    gradient at 2e-5 after dividing by max(|ref|, 1), the tolerances of
    the parity tests (tests/test_torch_parts.py), the 2-phase ops with
    the reference's own cap, where the argmax edge takes LeakyReLU's
    slope at 0 (its pre-activation is 0 exactly, in both packages);
  * that each op computes the table once a call;
  * entries given their own table give the bits of entries that compute
    it, and every wrapper refuses a table of another shape, dtype or
    device;
  * the lane plans of the forward and of the score pass at every width
    the fits run: each element covered once, and two heads in one vector
    only where the kernel tests each element.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.ops.pallas import segment_attention as jfsa
from gat_pytorch_tpu.ops.pallas import segment_attention_window as jfsw
from gat_pytorch_tpu_torch.ops.cuda import v5_attention as tv5
from gat_pytorch_tpu_torch.ops.cuda import window_attention as tw

from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_parts import assert_close, v5_case, v5_parts_pair
from .test_torch_parts import assert_same as assert_parts_same
from .test_torch_two_phase_ops import edge_arrays, jax_edges, run_both
from .test_torch_window_attention import banded_edges, make_case

SLOPE = 0.01
EPS = 1e-8
GRADS = ("h", "a_src", "s_dst", "drop")
# (heads, features) of every layer width the fits run: 1, 7, 24, 48, 64,
# 96, 726 and 1024
WIDTHS = [(1, 1), (1, 7), (8, 3), (4, 12), (8, 8), (4, 24), (6, 121),
          (4, 256)]
OP_SHAPES = [(8, 8), (8, 3), (1, 7), (4, 256)]


def scores_case(nh, f, seed=0, n=96):
    rng = np.random.default_rng(seed)
    d = nh * f
    return (rng.normal(size=(n, d)).astype(np.float32),
            (rng.normal(size=(d, nh)) / np.sqrt(d)).astype(np.float32))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("nh,f", WIDTHS)
def test_source_scores_plain_matches_jnp_dot(nh, f, bf16):
    h, a = scores_case(nh, f)
    h_t = torch.tensor(h)
    if bf16:        # the table mode's table: the rows rounded once
        h_t = h_t.to(torch.bfloat16)
        h = h_t.float().numpy()
    want = np.asarray(jnp.dot(jnp.asarray(h), jnp.asarray(a)))
    got = tv5.source_scores(h_t, torch.tensor(a))
    assert got.dtype == torch.float32 and got.shape == (h.shape[0], nh)
    assert torch.equal(got, tv5.source_scores_plain(h_t, torch.tensor(a)))
    # two float32 products of up to 1024 terms, each BLAS build summing in
    # its own order: held as the v5 op's outputs are, which carry them
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale


# -- the ops against the JAX package -----------------------------------------

def v5_args(c, dropout):
    args = [c["h"], c["a_src"], c["s_dst"]]
    return args + [c["drop"]] if dropout else args


def small_v5_case(nh, f, dropout, seed):
    """A small v5_case (the JAX kernel runs interpreted)."""
    return v5_case(nh, f, dropout, seed=seed, n=96, e_real=500, pad=12)


def count_scores(monkeypatch):
    """A list that gets one entry per source_scores call."""
    calls = []
    real = tv5.source_scores

    def counted(h, a_src):
        calls.append(h.shape)
        return real(h, a_src)

    monkeypatch.setattr(tv5, "source_scores", counted)
    return calls


@pytest.mark.parametrize("nh,f", OP_SHAPES)
def test_v5_op_reads_one_table(nh, f, monkeypatch):
    """The sweep-1 op against the JAX autocap op; the table is computed
    once for the forward and the backward."""
    calls = count_scores(monkeypatch)
    c = small_v5_case(nh, f, True, seed=11)
    n, er = c["n"], c["e_real"]
    sd, rc, od = jax_edges(c)
    send, recv, order = edge_arrays(c)

    def jfn(h, a, s, dd):
        return jfsa.fused_gat_table_autocap(
            h, a, s, dd, sd, rc, od, jnp.int32(er), None, n, nh, f, EPS,
            SLOPE, 256, 128, True)

    def tfn(h, a, s, dd):
        return tv5.fused_gat_table_autocap(
            h, a, s, dd, send, recv, order, er, None, n, nh, f, EPS, SLOPE)

    (jout, jg), (tout, tg) = run_both(v5_args(c, True), jfn, tfn)
    assert_close([tout], [jout], 1e-5, ("out",))
    assert_close(tg, jg, 2e-5, GRADS)
    assert len(calls) == 1


@pytest.mark.parametrize("nh,f", OP_SHAPES)
def test_v5_parts_op_reads_one_table(nh, f, monkeypatch):
    calls = count_scores(monkeypatch)
    c = small_v5_case(nh, f, True, seed=12)
    assert_parts_same(c, *v5_parts_pair(c), nh)
    assert len(calls) == 1


@pytest.mark.parametrize("nh,f", OP_SHAPES)
def test_v5_two_phase_op_at_the_cap(nh, f, monkeypatch):
    """The 2-phase op with the reference's cap (GAT_TPU_V10=0 on the JAX
    side): its argmax edge has pre == 0 and takes the slope. The cap
    pass, the forward and the backward read one table."""
    monkeypatch.setenv("GAT_TPU_V10", "0")
    calls = count_scores(monkeypatch)
    c = small_v5_case(nh, f, True, seed=13)
    n, er = c["n"], c["e_real"]
    sd, rc, od = jax_edges(c)
    send, recv, order = edge_arrays(c)

    def jfn(h, a, s, dd):
        return jfsa.fused_gat_table_autocap(
            h, a, s, dd, sd, rc, od, jnp.int32(er), None, n, nh, f, 1.0,
            SLOPE, 256, 128, True)

    def tfn(h, a, s, dd):
        return tv5.fused_gat_table_autocap(
            h, a, s, dd, send, recv, order, er, None, n, nh, f, 1.0, SLOPE,
            two_phase=True)

    (jout, jg), (tout, tg) = run_both(v5_args(c, True), jfn, tfn)
    assert_close([tout], [jout], 1e-5, ("out",))
    assert_close(tg, jg, 2e-5, GRADS)
    assert len(calls) == 1
    # the argmax edge's pre-activation is 0 in the port's own arithmetic
    t = {k: torch.tensor(c[k]) for k in ("h", "a_src", "s_dst")}
    s_src = tv5.source_scores(t["h"], t["a_src"])
    cap, code = tv5.v5_cap(t["h"], t["a_src"], t["s_dst"], send, recv, er,
                           s_src=s_src)
    e_star, k_star = divmod(int(code), nh)
    pre = (s_src[send[e_star].long(), k_star]
           + t["s_dst"][recv[e_star].long(), k_star]) - cap
    assert float(pre) == 0.0


def window_case(nh, f, dropout, seed):
    """A small banded graph's layout (the JAX kernel runs interpreted)."""
    send, recv = banded_edges(seed, n=300, e=1200, band=120)
    return make_case(nh, f, send, recv, 300, seed=seed, dropout=dropout)


def window_fns(c, eps, two_phase):
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


@pytest.mark.parametrize("two_phase", [False, True])
@pytest.mark.parametrize("nh,f", OP_SHAPES)
def test_window_op_reads_one_table(nh, f, two_phase, monkeypatch):
    """The windowed op, single sweep and 2-phase (GAT_TPU_V10=0 on the JAX
    side, the reference's cap at eps = 1), against the JAX v7 op."""
    if two_phase:
        monkeypatch.setenv("GAT_TPU_V10", "0")
    calls = count_scores(monkeypatch)
    eps = 1.0 if two_phase else EPS
    c = window_case(nh, f, True, seed=14)
    args = [c[k] for k in ("h", "a_src", "s_dst", "drop")]
    (jout, jg), (tout, tg) = run_both(args, *window_fns(c, eps, two_phase))
    assert_close([tout], [jout], 1e-5, ("out",))
    assert_close(tg, jg, 2e-5, GRADS)
    assert len(calls) == 1


# -- entries given a table, and tables refused -------------------------------

def entry_case():
    c = v5_case(8, 3, True, seed=15)
    t = {k: torch.tensor(c[k]) for k in ("h", "a_src", "s_dst", "drop")}
    send, recv, order = edge_arrays(c)
    g = torch.tensor(np.random.default_rng(16).normal(
        size=(c["n"], 24)).astype(np.float32))
    return c, t, send, recv, g


def v5_entries(c, t, send, recv, g):
    """name -> a call of each v5 entry with **kw (s_src=...)."""
    er = c["e_real"]
    base = (t["h"], t["a_src"], t["s_dst"])
    graph = (send, recv, er)
    cap = torch.tensor(0.5)
    num, den, cp, _ = tv5.v5_forward(*base, t["drop"], *graph, SLOPE)
    out, epsp = tv5.normalise(num, den, cp, EPS, SLOPE, 8)
    return {
        "v5_forward": lambda **kw: tv5.v5_forward(
            *base, t["drop"], *graph, SLOPE, **kw),
        "v5_backward": lambda **kw: tv5.v5_backward(
            *base, t["drop"], *graph, SLOPE, g, out, den, epsp, True, **kw),
        "v5_cap": lambda **kw: tv5.v5_cap(*base, *graph, **kw),
        "v5_forward_two_phase": lambda **kw: tv5.v5_forward_two_phase(
            *base, cap, t["drop"], *graph, EPS, SLOPE, **kw),
        "v5_backward_two_phase": lambda **kw: tv5.v5_backward_two_phase(
            *base, cap, t["drop"], *graph, EPS, SLOPE, g, out, den, True,
            **kw),
    }


def window_entries(nh=8, f=8):
    c = window_case(nh, f, True, seed=17)
    t = {k: torch.tensor(c[k]) for k in ("h", "a_src", "s_dst", "drop")}
    bl = c["tbl"]
    base = (t["h"], t["a_src"], t["s_dst"])
    g = torch.ones((c["n"], nh * f))
    cap = torch.tensor(0.2)
    num, den, cp, _ = tw.window_forward(*base, t["drop"], bl, SLOPE)
    out, epsp = tv5.normalise(num, den, cp, EPS, SLOPE, nh)
    return t, {
        "window_forward": lambda **kw: tw.window_forward(
            *base, t["drop"], bl, SLOPE, **kw),
        "window_backward": lambda **kw: tw.window_backward(
            *base, t["drop"], bl, SLOPE, g, out, den, epsp, True, **kw),
        "window_forward_two_phase": lambda **kw: tw.window_forward_two_phase(
            *base, cap, t["drop"], bl, EPS, SLOPE, **kw),
        "window_backward_two_phase":
            lambda **kw: tw.window_backward_two_phase(
                *base, cap, t["drop"], bl, EPS, SLOPE, g, out, den, True,
                **kw),
    }, bl


def flat(outs):
    return [o for o in outs if o is not None]


def test_entries_given_their_table_give_the_same_bits():
    c, t, send, recv, g = entry_case()
    s_src = tv5.source_scores(t["h"], t["a_src"])
    for name, call in v5_entries(c, t, send, recv, g).items():
        for x, y in zip(flat(call()), flat(call(s_src=s_src))):
            assert torch.equal(x, y), name
    tw_t, calls, bl = window_entries()
    s_src = tv5.source_scores(tw_t["h"], tw_t["a_src"])
    for name, call in calls.items():
        outs = call()
        for x, y in zip(flat(outs), flat(call(s_src=s_src))):
            assert torch.equal(x, y), name
        if "backward" in name:  # d(h) summed by sender, one row a node
            assert outs[0].shape == tw_t["h"].shape, name
    got = tw.window_cap(s_src, tw_t["s_dst"], bl)
    want = tw.window_cap_plain(s_src, tw_t["s_dst"], bl)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def bad_tables(n, nh):
    good = torch.zeros((n, nh))
    return {"shape": torch.zeros((n, nh + 1)),
            "rows": torch.zeros((n - 1, nh)),
            "dtype": good.double(),
            "device": good.to("meta"),
            "contiguity": torch.zeros((nh, n)).t()}


def test_wrappers_refuse_a_table_of_the_wrong_shape_dtype_or_device():
    c, t, send, recv, g = entry_case()
    for name, call in v5_entries(c, t, send, recv, g).items():
        for why, bad in bad_tables(c["n"], 8).items():
            with pytest.raises(ValueError, match="s_src"):
                call(s_src=bad)
    tw_t, calls, bl = window_entries()
    n = tw_t["h"].shape[0]
    for name, call in calls.items():
        for why, bad in bad_tables(n, 8).items():
            with pytest.raises(ValueError, match="s_src"):
                call(s_src=bad)
    for why in ("shape", "dtype", "device"):
        with pytest.raises(ValueError, match="s_src"):
            tw.window_cap(bad_tables(n, 8)[why], tw_t["s_dst"], bl)
    with pytest.raises(ValueError, match="s_src"):
        tv5.fused_gat_table(t["h"], t["a_src"], t["s_dst"], 0.0, None, send,
                            recv, torch.tensor(c["order"]), c["e_real"],
                            c["n"], 8, 3, s_src=torch.zeros((c["n"], 7)))


# -- lane plans ---------------------------------------------------------------

def forward_cover(plan, nh, f):
    """For each element j of a row, the (lane, c, v) places that add it
    into its own head's sum, and whether a place's vector meets two heads
    without its elements being tested: the indexing of
    attention_fwd_wide / attention_fwd_narrow (csrc/attention_common.cuh)."""
    d, v_ = nh * f, plan.vec
    places = {j: [] for j in range(d)}
    untested = []
    if plan.wide:
        for k in range(nh):     # warp k, head k: stores keep head k's only
            lo = k * f
            for lane in range(32):
                for c in range(plan.per_lane):
                    first = lo - lo % v_ + v_ * (lane + 32 * c)
                    for v in range(v_):
                        j = first + v
                        if lo <= j < lo + f:
                            places[j].append((k, lane, c, v))
        return places, untested
    tested = f % v_ != 0          # the kernel's `split`: each element tested
    for t in range(plan.lanes):
        for c in range(plan.per_lane):
            first = v_ * (t + plan.lanes * c)
            if first >= d:
                continue
            heads = {(first + v) // f for v in range(v_)}
            if len(heads) > 2 or (len(heads) == 2 and not tested):
                untested.append((t, c))
            for v in range(v_):
                places[first + v].append((t, c, v))
    return places, untested


@pytest.mark.parametrize("align", [4, 2, 1])
@pytest.mark.parametrize("nh,f", WIDTHS + [(8, 1), (2, 33), (1, 1023)])
def test_forward_lane_plan_covers_each_element_once(nh, f, align):
    plan = tv5.lane_plan(nh, f, align)
    assert plan.vec <= align and (nh * f) % plan.vec == 0
    assert plan.wide == (f >= 32)
    places, untested = forward_cover(plan, nh, f)
    assert all(len(p) == 1 for p in places.values())
    assert not untested
    elems = plan.vec * plan.per_lane
    assert plan.unroll in (2, tv5.in_flight(elems))
    if plan.wide:
        assert plan.lanes == 32 and elems <= 32
        assert plan.unroll == tv5.in_flight(elems)
    else:
        assert plan.lanes & (plan.lanes - 1) == 0 and plan.lanes <= 32
        assert plan.vec * plan.per_lane <= 8
        # lanes fit the row: fewer lanes, or fewer vectors a lane, would
        # not cover it
        cover = plan.lanes * plan.per_lane * plan.vec
        assert cover // 2 < nh * f <= cover or plan.lanes == 1


@pytest.mark.parametrize("align", [4, 1])
@pytest.mark.parametrize("d", [1, 7, 24, 48, 64, 96, 726, 1024, 1023])
def test_score_plan_covers_each_element_once(d, align):
    plan = tv5.score_plan(d, align)
    assert plan.vec <= align and d % plan.vec == 0 and plan.per_lane <= 8
    chunk = plan.lanes * plan.vec * plan.per_lane
    seen = np.zeros(d, int)
    for c0 in range(0, d, chunk):
        for t in range(plan.lanes):
            for c in range(plan.per_lane):
                for v in range(plan.vec):
                    j = c0 + plan.vec * (t + plan.lanes * c) + v
                    if j < d:
                        seen[j] += 1
    assert np.all(seen == 1)
