"""The v5 op's backward by sender (row 2 at rows of 256 floats or fewer):
d(h) summed by sender inside the backward and returned per node, in every
mode.

On the card the backward entries (v5_backward in its normalised and parts
modes, v5_backward_two_phase) run the kernel by sender at rows of WIDE_D
floats or fewer, whose contract is the plain versions
v5_backward_by_sender_plain and v5_backward_two_phase_by_sender_plain:
d(h) (rows of h, D) per node, each sender's edges' d(h) terms summed in
ascending position of its run of src_order, from 0, and d(a_src) = h^T S,
S the per-sender sums of d(raw). chip_smoke.py holds the kernel to them.
Here the plain versions are held:
  * to the route they replace, the TPU kernel's per-edge rows
    (v5_backward_plain) reduced by sender through dh_reduce_ptr: d(h),
    d(drop) and d(s_dst) to the bits; d(a_src) and d(cap), the same sums
    in another association, within 1e-5 of max(1, |ref|); the ops' CPU
    route (v5_backward and v5_backward_two_phase on CPU tensors: the rows,
    then the JAX package's d(h) reduce) to the same d(h) bits;
  * through the ops, their backward routed through the plain versions by
    sender (as the card routes it through the kernel), to the JAX
    package's VJP in interpret mode: fused_gat_table_autocap,
    v5_sweep1_parts with more source rows than destinations, the 2-phase
    fused_gat_table with more source rows and a cap below the largest
    logit, and the v6 form (window_attention.fused_gat_window). float32
    within 1e-5 (outputs) and 2e-5 (cotangents) of max(|ref|, 1), the
    tolerances of tests/test_torch_parts.py; the bfloat16 table mode
    (GAT_TPU_H_DTYPE) and the v6 form's bfloat16 mode within 1e-2 of the
    scale, live, and 10x nearer the JAX result than the port's float32
    result (tests/test_torch_bf16_window.py's checks);
  * on the edge cases: padding edges (zero d(drop)), senders without a
    real edge (zero d(h)), destinations without a real edge (zero
    d(s_dst)), an h table with more rows than destinations; at 8x8, 1x7,
    4x12 and 8x3, with dropout (each through the ops at two of them).
"""

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
from gat_pytorch_tpu_torch.ops.cuda.rounding import FLOAT32, Rounding
from gat_pytorch_tpu_torch.ops.cuda.segment_sum import dh_reduce_ptr

from .test_torch_bf16_window import assert_bf16_mode
from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_parts import assert_close, op_inputs
from .test_torch_two_phase_ops import run_both
from .test_torch_window_attention import banded_edges

SLOPE = 0.01
EPS = 1e-8
SHAPES = [(8, 8), (1, 7), (4, 12), (8, 3)]
N, N_SRC, E_REAL, PAD = 128, 160, 300, 20
# rows d(h) of the JAX package (its tests' tolerances)
OUT_TOL, GRAD_TOL = 1e-5, 2e-5
ROUNDINGS = {"float32": FLOAT32,
             "table": Rounding(table=True, acc=True),
             "v6": tw.V6_BF16}


def sender_case(nh, f, seed=11, n_src=N_SRC, dropout=True):
    """Edges into the even nodes below N - 1 (the odd ones receive none),
    from senders that are not multiples of 5 (those send none) below
    n_src - 1, then PAD padding edges from the last sender into the sink
    N - 1; src_order the stable sort by sender."""
    rng = np.random.default_rng(seed)
    recv = np.concatenate([np.sort(rng.choice(np.arange(0, N - 1, 2),
                                              E_REAL)),
                           np.full(PAD, N - 1)]).astype(np.int32)
    pool = np.array([s for s in range(n_src - 1) if s % 5])
    send = np.concatenate([rng.choice(pool, E_REAL),
                           np.full(PAD, n_src - 1)]).astype(np.int32)
    c = op_inputs(rng, n_src, N, nh, f, E_REAL + PAD, dropout)
    c.update(n=N, n_src=n_src, nh=nh, f=f, e_real=E_REAL, send=send,
             recv=recv, order=np.argsort(send, kind="stable"
                                         ).astype(np.int32))
    return c


def mode_args(c, mode, rnd, seed=3):
    """(plain by sender, plain per-edge rows, the ops' CPU route, their
    arguments) of one backward mode, with random cotangents and the
    forward's outputs from its plain version."""
    t = {k: torch.tensor(c[k]) for k in ("h", "a_src", "s_dst", "send",
                                         "recv")}
    drop = None if c["drop"] is None else torch.tensor(c["drop"])
    h = rnd.table_of(t["h"])
    er, nh, f = c["e_real"], c["nh"], c["f"]
    rng = np.random.default_rng(seed)
    g = torch.tensor(rng.normal(size=(N, nh * f)).astype(np.float32))
    graph = (t["send"], t["recv"], er)
    if mode == "two_phase":
        cap = torch.tensor(0.3)
        fa = (h, t["a_src"], t["s_dst"], cap, drop) + graph + (1.0, SLOPE)
        out, den = tv5.v5_forward_two_phase_plain(*fa, rounding=rnd)
        args = fa + (g, out, den, drop is not None)
        return (tv5.v5_backward_two_phase_by_sender_plain,
                tv5.v5_backward_two_phase_plain, tv5.v5_backward_two_phase,
                args, {"rounding": rnd})
    fa = (h, t["a_src"], t["s_dst"], drop) + graph + (SLOPE,)
    num, den, cap, _ = tv5.v5_forward_plain(*fa, rounding=rnd)
    norm = mode == "normalised"
    if norm:
        out, epsp = tv5.normalise(num, den, cap, 1.0, SLOPE, nh)
        co = (g, out, den, epsp)
    else:
        d_den = torch.tensor(rng.normal(size=(N, nh)).astype(np.float32))
        co = (g, None, d_den, None)
    return (tv5.v5_backward_by_sender_plain, tv5.v5_backward_plain,
            tv5.v5_backward, fa + co + (drop is not None,),
            {"normalize": norm, "rounding": rnd})


@pytest.mark.parametrize("mode,rounding", [
    ("normalised", "float32"), ("normalised", "table"),
    ("parts", "float32"), ("parts", "table"), ("two_phase", "float32"),
    ("two_phase", "table"), ("two_phase", "v6")])
@pytest.mark.parametrize("nh,f", SHAPES)
def test_by_sender_has_the_bits_of_the_per_edge_route(nh, f, mode,
                                                      rounding):
    c = sender_case(nh, f)
    rnd = ROUNDINGS[rounding]
    by_sender, rows_plain, op_route, args, kw = mode_args(c, mode, rnd)
    got = by_sender(*args, **kw)
    rows, *rest = rows_plain(*args, **kw)
    order = torch.tensor(c["order"][:c["e_real"]])
    ptr = torch.searchsorted(torch.tensor(c["send"])[order.long()],
                             torch.arange(N_SRC + 1, dtype=torch.int32),
                             out_int32=True)
    assert got[0].shape == (N_SRC, nh * f)
    assert torch.equal(got[0], dh_reduce_ptr(rows, order, ptr))
    # d(drop), d(s_dst) to the bits; d(a_src) (and d(cap)) by sender
    assert torch.equal(got[1], rest[0]) and torch.equal(got[2], rest[1])
    assert_close([x.numpy() for x in got[3:]], [x.numpy() for x in rest[2:]],
                 1e-5, ("d_a_src", "d_cap")[:len(got) - 3])
    # the same runs given as the graph carries them: the same bits
    again = by_sender(*args, **kw, src_order=torch.tensor(c["order"]),
                      src_ptr=ptr)
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    # the ops' CPU route: the rows, then the d(h) reduce
    assert torch.equal(op_route(*args, **kw)[0], got[0])
    # senders without a real edge, destinations without one, padding edges
    idle = np.ones(N_SRC, bool)
    idle[c["send"][:c["e_real"]]] = False
    assert idle.sum() > 25 and bool((got[0][idle] == 0).all())
    assert bool(got[0][~idle].abs().sum(1).gt(0).all())
    assert bool((got[2][1:N - 1:2] == 0).all())
    assert bool((got[1][c["e_real"]:] == 0).all())


def autocap_fns(c, two_phase=False):
    sd, rc, od = (jnp.asarray(c[k]) for k in ("send", "recv", "order"))
    send, recv, order = (torch.tensor(c[k]) for k in ("send", "recv",
                                                      "order"))
    n, nh, f, er = c["n"], c["nh"], c["f"], c["e_real"]

    def jfn(h, a, s, dd):
        return jfsa.fused_gat_table_autocap(
            h, a, s, dd, sd, rc, od, jnp.int32(er), None, n, nh, f, 1.0,
            SLOPE, 256, 128, True)

    def tfn(h, a, s, dd):
        return tv5.fused_gat_table_autocap(h, a, s, dd, send, recv, order,
                                           er, None, n, nh, f, 1.0, SLOPE,
                                           two_phase)

    return jfn, tfn


def parts_fns(c):
    """v5_sweep1_parts over an h table of more rows than destinations,
    the loss reading num, den and cap'."""
    sd, rc, od = (jnp.asarray(c[k]) for k in ("send", "recv", "order"))
    send, recv, order = (torch.tensor(c[k]) for k in ("send", "recv",
                                                      "order"))
    n, nh, f, er = c["n"], c["nh"], c["f"], c["e_real"]
    w = np.random.default_rng(5).normal(size=(n, nh)).astype(np.float32)

    def jfn(h, a, s, dd):
        num, den, cap, _ = jfsa.v5_sweep1_parts(
            h, a, s, dd, sd, rc, od, jnp.int32(er), n, nh, f, EPS, SLOPE,
            256, 128, True, c["n_src"])
        return jnp.concatenate([num, den * w, jnp.zeros((n, nh)) + cap],
                               axis=1)

    def tfn(h, a, s, dd):
        num, den, cap, _ = tv5.v5_sweep1_parts(
            h, a, s, dd, send, recv, order, er, n, nh, f, EPS, SLOPE,
            c["n_src"])
        return torch.cat([num, den * torch.tensor(w), cap.expand(n, nh)],
                         dim=1)

    return jfn, tfn


def two_phase_fns(c):
    """fused_gat_table with an explicit cap below 1% of the logits (those
    take LeakyReLU's positive branch) over more source rows."""
    sd, rc, od = (jnp.asarray(c[k]) for k in ("send", "recv", "order"))
    send, recv, order = (torch.tensor(c[k]) for k in ("send", "recv",
                                                      "order"))
    n, nh, f, er = c["n"], c["nh"], c["f"], c["e_real"]
    raw = np.sort((c["h"][c["send"][:er]].astype(np.float64) @ c["a_src"]
                   + c["s_dst"][c["recv"][:er]]).reshape(-1))
    i = int(raw.size * 0.99)
    cap = np.float32((raw[i] + raw[i + 1]) / 2)

    def jfn(h, a, s, dd):
        return jfsa.fused_gat_table(h, a, s, jnp.asarray(cap), dd, sd, rc,
                                    od, jnp.int32(er), n, nh, f, 1.0, SLOPE,
                                    256, 128, True, c["n_src"])

    def tfn(h, a, s, dd):
        return tv5.fused_gat_table(h, a, s, torch.tensor(cap), dd, send,
                                   recv, order, er, n, nh, f, 1.0, SLOPE,
                                   c["n_src"])

    return jfn, tfn


OPS = {"autocap": autocap_fns, "parts": parts_fns,
       "two_phase": two_phase_fns}


@pytest.fixture
def by_sender(monkeypatch):
    """The ops' backward through the plain versions by sender, the card
    kernel's contract (the CPU route takes the per-edge rows and the JAX
    package's d(h) reduce)."""
    def bwd(*a, dst_ptr=None, transposed=False, **kw):
        return tv5.v5_backward_by_sender_plain(*a, **kw)

    def bwd2(*a, dst_ptr=None, transposed=False, **kw):
        return tv5.v5_backward_two_phase_by_sender_plain(*a, **kw)

    monkeypatch.setattr(tv5, "v5_backward", bwd)
    monkeypatch.setattr(tv5, "v5_backward_two_phase", bwd2)


def args_of(c):
    return [c[k] for k in ("h", "a_src", "s_dst", "drop")]


# each op at two of the shapes, every shape at least once: the single
# sweep at Cora's, the parts op at the hybrid remainder's (Pubmed's), the
# 2-phase op at PATTERN's and Pubmed's (an interpret-mode VJP takes about
# 5 s on one worker)
@pytest.mark.parametrize("op,nh,f", [
    ("autocap", 8, 8), ("autocap", 1, 7), ("parts", 8, 8), ("parts", 8, 3),
    ("two_phase", 4, 12), ("two_phase", 8, 3)])
def test_ops_by_sender_match_jax(op, nh, f, by_sender):
    n_src = N if op == "autocap" else N_SRC
    c = sender_case(nh, f, seed=nh * 10 + f, n_src=n_src)
    (jout, jg), (tout, tg) = run_both(args_of(c), *OPS[op](c))
    assert_close([tout], [jout], OUT_TOL, ("out",))
    assert_close(tg, jg, GRAD_TOL, ("h", "a_src", "s_dst", "drop"))
    assert tg[0].shape == (n_src, nh * f)


@pytest.mark.parametrize("op", ["autocap", "two_phase"])
def test_ops_by_sender_bf16_table_mode_matches_jax(op, by_sender,
                                                   monkeypatch):
    """GAT_TPU_H_DTYPE=bfloat16 (the modes of the Cora bf16 fits): every
    product of the backward reads the rounded rows; d(h) stays
    float32."""
    n_src = N if op == "autocap" else N_SRC
    c = sender_case(8, 8, seed=23, n_src=n_src)
    fns = OPS[op](c)
    f32 = run_both(args_of(c), *fns)[1]
    monkeypatch.setenv("GAT_TPU_H_DTYPE", "bfloat16")
    want, got = run_both(args_of(c), *fns)
    assert_bf16_mode(got, want, f32)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_v6_form_by_sender_matches_jax(bf16, by_sender, monkeypatch):
    """fused_gat_window (the v6 form: the v5 2-phase entries over the
    graph's own edges) on a banded graph; its bfloat16 mode rounds the
    rows, each edge's d(h) term (kRoundDh) and d(raw) in d(a_src)."""
    if bf16:
        monkeypatch.delenv("GAT_TPU_V6_DTYPE")
    n, nh, f = 800, 8, 8
    send, recv = banded_edges(3, n=n, e=4000, band=300)
    x = np.zeros((n, 1), np.float32)
    jg = JT.canonicalize(x, send, recv, src_windows=True)
    tg = TT.canonicalize(x, send, recv, src_windows=True)
    n_pad, e, er = tg.num_nodes, tg.num_edges, tg.num_real_edges
    window = min(-(-tg.src_band // 8) * 8, -(-n_pad // 8) * 8)
    rng = np.random.default_rng(6)
    args = [rng.normal(size=(n_pad, nh * f)).astype(np.float32),
            (rng.normal(size=(nh * f, nh)) / np.sqrt(nh * f)
             ).astype(np.float32),
            rng.normal(size=(n_pad, nh)).astype(np.float32),
            (rng.random((e, nh)) > 0.4).astype(np.float32) / 0.6]

    def jfn(h, a, s, dd):
        return jfsw.fused_gat_window(h, a, s, dd, jg.senders, jg.receivers,
                                     jnp.int32(er), jg.tile_lo, n_pad, nh, f,
                                     window, 1.0, SLOPE, 256, 128, True)

    def tfn(h, a, s, dd):
        return tw.fused_gat_window(h, a, s, dd, tg.senders, tg.receivers, er,
                                   tg.tile_lo, n_pad, nh, f, window, 1.0,
                                   SLOPE)

    want, got = run_both(args, jfn, tfn)
    if not bf16:
        assert_close([got[0]], [want[0]], OUT_TOL, ("out",))
        assert_close(got[1], want[1], GRAD_TOL,
                     ("h", "a_src", "s_dst", "drop"))
        return
    monkeypatch.setenv("GAT_TPU_V6_DTYPE", "float32")
    f32 = run_both(args, jfn, tfn)[1]
    monkeypatch.delenv("GAT_TPU_V6_DTYPE")
    assert_bf16_mode(got, want, f32)
