"""The v5 op's backward by sender (row 2): d(h) summed by sender inside
the backward and returned per node, in every mode, at every row width
and table type.

The backward entries (v5_backward in its normalised and parts modes,
v5_backward_two_phase) run the kernel by sender on CUDA tensors, whose
contract is the plain versions v5_backward_by_sender_plain and
v5_backward_two_phase_by_sender_plain: d(h) (rows of h, D) per node, each
sender's edges' d(h) terms summed in ascending position of its run of
src_order, from 0, and d(a_src) = h^T S, S the per-sender sums of
d(raw). chip_smoke.py holds the kernel to them. On CPU tensors the
entries run the split plain versions, the same sums in the kernel's
items (a long run cut, its partial rows added in item order). Here the
plain versions are held:
  * to the route they replace, the TPU kernel's per-edge rows
    (v5_backward_plain) reduced by sender through dh_reduce_ptr: d(h),
    d(drop) and d(s_dst) to the bits; d(a_src) and d(cap), the same sums
    in another association, within 1e-5 of max(1, |ref|); the entries on
    CPU tensors to the same d(h) bits where no run is cut;
  * each op's backward on CPU tensors to its kernel's plain version bit
    for bit, on a graph whose hub's run the kernel's items cut: the v5
    op, its parts op and its 2-phase op (the split plain versions), and
    the table op (table_backward_by_sender_plain);
  * through the ops to the JAX package's VJP in interpret mode: fused_gat_table_autocap,
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
from gat_pytorch_tpu_torch.ops.cuda import build
from gat_pytorch_tpu_torch.ops.cuda import table_attention as tv4
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
    # the entries on CPU tensors, in the kernel's items: no run is cut here
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


def args_of(c):
    return [c[k] for k in ("h", "a_src", "s_dst", "drop")]


# each op at two of the shapes, every shape at least once: the single
# sweep at Cora's, the parts op at the hybrid remainder's (Pubmed's), the
# 2-phase op at PATTERN's and Pubmed's (an interpret-mode VJP takes about
# 5 s on one worker)
@pytest.mark.parametrize("op,nh,f", [
    ("autocap", 8, 8), ("autocap", 1, 7), ("parts", 8, 8), ("parts", 8, 3),
    ("two_phase", 4, 12), ("two_phase", 8, 3)])
def test_ops_by_sender_match_jax(op, nh, f):
    n_src = N if op == "autocap" else N_SRC
    c = sender_case(nh, f, seed=nh * 10 + f, n_src=n_src)
    (jout, jg), (tout, tg) = run_both(args_of(c), *OPS[op](c))
    assert_close([tout], [jout], OUT_TOL, ("out",))
    assert_close(tg, jg, GRAD_TOL, ("h", "a_src", "s_dst", "drop"))
    assert tg[0].shape == (n_src, nh * f)


@pytest.mark.parametrize("op", ["autocap", "two_phase"])
def test_ops_by_sender_bf16_table_mode_matches_jax(op, monkeypatch):
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
def test_v6_form_by_sender_matches_jax(bf16, monkeypatch):
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


# -- each op's backward on CPU tensors: its kernel's plain version -----------

HUB = 150       # sender 3's slots: more than build.SPLIT_MIN, so cut


def hub_case(nh, f, seed=31):
    """sender_case's graph (N source rows) with HUB more real edges from
    sender 3 into the even destinations, dst-sorted, the padding edges
    last, and a dropout mask over them all."""
    c = sender_case(nh, f, seed=seed, n_src=N)
    rng = np.random.default_rng(seed)
    er = c["e_real"]
    send = np.concatenate([c["send"][:er], np.full(HUB, 3)])
    recv = np.concatenate([c["recv"][:er],
                           rng.choice(np.arange(0, N - 1, 2), HUB)])
    by_dst = np.argsort(recv, kind="stable")
    c.update(e_real=er + HUB,
             send=np.concatenate([send[by_dst], c["send"][er:]]
                                 ).astype(np.int32),
             recv=np.concatenate([recv[by_dst], c["recv"][er:]]
                                 ).astype(np.int32),
             drop=(rng.random((er + HUB + PAD, nh)) > 0.4
                   ).astype(np.float32) / 0.6)
    c["order"] = np.argsort(c["send"], kind="stable").astype(np.int32)
    return c


def op_and_plain(op, c):
    """(the leaves' gradients through the op for the loss sum(out * w),
    the kernel's plain version's, in the same order)."""
    t = {k: torch.tensor(c[k]) for k in ("h", "a_src", "s_dst", "drop",
                                         "send", "recv", "order")}
    h, a, s, drop = t["h"], t["a_src"], t["s_dst"], t["drop"]
    send, recv, order = t["send"], t["recv"], t["order"]
    er, nh, f = c["e_real"], c["nh"], c["f"]
    w = torch.tensor(np.random.default_rng(4).normal(
        size=(N, nh * f)).astype(np.float32))
    s_src = tv5.source_scores_plain(h, a)
    graph = (send, recv, er)
    if op == "table":
        raw = s_src.index_select(0, send.long()) + s.index_select(
            0, recv.long())
        lg = torch.where((torch.arange(send.shape[0]) < er)[:, None],
                         SLOPE * (raw - raw.max()),
                         torch.full_like(raw, tv4.NEG_INF))
        leaves = [x.clone().requires_grad_(True) for x in (lg, h, drop)]
        out = tv4.fused_segment_attention_table(
            leaves[0], leaves[1], send, recv, leaves[2], order, N, nh, f,
            EPS, er)
        out_, den = tv4.table_forward_plain(lg, h, drop, send, recv, N, er,
                                            EPS)
        d_h, d_lg, d_drop = tv4.table_backward_by_sender_plain(
            lg, h, drop, send, recv, er, EPS, w, out_, den, True, order)
        want = (d_lg, d_h, d_drop)
    elif op == "two_phase":
        cap = torch.tensor(0.3)
        leaves = [x.clone().requires_grad_(True) for x in (h, a, s, cap,
                                                            drop)]
        out = tv5.fused_gat_table(*leaves[:4], leaves[4], send, recv, order,
                                  er, N, nh, f, 1.0, SLOPE)
        fa = (h, a, s, cap, drop) + graph + (1.0, SLOPE)
        out_, den = tv5.v5_forward_two_phase_plain(*fa, s_src=s_src)
        d_h, d_drop, d_sdst, d_asrc, d_cap = (
            tv5.v5_backward_two_phase_split_plain(*fa, w, out_, den, True,
                                                  s_src=s_src))
        want = (d_h, d_asrc, d_sdst, d_cap, d_drop)
    elif op == "parts":
        w_den = torch.tensor(np.random.default_rng(5).normal(
            size=(N, nh)).astype(np.float32))
        leaves = [x.clone().requires_grad_(True) for x in (h, a, s, drop)]
        num, den, _, _ = tv5.v5_sweep1_parts(*leaves[:3], leaves[3], send,
                                             recv, order, er, N, nh, f)
        out, w = torch.cat([num, den], 1), torch.cat([w, w_den], 1)
        fa = (h, a, s, drop) + graph + (SLOPE,)
        _, _, _, code = tv5.v5_forward_plain(*fa, s_src=s_src)
        d_h, d_drop, d_sdst, d_asrc = tv5.v5_backward_split_plain(
            *fa, w[:, :nh * f], None, w_den, None, True, normalize=False,
            s_src=s_src)
        d_h, d_asrc, d_sdst = tv5.route_cap_cotangent(
            d_h, d_asrc, d_sdst, torch.zeros(()), code, send, recv, h, a,
            nh)
        want = (d_h, d_asrc, d_sdst, d_drop)
    else:
        leaves = [x.clone().requires_grad_(True) for x in (h, a, s, drop)]
        out = tv5.fused_gat_table_autocap(*leaves[:3], leaves[3], send,
                                          recv, order, er, None, N, nh, f,
                                          EPS, SLOPE)
        s_eff = (s - tv5.score_bound_of(h, a, s, s_src)).contiguous()
        fa = (h, a, s_eff, drop) + graph + (SLOPE,)
        num, den, cap, code = tv5.v5_forward_plain(*fa, s_src=s_src)
        out_, epsp = tv5.normalise(num, den, cap, EPS, SLOPE, nh)
        d_h, d_drop, d_sdst, d_asrc = tv5.v5_backward_split_plain(
            *fa, w, out_, den, epsp, True, s_src=s_src)
        d_h, d_asrc, d_sdst = tv5.route_cap_cotangent(
            d_h, d_asrc, d_sdst,
            tv5.cap_cotangent(w, out_, den, epsp, SLOPE, nh), code, send,
            recv, h, a, nh)
        want = (d_h, d_asrc, d_sdst, d_drop)
    (out * w).sum().backward()
    return [x.grad for x in leaves], want


@pytest.mark.parametrize("op", ["normalised", "parts", "two_phase",
                                "table"])
def test_op_cpu_backward_is_the_kernel_plain_version(op):
    """On CPU tensors an op's backward takes no route of its own: its
    gradients are its kernel's plain version's, bit for bit, here on a
    graph whose hub's run the kernel's items cut."""
    c = hub_case(4, 12)
    ptr = build.sender_runs(torch.tensor(c["send"]), c["e_real"], N)[1]
    assert build.sender_items(ptr, tv5.sender_warps(N)).n_split == 1
    got, want = op_and_plain(op, c)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        assert x.shape == y.shape and torch.equal(x, y)
