"""The port's sweep-1 parts ops against the JAX package's v5_sweep1_parts
and v7_sweep1_parts, run in interpret mode (the windowed one with float32
contractions, GAT_TPU_V6_DTYPE=float32).

A parts op returns the unnormalised (num, den, cap', code) and leaves the
epilogue to its caller, so its backward takes three raw cotangents. The
loss here uses all three outputs, so that none of them is zero:
sum(sin(num)) + sum(sin(den)) + 2 cap'. s_dst goes in already B-shifted,
the same numbers on both sides. On CPU tensors the port runs its kernels'
plain versions. Tolerances: outputs 1e-5, cotangents 2e-5, each after
dividing by max(|ref|, 1) (float32 sums in another order; d(s_dst) is a
sum of cancelling terms, so a relative test would only amplify noise).
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
from .test_torch_layout import clustered

SLOPE = 0.01
EPS = 1e-8
SHAPES = [(8, 8), (8, 3), (2, 8), (4, 32)]


def op_inputs(rng, n_src, n, nh, f, slots, dropout):
    """Seeded h, a_src, the B-shifted s_dst and a dropout mask."""
    h = rng.normal(size=(n_src, nh * f)).astype(np.float32)
    a_src = (rng.normal(size=(nh * f, nh)) / np.sqrt(nh * f)
             ).astype(np.float32)
    s_dst = rng.normal(size=(n, nh)).astype(np.float32)
    bound = (h @ a_src).max() + s_dst.max()
    drop = ((rng.random((slots, nh)) > 0.4).astype(np.float32) / 0.6
            if dropout else None)
    return dict(h=h, a_src=a_src, s_dst=(s_dst - bound).astype(np.float32),
                drop=drop)


def loss_of(num, den, cap, lib):
    return lib.sum(lib.sin(num)) + lib.sum(lib.sin(den)) + 2.0 * cap


def jax_run(c, parts):
    args = [jnp.asarray(c[k]) for k in ("h", "a_src", "s_dst")]
    if c["drop"] is not None:
        args.append(jnp.asarray(c["drop"]))

    def loss(hh, aa, ss, dd=None):
        num, den, cap, code = parts(hh, aa, ss, dd)
        return loss_of(num, den, cap, jnp), (num, den, cap, code)

    (_, outs), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(args))), has_aux=True)(*args)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def torch_run(c, parts):
    leaves = [torch.tensor(c[k], requires_grad=True)
              for k in ("h", "a_src", "s_dst")]
    drop = (None if c["drop"] is None
            else torch.tensor(c["drop"], requires_grad=True))
    num, den, cap, code = parts(*leaves, drop)
    assert not code.requires_grad and code.dtype == torch.int32
    loss_of(num, den, cap, torch).backward()
    grads = [t.grad.numpy() for t in leaves]
    if drop is not None:
        grads.append(drop.grad.numpy())
    return [o.detach().numpy() for o in (num, den, cap, code)], grads


def assert_close(got, want, atol, names):
    """Each pair within atol after dividing by max(|want|, 1); a failure
    names the worst element, its two values and the scale."""
    assert len(got) == len(want)
    for a, b, nm in zip(got, want, names):
        scale = max(float(np.abs(b).max()), 1.0)
        worst = np.unravel_index(np.argmax(np.abs(a - b)), np.shape(b))
        np.testing.assert_allclose(
            a / scale, b / scale, rtol=0, atol=atol,
            err_msg=f"{nm}: worst at {worst}: {np.asarray(a)[worst]!r} "
                    f"against {np.asarray(b)[worst]!r}, scale {scale}")


def assert_same(c, jparts, tparts, nh):
    jouts, jgrads = jax_run(c, jparts)
    touts, tgrads = torch_run(c, tparts)
    assert_close(touts[:3], jouts[:3], 1e-5, ("num", "den", "cap"))
    # the JAX code counts heads padded to 8: compare (slot, head)
    nh8 = -(-nh // 8) * 8
    jcode, tcode = int(jouts[3]), int(touts[3])
    assert (tcode // nh, tcode % nh) == (jcode // nh8, jcode % nh8)
    assert_close(tgrads, jgrads, 2e-5, ("h", "a_src", "s_dst", "drop"))
    return touts, tgrads


def v5_case(nh, f, dropout, seed=3, n=256, n_src=None, e_real=1500, pad=36):
    rng = np.random.default_rng(seed)
    n_src = n if n_src is None else n_src
    recv = np.concatenate([np.sort(rng.integers(0, n - 1, e_real)),
                           np.full(pad, n - 1)]).astype(np.int32)
    send = np.concatenate([rng.integers(0, n_src - 1, e_real),
                           np.full(pad, n_src - 1)]).astype(np.int32)
    c = op_inputs(rng, n_src, n, nh, f, e_real + pad, dropout)
    c.update(n=n, n_src=n_src, nh=nh, f=f, e_real=e_real, send=send,
             recv=recv, order=np.argsort(send, kind="stable"
                                         ).astype(np.int32))
    return c


def v5_parts_pair(c):
    sd, rc, od = (jnp.asarray(c[k]) for k in ("send", "recv", "order"))
    n_src = None if c["n_src"] == c["n"] else c["n_src"]

    def jparts(hh, aa, ss, dd):
        return jfsa.v5_sweep1_parts(
            hh, aa, ss, dd, sd, rc, od, jnp.int32(c["e_real"]), c["n"],
            c["nh"], c["f"], EPS, SLOPE, 256, 128, True, n_src)

    def tparts(hh, aa, ss, dd):
        return tv5.v5_sweep1_parts(
            hh, aa, ss, dd, torch.tensor(c["send"]), torch.tensor(c["recv"]),
            torch.tensor(c["order"]), c["e_real"], c["n"], c["nh"], c["f"],
            EPS, SLOPE, n_src)

    return jparts, tparts


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("nh,f", SHAPES)
def test_v5_parts_match_jax(nh, f, dropout):
    c = v5_case(nh, f, dropout)
    assert_same(c, *v5_parts_pair(c), nh)


def test_v5_parts_with_more_source_rows_than_destinations():
    """Senders index an h table of 320 rows, receivers 256 destination
    rows: d(h) has the table's rows, d(s_dst) the destinations'."""
    c = v5_case(8, 8, True, seed=5, n_src=320)
    assert c["send"].max() >= 256
    _, grads = assert_same(c, *v5_parts_pair(c), 8)
    assert grads[0].shape == (320, 64) and grads[2].shape == (256, 8)
    assert np.abs(grads[0][256:]).max() > 0


def hybrid_case(nh, f, dropout, seed=4):
    x, send, recv = clustered(seed)
    kw = dict(reorder="cluster", src_windows=True, hybrid=True)
    jg, tg = JT.canonicalize(x, send, recv, **kw), TT.canonicalize(
        x, send, recv, **kw)
    assert tg.block_layout.rem_e > 0
    rng = np.random.default_rng(seed + 10)
    c = op_inputs(rng, tg.num_nodes, tg.num_nodes, nh, f,
                  tg.block_layout.num_slots, dropout)
    c.update(n=tg.num_nodes, nh=nh, f=f, jbl=jg.block_layout,
             tbl=tg.block_layout, tg=tg)
    return c


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("nh,f", SHAPES)
def test_v7_parts_match_jax(nh, f, dropout):
    c = hybrid_case(nh, f, dropout)
    bl = c["jbl"]

    def jparts(hh, aa, ss, dd):
        return jfsw.v7_sweep1_parts(
            hh, aa, ss, dd, bl.send, bl.recv, bl.base, bl.tile_ptr,
            bl.tile_base, c["n"], nh, f, bl.window, bl.wb, EPS, SLOPE,
            bl.eb, bl.nb, True, bl.dmax)

    def tparts(hh, aa, ss, dd):
        return tw.v7_sweep1_parts(hh, aa, ss, dd, c["tbl"], c["n"], nh, f,
                                  EPS, SLOPE)

    _, grads = assert_same(c, jparts, tparts, nh)
    if dropout:     # pad slots get a zero dropout cotangent
        assert np.all(grads[3][c["tbl"].recv.numpy() < 0] == 0.0)


def test_parts_add_over_a_partition_of_the_edges():
    """num and den are sums over edges and cap' a max: the parts over the
    even and the odd edges of a list add to the parts over the whole."""
    c = v5_case(8, 8, False, seed=6, pad=0)
    t = {k: torch.tensor(c[k]) for k in ("h", "a_src", "s_dst", "send",
                                         "recv")}

    def parts(idx):
        send, recv = t["send"][idx], t["recv"][idx]
        return tv5.v5_sweep1_parts(
            t["h"], t["a_src"], t["s_dst"], None, send, recv,
            torch.argsort(send, stable=True).to(torch.int32), send.shape[0],
            c["n"], 8, 8)

    every = torch.arange(c["e_real"])
    whole, even, odd = parts(every), parts(every[::2]), parts(every[1::2])
    torch.testing.assert_close(even[0] + odd[0], whole[0], rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(even[1] + odd[1], whole[1], rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(torch.maximum(even[2], odd[2]), whole[2])


def test_hybrid_layout_parts_add_to_the_whole_graph():
    """The windowed parts over a hybrid layout's slots plus the v5 parts
    over its remainder are the v5 parts over the graph's edge list."""
    c = hybrid_case(8, 3, False, seed=2)
    tg, bl = c["tg"], c["tbl"]
    h, a, s = (torch.tensor(c[k]) for k in ("h", "a_src", "s_dst"))
    local = tw.v7_sweep1_parts(h, a, s, None, bl, c["n"], 8, 3)
    rem = tv5.v5_sweep1_parts(h, a, s, None, bl.rem_send, bl.rem_recv,
                              bl.rem_order, bl.rem_e, c["n"], 8, 3,
                              dst_ptr=bl.rem_dst_ptr, src_ptr=bl.rem_src_ptr)
    whole = tv5.v5_sweep1_parts(h, a, s, None, tg.senders, tg.receivers,
                                tg.src_order, tg.num_real_edges, c["n"], 8, 3)
    torch.testing.assert_close(local[0] + rem[0], whole[0], rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(local[1] + rem[1], whole[1], rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(torch.maximum(local[2], rem[2]), whole[2])


def test_parts_ops_refuse_mismatched_shapes():
    c = v5_case(1, 7, False, e_real=100, pad=4)
    t = {k: torch.tensor(v) for k, v in c.items()
         if isinstance(v, np.ndarray)}
    with pytest.raises(ValueError, match="do not match"):
        tv5.v5_sweep1_parts(t["h"][:-1], t["a_src"], t["s_dst"], None,
                            t["send"], t["recv"], t["order"], 100, 256, 1, 7)
    with pytest.raises(ValueError, match="no kernel"):
        tv5.v5_backward(t["h"].to("meta"), t["a_src"], t["s_dst"], None,
                        t["send"], t["recv"], 100, SLOPE, t["h"], None,
                        t["s_dst"], None, False, normalize=False)
