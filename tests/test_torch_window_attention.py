"""The port's windowed attention op against the JAX package's
fused_gat_window_v7, run in interpret mode with float32 contractions
(GAT_TPU_V6_DTYPE=float32), as tests/test_window_kernel.py runs it.

Both packages build the block layout from the same numpy graph
(tests/test_torch_layout.py holds the layouts equal). On CPU tensors the
port's op runs its kernels' plain versions. Tolerances are those of the
JAX package's own v7 test: output rtol/atol 3e-5 (float32 sums in another
order: the JAX kernel adds per eb-slot block, the port per destination
row); gradients of h, a_src, s_dst and the dropout mask atol 2e-5 after
dividing by max(|ref|, 1), since d(s_dst) is structurally about 0 and a
relative test would only amplify noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.graph import transforms as JT
from gat_pytorch_tpu.ops.pallas import segment_attention_window as jfsw
from gat_pytorch_tpu_torch.graph import transforms as TT
from gat_pytorch_tpu_torch.ops.cuda import window_attention as tw

SLOPE = 0.01


@pytest.fixture(autouse=True)
def _float32_contractions(monkeypatch):
    monkeypatch.setenv("GAT_TPU_V6_DTYPE", "float32")


def banded_edges(seed, n=1500, e=9000, band=400):
    rng = np.random.default_rng(seed)
    recv = rng.integers(0, n, e)
    send = np.clip(recv + rng.integers(-band // 2, band // 2, e), 0, n - 1)
    return send, recv


def make_case(nh, f, send, recv, n, seed=1, dropout=False, eps=1e-8,
              **canon):
    """Both packages' graphs of one edge list, and seeded op inputs."""
    x = np.zeros((n, 1), np.float32)
    jg = JT.canonicalize(x, send, recv, src_windows=True, **canon)
    tg = TT.canonicalize(x, send, recv, src_windows=True, **canon)
    rng = np.random.default_rng(seed)
    n_pad, e7 = tg.num_nodes, tg.block_layout.num_slots
    return dict(
        nh=nh, f=f, n=n_pad, eps=eps, jbl=jg.block_layout,
        tbl=tg.block_layout,
        h=(rng.normal(size=(n_pad, nh * f)) * 0.1).astype(np.float32),
        a_src=(rng.normal(size=(nh * f, nh))
               / np.sqrt(nh * f)).astype(np.float32),
        s_dst=(rng.normal(size=(n_pad, nh)) * 0.1).astype(np.float32),
        drop=((rng.random((e7, nh)) > 0.4).astype(np.float32) / 0.6
              if dropout else None))


def run_jax(c):
    bl = c["jbl"]
    args = [jnp.asarray(c[k]) for k in ("h", "a_src", "s_dst")]
    if c["drop"] is not None:
        args.append(jnp.asarray(c["drop"]))

    def loss(hh, aa, ss, dd=None):
        out = jfsw.fused_gat_window_v7(
            hh, aa, ss, dd, bl.send, bl.recv, bl.base, bl.tile_ptr,
            bl.tile_base, None, c["n"], c["nh"], c["f"], bl.window, bl.wb,
            c["eps"], SLOPE, bl.eb, bl.nb, True, bl.dmax)
        return jnp.sum(jnp.sin(out)), out

    (_, out), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(args))), has_aux=True)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def run_torch(c):
    leaves = [torch.tensor(c[k], requires_grad=True)
              for k in ("h", "a_src", "s_dst")]
    drop = (None if c["drop"] is None
            else torch.tensor(c["drop"], requires_grad=True))
    out = tw.fused_gat_window_v7(*leaves, drop, c["tbl"], None, c["n"],
                                 c["nh"], c["f"], c["eps"], SLOPE)
    torch.sin(out).sum().backward()
    grads = [t.grad.numpy() for t in leaves]
    if drop is not None:
        grads.append(drop.grad.numpy())
    return out.detach().numpy(), grads


def assert_same(c):
    out_j, grads_j = run_jax(c)
    out_t, grads_t = run_torch(c)
    np.testing.assert_allclose(out_t, out_j, rtol=3e-5, atol=3e-5)
    assert len(grads_t) == len(grads_j)
    for a, b, nm in zip(grads_t, grads_j, ("h", "a_src", "s_dst", "drop")):
        scale = max(float(np.abs(b).max()), 1.0)
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=2e-5,
                                   err_msg=nm)
    return out_t, grads_t


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("nh,f", [(8, 8), (8, 3), (1, 7)])
def test_window_op_matches_jax(nh, f, dropout):
    send, recv = banded_edges(1)
    c = make_case(nh, f, send, recv, 1500, dropout=dropout)
    assert (c["tbl"].recv.numpy() < 0).any()        # the layout has pad slots
    _, grads = assert_same(c)
    if dropout:     # pad slots get a zero dropout cotangent
        assert np.all(grads[3][c["tbl"].recv.numpy() < 0] == 0.0)


def test_window_op_cap_tie_goes_to_lowest_slot_code():
    """The top edge is duplicated and both heads score alike, so the cap is
    attained at several (slot, head) codes. The code counts layout slots,
    not dst-sorted edges; both packages must route the cap's cotangent to
    the lowest one. eps = 1 makes that cotangent of order 1 (at the
    reference's 1e-8 it is far below the tolerance and a wrong route would
    pass)."""
    n, nh, f = 1500, 2, 8
    send, recv = banded_edges(5)
    c = make_case(nh, f, send, recv, n, seed=6, dropout=True)
    c["a_src"][:, 1] = c["a_src"][:, 0]
    c["s_dst"][:, 1] = c["s_dst"][:, 0]
    v = int(recv[10])
    c["s_dst"][v] += 6.0                     # v's in-edges take the cap
    into_v = np.concatenate([send[(recv == v) & (send != v)], [v]])
    top = int(into_v[np.argmax(c["h"][into_v] @ c["a_src"][:, 0])])
    assert top != v                          # a self-loop is never doubled
    dup = make_case(nh, f, np.append(send, top), np.append(recv, v), n,
                    seed=6, dropout=True, eps=1.0)
    for k in ("h", "a_src", "s_dst"):
        dup[k] = c[k]
    bl = dup["tbl"]
    _, _, cap, code = tw.window_forward_plain(
        torch.tensor(dup["h"]), torch.tensor(dup["a_src"]),
        torch.tensor(dup["s_dst"]), None, bl, SLOPE)
    s7, r7 = bl.send.numpy(), bl.recv.numpy()
    raw = dup["h"][s7] @ dup["a_src"] + dup["s_dst"][np.maximum(r7, 0)]
    raw[r7 < 0] = -np.inf
    tied = np.flatnonzero(raw.reshape(-1) == raw.max())
    assert tied.size >= 4                    # 2 slots x 2 heads
    assert int(code) == tied[0] and float(cap) == raw.max()
    slots = tied // nh
    assert (s7[slots] == top).all() and (r7[slots] == v).all()
    _, grads = assert_same(dup)
    # the route is visible: the cap cotangent reaches only head 0 of v
    assert abs(grads[2][v, 0] - grads[2][v, 1]) > 1e-3


def test_window_op_cap_cotangent_without_tie():
    send, recv = banded_edges(7)
    assert_same(make_case(8, 8, send, recv, 1500, seed=8, dropout=True,
                          eps=1.0))


def test_window_op_empty_tiles_and_isolated_rows():
    """No self-loops, and every edge lands in the first 100 rows: whole
    destination tiles are empty and most rows receive nothing. Their
    output is 0, not NaN, and nothing flows back from them."""
    rng = np.random.default_rng(9)
    n = 700
    recv = rng.integers(0, 100, 400)
    send = np.clip(recv + rng.integers(-30, 30, 400), 0, n - 1)
    c = make_case(8, 8, send, recv, n, seed=10, dropout=True,
                  add_self_loops=False)
    tp = c["tbl"].tile_ptr.numpy()
    assert (np.diff(tp) == 0).any()          # an empty tile
    out, grads = assert_same(c)
    lonely = np.setdiff1d(np.arange(c["n"]), recv)
    assert lonely.size > 500
    assert np.all(out[lonely] == 0.0) and np.isfinite(out).all()
    assert np.all(grads[2][lonely] == 0.0)


def test_window_wrappers_refuse_other_devices():
    send, recv = banded_edges(11, n=300, e=900, band=100)
    c = make_case(1, 7, send, recv, 300)
    args = [torch.tensor(c[k]).to("meta") for k in ("h", "a_src", "s_dst")]
    with pytest.raises(ValueError, match="no kernel"):
        tw.window_forward(*args, None, c["tbl"], SLOPE)
    with pytest.raises(ValueError, match="do not match"):
        tw.fused_gat_window_v7(torch.tensor(c["h"])[:-1],
                               torch.tensor(c["a_src"]),
                               torch.tensor(c["s_dst"]), None, c["tbl"],
                               None, c["n"], 1, 7)
