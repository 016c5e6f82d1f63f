"""The port's locality layouts against the JAX package: RCM order, source
windows and the block layout of the windowed attention op. The same numpy
graph must give equal arrays and ints (equal, not close: the kernels index
with them), and the port's extra index arrays must be consistent with the
layout's `send` and `recv`."""

import numpy as np
import pytest

from gat_pytorch_tpu.graph import graphcore_binding as jcore
from gat_pytorch_tpu.graph import transforms as JT
from gat_pytorch_tpu_torch.graph import graphcore_binding as tcore
from gat_pytorch_tpu_torch.graph import transforms as TT
from gat_pytorch_tpu_torch.utils.convert import block_layout_from_jax

LAYOUT_ARRAYS = ("send", "recv", "base", "tile_ptr", "tile_base")
LAYOUT_INTS = ("wb", "window", "nb", "eb", "dmax")
GRAPH_FIELDS = ("x", "senders", "receivers", "edge_mask", "node_mask", "y",
                "train_mask", "src_order", "tile_lo", "node_order")


def banded(seed, n=1500, e=9000, band=400, feats=8):
    """The banded fixture of tests/test_window_kernel.py."""
    rng = np.random.default_rng(seed)
    recv = rng.integers(0, n, e)
    send = np.clip(recv + rng.integers(-band // 2, band // 2, e), 0, n - 1)
    x = rng.normal(size=(n, feats)).astype(np.float32)
    return x, send, recv


def pubmed_like(seed, n=1200, e=3300, classes=3, p_in=0.85):
    """A small community graph in node-id order that hides the
    communities, as the Pubmed stand-in: RCM has real work to do."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    send = rng.integers(0, n, e)
    same = rng.random(e) < p_in
    pools = [np.flatnonzero(y == c) for c in range(classes)]
    recv = np.where(same,
                    [rng.choice(pools[y[s]]) for s in send],
                    rng.integers(0, n, e))
    sym_s, sym_r = np.concatenate([send, recv]), np.concatenate([recv, send])
    x = rng.normal(size=(n, 8)).astype(np.float32)
    mask = rng.random(n) < 0.3
    return x, sym_s, sym_r, y, mask


def assert_same_layout(jbl, tbl):
    for name in LAYOUT_ARRAYS:
        a, b = np.asarray(getattr(jbl, name)), getattr(tbl, name).numpy()
        assert b.dtype == np.int32, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in LAYOUT_INTS:
        assert getattr(tbl, name) == getattr(jbl, name), name
    assert tbl.num_slots == jbl.num_slots


def assert_index_arrays(bl, n_pad):
    """dst_perm / src_perm are permutations that sort the slots by
    destination / the real slots by sender, stably, and the offsets cut
    them into per-node runs."""
    send, recv = bl.send.numpy().astype(np.int64), bl.recv.numpy()
    dperm, dptr = bl.dst_perm.numpy(), bl.dst_ptr.numpy()
    sperm, sptr = bl.src_perm.numpy(), bl.src_ptr.numpy()
    e7, real = bl.num_slots, np.flatnonzero(recv >= 0)
    assert bl.num_real == real.size
    np.testing.assert_array_equal(np.sort(dperm), np.arange(e7))
    np.testing.assert_array_equal(np.sort(sperm), real)
    assert dptr.shape == sptr.shape == (n_pad + 1,)
    assert dptr[0] == sptr[0] == 0
    assert dptr[-1] == sptr[-1] == real.size
    assert (recv[dperm[real.size:]] == -1).all()
    for perm, ptr, ids in ((dperm, dptr, recv), (sperm, sptr, send)):
        runs = np.repeat(np.arange(n_pad), np.diff(ptr))
        np.testing.assert_array_equal(ids[perm[:real.size]], runs)
        # stable: slot ids ascend within each node's run
        same_run = np.diff(runs) == 0
        assert (np.diff(perm[:real.size].astype(np.int64))[same_run]
                > 0).all()


@pytest.mark.parametrize("case", ["banded", "pubmed_like", "self_loops"])
def test_rcm_order_matches_jax(case):
    if case == "banded":
        _, s, r = banded(0)
        n = 1500
    elif case == "pubmed_like":
        _, s, r, _, _ = pubmed_like(1)
        n = 1200
    else:   # self-loops, multi-edges, isolated nodes, two components
        s = np.array([0, 0, 1, 2, 2, 5, 6, 6, 3])
        r = np.array([1, 1, 2, 0, 2, 6, 5, 6, 3])
        n = 9
    want = jcore.rcm_order(s, r, n)
    got = tcore.rcm_order(s, r, n)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got), np.arange(n))


@pytest.mark.parametrize("band", [400, 1100])
def test_src_windows_and_block_layout_match_jax(band):
    x, s, r = banded(0, band=band)
    jg = JT.canonicalize(x, s, r, src_windows=True)
    tg = TT.canonicalize(x, s, r, src_windows=True)
    np.testing.assert_array_equal(tg.tile_lo.numpy(), np.asarray(jg.tile_lo))
    assert tg.src_band == jg.src_band > 0
    assert_same_layout(jg.block_layout, tg.block_layout)
    assert_index_arrays(tg.block_layout, tg.num_nodes)
    assert tg.node_order is None and jg.node_order is None


@pytest.mark.parametrize("sizes", [dict(nb=128, eb=128), dict(nb=256),
                                   dict(eb=256), dict(nb=512, eb=1024)])
def test_block_layout_explicit_sizes_match_jax(sizes):
    x, s, r = banded(2, band=1100)
    tg = TT.canonicalize(x, s, r)
    args = (tg.senders.numpy(), tg.receivers.numpy(), tg.num_real_edges,
            tg.num_nodes)
    assert_same_layout(JT.compute_block_layout(*args, **sizes),
                       TT.compute_block_layout(*args, **sizes))


def test_rcm_canonicalize_matches_jax():
    x, s, r, y, mask = pubmed_like(3)
    kw = dict(y=y, train_mask=mask, reorder="rcm", src_windows=True)
    jg, tg = JT.canonicalize(x, s, r, **kw), TT.canonicalize(x, s, r, **kw)
    for name in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)),
                                      err_msg=name)
    assert tg.src_band == jg.src_band
    assert_same_layout(jg.block_layout, tg.block_layout)
    assert_index_arrays(tg.block_layout, tg.num_nodes)
    tg.validate()
    # the nodes moved with their features, labels and masks
    order = tg.node_order.numpy()[:x.shape[0]]
    np.testing.assert_array_equal(tg.x.numpy()[:x.shape[0]], x[order])
    np.testing.assert_array_equal(tg.y.numpy()[:x.shape[0]], y[order])
    # RCM narrowed the band of this graph
    plain = TT.canonicalize(x, s, r, src_windows=True)
    assert tg.src_band < plain.src_band


@pytest.mark.parametrize("band", [400, 1100])
def test_block_layout_invariants(band):
    """On the port alone: the real-edge multiset is kept, tiles are
    eb-aligned and sender-sorted, every block's senders lie inside its
    128-aligned wb window, pad slots have recv == -1."""
    x, s, r = banded(0, band=band)
    g = TT.canonicalize(x, s, r, src_windows=True)
    bl = g.block_layout
    s7, r7 = bl.send.numpy(), bl.recv.numpy()
    tp, bb = bl.tile_ptr.numpy(), bl.base.numpy()
    em = g.edge_mask.numpy()
    ref = sorted(zip(g.senders.numpy()[em].tolist(),
                     g.receivers.numpy()[em].tolist()))
    assert ref == sorted(zip(s7[r7 >= 0].tolist(), r7[r7 >= 0].tolist()))
    assert bl.num_real == g.num_real_edges
    assert bl.wb % 128 == 0 and bl.window % 128 == 0 and bl.wb <= bl.window
    assert tp[-1] == bl.num_slots
    for ti in range(len(tp) - 1):
        lo, hi = tp[ti], tp[ti + 1]
        assert lo % bl.eb == 0 and hi % bl.eb == 0
        real = r7[lo:hi] >= 0
        assert ((r7[lo:hi][real] // bl.nb) == ti).all()
        assert (np.diff(s7[lo:hi][real]) >= 0).all()
    for gi in range(bl.num_slots // bl.eb):
        blk = s7[gi * bl.eb:(gi + 1) * bl.eb]
        assert bb[gi] % 128 == 0
        assert (blk >= bb[gi]).all() and (blk < bb[gi] + bl.wb).all()


def test_block_layout_of_an_edgeless_graph():
    e = np.zeros(0, np.int64)
    jbl = JT.compute_block_layout(e, e, 0, 256)
    tbl = TT.compute_block_layout(e, e, 0, 256)
    assert_same_layout(jbl, tbl)
    assert tbl.num_slots == 0 and tbl.num_real == 0
    assert_index_arrays(tbl, 256)


def test_block_layout_from_jax_rebuilds_the_index_arrays():
    x, s, r = banded(4)
    jg = JT.canonicalize(x, s, r, src_windows=True)
    want = TT.canonicalize(x, s, r, src_windows=True).block_layout
    got = block_layout_from_jax(jg.block_layout, jg.num_nodes, device="cpu")
    assert_same_layout(jg.block_layout, got)
    for name in ("dst_perm", "dst_ptr", "src_perm", "src_ptr"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name).numpy(),
                                      err_msg=name)
    assert got.num_real == want.num_real


def test_unported_layouts_raise():
    x, s, r = banded(5, n=300, e=900, band=100)
    with pytest.raises(NotImplementedError, match="item 12"):
        TT.canonicalize(x, s, r, reorder="cluster", src_windows=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        TT.canonicalize(x, s, r, src_windows=True, hybrid=True)
    with pytest.raises(ValueError, match="unknown reorder"):
        TT.canonicalize(x, s, r, reorder="bfs")
