"""The port's locality layouts against the JAX package: RCM and cluster
order, source windows, the block layout of the windowed attention op and
the hybrid split-locality layout with its remainder. The same numpy graph
must give equal arrays and ints (equal, not close: the kernels index with
them), and the port's extra index arrays must be consistent with the
layout's `send` and `recv` and with the remainder's edge list."""

import numpy as np
import pytest
import torch

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


def clustered(seed, n=900, communities=3, deg=5, homophily=0.9, f_in=12):
    """The small SBM of tests/test_hybrid_layout.py: the Pubmed stand-in's
    structure."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, communities, n)
    src = rng.integers(0, n, n * deg)
    partner = rng.integers(0, n, n * deg)
    same = rng.random(n * deg) < homophily
    for c in range(communities):
        members = np.where(labels == c)[0]
        pick = same & (labels[src] == c)
        partner[pick] = members[rng.integers(0, len(members), pick.sum())]
    keep = src != partner
    x = rng.normal(size=(n, f_in)).astype(np.float32)
    return x, src[keep], partner[keep]


def assert_same_layout(jbl, tbl):
    """The slot arrays and ints, and the remainder (None on both sides of
    a plain layout)."""
    for name in LAYOUT_ARRAYS:
        a, b = np.asarray(getattr(jbl, name)), getattr(tbl, name).numpy()
        assert b.dtype == np.int32, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in LAYOUT_INTS + ("rem_e",):
        assert getattr(tbl, name) == getattr(jbl, name), name
    assert tbl.num_slots == jbl.num_slots
    for name in ("rem_send", "rem_recv", "rem_order"):
        a, b = getattr(jbl, name), getattr(tbl, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert b.dtype == torch.int32, name
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=name)
    if tbl.rem_send is None:
        assert tbl.rem_dst_ptr is None and tbl.rem_src_ptr is None


def assert_remainder(g, n_src=None):
    """Local slots + remainder hold every real edge once; the remainder is
    dst-sorted, rem_order sender-sorts its padded list, and the offsets
    cut both orders into per-node runs."""
    bl = g.block_layout
    e, n_pad = g.num_real_edges, g.num_nodes
    n_src = n_pad if n_src is None else n_src
    ls, lr = bl.send.numpy(), bl.recv.numpy()
    rs_pad, rr_pad = bl.rem_send.numpy(), bl.rem_recv.numpy()
    rs, rr, ro = rs_pad[:bl.rem_e], rr_pad[:bl.rem_e], bl.rem_order.numpy()
    assert bl.rem_e > 0 and bl.num_real + bl.rem_e == e
    assert rs_pad.shape[0] % 128 == 0 and rs_pad.shape[0] >= bl.rem_e
    both = list(zip(ls[lr >= 0].tolist(), lr[lr >= 0].tolist()))
    both += list(zip(rs.tolist(), rr.tolist()))
    assert sorted(both) == sorted(zip(g.senders.numpy()[:e].tolist(),
                                      g.receivers.numpy()[:e].tolist()))
    assert (np.diff(rr_pad) >= 0).all() and (np.diff(rs_pad[ro]) >= 0).all()
    assert (rs_pad[bl.rem_e:] == n_src - 1).all()
    assert (rr_pad[bl.rem_e:] == n_pad - 1).all()
    dptr, sptr = bl.rem_dst_ptr.numpy(), bl.rem_src_ptr.numpy()
    assert dptr.shape == (n_pad + 1,) and sptr.shape == (n_src + 1,)
    np.testing.assert_array_equal(
        np.repeat(np.arange(n_pad), np.diff(dptr)), rr_pad)
    np.testing.assert_array_equal(
        np.repeat(np.arange(n_src), np.diff(sptr)), rs_pad[ro[:bl.rem_e]])


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
    """What the port has no layout for raises; the cluster order and the
    hybrid layout, which it refused once, build (the tests below hold
    them to the JAX package's)."""
    x, s, r = banded(5, n=300, e=900, band=100)
    assert TT.canonicalize(x, s, r, reorder="cluster", src_windows=True,
                           hybrid=True).block_layout is not None
    with pytest.raises(ValueError, match="unknown reorder"):
        TT.canonicalize(x, s, r, reorder="bfs")
    g = TT.canonicalize(x, s, r)
    with pytest.raises(ValueError, match="128-multiples"):
        TT.compute_hybrid_layout(g.senders.numpy(), g.receivers.numpy(),
                                 g.num_real_edges, g.num_nodes, eb=100)


@pytest.mark.parametrize("seed", [2, 4])
def test_label_propagation_matches_jax(seed):
    _, s, r = clustered(seed)
    want = JT.label_propagation_capped(s, r, 900)
    got = TT.label_propagation_capped(s, r, 900)
    np.testing.assert_array_equal(got, want)
    assert got.max() + 1 < 900            # nodes did merge into communities
    # a cap that binds: no label gains more members than it allows
    np.testing.assert_array_equal(
        TT.label_propagation_capped(s, r, 900, cap=100),
        JT.label_propagation_capped(s, r, 900, cap=100))


@pytest.mark.parametrize("seed", [2, 4])
def test_hybrid_canonicalize_matches_jax(seed):
    x, s, r = clustered(seed)
    y = np.random.default_rng(seed).integers(0, 3, 900)
    kw = dict(y=y, train_mask=y == 0, reorder="cluster", src_windows=True,
              hybrid=True)
    jg, tg = JT.canonicalize(x, s, r, **kw), TT.canonicalize(x, s, r, **kw)
    for name in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)),
                                      err_msg=name)
    assert tg.src_band == jg.src_band
    assert_same_layout(jg.block_layout, tg.block_layout)
    assert tg.block_layout.rem_send is not None
    assert tg.block_layout.eb == TT.V7_HYBRID_EB
    assert_index_arrays(tg.block_layout, tg.num_nodes)
    assert_remainder(tg)
    tg.validate()
    # the cluster order alone, without a layout
    np.testing.assert_array_equal(
        TT.canonicalize(x, s, r, reorder="cluster").node_order.numpy(),
        np.asarray(JT.canonicalize(x, s, r, reorder="cluster").node_order))


def test_hybrid_layout_with_a_wider_sender_range_matches_jax():
    """n_src: the senders index more rows than the destinations (the
    sharded layouts' case): the remainder's sink sender and the sender
    offsets follow n_src."""
    x, s, r = clustered(3)
    tg = TT.canonicalize(x, s, r, reorder="cluster")
    args = (tg.senders.numpy(), tg.receivers.numpy(), tg.num_real_edges,
            tg.num_nodes)
    n_src = tg.num_nodes + 256
    for fn in ("compute_block_layout", "compute_hybrid_layout"):
        jbl = getattr(JT, fn)(*args, n_src=n_src)
        tbl = getattr(TT, fn)(*args, n_src=n_src)
        assert_same_layout(jbl, tbl)
        assert tbl.src_ptr.shape == (n_src + 1,)
    assert_remainder(tg.replace(block_layout=tbl), n_src)


@pytest.mark.parametrize("case", ["one_window", "edgeless", "no_locality"])
def test_hybrid_layout_falls_back_to_the_plain_layout(case):
    """Nothing left over (every edge inside its tile's window), no edge at
    all, or too little locality (a random graph whose windows may span
    256 rows of 3000): the plain block layout at the hybrid block size,
    on both sides."""
    window = {}
    if case == "one_window":
        x, s, r = banded(6, n=100, e=400, band=60)
    elif case == "edgeless":
        x, s, r = np.zeros((200, 1), np.float32), np.zeros(0, int), \
            np.zeros(0, int)
    else:
        rng = np.random.default_rng(7)
        x = np.zeros((3000, 1), np.float32)
        s, r = rng.integers(0, 3000, 9000), rng.integers(0, 3000, 9000)
        window = dict(max_window=256)
    tg = TT.canonicalize(x, s, r, add_self_loops=case != "edgeless")
    args = (tg.senders.numpy(), tg.receivers.numpy(), tg.num_real_edges,
            tg.num_nodes)
    jbl = JT.compute_hybrid_layout(*args, **window)
    tbl = TT.compute_hybrid_layout(*args, **window)
    assert jbl.rem_send is None and tbl.rem_send is None and tbl.rem_e == 0
    assert tbl.eb == TT.V7_HYBRID_EB and tbl.num_real == tg.num_real_edges
    assert_same_layout(jbl, tbl)
    assert_same_layout(jbl, TT.compute_block_layout(
        *args, nb=TT.V7_NB, eb=TT.V7_HYBRID_EB))


def test_block_layout_from_jax_carries_the_remainder():
    x, s, r = clustered(4)
    kw = dict(reorder="cluster", src_windows=True, hybrid=True)
    jg = JT.canonicalize(x, s, r, **kw)
    want = TT.canonicalize(x, s, r, **kw).block_layout
    got = block_layout_from_jax(jg.block_layout, jg.num_nodes, device="cpu")
    assert_same_layout(jg.block_layout, got)
    for name in ("dst_perm", "dst_ptr", "src_perm", "src_ptr", "rem_dst_ptr",
                 "rem_src_ptr"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name).numpy(),
                                      err_msg=name)
    assert got.num_real == want.num_real and got.rem_e == want.rem_e > 0
