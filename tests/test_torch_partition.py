"""The port's destination-owned partitioning (parallel/partition.py) and
its shards (parallel/sharding.dst_shard) against the JAX package's
arrays, and the parts ops over an empty edge list. Numpy only: no ranks.

The graphs are the JAX dst-owned tests' (tests/test_parallel_dst_owned.py:
the 24-node graph in a 32-node bucket, whose shard 3 of 4 has no edge,
the banded graph for the windowed layouts, the clustered one for the
hybrid layouts), canonicalised by the JAX package and handed to the port
as numpy arrays. The arrays must be equal, but `rem_order` after a
re-pad: the port re-derives it by a stable argsort, and a remainder that
filled its bucket is padded with sink edges (the JAX package appends an
identity order to its last edge; that fault is not pinned here).

The empty parts ops: the JAX v5_sweep1_parts (interpret mode) and
v7_sweep1_parts (interpret mode, float32 contractions) with no real edge
give num 0, den 0 and cap' -1e30 (code 0, and the windowed op's INT32_MAX
sentinel); the port's plain versions must give the same with code 0, and
zero gradients (cap' is then a constant).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.ops.pallas import segment_attention as jfsa
from gat_pytorch_tpu.ops.pallas import segment_attention_window as jfsw
from gat_pytorch_tpu.parallel import partition as JP
from gat_pytorch_tpu_torch.graph.transforms import layout_index_arrays
from gat_pytorch_tpu_torch.ops.cuda import v5_attention as tv5
from gat_pytorch_tpu_torch.ops.cuda import window_attention as tw
from gat_pytorch_tpu_torch.parallel import partition as TP
from gat_pytorch_tpu_torch.parallel import sharding as TS

from . import torch_ranks as R
from .test_parallel_dst_owned import (_clustered_graph, make_banded_graph,
                                      make_graph)
from .test_torch_knobs import default_knobs  # noqa: F401

K = 4
LAYOUT_KEYS = ("send", "recv", "base", "tile_ptr", "tile_base")
STATICS = ("wb", "window", "nb", "eb", "dmax")
REM_KEYS = ("rem_send", "rem_recv", "rem_order", "rem_count")


def port_graph(jg):
    return R.graph_of(R.numpy_graph(jg))


CASES = {
    "plain": (lambda: make_graph(seed=1), dict(pad_multiple=32)),
    "windowed": (lambda: make_banded_graph(seed=11),
                 dict(pad_multiple=32, src_windows=True, nb=128, eb=128)),
    "cost_model": (lambda: make_banded_graph(seed=12),
                   dict(pad_multiple=32, src_windows=True, eb=128)),
    "hybrid": (lambda: _clustered_graph(seed=31),
               dict(pad_multiple=32, src_windows=True, hybrid=True, nb=128,
                    eb=128)),
}


def assert_graphs_equal(tg, jg):
    for key in ("senders", "receivers", "edge_mask", "src_order", "x",
                "node_mask"):
        np.testing.assert_array_equal(getattr(tg, key).numpy(),
                                      np.asarray(getattr(jg, key)), key)
    assert (tg.num_nodes, tg.num_edges) == (jg.num_nodes, jg.num_edges)
    jb, tb = jg.block_layout, tg.block_layout
    assert (jb is None) == (tb is None)
    if jb is None:
        return
    for key in LAYOUT_KEYS + STATICS + ("rem_e",):
        np.testing.assert_array_equal(np.asarray(getattr(tb, key)),
                                      np.asarray(getattr(jb, key)), key)
    assert (jb.rem_send is None) == (tb.rem_send is None)
    if jb.rem_send is not None:
        for key in REM_KEYS:
            np.testing.assert_array_equal(getattr(tb, key).numpy(),
                                          np.asarray(getattr(jb, key)), key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_partition_equals_jax(case):
    make, kw = CASES[case]
    jg = make()
    jg2, jeps = JP.partition_edges_by_dst(jg, K, **kw)
    tg2, teps = TP.partition_edges_by_dst(port_graph(jg), K, **kw)
    assert teps == jeps
    assert_graphs_equal(tg2, jg2)
    if case == "hybrid":
        assert tg2.block_layout.rem_count.sum() > 0


@pytest.mark.parametrize("case", ["plain", "windowed", "hybrid"])
def test_partition_batches_equals_jax(case):
    """Graphs of different sizes share one bucket and, with layouts, one
    re-padded shape (repad_block_layout through _unify_batch_layouts)."""
    make, kw = CASES[case]
    kw = {k: v for k, v in kw.items() if k in ("pad_multiple",
                                                "src_windows", "hybrid")}
    if case == "plain":
        jgs = [make_graph(seed=s, num_nodes=n) for s, n in
               ((1, 24), (2, 30), (3, 28))]
    elif case == "windowed":
        jgs = [make_banded_graph(seed=s, num_nodes=n) for s, n in
               ((11, 120), (12, 90))]
    else:
        jgs = [_clustered_graph(seed=s, num_nodes=n) for s, n in
               ((31, 192), (33, 160))]
    jout, jeps = JP.partition_batches(jgs, K, **kw)
    tout, teps = TP.partition_batches([port_graph(g) for g in jgs], K, **kw)
    assert teps == jeps
    for tg, jg in zip(tout, jout):
        assert_graphs_equal(tg, jg)
    # a given bucket is kept, and one too small raises
    again, eps = TP.partition_batches([port_graph(g) for g in jgs], K,
                                      eps=teps + 256, **kw)
    assert eps == teps + 256 and again[0].num_edges == K * eps
    with pytest.raises(ValueError, match="per-shard bucket"):
        TP.partition_batches([port_graph(g) for g in jgs], K, eps=1, **kw)


@pytest.mark.parametrize("case", ["plain", "windowed", "hybrid"])
def test_dst_shards(case):
    """Each shard's edges are the in-edges of its rows, real first; its
    offsets and its own layout are those of its slice (the Hopper index
    arrays of layout_index_arrays over its rows and the N senders; the
    remainder's rem_e its own count)."""
    make, kw = CASES[case]
    tg2, eps = TP.partition_edges_by_dst(port_graph(make()), K, **kw)
    n = tg2.num_nodes
    rows = n // K
    real_total = 0
    for j in range(K):
        sh = TS.dst_shard(tg2, j, K)
        r, m = sh.receivers.numpy(), sh.edge_mask.numpy()
        s, o = sh.senders.numpy(), sh.src_order.numpy()
        e_real = sh.num_real_edges
        real_total += e_real
        assert sh.num_edges == eps and m[:e_real].all() and not m[
            e_real:].any()
        assert ((r // rows) == j).all() and (np.diff(r) >= 0).all()
        assert (np.diff(s[o[:e_real]]) >= 0).all()
        np.testing.assert_array_equal(
            sh.dst_ptr.numpy(),
            np.searchsorted(r - j * rows, np.arange(rows + 1)))
        np.testing.assert_array_equal(
            sh.src_ptr.numpy(),
            np.searchsorted(np.sort(s[:e_real]), np.arange(n + 1)))
        bl = sh.block_layout
        if bl is None:
            continue
        full = tg2.block_layout
        slots = full.num_slots // K
        send = full.send.numpy()[j * slots:(j + 1) * slots]
        recv = full.recv.numpy()[j * slots:(j + 1) * slots]
        np.testing.assert_array_equal(bl.send.numpy(), send)
        dperm, dptr, sperm, sptr, nreal = layout_index_arrays(
            send, recv, rows, n_src=n)
        for got, want in ((bl.dst_perm, dperm), (bl.dst_ptr, dptr),
                          (bl.src_perm, sperm), (bl.src_ptr, sptr)):
            np.testing.assert_array_equal(got.numpy(), want)
        assert bl.num_real == nreal == int((recv >= 0).sum())
        if bl.rem_send is not None:
            count = int(full.rem_count[j])
            assert bl.rem_e == count and bl.rem_count is None
            rs, rr = bl.rem_send.numpy(), bl.rem_recv.numpy()
            ro = bl.rem_order.numpy()
            assert (rr < rows).all() and (np.diff(rr) >= 0).all()
            assert sorted(ro[:count]) == list(range(count))
            np.testing.assert_array_equal(
                bl.rem_src_ptr.numpy(),
                np.searchsorted(np.sort(rs[:count]), np.arange(n + 1)))
            np.testing.assert_array_equal(
                bl.rem_dst_ptr.numpy(),
                np.searchsorted(rr, np.arange(rows + 1)))
    assert real_total == int(tg2.edge_mask.sum())


def test_empty_shard_of_a_padded_bucket():
    """24 nodes in a 32-node bucket: shard 3 of 4 holds only padding rows,
    so its slice has no real edge."""
    tg2, _ = TP.partition_edges_by_dst(port_graph(make_graph(seed=1)), K,
                                       pad_multiple=32)
    assert TS.dst_shard(tg2, 3, K).num_real_edges == 0


def test_repad_of_a_full_remainder_is_sender_sorted():
    """A remainder that exactly fills its bucket, re-padded to a larger
    one: the port's rem_order sorts the padded remainder by sender with
    its real edges first, and its offsets describe them."""
    rows, n, k = 128, 256, 2
    rng = np.random.default_rng(0)
    # shard 0's 128 real remainder edges fill the bucket; its last
    # dst-sorted sender is not its largest
    rr = np.stack([np.sort(rng.integers(0, rows, 128)),
                   np.concatenate([np.arange(40), np.full(88, rows - 1)])])
    rs = np.stack([rng.integers(0, n - 1, 128),
                   np.concatenate([rng.integers(0, n - 1, 40),
                                   np.full(88, n - 1)])])
    rs[0, -1] = 3
    counts = np.array([128, 40])
    empty = np.zeros((k, 128), np.int64)
    bl = TP._stacked(k, rows, n, send=empty, recv=empty - 1,
                     base=np.zeros((k, 1), np.int64),
                     tile_ptr=np.zeros((k, 2), np.int64),
                     tile_base=np.zeros((k, 1), np.int64), wb=128,
                     window=128, nb=128, eb=128, dmax=8,
                     rem=(rs, rr, counts))
    out = TP.repad_block_layout(bl, k, rem_slots=256)
    assert out.rem_send.shape[0] == k * 256
    for j in range(k):
        sh = TS._layout_shard(out, j, k)
        rs_j, ro_j = sh.rem_send.numpy(), sh.rem_order.numpy()
        assert (np.diff(rs_j[ro_j]) >= 0).all()
        assert sorted(ro_j[:counts[j]]) == list(range(counts[j]))
        np.testing.assert_array_equal(rs_j[:counts[j]], rs[j, :counts[j]])
        assert (rs_j[counts[j]:] == n - 1).all()
        assert (sh.rem_recv.numpy()[counts[j]:] == rows - 1).all()
        assert sh.rem_e == counts[j]
        np.testing.assert_array_equal(
            sh.rem_src_ptr.numpy(),
            np.searchsorted(np.sort(rs[j, :counts[j]]), np.arange(n + 1)))


# -- the parts ops over no edges --------------------------------------------

def empty_inputs(nh=2, f=8, n_src=32, rows=8, edges=32):
    rng = np.random.default_rng(3)
    h = rng.normal(size=(n_src, nh * f)).astype(np.float32)
    a_src = rng.normal(size=(nh * f, nh)).astype(np.float32) * 0.3
    s_dst = rng.normal(size=(rows, nh)).astype(np.float32) - 5.0
    send = np.full(edges, n_src - 1, np.int32)
    recv = np.full(edges, rows - 1, np.int32)
    return h, a_src, s_dst, send, recv


def run_torch_parts(parts, h, a_src, s_dst):
    leaves = [torch.tensor(v, requires_grad=True) for v in (h, a_src, s_dst)]
    num, den, cap, code = parts(*leaves)
    (num.sum() + den.sum() + cap).backward()
    grads = [t.grad for t in leaves]
    for g in grads:
        assert torch.isfinite(g).all() and not g.any()
    return [t.detach().numpy() for t in (num, den, cap, code)]


def assert_empty_equal(got, want, jax_code=0):
    """The port's (num, den, cap', code) over no edges equal to the JAX
    op's, code 0 (the JAX windowed op's code there is its INT32_MAX
    sentinel: it names no slot)."""
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert int(got[3]) == 0 and int(want[3]) == jax_code
    assert got[2] == np.float32(-1e30)


def test_empty_v5_parts_match_jax():
    h, a_src, s_dst, send, recv = empty_inputs()
    order = np.arange(send.shape[0], dtype=np.int32)
    want = jfsa.v5_sweep1_parts(
        jnp.asarray(h), jnp.asarray(a_src), jnp.asarray(s_dst), None,
        jnp.asarray(send), jnp.asarray(recv), jnp.asarray(order),
        jnp.int32(0), 8, 2, 8, 1e-8, 0.01, 256, 128, True, 32)
    got = run_torch_parts(
        lambda hh, aa, ss: tv5.v5_sweep1_parts(
            hh, aa, ss, None, torch.tensor(send), torch.tensor(recv),
            torch.tensor(order), 0, 8, 2, 8, 1e-8, 0.01, 32),
        h, a_src, s_dst)
    assert_empty_equal(got, want)


def test_empty_window_parts_match_jax(monkeypatch):
    """Shard 3 of the 24-node graph's windowed partition: a layout of pad
    slots only."""
    monkeypatch.setenv("GAT_TPU_V6_DTYPE", "float32")
    jg = make_graph(seed=1)
    kw = dict(pad_multiple=32, src_windows=True, nb=128, eb=128)
    jg2, _ = JP.partition_edges_by_dst(jg, K, **kw)
    tg2, _ = TP.partition_edges_by_dst(port_graph(jg), K, **kw)
    sh = TS.dst_shard(tg2, 3, K)
    assert sh.block_layout.num_real == 0
    jb = jg2.block_layout
    h, a_src, s_dst, _, _ = empty_inputs(rows=8)
    w = jb.send.shape[0] // K

    def cut(a, m=K):
        a = np.asarray(a)
        step = a.shape[0] // m
        return jnp.asarray(a[3 * step:4 * step])

    want = jfsw.v7_sweep1_parts(
        jnp.asarray(h), jnp.asarray(a_src), jnp.asarray(s_dst), None,
        cut(jb.send), cut(jb.recv), cut(jb.base), cut(jb.tile_ptr),
        cut(jb.tile_base), 8, 2, 8, jb.window, jb.wb, 1e-8, 0.01, jb.eb,
        jb.nb, True, jb.dmax)
    assert w == sh.block_layout.num_slots
    got = run_torch_parts(
        lambda hh, aa, ss: tw.v7_sweep1_parts(
            hh, aa, ss, None, sh.block_layout, 8, 2, 8, 1e-8, 0.01, 32),
        h, a_src, s_dst)
    assert_empty_equal(got, want, jax_code=np.iinfo(np.int32).max)


def test_empty_two_phase_ops():
    """The 2-phase cap pass over no edges gives cap -1e30 (as the JAX
    v5_local_cap), and the attention pass zeros, both with zero
    gradients."""
    h, a_src, s_dst, send, recv = empty_inputs()
    want = jfsa.v5_local_cap(jnp.asarray(h), jnp.asarray(a_src),
                             jnp.asarray(s_dst), jnp.asarray(send),
                             jnp.asarray(recv), jnp.int32(0), 8, 2, 8, 256,
                             128, True)
    leaves = [torch.tensor(v, requires_grad=True) for v in (h, a_src, s_dst)]
    args = (torch.tensor(send), torch.tensor(recv))
    cap = tv5.v5_local_cap(*leaves, *args, 0, 8, 2, 8)
    assert cap.item() == float(np.asarray(want)) == float(np.float32(-1e30))
    out = tv5.fused_gat_table(*leaves, torch.tensor(0.5), None, *args,
                              torch.arange(32, dtype=torch.int32), 0, 8, 2,
                              8, 1e-8, 0.01, 32)
    assert not out.any()
    (out.sum() + cap).backward()
    for t in leaves:
        assert torch.isfinite(t.grad).all() and not t.grad.any()
