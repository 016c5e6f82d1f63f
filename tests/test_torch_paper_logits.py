"""The paper form's logits op (ops/cuda/paper_logits.py): its plain
version against the torch chain it replaced in the model, bit for bit in
the logits and in the gradients into the two score tables; the layer
built on it against the layer built on the chain; and, marked `card`
(skipped without a CUDA device), the kernels against the chain's bits.
Imports nothing of JAX, so that the card tests run on the card:

    python -m pytest tests/test_torch_paper_logits.py -m card --noconftest -q
"""

import os

import numpy as np
import pytest
import torch

from gat_pytorch_tpu_torch.graph import transforms as TT
from gat_pytorch_tpu_torch.models import gat
from gat_pytorch_tpu_torch.ops import segment as seg
from gat_pytorch_tpu_torch.ops.cuda import build
from gat_pytorch_tpu_torch.ops.cuda import paper_logits as pl
from gat_pytorch_tpu_torch.ops.cuda import table_attention as v4

SLOPE = 0.2
HEADS = (1, 4, 6, 8)


@pytest.fixture(autouse=True)
def no_knobs(monkeypatch):
    """The JAX package's knobs unset: each test sets what it needs."""
    for name in list(os.environ):
        if name.startswith("GAT_TPU_"):
            monkeypatch.delenv(name)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def make_graph(n=61, e=300, hub_out=0, seed=0):
    """A canonicalised random graph over n nodes (self-loops, dst-sorted,
    padded: padding nodes without an edge, padding edges on the sink),
    node 1 sending hub_out more edges; also node 5 made a destination of
    no edge but its self-loop's."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e + hub_out)
    r = rng.integers(0, n, e + hub_out)
    s[e:] = 1
    keep = r != 5
    s, r = s[keep], r[keep]
    g = TT.canonicalize(np.zeros((n, 1), np.float32), s.astype(np.int32),
                        r.astype(np.int32))
    deg = torch.diff(torch.clamp(g.dst_ptr.long(), max=g.num_real_edges))
    assert bool((deg == 0).any()), "no destination without a real edge"
    assert g.num_edges > g.num_real_edges, "no padding edge"
    return g


def scores(g, nh, seed, zero_edge=None):
    """Seeded (s_src, s_dst) (N, nh), requiring grad; zero_edge: an edge
    index whose z = s_src[j] + s_dst[i] is exactly 0 in every head."""
    gen = torch.Generator().manual_seed(seed)
    s_src = torch.randn((g.num_nodes, nh), generator=gen)
    s_dst = torch.randn((g.num_nodes, nh), generator=gen)
    if zero_edge is not None:
        j, i = int(g.senders[zero_edge]), int(g.receivers[zero_edge])
        s_src[j] = 0.75
        s_dst[i] = -0.75
    return s_src.requires_grad_(True), s_dst.requires_grad_(True)


def graph_args(g, offsets):
    """The op's edge arguments, with the Graph's offsets or without."""
    kw = dict(src_order=g.src_order)
    if offsets:
        kw.update(src_ptr=g.src_ptr, dst_ptr=g.dst_ptr)
    return ((g.senders, g.receivers, g.edge_mask, g.num_nodes, SLOPE,
             g.num_real_edges), kw)


def chain_and_op(g, nh, seed, offsets=True, zero_edge=None):
    """(chain logits, op logits, chain grads, op grads) of one seeded
    cotangent, the padding edges' rows of it included."""
    args, kw = graph_args(g, offsets)
    out = []
    for fn in (pl.paper_logits_plain, pl.paper_logits):
        s_src, s_dst = scores(g, nh, seed, zero_edge)
        logits = fn(s_src, s_dst, *args, **kw)
        gen = torch.Generator().manual_seed(seed + 1)
        cot = torch.randn(logits.shape, generator=gen)
        grads = torch.autograd.grad(logits, (s_src, s_dst), cot)
        out.append((logits.detach(), grads))
    return out


@pytest.mark.parametrize("offsets", [True, False])
@pytest.mark.parametrize("nh", HEADS)
def test_plain_op_has_the_chains_bits(nh, offsets):
    g = make_graph(seed=nh)
    (want, want_g), (got, got_g) = chain_and_op(g, nh, 3, offsets)
    assert torch.equal(got, want)
    for x, y in zip(got_g, want_g):
        assert torch.equal(x, y)


@pytest.mark.parametrize("nh", HEADS)
def test_a_sender_of_many_edges(nh):
    g = make_graph(hub_out=200, seed=10 + nh)
    runs = torch.diff(g.src_ptr.long())
    assert int(runs.max()) >= 150
    (want, want_g), (got, got_g) = chain_and_op(g, nh, 4)
    assert torch.equal(got, want)
    for x, y in zip(got_g, want_g):
        assert torch.equal(x, y)


@pytest.mark.parametrize("nh", HEADS)
def test_z_of_exactly_zero_takes_the_slope(nh):
    g = make_graph(seed=20 + nh)
    edge = 7
    (want, want_g), (got, got_g) = chain_and_op(g, nh, 5, zero_edge=edge)
    assert torch.equal(got, want)
    for x, y in zip(got_g, want_g):
        assert torch.equal(x, y)
    s_src, s_dst = scores(g, nh, 5, zero_edge=edge)
    cot = torch.randn((g.num_edges, nh))
    d_z = pl.paper_logits_backward(cot, s_src.detach(), s_dst.detach(),
                                   g.senders, g.receivers, g.edge_mask,
                                   SLOPE)
    assert torch.equal(d_z[edge], cot[edge] * SLOPE)


@pytest.mark.parametrize("nh", HEADS)
def test_padding_edges_and_each_destinations_max(nh):
    g = make_graph(seed=30 + nh)
    (_, _), (got, _) = chain_and_op(g, nh, 6)
    mask = g.edge_mask
    assert bool((got[~mask] == v4.NEG_INF).all())
    real = got[mask]
    assert bool((real <= 0).all()) and bool(torch.isfinite(real).all())
    # each destination's largest logit is its max subtracted: 0
    n = g.num_nodes
    top = seg.segment_max(torch.where(mask[:, None], got, v4.NEG_INF),
                          g.receivers, n)
    deg = torch.diff(torch.clamp(g.dst_ptr.long(), max=g.num_real_edges))
    assert bool((top[deg > 0] == 0).all())


def test_backward_zeroes_the_padding_edges():
    g = make_graph(seed=40)
    s_src, s_dst = scores(g, 4, 7)
    cot = torch.randn((g.num_edges, 4))
    d_z = pl.paper_logits_backward(cot, s_src.detach(), s_dst.detach(),
                                   g.senders, g.receivers, g.edge_mask,
                                   SLOPE)
    assert bool((d_z[~g.edge_mask] == 0).all())
    assert bool((d_z[g.edge_mask] != 0).all())


def test_op_refuses_mismatched_tables():
    g = make_graph(seed=41)
    s_src, s_dst = scores(g, 4, 8)
    args, kw = graph_args(g, True)
    with pytest.raises(ValueError):
        pl.paper_logits(s_src, s_dst[:, :3], *args, **kw)
    with pytest.raises(ValueError):
        pl.paper_logits(s_src[1:], s_dst[1:], *args, **kw)


def test_op_counts_no_launch_on_cpu_tensors():
    assert "paper_logits" in build.SOURCES
    assert {"paper_logits_forward", "paper_logits_backward"} <= set(
        build.LAUNCHES)
    before = dict(build.LAUNCHES)
    g = make_graph(seed=42)
    chain_and_op(g, 8, 9)
    assert build.LAUNCHES == before


# -- the layer ---------------------------------------------------------------

def layer_case(nh, f, concat, seed):
    g = make_graph(seed=seed)
    cfg = gat.GATLayerConfig(in_features=12, out_features=f, num_heads=nh,
                             concat=concat, dropout=0.3, paper_faithful=True)
    params = gat.init_gat_layer(torch.Generator().manual_seed(seed), cfg,
                                torch.device("cpu"))
    x = torch.randn((g.num_nodes, 12),
                    generator=torch.Generator().manual_seed(seed + 1))
    return g, cfg, params, x


def graph_kw(g):
    return dict(num_real_edges=g.num_real_edges, src_order=g.src_order,
                src_ptr=g.src_ptr, dst_ptr=g.dst_ptr)


def todays_layer(params, cfg, x, g, training, gen, return_attention=False):
    """The paper form's table layer as the model built it on the torch
    chain: the scores' cat, the sorted gathers, the max, the table op."""
    nh, f, n = cfg.num_heads, cfg.out_features, g.num_nodes
    h_flat = gat._node_transform(x, params["W"], torch.float32, None, n)
    raw = gat._edge_logits(params, cfg, h_flat, g.senders, g.receivers,
                           g.edge_mask, g.src_order, src_ptr=g.src_ptr,
                           dst_ptr=g.dst_ptr,
                           num_real_edges=g.num_real_edges)
    pad = torch.full_like(raw, v4.NEG_INF)
    logits = torch.where(g.edge_mask[:, None], raw, pad)
    seg_max = seg.segment_max(logits, g.receivers, n).detach()
    seg_max = torch.where(torch.isfinite(seg_max), seg_max,
                          torch.zeros_like(seg_max))
    logits = torch.where(g.edge_mask[:, None],
                         logits - seg.gather_rows(seg_max, g.receivers), pad)
    drop = (gat._attention_dropout((g.num_edges, nh), cfg.dropout, gen,
                                   x.device) if training else None)
    out = v4.fused_segment_attention_table(
        logits, h_flat, g.senders, g.receivers, drop, g.src_order, n, nh, f,
        0.0, g.num_real_edges, src_ptr=g.src_ptr, dst_ptr=g.dst_ptr)
    out = gat._head_combine(out, cfg, n, params)
    if not return_attention:
        return out
    return out, seg.segment_softmax_sorted(
        raw, g.receivers, n, edge_mask=g.edge_mask, ptr=g.dst_ptr,
        num_real=g.num_real_edges, eps=0.0, subtract_segment_max=True)


def layer_grads(fn, params, x, cot):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    xx = x.clone().requires_grad_(True)
    out = fn(leaves, xx)
    first = out[0] if isinstance(out, tuple) else out
    loss = (first * cot).sum()
    if isinstance(out, tuple):
        loss = loss + out[1].square().sum()
    grads = torch.autograd.grad(loss, (xx, leaves["W"], leaves["a"]))
    return out, grads


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("nh,f,concat", [(1, 5, True), (4, 3, True),
                                         (6, 2, False), (8, 4, True)])
def test_layer_matches_todays_layer(nh, f, concat, training):
    g, cfg, params, x = layer_case(nh, f, concat, 50 + nh)
    n = g.num_nodes
    cot = torch.randn((n, nh * f if concat else f))
    gat.PATH_TRACE.clear()
    got, got_g = layer_grads(
        lambda p, xx: gat.gat_layer_apply(
            p, cfg, xx, g.senders, g.receivers, g.edge_mask, n,
            generator=torch.Generator().manual_seed(9), training=training,
            **graph_kw(g)), params, x, cot)
    assert gat.PATH_TRACE == ["v4_table"]
    want, want_g = layer_grads(
        lambda p, xx: todays_layer(p, cfg, xx, g, training,
                                   torch.Generator().manual_seed(9)),
        params, x, cot)
    assert torch.equal(got, want)
    for name, a, b in zip(("h", "W", "a"), got_g, want_g):
        err = float((a - b).abs().max())
        assert err <= 1e-6 * float(b.abs().max()), (name, err)


def test_layer_alpha_is_todays():
    g, cfg, params, x = layer_case(4, 3, True, 60)
    n = g.num_nodes
    cot = torch.randn((n, 12))
    got, got_g = layer_grads(
        lambda p, xx: gat.gat_layer_apply(
            p, cfg, xx, g.senders, g.receivers, g.edge_mask, n,
            return_attention=True, **graph_kw(g)), params, x, cot)
    want, want_g = layer_grads(
        lambda p, xx: todays_layer(p, cfg, xx, g, False, None,
                                   return_attention=True), params, x, cot)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for name, a, b in zip(("h", "W", "a"), got_g, want_g):
        err = float((a - b).abs().max())
        assert err <= 1e-6 * float(b.abs().max()), (name, err)


def test_layer_without_the_graphs_order():
    """A graph without src_order: the layer sorts the senders itself, and
    the op gives the bits of the layer handed the order."""
    g, cfg, params, x = layer_case(8, 4, True, 70)
    n = g.num_nodes
    args = (params, cfg, x, g.senders, g.receivers, g.edge_mask, n)
    with_order = gat.gat_layer_apply(*args, **graph_kw(g))
    without = gat.gat_layer_apply(*args, num_real_edges=g.num_real_edges)
    assert torch.equal(with_order, without)


# -- on the card --------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("nh", [1, 2, 3, 4, 5, 6, 7, 8])
def test_kernels_have_the_chains_bits_on_card(card, nh):
    g = make_graph(n=400, e=4000, hub_out=300, seed=80 + nh).to(card)
    edge = 11
    args, kw = graph_args(g, True)
    res = []
    for fn in (pl.paper_logits_plain, pl.paper_logits, pl.paper_logits):
        s_src, s_dst = (t.detach().to(card).requires_grad_(True)
                        for t in scores(g, nh, 12, zero_edge=edge))
        before = dict(build.LAUNCHES)
        logits = fn(s_src, s_dst, *args, **kw)
        cot = torch.randn(logits.shape, device=card,
                          generator=torch.Generator(card).manual_seed(13))
        grads = torch.autograd.grad(logits, (s_src, s_dst), cot)
        ran = {k: v - before[k] for k, v in build.LAUNCHES.items()
               if v != before[k]}
        res.append((logits, grads, ran))
    (want, want_g, ran_chain), *ops = res
    assert ran_chain == {"segment_sum_sorted": 2}
    for got, got_g, ran in ops:
        assert ran == {"paper_logits_forward": 1, "paper_logits_backward": 1,
                       "segment_sum_sorted": 2}
        assert torch.equal(got, want)
        for x, y in zip(got_g, want_g):
            assert torch.equal(x, y)


@pytest.mark.card
def test_layer_matches_todays_layer_on_card(card):
    g, cfg, params, x = layer_case(8, 4, True, 90)
    g = g.to(card)
    params = {k: v.to(card) for k, v in params.items()}
    x, n = x.to(card), g.num_nodes
    cot = torch.randn((n, 32), device=card)
    got, got_g = layer_grads(
        lambda p, xx: gat.gat_layer_apply(
            p, cfg, xx, g.senders, g.receivers, g.edge_mask, n,
            **graph_kw(g)), params, x, cot)
    want, want_g = layer_grads(
        lambda p, xx: todays_layer(p, cfg, xx, g, False, None), params, x,
        cot)
    assert torch.equal(got, want)
    for a, b in zip(got_g, want_g):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
