"""The v2 op's backward (PERF.md row 10, an edge-parallel map on the
card) against the JAX package's fused_segment_attention and
fused_segment_attention_partial VJPs, run in interpret mode as
tests/test_pallas_kernel.py runs them, and the op's receiver offsets.

On CPU tensors the op runs its kernels' plain versions, the contract the
card's kernel is held to (chip_smoke.py). Cases: the PPI layer shapes
4x256 and 6x121 (a head starting mid-vector on the card's 8-byte vectors)
and Cora's 8x8 and 1x7; eps = 1e-8 on capped logits and eps = 0 on
max-subtracted ones (paper_faithful: empty segments give 0, not NaN);
padding edges (told the number of real edges, and h_src gathered for the
real edges alone, as the sharded layer calls it); and a call over fewer
rows than the receivers reach (the edges past them get zero cotangents).
Tolerances are tests/test_torch_v2_attention.py's: outputs rtol/atol
1e-5, cotangents 2e-5 after dividing by max(|ref|, 1) (float32 sums in
another order).

The receiver offsets: fused_segment_attention(_partial) take the graph's
dst_ptr (an edge shard's own under edge sharding), checked, and give the
outputs and gradients of the call that derives them; the sharded layer
hands the op its shard's dst_ptr.
"""

import numpy as np
import pytest
import torch

from gat_pytorch_tpu_torch.models import gat as tgat
from gat_pytorch_tpu_torch.ops import collectives as C
from gat_pytorch_tpu_torch.ops.cuda import segment_attention as tsa
from gat_pytorch_tpu_torch.parallel import Axis

from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_two_phase_ops import run_both
from .test_torch_v2_attention import E_REAL, N, assert_close, make_case, pair

SHAPES = [(4, 256), (6, 121), (8, 8), (1, 7)]


@pytest.mark.parametrize("partial", [False, True], ids=["norm", "partial"])
@pytest.mark.parametrize("eps", [1e-8, 0.0])
@pytest.mark.parametrize("nh,f", SHAPES)
def test_v2_backward_matches_jax(nh, f, eps, partial):
    """The cotangents of the logits, h_src and the mask, the op told its
    real-edge count and given h_src for the real edges alone (the
    sharded layer's call); the padding edges' cotangents are 0."""
    kind = "capped" if eps else "segmax"
    c = make_case(nh, f, seed=nh * 7 + f, dropout=True, kind=kind)
    want, _ = run_both(c["args"], *pair(c, eps, partial))
    args = [c["args"][0], c["args"][1][:E_REAL], c["args"][2]]
    out_t, (d_lg, d_h, d_drop) = run_port(args,
                                          pair(c, eps, partial, E_REAL)[1])
    out_j, (j_lg, j_h, j_drop) = want
    assert_close((out_t, [d_lg, d_h, d_drop]),
                 (out_j, [j_lg, j_h[:E_REAL], j_drop]))
    assert d_h.shape == (E_REAL, nh * f)
    assert np.all(d_lg[E_REAL:] == 0.0) and np.all(d_drop[E_REAL:] == 0.0)


@pytest.mark.parametrize("partial", [False, True], ids=["norm", "partial"])
@pytest.mark.parametrize("nh,f", SHAPES)
def test_v2_backward_over_fewer_rows_than_the_receivers_reach(nh, f,
                                                              partial):
    """num_nodes below the largest receiver: the edges past the rows add
    nothing and get zero cotangents, as in the JAX package."""
    c = make_case(nh, f, seed=nh * 11 + f, dropout=True)
    c["n"] = rows = N - 40
    past = c["recv"] >= rows
    assert past[:E_REAL].any()
    want, got = run_both(c["args"], *pair(c, 1e-8, partial))
    assert_close(got, want)
    for grad in got[1]:
        assert np.all(grad[past] == 0.0)


def run_port(args, tfn):
    """(out, grads) of the port's function for the loss sum(sin(out))."""
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = tfn(*leaves)
    torch.sin(out).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def dst_offsets(recv, n):
    return torch.searchsorted(torch.tensor(recv),
                              torch.arange(n + 1, dtype=torch.int32),
                              out_int32=True)


@pytest.mark.parametrize("partial", [False, True], ids=["norm", "partial"])
def test_v2_op_takes_the_receiver_offsets(partial):
    """With and without dst_ptr: equal outputs and gradients; offsets of
    the wrong shape or dtype are refused."""
    nh, f = 4, 8
    c = make_case(nh, f, seed=17, dropout=True)
    rc = torch.tensor(c["recv"])

    def run(**kw):
        leaves = [torch.tensor(a, requires_grad=True) for a in c["args"]]
        if partial:
            out = torch.cat(tsa.fused_segment_attention_partial(
                *leaves[:2], rc, leaves[2], N, nh, f, E_REAL, **kw), dim=1)
        else:
            out = tsa.fused_segment_attention(*leaves[:2], rc, leaves[2], N,
                                              nh, f, 1e-8, E_REAL, **kw)
        torch.sin(out).sum().backward()
        return [out.detach()] + [t.grad for t in leaves]

    base = run()
    for x, y in zip(run(dst_ptr=dst_offsets(c["recv"], N)), base):
        assert torch.equal(x, y)
    for bad in (dst_offsets(c["recv"], N - 1),
                dst_offsets(c["recv"], N).long()):
        with pytest.raises(ValueError, match="dst_ptr"):
            run(dst_ptr=bad)


def test_sharded_layer_hands_the_op_its_shards_dst_ptr(monkeypatch):
    """The cut-neighbourhood layer (edge_axis set) passes the shard
    graph's dst_ptr to the partial v2 op: the op receives that tensor,
    and the layer's output and gradients equal the call without it. The
    collectives are the identity on one shard (patched here: no process
    group)."""
    for name in ("psum", "vary", "split_rows", "all_gather_rows", "pmax",
                 "pmin"):
        monkeypatch.setattr(C, name, lambda x, axis: x)
    seen = []
    op = tsa.fused_segment_attention_partial

    def recording(*a, dst_ptr=None, **kw):
        seen.append(dst_ptr)
        return op(*a, dst_ptr=dst_ptr, **kw)

    monkeypatch.setattr(tsa, "fused_segment_attention_partial", recording)
    rng = np.random.default_rng(3)
    n, nh, f, fin = 64, 2, 4, 5
    recv = np.sort(rng.integers(0, n, 300)).astype(np.int32)
    send = rng.integers(0, n, 300).astype(np.int32)
    lc = tgat.GATLayerConfig(in_features=fin, out_features=f, num_heads=nh,
                             concat=True)
    params = tgat.init_gat_layer(torch.Generator().manual_seed(0), lc,
                                 torch.device("cpu"))
    x = torch.tensor(rng.normal(size=(n, fin)).astype(np.float32))
    order = torch.argsort(torch.tensor(send), stable=True).to(torch.int32)
    ptr = dst_offsets(recv, n)
    axis = Axis("edge", 1, 0, None)

    def run(dst_ptr):
        leaves = {k: v.clone().requires_grad_(True) for k, v in
                  params.items()}
        out = tgat.gat_layer_apply(
            leaves, lc, x, torch.tensor(send), torch.tensor(recv),
            torch.ones(300, dtype=torch.bool), n, num_real_edges=300,
            src_order=order, dst_ptr=dst_ptr, edge_axis=axis)
        torch.sin(out).sum().backward()
        return [out.detach()] + [leaves[k].grad for k in sorted(leaves)]

    with_ptr = run(ptr)
    assert seen[-1] is ptr
    without = run(None)
    assert seen[-1] is None
    for a, b in zip(with_ptr, without):
        assert torch.equal(a, b)
