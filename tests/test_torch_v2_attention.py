"""The port's v2 segment attention ops against the JAX package's
fused_segment_attention and fused_segment_attention_partial, run in
interpret mode as tests/test_pallas_kernel.py runs them.

On CPU tensors the port's ops run their kernels' plain versions. Inputs
are made from a seed with numpy: dst-sorted receivers, some destinations
without an edge, padding edges on the last node with NEG_INF logits, a
pre-gathered h_src table. Forward: rtol/atol 1e-5 (float32 sums in
another order). Cotangents of the logits, h_src and the dropout mask:
atol 2e-5 after dividing by max(|ref|, 1), as
tests/test_torch_table_attention.py does. The partial op's loss reads
num and den (sin of both), so that d(num) and d(den) are both live.
Under GAT_TPU_KERNEL_DTYPE=bfloat16 the tolerance is 1e-2 of the same
scales, and the mode must be live (tests/test_torch_bf16_window.py's
checks).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.ops.pallas import segment_attention as jfsa
from gat_pytorch_tpu_torch.ops.cuda import segment_attention as tsa

from .test_torch_bf16_window import assert_bf16_mode
from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_two_phase_ops import run_both

N, E_REAL, PAD = 256, 700, 36
NAMES = ("out", "logits", "h_src", "drop")


def make_case(nh, f, seed=0, dropout=False, kind="capped", n=N,
              e_real=E_REAL, pad=PAD):
    """Edges into the even nodes below n - 1 only (the odd ones have none:
    empty segments), then `pad` padding edges on node n - 1."""
    rng = np.random.default_rng(seed)
    e = e_real + pad
    recv = np.concatenate([np.sort(rng.choice(np.arange(0, n - 1, 2),
                                              e_real)),
                           np.full(pad, n - 1)]).astype(np.int32)
    logits = rng.normal(size=(e, nh)).astype(np.float32)
    if kind == "capped":          # the reference quirk: <= 0, eps 1e-8
        logits -= logits[:e_real].max()
    else:                         # paper_faithful: per-destination max
        seg_max = np.full((n, nh), -np.inf, np.float32)
        np.maximum.at(seg_max, recv[:e_real], logits[:e_real])
        logits -= np.where(np.isfinite(seg_max), seg_max, 0.0)[recv]
    logits[e_real:] = tsa.NEG_INF
    assert tsa.NEG_INF == jfsa.NEG_INF
    args = [logits, rng.normal(size=(e, nh * f)).astype(np.float32)]
    if dropout:
        args.append((rng.random((e, nh)) > 0.4).astype(np.float32) / 0.6)
    return dict(n=n, nh=nh, f=f, recv=recv, e_real=e_real, args=args)


def pair(c, eps, partial=False, num_real_edges=None, sl=slice(None)):
    """(JAX function, port function) of the args of case c, over the
    edges `sl`; the partial op's (num, den) concatenated."""
    n, nh, f = c["n"], c["nh"], c["f"]
    recv = c["recv"][sl]

    def jfn(lg, hs, dd=None):
        rc = jnp.asarray(recv)
        if partial:
            num, den = jfsa.fused_segment_attention_partial(
                lg, hs, rc, dd, n, nh, f, 256, 128, True)
            return jnp.concatenate([num, den], axis=1)
        return jfsa.fused_segment_attention(lg, hs, rc, dd, n, nh, f, eps,
                                            256, 128, True)

    def tfn(lg, hs, dd=None):
        rc = torch.tensor(recv)
        if partial:
            return torch.cat(tsa.fused_segment_attention_partial(
                lg, hs, rc, dd, n, nh, f, num_real_edges), dim=1)
        return tsa.fused_segment_attention(lg, hs, rc, dd, n, nh, f, eps,
                                           num_real_edges)

    return jfn, tfn


def assert_close(got, want, tol=2e-5, names=NAMES):
    out_t, grads_t = got
    out_j, grads_j = want
    assert np.isfinite(out_t).all()
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)
    assert len(grads_t) == len(grads_j)
    for a, b, nm in zip(grads_t, grads_j, names[1:]):
        assert np.isfinite(a).all(), nm
        scale = max(float(np.abs(b).max()), 1.0)
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=tol,
                                   err_msg=nm)


@pytest.mark.parametrize("partial", [False, True], ids=["norm", "partial"])
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("nh,f", [(8, 8), (1, 7), (4, 32), (6, 11)])
def test_v2_op_matches_jax(nh, f, dropout, partial):
    """Capped logits at eps 1e-8: forward and the cotangents of the
    logits, h_src and the mask."""
    c = make_case(nh, f, seed=nh * 10 + f, dropout=dropout)
    want, got = run_both(c["args"], *pair(c, 1e-8, partial))
    assert_close(got, want)
    out = got[0]
    # destinations without an edge (the odd ones) get zero rows
    assert np.all(out[1:N - 1:2] == 0.0)


@pytest.mark.parametrize("partial", [False, True], ids=["norm", "partial"])
@pytest.mark.parametrize("nh,f", [(4, 32), (6, 11)])
def test_v2_op_matches_jax_at_eps_zero(nh, f, partial):
    """paper_faithful hands the op max-subtracted logits and eps = 0:
    empty segments give 0, not NaN, in the output and the cotangents."""
    c = make_case(nh, f, seed=5, dropout=True, kind="segmax")
    want, got = run_both(c["args"], *pair(c, 0.0, partial))
    assert_close(got, want)


@pytest.mark.parametrize("partial", [False, True], ids=["norm", "partial"])
def test_v2_op_told_the_number_of_real_edges(partial):
    """A caller that knows how many leading edges are real passes it and
    the padding edges are not walked: the same result, also where their
    logits are not NEG_INF, and zero cotangents on them."""
    c = make_case(6, 11, seed=9, dropout=True)
    want, got = run_both(c["args"], *pair(c, 1e-8, partial, E_REAL))
    assert_close(got, want)
    c["args"][0][E_REAL:] = 0.5
    _, again = run_both(c["args"], *pair(c, 1e-8, partial, E_REAL))
    for a, b in zip(got[1], again[1]):
        assert np.array_equal(a, b)
    for grad in again[1]:
        assert np.all(grad[E_REAL:] == 0.0)
    with pytest.raises(ValueError, match="num_real_edges"):
        pair(c, 1e-8, partial, E_REAL + PAD + 1)[1](
            *[torch.tensor(a) for a in c["args"]])


@pytest.mark.parametrize("k", [2, 4])
def test_partial_slices_sum_to_the_full_op(k):
    """The cut contract: K contiguous slices of the edge list, each shard
    told its own real-edge count clamp(E_real - k E/K, 0, E/K), summed and
    divided, give the JAX package's full normalised op; their cotangents,
    concatenated, its cotangents."""
    nh, f = 4, 8
    c = make_case(nh, f, seed=21, dropout=True)
    e = E_REAL + PAD
    assert e % k == 0
    shard = e // k
    leaves = [torch.tensor(a, requires_grad=True) for a in c["args"]]
    num = den = 0.0
    for i in range(k):
        sl = slice(i * shard, (i + 1) * shard)
        e_real_i = min(max(E_REAL - i * shard, 0), shard)
        n_i, d_i = tsa.fused_segment_attention_partial(
            leaves[0][sl], leaves[1][sl], torch.tensor(c["recv"][sl]),
            leaves[2][sl], N, nh, f, e_real_i)
        num, den = num + n_i, den + d_i
    inv = torch.where(den > 0, 1.0 / (den + 1e-8), torch.zeros_like(den))
    out = (num.view(N, nh, f) * inv[:, :, None]).reshape(N, nh * f)
    torch.sin(out).sum().backward()
    got = (out.detach().numpy(), [t.grad.numpy() for t in leaves])
    want, full = run_both(c["args"], *pair(c, 1e-8))
    assert_close(got, want)
    assert_close(got, full)


@pytest.mark.parametrize("partial", [False, True], ids=["norm", "partial"])
def test_v2_op_bf16_mode_matches_jax(partial, monkeypatch):
    """GAT_TPU_KERNEL_DTYPE=bfloat16 rounds each edge's [m ex h | ex]
    before the forward's float32 sums, in the JAX kernel and in the
    port; the backward reads the rounded output but rounds nothing."""
    c = make_case(4, 16, seed=14, dropout=True)
    args = c["args"]
    jfn, tfn = pair(c, 1e-8, partial)
    f32 = run_both(args, jfn, tfn)[1]
    monkeypatch.setenv("GAT_TPU_KERNEL_DTYPE", "bfloat16")
    want, got = run_both(args, jfn, tfn)
    assert_bf16_mode(got, want, f32, NAMES)


@pytest.mark.parametrize("partial", [False, True], ids=["norm", "partial"])
def test_v2_op_reads_only_the_real_rows_of_h_src(partial):
    """A caller that passes the number of real edges may gather h_src for
    them alone (the sharded layer does): the same outputs and cotangents,
    the d(h_src) of the real rows, bit for bit; fewer rows than real
    edges are refused."""
    c = make_case(4, 8, seed=3, dropout=True)
    tfn = pair(c, 1e-8, partial, E_REAL)[1]

    def run_port(args):
        leaves = [torch.tensor(a, requires_grad=True) for a in args]
        out = tfn(*leaves)
        torch.sin(out).sum().backward()
        return out.detach().numpy(), [t.grad.numpy() for t in leaves]

    full = run_port(c["args"])
    c["args"][1] = c["args"][1][:E_REAL]
    cut = run_port(c["args"])
    assert np.array_equal(cut[0], full[0])
    assert np.array_equal(cut[1][1], full[1][1][:E_REAL])
    for i in (0, 2):
        assert np.array_equal(cut[1][i], full[1][i])
    with pytest.raises(ValueError, match="num_real_edges"):
        pair(c, 1e-8, partial, E_REAL + 1)[1](
            *[torch.tensor(a) for a in c["args"]])
