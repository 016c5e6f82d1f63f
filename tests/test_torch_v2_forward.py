"""The v2 forward (row 9) on its two layouts: the wrapper's plan, and the
op against the JAX package's at PPI's widths.

The kernel walks each destination's run with the v5 and table forwards'
bodies (csrc/attention_common.cuh attention_fwd_wide / _narrow, the rows
streamed): at f >= 32 a block of nh warps a destination, warp k head k,
at narrower heads one warp a destination in teams of lanes sized to the
row (v5_attention.plan_of, the v5 forward's lane plan). The plan decides
which layout runs and which elements a lane loads; the kernel refuses a
plan that does not cover the row. Here:
  * the plan and segment_attention.forward_blocks at PPI's 4 x 256 and
    6 x 121 (the wide layout: 16-byte vectors where 4 divides f, 8-byte
    at 6 x 121, whose heads start mid-vector) and Cora's 8 x 8 and 1 x 7
    (teams of 16 and 8 lanes), at every alignment of the table, cover
    each row as the kernel's check_plan requires;
  * the op's forward against JAX fused_segment_attention and
    fused_segment_attention_partial in interpret mode at 4 x 256 and
    6 x 121, which tests/test_torch_v2_attention.py does not reach: both
    modes, with and without dropout, with destinations without an edge
    and padding edges; float32 within rtol/atol 1e-5 (float32 sums in
    another order, test_torch_v2_attention.py's tolerance); and under
    GAT_TPU_KERNEL_DTYPE=bfloat16 within 1e-2 of max(1, |ref|) and live
    (the rounded sums move the output by more than 1e-4 of its scale).
On CPU tensors the op runs the kernel's plain version; the card holds the
kernel to it (chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gat_pytorch_tpu.ops.pallas import segment_attention as jfsa
from gat_pytorch_tpu_torch.ops.cuda import segment_attention as tsa
from gat_pytorch_tpu_torch.ops.cuda import v5_attention as tv5

from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_v2_attention import make_case

SHAPES = [(4, 256), (6, 121), (8, 8), (1, 7)]
# the plan of each shape at a table aligned to 16 bytes: (wide, vec,
# per_lane, lanes)
PLANS = {(4, 256): (True, 4, 2, 32), (6, 121): (True, 2, 2, 32),
         (8, 8): (False, 4, 1, 16), (1, 7): (False, 1, 1, 8)}


def covers(plan, nh, f):
    """The kernel's check_plan in Python: the wide plan covers a head from
    the vector holding its first element with 32 lanes, the narrow one the
    row with lanes * vec * per_lane elements, vectors meeting at most two
    heads."""
    d = nh * f
    if d % plan.vec:
        return False
    if plan.wide:
        span = f + plan.vec - 1 if f % plan.vec else f
        return plan.lanes == 32 and 32 * plan.vec * plan.per_lane >= span
    pow2 = plan.lanes & (plan.lanes - 1) == 0
    return (pow2 and plan.lanes * plan.vec * plan.per_lane >= d
            and (f % plan.vec == 0 or plan.vec <= f + 1))


def table_at(n, d, offset):
    """An (n, d) float32 table starting `offset` floats into a buffer
    aligned to 16 bytes."""
    return torch.zeros(n * d + 4)[offset:offset + n * d].view(n, d)


@pytest.mark.parametrize("nh,f", SHAPES)
def test_forward_plan(nh, f):
    """The wrapper's plan (v5_attention.plan_of of the h_src table and the
    output): f >= 32 takes the wide layout, narrower heads teams of
    lanes; a table at every alignment gives a plan the kernel takes, the
    widest vector it allows; the grid is a block a destination (wide) or
    a warp each (narrow)."""
    d = nh * f
    out = table_at(8, d, 0)
    plan = tv5.plan_of(table_at(8, d, 0), out, nh, f)
    assert plan[:4] == PLANS[(nh, f)]
    assert plan.wide == (f >= 32)
    for offset, align in ((0, 4), (2, 2), (1, 1)):
        p = tv5.plan_of(table_at(8, d, offset), out, nh, f)
        assert p.vec <= align and covers(p, nh, f), (offset, p)
    # an output aligned to 4 bytes only takes scalar stores
    assert tv5.plan_of(table_at(8, d, 0), table_at(8, d, 1), nh, f).vec == 1
    assert tsa.forward_blocks(plan, 2432) == (2432 if plan.wide else 304)
    assert tsa.forward_blocks(plan, 1) == 1


def jax_forward(c, partial, eps):
    args = [jnp.asarray(a) for a in c["args"]]
    dd = args[2] if len(args) > 2 else None
    rc = jnp.asarray(c["recv"])
    n, nh, f = c["n"], c["nh"], c["f"]
    if partial:
        num, den = jfsa.fused_segment_attention_partial(
            args[0], args[1], rc, dd, n, nh, f, 256, 128, True)
        return np.concatenate([np.asarray(num), np.asarray(den)], axis=1)
    return np.asarray(jfsa.fused_segment_attention(
        args[0], args[1], rc, dd, n, nh, f, eps, 256, 128, True))


def port_forward(c, partial, eps):
    t = [torch.tensor(a) for a in c["args"]]
    dd = t[2] if len(t) > 2 else None
    rc = torch.tensor(c["recv"])
    n, nh, f = c["n"], c["nh"], c["f"]
    if partial:
        return torch.cat(tsa.fused_segment_attention_partial(
            t[0], t[1], rc, dd, n, nh, f, c["e_real"]), dim=1).numpy()
    return tsa.fused_segment_attention(t[0], t[1], rc, dd, n, nh, f, eps,
                                       c["e_real"]).numpy()


def wide_case(nh, f, dropout):
    """A small graph at a wide row: 96 destinations (the odd ones without
    an edge), 300 real edges and 12 padding edges on the last node."""
    return make_case(nh, f, seed=nh * 1000 + f, dropout=dropout, n=96,
                     e_real=300, pad=12)


@pytest.mark.parametrize("partial", [False, True], ids=["norm", "partial"])
@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("nh,f", [(4, 256), (6, 121)])
def test_wide_forward_matches_jax(nh, f, dropout, partial):
    c = wide_case(nh, f, dropout)
    got, want = port_forward(c, partial, 1e-8), jax_forward(c, partial,
                                                            1e-8)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # destinations without an edge get zero rows (num and den alike)
    assert np.all(got[1:c["n"] - 1:2] == 0.0)


@pytest.mark.parametrize("partial", [False, True], ids=["norm", "partial"])
@pytest.mark.parametrize("nh,f", [(4, 256), (6, 121)])
def test_wide_forward_bf16_mode_matches_jax(nh, f, partial, monkeypatch):
    """GAT_TPU_KERNEL_DTYPE=bfloat16 rounds each edge's [m ex h | ex]
    before the float32 sums in both packages."""
    c = wide_case(nh, f, True)
    f32 = port_forward(c, partial, 1e-8)
    monkeypatch.setenv("GAT_TPU_KERNEL_DTYPE", "bfloat16")
    got, want = port_forward(c, partial, 1e-8), jax_forward(c, partial,
                                                            1e-8)
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= 1e-2 * scale
    assert float(np.abs(f32 - got).max()) > 1e-4 * scale, "mode not live"
