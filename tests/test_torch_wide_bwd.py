"""The v5 ops at rows wider than 256 floats and the sorted segment sum
with offsets, against the JAX package.

Rows wider than 256 floats take the backward by sender's wide plans (an
item's sums and its sender's row in shared memory), from a float32 and
from a bfloat16 table alike; on CPU tensors its plain version. The same
numpy inputs, made from a seed, go through both packages, the JAX ops in
interpret mode:
  * the v5 op, its parts op and its 2-phase op (v5_local_cap,
    fused_gat_table) at widths 320 (2 x 160 and 4 x 80), with and without
    dropout, at eps 1e-8 and 1, on a real argmax tie, and with more
    source rows than destinations: output 1e-5, cotangents 2e-5 of
    max(|ref|, 1), as tests/test_torch_v5_attention.py holds them;
  * the v5 op in the bfloat16 table mode (GAT_TPU_H_DTYPE) at those
    widths, with the checks of tests/test_torch_bf16_window.py;
  * the backward with the graph's sender offsets against the one that
    derives them (equal bits);
  * gather_rows_sorted_grad with ptr= / num_real= against JAX
    gather_rows_src_sorted (interpret) on a PPI-like batch at 1e-6, and
    bit-equal to the call without offsets where the padding cotangent is
    zero; segment_sum_sorted's plain version against a numpy sum on the
    cases its kernel must handle (one long segment, ids past the
    segments, empty segments, row_limit, widths 1 to 1024);
  * a 3-layer PPI-shaped model (its last layer 6 x 121, 726 wide) on the
    v4 and the v5 path against gat_model_apply(backend="pallas") in
    interpret mode, rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.data import loader as jloader
from gat_pytorch_tpu.data import synthetic as jsyn
from gat_pytorch_tpu.models import gat as jgat
from gat_pytorch_tpu.ops.pallas import gather as jgather
from gat_pytorch_tpu.ops.pallas import segment_attention as jfsa
from gat_pytorch_tpu.train.tasks import ppi_task as jppi_task
from gat_pytorch_tpu_torch.data import loader as tloader
from gat_pytorch_tpu_torch.data import synthetic as tsyn
from gat_pytorch_tpu_torch.models import gat as tgat
from gat_pytorch_tpu_torch.ops import segment as tseg
from gat_pytorch_tpu_torch.ops.cuda import segment_sum as tss
from gat_pytorch_tpu_torch.ops.cuda import v5_attention as tv5
from gat_pytorch_tpu_torch.train.tasks import ppi_task as tppi_task
from gat_pytorch_tpu_torch.utils.convert import params_from_jax

from .test_torch_bf16_window import assert_bf16_mode
from .test_torch_inductive import _small
from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_parts import assert_close
from .test_torch_parts import assert_same as assert_parts_same
from .test_torch_parts import v5_case, v5_parts_pair
from .test_torch_two_phase_ops import NAMES, edge_arrays, jax_edges, run_both
from .test_torch_v5_attention import assert_same, make_case
from .test_torch_v5_by_sender import N, args_of, autocap_fns, sender_case

SLOPE = 0.01
WIDE = [(2, 160), (4, 80)]


# -- the v5 ops at wide rows ------------------------------------------------

@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("nh,f", WIDE)
def test_v5_op_matches_jax_at_wide_rows(nh, f, dropout):
    assert_same(make_case(nh, f, seed=11, e_real=600, dropout=dropout))


@pytest.mark.parametrize("nh,f", WIDE)
def test_v5_op_wide_cap_cotangent(nh, f):
    """eps = 1: the cap's cotangent is of order 1 (its closed form)."""
    c = make_case(nh, f, seed=12, e_real=600, dropout=True)
    c["eps"] = 1.0
    assert_same(c)


def test_v5_op_wide_cap_tie_goes_to_lowest_code():
    """The top edge duplicated and both heads alike: the cap is attained
    at several (edge, head) codes and its cotangent goes to the lowest."""
    c = make_case(2, 160, seed=13, e_real=600, dropout=True)
    c["a_src"][:, 1] = c["a_src"][:, 0]
    c["s_dst"][:, 1] = c["s_dst"][:, 0]
    c["s_dst"][c["recv"][10]] += 6.0
    dup = np.insert(np.arange(c["send"].shape[0]), 10, 10)[:-1]
    c["send"], c["recv"] = c["send"][dup], c["recv"][dup]
    c["order"] = np.argsort(c["send"], kind="stable").astype(np.int32)
    raw = (c["h"][c["send"][:c["e_real"]]] @ c["a_src"]
           + c["s_dst"][c["recv"][:c["e_real"]]])
    assert (raw == raw.max()).sum() >= 2
    assert_same(c)


@pytest.mark.parametrize("dropout", [False, True])
def test_v5_parts_match_jax_at_wide_rows(dropout):
    c = v5_case(4, 80, dropout, seed=14, e_real=600)
    assert_parts_same(c, *v5_parts_pair(c), 4)


def test_v5_parts_wide_with_more_source_rows_than_destinations():
    c = v5_case(2, 160, True, seed=15, n_src=320, e_real=600)
    assert c["send"].max() >= 256
    _, grads = assert_parts_same(c, *v5_parts_pair(c), 2)
    assert grads[0].shape == (320, 320)


@pytest.mark.parametrize("dropout,eps,n_src", [(False, 1e-8, 256),
                                               (True, 1.0, 320)])
def test_fused_gat_table_matches_jax_at_wide_rows(dropout, eps, n_src):
    """The 2-phase op with the reference's cap (v5_local_cap), so that
    the argmax edge has pre == 0 and takes the slope in both packages."""
    nh, f = 2, 160
    c = v5_case(nh, f, dropout, seed=16, n_src=n_src, e_real=600)
    er = c["e_real"]
    sd, rc, od = jax_edges(c)
    send, recv, order = edge_arrays(c)
    n_src_arg = None if n_src == 256 else n_src
    args = [c["h"], c["a_src"], c["s_dst"]]
    if dropout:
        args.append(c["drop"])

    def jfn(h, a, s, dd=None):
        cap = jfsa.v5_local_cap(h, a, s, sd, rc, jnp.int32(er), 256, nh, f,
                                256, 128, True)
        return jfsa.fused_gat_table(h, a, s, cap, dd, sd, rc, od,
                                    jnp.int32(er), 256, nh, f, eps, SLOPE,
                                    256, 128, True, n_src_arg)

    def tfn(h, a, s, dd=None):
        cap = tv5.v5_local_cap(h, a, s, send, recv, er, 256, nh, f)
        return tv5.fused_gat_table(h, a, s, cap, dd, send, recv, order, er,
                                   256, nh, f, eps, SLOPE, n_src_arg)

    (jout, jg), (tout, tg) = run_both(args, jfn, tfn)
    assert_close([tout], [jout], 1e-5, ("out",))
    assert_close(tg, jg, 2e-5, NAMES[:3] + NAMES[4:])
    assert tg[0].shape == (n_src, nh * f)


@pytest.mark.parametrize("nh,f", WIDE)
def test_v5_op_bf16_table_mode_matches_jax_at_wide_rows(nh, f, monkeypatch):
    """GAT_TPU_H_DTYPE=bfloat16 at rows of 320 floats: the backward by
    sender reads the rounded rows in every product, d(h) stays float32;
    within 1e-2 of the JAX op, live, and 10x nearer it than the port's
    float32 result."""
    c = sender_case(nh, f, seed=nh * 10 + 7, n_src=N)
    fns = autocap_fns(c)
    f32 = run_both(args_of(c), *fns)[1]
    monkeypatch.setenv("GAT_TPU_H_DTYPE", "bfloat16")
    want, got = run_both(args_of(c), *fns)
    assert_bf16_mode(got, want, f32)


# -- the backward with the graph's sender runs --------------------------------

def wide_backward_args(nh=4, f=80, seed=17):
    c = make_case(nh, f, seed=seed, e_real=600, dropout=True)
    t = {k: torch.tensor(c[k]) for k in ("h", "a_src", "s_dst", "drop",
                                         "send", "recv")}
    s_eff = t["s_dst"] - ((t["h"] @ t["a_src"]).max() + t["s_dst"].max())
    num, den, cap, _ = tv5.v5_forward(t["h"], t["a_src"], s_eff, t["drop"],
                                      t["send"], t["recv"], c["e_real"],
                                      SLOPE)
    out, epsp = tv5.normalise(num, den, cap, 1e-8, SLOPE, nh)
    g = torch.tensor(np.random.default_rng(seed).normal(
        size=out.shape).astype(np.float32))
    return c, (t["h"], t["a_src"], s_eff, t["drop"], t["send"], t["recv"],
               c["e_real"], SLOPE, g, out, den, epsp, True)


def test_wide_backward_with_the_graph_s_sender_runs_gives_the_bits():
    """The backward by sender (its plain version on CPU tensors): the real
    edges' runs from the graph (src_order, src_ptr) and the ones the
    wrapper derives when it has none sum in the same order."""
    c, args = wide_backward_args(seed=18)
    send, e_real = args[4], c["e_real"]
    order = torch.argsort(send, stable=True).to(torch.int32)
    ids = send.index_select(0, order[:e_real].long())
    ptr = torch.searchsorted(ids, torch.arange(c["n"] + 1, dtype=torch.int32),
                             out_int32=True)
    derived = tv5.sender_runs(send, e_real, c["n"])
    assert torch.equal(derived[0], order[:e_real])
    assert torch.equal(derived[1], ptr)
    with_ptr = tv5.v5_backward(*args, src_order=order, src_ptr=ptr)
    without = tv5.v5_backward(*args)
    for a, b in zip(with_ptr, without):
        assert torch.equal(a, b)


# -- the sorted segment sum and the gathers built on it -----------------------

def ppi_batch():
    """A PPI-like batch of two small stand-in graphs, padded to its
    bucket: the padding edges hang on the sink."""
    graphs = _small(tsyn.make_ppi_like("train", num_graphs=2), n=60)
    return tloader.InductiveBatcher(graphs, 2, shuffle=False).epoch()[0]


def test_gather_with_offsets_matches_jax_gather_rows_src_sorted():
    g = ppi_batch()
    n, e, er = g.num_nodes, g.num_edges, g.num_real_edges
    assert er < e and g.src_ptr is not None
    rng = np.random.default_rng(19)
    table = rng.normal(size=(n, 6)).astype(np.float32)
    weight = rng.normal(size=(e, 6)).astype(np.float32)
    weight[er:] = 0.0       # the padding edges' cotangent, as the layer's
    for indices, order, kw in (
            (g.senders, g.src_order, dict(ptr=g.src_ptr)),
            (g.receivers, None, dict(ptr=g.dst_ptr, num_real=er))):
        jorder = (jnp.asarray(order.numpy()) if order is not None
                  else jnp.arange(e, dtype=jnp.int32))
        want = jax.grad(lambda t: jnp.sum(jgather.gather_rows_src_sorted(
            t, jnp.asarray(indices.numpy()), jorder, n, True)
            * weight))(jnp.asarray(table))

        def grad(**k):
            t = torch.tensor(table, requires_grad=True)
            (tseg.gather_rows_sorted_grad(t, indices, n, order, **k)
             * torch.tensor(weight)).sum().backward()
            return t.grad

        got = grad(**kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
        assert torch.equal(got, grad())


def numpy_segment_sum(values, keys, n):
    out = np.zeros((n,) + values.shape[1:], np.float64)
    for v, k in zip(values, keys):
        if 0 <= k < n:
            out[k] += v
    return out


@pytest.mark.parametrize("case", ["one_segment", "all_one_id", "past_nseg",
                                  "empty_segments", "row_limit", "negative"])
@pytest.mark.parametrize("d", [1, 6, 1024])
def test_sorted_sum_plain_forms(case, d):
    """The plain version of every form (ids, ids through order, offsets;
    with row_limit) against a float64 numpy sum of the same rows."""
    rng = np.random.default_rng(20)
    e, n = 700, 40
    if case == "one_segment":
        ids = np.full(e, 7)
    elif case == "all_one_id":
        ids = np.zeros(e, np.int64)
    elif case == "past_nseg":
        ids = np.sort(rng.integers(0, n + 5, e))
    elif case == "negative":
        ids = np.sort(rng.integers(-3, n, e))
    else:
        ids = np.sort(rng.choice(np.arange(0, n, 3), e))
    limit = 500 if case == "row_limit" else None
    values = rng.normal(size=(e, d)).astype(np.float32)
    perm = rng.permutation(e)           # rows stored out of order
    stored = np.empty_like(values)
    stored[perm] = values
    ids_rows = np.empty_like(ids)
    ids_rows[perm] = ids
    kept = slice(None, limit)
    want = numpy_segment_sum(values[kept], ids[kept], n)
    order = torch.tensor(perm.astype(np.int32))
    ptr_ids = np.clip(ids, -1, n)
    ptr = torch.tensor(np.searchsorted(ptr_ids, np.arange(n + 1)),
                       dtype=torch.int32)
    forms = [tss.segment_sum_sorted(torch.tensor(values), torch.tensor(
                 ids.astype(np.int32)), n, row_limit=limit),
             tss.segment_sum_sorted(torch.tensor(stored), torch.tensor(
                 ids_rows.astype(np.int32)), n, order=order,
                 row_limit=limit),
             # offsets: the positions before ptr[0] (negative ids) and
             # from ptr[n] on (ids past the segments) belong to none
             tss.segment_sum_sorted(torch.tensor(stored), None, n,
                                    order=order, ptr=ptr, row_limit=limit)]
    for got in forms:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    assert all(torch.equal(forms[0], f) for f in forms[1:])


def test_sorted_sum_of_no_rows_is_zero():
    out = tss.segment_sum_sorted(torch.zeros((0, 3)), None, 5,
                                 order=torch.zeros((0,), dtype=torch.int32),
                                 ptr=torch.zeros((6,), dtype=torch.int32))
    assert torch.equal(out, torch.zeros((5, 3)))


# -- a PPI-shaped model with a wide layer ------------------------------------

@pytest.mark.parametrize("paper_faithful", [True, False])
def test_ppi_shaped_model_with_a_wide_layer_matches_jax(paper_faithful,
                                                        monkeypatch):
    """PPI's configuration (heads 4, 4, 6; the last layer 6 x 121, 726
    wide, mean-folded; skip on layer 2) on a padded batch of two small
    graphs: the v4 path (paper_faithful) and the v5 path (forced on the
    JAX side with GAT_TPU_V5=1) against gat_model_apply(backend="pallas")
    in interpret mode. The port's batch carries the Graph's offsets, so
    the score gathers and the wide backward take them."""
    monkeypatch.setenv("GAT_TPU_V5", "1")
    kw = dict(num_input_node_features=50, num_layers=3,
              num_heads_per_layer=[4, 4, 6],
              heads_concat_per_layer=[True, True, False],
              head_output_features_per_layer=[50, 16, 16, 121],
              num_classes=121, add_skip_connection=[False, True, False],
              dropout=0.0, paper_faithful=paper_faithful)
    jcfg, tcfg = jgat.GATConfig(**kw), tgat.GATConfig(**kw)
    jg = jloader.InductiveBatcher(
        _small(jsyn.make_ppi_like("train", num_graphs=2), n=60), 2,
        shuffle=False).epoch()[0]
    tg = ppi_batch()
    assert tg.num_real_edges < tg.num_edges and tg.src_ptr is not None
    jparams = jgat.init_gat_model(jax.random.key(21), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    jtask_, ttask_ = jppi_task(), tppi_task()

    def loss(p):
        logits = jgat.gat_model_apply(p, jcfg, jg, backend="pallas")
        return jtask_.loss(logits, jg, "train"), logits

    path = "v4_table" if paper_faithful else "v5"
    jgat.PATH_TRACE.clear()
    (_, jlogits), jgrads = jax.value_and_grad(loss, has_aux=True)(jparams)
    assert jgat.PATH_TRACE == [path] * 3
    tgat.PATH_TRACE.clear()
    tlogits = tgat.gat_model_apply(tparams, tcfg, tg, device="cpu")
    ttask_.loss(tlogits, tg, "train").backward()
    assert tgat.PATH_TRACE == [path] * 3
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               **tol)
    for group in ("layers", "skips"):
        for i, (tp, jgr) in enumerate(zip(tparams[group], jgrads[group])):
            for k in tp:
                np.testing.assert_allclose(
                    tp[k].grad.numpy(), np.asarray(jgr[k]), **tol,
                    err_msg=f"{group}[{i}].{k}")
