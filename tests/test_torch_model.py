"""The slice as a whole: the port's 2-layer GAT against the JAX model.

The same graph (canonicalised by each package from the same numpy
arrays) and the same parameters (carried over with params_from_jax) go
through both, dropout off. The logits and the gradient of the planetoid
training loss for every parameter must agree to rtol 1e-4 / atol 1e-5
(float32 sums over edges and features in another order):
  * the port's kernel path (plain versions on the CPU) against
    gat_model_apply(backend="pallas") in interpret mode, the v5 op forced
    on the small graph with GAT_TPU_V5=1;
  * the port's segment path against the JAX "xla" path;
  * on a banded graph that carries a block layout, the port's "v7" path
    against gat_model_apply(backend="pallas", force_windowed=True) in
    interpret mode with float32 contractions;
  * on a community graph in cluster order with the hybrid layout, the
    port's "v7_hybrid" path against the JAX hybrid branch with its
    remainder sent through v5_sweep1_parts
    (GAT_TPU_HYBRID_REM_XLA_MAX=0), and against the JAX "xla" path;
  * with paper_faithful or const_attention, and on a graph without
    src_order, the port's "v4_table" path against the JAX "pallas" path
    (its v4 table op, interpret mode) and the "xla" path; also a 3-layer
    PPI-shaped model (skip on layer 2, widths 4x16, 4x16, 6x11, BCE loss).
The Adam update is compared on its own, from identical gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gat_pytorch_tpu.graph import transforms as JT
from gat_pytorch_tpu.models import gat as jgat
from gat_pytorch_tpu.train import optim as jopt
from gat_pytorch_tpu.train.tasks import planetoid_task as jtask
from gat_pytorch_tpu.train.tasks import ppi_task as jppi_task
from gat_pytorch_tpu_torch.graph import transforms as TT
from gat_pytorch_tpu_torch.models import gat as tgat
from gat_pytorch_tpu_torch.ops.cuda import v5_attention as tv5
from gat_pytorch_tpu_torch.ops.cuda import window_attention as tw
from gat_pytorch_tpu_torch.train import optim as topt
from gat_pytorch_tpu_torch.train.tasks import planetoid_task as ttask
from gat_pytorch_tpu_torch.train.tasks import ppi_task as tppi_task
from gat_pytorch_tpu_torch.utils.convert import params_from_jax

from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_layout import clustered

TOL = dict(rtol=1e-4, atol=1e-5)

# the Cora configuration at narrow width, and a Pubmed-like one with skip
# projections and a mean-folded multi-head last layer
CONFIGS = {
    "cora": dict(num_heads_per_layer=[8, 1],
                 heads_concat_per_layer=[True, False],
                 head_output_features_per_layer=[32, 8, 7], num_classes=7,
                 add_skip_connection=[False, False]),
    "skips": dict(num_heads_per_layer=[8, 8],
                  heads_concat_per_layer=[True, False],
                  head_output_features_per_layer=[32, 8, 3], num_classes=3,
                  add_skip_connection=[True, True]),
}


def make_graph_arrays(num_classes, n=200, e=1200, f_in=32, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    x = (rng.random((n, f_in)) < 0.2).astype(np.float32)
    y = rng.integers(0, num_classes, n)
    split = rng.permutation(n)
    masks = [np.zeros(n, bool) for _ in range(3)]
    for m, idx in zip(masks, (split[:60], split[60:130], split[130:])):
        m[idx] = True
    return dict(x=x, senders=s, receivers=r, y=y, train_mask=masks[0],
                val_mask=masks[1], test_mask=masks[2])


def build(name, **extra):
    kw = dict(CONFIGS[name], num_input_node_features=32, num_layers=2,
              dropout=0.0, **extra)
    jcfg, tcfg = jgat.GATConfig(**kw), tgat.GATConfig(**kw)
    arr = make_graph_arrays(kw["num_classes"])
    args = (arr.pop("x"), arr.pop("senders"), arr.pop("receivers"))
    jg, tg = JT.canonicalize(*args, **arr), TT.canonicalize(*args, **arr)
    jparams = jgat.init_gat_model(jax.random.key(1), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jg, tg, jparams, tparams


def jax_loss_and_grads(jcfg, jg, jparams, backend):
    task = jtask()

    def loss(p):
        logits = jgat.gat_model_apply(p, jcfg, jg, backend=backend)
        return task.loss(logits, jg, "train"), logits

    (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(jparams)
    return np.asarray(logits), grads


def torch_loss_and_grads(tcfg, tg, tparams, backend):
    logits = tgat.gat_model_apply(tparams, tcfg, tg, device="cpu",
                                  backend=backend)
    ttask().loss(logits, tg, "train").backward()
    return logits.detach().numpy()


def assert_same(jlogits, jgrads, tlogits, tparams):
    np.testing.assert_allclose(tlogits, jlogits, **TOL)
    for group in ("layers", "skips"):
        assert len(tparams[group]) == len(jgrads[group])
        for i, (tp, jgr) in enumerate(zip(tparams[group], jgrads[group])):
            assert sorted(tp) == sorted(jgr)
            for k in tp:
                np.testing.assert_allclose(
                    tp[k].grad.numpy(), np.asarray(jgr[k]), **TOL,
                    err_msg=f"{group}[{i}].{k}")


@pytest.mark.parametrize("name", ["cora", "skips"])
def test_kernel_path_matches_jax_pallas(name, monkeypatch):
    monkeypatch.setenv("GAT_TPU_V5", "1")
    jcfg, tcfg, jg, tg, jparams, tparams = build(name)
    jgat.PATH_TRACE.clear()
    jlogits, jgrads = jax_loss_and_grads(jcfg, jg, jparams, "pallas")
    assert jgat.PATH_TRACE == ["v5", "v5"]
    tgat.PATH_TRACE.clear()
    tlogits = torch_loss_and_grads(tcfg, tg, tparams, "kernel")
    assert tgat.PATH_TRACE == ["v5", "v5"]
    assert tlogits.shape == (tg.num_nodes, tcfg.num_classes)
    assert_same(jlogits, jgrads, tlogits, tparams)


def build_windowed(name, n=1500, e=9000, band=400):
    """`build` on a banded graph (senders near receivers, as
    tests/test_window_kernel.py) canonicalised with src_windows=True."""
    kw = dict(CONFIGS[name], num_input_node_features=32, num_layers=2,
              dropout=0.0)
    jcfg, tcfg = jgat.GATConfig(**kw), tgat.GATConfig(**kw)
    arr = make_graph_arrays(kw["num_classes"], n=n, e=e)
    rng = np.random.default_rng(7)
    arr["receivers"] = rng.integers(0, n, e)
    arr["senders"] = np.clip(
        arr["receivers"] + rng.integers(-band // 2, band // 2, e), 0, n - 1)
    args = (arr.pop("x"), arr.pop("senders"), arr.pop("receivers"))
    jg = JT.canonicalize(*args, **arr, src_windows=True)
    tg = TT.canonicalize(*args, **arr, src_windows=True)
    jparams = jgat.init_gat_model(jax.random.key(2), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jg, tg, jparams, tparams


@pytest.mark.parametrize("name", ["cora", "skips"])
def test_windowed_path_matches_jax_v7(name, monkeypatch):
    monkeypatch.setenv("GAT_TPU_V6_DTYPE", "float32")
    jcfg, tcfg, jg, tg, jparams, tparams = build_windowed(name)
    task = jtask()

    def loss(p):
        logits = jgat.gat_model_apply(p, jcfg, jg, backend="pallas",
                                      force_windowed=True)
        return task.loss(logits, jg, "train"), logits

    jgat.PATH_TRACE.clear()
    (_, jlogits), jgrads = jax.value_and_grad(loss, has_aux=True)(jparams)
    assert jgat.PATH_TRACE == ["v7", "v7"]
    tgat.PATH_TRACE.clear()
    tlogits = torch_loss_and_grads(tcfg, tg, tparams, "kernel")
    assert tgat.PATH_TRACE == ["v7", "v7"]
    assert tlogits.shape == (tg.num_nodes, tcfg.num_classes)
    assert_same(np.asarray(jlogits), jgrads, tlogits, tparams)


def test_windowed_path_matches_the_other_paths():
    """One graph, three routes of the port: the windowed op, the v5 op
    (the same graph without its block layout) and the segment ops."""
    _, tcfg, _, tg, _, tparams = build_windowed("skips", n=600, e=3000)
    results = []
    for graph, backend, path in ((tg, "kernel", "v7"),
                                 (tg.replace(block_layout=None), "kernel",
                                  "v5"),
                                 (tg, "segment", "segment")):
        for p in tgat.parameters(tparams):
            p.grad = None
        tgat.PATH_TRACE.clear()
        logits = torch_loss_and_grads(tcfg, graph, tparams, backend)
        assert tgat.PATH_TRACE == [path, path]
        results.append((logits, [p.grad.clone().numpy()
                                 for p in tgat.parameters(tparams)]))
    for logits, grads in results[1:]:
        np.testing.assert_allclose(results[0][0], logits, **TOL)
        for a, b in zip(results[0][1], grads):
            np.testing.assert_allclose(a, b, **TOL)


def test_windowed_dropout_mask_is_drawn_in_slot_order():
    """With attention dropout on, the kernel path draws an (E7, nh) mask
    for the layout's slots and an (E, nh) one without a layout: the same
    generator state then yields different logits on the two routes, and
    the same on a repeat."""
    _, _, _, tg, _, tparams = build_windowed("cora", n=600, e=3000)
    cfg = tgat.GATConfig(**dict(CONFIGS["cora"], num_input_node_features=32,
                                num_layers=2, dropout=0.5))
    assert tg.block_layout.num_slots != tg.num_edges

    def run(graph):
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            return tgat.gat_model_apply(tparams, cfg, graph, device="cpu",
                                        generator=gen, training=True)

    a, b = run(tg), run(tg)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert not torch.allclose(a, run(tg.replace(block_layout=None)))


@pytest.mark.parametrize("extra", [
    {}, {"paper_faithful": True}, {"const_attention": True}])
def test_segment_path_matches_jax_xla(extra):
    jcfg, tcfg, jg, tg, jparams, tparams = build("cora", **extra)
    jlogits, jgrads = jax_loss_and_grads(jcfg, jg, jparams, "xla")
    tgat.PATH_TRACE.clear()
    tlogits = torch_loss_and_grads(tcfg, tg, tparams, "segment")
    assert tgat.PATH_TRACE == ["segment", "segment"]
    assert_same(jlogits, jgrads, tlogits, tparams)


@pytest.mark.parametrize("extra", [{"backend": "naive"}, {"training": True}])
def test_kernel_path_refuses_unported_modes(extra):
    """paper_faithful, const_attention and the hybrid layout run on the
    kernel path now (the tests around this one); what the model still
    refuses is a layer path it does not have (the JAX package's "naive"
    oracle) and dropout without a generator."""
    _, tcfg, _, tg, _, tparams = build("cora")
    cfg = tgat.GATConfig(**dict(CONFIGS["cora"], num_input_node_features=32,
                                num_layers=2, dropout=0.5))
    with pytest.raises(ValueError, match="backend|generator"):
        tgat.gat_model_apply(tparams, cfg, tg, device="cpu", **extra)


def build_hybrid(seed=4, n=900, dropout=0.0):
    """The 2-layer model of tests/test_hybrid_layout.py (2 heads x 8
    concatenated, 2 x 4 mean-folded with a skip projection) on its small
    SBM (12 features), in cluster order with the hybrid layout."""
    kw = dict(num_input_node_features=12, num_layers=2,
              num_heads_per_layer=[2, 2], heads_concat_per_layer=[True, False],
              head_output_features_per_layer=[12, 8, 4], num_classes=4,
              add_skip_connection=[False, True], dropout=dropout)
    jcfg, tcfg = jgat.GATConfig(**kw), tgat.GATConfig(**kw)
    x, send, recv = clustered(seed, n=n)
    rng = np.random.default_rng(seed)
    gkw = dict(y=rng.integers(0, 4, n), train_mask=rng.random(n) < 0.3,
               reorder="cluster", src_windows=True, hybrid=True)
    jg = JT.canonicalize(x, send, recv, **gkw)
    tg = TT.canonicalize(x, send, recv, **gkw)
    jparams = jgat.init_gat_model(jax.random.key(3), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    return jcfg, tcfg, jg, tg, jparams, tparams


@pytest.mark.parametrize("jbackend", ["pallas", "xla"])
def test_hybrid_path_matches_jax(jbackend, monkeypatch):
    monkeypatch.setenv("GAT_TPU_V6", "1")
    monkeypatch.setenv("GAT_TPU_V6_DTYPE", "float32")
    # the JAX package's remainder through its v5 parts kernel too
    monkeypatch.setenv("GAT_TPU_HYBRID_REM_XLA_MAX", "0")
    jcfg, tcfg, jg, tg, jparams, tparams = build_hybrid()
    assert tg.block_layout.rem_e > 0
    jgat.PATH_TRACE.clear()
    jlogits, jgrads = jax_loss_and_grads(jcfg, jg, jparams, jbackend)
    assert jgat.PATH_TRACE == [
        "v7_hybrid" if jbackend == "pallas" else "xla"] * 2
    tgat.PATH_TRACE.clear()
    tlogits = torch_loss_and_grads(tcfg, tg, tparams, "kernel")
    assert tgat.PATH_TRACE == ["v7_hybrid", "v7_hybrid"]
    assert tlogits.shape == (tg.num_nodes, tcfg.num_classes)
    assert_same(jlogits, jgrads, tlogits, tparams)


def test_hybrid_path_matches_the_other_paths_and_ignores_the_layout_on_v4():
    """One hybrid graph, the port's routes: hybrid, windowed-free v5 (no
    layout), segment; paper_faithful goes on ignoring the layout."""
    _, tcfg, _, tg, _, tparams = build_hybrid(seed=5)
    results = []
    for graph, backend, path in (
            (tg, "kernel", "v7_hybrid"),
            (tg.replace(block_layout=None), "kernel", "v5"),
            (tg, "segment", "segment")):
        for p in tgat.parameters(tparams):
            p.grad = None
        tgat.PATH_TRACE.clear()
        logits = torch_loss_and_grads(tcfg, graph, tparams, backend)
        assert tgat.PATH_TRACE == [path, path]
        results.append((logits, [p.grad.clone().numpy()
                                 for p in tgat.parameters(tparams)]))
    for logits, grads in results[1:]:
        np.testing.assert_allclose(results[0][0], logits, **TOL)
        for a, b in zip(results[0][1], grads):
            np.testing.assert_allclose(a, b, **TOL)
    pf = dataclasses.replace(tcfg, paper_faithful=True)
    pf_params = tgat.init_gat_model(pf, seed=1, device="cpu")
    tgat.PATH_TRACE.clear()
    tgat.gat_model_apply(pf_params, pf, tg, device="cpu")
    assert tgat.PATH_TRACE == ["v4_table", "v4_table"]


@pytest.mark.parametrize("env,tables", [
    ({}, 1),                                     # float32 tables
    ({"GAT_TPU_V6_DTYPE": "bfloat16"}, 2),       # packed bfloat16, float32
    ({"GAT_TPU_V6_DTYPE": "bfloat16", "GAT_TPU_H_DTYPE": "bfloat16"}, 1),
])
def test_hybrid_layer_computes_one_source_score_table(env, tables,
                                                      monkeypatch):
    """The hybrid layer's two parts ops read one source-score table where
    their kernels read the same h table, and each its own where they do
    not (the windowed op's packed bfloat16 table beside the v5 op's
    float32 one)."""
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    _, tcfg, _, tg, _, tparams = build_hybrid(seed=5)
    dtypes = []
    scores = tv5.source_scores

    def counted(h, a_src):
        dtypes.append(h.dtype)
        return scores(h, a_src)

    monkeypatch.setattr(tv5, "source_scores", counted)
    tgat.PATH_TRACE.clear()
    tgat.gat_model_apply(tparams, tcfg, tg, device="cpu")
    assert tgat.PATH_TRACE == ["v7_hybrid", "v7_hybrid"]
    assert len(dtypes) == 2 * tables
    assert len(set(dtypes)) == (2 if tables == 2 else 1)


def test_hybrid_dropout_masks_are_drawn_layout_first():
    """With attention dropout on, the hybrid branch draws the layout's
    (E7, nh) mask, then the remainder's (rem_E, nh), from the one
    generator, after the layer's input dropout: replaying the generator
    by hand and handing both masks to the parts ops gives the layer's
    output bit for bit."""
    _, _, _, tg, _, tparams = build_hybrid(seed=6)
    bl, nh, f, n = tg.block_layout, 2, 8, tg.num_nodes
    lc = tgat.GATLayerConfig(in_features=12, out_features=f, num_heads=nh,
                             concat=True, dropout=0.5)
    params = {k: v.detach() for k, v in tparams["layers"][0].items()}

    gen = torch.Generator().manual_seed(9)
    got = tgat.gat_layer_apply(
        params, lc, tg.x, tg.senders, tg.receivers, tg.edge_mask, n,
        num_real_edges=tg.num_real_edges, src_order=tg.src_order,
        block_layout=bl, generator=gen, training=True)

    gen = torch.Generator().manual_seed(9)
    masks = [(torch.rand((slots, nh), generator=gen) >= 0.5).float() / 0.5
             for slots in (bl.num_slots, bl.rem_send.shape[0])]
    h = tg.x @ params["W"]
    a_src, a_dst = tgat._split_attention_map(params["a"], nh, f)
    s_both = h @ torch.cat([a_src, a_dst], dim=1)
    s_eff = s_both[:, nh:] - (s_both[:, :nh].max() + s_both[:, nh:].max())
    num1, den1, cap1, _ = tw.v7_sweep1_parts(h, a_src, s_eff, masks[0], bl,
                                             n, nh, f)
    num2, den2, cap2, _ = tv5.v5_sweep1_parts(
        h, a_src, s_eff, masks[1], bl.rem_send, bl.rem_recv, bl.rem_order,
        bl.rem_e, n, nh, f)
    want, _ = tv5.normalise(num1 + num2, den1 + den2,
                            torch.maximum(cap1, cap2), 1e-8, lc.slope, nh)
    assert torch.equal(got, want) and torch.isfinite(got).all()
    # the other order of the two draws gives another output
    swapped, _ = tv5.normalise(
        tw.v7_sweep1_parts(h, a_src, s_eff, masks[0].flip(0), bl, n, nh,
                           f)[0] + num2, den1 + den2,
        torch.maximum(cap1, cap2), 1e-8, lc.slope, nh)
    assert not torch.allclose(got, swapped)


@pytest.mark.parametrize("jbackend", ["pallas", "xla"])
@pytest.mark.parametrize("name,extra", [
    ("cora", {"paper_faithful": True}), ("cora", {"const_attention": True}),
    ("skips", {"paper_faithful": True})])
def test_table_path_matches_jax(name, extra, jbackend):
    jcfg, tcfg, jg, tg, jparams, tparams = build(name, **extra)
    jgat.PATH_TRACE.clear()
    jlogits, jgrads = jax_loss_and_grads(jcfg, jg, jparams, jbackend)
    assert jgat.PATH_TRACE == [
        "v4_table" if jbackend == "pallas" else "xla"] * 2
    tgat.PATH_TRACE.clear()
    tlogits = torch_loss_and_grads(tcfg, tg, tparams, "kernel")
    assert tgat.PATH_TRACE == ["v4_table", "v4_table"]
    assert tlogits.shape == (tg.num_nodes, tcfg.num_classes)
    assert_same(jlogits, jgrads, tlogits, tparams)


def test_table_path_serves_graphs_without_src_order():
    """The reference-quirk model on a graph that carries no src_order:
    both packages take the v4 table op (capped logits, eps 1e-8); the
    result is the v5 path's."""
    jcfg, tcfg, jg, tg, jparams, tparams = build("cora")
    jgat.PATH_TRACE.clear()
    jlogits, jgrads = jax_loss_and_grads(
        jcfg, jg.replace(src_order=None), jparams, "pallas")
    assert jgat.PATH_TRACE == ["v4_table", "v4_table"]
    tgat.PATH_TRACE.clear()
    tlogits = torch_loss_and_grads(tcfg, tg.replace(src_order=None), tparams,
                                   "kernel")
    assert tgat.PATH_TRACE == ["v4_table", "v4_table"]
    assert_same(jlogits, jgrads, tlogits, tparams)
    grads = [p.grad.clone() for p in tgat.parameters(tparams)]
    for p in tgat.parameters(tparams):
        p.grad = None
    tgat.PATH_TRACE.clear()
    v5_logits = torch_loss_and_grads(tcfg, tg, tparams, "kernel")
    assert tgat.PATH_TRACE == ["v5", "v5"]
    np.testing.assert_allclose(tlogits, v5_logits, **TOL)
    for a, p in zip(grads, tgat.parameters(tparams)):
        np.testing.assert_allclose(a.numpy(), p.grad.numpy(), **TOL)


def test_ppi_shaped_model_matches_jax(paper_faithful=True):
    """Three layers, the skip on layer 2, a mean-folded 6-head last layer
    of odd width, multi-label BCE, paper_faithful: v4_table on both
    sides."""
    kw = dict(num_input_node_features=32, num_layers=3,
              num_heads_per_layer=[4, 4, 6],
              heads_concat_per_layer=[True, True, False],
              head_output_features_per_layer=[32, 16, 16, 11],
              num_classes=11, add_skip_connection=[False, True, False],
              dropout=0.0, paper_faithful=paper_faithful)
    jcfg, tcfg = jgat.GATConfig(**kw), tgat.GATConfig(**kw)
    arr = make_graph_arrays(2)
    y = (np.random.default_rng(8).random((200, 11)) < 0.3).astype(np.float32)
    args = (arr["x"], arr["senders"], arr["receivers"])
    jg, tg = JT.canonicalize(*args, y=y), TT.canonicalize(*args, y=y)
    jparams = jgat.init_gat_model(jax.random.key(5), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    jtask_, ttask_ = jppi_task(), tppi_task()

    def loss(p):
        logits = jgat.gat_model_apply(p, jcfg, jg, backend="pallas")
        return jtask_.loss(logits, jg, "train"), logits

    path = "v4_table"
    jgat.PATH_TRACE.clear()
    (_, jlogits), jgrads = jax.value_and_grad(loss, has_aux=True)(jparams)
    assert jgat.PATH_TRACE == [path] * 3
    tgat.PATH_TRACE.clear()
    tlogits = tgat.gat_model_apply(tparams, tcfg, tg, device="cpu")
    ttask_.loss(tlogits, tg, "train").backward()
    assert tgat.PATH_TRACE == [path] * 3
    assert tparams["skips"] == [{}]
    assert_same(np.asarray(jlogits), jgrads, tlogits.detach().numpy(),
                tparams)


def test_table_path_attention_dropout():
    """With dropout on, the table path draws an (E, nh) mask per layer
    from the generator: the same state gives the same logits, and no
    src_order changes nothing but the d(h) order."""
    _, _, _, tg, _, tparams = build("cora", paper_faithful=True)
    cfg = tgat.GATConfig(**dict(CONFIGS["cora"], num_input_node_features=32,
                                num_layers=2, dropout=0.5,
                                paper_faithful=True))

    def run(graph, seed=3):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return tgat.gat_model_apply(tparams, cfg, graph, device="cpu",
                                        generator=gen, training=True)

    a = run(tg)
    assert torch.isfinite(a).all() and torch.equal(a, run(tg))
    assert torch.equal(a, run(tg.replace(src_order=None)))
    assert not torch.allclose(a, run(tg, seed=4))
    with pytest.raises(ValueError, match="generator"):
        tgat.gat_model_apply(tparams, cfg, tg, device="cpu", training=True)


def test_adam_update_matches_optax():
    """torch.optim.Adam(weight_decay) against the JAX adam_l2 (optax
    add_decayed_weights -> scale_by_adam), two steps from the same
    parameters and the same gradients, to 1e-6."""
    rng = np.random.default_rng(4)
    shapes = {"W": (32, 64), "a": (128, 8)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    gs = [{k: rng.normal(size=s).astype(np.float32)
           for k, s in shapes.items()} for _ in range(2)]
    tx = jopt.adam_l2(0.005, 5e-4)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = topt.adam_l2(tp.values(), 0.005, 5e-4)
    for g in gs:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in tp.items():
            t.grad = torch.tensor(g[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6,
                                       err_msg=k)


def test_early_stopping_matches_jax():
    seq = [1.0, 0.9, 0.95, 0.9, 0.8, 0.85, 0.86, 0.87]
    j, t = jopt.EarlyStopping(patience=3), topt.EarlyStopping(patience=3)
    assert [j.update(v) for v in seq] == [t.update(v) for v in seq]
