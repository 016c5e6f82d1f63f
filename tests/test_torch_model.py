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
    interpret mode with float32 contractions.
The Adam update is compared on its own, from identical gradients.
"""

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
from gat_pytorch_tpu_torch.graph import transforms as TT
from gat_pytorch_tpu_torch.models import gat as tgat
from gat_pytorch_tpu_torch.train import optim as topt
from gat_pytorch_tpu_torch.train.tasks import planetoid_task as ttask
from gat_pytorch_tpu_torch.utils.convert import params_from_jax

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


@pytest.mark.parametrize("extra", [
    {"paper_faithful": True}, {"const_attention": True}])
def test_kernel_path_refuses_unported_modes(extra):
    _, tcfg, _, tg, _, tparams = build("cora", **extra)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgat.gat_model_apply(tparams, tcfg, tg, device="cpu")


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
