"""The port's edge-sharded (cut-neighbourhood) training against the JAX
package's, with the ranks under gloo on the CPU.

The port's ranks are torch.distributed processes started with the spawn
method (tests/torch_ranks.py; a FileStore in tmp_path, so that test
workers never compete for a port), all the cases of one world in one
start. The JAX side runs in this process on conftest's 8-device CPU mesh.
Inputs are the JAX package's: graphs canonicalised by it (the shapes of
tests/test_parallel.py and tests/test_pallas_kernel.py) and parameters
initialised by it, handed to the ranks as numpy arrays. The port runs
both layer paths, `kernel` (the partial v2 op, its plain version on CPU
tensors) and `segment`.

Tolerances: logits and layer outputs rtol 1e-4, atol 1e-5 (the JAX
package's own for its sharded layer against the unsharded one); a step's
loss rtol 1e-5, its parameters rtol 1e-4, atol 1e-6 (its sharded-step
test's); gradients rtol 1e-4, atol 1e-6 (float32 sums in another order
and over shards); fit_sharded's history rtol 1e-4. Across the ranks of
a mesh every replicated result must be equal bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_pytorch_tpu import parallel as jpar
from gat_pytorch_tpu.graph import transforms as JT
from gat_pytorch_tpu.models import gat as jgat
from gat_pytorch_tpu.train.tasks import make_task as jmake_task
from gat_pytorch_tpu.train.trainer import Trainer as JTrainer
from gat_pytorch_tpu.train.trainer import TrainState
from gat_pytorch_tpu_torch.models import gat as tgat

from . import torch_ranks as R
from .test_pallas_kernel import _tiny_graph
from .test_parallel import tiny_batch
from .test_torch_knobs import default_knobs  # noqa: F401

CFG = dict(num_input_node_features=12, num_layers=2,
           num_heads_per_layer=[2, 2], heads_concat_per_layer=[True, False],
           head_output_features_per_layer=[12, 8, 4], num_classes=4,
           add_skip_connection=[False, True])
LAYER = dict(in_features=12, out_features=8, num_heads=2, concat=True)
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
FIT_EPOCHS, FIT_LR = 6, 1e-2


def jcfg(**kw):
    return jgat.GATConfig(**CFG, **kw)


def graph_at(batch, i):
    return jax.tree_util.tree_map(lambda v: v[i], batch)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def gemm_graph():
    """tests/test_parallel.py's non-divisible case: 32 padded nodes, 192
    edges, sharded over 3."""
    rng = np.random.default_rng(11)
    n = 24
    senders = np.repeat(np.arange(n), 3)
    receivers = rng.integers(0, n, n * 3)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    y = (rng.random((n, 4)) > 0.5).astype(np.float32)
    return JT.canonicalize(x, senders, receivers, y=y, node_bucket=32,
                           edge_bucket=192, pad_multiple=32)


def inputs():
    """Every case's JAX inputs, by name."""
    layer_cfg = jgat.GATLayerConfig(**LAYER)
    fit_graphs = [graph_at(tiny_batch(1, seed=i), 0) for i in range(8)]
    rng = jax.random.key(0)           # JAX Trainer.init_state's params
    _, init_rng = jax.random.split(rng)
    return dict(
        layer=(layer_cfg, _tiny_graph(seed=21, num_nodes=120),
               jgat.init_gat_layer(jax.random.key(2), layer_cfg)),
        step=(jcfg(), tiny_batch(4, seed=3),
              jgat.init_gat_model(jax.random.key(1), jcfg())),
        # seed 14: the first layer's argmax edge on shard 2 of 4 (the JAX
        # test's seed 13 puts it on shard 1 of 8, but on shard 0 of 4)
        cap=(jcfg(), graph_at(tiny_batch(1, seed=14), 0),
             jgat.init_gat_model(jax.random.key(5), jcfg())),
        pf=(jcfg(paper_faithful=True), graph_at(tiny_batch(1, seed=17), 0),
            jgat.init_gat_model(jax.random.key(6),
                                jcfg(paper_faithful=True))),
        dropout=(jcfg(dropout=0.4), tiny_batch(4, seed=7),
                 jgat.init_gat_model(jax.random.key(1), jcfg(dropout=0.4))),
        fit=(jcfg(), fit_graphs, jgat.init_gat_model(init_rng, jcfg())),
        gemm=(jcfg(), gemm_graph(),
              jgat.init_gat_model(jax.random.key(4), jcfg())))


def jobs_of(inp):
    """The ranks' jobs: world 4 and world 3 (the non-divisible GEMM)."""
    def batch_arrays(batch, n):
        return [R.numpy_graph(graph_at(batch, i)) for i in range(n)]

    lc, lg, lp = inp["layer"]
    cfg = dataclasses.asdict(jcfg())
    four = [
        dict(name="layer", kind="layer", mesh=(1, 4),
             cfg=dataclasses.asdict(lc), graph=R.numpy_graph(lg),
             params=np_tree(lp)),
        dict(name="step", kind="step", mesh=(2, 2), cfg=cfg, task="PPI",
             lr=0.1, graphs=batch_arrays(inp["step"][1], 4),
             params=np_tree(inp["step"][2])),
        dict(name="cap", kind="model", mesh=(1, 4), cfg=cfg,
             graph=R.numpy_graph(inp["cap"][1]),
             params=np_tree(inp["cap"][2])),
        dict(name="pf", kind="model", mesh=(1, 4),
             cfg=dataclasses.asdict(inp["pf"][0]),
             graph=R.numpy_graph(inp["pf"][1]),
             params=np_tree(inp["pf"][2])),
        dict(name="dropout", kind="step", mesh=(2, 2),
             cfg=dataclasses.asdict(inp["dropout"][0]), task="PPI", lr=0.1,
             graphs=batch_arrays(inp["dropout"][1], 4),
             params=np_tree(inp["dropout"][2]), repeats=2),
        dict(name="masks", kind="masks", mesh=(2, 2), seed=1, rate=0.4,
             node_shape=(32, 12), edge_shape=(32, 2)),
        dict(name="pod", kind="pod", hosts=2,
             graphs=batch_arrays(inp["step"][1], 4)),
        dict(name="fit", kind="fit", mesh=(2, 2), cfg=cfg, task="PPI",
             lr=FIT_LR, epochs=FIT_EPOCHS, n_train=6, backend="kernel",
             graphs=[R.numpy_graph(g) for g in inp["fit"][1]],
             params=np_tree(inp["fit"][2]))]
    three = [dict(name="gemm", kind="model", mesh=(1, 3), cfg=cfg,
                  graph=R.numpy_graph(inp["gemm"][1]),
                  params=np_tree(inp["gemm"][2]))]
    return four, three


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """(JAX inputs, world-4 results per rank, world-3 results per rank)."""
    inp = inputs()
    four, three = jobs_of(inp)
    got4 = R.spawn(four, 4, str(tmp_path_factory.mktemp("world4")))
    got3 = R.spawn(three, 3, str(tmp_path_factory.mktemp("world3")))
    return inp, got4, got3


def flat(tree):
    """A JAX parameter tree's leaves in the port's order
    (gat.parameters: layers then skips, keys sorted)."""
    return [np.asarray(d[k]) for group in ("layers", "skips")
            for d in tree[group] for k in sorted(d)]


def assert_equal_on_every_rank(per_rank):
    """Each rank's tensors (a list per rank) bit for bit equal to rank
    0's."""
    for r, tensors in enumerate(per_rank[1:], start=1):
        for i, (a, b) in enumerate(zip(per_rank[0], tensors)):
            assert torch.equal(a, b), f"rank {r} differs in tensor {i}"


def jax_model(cfg, g, params):
    """Unsharded JAX logits and the gradients of mean(logits ** 2)."""
    def loss(p):
        logits = jgat.gat_model_apply(p, cfg, g, training=False,
                                      backend="xla")
        return jnp.mean(logits ** 2), logits
    (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(logits), flat(grads)


def assert_model_matches(name, got, inp):
    cfg, g, params = inp[name]
    logits, grads = jax_model(cfg, g, params)
    for backend in ("kernel", "segment"):
        for rank in got:
            res = rank[name][backend]
            np.testing.assert_allclose(res["logits"].numpy(), logits, **TOL)
            for i, (a, b) in enumerate(zip(res["grads"], grads)):
                np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL,
                                           err_msg=f"{backend} grad {i}")
        assert_equal_on_every_rank([[r[name][backend]["logits"]]
                                    + r[name][backend]["grads"]
                                    for r in got])


def test_sharded_layer_matches_unsharded_jax(cases):
    """(a) tests/test_pallas_kernel.py's sharded-layer setting at K = 4:
    the port's cut-neighbourhood layer, on both paths, against the JAX
    package's unsharded layer (which its test holds its sharded pallas
    layer to), the output and the gradients of sum(sin(out))."""
    inp, got, _ = cases
    lc, g, params = inp["layer"]

    def loss(p):
        out = jgat.gat_layer_apply(p, lc, g.x, g.senders, g.receivers,
                                   g.edge_mask, g.num_nodes, backend="xla")
        return jnp.sum(jnp.sin(out)), out
    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    for backend, trace in (("kernel", "sharded_v4_partial"),
                           ("segment", "sharded_segment")):
        for rank in got:
            res = rank["layer"][backend]
            assert res["trace"] == [trace]
            np.testing.assert_allclose(res["out"].numpy(), np.asarray(out),
                                       **TOL)
            for k in ("W", "a"):
                np.testing.assert_allclose(res["grads"][k].numpy(),
                                           np.asarray(grads[k]), **GRAD_TOL,
                                           err_msg=f"{backend} d{k}")


def test_sharded_train_step_matches_jax(cases):
    """(b) One step on a (2, 2) mesh, dropout 0, SGD 0.1 (the JAX test's:
    Adam's first step is +-lr for any non-zero gradient): the loss and
    the updated parameters against the JAX unsharded step and the JAX
    package's make_sharded_train_step (backend xla) on its (2, 2) mesh;
    (c) the gradients and parameters equal bit for bit on every rank."""
    import optax
    inp, got, _ = cases
    cfg, batch, params = inp["step"]
    task = jmake_task("PPI")
    tx = optax.sgd(1e-1)
    rng = jax.random.key(2)
    mesh = jpar.make_mesh(data=2, edge=2, devices=jax.devices()[:4])
    step = jpar.make_sharded_train_step(cfg, task, tx, mesh)
    state = TrainState(params=params, opt_state=tx.init(params), rng=rng,
                       step=jnp.int32(0))
    state_s, mets_s = step(jpar.replicated(state, mesh),
                           jpar.put_batch(batch, mesh))

    def loss_fn(p):
        def per_graph(g):
            logits = jgat.gat_model_apply(p, cfg, g, training=False)
            return task.loss(logits, g, "train")
        return jnp.mean(jax.vmap(per_graph)(batch))
    loss_ref, grads_ref = jax.value_and_grad(loss_fn)(params)
    want_params = [a - 0.1 * g for a, g in zip(flat(params),
                                               flat(grads_ref))]
    np.testing.assert_allclose(float(mets_s["train_loss"]), float(loss_ref),
                               rtol=1e-5)
    for backend in ("kernel", "segment"):
        for rank in got:
            run = rank["step"][backend][0]
            np.testing.assert_allclose(float(run["loss"]), float(loss_ref),
                                       rtol=1e-5)
            np.testing.assert_allclose(float(run["loss"]),
                                       float(mets_s["train_loss"]),
                                       rtol=1e-5)
            np.testing.assert_allclose(float(run["metrics"]["f1"]),
                                       float(mets_s["train_f1"]), rtol=1e-5)
            for i, (a, b, c) in enumerate(zip(
                    run["params"], want_params, flat(state_s.params))):
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                           atol=1e-6, err_msg=f"param {i}")
                np.testing.assert_allclose(a.numpy(), c, rtol=1e-4,
                                           atol=1e-6, err_msg=f"param {i}")
            for i, (a, b) in enumerate(zip(run["grads"], flat(grads_ref))):
                np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL,
                                           err_msg=f"{backend} grad {i}")
        assert_equal_on_every_rank(
            [[r["step"][backend][0]["loss"]] + r["step"][backend][0]["grads"]
             + r["step"][backend][0]["params"] for r in got])


def test_cap_gradient_from_a_nonzero_shard(cases):
    """(c) The global cap's cotangent reaches the argmax logit through the
    owner shard (tests/test_parallel.py
    test_edge_sharded_cap_gradient_matches_unsharded): on this graph the
    first layer's argmax edge sits on shard 1 or later of 4, and the
    gradients of mean(logits ** 2) equal the unsharded JAX model's."""
    inp, got, _ = cases
    cfg, g, params = inp["cap"]
    lc = cfg.layer_configs()[0]
    x = np.asarray(g.x)
    w, a = (np.asarray(params["layers"][0][k]) for k in ("W", "a"))
    a_src, a_dst = (t.numpy() for t in tgat._split_attention_map(
        torch.tensor(a), lc.num_heads, lc.out_features))
    h = x @ w
    snd, rcv = np.asarray(g.senders), np.asarray(g.receivers)
    raw = (h @ a_src)[snd] + (h @ a_dst)[rcv]
    raw[~np.asarray(g.edge_mask)] = -np.inf
    edge = np.unravel_index(np.argmax(raw), raw.shape)[0]
    assert edge // (g.num_edges // 4) > 0
    assert_model_matches("cap", got, inp)


def test_non_divisible_gemm_takes_the_replicated_product(cases):
    """(d) 32 padded nodes over 3 edge shards: the product is replicated,
    and the model equals the unsharded JAX model."""
    inp, _, got = cases
    assert inp["gemm"][1].num_nodes % 3 != 0
    assert_model_matches("gemm", got, inp)


def test_dropout_masks_differ_across_edge_shards(cases):
    """(e) Each edge shard draws its own attention dropout masks, while
    the input dropout masks are those of its edge group (the node
    features are replicated over it); a step with dropout is finite,
    gives the same bits twice from the same generators, and gives the
    same loss on both paths, which draw the same masks."""
    _, got, _ = cases
    masks = [r["masks"] for r in got]
    for i in range(4):
        for j in range(i + 1, 4):
            assert not torch.equal(masks[i]["edge"], masks[j]["edge"])
    # ranks (0, 1) form data index 0's edge group, (2, 3) index 1's
    assert torch.equal(masks[0]["node"], masks[1]["node"])
    assert torch.equal(masks[2]["node"], masks[3]["node"])
    assert not torch.equal(masks[0]["node"], masks[2]["node"])
    for rank in got:
        kernel, segment = rank["dropout"]["kernel"], rank["dropout"]["segment"]
        for runs in (kernel, segment):
            assert np.isfinite(float(runs[0]["loss"]))
            assert torch.equal(runs[0]["loss"], runs[1]["loss"])
            for a, b in zip(runs[0]["params"], runs[1]["params"]):
                assert torch.equal(a, b)
        np.testing.assert_allclose(float(kernel[0]["loss"]),
                                   float(segment[0]["loss"]), rtol=1e-5)


def test_fit_sharded_matches_jax(cases):
    """(f) Trainer.fit_sharded for 6 epochs on a (2, 2) mesh, dropout 0,
    Adam 1e-2, 6 train and 2 validation graphs, from the JAX Trainer's
    own initial parameters: every epoch's train and validation loss and
    F1 against the JAX package's fit_sharded on its (2, 2) mesh, and the
    same history and final parameters on every rank."""
    inp, got, _ = cases
    cfg, graphs, _ = inp["fit"]
    mesh = jpar.make_mesh(data=2, edge=2, devices=jax.devices()[:4])
    tr = JTrainer(cfg=cfg, task=jmake_task("PPI"), learning_rate=FIT_LR,
                  max_epochs=FIT_EPOCHS, patience=100, seed=0)
    want = tr.fit_sharded(mesh, graphs[:6], graphs[6:]).history
    for rank in got:
        hist = rank["fit"]["history"]
        assert len(hist) == FIT_EPOCHS
        for k in ("train_loss", "val_loss", "train_f1", "val_f1"):
            np.testing.assert_allclose([r[k] for r in hist],
                                       [r[k] for r in want], rtol=1e-4,
                                       err_msg=k)
        assert hist[-1]["train_loss"] < hist[0]["train_loss"]
        assert hist == got[0]["fit"]["history"]
    assert_equal_on_every_rank([r["fit"]["params"] for r in got])


def test_paper_faithful_under_four_edge_shards(cases):
    """(g) paper_faithful (per-head a, the per-destination max completed
    by pmax, eps 0) at K = 4 on both paths against the unsharded JAX
    model."""
    inp, got, _ = cases
    assert_model_matches("pf", got, inp)


def test_pod_mesh_and_global_batch(cases):
    """parallel.multihost on 2 hosts of 2 processes: the edge axis spans
    a host's processes, the data axis the hosts; each process's shard of
    the global batch is shard_batch's; initialize is a no-op once
    joined."""
    _, got, _ = cases
    for rank, res in enumerate(got):
        pod = res["pod"]
        assert pod["shape"] == {"data": 2, "edge": 2}
        assert pod["index"] == divmod(rank, 2)
        assert pod["joined"] and pod["same"] and pod["shards"] == 2
