"""The port's dst-owned layout (models/gat.py dst_owned, parallel/partition.py,
parallel/sharding.dst_shard) against the JAX package's, with the ranks
under gloo on the CPU.

One gloo world of 4 ranks started once by spawn (tests/torch_ranks.py),
all the cases in that start; the JAX side runs in this process on
conftest's 8-device CPU mesh, while the ranks run. Inputs are the JAX dst-owned tests' graphs
(tests/test_parallel_dst_owned.py), canonicalised by the JAX package, and
parameters initialised by it; each rank partitions its graph itself. The
reference is the JAX package's dst-owned layer on its `xla` path under
shard_map (its own tests hold its pallas branches to it), its gradients
taken with its own convention (loss / K, psum of the gradients). The
port's kernel branches run their kernels' plain versions here.

Cases: the sharded_v5 branch (single sweep, and 2-phase under
GAT_TPU_V10=0) on a graph whose shard 3 of 4 has no edge, sharded_v7 on
the banded graph, sharded_v7_hybrid on the clustered one, sharded_v4_table
under paper_faithful and under return_attention (with the attention
norm), the dst_owned_segment path beside each; bfloat16 transport of the
gathers; a train step on a (2, 2) mesh with the attention penalty; the
collectives of a step against the cut-neighbourhood step's; and a
fit_sharded(dst_owned=True) against the JAX Trainer's.

Tolerances: logits rtol 1e-4, atol 1e-5; gradients rtol 1e-4, atol 1e-6;
a step's loss rtol 1e-5 and parameters rtol 1e-4, atol 1e-6; the fit's
history rtol 1e-4; bfloat16 transport within 1e-2 of float32. Every
replicated result must be equal bit for bit on every rank.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gat_pytorch_tpu import parallel as jpar
from gat_pytorch_tpu.models import gat as jgat
from gat_pytorch_tpu.parallel.partition import (partition_batches,
                                                partition_edges_by_dst)
from gat_pytorch_tpu.train.tasks import make_task as jmake_task
from gat_pytorch_tpu.train.trainer import Trainer as JTrainer
from gat_pytorch_tpu.train.trainer import TrainState

from . import torch_ranks as R
from .test_parallel_dst_owned import (_clustered_graph, _specs_for,
                                      make_banded_graph, make_graph,
                                      tiny_cfg)
from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_parallel import assert_equal_on_every_rank, flat, np_tree

K = 4
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PLAIN = dict(pad_multiple=32)
WINDOWED = dict(pad_multiple=32, src_windows=True, nb=128, eb=128)
HYBRID = dict(WINDOWED, hybrid=True)
F32 = {"GAT_TPU_V6_DTYPE": "float32"}
BOTH = ("kernel", "segment")
# name: (cfg, graph, partition, env, backends, return_attention, traces)
MODEL_CASES = {
    "v5": (tiny_cfg(), make_graph(seed=7), PLAIN, {}, BOTH, False,
           ("sharded_v5", "dst_owned_segment")),
    "v5_two_phase": (tiny_cfg(), make_graph(seed=7), PLAIN,
                     {"GAT_TPU_V10": "0"}, ("kernel",), False,
                     ("sharded_v5",)),
    "v7": (tiny_cfg(), make_banded_graph(seed=11), WINDOWED, F32, BOTH,
           False, ("sharded_v7", "dst_owned_segment")),
    "hybrid": (tiny_cfg(), _clustered_graph(seed=31), HYBRID, F32, BOTH,
               False, ("sharded_v7_hybrid", "dst_owned_segment")),
    "pf": (tiny_cfg(paper_faithful=True), make_graph(seed=2), PLAIN, {},
           BOTH, False, ("sharded_v4_table", "dst_owned_segment")),
    "attention": (tiny_cfg(), make_graph(seed=9, num_nodes=31,
                                         edge_bucket=256), PLAIN, {}, BOTH,
                  True, ("sharded_v4_table", "dst_owned_segment")),
    "bf16": (tiny_cfg(), make_graph(seed=7), PLAIN,
             {"GAT_TPU_AG_DTYPE": "bfloat16"}, BOTH, False,
             ("sharded_v5", "dst_owned_segment")),
}
WIDE = dict(num_input_node_features=32, num_layers=2,
            num_heads_per_layer=[4, 4], heads_concat_per_layer=[True, False],
            head_output_features_per_layer=[32, 32, 16], num_classes=16,
            add_skip_connection=[False, False])
FIT_EPOCHS, FIT_LR = 4, 1e-2


# cases on the v5 case's graph and parameters, so on its JAX reference
SAME_AS_V5 = ("v5_two_phase", "bf16")


def case_params(name):
    cfg = MODEL_CASES[name][0]
    key = list(MODEL_CASES).index("v5" if name in SAME_AS_V5 else name)
    return jgat.init_gat_model(jax.random.key(key), cfg)


def step_graphs():
    return [make_graph(seed=20), make_graph(seed=21)]


def fit_graphs():
    return [make_graph(seed=i) for i in range(6)]


def wide_graph():
    return make_graph(seed=5, num_nodes=504, node_bucket=512,
                      edge_bucket=4096, num_feats=32, num_classes=16)


def jobs():
    four = []
    for name, (cfg, g, part, env, backends, att, _) in MODEL_CASES.items():
        four.append(dict(
            name=name, kind="dst_model", mesh=(1, K),
            cfg=dataclasses.asdict(cfg), graph=R.numpy_graph(g),
            partition=part, env=env, backends=backends, attention=att,
            params=np_tree(case_params(name))))
    cfg = dataclasses.asdict(tiny_cfg())
    four.append(dict(
        name="step", kind="step", mesh=(2, 2), cfg=cfg, task="PPI",
        task_kw=dict(attention_penalty=0.05), lr=0.1, dst_owned=True,
        partition=PLAIN,
        graphs=[R.numpy_graph(g) for g in step_graphs()],
        params=np_tree(jgat.init_gat_model(jax.random.key(7), tiny_cfg()))))
    wide = dict(kind="step", mesh=(1, K), cfg=WIDE, task="PPI", lr=0.1,
                backends=("kernel",), graphs=[R.numpy_graph(wide_graph())],
                params=np_tree(jgat.init_gat_model(
                    jax.random.key(0), jgat.GATConfig(**WIDE))))
    four.append(dict(wide, name="wide_dst", dst_owned=True,
                     partition=dict(pad_multiple=128)))
    four.append(dict(wide, name="wide_cut"))
    _, init_rng = jax.random.split(jax.random.key(0))
    four.append(dict(
        name="fit", kind="fit", mesh=(2, 2), cfg=cfg, task="PPI",
        lr=FIT_LR, epochs=FIT_EPOCHS, n_train=4, backend="kernel",
        dst_owned=True, graphs=[R.numpy_graph(g) for g in fit_graphs()],
        params=np_tree(jgat.init_gat_model(init_rng, tiny_cfg()))))
    return four


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results by case, the JAX references by case): the
    JAX side computed while the ranks run."""
    tmp = str(tmp_path_factory.mktemp("world4"))
    ranks = R.start(jobs(), K, tmp)
    refs = {name: jax_dst_model(name) for name in MODEL_CASES
            if name not in SAME_AS_V5}
    refs["v5_two_phase"] = refs["v5"]
    refs["step"], refs["fit"] = jax_step(), jax_fit()
    return R.results(ranks, K, tmp), refs


@pytest.fixture(scope="module")
def got(runs):
    return runs[0]


@pytest.fixture(scope="module")
def refs(runs):
    return runs[1]


def jax_dst_model(name):
    """The JAX package's dst-owned xla model on the case's graph: logits,
    gradients of mean(logits ** 2) [+ the norm], alpha over the
    partitioned edges, the norm."""
    cfg, g, part, _, _, att, _ = MODEL_CASES[name]
    params = case_params(name)
    g2, _ = partition_edges_by_dst(g, K, **part)
    mesh = jpar.make_mesh(data=1, edge=K, devices=jax.devices()[:K])

    def loss_of(p, graph):
        out = jgat.gat_model_apply(p, cfg, graph, training=False,
                                   edge_axis="edge", dst_owned=True,
                                   backend="xla", return_attention=att)
        logits, alpha = out if att else (out, [])
        loss = jnp.mean(logits ** 2)
        norm = jnp.float32(0.0)
        if att:
            norm = jgat.calc_attention_norm(graph, alpha, edge_axis="edge",
                                            dst_owned=True)
            loss = loss + norm
        return loss / K, (logits, alpha, norm)

    def body(p, graph):
        (_, aux), grads = jax.value_and_grad(loss_of, has_aux=True)(p, graph)
        return aux, jax.lax.psum(grads, "edge")

    nl = cfg.num_layers if att else 0
    (logits, alpha, norm), grads = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(), _specs_for(g2)),
        out_specs=((P(), [P("edge")] * nl, P()), P()),
        check_vma=False))(params, g2)
    return (np.asarray(logits), flat(grads), [np.asarray(a) for a in alpha],
            float(norm), g2)


@pytest.mark.parametrize("name", [n for n in MODEL_CASES if n != "bf16"])
def test_dst_owned_model_matches_jax(got, refs, name):
    """Logits and gradients of every branch (kernel: the plain versions)
    and of the segment path against the JAX dst-owned layer, PATH_TRACE
    naming the branch each layer took, every rank equal."""
    _, _, _, _, backends, att, traces = MODEL_CASES[name]
    logits, grads, alpha, norm, g2 = refs[name]
    real = np.asarray(g2.edge_mask)
    for backend, trace in zip(backends, traces):
        for rank in got:
            res = rank[name][backend]
            assert res["trace"] == [trace] * 2
            np.testing.assert_allclose(res["logits"].numpy(), logits, **TOL)
            for i, (a, b) in enumerate(zip(res["grads"], grads)):
                np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL,
                                           err_msg=f"{backend} grad {i}")
        if att:
            for layer in range(2):
                a = torch.cat([r[name][backend]["alpha"][layer]
                               for r in got]).numpy()
                np.testing.assert_allclose(a[real], alpha[layer][real],
                                           **TOL)
            for rank in got:
                np.testing.assert_allclose(float(rank[name][backend]["norm"]),
                                           norm, rtol=1e-5)
        assert_equal_on_every_rank([[r[name][backend]["logits"]]
                                    + r[name][backend]["grads"]
                                    for r in got])


def test_empty_shard_and_remainder(got):
    """The v5 graph's shard 3 holds only padding rows (no real edge), and
    the hybrid graph's shards have remainders of unequal size."""
    g2, _ = partition_edges_by_dst(MODEL_CASES["v5"][1], K, **PLAIN)
    eps = g2.num_edges // K
    assert not np.asarray(g2.edge_mask)[3 * eps:].any()
    rems = [r["hybrid"]["kernel"]["rem_e"] for r in got]
    assert max(rems) > 0 and min(rems) < max(rems)


def test_bf16_transport_close_to_float32(got):
    """GAT_TPU_AG_DTYPE=bfloat16 carries each layer's gathered rows in
    bfloat16: within 1e-2 of float32, and not equal to it."""
    for rank in got:
        for backend in BOTH:
            bf16 = rank["bf16"][backend]["logits"].numpy()
            f32 = rank["v5"][backend]["logits"].numpy()
            np.testing.assert_allclose(bf16, f32, rtol=1e-2, atol=1e-2)
            assert not np.array_equal(bf16, f32)
            for a, b in zip(rank["bf16"][backend]["grads"],
                            rank["v5"][backend]["grads"]):
                assert torch.isfinite(a).all()
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-2,
                                           atol=1e-2)


def jax_step():
    """The JAX package's dst-owned step on its (2, 2) mesh (the step
    case): its parameters after the step and its metrics."""
    import optax
    cfg = tiny_cfg()
    task = jmake_task("PPI", attention_penalty=0.05)
    tx = optax.sgd(1e-1)
    params = jgat.init_gat_model(jax.random.key(7), cfg)
    mesh = jpar.make_mesh(data=2, edge=2, devices=jax.devices()[:4])
    parts, _ = partition_batches(step_graphs(), 2, **PLAIN)
    step = jpar.make_sharded_train_step(cfg, task, tx, mesh, dst_owned=True)
    state = TrainState(params=params, opt_state=tx.init(params),
                       rng=jax.random.key(2), step=jnp.int32(0))
    state_s, mets = step(jpar.replicated(state, mesh),
                         jpar.put_batch(jpar.stack_graphs(parts), mesh))
    return flat(state_s.params), {k: float(v) for k, v in mets.items()}


def jax_fit():
    """The JAX Trainer's fit_sharded(dst_owned=True) history (the fit
    case)."""
    mesh = jpar.make_mesh(data=2, edge=2, devices=jax.devices()[:4])
    graphs = fit_graphs()
    tr = JTrainer(cfg=tiny_cfg(), task=jmake_task("PPI"),
                  learning_rate=FIT_LR, max_epochs=FIT_EPOCHS, patience=100,
                  seed=0)
    return tr.fit_sharded(mesh, graphs[:4], graphs[4:],
                          dst_owned=True).history


def test_dst_owned_train_step_matches_jax(got, refs):
    """One dst-owned step on a (2, 2) mesh with the attention penalty,
    SGD 0.1: the loss and the parameters against the JAX package's
    dst-owned make_sharded_train_step on its (2, 2) mesh."""
    want_params, mets = refs["step"]
    for backend in BOTH:
        for rank in got:
            run = rank["step"][backend][0]
            np.testing.assert_allclose(float(run["loss"]),
                                       mets["train_loss"], rtol=1e-5)
            np.testing.assert_allclose(
                float(run["metrics"]["attention_norm"]),
                mets["train_attention_norm"], rtol=1e-5)
            for i, (a, b) in enumerate(zip(run["params"], want_params)):
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                           atol=1e-6, err_msg=f"param {i}")
        assert_equal_on_every_rank(
            [[r["step"][backend][0]["loss"]] + r["step"][backend][0]["grads"]
             + r["step"][backend][0]["params"] for r in got])


def test_dst_owned_reduces_collective_bytes(got):
    """The dst-owned step (the JAX test_dst_owned_reduces_collective_bytes
    workload) makes one (N, nh*f) all_gather a layer and no all_reduce
    over the N node rows, and moves fewer collective bytes than the
    cut-neighbourhood step on the same graph; both give the same loss."""
    from gat_pytorch_tpu_torch.ops.collectives import collective_bytes
    n = 512
    for rank in got:
        dst = rank["wide_dst"]["kernel"][0]
        cut = rank["wide_cut"]["kernel"][0]
        gathers = [shape for kind, shape, _ in dst["calls"]
                   if kind == "all_gather"]
        assert sorted(gathers) == [(n, 64), (n, 128)]
        assert not [c for c in dst["calls"] if c[0] == "all_reduce"
                    and c[1] and c[1][0] == n]
        assert collective_bytes(dst["calls"]) < 0.6 * collective_bytes(
            cut["calls"])
        np.testing.assert_allclose(float(dst["loss"]), float(cut["loss"]),
                                   rtol=1e-5)


def test_fit_sharded_dst_owned_matches_jax(got, refs):
    """Trainer.fit_sharded(dst_owned=True) for 4 epochs on a (2, 2) mesh,
    Adam 1e-2, 4 train and 2 validation graphs, from the JAX Trainer's
    initial parameters: the history against the JAX package's
    fit_sharded(dst_owned=True), equal on every rank."""
    want = refs["fit"]
    for rank in got:
        hist = rank["fit"]["history"]
        assert len(hist) == FIT_EPOCHS
        for k in ("train_loss", "val_loss", "train_f1", "val_f1"):
            np.testing.assert_allclose([r[k] for r in hist],
                                       [r[k] for r in want], rtol=1e-4,
                                       err_msg=k)
        assert hist == got[0]["fit"]["history"]
    assert_equal_on_every_rank([r["fit"]["params"] for r in got])
