"""The slice as a whole under the 2-phase knobs: the port's model against
the JAX model, and against the port's own single-sweep path.

GAT_TPU_V10=0 (or GAT_TPU_V5_MERGED=0 for the v5 op) puts both packages
on the 2-phase (cap, then attention) forms, read at call time:
  * a graph without a block layout takes the v5 op ("v5"), held against
    gat_model_apply(backend="pallas") in interpret mode with the v5 op
    forced on the small graph (GAT_TPU_V5=1), under either knob;
  * a banded graph that carries a block layout takes the windowed op in
    its 2-phase mode ("v7"), held against the JAX v7 branch
    (force_windowed=True, float32 contractions);
  * a community graph in cluster order with the hybrid layout, whose
    single-sweep parts cannot be split under 2-phase, takes the v6 form
    over the graph's own edges ("v6"), held against the JAX v6 branch
    (force_windowed=True).
Dropout off, parameters carried over with params_from_jax; logits and the
gradient of the planetoid training loss for every parameter agree to
rtol 1e-4 / atol 1e-5, the tolerance of tests/test_torch_model.py (float32
sums over edges and features in another order). The same model on the
same graph with the knobs unset (the single-sweep path) agrees to the
same tolerance: the two forms are one function in exact arithmetic.
"""

import jax
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.models import gat as jgat
from gat_pytorch_tpu.train.tasks import planetoid_task as jtask
from gat_pytorch_tpu_torch.models import gat as tgat

from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_model import (TOL, assert_same, build, build_hybrid,
                               build_windowed, torch_loss_and_grads)


def jax_run(jcfg, jg, jparams, **kw):
    task = jtask()

    def loss(p):
        logits = jgat.gat_model_apply(p, jcfg, jg, backend="pallas", **kw)
        return task.loss(logits, jg, "train"), logits

    jgat.PATH_TRACE.clear()
    (_, logits), grads = jax.value_and_grad(loss, has_aux=True)(jparams)
    return np.asarray(logits), grads, list(jgat.PATH_TRACE)


def port_run(tcfg, tg, tparams):
    """(logits, gradients, PATH_TRACE) of the port's kernel path."""
    for p in tgat.parameters(tparams):
        p.grad = None
    tgat.PATH_TRACE.clear()
    logits = torch_loss_and_grads(tcfg, tg, tparams, "kernel")
    return (logits, [p.grad.clone().numpy() for p in tgat.parameters(tparams)],
            list(tgat.PATH_TRACE))


def check(built, path, jax_kw, knob, monkeypatch, sweep_path=None):
    """The port under `knob`=0 against the JAX model under the same knob,
    then against the port's single-sweep path (`sweep_path`, default
    `path`) with the knob unset."""
    jcfg, tcfg, jg, tg, jparams, tparams = built
    monkeypatch.setenv(knob, "0")
    jlogits, jgrads, jtrace = jax_run(jcfg, jg, jparams, **jax_kw)
    assert jtrace == [path, path]
    logits, grads, trace = port_run(tcfg, tg, tparams)
    assert trace == [path, path]
    assert logits.shape == (tg.num_nodes, tcfg.num_classes)
    assert_same(jlogits, jgrads, logits, tparams)
    monkeypatch.delenv(knob)
    sweep_logits, sweep_grads, sweep_trace = port_run(tcfg, tg, tparams)
    assert sweep_trace == [sweep_path or path] * 2
    np.testing.assert_allclose(logits, sweep_logits, **TOL)
    for a, b in zip(grads, sweep_grads):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("knob", ["GAT_TPU_V10", "GAT_TPU_V5_MERGED"])
def test_v5_two_phase_matches_jax(knob, monkeypatch):
    monkeypatch.setenv("GAT_TPU_V5", "1")
    check(build("cora"), "v5", {}, knob, monkeypatch)


def test_v7_two_phase_matches_jax(monkeypatch):
    check(build_windowed("cora", n=900, e=5000, band=300), "v7",
          dict(force_windowed=True), "GAT_TPU_V10", monkeypatch)


def test_hybrid_graph_takes_v6_under_two_phase(monkeypatch):
    """The single-sweep path of this graph is "v7_hybrid"; under
    GAT_TPU_V10=0 both packages take the v6 form instead."""
    built = build_hybrid(seed=4)
    assert built[3].block_layout.rem_e > 0
    check(built, "v6", dict(force_windowed=True), "GAT_TPU_V10",
          monkeypatch, sweep_path="v7_hybrid")


def test_v6_is_the_v5_two_phase_op_on_the_graphs_edges(monkeypatch):
    """With attention dropout on, the v6 form draws one (E, nh) mask in
    graph edge order and runs the v5 2-phase kernels over the graph's
    CSR: the hybrid graph gives the bits of the same graph without its
    layout (the "v5" 2-phase path), and GAT_TPU_V5_MERGED=0 alone leaves
    the hybrid on its single sweep."""
    _, tcfg, _, tg, _, tparams = build_hybrid(seed=6, dropout=0.5)

    def run(graph):
        gen = torch.Generator().manual_seed(3)
        tgat.PATH_TRACE.clear()
        with torch.no_grad():
            out = tgat.gat_model_apply(tparams, tcfg, graph, device="cpu",
                                       generator=gen, training=True)
        return out, list(tgat.PATH_TRACE)

    monkeypatch.setenv("GAT_TPU_V10", "0")
    v6, trace6 = run(tg)
    v5, trace5 = run(tg.replace(block_layout=None))
    assert trace6 == ["v6", "v6"] and trace5 == ["v5", "v5"]
    assert torch.equal(v6, v5) and torch.isfinite(v6).all()
    monkeypatch.delenv("GAT_TPU_V10")
    monkeypatch.setenv("GAT_TPU_V5_MERGED", "0")
    assert run(tg)[1] == ["v7_hybrid", "v7_hybrid"]
