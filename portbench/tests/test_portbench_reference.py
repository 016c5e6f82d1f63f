"""The plain references (each configuration's, in its model form) against
the port's `backend="segment"` path (its plain torch segment ops) at a
small size: the same weights and graph, the same dropout stream, the same
logits, loss and gradients."""

import json

import numpy as np
import pytest
import torch

from portbench import inputs, spec
from portbench import traffic as T
from portbench.reference import gat as R
from portbench.tests.helpers import BENCH, SMALL

CPU = torch.device("cpu")


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def graph_of(name, seed):
    mix = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    mix["params"].update(SMALL[name])
    return T.make(mix, spec.load_module(
        BENCH / "traffic" / f"{mix['generator']}.py"), seed)


def port_side(cfg, graph, seed):
    from gat_pytorch_tpu_torch.models import gat
    from gat_pytorch_tpu_torch.train import tasks
    gcfg = gat.GATConfig(**spec.form_of(cfg).port_args(cfg))
    params = inputs.make_weights(cfg, seed, CPU)
    ps = inputs.leaves(params)
    for p in ps:
        p.requires_grad_(True)
    gen = torch.Generator(device=CPU)
    gen.manual_seed(inputs.torch_seed(seed, inputs.DROPOUT))
    logits = gat.gat_model_apply(params, gcfg, graph, device="cpu",
                                 generator=gen, training=True,
                                 backend="segment")
    loss = tasks.planetoid_task().loss(logits, graph, "train")
    return logits, loss, torch.autograd.grad(loss, ps)


def reference_side(cfg, b, seed):
    ref = spec.load_module(BENCH / "reference" / f"{cfg['reference']}.py")
    params = inputs.make_weights(cfg, seed, CPU)
    ps = inputs.leaves(params)
    for p in ps:
        p.requires_grad_(True)
    (masks,) = list(R.masks(cfg, b, 1, inputs.torch_seed(
        seed, inputs.DROPOUT), CPU))
    logits = ref.forward(cfg, params, b, masks)
    loss = R.loss(cfg, logits, b)
    return logits, loss, torch.autograd.grad(loss, ps)


def assert_close(port, ref, n):
    (lp, fp, gp), (lr, fr, gr) = port, ref
    assert torch.allclose(lp[:n], lr, rtol=1e-5, atol=1e-6)
    assert float(fp.detach()) == pytest.approx(float(fr.detach()), rel=1e-6)
    for a, b in zip(gp, gr):
        scale = float(b.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 9])
@pytest.mark.parametrize("mix,name", [
    ("arxiv_like", "gat-transductive"),
    ("arxiv_powerlaw", "gat-transductive"),
    ("arxiv_like", "gat-paper-transductive")])
def test_transductive_with_dropout(mix, name, seed):
    from gat_pytorch_tpu_torch.graph import transforms
    cfg = config(name)
    g = graph_of(mix, seed)
    graph = transforms.canonicalize(
        g.x, g.senders, g.receivers, y=g.y, train_mask=g.train_mask,
        val_mask=g.val_mask, test_mask=g.test_mask)
    b = R.Batch(g, CPU)
    assert (b.n_pad, b.e_pad) == (graph.num_nodes, graph.senders.shape[0])
    assert np.array_equal(graph.senders[:b.e].numpy(), b.senders.numpy())
    assert_close(port_side(cfg, graph, seed), reference_side(cfg, b, seed),
                 b.n)

