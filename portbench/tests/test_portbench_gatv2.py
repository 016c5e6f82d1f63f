"""GATv2's configuration as files (portbench/forms/gatv2.py,
counts/gatv2.py, reference/gatv2.py and the cell arxiv-powerlaw-gatv2),
on the CPU at a small size: the form's weights and leaf order, the op's
contract counted by hand, the reference against the port's segment path
and its kernel path's plain route, and the cell on the GATv2 op."""

import json
import time

import numpy as np
import pytest
import torch

from portbench import check, counts, harness, inputs, spec
from portbench.counts import gatv2 as C
from portbench.tests.helpers import BENCH, small_root
from portbench.tests.test_portbench_forms import build, small_cell
from portbench.tests.test_portbench_reference import (graph_of,
                                                      reference_side)

CPU = torch.device("cpu")


def config():
    return json.loads((BENCH / "configs" / "gatv2-transductive.json")
                      .read_text())


@pytest.mark.parametrize("seed", [4, 2 ** 31 + 19])
def test_form_draws_w_w_r_and_a_in_one_flat_draw(seed):
    cfg = config()
    params = inputs.make_weights(cfg, seed, CPU)
    assert [sorted(layer) for layer in params["layers"]] == [
        ["W", "W_r", "a"]] * 2
    got = inputs.leaves(params)
    assert [tuple(t.shape) for t in got] == [
        (128, 64), (128, 64), (8, 8), (64, 320), (64, 320), (8, 40)]
    # the one flat draw, in the form's order, scaled per leaf
    bounds = [(6 / 192) ** 0.5, (6 / 192) ** 0.5, (6 / 16) ** 0.5,
              (6 / 384) ** 0.5, (6 / 384) ** 0.5, (6 / 48) ** 0.5]
    total = sum(t.numel() for t in got)
    gen = torch.Generator(device=CPU)
    gen.manual_seed(inputs.torch_seed(seed, inputs.WEIGHTS))
    flat = torch.rand(total, generator=gen) * 2.0 - 1.0
    at = 0
    for t, bound in zip(got, bounds):
        want = flat[at:at + t.numel()].reshape(t.shape) * bound
        at += t.numel()
        assert torch.equal(t, want)
        assert float(t.abs().max()) <= bound


def test_contract_counted_by_hand():
    """n = 3 nodes, e = 4 edges, 2 heads of 3 (D = 6), dropping.
    Forward: operations 4 * 2 * (6*3 + 2 + 1) + 3*6 = 186; bytes, floats
    xl and xr 36, a 6, the multipliers 8, the output 18, max and den 12
    (80 x 4) and ints, the senders 4 and the offsets 4 (8 x 4): 352.
    Backward: operations 4 * 2 * (14*3 + 6) + 2 * 18 = 420; bytes, floats
    g, out, xl, xr 72, a 6, max and den 12, the multipliers 8, d(xl) and
    d(xr) 36, d(a) 6 (140 x 4) and ints, senders, receivers and the sender
    order 12, both offsets 8 (20 x 4): 640. Without dropout the
    multipliers go (and one operation an edge and head forward)."""
    assert C.forward(3, 4, 2, 3, True) == (186.0, 352.0)
    assert C.backward(3, 4, 2, 3, True) == (420.0, 640.0)
    assert C.forward(3, 4, 2, 3, False) == (178.0, 320.0)
    assert C.backward(3, 4, 2, 3, False) == (420.0, 608.0)


def test_form_counts_the_step():
    """Counts.step_ops of the form: per layer both products (forward, and
    backward twice but at layer 0) and the op's contract."""
    cfg = config()
    n, e = 1000, 9000
    c = counts.Counts(spec.form_of(cfg), cfg, [n], [e])
    ops = 0.0
    for i, ld in enumerate(inputs.layer_dims(cfg)):
        products = 2 * (2.0 * n * ld.fin * ld.d) * (2 if i == 0 else 3)
        ops += (products + C.forward(n, e, ld.nh, ld.f, True)[0]
                + C.backward(n, e, ld.nh, ld.f, True)[0])
    assert c.step_ops() == ops
    assert c.attention_least("forward") == c.least(C.forward)


def port_loss_and_grads(cfg, graph, seed, backend):
    from gat_pytorch_tpu_torch.models import gat
    from gat_pytorch_tpu_torch.train import tasks
    gcfg = gat.GATConfig(**spec.form_of(cfg).port_args(cfg))
    params = inputs.make_weights(cfg, seed, CPU)
    ps = inputs.leaves(params)
    for p in ps:
        p.requires_grad_(True)
    gen = torch.Generator(device=CPU)
    gen.manual_seed(inputs.torch_seed(seed, inputs.DROPOUT))
    gat.PATH_TRACE.clear()
    logits = gat.gat_model_apply(params, gcfg, graph, device="cpu",
                                 generator=gen, training=True,
                                 backend=backend)
    loss = tasks.planetoid_task().loss(logits, graph, "train")
    return logits, loss, torch.autograd.grad(loss, ps), list(gat.PATH_TRACE)


@pytest.mark.parametrize("backend", ["segment", "kernel"])
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 9])
def test_reference_against_the_port(backend, seed):
    """The plain reference against the port's segment path and its
    kernel path's plain route, same weights and dropout stream, on the
    arxiv_powerlaw mix at 700 nodes. Tolerances: all three sum the same
    float32 terms in other orders (index_add, the op's own sums), about
    1e-7 of a value; logits within 1e-5 relative and 1e-6 absolute, the
    loss within 1e-6 relative, each gradient within 1e-5 of its leaf's
    largest entry: an error in any term of the layer moves them by far
    more (the half-batch fault moves the loss by 1e-2)."""
    from gat_pytorch_tpu_torch.graph import transforms
    from portbench.reference import gat as R
    cfg = config()
    g = graph_of("arxiv_powerlaw", seed)
    graph = transforms.canonicalize(
        g.x, g.senders, g.receivers, y=g.y, train_mask=g.train_mask,
        val_mask=g.val_mask, test_mask=g.test_mask)
    b = R.Batch(g, CPU)
    lp, fp, gp, trace = port_loss_and_grads(cfg, graph, seed, backend)
    assert trace == (["gatv2"] * 2 if backend == "kernel"
                     else ["segment"] * 2)
    lr, fr, gr = reference_side(cfg, b, seed)
    assert torch.allclose(lp[:b.n], lr, rtol=1e-5, atol=1e-6)
    assert float(fp.detach()) == pytest.approx(float(fr.detach()), rel=1e-6)
    for a, ref in zip(gp, gr):
        scale = float(ref.abs().max())
        assert scale > 0.0
        assert float((a - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("backend", ["segment", "kernel"])
def test_three_adam_steps_against_the_reference(tmp_path, backend):
    """The first three steps (each loss, the first gradient, the change
    under Adam) of the port's segment path and of its kernel path's plain
    route against the reference's, within the cell's limits: set on the
    card at full size, they leave these float32 reorderings (about 1e-7)
    far inside."""
    cell = small_cell(tmp_path, "arxiv-powerlaw-gatv2", backend=backend)
    seed = 2 ** 31 + 57
    data, prog = build(cell, seed)
    readout = harness.first_steps(prog)
    ref = harness.reference_readout(cell, data, seed, CPU)
    ok, table = check.judge(check.compare(readout, ref), cell.limits)
    assert ok, table


def test_gatv2_cell_takes_the_gatv2_op(tmp_path):
    from gat_pytorch_tpu_torch.models import gat
    _, prog = build(small_cell(tmp_path, "arxiv-powerlaw-gatv2"), 6)
    assert prog.trainer.cfg.gatv2
    gat.PATH_TRACE.clear()
    prog.step()
    assert gat.PATH_TRACE == ["gatv2", "gatv2"]


def test_gatv2_cell_is_correct_and_traced_on_the_cpu(tmp_path):
    """The cell at a small size on the CPU (the op's plain versions)
    passes its own limits; a traced run reads the op's host spans and its
    launches count nothing on CPU tensors, and no device metric."""
    cell = spec.load_cell("arxiv-powerlaw-gatv2",
                          data_root=small_root(tmp_path))
    res = harness.run_cell(cell, 2 ** 31 + 41, 0.2, True, CPU,
                           time.perf_counter())
    assert res["correct"], res["checks"]
    metrics = res["metrics"]
    assert metrics["op_host_ms"]["value"] > 0.0
    assert metrics["port_kernel_calls_per_step"]["value"] == 0.0
    for name in ("gatv2_fwd_roofline", "gatv2_bwd_roofline", "mfu",
                 "gatv2_split_share"):
        assert name not in metrics
    assert np.isfinite(res["checks"]["loss_gap"]["value"])


def _split_reader():
    return spec.load_module(BENCH / "metrics" / "gatv2_split_share.py")


def _step_record(i, counters):
    from gat_pytorch_tpu_torch.utils import profiling as P
    rec = P.StepRecord(i, torch.device("cuda"))
    rec.counters.update(counters)
    return rec


def test_split_share_of_the_traced_steps(monkeypatch):
    """gatv2_split_share: the GATv2 backward's counters over the traced
    steps (the first record is not one), not the v5 backward's."""
    from gat_pytorch_tpu_torch.utils import profiling as P
    recs = [_step_record(0, dict(gatv2_bwd_slots=100,
                                 gatv2_bwd_split_slots=90))]
    recs += [_step_record(i, dict(gatv2_bwd_slots=200,
                                  gatv2_bwd_split_slots=10 * i,
                                  bwd_slots=50, bwd_split_slots=50))
             for i in range(1, 5)]
    monkeypatch.setattr(P, "records", lambda: recs)
    got = _split_reader().read({"steps": 4})
    assert got == pytest.approx(100.0 * (10 + 20 + 30 + 40) / 800)


@pytest.mark.parametrize("counters", [{}, dict(bwd_slots=100,
                                               bwd_split_slots=10)])
def test_split_share_reads_nothing_without_gatv2_slots(counters,
                                                       monkeypatch):
    from gat_pytorch_tpu_torch.utils import profiling as P
    monkeypatch.setattr(P, "records", lambda: [
        _step_record(i, counters) for i in range(3)])
    assert _split_reader().read({"steps": 2}) is None
    assert _split_reader().read({"steps": 0}) is None
