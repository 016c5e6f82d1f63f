"""A configuration's model form comes from files found by name
(portbench/forms): the port's GATConfig arguments, the weights' layout and
the counts. Shown on the CPU at a small size: the default form draws the
same weights and counts as the harness did before forms were files; the
paper's form reaches the port's paper_faithful path and agrees with its
reference; a form planted as a file alone reaches the port's GATConfig."""

import json

import numpy as np
import pytest
import torch

from portbench import check, counts, harness, inputs, spec
from portbench import traffic as T
from portbench.tests.helpers import BENCH, small_root

CPU = torch.device("cpu")
ARXIV_NODES, ARXIV_EDGES = 169343, 2501829


def config(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def old_weights(cfg, seed):
    """The weights as inputs.make_weights drew them before the form was a
    file: per layer W, then the cross-head a, then a skip projection, in
    one flat draw."""
    shapes = []
    for i, ld in enumerate(inputs.layer_dims(cfg)):
        shapes.append((("layers", i, "W"), (ld.fin, ld.d),
                       (6.0 / (ld.fin + ld.d)) ** 0.5))
        shapes.append((("layers", i, "a"), (ld.d * 2, ld.nh),
                       (6.0 / (ld.d * 2 + ld.nh)) ** 0.5))
        if ld.skip == "project":
            shapes.append((("skips", i, "w"), (ld.fin, ld.d),
                           1.0 / ld.fin ** 0.5))
    total = sum(int(np.prod(s)) for _, s, _ in shapes)
    gen = torch.Generator(device=CPU)
    gen.manual_seed(inputs.torch_seed(seed, inputs.WEIGHTS))
    flat = torch.rand(total, generator=gen) * 2.0 - 1.0
    out, at = [], 0
    for _, shape, bound in shapes:
        size = int(np.prod(shape))
        out.append(flat[at:at + size].reshape(shape) * bound)
        at += size
    return out


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17])
def test_default_form_draws_the_same_weights(seed):
    cfg = config("gat-transductive")
    assert "form" not in cfg
    got = inputs.leaves(inputs.make_weights(cfg, seed, CPU))
    want = old_weights(cfg, seed)
    assert [tuple(t.shape) for t in got] == [tuple(t.shape) for t in want]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_default_form_counts_as_before():
    """Counts.step_ops and attention_least at the arxiv cells' sizes, by
    the formulas the harness counted with before."""
    cfg = config("gat-transductive")
    n, e = ARXIV_NODES, ARXIV_EDGES
    c = counts.Counts(spec.form_of(cfg), cfg, [n] * 3, [e] * 3)
    ops, fwd_s, bwd_s = 0.0, 0.0, 0.0
    for i, ld in enumerate(inputs.layer_dims(cfg)):
        d, nh, f = ld.d, ld.nh, ld.f
        fwd = (2 * n * d * nh + e * nh * (5 + 2 * f) + n * d,
               4 * (n * d + d * nh + n * nh + e * nh + n * d)
               + 4 * (e + n + 1))
        bwd = (e * nh * (8 + 4 * f) + 4 * n * d * nh,
               4 * (2 * n * d + n * nh + d * nh + e * nh + n * d + n * nh
                    + d * nh) + 4 * (e + n + 1))
        product = 2 * n * ld.fin * d
        ops += (product * (2 if i == 0 else 3) + 2 * n * d * nh * 3
                + fwd[0] + bwd[0])
        fwd_s += counts.least_seconds(*fwd)[0]
        bwd_s += counts.least_seconds(*bwd)[0]
    assert c.step_ops() == 3 * ops
    assert c.attention_least("forward") == pytest.approx(3 * fwd_s,
                                                          rel=1e-15)
    assert c.attention_least("backward") == pytest.approx(3 * bwd_s,
                                                           rel=1e-15)


def small_cell(tmp_path, name, backend=None, form=None):
    """The cell `name` at a small size; its configuration's backend or
    form replaced where given (a configuration file of its own)."""
    root = small_root(tmp_path)
    cell = spec.load_cell(name, data_root=root)
    if backend is None and form is None:
        return cell
    cfg = dict(cell.config)
    if backend is not None:
        cfg["path"] = {"backend": backend}
    if form is not None:
        cfg["form"] = form
    (root / "configs" / "planted.json").write_text(json.dumps(cfg))
    workload = dict(cell.workload, config="planted")
    (root / "workloads" / "planted.json").write_text(json.dumps(workload))
    return spec.load_cell("planted", data_root=root)


def build(cell, seed):
    data = T.make(cell.traffic, cell.generator(), seed)
    return data, harness.build_program(cell, data, seed, CPU)


def test_paper_form_reaches_the_ports_paper_path(tmp_path):
    from gat_pytorch_tpu_torch.models import gat
    cell = small_cell(tmp_path, "arxiv-full-paper", backend="segment")
    _, prog = build(cell, 5)
    assert prog.trainer.cfg.paper_faithful
    assert prog.trainer.backend == "segment"
    port = gat.init_gat_model(prog.trainer.cfg, device="cpu")
    assert ([{k: tuple(v.shape) for k, v in layer.items()}
             for layer in prog.params["layers"]]
            == [{k: tuple(v.shape) for k, v in layer.items()}
                for layer in port["layers"]] == [
                {"W": (128, 64), "a": (8, 16)},
                {"W": (64, 320), "a": (8, 80)}])
    gat.PATH_TRACE.clear()
    loss = prog.step()[0]
    assert torch.isfinite(loss)
    assert gat.PATH_TRACE == ["segment", "segment"]


def test_paper_cell_takes_the_table_op(tmp_path):
    from gat_pytorch_tpu_torch.models import gat
    _, prog = build(small_cell(tmp_path, "arxiv-full-paper"), 6)
    gat.PATH_TRACE.clear()
    prog.step()
    assert gat.PATH_TRACE == ["v4_table", "v4_table"]


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 23])
def test_paper_reference_against_the_ports_segment_path(tmp_path, seed):
    cell = small_cell(tmp_path, "arxiv-full-paper", backend="segment")
    data, prog = build(cell, seed)
    readout = harness.first_steps(prog)
    ref = harness.reference_readout(cell, data, seed, CPU)
    ok, table = check.judge(check.compare(readout, ref), cell.limits)
    assert ok, table


def test_a_planted_form_reaches_the_ports_config(tmp_path):
    """A form file alone (here: the constant-attention form, which has no
    attention weights) reaches the port's GATConfig and the weights, and
    the reference draws the same weights through the same lookup."""
    cell = small_cell(tmp_path, "arxiv-full-v5", form="gat_const")
    (cell.data_root / "forms" / "gat_const.py").write_text(
        (BENCH / "forms" / "gat.py").read_text()
        + "\n\n_port_args = port_args\n_leaf_shapes = leaf_shapes\n\n\n"
        "def port_args(config):\n"
        "    return dict(_port_args(config), const_attention=True)\n\n\n"
        "def leaf_shapes(config):\n"
        "    return [s for s in _leaf_shapes(config) if s[0][2] != 'a']\n")
    _, prog = build(cell, 8)
    assert prog.trainer.cfg.const_attention
    assert not prog.trainer.cfg.paper_faithful
    assert [sorted(layer) for layer in prog.params["layers"]] == [["W"],
                                                                  ["W"]]
    reference_draw = inputs.leaves(inputs.make_weights(cell.config, 8, CPU))
    assert len(reference_draw) == 2
    for a, b in zip(inputs.leaves(prog.params), reference_draw):
        assert torch.equal(a.detach(), b)
    assert torch.isfinite(prog.step()[0])
