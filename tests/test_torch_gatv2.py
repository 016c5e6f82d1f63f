"""GATv2 (dynamic attention, arXiv:2105.14491) in the port: the op's plain
versions against float64 finite differences, the kernel path's CPU route
against the segment path, the step's bits, the refusals, the CLI flag;
and, marked `card` (skipped without a CUDA device), the CUDA kernels
against the plain versions. Imports nothing of JAX, so that the card
tests run on the card:

    python -m pytest tests/test_torch_gatv2.py -m card --noconftest -q
"""

import json
import os

import numpy as np
import pytest
import torch

from gat_pytorch_tpu_torch.cli import train as cli
from gat_pytorch_tpu_torch.graph import transforms as TT
from gat_pytorch_tpu_torch.models import gat
from gat_pytorch_tpu_torch.ops.cuda import build
from gat_pytorch_tpu_torch.ops.cuda import gatv2_attention as g2
from gat_pytorch_tpu_torch.train import optim
from gat_pytorch_tpu_torch.train.tasks import planetoid_task

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def no_knobs(monkeypatch):
    """The JAX package's knobs unset: each test sets what it needs."""
    for name in list(os.environ):
        if name.startswith("GAT_TPU_"):
            monkeypatch.delenv(name)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def edges_with_hub(n, e, hub_in, hub_out, seed):
    """Random edges over n nodes, with node 0 receiving hub_in of them and
    node 1 sending hub_out; self-loops added, sorted by destination, the
    real edges followed by 5 padding edges of the last node."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n - 1, e)
    r = rng.integers(0, n - 1, e)
    r[:hub_in] = 0
    s[hub_in:hub_in + hub_out] = 1
    loop = np.arange(n - 1)
    s, r = np.concatenate([s, loop]), np.concatenate([r, loop])
    order = np.argsort(r, kind="stable")
    e_real = s.shape[0]
    pad = np.full(5, n - 1)
    s = np.concatenate([s[order], pad]).astype(np.int32)
    r = np.concatenate([r[order], pad]).astype(np.int32)
    return torch.from_numpy(s), torch.from_numpy(r), e_real


def op_inputs(n, nh, f, e, dtype, seed, drop=True, hub=(0, 0)):
    gen = torch.Generator().manual_seed(seed)
    s, r, e_real = edges_with_hub(n, e, *hub, seed)
    xl = torch.randn((n, nh * f), generator=gen, dtype=dtype)
    xr = torch.randn((n, nh * f), generator=gen, dtype=dtype)
    a = torch.randn((nh, f), generator=gen, dtype=dtype)
    m = ((torch.rand((s.shape[0], nh), generator=gen) >= 0.4).to(dtype)
         / 0.6 if drop else None)
    return xl, xr, a, m, s, r, e_real


@pytest.mark.parametrize("drop", [False, True])
def test_op_gradcheck_float64(drop):
    xl, xr, a, m, s, r, e_real = op_inputs(7, 2, 3, 14, torch.float64, 1,
                                           drop)
    for t in (xl, xr, a):
        t.requires_grad_(True)

    def fn(xl, xr, a):
        return g2.gatv2_attention(xl, xr, a, m, s, r, 7, 0.2, e_real)

    assert torch.autograd.gradcheck(fn, (xl, xr, a), eps=1e-6, atol=1e-7,
                                    rtol=1e-5)


def test_op_reads_no_padding_edge_and_zeroes_empty_rows():
    xl, xr, a, m, s, r, e_real = op_inputs(7, 2, 3, 14, torch.float64, 2)
    out, mx, den = g2.gatv2_forward_plain(xl, xr, a, m, s, r, 7, e_real, 0.2)
    # the last node receives only padding edges
    assert torch.equal(out[6], torch.zeros(6, dtype=torch.float64))
    assert torch.equal(den[6], torch.zeros(2, dtype=torch.float64))
    assert torch.equal(mx[6], torch.zeros(2, dtype=torch.float64))
    # dropping the multipliers gives a softmax that sums to 1
    _, _, den1 = g2.gatv2_forward_plain(xl, xr, a, None, s, r, 7, e_real,
                                        0.2)
    assert torch.all(den1[:6] >= 1.0)


@pytest.mark.parametrize("f,want", [(8, (4, 1, 2)), (40, (4, 1, 16)),
                                    (7, (1, 1, 8)), (121, (1, 4, 32)),
                                    (256, (4, 2, 32))])
def test_plan_covers_a_head(f, want):
    vec, per_lane, lanes = g2.plan(f)
    assert (vec, per_lane, lanes) == want
    assert vec * per_lane * lanes >= f and f % vec == 0


def test_plan_refuses_heads_over_256_features():
    with pytest.raises(ValueError, match="256"):
        g2.plan(257)


def test_destination_order_by_degree_kept_with_its_owner():
    """Destinations by descending count of real edges (padding edges
    last, not counted), ties in id order; made once while the owner
    lives."""
    ptr = torch.tensor([0, 2, 2, 5, 6, 8, 9], dtype=torch.int32)
    order = g2.destination_order(ptr, 8)       # the last edge is padding
    assert order.tolist() == [2, 0, 4, 3, 1, 5]
    assert order.dtype == torch.int32
    assert g2.destination_order(ptr, 8, ptr, (8,)) is g2.destination_order(
        ptr, 8, ptr, (8,))
    assert g2.destination_order(ptr, 9, ptr, (9,)).tolist() == [
        2, 0, 4, 3, 5, 1]


CONFIGS = {
    "two-layer": dict(num_heads_per_layer=[8, 1],
                      heads_concat_per_layer=[True, False],
                      head_output_features_per_layer=[32, 8, 7],
                      num_classes=7, add_skip_connection=[False, False]),
    "skips": dict(num_heads_per_layer=[4, 4],
                  heads_concat_per_layer=[True, False],
                  head_output_features_per_layer=[32, 8, 3], num_classes=3,
                  add_skip_connection=[True, True]),
}


def small_graph(num_classes, n=200, e=1200, f_in=32, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n, e)
    r = rng.integers(0, n, e)
    r[:60] = 3          # a hub destination
    x = (rng.random((n, f_in)) < 0.2).astype(np.float32)
    y = rng.integers(0, num_classes, n)
    split = rng.permutation(n)
    masks = [np.zeros(n, bool) for _ in range(3)]
    for mk, idx in zip(masks, (split[:60], split[60:130], split[130:])):
        mk[idx] = True
    return TT.canonicalize(x, s, r, y=y, train_mask=masks[0],
                           val_mask=masks[1], test_mask=masks[2])


def config(name, **extra):
    kw = dict(CONFIGS[name], num_input_node_features=32, num_layers=2,
              dropout=0.6, gatv2=True)
    return gat.GATConfig(**dict(kw, **extra))


def loss_and_grads(cfg, graph, backend, seed=3):
    params = gat.init_gat_model(cfg, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(11)
    gat.PATH_TRACE.clear()
    logits = gat.gat_model_apply(params, cfg, graph, device="cpu",
                                 generator=gen, training=True,
                                 backend=backend)
    loss = planetoid_task().loss(logits, graph, "train")
    loss.backward()
    return (float(loss.detach()), list(gat.PATH_TRACE),
            {f"{i}.{k}": v.grad for i, layer in enumerate(params["layers"])
             for k, v in layer.items()})


def test_layer_leaves_and_init_bounds():
    cfg = config("two-layer")
    params = gat.init_gat_model(cfg, seed=0, device="cpu")
    layer = params["layers"][0]
    assert sorted(layer) == ["W", "W_r", "a"]
    assert tuple(layer["W_r"].shape) == tuple(layer["W"].shape) == (32, 64)
    assert tuple(layer["a"].shape) == (8, 8)
    assert float(layer["a"].abs().max()) <= (6.0 / 16) ** 0.5
    assert [tuple(t.shape) for t in gat.parameters(params)] == [
        (32, 64), (32, 64), (8, 8), (64, 7), (64, 7), (1, 7)]
    assert cfg.layer_configs()[0].slope == 0.2


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_route_matches_segment_path(name):
    """The kernel path's CPU route (the op's plain versions) against the
    segment path (plain torch segment ops), same weights and dropout
    stream. Tolerance: the two sum the same float32 terms in other
    orders, about 1e-7 of a value; 2e-5 of each leaf's largest gradient
    leaves room and no room for a wrong term (the smallest leaf's
    largest entry is about 1e-2)."""
    cfg = config(name)
    graph = small_graph(cfg.num_classes)
    lk, trace_k, gk = loss_and_grads(cfg, graph, "kernel")
    ls, trace_s, gs = loss_and_grads(cfg, graph, "segment")
    assert trace_k == ["gatv2", "gatv2"]
    assert trace_s == ["segment", "segment"]
    assert lk == pytest.approx(ls, rel=1e-6)
    assert sorted(gk) == sorted(gs)
    for key in gk:
        scale = float(gs[key].abs().max())
        assert scale > 0.0, key
        assert float((gk[key] - gs[key]).abs().max()) <= 2e-5 * scale, key


def test_return_attention_is_the_segment_paths_softmax():
    cfg = config("two-layer", dropout=0.0)
    graph = small_graph(cfg.num_classes)
    params = gat.init_gat_model(cfg, seed=4, device="cpu")
    out = {}
    for backend in ("kernel", "segment"):
        logits, alpha = gat.gat_model_apply(params, cfg, graph, device="cpu",
                                            backend=backend,
                                            return_attention=True)
        out[backend] = (logits.detach(), [a.detach() for a in alpha])
    assert torch.allclose(out["kernel"][0], out["segment"][0], atol=1e-6)
    for ak, aseg in zip(out["kernel"][1], out["segment"][1]):
        assert torch.equal(ak, aseg)
        real = graph.edge_mask
        sums = torch.zeros((graph.num_nodes, ak.shape[1])).index_add(
            0, graph.receivers[real].long(), ak[real])
        assert torch.allclose(sums[graph.node_mask], torch.ones(1),
                              atol=1e-5)


def train_steps(cfg, graph, steps=3):
    params = gat.init_gat_model(cfg, seed=5, device="cpu")
    opt = optim.adam_l2(gat.parameters(params), 0.01, 1e-3)
    from gat_pytorch_tpu_torch.train.trainer import Trainer
    trainer = Trainer(cfg=cfg, task=planetoid_task(), learning_rate=0.01,
                      weight_decay=1e-3, device="cpu", backend="kernel")
    gen = torch.Generator().manual_seed(7)
    losses = [trainer.train_step(params, opt, graph, gen)[0]
              for _ in range(steps)]
    return losses, [p.detach().clone() for p in gat.parameters(params)]


def test_train_step_is_bitwise_reproducible():
    cfg = config("two-layer")
    graph = small_graph(cfg.num_classes)
    gat.PATH_TRACE.clear()
    l1, p1 = train_steps(cfg, graph)
    assert gat.PATH_TRACE[:2] == ["gatv2", "gatv2"]
    l2, p2 = train_steps(cfg, graph)
    assert all(torch.equal(a, b) for a, b in zip(l1, l2))
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


@pytest.mark.parametrize("other", ["paper_faithful", "const_attention"])
def test_validate_refuses_gatv2_with_another_form(other):
    with pytest.raises(ValueError, match="gatv2"):
        config("two-layer", **{other: True}).validate()


UNSUPPORTED = {
    "naive": (dict(backend="naive"), {}),
    "edge_axis": (dict(edge_axis=object()), {}),
    "dst_owned": (dict(dst_owned=True), {}),
    "block_layout": (dict(block_layout=object()), {}),
    "two_phase": ({}, {"GAT_TPU_V10": "0"}),
    "v5_two_phase": ({}, {"GAT_TPU_V5_MERGED": "0"}),
    "bf16_kernel": ({}, {"GAT_TPU_KERNEL_DTYPE": "bfloat16"}),
    "bf16_table": ({}, {"GAT_TPU_H_DTYPE": "bfloat16"}),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_paths_raise(case, monkeypatch):
    kw, env = UNSUPPORTED[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = config("two-layer")
    lc = cfg.layer_configs()[0]
    graph = small_graph(cfg.num_classes)
    params = gat.init_gat_model(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="gatv2"):
        gat.gat_layer_apply(params["layers"][0], lc, graph.x,
                            graph.senders, graph.receivers, graph.edge_mask,
                            graph.num_nodes, **kw)


def test_cli_takes_gatv2(tmp_path, monkeypatch):
    """--gatv2 through cli/train.py on the Cora stand-in: every layer of
    every forward ran the GATv2 op."""
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "rows.jsonl"
    gat.PATH_TRACE.clear()
    assert cli.main(["--dataset", "Cora", "--gatv2", "--device", "cpu",
                     "--num_epochs", "2", "--metrics_file", str(out)]) == 0
    assert gat.PATH_TRACE and set(gat.PATH_TRACE) == {"gatv2"}
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == 2
    assert all(np.isfinite(r["train_loss"]) for r in rows)


# -- on the card --------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("nh,f", [(8, 8), (8, 40), (1, 7), (4, 121)])
def test_kernels_match_plain_on_card(card, nh, f):
    """The CUDA kernels against the plain versions on the same CUDA
    tensors, on a graph of odd degrees with a hub destination (1,500 in
    edges) and a hub sender (1,500 out edges, cut into items): float32
    sums in other orders, within 1e-5 of each output's largest value (the
    hub's softmax and sums run over 1,500 terms); and two launches give
    the same bits."""
    xl, xr, a, m, s, r, e_real = op_inputs(3001, nh, f, 20000,
                                           torch.float32, 9,
                                           hub=(1500, 1500))
    xl, xr, a, m, s, r = (t.to(card) for t in (xl, xr, a, m, s, r))
    n = xl.shape[0]
    before = dict(build.LAUNCHES)
    out, mx, den = g2.gatv2_forward(xl, xr, a, m, s, r, n, e_real, 0.2)
    ref = g2.gatv2_forward_plain(xl, xr, a, m, s, r, n, e_real, 0.2)
    for got, want in zip((out, mx, den), ref):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-5 * scale
    g = torch.randn(out.shape, device=card)
    grads = g2.gatv2_backward(xl, xr, a, m, s, r, e_real, 0.2, g, out, mx,
                              den)
    want = g2.gatv2_backward_plain(xl, xr, a, m, s, r, e_real, 0.2, g, out,
                                   mx, den)
    for got, w in zip(grads, want):
        scale = float(w.abs().max())
        assert float((got - w).abs().max()) <= 1e-5 * scale
    again = g2.gatv2_backward(xl, xr, a, m, s, r, e_real, 0.2, g, out, mx,
                              den)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    assert build.LAUNCHES["gatv2_forward"] == before["gatv2_forward"] + 1
    assert build.LAUNCHES["gatv2_backward"] == before["gatv2_backward"] + 2


@pytest.mark.card
def test_kernel_path_trains_on_card(card):
    """GATConfig(gatv2=True) through Trainer.train_step on a CUDA graph:
    the GATv2 op on both layers, two fits to equal bits, and the three
    steps' losses within float32 rounding of the segment path's."""
    from gat_pytorch_tpu_torch.train.trainer import Trainer
    cfg = config("two-layer")
    graph = small_graph(cfg.num_classes).to(card)
    runs = []
    for backend in ("kernel", "kernel", "segment"):
        params = gat.init_gat_model(cfg, seed=5, device=card)
        opt = optim.adam_l2(gat.parameters(params), 0.01, 1e-3)
        trainer = Trainer(cfg=cfg, task=planetoid_task(), learning_rate=0.01,
                          weight_decay=1e-3, device=str(card),
                          backend=backend)
        gen = torch.Generator(device=card).manual_seed(7)
        gat.PATH_TRACE.clear()
        losses = [float(trainer.train_step(params, opt, graph, gen)[0])
                  for _ in range(3)]
        runs.append((losses, list(gat.PATH_TRACE),
                     [p.detach().cpu() for p in gat.parameters(params)]))
    (l1, t1, p1), (l2, _, p2), (l3, t3, _) = runs
    assert t1 == ["gatv2"] * 6 and t3 == ["segment"] * 6
    assert l1 == l2 and all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert l1 == pytest.approx(l3, rel=1e-5)
