"""return_attention, the attention regulariser and the naive layer: the
port against the JAX package on the CPU.

The same graph (canonicalised by each package from the same numpy
arrays) and the same parameters (carried over with params_from_jax) go
through both, dropout off. On every layer path of the port (the segment
ops; the v5 op in its single sweep and its 2-phase form; the windowed op
on a banded graph with its block layout; the hybrid layout in the single
sweep and, under GAT_TPU_V10=0, the v6 form; the table op under
paper_faithful and const_attention; the naive layer) each layer's alpha
and calc_attention_norm must agree with JAX
gat_model_apply(return_attention=True, backend="xla") to rtol 1e-4 /
atol 1e-5, and the regularised loss sum(out[mask] ** 2) * 1e-3 +
1.0 * norm with its gradient for every parameter to rtol 2e-4 / atol
1e-6 (tests/test_gat_layer.py's test of the JAX kernels against "xla").
The JAX package's tests hold its pallas kernels to "xla" for alpha, so
one case (v5) runs the JAX pallas path, in interpret mode. The naive
layer is also held against the JAX naive layer and the port's segment
path, and the sorted softmax against the plain one.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.models import gat as jgat
from gat_pytorch_tpu.models.naive import gat_layer_naive as jnaive
from gat_pytorch_tpu_torch.models import gat as tgat
from gat_pytorch_tpu_torch.ops import segment as seg

from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_model import build, build_hybrid, build_windowed

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=1e-6)

# name -> (graph builder and its arguments, config extras, knobs, the
# port's backend, the port's PATH_TRACE entry)
PATHS = {
    "segment": (build, ("cora",), {}, {}, "segment", "segment"),
    "v5": (build, ("skips",), {}, {}, "kernel", "v5"),
    "v5 2-phase": (build, ("cora",), {}, {"GAT_TPU_V10": "0"}, "kernel",
                   "v5"),
    "v7": (build_windowed, ("skips", 600, 3000), {},
           {"GAT_TPU_V6_DTYPE": "float32"}, "kernel", "v7"),
    "hybrid": (build_hybrid, (5,), {}, {"GAT_TPU_V6_DTYPE": "float32"},
               "kernel", "v7_hybrid"),
    "v6": (build_hybrid, (5,), {}, {"GAT_TPU_V10": "0",
                                     "GAT_TPU_V6_DTYPE": "float32"},
           "kernel", "v6"),
    "paper_faithful": (build, ("skips",), {"paper_faithful": True}, {},
                       "kernel", "v4_table"),
    "const_attention": (build, ("cora",), {"const_attention": True}, {},
                        "kernel", "v4_table"),
    "naive": (build, ("skips",), {}, {}, "naive", "naive"),
}


@functools.lru_cache(maxsize=None)
def _built(builder, args, extra):
    return builder(*args, **dict(extra))


def make(name):
    """(jcfg, tcfg, jax graph, port graph, jax params, port params) of a
    case, built once a test session (the hybrid cases share a graph)."""
    builder, args, extra, _, _, _ = PATHS[name]
    return _built(builder, args, tuple(sorted(extra.items())))


def jax_regularised(jcfg, jg, jparams, backend="xla"):
    """JAX: (alpha per layer, norm, loss, gradients) of the regularised
    loss."""
    nmask = np.asarray(jg.node_mask)

    def loss(p):
        out, att = jgat.gat_model_apply(p, jcfg, jg, backend=backend,
                                        return_attention=True)
        norm = jgat.calc_attention_norm(jg, att)
        return jnp.sum(out[nmask] ** 2) * 1e-3 + 1.0 * norm, (att, norm)

    (value, (att, norm)), grads = jax.value_and_grad(loss, has_aux=True)(
        jparams)
    return ([np.asarray(a) for a in att], float(norm), float(value),
            [np.asarray(d[k]) for group in ("layers", "skips")
             for d in grads[group] for k in sorted(d)])


def torch_regularised(tcfg, tg, tparams, backend):
    """The port: the same four, the gradients in gat.parameters order."""
    for p in tgat.parameters(tparams):
        p.grad = None
    out, att = tgat.gat_model_apply(tparams, tcfg, tg, device="cpu",
                                    backend=backend, return_attention=True)
    norm = tgat.calc_attention_norm(tg, att)
    loss = (out[tg.node_mask] ** 2).sum() * 1e-3 + 1.0 * norm
    loss.backward()
    return ([a.detach().numpy() for a in att], float(norm.detach()),
            float(loss.detach()),
            [p.grad.numpy() for p in tgat.parameters(tparams)])


def assert_regularised_close(got, want):
    (t_att, t_norm, t_loss, t_grads), (j_att, j_norm, j_loss, j_grads) = \
        got, want
    assert len(t_att) == len(j_att)
    for i, (a, b) in enumerate(zip(t_att, j_att)):
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"alpha {i}")
    np.testing.assert_allclose(t_norm, j_norm, **TOL)
    np.testing.assert_allclose(t_loss, j_loss, rtol=2e-4)
    assert len(t_grads) == len(j_grads)
    for i, (a, b) in enumerate(zip(t_grads, j_grads)):
        np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=f"grad {i}")


@pytest.mark.parametrize("name", list(PATHS))
def test_regularised_model_matches_jax_xla(name, monkeypatch):
    _, _, _, env, backend, trace = PATHS[name]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jcfg, tcfg, jg, tg, jparams, tparams = make(name)
    want = jax_regularised(jcfg, jg, jparams)
    tgat.PATH_TRACE.clear()
    got = torch_regularised(tcfg, tg, tparams, backend)
    assert tgat.PATH_TRACE == [trace] * tcfg.num_layers
    for alpha, heads in zip(got[0], tcfg.num_heads_per_layer):
        # over the graph's dst-sorted edges, never a layout's slots
        assert alpha.shape == (tg.num_edges, heads)
        assert not alpha[~tg.edge_mask.numpy()].any()
    assert got[1] > 0.0 or name == "const_attention"
    assert_regularised_close(got, want)


def test_v5_regularised_model_matches_jax_pallas(monkeypatch):
    """The one case of the JAX kernels, in interpret mode: its v5 op with
    its alpha replica, forced on the small graph (tests/test_gat_layer.py
    test_v5_return_attention_parity)."""
    monkeypatch.setenv("GAT_TPU_V5", "1")
    monkeypatch.setenv("GAT_TPU_V6", "0")
    jcfg, tcfg, jg, tg, jparams, tparams = build("cora")
    jgat.PATH_TRACE.clear()
    want = jax_regularised(jcfg, jg, jparams, backend="pallas")
    assert "v5" in jgat.PATH_TRACE
    assert_regularised_close(torch_regularised(tcfg, tg, tparams, "kernel"),
                             want)


def _backward_nodes(t):
    """The names of the autograd nodes behind t."""
    seen, stack, names = set(), [t.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        stack.extend(n for n, _ in node.next_functions)
    return names


@pytest.mark.parametrize("name", ["v5", "v7", "hybrid", "paper_faithful"])
def test_kernel_path_alpha_has_no_scatter_in_its_backward(name,
                                                          monkeypatch):
    """On the kernel path the regularised loss's backward sums nothing
    by a gather's scatter-add (atomics on the card): alpha's sums are the
    sorted segment sum's, in both directions."""
    for k, v in PATHS[name][3].items():
        monkeypatch.setenv(k, v)
    _, tcfg, _, tg, _, tparams = make(name)
    out, att = tgat.gat_model_apply(tparams, tcfg, tg, device="cpu",
                                    return_attention=True)
    loss = out.sum() + tgat.calc_attention_norm(tg, att)
    names = _backward_nodes(loss)
    assert "_SegmentSumSorted" in " ".join(names)
    assert not {n for n in names if n.startswith(
        ("IndexSelectBackward", "IndexAddBackward", "ScatterAddBackward",
         "ScatterReduceBackward", "IndexBackward"))}, names


def test_return_attention_draws_no_random_numbers():
    """With dropout on, the model with return_attention gives the logits
    of the model without it, and leaves its generator in the same state:
    alpha takes no draw, so every dropout stream keeps its order."""
    for name in ("v5", "hybrid", "paper_faithful", "segment"):
        _, tcfg, _, tg, _, tparams = make(name)
        cfg = dataclasses.replace(tcfg, dropout=0.3)
        backend = PATHS[name][4]
        runs = []
        for ra in (False, True):
            gen = torch.Generator().manual_seed(5)
            with torch.no_grad():
                out = tgat.gat_model_apply(tparams, cfg, tg, device="cpu",
                                           generator=gen, training=True,
                                           backend=backend,
                                           return_attention=ra)
            runs.append((out[0] if ra else out, gen.get_state()))
        assert torch.equal(runs[0][0], runs[1][0]), name
        assert torch.equal(runs[0][1], runs[1][1]), name


@pytest.mark.parametrize("extra", [{}, {"paper_faithful": True},
                                   {"const_attention": True}])
def test_naive_layer_matches_jax_naive_and_the_segment_path(extra):
    """One layer (8 heads x 8, concatenated): the port's naive layer
    against the JAX package's gat_layer_naive (output, alpha and the
    gradients of sum(sin(out)) + sum(alpha ** 2)) and against the port's
    own segment path."""
    jcfg, tcfg, jg, tg, jparams, tparams = build("cora", **extra)
    lc = tcfg.layer_configs()[0]
    jlc = jcfg.layer_configs()[0]
    jp = jparams["layers"][0]

    def jloss(p):
        out, alpha = jnaive(p, jlc, jg.x, jg.senders, jg.receivers,
                            jg.edge_mask, jg.num_nodes,
                            return_attention=True)
        return jnp.sum(jnp.sin(out)) + jnp.sum(alpha ** 2), (out, alpha)

    (_, (jout, jalpha)), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp)
    results = []
    for backend in ("naive", "segment"):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in tparams["layers"][0].items()}
        tgat.PATH_TRACE.clear()
        out, alpha = tgat.gat_layer_apply(
            p, lc, tg.x, tg.senders, tg.receivers, tg.edge_mask,
            tg.num_nodes, backend=backend, return_attention=True)
        assert tgat.PATH_TRACE == [backend]
        (torch.sin(out).sum() + (alpha ** 2).sum()).backward()
        results.append((out.detach(), alpha.detach(),
                        {k: v.grad for k, v in p.items()}))
    naive = results[0]
    np.testing.assert_allclose(naive[0].numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(naive[1].numpy(), np.asarray(jalpha), **TOL)
    for k, g in naive[2].items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[k]),
                                   **GRAD_TOL, err_msg=k)
    for a, b in zip(naive[:2], results[1][:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    for k, g in naive[2].items():
        np.testing.assert_allclose(g.numpy(), results[1][2][k].numpy(),
                                   **GRAD_TOL, err_msg=k)


def test_naive_layer_draws_its_own_dropout_and_refuses_an_edge_axis():
    from gat_pytorch_tpu_torch.ops.collectives import Axis
    _, tcfg, _, tg, _, tparams = build("cora")
    lc = dataclasses.replace(tcfg.layer_configs()[0], dropout=0.5)
    p = tparams["layers"][0]
    args = (p, lc, tg.x, tg.senders, tg.receivers, tg.edge_mask,
            tg.num_nodes)
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(3)
        with torch.no_grad():
            outs.append(tgat.gat_layer_apply(*args, backend="naive",
                                             generator=gen, training=True))
    assert torch.equal(outs[0], outs[1]) and torch.isfinite(outs[0]).all()
    with torch.no_grad():
        assert not torch.allclose(outs[0], tgat.gat_layer_apply(
            *args, backend="naive"))
    with pytest.raises(ValueError, match="generator"):
        tgat.gat_layer_apply(*args, backend="naive", training=True)
    with pytest.raises(ValueError, match="edge sharding"):
        tgat.gat_layer_apply(*args, backend="naive",
                             edge_axis=Axis("edge", 1, 0, None))


@pytest.mark.parametrize("offsets", [True, False])
@pytest.mark.parametrize("eps,submax", [(1e-8, False), (0.0, True)])
def test_sorted_softmax_matches_the_plain_softmax(offsets, eps, submax):
    """segment_softmax_sorted against segment_softmax: the value and the
    gradient of a random cotangent, with the graph's offsets and real
    edge count or without; padding edges give 0 and get 0."""
    _, _, _, tg, _, _ = build("cora")
    rng = np.random.default_rng(2)
    logits = torch.tensor(rng.normal(size=(tg.num_edges, 3))
                          .astype(np.float32))
    cot = torch.tensor(rng.normal(size=(tg.num_edges, 3)).astype(np.float32))
    kw = dict(edge_mask=tg.edge_mask, eps=eps, subtract_segment_max=submax)
    res = []
    for fn, extra in ((seg.segment_softmax, {}),
                      (seg.segment_softmax_sorted,
                       dict(ptr=tg.dst_ptr, num_real=tg.num_real_edges)
                       if offsets else {})):
        x = logits.clone().requires_grad_(True)
        y = fn(x, tg.receivers, tg.num_nodes, **kw, **extra)
        (y * cot).sum().backward()
        res.append((y.detach(), x.grad))
    (y0, g0), (y1, g1) = res
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=1e-5, atol=1e-7)
    pad = ~tg.edge_mask
    assert not y1[pad].any() and not g1[pad].any()


def test_sorted_segment_sum_gradient_is_the_gather():
    """segment_sum_sorted_grad: the sum of segment_sum over sorted ids
    (ids past the segments dropped, rows from num_real on promised zero
    and not read); its backward hands each row its segment's cotangent,
    0 to a dropped id and to a row from num_real on."""
    ids = torch.tensor([0, 0, 1, 3, 3, 3, 4, 5], dtype=torch.int32)
    vals = torch.arange(16, dtype=torch.float32).reshape(8, 2)
    vals[6:] = 0.0
    vals.requires_grad_(True)
    out = seg.segment_sum_sorted_grad(vals, ids, 4, num_real=6)
    assert torch.equal(out.detach(), seg.segment_sum(vals.detach(), ids, 4))
    g = torch.tensor([[1., 2.], [3., 4.], [5., 6.], [7., 8.]])
    (out * g).sum().backward()
    want = torch.tensor([[1., 2.], [1., 2.], [3., 4.], [7., 8.], [7., 8.],
                         [7., 8.], [0., 0.], [0., 0.]])
    assert torch.equal(vals.grad, want)


@pytest.mark.parametrize("offsets", [True, False])
def test_attention_norm_matches_jax(offsets):
    """calc_attention_norm of the same alphas (random, in [0, 1]) on the
    same graph, with the graph's offsets or deriving them."""
    _, _, jg, tg, _, _ = build("cora")
    rng = np.random.default_rng(4)
    alphas = [rng.random((tg.num_edges, h)).astype(np.float32)
              for h in (8, 1)]
    want = float(jgat.calc_attention_norm(jg, [jnp.asarray(a)
                                                for a in alphas]))
    graph = tg if offsets else tg.replace(dst_ptr=None)
    got = tgat.calc_attention_norm(graph, [torch.tensor(a) for a in alphas])
    np.testing.assert_allclose(float(got), want, **TOL)
