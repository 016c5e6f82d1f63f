"""The JAX package's opt-in bfloat16 modes against the port's.

  * GAT_TPU_KERNEL_DTYPE=bfloat16: each edge's [weighted h | ex] is
    rounded before the forward kernels' float32 sums;
  * GAT_TPU_H_DTYPE=bfloat16: the h table is cast to bfloat16 before the
    gather, so that the logits, every product of the forward and the
    backward and the cap chain read rounded rows (d(h) stays float32);
both on the v5 op (fused_gat_table_autocap in its single sweep and its
2-phase form, v5_sweep1_parts) and on the v4 table op, in interpret mode
against the port's plain versions (CPU tensors); and
  * GAT_TPU_GEMM_DTYPE=bfloat16: x @ W and the skip products from
    bfloat16 operands with float32 results and bfloat16-rounded d(x) and
    d(W), with the model's input cast once, on the Cora- and skip-shaped
    models (dropout off) against gat_model_apply; and the input dropout
    in bfloat16 arithmetic at the function level, one mask for both.

Tolerances and checks are those of tests/test_torch_bf16_window.py:
within 1e-2 of each output's scale; live (the port's bfloat16 result
differs from its float32 result by more than 10x the float32 tolerance);
and 10x nearer the JAX result than the port's float32 result (RMS).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.models import gat as jgat
from gat_pytorch_tpu.ops.pallas import segment_attention as jfsa
from gat_pytorch_tpu_torch.models import gat as tgat
from gat_pytorch_tpu_torch.ops.cuda import table_attention as tv4
from gat_pytorch_tpu_torch.ops.cuda import v5_attention as tv5

from .test_torch_bf16_window import (assert_bf16_mode, assert_bf16_model,
                                     jax_model_outputs, model_outputs)
from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_model import build, jax_loss_and_grads, torch_loss_and_grads
from .test_torch_parts import v5_case
from .test_torch_two_phase_ops import edge_arrays, jax_edges, run_both

SLOPE = 0.01
KERNEL = {"GAT_TPU_KERNEL_DTYPE": "bfloat16"}
H = {"GAT_TPU_H_DTYPE": "bfloat16"}
NAMES = ("out", "h", "a_src", "s_dst", "drop")


def set_knobs(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def port_in_float32(monkeypatch, env, args, tfn):
    """The port's (out, grads) with the knobs of `env` removed."""
    for k in env:
        monkeypatch.delenv(k)
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = tfn(*leaves)
    torch.sin(out).sum().backward()
    set_knobs(monkeypatch, env)
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def autocap_pair(c, eps, two_phase=False):
    sd, rc, od = jax_edges(c)
    send, recv, order = edge_arrays(c)
    er, nh, f = c["e_real"], c["nh"], c["f"]

    def jfn(h, a, s, dd=None):
        return jfsa.fused_gat_table_autocap(
            h, a, s, dd, sd, rc, od, jnp.int32(er), None, 256, nh, f, eps,
            SLOPE, 256, 128, True)

    def tfn(h, a, s, dd=None):
        return tv5.fused_gat_table_autocap(
            h, a, s, dd, send, recv, order, er, None, 256, nh, f, eps,
            SLOPE, two_phase=two_phase)

    return jfn, tfn


def v5_args(c):
    args = [c["h"], c["a_src"], c["s_dst"]]
    if c["drop"] is not None:
        args.append(c["drop"])
    return args


@pytest.mark.parametrize("env", [KERNEL, H, {**KERNEL, **H}],
                         ids=["kernel", "h", "kernel+h"])
def test_v5_autocap_bf16_modes_match_jax(env, monkeypatch):
    set_knobs(monkeypatch, env)
    c = v5_case(8, 8, True, seed=11)
    args = v5_args(c)
    jfn, tfn = autocap_pair(c, 1e-8)
    want, got = run_both(args, jfn, tfn)
    assert_bf16_mode(got, want, port_in_float32(monkeypatch, env, args, tfn),
                     NAMES)


@pytest.mark.parametrize("knob", ["GAT_TPU_V10", "GAT_TPU_V5_MERGED"])
def test_v5_two_phase_bf16_modes_match_jax(knob, monkeypatch):
    """The cap pass reads the rounded table too: the argmax and d(cap)
    follow the rounded logits. eps = 1 makes d(cap) of order 1."""
    env = {**KERNEL, **H}
    set_knobs(monkeypatch, {**env, knob: "0"})
    c = v5_case(1, 7, False, seed=12)
    args = v5_args(c)
    jfn, tfn = autocap_pair(c, 1.0, two_phase=True)
    want, got = run_both(args, jfn, tfn)
    assert_bf16_mode(got, want, port_in_float32(monkeypatch, env, args, tfn),
                     NAMES)


def test_v5_parts_bf16_modes_match_jax(monkeypatch):
    """v5_sweep1_parts: num, den and cap' (flattened into one output),
    with more source rows than destinations."""
    env = {**KERNEL, **H}
    set_knobs(monkeypatch, env)
    c = v5_case(8, 3, True, seed=13, n_src=320)
    sd, rc, od = jax_edges(c)
    send, recv, order = edge_arrays(c)
    er = c["e_real"]

    def jfn(hh, aa, ss, dd):
        num, den, cap, _ = jfsa.v5_sweep1_parts(
            hh, aa, ss, dd, sd, rc, od, jnp.int32(er), 256, 8, 3, 1e-8,
            SLOPE, 256, 128, True, 320)
        return jnp.concatenate([num.reshape(-1), den.reshape(-1),
                                cap.reshape(1)])

    def tfn(hh, aa, ss, dd):
        num, den, cap, _ = tv5.v5_sweep1_parts(
            hh, aa, ss, dd, send, recv, order, er, 256, 8, 3, 1e-8, SLOPE,
            320)
        return torch.cat([num.reshape(-1), den.reshape(-1), cap.reshape(1)])

    args = v5_args(c)
    want, got = run_both(args, jfn, tfn)
    assert got[1][0].shape == (320, 24)
    assert_bf16_mode(got, want, port_in_float32(monkeypatch, env, args, tfn),
                     ("num|den|cap",) + NAMES[1:])


@pytest.mark.parametrize("env", [KERNEL, H], ids=["kernel", "h"])
def test_table_op_bf16_modes_match_jax(env, monkeypatch):
    """fused_segment_attention_table on capped cross-head logits with a
    dropout mask: differentiable in the logits, h and the mask."""
    set_knobs(monkeypatch, env)
    c = v5_case(4, 16, True, seed=14)
    er, e = c["e_real"], c["send"].shape[0]
    raw = (c["h"][c["send"]] @ c["a_src"] + c["s_dst"][c["recv"]])
    valid = (np.arange(e) < er)[:, None]
    lg = np.where(valid, SLOPE * (raw - raw[:er].max()), -1e30
                  ).astype(np.float32)
    args = [lg, c["h"], c["drop"]]
    sd, rc, od = jax_edges(c)
    send, recv, order = edge_arrays(c)

    def jfn(lg_, h, dd):
        return jfsa.fused_segment_attention_table(
            lg_, h, sd, rc, dd, od, 256, 4, 16, 1e-8, 256, 128, True)

    def tfn(lg_, h, dd):
        return tv4.fused_segment_attention_table(
            lg_, h, send, recv, dd, order, 256, 4, 16, 1e-8, er)

    want, got = run_both(args, jfn, tfn)
    f32 = port_in_float32(monkeypatch, env, args, tfn)
    # d(h) is the second gradient here: the liveness check reads out and
    # the first cotangent, d(logits), which both modes move
    assert_bf16_mode(got, want, f32, ("out", "logits", "h", "drop"))


@pytest.mark.parametrize("name,jbackend,tbackend", [
    ("cora", "pallas", "kernel"), ("skips", "pallas", "kernel"),
    ("skips", "xla", "segment")])
def test_gemm_bf16_model_matches_jax(name, jbackend, tbackend, monkeypatch):
    """GAT_TPU_GEMM_DTYPE=bfloat16 on both backends: logits and every
    parameter gradient; d(W) and the skip projection's d(w) are
    bfloat16 values, as the JAX transpose rounds them."""
    monkeypatch.setenv("GAT_TPU_V5", "1")
    monkeypatch.setenv("GAT_TPU_GEMM_DTYPE", "bfloat16")
    jcfg, tcfg, jg, tg, jparams, tparams = build(name)
    jlogits, jgrads = jax_loss_and_grads(jcfg, jg, jparams, jbackend)
    tlogits = torch_loss_and_grads(tcfg, tg, tparams, tbackend)
    got = model_outputs(tlogits, tparams)
    for group in ("layers", "skips"):
        for tp in tparams[group]:
            for k in ("W", "w"):
                if k in tp:
                    gr = tp[k].grad
                    assert torch.equal(gr, gr.to(torch.bfloat16).float())
    for p in tgat.parameters(tparams):
        p.grad = None
    monkeypatch.delenv("GAT_TPU_GEMM_DTYPE")
    f32 = model_outputs(torch_loss_and_grads(tcfg, tg, tparams, tbackend),
                        tparams)
    assert_bf16_model(got, jax_model_outputs(jlogits, jgrads, tparams), f32)


def test_bf16_input_dropout_matches_jax():
    """The model's input dropout on a bfloat16 input: x / bfloat16(1 -
    rate) in bfloat16 arithmetic where kept, the mask the JAX package
    draws from its key given to the port; equal bits."""
    rate, key = 0.6, jax.random.key(4)
    x = np.random.default_rng(15).random((64, 40)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jgat._dropout(xb, rate, key, True)
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - rate, xb.shape))
    xt = torch.tensor(x).to(torch.bfloat16)
    got = tgat.input_dropout(xt, torch.tensor(keep), rate)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # the float32 input's dropout gives other values: the mode is live
    f32 = tgat.input_dropout(torch.tensor(x), torch.tensor(keep), rate)
    assert float((f32 - got.float()).abs().max()) > 1e-3
