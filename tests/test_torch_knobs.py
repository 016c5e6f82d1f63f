"""The environment knobs both packages read, pinned for the parity tests.

Both packages read GAT_TPU_* variables when they trace or dispatch: the
JAX package's ops (GAT_TPU_KERNEL_DTYPE, GAT_TPU_H_DTYPE, GAT_TPU_GATHER*,
GAT_TPU_DH_REDUCE_*, GAT_TPU_V10, GAT_TPU_V5_MERGED, ...) and models
(GAT_TPU_GEMM_DTYPE, GAT_TPU_BACKEND), the port's model (GAT_TPU_V10,
GAT_TPU_V5_MERGED, GAT_TPU_GEMM_DTYPE) and ops (GAT_TPU_V6_DTYPE,
GAT_TPU_V12, GAT_TPU_KERNEL_DTYPE, GAT_TPU_H_DTYPE,
GAT_TPU_DH_REDUCE_NT); the tests below hold each port reader to its JAX
counterpart over a grid of settings. Some code of the repository sets
such variables for the rest of its process (the JAX CLI sets
GAT_TPU_BACKEND, bench.py GAT_TPU_GEMM_DTYPE). `default_knobs` removes
every GAT_TPU_* variable for the duration of a test, so that each knob takes its default, and sets
GAT_TPU_V6_DTYPE=float32, the JAX windowed kernels' float32 contraction
mode that the port is held against. A parity test module takes it with

    from .test_torch_knobs import default_knobs  # noqa: F401

(an autouse fixture applies to the module that imports it); a test that
needs another setting sets it with monkeypatch after the fixture ran.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.models import gat as jgat
from gat_pytorch_tpu.ops.pallas import segment_attention as jsa
from gat_pytorch_tpu.ops.pallas import segment_attention_window as jsw
from gat_pytorch_tpu.ops.pallas import segment_sum as jss
from gat_pytorch_tpu_torch.models import gat as tgat
from gat_pytorch_tpu_torch.ops.cuda import segment_sum as tss
from gat_pytorch_tpu_torch.ops.cuda import v5_attention as tv5
from gat_pytorch_tpu_torch.ops.cuda import window_attention as tw


@pytest.fixture(autouse=True)
def default_knobs(monkeypatch):
    for name in list(os.environ):
        if name.startswith("GAT_TPU_"):
            monkeypatch.delenv(name)
    monkeypatch.setenv("GAT_TPU_V6_DTYPE", "float32")


def test_knobs_are_pinned():
    assert os.environ["GAT_TPU_V6_DTYPE"] == "float32"
    assert not [k for k in os.environ
                if k.startswith("GAT_TPU_") and k != "GAT_TPU_V6_DTYPE"]


@pytest.mark.parametrize("env,modes", [
    ({}, (False, False)),
    ({"GAT_TPU_V10": "0"}, (True, True)),
    ({"GAT_TPU_V5_MERGED": "0"}, (True, False)),
    ({"GAT_TPU_V10": "1", "GAT_TPU_V5_MERGED": "1"}, (False, False)),
])
def test_two_phase_modes_read_the_jax_knobs(env, modes, monkeypatch):
    """(v5 2-phase, v7 2-phase) as the JAX package decides them:
    segment_attention._fgta_fwd runs single-sweep only while both V10 and
    V5_MERGED are on, segment_attention_window._fgw7_fwd while V10 is."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tgat.two_phase_modes() == modes


def _torch_dtype(jax_dtype):
    return getattr(torch, np.dtype(jax_dtype).name)


# every dtype knob unset, set to each value the JAX package tests for, and
# to values it does not recognise
READER_ENVS = [
    {}, {"GAT_TPU_V6_DTYPE": "float32"}, {"GAT_TPU_V6_DTYPE": "bfloat16"},
    {"GAT_TPU_V6_DTYPE": "f32"}, {"GAT_TPU_V12": "0"}, {"GAT_TPU_V12": "1"},
    {"GAT_TPU_V12": "no"}, {"GAT_TPU_KERNEL_DTYPE": "bfloat16"},
    {"GAT_TPU_KERNEL_DTYPE": "float32"}, {"GAT_TPU_H_DTYPE": "bfloat16"},
    {"GAT_TPU_H_DTYPE": "bf16"}, {"GAT_TPU_GEMM_DTYPE": "bfloat16"},
    {"GAT_TPU_GEMM_DTYPE": "float32"}, {"GAT_TPU_DH_REDUCE_NT": "0"},
    {"GAT_TPU_DH_REDUCE_NT": "1"}, {"GAT_TPU_DH_REDUCE_NT": "false"},
    {"GAT_TPU_V6_DTYPE": "float32", "GAT_TPU_V12": "0",
     "GAT_TPU_KERNEL_DTYPE": "bfloat16", "GAT_TPU_H_DTYPE": "bfloat16",
     "GAT_TPU_GEMM_DTYPE": "bfloat16", "GAT_TPU_DH_REDUCE_NT": "0"},
]


@pytest.mark.parametrize("env", READER_ENVS,
                         ids=lambda e: ",".join(f"{k[8:]}={v}"
                                                for k, v in e.items())
                         or "unset")
def test_dtype_readers_match_the_jax_package(env, monkeypatch):
    """Each port reader gives what the JAX package decides under the same
    environment: _v6_dtype, _pair_slot, _matmul_dtype and _gemm_dtype
    against their namesakes; the h dtype against the table
    segment_attention._v5_operands gathers; the d(h) form against the
    no_transpose that segment_attention._dh_reduce hands the reduce."""
    monkeypatch.delenv("GAT_TPU_V6_DTYPE")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tw._v6_dtype() == _torch_dtype(jsw._v6_dtype())
    for nhf in (7, 24, 64, 65, 128, 1024):
        assert tw._pair_slot(nhf) == jsw._pair_slot(nhf), nhf
    assert tv5._matmul_dtype() == _torch_dtype(jsa._matmul_dtype())
    assert tgat._gemm_dtype() == _torch_dtype(jgat._gemm_dtype())
    h_src = jsa._v5_operands(jnp.zeros((16, 8)), jnp.zeros((8, 1)),
                             jnp.zeros((16, 1)), jnp.zeros(32, jnp.int32),
                             jnp.zeros(32, jnp.int32), 32, 1, 8, 8, 8)[0]
    assert tv5._h_dtype() == _torch_dtype(h_src.dtype)
    seen = {}
    monkeypatch.setattr(jss, "segment_sum_pallas_rows",
                        lambda *a, **kw: seen.update(kw))
    jsa._dh_reduce(jnp.zeros((40, 128)), jnp.arange(32, dtype=jnp.int32),
                   jnp.zeros(32, jnp.int32), 32, 8, 16, True)
    assert tss.dh_transposed() == (not seen["no_transpose"])
    assert tv5.v5_rounding().table == (tv5._h_dtype() == torch.bfloat16)
    assert tv5.v5_rounding().acc == (tv5._matmul_dtype() == torch.bfloat16)
