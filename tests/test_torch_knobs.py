"""The environment knobs both packages read, pinned for the parity tests.

Both packages read GAT_TPU_* variables when they trace or dispatch: the
JAX package's ops (GAT_TPU_KERNEL_DTYPE, GAT_TPU_H_DTYPE, GAT_TPU_GATHER*,
GAT_TPU_DH_REDUCE_*, GAT_TPU_V10, GAT_TPU_V5_MERGED, ...) and models
(GAT_TPU_GEMM_DTYPE, GAT_TPU_BACKEND), the port's model (GAT_TPU_V10,
GAT_TPU_V5_MERGED). Some code of the repository sets such variables for
the rest of its process (the JAX CLI sets GAT_TPU_BACKEND, bench.py
GAT_TPU_GEMM_DTYPE). `default_knobs` removes every GAT_TPU_* variable for
the duration of a test, so that each knob takes its default, and sets
GAT_TPU_V6_DTYPE=float32, the JAX windowed kernels' float32 contraction
mode that the port is held against. A parity test module takes it with

    from .test_torch_knobs import default_knobs  # noqa: F401

(an autouse fixture applies to the module that imports it); a test that
needs another setting sets it with monkeypatch after the fixture ran.
"""

import os

import pytest

from gat_pytorch_tpu_torch.models import gat as tgat


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
