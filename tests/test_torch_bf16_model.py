"""The model on every path that the windowed op's default bfloat16
payload reaches, against the JAX package under the same environment
(GAT_TPU_V6_DTYPE unset; the JAX kernels in interpret mode).

Cases, each the JAX package's gat_model_apply(backend="pallas") against
the port's gat_model_apply on the kernel path, logits and every
parameter gradient of the training loss:
  rcm     the Cora-shaped 2-layer model (8x8 concatenated, 1x7 mean) on a
          banded graph, force_windowed=True: the v7 single sweep, both
          layers in the packed window (bfloat16 table, logits from the
          rounded rows);
  V12=0   the same without the packed window: logits from the float32
          rows, the rows rounded after them;
  V10=0   the same in the 2-phase form (cap pass on the float32 rows);
  hybrid  the hybrid split-locality model of tests/test_hybrid_layout.py
          in cluster order: the windowed parts op in the packed window,
          the remainder through the v5 parts op (float32: the v5 knobs
          are unset);
  v6      the same graph under GAT_TPU_V10=0: the v6 form (rows, [weighted
          h | ex], d(h) and d(raw) in d(a_src) rounded; payload and
          d(s_dst) float32).
Tolerance, liveness and the rounding-point check are
tests/test_torch_bf16_window.py's `assert_bf16_model`: each output within
1e-2 of its own largest magnitude; the logits further than 10x the
float32 model tests' 1e-4 from the port's float32 result (the mode is
live); every output that the mode moves that far at least 10x nearer the
JAX result (root mean square) than the port's float32 result is.
"""

import jax
import pytest

from gat_pytorch_tpu.models import gat as jgat
from gat_pytorch_tpu.train.tasks import planetoid_task as jtask
from gat_pytorch_tpu_torch.models import gat as tgat

from .test_torch_bf16_window import (assert_bf16_model, jax_model_outputs,
                                     port_model)
from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_model import build_hybrid, build_windowed

HYBRID = {"GAT_TPU_V6": "1", "GAT_TPU_HYBRID_REM_XLA_MAX": "0"}
CASES = {
    # name: (graph, environment, JAX keywords, the layers' path)
    "rcm": ("banded", {}, {"force_windowed": True}, "v7"),
    "V12=0": ("banded", {"GAT_TPU_V12": "0"}, {"force_windowed": True},
              "v7"),
    "V10=0": ("banded", {"GAT_TPU_V10": "0"}, {"force_windowed": True},
              "v7"),
    "hybrid": ("clustered", HYBRID, {}, "v7_hybrid"),
    "v6": ("clustered", {"GAT_TPU_V10": "0"}, {"force_windowed": True},
           "v6"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_windowed_model_bf16_matches_jax(case, monkeypatch):
    graph, env, jax_kw, path = CASES[case]
    monkeypatch.delenv("GAT_TPU_V6_DTYPE")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jcfg, tcfg, jg, tg, jparams, tparams = (
        build_windowed("cora", n=800, e=4000) if graph == "banded"
        else build_hybrid())
    task = jtask()

    def loss(p):
        logits = jgat.gat_model_apply(p, jcfg, jg, backend="pallas",
                                      **jax_kw)
        return task.loss(logits, jg, "train"), logits

    jgat.PATH_TRACE.clear()
    (_, jlogits), jgrads = jax.value_and_grad(loss, has_aux=True)(jparams)
    assert jgat.PATH_TRACE == [path, path]
    got = port_model(tcfg, tg, tparams)
    assert tgat.PATH_TRACE == [path, path]
    monkeypatch.setenv("GAT_TPU_V6_DTYPE", "float32")
    f32 = port_model(tcfg, tg, tparams)
    assert tgat.PATH_TRACE == [path, path]
    assert_bf16_model(got, jax_model_outputs(jlogits, jgrads, tparams), f32)
