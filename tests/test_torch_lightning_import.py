"""The reference-checkpoint importer (utils/lightning_import.py) against the
JAX package's.

The reference's trained Lightning checkpoints are not in the repository,
so the test writes a Lightning-shaped one: a state_dict in the
reference's names and (out, in) layout, with epoch and global_step, and a
callback object of a stand-in `pytorch_lightning` class that is removed
from sys.modules before the load, as on a machine without Lightning. Both
importers must stub the class out and give the same arrays to the bits,
and the port's model on them a forward within 1e-5 of the JAX model's.
"""

import sys
import types

import numpy as np
import pytest
import torch

from gat_pytorch_tpu.graph import transforms as JT
from gat_pytorch_tpu.models import gat as jgat
from gat_pytorch_tpu.utils import lightning_import as jL
from gat_pytorch_tpu_torch.graph import transforms as TT
from gat_pytorch_tpu_torch.models import gat as tgat
from gat_pytorch_tpu_torch.utils import lightning_import as tL

from .test_torch_knobs import default_knobs  # noqa: F401

CFG = dict(num_input_node_features=8, num_layers=3,
           num_heads_per_layer=[2, 2, 1],
           heads_concat_per_layer=[True, True, False],
           head_output_features_per_layer=[8, 4, 4, 3], num_classes=3,
           add_skip_connection=[False, True, True], dropout=0.0)
LIGHTNING = ("pytorch_lightning", "pytorch_lightning.callbacks",
             "pytorch_lightning.callbacks.model_checkpoint")


@pytest.fixture
def no_lightning():
    """sys.modules as it was, without the stand-in or the stubs after."""
    before = {k: v for k, v in sys.modules.items()
              if k.startswith("pytorch_lightning")}
    yield
    for k in [k for k in sys.modules if k.startswith("pytorch_lightning")]:
        del sys.modules[k]
    sys.modules.update(before)


def write_checkpoint(path):
    """A checkpoint as the reference's Lightning Trainer writes it: the
    skip of layer 1 is the identity (8 -> 8 features, no weight), layer
    2's a projection (8 -> 3); the callback state holds an object of a
    Lightning class."""
    rng = np.random.default_rng(4)
    sd = {}
    dims = CFG["head_output_features_per_layer"]
    heads = CFG["num_heads_per_layer"]
    f_in = dims[0]
    for i, (nh, f) in enumerate(zip(heads, dims[1:])):
        sd[f"gat_layer_list.{i}.W.weight"] = torch.tensor(
            rng.normal(size=(nh * f, f_in)), dtype=torch.float32)
        sd[f"gat_layer_list.{i}.a.weight"] = torch.tensor(
            rng.normal(size=(nh, nh * 2 * f)), dtype=torch.float32)
        f_in = nh * f if CFG["heads_concat_per_layer"][i] else f
    sd["skip_layer_list.1.weight"] = torch.tensor(
        rng.normal(size=(3, 8)), dtype=torch.float32)
    mods = [types.ModuleType(name) for name in LIGHTNING]
    ModelCheckpoint = type("ModelCheckpoint", (), {})
    ModelCheckpoint.__module__ = LIGHTNING[-1]
    mods[-1].ModelCheckpoint = ModelCheckpoint
    sys.modules.update(zip(LIGHTNING, mods))
    cb = ModelCheckpoint()
    cb.best_model_score = torch.tensor(0.5)
    torch.save({"state_dict": sd, "epoch": 41, "global_step": 420,
                "callbacks": {"ModelCheckpoint": cb}}, path)
    for name in LIGHTNING:
        del sys.modules[name]
    return sd


def test_import_params_equals_the_jax_importer(tmp_path, no_lightning):
    path = str(tmp_path / "ref.ckpt")
    sd = write_checkpoint(path)
    skips = CFG["add_skip_connection"]
    want = jL.import_params(path, 3, skips)
    got = tL.import_params(path, 3, skips, device="cpu")
    assert [sorted(d) for d in got["layers"]] == \
        [sorted(d) for d in want["layers"]] == [["W", "a"]] * 3
    assert got["skips"][0] == {} and want["skips"][0] == {}
    for group in ("layers", "skips"):
        for t, j in zip(got[group], want[group]):
            for k in t:
                assert t[k].requires_grad and t[k].dtype == torch.float32
                np.testing.assert_array_equal(t[k].detach().numpy(),
                                              np.asarray(j[k]))
    np.testing.assert_array_equal(got["layers"][0]["W"].detach().numpy(),
                                  sd["gat_layer_list.0.W.weight"].numpy().T)

    raw = tL.load_state_dict(path)
    assert int(raw["__epoch__"]) == 41 and int(raw["__global_step__"]) == 420
    ref = tL.reference_layer_arrays(path, 3)
    jref = jL.reference_layer_arrays(path, 3)
    for a, b in zip(ref, jref):
        np.testing.assert_array_equal(a["W"], b["W"])
        np.testing.assert_array_equal(a["a"], b["a"])

    # the models on the imported parameters
    rng = np.random.default_rng(0)
    n = 40
    x = rng.normal(size=(n, 8)).astype(np.float32)
    s, r = rng.integers(0, n, 160), rng.integers(0, n, 160)
    jcfg, tcfg = jgat.GATConfig(**CFG), tgat.GATConfig(**CFG)
    jout = np.asarray(jgat.gat_model_apply(want, jcfg,
                                           JT.canonicalize(x, s, r)))
    tout = tgat.gat_model_apply(got, tcfg, TT.canonicalize(x, s, r),
                                device="cpu").detach().numpy()
    np.testing.assert_allclose(tout, jout, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jout).max()))
