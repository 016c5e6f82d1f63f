"""One-way importer: reference PyTorch-Lightning checkpoints -> the port's
parameters.

Counterpart of gat_pytorch_tpu/utils/lightning_import.py. The reference
ships trained Lightning checkpoints whose state_dict holds:
    gat_layer_list.{i}.W.weight   (NH*F_out, F_in)     torch (out, in)
    gat_layer_list.{i}.a.weight   (NH, NH*2F_out)
    skip_layer_list.{j}.weight    (out, in)            only where skip+proj
    loss_fn.pos_weight            ()                   PATTERN only

The port's layout (models/gat.py init_gat_layer) is the JAX package's:
W (F_in, NH*F_out), a (NH*2F_out, NH), skip w (in, out), each the
transpose of the reference's, for right-multiplication. The unpickle
stubs out the Lightning classes a checkpoint refers to (pytorch_lightning
is not a dependency), keeping only the plain tensors. Unpickling runs
code: load only checkpoints from a trusted source.
"""

from __future__ import annotations

import sys
import types
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.gat import Params
from ..utils.device import resolve_device


class _StubModule(types.ModuleType):
    """Module that manufactures an empty class for any attribute: enough
    for pickle to resolve the Lightning callback and enum references it
    never calls."""

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        t = type(name, (), {})
        setattr(self, name, t)
        return t


def _install_stubs() -> None:
    for mod in [
        "pytorch_lightning",
        "pytorch_lightning.callbacks",
        "pytorch_lightning.callbacks.model_checkpoint",
        "pytorch_lightning.callbacks.early_stopping",
        "pytorch_lightning.utilities",
        "pytorch_lightning.trainer",
        "pytorch_lightning.trainer.connectors",
    ]:
        if mod not in sys.modules:
            sys.modules[mod] = _StubModule(mod)


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The checkpoint's state_dict as detached CPU tensors, plus its
    "__epoch__" and "__global_step__" (-1 where absent) as 0-d int64
    tensors."""
    _install_stubs()
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    out = {k: v.detach() for k, v in ckpt["state_dict"].items()}
    out["__epoch__"] = torch.tensor(ckpt.get("epoch", -1))
    out["__global_step__"] = torch.tensor(ckpt.get("global_step", -1))
    return out


def import_params(path: str,
                  num_layers: int,
                  skip_flags: Optional[List[bool]] = None,
                  device="cuda") -> Params:
    """The port's parameters from a reference checkpoint: float32
    tensors on `device` that require grad, as params_from_jax gives them.

    skip_flags: per-layer add_skip_connection; a skip entry is emitted, in
    layer order, for each layer with a skip: {"w": ...} where the
    checkpoint has a projection weight for it, {} (identity) where not.
    """
    dev = resolve_device(device)
    sd = load_state_dict(path)

    def leaf(t: torch.Tensor) -> torch.Tensor:
        return (t.T.to(dtype=torch.float32, device=dev).contiguous()
                .requires_grad_(True))

    params: Params = {"layers": [], "skips": []}
    for i in range(num_layers):
        layer = {"W": leaf(sd[f"gat_layer_list.{i}.W.weight"])}
        a_key = f"gat_layer_list.{i}.a.weight"
        if a_key in sd:
            layer["a"] = leaf(sd[a_key])
        params["layers"].append(layer)
    if skip_flags:
        j = 0
        for flag in skip_flags:
            if not flag:
                continue
            w_key = f"skip_layer_list.{j}.weight"
            params["skips"].append({"w": leaf(sd[w_key])} if w_key in sd
                                   else {})
            j += 1
    return params


def reference_layer_arrays(path: str, num_layers: int):
    """Torch-layout (out, in) arrays per layer, as numpy, for the numpy
    oracle of the tests (tests/reference_math.py); "a" is None where the
    checkpoint has none."""
    sd = load_state_dict(path)
    layers = []
    for i in range(num_layers):
        a = sd.get(f"gat_layer_list.{i}.a.weight")
        layers.append({
            "W": sd[f"gat_layer_list.{i}.W.weight"].numpy(),
            "a": None if a is None else a.numpy(),
        })
    return layers
