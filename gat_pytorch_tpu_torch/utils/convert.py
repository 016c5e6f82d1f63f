"""Carry parameters over from the JAX package.

`params_from_jax` takes the JAX model's parameter tree
{"layers": [{"W", "a", ["bias"]}], "skips": [{} | {"w"}]} with numpy
arrays as leaves (np.asarray of each jax array) and returns the port's
parameters: the same layout (W right-multiplied, cross-head a), float32
tensors on `device` that require grad. Both packages then compute the
same function.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gat import Params
from ..utils.device import resolve_device


def params_from_jax(tree, device="cuda") -> Params:
    dev = resolve_device(device)

    def leaf(a) -> torch.Tensor:
        t = torch.tensor(np.asarray(a, dtype=np.float32), device=dev)
        return t.requires_grad_(True)

    return {group: [{k: leaf(v) for k, v in d.items()}
                    for d in tree.get(group, [])]
            for group in ("layers", "skips")}
