"""The inputs the benchmark makes from the seed and hands to both sides:
the model's weights and the seeds of the dropout stream. Plain torch; it
imports nothing of the port, so the reference may use it too.

The weights have the port's parameter layout (models/gat.py), leaf by
leaf as the configuration's model form gives it (portbench/forms: per
layer W and the form's attention leaves; per skip connection {} (an
identity) or {"w": (in, out)}). They are drawn on the device in one call,
in the form's order, and scaled per leaf by the form's bound.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.spec import form_of


@dataclasses.dataclass(frozen=True)
class LayerDims:
    fin: int          # input width
    nh: int           # heads
    f: int            # features a head
    concat: bool
    skip: Optional[str]   # None, "identity" or "project"

    @property
    def d(self) -> int:
        return self.nh * self.f


def layer_dims(config: dict) -> List[LayerDims]:
    heads = [1] + list(config["num_heads_per_layer"])
    feats = config["head_output_features_per_layer"]
    dims = []
    for i in range(config["num_layers"]):
        fin = heads[i] * feats[i]
        skip = None
        if config["add_skip_connection"][i]:
            skip = ("identity" if fin == heads[i + 1] * feats[i + 1]
                    else "project")
        dims.append(LayerDims(fin, heads[i + 1], feats[i + 1],
                              bool(config["heads_concat_per_layer"][i]),
                              skip))
    return dims


def torch_seed(seed: int, stream: int) -> int:
    """A 63-bit torch seed for one stream of the run `seed`."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, 1000 + stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


WEIGHTS, DROPOUT = 0, 1      # streams


def make_weights(config: dict, seed: int, device) -> Dict[str, list]:
    """The weights of `config` for the run `seed`, float32 on `device`,
    in the port's layout (a skip's entry only where the layer has one),
    in the layout of the form it names (spec.form_of)."""
    shapes = form_of(config).leaf_shapes(config)
    total = sum(int(np.prod(s)) for _, s, _ in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, WEIGHTS))
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    params: Dict[str, list] = {
        "layers": [{} for _ in layer_dims(config)], "skips": []}
    skips = {}
    at = 0
    for (group, i, key), shape, bound in shapes:
        size = int(np.prod(shape))
        leaf = (flat[at:at + size].reshape(shape) * bound).contiguous()
        at += size
        if group == "layers":
            params["layers"][i][key] = leaf
        else:
            skips[i] = {key: leaf}
    for i, ld in enumerate(layer_dims(config)):
        if ld.skip is not None:
            params["skips"].append(skips.get(i, {}))
    return params


def leaves(params: Dict[str, list]) -> List[torch.Tensor]:
    """Every tensor of `params` in the port's order (models/gat.py
    `parameters`: layers, then skips; keys sorted)."""
    return [d[k] for group in ("layers", "skips") for d in params[group]
            for k in sorted(d)]
