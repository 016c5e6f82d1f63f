"""Carry parameters and block layouts over from the JAX package.

`params_from_jax` takes the JAX model's parameter tree
{"layers": [{"W", "a", ["bias"]}], "skips": [{} | {"w"}]} with numpy
arrays as leaves (np.asarray of each jax array) and returns the port's
parameters: the same layout (W right-multiplied, cross-head a), float32
tensors on `device` that require grad. Both packages then compute the
same function.

`block_layout_from_jax` takes a JAX BlockLayout (any object with its
array and int attributes; the arrays go through np.asarray) and returns
the port's, with the index arrays the CUDA kernels need rebuilt.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.graph import BlockLayout
from ..graph.transforms import layout_index_arrays
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


def block_layout_from_jax(layout, num_nodes: int, device="cuda"
                          ) -> BlockLayout:
    """The port's BlockLayout of a plain (no hybrid remainder) JAX one
    over `num_nodes` padded nodes."""
    if getattr(layout, "rem_send", None) is not None:
        raise NotImplementedError(
            "a hybrid layout's remainder needs the split-locality path "
            "(ROADMAP queue A item 12, not ported)")
    dev = resolve_device(device)
    arrays = {k: np.array(getattr(layout, k), dtype=np.int32)  # a copy
              for k in ("send", "recv", "base", "tile_ptr", "tile_base")}
    (arrays["dst_perm"], arrays["dst_ptr"], arrays["src_perm"],
     arrays["src_ptr"], num_real) = layout_index_arrays(
        arrays["send"], arrays["recv"], num_nodes)
    return BlockLayout(
        **{k: torch.from_numpy(v).to(dev) for k, v in arrays.items()},
        wb=int(layout.wb), window=int(layout.window), nb=int(layout.nb),
        eb=int(layout.eb), dmax=int(layout.dmax), num_real=num_real)
