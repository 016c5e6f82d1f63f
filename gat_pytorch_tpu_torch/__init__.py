"""PyTorch/CUDA port of gat_pytorch_tpu for NVIDIA Hopper.

The JAX package `gat_pytorch_tpu` is the reference: this package mirrors
its layout (graph/, data/, ops/, models/, train/, parallel/, utils/,
cli/) and its public function signatures and parameter layouts, so each
module can be held against its JAX counterpart in the tests. It imports torch and never
jax, and nothing of the JAX package.

The attention hot path runs through hand-written CUDA kernels
(ops/cuda/csrc/*.cu, built with nvcc at first use). Every kernel has a
plain PyTorch version beside it that runs only on CPU tensors; a CUDA
tensor launches the kernel or raises.

The package exports the JAX package's names that the port has, but the
trainer (train/trainer.py), which imports parallel/: the model layers
import nothing of parallel/.
"""

from .graph.graph import Graph  # noqa: F401,E402
from .models.gat import (  # noqa: F401,E402
    GATConfig, GATLayerConfig, calc_attention_norm, gat_layer_apply,
    gat_model_apply, init_gat_layer, init_gat_model,
)
from .train.tasks import Task, make_task  # noqa: F401,E402
from .utils.config import DATA_CONFIG, RunConfig, get_config  # noqa: F401,E402
