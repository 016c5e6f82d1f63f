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
"""
