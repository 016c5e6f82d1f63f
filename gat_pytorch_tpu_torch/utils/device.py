"""Device resolution for the port's entry points.

Entry points default to "cuda". Where there is no GPU they raise rather
than carry on quietly on the CPU: a CPU run must be asked for by name
(device="cpu" / --device cpu), as the tests do.
"""

from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = DEFAULT_DEVICE
                   ) -> torch.device:
    """torch.device for `device` (a bare "cuda" gets the current card's
    index); RuntimeError for CUDA without a GPU.

    For CUDA it also sets torch.backends.cuda.matmul.allow_tf32 = False
    (PyTorch's default, stated here): the plain products x @ W and the
    score tables must run in full float32 to agree with the reference."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        _require_gpu(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_device(actual: torch.device,
                 device: Union[str, torch.device, None] = DEFAULT_DEVICE
                 ) -> None:
    """Raise unless data on `actual` may run as `device` asks: the same
    type, and the same index where `device` names one. RuntimeError for
    CUDA without a GPU, ValueError for any other mismatch. It sets
    nothing; callers resolve the device once, up front, with
    resolve_device."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if actual.type == dev.type and dev.index in (None, actual.index):
        return
    if dev.type == "cuda":
        _require_gpu(dev)
    raise ValueError(f"data is on {actual}, device is {dev}")


def _require_gpu(dev: torch.device) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but "
            "torch.cuda.is_available() is False; pass device='cpu' "
            "(--device cpu) to run on the CPU")
