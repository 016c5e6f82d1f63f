"""Metric logging: a JSONL stream and, optionally, TensorBoard.

Counterpart of gat_pytorch_tpu/train/logging.py, which it transcribes:

  * scalars: every epoch's history row goes to a JSONL file (one
    {"step": epoch, **row} object a line, flushed a line) and/or to
    TensorBoard through torch.utils.tensorboard;
  * histograms: `log_histogram` for the per-layer attention and the
    gradient distributions, which the Trainer calls where its
    tensorboard_dir is set (and track_grads, for the gradients).

torch.utils.tensorboard is imported only where a tensorboard_dir is
given. Without the tensorboard package that import raises ImportError,
which is left to the caller.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np


class MetricsLogger:
    """Composite logger: JSONL file and/or TensorBoard event files."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 tensorboard_dir: Optional[str] = None):
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(tensorboard_dir)
            except BaseException:
                self.close()
                raise

    def log_scalars(self, step: int, row: Dict[str, float]) -> None:
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, **row}) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in row.items():
                if isinstance(v, (int, float)) and k != "epoch":
                    self._tb.add_scalar(k, v, step)

    def log_histogram(self, step: int, tag: str, values) -> None:
        if self._tb:
            self._tb.add_histogram(tag, np.asarray(values), step)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._tb:
            self._tb.close()
            self._tb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
