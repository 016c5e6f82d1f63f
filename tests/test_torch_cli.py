"""The port's training CLI end to end on the CPU, as a user runs it."""

import json
import math
import os
import subprocess
import sys

import pytest

from gat_pytorch_tpu_torch.cli import train as cli
from gat_pytorch_tpu_torch.models import gat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_trains_cora_stand_in_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "gat_pytorch_tpu_torch.cli.train",
         "--dataset", "Cora", "--device", "cpu", "--num_epochs", "3",
         "--log_every", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    metrics = json.loads(lines[-1])
    assert metrics["epochs_run"] == 3
    for key in ("test_loss", "test_acc", "best_val_loss"):
        assert math.isfinite(metrics[key]), key
    assert 0.0 <= metrics["test_acc"] <= 1.0
    # one printed row per epoch (--log_every 1) before the metrics line
    assert sum(line.startswith("{'train_loss'") for line in lines) == 3


def test_cli_trains_with_rcm_reorder_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "gat_pytorch_tpu_torch.cli.train",
         "--dataset", "Cora", "--reorder", "rcm", "--device", "cpu",
         "--num_epochs", "2"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    metrics = json.loads(proc.stdout.strip().splitlines()[-1])
    assert metrics["epochs_run"] == 2
    for key in ("test_loss", "test_acc", "best_val_loss"):
        assert math.isfinite(metrics[key]), key


def test_cli_rcm_reorder_takes_the_windowed_op():
    """In-process, so that PATH_TRACE can be read: every layer of every
    forward (2 epochs x (train + validation) + the test pass) ran v7."""
    gat.PATH_TRACE.clear()
    cli.main(["--dataset", "Cora", "--reorder", "rcm", "--device", "cpu",
              "--num_epochs", "2"])
    assert gat.PATH_TRACE == ["v7"] * 10


def test_cli_refuses_cluster_reorder():
    with pytest.raises(NotImplementedError, match="item 12"):
        cli.main(["--device", "cpu", "--reorder", "cluster"])
