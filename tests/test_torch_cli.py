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


@pytest.fixture(autouse=True)
def in_tmp_path(tmp_path, monkeypatch):
    """The CLI checkpoints to ./checkpoints by default: each in-process
    run writes in a directory of its own (the subprocesses, which run
    from the repository's root, are given --checkpoint_dir)."""
    monkeypatch.chdir(tmp_path)


def test_cli_trains_cora_stand_in_on_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "gat_pytorch_tpu_torch.cli.train",
         "--dataset", "Cora", "--device", "cpu", "--num_epochs", "3",
         "--log_every", "1", "--checkpoint_dir", str(tmp_path)],
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


def test_cli_trains_with_rcm_reorder_on_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "gat_pytorch_tpu_torch.cli.train",
         "--dataset", "Cora", "--reorder", "rcm", "--device", "cpu",
         "--num_epochs", "2", "--checkpoint_dir", str(tmp_path)],
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
    """On the batched datasets: a reorder relabels one full graph."""
    with pytest.raises(NotImplementedError, match="full graph"):
        cli.main(["--device", "cpu", "--dataset", "PPI", "--reorder",
                  "cluster"])


def test_cli_trains_pubmed_with_cluster_reorder_on_cpu():
    """`--dataset Pubmed --reorder cluster` at full width, in-process so
    that PATH_TRACE can be read: every layer of every forward (2 epochs x
    (train + validation) + the test pass) took the hybrid branch."""
    gat.PATH_TRACE.clear()
    assert cli.main(["--dataset", "Pubmed", "--reorder", "cluster",
                     "--device", "cpu", "--num_epochs", "2"]) == 0
    assert gat.PATH_TRACE == ["v7_hybrid"] * 10


def test_cli_trains_ppi_paper_faithful_on_cpu():
    """`--dataset PPI --paper_faithful` at the full width of the
    configuration, in-process so that PATH_TRACE can be read: 3 layers x
    (2 epochs x (10 train + 1 validation batches) + 2 test graphs)
    forwards, all through the table op."""
    gat.PATH_TRACE.clear()
    assert cli.main(["--dataset", "PPI", "--paper_faithful", "--device",
                     "cpu", "--num_epochs", "2", "--log_every", "0"]) == 0
    assert gat.PATH_TRACE == ["v4_table"] * (3 * (2 * 11 + 2))


def test_cli_trains_pattern_stand_in_on_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "gat_pytorch_tpu_torch.cli.train",
         "--dataset", "PATTERN", "--device", "cpu", "--num_epochs", "2",
         "--log_every", "1", "--checkpoint_dir", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "synthetic stand-in" in proc.stderr
    lines = proc.stdout.strip().splitlines()
    metrics = json.loads(lines[-1])
    assert metrics["epochs_run"] == 2
    for key in ("test_loss", "test_weighted_acc", "best_val_loss"):
        assert math.isfinite(metrics[key]), key
    rows = [line for line in lines if line.startswith("{'train_loss'")]
    assert len(rows) == 2 and "'lr': 0.005" in rows[0]


def test_cli_const_attention_takes_the_table_op():
    gat.PATH_TRACE.clear()
    cli.main(["--dataset", "Cora", "--const_attention", "--device", "cpu",
              "--num_epochs", "1"])
    assert gat.PATH_TRACE == ["v4_table"] * 6
