"""The port's training CLI with the attention regulariser's flags and
the naive layer (--attention_reward, --attention_penalty, --layer_type
naive), on the CPU as a user runs it with --device cpu; the PPI run is
at the full width of its configuration."""

import ast

import numpy as np
import pytest

from gat_pytorch_tpu_torch.cli import train as cli
from gat_pytorch_tpu_torch.models import gat as tgat


@pytest.mark.parametrize("flags,path", [
    (["--dataset", "Cora", "--attention_reward", "0.1"], "v5"),
    (["--dataset", "PPI", "--attention_penalty", "0.05"], "v5"),
    (["--dataset", "Cora", "--layer_type", "naive"], "naive")])
def test_cli_trains_an_epoch_with_the_new_flags(flags, path, capsys):
    """In-process, so that PATH_TRACE and the printed rows can be read;
    the regularised runs report a norm above 0, the naive one 0."""
    tgat.PATH_TRACE.clear()
    assert cli.main(["--device", "cpu", "--num_epochs", "1",
                     "--log_every", "1"] + flags) == 0
    assert set(tgat.PATH_TRACE) == {path}
    lines = capsys.readouterr().out.strip().splitlines()
    row = ast.literal_eval(next(line for line in lines
                                if line.startswith("{'train_loss'")))
    assert (row["train_attention_norm"] > 0.0) == (path != "naive")
    assert np.isfinite(row["train_loss"]) and np.isfinite(row["val_loss"])
