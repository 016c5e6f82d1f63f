"""The CLI's routes of checkpoints, metrics logging and neighbour sampling,
on the CPU at the full width of the Cora configuration, as a user runs
them with --device cpu:

  * `--sampling_fanouts 10,10 --sampling_batch_size 128`: every train
    batch a sampled subgraph of its one bucket on the v5 path, validation
    and test on the full graph;
  * `--checkpoint_dir D --checkpoint_every_n_epochs 1 --metrics_file F`,
    then `--exec_type load --checkpoint_dir D`: the saved best parameters
    give the train run's test metrics, and F holds the run's rows;
  * `--exec_type load` where D holds no checkpoint: the JAX CLI's message
    and no metrics.
"""

import ast
import json
import os

import pytest

from gat_pytorch_tpu_torch.cli import train as cli
from gat_pytorch_tpu_torch.models import gat as tgat
from gat_pytorch_tpu_torch.utils.config import get_config

from .test_torch_knobs import default_knobs  # noqa: F401


@pytest.fixture(autouse=True)
def in_tmp_path(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


def _metrics(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sampled_cora_trains_on_the_v5_path(capsys):
    tgat.PATH_TRACE.clear()
    assert cli.main(["--dataset", "Cora", "--device", "cpu",
                     "--num_epochs", "2", "--sampling_fanouts", "10,10",
                     "--sampling_batch_size", "128"]) == 0
    m = _metrics(capsys)
    assert m["epochs_run"] == 2 and 0.0 <= m["test_acc"] <= 1.0
    # 2 layers x (2 epochs x (2 sampled train + 1 validation batches) + the
    # test pass): 140 train nodes in minibatches of 128
    assert tgat.PATH_TRACE == ["v5"] * (2 * (2 * 3 + 1))
    assert os.path.exists(os.path.join("checkpoints", "best"))


def test_checkpointed_run_then_load(capsys, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    assert cli.main(["--dataset", "Cora", "--device", "cpu",
                     "--num_epochs", "2", "--log_every", "1",
                     "--checkpoint_dir", ckpt,
                     "--checkpoint_every_n_epochs", "1",
                     "--metrics_file", "m.jsonl"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    trained = json.loads(out[-1])
    rows = [ast.literal_eval(line) for line in out
            if line.startswith("{'train_loss'")]
    assert sorted(os.listdir(ckpt)) == ["best", "epoch-1", "epoch-2"]
    logged = [json.loads(line) for line in open("m.jsonl")]
    assert [r["step"] for r in logged] == [0, 1]
    for row, got in zip(rows, logged):
        for k, v in row.items():     # the printed row rounds to 4 places
            assert (round(got[k], 4) if isinstance(v, float)
                    else got[k]) == v, k
    assert cli.main(["--dataset", "Cora", "--device", "cpu",
                     "--exec_type", "load", "--checkpoint_dir", ckpt]) == 0
    loaded = _metrics(capsys)
    assert sorted(loaded) == ["test_acc", "test_loss"]
    assert {k: trained[k] for k in loaded} == loaded


def test_load_without_a_checkpoint(capsys, tmp_path):
    config = get_config("Cora", device="cpu", exec_type="load",
                        checkpoint_dir=str(tmp_path / "none"))
    assert cli.run(config) == {}
    assert capsys.readouterr().out.strip() == \
        "There is no saved checkpoint for this dataset!"
