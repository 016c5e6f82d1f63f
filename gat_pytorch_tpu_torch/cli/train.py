"""Train/eval CLI: the port's `python -m gat_pytorch_tpu.cli.train`.

Usage:
    python -m gat_pytorch_tpu_torch.cli.train --dataset Cora
    python -m gat_pytorch_tpu_torch.cli.train --dataset Cora --device cpu
    python -m gat_pytorch_tpu_torch.cli.train --dataset Pubmed --reorder rcm
    python -m gat_pytorch_tpu_torch.cli.train --dataset Pubmed --reorder cluster
    python -m gat_pytorch_tpu_torch.cli.train --dataset PPI --paper_faithful
    python -m gat_pytorch_tpu_torch.cli.train --dataset PATTERN
    python -m gat_pytorch_tpu_torch.cli.train --dataset Cora \
        --attention_reward 0.1
    python -m gat_pytorch_tpu_torch.cli.train --dataset PPI \
        --attention_penalty 0.05
    python -m gat_pytorch_tpu_torch.cli.train --dataset Cora \
        --layer_type naive

It keeps the JAX CLI's flags; `--device` (default cuda) takes the place
of `--platform`, and `--backend` picks the layer path (kernel | segment);
`--layer_type naive` takes the third, the oracle layer of
models/naive.py (Trainer(backend="naive")). `--attention_reward`
(Planetoid) and `--attention_penalty` (PPI) add the attention
regulariser to the loss.
`--reorder rcm` relabels the nodes by reverse Cuthill-McKee and builds the
block layout, which puts the kernel path on the windowed attention op;
`--reorder cluster` relabels them by community and builds the hybrid
split-locality layout, whose in-window edges take the windowed parts op
and whose remainder the v5 parts op;
`--paper_faithful` and `--const_attention` put it on the table op. PPI and
PATTERN train on reshuffled block-diagonal batches of whole graphs.
Without a GPU it raises unless `--device cpu` is given. Flags of features
not ported yet raise NotImplementedError naming the feature, under which
ROADMAP lists its port. The last line printed is the metrics JSON object,
as the JAX CLI prints it.
"""

from __future__ import annotations

import argparse
import json
import sys

# flag -> the feature it selects, as ROADMAP names its port
_NOT_PORTED = {
    "checkpoint_dir": "checkpoints (save/resume)",
    "checkpoint_every_n_epochs": "checkpoints (save/resume)",
    "metrics_file": "metrics logging",
    "tensorboard_dir": "metrics logging",
    "track_grads": "metrics logging",
    "sampling_fanouts": "neighbour sampling (data/sampling.py)",
    "sampling_batch_size": "neighbour sampling (data/sampling.py)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train the PyTorch/CUDA GAT on one of the datasets")
    p.add_argument("--dataset", default="Cora",
                   choices=["Cora", "Citeseer", "Pubmed", "PPI", "PATTERN"])
    p.add_argument("--num_epochs", type=int)
    p.add_argument("--l2_reg", type=float)
    p.add_argument("--learning_rate", type=float)
    p.add_argument("--patience", type=int)
    p.add_argument("--exec_type", default="train", choices=["train", "load"])
    p.add_argument("--attention_reward", type=float)
    p.add_argument("--attention_penalty", type=float)
    p.add_argument("--const_attention", action="store_true", default=None)
    p.add_argument("--paper_faithful", action="store_true", default=None)
    p.add_argument("--batch_size", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    p.add_argument("--synthetic", action="store_true", default=None,
                   help="force synthetic data even if real files exist")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--backend", default=None, choices=["kernel", "segment"],
                   help="layer path: the attention kernel ops or plain "
                        "segment ops")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--checkpoint_every_n_epochs", type=int, default=None)
    p.add_argument("--metrics_file", default=None)
    p.add_argument("--tensorboard_dir", default=None)
    p.add_argument("--track_grads", action="store_true", default=None)
    p.add_argument("--layer_type", default=None, choices=["custom", "naive"])
    p.add_argument("--sampling_fanouts", default=None)
    p.add_argument("--sampling_batch_size", type=int, default=None)
    p.add_argument("--reorder", default=None, choices=["rcm", "cluster"])
    return p


def run(config) -> dict:
    """Train on the dataset, evaluate the best-validation parameters on
    the test data, print and return the metrics."""
    from ..data import datasets, loader
    from ..train import optim as O
    from ..train.tasks import make_task
    from ..train.trainer import Trainer
    from ..utils.device import resolve_device

    resolve_device(config.device)
    if config.exec_type == "load":
        raise NotImplementedError(
            "--exec_type load needs checkpoints (ROADMAP: checkpoints and "
            "logging)")
    name = config.dataset
    task = make_task(name, attention_reward=config.attention_reward,
                     attention_penalty=config.attention_penalty)
    synth = config.synthetic
    reshuffle = None
    if name in datasets.PLANETOID:
        raw = datasets.load_planetoid(name, synthetic_override=synth,
                                      seed=config.seed)
        graph = loader.transductive_graph(
            raw, reorder=config.reorder,
            src_windows=config.reorder is not None,
            hybrid=config.reorder == "cluster")
        train_data = val_data = test_data = [graph]
    else:
        if config.reorder is not None:
            raise NotImplementedError(
                "--reorder relabels one full graph; the batched datasets "
                "do not take it")
        load = datasets.load_ppi if name == "PPI" else datasets.load_pattern
        train, val, test = (load(split, synth, config.seed)
                            for split in ("train", "val", "test"))
        batcher = loader.InductiveBatcher(train, config.batch_size,
                                          seed=config.seed)
        # as the JAX CLI: the first permutation builds train_data, and
        # every epoch (the first too) draws the next one
        train_data = batcher.epoch(0)
        reshuffle = batcher.epoch
        val_data = loader.InductiveBatcher(
            val, config.batch_size, shuffle=False).epoch()
        test_data = loader.InductiveBatcher(test, 1, shuffle=False).epoch()
    plateau = (O.ReduceLROnPlateau(factor=0.5, patience=5, min_lr=1e-6)
               if name == "PATTERN" else None)
    trainer = Trainer(cfg=config.gat_config(), task=task,
                      learning_rate=config.learning_rate,
                      weight_decay=config.l2_reg,
                      max_epochs=config.num_epochs,
                      patience=config.patience, plateau=plateau,
                      seed=config.seed, log_every=config.log_every,
                      device=config.device,
                      backend=("naive" if config.layer_type == "naive"
                               else config.backend))
    result = trainer.fit_epochs(train_data, val_data, reshuffle=reshuffle)
    metrics = trainer.evaluate(result.params, test_data)
    metrics["best_val_loss"] = result.best_val_loss
    metrics["best_epoch"] = result.best_epoch
    metrics["epochs_run"] = len(result.history)
    metrics["wall_time_s"] = round(result.wall_time_s, 2)
    print(json.dumps(metrics))
    return metrics


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag} is not ported yet (ROADMAP: {item})")
    from ..data import datasets
    from ..utils.config import get_config
    overrides = {k: v for k, v in vars(args).items()
                 if v is not None and k not in ("dataset", *_NOT_PORTED)}
    config = get_config(args.dataset, **overrides)
    if datasets.is_synthetic(args.dataset):
        print(f"[data] real {args.dataset} files not found -> synthetic "
              f"stand-in (set GAT_TPU_DATA to use real data)",
              file=sys.stderr)
    run(config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
