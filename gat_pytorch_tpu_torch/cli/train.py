"""Train/eval CLI: the port's `python -m gat_pytorch_tpu.cli.train`.

Usage:
    python -m gat_pytorch_tpu_torch.cli.train --dataset Cora
    python -m gat_pytorch_tpu_torch.cli.train --dataset Cora --device cpu
    python -m gat_pytorch_tpu_torch.cli.train --dataset Pubmed --reorder rcm

It keeps the JAX CLI's flags; `--device` (default cuda) takes the place
of `--platform`, and `--backend` picks the layer path (kernel | segment).
`--reorder rcm` relabels the nodes by reverse Cuthill-McKee and builds the
block layout, which puts the kernel path on the windowed attention op.
Without a GPU it raises unless `--device cpu` is given. Flags of features
not ported yet raise NotImplementedError naming their ROADMAP item. The
last line printed is the metrics JSON object, as the JAX CLI prints it.
"""

from __future__ import annotations

import argparse
import json
import sys

# flag -> the ROADMAP item that ports what it selects
_NOT_PORTED = {
    "checkpoint_dir": "queue A item 6 (save/resume)",
    "checkpoint_every_n_epochs": "queue A item 6 (save/resume)",
    "metrics_file": "queue A item 6 (metrics logging)",
    "tensorboard_dir": "queue A item 6 (metrics logging)",
    "track_grads": "queue A item 6 (metrics logging)",
    "layer_type": "queue A item 3 (models/naive.py)",
    "sampling_fanouts": "queue A item 9 (sampling)",
    "sampling_batch_size": "queue A item 9 (sampling)",
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
    the test mask, print and return the metrics."""
    from ..data import datasets, loader
    from ..train.tasks import make_task
    from ..train.trainer import Trainer
    from ..utils.device import resolve_device

    resolve_device(config.device)
    if config.exec_type == "load":
        raise NotImplementedError(
            "--exec_type load needs checkpoints (ROADMAP queue A item 6)")
    if config.attention_penalty:
        raise NotImplementedError(
            "--attention_penalty is the PPI regulariser (ROADMAP queue A "
            "item 9)")
    task = make_task(config.dataset,
                     attention_reward=config.attention_reward)
    raw = datasets.load_planetoid(config.dataset,
                                  synthetic_override=config.synthetic,
                                  seed=config.seed)
    graph = loader.transductive_graph(
        raw, reorder=config.reorder, src_windows=config.reorder is not None)
    trainer = Trainer(cfg=config.gat_config(), task=task,
                      learning_rate=config.learning_rate,
                      weight_decay=config.l2_reg,
                      max_epochs=config.num_epochs,
                      patience=config.patience, seed=config.seed,
                      log_every=config.log_every, device=config.device,
                      backend=config.backend)
    result = trainer.fit(graph)
    metrics = trainer.evaluate(result.params, [graph])
    metrics["best_val_loss"] = result.best_val_loss
    metrics["best_epoch"] = result.best_epoch
    metrics["epochs_run"] = len(result.history)
    metrics["wall_time_s"] = round(result.wall_time_s, 2)
    print(json.dumps(metrics))
    return metrics


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.reorder == "cluster":
        raise NotImplementedError(
            "--reorder cluster is not ported yet (ROADMAP queue A item 12, "
            "the split-locality layout)")
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag) not in (None, "custom"):
            raise NotImplementedError(
                f"--{flag} is not ported yet (ROADMAP {item})")
    from ..data import datasets
    from ..utils.config import get_config
    overrides = {k: v for k, v in vars(args).items()
                 if v is not None and k not in ("dataset", *_NOT_PORTED)}
    config = get_config(args.dataset, **overrides)
    if (args.dataset in datasets.PLANETOID
            and datasets.is_synthetic(args.dataset)):
        print(f"[data] real {args.dataset} files not found -> synthetic "
              f"stand-in (set GAT_TPU_DATA to use real data)",
              file=sys.stderr)
    run(config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
