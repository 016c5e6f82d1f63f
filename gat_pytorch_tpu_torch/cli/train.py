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
    python -m gat_pytorch_tpu_torch.cli.train --dataset Cora \
        --sampling_fanouts 10,10 --sampling_batch_size 128
    python -m gat_pytorch_tpu_torch.cli.train --dataset Cora \
        --checkpoint_dir ckpt --checkpoint_every_n_epochs 50 \
        --metrics_file metrics.jsonl
    python -m gat_pytorch_tpu_torch.cli.train --dataset Cora \
        --exec_type load --checkpoint_dir ckpt

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
`--paper_faithful` and `--const_attention` put it on the table op, and
`--gatv2` (GATv2's dynamic attention) on the GATv2 op. PPI and
PATTERN train on reshuffled block-diagonal batches of whole graphs.
`--sampling_fanouts 10,10 --sampling_batch_size 128` (Planetoid) trains on
neighbour-sampled subgraphs around minibatches of the train nodes
(data/sampling.py), drawn anew each epoch, and validates and tests on
the full graph. A run saves the best-validation checkpoint to
`<checkpoint_dir>/best` (default ./checkpoints), with
`--checkpoint_every_n_epochs N` also `epoch-<E>` every N epochs;
`--exec_type load` evaluates the saved best parameters on the test data
instead of training. `--metrics_file` streams every epoch's row as JSONL,
`--tensorboard_dir` writes TensorBoard events (the tensorboard package
must be installed) with the attention histograms, and `--track_grads` the
gradient histograms. Without a GPU it raises unless `--device cpu` is
given. The last line printed is the metrics JSON object, as the JAX CLI
prints it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


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
    p.add_argument("--gatv2", action="store_true", default=None,
                   help="GATv2's dynamic attention (arXiv:2105.14491)")
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
    p.add_argument("--checkpoint_every_n_epochs", type=int, default=None,
                   help="also save <checkpoint_dir>/epoch-N snapshots")
    p.add_argument("--metrics_file", default=None,
                   help="JSONL stream of per-epoch metrics")
    p.add_argument("--tensorboard_dir", default=None)
    p.add_argument("--track_grads", action="store_true", default=None,
                   help="gradient histograms to TensorBoard")
    p.add_argument("--layer_type", default=None, choices=["custom", "naive"])
    p.add_argument("--sampling_fanouts", default=None,
                   help="neighbour-sampled minibatch training, e.g. '10,10'"
                        " (Planetoid datasets)")
    p.add_argument("--sampling_batch_size", type=int, default=None)
    p.add_argument("--reorder", default=None, choices=["rcm", "cluster"])
    return p


def neighbour_sampler(raw, config):
    """The batcher of `--sampling_fanouts`: sampled subgraphs around
    minibatches of the train nodes of `raw` (a Planetoid RawGraph)."""
    import numpy as np
    from ..data.sampling import NeighborSampledBatcher
    fanouts = [int(v) for v in config.sampling_fanouts.split(",")]
    return NeighborSampledBatcher(
        raw.x, raw.senders, raw.receivers, raw.y,
        np.nonzero(raw.train_mask)[0], config.sampling_batch_size, fanouts,
        seed=config.seed)


def run(config) -> dict:
    """Train on the dataset and evaluate the best-validation parameters
    on the test data (`exec_type` "load": evaluate the parameters saved
    in <checkpoint_dir>/best), print and return the metrics."""
    from ..data import datasets, loader
    from ..train import optim as O
    from ..train.tasks import make_task
    from ..train.trainer import Trainer
    from ..utils.device import resolve_device

    resolve_device(config.device)
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
        if config.sampling_fanouts:
            # as the JAX CLI: epoch 0's draw builds train_data, and every
            # epoch (the first too) draws anew
            sampled = neighbour_sampler(raw, config)
            train_data = sampled.epoch(0)
            reshuffle = sampled.epoch
    else:
        if config.reorder is not None:
            raise NotImplementedError(
                "--reorder relabels one full graph; the batched datasets "
                "do not take it")
        if config.sampling_fanouts:
            raise ValueError(
                "--sampling_fanouts samples the neighbourhoods of one full "
                "graph; the batched datasets do not take it")
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
    ckpt_dir = config.checkpoint_dir
    trainer = Trainer(cfg=config.gat_config(), task=task,
                      learning_rate=config.learning_rate,
                      weight_decay=config.l2_reg,
                      max_epochs=config.num_epochs,
                      patience=config.patience, plateau=plateau,
                      checkpoint_dir=ckpt_dir, seed=config.seed,
                      log_every=config.log_every,
                      metrics_file=config.metrics_file,
                      tensorboard_dir=config.tensorboard_dir,
                      track_grads=config.track_grads,
                      checkpoint_every_n_epochs=(
                          config.checkpoint_every_n_epochs),
                      device=config.device,
                      backend=("naive" if config.layer_type == "naive"
                               else config.backend))
    if config.exec_type == "load":
        if not ckpt_dir or not os.path.exists(os.path.join(ckpt_dir,
                                                           "best")):
            print("There is no saved checkpoint for this dataset!")
            return {}
        params = Trainer.load_checkpoint(ckpt_dir, config.device)["params"]
        metrics = trainer.evaluate(params, test_data)
    else:
        result = trainer.fit_epochs(train_data, val_data,
                                    reshuffle=reshuffle)
        metrics = trainer.evaluate(result.params, test_data)
        metrics["best_val_loss"] = result.best_val_loss
        metrics["best_epoch"] = result.best_epoch
        metrics["epochs_run"] = len(result.history)
        metrics["wall_time_s"] = round(result.wall_time_s, 2)
    print(json.dumps(metrics))
    return metrics


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..data import datasets
    from ..utils.config import get_config
    overrides = {k: v for k, v in vars(args).items()
                 if v is not None and k not in ("dataset", "log_every",
                                                "metrics_file")}
    config = get_config(args.dataset, **overrides)
    if datasets.is_synthetic(args.dataset):
        print(f"[data] real {args.dataset} files not found -> synthetic "
              f"stand-in (set GAT_TPU_DATA to use real data)",
              file=sys.stderr)
    config.log_every = args.log_every
    config.metrics_file = args.metrics_file
    run(config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
