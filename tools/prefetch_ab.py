"""Epoch times of the port's batched fits under three feeds of their
batches to one card, in turns in one process:

  none    Trainer(prefetch=False): each epoch's batches built by the
          reshuffle on the main thread, each copied there before its step;
  build   Trainer(prefetch=True), the trainer's default: the next epoch's
          batches built by the prefetch thread (data/prefetch.py,
          put=False, one epoch ahead), each copied on the main thread;
  copy    Trainer(prefetch=False) with each epoch's batches, built on the
          main thread, copied to the card by a prefetch thread of their
          own on a side stream while the previous batches train
          (PrefetchIterator put=True, depth 2).

The cells are the fits of chip_smoke.py whose epochs hold several
batches: "Cora sampled" (cli.train --dataset Cora --sampling_fanouts
10,10 --sampling_batch_size 128: two sampled subgraphs an epoch, built in
about 0.3 s on the host) and "PPI paper_faithful" (ten block-diagonal
batches of two graphs an epoch), full width, seed 0, on the stand-ins.
Every variant's history and parameters must equal the "none" fit's bits.

    python3 tools/prefetch_ab.py [--epochs 3] [--rounds 2]

Prints, per cell and variant, the milliseconds an epoch (fit wall time
over epochs, the card synchronised) of each run, with the card's name and
power limit. Needs one CUDA card.
"""

import argparse
import os
import subprocess
import sys
import time

VARIANTS = ("none", "build", "copy")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("prefetch_ab: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from gat_pytorch_tpu_torch.cli import train as cli
    from gat_pytorch_tpu_torch.data import datasets, loader
    from gat_pytorch_tpu_torch.data.prefetch import PrefetchIterator
    from gat_pytorch_tpu_torch.models import gat
    from gat_pytorch_tpu_torch.train.tasks import make_task
    from gat_pytorch_tpu_torch.train.trainer import Trainer
    from gat_pytorch_tpu_torch.utils.config import get_config

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cora_raw = datasets.load_planetoid("Cora", synthetic_override=True,
                                       seed=0)
    cora = loader.transductive_graph(cora_raw).to(dev)
    ppi = [datasets.load_ppi(split, True, 0) for split in ("train", "val")]

    def cell(name):
        """(config, train batches, validation batches, reshuffle) as
        cli.train builds them, anew (a fresh generator) each call."""
        if name == "Cora sampled":
            cfg = get_config("Cora", sampling_fanouts="10,10",
                             num_epochs=args.epochs)
            sampler = cli.neighbour_sampler(cora_raw, cfg)
            return cfg, sampler.epoch(0), [cora], sampler.epoch
        cfg = get_config("PPI", paper_faithful=True, num_epochs=args.epochs)
        batcher = loader.InductiveBatcher(ppi[0], cfg.batch_size, seed=0)
        val = loader.InductiveBatcher(ppi[1], cfg.batch_size,
                                      shuffle=False).epoch()
        return cfg, batcher.epoch(0), val, batcher.epoch

    def fit(name, variant):
        cfg, train, val, build = cell(name)
        trainer = Trainer(cfg=cfg.gat_config(), task=make_task(cfg.dataset),
                          learning_rate=cfg.learning_rate,
                          weight_decay=cfg.l2_reg, max_epochs=args.epochs,
                          seed=0, prefetch=variant == "build")
        reshuffle = build
        if variant == "copy":
            def reshuffle(epoch):
                return PrefetchIterator(build(epoch), depth=2, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = trainer.fit_epochs(train, val, reshuffle=reshuffle)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / args.epochs * 1e3
        return ms, res.history, gat.parameters(res.final_params)

    for name in ("Cora sampled", "PPI paper_faithful"):
        fit(name, "none")                                  # warm-up
        times = {v: [] for v in VARIANTS}
        ref = None
        for rnd in range(args.rounds):     # in turns: forward, then back
            for variant in VARIANTS if rnd % 2 == 0 else VARIANTS[::-1]:
                ms, hist, params = fit(name, variant)
                times[variant].append(round(ms, 1))
                if ref is None:
                    ref = (hist, params)
                elif not (hist == ref[0] and all(
                        torch.equal(a, b) for a, b in zip(params, ref[1]))):
                    print(f"prefetch_ab: {name} {variant}: the fit differs "
                          f"from the first fit's bits", file=sys.stderr)
                    return 1
        print(f"[prefetch_ab] {name}, {args.epochs} epochs a fit, on "
              f"{card}: ms an epoch " + ", ".join(
                  f"{v} {times[v]} (mean "
                  f"{sum(times[v]) / len(times[v]):.1f})" for v in VARIANTS)
              + "; every fit the same bits", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
