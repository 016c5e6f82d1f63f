"""Attention visualisation CLI: the port's `python -m gat_pytorch_tpu.cli.vis`
(reference: vis.py:30-93).

Usage:
    python -m gat_pytorch_tpu_torch.cli.vis --dataset Cora --vis_type Entropy
    python -m gat_pytorch_tpu_torch.cli.vis --dataset Cora \
        --vis_type Entropy --device cpu
    python -m gat_pytorch_tpu_torch.cli.vis --dataset PATTERN --vis_type Weight
    python -m gat_pytorch_tpu_torch.cli.vis --dataset Cora \
        --vis_type Neighbourhood --checkpoint_path ckpt/epoch-100
    python -m gat_pytorch_tpu_torch.cli.vis --dataset PPI --vis_type Weight \
        --checkpoint_path 'ckpt/epoch-{epoch}'

It keeps the JAX CLI's flags; `--device` (default cuda) takes the place of
`--platform`: the attention is extracted on that device (the eval forward
on the kernel path), and without a GPU it raises unless `--device cpu` is
given. The figures are drawn with matplotlib on the host.
`--checkpoint_path` takes a checkpoint of the port's Trainer (a `best` or
`epoch-<E>` file, or a checkpoint_dir that holds `best`) or a reference
Lightning `.ckpt` (imported by utils/lightning_import: attention maps from
the reference's own trained weights). Without one, weights from seed 0
(a shape smoke). For PPI Weight-vis the reference sweeps the epoch
checkpoints `PPI-{1,5,20,50,100}epochs.ckpt` (vis.py:59-69): a
`--checkpoint_path` holding `{epoch}` is swept over the same epochs, a
missing file skipped.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GAT attention visualisation")
    p.add_argument("--dataset", default="Cora",
                   choices=["Cora", "Citeseer", "Pubmed", "PPI", "PATTERN"])
    p.add_argument("--vis_type", default="Entropy",
                   choices=["Entropy", "Neighbourhood", "Weight"])
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--node", type=int, default=None,
                   help="centre node for Neighbourhood (default: first "
                        "degree-10 node, reference behaviour)")
    p.add_argument("--layer", type=int, default=0)
    p.add_argument("--head", type=int, default=0)
    p.add_argument("--out_dir", default="figures")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; cpu runs the kernels' "
                        "plain versions)")
    p.add_argument("--synthetic", action="store_true", default=None)
    return p


def _load_params(path, cfg, run_cfg, device="cuda"):
    """The parameters to draw: seed 0's without a path, a reference
    Lightning `.ckpt` through lightning_import, else a checkpoint of the
    port's Trainer."""
    from ..models.gat import init_gat_model
    if path is None:
        return init_gat_model(cfg, seed=0, device=device)
    if path.endswith(".ckpt"):
        from ..utils import lightning_import as LI
        return LI.import_params(path, cfg.num_layers,
                                run_cfg.add_skip_connection, device=device)
    from ..train.trainer import Trainer
    # load_checkpoint takes the checkpoint file itself (best / epoch-N
    # snapshots) or a checkpoint_dir holding "best"
    return Trainer.load_checkpoint(path, device)["params"]


def get_test_graph(dataset: str, synthetic=None, device="cuda"):
    """First test batch (reference: vis.py:17-27), on `device`."""
    from ..data import datasets, loader
    if dataset in ("Cora", "Citeseer", "Pubmed"):
        raw = datasets.load_planetoid(dataset, synthetic_override=synthetic)
        graph = loader.transductive_graph(raw)
    else:
        load = (datasets.load_ppi if dataset == "PPI"
                else datasets.load_pattern)
        graphs = load("test", synthetic)
        graph = loader.InductiveBatcher(graphs, 1, shuffle=False).epoch()[0]
    return graph.to(device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils.config import get_config
    from ..utils.device import resolve_device
    from ..vis import attention as A
    from ..vis import plots as P

    device = resolve_device(args.device)
    run_cfg = get_config(args.dataset)
    cfg = run_cfg.gat_config()
    graph = get_test_graph(args.dataset, args.synthetic, device)
    os.makedirs(args.out_dir, exist_ok=True)

    def render(params, tag=""):
        _, att = A.extract_attention(params, cfg, graph)
        stem = os.path.join(args.out_dir,
                            f"{args.dataset}-{args.vis_type}{tag}.png")
        if args.vis_type == "Entropy":
            P.draw_entropy_histogram(att, graph, args.dataset, out=stem)
        elif args.vis_type == "Weight":
            P.draw_weights_histogram(att, graph, args.dataset, out=stem,
                                     epoch_label=tag.strip("-"))
        else:
            node = args.node
            if node is None:
                cands = A.nodes_of_degree(graph, 10)
                if cands.size == 0:
                    print("no degree-10 node; pass --node", file=sys.stderr)
                    return 1
                node = int(cands[0])
            P.draw_neighbour_attention_distribution(
                att, graph, node, layer=args.layer, head=args.head,
                dataset=args.dataset, out=stem)
        print(f"wrote {stem}")
        return 0

    # PPI Weight-vis epoch sweep (reference vis.py:59-69)
    if (args.vis_type == "Weight" and args.dataset == "PPI"
            and args.checkpoint_path and "{epoch}" in args.checkpoint_path):
        rc = 0
        for epoch in (1, 5, 20, 50, 100):
            path = args.checkpoint_path.format(epoch=epoch)
            if not os.path.exists(path):
                print(f"missing {path}, skipping", file=sys.stderr)
                continue
            params = _load_params(path, cfg, run_cfg, device)
            rc |= render(params, tag=f"-{epoch}epochs")
        return rc

    params = _load_params(args.checkpoint_path, cfg, run_cfg, device)
    return render(params)


if __name__ == "__main__":
    sys.exit(main())
