"""Side-by-side times of the narrow attention backwards of two trees of
the port on one card: the v5 backward (row 2 of PERF.md's kernel table)
at Cora's and PATTERN's layer shapes and the windowed backward (row 13)
at Pubmed's, in float32 and in the bfloat16 mode each fit runs.

    python3 tools/ab_backward.py --tree parent=build/parent --tree change=. \
        --order parent,change,change,parent

Each entry of --order runs in a process of its own, from its tree (its
package and its kernels, built there under build/torch_kernels), on the
same seeded inputs. Per case it prints the milliseconds of one wrapper
call (CUDA-graph replay of 20 calls, as chip_smoke.py times): `whole`, the
call as a caller without a source-score table makes it (a tree whose
backward recomputes the sender's dot per edge; or one that computes the
table first), and `given`, the call given the table its op's forward
computed, where the tree's entry takes one (`s_src=`), and the largest
difference of the call's outputs from its plain version on the same
inputs over max(1, |ref|). The card's name and power limit are printed
with the results, which also go to chiprun_out/ab_backward.jsonl. Needs
one CUDA card.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

SLOPE, DROPOUT = 0.01, 0.6     # as chip_smoke.py
CASES = (("Cora", 8, 8), ("Cora", 1, 7), ("PATTERN", 4, 12),
         ("PATTERN", 4, 24), ("Pubmed", 8, 8), ("Pubmed", 8, 3))


def time_ms(torch, fn, calls=20, replays=10):
    """Mean device milliseconds per call of `fn` (CUDA-graph replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def worker(label, root):
    """Time every case from the tree at `root`; one JSON line per case."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    from gat_pytorch_tpu_torch.data import datasets, loader
    from gat_pytorch_tpu_torch.ops.cuda import build
    from gat_pytorch_tpu_torch.ops.cuda import v5_attention as v5
    from gat_pytorch_tpu_torch.ops.cuda import window_attention as wa
    from gat_pytorch_tpu_torch.ops.cuda.rounding import FLOAT32, Rounding
    from gat_pytorch_tpu_torch.utils.config import get_config

    build.build_all()
    dev = torch.device("cuda")
    graphs = {"Cora": loader.transductive_graph(datasets.load_planetoid(
        "Cora", synthetic_override=True, seed=0)).to(dev)}
    graphs["PATTERN"] = loader.InductiveBatcher(
        datasets.load_pattern("train", True, 0),
        get_config("PATTERN").batch_size, shuffle=False).epoch()[0].to(dev)
    graphs["Pubmed"] = loader.transductive_graph(
        datasets.load_planetoid("Pubmed", synthetic_override=True, seed=0),
        reorder="rcm", src_windows=True).to(dev)
    takes_table = ("s_src" in inspect.signature(v5.v5_backward).parameters)
    for name, nh, f in CASES:
        graph = graphs[name]
        gen = torch.Generator(device=dev).manual_seed(nh * 100 + f)
        n, d = graph.num_nodes, nh * f
        windowed = name == "Pubmed"
        slots = (graph.block_layout.num_slots if windowed
                 else graph.num_edges)
        h = torch.randn((n, d), generator=gen, device=dev)
        a_src = torch.randn((d, nh), generator=gen, device=dev) / d ** 0.5
        s_dst = torch.randn((n, nh), generator=gen, device=dev)
        s_eff = (s_dst - ((h @ a_src).max() + s_dst.max())).contiguous()
        drop = ((torch.rand((slots, nh), generator=gen, device=dev)
                 >= DROPOUT).float() / (1.0 - DROPOUT))
        g = torch.randn((n, d), generator=gen, device=dev)
        if windowed:
            os.environ["GAT_TPU_V6_DTYPE"] = "bfloat16"
            modes = (("float32", FLOAT32),
                     ("bf16", wa.window_rounding(nh, f)))
        else:
            modes = (("float32", FLOAT32),
                     ("bf16", Rounding(table=True, acc=True)))
        for tag, rnd in modes:
            hk = rnd.table_of(h)
            if windowed:
                bl = graph.block_layout
                num, den, cap, _ = wa.window_forward(hk, a_src, s_eff, drop,
                                                     bl, SLOPE, rnd)
                args = (hk, a_src, s_eff, drop, bl, SLOPE)
                entry, kw = wa.window_backward, dict(rounding=rnd)
            else:
                er = graph.num_real_edges
                num, den, cap, _ = v5.v5_forward(
                    hk, a_src, s_eff, drop, graph.senders, graph.receivers,
                    er, SLOPE, graph.dst_ptr, rnd)
                args = (hk, a_src, s_eff, drop, graph.senders,
                        graph.receivers, er, SLOPE)
                entry = v5.v5_backward
                kw = dict(dst_ptr=graph.dst_ptr, rounding=rnd,
                          src_order=graph.src_order, src_ptr=graph.src_ptr)
            epsp = 1e-8 * torch.exp(SLOPE * cap)
            out = num / (den.repeat_interleave(f, dim=1) + epsp)
            args += (g, out, den, epsp, True)
            # the kernel against its plain version on the card (the
            # windowed d(h) rows of pad slots are unwritten: not compared)
            plain = (wa.window_backward_plain if windowed
                     else v5.v5_backward_plain)
            got = entry(*args, **kw)
            want = plain(*args, rounding=rnd)
            err = max(float((x - y).abs().max()) / max(1.0, float(
                y.abs().max())) for x, y in zip(got[1 if windowed else 0:],
                                                 want[1 if windowed else 0:])
                      if x is not None)
            whole = time_ms(torch, lambda: entry(*args, **kw))
            given = None
            if takes_table:
                table = v5.source_scores(hk, a_src)
                given = time_ms(torch, lambda: entry(*args, **kw,
                                                     s_src=table))
            print(json.dumps({"tree": label, "case": f"{name} {nh}x{f}",
                              "mode": tag, "whole_ms": whole,
                              "given_ms": given, "rel_err": err}),
                  flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=PATH of a tree of the repo")
    ap.add_argument("--order", help="comma-separated labels, one process "
                    "each, in this order")
    ap.add_argument("--worker", nargs=2, metavar=("LABEL", "PATH"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        worker(*a.worker)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_backward: no CUDA card")
    trees = dict(t.split("=", 1) for t in a.tree)
    rows = []
    for label in a.order.split(","):
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", label, trees[label]],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"ab_backward: {label} failed:\n"
                             f"{proc.stdout}\n{proc.stderr}")
        rows += [json.loads(line) for line in proc.stdout.splitlines()
                 if line.startswith("{")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for r in rows:
        given = ("" if r["given_ms"] is None
                 else f"  given {r['given_ms']:.4f}")
        print(f"{r['tree']:>8} {r['case']:<14} {r['mode']:<8} whole "
              f"{r['whole_ms']:.4f}{given} ms (against the plain version: "
              f"{r['rel_err']:.2e} of max(1, |ref|))")
    print(card)
    Path("chiprun_out").mkdir(exist_ok=True)
    with open("chiprun_out/ab_backward.jsonl", "w") as fh:
        for r in rows:
            fh.write(json.dumps(dict(r, card=card)) + "\n")


if __name__ == "__main__":
    main()
