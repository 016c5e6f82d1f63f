"""Side-by-side times of attention kernels of two trees of the port on one
card: the v5 backward (row 2 of PERF.md's kernel table) at Cora's and
PATTERN's layer shapes in its normalised mode, at Cora's in its 2-phase
mode, on the hybrid Pubmed layout's remainder in its parts mode and on the
cluster-ordered Pubmed graph in its 2-phase mode (the v6 form); the v2
forward (row 9) at PPI's and Cora's layer shapes in its partial and
normalised modes; the windowed backward (row 13) at Pubmed's in its three
modes (normalised and 2-phase on the RCM layout, parts on the hybrid
layout's in-window slots); and the v2 backward (row 10) at PPI's and
Cora's layer shapes in its partial and normalised modes: each in float32
and in the bfloat16 mode its fits run (the v2 backward has none).

    python3 tools/ab_backward.py --tree parent=build/parent --tree change=. \
        --order parent,change,change,parent [--rows 2,9,10,13]

Each entry of --order runs in a process of its own, from its tree (its
package and its kernels, built there under build/torch_kernels), on the
same seeded inputs. Per case it prints the milliseconds of one wrapper
call (CUDA-graph replay of 20 calls, as chip_smoke.py times): `whole`, the
call as a caller without a source-score table makes it (a tree whose
backward recomputes the sender's dot per edge; or one that computes the
table first), and `given`, the call given the table its op's forward
computed, where the tree's entry takes one (`s_src=`), and the largest
difference of the call's outputs from its plain version on the same
inputs over max(1, |ref|). A backward's time includes its d(h) per node:
where the tree's entry returns per-edge (or per-slot) rows, the call is
the entry and the reduction by sender the op runs after it (row 3,
dh_reduce or dh_reduce_ptr). The v2 forward is called with the graph's
offsets, as the sharded layer calls it. The card's name and power limit
are printed with the results, which are also written as JSON lines
(ab_backward.jsonl, in the output directory below). Needs one CUDA card.
"""

import argparse
import inspect
import json
import os
import subprocess
import sys
import types
from pathlib import Path

SLOPE, DROPOUT = 0.01, 0.6     # as chip_smoke.py
# (graph, heads, features, mode): the fits' layer shapes in each mode the
# main paths run
V5_CASES = (("Cora", 8, 8, "normalised"), ("Cora", 1, 7, "normalised"),
            ("PATTERN", 4, 12, "normalised"), ("PATTERN", 4, 24, "normalised"),
            ("Cora", 8, 8, "2-phase"), ("Cora", 1, 7, "2-phase"),
            ("remainder", 8, 8, "parts"), ("remainder", 8, 3, "parts"),
            ("Pubmed cluster", 8, 8, "v6 form"),
            ("Pubmed cluster", 8, 3, "v6 form"))
WINDOW_CASES = (("Pubmed", 8, 8), ("Pubmed", 8, 3))
# the v2 forward and backward as the sharded fits run them: PPI
# paper_faithful (no mask) and Cora (dropout)
V2_CASES = (("PPI", 4, 256, False), ("PPI", 6, 121, False),
            ("Cora", 8, 8, True), ("Cora", 1, 7, True))


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


def rel_err(got, want):
    """Largest |got - want| over max(1, |want|) across the outputs."""
    return max(float((x - y).abs().max()) / max(1.0, float(y.abs().max()))
               for x, y in zip(got, want) if x is not None)


def worker(label, root, rows):
    """Time every case of the rows asked for from the tree at `root`; one
    JSON line per case."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch
    from gat_pytorch_tpu_torch.data import datasets, loader
    from gat_pytorch_tpu_torch.ops import segment as seg
    from gat_pytorch_tpu_torch.ops.cuda import build
    from gat_pytorch_tpu_torch.ops.cuda import segment_attention as sa
    from gat_pytorch_tpu_torch.ops.cuda import segment_sum as ss
    from gat_pytorch_tpu_torch.ops.cuda import v5_attention as v5
    from gat_pytorch_tpu_torch.ops.cuda import window_attention as wa
    from gat_pytorch_tpu_torch.ops.cuda.rounding import (FLOAT32, V2_BF16,
                                                         Rounding)
    from gat_pytorch_tpu_torch.utils.config import get_config

    build.build_all()
    dev = torch.device("cuda")
    pubmed_raw = datasets.load_planetoid("Pubmed", synthetic_override=True,
                                         seed=0)
    graphs = {"Cora": loader.transductive_graph(datasets.load_planetoid(
        "Cora", synthetic_override=True, seed=0)).to(dev)}
    graphs["PATTERN"] = loader.InductiveBatcher(
        datasets.load_pattern("train", True, 0),
        get_config("PATTERN").batch_size, shuffle=False).epoch()[0].to(dev)
    graphs["PPI"] = loader.InductiveBatcher(
        datasets.load_ppi("train", True, 0), get_config("PPI").batch_size,
        shuffle=False).epoch()[0].to(dev)
    graphs["Pubmed"] = loader.transductive_graph(
        pubmed_raw, reorder="rcm", src_windows=True).to(dev)
    hybrid = loader.transductive_graph(
        pubmed_raw, reorder="cluster", src_windows=True, hybrid=True).to(dev)
    takes_table = ("s_src" in inspect.signature(v5.v5_backward).parameters)

    def emit(row, case, tag, whole, given, err):
        print(json.dumps({"tree": label, "row": row, "case": case,
                          "mode": tag, "whole_ms": whole, "given_ms": given,
                          "rel_err": err}), flush=True)

    def inputs(n, nh, f, slots, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        d = nh * f
        h = torch.randn((n, d), generator=gen, device=dev)
        a_src = torch.randn((d, nh), generator=gen, device=dev) / d ** 0.5
        s_dst = torch.randn((n, nh), generator=gen, device=dev)
        s_eff = (s_dst - ((h @ a_src).max() + s_dst.max())).contiguous()
        drop = ((torch.rand((slots, nh), generator=gen, device=dev)
                 >= DROPOUT).float() / (1.0 - DROPOUT))
        g = torch.randn((n, d), generator=gen, device=dev)
        d_den = torch.randn((n, nh), generator=gen, device=dev)
        return h, a_src, s_dst, s_eff, drop, g, d_den

    def time_entry(entry, args, kw, table_of, done=None):
        """Time entry(*args, **kw) whole and given its table (table_of()),
        `done` applied to its outputs (a windowed tree's reduction)."""
        call = entry if done is None else (
            lambda *a, **k: done(entry(*a, **k)))
        whole = time_ms(torch, lambda: call(*args, **kw))
        given = None
        if takes_table:
            table = table_of()
            given = time_ms(torch, lambda: call(*args, **kw, s_src=table))
        return whole, given

    if "2" in rows:
        hb = hybrid.block_layout
        graphs["Pubmed cluster"] = hybrid
        # the hybrid layer's remainder: a dst-sorted edge list over the
        # cluster-ordered graph's nodes, with the layout's own runs
        graphs["remainder"] = types.SimpleNamespace(
            num_nodes=hybrid.num_nodes, num_edges=hb.rem_send.shape[0],
            num_real_edges=hb.rem_e, senders=hb.rem_send,
            receivers=hb.rem_recv, src_order=hb.rem_order,
            src_ptr=hb.rem_src_ptr, dst_ptr=hb.rem_dst_ptr)
        table_bf16 = Rounding(table=True, acc=True)
        for name, nh, f, mode in V5_CASES:
            graph = graphs[name]
            n, er = graph.num_nodes, graph.num_real_edges
            h, a_src, s_dst, s_eff, drop, g, d_den = inputs(
                n, nh, f, graph.num_edges, nh * 100 + f)
            snd, rcv = graph.senders, graph.receivers

            def by_sender(outs, graph=graph, n=n, er=er):
                """d(h) per node: the tree's, or its per-edge rows reduced
                as the op reduces them (row 3 by the graph's runs)."""
                if outs[0].shape[0] == n:
                    return outs
                return (ss.dh_reduce(outs[0], graph.src_order,
                                     graph.senders, n, er,
                                     src_ptr=graph.src_ptr),) + tuple(
                                         outs[1:])

            modes = (("float32", FLOAT32),
                     ("bf16", wa.V6_BF16 if mode == "v6 form"
                      else table_bf16))
            for tag, rnd in modes:
                hk = rnd.table_of(h)
                runs = dict(dst_ptr=graph.dst_ptr, src_order=graph.src_order,
                            src_ptr=graph.src_ptr)
                if mode in ("2-phase", "v6 form"):
                    cap = v5.v5_cap(h, a_src, s_dst, snd, rcv, er)[0]
                    fa = (hk, a_src, s_dst, cap, drop, snd, rcv, er, 1e-8,
                          SLOPE)
                    out, den = v5.v5_forward_two_phase(
                        *fa, rnd, dst_ptr=graph.dst_ptr)
                    args = fa + (g, out, den, True)
                    entry, plain = (v5.v5_backward_two_phase,
                                    v5.v5_backward_two_phase_plain)
                    kw = dict(rounding=rnd, **runs)
                    pkw = dict(rounding=rnd)
                else:
                    num, den, cap, _ = v5.v5_forward(
                        hk, a_src, s_eff, drop, snd, rcv, er, SLOPE,
                        graph.dst_ptr, rnd)
                    epsp = 1e-8 * torch.exp(SLOPE * cap)
                    out = num / (den.repeat_interleave(f, dim=1) + epsp)
                    norm = mode == "normalised"
                    args = (hk, a_src, s_eff, drop, snd, rcv, er, SLOPE, g) + (
                        (out, den, epsp) if norm else (None, d_den, None)) + (
                        True,)
                    entry, plain = v5.v5_backward, v5.v5_backward_plain
                    kw = dict(normalize=norm, rounding=rnd, **runs)
                    pkw = dict(normalize=norm, rounding=rnd)
                err = rel_err(by_sender(entry(*args, **kw)),
                              by_sender(plain(*args, **pkw)))
                emit(2, f"{name} {nh}x{f}", f"{mode} {tag}", *time_entry(
                    entry, args, kw, lambda: v5.source_scores(hk, a_src),
                    by_sender), err)

    if "9" in rows:
        for name, nh, f, with_drop in V2_CASES:
            graph = graphs[name]
            n, e, er = graph.num_nodes, graph.num_edges, graph.num_real_edges
            d = nh * f
            gen = torch.Generator(device=dev).manual_seed(nh * 1000 + f)
            h = torch.randn((n, d), generator=gen, device=dev)
            logits = torch.where(
                graph.edge_mask[:, None],
                torch.randn((e, nh), generator=gen, device=dev),
                torch.full((e, nh), sa.NEG_INF, device=dev))
            # the sharded layer's h_src: the real edges' rows alone
            h_src = seg.gather_rows(h, graph.senders[:er]).contiguous()
            drop = (((torch.rand((e, nh), generator=gen, device=dev)
                      >= DROPOUT).float() / (1.0 - DROPOUT))
                    if with_drop else None)
            for mode in ("partial", "normalised"):
                for tag, rnd in (("float32", FLOAT32), ("bf16", V2_BF16)):
                    args = (logits, h_src, drop, graph.receivers, n, er,
                            1e-8, mode == "normalised", rnd)
                    err = rel_err(
                        sa.v2_forward(*args, dst_ptr=graph.dst_ptr),
                        sa.v2_forward_plain(*args))
                    whole = time_ms(torch, lambda: sa.v2_forward(
                        *args, dst_ptr=graph.dst_ptr))
                    emit(9, f"{name} {nh}x{f}", f"{mode} {tag}", whole,
                         None, err)

    if "13" in rows:
        for name, nh, f in WINDOW_CASES:
            os.environ["GAT_TPU_V6_DTYPE"] = "bfloat16"
            for mode, graph in (("normalised", graphs["Pubmed"]),
                                ("parts", hybrid),
                                ("2-phase", graphs["Pubmed"])):
                bl, n = graph.block_layout, graph.num_nodes
                h, a_src, s_dst, s_eff, drop, g, d_den = inputs(
                    n, nh, f, bl.num_slots, nh * 100 + f)

                def by_sender(outs, bl=bl, n=n):
                    """d(h) per node: the tree's, or its per-slot rows
                    reduced as the op reduces them."""
                    if outs[0].shape[0] == n:
                        return outs
                    return (ss.dh_reduce_ptr(outs[0], bl.src_perm,
                                             bl.src_ptr),) + tuple(outs[1:])

                two = mode == "2-phase"
                for tag, rnd in (("float32", FLOAT32),
                                 ("bf16", wa.window_rounding(
                                     nh, f, sweep1=not two))):
                    hk = rnd.table_of(h)
                    if two:
                        cap = wa.window_cap(v5.source_scores(h, a_src),
                                            s_dst, bl)[0]
                        fa = (hk, a_src, s_dst, cap, drop, bl, 1e-8, SLOPE)
                        out, den = wa.window_forward_two_phase(*fa, rnd)
                        args = fa + (g, out, den, True)
                        entry, plain = (wa.window_backward_two_phase,
                                        wa.window_backward_two_phase_plain)
                        kw = dict(rounding=rnd)
                    else:
                        num, den, cap, _ = wa.window_forward(
                            hk, a_src, s_eff, drop, bl, SLOPE, rnd)
                        epsp = 1e-8 * torch.exp(SLOPE * cap)
                        out = num / (den.repeat_interleave(f, dim=1) + epsp)
                        co = ((g, out, den, epsp) if mode == "normalised"
                              else (g, None, d_den, None))
                        args = (hk, a_src, s_eff, drop, bl, SLOPE) + co + (
                            True,)
                        entry, plain = wa.window_backward, \
                            wa.window_backward_plain
                        kw = dict(rounding=rnd,
                                  normalize=mode == "normalised")
                    got = by_sender(entry(*args, **kw))
                    want = by_sender(plain(*args, **kw))
                    emit(13, f"{name} {nh}x{f}", f"{mode} {tag}",
                         *time_entry(entry, args, kw,
                                     lambda: v5.source_scores(hk, a_src),
                                     by_sender), rel_err(got, want))

    if "10" in rows:
        for name, nh, f, with_drop in V2_CASES:
            graph = graphs[name]
            n, e, er = graph.num_nodes, graph.num_edges, graph.num_real_edges
            d = nh * f
            gen = torch.Generator(device=dev).manual_seed(nh * 1000 + f)
            h = torch.randn((n, d), generator=gen, device=dev)
            logits = torch.where(
                graph.edge_mask[:, None],
                torch.randn((e, nh), generator=gen, device=dev),
                torch.full((e, nh), sa.NEG_INF, device=dev))
            # the sharded layer's h_src: the real edges' rows alone
            h_src = seg.gather_rows(h, graph.senders[:er]).contiguous()
            drop = (((torch.rand((e, nh), generator=gen, device=dev)
                      >= DROPOUT).float() / (1.0 - DROPOUT))
                    if with_drop else None)
            g = torch.randn((n, d), generator=gen, device=dev)
            d_den = torch.randn((n, nh), generator=gen, device=dev)
            for mode in ("partial", "normalised"):
                norm = mode == "normalised"
                out, den = sa.v2_forward_plain(logits, h_src, drop,
                                               graph.receivers, n, er, 1e-8,
                                               True)
                args = (logits, h_src, drop, graph.receivers, er, 1e-8, g,
                        out if norm else None, den if norm else d_den,
                        with_drop, norm)
                err = rel_err(sa.v2_backward(*args),
                              sa.v2_backward_plain(*args))
                whole = time_ms(torch, lambda: sa.v2_backward(*args))
                emit(10, f"{name} {nh}x{f}", mode, whole, None, err)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="LABEL=PATH of a tree of the repo")
    ap.add_argument("--order", help="comma-separated labels, one process "
                    "each, in this order")
    ap.add_argument("--rows", default="2,9,10,13",
                    help="comma-separated rows of PERF.md's kernel table "
                    "to time (2, 9, 10, 13)")
    ap.add_argument("--worker", nargs=2, metavar=("LABEL", "PATH"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    rows = a.rows.split(",")
    if a.worker:
        worker(*a.worker, rows)
        return
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ab_backward: no CUDA card")
    trees = dict(t.split("=", 1) for t in a.tree)
    results = []
    for label in a.order.split(","):
        proc = subprocess.run(
            [sys.executable, __file__, "--worker", label, trees[label],
             "--rows", a.rows], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"ab_backward: {label} failed:\n"
                             f"{proc.stdout}\n{proc.stderr}")
        results += [json.loads(line) for line in proc.stdout.splitlines()
                    if line.startswith("{")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for r in results:
        given = ("" if r["given_ms"] is None
                 else f"  given {r['given_ms']:.4f}")
        print(f"{r['tree']:>8} row {r['row']:<2} {r['case']:<14} "
              f"{r['mode']:<18} whole "
              f"{r['whole_ms']:.4f}{given} ms (against the plain version: "
              f"{r['rel_err']:.2e} of max(1, |ref|))")
    print(card)
    Path("chiprun_out").mkdir(exist_ok=True)
    with open("chiprun_out/ab_backward.jsonl", "w") as fh:
        for r in results:
            fh.write(json.dumps(dict(r, card=card)) + "\n")


if __name__ == "__main__":
    main()
