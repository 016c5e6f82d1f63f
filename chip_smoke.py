#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

Five paths, each at the full width and depth of its configuration on the
synthetic stand-in of its dataset:
  Cora    `cli.train --dataset Cora`: the v5 attention op (kernels
          v5_forward, v5_backward, segment_sum_rows);
  Pubmed  `cli.train --dataset Pubmed --reorder rcm`: RCM reorder, block
          layout, the windowed attention op (kernels window_forward,
          window_backward, and segment_sum_rows again for d(h));
  PPI paper_faithful  `cli.train --dataset PPI --paper_faithful`:
          block-diagonal batches of two graphs, the table op (kernels
          table_forward, table_backward, segment_sum_rows) at 1024- and
          726-wide rows;
  PPI     `cli.train --dataset PPI`: the v5 op at the same widths;
  PATTERN `cli.train --dataset PATTERN`: 4 layers with skip projections,
          batches of eight graphs, the plateau schedule, the v5 op.

Phases (every failure is fatal):
  1. build the CUDA kernels from gat_pytorch_tpu_torch/ops/cuda/csrc
     (one nvcc per source, started together) and print the card's name
     and power limit as nvidia-smi gives them;
  2. at each path's layer shapes (Cora 8 heads x 8 features and 1 x 7;
     Pubmed 8 x 8 and 8 x 3; PPI 4 x 256 and 6 x 121; PATTERN 4 x 12,
     4 x 24 and 1 x 1) on its graph or on one batch of its graphs, run
     each kernel's wrapper and its plain PyTorch version on the same card
     tensors and hold them together: with and without the dropout mask,
     the v5 and window backward also at eps = 1, the table kernels at
     eps = 0 on max-subtracted logits (PPI) and at eps = 1e-8 with dropout
     (Cora 8 x 8) and without (PATTERN); the window and table kernels are
     also launched twice and must give the same bits;
  3. train each stand-in for the epochs of CELLS through the port's
     Trainer (the code the CLI runs), with every launch counter set to 0
     just before and read just after; the train loss must be finite and
     fall, every kernel of the path must have run the expected number of
     times, and PATH_TRACE must name the path;
  4. hold the trained model's logits and gradients on the kernel path
     against the plain segment-op path on the card (Pubmed: the windowed
     path also against the v5 kernel path on the same reordered graph
     without its block layout);
  5. time each kernel (CUDA graph replays), its plain version and, where
     one PyTorch call computes the same function, that call; time the
     train step on each path and profile a short window of steps; time
     the table op against the v5 op on one PATTERN batch;
  6. print one {"kernels": [...]} line, then the {"ok": true, ...} line.

It exits non-zero without printing a result when there is no GPU or when
the port's package is not beside it.
"""

import json
import math
import os
import subprocess
import sys
import time

SHAPES = {"Cora": ((8, 8), (1, 7)),      # (heads, features) per layer
          "Pubmed": ((8, 8), (8, 3)),
          "PPI": ((4, 256), (6, 121)),   # layers 1-2 share 4 x 256
          "PATTERN": ((4, 12), (4, 24), (1, 1))}   # layer 3 is 4 x 12 again
DROPOUT = 0.6
SLOPE = 0.01
PF_SLOPE = 0.2      # LeakyReLU slope under paper_faithful
# the fits of phase 3: name -> (dataset, config overrides, epochs, layer
# path, layers); the first two are cut from up to 1000 epochs with early
# stopping, PPI and PATTERN further, since an epoch there is 10 and 32
# train steps
CELLS = {
    "Cora": ("Cora", {}, 50, "v5", 2),
    "Pubmed": ("Pubmed", {"reorder": "rcm"}, 50, "v7", 2),
    "PPI paper_faithful": ("PPI", {"paper_faithful": True}, 30, "v4_table",
                           3),
    "PPI": ("PPI", {}, 10, "v5", 3),
    "PATTERN": ("PATTERN", {}, 5, "v5", 4),
}
PATH_KERNELS = {"v5": ("v5_forward", "v5_backward"),
                "v7": ("window_forward", "window_backward"),
                "v4_table": ("table_forward", "table_backward")}
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# kernel vs plain version on the card: sums run in another order
# (per-warp shuffles against matmul / index_add), float32 rounding only
REL_TOL = 1e-4
_PALLAS = "gat_pytorch_tpu/ops/pallas/"
_CSRC = "gat_pytorch_tpu_torch/ops/cuda/csrc/"
REPLACES = {
    "v5_forward": _PALLAS + "segment_attention.py:1265",
    "v5_backward": _PALLAS + "segment_attention_bwd.py:537",
    "segment_sum_rows": _PALLAS + "segment_sum.py:120",
    "window_forward": _PALLAS + "segment_attention_window.py:163",
    "window_backward": _PALLAS + "segment_attention_window.py:923",
    "table_forward": _PALLAS + "segment_attention.py:269",
    "table_backward": _PALLAS + "segment_attention_bwd.py:178",
}
SOURCES = {
    "v5_forward": _CSRC + "v5_attention.cu",
    "v5_backward": _CSRC + "v5_attention.cu",
    "segment_sum_rows": _CSRC + "segment_sum.cu",
    "window_forward": _CSRC + "window_attention.cu",
    "window_backward": _CSRC + "window_attention.cu",
    "table_forward": _CSRC + "table_attention.cu",
    "table_backward": _CSRC + "table_attention.cu",
}
BWD_NAMES = ("d_h_rows", "d_drop", "d_s_dst", "d_a_src")
TABLE_BWD_NAMES = ("d_h_rows", "d_logits", "d_drop")


def launches_per_epoch(path, layers, train_batches, val_batches):
    """Launches per epoch of a fit on `path`: each layer's forward runs
    in every train step and in every validation batch, its backward and
    its d(h) reduce in every train step."""
    fwd, bwd = PATH_KERNELS[path]
    per = {k: 0 for k in REPLACES}
    per[fwd] = layers * (train_batches + val_batches)
    per[bwd] = per["segment_sum_rows"] = layers * train_batches
    return per


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def max_err(got, want, floor=1.0):
    """(max |got - want|, max(floor, max |want|))."""
    got, want = got.float(), want.float()
    return (float((got - want).abs().max()),
            max(floor, float(want.abs().max())))


def hold(name, got, want, errs, floor=1.0):
    """Fail unless got is within REL_TOL x max(floor, max |want|) of want.
    floor=0 holds an output at its own magnitude, which must be non-zero
    for the check to mean anything."""
    err, scale = max_err(got, want, floor)
    print(f"  {name}: max_abs_err {err:.3e} (scale {scale:.3e})")
    if not scale > 0.0:
        fail(f"{name}: the plain version is all zeros, nothing to hold")
    if not err <= REL_TOL * scale:
        fail(f"{name} differs from its plain version: {err} > "
             f"{REL_TOL} x {scale}")
    errs.append(err)


def time_ms(torch, fn, calls=20, replays=10):
    """Mean device milliseconds per call of `fn`: `calls` calls captured
    in one CUDA graph, replayed `replays` times between CUDA events, so
    the host's launch overhead is left out."""
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


def step_time_ms(torch, fn, iters=100, warmup=10):
    """Mean milliseconds per eager call, host launch overhead included
    (CUDA events around back-to-back calls)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def op_inputs(torch, gen, n, nh, f, slots, dev):
    """Seeded inputs of an attention op at one layer shape: h, a_src, the
    B-shifted s_dst, a dropout mask over `slots` edge slots, and g."""
    d = nh * f
    h = torch.randn((n, d), generator=gen, device=dev)
    a_src = torch.randn((d, nh), generator=gen, device=dev) / d ** 0.5
    s_dst = torch.randn((n, nh), generator=gen, device=dev)
    s_eff = (s_dst - ((h @ a_src).max() + s_dst.max())).contiguous()
    drop = ((torch.rand((slots, nh), generator=gen, device=dev) >= DROPOUT)
            .float() / (1.0 - DROPOUT))
    g = torch.randn((n, d), generator=gen, device=dev)
    return h, a_src, s_eff, drop, g


def epilogue(torch, num, den, cap, f, eps):
    """(out, eps') of the ops' normalising epilogue."""
    epsp = eps * torch.exp(SLOPE * cap)
    return num / (den.repeat_interleave(f, dim=1) + epsp), epsp


def profile_steps(torch, step, step_ms, label, steps=20, top=12):
    """Profile `steps` train steps; print the device's busy time per step,
    its idle share of `step_ms`, and the top kernels and host operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA
              and not ev.is_user_annotation]
    dev_us = sum(ev.self_device_time_total for ev in events) / steps
    launches = sum(ev.count for ev in events) / steps
    print(f"[profile] {label}, {steps} train steps: kernels busy "
          f"{dev_us:.1f} us/step in {launches:.0f} launches/step of "
          f"{step_ms * 1e3:.1f} us/step (device idle "
          f"{1 - dev_us / (step_ms * 1e3):.3f}); top kernels:")
    for ev in sorted(events, key=lambda ev: -ev.self_device_time_total)[:top]:
        print(f"  {ev.self_device_time_total / steps:9.1f} us/step "
              f"{ev.count / steps:5.1f}/step  {ev.key[:90]}")
    if top:
        host = [ev for ev in prof.key_averages()
                if ev.device_type == DeviceType.CPU]
        print("[profile] top host operations by self CPU time (under the "
              "profiler, which slows the host):")
        for ev in sorted(host, key=lambda ev: -ev.self_cpu_time_total)[:top]:
            print(f"  {ev.self_cpu_time_total / steps:9.1f} us/step "
                  f"{ev.count / steps:5.1f}/step  {ev.key[:90]}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gat_pytorch_tpu_torch.data import datasets, loader
    from gat_pytorch_tpu_torch.models import gat
    from gat_pytorch_tpu_torch.ops import segment as seg
    from gat_pytorch_tpu_torch.ops.cuda import build
    from gat_pytorch_tpu_torch.ops.cuda import segment_sum as ss
    from gat_pytorch_tpu_torch.ops.cuda import table_attention as ta
    from gat_pytorch_tpu_torch.ops.cuda import v5_attention as v5
    from gat_pytorch_tpu_torch.ops.cuda import window_attention as wa
    from gat_pytorch_tpu_torch.train import optim as O
    from gat_pytorch_tpu_torch.train.tasks import make_task
    from gat_pytorch_tpu_torch.train.trainer import Trainer
    from gat_pytorch_tpu_torch.utils.config import get_config
    from gat_pytorch_tpu_torch.utils.device import resolve_device

    # -- 1. build --------------------------------------------------------
    t0 = time.time()
    build.build_all()
    print(f"[build] {len(build.SOURCES)} sources in "
          f"{time.time() - t0:.1f} s into {build.BUILD_DIR}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    dev = resolve_device("cuda")
    print(f"[device] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = {k: [] for k in REPLACES}

    def hold_all(prefix, names, got, want, key, floor=1.0):
        torch.cuda.synchronize()
        for nm, x, y in zip(names, got, want):
            hold(f"{prefix} {nm}", x, y, errs[key], floor)

    def same_bits(name, first, second):
        """The kernels sum in a fixed order and use no atomics: a second
        launch on the same inputs must give the same bits."""
        torch.cuda.synchronize()
        for x, y in zip(first, second):
            if (x is None) != (y is None) or \
                    (x is not None and not torch.equal(x, y)):
                fail(f"{name}: two launches on the same inputs differ")

    # -- 2a. the v5 kernels and the reduce against their plain versions -----
    def check_v5(graph, nh, f, with_drop):
        """The v5 kernels and the d(h) reduce at one layer shape on
        `graph`; returns the inputs for the timings."""
        n, e, e_real = graph.num_nodes, graph.num_edges, graph.num_real_edges
        snd, rcv, order = graph.senders, graph.receivers, graph.src_order
        h, a_src, s_eff, drop, g = op_inputs(torch, gen, n, nh, f, e, dev)
        if not with_drop:
            drop = None
        fwd_args = (h, a_src, s_eff, drop, snd, rcv, e_real, SLOPE)
        got = v5.v5_forward(*fwd_args)
        want = v5.v5_forward_plain(*fwd_args)
        hold_all("v5_forward", ("num", "den", "cap"), got, want,
                 "v5_forward")
        if int(got[3]) != int(want[3]):
            fail(f"argmax code {int(got[3])} != plain {int(want[3])}")
        num, den, cap, _ = want
        out, epsp = epilogue(torch, num, den, cap, f, 1e-8)
        bwd_args = fwd_args + (g, out, den, epsp, with_drop)
        want = v5.v5_backward_plain(*bwd_args)
        keep = [i for i in range(4) if want[i] is not None]
        names = [BWD_NAMES[i] for i in keep]
        got = v5.v5_backward(*bwd_args)
        hold_all("v5_backward", names, [got[i] for i in keep],
                 [want[i] for i in keep], "v5_backward")
        rows = want[0]
        # At eps = 1e-8, d(s_dst) is about eps' (the softmax's own terms
        # cancel), so the check above cannot see eps' or a d(s_dst) left
        # at zero. At eps = 1, eps' is of the size of den: hold every
        # output there at its own magnitude.
        out1, epsp1 = epilogue(torch, num, den, cap, f, 1.0)
        bwd1 = fwd_args + (g, out1, den, epsp1, with_drop)
        got, want = v5.v5_backward(*bwd1), v5.v5_backward_plain(*bwd1)
        hold_all("v5_backward eps=1", names, [got[i] for i in keep],
                 [want[i] for i in keep], "v5_backward", floor=0.0)
        got = ss.dh_reduce(rows, order, snd, n, e_real)
        want = ss.segment_rows_plain(rows, order,
                                      snd.index_select(0, order.long()), n)
        hold_all("segment_sum_rows", ("(d(h) reduce)",), (got,), (want,),
                 "segment_sum_rows")
        return dict(nh=nh, f=f, drop=with_drop, fwd_args=fwd_args,
                    bwd_args=bwd_args, rows=rows)

    raw = datasets.load_planetoid("Cora", synthetic_override=True, seed=0)
    cora = loader.transductive_graph(raw).to(dev)
    n, e, e_real = cora.num_nodes, cora.num_edges, cora.num_real_edges
    snd, rcv, order = cora.senders, cora.receivers, cora.src_order
    print(f"[graph] Cora stand-in: {n} nodes (padded), {e} edges "
          f"(padded), {e_real} real")
    cora_cases = []
    for nh, f in SHAPES["Cora"]:
        print(f"[kernels] Cora layer shape {nh}x{f}")
        cora_cases.append(check_v5(cora, nh, f, with_drop=True))

    # -- 2b. the Pubmed path's kernels against their plain versions --------
    t0 = time.time()
    raw = datasets.load_planetoid("Pubmed", synthetic_override=True, seed=0)
    pubmed_cpu = loader.transductive_graph(raw, reorder="rcm",
                                           src_windows=True)
    host_s = time.time() - t0
    pubmed = pubmed_cpu.to(dev)
    bl = pubmed.block_layout
    np_, e7, e7_real = pubmed.num_nodes, bl.num_slots, bl.num_real
    print(f"[graph] Pubmed stand-in, RCM-reordered ({host_s:.2f} s on the "
          f"host for data, reorder and layout): {np_} nodes (padded), "
          f"{pubmed.num_real_edges} real edges in {e7} layout slots "
          f"(nb {bl.nb}, eb {bl.eb}, wb {bl.wb}, window {bl.window}, "
          f"dmax {bl.dmax}, src_band {pubmed.src_band})")
    if e7_real != pubmed.num_real_edges:
        fail(f"the layout holds {e7_real} real slots, the graph "
             f"{pubmed.num_real_edges} real edges")
    real = (bl.recv >= 0).nonzero().squeeze(1)
    src_ids = bl.send[bl.src_perm.long()]      # ascending sender ids
    pubmed_cases = []
    for nh, f in SHAPES["Pubmed"]:
        print(f"[kernels] Pubmed layer shape {nh}x{f}")
        h, a_src, s_eff, drop, g = op_inputs(torch, gen, np_, nh, f, e7, dev)
        for label, mask in (("", drop), (" no dropout", None)):
            fwd_args = (h, a_src, s_eff, mask, bl, SLOPE)
            got = wa.window_forward(*fwd_args)
            want = wa.window_forward_plain(*fwd_args)
            hold_all("window_forward" + label, ("num", "den", "cap"), got,
                     want, "window_forward")
            if int(got[3]) != int(want[3]):
                fail(f"argmax code {int(got[3])} != plain {int(want[3])}")
            same_bits("window_forward" + label, got,
                      wa.window_forward(*fwd_args))
            num, den, cap, _ = want
            for eps, floor in ((1e-8, 1.0), (1.0, 0.0)):
                out, epsp = epilogue(torch, num, den, cap, f, eps)
                bwd_args = fwd_args + (g, out, den, epsp, mask is not None)
                got = list(wa.window_backward(*bwd_args))
                want = list(wa.window_backward_plain(*bwd_args))
                rows = want[0]
                # the kernel leaves the d(h) rows of pad slots unwritten
                got[0], want[0] = got[0][real], rows[real]
                again = list(wa.window_backward(*bwd_args))
                again[0] = again[0][real]
                same_bits(f"window_backward{label} eps={eps:g}", got, again)
                keep = [i for i in range(4) if want[i] is not None]
                hold_all(f"window_backward{label} eps={eps:g}",
                         [BWD_NAMES[i] for i in keep],
                         [got[i] for i in keep], [want[i] for i in keep],
                         "window_backward", floor)
                if mask is not None and eps == 1e-8:
                    got = ss.dh_reduce_ptr(rows, bl.src_perm, bl.src_ptr)
                    want = ss.segment_rows_plain(rows, bl.src_perm,
                                                  src_ids, np_)
                    hold_all("segment_sum_rows", ("(d(h) reduce by ptr)",),
                             (got,), (want,), "segment_sum_rows")
                    pubmed_cases.append(dict(
                        nh=nh, f=f, fwd_args=fwd_args, bwd_args=bwd_args,
                        rows=rows))

    # -- 2c. the table kernels, and the v5 kernels at the PPI widths --------
    def table_inputs(graph, nh, f, paper_faithful, with_drop):
        """Seeded inputs of the table op as the model hands them over:
        per-head scores through LeakyReLU(0.2) with the per-destination
        max subtracted (paper_faithful), or cross-head scores capped
        before LeakyReLU(0.01); NEG_INF on padding edges."""
        n_, e_ = graph.num_nodes, graph.num_edges
        snd_, rcv_ = graph.senders, graph.receivers
        mask = graph.edge_mask[:, None]
        pad = torch.full((e_, nh), ta.NEG_INF, device=dev)
        h = torch.randn((n_, nh * f), generator=gen, device=dev)
        s_src, s_dst = torch.randn((2, n_, nh), generator=gen, device=dev)
        raw_ = seg.gather_rows(s_src, snd_) + seg.gather_rows(s_dst, rcv_)
        if paper_faithful:
            lg = torch.where(mask, torch.nn.functional.leaky_relu(
                raw_, PF_SLOPE), pad)
            top = seg.segment_max(lg, rcv_, n_)
            top = torch.where(torch.isfinite(top), top,
                              torch.zeros_like(top))
            lg = torch.where(mask, lg - seg.gather_rows(top, rcv_), pad)
        else:
            cap = torch.where(mask, raw_, pad).max()
            lg = torch.where(mask, SLOPE * (raw_ - cap), pad)
        drop = None
        if with_drop:
            drop = ((torch.rand((e_, nh), generator=gen, device=dev)
                     >= DROPOUT).float() / (1.0 - DROPOUT))
        g = torch.randn((n_, nh * f), generator=gen, device=dev)
        return h, lg.contiguous(), drop, g

    def check_table(graph, nh, f, eps, paper_faithful, with_drop):
        """The table kernels at one layer shape on `graph`; returns the
        inputs for the timings."""
        h, lg, drop, g = table_inputs(graph, nh, f, paper_faithful,
                                      with_drop)
        fwd_args = (lg, h, drop, graph.senders, graph.receivers,
                    graph.num_nodes, graph.num_real_edges, eps)
        got = ta.table_forward(*fwd_args)
        out, den = ta.table_forward_plain(*fwd_args)
        hold_all("table_forward", ("out", "den"), got, (out, den),
                 "table_forward")
        same_bits("table_forward", got, ta.table_forward(*fwd_args))
        # padded rows have no edge and the sink only padding edges
        if not torch.isfinite(got[0]).all() or \
                not (got[0][~graph.node_mask] == 0).all():
            fail("table_forward: rows without a real edge are not 0")
        bwd_args = (lg, h, drop, graph.senders, graph.receivers,
                    graph.num_real_edges, eps, g, out, den, with_drop)
        got = ta.table_backward(*bwd_args)
        want = ta.table_backward_plain(*bwd_args)
        keep = [i for i in range(3) if want[i] is not None]
        for floor, tag in ((1.0, ""), (0.0, " at its own magnitude")):
            hold_all("table_backward" + tag,
                     [TABLE_BWD_NAMES[i] for i in keep],
                     [got[i] for i in keep], [want[i] for i in keep],
                     "table_backward", floor)
        same_bits("table_backward", got, ta.table_backward(*bwd_args))
        if not all(torch.isfinite(got[i]).all() for i in keep) or \
                not (got[1][~graph.edge_mask] == 0).all():
            fail("table_backward: padding edges' cotangents are not 0")
        return dict(nh=nh, f=f, drop=with_drop, fwd_args=fwd_args,
                    bwd_args=bwd_args, rows=want[0])

    inductive = {}
    for name in ("PPI", "PATTERN"):
        load = datasets.load_ppi if name == "PPI" else datasets.load_pattern
        inductive[name] = [load(split, True, 0)
                           for split in ("train", "val", "test")]
    batch_size = get_config("PPI").batch_size
    ppi = loader.InductiveBatcher(inductive["PPI"][0], batch_size,
                                  shuffle=False).epoch()[0].to(dev)
    print(f"[graph] PPI stand-in, one batch of {batch_size} graphs: "
          f"{ppi.num_nodes} nodes (padded, {int(ppi.node_mask.sum())} "
          f"real), {ppi.num_edges} edges (padded), {ppi.num_real_edges} "
          f"real")
    ppi_table_cases, ppi_v5_cases = [], []
    for nh, f in SHAPES["PPI"]:
        print(f"[kernels] PPI layer shape {nh}x{f}: table kernels on "
              f"max-subtracted logits at eps = 0, v5 kernels, no dropout")
        ppi_table_cases.append(check_table(ppi, nh, f, 0.0, True, False))
        ppi_v5_cases.append(check_v5(ppi, nh, f, with_drop=False))
    print("[kernels] Cora layer shape 8x8: table kernels on capped logits "
          "with dropout at eps = 1e-8")
    cora_table_case = check_table(cora, 8, 8, 1e-8, False, True)
    batch_size = get_config("PATTERN").batch_size
    pattern = loader.InductiveBatcher(inductive["PATTERN"][0], batch_size,
                                      shuffle=False).epoch()[0].to(dev)
    print(f"[graph] PATTERN stand-in, one batch of {batch_size} graphs: "
          f"{pattern.num_nodes} nodes (padded), {pattern.num_edges} edges "
          f"(padded), {pattern.num_real_edges} real")
    pattern_table_cases, pattern_v5_cases = [], []
    for nh, f in SHAPES["PATTERN"]:
        print(f"[kernels] PATTERN layer shape {nh}x{f}: table kernels on "
              f"capped logits at eps = 1e-8, v5 kernels, no dropout")
        pattern_table_cases.append(check_table(pattern, nh, f, 1e-8, False,
                                               False))
        pattern_v5_cases.append(check_v5(pattern, nh, f, with_drop=False))

    # -- 3. the main paths: train each stand-in ----------------------------
    def cell_data(dataset, cfg):
        """(train batches, validation batches, reshuffle) as cli.train
        builds them."""
        if dataset == "Cora":
            return [cora], [cora], None
        if dataset == "Pubmed":
            return [pubmed], [pubmed], None
        train, val, _ = inductive[dataset]
        batcher = loader.InductiveBatcher(train, cfg.batch_size, seed=0)
        val_data = loader.InductiveBatcher(val, cfg.batch_size,
                                           shuffle=False).epoch()
        return batcher.epoch(0), val_data, batcher.epoch

    fits, launches, per_epoch = {}, {k: 0 for k in REPLACES}, {}
    for name, (dataset, overrides, max_epochs, path, layers) in CELLS.items():
        cfg = get_config(dataset, num_epochs=max_epochs, device="cuda",
                         **overrides)
        train_data, val_data, reshuffle = cell_data(dataset, cfg)
        plateau = (O.ReduceLROnPlateau(factor=0.5, patience=5, min_lr=1e-6)
                   if dataset == "PATTERN" else None)
        trainer = Trainer(cfg=cfg.gat_config(), task=make_task(dataset),
                          learning_rate=cfg.learning_rate,
                          weight_decay=cfg.l2_reg, max_epochs=cfg.num_epochs,
                          patience=cfg.patience, plateau=plateau, seed=0,
                          device="cuda")
        gat.PATH_TRACE.clear()
        build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        result = trainer.fit_epochs(train_data, val_data, reshuffle=reshuffle)
        torch.cuda.synchronize()
        wall = time.time() - t0
        ran = dict(build.LAUNCHES)
        trace = set(gat.PATH_TRACE)
        hist = result.history
        epochs = len(hist)
        losses = [r["train_loss"] for r in hist]
        val_key = next(k for k in hist[-1]
                       if k.startswith("val_") and k != "val_loss")
        print(f"[train] {name}: {epochs} epochs of {len(train_data)} train "
              f"and {len(val_data)} validation batches in {wall:.3f} s "
              f"({wall / epochs * 1e3:.3f} ms/epoch incl. the host's "
              f"batching and the per-epoch metric sync); train_loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; {val_key} "
              f"{hist[-1][val_key]:.4f}; paths {sorted(trace)}; launches "
              f"{ran}")
        if not all(math.isfinite(v) for v in losses) or \
                not math.isfinite(hist[-1][val_key]):
            fail(f"{name}: train loss or {val_key} is not finite")
        if not losses[-1] < losses[0]:
            fail(f"{name}: train loss did not fall")
        forwards = layers * (len(train_data) + len(val_data)) * epochs
        if trace != {path} or len(gat.PATH_TRACE) != forwards:
            fail(f"{name}: layer paths {sorted(trace)} x "
                 f"{len(gat.PATH_TRACE)}, expected {path} x {forwards}")
        per_epoch[name] = launches_per_epoch(path, layers, len(train_data),
                                             len(val_data))
        for k, per in per_epoch[name].items():
            if ran[k] != per * epochs:
                fail(f"{name}: {k}: {ran[k]} launches on the main path, "
                     f"expected {per * epochs} ({layers} layers x batches, "
                     f"validation forwards included)")
            launches[k] += ran[k]
        test_data = val_data
        if reshuffle is not None:     # as cli.train: test batches of one graph
            test_data = loader.InductiveBatcher(
                inductive[dataset][2], 1, shuffle=False).epoch()
        metrics = trainer.evaluate(result.params, test_data)
        print(f"[train] {name}: best epoch {result.best_epoch}, best "
              f"val_loss {result.best_val_loss:.4f}, {metrics}")
        if not all(math.isfinite(v) for v in metrics.values()):
            fail(f"{name}: test metrics are not finite")
        fits[name] = (cfg, trainer, result.final_params,
                      train_data[0].to(dev))

    # -- 4. kernel paths against the plain segment path on the card --------
    def logits_and_grads(trainer, params, graph):
        for p in gat.parameters(params):
            p.grad = None
        logits = trainer.apply(params, graph)
        trainer.task.loss(logits, graph, "train").backward()
        torch.cuda.synchronize()
        return (logits.detach(),
                [p.grad.clone() for p in gat.parameters(params)])

    refs = {}
    for name, (cfg, trainer, params, graph) in fits.items():
        refs[name] = Trainer(cfg=cfg.gat_config(), task=trainer.task,
                             learning_rate=0.0, device="cuda",
                             backend="segment")
        lk, gk = logits_and_grads(trainer, params, graph)
        shape = ((graph.num_nodes,) if trainer.task.squeeze_output
                 else (graph.num_nodes, cfg.num_classes))
        if lk.shape != shape or not torch.isfinite(lk).all():
            fail(f"{name}: logits of shape {tuple(lk.shape)} or not finite")
        others = [("segment", refs[name], graph)]
        if graph.block_layout is not None:
            others.append(("v5 kernel", trainer,
                           graph.replace(block_layout=None)))
        for label, other, other_graph in others:
            gat.PATH_TRACE.clear()
            lo, go = logits_and_grads(other, params, other_graph)
            print(f"[model] {name}: kernel path vs {label} path "
                  f"{gat.PATH_TRACE} on the card")
            model_errs = []
            hold("logits", lk, lo, model_errs)
            # a trained model's gradients are small, and d(a) is a sum of
            # cancelling terms: hold each at the largest gradient's
            # magnitude, not at 1 and not at its own
            gscale = max(float(y.abs().max()) for y in go)
            for i, (x, y) in enumerate(zip(gk, go)):
                hold(f"grad param {i}", x, y, model_errs, floor=gscale)

    # -- 5. timings ---------------------------------------------------------
    timing = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
                      bytes=0, ops=0) for k in REPLACES}

    def time_rows(label, rows, into_json):
        for k, (kern, plain, lib, nbytes, ops) in rows.items():
            km, pm = time_ms(torch, kern), time_ms(torch, plain)
            lm = time_ms(torch, lib) if lib is not None else None
            bm, by = bound_ms(nbytes, ops)
            print(f"[time] {k} {label}: kernel_ms {km:.4f} plain_ms "
                  f"{pm:.4f} library_ms "
                  f"{'null' if lm is None else f'{lm:.4f}'} bound_us "
                  f"{bm * 1e3:.3f} ({by})")
            if not into_json:
                continue
            t = timing[k]
            t["ms"] += km
            t["plain_ms"] += pm
            t["bound_ms"] += bm
            t["bytes"] += nbytes
            t["ops"] += ops
            if lm is not None:
                t["library_ms"] = (t["library_ms"] or 0.0) + lm

    # bytes: every input read once, every output written once (float32 and
    # int32 = 4 bytes); ops: this run's real edges
    def attention_ops(e_edges, d, nh):
        return (e_edges * (2 * d * nh + 2 * d + 4 * nh),
                e_edges * (6 * d * nh + 4 * d + 10 * nh))

    def v5_time_rows(graph, c):
        """The v5 kernels and the d(h) reduce at one case of check_v5."""
        n_, e_ = graph.num_nodes, graph.num_edges
        snd_, order_ = graph.senders, graph.src_order
        nh, d = c["nh"], c["nh"] * c["f"]
        fa, ba, rows = c["fwd_args"], c["bwd_args"], c["rows"]
        dm = e_ * nh if c["drop"] else 0      # the mask in, d(mask) out
        b_fwd = 4 * (n_ * d + d * nh + n_ * nh + dm + 2 * e_
                     + n_ * d + n_ * nh + 2)
        b_bwd = 4 * (n_ * d + d * nh + n_ * nh + dm + 2 * e_ + 2 * n_ * d
                     + n_ * nh + 1 + e_ * d + dm + n_ * nh + d * nh)
        o_fwd, o_bwd = attention_ops(graph.num_real_edges, d, nh)
        ids_sorted = snd_.index_select(0, order_.long())
        snd_l = snd_.long()
        return {
            "v5_forward": (lambda: v5.v5_forward(*fa),
                           lambda: v5.v5_forward_plain(*fa), None,
                           b_fwd, o_fwd),
            "v5_backward": (lambda: v5.v5_backward(*ba),
                            lambda: v5.v5_backward_plain(*ba), None,
                            b_bwd, o_bwd),
            "segment_sum_rows": (
                lambda: ss.dh_reduce(rows, order_, snd_, n_,
                                     graph.num_real_edges),
                lambda: ss.segment_rows_plain(rows, order_, ids_sorted, n_),
                lambda: torch.zeros((n_, d), device=dev).index_add_(
                    0, snd_l, rows),
                4 * (e_ * d + 2 * e_ + n_ * d), e_ * d),
        }

    def table_time_rows(graph, c):
        """The table kernels at one case of check_table. Inputs: logits,
        h, the mask, senders, receivers (and g, out, den); per real edge
        the forward does nh exp and a d-wide multiply-add, the backward a
        d-wide dot, a d-wide product and the per-head terms."""
        n_, e_, er = graph.num_nodes, graph.num_edges, graph.num_real_edges
        nh, d = c["nh"], c["nh"] * c["f"]
        fa, ba = c["fwd_args"], c["bwd_args"]
        dm = e_ * nh if c["drop"] else 0
        b_fwd = 4 * (e_ * nh + n_ * d + dm + 2 * e_ + n_ * d + n_ * nh)
        b_bwd = 4 * (e_ * nh + n_ * d + dm + 2 * e_ + 2 * n_ * d + n_ * nh
                     + e_ * d + e_ * nh + dm)
        return {
            "table_forward": (lambda: ta.table_forward(*fa),
                              lambda: ta.table_forward_plain(*fa), None,
                              b_fwd, er * (2 * d + 3 * nh) + n_ * d),
            "table_backward": (lambda: ta.table_backward(*ba),
                               lambda: ta.table_backward_plain(*ba), None,
                               b_bwd, er * (3 * d + 8 * nh) + 2 * n_ * d),
        }

    for c in cora_cases:
        time_rows(f"Cora {c['nh']}x{c['f']}", v5_time_rows(cora, c),
                  into_json=True)
    send_real = bl.send[real].long()
    plain = loader.transductive_graph(raw).to(dev)   # Pubmed, not reordered
    drop5 = ((torch.rand((plain.num_edges, 8), generator=gen, device=dev)
              >= DROPOUT).float() / (1.0 - DROPOUT))
    for c in pubmed_cases:
        nh, f, d = c["nh"], c["f"], c["nh"] * c["f"]
        fa, ba, rows = c["fwd_args"], c["bwd_args"], c["rows"]
        # inputs h, a_src, s_dst, drop, send, dst_perm, dst_ptr; the
        # backward also g, out, den, eps' and writes the real slots' rows
        b_in = np_ * d + d * nh + np_ * nh + e7 * nh + 2 * e7 + np_ + 1
        b_fwd = 4 * (b_in + np_ * d + np_ * nh + 2)
        b_bwd = 4 * (b_in + 2 * np_ * d + np_ * nh + 1 + e7_real * d
                     + e7 * nh + np_ * nh + d * nh)
        o_fwd, o_bwd = attention_ops(e7_real, d, nh)
        rows_real = rows[real]
        time_rows(f"Pubmed {nh}x{f}", {
            "window_forward": (lambda: wa.window_forward(*fa),
                               lambda: wa.window_forward_plain(*fa), None,
                               b_fwd, o_fwd),
            "window_backward": (lambda: wa.window_backward(*ba),
                                lambda: wa.window_backward_plain(*ba), None,
                                b_bwd, o_bwd),
        }, into_json=True)
        # the v5 kernels on the same inputs, for the question whether the
        # layout buys anything on this card: on the reordered graph's
        # dst-sorted edge list, and on the graph as it comes
        for tag, gph in (("RCM order", pubmed), ("input order", plain)):
            fa5 = (fa[0], fa[1], fa[2], drop5[:, :nh].contiguous(),
                   gph.senders, gph.receivers, gph.num_real_edges, SLOPE)
            num, den, cap, _ = v5.v5_forward(*fa5)
            ba5 = fa5 + (ba[6],) + epilogue(torch, num, den, cap, f, 1e-8)[:1]
            ba5 += (den, ba[9], True)
            print(f"[time] v5 kernels at Pubmed {nh}x{f}, {tag}: forward "
                  f"{time_ms(torch, lambda: v5.v5_forward(*fa5)):.4f} ms, "
                  f"backward "
                  f"{time_ms(torch, lambda: v5.v5_backward(*ba5)):.4f} ms")
        # the d(h) reduce at this path's shapes, beside the table's (Cora)
        time_rows(f"Pubmed {nh}x{f}", {
            "segment_sum_rows": (
                lambda: ss.dh_reduce_ptr(rows, bl.src_perm, bl.src_ptr),
                lambda: ss.segment_rows_plain(rows, bl.src_perm, src_ids,
                                              np_),
                lambda: torch.zeros((np_, d), device=dev).index_add_(
                    0, send_real, rows_real),
                4 * (e7_real * d + e7_real + np_ + 1 + np_ * d),
                e7_real * d),
        }, into_json=False)
    # the table kernels at the PPI widths (the JSON line's times), and
    # beside them the v5 kernels and the reduce on the same batch
    for ct, c5 in zip(ppi_table_cases, ppi_v5_cases):
        label = f"PPI {ct['nh']}x{ct['f']}"
        time_rows(label, table_time_rows(ppi, ct), into_json=True)
        time_rows(label, v5_time_rows(ppi, c5), into_json=False)
    time_rows("Cora 8x8 with dropout", table_time_rows(cora, cora_table_case),
              into_json=False)
    # both ops on one small batch: the JAX package takes the table op
    # under 4096 edges and v5 above, for the TPU's launch cost; these
    # times are what a gate for this card would be decided on
    for ct, c5 in zip(pattern_table_cases, pattern_v5_cases):
        label = (f"PATTERN {ct['nh']}x{ct['f']} "
                 f"({pattern.num_real_edges} real edges)")
        time_rows(label, table_time_rows(pattern, ct), into_json=False)
        time_rows(label, v5_time_rows(pattern, c5), into_json=False)

    for name, (cfg, trainer, params, graph) in fits.items():
        opt = torch.optim.Adam(gat.parameters(params), lr=0.0)
        dgen = trainer.dropout_generator()
        routes = [("kernel path", trainer, graph),
                  ("segment path", refs[name], graph)]
        if graph.block_layout is not None:
            routes.insert(1, ("v5 kernel path", trainer,
                              graph.replace(block_layout=None)))
        if name == "PATTERN":
            # without src_order the same model takes the table op (and
            # sorts the senders itself in every backward)
            routes.insert(1, ("table kernel path", trainer,
                              graph.replace(src_order=None)))
        steps = [(label, (lambda tr=tr, gr=gr: tr.train_step(params, opt,
                                                             gr, dgen)))
                 for label, tr, gr in routes]
        times = [step_time_ms(torch, step) for _, step in steps]
        print(f"[time] {name} train step (forward, loss, backward, Adam) on "
              f"{card}: " + ", ".join(f"{label} {t:.4f} ms" for (label, _), t
                                      in zip(steps, times)))
        for i, ((label, step), t) in enumerate(zip(steps, times)):
            profile_steps(torch, step, t, f"{name} {label}",
                          top=12 if i == 0 else 0)

    # -- 6. results ---------------------------------------------------------
    kernels = []
    for k in REPLACES:
        t = timing[k]
        _, by = bound_ms(t["bytes"], t["ops"])
        per = ", ".join(f"{name} {per_epoch[name][k]}" for name in per_epoch)
        print(f"[kernel] {k}: kernel_ms {t['ms']:.4f} plain_ms "
              f"{t['plain_ms']:.4f} library_ms {t['library_ms']} bound_us "
              f"{t['bound_ms'] * 1e3:.3f} (both layer shapes of its path "
              f"summed: v5 and segment_sum_rows Cora's, window Pubmed's, "
              f"table PPI's); launches {launches[k]} over the "
              f"{len(per_epoch)} fits (per epoch: {per})")
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": max(errs[k]), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": by, "library_ms": t["library_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
