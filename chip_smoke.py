#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

    python3 chip_smoke.py --checks-only    (phases 1-2, then stop)

Six paths, each at the full width and depth of its configuration on the
synthetic stand-in of its dataset:
  Cora    `cli.train --dataset Cora`: the v5 attention op (kernels
          v5_forward, v5_backward, segment_sum_rows);
  Pubmed  `cli.train --dataset Pubmed --reorder rcm`: RCM reorder, block
          layout, the windowed attention op (kernels window_forward,
          window_backward, and segment_sum_rows again for d(h));
  Pubmed cluster  `cli.train --dataset Pubmed --reorder cluster`: cluster
          order, the hybrid split-locality layout, the windowed parts op
          over the in-window edges plus the v5 parts op over the
          remainder (kernels window_forward, v5_forward,
          window_backward_parts, v5_backward_parts, segment_sum_rows
          twice);
  PPI paper_faithful  `cli.train --dataset PPI --paper_faithful`:
          block-diagonal batches of two graphs, the table op (kernels
          table_forward, table_backward, segment_sum_rows) at 1024- and
          726-wide rows, its logits' two score gathers reduced in the
          backward by segment_sum_sorted;
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
     also launched twice and must give the same bits. The parts modes of
     the v5 and window backward take random d(num) and d(den), are held
     at every output's own magnitude and launched twice, at all these
     shapes and on the hybrid layout of the cluster-ordered Pubmed
     stand-in and its remainder (the parts forwards there too, and the
     v5 parts op with more source rows than destinations); the sorted
     segment sum at widths 4 and 6 (PPI, by receiver and by sender) and
     8, 24, 64, 1024 (Pubmed), and the sorted-gradient gather built on it;
  3. train each stand-in for the epochs of CELLS through the port's
     Trainer (the code the CLI runs), with every launch counter set to 0
     just before and read just after; the train loss must be finite and
     fall, every kernel of the path must have run the expected number of
     times, and PATH_TRACE must name the path;
  4. hold the trained model's logits and gradients on the kernel path
     against the plain segment-op path on the card (Pubmed: the windowed
     path also against the v5 kernel path on the same reordered graph
     without its block layout);
     then two PPI paper_faithful fits and two hybrid Pubmed fits of a
     few epochs, each pair from one seed, must give the same bits in
     every epoch's losses and in every parameter;
  5. time each kernel (CUDA graph replays), its plain version and, where
     one PyTorch call computes the same function, that call; time the
     train step on each path and profile a short window of steps; time
     the table op against the v5 op on one PATTERN batch, and the hybrid
     step with its remainder through plain segment ops;
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
import types

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
    "Pubmed cluster": ("Pubmed", {"reorder": "cluster"}, 50, "v7_hybrid", 2),
    "PPI paper_faithful": ("PPI", {"paper_faithful": True}, 30, "v4_table",
                           3),
    "PPI": ("PPI", {}, 10, "v5", 3),
    "PATTERN": ("PATTERN", {}, 5, "v5", 4),
}
# per path: the kernels of a layer's forward, and of its backward (each
# launched once per layer unless a count says otherwise). The table path's
# two sorted sums are the gradients of its logits' score gathers (by
# sender and by receiver), which every model on that path here has.
PATH_KERNELS = {
    "v5": (("v5_forward",), {"v5_backward": 1, "segment_sum_rows": 1}),
    "v7": (("window_forward",),
           {"window_backward": 1, "segment_sum_rows": 1}),
    "v4_table": (("table_forward",),
                 {"table_backward": 1, "segment_sum_rows": 1,
                  "segment_sum_sorted": 2}),
    "v7_hybrid": (("window_forward", "v5_forward"),
                  {"window_backward_parts": 1, "v5_backward_parts": 1,
                   "segment_sum_rows": 2}),
}
REPRO_EPOCHS = {"PPI paper_faithful": 2, "Pubmed cluster": 5}
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
    # the same TPU kernels in their normalize=False (sweep-1 parts) mode
    "v5_backward_parts": _PALLAS + "segment_attention_bwd.py:537",
    "window_backward_parts": _PALLAS + "segment_attention_window.py:923",
    "segment_sum_sorted": _PALLAS + "segment_sum.py:30",
}
SOURCES = {
    "v5_forward": _CSRC + "v5_attention.cu",
    "v5_backward": _CSRC + "v5_attention.cu",
    "segment_sum_rows": _CSRC + "segment_sum.cu",
    "window_forward": _CSRC + "window_attention.cu",
    "window_backward": _CSRC + "window_attention.cu",
    "table_forward": _CSRC + "table_attention.cu",
    "table_backward": _CSRC + "table_attention.cu",
    "v5_backward_parts": _CSRC + "v5_attention.cu",
    "window_backward_parts": _CSRC + "window_attention.cu",
    "segment_sum_sorted": _CSRC + "segment_sum.cu",
}
BWD_NAMES = ("d_h_rows", "d_drop", "d_s_dst", "d_a_src")
TABLE_BWD_NAMES = ("d_h_rows", "d_logits", "d_drop")


def launches_per_epoch(path, layers, train_batches, val_batches):
    """Launches per epoch of a fit on `path`: each layer's forward runs
    in every train step and in every validation batch, its backward
    kernels in every train step."""
    fwd, bwd = PATH_KERNELS[path]
    per = {k: 0 for k in REPLACES}
    for k in fwd:
        per[k] = layers * (train_batches + val_batches)
    for k, count in bwd.items():
        per[k] = count * layers * train_batches
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
        # the parts mode: raw cotangents of num and den, no eps in it,
        # every output at its own magnitude
        d_den = torch.randn((n, nh), generator=gen, device=dev)
        parts_args = fwd_args + (g, None, d_den, None, with_drop)
        got = v5.v5_backward(*parts_args, normalize=False)
        want = v5.v5_backward_plain(*parts_args, normalize=False)
        hold_all("v5_backward_parts", names, [got[i] for i in keep],
                 [want[i] for i in keep], "v5_backward_parts", floor=0.0)
        same_bits("v5_backward_parts", got,
                  v5.v5_backward(*parts_args, normalize=False))
        got = ss.dh_reduce(rows, order, snd, n, e_real)
        want = ss.segment_rows_plain(rows, order,
                                      snd.index_select(0, order.long()), n)
        hold_all("segment_sum_rows", ("(d(h) reduce)",), (got,), (want,),
                 "segment_sum_rows")
        return dict(nh=nh, f=f, drop=with_drop, fwd_args=fwd_args,
                    bwd_args=bwd_args, parts_args=parts_args, rows=rows)

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

    def check_window(bl, n_, shapes, label):
        """The window kernels (both backward modes) and the reduce by
        offsets at each layer shape on the layout `bl` over n_ nodes;
        returns the inputs for the timings."""
        e7 = bl.num_slots
        real = (bl.recv >= 0).nonzero().squeeze(1)
        src_ids = bl.send[bl.src_perm.long()]      # ascending sender ids
        cases = []
        for nh, f in shapes:
            print(f"[kernels] {label} layer shape {nh}x{f}")
            h, a_src, s_eff, drop, g = op_inputs(torch, gen, n_, nh, f, e7,
                                                 dev)
            d_den = torch.randn((n_, nh), generator=gen, device=dev)
            for tag, mask in (("", drop), (" no dropout", None)):
                fwd_args = (h, a_src, s_eff, mask, bl, SLOPE)
                got = wa.window_forward(*fwd_args)
                want = wa.window_forward_plain(*fwd_args)
                hold_all("window_forward" + tag, ("num", "den", "cap"), got,
                         want, "window_forward")
                if int(got[3]) != int(want[3]):
                    fail(f"argmax code {int(got[3])} != plain "
                         f"{int(want[3])}")
                same_bits("window_forward" + tag, got,
                          wa.window_forward(*fwd_args))
                num, den, cap, _ = want
                need = mask is not None

                def backward_mode(name, key, floor, norm, cotangents):
                    """One backward mode against its plain version, twice;
                    returns (its arguments, the plain d(h) rows)."""
                    bwd_args = fwd_args + cotangents + (need,)
                    got = list(wa.window_backward(*bwd_args,
                                                  normalize=norm))
                    want = list(wa.window_backward_plain(*bwd_args,
                                                         normalize=norm))
                    rows = want[0]
                    # the kernel leaves the d(h) rows of pad slots unwritten
                    got[0], want[0] = got[0][real], rows[real]
                    again = list(wa.window_backward(*bwd_args,
                                                    normalize=norm))
                    again[0] = again[0][real]
                    same_bits(name, got, again)
                    keep = [i for i in range(4) if want[i] is not None]
                    hold_all(name, [BWD_NAMES[i] for i in keep],
                             [got[i] for i in keep], [want[i] for i in keep],
                             key, floor)
                    return bwd_args, rows

                for eps, floor in ((1e-8, 1.0), (1.0, 0.0)):
                    out, epsp = epilogue(torch, num, den, cap, f, eps)
                    bwd_args, rows = backward_mode(
                        f"window_backward{tag} eps={eps:g}",
                        "window_backward", floor, True, (g, out, den, epsp))
                    if mask is not None and eps == 1e-8:
                        got = ss.dh_reduce_ptr(rows, bl.src_perm, bl.src_ptr)
                        want = ss.segment_rows_plain(rows, bl.src_perm,
                                                     src_ids, n_)
                        hold_all("segment_sum_rows",
                                 ("(d(h) reduce by ptr)",), (got,), (want,),
                                 "segment_sum_rows")
                        cases.append(dict(nh=nh, f=f, fwd_args=fwd_args,
                                          bwd_args=bwd_args, rows=rows))
                # the parts mode: raw cotangents of num and den, no eps in
                # it, every output at its own magnitude
                parts_args, _ = backward_mode(
                    f"window_backward_parts{tag}", "window_backward_parts",
                    0.0, False, (g, None, d_den, None))
                if mask is not None:
                    cases[-1]["parts_args"] = parts_args
        return cases

    pubmed_cases = check_window(bl, np_, SHAPES["Pubmed"], "Pubmed")
    real = (bl.recv >= 0).nonzero().squeeze(1)
    src_ids = bl.send[bl.src_perm.long()]

    # -- 2b'. the hybrid layout of the cluster-ordered Pubmed stand-in ------
    t0 = time.time()
    hybrid_cpu = loader.transductive_graph(raw, reorder="cluster",
                                           src_windows=True, hybrid=True)
    host_s = time.time() - t0
    hybrid = hybrid_cpu.to(dev)
    hb = hybrid.block_layout
    if hb.rem_send is None or hb.rem_e <= 0:
        fail("the cluster-ordered Pubmed stand-in got a plain layout: no "
             "remainder, so no hybrid path to drive")
    if hb.num_real + hb.rem_e != hybrid.num_real_edges:
        fail(f"{hb.num_real} local + {hb.rem_e} remainder edges, the graph "
             f"has {hybrid.num_real_edges}")
    rem_pad = int(hb.rem_send.shape[0])
    print(f"[graph] Pubmed stand-in, cluster order, hybrid layout "
          f"({host_s:.2f} s on the host for label propagation, reorder and "
          f"layout): {hybrid.num_nodes} nodes (padded), "
          f"{hybrid.num_real_edges} real edges: {hb.num_real} in "
          f"{hb.num_slots} layout slots (local fraction "
          f"{hb.num_real / hybrid.num_real_edges:.4f}; nb {hb.nb}, eb "
          f"{hb.eb}, wb {hb.wb}, window {hb.window}, dmax {hb.dmax}), "
          f"rem_e {hb.rem_e} remainder edges padded to {rem_pad}")
    hybrid_cases = check_window(hb, hybrid.num_nodes, SHAPES["Pubmed"],
                                "Pubmed hybrid layout (in-window edges)")
    # the remainder as the v5 kernels see it: a dst-sorted edge list
    remainder = types.SimpleNamespace(
        num_nodes=hybrid.num_nodes, num_edges=rem_pad,
        num_real_edges=hb.rem_e, senders=hb.rem_send, receivers=hb.rem_recv,
        src_order=hb.rem_order)
    rem_cases = []
    for nh, f in SHAPES["Pubmed"]:
        print(f"[kernels] Pubmed hybrid remainder layer shape {nh}x{f}")
        rem_cases.append(check_v5(remainder, nh, f, with_drop=True))
    # the layout's own offsets give the bits of the per-call ones, and the
    # parts op takes an h table with more rows than destinations: 256 rows
    # put in front of the table and every sender moved up by 256
    c = rem_cases[0]
    h, a_src, s_eff, drop = c["fwd_args"][:4]
    nh, f, n_ = c["nh"], c["f"], hybrid.num_nodes
    same_bits("v5_forward with the layout's offsets",
              v5.v5_forward(*c["fwd_args"]),
              v5.v5_forward(*c["fwd_args"], hb.rem_dst_ptr))
    w_num = torch.randn((n_, nh * f), generator=gen, device=dev)
    w_den = torch.randn((n_, nh), generator=gen, device=dev)
    shift = 256
    h_wide = torch.cat([torch.zeros((shift, nh * f), device=dev), h])
    send_wide = hb.rem_send + shift
    order_wide = torch.argsort(send_wide[:hb.rem_e].long(), stable=True
                               ).to(torch.int32)

    def parts_grads(table, senders, order, n_src, **ptrs):
        leaves = [t.clone().requires_grad_(True)
                  for t in (table, a_src, s_eff)]
        num, den, cap, code = v5.v5_sweep1_parts(
            *leaves, drop, senders, hb.rem_recv, order, hb.rem_e, n_, nh, f,
            1e-8, SLOPE, n_src, **ptrs)
        ((num * w_num).sum() + (den * w_den).sum() + 2.0 * cap).backward()
        return [num.detach(), den.detach(), cap.detach(), code] + [
            t.grad for t in leaves]

    narrow = parts_grads(h, hb.rem_send, hb.rem_order, None,
                         dst_ptr=hb.rem_dst_ptr, src_ptr=hb.rem_src_ptr)
    wide = parts_grads(h_wide, send_wide, order_wide, n_ + shift)
    if wide[4].shape[0] != n_ + shift or bool(wide[4][:shift].any()):
        fail("v5_sweep1_parts: d(h) of a wider source table has the wrong "
             "rows")
    wide[4] = wide[4][shift:]
    same_bits("v5_sweep1_parts with more source rows than destinations",
              narrow, wide)
    print(f"[kernels] v5_sweep1_parts on the remainder with {n_ + shift} "
          f"source rows for {n_} destinations: the bits of the square call")

    # -- 2b''. the sorted segment sum and the gather built on it ------------
    def check_sorted_sum(label, ids, n_, widths):
        """segment_sum_sorted on the ascending ids at each width against
        its plain version; returns {width: (values, ids)}."""
        cases = {}
        for d in widths:
            vals = torch.randn((ids.shape[0], d), generator=gen, device=dev)
            got = ss.segment_sum_sorted(vals, ids, n_)
            want = ss.segment_sum_sorted_plain(vals, ids, n_)
            hold_all(f"segment_sum_sorted {label} D={d}", ("out",), (got,),
                     (want,), "segment_sum_sorted", floor=0.0)
            same_bits(f"segment_sum_sorted {label} D={d}", (got,),
                      (ss.segment_sum_sorted(vals, ids, n_),))
            cases[d] = (vals, ids)
        return cases

    sorted_cases = {}
    hybrid_send_sorted = hybrid.senders[hybrid.src_order.long()]
    print("[kernels] sorted segment sum on the cluster-ordered Pubmed "
          "stand-in's edge list, by receiver and by sorted sender")
    sorted_cases["Pubmed by receiver"] = check_sorted_sum(
        "Pubmed by receiver", hybrid.receivers, hybrid.num_nodes,
        (8, 24, 64, 1024))
    check_sorted_sum("Pubmed by sender", hybrid_send_sorted,
                     hybrid.num_nodes, (1, 8, 33))

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
    # the sorted segment sum where the main path launches it: the
    # gradients of the table path's two score gathers, (E, nh) rows summed
    # by receiver and, through src_order, by sender
    print("[kernels] sorted segment sum at the PPI score widths, and the "
          "sorted-gradient gather")
    ppi_heads = tuple(nh for nh, _ in SHAPES["PPI"])
    ppi_order = ppi.src_order.long()
    sorted_cases["PPI by receiver"] = check_sorted_sum(
        "PPI by receiver", ppi.receivers, ppi.num_nodes, ppi_heads)
    sorted_cases["PPI by sender"] = check_sorted_sum(
        "PPI by sender", ppi.senders[ppi_order], ppi.num_nodes, ppi_heads)
    table = torch.randn((ppi.num_nodes, ppi_heads[0]), generator=gen,
                        device=dev)
    weight = torch.randn((ppi.num_edges, ppi_heads[0]), generator=gen,
                         device=dev)

    def gather_grad(fn):
        t = table.clone().requires_grad_(True)
        (fn(t) * weight).sum().backward()
        return t.grad

    for label, sorted_fn, plain_fn in (
            ("by sender", lambda t: seg.gather_rows_sorted_grad(
                t, ppi.senders, ppi.num_nodes, ppi.src_order),
             lambda t: seg.gather_rows(t, ppi.senders)),
            ("by receiver", lambda t: seg.gather_rows_sorted_grad(
                t, ppi.receivers, ppi.num_nodes),
             lambda t: seg.gather_rows(t, ppi.receivers))):
        got = gather_grad(sorted_fn)
        hold_all(f"gather_rows_sorted_grad {label}", ("d(table)",), (got,),
                 (gather_grad(plain_fn),), "segment_sum_sorted", floor=0.0)
        same_bits(f"gather_rows_sorted_grad {label}", (got,),
                  (gather_grad(sorted_fn),))
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

    if "--checks-only" in sys.argv[1:]:
        print("chip_smoke: --checks-only: every kernel built and held "
              "against its plain version; no fit, no timing, no result line")
        return 0

    # -- 3. the main paths: train each stand-in ----------------------------
    def cell_data(dataset, cfg):
        """(train batches, validation batches, reshuffle) as cli.train
        builds them."""
        if dataset == "Cora":
            return [cora], [cora], None
        if dataset == "Pubmed":
            graph = hybrid if cfg.reorder == "cluster" else pubmed
            return [graph], [graph], None
        train, val, _ = inductive[dataset]
        batcher = loader.InductiveBatcher(train, cfg.batch_size, seed=0)
        val_data = loader.InductiveBatcher(val, cfg.batch_size,
                                           shuffle=False).epoch()
        return batcher.epoch(0), val_data, batcher.epoch

    def make_trainer(dataset, overrides, max_epochs):
        """(config, trainer, train batches, validation batches, reshuffle)
        of one fit from seed 0, as cli.train sets it up."""
        cfg = get_config(dataset, num_epochs=max_epochs, device="cuda",
                         **overrides)
        plateau = (O.ReduceLROnPlateau(factor=0.5, patience=5, min_lr=1e-6)
                   if dataset == "PATTERN" else None)
        trainer = Trainer(cfg=cfg.gat_config(), task=make_task(dataset),
                          learning_rate=cfg.learning_rate,
                          weight_decay=cfg.l2_reg, max_epochs=cfg.num_epochs,
                          patience=cfg.patience, plateau=plateau, seed=0,
                          device="cuda")
        return (cfg, trainer) + cell_data(dataset, cfg)

    fits, launches, per_epoch = {}, {k: 0 for k in REPLACES}, {}
    for name, (dataset, overrides, max_epochs, path, layers) in CELLS.items():
        cfg, trainer, train_data, val_data, reshuffle = make_trainer(
            dataset, overrides, max_epochs)
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

    # -- 4b. run-to-run reproducibility ------------------------------------
    # The port's kernels sum in fixed orders and the kernel path's gathers
    # reduce their gradients through segment_sum_sorted, so two fits from
    # one seed must agree bit for bit: every epoch's losses and metrics,
    # every parameter.
    def one_step_report(name, dataset, overrides):
        """Where two fits differ: the gradients of one step, twice, from
        the same parameters and the same generator state."""
        _, trainer, train_data, _, _ = make_trainer(dataset, overrides, 1)
        params, graph = trainer.init_params(), train_data[0].to(dev)
        runs = []
        for _ in range(2):
            for q in gat.parameters(params):
                q.grad = None
            logits = trainer.apply(params, graph, training=True,
                                   generator=trainer.dropout_generator())
            trainer.task.loss(logits, graph, "train").backward()
            torch.cuda.synchronize()
            runs.append([logits.detach()] + [q.grad.clone() for q in
                                             gat.parameters(params)])
        for i, (x, y) in enumerate(zip(*runs)):
            what = "logits" if i == 0 else f"grad param {i - 1}"
            print(f"[repro] {name}: one step twice: {what} "
                  f"{'equal bits' if torch.equal(x, y) else 'DIFFER'} "
                  f"(max abs diff {float((x - y).abs().max()):.3e})")

    for name, epochs in REPRO_EPOCHS.items():
        dataset, overrides = CELLS[name][:2]
        runs = []
        for _ in range(2):
            _, trainer, train_data, val_data, reshuffle = make_trainer(
                dataset, overrides, epochs)
            result = trainer.fit_epochs(train_data, val_data,
                                        reshuffle=reshuffle)
            torch.cuda.synchronize()
            runs.append((result.history,
                         gat.parameters(result.final_params)))
        (hist_a, par_a), (hist_b, par_b) = runs
        same_hist = hist_a == hist_b
        same_par = all(torch.equal(x, y) for x, y in zip(par_a, par_b))
        print(f"[repro] {name}: two fits of {epochs} epochs from seed 0: "
              f"histories {'equal' if same_hist else 'DIFFER'}, parameters "
              f"{'equal bits' if same_par else 'DIFFER'}; train_loss "
              f"{[r['train_loss'] for r in hist_a]}")
        if not (same_hist and same_par):
            one_step_report(name, dataset, overrides)
            fail(f"{name}: two fits from one seed differ")

    # -- 5. timings ---------------------------------------------------------
    timing = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
                      bytes=0, ops=0) for k in REPLACES}

    def time_rows(label, rows, into_json):
        """Time each row's kernel, plain version and library call;
        into_json: True, False, or the names whose times the result line
        reports from this call."""
        for k, (kern, plain, lib, nbytes, ops) in rows.items():
            km, pm = time_ms(torch, kern), time_ms(torch, plain)
            lm = time_ms(torch, lib) if lib is not None else None
            bm, by = bound_ms(nbytes, ops)
            print(f"[time] {k} {label}: kernel_ms {km:.4f} plain_ms "
                  f"{pm:.4f} library_ms "
                  f"{'null' if lm is None else f'{lm:.4f}'} bound_us "
                  f"{bm * 1e3:.3f} ({by})")
            if into_json is not True and (not into_json
                                          or k not in into_json):
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
        # the parts mode reads d(num) and d(den) in place of g, out, den, eps'
        b_parts = b_bwd - 4 * (n_ * d + 1)
        pa = c["parts_args"]
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
            "v5_backward_parts": (
                lambda: v5.v5_backward(*pa, normalize=False),
                lambda: v5.v5_backward_plain(*pa, normalize=False), None,
                b_parts, o_bwd),
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

    V5_JSON = ("v5_forward", "v5_backward", "segment_sum_rows")
    for c in cora_cases:
        time_rows(f"Cora {c['nh']}x{c['f']}", v5_time_rows(cora, c),
                  into_json=V5_JSON)

    def window_time_rows(layout, n_, c):
        """The window kernels at one case of check_window. Inputs h,
        a_src, s_dst, drop, send, dst_perm, dst_ptr; the backward also g,
        out, den, eps' (parts mode: d(num), d(den)) and writes the real
        slots' rows."""
        nh, d = c["nh"], c["nh"] * c["f"]
        fa, ba, pa = c["fwd_args"], c["bwd_args"], c["parts_args"]
        slots, slots_real = layout.num_slots, layout.num_real
        b_in = n_ * d + d * nh + n_ * nh + slots * nh + 2 * slots + n_ + 1
        b_fwd = 4 * (b_in + n_ * d + n_ * nh + 2)
        b_bwd = 4 * (b_in + 2 * n_ * d + n_ * nh + 1 + slots_real * d
                     + slots * nh + n_ * nh + d * nh)
        o_fwd, o_bwd = attention_ops(slots_real, d, nh)
        return {
            "window_forward": (lambda: wa.window_forward(*fa),
                               lambda: wa.window_forward_plain(*fa), None,
                               b_fwd, o_fwd),
            "window_backward": (lambda: wa.window_backward(*ba),
                                lambda: wa.window_backward_plain(*ba), None,
                                b_bwd, o_bwd),
            "window_backward_parts": (
                lambda: wa.window_backward(*pa, normalize=False),
                lambda: wa.window_backward_plain(*pa, normalize=False), None,
                b_bwd - 4 * (n_ * d + 1), o_bwd),
        }

    send_real = bl.send[real].long()
    plain = loader.transductive_graph(raw).to(dev)   # Pubmed, not reordered
    drop5 = ((torch.rand((plain.num_edges, 8), generator=gen, device=dev)
              >= DROPOUT).float() / (1.0 - DROPOUT))
    for c in pubmed_cases:
        nh, f, d = c["nh"], c["f"], c["nh"] * c["f"]
        fa, ba, rows = c["fwd_args"], c["bwd_args"], c["rows"]
        rows_real = rows[real]
        time_rows(f"Pubmed {nh}x{f}", window_time_rows(bl, np_, c),
                  into_json=("window_forward", "window_backward"))
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
    # the hybrid cell: the window kernels over the in-window slots and the
    # v5 kernels over the remainder; the result line takes the two parts
    # backward modes from here, where the main path launches them
    for cw, c5 in zip(hybrid_cases, rem_cases):
        label = f"Pubmed hybrid {cw['nh']}x{cw['f']}"
        time_rows(f"{label}, {hb.num_real} in-window edges",
                  window_time_rows(hb, hybrid.num_nodes, cw),
                  into_json=("window_backward_parts",))
        time_rows(f"{label}, {hb.rem_e} remainder edges",
                  v5_time_rows(remainder, c5),
                  into_json=("v5_backward_parts",))

    def sorted_time_rows(vals, ids, n_):
        """The sorted segment sum on one case of check_sorted_sum: values
        and ids read once, the table written once; one add per value."""
        e_, d = vals.shape
        ids_l = ids.long()
        return {"segment_sum_sorted": (
            lambda: ss.segment_sum_sorted(vals, ids, n_),
            lambda: ss.segment_sum_sorted_plain(vals, ids, n_),
            lambda: torch.zeros((n_, d), device=dev).index_add_(
                0, ids_l, vals),
            4 * (e_ * d + e_ + n_ * d), e_ * d)}

    # the result line: the score widths of the PPI paper_faithful fit, by
    # receiver (the sum by sender runs the same kernel on permuted rows)
    for label, cases in sorted_cases.items():
        n_ = ppi.num_nodes if label.startswith("PPI") else hybrid.num_nodes
        for d, (vals, ids) in cases.items():
            time_rows(f"{label} D={d} ({ids.shape[0]} rows, {n_} segments)",
                      sorted_time_rows(vals, ids, n_),
                      into_json=label == "PPI by receiver")
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

    def remainder_by_segment_ops(h, a_src, s_eff, drop, send, recv, order,
                                 e_real, n_, nh, f, eps=1e-8, slope=SLOPE,
                                 num_src_nodes=None, **_):
        """The parts of v5_sweep1_parts from plain segment ops under
        autograd, as the JAX package computes a small remainder. Timing
        only: no path of the package."""
        e_ = send.shape[0]
        mask = (torch.arange(e_, device=h.device) < e_real)[:, None]
        raw_ = seg.gather_rows(h @ a_src, send) + seg.gather_rows(s_eff, recv)
        ex = torch.where(mask, torch.exp(slope * raw_),
                         torch.zeros_like(raw_))
        w = ex if drop is None else ex * drop
        rows = seg.gather_rows(h, send).view(e_, nh, f) * w[:, :, None]
        cap = torch.where(mask, raw_,
                          torch.full_like(raw_, float("-inf"))).max()
        return (seg.segment_sum(rows.reshape(e_, nh * f), recv, n_),
                seg.segment_sum(ex, recv, n_), cap, None)

    def with_segment_remainder(step):
        def run():
            kernel_parts = v5.v5_sweep1_parts
            v5.v5_sweep1_parts = remainder_by_segment_ops
            try:
                return step()
            finally:
                v5.v5_sweep1_parts = kernel_parts
        return run

    for name, (cfg, trainer, params, graph) in fits.items():
        opt = torch.optim.Adam(gat.parameters(params), lr=0.0)
        dgen = trainer.dropout_generator()
        routes = [("kernel path", trainer, graph),
                  ("segment path", refs[name], graph)]
        if graph.block_layout is not None:
            routes.insert(1, ("v5 kernel path", trainer,
                              graph.replace(block_layout=None)))
        if name == "Pubmed cluster":
            # the same model on the RCM-ordered graph takes the windowed op
            routes.insert(1, ("v7 kernel path on the RCM-ordered graph",
                              trainer, pubmed))
        if name == "PATTERN":
            # without src_order the same model takes the table op (and
            # sorts the senders itself in every backward)
            routes.insert(1, ("table kernel path", trainer,
                              graph.replace(src_order=None)))
        steps = [(label, (lambda tr=tr, gr=gr: tr.train_step(params, opt,
                                                             gr, dgen)))
                 for label, tr, gr in routes]
        if name == "Pubmed cluster":
            # what a gate on the remainder's size would be decided on
            steps.insert(1, ("hybrid with the remainder through plain "
                             "segment ops (timing only)",
                             with_segment_remainder(steps[0][1])))
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
              f"table PPI's, the parts modes the hybrid Pubmed layout's and "
              f"its remainder's, segment_sum_sorted PPI's score widths by "
              f"receiver); launches {launches[k]} over the "
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
