#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

Two paths, each at the full width and depth of its configuration on the
synthetic stand-in of its dataset:
  Cora    `cli.train --dataset Cora`: the v5 attention op (kernels
          v5_forward, v5_backward, segment_sum_rows);
  Pubmed  `cli.train --dataset Pubmed --reorder rcm`: RCM reorder, block
          layout, the windowed attention op (kernels window_forward,
          window_backward, and segment_sum_rows again for d(h)).

Phases (every failure is fatal):
  1. build the CUDA kernels from gat_pytorch_tpu_torch/ops/cuda/csrc
     (one nvcc per source, started together) and print the card's name
     and power limit as nvidia-smi gives them;
  2. at each path's layer shapes (Cora 8 heads x 8 features and 1 x 7;
     Pubmed 8 x 8 and 8 x 3) on its graph, run each kernel's wrapper and
     its plain PyTorch version on the same card tensors and hold them
     together: with and without the dropout mask, the backward also at
     eps = 1; the window kernels are also launched twice and must give
     the same bits;
  3. train each stand-in for EPOCHS epochs through the port's Trainer (the
     code the CLI runs), with every launch counter set to 0 just before
     and read just after; the train loss must be finite and fall, every
     kernel of the path must have run, and PATH_TRACE must name the path;
  4. hold the trained model's logits and gradients on the kernel path
     against the plain segment-op path on the card (Pubmed: the windowed
     path against the segment path and against the v5 kernel path on the
     same reordered graph without its block layout);
  5. time each kernel (CUDA graph replays), its plain version and, where
     one PyTorch call computes the same function, that call; time the
     train step on each path and profile a short window of steps;
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

EPOCHS = 50
SHAPES = {"Cora": ((8, 8), (1, 7)),      # (heads, features) per layer
          "Pubmed": ((8, 8), (8, 3))}
DROPOUT = 0.6
SLOPE = 0.01
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
}
SOURCES = {
    "v5_forward": _CSRC + "v5_attention.cu",
    "v5_backward": _CSRC + "v5_attention.cu",
    "segment_sum_rows": _CSRC + "segment_sum.cu",
    "window_forward": _CSRC + "window_attention.cu",
    "window_backward": _CSRC + "window_attention.cu",
}
# launches per epoch of Trainer.fit (2 layers; the forward also runs in
# each epoch's validation pass) on the path that uses the kernel
PER_EPOCH = {
    "Cora": {"v5_forward": 4, "v5_backward": 2, "segment_sum_rows": 2,
             "window_forward": 0, "window_backward": 0},
    "Pubmed": {"v5_forward": 0, "v5_backward": 0, "segment_sum_rows": 2,
               "window_forward": 4, "window_backward": 2},
}
BWD_NAMES = ("d_h_rows", "d_drop", "d_s_dst", "d_a_src")


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
    from gat_pytorch_tpu_torch.ops.cuda import build
    from gat_pytorch_tpu_torch.ops.cuda import segment_sum as ss
    from gat_pytorch_tpu_torch.ops.cuda import v5_attention as v5
    from gat_pytorch_tpu_torch.ops.cuda import window_attention as wa
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

    # -- 2a. the Cora path's kernels against their plain versions ----------
    raw = datasets.load_planetoid("Cora", synthetic_override=True, seed=0)
    cora = loader.transductive_graph(raw).to(dev)
    n, e, e_real = cora.num_nodes, cora.num_edges, cora.num_real_edges
    snd, rcv, order = cora.senders, cora.receivers, cora.src_order
    print(f"[graph] Cora stand-in: {n} nodes (padded), {e} edges "
          f"(padded), {e_real} real")
    cora_cases = []
    for nh, f in SHAPES["Cora"]:
        print(f"[kernels] Cora layer shape {nh}x{f}")
        h, a_src, s_eff, drop, g = op_inputs(torch, gen, n, nh, f, e, dev)
        fwd_args = (h, a_src, s_eff, drop, snd, rcv, e_real, SLOPE)
        got = v5.v5_forward(*fwd_args)
        want = v5.v5_forward_plain(*fwd_args)
        hold_all("v5_forward", ("num", "den", "cap"), got, want,
                 "v5_forward")
        if int(got[3]) != int(want[3]):
            fail(f"argmax code {int(got[3])} != plain {int(want[3])}")
        num, den, cap, _ = want
        out, epsp = epilogue(torch, num, den, cap, f, 1e-8)
        bwd_args = fwd_args + (g, out, den, epsp, True)
        want = v5.v5_backward_plain(*bwd_args)
        hold_all("v5_backward", BWD_NAMES, v5.v5_backward(*bwd_args), want,
                 "v5_backward")
        rows = want[0]
        # At eps = 1e-8, d(s_dst) is about eps' (the softmax's own terms
        # cancel), so the check above cannot see eps' or a d(s_dst) left
        # at zero. At eps = 1, eps' is of the size of den: hold every
        # output there at its own magnitude.
        out1, epsp1 = epilogue(torch, num, den, cap, f, 1.0)
        bwd1 = fwd_args + (g, out1, den, epsp1, True)
        hold_all("v5_backward eps=1", BWD_NAMES, v5.v5_backward(*bwd1),
                 v5.v5_backward_plain(*bwd1), "v5_backward", floor=0.0)
        got = ss.dh_reduce(rows, order, snd, n)
        want = ss.segment_rows_plain(rows, order,
                                      snd.index_select(0, order.long()), n)
        hold_all("segment_sum_rows", ("(d(h) reduce)",), (got,), (want,),
                 "segment_sum_rows")
        cora_cases.append(dict(nh=nh, f=f, fwd_args=fwd_args,
                               bwd_args=bwd_args, rows=rows))

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

    # -- 3. the main paths: train each stand-in ----------------------------
    fits, launches = {}, {k: 0 for k in REPLACES}
    for name, graph, reorder in (("Cora", cora, None),
                                 ("Pubmed", pubmed, "rcm")):
        cfg = get_config(name, num_epochs=EPOCHS, device="cuda",
                         reorder=reorder)
        trainer = Trainer(cfg=cfg.gat_config(), task=make_task(name),
                          learning_rate=cfg.learning_rate,
                          weight_decay=cfg.l2_reg, max_epochs=cfg.num_epochs,
                          patience=cfg.patience, seed=0, device="cuda")
        gat.PATH_TRACE.clear()
        build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        result = trainer.fit(graph)
        torch.cuda.synchronize()
        wall = time.time() - t0
        ran = dict(build.LAUNCHES)
        trace = set(gat.PATH_TRACE)
        hist = result.history
        epochs = len(hist)
        losses = [r["train_loss"] for r in hist]
        print(f"[train] {name}: {epochs} epochs in {wall:.3f} s "
              f"({wall / epochs * 1e3:.3f} ms/epoch incl. val forward and "
              f"the per-epoch metric sync); train_loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; val_acc {hist[-1]['val_acc']:.4f}; "
              f"paths {sorted(trace)}; launches {ran}")
        if not all(math.isfinite(v) for v in losses):
            fail(f"{name}: train loss is not finite")
        if not losses[-1] < losses[0]:
            fail(f"{name}: train loss did not fall")
        if trace != {"v7" if reorder else "v5"} or \
                len(gat.PATH_TRACE) != 4 * epochs:
            fail(f"{name}: layer paths {sorted(trace)} x "
                 f"{len(gat.PATH_TRACE)}")
        for k, per_epoch in PER_EPOCH[name].items():
            if ran[k] != per_epoch * epochs:
                fail(f"{name}: {k}: {ran[k]} launches on the main path, "
                     f"expected {per_epoch * epochs} (2 layers x steps, "
                     f"forward + val forward)")
            launches[k] += ran[k]
        metrics = trainer.evaluate(result.params, [graph])
        print(f"[train] {name}: best epoch {result.best_epoch}, best "
              f"val_loss {result.best_val_loss:.4f}, {metrics}")
        if not all(math.isfinite(v) for v in metrics.values()):
            fail(f"{name}: test metrics are not finite")
        fits[name] = (cfg, trainer, result.final_params)

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
    for name, graph in (("Cora", cora), ("Pubmed", pubmed)):
        cfg, trainer, params = fits[name]
        refs[name] = Trainer(cfg=cfg.gat_config(), task=trainer.task,
                             learning_rate=0.0, device="cuda",
                             backend="segment")
        lk, gk = logits_and_grads(trainer, params, graph)
        if lk.shape != (graph.num_nodes, cfg.num_classes) or \
                not torch.isfinite(lk).all():
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

    ids_sorted = snd.index_select(0, order.long())
    snd_l = snd.long()
    for c in cora_cases:
        nh, f, d = c["nh"], c["f"], c["nh"] * c["f"]
        fa, ba, rows = c["fwd_args"], c["bwd_args"], c["rows"]
        b_fwd = 4 * (n * d + d * nh + n * nh + e * nh + 2 * e
                     + n * d + n * nh + 2)
        b_bwd = 4 * (n * d + d * nh + n * nh + e * nh + 2 * e + 2 * n * d
                     + n * nh + 1 + e * d + e * nh + n * nh + d * nh)
        o_fwd, o_bwd = attention_ops(e_real, d, nh)
        time_rows(f"Cora {nh}x{f}", {
            "v5_forward": (lambda: v5.v5_forward(*fa),
                           lambda: v5.v5_forward_plain(*fa), None,
                           b_fwd, o_fwd),
            "v5_backward": (lambda: v5.v5_backward(*ba),
                            lambda: v5.v5_backward_plain(*ba), None,
                            b_bwd, o_bwd),
            "segment_sum_rows": (
                lambda: ss.dh_reduce(rows, order, snd, n),
                lambda: ss.segment_rows_plain(rows, order, ids_sorted, n),
                lambda: torch.zeros((n, d), device=dev).index_add_(
                    0, snd_l, rows),
                4 * (e * d + 2 * e + n * d), e * d),
        }, into_json=True)
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

    for name, graph in (("Cora", cora), ("Pubmed", pubmed)):
        cfg, trainer, params = fits[name]
        opt = torch.optim.Adam(gat.parameters(params), lr=0.0)
        dgen = trainer.dropout_generator()
        routes = [("kernel path", trainer, graph),
                  ("segment path", refs[name], graph)]
        if graph.block_layout is not None:
            routes.insert(1, ("v5 kernel path", trainer,
                              graph.replace(block_layout=None)))
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
        per_epoch = ", ".join(f"{name} {PER_EPOCH[name][k]}"
                              for name in PER_EPOCH)
        print(f"[kernel] {k}: kernel_ms {t['ms']:.4f} plain_ms "
              f"{t['plain_ms']:.4f} library_ms {t['library_ms']} bound_us "
              f"{t['bound_ms'] * 1e3:.3f} (both layer shapes of its path "
              f"summed; segment_sum_rows: Cora's); launches {launches[k]} "
              f"over both fits (per epoch: {per_epoch})")
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
