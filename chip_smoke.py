#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

Phases (every failure is fatal):
  1. build the CUDA kernels from gat_pytorch_tpu_torch/ops/cuda/csrc
     (one nvcc per source, started together) and print the card's name
     and power limit as nvidia-smi gives them;
  2. at both Cora layer shapes (8 heads x 8 features, 1 head x 7) on the
     Cora stand-in graph, run each kernel's wrapper and its plain PyTorch
     version on the same card tensors and hold them together;
  3. train the Cora stand-in at full width for EPOCHS epochs through the
     port's Trainer (the code the CLI runs), with every launch counter set
     to 0 just before and read just after; the train loss must be finite
     and fall, and every kernel must have run;
  4. hold the trained model's logits and gradients on the kernel path
     against the plain segment-op path on the card;
  5. time each kernel (CUDA graph replays), its plain version and, where one
     PyTorch call computes the same function, that call; time the train
     step; profile a short window of steps;
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
SHAPES = ((8, 8), (1, 7))       # (heads, features) of the two Cora layers
DROPOUT = 0.6
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# kernel vs plain version on the card: sums run in another order
# (per-warp shuffles against matmul / index_add), float32 rounding only
REL_TOL = 1e-4
REPLACES = {
    "v5_forward": "gat_pytorch_tpu/ops/pallas/segment_attention.py:1265",
    "v5_backward": "gat_pytorch_tpu/ops/pallas/segment_attention_bwd.py:537",
    "segment_sum_rows": "gat_pytorch_tpu/ops/pallas/segment_sum.py:120",
}
SOURCES = {
    "v5_forward": "gat_pytorch_tpu_torch/ops/cuda/csrc/v5_attention.cu",
    "v5_backward": "gat_pytorch_tpu_torch/ops/cuda/csrc/v5_attention.cu",
    "segment_sum_rows": "gat_pytorch_tpu_torch/ops/cuda/csrc/segment_sum.cu",
}


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

    # -- 2. each kernel against its plain version --------------------------
    raw = datasets.load_planetoid("Cora", synthetic_override=True, seed=0)
    graph = loader.transductive_graph(raw).to(dev)
    n, e, e_real = graph.num_nodes, graph.num_edges, graph.num_real_edges
    snd, rcv, order = graph.senders, graph.receivers, graph.src_order
    print(f"[graph] Cora stand-in: {n} nodes (padded), {e} edges "
          f"(padded), {e_real} real")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = {k: [] for k in REPLACES}
    cases = []
    for nh, f in SHAPES:
        d = nh * f
        print(f"[kernels] layer shape {nh}x{f}")
        h = torch.randn((n, d), generator=gen, device=dev)
        a_src = torch.randn((d, nh), generator=gen, device=dev) / d ** 0.5
        s_dst = torch.randn((n, nh), generator=gen, device=dev)
        bound = (h @ a_src).max() + s_dst.max()
        s_eff = (s_dst - bound).contiguous()
        drop = ((torch.rand((e, nh), generator=gen, device=dev) >= DROPOUT)
                .float() / (1.0 - DROPOUT))
        fwd_args = (h, a_src, s_eff, drop, snd, rcv, e_real, 0.01)
        got = v5.v5_forward(*fwd_args)
        want = v5.v5_forward_plain(*fwd_args)
        torch.cuda.synchronize()
        for nm, x, y in zip(("num", "den", "cap"), got, want):
            hold(f"v5_forward {nm}", x, y, errs["v5_forward"])
        if int(got[3]) != int(want[3]):
            fail(f"argmax code {int(got[3])} != plain {int(want[3])}")
        num, den, cap, _ = want
        epsp = 1e-8 * torch.exp(0.01 * cap)
        out = num / (den.repeat_interleave(f, dim=1) + epsp)
        g = torch.randn((n, d), generator=gen, device=dev)
        bwd_args = fwd_args + (g, out, den, epsp, True)
        got = v5.v5_backward(*bwd_args)
        want = v5.v5_backward_plain(*bwd_args)
        torch.cuda.synchronize()
        for nm, x, y in zip(("d_h_rows", "d_drop", "d_s_dst", "d_a_src"),
                            got, want):
            hold(f"v5_backward {nm}", x, y, errs["v5_backward"])
        rows = want[0]
        # At eps = 1e-8, d(s_dst) is about eps' (the softmax's own terms
        # cancel), so the check above cannot see eps' or a d(s_dst) left
        # at zero. At eps = 1, eps' is of the size of den: hold every
        # output there at its own magnitude.
        epsp1 = torch.exp(0.01 * cap)
        out1 = num / (den.repeat_interleave(f, dim=1) + epsp1)
        bwd1 = fwd_args + (g, out1, den, epsp1, True)
        got = v5.v5_backward(*bwd1)
        want = v5.v5_backward_plain(*bwd1)
        torch.cuda.synchronize()
        for nm, x, y in zip(("d_h_rows", "d_drop", "d_s_dst", "d_a_src"),
                            got, want):
            hold(f"v5_backward eps=1 {nm}", x, y, errs["v5_backward"],
                 floor=0.0)
        got = ss.dh_reduce(rows, order, snd, n)
        want = ss.segment_rows_plain(rows, order,
                                      snd.index_select(0, order.long()), n)
        torch.cuda.synchronize()
        hold("segment_sum_rows (d(h) reduce)", got, want,
             errs["segment_sum_rows"])
        cases.append(dict(nh=nh, f=f, fwd_args=fwd_args, bwd_args=bwd_args,
                          rows=rows))

    # -- 3. the main path: train the Cora stand-in -------------------------
    cfg = get_config("Cora", num_epochs=EPOCHS, device="cuda")
    trainer = Trainer(cfg=cfg.gat_config(), task=make_task("Cora"),
                      learning_rate=cfg.learning_rate,
                      weight_decay=cfg.l2_reg, max_epochs=cfg.num_epochs,
                      patience=cfg.patience, seed=0, device="cuda")
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    result = trainer.fit(graph)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(build.LAUNCHES)
    hist = result.history
    epochs = len(hist)
    losses = [r["train_loss"] for r in hist]
    print(f"[train] {epochs} epochs in {wall:.3f} s "
          f"({wall / epochs * 1e3:.3f} ms/epoch incl. val forward and the "
          f"per-epoch metric sync); train_loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; val_acc {hist[-1]['val_acc']:.4f}; "
          f"launches {launches}")
    if not all(math.isfinite(v) for v in losses):
        fail("train loss is not finite")
    if not losses[-1] < losses[0]:
        fail("train loss did not fall")
    want_launches = {"v5_forward": 4 * epochs, "v5_backward": 2 * epochs,
                     "segment_sum_rows": 2 * epochs}
    for k, v in want_launches.items():
        if launches[k] != v:
            fail(f"{k}: {launches[k]} launches on the main path, "
                 f"expected {v} (2 layers x steps, forward + val forward)")
    metrics = trainer.evaluate(result.params, [graph])
    print(f"[train] best epoch {result.best_epoch}, best val_loss "
          f"{result.best_val_loss:.4f}, {metrics}")
    if not all(math.isfinite(v) for v in metrics.values()):
        fail("test metrics are not finite")

    # -- 4. kernel path against the plain segment path on the card ----------
    params = result.final_params
    model_cfg = cfg.gat_config()
    ref = Trainer(cfg=model_cfg, task=trainer.task, learning_rate=0.0,
                  device="cuda", backend="segment")
    outs = []
    for tr in (trainer, ref):
        for p in gat.parameters(params):
            p.grad = None
        logits = tr.apply(params, graph)
        tr.task.loss(logits, graph, "train").backward()
        outs.append((logits.detach(),
                     [p.grad.clone() for p in gat.parameters(params)]))
    torch.cuda.synchronize()
    (lk, gk), (ls, gs) = outs
    if lk.shape != (n, cfg.num_classes) or not torch.isfinite(lk).all():
        fail(f"logits of shape {tuple(lk.shape)} or not finite")
    print("[model] kernel path vs segment path on the card")
    model_errs = []
    hold("logits", lk, ls, model_errs)
    for i, (x, y) in enumerate(zip(gk, gs)):
        hold(f"grad param {i}", x, y, model_errs)

    # -- 5. timings ---------------------------------------------------------
    timing = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
                      bytes=0, ops=0) for k in REPLACES}
    for c in cases:
        nh, f, d = c["nh"], c["f"], c["nh"] * c["f"]
        fa, ba, rows = c["fwd_args"], c["bwd_args"], c["rows"]
        # bytes: every input read once, every output written once
        # (float32 and int32 = 4 bytes); ops: this run's real edges
        b_fwd = 4 * (n * d + d * nh + n * nh + e * nh + 2 * e
                     + n * d + n * nh + 2)
        o_fwd = e_real * (2 * d * nh + 2 * d + 4 * nh)
        b_bwd = 4 * (n * d + d * nh + n * nh + e * nh + 2 * e + 2 * n * d
                     + n * nh + 1 + e * d + e * nh + n * nh + d * nh)
        o_bwd = e_real * (6 * d * nh + 4 * d + 10 * nh)
        b_red = 4 * (e * d + 2 * e + n * d)
        o_red = e * d
        ids_sorted = snd.index_select(0, order.long())
        snd_l = snd.long()
        row = {
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
                b_red, o_red),
        }
        for k, (kern, plain, lib, nbytes, ops) in row.items():
            t = timing[k]
            km, pm = time_ms(torch, kern), time_ms(torch, plain)
            lm = time_ms(torch, lib) if lib is not None else None
            bm, by = bound_ms(nbytes, ops)
            t["ms"] += km
            t["plain_ms"] += pm
            t["bound_ms"] += bm
            t["bytes"] += nbytes
            t["ops"] += ops
            if lm is not None:
                t["library_ms"] = (t["library_ms"] or 0.0) + lm
            print(f"[time] {k} {nh}x{f}: kernel_ms {km:.4f} plain_ms "
                  f"{pm:.4f} library_ms "
                  f"{'null' if lm is None else f'{lm:.4f}'} bound_us "
                  f"{bm * 1e3:.3f} ({by})")
    opt = torch.optim.Adam(gat.parameters(params), lr=0.0)
    dgen = trainer.dropout_generator()
    step_ms = step_time_ms(torch, lambda: trainer.train_step(params, opt,
                                                             graph, dgen))
    plain_step_ms = step_time_ms(torch, lambda: ref.train_step(
        params, opt, graph, dgen))
    print(f"[time] Cora train step (forward, loss, backward, Adam): "
          f"kernel path {step_ms:.4f} ms, segment path {plain_step_ms:.4f} "
          f"ms on {card}")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            trainer.train_step(params, opt, graph, dgen)
        torch.cuda.synchronize()
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA
              and not ev.is_user_annotation]
    dev_us = sum(ev.self_device_time_total for ev in events)
    print(f"[profile] 20 train steps: kernels busy {dev_us / 20:.1f} "
          f"us/step of {step_ms * 1e3:.1f} us/step (device idle "
          f"{1 - dev_us / 20 / (step_ms * 1e3):.3f}); top kernels:")
    for ev in sorted(events, key=lambda ev: -ev.self_device_time_total)[:12]:
        print(f"  {ev.self_device_time_total / 20:9.1f} us/step "
              f"{ev.count / 20:5.1f}/step  {ev.key[:90]}")
    host = [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CPU]
    print("[profile] top host operations by self CPU time (under the "
          "profiler, which slows the host):")
    for ev in sorted(host, key=lambda ev: -ev.self_cpu_time_total)[:12]:
        print(f"  {ev.self_cpu_time_total / 20:9.1f} us/step "
              f"{ev.count / 20:5.1f}/step  {ev.key[:90]}")

    # -- 6. results ---------------------------------------------------------
    kernels = []
    for k in REPLACES:
        t = timing[k]
        _, by = bound_ms(t["bytes"], t["ops"])
        per_step = want_launches[k] // epochs
        print(f"[kernel] {k}: kernel_ms {t['ms']:.4f} plain_ms "
              f"{t['plain_ms']:.4f} library_ms {t['library_ms']} "
              f"launches_per_step {per_step} bound_us "
              f"{t['bound_ms'] * 1e3:.3f} (both layer shapes summed)")
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
