"""One run of one cell: set-up, the measured window, the traced steps, the
correctness check against the plain reference, and the result line.

The entry the window drives is the port's training step,
`Trainer.train_step` (forward with dropout, the task's loss, backward, the
Adam step with L2), full batch, with the configuration's backend. Set-up,
as `Trainer.fit_epochs` sets a fit up: the port's GATConfig takes its
arguments from the configuration's model form (portbench/forms), the
cell's graph is built by the port (`canonicalize`, in the graph's own
order) and moved to the device, the benchmark's weights for the seed, in
the form's layout, are handed to the port, the
optimiser and the dropout generator are made from the seed. The same
objects then take the first steps, whose readout the reference checks
after the window, then run the window: steps back to back, nothing
synchronised between steps, a CUDA event recorded at each step's start,
and a synchronise at the window's end. A traced run then profiles
`trace_steps` more steps.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import statistics
import sys
import time
from typing import Dict, List, Tuple

import torch
from torch.profiler import record_function

from portbench import check, counts, inputs, trace
from portbench import traffic as traffic_mod
from portbench.spec import Cell, load_module

FIRST_STEPS = 3            # the steps the reference follows
PROFILER_WARM_STEPS = 2    # profiled before the traced window opens
FORBIDDEN = ("jax", "jaxlib", "flax", "gat_pytorch_tpu")
GIB = 2.0 ** 30


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's (compared whole: the port's name only begins with
    the JAX package's)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Program:
    """The training step's objects, built once in set-up and handed to
    the window."""
    trainer: object
    params: dict
    opt: torch.optim.Optimizer
    generator: torch.Generator
    graph: object                 # the port's Graph, on the device
    real_edges: int               # self-loops in
    real_nodes: int
    device: torch.device

    def step(self):
        return self.trainer.train_step(self.params, self.opt, self.graph,
                                       self.generator)


def _set_knobs(config: dict) -> None:
    """The port reads its precision and path knobs from the environment
    when it runs; the configuration states each."""
    for key, value in config.get("knobs", {}).items():
        os.environ[key] = str(value)


def port_graph(data: traffic_mod.HostGraph):
    """The cell's graph as the port builds it (a CPU Graph)."""
    from gat_pytorch_tpu_torch.graph import transforms as T
    return T.canonicalize(
        data.x, data.senders, data.receivers, y=data.y,
        train_mask=data.train_mask, val_mask=data.val_mask,
        test_mask=data.test_mask)


def build_program(cell: Cell, data: traffic_mod.HostGraph, seed: int,
                  device: torch.device, phase=lambda name: None) -> Program:
    """The port's training step for the cell; `phase(name)` is called as
    each part of the set-up ends."""
    from gat_pytorch_tpu_torch.models import gat
    from gat_pytorch_tpu_torch.train import optim, tasks
    from gat_pytorch_tpu_torch.train.trainer import Trainer
    phase("import")
    cfg = cell.config
    _set_knobs(cfg)
    gcfg = gat.GATConfig(**cell.form().port_args(cfg))
    task = {"planetoid": tasks.planetoid_task}[cfg["task"]]()
    trainer = Trainer(cfg=gcfg, task=task,
                      learning_rate=float(cfg["learning_rate"]),
                      weight_decay=float(cfg["l2_reg"]), device=str(device),
                      backend=cfg.get("path", {}).get("backend", "kernel"))
    graph = port_graph(data)
    phase("graphs")
    graph = graph.to(device)
    phase("to_device")
    params = inputs.make_weights(cfg, seed, device)
    for p in inputs.leaves(params):
        p.requires_grad_(True)
    opt = optim.adam_l2(inputs.leaves(params), trainer.learning_rate,
                        trainer.weight_decay)
    gen = torch.Generator(device=device)
    gen.manual_seed(inputs.torch_seed(seed, inputs.DROPOUT))
    return Program(
        trainer=trainer, params=params, opt=opt, generator=gen,
        graph=graph, real_edges=int(graph.num_real_edges),
        real_nodes=int(graph.node_mask.sum()), device=device)


def first_steps(prog: Program) -> check.Readout:
    """The first FIRST_STEPS steps through the window's own call, and
    their readout: each step's loss, the first gradient as Adam holds it
    after one step (exp_avg / (1 - beta1)), the parameters' change over
    the steps."""
    ps = inputs.leaves(prog.params)
    p0 = [p.detach().clone() for p in ps]
    beta1 = prog.opt.param_groups[0]["betas"][0]
    losses, grads = [], None
    for _ in range(FIRST_STEPS):
        loss = prog.step()[0]
        losses.append(float(loss))
        if grads is None:
            grads = []
            for p in ps:
                m = prog.opt.state.get(p, {}).get("exp_avg")
                grads.append(0.0 if m is None
                             else float(m.norm()) / (1.0 - beta1))
    changes = [float((p.detach() - q).norm()) for p, q in zip(ps, p0)]
    return check.Readout(losses, grads, changes)


@dataclasses.dataclass
class Window:
    seconds: float
    steps: int
    edges: int                    # real edges over the steps
    step_ms: List[float]
    failed: int                   # steps whose loss is not finite


def run_window(prog: Program, seconds: float) -> Window:
    cuda = prog.device.type == "cuda"
    marks, losses = [], []
    edges = steps = 0
    t0 = time.perf_counter()
    while True:
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())
        losses.append(prog.step()[0])
        edges += prog.real_edges
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if cuda:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize(prog.device)
        marks.append(end)
        step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        marks.append(time.perf_counter())
        step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    window = time.perf_counter() - t0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    return Window(window, steps, edges, step_ms, failed)


def percentile(values: List[float], q: int) -> float:
    """The q-th percentile, as statistics.quantiles gives it."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def end_to_end(cell: Cell, win: Window, setup_s: float,
               peak_bytes: int) -> Dict[str, dict]:
    layers = int(cell.config["num_layers"])
    values = {
        "train_edges_per_s": layers * win.edges / win.seconds,
        "step_ms_p95": percentile(win.step_ms, 95),
        "peak_mem_gib": peak_bytes / GIB,
        "setup_s": setup_s,
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}


def traced_steps(cell: Cell, prog: Program) -> Tuple[dict, dict]:
    """Profile the cell's `trace_steps` steps; (the per-layer metrics'
    readings, the device's busy and window seconds with the breakdown)."""
    from gat_pytorch_tpu_torch.ops.cuda import build
    n = int(cell.workload["trace_steps"])
    host_s = []
    with trace.Recorder(prog.device) as rec:
        for _ in range(PROFILER_WARM_STEPS):
            prog.step()
        before = dict(build.LAUNCHES)
        rec.open()
        for _ in range(n):
            t = time.perf_counter()
            with record_function("portbench.train_step"):
                prog.step()
            host_s.append(time.perf_counter() - t)
    launches = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()}
    ctx = {
        "steps": n, "host_step_s": host_s,
        "window_s": rec.window_s, "busy_s": rec.busy_s,
        "kernels": rec.kernels, "launches": launches,
        "counts": counts.Counts(cell.form(), cell.config,
                                [prog.real_nodes] * n, [prog.real_edges] * n),
    }
    device = {"busy_s": rec.busy_s, "window_s": rec.window_s}
    return ctx, {"device": device, "breakdown": rec.breakdown()}


def per_layer(cell: Cell, ctx: dict) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        value = cell.metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def reference_readout(cell: Cell, data: traffic_mod.HostGraph, seed: int,
                      device, **mode) -> check.Readout:
    ref = load_module(cell.data_root / "reference"
                      / f"{cell.config['reference']}.py")
    return ref.readout(cell.config, data, FIRST_STEPS, seed, device, **mode)


def finite(value):
    return value if isinstance(value, (int, float)) and math.isfinite(
        value) else None


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float) -> dict:
    """One run; the result line's object (the check under "checks",
    last). t_start: the process's start on the host clock."""
    cuda = device.type == "cuda"
    phases = {"start": time.perf_counter() - t_start}
    clock = time.perf_counter()

    def phase(name):
        nonlocal clock
        if cuda:
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        phases[name] = now - clock
        clock = now

    data = traffic_mod.make(cell.traffic, cell.generator(), seed)
    phase("traffic")
    prog = build_program(cell, data, seed, device, phase)
    phase("weights_optimiser")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    readout = first_steps(prog)
    phase("first_steps")
    setup_s = time.perf_counter() - t_start
    win = run_window(prog, seconds)
    phase("window")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    result = {"correct": False, "attempted": win.steps, "failed": win.failed}
    extra = {}
    if traced:
        ctx, extra = traced_steps(cell, prog)
        metrics = per_layer(cell, ctx)
    else:
        metrics = end_to_end(cell, win, setup_s, peak)
    phase("traced" if traced else "end_to_end")
    prog = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_readout(cell, data, seed, device)
    phase("reference")
    numbers = check.compare(readout, ref)
    ok, table = check.judge(numbers, cell.limits)
    result["correct"] = ok and win.failed == 0
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if cuda else "cpu",
                        "kind": (torch.cuda.get_device_name(device) if cuda
                                 else "cpu"),
                        "count": 1, "memory_peak_bytes": int(peak),
                        **extra.get("device", {})}
    if "breakdown" in extra:
        result["breakdown"] = extra["breakdown"]
    result["phases_s"] = phases
    result["checks"] = {k: {"value": finite(v["value"]),
                            "limit": v["limit"]} for k, v in table.items()}
    return result
