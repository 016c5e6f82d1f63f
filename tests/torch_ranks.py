"""The rank side of tests/test_torch_parallel.py and the other tests of
the port's sharded paths: what each of several torch.distributed
processes runs (gloo, CPU tensors).

Its top level imports only torch and numpy, and nothing here imports
jax: the ranks are started with the spawn method, which imports this
module anew in each process. The test process hands every input over as
numpy arrays (graphs canonicalised and parameters initialised by the JAX
package) and reads each rank's results from a file.

`run_jobs(rank, world, store, jobs_path, out_dir)` joins a gloo group
through a FileStore, runs each job of the list pickled at jobs_path (a
dict; `kind` names one of JOBS) and saves {job name: result} to
out_dir/rank<r>.pt. The jobs go through a file, not the processes'
arguments: spawn writes a process's arguments to a pipe that the child
reads only once its interpreter is up, so arguments larger than the pipe
hold each start until the child before it has imported torch.
"""

import contextlib
import os
import pickle

import numpy as np
import torch


def graph_of(arrays):
    from gat_pytorch_tpu_torch.graph.graph import from_numpy
    a = dict(arrays)
    return from_numpy(a.pop("x"), a.pop("senders"), a.pop("receivers"), **a)


def params_of(tree):
    from gat_pytorch_tpu_torch.utils.convert import params_from_jax
    return params_from_jax(tree, device="cpu")


def grads_of(params):
    from gat_pytorch_tpu_torch.models import gat
    return [p.grad.clone() for p in gat.parameters(params)]


@contextlib.contextmanager
def _env(values):
    """The environment variables `values` set inside the block."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _batch(job, mesh):
    """This rank's shard of job["graphs"]: cut over the edge axis, or
    where job["dst_owned"] partitioned by destination (partition_batches
    with job["partition"]) and cut by dst_shard."""
    from gat_pytorch_tpu_torch.parallel import partition_batches, shard_batch
    graphs = [graph_of(a) for a in job["graphs"]]
    if job.get("dst_owned"):
        graphs, _ = partition_batches(graphs, mesh.edge.size,
                                      **job.get("partition", {}))
    return shard_batch(graphs, mesh, dst_owned=job.get("dst_owned", False))


def _mesh(job):
    from gat_pytorch_tpu_torch.parallel import make_mesh
    data, edge = job["mesh"]
    return make_mesh(data=data, edge=edge)


def layer_job(job):
    """One layer on this rank's edge shard of one graph: its output and
    the gradients of sum(sin(out)) for each backend."""
    from gat_pytorch_tpu_torch.models import gat
    from gat_pytorch_tpu_torch.parallel import edge_shard
    mesh = _mesh(job)
    cfg = gat.GATLayerConfig(**job["cfg"])
    g = edge_shard(graph_of(job["graph"]), mesh.edge.index, mesh.edge.size)
    out = {}
    for backend in ("kernel", "segment"):
        params = {k: torch.tensor(v, requires_grad=True)
                  for k, v in job["params"].items()}
        gat.PATH_TRACE.clear()
        y = gat.gat_layer_apply(params, cfg, g.x, g.senders, g.receivers,
                                g.edge_mask, g.num_nodes,
                                num_real_edges=g.num_real_edges,
                                src_order=g.src_order, backend=backend,
                                edge_axis=mesh.edge)
        torch.sin(y).sum().backward()
        out[backend] = dict(out=y.detach(), trace=list(gat.PATH_TRACE),
                            grads={k: p.grad for k, p in params.items()})
    return out


def dst_model_job(job):
    """The dst-owned model (mesh (1, K)) on this rank's shard of one graph
    partitioned by destination (job["partition"]), under the environment
    job["env"], for each backend of job["backends"]: logits, PATH_TRACE,
    the collectives made, and the gradients of mean(logits ** 2), plus the
    attention norm where job["attention"] (then alpha and the norm too)."""
    from gat_pytorch_tpu_torch.models import gat
    from gat_pytorch_tpu_torch.ops import collectives as C
    from gat_pytorch_tpu_torch.parallel import (dst_shard,
                                                partition_edges_by_dst)
    mesh = _mesh(job)
    cfg = gat.GATConfig(**job["cfg"])
    attention = job.get("attention", False)
    g2, _ = partition_edges_by_dst(graph_of(job["graph"]), mesh.edge.size,
                                   **job.get("partition", {}))
    g = dst_shard(g2, mesh.edge.index, mesh.edge.size)
    out = {}
    with _env(job.get("env", {})):
        for backend in job["backends"]:
            params = params_of(job["params"])
            gat.PATH_TRACE.clear()
            with C.recording() as calls:
                res = gat.gat_model_apply(
                    params, cfg, g, device="cpu", backend=backend,
                    edge_axis=mesh.edge, dst_owned=True,
                    return_attention=attention)
                logits, alpha = res if attention else (res, [])
                loss = (logits ** 2).mean()
                norm = None
                if attention:
                    norm = gat.calc_attention_norm(
                        g, alpha, edge_axis=mesh.edge, dst_owned=True)
                    loss = loss + norm
                loss.backward()
            out[backend] = dict(
                logits=logits.detach(), grads=grads_of(params),
                trace=list(gat.PATH_TRACE), calls=list(calls),
                alpha=[a.detach() for a in alpha],
                norm=None if norm is None else norm.detach(),
                rem_e=(None if g.block_layout is None
                       else g.block_layout.rem_e))
    return out


def model_job(job):
    """The model on this rank's shard of one graph (mesh (1, K)): logits
    and the gradients of mean(logits ** 2) for each backend."""
    from gat_pytorch_tpu_torch.models import gat
    from gat_pytorch_tpu_torch.parallel import edge_shard
    mesh = _mesh(job)
    cfg = gat.GATConfig(**job["cfg"])
    g = edge_shard(graph_of(job["graph"]), mesh.edge.index, mesh.edge.size)
    out = {}
    for backend in ("kernel", "segment"):
        params = params_of(job["params"])
        logits = gat.gat_model_apply(params, cfg, g, device="cpu",
                                     backend=backend, edge_axis=mesh.edge)
        (logits ** 2).mean().backward()
        out[backend] = dict(logits=logits.detach(), grads=grads_of(params))
    return out


def step_job(job):
    """One sharded train step (SGD, lr job["lr"]) per backend: the loss,
    the metrics, the gradients, the parameters after the step and the
    collectives it made; the task from make_task(job["task"],
    **job["task_kw"]); the dst-owned layout where job["dst_owned"]
    (_batch)."""
    from gat_pytorch_tpu_torch.models import gat
    from gat_pytorch_tpu_torch.ops import collectives as C
    from gat_pytorch_tpu_torch.parallel import (DropoutGenerators,
                                                make_sharded_train_step)
    from gat_pytorch_tpu_torch.train.tasks import make_task
    mesh = _mesh(job)
    cfg = gat.GATConfig(**job["cfg"])
    batch = _batch(job, mesh)
    out = {}
    for backend in job.get("backends", ("kernel", "segment")):
        step = make_sharded_train_step(
            cfg, make_task(job["task"], **job.get("task_kw", {})), mesh,
            backend=backend, dst_owned=job.get("dst_owned", False))
        runs = []
        for _ in range(job.get("repeats", 1)):
            gens = DropoutGenerators.for_rank(job.get("seed", 1), mesh,
                                              torch.device("cpu"))
            params = params_of(job["params"])
            opt = torch.optim.SGD(gat.parameters(params), lr=job["lr"])
            with C.recording() as calls:
                loss, mets = step(params, opt, batch, gens)
            runs.append(dict(loss=loss, metrics=mets, grads=grads_of(params),
                             params=[t.detach() for t in
                                     gat.parameters(params)],
                             calls=list(calls)))
        out[backend] = runs
    return out


def masks_job(job):
    """The first attention dropout mask of this rank's edge shard and the
    first input dropout mask, as the model draws them."""
    from gat_pytorch_tpu_torch.parallel import DropoutGenerators
    mesh = _mesh(job)
    gens = DropoutGenerators.for_rank(job["seed"], mesh, torch.device("cpu"))
    node = torch.rand(job["node_shape"], generator=gens.node)
    edge = torch.rand(job["edge_shape"], generator=gens.edge)
    return dict(node=node >= job["rate"], edge=edge >= job["rate"])


def fit_job(job):
    """Trainer.fit_sharded: the history and the final parameters. Options:
    job["reshuffle"] rotates the train graphs by the epoch (a reshuffle
    that builds each epoch anew); job["checkpoint_dir"] (formatted with
    this process's rank) and job["every"] the trainer's checkpoints, whose
    files are listed; job["patience"]; job["spy_prefetch"] records the
    trainer's prefetch iterators (their put flag, and whether each thread
    still runs when the fit returns); job["dst_owned"] the dst-owned
    layout."""
    from gat_pytorch_tpu_torch.models import gat
    from gat_pytorch_tpu_torch.train import trainer as T
    from gat_pytorch_tpu_torch.train.tasks import make_task
    mesh = _mesh(job)
    graphs = [graph_of(a) for a in job["graphs"]]
    n_train = job["n_train"]
    train = graphs[:n_train]
    ckpt = job.get("checkpoint_dir")
    if ckpt is not None:
        ckpt = ckpt.format(rank=torch.distributed.get_rank())
    spied, plain = [], T.PrefetchIterator

    class Spy(plain):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            spied.append((kw.get("put", True), self))

    tr = T.Trainer(cfg=gat.GATConfig(**job["cfg"]),
                   task=make_task(job["task"], **job.get("task_kw", {})),
                   learning_rate=job["lr"], max_epochs=job["epochs"],
                   patience=job.get("patience", 100), seed=0, device="cpu",
                   backend=job["backend"], checkpoint_dir=ckpt,
                   checkpoint_every_n_epochs=job.get("every", 0),
                   prefetch=job.get("prefetch", True))
    reshuffle = None
    if job.get("reshuffle"):
        def reshuffle(epoch):
            k = epoch % len(train)
            return train[k:] + train[:k]
    if job.get("spy_prefetch"):
        T.PrefetchIterator = Spy
    try:
        res = tr.fit_sharded(mesh, train, graphs[n_train:],
                             reshuffle=reshuffle,
                             params=params_of(job["params"]),
                             dst_owned=job.get("dst_owned", False))
    finally:
        T.PrefetchIterator = plain
    return dict(history=res.history, best_epoch=res.best_epoch,
                stopped_early=res.stopped_early,
                params=[t.detach() for t in gat.parameters(res.final_params)],
                files=(sorted(os.listdir(ckpt))
                       if ckpt is not None and os.path.isdir(ckpt) else []),
                prefetch=[(put, it.alive) for put, it in spied])


def pod_job(job):
    """parallel.multihost on a pod of job["hosts"] hosts, each of
    world/hosts processes (LOCAL_WORLD_SIZE as torchrun sets it): the mesh
    and this process's shard of a global batch."""
    from gat_pytorch_tpu_torch.parallel import multihost, shard_batch
    world = torch.distributed.get_world_size()
    os.environ["LOCAL_WORLD_SIZE"] = str(world // job["hosts"])
    try:
        mesh = multihost.pod_mesh()
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    batch = [graph_of(a) for a in job["graphs"]]
    got = multihost.shard_global_batch(batch, mesh, device="cpu")
    want = shard_batch(batch, mesh)
    same = all(torch.equal(getattr(a, k), getattr(b, k))
               for a, b in zip(got, want)
               for k in ("x", "senders", "receivers", "edge_mask",
                         "src_order"))
    return dict(shape=mesh.shape, index=(mesh.data.index, mesh.edge.index),
                joined=multihost.initialize(), same=same, shards=len(got))


JOBS = {"layer": layer_job, "model": model_job, "dst_model": dst_model_job,
        "step": step_job,
        "masks": masks_job, "fit": fit_job, "pod": pod_job}


def run_jobs(rank, world, store, jobs_path, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(jobs_path, "rb") as fh:
        jobs = pickle.load(fh)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        results = {job["name"]: JOBS[job["kind"]](job) for job in jobs}
    finally:
        dist.destroy_process_group()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def start(jobs, world, tmp_dir):
    """Start `jobs` on `world` gloo ranks and return at once (the caller
    may work meanwhile); results(...) waits for them."""
    jobs_path = os.path.join(tmp_dir, "jobs.pkl")
    with open(jobs_path, "wb") as fh:
        pickle.dump(jobs, fh)
    return torch.multiprocessing.start_processes(
        run_jobs, args=(world, os.path.join(tmp_dir, "store"), jobs_path,
                        tmp_dir), nprocs=world, join=False,
        start_method="spawn")


def results(context, world, tmp_dir):
    """Each rank's results, once the ranks of `context` (start) end."""
    while not context.join():
        pass
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def spawn(jobs, world, tmp_dir):
    """Run `jobs` on `world` gloo ranks; returns each rank's results."""
    return results(start(jobs, world, tmp_dir), world, tmp_dir)


def numpy_graph(g):
    """The arrays of a canonicalised graph (either package's) that
    graph_of rebuilds it from."""
    keys = ("x", "senders", "receivers", "edge_mask", "node_mask", "y",
            "train_mask", "val_mask", "test_mask", "graph_ids", "src_order")
    return {k: np.asarray(getattr(g, k)) for k in keys
            if getattr(g, k) is not None}
