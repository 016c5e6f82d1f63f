"""The rank side of tests/test_torch_parallel.py: what each of several
torch.distributed processes runs (gloo, CPU tensors).

Its top level imports only torch and numpy, and nothing here imports
jax: the ranks are started with the spawn method, which imports this
module anew in each process. The test process hands every input over as
numpy arrays (graphs canonicalised and parameters initialised by the JAX
package) and reads each rank's results from a file.

`run_jobs(rank, world, store, jobs, out_dir)` joins a gloo group through
a FileStore, runs each job (a dict; `kind` names one of JOBS) and saves
{job name: result} to out_dir/rank<r>.pt.
"""

import os

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
    the metrics, the gradients and the parameters after the step; the
    task from make_task(job["task"], **job["task_kw"])."""
    from gat_pytorch_tpu_torch.models import gat
    from gat_pytorch_tpu_torch.parallel import (DropoutGenerators,
                                                make_sharded_train_step,
                                                shard_batch)
    from gat_pytorch_tpu_torch.train.tasks import make_task
    mesh = _mesh(job)
    cfg = gat.GATConfig(**job["cfg"])
    batch = shard_batch([graph_of(a) for a in job["graphs"]], mesh)
    out = {}
    for backend in job.get("backends", ("kernel", "segment")):
        step = make_sharded_train_step(
            cfg, make_task(job["task"], **job.get("task_kw", {})), mesh,
            backend=backend)
        runs = []
        for _ in range(job.get("repeats", 1)):
            gens = DropoutGenerators.for_rank(job.get("seed", 1), mesh,
                                              torch.device("cpu"))
            params = params_of(job["params"])
            opt = torch.optim.SGD(gat.parameters(params), lr=job["lr"])
            loss, mets = step(params, opt, batch, gens)
            runs.append(dict(loss=loss, metrics=mets, grads=grads_of(params),
                             params=[t.detach() for t in
                                     gat.parameters(params)]))
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
    still runs when the fit returns)."""
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
                             params=params_of(job["params"]))
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


JOBS = {"layer": layer_job, "model": model_job, "step": step_job,
        "masks": masks_job, "fit": fit_job, "pod": pod_job}


def run_jobs(rank, world, store, jobs, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        results = {job["name"]: JOBS[job["kind"]](job) for job in jobs}
    finally:
        dist.destroy_process_group()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn(jobs, world, tmp_dir):
    """Run `jobs` on `world` gloo ranks; returns each rank's results."""
    torch.multiprocessing.start_processes(
        run_jobs, args=(world, os.path.join(tmp_dir, "store"), jobs,
                        tmp_dir), nprocs=world, start_method="spawn")
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def numpy_graph(g):
    """The arrays of a canonicalised graph (either package's) that
    graph_of rebuilds it from."""
    keys = ("x", "senders", "receivers", "edge_mask", "node_mask", "y",
            "train_mask", "val_mask", "test_mask", "graph_ids", "src_order")
    return {k: np.asarray(getattr(g, k)) for k in keys
            if getattr(g, k) is not None}
