"""Neighbour-sampled minibatches (GraphSAGE-style) for large-graph training.

Counterpart of gat_pytorch_tpu/data/sampling.py: K-hop sampled subgraphs
around seed-node minibatches, padded to one static (node, edge) bucket so
that every train step sees the same shapes. The route past a graph that
does not fit on the card whole.

Sampling: per hop h with fanout f_h, every frontier node keeps at most f_h
of its distinct in-neighbours, uniform without replacement (attention is
degree-sensitive, so a repeated edge would bias the softmax). The loss is
taken on the seed nodes only, through the subgraph's train_mask.
canonicalize adds the self-loops, so a seed keeps its own features at
fanout 0.

The draws are the JAX package's, branch for branch. Where the native
graphcore library is loaded (graph/graphcore_binding.native_available) a
hop draws one seed, int(rng.integers(2 ** 62)), and the C entry
gc_sample_neighbors samples every frontier node's in-edge slots from it;
the pairs are deduplicated (np.unique(..., axis=0)) and grouped by
destination in their first appearance. Without it (the numpy branch) the
same np.random.Generator calls come in the same order as there: a
permutation of the seeds an epoch, then per frontier node np.unique of
its in-neighbours and, only where there are more than the fanout,
rng.choice(..., replace=False); no draw for a node with no in-edge. So
from one seed the port draws what the JAX package draws where both load
the library, or neither does.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from ..graph import graphcore_binding as core
from ..graph import transforms as T
from ..graph.graph import Graph


class CSRGraph:
    """Host-side CSR (by destination) view of a raw edge list."""

    def __init__(self, senders: np.ndarray, receivers: np.ndarray,
                 num_nodes: int):
        order = np.argsort(receivers, kind="stable")
        self.senders = np.asarray(senders)[order]
        self.receivers = np.asarray(receivers)[order]
        self.num_nodes = num_nodes
        self.offsets = np.zeros(num_nodes + 1, dtype=np.int64)
        np.add.at(self.offsets[1:], self.receivers, 1)
        np.cumsum(self.offsets, out=self.offsets)

    def in_edges(self, node: int) -> np.ndarray:
        return self.senders[self.offsets[node]:self.offsets[node + 1]]


def sample_subgraph(csr: CSRGraph,
                    seeds: np.ndarray,
                    fanouts: Sequence[int],
                    rng: np.random.Generator
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
    """One sampled K-hop subgraph.

    Returns (nodes, sub_senders, sub_receivers, seed_local): the global
    node ids of the subgraph (the distinct seeds first, then each hop's
    new nodes in the order they were reached), its edges in local ids,
    and the local index of each seed.
    """
    nodes: List[int] = list(dict.fromkeys(int(s) for s in seeds))
    local = {n: i for i, n in enumerate(nodes)}
    sub_s: List[int] = []
    sub_r: List[int] = []
    frontier = np.asarray(nodes, dtype=np.int64)
    use_native = core.native_available()
    for fanout in fanouts:
        if use_native:
            # one draw a hop seeds the C entry's Floyd sampling; only
            # parallel edges collapse in the dedupe
            src, dst = core.sample_neighbors(
                csr.offsets, csr.senders, frontier, fanout,
                int(rng.integers(2 ** 62)))
            pairs = np.unique(np.stack([src, dst], axis=1), axis=0)
            per_v = {}
            for u, v in pairs:
                per_v.setdefault(int(v), []).append(int(u))
            hop = list(per_v.items())
        else:
            hop = []
            for v in frontier:
                nbrs = np.unique(csr.in_edges(int(v)))
                if nbrs.size == 0:
                    continue
                if nbrs.size > fanout:
                    nbrs = rng.choice(nbrs, size=fanout, replace=False)
                hop.append((int(v), nbrs))
        nxt: List[int] = []
        for v, nbrs in hop:
            for u in nbrs:
                u = int(u)
                if u not in local:
                    local[u] = len(nodes)
                    nodes.append(u)
                    nxt.append(u)
                sub_s.append(local[u])
                sub_r.append(local[v])
        frontier = np.asarray(nxt, dtype=np.int64)
    seed_local = np.array([local[int(s)] for s in seeds], dtype=np.int64)
    return (np.asarray(nodes, dtype=np.int64),
            np.asarray(sub_s, dtype=np.int64),
            np.asarray(sub_r, dtype=np.int64),
            seed_local)


class NeighborSampledBatcher:
    """Epoch-reshuffled seed minibatches -> padded sampled subgraphs.

    The Trainer's `reshuffle` protocol (Trainer.fit_epochs): `epoch(i)`
    returns a list of CPU Graphs sharing one static (node, edge) bucket,
    each with train_mask marking its seed nodes. Each call draws the next
    permutation from np.random.default_rng(seed) (`i` is not read), as the
    JAX package's batcher does.
    """

    def __init__(self,
                 x: np.ndarray,
                 senders: np.ndarray,
                 receivers: np.ndarray,
                 y: np.ndarray,
                 seed_nodes: np.ndarray,
                 batch_size: int,
                 fanouts: Sequence[int] = (10, 10),
                 seed: int = 0,
                 pad_multiple: int = 128):
        self.x, self.y = np.asarray(x), np.asarray(y)
        self.csr = CSRGraph(senders, receivers, self.x.shape[0])
        self.seed_nodes = np.asarray(seed_nodes)
        self.batch_size = batch_size
        self.fanouts = list(fanouts)
        self.rng = np.random.default_rng(seed)
        # worst-case bucket: seeds + seeds*f1 + seeds*f1*f2 + ... nodes;
        # one sampled in-edge set per frontier node, plus self-loops
        widths = [batch_size]
        for f in self.fanouts:
            widths.append(widths[-1] * f)
        worst_nodes = sum(widths) + 1
        worst_edges = sum(widths[1:]) + worst_nodes
        self.node_bucket = T.round_up(worst_nodes, pad_multiple)
        self.edge_bucket = T.round_up(worst_edges, pad_multiple)

    def __len__(self) -> int:
        return math.ceil(self.seed_nodes.size / self.batch_size)

    def epoch(self, epoch_idx: int = 0) -> List[Graph]:
        order = self.rng.permutation(self.seed_nodes.size)
        out = []
        for i in range(0, order.size, self.batch_size):
            seeds = self.seed_nodes[order[i:i + self.batch_size]]
            nodes, s, r, seed_local = sample_subgraph(
                self.csr, seeds, self.fanouts, self.rng)
            train_mask = np.zeros(nodes.size, dtype=bool)
            train_mask[seed_local] = True
            out.append(T.canonicalize(
                self.x[nodes], s, r, y=self.y[nodes],
                train_mask=train_mask,
                node_bucket=self.node_bucket,
                edge_bucket=self.edge_bucket))
        return out
