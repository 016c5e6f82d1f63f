"""Batching: block-diagonal batches of whole graphs for the inductive
datasets, one full graph for the transductive ones.

Counterpart of gat_pytorch_tpu/data/loader.py. Every batch of a dataset is
padded to one static node and edge bucket, so every step sees the same
shapes (buffers are reused, and a step can later be captured once).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from ..graph import graphcore_binding as core
from ..graph import transforms as T
from ..graph.graph import Graph
from .synthetic import RawGraph


def batch_raw(graphs: Sequence[RawGraph]) -> tuple:
    """Block-diagonal concat. Returns (x, senders, receivers, y, graph_ids)."""
    node_counts = np.array([g.num_nodes for g in graphs], np.int64)
    edge_counts = np.array([g.num_edges for g in graphs], np.int64)
    s = np.concatenate([g.senders for g in graphs])
    r = np.concatenate([g.receivers for g in graphs])
    s, r, gids = core.block_diagonal(s, r, node_counts, edge_counts)
    x = np.concatenate([g.x for g in graphs])
    y = np.concatenate([g.y for g in graphs])
    return x, s, r, y, gids


class InductiveBatcher:
    """Epoch-reshuffled block-diagonal batches with one static bucket.

    DataLoader(batch_size, shuffle=True) semantics, the ragged last batch
    included (it is padded to the same bucket). The shuffles come from
    np.random.default_rng(seed), one permutation per `epoch` call, so the
    JAX package's batcher yields the same batches in the same order.
    """

    def __init__(self, graphs: Sequence[RawGraph], batch_size: int,
                 seed: int = 0, shuffle: bool = True,
                 pad_multiple: int = 128):
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        # worst-case bucket over any batch composition: sum of the largest
        # batch_size graphs (+1 node sink; self-loops add <= nodes edges)
        top_n = sorted((g.num_nodes for g in self.graphs), reverse=True)
        top_e = sorted((g.num_edges for g in self.graphs), reverse=True)
        worst_n = sum(top_n[:batch_size]) + 1
        worst_e = sum(top_e[:batch_size]) + sum(top_n[:batch_size])
        self.node_bucket = T.round_up(worst_n, pad_multiple)
        self.edge_bucket = T.round_up(worst_e, pad_multiple)

    def __len__(self) -> int:
        return math.ceil(len(self.graphs) / self.batch_size)

    def epoch(self, epoch_idx: int = 0) -> List[Graph]:
        """The epoch's batches as CPU Graphs (`epoch_idx` is not read:
        each call draws the generator's next permutation)."""
        order = np.arange(len(self.graphs))
        if self.shuffle:
            order = self.rng.permutation(len(self.graphs))
        batches = []
        for i in range(0, len(order), self.batch_size):
            chunk = [self.graphs[j] for j in order[i:i + self.batch_size]]
            x, s, r, y, gids = batch_raw(chunk)
            batches.append(T.canonicalize(
                x, s, r, y=y, graph_ids=gids,
                node_bucket=self.node_bucket,
                edge_bucket=self.edge_bucket))
        return batches


def transductive_graph(raw: RawGraph, pad_multiple: int = 128,
                       reorder: Optional[str] = None,
                       src_windows: bool = False,
                       hybrid: bool = False) -> Graph:
    """Single full-graph CPU Graph with the split masks (Planetoid path).

    reorder="rcm" with src_windows=True relabels the nodes by reverse
    Cuthill-McKee and builds the block layout of the windowed attention
    op. reorder="cluster" with hybrid=True is the order and layout for
    graphs RCM cannot band (community graphs such as Pubmed): the edges
    inside a tile's sender window go to the windowed op, the remainder to
    the v5 op (transforms.compute_hybrid_layout). Labels and masks move
    with the nodes (Graph.node_order maps back), so training and metrics
    need no un-permute."""
    return T.canonicalize(
        raw.x, raw.senders, raw.receivers, y=raw.y,
        train_mask=raw.train_mask, val_mask=raw.val_mask,
        test_mask=raw.test_mask, pad_multiple=pad_multiple,
        reorder=reorder, src_windows=src_windows, hybrid=hybrid)
