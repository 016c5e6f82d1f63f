"""Transductive full-graph loading (counterpart of
gat_pytorch_tpu/data/loader.py:77). Block-diagonal batching for the
inductive datasets waits for ROADMAP queue A item 9."""

from __future__ import annotations

from typing import Optional

from ..graph import transforms as T
from ..graph.graph import Graph
from .synthetic import RawGraph


def transductive_graph(raw: RawGraph, pad_multiple: int = 128,
                       reorder: Optional[str] = None,
                       src_windows: bool = False) -> Graph:
    """Single full-graph CPU Graph with the split masks (Planetoid path).

    reorder="rcm" with src_windows=True relabels the nodes by reverse
    Cuthill-McKee and builds the block layout of the windowed attention
    op. Labels and masks move with the nodes (Graph.node_order maps
    back), so training and metrics need no un-permute."""
    return T.canonicalize(
        raw.x, raw.senders, raw.receivers, y=raw.y,
        train_mask=raw.train_mask, val_mask=raw.val_mask,
        test_mask=raw.test_mask, pad_multiple=pad_multiple,
        reorder=reorder, src_windows=src_windows)
