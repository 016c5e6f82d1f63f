"""Traffic: the graph a cell trains on, full batch, made on the host from
the seed.

A traffic mix is a data file, `traffic/<name>.json`:
`{"generator": "<generator>", "params": {...}}`. The generator,
`traffic/<generator>.py`, has `generate(params, rng_for) -> HostGraph`;
`rng_for(*stream)` gives a numpy Generator of its own to each stream of
draws, all from the run's seed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class HostGraph:
    """One graph as the benchmark makes it: directed edges without
    self-loops (each undirected pair in both directions), features, class
    ids and the split masks."""
    x: np.ndarray
    senders: np.ndarray
    receivers: np.ndarray
    y: np.ndarray
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.senders.shape[0])


def rng_factory(seed: int) -> Callable[..., np.random.Generator]:
    """rng_for(*stream): a numpy Generator for one stream of draws of the
    run `seed` (any whole number)."""
    base = int(seed) % 2 ** 64

    def rng_for(*stream: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([base, *stream]))
    return rng_for


def make(traffic: dict, generator, seed: int) -> HostGraph:
    """The traffic mix `traffic` (its data file) drawn by `generator` (its
    module) from `seed`."""
    return generator.generate(traffic["params"], rng_factory(seed))


def unique_pairs(rng: np.random.Generator, groups: np.ndarray, count: int,
                 homophily: float,
                 weights: Optional[np.ndarray] = None) -> np.ndarray:
    """`count` distinct unordered node pairs (lo < hi), no self-pairs, as
    data/synthetic.py's _sbm_edges draws them: a uniform first node (or
    one drawn in proportion to `weights`), and a partner of the same group
    with probability `homophily`, else uniform. Draws are repeated until
    `count` distinct pairs exist, in the order of their first draw, so the
    count is exact whatever the seed."""
    n = groups.shape[0]
    members = [np.flatnonzero(groups == g) for g in range(groups.max() + 1)]
    p = None if weights is None else weights / weights.sum()
    keys = np.empty(0, dtype=np.int64)
    while keys.shape[0] < count:
        k = int((count - keys.shape[0]) * 1.2) + 1024
        src = (rng.integers(0, n, size=k) if p is None
               else rng.choice(n, size=k, p=p))
        same = rng.random(k) < homophily
        partner = rng.integers(0, n, size=k)
        for g, idx in enumerate(members):
            pick = same & (groups[src] == g)
            partner[pick] = idx[rng.integers(0, len(idx), size=pick.sum())]
        keep = src != partner
        lo = np.minimum(src, partner)[keep]
        hi = np.maximum(src, partner)[keep]
        keys = np.concatenate([keys, lo * n + hi])
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)]
    keys = keys[:count]
    return np.stack([keys // n, keys % n], axis=1)


def both_directions(pairs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(senders, receivers) of each pair in both directions."""
    s = np.concatenate([pairs[:, 0], pairs[:, 1]]).astype(np.int64)
    r = np.concatenate([pairs[:, 1], pairs[:, 0]]).astype(np.int64)
    return s, r

