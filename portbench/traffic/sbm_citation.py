"""One homophilous citation graph with a train, validation and test split:
the recipe of the port's data/synthetic.py (`_sbm_edges`, class labels, a
random split) at counts given by the traffic file, with exact edge counts
and dense class-conditioned features.

params: nodes, citations (distinct undirected pairs, each made two
directed edges), features, classes, homophily (the share of pairs drawn
inside a class), signal (the spread of the class means against unit
noise), train, val, test (split sizes). Optional: cited_tail, for a
heavy-tailed degree: each pair's first (cited) node is drawn in proportion
to a Pareto weight of tail index cited_tail (its quantiles, one a node);
structure_seed: the labels and the
pairs are drawn from it and not from the run's seed, which then relabels
the nodes by a permutation (and draws the features and the split), so
that every seed trains on the same graph up to the order of its nodes: a
heavy tail's largest degrees, which set the work of a step, are then the
same for every seed.
"""

from __future__ import annotations

import numpy as np

from portbench.traffic import (HostGraph, both_directions, rng_factory,
                               unique_pairs)


def generate(params: dict, rng_for) -> HostGraph:
    n, c, f = params["nodes"], params["classes"], params["features"]
    fixed = params.get("structure_seed")
    structure = rng_for if fixed is None else rng_factory(fixed)
    labels = structure(0).integers(0, c, size=n).astype(np.int64)
    weights = None
    if "cited_tail" in params:
        # the Pareto(cited_tail) quantiles of n evenly spaced levels, dealt
        # to the nodes in a drawn order: the tail has no draw of its own
        levels = (np.arange(n) + 0.5) / n
        weights = ((1.0 - levels) ** (-1.0 / params["cited_tail"]))[
            structure(4).permutation(n)]
    pairs = unique_pairs(structure(1), labels, params["citations"],
                         params["homophily"], weights)
    if fixed is not None:
        new_id = rng_for(5).permutation(n)
        pairs = new_id[pairs]
        relabelled = np.empty_like(labels)
        relabelled[new_id] = labels
        labels = relabelled
    s, r = both_directions(pairs)
    rng = rng_for(2)
    means = (params["signal"] * rng.standard_normal((c, f))).astype(
        np.float32)
    x = means[labels] + rng.standard_normal((n, f), dtype=np.float32)
    perm = rng_for(3).permutation(n)
    masks = []
    start = 0
    for part in ("train", "val", "test"):
        m = np.zeros(n, dtype=bool)
        m[perm[start:start + params[part]]] = True
        start += params[part]
        masks.append(m)
    return HostGraph(x=x, senders=s, receivers=r, y=labels,
                     train_mask=masks[0], val_mask=masks[1],
                     test_mask=masks[2])
