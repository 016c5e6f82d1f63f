"""The traffic generators hit their published counts at reduced scale,
exactly and for any seed, and a seed gives the same arrays again."""

import numpy as np
import pytest

from portbench import spec
from portbench import traffic as T
from portbench.tests.helpers import BENCH

CITATION = {"nodes": 900, "citations": 4000, "features": 128, "classes": 40,
            "homophily": 0.65, "signal": 0.5, "train": 400, "val": 150,
            "test": 250}


def gen(name):
    return spec.load_module(BENCH / "traffic" / f"{name}.py")


def pairs_of(g):
    lo = np.minimum(g.senders, g.receivers)
    hi = np.maximum(g.senders, g.receivers)
    return lo * g.num_nodes + hi


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_citation_graph_counts(seed):
    g = gen("sbm_citation").generate(CITATION, T.rng_factory(seed))
    assert g.num_nodes == 900 and g.x.shape == (900, 128)
    assert g.num_edges == 2 * 4000
    assert not np.any(g.senders == g.receivers)
    assert np.unique(pairs_of(g)).shape[0] == 4000
    assert g.y.min() >= 0 and g.y.max() < 40
    assert [int(m.sum()) for m in (g.train_mask, g.val_mask,
                                   g.test_mask)] == [400, 150, 250]
    assert not np.any(g.train_mask & g.val_mask)
    same = np.mean(g.y[g.senders] == g.y[g.receivers])
    assert 0.55 < same < 0.75


def test_a_seed_repeats_and_another_differs():
    mix = {"generator": "sbm_citation", "params": CITATION}
    one = T.make(mix, gen("sbm_citation"), 11)
    two = T.make(mix, gen("sbm_citation"), 11)
    other = T.make(mix, gen("sbm_citation"), 12)
    for key in ("senders", "receivers", "x", "y", "train_mask"):
        assert np.array_equal(getattr(one, key), getattr(two, key))
    assert not np.array_equal(one.senders, other.senders)


def test_a_fixed_structure_is_relabelled_by_the_seed():
    params = dict(CITATION, cited_tail=1.3, structure_seed=17)
    a = gen("sbm_citation").generate(params, T.rng_factory(1))
    b = gen("sbm_citation").generate(params, T.rng_factory(2))
    deg_a = np.bincount(a.receivers, minlength=900)
    deg_b = np.bincount(b.receivers, minlength=900)
    assert np.array_equal(np.sort(deg_a), np.sort(deg_b))
    assert not np.array_equal(deg_a, deg_b)
    assert deg_a.max() > 8 * np.median(deg_a)
    assert np.sort(a.y).tolist() == np.sort(b.y).tolist()
    assert a.num_edges == 2 * 4000
