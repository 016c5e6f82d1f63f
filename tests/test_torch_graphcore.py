"""The port's native graphcore library against its numpy form.

graph/graphcore_binding.py builds csrc/graphcore.cpp into build/graphcore/
at first use and falls back to numpy only where no compiler is found.
The cases of the JAX tests/test_graphcore.py (which skip where the JAX
package's own library is not built) run here on the port's library, each
native function held to the numpy form as equal arrays, plus the RCM
order, the calls on empty edge lists, and the build's own contract.
"""

import os
import stat

import numpy as np
import pytest

from gat_pytorch_tpu_torch.graph import graphcore_binding as core

class _NumpyForm:
    """Each binding function with the library hidden (the numpy form)."""

    def __getattr__(self, name):
        fn = getattr(core, name)

        def call(*a, **kw):
            saved = core._load
            core._load = lambda: None
            try:
                return fn(*a, **kw)
            finally:
                core._load = saved
        return call


NP = _NumpyForm()


@pytest.fixture(autouse=True)
def native():
    if core.compiler() is None:
        pytest.skip("no C++ compiler: the numpy form only")
    assert core.native_available()


def random_edges(n=200, e=900, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, e).astype(np.int64),
            rng.integers(0, n, e).astype(np.int64))


def assert_all_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)


def test_self_loops_native_matches_numpy():
    s, r = random_edges()
    assert_all_equal(core.add_remaining_self_loops(s, r, 200),
                     NP.add_remaining_self_loops(s, r, 200))


def test_sort_native_matches_numpy_and_is_stable():
    s, r = random_edges(seed=1)
    # stability: the same tie order, and the same permutation
    assert_all_equal(core.sort_by_destination(s, r, return_perm=True),
                     NP.sort_by_destination(s, r, return_perm=True))


def test_csr_offsets_native_matches_numpy():
    s, r = random_edges(seed=2)
    _, r_sorted = core.sort_by_destination(s, r)
    got = core.csr_offsets(r_sorted, 200)
    np.testing.assert_array_equal(got, NP.csr_offsets(r_sorted, 200))
    assert got[-1] == len(r_sorted)


def test_block_diagonal_native_matches_numpy():
    rng = np.random.default_rng(3)
    ncounts = np.array([5, 8, 3], np.int64)
    ecounts = np.array([10, 20, 6], np.int64)
    s = np.concatenate([rng.integers(0, n, e)
                        for n, e in zip(ncounts, ecounts)]).astype(np.int64)
    r = np.concatenate([rng.integers(0, n, e)
                        for n, e in zip(ncounts, ecounts)]).astype(np.int64)
    assert_all_equal(core.block_diagonal(s, r, ncounts, ecounts),
                     NP.block_diagonal(s, r, ncounts, ecounts))


def test_sample_neighbors_invariants():
    s, r = random_edges(n=100, e=600, seed=4)
    ss, rr = core.sort_by_destination(s, r)
    offs = core.csr_offsets(rr, 100)
    seeds = np.array([0, 5, 50, 99], np.int64)
    src, dst = core.sample_neighbors(offs, ss, seeds, k=4, seed=7)
    assert src.shape == dst.shape
    edge_set = set(zip(ss.tolist(), rr.tolist()))
    for a, b in zip(src, dst):
        assert (int(a), int(b)) in edge_set
    # without replacement: exactly min(k, deg) samples per seed
    for v in seeds:
        deg = int(offs[v + 1] - offs[v])
        assert int((dst == v).sum()) == min(4, deg)


def test_sample_neighbors_without_replacement_uniform():
    """Distinct slots, uniform without replacement, as the numpy form
    (not with replacement and a dedupe, which under-fills and biases).
    Star graph: one hub with 12 distinct in-neighbours, fanout 4."""
    deg, k, trials = 12, 4, 3000
    senders = np.arange(1, deg + 1, dtype=np.int64)   # hub = node 0
    receivers = np.zeros(deg, dtype=np.int64)
    ss, rr = core.sort_by_destination(senders, receivers)
    offs = core.csr_offsets(rr, deg + 1)
    seeds = np.array([0], np.int64)
    counts = np.zeros(deg + 2, dtype=np.int64)
    for t in range(trials):
        src, dst = core.sample_neighbors(offs, ss, seeds, k=k, seed=1000 + t)
        assert src.size == k
        assert np.unique(src).size == k
        counts[src] += 1
    # each neighbour appears with P = k/deg = 1/3; within 5 sigma of the
    # binomial std
    p = k / deg
    sigma = (trials * p * (1 - p)) ** 0.5
    dev = np.abs(counts[1:deg + 1] - trials * p)
    assert (dev < 5 * sigma).all(), counts[1:deg + 1]


@pytest.mark.parametrize("n,e,seed", [(200, 900, 5), (500, 600, 6),
                                      (64, 2000, 7)])
def test_rcm_order_native_matches_numpy(n, e, seed):
    """Several components, isolated nodes, self-loops and multi-edges."""
    s, r = random_edges(n, e, seed)
    s[:20] = r[:20]                       # self-loops, ignored
    s[20:40], r[20:40] = s[40:60], r[40:60]   # repeated edges
    got = core.rcm_order(s, r, n)
    np.testing.assert_array_equal(got, NP.rcm_order(s, r, n))
    np.testing.assert_array_equal(np.sort(got), np.arange(n))


def test_empty_edge_lists():
    """Every entry on zero edges: the numpy form's arrays."""
    none = np.empty(0, np.int64)
    assert_all_equal(core.add_remaining_self_loops(none, none, 5),
                     NP.add_remaining_self_loops(none, none, 5))
    assert_all_equal(core.sort_by_destination(none, none, return_perm=True),
                     NP.sort_by_destination(none, none, return_perm=True))
    np.testing.assert_array_equal(core.csr_offsets(none, 4), np.zeros(5))
    np.testing.assert_array_equal(core.csr_offsets(none, 4),
                                  NP.csr_offsets(none, 4))
    counts = np.array([2, 3], np.int64)
    assert_all_equal(core.block_diagonal(none, none, counts, [0, 0]),
                     NP.block_diagonal(none, none, counts, [0, 0]))
    np.testing.assert_array_equal(core.rcm_order(none, none, 6),
                                  NP.rcm_order(none, none, 6))
    np.testing.assert_array_equal(core.rcm_order(none, none, 6),
                                  np.arange(6)[::-1])
    offs = np.zeros(4, np.int64)
    for seeds in (none, np.array([0, 2], np.int64)):
        assert_all_equal(core.sample_neighbors(offs, none, seeds, 3, 1),
                         (none, none))


def test_no_compiler_runs_the_numpy_form(monkeypatch):
    """Without a compiler the numpy form runs and native_available says
    so; nothing is built."""
    monkeypatch.setattr(core, "_lib", None)
    monkeypatch.setattr(core, "_searched", False)
    monkeypatch.setattr(core, "compiler", lambda: None)
    assert not core.native_available()
    s, r = random_edges(seed=8)
    assert_all_equal(core.sort_by_destination(s, r),
                     NP.sort_by_destination(s, r))


def test_a_failing_build_raises(monkeypatch, tmp_path):
    """A compiler that is found but fails raises, naming it; nothing is
    left in the build directory."""
    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'cannot compile' >&2\nexit 3\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(core, "_lib", None)
    monkeypatch.setattr(core, "_searched", False)
    monkeypatch.setattr(core, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken-cxx.*rc 3"):
        core.native_available()
    assert os.listdir(tmp_path / "build") == []


def test_the_library_is_named_by_source_compiler_flags_and_host(
        monkeypatch):
    """The file lives under build/graphcore/ and its name changes with
    the compiler, the flags and the host's CPU (-march=native)."""
    path = core.lib_path(core.compiler())
    assert core._lib._name == str(path) and path.exists()
    assert path.parent.name == "graphcore" and path.parent.parent.name == \
        "build"
    assert core.lib_path("/other/g++") != path
    monkeypatch.setattr(core, "_host", lambda: "another CPU")
    assert core.lib_path(core.compiler()) != path
    monkeypatch.undo()
    monkeypatch.setattr(core, "CXXFLAGS", core.CXXFLAGS + ["-DX"])
    assert core.lib_path(core.compiler()) != path
    assert "flags" in core._host() or "Features" in core._host()
