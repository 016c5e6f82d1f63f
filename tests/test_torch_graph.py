"""The port's graph canonicalisation and data loading against the JAX
package: the same numpy inputs must give array-equal padded graphs."""

import numpy as np
import pytest

from gat_pytorch_tpu.data import loader as jloader
from gat_pytorch_tpu.data import synthetic as jsyn
from gat_pytorch_tpu.graph import graphcore_binding as jcore
from gat_pytorch_tpu.graph import transforms as JT
from gat_pytorch_tpu_torch.data import datasets as tdatasets
from gat_pytorch_tpu_torch.data import loader as tloader
from gat_pytorch_tpu_torch.data import synthetic as tsyn
from gat_pytorch_tpu_torch.graph import graphcore_binding as tcore
from gat_pytorch_tpu_torch.graph import transforms as TT

FIELDS = ("x", "senders", "receivers", "edge_mask", "node_mask", "y",
          "train_mask", "val_mask", "test_mask", "graph_ids", "src_order")


def assert_same_graph(jg, tg):
    assert (tg.num_nodes, tg.num_edges) == (jg.num_nodes, jg.num_edges)
    assert tg.num_real_edges == int(np.asarray(jg.edge_mask).sum())
    for name in FIELDS:
        a, b = getattr(jg, name), getattr(tg, name)
        if a is None:
            assert b is None, name
            continue
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)
    tg.validate()


def _random(seed, n, deg, f):
    g = jsyn.make_random_graph(seed, n, deg, f)
    return g.x, g.senders, g.receivers, g.y


@pytest.mark.parametrize("case", [
    dict(seed=2, n=300, deg=6.0, f=8, kw={}),
    dict(seed=3, n=50, deg=3.0, f=4, kw=dict(node_bucket=256,
                                             edge_bucket=512)),
    dict(seed=4, n=200, deg=5.0, f=4, kw=dict(pad_strategy="pow2")),
    dict(seed=5, n=100, deg=4.0, f=4, kw=dict(add_self_loops=False)),
])
def test_canonicalize_matches_jax(case):
    x, s, r, y = _random(case["seed"], case["n"], case["deg"], case["f"])
    assert_same_graph(JT.canonicalize(x, s, r, y=y, **case["kw"]),
                      TT.canonicalize(x, s, r, y=y, **case["kw"]))


def test_canonicalize_self_loop_input():
    # an existing self-loop is dropped and re-added once, as in the JAX
    # transforms test (tests/test_graph_transforms.py)
    x = np.ones((4, 3), np.float32)
    s, r = np.array([0, 1, 2, 2]), np.array([1, 1, 0, 2])
    assert_same_graph(JT.canonicalize(x, s, r), TT.canonicalize(x, s, r))


def test_host_primitives_match_jax():
    _, s, r, _ = _random(1, 500, 8.0, 2)
    for a, b in zip(jcore.add_remaining_self_loops(s, r, 500),
                    tcore.add_remaining_self_loops(s, r, 500)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jcore.sort_by_destination(s, r, return_perm=True),
                    tcore.sort_by_destination(s, r, return_perm=True)):
        np.testing.assert_array_equal(a, b)
    rs = np.sort(r)
    np.testing.assert_array_equal(jcore.csr_offsets(rs, 500),
                                  tcore.csr_offsets(rs, 500))
    for a, b in zip(JT.add_remaining_self_loops(s, r, 500),
                    TT.add_remaining_self_loops(s, r, 500)):
        np.testing.assert_array_equal(a, b)
    eid = np.arange(s.shape[0])
    for a, b in zip(JT.sort_by_destination(s, r, eid),
                    TT.sort_by_destination(s, r, eid)):
        np.testing.assert_array_equal(a, b)
    for n in (1, 127, 128, 129, 3000):
        for strategy in ("multiple", "pow2"):
            assert TT.pad_bucket(n, 128, strategy) == \
                JT.pad_bucket(n, 128, strategy)
        assert TT.round_up(n, 8) == JT.round_up(n, 8)


@pytest.mark.parametrize("name", ["Cora", "Citeseer"])
def test_synthetic_planetoid_bit_identical(name):
    a = jsyn.make_planetoid_like(name, seed=0)
    b = tsyn.make_planetoid_like(name, seed=0)
    for field in ("x", "senders", "receivers", "y", "train_mask",
                  "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field),
                                      err_msg=field)
        assert getattr(a, field).dtype == getattr(b, field).dtype


def test_cora_transductive_graph_matches_jax():
    raw = tdatasets.load_planetoid("Cora", synthetic_override=True)
    tg = tloader.transductive_graph(raw)
    jg = jloader.transductive_graph(jsyn.make_planetoid_like("Cora"))
    assert_same_graph(jg, tg)
    # the sizes the port's kernels run at
    assert (tg.num_nodes, tg.num_edges, tg.num_real_edges) == \
        (2816, 13312, 13212)


def test_is_synthetic_without_data(monkeypatch):
    monkeypatch.delenv("GAT_TPU_DATA", raising=False)
    assert tdatasets.is_synthetic("Cora")
    with pytest.raises(ValueError):
        tdatasets.is_synthetic("NoSuchSet")


def test_real_planetoid_files_parse_like_jax(tmp_path, monkeypatch):
    """The Kipf/GCN pickle parser on the JAX tests' generated raw files."""
    from gat_pytorch_tpu.data import datasets as jdatasets
    from tests.test_real_data_formats import _write_planetoid
    _write_planetoid(str(tmp_path), "Cora")
    monkeypatch.setenv("GAT_TPU_DATA", str(tmp_path))
    assert not tdatasets.is_synthetic("Cora")
    a, b = jdatasets.load_planetoid("Cora"), tdatasets.load_planetoid("Cora")
    for field in ("x", "senders", "receivers", "y", "train_mask",
                  "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(b, field), getattr(a, field),
                                      err_msg=field)
