"""Row 4: the feature-major d(h) reduction, GAT_TPU_DH_REDUCE_NT=0.

The JAX package's `_dh_reduce` sums the attention backward's per-edge
d(h) rows by sender with segment_sum_pallas_rows, in its row-major form
(`_kernel_rows_nt`, the default) or, under GAT_TPU_DH_REDUCE_NT=0, its
feature-major one (`_kernel_rows`: a (D, N) accumulator transposed
back). The port's counterpart of the second is segment_rows_t_plain /
the segment_sum_rows_t kernel. Held here:
  * its plain version against segment_sum_pallas_rows(no_transpose=False)
    in interpret mode, and against JAX `_dh_reduce` under the knob, at
    1e-6 of the scale (float32 sums in another order: the one-hot
    product against index_add);
  * the v5 ops (single sweep, 2-phase, sweep-1 parts by the layout's
    offsets and per call) and the table op: their backwards sum d(h) by
    sender and run no d(h) reduce, so under both values of the knob they
    give the same bits and call neither form.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.ops.pallas import segment_attention as jfsa
from gat_pytorch_tpu.ops.pallas import segment_sum as jss
from gat_pytorch_tpu_torch.ops.cuda import segment_sum as tss
from gat_pytorch_tpu_torch.ops.cuda import table_attention as tv4
from gat_pytorch_tpu_torch.ops.cuda import v5_attention as tv5

from .test_torch_knobs import default_knobs  # noqa: F401
from .test_torch_parts import v5_case

SLOPE = 0.01


def rows_case(seed, e=700, n=90, d=128, eb=256):
    """Per-edge rows with a zero overrun of eb rows, sorted sender ids
    (some ids past n, dropped), and a permutation."""
    rng = np.random.default_rng(seed)
    vals = np.zeros((e + eb, d), np.float32)
    vals[:e] = rng.normal(size=(e, d))
    ids = np.sort(rng.integers(0, n + 3, e)).astype(np.int32)
    return vals, ids, n


def test_plain_version_matches_the_jax_kernel():
    vals, ids, n = rows_case(1)
    want = np.asarray(jss.segment_sum_pallas_rows(
        jnp.asarray(vals), jnp.asarray(ids), n, eb=256, nb=128,
        interpret=True, no_transpose=False))
    got = tss.segment_rows_t_plain(torch.tensor(vals), None,
                                   torch.tensor(ids), n).numpy()
    assert got.shape == (n, 128)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_plain_version_matches_jax_dh_reduce(monkeypatch):
    """Through a sender-sorting permutation, as the backward calls it."""
    monkeypatch.setenv("GAT_TPU_DH_REDUCE_NT", "0")
    rng = np.random.default_rng(2)
    e, n, eb = 600, 80, 256
    senders = rng.integers(0, n, e).astype(np.int32)
    order = np.argsort(senders, kind="stable").astype(np.int32)
    rows = np.zeros((e + eb, 128), np.float32)
    rows[:e] = rng.normal(size=(e, 128))
    want = np.asarray(jfsa._dh_reduce(jnp.asarray(rows), jnp.asarray(order),
                                      jnp.asarray(senders), e, eb, n, True))
    got = tss.dh_reduce(torch.tensor(rows), torch.tensor(order),
                        torch.tensor(senders), n,
                        transposed=tss.dh_transposed()).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_both_forms_give_the_same_bits():
    vals, ids, n = rows_case(3, d=24)
    perm = torch.randperm(ids.shape[0], generator=torch.Generator()
                          .manual_seed(0)).to(torch.int32)
    v, i = torch.tensor(vals), torch.tensor(ids)
    assert torch.equal(tss.segment_rows_t_plain(v, perm, i, n),
                       tss.segment_rows_plain(v, perm, i, n))
    with pytest.raises(ValueError, match="no kernel"):
        tss.dh_reduce(v.to("meta"), perm.to("meta"), i.to("meta"), n,
                      transposed=True)


REDUCES = ("dh_reduce", "dh_reduce_ptr", "segment_rows_t_plain")


def grads_under(monkeypatch, nt, fn, args):
    """(d(args) of sum(sin(fn(*args))), calls of the d(h) reduce in
    either form) under GAT_TPU_DH_REDUCE_NT=nt."""
    monkeypatch.setenv("GAT_TPU_DH_REDUCE_NT", nt)
    calls = []
    plain = {name: getattr(tss, name) for name in REDUCES}

    def counted(name):
        def call(*a, **kw):
            calls.append(name)
            return plain[name](*a, **kw)
        return call

    for name in REDUCES:
        monkeypatch.setattr(tss, name, counted(name))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*leaves)
    if isinstance(out, tuple):
        out = torch.cat([t.reshape(-1) for t in out[:3]])
    torch.sin(out).sum().backward()
    for name in REDUCES:
        monkeypatch.setattr(tss, name, plain[name])
    return [t.grad for t in leaves], len(calls)


def v5_ops(c):
    send, recv, order = (torch.tensor(c[k]) for k in ("send", "recv",
                                                      "order"))
    er, nh, f, n = c["e_real"], c["nh"], c["f"], c["n"]
    # the table op's logits as given (the model's prelude sums its own
    # gradients with index_select's backward; only the op's are held)
    raw = (c["h"][c["send"]] @ c["a_src"] + c["s_dst"][c["recv"]])
    logits = torch.tensor(np.where(
        (np.arange(send.shape[0]) < er)[:, None], SLOPE * (raw - raw.max()),
        tv4.NEG_INF).astype(np.float32))
    src_ptr = torch.searchsorted(
        send[order[:er].long()].contiguous(),
        torch.arange(c["n_src"] + 1, dtype=torch.int32), out_int32=True)
    return {
        "autocap": lambda h, a, s: tv5.fused_gat_table_autocap(
            h, a, s, None, send, recv, order, er, None, n, nh, f),
        "two-phase": lambda h, a, s: tv5.fused_gat_table_autocap(
            h, a, s, None, send, recv, order, er, None, n, nh, f,
            two_phase=True),
        "parts": lambda h, a, s: tv5.v5_sweep1_parts(
            h, a, s, None, send, recv, order, er, n, nh, f,
            num_src_nodes=c["n_src"]),
        "parts by offsets": lambda h, a, s: tv5.v5_sweep1_parts(
            h, a, s, None, send, recv, order, er, n, nh, f,
            num_src_nodes=c["n_src"], src_ptr=src_ptr),
        "table": lambda h, a, s: tv4.fused_segment_attention_table(
            logits + 0 * (a.sum() + s.sum()), h, send, recv, None, order, n,
            nh, f, 1e-8, er),
    }


@pytest.mark.parametrize("op", ["autocap", "two-phase", "parts",
                                "parts by offsets", "table"])
def test_ops_take_the_feature_major_form_under_the_knob(op, monkeypatch):
    """The knob picks the form of the JAX package's d(h) reduce, which the
    ops' backwards by sender no longer run: under either value they give
    the same bits and call no reduce, row-major or feature-major."""
    c = v5_case(4, 8, False, seed=5, n_src=300)
    if op in ("autocap", "two-phase", "table"):
        c = v5_case(4, 8, False, seed=5)
    args = [c["h"], c["a_src"], c["s_dst"]]
    fn = v5_ops(c)[op]
    default, calls = grads_under(monkeypatch, "1", fn, args)
    assert calls == 0
    knob, calls = grads_under(monkeypatch, "0", fn, args)
    assert calls == 0
    for a, b in zip(knob, default):
        assert torch.equal(a, b)
