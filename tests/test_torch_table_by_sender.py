"""The table op's backward by sender (ops/cuda/table_attention.py:
table_dden and table_backward) in its plain versions, against the JAX
package's fused_segment_attention_table run in interpret mode, as
tests/test_torch_table_attention.py runs it.

On the card the backward is two kernels: the per-destination d(den) term
(table_dden) and a walk of each sender's edges that writes d(h) (N, D)
with no per-edge rows. Their plain versions are held here:
- against the JAX op's cotangents of the logits, h and the dropout mask
  (the loss sum(sin(out))): atol 2e-5 after dividing by max(|ref|, 1), as
  tests/test_torch_table_attention.py holds the op; dden through
  ex * dden[dst] = d(logits) - d(drop) * mask, at the same tolerance;
- against table_backward_plain's per-edge rows summed by sender with
  segment_rows_plain in edge order: 1e-6 of max(|ref|, 1) (the same
  products added in another order), d(logits) and d(drop) equal.
Every case passes num_real_edges below E (36 padding edges on the sink),
has senders without a real edge (zero d(h) rows), and half of them real
edges whose receiver is past num_nodes (zero cotangents).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.ops.pallas import segment_attention as jfsa
from gat_pytorch_tpu_torch.ops.cuda import segment_sum as tss
from gat_pytorch_tpu_torch.ops.cuda import table_attention as tta

from .test_torch_knobs import default_knobs  # noqa: F401

N, E_REAL, PAD = 128, 400, 36
SILENT = (5, 6, 7, 40)      # nodes that send no real edge
PAST = 6                    # real edges moved past num_nodes


def make_case(nh, f, seed, dropout, eps, past):
    """Dst-sorted edges over N nodes, the padding edges last on the sink
    (sender N - 1, NEG_INF logits); with `past`, the last PAST real edges
    and the padding edges have receiver N, no row of the call."""
    rng = np.random.default_rng(seed)
    e = E_REAL + PAD
    pool = np.setdiff1d(np.arange(N - 1), SILENT)
    recv = np.concatenate([np.sort(rng.choice(np.arange(N - 1), E_REAL)),
                           np.full(PAD, N - 1)]).astype(np.int32)
    if past:
        recv[E_REAL - PAST:] = N
    send = np.concatenate([rng.choice(pool, E_REAL),
                           np.full(PAD, N - 1)]).astype(np.int32)
    logits = rng.normal(size=(e, nh)).astype(np.float32)
    seg_max = np.full((N + 1, nh), -np.inf, np.float32)
    np.maximum.at(seg_max, recv[:E_REAL], logits[:E_REAL])
    logits -= np.where(np.isfinite(seg_max), seg_max, 0.0)[recv]
    logits[E_REAL:] = tta.NEG_INF
    return dict(
        nh=nh, f=f, eps=eps, send=send, recv=recv, logits=logits,
        order=np.argsort(send, kind="stable").astype(np.int32),
        h=rng.normal(size=(N, nh * f)).astype(np.float32),
        drop=((rng.random((e, nh)) > 0.4).astype(np.float32) / 0.6
              if dropout else None))


def run_jax(c):
    """The JAX op's output and its cotangents (logits, h[, drop]) of
    sum(sin(out)), in interpret mode."""
    sd, rc = jnp.asarray(c["send"]), jnp.asarray(c["recv"])
    args = [jnp.asarray(c["logits"]), jnp.asarray(c["h"])]
    if c["drop"] is not None:
        args.append(jnp.asarray(c["drop"]))

    def loss(ll, hh, dd=None):
        out = jfsa.fused_segment_attention_table(
            ll, hh, sd, rc, dd, jnp.asarray(c["order"]), N, c["nh"], c["f"],
            c["eps"], 256, 128, True)
        return jnp.sum(jnp.sin(out)), out

    (_, out), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(args))), has_aux=True)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def port_inputs(c, out_jax):
    """The plain backward's arguments: the port's forward residuals, and
    the JAX side's cotangent g = cos(out)."""
    lg, h = torch.tensor(c["logits"]), torch.tensor(c["h"])
    drop = None if c["drop"] is None else torch.tensor(c["drop"])
    send, recv = torch.tensor(c["send"]), torch.tensor(c["recv"])
    out, den = tta.table_forward_plain(lg, h, drop, send, recv, N, E_REAL,
                                       c["eps"])
    g = torch.cos(torch.tensor(out_jax))
    return (lg, h, drop, send, recv, E_REAL, c["eps"], g, out, den,
            drop is not None)


def sender_kwargs(c, mode):
    """The sender runs as a caller hands them over: the Graph's order and
    offsets (of the real prefix), the order alone, or nothing."""
    if mode == "none":
        return {}
    order = torch.tensor(c["order"])
    if mode == "order":
        return dict(src_order=order)
    real = torch.tensor(c["send"])[order[:E_REAL].long()]
    return dict(src_order=order, src_ptr=torch.searchsorted(
        real, torch.arange(N + 1, dtype=torch.int32), out_int32=True))


def assert_near(got, want, atol, name):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got) / scale,
                               np.asarray(want) / scale, rtol=0, atol=atol,
                               err_msg=name)


CASES = [(nh, f, dropout) for nh, f in ((4, 32), (6, 11), (1, 7), (8, 8))
         for dropout in (False, True)]


@pytest.mark.parametrize("nh,f,dropout", CASES)
def test_by_sender_plain_matches_jax(nh, f, dropout):
    i = CASES.index((nh, f, dropout))
    eps = (0.0, 1e-8)[i % 2 ^ (i // 2) % 2]     # both eps with each mask
    past = i // 2 % 2 == 1
    mode = ("offsets", "order", "none")[i % 3]
    c = make_case(nh, f, 20 + i, dropout, eps, past)
    out_j, grads_j = run_jax(c)
    args = port_inputs(c, out_j)
    np.testing.assert_allclose(args[8].numpy(), out_j, rtol=1e-5, atol=1e-5)

    d_h, d_lg, d_dr = tta.table_backward(*args, **sender_kwargs(c, mode))
    got = [d_lg, d_h] + ([d_dr] if dropout else [])
    for a, b, nm in zip(got, grads_j, ("logits", "h", "drop")):
        assert np.isfinite(a.numpy()).all(), nm
        assert_near(a.numpy(), b, 2e-5, nm)
    assert torch.all(d_h[list(SILENT)] == 0)
    assert torch.all(d_lg[E_REAL:] == 0)
    if past:
        assert torch.all(d_lg[E_REAL - PAST:] == 0)
    if dropout:
        assert torch.all(d_dr[E_REAL:] == 0)
        # dden: the JAX cotangents give ex * dden[dst] on edges into a row
        dden = tta.table_dden_plain(args[7], args[8], args[9], eps)
        inside = (c["recv"] < N) & (np.arange(c["recv"].shape[0]) < E_REAL)
        ex = np.exp(c["logits"][inside])
        implied = grads_j[0][inside] - grads_j[2][inside] * c["drop"][inside]
        assert_near(ex * dden.numpy()[c["recv"][inside]], implied, 2e-5,
                    "dden")

    # the per-edge rows summed by sender in edge order
    rows, r_lg, r_dr = tta.table_backward_plain(*args)
    ref = tss.segment_rows_plain(rows, None, args[3], N)
    assert_near(d_h.numpy(), ref.numpy(), 1e-6, "d_h")
    assert torch.equal(d_lg, r_lg)
    assert (d_dr is None) == (r_dr is None)
    if dropout:
        assert torch.equal(d_dr, r_dr)


@pytest.mark.parametrize("mode", ["offsets", "order", "none"])
def test_by_sender_plain_reads_the_sender_runs(mode):
    """The three ways of handing over the sender runs walk the same
    edges: d(h) within 1e-6 of the scale of one another, and the runs
    the kernel would walk hold every real edge once, by sender."""
    c = make_case(4, 8, 3, True, 1e-8, True)
    args = port_inputs(c, np.zeros((N, 32), np.float32))
    want = tta.table_backward(*args, **sender_kwargs(c, "offsets"))
    got = tta.table_backward(*args, **sender_kwargs(c, mode))
    for a, b in zip(got, want):
        assert_near(a.numpy(), b.numpy(), 1e-6, mode)
    order, ptr = tta.sender_runs(args[3], E_REAL, N,
                                 **sender_kwargs(c, mode))
    walked = order[:int(ptr[-1])].long()
    real = walked[walked < E_REAL]
    assert sorted(real.tolist()) == list(range(E_REAL))
    ids = torch.repeat_interleave(torch.arange(N), ptr.long().diff())
    assert torch.equal(args[3][walked], ids.to(torch.int32))


def test_dden_and_backward_refuse_other_devices():
    c = make_case(1, 7, 1, False, 0.0, False)
    args = port_inputs(c, np.zeros((N, 7), np.float32))
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        tta.table_dden(meta[7], meta[8], meta[9], 0.0)
    with pytest.raises(ValueError, match="no kernel"):
        tta.table_backward(*meta)
    with pytest.raises(ValueError, match="src_ptr"):
        tta.table_backward(*args, src_order=torch.tensor(c["order"]),
                           src_ptr=torch.zeros(N, dtype=torch.int32))
