"""The v5 backward by sender's work items (build.sender_items) and the
association they give d(h) and d(a_src) (v5_attention's split plain
versions).

The card's backward gives its warps items, runs of at most L slots of one
sender's run of src_order, L = build.split_limit of the real slot count,
the longest run and the warps; a longer run is cut into items in slot
order whose partial d(h) rows the tail adds in item order. Held here:
  * the item table on several run shapes and warp counts: every real slot
    in exactly one item, items in slot order and of at most L slots, only
    runs over L cut (into ceil(len / L) items, never more than there are
    warps, so that a run's items land on as many warps), the cut runs'
    partial rows numbered in item order; L following the counts; a graph
    of ogbn-arxiv's counts with one 14,521-slot hub among runs of at most
    35 slots cuts the hub alone; the table of a caller's runs built once
    and kept while its owner lives;
  * the split plain versions at 8 x 40 (a wide row) and 8 x 8, in the
    normalised, parts and 2-phase modes, on a graph whose hub is cut into
    items, against the per-edge route (v5_backward_plain plus the d(h)
    reduce by sender): d(drop) and d(s_dst) to the bits, d(h) to the bits
    on senders whose run is whole, and d(h) of the cut senders, d(a_src)
    and d(cap) within 1e-5 of max(1, |ref|): the same float32 terms summed
    in another association (partial rows, then their sum), whose rounding
    is a few units in the last place of sums of 200 terms, the tolerance
    tests/test_torch_v5_by_sender.py gives d(a_src) for the same reason.
"""

import gc

import numpy as np
import pytest
import torch

from gat_pytorch_tpu_torch.ops.cuda import build
from gat_pytorch_tpu_torch.ops.cuda import v5_attention as tv5
from gat_pytorch_tpu_torch.ops.cuda.rounding import FLOAT32
from gat_pytorch_tpu_torch.ops.cuda.segment_sum import dh_reduce_ptr

from .test_torch_parts import assert_close, op_inputs
from .test_torch_v5_by_sender import N, N_SRC, mode_args

TOL = 1e-5


def ptr_of(lens):
    return torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                        dtype=torch.int32)


def arxiv_hub_lens():
    """ogbn-arxiv's node count with near-Poisson runs of at most 35 slots
    (self-loop included) and one run of 14,521."""
    rng = np.random.default_rng(0)
    lens = np.minimum(rng.poisson(13.8, 169_343) + 1, 35)
    lens[4_242] = 14_521
    return lens


RUNS = {
    "short": lambda: np.random.default_rng(1).integers(0, 6, 300),
    "empty_senders": lambda: np.array([0, 0, 5, 0, 0, 3, 0]),
    "one_hub": lambda: np.array([2, 1, 500, 0, 3]),
    "hubs_at_the_ends": lambda: np.array([300, 1, 2, 64, 65, 128, 129, 700]),
    "heavy_tail": lambda: np.minimum(
        (np.random.default_rng(2).pareto(1.3, 5000) * 4).astype(np.int64),
        20_000),
}


def table_of(items):
    return {k: getattr(items, k).long().numpy()
            for k in ("ptr", "src", "part", "split_src", "split_ptr")}


@pytest.mark.parametrize("warps", [16, 160, 2112])
@pytest.mark.parametrize("runs", sorted(RUNS))
def test_item_table_covers_the_runs(runs, warps):
    lens = RUNS[runs]()
    ptr = ptr_of(lens)
    items = build.sender_items(ptr, warps)
    t = table_of(items)
    e_real, limit = int(lens.sum()), items.limit
    assert limit == build.split_limit(e_real, int(lens.max()), warps)
    assert (items.slots, items.n_items) == (e_real, t["src"].shape[0])
    # every real slot in exactly one item: the items tile [0, e_real) in
    # slot order, each of at most L slots
    assert t["ptr"][0] == 0 and t["ptr"][-1] == e_real
    sizes = np.diff(t["ptr"])
    assert (sizes >= 0).all() and (sizes <= limit).all()
    assert (np.diff(t["src"]) >= 0).all()
    # each sender's items lie inside its run, in order, and are as many as
    # ceil(len / L) (one for a run of L or fewer, empty runs included)
    per = np.bincount(t["src"], minlength=lens.size)
    want = np.maximum(1, -(-lens // limit))
    assert (per == want).all()
    first = np.concatenate([[0], np.cumsum(per)[:-1]])
    assert (t["ptr"][first] == ptr.numpy()[:-1]).all()
    # only runs over L are cut, and each cut run's items are fewer than the
    # warps: warp i % warps takes item i, so they land on as many warps
    cut = lens > limit
    assert (t["split_src"] == np.nonzero(cut)[0]).all()
    assert items.split_slots == int(lens[cut].sum())
    assert (per <= warps).all()
    whole = t["part"] < 0
    assert (whole == ~cut[t["src"]]).all()
    assert (t["part"][~whole] == np.arange(items.n_parts)).all()
    assert (np.diff(t["split_ptr"]) == per[cut]).all()
    assert items.n_parts == int(per[cut].sum())


@pytest.mark.parametrize("e_real,max_run,warps,want", [
    (2_501_829, 14_521, 2112, 75),      # ogbn-arxiv's counts: the share
    (2_501_829, 35, 2112, 75),
    (13_264, 169, 2112, 64),            # Cora's: the floor
    (600, 200, 160, 64),
    (5_000_000, 14_521, 2112, 148),     # twice the slots, twice L
    (100_000, 90_000, 16, 5625),        # a run past warps x L: its share
])
def test_split_limit_follows_the_counts(e_real, max_run, warps, want):
    assert build.split_limit(e_real, max_run, warps) == want


def test_arxiv_counts_with_one_hub_split_only_the_hub():
    lens = arxiv_hub_lens()
    warps = tv5.sender_warps(lens.size)
    assert warps == 2112
    items = build.sender_items(ptr_of(lens), warps)
    t = table_of(items)
    assert items.limit == 75 and items.n_split == 1
    assert t["split_src"].tolist() == [4_242]
    assert items.n_parts == -(-14_521 // 75) == 194
    assert items.split_slots == 14_521
    assert items.n_items == lens.size + 193
    # the hub's items on 194 warps, none of more than L slots
    hub = np.nonzero(t["src"] == 4_242)[0]
    assert np.unique(hub % warps).size == hub.size == 194
    assert np.diff(t["ptr"])[hub].max() == 75


def test_a_caller_s_table_is_built_once():
    """Kept with its owner (the caller's offsets, or the senders they were
    derived from, with a key), and dropped with it."""
    ptr = ptr_of(np.array([3, 0, 300, 5]))
    first = build.sender_items(ptr, 16, ptr)
    assert build.sender_items(ptr, 16, ptr) is first
    assert build.sender_items(ptr, 16) is not first     # a call's own
    other = build.sender_items(ptr, 32, ptr)            # another grid
    assert other is not first and other.limit == first.limit
    senders = torch.zeros(308, dtype=torch.int32)
    derived = build.sender_items(ptr, 16, senders, (308, 4))
    assert build.sender_items(ptr, 16, senders, (308, 4)) is derived
    assert build.sender_items(ptr, 16, senders, (300, 4)) is not derived
    keys = [k for k in build._ITEMS if k[0] in (id(ptr), id(senders))]
    assert len(keys) == 4
    del ptr, senders
    gc.collect()
    assert not any(k in build._ITEMS for k in keys)


# -- the split association -----------------------------------------------------

HUB, HUB_RUN, E_REAL, PAD = 7, 200, 600, 20


def hub_case(nh, f, seed=31):
    """The by-sender tests' sizes (N destinations, N_SRC source rows) with
    E_REAL real edges, HUB_RUN of them from sender HUB (cut into four
    items at L = 64), then PAD padding edges into the sink."""
    rng = np.random.default_rng(seed)
    recv = np.concatenate([np.sort(rng.integers(0, N - 1, E_REAL)),
                           np.full(PAD, N - 1)]).astype(np.int32)
    send = rng.integers(0, N_SRC - 1, E_REAL)
    send[rng.choice(E_REAL, HUB_RUN, replace=False)] = HUB
    send = np.concatenate([send, np.full(PAD, N_SRC - 1)]).astype(np.int32)
    c = op_inputs(rng, N_SRC, N, nh, f, E_REAL + PAD, True)
    c.update(n=N, n_src=N_SRC, nh=nh, f=f, e_real=E_REAL, send=send,
             recv=recv, order=np.argsort(send, kind="stable"
                                         ).astype(np.int32))
    return c


SPLIT = {tv5.v5_backward_by_sender_plain: tv5.v5_backward_split_plain,
         tv5.v5_backward_two_phase_by_sender_plain:
         tv5.v5_backward_two_phase_split_plain}


@pytest.mark.parametrize("mode", ["normalised", "parts", "two_phase"])
@pytest.mark.parametrize("nh,f", [(8, 40), (8, 8)])
def test_split_association_against_the_per_edge_route(nh, f, mode):
    c = hub_case(nh, f)
    by_sender, rows_plain, _, args, kw = mode_args(c, mode, FLOAT32)
    got = SPLIT[by_sender](*args, **kw)
    rows, *rest = rows_plain(*args, **kw)
    order, ptr = build.sender_runs(torch.tensor(c["send"]), E_REAL, N_SRC)
    items = build.sender_items(ptr, tv5.sender_warps(N_SRC))
    assert items.limit == 64 and items.split_src.tolist() == [HUB]
    assert items.n_parts == 4
    reduced = dh_reduce_ptr(rows, order, ptr)
    assert got[0].shape == reduced.shape == (N_SRC, nh * f)
    # d(drop), d(s_dst) to the bits; d(h) to the bits where no run is cut
    assert torch.equal(got[1], rest[0]) and torch.equal(got[2], rest[1])
    whole = torch.ones(N_SRC, dtype=torch.bool)
    whole[HUB] = False
    assert torch.equal(got[0][whole], reduced[whole])
    assert not torch.equal(got[0][HUB], torch.zeros(nh * f))
    # the cut run's d(h), d(a_src) and d(cap): another association
    assert_close([got[0][HUB].numpy()] + [x.numpy() for x in got[3:]],
                 [reduced[HUB].numpy()] + [x.numpy() for x in rest[2:]],
                 TOL, ("d_h of the hub", "d_a_src", "d_cap")[:len(got) - 2])
    # the by-sender plain version: the same bits but the hub's sums
    by = by_sender(*args, **kw)
    assert torch.equal(by[0][whole], got[0][whole])
    assert torch.equal(by[1], got[1]) and torch.equal(by[2], got[2])
