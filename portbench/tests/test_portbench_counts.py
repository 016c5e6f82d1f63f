"""portbench/counts, the forms' counts and the table op's contract against
counts made by hand for one small layer."""

import pytest

from portbench import counts
from portbench.counts import table
from portbench.spec import form_of

# n = 10 nodes, e = 30 edges, 2 heads of 3 features (D = 6), dropout on
N, E, NH, F = 10, 30, 2, 3
GAT = form_of({})
PAPER = form_of({"form": "gat_paper"})
ONE_LAYER = {"num_layers": 1, "num_heads_per_layer": [2],
             "heads_concat_per_layer": [True],
             "head_output_features_per_layer": [5, 3],
             "add_skip_connection": [False], "dropout": 0.5}


def test_attention_forward_by_hand():
    ops, nbytes = GAT.attention_forward(N, E, NH, F, True)
    # source scores 2*10*6*2; per edge and head 5 + 2*3; the divide 10*6
    assert ops == 240 + 30 * 2 * 11 + 60
    # h, a_src, s_dst, the multipliers, out; senders and n + 1 offsets
    assert nbytes == 4 * (60 + 12 + 20 + 60 + 60) + 4 * (30 + 11)


def test_attention_backward_by_hand():
    ops, nbytes = GAT.attention_backward(N, E, NH, F, False)
    assert ops == 30 * 2 * (8 + 12) + 4 * 10 * 6 * 2
    # g, h, s_dst, a_src, then d(h), d(s_dst), d(a_src)
    assert nbytes == 4 * (120 + 20 + 12 + 60 + 20 + 12) + 4 * 41


def test_step_of_one_layer_by_hand():
    c = counts.Counts(GAT, ONE_LAYER, [N], [E])
    product = 2 * 10 * 5 * 6          # x @ W; layer 0: d(W) only after
    scores = 2 * 10 * 6 * 2 * 3       # h @ a_dst forward and backward
    fwd = GAT.attention_forward(N, E, NH, F, True)[0]
    bwd = GAT.attention_backward(N, E, NH, F, True)[0]
    assert c.step_ops() == 2 * product + scores + fwd + bwd


def test_table_op_by_hand():
    ops, nbytes = table.forward(N, E, NH, F, True)
    # per edge and head exp, den add, drop multiply, 2*3; the divide
    assert ops == 30 * 2 * (3 + 6) + 60
    # logits, multipliers, h, out, den; senders and n + 1 offsets
    assert nbytes == 4 * (120 + 60 + 60 + 20) + 4 * (30 + 11)
    ops, nbytes = table.backward(N, E, NH, F, False)
    # per edge and head 8 + 4*3; d(den) 2*10*6 + 10*2
    assert ops == 30 * 2 * 20 + 120 + 20
    # g, h, out, den, logits, then d(h), d(logits); receivers, order and
    # n + 1 offsets
    assert nbytes == 4 * (180 + 20 + 60 + 60 + 60) + 4 * (60 + 11)
    # with dropout the multipliers are read too; no d(drop) is written
    assert table.backward(N, E, NH, F, True) == (
        ops, 4 * (180 + 20 + 60 + 60 + 60 + 60) + 4 * (60 + 11))


def test_paper_step_of_one_layer_by_hand():
    c = counts.Counts(PAPER, ONE_LAYER, [N], [E])
    product = 2 * 10 * 5 * 6
    # scores 2 * 2nD; per edge and head gather-add, LeakyReLU, max, subtract
    fwd = 4 * 60 + 4 * 60 + table.forward(N, E, NH, F, True)[0]
    # LeakyReLU's derivative and the two gathers' sums; 8nD the scores'
    bwd = table.backward(N, E, NH, F, True)[0] + 3 * 60 + 8 * 60
    assert PAPER.attention_forward(N, E, NH, F, True)[0] == fwd
    assert PAPER.attention_backward(N, E, NH, F, True)[0] == bwd
    assert c.step_ops() == 2 * product + fwd + bwd


def test_least_time_names_its_bound():
    t, bound = counts.least_seconds(67e12, 1.0)
    assert bound == "operations" and t == pytest.approx(1.0)
    t, bound = counts.least_seconds(1.0, 3.35e12)
    assert bound == "bytes" and t == pytest.approx(1.0)


def test_least_sums_each_steps_layers():
    c = counts.Counts(PAPER, ONE_LAYER, [N, 2 * N], [E, 3 * E])
    want = sum(counts.least_seconds(*table.forward(n, e, NH, F, True))[0]
               for n, e in ((N, E), (2 * N, 3 * E)))
    assert c.least(table.forward) == want
