"""portbench/counts against counts made by hand for one small layer."""

import pytest

from portbench import counts

# n = 10 nodes, e = 30 edges, 2 heads of 3 features (D = 6), dropout on
N, E, NH, F = 10, 30, 2, 3


def test_attention_forward_by_hand():
    ops, nbytes = counts.attention_forward(N, E, NH, F, True)
    # source scores 2*10*6*2; per edge and head 5 + 2*3; the divide 10*6
    assert ops == 240 + 30 * 2 * 11 + 60
    # h, a_src, s_dst, the multipliers, out; senders and n + 1 offsets
    assert nbytes == 4 * (60 + 12 + 20 + 60 + 60) + 4 * (30 + 11)


def test_attention_backward_by_hand():
    ops, nbytes = counts.attention_backward(N, E, NH, F, False)
    assert ops == 30 * 2 * (8 + 12) + 4 * 10 * 6 * 2
    # g, h, s_dst, a_src, then d(h), d(s_dst), d(a_src)
    assert nbytes == 4 * (120 + 20 + 12 + 60 + 20 + 12) + 4 * 41


def test_step_of_one_layer_by_hand():
    config = {"num_layers": 1, "num_heads_per_layer": [2],
              "heads_concat_per_layer": [True],
              "head_output_features_per_layer": [5, 3],
              "add_skip_connection": [False], "dropout": 0.5}
    c = counts.Counts(config, [N], [E])
    product = 2 * 10 * 5 * 6          # x @ W; layer 0: d(W) only after
    scores = 2 * 10 * 6 * 2 * 3       # h @ a_dst forward and backward
    fwd = counts.attention_forward(N, E, NH, F, True)[0]
    bwd = counts.attention_backward(N, E, NH, F, True)[0]
    assert c.step_ops() == 2 * product + scores + fwd + bwd


def test_least_time_names_its_bound():
    t, bound = counts.least_seconds(67e12, 1.0)
    assert bound == "operations" and t == pytest.approx(1.0)
    t, bound = counts.least_seconds(1.0, 3.35e12)
    assert bound == "bytes" and t == pytest.approx(1.0)
