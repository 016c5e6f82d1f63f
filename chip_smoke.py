#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

    python3 chip_smoke.py --checks-only    (phases 1-2, then stop)

    python3 chip_smoke.py --hub-only       (phase 1, then the backward
                                            by sender on the hub graph)

    python3 chip_smoke.py --gatv2-only     (--hub-only's, then the GATv2
                                            op at its benchmark cell's
                                            shapes)

    python3 chip_smoke.py --paper-logits-only  (phase 1, then the paper
                                            form's logits op at its
                                            benchmark cell's shapes)

Six paths, three 2-phase forms and the bfloat16 modes, each at the full
width and depth of its configuration on the synthetic stand-in of its
dataset:
  Cora    `cli.train --dataset Cora`: the v5 attention op (kernels
          source_scores, v5_forward, v5_backward, which sums d(h) by
          sender; every v5 and windowed op runs source_scores once a
          forward);
  Pubmed  `cli.train --dataset Pubmed --reorder rcm`: RCM reorder, block
          layout, the windowed attention op (kernels window_forward and
          window_backward, which sums d(h) by sender);
  Pubmed cluster  `cli.train --dataset Pubmed --reorder cluster`: cluster
          order, the hybrid split-locality layout, the windowed parts op
          over the in-window edges plus the v5 parts op over the
          remainder (kernels window_forward, v5_forward,
          window_backward_parts, v5_backward_parts; both backwards sum
          d(h) by sender);
  PPI paper_faithful  `cli.train --dataset PPI --paper_faithful`:
          block-diagonal batches of two graphs, the table op (kernels
          table_forward, table_dden and table_backward, which sums d(h)
          by sender) at 1024- and 726-wide rows, its logits' two score
          gathers reduced in the backward by segment_sum_sorted;
  PPI     `cli.train --dataset PPI`: the v5 op at the same widths (the
          backward by sender's wide plans, which sum d(h) in shared
          memory);
  PATTERN `cli.train --dataset PATTERN`: 4 layers with skip projections,
          batches of eight graphs, the plateau schedule, the v5 op;
  under the JAX package's 2-phase knobs (set around each fit, CELL_ENV):
  Cora two-phase (GAT_TPU_V10=0) and Cora unmerged (GAT_TPU_V5_MERGED=0)
          the v5 op's 2-phase form (kernels v5_cap, v5_forward_two_phase,
          v5_backward_two_phase);
  Pubmed two-phase (GAT_TPU_V10=0, RCM): the windowed op's 2-phase form
          (window_cap, window_forward_two_phase,
          window_backward_two_phase);
  Pubmed cluster two-phase (GAT_TPU_V10=0, cluster order): the v6 form,
          the v5 2-phase kernels over the graph's own edges;
  and the JAX package's bfloat16 numerics (the float32 fits above pin
  GAT_TPU_V6_DTYPE=float32): with GAT_TPU_GEMM_DTYPE=bfloat16 (bench.py's
  numerics) and the windowed op's default bfloat16 payload, Pubmed bf16
          (RCM: window_forward_bf16, window_backward_bf16 in the packed
          window mode), Pubmed two-phase bf16, Pubmed cluster bf16 and
          Pubmed cluster two-phase bf16 (the v6 form's bfloat16 mode on the
          v5 2-phase kernels); with GAT_TPU_KERNEL_DTYPE, GAT_TPU_H_DTYPE,
          GAT_TPU_GEMM_DTYPE = bfloat16 and GAT_TPU_DH_REDUCE_NT=0, Cora
          bf16 kernels (v5_forward_bf16, v5_backward_bf16 on a bfloat16 h
          table; the backward by sender reads no GAT_TPU_DH_REDUCE_NT, so
          no fit runs segment_sum_rows_t, the feature-major d(h) reduce,
          which phase 2 holds),
          PPI paper_faithful bf16 (table_forward_bf16, table_dden,
          table_backward_bf16), and two more that reach the remaining
          modes: Cora two-phase bf16 kernels (v5_cap_bf16) and Pubmed
          cluster bf16 kernels (v5_backward_parts_bf16);
  with the attention regulariser (`--attention_reward`,
  `--attention_penalty`): Cora attention (v5), Pubmed attention (RCM,
  windowed) and PPI paper_faithful attention (table), whose alpha (from
  the score tables or the layer's logits) sums through
  segment_sum_sorted: four launches a v5 or windowed layer a train step,
  two a table layer; and Cora naive (`--layer_type naive`, the plain-torch
  oracle layer: no kernel);
  Cora sampled `cli.train --dataset Cora --sampling_fanouts 10,10
          --sampling_batch_size 128`: each epoch two neighbour-sampled
          subgraphs of the train nodes (data/sampling.py, one bucket,
          the next epoch's built by the prefetch thread) on the v5 op, and
          the full graph's validation forward;
  Cora gatv2 `cli.train --dataset Cora --gatv2`: GATv2's dynamic
          attention on the GATv2 op (kernels gatv2_forward and
          gatv2_backward: a pass by destination, a pass by sender, the
          tail);
  and the edge-sharded path (Trainer.fit_sharded, the cut-neighbourhood
  layout) under a one-rank NCCL process group: Cora sharded, PPI
  paper_faithful sharded (also with the regulariser, two more sorted sums
  a layer) and Cora sharded bf16 kernels
          (GAT_TPU_KERNEL_DTYPE and GAT_TPU_GEMM_DTYPE = bfloat16), each
          layer the partial v2 op (kernels v2_forward or v2_forward_bf16,
          v2_backward, and segment_sum_sorted for the gradients of the
          h_src gather and the two score gathers);
  and the dst-owned layout (Trainer.fit_sharded(dst_owned=True): each
  graph partitioned by destination, parallel/partition.py) on the same
  group: Cora dst-owned (the sharded_v5 branch: the v5 parts op over the
  shard's rows), Pubmed dst-owned (RCM, sharded_v7: the windowed parts
  op over the shard's own block layout), Pubmed cluster dst-owned
  (sharded_v7_hybrid: both parts ops) and PPI paper_faithful dst-owned
  (sharded_v4_table: the table op over the shard's rows).

Phases (every failure is fatal):
  1. build the CUDA kernels from gat_pytorch_tpu_torch/ops/cuda/csrc
     (one nvcc per library, started together: each source, and the three
     attention sources again for a bfloat16 h table), print a [build]
     line per kernel instance with its registers and local memory
     (cuobjdump -res-usage; no instance of the v5, windowed, table and v2
     forwards, of the source-score pass, of the window and v5 backwards by sender and
     their tail, of the v2 backward, of the d(den) prologue or of the
     GATv2 op may use any, nor may the backwards by sender, their tail,
     the v2 kernels, the table forward, the d(den) prologue and the GATv2
     kernels spill: ptxas's report); build
     the native graphcore library (csrc/graphcore.cpp with $CXX or g++
     into build/graphcore/; a [build] line with its seconds), with which
     every graph below is built; and print the card's name and power
     limit as nvidia-smi gives them;
  2. the source-score pass (the table every v5 and windowed kernel reads
     its logits from) at every width the fits run, from float32 and
     bfloat16 tables, against its plain version, twice for equal bits,
     with more source rows than destinations and off 16-byte alignment;
     at each path's layer shapes (Cora 8 heads x 8 features and 1 x 7;
     Pubmed 8 x 8 and 8 x 3; PPI 4 x 256 and 6 x 121; PATTERN 4 x 12,
     4 x 24 and 1 x 1) on its graph or on one batch of its graphs, run
     each kernel's wrapper and its plain PyTorch version on the same card
     tensors and hold them together: with and without the dropout mask,
     the v5 and window backward also at eps = 1, the table kernels at
     eps = 0 on max-subtracted logits (PPI) and at eps = 1e-8 with dropout
     (PPI, Cora 8 x 8) and without (PATTERN), the table and v5 backwards
     by sender as the main path calls them (the Graph's order and
     offsets) and deriving their sender runs (the two equal bits), their
     d(h) also against the row-3 reduce of the plain per-edge rows on the
     card (bits compared and printed), zero on senders without a real
     edge; the v5, window and table kernels are also launched twice and
     must give the same bits. The
     parts modes of the v5 and window backward take random d(num) and
     d(den), are held at every output's own magnitude and launched
     twice, at all these
     shapes and on the hybrid layout of the cluster-ordered Pubmed
     stand-in and its remainder (the parts forwards there too, and the
     v5 parts op with more source rows than destinations); the window
     backward's d(h), summed by sender, also against row 3 over the plain
     version's per-slot rows (bits compared and printed), and every window
     backward mode at 1 x 7 and 8 x 128 on the Pubmed layout; the sorted
     segment sum at widths 4 and 6 (PPI, by receiver and by sender) and
     8, 24, 64, 1024 (Pubmed), and its contract case by case
     (check_sorted_forms: one segment of 100,000 rows, a row a segment,
     ids past the segments, empty segments, D = 1 to 1024, through ids,
     ids read by a permutation and offsets, with and without row_limit,
     a table off 16-byte alignment; the forms to each other's bits), and
     the sorted-gradient gather built on it, also as the main path calls
     it with the Graph's offsets (one launch, the bits of the call
     without); at PPI's widths the v5 backward by sender in every mode
     and fused_gat_table with more source rows than destinations; before
     Cora's, the v5 backward by sender on a graph whose node 0 sends
     14,521 edges (check_hub_backward: its run cut into items) at 8 x 40
     and 8 x 8 in every mode, against the split plain versions, launched
     twice, and timed, and from a bfloat16 h table at PPI's 4 x 256 and
     6 x 121 and at 8 x 40 (check_bf16_wide_by_sender: the wide plans of
     the bfloat16-table library) in every mode, within 1e-2 of the split
     plain versions, launched twice (--hub-only: phase 1, these checks,
     then stop); then the GATv2 op (check_gatv2) on the graph of
     the benchmark's arxiv_powerlaw traffic as the port builds it
     (169,344 rows, 2.5M edges, a run of 14,521 slots by destination and
     by sender, the longest sender runs cut into items) at the
     arxiv-powerlaw-gatv2 cell's 8 x 8 and 8 x 40, with and without the
     attention mask, each output within 1e-5 of its plain version's
     largest value, launched twice, and timed beside the warm plain
     versions and the op's contract (--gatv2-only: stop after it);
     then the paper form's logits op (check_paper_logits) on the graph
     of the benchmark's arxiv_like traffic at the arxiv-full-paper
     cell's 8 x 8 and 8 x 40: its logits and the gradients into the two
     score tables the bits of the torch chain it replaced, on two
     launches, timed beside the chain and the bytes bound
     (--paper-logits-only: phase 1, this check, then stop);
     the 2-phase entries (cap pass, forward, backward with d(cap)) at
     the Cora, PPI and PATTERN shapes, on the RCM layout and on the
     cluster-ordered edge list, at the cap, above and below it, eps =
     1e-8 and 1, with and without dropout, each launched twice; and
     fused_gat_table with v5_local_cap on more source rows than
     destinations (the bits of the square call, but for the sums over
     blocks of senders: d(a_src) and d(cap), and where d(cap) is routed,
     held at 1e-4); every bfloat16 mode of every entry (the flags word of
     ops/cuda/rounding.py) at the cells' layer shapes, against its plain
     version in the same mode and in float32 on the same inputs (within
     1e-2 of the scale, and 10x nearer the same mode's plain version than
     the float32 one, in RMS, wherever the mode moves an output), launched
     twice for equal bits; and segment_sum_rows_t against its plain version
     and against segment_sum_rows's bits; rows 3 and 4 on their own
     (check_dh_rows) at D = 1, 7, 24, 64, 726 and 1024 with empty
     segments, a segment of 300 rows and rows past row_limit, through a
     sender list without offsets and with the Graph's (the two equal
     bits), against their plain versions, to the bits of the
     ordered reference (ordered_dh_sum), of each other and of a second
     launch; the v2 entries in both modes at
     the Cora and PPI shapes, with and without the dropout mask (the
     backward also at eps = 1, at each output's own magnitude and over
     fewer rows than the receivers reach, the forward with the Graph's
     dst_ptr to the bits of the call without and in its bfloat16 mode,
     each launched twice), and the cut
     contract: the partial kernel over 4 contiguous slices of the edge
     list, summed and divided, against the unsharded normalised kernel
     and its plain version;
  2f. the dst-owned branches' kernels shard by shard, without a process
     group: each of 4 shards of Cora (v5 parts), the RCM Pubmed layout
     (windowed parts), the cluster-ordered Pubmed (both parts ops over
     the shard's layout and its remainder) and a PPI batch (table op),
     partitioned by destination (N/4 destination rows, the N-row h
     table), forward and backward with dropout against their plain
     versions (d(h) over all N rows); the shards' outputs without
     dropout joined (the global cap' the largest shard cap') against the
     unsharded op; and the v5 and windowed parts ops over a shard without
     edges (a padded bucket's last shard): zeros, cap' -1e30, code 0,
     zero gradients and no launch;
  3. train each stand-in for the epochs of CELLS through the port's
     Trainer (the code the CLI runs), with every launch counter set to 0
     just before and read just after; the train loss must be finite and
     fall, every kernel of the path must have run the expected number of
     times, and PATH_TRACE must name the path;
  4. hold the trained model's logits and the gradients of its training
     loss (the regulariser included) on the kernel path
     against the plain segment-op path on the card (Pubmed: the windowed
     path also against the v5 kernel path on the same reordered graph
     without its block layout; a 2-phase model also against the
     single-sweep kernel path; a regularised model's alpha of each layer
     and its attention norm also against the segment path and the naive
     layer; the naive model against the segment path);
     a bfloat16 model against the float32 kernel path and the segment path
     of the same model at 1e-2 of the scale, and it must differ from the
     float32 kernel path by more than 10x the float32 paths' own difference
     (the mode is live);
     then two PPI paper_faithful fits, two hybrid Pubmed fits, two
     Pubmed bf16 fits, two Cora attention fits and two Cora sampled fits
     of a few epochs, each pair from one seed, must give
     the same bits in every epoch's losses and in every parameter, and
     so must a Cora fit on the graph with its CSR offsets and one on the
     graph without them (and the trained model's logits and gradients),
     and a Cora sampled fit and a PPI paper_faithful fit with the prefetch
     thread and one without it (PREFETCH_REPRO), and the prefetch
     iterator's own copies to the card (put=True) must equal the batches;
  4c. under a one-rank NCCL process group (destroyed on any exit), train
     the sharded cells as phase 3 does, hold each trained sharded model's
     logits and gradients against the single-device kernel path and the
     sharded segment path (a bfloat16 model at 1e-2 against the float32
     ones, and live), hold two Cora sharded fits from one seed to equal
     bits, and time and profile the sharded step beside the
     single-device step; then the dst-owned cells (DST_CELLS) the same
     way, each held against the single-device kernel path and the
     dst-owned segment path, two Cora dst-owned fits to equal bits, and
     each dst-owned step timed in turns beside the cut-neighbourhood step
     of the same cell with the collectives each makes a step
     (`[collectives]` lines: kind, shape, bytes);
  4d. in a temporary directory under build/: a Cora fit of 10 epochs
     with checkpoint_every_n_epochs=5 and a metrics file (the JSONL rows
     must equal the history); resume_state from its epoch-5 snapshot and
     5 train steps must give its final parameters to the bits (the Adam
     state and the CUDA generator's state restored); cli.train.run with
     exec_type "load" must print the train run's test metrics; a Cora fit
     with track_grads (histograms to a recording logger) must give the
     bits of one without;
  4e. the last modules ported: the native graphcore library against its
     numpy form as equal arrays (the Pubmed stand-in's self-loops, sort
     and permutation, CSR offsets and RCM order; PPI's block-diagonal
     batches), sample_neighbors' invariants (min(k, degree) distinct
     slots of each seed's run, over every node of Cora and Pubmed), and
     a [graph] line with the host ms of RCM and of a sampled Cora epoch's
     build, native beside numpy; the attention extraction of cli/vis.py
     (its _load_params and get_test_graph, then vis.attention's
     extract_attention) on Cora from 4d's epoch-5 snapshot (before its
     directory is removed), and with seed-0 weights on the first test
     graph of PPI and of PATTERN (v5 path) and of PATTERN under
     paper_faithful (table path), each with the launch counters set to 0
     just before and read just after (a layer: source_scores, v5_forward
     and segment_sum_sorted, or table_forward and segment_sum_sorted;
     added to the result line's launches), alpha of every layer against
     the segment path within 1e-4, each real node's alphas summing to 1,
     the entropies no larger than the uniform ones, and the entropies and
     degree-scaled weights of the two paths within 1e-4 (the figures need
     matplotlib, which this machine may lack: the CPU tests hold them);
     utils/profiling: time_fn's median of the Cora eval forward, and a
     trace of three Cora train steps (one under span("gat_layer_0"))
     and an attention extraction, parsed for both regions, the port's own
     spans and the port's kernels (v5_fwd_kernel, source_scores_kernel,
     v5_bwd_sender_kernel, sorted_sum_kernel), with the three steps'
     records: each phase's device time and the step's host syncs;
  5. time each kernel and bfloat16 mode (CUDA graph replays; a v5 or
     windowed forward or cap entry with its source-score pass, a backward
     entry given its op's table, as the main path calls them), its plain
     version and, where one PyTorch call computes the same function, that
     call (rows 3 and 4 also without the graph's offsets and as the bare
     kernel launch, time_dh_rows); time the
     train step on each path (a 2-phase fit's beside the single-sweep
     step of the same model and graph, a regularised fit's beside the
     same step without the regulariser, the naive fit's beside the v5
     kernel path's; Cora, Pubmed and the PPI fits
     also on the graph without its offsets) and profile a short window of
     steps; time
     the table op against the v5 op on one PATTERN batch, and the hybrid
     step with its remainder through plain segment ops; the sampled Cora
     step beside the full-graph step, an epoch of the sampled and PPI
     paper_faithful fits with and without the prefetch thread, the host
     build of a sampled epoch, and save_checkpoint at Cora's and PPI's
     widths;
  6. print one {"kernels": [...]} line, then the {"ok": true, ...} line.

It exits non-zero without printing a result when there is no GPU or when
the port's package is not beside it.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
import types
from unittest import mock

# scratch space of phase 4d (checkpoints), gitignored
ROOT_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "build")
SHAPES = {"Cora": ((8, 8), (1, 7)),      # (heads, features) per layer
          "Pubmed": ((8, 8), (8, 3)),
          "PPI": ((4, 256), (6, 121)),   # layers 1-2 share 4 x 256
          "PATTERN": ((4, 12), (4, 24), (1, 1))}   # layer 3 is 4 x 12 again
DROPOUT = 0.6
SLOPE = 0.01
PF_SLOPE = 0.2      # LeakyReLU slope under paper_faithful and gatv2
# the GATv2 op's check (check_gatv2): the benchmark cell whose graph it
# runs on (its traffic drawn from GATV2_SEED), the cell's layer shapes, the
# hub's slots (the largest in- and out-run of that traffic, self-loop in)
# and the tolerance, a share of each output's largest value
GATV2_CELL = "arxiv-powerlaw-gatv2"
GATV2_SEED = 2147484301
GATV2_SHAPES = ((8, 8), (8, 40))
GATV2_HUB = 14_521
GATV2_TOL = 1e-5
# the paper form's logits op's check (check_paper_logits): the benchmark
# cell whose graph it runs on (its traffic drawn from PAPER_SEED) and the
# cell's layer shapes
PAPER_CELL = "arxiv-full-paper"
PAPER_SEED = 2147484401
PAPER_SHAPES = ((8, 8), (8, 40))
# the fits of phase 3: name -> (dataset, config overrides, epochs, layer
# path, layers); the first two are cut from up to 1000 epochs with early
# stopping, PPI and PATTERN further, since an epoch there is 10 and 32
# train steps
CELLS = {
    "Cora": ("Cora", {}, 50, "v5", 2),
    "Pubmed": ("Pubmed", {"reorder": "rcm"}, 50, "v7", 2),
    "Pubmed cluster": ("Pubmed", {"reorder": "cluster"}, 50, "v7_hybrid", 2),
    "PPI paper_faithful": ("PPI", {"paper_faithful": True}, 30, "v4_table",
                           3),
    "PPI": ("PPI", {}, 10, "v5", 3),
    "PATTERN": ("PATTERN", {}, 5, "v5", 4),
    # the 2-phase forms, under the JAX package's knobs (CELL_ENV); the
    # layer path's PATH_TRACE name is the first word
    "Cora two-phase": ("Cora", {}, 50, "v5 2-phase", 2),
    "Cora unmerged": ("Cora", {}, 10, "v5 2-phase", 2),
    "Pubmed two-phase": ("Pubmed", {"reorder": "rcm"}, 50, "v7 2-phase", 2),
    "Pubmed cluster two-phase": ("Pubmed", {"reorder": "cluster"}, 20, "v6",
                                 2),
    # the JAX package's bfloat16 numerics (CELL_ENV)
    "Pubmed bf16": ("Pubmed", {"reorder": "rcm"}, 50, "v7 bf16", 2),
    "Pubmed two-phase bf16": ("Pubmed", {"reorder": "rcm"}, 20,
                              "v7 2-phase bf16", 2),
    "Pubmed cluster bf16": ("Pubmed", {"reorder": "cluster"}, 20,
                            "v7_hybrid bf16", 2),
    "Pubmed cluster two-phase bf16": ("Pubmed", {"reorder": "cluster"}, 10,
                                      "v6 bf16", 2),
    "Cora bf16 kernels": ("Cora", {}, 50, "v5 bf16", 2),
    "PPI paper_faithful bf16": ("PPI", {"paper_faithful": True}, 10,
                                "v4_table bf16", 3),
    "Cora two-phase bf16 kernels": ("Cora", {}, 10, "v5 2-phase bf16", 2),
    "Pubmed cluster bf16 kernels": ("Pubmed", {"reorder": "cluster"}, 5,
                                    "v7_hybrid bf16 kernels", 2),
    # the attention regulariser (cli: --attention_reward,
    # --attention_penalty) on three kernel paths, and the naive oracle
    # layer (--layer_type naive), which launches no kernel
    "Cora attention": ("Cora", {"attention_reward": 0.1}, 20,
                       "v5 attention", 2),
    "Pubmed attention": ("Pubmed", {"reorder": "rcm",
                                    "attention_reward": 0.1}, 10,
                         "v7 attention", 2),
    "PPI paper_faithful attention": ("PPI", {"paper_faithful": True,
                                             "attention_penalty": 0.05}, 5,
                                     "v4_table attention", 3),
    "Cora naive": ("Cora", {"layer_type": "naive"}, 10, "naive", 2),
    # neighbour-sampled minibatches (cli: --sampling_fanouts 10,10
    # --sampling_batch_size 128): each epoch two sampled subgraphs of the
    # train nodes, in one bucket, and the full graph's validation forward
    "Cora sampled": ("Cora", {"sampling_fanouts": "10,10",
                              "sampling_batch_size": 128}, 20, "v5", 2),
    # GATv2's dynamic attention (cli: --gatv2) on the GATv2 op
    "Cora gatv2": ("Cora", {"gatv2": True}, 20, "gatv2", 2),
}
# the environment each fit runs under, set and restored around it; the
# float32 fits of the windowed op pin its contraction dtype (the JAX
# package's default is bfloat16)
F32 = {"GAT_TPU_V6_DTYPE": "float32"}
GEMM_BF16 = {"GAT_TPU_GEMM_DTYPE": "bfloat16"}
KERNELS_BF16 = {"GAT_TPU_KERNEL_DTYPE": "bfloat16",
                "GAT_TPU_H_DTYPE": "bfloat16", "GAT_TPU_DH_REDUCE_NT": "0",
                **GEMM_BF16}
TWO_PHASE = {"GAT_TPU_V10": "0"}
CELL_ENV = {"Pubmed": F32, "Pubmed cluster": F32, "Pubmed attention": F32,
            "Cora two-phase": TWO_PHASE,
            "Cora unmerged": {"GAT_TPU_V5_MERGED": "0"},
            "Pubmed two-phase": {**TWO_PHASE, **F32},
            "Pubmed cluster two-phase": {**TWO_PHASE, **F32},
            "Pubmed bf16": GEMM_BF16,
            "Pubmed two-phase bf16": {**TWO_PHASE, **GEMM_BF16},
            "Pubmed cluster bf16": GEMM_BF16,
            "Pubmed cluster two-phase bf16": {**TWO_PHASE, **GEMM_BF16},
            "Cora bf16 kernels": KERNELS_BF16,
            "PPI paper_faithful bf16": KERNELS_BF16,
            "Cora two-phase bf16 kernels": {**TWO_PHASE, **KERNELS_BF16},
            "Pubmed cluster bf16 kernels": KERNELS_BF16,
            "Cora sharded bf16 kernels": {"GAT_TPU_KERNEL_DTYPE": "bfloat16",
                                          **GEMM_BF16},
            "Pubmed dst-owned": F32, "Pubmed cluster dst-owned": F32}
# the numerics knobs a bfloat16 fit sets: without them, the same model
# runs the float32 path (phase 4)
BF16_KNOBS = ("GAT_TPU_GEMM_DTYPE", "GAT_TPU_KERNEL_DTYPE", "GAT_TPU_H_DTYPE")
# per path: the kernels of a layer's forward (each launched once per layer
# and name: a name twice, twice), and of its backward (each launched once
# per layer unless a count says otherwise). Every v5 and windowed op
# computes its source-score table once in its forward (source_scores, or
# source_scores_bf16 from a bfloat16 h table) and hands it to its cap
# pass, forward and backward; the hybrid layer computes one for both its
# ops where their kernels read the same h table, else one each. The
# table path's two sorted sums are the gradients of its logits' score
# gathers (by sender and by receiver), which every model on that path
# here has. Under paper_faithful (every table fit here) the logits are
# one op, its forward and its backward launched once a layer; those two
# sums are its backward's.
PATH_KERNELS = {
    # the backward sums d(h) by sender itself at every width and table
    # type (PPI's too): no segment_sum_rows
    "v5": (("source_scores", "v5_forward"), {"v5_backward": 1}),
    # the window backward sums d(h) by sender itself: no segment_sum_rows
    "v7": (("source_scores", "window_forward"), {"window_backward": 1}),
    # the table backward sums d(h) by sender itself: no segment_sum_rows
    "v4_table": (("paper_logits_forward", "table_forward"),
                 {"paper_logits_backward": 1, "table_dden": 1,
                  "table_backward": 1, "segment_sum_sorted": 2}),
    # the remainder's backward sums its d(h) by sender too
    "v7_hybrid": (("source_scores", "window_forward", "v5_forward"),
                  {"window_backward_parts": 1, "v5_backward_parts": 1}),
    # v5_cap and window_cap each launch the cap stream and its reduce
    "v5 2-phase": (("source_scores", "v5_cap", "v5_forward_two_phase"),
                   {"v5_backward_two_phase": 1}),
    "v7 2-phase": (("source_scores", "window_cap",
                    "window_forward_two_phase"),
                   {"window_backward_two_phase": 1}),
    "v6": (("source_scores", "v5_cap", "v5_forward_two_phase"),
           {"v5_backward_two_phase": 1}),
    "v7 bf16": (("source_scores_bf16", "window_forward_bf16"),
                {"window_backward_bf16": 1}),
    "v7 2-phase bf16": (("source_scores", "window_cap",
                         "window_forward_two_phase_bf16"),
                        {"window_backward_two_phase_bf16": 1}),
    "v7_hybrid bf16": (("source_scores_bf16", "window_forward_bf16",
                        "source_scores", "v5_forward"),
                       {"window_backward_parts_bf16": 1,
                        "v5_backward_parts": 1}),
    "v6 bf16": (("source_scores", "v5_cap", "v5_forward_two_phase_bf16"),
                {"v5_backward_two_phase_bf16": 1}),
    # under GAT_TPU_DH_REDUCE_NT=0 too: the backward by sender reads no
    # knob and runs no d(h) reduce
    "v5 bf16": (("source_scores_bf16", "v5_forward_bf16"),
                {"v5_backward_bf16": 1}),
    # the logits op is float32 in every mode
    "v4_table bf16": (("paper_logits_forward", "table_forward_bf16"),
                      {"paper_logits_backward": 1, "table_dden": 1,
                       "table_backward_bf16": 1, "segment_sum_sorted": 2}),
    "v5 2-phase bf16": (("source_scores_bf16", "v5_cap_bf16",
                         "v5_forward_two_phase_bf16"),
                        {"v5_backward_two_phase_bf16": 1}),
    # the sharded layer: the partial v2 op; its backward's sorted sums
    # are the gradients of the h_src gather and of the two score gathers
    "sharded_v4_partial": (("v2_forward",),
                           {"v2_backward": 1, "segment_sum_sorted": 3}),
    "sharded_v4_partial bf16": (("v2_forward_bf16",),
                                {"v2_backward": 1, "segment_sum_sorted": 3}),
    # the dst-owned layer's branches: the parts ops (the single sweep)
    # over a shard's rows, or the table op over them; the global cap' and
    # the epilogue are plain torch and collectives
    "sharded_v5": (("source_scores", "v5_forward"),
                   {"v5_backward_parts": 1}),
    "sharded_v7": (("source_scores", "window_forward"),
                   {"window_backward_parts": 1}),
    "sharded_v7_hybrid": (("source_scores", "window_forward", "v5_forward"),
                          {"window_backward_parts": 1,
                           "v5_backward_parts": 1}),
    "sharded_v4_table": (("table_forward",),
                         {"table_dden": 1, "table_backward": 1,
                          "segment_sum_sorted": 2}),
    # both parts ops sum their d(h) by sender and read no
    # GAT_TPU_DH_REDUCE_NT
    "v7_hybrid bf16 kernels": (("source_scores_bf16", "window_forward_bf16",
                                "v5_forward_bf16"),
                               {"window_backward_parts_bf16": 1,
                                "v5_backward_parts_bf16": 1}),
    # the regulariser's alpha, in train steps only (a validation forward
    # asks for no attention): a v5 or windowed layer adds four sorted sums,
    # alpha's denominator and the backwards of its three sorted-gradient
    # gathers (the two score gathers and the denominator's); a table or
    # sharded layer two, the denominator's sum and gather, since alpha
    # shares the layer's logits and their score gathers; a paper_faithful
    # table layer two more, as alpha takes its logits from the score
    # gathers (the logits op's are past the max)
    "v5 attention": (("source_scores", "v5_forward"),
                     {"v5_backward": 1, "segment_sum_sorted": 4}),
    "v7 attention": (("source_scores", "window_forward"),
                     {"window_backward": 1, "segment_sum_sorted": 4}),
    "v4_table attention": (("paper_logits_forward", "table_forward"),
                           {"paper_logits_backward": 1, "table_dden": 1,
                            "table_backward": 1,
                            "segment_sum_sorted": 2 + 2 + 2}),
    "sharded_v4_partial attention": (("v2_forward",),
                                     {"v2_backward": 1,
                                      "segment_sum_sorted": 3 + 2}),
    # the oracle layer: plain torch, no kernel of this repository
    "naive": ((), {}),
    # the GATv2 op: its forward, and its backward's three launches (the
    # passes by destination and by sender, the tail) in one entry
    "gatv2": (("gatv2_forward",), {"gatv2_backward": 1}),
}
REPRO_EPOCHS = {"PPI paper_faithful": 2, "Pubmed cluster": 5,
                "Pubmed bf16": 5, "Cora attention": 5, "Cora sampled": 5,
                "Cora gatv2": 5}
# fits held to the same bits with the prefetch thread and without it
# (Trainer.prefetch): cells of multi-batch epochs
PREFETCH_REPRO = {"Cora sampled": 5, "PPI paper_faithful": 3}
# the sharded fits of phase 4c, under a one-rank NCCL process group
# (Trainer.fit_sharded, the cut-neighbourhood layout; the card is one,
# so the edge axis has one shard and every collective is a real NCCL
# call on it): name -> (dataset, config overrides, epochs, layer path,
# layers), as CELLS
SHARDED_CELLS = {
    "Cora sharded": ("Cora", {}, 50, "sharded_v4_partial", 2),
    "PPI paper_faithful sharded": ("PPI", {"paper_faithful": True}, 10,
                                   "sharded_v4_partial", 3),
    "Cora sharded bf16 kernels": ("Cora", {}, 10,
                                  "sharded_v4_partial bf16", 2),
    "PPI paper_faithful sharded attention": (
        "PPI", {"paper_faithful": True, "attention_penalty": 0.05}, 3,
        "sharded_v4_partial attention", 3),
}
SHARDED_REPRO = ("Cora sharded", 5)
# the dst-owned fits of phase 4c, on the same one-rank group
# (Trainer.fit_sharded(dst_owned=True): the graphs partitioned by
# destination, a Pubmed graph's per-shard block layout from its own, plain
# or hybrid), as CELLS; and the cells of phase 2f's per-shard holds at
# K = DST_K shards without a process group: name -> (graph, partition
# keywords, branch, layer shape)
DST_CELLS = {
    "Cora dst-owned": ("Cora", {}, 20, "sharded_v5", 2),
    "Pubmed dst-owned": ("Pubmed", {"reorder": "rcm"}, 10, "sharded_v7", 2),
    "Pubmed cluster dst-owned": ("Pubmed", {"reorder": "cluster"}, 10,
                                 "sharded_v7_hybrid", 2),
    "PPI paper_faithful dst-owned": ("PPI", {"paper_faithful": True}, 5,
                                     "sharded_v4_table", 3),
}
DST_REPRO = ("Cora dst-owned", 5)
DST_K = 4
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# kernel vs plain version on the card: sums run in another order
# (per-warp shuffles against matmul / index_add), float32 rounding only
REL_TOL = 1e-4
# the same in a bfloat16 mode, and a bfloat16 model against the float32
# paths: one float32 difference in the last bit can move a bfloat16
# rounding by 2^-8 of one term
BF16_TOL = 1e-2
_PALLAS = "gat_pytorch_tpu/ops/pallas/"
_CSRC = "gat_pytorch_tpu_torch/ops/cuda/csrc/"
REPLACES = {
    "v5_forward": _PALLAS + "segment_attention.py:1265",
    "v5_backward": _PALLAS + "segment_attention_bwd.py:537",
    "segment_sum_rows": _PALLAS + "segment_sum.py:120",
    "window_forward": _PALLAS + "segment_attention_window.py:163",
    "window_backward": _PALLAS + "segment_attention_window.py:923",
    "table_forward": _PALLAS + "segment_attention.py:269",
    "table_backward": _PALLAS + "segment_attention_bwd.py:178",
    # the d(den) prologue of the same TPU kernel (:204-210), its own launch
    "table_dden": _PALLAS + "segment_attention_bwd.py:178",
    # the same TPU kernels in their normalize=False (sweep-1 parts) mode
    "v5_backward_parts": _PALLAS + "segment_attention_bwd.py:537",
    "window_backward_parts": _PALLAS + "segment_attention_window.py:923",
    "segment_sum_sorted": _PALLAS + "segment_sum.py:30",
    # the 2-phase forms: the cap pre-pass, the explicit-cap forward (also
    # the merged _kernel_v5_auto's 2-phase mode, :1265), and the
    # backward's sweep1=False mode; the windowed kernels' phase 0, phase
    # 1 and backward in their 2-phase mode
    "v5_cap": _PALLAS + "segment_attention.py:1117",
    "v5_forward_two_phase": _PALLAS + "segment_attention.py:809",
    "v5_backward_two_phase": _PALLAS + "segment_attention_bwd.py:537",
    "window_cap": _PALLAS + "segment_attention_window.py:163",
    "window_forward_two_phase": _PALLAS + "segment_attention_window.py:163",
    "window_backward_two_phase": (_PALLAS
                                  + "segment_attention_window.py:923"),
    # the feature-major d(h) reduce (GAT_TPU_DH_REDUCE_NT=0)
    "segment_sum_rows_t": _PALLAS + "segment_sum.py:70",
    # the v2 op over a pre-gathered edge table (both modes; the sharded
    # path runs its partial mode)
    "v2_forward": _PALLAS + "segment_attention.py:65",
    "v2_backward": _PALLAS + "segment_attention_bwd.py:39",
    # the per-edge h_blk @ a_src inside _kernel_v5_auto (and _kernel_v5,
    # _kernel_v5_cap, _kernel_v5_bwd, _kernel_v6, _kernel_v6_bwd): one pass
    # over the h table an op call, read by every v5 and windowed kernel
    "source_scores": _PALLAS + "segment_attention.py:1265",
    # GATv2's op: the JAX package has no GATv2 layer, so no TPU kernel
    "gatv2_forward": "none",
    "gatv2_backward": "none",
    # the paper form's logits: the JAX package forms them in XLA
    "paper_logits_forward": "none",
    "paper_logits_backward": "none",
}
SOURCES = {
    "v5_forward": _CSRC + "v5_attention.cu",
    "v5_backward": _CSRC + "v5_attention.cu",
    "segment_sum_rows": _CSRC + "segment_sum.cu",
    "window_forward": _CSRC + "window_attention.cu",
    "window_backward": _CSRC + "window_attention.cu",
    "table_forward": _CSRC + "table_attention.cu",
    "table_backward": _CSRC + "table_attention.cu",
    "table_dden": _CSRC + "table_attention.cu",
    "v5_backward_parts": _CSRC + "v5_attention.cu",
    "window_backward_parts": _CSRC + "window_attention.cu",
    "segment_sum_sorted": _CSRC + "segment_sum.cu",
    "v5_cap": _CSRC + "v5_attention.cu",
    "v5_forward_two_phase": _CSRC + "v5_attention.cu",
    "v5_backward_two_phase": _CSRC + "v5_attention.cu",
    "window_cap": _CSRC + "window_attention.cu",
    "window_forward_two_phase": _CSRC + "window_attention.cu",
    "window_backward_two_phase": _CSRC + "window_attention.cu",
    "segment_sum_rows_t": _CSRC + "segment_sum.cu",
    "v2_forward": _CSRC + "segment_attention.cu",
    "v2_backward": _CSRC + "segment_attention.cu",
    "source_scores": _CSRC + "attention_common.cuh",
    "gatv2_forward": _CSRC + "gatv2_attention.cu",
    "gatv2_backward": _CSRC + "gatv2_attention.cu",
    "paper_logits_forward": _CSRC + "paper_logits.cu",
    "paper_logits_backward": _CSRC + "paper_logits.cu",
}
# every bfloat16 mode of an entry: the same TPU kernel and source, its
# launches counted apart (rounding.Rounding.counter)
BF16_KEYS = tuple(k + "_bf16" for k in REPLACES
                  if not k.startswith(("segment_sum", "window_cap",
                                       "v2_backward", "table_dden",
                                       "gatv2",
                                       "paper_logits")))
for _k in BF16_KEYS:
    REPLACES[_k], SOURCES[_k] = REPLACES[_k[:-5]], SOURCES[_k[:-5]]
BWD_NAMES = ("d_h", "d_drop", "d_s_dst", "d_a_src")
TABLE_BWD_NAMES = ("d_h", "d_logits", "d_drop")
V2_BWD_NAMES = ("d_logits", "d_h_src", "d_drop")


def launches_per_epoch(path, layers, train_batches, val_batches):
    """Launches per epoch of a fit on `path`: each layer's forward runs
    in every train step and in every validation batch, its backward
    kernels in every train step."""
    fwd, bwd = PATH_KERNELS[path]
    per = {k: 0 for k in REPLACES}
    for k in fwd:
        per[k] += layers * (train_batches + val_batches)
    for k, count in bwd.items():
        per[k] = count * layers * train_batches
    return per


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# the kernels that must use no local memory in any instance (cuobjdump):
# the forwards (the v5, windowed, table and v2 ops'), the source-score pass, the backwards by
# sender (the windowed op's and the v5 op's) with their tail, the v2
# backward and the d(den) prologue, the GATv2 op's kernels and the paper
# form's logits
NO_LOCAL = {"v5_fwd_kernel": r"v5_fwd_kernel",
            "window_fwd_kernel": r"window_fwd_kernel",
            "table_fwd_kernel": r"table_fwd_kernel",
            "v2_fwd_kernel": r"v2_fwd_kernel",
            "source_scores_kernel": r"source_scores_kernel",
            "window_bwd_kernel": r"window_bwd_kernel",
            "v5_bwd_sender_kernel": r"v5_bwd_sender_kernel",
            "bwd_tail_kernel": r"bwd_tail_kernel",
            "v2_bwd_kernel": r"v2_bwd_(wide_)?kernel",
            "dden_kernel": r"\d+dden_(narrow_)?kernel",
            "gatv2_fwd_kernel": r"gatv2_fwd_kernel",
            "gatv2_bwd_kernel": r"gatv2_bwd_(dst|src)_kernel",
            "paper_logits_kernel": r"paper_logits_(fwd|bwd)_kernel"}
# of those, the kernels whose registers must not spill either (ptxas's
# spill stores and loads, which cuobjdump's LOCAL does not count: they go
# to the stack frame)
NO_SPILL = ("window_bwd_kernel", "v5_bwd_sender_kernel", "bwd_tail_kernel",
            "v2_bwd_kernel", "dden_kernel", "v2_fwd_kernel",
            "table_fwd_kernel", "gatv2_fwd_kernel", "gatv2_bwd_kernel",
            "paper_logits_kernel")


def check_resource_usage(build):
    """A [build] line per kernel instance of every library: its registers
    and its local memory (spilled registers, local arrays) as cuobjdump
    -res-usage reports them, and ptxas's spill stores and loads. No
    instance of a NO_LOCAL kernel may use local memory, nor may one of a
    NO_SPILL kernel spill; their registers are summed up per kernel."""
    found = {name: [] for name in NO_LOCAL}
    for lib in build.LIBRARIES:
        ptxas = build.spills(lib)
        for sym, reg, local, stack in build.resource_usage(lib):
            frame, st, ld = ptxas.get(sym, (None, None, None))
            print(f"[build] {lib} {sym}: registers {reg}, local {local} "
                  f"bytes, stack {stack} bytes, spill stores {st} and "
                  f"loads {ld} bytes")
            for name, pattern in NO_LOCAL.items():
                if re.search(pattern, sym):
                    found[name].append((lib, sym, reg, local, st, ld))
    for name, rows in found.items():
        if not rows:
            fail(f"no {name} instance in cuobjdump's report")
        for lib, sym, reg, local, st, ld in rows:
            if local:
                fail(f"{lib} {sym}: {name} uses {local} bytes of local "
                     f"memory")
            if name in NO_SPILL and (st is None or st or ld):
                fail(f"{lib} {sym}: {name} spills ({st} bytes stored, "
                     f"{ld} loaded; None: no ptxas report)")
        print(f"[build] {len(rows)} {name} instances, no local memory "
              f"(registers {sorted({r[2] for r in rows})})")


def knobs(env):
    """The environment variables of `env` set for a `with` block and
    restored after it, on any exit."""
    return mock.patch.dict(os.environ, env)


def under(env, fn):
    """fn, to be run with the knobs of `env`."""
    def run():
        with knobs(env):
            return fn()
    return run


def max_err(got, want, floor=1.0):
    """(max |got - want|, max(floor, max |want|))."""
    got, want = got.float(), want.float()
    return (float((got - want).abs().max()),
            max(floor, float(want.abs().max())))


def hold(name, got, want, errs, floor=1.0, tol=REL_TOL):
    """Fail unless got is within tol x max(floor, max |want|) of want.
    floor=0 holds an output at its own magnitude, which must be non-zero
    for the check to mean anything."""
    err, scale = max_err(got, want, floor)
    print(f"  {name}: max_abs_err {err:.3e} (scale {scale:.3e})")
    if not scale > 0.0:
        fail(f"{name}: the plain version is all zeros, nothing to hold")
    if not err <= tol * scale:
        fail(f"{name} differs from its plain version: {err} > "
             f"{tol} x {scale}")
    errs.append(err)


def time_ms(torch, fn, calls=20, replays=10):
    """Mean device milliseconds per call of `fn`: `calls` calls captured
    in one CUDA graph, replayed `replays` times between CUDA events, so
    the host's launch overhead is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def step_time_ms(torch, fn, iters=30, warmup=5):
    """Mean milliseconds per eager call, host launch overhead included
    (CUDA events around back-to-back calls)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_host(fn):
    """Host milliseconds of one call of fn, the card synchronised before
    and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def op_inputs(torch, gen, n, nh, f, slots, dev):
    """Seeded inputs of an attention op at one layer shape: h, a_src, the
    B-shifted s_dst, a dropout mask over `slots` edge slots, and g."""
    d = nh * f
    h = torch.randn((n, d), generator=gen, device=dev)
    a_src = torch.randn((d, nh), generator=gen, device=dev) / d ** 0.5
    s_dst = torch.randn((n, nh), generator=gen, device=dev)
    s_eff = (s_dst - ((h @ a_src).max() + s_dst.max())).contiguous()
    drop = ((torch.rand((slots, nh), generator=gen, device=dev) >= DROPOUT)
            .float() / (1.0 - DROPOUT))
    g = torch.randn((n, d), generator=gen, device=dev)
    return h, a_src, s_eff, drop, g


def epilogue(torch, num, den, cap, f, eps):
    """(out, eps') of the ops' normalising epilogue."""
    epsp = eps * torch.exp(SLOPE * cap)
    return num / (den.repeat_interleave(f, dim=1) + epsp), epsp


def profile_steps(torch, step, step_ms, label, steps=5, top=12):
    """Profile `steps` train steps; print the device's busy time per step,
    its idle share of `step_ms`, and the top kernels and host operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    events = [ev for ev in prof.key_averages()
              if ev.device_type == DeviceType.CUDA
              and not ev.is_user_annotation]
    dev_us = sum(ev.self_device_time_total for ev in events) / steps
    launches = sum(ev.count for ev in events) / steps
    print(f"[profile] {label}, {steps} train steps: kernels busy "
          f"{dev_us:.1f} us/step in {launches:.0f} launches/step of "
          f"{step_ms * 1e3:.1f} us/step (device idle "
          f"{1 - dev_us / (step_ms * 1e3):.3f}); top kernels:")
    for ev in sorted(events, key=lambda ev: -ev.self_device_time_total)[:top]:
        print(f"  {ev.self_device_time_total / steps:9.1f} us/step "
              f"{ev.count / steps:5.1f}/step  {ev.key[:90]}")
    if top:
        host = [ev for ev in prof.key_averages()
                if ev.device_type == DeviceType.CPU]
        print("[profile] top host operations by self CPU time (under the "
              "profiler, which slows the host):")
        for ev in sorted(host, key=lambda ev: -ev.self_cpu_time_total)[:top]:
            print(f"  {ev.self_cpu_time_total / steps:9.1f} us/step "
                  f"{ev.count / steps:5.1f}/step  {ev.key[:90]}")


# -- rows 3 and 4, the d(h) reduce: checks and timings shared by main() ------
# The widths of every d(h) reduce the fits run (Cora 64 and 7, Pubmed 24,
# PPI 1024 and 726) and of a one-feature row.
DH_WIDTHS = (1, 7, 24, 64, 726, 1024)
DH_KEYS = ("segment_sum_rows", "segment_sum_rows_t")


def ordered_dh_sum(torch, values, order, ptr, row_limit):
    """Rows 3 and 4's contract written out on the card, in their order:
    for k = 0, 1, ... every segment adds its k-th row (if it has one and
    the row is under row_limit) to its sum, one float add an element, so
    each sum adds its rows in ascending position from 0."""
    n = ptr.shape[0] - 1
    lo, lens = ptr[:-1].long(), (ptr[1:] - ptr[:-1]).long()
    acc = torch.zeros((n, values.shape[1]), device=values.device)
    top = max(order.shape[0] - 1, 0)
    for k in range(int(lens.max()) if n else 0):
        src = order.long()[(lo + k).clamp(max=top)]
        take = (k < lens) & (src < row_limit)
        row = values.index_select(0, src.clamp(max=values.shape[0] - 1))
        acc = torch.where(take[:, None], acc + row, acc)
    return acc


def dh_cases(torch, np, dev, seed=0):
    """Two seeded cases of the d(h) reduce, as host arrays on `dev`:
    "offsets": 1,500 segments of 0-12 rows, 200 of them empty and one of
    300 rows, read through an order with repeats, a fifth of whose rows
    lie past row_limit; "graph": a sender list of 9,000 real edges with a
    hub of 300 and 700 padding edges on the sink, its stable sender order
    and the offsets of its real edges, as a caller without offsets hands
    it over (rows past E_real are the padding edges')."""
    rng = np.random.default_rng(seed)
    n = 1500
    lens = rng.integers(0, 13, n)
    lens[rng.choice(n, 200, replace=False)] = 0
    lens[700] = 300
    e = int(lens.sum())
    rows = e + 64
    ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    order = rng.integers(0, rows, e).astype(np.int32)
    i32 = dict(dtype=torch.int32, device=dev)
    offsets = dict(rows=rows, limit=int(rows * 0.8), n=n,
                   ptr=torch.tensor(ptr, **i32),
                   order=torch.tensor(order, **i32))
    e_real, pad = 9000, 700
    senders = rng.integers(0, n - 1, e_real)
    senders[rng.choice(e_real, 300, replace=False)] = 11      # the hub
    senders = np.concatenate([senders, np.full(pad, n - 1)]).astype(np.int32)
    src_order = np.argsort(senders, kind="stable").astype(np.int32)
    src_ptr = np.searchsorted(senders[src_order[:e_real]],
                              np.arange(n + 1)).astype(np.int32)
    graph = dict(rows=e_real + pad, limit=e_real, n=n,
                 senders=torch.tensor(senders, **i32),
                 order=torch.tensor(src_order, **i32),
                 src_ptr=torch.tensor(src_ptr, **i32))
    return offsets, graph


def check_dh_rows(torch, np, ss, dev, errs, widths=DH_WIDTHS):
    """Rows 3 and 4 at each width on both dh_cases: against their plain
    versions (rows past row_limit are NaN in the kernels' input, zero in
    the plain version's: a row not skipped fails), to equal bits with
    ordered_dh_sum, with each other and across two launches; the graph
    case with and without its offsets to equal bits, and a table that is
    not 16-byte aligned (the float-at-a-time form of a float4 width) to
    the bits of the aligned one."""
    offsets, graph = dh_cases(torch, np, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)

    def same(name, x, y):
        torch.cuda.synchronize()
        if not torch.equal(x, y):
            bad = int((x != y).any(1).nonzero()[0, 0])
            fail(f"{name}: not the same bits (first at segment {bad}: "
                 f"{x[bad, :4].tolist()} against {y[bad, :4].tolist()})")

    def table(case, d):
        vals = torch.randn((case["rows"], d), generator=gen, device=dev)
        vals[case["limit"]:] = float("nan")
        return vals, torch.where(torch.isnan(vals), torch.zeros_like(vals),
                                 vals)

    for d in widths:
        firsts = []
        c_off, c_gr = offsets, graph
        vals_off, zeroed_off = table(c_off, d)
        vals_gr, zeroed_gr = table(c_gr, d)
        ids_off = torch.repeat_interleave(
            torch.arange(c_off["n"], device=dev), c_off["ptr"].long().diff())
        ids_gr = c_gr["senders"].index_select(0, c_gr["order"].long())
        ptr_gr = torch.searchsorted(
            ids_gr, torch.arange(c_gr["n"] + 1, dtype=torch.int32,
                                 device=dev), out_int32=True)
        for t in (False, True):
            key = DH_KEYS[t]
            tag = f"{key} D={d}"
            plain_fn = ss.segment_rows_t_plain if t else ss.segment_rows_plain

            def run(v=vals_off, t=t):
                return ss._segment_rows_cuda(v, c_off["order"], c_off["ptr"],
                                             c_off["limit"], transposed=t)
            got = run()
            hold(f"{tag} (offsets, empty and long segments, rows past "
                 f"row_limit)", got,
                 plain_fn(zeroed_off, c_off["order"], ids_off, c_off["n"]),
                 errs[key])
            same(f"{tag} against the ordered reference", got,
                 ordered_dh_sum(torch, vals_off, c_off["order"],
                                c_off["ptr"], c_off["limit"]))
            same(f"{tag}: two launches", got, run())
            if d % 4 == 0:
                flat = torch.empty(c_off["rows"] * d + 1, device=dev)[1:]
                same(f"{tag}: a table off 16-byte alignment", got,
                     run(flat.view(c_off["rows"], d).copy_(vals_off)))
            derived = ss.dh_reduce(vals_gr, c_gr["order"], c_gr["senders"],
                                   c_gr["n"], c_gr["limit"], transposed=t)
            carried = ss.dh_reduce(vals_gr, c_gr["order"], c_gr["senders"],
                                   c_gr["n"], c_gr["limit"], transposed=t,
                                   src_ptr=c_gr["src_ptr"])
            hold(f"{tag} (a sender list without offsets, padding rows on "
                 f"the sink)", derived,
                 plain_fn(zeroed_gr, c_gr["order"], ids_gr, c_gr["n"]),
                 errs[key])
            same(f"{tag}: with and without offsets", carried, derived)
            same(f"{tag} (graph) against the ordered reference", derived,
                 ordered_dh_sum(torch, vals_gr, c_gr["order"], ptr_gr,
                                c_gr["limit"]))
            firsts.append((got, carried))
        for x, y in zip(*firsts):
            same(f"segment_sum_rows_t against segment_sum_rows D={d}", y, x)
        print(f"[kernels] rows 3 and 4 at D={d}: within {REL_TOL} of their "
              f"plain versions, the ordered reference's bits, each other's, "
              f"with offsets the bits without, two launches equal")


def time_dh_rows(torch, ss, label, rows, order, src_ptr, n, senders=None,
                 e_real=None, lib=None):
    """Print rows 3 and 4 at one shape, each timed (time_ms) four ways:
    the wrapper as the main path calls it (with the offsets the graph or
    layout carries: dh_reduce / dh_reduce_ptr), the kernel launch alone
    (_segment_rows_cuda), the wrapper without offsets where the caller
    has a sender list (the stable sort, gather and searchsorted before
    the kernel: build.sender_runs), and `lib`, the one
    PyTorch call (index_add_) over the real rows; beside them the plain
    version. The bound counts the real rows read once, their indices and
    the offsets once, the table written once. Returns {key: (main path
    ms, bound ms, library ms)}."""
    d = rows.shape[1]
    er = int(src_ptr[-1])
    bm, by = bound_ms(4 * (er * d + er + n + 1 + n * d), er * d)
    lm = time_ms(torch, lib) if lib is not None else None
    ids = torch.repeat_interleave(torch.arange(n, device=rows.device),
                                  src_ptr.long().diff())
    out = {}
    for t, key in enumerate(DH_KEYS):
        plain = ss.segment_rows_t_plain if t else ss.segment_rows_plain
        pm = time_ms(torch, lambda p=plain: p(rows, order[:er], ids, n))
        if senders is None:
            def main(t=t):
                return ss.dh_reduce_ptr(rows, order, src_ptr, bool(t))
        else:
            def main(t=t):
                return ss.dh_reduce(rows, order, senders, n, e_real, bool(t),
                                    src_ptr=src_ptr)
        km = time_ms(torch, main)
        alone = time_ms(torch, lambda t=t: ss._segment_rows_cuda(
            rows, order, src_ptr, transposed=bool(t)))
        derived = ""
        if senders is not None:
            dm = time_ms(torch, lambda t=t: ss.dh_reduce(
                rows, order, senders, n, e_real, bool(t)))
            derived = f", without offsets {dm:.4f}"
        print(f"[time] {key} {label} (D={d}, {er} rows, {n} segments): "
              f"main path {km:.4f} ms, kernel alone {alone:.4f}{derived}, "
              f"index_add_ {'null' if lm is None else f'{lm:.4f}'}, plain "
              f"{pm:.4f}, bound {bm:.5f} ({by})")
        out[key] = (km, bm, lm)
    return out


# -- phase 4e: the native graphcore library, vis and profiling --------------

# the graphs of phase 4e's attention extraction (cli/vis.py's _load_params
# and get_test_graph): name -> (dataset, config overrides, the eval
# forward's layer path). The port runs v5 at every edge count (the JAX
# package's table op below 4096 edges is a gate on the TPU's launch cost,
# not ported), so a PATTERN test graph takes v5, and the table path is
# the same graph under paper_faithful.
VIS_GRAPHS = {"Cora": ("Cora", {}, "v5"),
              "PPI": ("PPI", {}, "v5"),
              "PATTERN": ("PATTERN", {}, "v5"),
              "PATTERN paper_faithful": ("PATTERN", {"paper_faithful": True},
                                         "v4_table")}
# the kernels a layer's eval forward with return_attention launches, once
# each: the path's forward (the table path's paper_faithful logits op and
# the table op) and alpha's denominator (segment_sum_sorted)
VIS_KERNELS = {"v5": ("source_scores", "v5_forward", "segment_sum_sorted"),
               "v4_table": ("paper_logits_forward", "table_forward",
                            "segment_sum_sorted")}
# the kernels a written trace must name (train steps on the v5 path, and
# an attention extraction for the sorted sum)
TRACE_KERNELS = ("v5_fwd_kernel", "source_scores_kernel",
                 "v5_bwd_sender_kernel", "sorted_sum_kernel")


def check_graphcore(np, core, datasets, sampling, cli_train, get_config,
                    ppi_train, cora_raw, card):
    """Phase 4e's holds of the native graphcore library: each function
    against its numpy form as equal arrays (the Pubmed stand-in: self-loops,
    the sort with its permutation, CSR offsets, the RCM order; PPI's
    block-diagonal batches), sample_neighbors' invariants, and the host ms
    of RCM and of a sampled Cora epoch's build on either."""
    if not core.native_available():
        fail("the native graphcore library is not loaded")

    def numpy_form(fn, *args, **kw):
        with mock.patch.object(core, "_load", lambda: None):
            return fn(*args, **kw)

    def same(label, fn, *args, **kw):
        got, want = fn(*args, **kw), numpy_form(fn, *args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if len(got) != len(want) or not all(
                a.dtype == b.dtype and np.array_equal(a, b)
                for a, b in zip(got, want)):
            fail(f"graphcore {label}: the native library differs from its "
                 f"numpy form")
        return got

    raw = datasets.load_planetoid("Pubmed", synthetic_override=True, seed=0)
    n, s, r = raw.num_nodes, raw.senders, raw.receivers
    ls, lr = same("add_remaining_self_loops", core.add_remaining_self_loops,
                  s, r, n)
    _, sr, _ = same("sort_by_destination", core.sort_by_destination, ls, lr,
                    return_perm=True)
    same("csr_offsets", core.csr_offsets, sr, n)
    (order,) = same("rcm_order", core.rcm_order, s, r, n)
    if not np.array_equal(np.sort(order), np.arange(n)):
        fail("graphcore rcm_order: not a permutation")
    for i in range(0, len(ppi_train), 2):
        chunk = ppi_train[i:i + 2]
        same(f"block_diagonal (PPI batch {i // 2})", core.block_diagonal,
             np.concatenate([g.senders for g in chunk]),
             np.concatenate([g.receivers for g in chunk]),
             np.array([g.num_nodes for g in chunk]),
             np.array([g.num_edges for g in chunk]))
    # sample_neighbors over slot ids: exactly min(k, degree) distinct slots
    # a seed, each inside its seed's run, the seeds in order; the same
    # draw over the senders reads those slots
    draws = 0
    for label, g in (("Cora", cora_raw), ("Pubmed", raw)):
        csr = sampling.CSRGraph(g.senders, g.receivers, g.num_nodes)
        slots = np.arange(csr.senders.size, dtype=np.int64)
        seeds = np.arange(csr.num_nodes, dtype=np.int64)
        deg = np.diff(csr.offsets)
        for k in (1, 4, 10, 25):
            got, dst = core.sample_neighbors(csr.offsets, slots, seeds, k,
                                             k + 7)
            src, dst2 = core.sample_neighbors(csr.offsets, csr.senders,
                                              seeds, k, k + 7)
            ok = (np.array_equal(np.bincount(dst, minlength=csr.num_nodes),
                                 np.minimum(k, deg))
                  and np.unique(got).size == got.size
                  and bool(((got >= csr.offsets[dst])
                            & (got < csr.offsets[dst + 1])).all())
                  and bool((np.diff(dst) >= 0).all())
                  and np.array_equal(dst2, dst)
                  and np.array_equal(src, csr.senders[got]))
            if not ok:
                fail(f"graphcore sample_neighbors on {label} at k={k}: not "
                     f"min(k, degree) distinct slots of each seed's run")
            draws += got.size
    # host ms: RCM, and a sampled Cora epoch's build (both packages' CLI
    # settings), native beside the numpy form
    rcm, builds = {}, {}
    cfg = get_config("Cora", sampling_fanouts="10,10",
                     sampling_batch_size=128)
    for branch, call in (("native", lambda fn, *a: fn(*a)),
                         ("numpy", numpy_form)):
        rcm[branch] = []
        for _ in range(3 if branch == "native" else 1):
            t0 = time.perf_counter()
            call(core.rcm_order, s, r, n)
            rcm[branch].append(round((time.perf_counter() - t0) * 1e3, 2))
        sampler = cli_train.neighbour_sampler(cora_raw, cfg)
        builds[branch] = []
        for i in range(3):
            t0 = time.perf_counter()
            epoch = call(sampler.epoch, i)
            builds[branch].append(round((time.perf_counter() - t0) * 1e3, 1))
    print(f"[graphcore] native against numpy, equal arrays: the Pubmed "
          f"stand-in ({n} nodes, {s.size} edges: self-loops, sort and "
          f"permutation, CSR offsets, RCM order), {len(ppi_train) // 2} PPI "
          f"block-diagonal batches; sample_neighbors' invariants at k = 1, "
          f"4, 10, 25 over every node of Cora and Pubmed ({draws} slots)")
    print(f"[graph] host ms on the machine of the {card}: RCM of the "
          f"Pubmed stand-in "
          f"native {rcm['native']}, numpy {rcm['numpy']}; a sampled Cora "
          f"epoch's build ({len(epoch)} subgraphs, fanouts 10,10, batch 128) "
          f"native {builds['native']}, numpy {builds['numpy']}")


def hold_vis(torch, np, A, gat, build, label, params, cfg, graph, path,
             launches):
    """Phase 4e on one graph: extract_attention on the kernel path with
    the launch counters set to 0 just before and read just after (each
    kernel of VIS_KERNELS[path] once a layer, no other; added to
    `launches`), then alpha of every layer against the segment path's
    (REL_TOL), each real node's alphas summing to 1, the entropies no
    larger than the uniform ones and, with the degree-scaled weights,
    held against the segment path's."""
    gat.PATH_TRACE.clear()
    build.reset_launches()
    torch.cuda.synchronize()
    logits, att = A.extract_attention(params, cfg, graph)
    torch.cuda.synchronize()
    ran = {k: v for k, v in build.LAUNCHES.items() if v}
    want = {k: cfg.num_layers for k in VIS_KERNELS[path]}
    print(f"[vis] {label}: {graph.num_nodes} nodes, {graph.num_real_edges} "
          f"real edges; paths {sorted(set(gat.PATH_TRACE))}; launches {ran}")
    if ran != want or gat.PATH_TRACE != [path] * cfg.num_layers:
        fail(f"vis {label}: launches {ran} on paths {gat.PATH_TRACE}, "
             f"expected {want} on {path}")
    for k, v in ran.items():
        launches[k] += v
    if logits.shape != (graph.num_nodes, cfg.num_classes) or \
            not np.isfinite(logits).all():
        fail(f"vis {label}: logits {logits.shape}, or not finite")
    with torch.no_grad():
        _, seg_att = gat.gat_model_apply(params, cfg, graph,
                                         device=graph.device,
                                         backend="segment",
                                         return_attention=True)
    recv = graph.receivers.cpu().numpy()
    emask = graph.edge_mask.cpu().numpy()
    deg = np.bincount(recv[emask], minlength=graph.num_nodes)
    real = graph.node_mask.cpu().numpy() & (deg > 0)
    for li, (a, b) in enumerate(zip(att, seg_att)):
        b = b.cpu().numpy()
        err = float(np.abs(a - b).max())
        sums = np.zeros((graph.num_nodes, a.shape[1]))
        np.add.at(sums, recv[emask], a[emask])
        sum_err = float(np.abs(sums[real] - 1.0).max())
        ents, unis = A.attention_entropies(a, graph)
        seg_ents, seg_unis = A.attention_entropies(b, graph)
        over = float((ents - unis).max())
        ent_err = float(np.abs(ents - seg_ents).max())
        w_err = max(float(np.abs(
            A.degree_scaled_weights(a, graph, h, np.inf)[0]
            - A.degree_scaled_weights(b, graph, h, np.inf)[0]).max())
            for h in range(a.shape[1]))
        print(f"  layer {li} ({a.shape[1]} heads): alpha against the "
              f"segment path {err:.3e}; sums to 1 within {sum_err:.3e}; "
              f"entropy - uniform at most {over:.3e} over {ents.size} "
              f"(node, head) pairs; entropies against the segment path's "
              f"{ent_err:.3e}, degree-scaled weights {w_err:.3e}")
        if not (err <= REL_TOL and sum_err <= REL_TOL and over <= 1e-5
                and ents.shape == seg_ents.shape and ent_err <= REL_TOL
                and np.array_equal(unis, seg_unis) and w_err <= REL_TOL):
            fail(f"vis {label} layer {li}: alpha {err}, sums {sum_err}, "
                 f"entropy over uniform {over}, entropies {ent_err}, "
                 f"weights {w_err} (limits {REL_TOL}, 1e-5)")
    return att


def check_profiling(torch, prof_utils, A, gat, O, trainer, params, cfg,
                    graph, logdir, card):
    """time_fn of the Cora eval forward; a trace of three Cora train steps
    (the second under span("gat_layer_0")) and an attention extraction
    (under span("extract_attention")), parsed: it must name both regions,
    the port's spans of a step and the kernels of TRACE_KERNELS; the
    three steps' records must give each phase a device time."""
    with torch.no_grad():
        sec, out = prof_utils.time_fn(
            lambda: gat.gat_model_apply(params, cfg, graph,
                                        device=graph.device),
            warmup=2, iters=20)
    print(f"[profile] time_fn: the Cora eval forward (4d's epoch-5 "
          f"parameters), median {sec * 1e3:.4f} ms of 20 calls after 2 of "
          f"warm-up, host launches included, on {card}")
    if out.shape != (graph.num_nodes, cfg.num_classes):
        fail(f"time_fn returned {tuple(out.shape)}")
    train_params = trainer.init_params()
    opt = O.adam_l2(gat.parameters(train_params), trainer.learning_rate,
                    trainer.weight_decay)
    gen = trainer.dropout_generator()
    with prof_utils.trace(logdir) as prof:
        trainer.train_step(train_params, opt, graph, gen)
        with prof_utils.span("gat_layer_0"):
            trainer.train_step(train_params, opt, graph, gen)
        trainer.train_step(train_params, opt, graph, gen)
        with prof_utils.span("extract_attention"):
            A.extract_attention(train_params, cfg, graph)
        torch.cuda.synchronize()
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    found = {k: sum(k in name for name in kernels) for k in TRACE_KERNELS}
    spans = {"gat.step", "gat.forward", "gat.backward", "gat.optimizer",
             "gat.layer.0", "gat.op.v5_attention.forward",
             "gat.op.v5_attention.backward"}
    print(f"[profile] trace: {os.path.basename(prof.trace_path)}, "
          f"{os.path.getsize(prof.trace_path)} bytes, {len(events)} events, "
          f"{len(kernels)} kernel launches; regions gat_layer_0 "
          f"{'gat_layer_0' in names}, extract_attention "
          f"{'extract_attention' in names}; the port's spans missing "
          f"{sorted(spans - names)}; the port's kernels {found}")
    steps = prof_utils.records()[-3:]
    for rec in steps:
        phases = {name: sum(s.device_ms for s in rec.named(name))
                  for name in ("gat.step", "gat.forward", "gat.backward",
                               "gat.optimizer")}
        print(f"[profile] step record {rec.step_id}: device ms "
              + ", ".join(f"{k} {v:.4f}" for k, v in phases.items())
              + f"; host syncs {rec.counters['host_syncs']}")
        if not all(v > 0.0 for v in phases.values()):
            fail(f"step record {rec.step_id}: a phase without device time")
    if not {"gat_layer_0", "extract_attention"} <= names or \
            not spans <= names or not all(found.values()) or \
            len(steps) != 3:
        fail("the written trace misses an annotated region, a span or a "
             "kernel of the port, or the records a step")


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gat_pytorch_tpu_torch.cli import train as cli_train
    from gat_pytorch_tpu_torch.cli import vis as cli_vis
    from gat_pytorch_tpu_torch.data import datasets, loader, sampling
    from gat_pytorch_tpu_torch.data.prefetch import PrefetchIterator
    from gat_pytorch_tpu_torch.graph import graphcore_binding as core
    from gat_pytorch_tpu_torch.models import gat
    from gat_pytorch_tpu_torch.ops import segment as seg
    from gat_pytorch_tpu_torch.ops.cuda import build
    from gat_pytorch_tpu_torch.ops.cuda import segment_attention as sa
    from gat_pytorch_tpu_torch.ops.cuda import segment_sum as ss
    from gat_pytorch_tpu_torch.ops.cuda import table_attention as ta
    from gat_pytorch_tpu_torch.ops.cuda import v5_attention as v5
    from gat_pytorch_tpu_torch.ops.cuda import window_attention as wa
    from gat_pytorch_tpu_torch.ops.cuda.rounding import (FLOAT32, V2_BF16,
                                                         Rounding)
    from gat_pytorch_tpu_torch.train import optim as O
    from gat_pytorch_tpu_torch.train.tasks import make_task
    from gat_pytorch_tpu_torch.train.trainer import Trainer, TrainState
    from gat_pytorch_tpu_torch.utils.config import get_config
    from gat_pytorch_tpu_torch.utils import profiling as prof_utils
    from gat_pytorch_tpu_torch.utils.device import resolve_device
    from gat_pytorch_tpu_torch.vis import attention as vis_attention

    started = time.time()

    def elapsed(phase):
        print(f"[elapsed] {time.time() - started:.1f} s at the start of "
              f"phase {phase}")

    # -- 1. build --------------------------------------------------------
    t0 = time.time()
    build.build_all()
    print(f"[build] {len(build.LIBRARIES)} libraries from "
          f"{len(build.SOURCES)} sources in {time.time() - t0:.1f} s into "
          f"{build.BUILD_DIR}")
    check_resource_usage(build)
    # the native graphcore library (csrc/graphcore.cpp), which every graph
    # below is built with: a compiler must be found here
    t0 = time.time()
    cxx = core.compiler()
    if cxx is None:
        fail("no C++ compiler ($CXX or g++) for the graphcore library")
    gc_lib = core.build(cxx)
    print(f"[build] graphcore: {gc_lib.name} from csrc/graphcore.cpp "
          f"({cxx} {' '.join(core.CXXFLAGS)}) in {time.time() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    dev = resolve_device("cuda")
    print(f"[device] {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = {k: [] for k in REPLACES}

    def hold_all(prefix, names, got, want, key, floor=1.0, tol=REL_TOL):
        torch.cuda.synchronize()
        for nm, x, y in zip(names, got, want):
            hold(f"{prefix} {nm}", x, y, errs[key], floor, tol)

    def same_bits(name, first, second):
        """The kernels sum in a fixed order and use no atomics: a second
        launch on the same inputs must give the same bits."""
        torch.cuda.synchronize()
        for x, y in zip(first, second):
            if (x is None) != (y is None) or \
                    (x is not None and not torch.equal(x, y)):
                fail(f"{name}: two launches on the same inputs differ")

    def rms(x, y):
        return float((x.float() - y.float()).pow(2).mean().sqrt())

    def hold_mode(prefix, names, got, want, base, key, floor=1.0):
        """A bfloat16 mode's kernel outputs against its plain version in
        the same mode (want) and in float32 on the same inputs (base):
        within BF16_TOL x max(floor, |want|), and wherever the mode moves
        an output by more than REL_TOL of that scale, 10x nearer `want`
        than `base` is in RMS (the kernel rounds where its plain version
        does). None entries are skipped."""
        torch.cuda.synchronize()
        for nm, x, y, z in zip(names, got, want, base):
            if y is None:
                continue
            err, scale = max_err(x, y, floor)
            moved = max_err(z, y, floor)[0] > REL_TOL * scale
            ratio = rms(x, y) / max(rms(z, y), 1e-30)
            print(f"  {prefix} {nm}: max_abs_err {err:.3e} (scale "
                  f"{scale:.3e}), rms over the float32 plain version's "
                  f"{ratio:.3e}{'' if moved else ' (not moved by the mode)'}")
            if not scale > 0.0:
                fail(f"{prefix} {nm}: the plain version is all zeros")
            if not err <= BF16_TOL * scale:
                fail(f"{prefix} {nm} differs from its plain version: {err} > "
                     f"{BF16_TOL} x {scale}")
            if moved and not ratio <= 0.1:
                fail(f"{prefix} {nm}: the kernel does not round where its "
                     f"plain version does (rms ratio {ratio})")
            errs[key].append(err)

    def mode_tag(rnd):
        return ",".join(k for k, v in vars(rnd).items() if v)

    def window_mode(nh, f, v12=True):
        """The windowed op's bfloat16 policy at a layer shape, as the
        port reads the JAX package's default (GAT_TPU_V12=0: no pair)."""
        env = {"GAT_TPU_V6_DTYPE": "bfloat16",
               "GAT_TPU_V12": "1" if v12 else "0"}
        with knobs(env):
            return wa.window_rounding(nh, f)

    # -- 2-phase entries: one checker for the v5 and the window forms ------
    def v5_two_phase_entries(graph):
        """(cap, plain cap, forward, plain forward, backward, plain
        backward) of the v5 2-phase entries bound to `graph`'s edges."""
        ga = (graph.senders, graph.receivers, graph.num_real_edges)
        # the backward as the main path calls it: the graph's sender runs
        # and offsets (the kernel by sender walks them)
        runs = {k: getattr(graph, k) for k in ("src_order", "src_ptr",
                                               "dst_ptr")
                if getattr(graph, k, None) is not None}
        return (lambda h, a, s, **kw: v5.v5_cap(h, a, s, *ga, **kw),
                lambda h, a, s, **kw: v5.v5_cap_plain(h, a, s, *ga),
                lambda h, a, s, c, m, *r: v5.v5_forward_two_phase(
                    h, a, s, c, m, *ga, *r),
                lambda h, a, s, c, m, *r: v5.v5_forward_two_phase_plain(
                    h, a, s, c, m, *ga, *r),
                lambda h, a, s, c, m, *r, **kw: v5.v5_backward_two_phase(
                    h, a, s, c, m, *ga, *r, **runs, **kw),
                lambda h, a, s, c, m, *r:
                v5.v5_backward_two_phase_by_sender_plain(h, a, s, c, m, *ga,
                                                         *r))

    def window_two_phase_entries(layout):
        # the cap reads the table: the timed call includes its pass
        return (lambda h, a, s, **kw: wa.window_cap(v5.source_scores(h, a),
                                                    s, layout),
                lambda h, a, s, **kw: wa.window_cap_plain(
                    v5.source_scores_plain(h, a), s, layout),
                lambda h, a, s, c, m, *r: wa.window_forward_two_phase(
                    h, a, s, c, m, layout, *r),
                lambda h, a, s, c, m, *r: wa.window_forward_two_phase_plain(
                    h, a, s, c, m, layout, *r),
                lambda h, a, s, c, m, *r, **kw: wa.window_backward_two_phase(
                    h, a, s, c, m, layout, *r, **kw),
                lambda h, a, s, c, m, *r: wa.window_backward_two_phase_plain(
                    h, a, s, c, m, layout, *r))

    def check_two_phase(label, entries, keys, n_, nh, f, slots, real=None):
        """The three 2-phase entries of one op at one layer shape, each
        against its plain version and launched twice. The forward and the
        backward run at the cap (the kernel's own beside the plain
        version's own: each takes the slope at its argmax, where
        pre == 0), 0.25 above it (every logit on LeakyReLU's negative
        branch) and 0.37 below it (the top ones on the positive branch),
        at eps = 1e-8 and 1, with and without the dropout mask; d(cap) at
        eps = 1 at the size of the sum it is (below). real: the slots
        whose d(h) rows
        the kernel writes (all where None). Returns the inputs of the
        timings: the cap, with dropout, eps = 1e-8."""
        cap_k, cap_p, fwd_k, fwd_p, bwd_k, bwd_p = entries
        kcap, kfwd, kbwd = keys
        h, a_src, s_dst, drop, g = op_inputs(torch, gen, n_, nh, f, slots,
                                             dev)
        cap_args = (h, a_src, s_dst)
        got, want = cap_k(*cap_args), cap_p(*cap_args)
        hold_all(f"{kcap} {label}", ("cap",), got[:1], want[:1], kcap)
        if int(got[1]) != int(want[1]):
            fail(f"{kcap}: argmax code {int(got[1])} != plain {int(want[1])}")
        same_bits(kcap, got, cap_k(*cap_args))
        case = None
        for mask in (drop, None):
            tag = " no dropout" if mask is None else ""
            for where, ck, cp in (("at the cap", got[0], want[0]),
                                  ("cap + 0.25", got[0] + 0.25,
                                   got[0] + 0.25),
                                  ("cap - 0.37", got[0] - 0.37,
                                   got[0] - 0.37)):
                for eps in (1e-8, 1.0):
                    name = f"{label}{tag} {where} eps={eps:g}"
                    fk = (h, a_src, s_dst, ck, mask, eps, SLOPE)
                    fp = (h, a_src, s_dst, cp, mask, eps, SLOPE)
                    out_k = fwd_k(*fk)
                    out, den = fwd_p(*fp)
                    hold_all(f"{kfwd} {name}", ("out", "den"), out_k,
                             (out, den), kfwd)
                    same_bits(f"{kfwd} {name}", out_k, fwd_k(*fk))
                    co = (g, out, den, mask is not None)
                    gk, gp = list(bwd_k(*fk, *co)), list(bwd_p(*fp, *co))
                    again = list(bwd_k(*fk, *co))
                    if real is not None:
                        gk[0], gp[0], again[0] = (gk[0][real], gp[0][real],
                                                  again[0][real])
                    same_bits(f"{kbwd} {name}", gk, again)
                    keep = [i for i in range(4) if gp[i] is not None]
                    hold_all(f"{kbwd} {name}", [BWD_NAMES[i] for i in keep],
                             [gk[i] for i in keep], [gp[i] for i in keep],
                             kbwd, 1.0 if eps < 1.0 else 0.0)
                    # d(cap) = -sum d(s_dst). At eps = 1 each
                    # destination's part is slope * (g . out) / (den + 1)
                    # and they do not cancel: hold it at the size such a
                    # sum has when the parts' signs vary, |d(s_dst)|_2,
                    # or its own if larger. At eps = 1e-8 the parts
                    # cancel within a destination (d(cap) ~ 1e-8): at 1.
                    hold_all(f"{kbwd} {name}", ("d_cap",), gk[4:], gp[4:],
                             kbwd, float(gp[2].norm()) if eps == 1.0
                             else 1.0)
                    if case is None:
                        case = dict(nh=nh, f=f, drop=True, cap_args=cap_args,
                                    fwd_args=fk, bwd_args=fk + co)
        return case

    elapsed("2a")
    # -- 2a. the source-score pass, at every width the fits run (Cora 64 and
    # 7, Pubmed 24, PATTERN 48, 96 and 1, PPI 1024 and 726), from a float32
    # and a bfloat16 table: against its plain version, twice for equal
    # bits, and with more source rows than destinations (256 rows put in
    # front: every row keeps its bits); a table off 16-byte alignment takes
    # scalar loads and is held against its plain version too
    SCORE_SHAPES = ((1, 1), (1, 7), (8, 3), (4, 12), (8, 8), (4, 24),
                    (6, 121), (4, 256))

    def check_source_scores(n_, shift=256):
        for nh, f in SCORE_SHAPES:
            d = nh * f
            h32 = torch.randn((n_, d), generator=gen, device=dev)
            a = torch.randn((d, nh), generator=gen, device=dev) / d ** 0.5
            for h, key in ((h32, "source_scores"),
                           (h32.to(torch.bfloat16), "source_scores_bf16")):
                got = v5.source_scores(h, a)
                hold_all(f"{key} {nh}x{f}", ("s_src",), (got,),
                         (v5.source_scores_plain(h, a),), key)
                same_bits(f"{key} {nh}x{f}", (got,),
                          (v5.source_scores(h, a),))
                wider = torch.cat([torch.zeros((shift, d), dtype=h.dtype,
                                               device=dev), h])
                same_bits(f"{key} {nh}x{f} with {shift} rows in front",
                          (got,), (v5.source_scores(wider, a)[shift:],))
            if d == 64:
                off = torch.empty((n_ * d + 1,), device=dev)[1:].view(n_, d)
                off.copy_(h32)
                hold_all(f"source_scores {nh}x{f} off 16-byte alignment",
                         ("s_src",), (v5.source_scores(off, a),),
                         (v5.source_scores_plain(off, a),), "source_scores")
        print(f"[kernels] source_scores at widths "
              f"{[nh * f for nh, f in SCORE_SHAPES]}, float32 and bfloat16 "
              f"tables: within {REL_TOL} of the plain version, the same bits "
              f"on two launches and with {shift} rows in front")

    def check_v5(graph, nh, f, with_drop):
        """The v5 kernels and the d(h) reduce at one layer shape on
        `graph`; returns the inputs for the timings."""
        n, e, e_real = graph.num_nodes, graph.num_edges, graph.num_real_edges
        snd, rcv, order = graph.senders, graph.receivers, graph.src_order
        h, a_src, s_eff, drop, g = op_inputs(torch, gen, n, nh, f, e, dev)
        if not with_drop:
            drop = None
        fwd_args = (h, a_src, s_eff, drop, snd, rcv, e_real, SLOPE)
        got = v5.v5_forward(*fwd_args)
        want = v5.v5_forward_plain(*fwd_args)
        hold_all("v5_forward", ("num", "den", "cap"), got, want,
                 "v5_forward")
        if int(got[3]) != int(want[3]):
            fail(f"argmax code {int(got[3])} != plain {int(want[3])}")
        same_bits("v5_forward", got, v5.v5_forward(*fwd_args))
        same_bits("v5_forward given its source-score table", got,
                  v5.v5_forward(*fwd_args,
                                s_src=v5.source_scores(h, a_src)))
        num, den, cap, _ = want
        out, epsp = epilogue(torch, num, den, cap, f, 1e-8)
        bwd_args = fwd_args + (g, out, den, epsp, with_drop)
        src_ptr = getattr(graph, "src_ptr", None)
        runs = (dict(src_order=order, src_ptr=src_ptr)
                if src_ptr is not None else {})
        # the backward returns d(h) per node, by sender at every width (the
        # kernel sums it; a cut run's partial rows in item order, within
        # REL_TOL of the sums from 0); held against the plain version by
        # sender, and the kernel's d(h) against the route it replaces, the
        # plain per-edge rows (the TPU kernel's) reduced by row 3 on the card
        want = v5.v5_backward_by_sender_plain(*bwd_args)
        keep = [i for i in range(4) if want[i] is not None]
        names = [BWD_NAMES[i] for i in keep]
        got = v5.v5_backward(*bwd_args, **runs)
        hold_all("v5_backward", names, [got[i] for i in keep],
                 [want[i] for i in keep], "v5_backward")
        same_bits("v5_backward", got, v5.v5_backward(*bwd_args, **runs))
        # the graph's sender runs and the ones the wrapper derives
        same_bits("v5_backward deriving its sender runs", got,
                  v5.v5_backward(*bwd_args))
        rows = v5.v5_backward_plain(*bwd_args)[0]
        routed = ss.dh_reduce(rows, order, snd, n, e_real)
        hold_all("v5_backward", ("d_h against row 3 over the plain per-edge "
                                 "rows",), got[:1], (routed,), "v5_backward")
        print(f"  v5_backward {nh}x{f} d_h "
              f"{'has' if torch.equal(got[0], routed) else 'has not'} the "
              f"bits of row 3 over the plain per-edge rows (max_abs_err "
              f"{float((got[0] - routed).abs().max()):.3e})")
        idle = torch.ones(n, dtype=torch.bool, device=dev)
        idle[snd[:e_real].long()] = False
        if bool(idle.any()) and bool(got[0][idle].any()):
            fail(f"v5_backward {nh}x{f}: a sender without a real edge has a "
                 f"non-zero d(h) row")
        # At eps = 1e-8, d(s_dst) is about eps' (the softmax's own terms
        # cancel), so the check above cannot see eps' or a d(s_dst) left
        # at zero. At eps = 1, eps' is of the size of den: hold every
        # output there at its own magnitude.
        out1, epsp1 = epilogue(torch, num, den, cap, f, 1.0)
        bwd1 = fwd_args + (g, out1, den, epsp1, with_drop)
        got = v5.v5_backward(*bwd1, **runs)
        want = v5.v5_backward_by_sender_plain(*bwd1)
        hold_all("v5_backward eps=1", names, [got[i] for i in keep],
                 [want[i] for i in keep], "v5_backward", floor=0.0)
        # the parts mode: raw cotangents of num and den, no eps in it,
        # every output at its own magnitude
        d_den = torch.randn((n, nh), generator=gen, device=dev)
        parts_args = fwd_args + (g, None, d_den, None, with_drop)
        got = v5.v5_backward(*parts_args, normalize=False, **runs)
        want = v5.v5_backward_by_sender_plain(*parts_args, normalize=False)
        hold_all("v5_backward_parts", names, [got[i] for i in keep],
                 [want[i] for i in keep], "v5_backward_parts", floor=0.0)
        same_bits("v5_backward_parts", got,
                  v5.v5_backward(*parts_args, normalize=False, **runs))
        routed = ss.dh_reduce(v5.v5_backward_plain(
            *parts_args, normalize=False)[0], order, snd, n, e_real)
        hold_all("v5_backward_parts", ("d_h against row 3 over the plain "
                                       "per-edge rows",), got[:1],
                 (routed,), "v5_backward_parts", floor=0.0)
        got = ss.dh_reduce(rows, order, snd, n, e_real)
        ids = snd.index_select(0, order.long())
        want = ss.segment_rows_plain(rows, order, ids, n)
        hold_all("segment_sum_rows", ("(d(h) reduce)",), (got,), (want,),
                 "segment_sum_rows")
        # the feature-major form: its plain version, and row 3's bits
        got_t = ss.dh_reduce(rows, order, snd, n, e_real, transposed=True)
        hold_all("segment_sum_rows_t", ("(d(h) reduce, feature-major)",),
                 (got_t,), (ss.segment_rows_t_plain(rows, order, ids, n),),
                 "segment_sum_rows_t")
        same_bits("segment_sum_rows_t", (got_t,), (ss.dh_reduce(
            rows, order, snd, n, e_real, transposed=True),))
        same_bits("segment_sum_rows_t against segment_sum_rows", (got_t,),
                  (got,))
        if src_ptr is not None:     # the main path's call: one launch
            same_bits("segment_sum_rows by the graph's offsets", (got,),
                      (ss.dh_reduce(rows, order, snd, n, e_real,
                                    src_ptr=src_ptr),))
            same_bits("segment_sum_rows_t by the graph's offsets", (got_t,),
                      (ss.dh_reduce(rows, order, snd, n, e_real, True,
                                    src_ptr=src_ptr),))
        return dict(nh=nh, f=f, drop=with_drop, fwd_args=fwd_args,
                    bwd_args=bwd_args, parts_args=parts_args, rows=rows,
                    runs=runs)

    # -- the backward by sender on a hub: its run cut into items ---------
    HUB_RUN = 14_521
    HUB_SHAPES = ((8, 40), (8, 8))

    def hub_graph(n_h=20_000, per_node=8):
        """n_h nodes, about per_node random edges a node (no self-pairs,
        none from node 0), and node 0 sending to HUB_RUN - 1 others: with
        its self-loop a run of HUB_RUN slots, cut into items of at most L
        (build.sender_items); the Graph the port's loader builds
        (self-loops, dst-sorted, its offsets and sender runs) on the
        card."""
        from gat_pytorch_tpu_torch.graph import transforms as TT
        rng = np.random.default_rng(21)
        snd_h = rng.integers(1, n_h, n_h * per_node)
        rcv_h = rng.integers(0, n_h, n_h * per_node)
        keep = snd_h != rcv_h
        hub_r = rng.choice(np.arange(1, n_h), HUB_RUN - 1, replace=False)
        snd_h = np.concatenate([snd_h[keep], np.zeros(HUB_RUN - 1, np.int64)])
        rcv_h = np.concatenate([rcv_h[keep], hub_r])
        graph = TT.canonicalize(np.zeros((n_h, 1), np.float32), snd_h,
                                rcv_h).to(dev)
        runs = torch.diff(graph.src_ptr.long())
        if int(runs[0]) != HUB_RUN or int(runs[1:].max()) >= 64:
            fail(f"hub graph: node 0 sends {int(runs[0])}, the largest "
                 f"other run is {int(runs[1:].max())}")
        return graph

    def check_hub_backward(graph):
        """The v5 backward by sender at HUB_SHAPES (8 x 40, a 320-float
        row, the wide plan; 8 x 8) on `graph` (hub_graph), as the main
        path calls it
        (the Graph's sender runs and offsets), in its normalised, parts
        and 2-phase modes: against the split plain versions (the kernel's
        association) at REL_TOL, d(drop) and d(s_dst) also against the
        by-sender plain version, the same bits on a second launch, and
        timed (the whole call given its op's table, CUDA-graph replay)
        beside its bound. Returns {shape: (ms, bound ms)}."""
        n_h, e_h, er = (graph.num_nodes, graph.num_edges,
                        graph.num_real_edges)
        snd_h, rcv_h = graph.senders, graph.receivers
        runs = dict(src_order=graph.src_order, src_ptr=graph.src_ptr,
                    dst_ptr=graph.dst_ptr)
        plain_runs = dict(src_order=graph.src_order, src_ptr=graph.src_ptr)
        items = build.sender_items(graph.src_ptr, v5.sender_warps(n_h))
        print(f"[graph] hub graph: {n_h} nodes (padded), {er} real edges, "
              f"node 0 sending {HUB_RUN}; items of at most L = "
              f"{items.limit} slots: {items.n_items} items, "
              f"{items.n_split} run cut into {items.n_parts}, "
              f"{items.split_slots} of {items.slots} slots in cut runs")
        if items.n_split != 1 or int(items.split_src[0]) != 0:
            fail("hub graph: the hub's run is not the one run cut")
        timed = {}
        for nh, f in HUB_SHAPES:
            d = nh * f
            h, a_src, s_eff, drop, g = op_inputs(torch, gen, n_h, nh, f,
                                                 e_h, dev)
            fa = (h, a_src, s_eff, drop, snd_h, rcv_h, er, SLOPE)
            num, den, cap, _ = v5.v5_forward_plain(*fa)
            out, epsp = epilogue(torch, num, den, cap, f, 1.0)
            d_den = torch.randn((n_h, nh), generator=gen, device=dev)
            cap2 = cap.clone()
            cases = {
                "normalised": (fa + (g, out, den, epsp, True), {},
                               v5.v5_backward, v5.v5_backward_split_plain,
                               v5.v5_backward_by_sender_plain),
                "parts": (fa + (g, None, d_den, None, True),
                          {"normalize": False}, v5.v5_backward,
                          v5.v5_backward_split_plain,
                          v5.v5_backward_by_sender_plain),
                "2-phase": ((h, a_src, s_eff, cap2, drop, snd_h, rcv_h, er,
                             1.0, SLOPE, g, out, den, True), {},
                            v5.v5_backward_two_phase,
                            v5.v5_backward_two_phase_split_plain,
                            v5.v5_backward_two_phase_by_sender_plain)}
            for mode, (args, kw, kern, split, by) in cases.items():
                tag = f"v5_backward {nh}x{f} hub {mode}"
                got = kern(*args, **kw, **runs)
                want = split(*args, **kw, **plain_runs)
                names = BWD_NAMES + (("d_cap",) if len(want) > 4 else ())
                hold_all(tag, names, got, want, "v5_backward", floor=0.0)
                by_ = by(*args, **kw, **plain_runs)
                hold_all(tag + " against the by-sender plain version",
                         ("d_h", "d_drop", "d_s_dst"), got[:3], by_[:3],
                         "v5_backward", floor=0.0)
                same_bits(tag, got, kern(*args, **kw, **runs))
            nbytes = 4 * (n_h * d + d * nh + 2 * n_h * nh + er * nh + 2 * er
                          + 2 * (n_h + 1) + 2 * n_h * d + n_h * nh + 1
                          + n_h * d + e_h * nh + n_h * nh + d * nh)
            ops = 2 * n_h * d * nh + er * (2 * d * nh + 5 * d + 10 * nh)
            bound, by_what = bound_ms(nbytes, ops)
            s_src = v5.source_scores(h, a_src)
            ms = time_ms(torch, lambda: v5.v5_backward(
                *cases["normalised"][0], s_src=s_src, **runs))
            timed[f"{nh}x{f}"] = (round(ms, 4), round(bound, 5))
            print(f"[timing] v5_backward {nh}x{f} on the hub graph: "
                  f"{ms:.4f} ms a call (three launches: each destination's "
                  f"d(den), the kernel by sender, its tail), bound "
                  f"{bound:.5f} ms ({by_what}), "
                  f"{ms / bound:.1f}x")
        print(f"[kernels] v5_backward by sender on the hub graph at "
              f"{', '.join(f'{a}x{b}' for a, b in HUB_SHAPES)}: every mode "
              f"within {REL_TOL} of the split plain version, the same bits "
              f"on two launches")
        return timed

    # rows over 256 floats from a bfloat16 table: the wide plans of the
    # bfloat16-table library, at PPI's widths and the hub's 8 x 40
    BF16_WIDE_SHAPES = ((4, 256), (6, 121), (8, 40))

    def check_bf16_wide_by_sender(graph):
        """The v5 backward by sender from a bfloat16 h table
        (Rounding(table=True): every product reads the rounded rows) at
        BF16_WIDE_SHAPES on `graph` (hub_graph: its hub's run cut into
        items), as the main path calls it (the Graph's runs and offsets,
        the op's source-score table), in its normalised, parts and
        2-phase modes: every output within BF16_TOL of its own magnitude
        of the split plain version in the same mode (the kernel's
        association), and the same bits on two launches."""
        rnd = Rounding(table=True)
        n_h, e_h, er = (graph.num_nodes, graph.num_edges,
                        graph.num_real_edges)
        edges = (graph.senders, graph.receivers, er)
        runs = dict(src_order=graph.src_order, src_ptr=graph.src_ptr,
                    dst_ptr=graph.dst_ptr)
        plain_runs = dict(src_order=graph.src_order, src_ptr=graph.src_ptr)
        for nh, f in BF16_WIDE_SHAPES:
            h, a_src, s_eff, drop, g = op_inputs(torch, gen, n_h, nh, f,
                                                 e_h, dev)
            hk = rnd.table_of(h)
            s_src = v5.source_scores(hk, a_src)
            fa = (hk, a_src, s_eff, drop) + edges + (SLOPE,)
            num, den, cap, _ = v5.v5_forward_plain(*fa, rounding=rnd,
                                                   s_src=s_src)
            out, epsp = epilogue(torch, num, den, cap, f, 1.0)
            d_den = torch.randn((n_h, nh), generator=gen, device=dev)
            norm = {"rounding": rnd, "s_src": s_src}
            cases = {
                "normalised": (fa + (g, out, den, epsp, True), norm,
                               v5.v5_backward, v5.v5_backward_split_plain,
                               "v5_backward_bf16"),
                "parts": (fa + (g, None, d_den, None, True),
                          {"normalize": False, **norm}, v5.v5_backward,
                          v5.v5_backward_split_plain,
                          "v5_backward_parts_bf16"),
                "2-phase": ((hk, a_src, s_eff, cap.clone(), drop) + edges
                            + (1.0, SLOPE, g, out, den, True), norm,
                            v5.v5_backward_two_phase,
                            v5.v5_backward_two_phase_split_plain,
                            "v5_backward_two_phase_bf16")}
            for mode, (args, kw, kern, split, key) in cases.items():
                tag = f"v5_backward {nh}x{f} hub {mode} [{mode_tag(rnd)}]"
                got = kern(*args, **kw, **runs)
                want = split(*args, **kw, **plain_runs)
                names = BWD_NAMES + (("d_cap",) if len(want) > 4 else ())
                hold_all(tag, names, got, want, key, floor=0.0,
                         tol=BF16_TOL)
                same_bits(tag, got, kern(*args, **kw, **runs))
            del h, hk, s_src, drop, g, num, out, cases, got, want
            torch.cuda.empty_cache()
        print(f"[kernels] v5_backward by sender from a bfloat16 table on "
              f"the hub graph at "
              f"{', '.join(f'{a}x{b}' for a, b in BF16_WIDE_SHAPES)}: every "
              f"mode within {BF16_TOL} of the split plain version, the same "
              f"bits on two launches")

    # -- the paper form's logits at the arxiv-full-paper cell's shapes -----
    def check_paper_logits():
        """The paper form's logits op (paper_logits_forward;
        paper_logits_backward and the two sorted sums after it) on the
        graph of the benchmark's arxiv_like traffic (PAPER_SEED) as the
        port builds it, at PAPER_SHAPES (the scores from a random h and a
        by the model's einsums), as the main path calls it (the Graph's
        offsets and sender order): the logits, d(s_src) and d(s_dst) the
        bits of the torch chain it replaced (paper_logits_plain through
        torch's autograd, the sorted sums on the card) on each of two
        launches, the launches counted. Timed: each kernel (CUDA-graph
        replay) beside its plain version (eager, warm) and its bytes
        bound; the op's whole backward (the kernel and the two sums)
        beside the chain's through autograd. Returns {entry: {ms,
        plain_ms, bound_ms, bytes, ops}}, both shapes summed."""
        from gat_pytorch_tpu_torch.graph import transforms as TT
        from gat_pytorch_tpu_torch.ops.cuda import paper_logits as pl
        from portbench import spec as pb_spec
        from portbench import traffic as pb_traffic
        cell = pb_spec.load_cell(PAPER_CELL)
        data = pb_traffic.make(cell.traffic, cell.generator(), PAPER_SEED)
        graph = TT.canonicalize(
            np.zeros((data.x.shape[0], 1), np.float32), data.senders,
            data.receivers).to(dev)
        n_g, e_g, er = graph.num_nodes, graph.num_edges, graph.num_real_edges
        snd_g, rcv_g, mask_g = graph.senders, graph.receivers, graph.edge_mask
        args = (snd_g, rcv_g, mask_g, n_g, PF_SLOPE, er)
        kw = dict(src_order=graph.src_order, src_ptr=graph.src_ptr,
                  dst_ptr=graph.dst_ptr)
        print(f"[graph] {PAPER_CELL} seed {PAPER_SEED}: {n_g} nodes "
              f"(padded), {e_g} edges, {er} real")
        timed = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0.0,
                         ops=0.0) for k in ("paper_logits_forward",
                                            "paper_logits_backward")}
        for nh, f in PAPER_SHAPES:
            h = torch.randn((n_g, nh, f), generator=gen, device=dev)
            a = torch.randn((nh, 2 * f), generator=gen, device=dev) / f ** 0.5
            s_src = torch.einsum("nhf,hf->nh", h, a[:, :f]).contiguous()
            s_dst = torch.einsum("nhf,hf->nh", h, a[:, f:]).contiguous()
            g = torch.randn((e_g, nh), generator=gen, device=dev)
            del h
            tag = f"paper_logits {nh}x{f} on the {PAPER_CELL} graph"
            res = []
            for fn in (pl.paper_logits_plain, pl.paper_logits,
                       pl.paper_logits):
                src = s_src.clone().requires_grad_(True)
                dst = s_dst.clone().requires_grad_(True)
                before = dict(build.LAUNCHES)
                out = fn(src, dst, *args, **kw)
                grads = torch.autograd.grad(out, (src, dst), g)
                torch.cuda.synchronize()
                ran = {k: v - before[k] for k, v in build.LAUNCHES.items()
                       if v != before[k]}
                res.append(((out.detach(),) + grads, ran))
            (want, ran_chain), *got = res
            if ran_chain != {"segment_sum_sorted": 2}:
                fail(f"{tag}: the chain launched {ran_chain}")
            for i, (outs, ran) in enumerate(got):
                if ran != {"paper_logits_forward": 1,
                           "paper_logits_backward": 1,
                           "segment_sum_sorted": 2}:
                    fail(f"{tag}: launch {i + 1} ran {ran}")
                for name, x, y in zip(("logits", "d_s_src", "d_s_dst"),
                                      outs, want):
                    if not torch.equal(x, y):
                        fail(f"{tag} {name}: launch {i + 1} is not the "
                             f"chain's bits (max abs diff "
                             f"{float((x - y).abs().max()):.3e})")
            same_bits(tag, got[0][0], got[1][0])
            errs["paper_logits_forward"].append(0.0)
            errs["paper_logits_backward"].append(0.0)
            padding = int((want[0][~mask_g] == pl.NEG_INF).sum())
            print(f"  {tag}: logits, d_s_src, d_s_dst the chain's bits on "
                  f"two launches; {padding} of {(e_g - er) * nh} padding "
                  f"entries at NEG_INF")
            del res, got, want

            def bwd_kernel():
                return pl.paper_logits_backward(g, s_src, s_dst, snd_g,
                                                rcv_g, mask_g, PF_SLOPE)

            def bwd_op():
                d_z = bwd_kernel()
                return (seg.sorted_gather_grad(d_z, snd_g, n_g,
                                               graph.src_order,
                                               graph.src_ptr),
                        seg.sorted_gather_grad(d_z, rcv_g, n_g, None,
                                               graph.dst_ptr, er))

            e4, n4 = 4.0 * e_g, 4.0 * n_g
            runs = {
                # senders, mask, offsets and both tables read; logits
                # written
                "paper_logits_forward": (
                    lambda: pl.paper_logits_forward(s_src, s_dst, *args,
                                                    **kw),
                    lambda: pl.paper_logits_plain(s_src, s_dst, *args,
                                                  **kw),
                    3.0 * e_g * nh,
                    e4 + e_g + n4 + 4 + 2 * n4 * nh + e4 * nh),
                # g, senders, receivers, mask and both tables read; d_z
                # written
                "paper_logits_backward": (
                    bwd_kernel,
                    lambda: pl.paper_logits_backward_plain(
                        g, s_src, s_dst, snd_g, rcv_g, mask_g, PF_SLOPE),
                    2.0 * e_g * nh,
                    e4 * nh + 2 * e4 + e_g + 2 * n4 * nh + e4 * nh)}
            for k, (kern, plain, ops, nbytes) in runs.items():
                km = time_ms(torch, kern)
                pm = step_time_ms(torch, plain, iters=5, warmup=2)
                bm, by = bound_ms(nbytes, ops)
                print(f"[timing] {k} {nh}x{f} on the {PAPER_CELL} graph: "
                      f"kernel_ms {km:.4f} plain_ms {pm:.4f} (warm) "
                      f"bound_ms {bm:.5f} ({by}), {km / bm:.1f}x")
                t = timed[k]
                t["ms"] += km
                t["plain_ms"] += pm
                t["bound_ms"] += bm
                t["bytes"] += nbytes
                t["ops"] += ops
            # the whole backward: the op's (its kernel and the two sorted
            # sums) against the chain's through autograd
            src = s_src.clone().requires_grad_(True)
            dst = s_dst.clone().requires_grad_(True)
            chain = pl.paper_logits_plain(src, dst, *args, **kw)
            om = time_ms(torch, bwd_op)
            cm = step_time_ms(torch, lambda: torch.autograd.grad(
                chain, (src, dst), g, retain_graph=True), iters=5, warmup=2)
            print(f"[timing] paper_logits whole backward {nh}x{f} on the "
                  f"{PAPER_CELL} graph: op {om:.4f} ms (the kernel and two "
                  f"sorted sums), the torch chain's {cm:.4f} ms (warm)")
            del chain, src, dst, g
            torch.cuda.empty_cache()
        print(f"[kernels] paper_logits_forward, paper_logits_backward on "
              f"the {PAPER_CELL} graph at "
              f"{', '.join(f'{a}x{b}' for a, b in PAPER_SHAPES)}: the torch "
              f"chain's bits on two launches")
        return timed

    if "--paper-logits-only" in sys.argv[1:]:
        print("chip_smoke: --paper-logits-only: built, the paper form's "
              f"logits op held and timed at the {PAPER_CELL} cell's "
              f"shapes: {check_paper_logits()}")
        return 0

    hub = hub_graph()
    hub_times = check_hub_backward(hub)
    check_bf16_wide_by_sender(hub)
    del hub
    if "--hub-only" in sys.argv[1:]:
        print("chip_smoke: --hub-only: built, the backward by sender held "
              f"and timed on the hub graph (also from a bfloat16 table at "
              f"rows over 256 floats): {hub_times}")
        return 0

    # -- the GATv2 op at the arxiv-powerlaw-gatv2 cell's shapes -----------
    def check_gatv2():
        """The GATv2 op's kernels (gatv2_forward; gatv2_backward: the pass
        by destination, the pass by sender over build.sender_items, the
        tail) on the graph of the benchmark's arxiv_powerlaw traffic
        (GATV2_SEED) as the port builds it, at GATV2_SHAPES, with and
        without the attention mask, as the main path calls them (the
        Graph's offsets and sender runs): each output within GATV2_TOL of
        the plain version's largest value, the same bits on a second
        launch, a destination without a real edge a zero row. Timed with
        the mask (the cell's training step): the kernel calls (CUDA-graph
        replay), the plain versions warm (eager), and the bound of the op's
        contract (portbench/counts/gatv2.py). Returns {entry: {ms,
        plain_ms, bound_ms, bytes, ops}}, both shapes summed."""
        from gat_pytorch_tpu_torch.graph import transforms as TT
        from gat_pytorch_tpu_torch.ops.cuda import gatv2_attention as g2
        from portbench import spec as pb_spec
        from portbench import traffic as pb_traffic
        from portbench.counts import gatv2 as gatv2_counts
        cell = pb_spec.load_cell(GATV2_CELL)
        data = pb_traffic.make(cell.traffic, cell.generator(), GATV2_SEED)
        graph = TT.canonicalize(
            np.zeros((data.x.shape[0], 1), np.float32), data.senders,
            data.receivers).to(dev)
        n_g, er = graph.num_nodes, graph.num_real_edges
        n_real = int(graph.node_mask.sum())
        snd_g, rcv_g = graph.senders, graph.receivers
        ptrs = dict(dst_ptr=graph.dst_ptr, src_order=graph.src_order,
                    src_ptr=graph.src_ptr)
        in_deg = torch.diff(torch.clamp(graph.dst_ptr.long(), max=er))
        out_deg = torch.diff(graph.src_ptr.long())
        items = build.sender_items(graph.src_ptr, g2.SENDER_BLOCKS)
        print(f"[graph] {GATV2_CELL} seed {GATV2_SEED}: {n_g} nodes "
              f"(padded; {n_real} real), {graph.num_edges} edges, {er} "
              f"real; largest run by destination {int(in_deg.max())}, by "
              f"sender {int(out_deg.max())}; the pass by sender's items "
              f"of at most L = {items.limit} slots: {items.n_items} items, "
              f"{items.n_split} runs cut into {items.n_parts}, "
              f"{items.split_slots} of {items.slots} slots in cut runs")
        if int(in_deg.max()) < GATV2_HUB or int(out_deg.max()) < GATV2_HUB \
                or not items.n_split:
            fail(f"{GATV2_CELL}: no hub of {GATV2_HUB} slots, or no run cut")
        empty = torch.nonzero(in_deg == 0).flatten()
        timed = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0.0,
                         ops=0.0) for k in ("gatv2_forward",
                                            "gatv2_backward")}

        for nh, f in GATV2_SHAPES:
            d = nh * f
            xl = torch.randn((n_g, d), generator=gen, device=dev)
            xr = torch.randn((n_g, d), generator=gen, device=dev)
            a = torch.randn((nh, f), generator=gen, device=dev) / f ** 0.5
            g = torch.randn((n_g, d), generator=gen, device=dev)
            mask = ((torch.rand((graph.num_edges, nh), generator=gen,
                                device=dev) >= DROPOUT).float()
                    / (1.0 - DROPOUT))
            for drop in (mask, None):
                tag = (f"gatv2 {nh}x{f} {GATV2_CELL} "
                       f"{'with' if drop is not None else 'without'} the "
                       f"attention mask")
                args = (xl, xr, a, drop, snd_g, rcv_g)
                got = g2.gatv2_forward(*args, n_g, er, PF_SLOPE,
                                       dst_ptr=graph.dst_ptr)
                want = g2.gatv2_forward_plain(*args, n_g, er, PF_SLOPE)
                hold_all(tag + " forward", ("out", "max", "den"), got, want,
                         "gatv2_forward", floor=0.0, tol=GATV2_TOL)
                same_bits(tag + " forward", got, g2.gatv2_forward(
                    *args, n_g, er, PF_SLOPE, dst_ptr=graph.dst_ptr))
                if len(empty) and bool(got[0][empty].any()):
                    fail(f"{tag}: a row without a real edge is not zero")
                out, mx, den = want
                bwd = args + (er, PF_SLOPE, g, out, mx, den)
                got_b = g2.gatv2_backward(*bwd, **ptrs)
                want_b = g2.gatv2_backward_plain(*bwd)
                hold_all(tag + " backward", ("d_xl", "d_xr", "d_a"), got_b,
                         want_b, "gatv2_backward", floor=0.0, tol=GATV2_TOL)
                same_bits(tag + " backward", got_b,
                          g2.gatv2_backward(*bwd, **ptrs))
                del got, want, got_b, want_b
                if drop is None:
                    continue
                runs = {
                    "gatv2_forward": (
                        lambda: g2.gatv2_forward(*args, n_g, er, PF_SLOPE,
                                                 dst_ptr=graph.dst_ptr),
                        lambda: g2.gatv2_forward_plain(*args, n_g, er,
                                                       PF_SLOPE),
                        gatv2_counts.forward(n_real, er, nh, f, True)),
                    "gatv2_backward": (
                        lambda: g2.gatv2_backward(*bwd, **ptrs),
                        lambda: g2.gatv2_backward_plain(*bwd),
                        gatv2_counts.backward(n_real, er, nh, f, True))}
                for k, (kern, plain, (ops, nbytes)) in runs.items():
                    km = time_ms(torch, kern)
                    # the plain versions eagerly (a CUDA graph would hold
                    # their allocations of some GB): one call, then three
                    pm = step_time_ms(torch, plain, iters=3, warmup=1)
                    bm, by = bound_ms(nbytes, ops)
                    print(f"[timing] {k} {nh}x{f} on the {GATV2_CELL} "
                          f"graph: kernel_ms {km:.4f} plain_ms {pm:.4f} "
                          f"(warm) bound_ms {bm:.5f} ({by}), "
                          f"{km / bm:.1f}x")
                    t = timed[k]
                    t["ms"] += km
                    t["plain_ms"] += pm
                    t["bound_ms"] += bm
                    t["bytes"] += nbytes
                    t["ops"] += ops
                torch.cuda.empty_cache()
        print(f"[kernels] gatv2_forward, gatv2_backward on the {GATV2_CELL} "
              f"graph at {', '.join(f'{a}x{b}' for a, b in GATV2_SHAPES)}, "
              f"with and without the mask: within {GATV2_TOL} of the plain "
              f"versions' largest values, the same bits on two launches")
        return timed

    gatv2_times = check_gatv2()
    if "--gatv2-only" in sys.argv[1:]:
        print("chip_smoke: --gatv2-only: built, the GATv2 op held and "
              f"timed at the {GATV2_CELL} cell's shapes: {gatv2_times}")
        return 0
    paper_times = check_paper_logits()

    cora_raw = datasets.load_planetoid("Cora", synthetic_override=True,
                                       seed=0)
    cora = loader.transductive_graph(cora_raw).to(dev)
    n, e, e_real = cora.num_nodes, cora.num_edges, cora.num_real_edges
    snd, rcv, order = cora.senders, cora.receivers, cora.src_order
    print(f"[graph] Cora stand-in: {n} nodes (padded), {e} edges "
          f"(padded), {e_real} real")
    check_source_scores(n)
    V5_TWO = ("v5_cap", "v5_forward_two_phase", "v5_backward_two_phase")
    cora_cases, cora_two = [], []
    for nh, f in SHAPES["Cora"]:
        print(f"[kernels] Cora layer shape {nh}x{f}")
        cora_cases.append(check_v5(cora, nh, f, with_drop=True))
        print(f"[kernels] Cora layer shape {nh}x{f}, 2-phase")
        cora_two.append(check_two_phase(
            f"Cora {nh}x{f}", v5_two_phase_entries(cora), V5_TWO, n, nh, f,
            e))
    # rows 3 and 4 on their own: every width of the fits, empty and long
    # segments, rows past row_limit, with and without offsets, against
    # the ordered reference's bits
    check_dh_rows(torch, np, ss, dev, errs)
    # fused_gat_table and v5_local_cap take an h table of more rows than
    # destinations: 256 rows put in front of the table and every sender
    # moved up by 256 give the bits of the square call, but for the sums
    # over blocks of senders, held at REL_TOL (more senders move the
    # blocks' bounds): d(a_src) and d(cap) (the backward by sender's
    # partial rows), and so the argmax edge's d(h) row and d(s_dst) entry,
    # where the cap op routes d(cap); every other d(h) row and d(s_dst)
    # entry keeps its bits
    def more_source_rows(label, graph, c2, shift=256):
        n_, e_real_ = graph.num_nodes, graph.num_real_edges
        snd_, rcv_ = graph.senders, graph.receivers
        h, a_src, s_dst, cap, drop = c2["fwd_args"][:5]
        nh, f = c2["nh"], c2["f"]
        w_out = torch.randn((n_, nh * f), generator=gen, device=dev)

        def table_grads(table, senders, n_src):
            order_ = torch.argsort(senders, stable=True).to(torch.int32)
            leaves = [t.clone().requires_grad_(True)
                      for t in (table, a_src, s_dst)]
            cap_ = v5.v5_local_cap(*leaves, senders, rcv_, e_real_, n_, nh,
                                   f)
            out = v5.fused_gat_table(*leaves, cap_, drop, senders, rcv_,
                                     order_, e_real_, n_, nh, f, 1.0, SLOPE,
                                     n_src)
            (out * w_out).sum().backward()
            return [out.detach(), cap_.detach()] + [t.grad for t in leaves]

        square = table_grads(h, snd_, None)
        wider = table_grads(torch.cat([torch.zeros((shift, nh * f),
                                                   device=dev), h]),
                            snd_ + shift, n_ + shift)
        if wider[2].shape[0] != n_ + shift or bool(wider[2][:shift].any()):
            fail(f"fused_gat_table {label}: d(h) of a wider source table "
                 f"has the wrong rows")
        wider[2] = wider[2][shift:]
        tag = f"fused_gat_table {label} with {n_ + shift} source rows"
        hold_all(tag, ("d_h", "d_a_src", "d_s_dst"), wider[2:5],
                 square[2:5], "v5_backward_two_phase", floor=0.0)
        code = int(v5.v5_cap(h, a_src, s_dst, snd_, rcv_, e_real_)[1])
        e_star, k_star = code // nh, code % nh
        rows_ = torch.ones(n_, dtype=torch.bool, device=dev)
        rows_[snd_[e_star].long()] = False
        cells = torch.ones((n_, nh), dtype=torch.bool, device=dev)
        cells[rcv_[e_star].long(), k_star] = False
        same_bits(f"{tag}: d(h) but the argmax sender's row, d(s_dst) "
                  f"but the argmax entry",
                  (square[2][rows_], square[4][cells]),
                  (wider[2][rows_], wider[4][cells]))
        square, wider = square[:2], wider[:2]
        same_bits(f"fused_gat_table {label} with more source rows than "
                  f"destinations", square, wider)
        print(f"[kernels] v5_local_cap and fused_gat_table on {label} with "
              f"{n_ + shift} source rows for {n_} destinations: the bits of "
              f"the square call but its sums over blocks of senders")

    more_source_rows("Cora", cora, cora_two[0])

    elapsed("2b")
    # -- 2b. the Pubmed path's kernels against their plain versions --------
    t0 = time.time()
    raw = datasets.load_planetoid("Pubmed", synthetic_override=True, seed=0)
    pubmed_cpu = loader.transductive_graph(raw, reorder="rcm",
                                           src_windows=True)
    host_s = time.time() - t0
    pubmed = pubmed_cpu.to(dev)
    bl = pubmed.block_layout
    np_, e7, e7_real = pubmed.num_nodes, bl.num_slots, bl.num_real
    print(f"[graph] Pubmed stand-in, RCM-reordered ({host_s:.2f} s on the "
          f"host for data, reorder and layout): {np_} nodes (padded), "
          f"{pubmed.num_real_edges} real edges in {e7} layout slots "
          f"(nb {bl.nb}, eb {bl.eb}, wb {bl.wb}, window {bl.window}, "
          f"dmax {bl.dmax}, src_band {pubmed.src_band})")
    if e7_real != pubmed.num_real_edges:
        fail(f"the layout holds {e7_real} real slots, the graph "
             f"{pubmed.num_real_edges} real edges")

    def check_window(bl, n_, shapes, label):
        """The window kernels (both backward modes) and the reduce by
        offsets at each layer shape on the layout `bl` over n_ nodes;
        returns the inputs for the timings."""
        e7 = bl.num_slots
        src_ids = bl.send[bl.src_perm.long()]      # ascending sender ids
        cases = []
        for nh, f in shapes:
            print(f"[kernels] {label} layer shape {nh}x{f}")
            h, a_src, s_eff, drop, g = op_inputs(torch, gen, n_, nh, f, e7,
                                                 dev)
            d_den = torch.randn((n_, nh), generator=gen, device=dev)
            for tag, mask in (("", drop), (" no dropout", None)):
                fwd_args = (h, a_src, s_eff, mask, bl, SLOPE)
                got = wa.window_forward(*fwd_args)
                want = wa.window_forward_plain(*fwd_args)
                hold_all("window_forward" + tag, ("num", "den", "cap"), got,
                         want, "window_forward")
                if int(got[3]) != int(want[3]):
                    fail(f"argmax code {int(got[3])} != plain "
                         f"{int(want[3])}")
                same_bits("window_forward" + tag, got,
                          wa.window_forward(*fwd_args))
                num, den, cap, _ = want
                need = mask is not None

                def backward_mode(name, key, floor, norm, cotangents):
                    """One backward mode against its plain version, twice,
                    and its d(h) by sender against the route it replaces
                    (the plain per-slot rows reduced by row 3 on the
                    card); returns (its arguments, the plain rows)."""
                    bwd_args = fwd_args + cotangents + (need,)
                    got = list(wa.window_backward(*bwd_args,
                                                  normalize=norm))
                    want = list(wa.window_backward_plain(*bwd_args,
                                                         normalize=norm))
                    same_bits(name, got, wa.window_backward(*bwd_args,
                                                            normalize=norm))
                    keep = [i for i in range(4) if want[i] is not None]
                    hold_all(name, [BWD_NAMES[i] for i in keep],
                             [got[i] for i in keep], [want[i] for i in keep],
                             key, floor)
                    rows = wa.window_backward_rows_plain(*bwd_args,
                                                         normalize=norm)[0]
                    routed = ss.dh_reduce_ptr(rows, bl.src_perm, bl.src_ptr)
                    hold_all(name, ("d_h against row 3 over the plain "
                                    "per-slot rows",), got[:1], (routed,),
                             key, floor)
                    print(f"  {name}: d(h) by sender "
                          f"{'has' if torch.equal(got[0], routed) else 'has not'}"
                          f" the bits of row 3 over the plain per-slot rows")
                    return bwd_args, rows

                for eps, floor in ((1e-8, 1.0), (1.0, 0.0)):
                    out, epsp = epilogue(torch, num, den, cap, f, eps)
                    bwd_args, rows = backward_mode(
                        f"window_backward{tag} eps={eps:g}",
                        "window_backward", floor, True, (g, out, den, epsp))
                    if mask is not None and eps == 1e-8:
                        got = ss.dh_reduce_ptr(rows, bl.src_perm, bl.src_ptr)
                        want = ss.segment_rows_plain(rows, bl.src_perm,
                                                     src_ids, n_)
                        hold_all("segment_sum_rows",
                                 ("(d(h) reduce by ptr)",), (got,), (want,),
                                 "segment_sum_rows")
                        got_t = ss.dh_reduce_ptr(rows, bl.src_perm,
                                                 bl.src_ptr, transposed=True)
                        hold_all("segment_sum_rows_t",
                                 ("(d(h) reduce by ptr, feature-major)",),
                                 (got_t,), (ss.segment_rows_t_plain(
                                     rows, bl.src_perm, src_ids, n_),),
                                 "segment_sum_rows_t")
                        same_bits("segment_sum_rows_t by ptr against "
                                  "segment_sum_rows", (got_t,), (got,))
                        cases.append(dict(nh=nh, f=f, fwd_args=fwd_args,
                                          bwd_args=bwd_args, rows=rows))
                # the parts mode: raw cotangents of num and den, no eps in
                # it, every output at its own magnitude
                parts_args, _ = backward_mode(
                    f"window_backward_parts{tag}", "window_backward_parts",
                    0.0, False, (g, None, d_den, None))
                if mask is not None:
                    cases[-1]["parts_args"] = parts_args
        return cases

    pubmed_cases = check_window(bl, np_, SHAPES["Pubmed"], "Pubmed")
    real = (bl.recv >= 0).nonzero().squeeze(1)
    src_ids = bl.send[bl.src_perm.long()]
    W_TWO = ("window_cap", "window_forward_two_phase",
             "window_backward_two_phase")
    # the index words the window backward by sender reads: recv, dst_perm
    # (every slot), src_perm (the real ones), src_ptr and dst_ptr
    W_BWD_IDX = 2 * e7 + e7_real + 2 * (np_ + 1)
    pubmed_two = []
    for nh, f in SHAPES["Pubmed"]:
        print(f"[kernels] Pubmed layer shape {nh}x{f}, 2-phase")
        pubmed_two.append(check_two_phase(
            f"Pubmed {nh}x{f}", window_two_phase_entries(bl), W_TWO, np_, nh,
            f, e7))

    # the backward by sender at widths no fit gives it on this layout (one
    # head of 7 features: teams of 8 lanes, 32 slots in flight; a 1024-wide
    # row: one team a warp, 32 floats a lane), in every float32 mode,
    # against its plain version and twice for equal bits
    for nh, f in ((1, 7), (8, 128)):
        h, a_src, s_eff, drop, g = op_inputs(torch, gen, np_, nh, f, e7, dev)
        fa = (h, a_src, s_eff, drop, bl, SLOPE)
        num, den, cap, _ = wa.window_forward_plain(*fa)
        out, epsp = epilogue(torch, num, den, cap, f, 1e-8)
        d_den = torch.randn((np_, nh), generator=gen, device=dev)
        for norm, co in ((True, (g, out, den, epsp)),
                         (False, (g, None, d_den, None))):
            name = (f"window_backward{'' if norm else '_parts'} Pubmed "
                    f"layout {nh}x{f}")
            ba = fa + co + (True,)
            got = wa.window_backward(*ba, normalize=norm)
            hold_all(name, BWD_NAMES, got,
                     wa.window_backward_plain(*ba, normalize=norm),
                     "window_backward" if norm else "window_backward_parts",
                     1.0 if norm else 0.0)
            same_bits(name, got, wa.window_backward(*ba, normalize=norm))
        check_two_phase(f"Pubmed layout {nh}x{f}",
                        window_two_phase_entries(bl), W_TWO, np_, nh, f, e7)

    # -- 2b'. the hybrid layout of the cluster-ordered Pubmed stand-in ------
    t0 = time.time()
    hybrid_cpu = loader.transductive_graph(raw, reorder="cluster",
                                           src_windows=True, hybrid=True)
    host_s = time.time() - t0
    hybrid = hybrid_cpu.to(dev)
    hb = hybrid.block_layout
    if hb.rem_send is None or hb.rem_e <= 0:
        fail("the cluster-ordered Pubmed stand-in got a plain layout: no "
             "remainder, so no hybrid path to drive")
    if hb.num_real + hb.rem_e != hybrid.num_real_edges:
        fail(f"{hb.num_real} local + {hb.rem_e} remainder edges, the graph "
             f"has {hybrid.num_real_edges}")
    rem_pad = int(hb.rem_send.shape[0])
    print(f"[graph] Pubmed stand-in, cluster order, hybrid layout "
          f"({host_s:.2f} s on the host for label propagation, reorder and "
          f"layout): {hybrid.num_nodes} nodes (padded), "
          f"{hybrid.num_real_edges} real edges: {hb.num_real} in "
          f"{hb.num_slots} layout slots (local fraction "
          f"{hb.num_real / hybrid.num_real_edges:.4f}; nb {hb.nb}, eb "
          f"{hb.eb}, wb {hb.wb}, window {hb.window}, dmax {hb.dmax}), "
          f"rem_e {hb.rem_e} remainder edges padded to {rem_pad}")
    hybrid_cases = check_window(hb, hybrid.num_nodes, SHAPES["Pubmed"],
                                "Pubmed hybrid layout (in-window edges)")
    # the remainder as the v5 kernels see it: a dst-sorted edge list
    remainder = types.SimpleNamespace(
        num_nodes=hybrid.num_nodes, num_edges=rem_pad,
        num_real_edges=hb.rem_e, senders=hb.rem_send, receivers=hb.rem_recv,
        src_order=hb.rem_order, src_ptr=hb.rem_src_ptr,
        dst_ptr=hb.rem_dst_ptr)
    rem_cases, hybrid_two = [], []
    for nh, f in SHAPES["Pubmed"]:
        print(f"[kernels] Pubmed hybrid remainder layer shape {nh}x{f}")
        rem_cases.append(check_v5(remainder, nh, f, with_drop=True))
        # the v6 form under GAT_TPU_V10=0: the v5 2-phase entries over
        # the cluster-ordered graph's own edges
        print(f"[kernels] Pubmed cluster-ordered graph layer shape {nh}x{f}, "
              f"2-phase (the v6 form)")
        hybrid_two.append(check_two_phase(
            f"Pubmed cluster {nh}x{f}", v5_two_phase_entries(hybrid), V5_TWO,
            hybrid.num_nodes, nh, f, hybrid.num_edges))
    # the layout's own offsets give the bits of the per-call ones, and the
    # parts op takes an h table with more rows than destinations: 256 rows
    # put in front of the table and every sender moved up by 256
    c = rem_cases[0]
    h, a_src, s_eff, drop = c["fwd_args"][:4]
    nh, f, n_ = c["nh"], c["f"], hybrid.num_nodes
    same_bits("v5_forward with the layout's offsets",
              v5.v5_forward(*c["fwd_args"]),
              v5.v5_forward(*c["fwd_args"], hb.rem_dst_ptr))
    w_num = torch.randn((n_, nh * f), generator=gen, device=dev)
    w_den = torch.randn((n_, nh), generator=gen, device=dev)
    shift = 256
    h_wide = torch.cat([torch.zeros((shift, nh * f), device=dev), h])
    send_wide = hb.rem_send + shift
    order_wide = torch.argsort(send_wide[:hb.rem_e].long(), stable=True
                               ).to(torch.int32)

    def parts_grads(table, senders, order, n_src, **ptrs):
        leaves = [t.clone().requires_grad_(True)
                  for t in (table, a_src, s_eff)]
        num, den, cap, code = v5.v5_sweep1_parts(
            *leaves, drop, senders, hb.rem_recv, order, hb.rem_e, n_, nh, f,
            1e-8, SLOPE, n_src, **ptrs)
        ((num * w_num).sum() + (den * w_den).sum() + 2.0 * cap).backward()
        return [num.detach(), den.detach(), cap.detach(), code] + [
            t.grad for t in leaves]

    narrow = parts_grads(h, hb.rem_send, hb.rem_order, None,
                         dst_ptr=hb.rem_dst_ptr, src_ptr=hb.rem_src_ptr)
    wide = parts_grads(h_wide, send_wide, order_wide, n_ + shift)
    if wide[4].shape[0] != n_ + shift or bool(wide[4][:shift].any()):
        fail("v5_sweep1_parts: d(h) of a wider source table has the wrong "
             "rows")
    wide[4] = wide[4][shift:]
    # d(a_src), a sum over blocks of senders, at REL_TOL (more senders
    # move the blocks' bounds); the rest to the bits
    hold_all(f"v5_sweep1_parts with {n_ + shift} source rows",
             ("d_a_src",), wide[5:6], narrow[5:6], "v5_backward_parts",
             floor=0.0)
    same_bits("v5_sweep1_parts with more source rows than destinations",
              narrow[:5] + narrow[6:], wide[:5] + wide[6:])
    print(f"[kernels] v5_sweep1_parts on the remainder with {n_ + shift} "
          f"source rows for {n_} destinations: the bits of the square call "
          f"but d(a_src)")

    # -- 2b''. the sorted segment sum and the gather built on it ------------
    def check_sorted_sum(label, ids, n_, widths):
        """segment_sum_sorted on the ascending ids at each width against
        its plain version; returns {width: (values, ids)}."""
        cases = {}
        for d in widths:
            vals = torch.randn((ids.shape[0], d), generator=gen, device=dev)
            got = ss.segment_sum_sorted(vals, ids, n_)
            want = ss.segment_sum_sorted_plain(vals, ids, n_)
            hold_all(f"segment_sum_sorted {label} D={d}", ("out",), (got,),
                     (want,), "segment_sum_sorted", floor=0.0)
            same_bits(f"segment_sum_sorted {label} D={d}", (got,),
                      (ss.segment_sum_sorted(vals, ids, n_),))
            cases[d] = (vals, ids)
        return cases

    def check_sorted_forms():
        """Row 11's contract case by case: one segment of 100,000 rows,
        every row its own id, ids past the segments, empty segments, at
        widths 1 to 1024, each through the ids, through ids read by a
        permutation (`order`) and through offsets with that permutation,
        with and without row_limit; each form against its plain version
        at REL_TOL x max(1, |ref|), launched twice for equal bits, and the
        three forms of the same rows to each other's bits; a table off
        16-byte alignment at widths 4 and 6."""
        rng = np.random.default_rng(1)
        cases = (
            ("one segment of 100000 rows", np.full(100000, 3), 8,
             (1, 4, 6, 64, 1024)),
            ("every row its own id", np.arange(20000), 20000, (1, 6, 726)),
            ("ids past the segments",
             np.sort(rng.integers(0, 3000, 60000)), 2432, (4, 6, 33)),
            ("empty segments",
             np.sort(rng.choice(np.arange(0, 4000, 7), 50000)), 4000,
             (1, 2, 3, 4, 6, 8, 24, 64, 256, 1024)))
        for label, ids_np, n_, widths in cases:
            e_ = ids_np.shape[0]
            ids = torch.tensor(ids_np, dtype=torch.int32, device=dev)
            perm = torch.randperm(e_, generator=gen, device=dev)
            order_ = perm.to(torch.int32)
            ids_rows = torch.empty_like(ids)
            ids_rows[perm] = ids
            ptr = torch.searchsorted(
                ids, torch.arange(n_ + 1, dtype=torch.int32, device=dev),
                out_int32=True)
            for d in widths:
                vals = torch.randn((e_, d), generator=gen, device=dev)
                stored = torch.empty_like(vals)
                stored[perm] = vals
                for limit in (None, (e_ * 7) // 10):
                    forms = ((vals, ids, {}), (stored, ids_rows,
                                              {"order": order_}),
                             (stored, None, {"order": order_, "ptr": ptr}))
                    first = None
                    for fi, (v, i, kw) in enumerate(forms):
                        name = (f"segment_sum_sorted {label} D={d} "
                                f"row_limit={limit} form {fi}")
                        got = ss.segment_sum_sorted(v, i, n_, row_limit=limit,
                                                    **kw)
                        want = ss.segment_sum_sorted_plain(
                            v, i, n_, row_limit=limit, **kw)
                        hold_all(name, ("out",), (got,), (want,),
                                 "segment_sum_sorted")
                        same_bits(name, (got,), (ss.segment_sum_sorted(
                            v, i, n_, row_limit=limit, **kw),))
                        if first is None:
                            first = got
                        else:
                            same_bits(f"{name} against form 0", (got,),
                                      (first,))
                if d in (4, 6):     # float4 / float2 loads refused
                    buf = torch.randn((e_ * d + 1,), generator=gen,
                                      device=dev)
                    odd = buf[1:].view(e_, d)
                    got = ss.segment_sum_sorted(odd, ids, n_)
                    hold_all(f"segment_sum_sorted {label} D={d} off "
                             f"16-byte alignment", ("out",), (got,),
                             (ss.segment_sum_sorted_plain(odd, ids, n_),),
                             "segment_sum_sorted")
        print("[kernels] segment_sum_sorted: every case and form against "
              "its plain version, equal bits on two launches and across "
              "the forms")

    check_sorted_forms()
    sorted_cases = {}
    hybrid_send_sorted = hybrid.senders[hybrid.src_order.long()]
    print("[kernels] sorted segment sum on the cluster-ordered Pubmed "
          "stand-in's edge list, by receiver and by sorted sender")
    sorted_cases["Pubmed by receiver"] = check_sorted_sum(
        "Pubmed by receiver", hybrid.receivers, hybrid.num_nodes,
        (8, 24, 64, 1024))
    check_sorted_sum("Pubmed by sender", hybrid_send_sorted,
                     hybrid.num_nodes, (1, 8, 33))

    elapsed("2c")
    # -- 2c. the table kernels, and the v5 kernels at the PPI widths --------
    def table_inputs(graph, nh, f, paper_faithful, with_drop):
        """Seeded inputs of the table op as the model hands them over:
        per-head scores through LeakyReLU(0.2) with the per-destination
        max subtracted (paper_faithful), or cross-head scores capped
        before LeakyReLU(0.01); NEG_INF on padding edges."""
        n_, e_ = graph.num_nodes, graph.num_edges
        snd_, rcv_ = graph.senders, graph.receivers
        mask = graph.edge_mask[:, None]
        pad = torch.full((e_, nh), ta.NEG_INF, device=dev)
        h = torch.randn((n_, nh * f), generator=gen, device=dev)
        s_src, s_dst = torch.randn((2, n_, nh), generator=gen, device=dev)
        raw_ = seg.gather_rows(s_src, snd_) + seg.gather_rows(s_dst, rcv_)
        if paper_faithful:
            lg = torch.where(mask, torch.nn.functional.leaky_relu(
                raw_, PF_SLOPE), pad)
            top = seg.segment_max(lg, rcv_, n_)
            top = torch.where(torch.isfinite(top), top,
                              torch.zeros_like(top))
            lg = torch.where(mask, lg - seg.gather_rows(top, rcv_), pad)
        else:
            cap = torch.where(mask, raw_, pad).max()
            lg = torch.where(mask, SLOPE * (raw_ - cap), pad)
        drop = None
        if with_drop:
            drop = ((torch.rand((e_, nh), generator=gen, device=dev)
                     >= DROPOUT).float() / (1.0 - DROPOUT))
        g = torch.randn((n_, nh * f), generator=gen, device=dev)
        return h, lg.contiguous(), drop, g

    def check_table(graph, nh, f, eps, paper_faithful, with_drop):
        """The table kernels at one layer shape on `graph`: the forward
        and the backward by sender as the main path calls them (the
        Graph's receiver offsets; its sender order and offsets), each
        also deriving them, and the backward's prelude (table_dden), each
        against its plain version and launched twice; returns the inputs
        for the timings."""
        h, lg, drop, g = table_inputs(graph, nh, f, paper_faithful,
                                      with_drop)
        er = graph.num_real_edges
        fwd_args = (lg, h, drop, graph.senders, graph.receivers,
                    graph.num_nodes, er, eps)
        fwd_kw = dict(dst_ptr=graph.dst_ptr)
        got = ta.table_forward(*fwd_args, **fwd_kw)
        out, den = ta.table_forward_plain(*fwd_args)
        hold_all("table_forward", ("out", "den"), got, (out, den),
                 "table_forward")
        same_bits("table_forward", got, ta.table_forward(*fwd_args, **fwd_kw))
        same_bits("table_forward deriving its receiver offsets", got,
                  ta.table_forward(*fwd_args))
        # padded rows have no edge and the sink only padding edges
        if not torch.isfinite(got[0]).all() or \
                not (got[0][~graph.node_mask] == 0).all():
            fail("table_forward: rows without a real edge are not 0")
        dden_args = (g, out, den, eps)
        dden = ta.table_dden(*dden_args)
        for floor, tag in ((1.0, ""), (0.0, " at its own magnitude")):
            hold_all("table_dden" + tag, ("dden",), (dden,),
                     (ta.table_dden_plain(*dden_args),), "table_dden", floor)
        same_bits("table_dden", (dden,), (ta.table_dden(*dden_args),))
        bwd_args = (lg, h, drop, graph.senders, graph.receivers, er, eps, g,
                    out, den, with_drop)
        runs = dict(src_order=graph.src_order, src_ptr=graph.src_ptr)
        got = ta.table_backward(*bwd_args, **runs)
        want = ta.table_backward_by_sender_plain(*bwd_args, **runs)
        keep = [i for i in range(3) if want[i] is not None]
        for floor, tag in ((1.0, ""), (0.0, " at its own magnitude")):
            hold_all("table_backward" + tag,
                     [TABLE_BWD_NAMES[i] for i in keep],
                     [got[i] for i in keep], [want[i] for i in keep],
                     "table_backward", floor)
        same_bits("table_backward", got, ta.table_backward(*bwd_args, **runs))
        same_bits("table_backward deriving its sender runs", got,
                  ta.table_backward(*bwd_args))
        sends = torch.zeros(graph.num_nodes, dtype=torch.bool, device=dev)
        sends[graph.senders[:er].long()] = True
        if not all(torch.isfinite(got[i]).all() for i in keep) or \
                not all((got[i][~graph.edge_mask] == 0).all()
                        for i in keep[1:]):
            fail("table_backward: padding edges' cotangents are not 0")
        if not (got[0][~sends] == 0).all():
            fail("table_backward: senders without a real edge have a "
                 "non-zero d(h) row")
        # d(h) as the JAX package forms it: the plain per-edge rows on the
        # card, summed by sender by the d(h) reduce (row 3)
        rows = ta.table_backward_plain(*bwd_args)[0]
        reduced = ss.dh_reduce(rows, graph.src_order, graph.senders,
                               graph.num_nodes, er, src_ptr=graph.src_ptr)
        err, scale = max_err(got[0], reduced, 0.0)
        bits = "equal bits" if torch.equal(got[0], reduced) else "bits differ"
        print(f"  table_backward d_h against dh_reduce over "
              f"table_backward_plain's rows on the card: {bits}, "
              f"max_abs_err {err:.3e} (scale {scale:.3e})")
        return dict(nh=nh, f=f, drop=with_drop, fwd_args=fwd_args,
                    fwd_kw=fwd_kw, bwd_args=bwd_args, runs=runs,
                    dden_args=dden_args)

    inductive = {}
    for name in ("PPI", "PATTERN"):
        load = datasets.load_ppi if name == "PPI" else datasets.load_pattern
        inductive[name] = [load(split, True, 0)
                           for split in ("train", "val", "test")]
    batch_size = get_config("PPI").batch_size
    ppi = loader.InductiveBatcher(inductive["PPI"][0], batch_size,
                                  shuffle=False).epoch()[0].to(dev)
    print(f"[graph] PPI stand-in, one batch of {batch_size} graphs: "
          f"{ppi.num_nodes} nodes (padded, {int(ppi.node_mask.sum())} "
          f"real), {ppi.num_edges} edges (padded), {ppi.num_real_edges} "
          f"real")
    ppi_table_cases, ppi_v5_cases, ppi_two = [], [], []
    for nh, f in SHAPES["PPI"]:
        print(f"[kernels] PPI layer shape {nh}x{f}: table kernels on "
              f"max-subtracted logits at eps = 0, v5 kernels (the wide "
              f"backward), no dropout")
        ppi_table_cases.append(check_table(ppi, nh, f, 0.0, True, False))
        print(f"[kernels] PPI layer shape {nh}x{f}: table kernels at eps = "
              f"1e-8, with dropout")
        check_table(ppi, nh, f, 1e-8, True, True)
        ppi_v5_cases.append(check_v5(ppi, nh, f, with_drop=False))
        print(f"[kernels] PPI layer shape {nh}x{f}, v5 with dropout")
        check_v5(ppi, nh, f, with_drop=True)
        print(f"[kernels] PPI layer shape {nh}x{f}, 2-phase")
        ppi_two.append(check_two_phase(
            f"PPI {nh}x{f}", v5_two_phase_entries(ppi), V5_TWO,
            ppi.num_nodes, nh, f, ppi.num_edges))
    more_source_rows("PPI 4x256", ppi, ppi_two[0])
    # the sorted segment sum where the main path launches it: the
    # gradients of the table path's two score gathers, (E, nh) rows summed
    # by receiver and, through src_order, by sender
    print("[kernels] sorted segment sum at the PPI score widths, and the "
          "sorted-gradient gather")
    ppi_heads = tuple(nh for nh, _ in SHAPES["PPI"])
    ppi_order = ppi.src_order.long()
    sorted_cases["PPI by receiver"] = check_sorted_sum(
        "PPI by receiver", ppi.receivers, ppi.num_nodes, ppi_heads)
    sorted_cases["PPI by sender"] = check_sorted_sum(
        "PPI by sender", ppi.senders[ppi_order], ppi.num_nodes, ppi_heads)
    table = torch.randn((ppi.num_nodes, ppi_heads[0]), generator=gen,
                        device=dev)
    weight = torch.randn((ppi.num_edges, ppi_heads[0]), generator=gen,
                         device=dev)

    def gather_grad(fn):
        t = table.clone().requires_grad_(True)
        (fn(t) * weight).sum().backward()
        return t.grad

    for label, sorted_fn, plain_fn in (
            ("by sender", lambda t: seg.gather_rows_sorted_grad(
                t, ppi.senders, ppi.num_nodes, ppi.src_order),
             lambda t: seg.gather_rows(t, ppi.senders)),
            ("by receiver", lambda t: seg.gather_rows_sorted_grad(
                t, ppi.receivers, ppi.num_nodes),
             lambda t: seg.gather_rows(t, ppi.receivers))):
        got = gather_grad(sorted_fn)
        hold_all(f"gather_rows_sorted_grad {label}", ("d(table)",), (got,),
                 (gather_grad(plain_fn),), "segment_sum_sorted", floor=0.0)
        same_bits(f"gather_rows_sorted_grad {label}", (got,),
                  (gather_grad(sorted_fn),))
    # as the main path calls them: with the Graph's offsets (and the
    # receivers' real-edge count), the padding edges' cotangent zero as
    # the layer's torch.where makes it; against index_select's gradient
    # and against the call without offsets (equal bits)
    weight[ppi.num_real_edges:] = 0.0
    er = ppi.num_real_edges
    for label, with_ptr, without, plain_fn in (
            ("by sender", lambda t: seg.gather_rows_sorted_grad(
                t, ppi.senders, ppi.num_nodes, ppi.src_order,
                ptr=ppi.src_ptr),
             lambda t: seg.gather_rows_sorted_grad(
                 t, ppi.senders, ppi.num_nodes, ppi.src_order),
             lambda t: seg.gather_rows(t, ppi.senders)),
            ("by receiver", lambda t: seg.gather_rows_sorted_grad(
                t, ppi.receivers, ppi.num_nodes, ptr=ppi.dst_ptr,
                num_real=er),
             lambda t: seg.gather_rows_sorted_grad(
                 t, ppi.receivers, ppi.num_nodes),
             lambda t: seg.gather_rows(t, ppi.receivers))):
        build.reset_launches()
        got = gather_grad(with_ptr)
        torch.cuda.synchronize()
        if build.LAUNCHES["segment_sum_sorted"] != 1:
            fail(f"gather_rows_sorted_grad {label} with offsets: "
                 f"{build.LAUNCHES['segment_sum_sorted']} sorted sums")
        hold_all(f"gather_rows_sorted_grad {label} with the graph's "
                 f"offsets", ("d(table)",), (got,), (gather_grad(plain_fn),),
                 "segment_sum_sorted", floor=0.0)
        same_bits(f"gather_rows_sorted_grad {label} with the graph's "
                  f"offsets against without", (got,), (gather_grad(without),))
    print("[kernels] Cora layer shape 8x8: table kernels on capped logits "
          "with dropout at eps = 1e-8")
    cora_table_case = check_table(cora, 8, 8, 1e-8, False, True)
    batch_size = get_config("PATTERN").batch_size
    pattern = loader.InductiveBatcher(inductive["PATTERN"][0], batch_size,
                                      shuffle=False).epoch()[0].to(dev)
    print(f"[graph] PATTERN stand-in, one batch of {batch_size} graphs: "
          f"{pattern.num_nodes} nodes (padded), {pattern.num_edges} edges "
          f"(padded), {pattern.num_real_edges} real")
    pattern_table_cases, pattern_v5_cases = [], []
    for nh, f in SHAPES["PATTERN"]:
        print(f"[kernels] PATTERN layer shape {nh}x{f}: table kernels on "
              f"capped logits at eps = 1e-8, v5 kernels, no dropout")
        pattern_table_cases.append(check_table(pattern, nh, f, 1e-8, False,
                                               False))
        pattern_v5_cases.append(check_v5(pattern, nh, f, with_drop=False))
        print(f"[kernels] PATTERN layer shape {nh}x{f}, 2-phase")
        check_two_phase(f"PATTERN {nh}x{f}", v5_two_phase_entries(pattern),
                        V5_TWO, pattern.num_nodes, nh, f, pattern.num_edges)

    elapsed("2d")
    # -- 2d. the bfloat16 modes against their plain versions ---------------
    # Every mode of every entry that a knob of the JAX package selects, at
    # the layer shapes of the cells that run it; each against its plain
    # version in the same mode and in float32 (hold_mode), twice.
    TABLE_ACC = Rounding(table=True, acc=True)
    V5_MODES = (Rounding(acc=True), Rounding(table=True), TABLE_ACC)

    def check_v5_modes(graph, label, nh, f, fwd_modes, bwd_mode, parts):
        """The v5 entries' bfloat16 modes at one layer shape on `graph`'s
        edges: each forward mode with dropout; the backward mode at eps =
        1e-8 and 1, or (parts) in the parts mode. Returns the inputs of
        the timings (the last forward mode)."""
        n_, er = graph.num_nodes, graph.num_real_edges
        ga = (graph.senders, graph.receivers, er)
        h, a_src, s_eff, drop, g = op_inputs(torch, gen, n_, nh, f,
                                             graph.num_edges, dev)
        fp = (h, a_src, s_eff, drop) + ga + (SLOPE,)
        num, den, cap, _ = v5.v5_forward_plain(*fp)
        case = dict(nh=nh, f=f, drop=True, f32_args=fp)
        for rnd in fwd_modes:
            name = f"v5_forward {label} [{mode_tag(rnd)}]"
            fa = (rnd.table_of(h),) + fp[1:]
            got = v5.v5_forward(*fa, rounding=rnd)
            want = v5.v5_forward_plain(*fa, rounding=rnd)
            hold_mode(name, ("num", "den", "cap"), got[:3], want[:3],
                      (num, den, cap), "v5_forward_bf16")
            if int(got[3]) != int(want[3]):
                fail(f"{name}: argmax code {int(got[3])} != plain "
                     f"{int(want[3])}")
            same_bits(name, got, v5.v5_forward(*fa, rounding=rnd))
            case.update(fwd_args=fa, rounding=rnd)
        fa, rnd = case["fwd_args"], bwd_mode
        fa = (rnd.table_of(h),) + fp[1:]
        d_den = torch.randn((n_, nh), generator=gen, device=dev)
        runs = ([("parts", "v5_backward_parts_bf16", (g, None, d_den, None,
                                                      True), False, 0.0)]
                if parts else
                [(f"eps={eps:g}", "v5_backward_bf16",
                  (g,) + (lambda o: (o[0], den, o[1], True))(
                      epilogue(torch, num, den, cap, f, eps)), True, floor)
                 for eps, floor in ((1e-8, 1.0), (1.0, 0.0))])
        for what, key, co, norm, floor in runs:
            name = f"v5_backward {label} [{mode_tag(rnd)}] {what}"
            got = v5.v5_backward(*fa, *co, normalize=norm, rounding=rnd)
            want = v5.v5_backward_by_sender_plain(*fa, *co, normalize=norm,
                                                  rounding=rnd)
            base = v5.v5_backward_by_sender_plain(*fp, *co, normalize=norm)
            hold_mode(name, BWD_NAMES, got, want, base, key, floor)
            same_bits(name, got, v5.v5_backward(*fa, *co, normalize=norm,
                                                rounding=rnd))
            case.setdefault("bwd_args", fa + co)
        case.update(bwd_rounding=rnd)
        return case

    def check_two_phase_modes(label, entries, keys, n_, nh, f, slots, rnd,
                              real=None):
        """The 2-phase entries in mode rnd at one layer shape: the cap pass
        (in the table mode, which it reads), then the forward and the
        backward at eps = 1e-8 and 1, with dropout, each side at its own
        cap (as check_two_phase: the argmax slot has pre == 0 exactly on
        each side, where LeakyReLU's slope at 0 decides its d(raw)): the
        kernel at the kernel's cap, the plain version in the mode at its
        own, the float32 plain version at the cap of the float32 rows.
        Returns the inputs of the timings (eps = 1e-8)."""
        cap_k, cap_p, fwd_k, fwd_p, bwd_k, bwd_p = entries
        kcap, kfwd, kbwd = keys
        h, a_src, s_dst, drop, g = op_inputs(torch, gen, n_, nh, f, slots,
                                             dev)
        hk = rnd.table_of(h)
        cap_args = (hk, a_src, s_dst)
        cap_b = cap_p(h, a_src, s_dst)
        if rnd.table:
            cap_g, cap_w = cap_k(*cap_args, rounding=rnd), cap_p(*cap_args)
            name = f"{kcap} {label} [{mode_tag(rnd)}]"
            hold_mode(name, ("cap",), cap_g[:1], cap_w[:1], cap_b[:1],
                      kcap + "_bf16")
            if int(cap_g[1]) != int(cap_w[1]):
                fail(f"{name}: argmax code {int(cap_g[1])} != plain "
                     f"{int(cap_w[1])}")
            same_bits(name, cap_g, cap_k(*cap_args, rounding=rnd))
        else:   # the cap pass of the float32 rows
            cap_g, cap_w = cap_k(*cap_args), cap_b
        case = None
        for eps in (1e-8, 1.0):
            name = f"{label} [{mode_tag(rnd)}] eps={eps:g}"
            fk = (hk, a_src, s_dst, cap_g[0], drop, eps, SLOPE)
            fp = (hk, a_src, s_dst, cap_w[0], drop, eps, SLOPE)
            fb = (h, a_src, s_dst, cap_b[0], drop, eps, SLOPE)
            got, want = fwd_k(*fk, rnd), fwd_p(*fp, rnd)
            base = fwd_p(*fb)
            hold_mode(f"{kfwd} {name}", ("out", "den"), got, want, base,
                      kfwd + "_bf16")
            same_bits(f"{kfwd} {name}", got, fwd_k(*fk, rnd))
            co = (g, base[0], base[1], True)
            gk, gp = list(bwd_k(*fk, *co, rnd)), list(bwd_p(*fp, *co, rnd))
            gb, again = list(bwd_p(*fb, *co)), list(bwd_k(*fk, *co, rnd))
            if real is not None:
                for x in (gk, gp, gb, again):
                    x[0] = x[0][real]
            same_bits(f"{kbwd} {name}", gk, again)
            hold_mode(f"{kbwd} {name}", BWD_NAMES, gk[:4], gp[:4], gb[:4],
                      kbwd + "_bf16", 1.0 if eps < 1.0 else 0.0)
            hold_mode(f"{kbwd} {name}", ("d_cap",), gk[4:], gp[4:], gb[4:],
                      kbwd + "_bf16",
                      float(gp[2].norm()) if eps == 1.0 else 1.0)
            if case is None:
                case = dict(nh=nh, f=f, cap_args=cap_args, fwd_args=fk,
                            bwd_args=fk + co, rounding=rnd)
        return case

    def check_window_modes(layout, n_, nh, f, rnd, label, parts):
        """The window entries in mode rnd at one layer shape on `layout`:
        the forward with dropout, then the normalised backward at eps =
        1e-8 and 1, or (parts) the parts mode. Returns the inputs of the
        timings."""
        h, a_src, s_eff, drop, g = op_inputs(torch, gen, n_, nh, f,
                                             layout.num_slots, dev)
        fp = (h, a_src, s_eff, drop, layout, SLOPE)
        fa = (rnd.table_of(h),) + fp[1:]
        name = f"window_forward {label} [{mode_tag(rnd)}]"
        num, den, cap, _ = wa.window_forward_plain(*fp)
        got = wa.window_forward(*fa, rounding=rnd)
        want = wa.window_forward_plain(*fa, rounding=rnd)
        hold_mode(name, ("num", "den", "cap"), got[:3], want[:3],
                  (num, den, cap), "window_forward_bf16")
        if int(got[3]) != int(want[3]):
            fail(f"{name}: argmax code {int(got[3])} != plain "
                 f"{int(want[3])}")
        same_bits(name, got, wa.window_forward(*fa, rounding=rnd))
        case = dict(nh=nh, f=f, fwd_args=fa, rounding=rnd)
        d_den = torch.randn((n_, nh), generator=gen, device=dev)
        runs = ([("parts", "window_backward_parts_bf16",
                  (g, None, d_den, None, True), False, 0.0)] if parts else
                [(f"eps={eps:g}", "window_backward_bf16",
                  (g,) + (lambda o: (o[0], den, o[1], True))(
                      epilogue(torch, num, den, cap, f, eps)), True, floor)
                 for eps, floor in ((1e-8, 1.0), (1.0, 0.0))])
        for what, key, co, norm, floor in runs:
            name = f"window_backward {label} [{mode_tag(rnd)}] {what}"
            outs = [list(fn(*args, *co, normalize=norm, **kw)) for fn, args, kw
                    in ((wa.window_backward, fa, {"rounding": rnd}),
                        (wa.window_backward_plain, fa, {"rounding": rnd}),
                        (wa.window_backward_plain, fp, {}),
                        (wa.window_backward, fa, {"rounding": rnd}))]
            same_bits(name, outs[0], outs[3])
            hold_mode(name, BWD_NAMES, *outs[:3], key, floor)
            case.setdefault("parts_args" if parts else "bwd_args", fa + co)
        return case

    def check_table_modes(graph, nh, f, eps, paper_faithful, label):
        """The table entries' bfloat16 modes at one layer shape: each
        forward mode of V5_MODES, the backward by sender on a bfloat16
        table (its only mode), held at 1 and at each output's own
        magnitude."""
        h, lg, drop, g = table_inputs(graph, nh, f, paper_faithful, True)
        fp = (lg, h, drop, graph.senders, graph.receivers, graph.num_nodes,
              graph.num_real_edges, eps)
        out, den = ta.table_forward_plain(*fp)
        fwd_kw = dict(dst_ptr=graph.dst_ptr)
        case = dict(nh=nh, f=f, drop=True, f32_args=fp, fwd_kw=fwd_kw)
        for rnd in V5_MODES:
            name = f"table_forward {label} [{mode_tag(rnd)}]"
            fa = (lg, rnd.table_of(h)) + fp[2:]
            got = ta.table_forward(*fa, rounding=rnd, **fwd_kw)
            hold_mode(name, ("out", "den"), got,
                      ta.table_forward_plain(*fa, rounding=rnd), (out, den),
                      "table_forward_bf16")
            same_bits(name, got, ta.table_forward(*fa, rounding=rnd,
                                                  **fwd_kw))
            same_bits(name + " deriving its receiver offsets", got,
                      ta.table_forward(*fa, rounding=rnd))
            case.update(fwd_args=fa, rounding=rnd)
        rnd = Rounding(table=True)
        co = (graph.senders, graph.receivers, graph.num_real_edges, eps, g,
              out, den, True)
        ba = (lg, rnd.table_of(h), drop) + co
        runs = dict(src_order=graph.src_order, src_ptr=graph.src_ptr)
        name = f"table_backward {label} [{mode_tag(rnd)}]"
        got = ta.table_backward(*ba, rnd, **runs)
        want = ta.table_backward_by_sender_plain(*ba, **runs)
        base = ta.table_backward_by_sender_plain(lg, h, drop, *co, **runs)
        for floor in (1.0, 0.0):
            hold_mode(name, TABLE_BWD_NAMES, got, want, base,
                      "table_backward_bf16", floor)
        same_bits(name, got, ta.table_backward(*ba, rnd, **runs))
        case.update(bwd_args=ba, bwd_rounding=rnd, runs=runs)
        return case

    print("[kernels] the bfloat16 modes")
    cora_modes, cora_two_modes = [], []
    for nh, f in SHAPES["Cora"]:
        cora_modes.append(check_v5_modes(cora, f"Cora {nh}x{f}", nh, f,
                                         V5_MODES, TABLE_ACC, False))
        cora_two_modes.append(check_two_phase_modes(
            f"Cora {nh}x{f}", v5_two_phase_entries(cora), V5_TWO, n, nh, f,
            e, TABLE_ACC))
    pubmed_modes, pubmed_two_modes, hybrid_modes = [], [], []
    pubmed_rows_modes = []
    rem_modes, v6_modes = [], []
    for nh, f in SHAPES["Pubmed"]:
        pair, rows_mode = window_mode(nh, f), window_mode(nh, f, v12=False)
        if not pair.table or rows_mode.table:
            fail(f"Pubmed {nh}x{f}: the packed-window policy is not the "
                 f"table mode")
        pubmed_modes.append(check_window_modes(
            bl, np_, nh, f, pair, f"Pubmed {nh}x{f}", False))
        pubmed_rows_modes.append(check_window_modes(
            bl, np_, nh, f, rows_mode, f"Pubmed {nh}x{f} GAT_TPU_V12=0",
            False))
        with knobs({"GAT_TPU_V6_DTYPE": "bfloat16"}):
            two_mode = wa.window_rounding(nh, f, sweep1=False)
        pubmed_two_modes.append(check_two_phase_modes(
            f"Pubmed {nh}x{f}", window_two_phase_entries(bl), W_TWO, np_, nh,
            f, e7, two_mode))
        hybrid_modes.append(check_window_modes(
            hb, hybrid.num_nodes, nh, f, pair,
            f"Pubmed hybrid layout {nh}x{f}", True))
        rem_modes.append(check_v5_modes(
            remainder, f"Pubmed hybrid remainder {nh}x{f}", nh, f,
            (TABLE_ACC,), TABLE_ACC, True))
        v6_modes.append(check_two_phase_modes(
            f"Pubmed cluster {nh}x{f} (the v6 form)",
            v5_two_phase_entries(hybrid), V5_TWO, hybrid.num_nodes, nh, f,
            hybrid.num_edges, wa.V6_BF16))
    # row 2 at PATTERN's 4-head widths in the bfloat16 table mode too
    # (its narrow backward at 4 heads; no PATTERN fit runs the mode)
    pattern_v5_modes = [check_v5_modes(pattern, f"PATTERN {nh}x{f}", nh, f,
                                       (TABLE_ACC,), TABLE_ACC, False)
                        for nh, f in SHAPES["PATTERN"][:2]]
    ppi_table_modes = [check_table_modes(ppi, nh, f, 0.0, True,
                                         f"PPI {nh}x{f}")
                       for nh, f in SHAPES["PPI"]]
    # the v5 entries' modes at PPI's widths: the backward by sender's wide
    # plans in every mode (d(raw) rounded where kRoundDraw says, the h rows
    # where kRoundRows does), from a bfloat16 table too
    ppi_v5_modes = []
    for nh, f in SHAPES["PPI"]:
        ppi_v5_modes.append(check_v5_modes(ppi, f"PPI {nh}x{f}", nh, f,
                                           V5_MODES, TABLE_ACC, False))
        check_v5_modes(ppi, f"PPI {nh}x{f}", nh, f, (TABLE_ACC,),
                       TABLE_ACC, True)
        for rnd in (TABLE_ACC, wa.V6_BF16):
            check_two_phase_modes(f"PPI {nh}x{f}", v5_two_phase_entries(ppi),
                                  V5_TWO, ppi.num_nodes, nh, f,
                                  ppi.num_edges, rnd)

    elapsed("2e")
    # -- 2e. the v2 kernels (rows 9-10) ------------------------------------
    def check_v2(graph, nh, f, paper_faithful, with_drop, label):
        """The v2 entries at one layer shape on `graph`'s dst-sorted edges
        with the logits of table_inputs and h_src the gathered rows of its
        table: the forward in both modes and in the bfloat16 mode, the
        backward in both modes (normalised also at eps = 1, partial with
        a random d(den)), each held at 1 and at every output's own
        magnitude and launched twice. Returns the inputs of the timings
        and of the cut check."""
        h, lg, drop, g = table_inputs(graph, nh, f, paper_faithful,
                                      with_drop)
        n_, er, rcv_ = graph.num_nodes, graph.num_real_edges, graph.receivers
        h_src = seg.gather_rows(h, graph.senders).contiguous()
        d_den = torch.randn((n_, nh), generator=gen, device=dev)
        eps = 0.0 if paper_faithful else 1e-8
        empty = seg.segment_sum(graph.edge_mask.float(), rcv_, n_) == 0
        case = dict(nh=nh, f=f, drop=with_drop, eps=eps)
        for norm in (True, False):
            mode = "normalised" if norm else "partial"
            name = f"v2_forward {label} {mode}"
            names = ("out" if norm else "num", "den")
            fa = (lg, h_src, drop, rcv_, n_, er, eps, norm)
            got = sa.v2_forward(*fa)
            want = sa.v2_forward_plain(*fa)
            hold_all(name, names, got, want, "v2_forward")
            same_bits(name, got, sa.v2_forward(*fa))
            same_bits(name + " with the graph's dst_ptr", got,
                      sa.v2_forward(*fa, dst_ptr=graph.dst_ptr))
            if not all(torch.isfinite(x).all() for x in got) or \
                    not all((x[empty] == 0).all() for x in got):
                fail(f"{name}: rows without a real edge are not 0")
            fb = fa + (V2_BF16,)
            got_b = sa.v2_forward(*fb)
            hold_mode(f"{name} [{mode_tag(V2_BF16)}]", names, got_b,
                      sa.v2_forward_plain(*fb), want, "v2_forward_bf16")
            same_bits(f"{name} [{mode_tag(V2_BF16)}]", got_b,
                      sa.v2_forward(*fb))
            for eps_b in ((eps, 1.0) if norm else (0.0,)):
                name = f"v2_backward {label} {mode} eps={eps_b}"
                out_, den_ = sa.v2_forward_plain(lg, h_src, drop, rcv_, n_,
                                                 er, eps_b, True)
                ba = (lg, h_src, drop, rcv_, er, eps_b, g,
                      out_ if norm else None, den_ if norm else d_den,
                      with_drop, norm)
                got = sa.v2_backward(*ba)
                want = sa.v2_backward_plain(*ba)
                keep = [i for i in range(3) if want[i] is not None]
                for floor, tag in ((1.0, ""), (0.0, " at its own magnitude")):
                    hold_all(name + tag, [V2_BWD_NAMES[i] for i in keep],
                             [got[i] for i in keep], [want[i] for i in keep],
                             "v2_backward", floor)
                same_bits(name, got, sa.v2_backward(*ba))
                if not all(torch.isfinite(got[i]).all() and
                           (got[i][~graph.edge_mask] == 0).all()
                           for i in keep):
                    fail(f"{name}: padding edges' cotangents are not 0")
                case.setdefault(f"bwd_{mode}", ba)
            case[f"fwd_{mode}"] = fa
        # edges whose receiver is no row of the call (a cotangent of fewer
        # rows than the receivers reach) get zero cotangents
        ba = case["bwd_partial"]
        cut = n_ - 7
        bc = ba[:6] + (ba[6][:cut].contiguous(), None,
                       ba[8][:cut].contiguous()) + ba[9:]
        name = f"v2_backward {label} partial over the first {cut} rows"
        got, want = sa.v2_backward(*bc), sa.v2_backward_plain(*bc)
        keep = [i for i in range(3) if want[i] is not None]
        hold_all(name, [V2_BWD_NAMES[i] for i in keep],
                 [got[i] for i in keep], [want[i] for i in keep],
                 "v2_backward", 0.0)
        past = rcv_ >= cut
        if not all((got[i][past] == 0).all() for i in keep):
            fail(f"{name}: edges past the rows have non-zero cotangents")
        # the sharded layer hands the partial op the real edges' h_src
        # rows alone: the same bits, d(h_src) for those rows
        name = f"v2 {label} partial on the real edges' h_src rows"
        fa, ba = case["fwd_partial"], case["bwd_partial"]
        same_bits(name, sa.v2_forward(*fa),
                  sa.v2_forward(lg, h_src[:er], *fa[2:]))
        full = sa.v2_backward(*ba)
        same_bits(name, (full[0], full[1][:er], full[2]),
                  sa.v2_backward(lg, h_src[:er], *ba[2:]))
        return case

    def check_cut(graph, c, label, k=4):
        """The cut contract: the partial kernel on each of k contiguous
        slices of the edge list, each told its own real-edge count,
        summed and divided, against the unsharded normalised kernel and
        its plain version."""
        lg, h_src, drop, rcv_, n_, er, eps, _ = c["fwd_normalised"]
        e_ = rcv_.shape[0]
        if e_ % k:
            fail(f"{label}: {e_} edges do not divide over {k} shards")
        s_ = e_ // k
        num = den = 0.0
        for i in range(k):
            sl = slice(i * s_, (i + 1) * s_)
            n_i, d_i = sa.v2_forward(
                lg[sl], h_src[sl], None if drop is None else drop[sl],
                rcv_[sl], n_, min(max(er - i * s_, 0), s_), 0.0, False)
            num, den = num + n_i, den + d_i
        inv = torch.where(den > 0, 1.0 / (den + eps), torch.zeros_like(den))
        out = (num.view(n_, c["nh"], c["f"]) * inv[:, :, None]).reshape(
            n_, -1)
        fa = c["fwd_normalised"]
        for what, want in (("kernel", sa.v2_forward(*fa)),
                           ("plain version", sa.v2_forward_plain(*fa))):
            hold_all(f"v2 partial over {k} edge shards {label}, summed, "
                     f"vs the unsharded {what}", ("out", "den"), (out, den),
                     want, "v2_forward")

    v2_cases = {}
    for ds, graph, pf in (("Cora", cora, False), ("PPI", ppi, True)):
        for nh, f in SHAPES[ds]:
            for with_drop in (False, True):
                label = (f"{ds} {nh}x{f}"
                         f"{' with dropout' if with_drop else ''}")
                print(f"[kernels] v2 entries at {label} ({graph.num_edges} "
                      f"edges, {graph.num_real_edges} real)")
                v2_cases[label] = check_v2(graph, nh, f, pf, with_drop,
                                           label)
    for label in ("Cora 8x8 with dropout", "PPI 4x256"):
        check_cut(cora if label.startswith("Cora") else ppi,
                  v2_cases[label], label)

    elapsed("2f")
    # -- 2f. the dst-owned layout's kernels, shard by shard -----------------
    from gat_pytorch_tpu_torch.graph import transforms as TT
    from gat_pytorch_tpu_torch.parallel import (dst_shard,
                                                partition_edges_by_dst)

    def hold_v5_parts(label, args, g, dden, drop):
        """The v5 parts forward and backward (d(h) over all the table's
        rows) on one edge list against their plain versions; returns the
        forward's parts without dropout."""
        h, a_src, sd, s_src, snd, rcv, order, er, dptr, sptr = args
        got = v5.v5_forward(h, a_src, sd, drop, snd, rcv, er, SLOPE, dptr,
                            s_src=s_src)
        want = v5.v5_forward_plain(h, a_src, sd, drop, snd, rcv, er, SLOPE,
                                   s_src=s_src)
        hold_all(f"{label} v5_forward (parts)", ("num", "den", "cap'"),
                 got[:3], want[:3], "v5_forward")
        if int(got[3]) != int(want[3]):
            fail(f"{label}: v5_forward's argmax code differs")
        got = v5.v5_backward(h, a_src, sd, drop, snd, rcv, er, SLOPE, g,
                             None, dden, None, True, normalize=False,
                             dst_ptr=dptr, src_order=order, src_ptr=sptr,
                             s_src=s_src)
        want = v5.v5_backward_by_sender_plain(
            h, a_src, sd, drop, snd, rcv, er, SLOPE, g, None, dden, None,
            True, normalize=False, s_src=s_src, src_order=order,
            src_ptr=sptr)
        if got[0].shape != h.shape:
            fail(f"{label}: v5_backward_parts' d(h) of shape "
                 f"{tuple(got[0].shape)}, not the table's {tuple(h.shape)}")
        hold_all(f"{label} v5_backward_parts",
                 ("d_h", "d_drop", "d_s_dst", "d_a_src"), got, want,
                 "v5_backward_parts", 0.0)
        return v5.v5_forward(h, a_src, sd, None, snd, rcv, er, SLOPE, dptr,
                             s_src=s_src)[:3]

    def hold_window_parts(label, args, bl, g, dden, drop):
        """The same for the windowed parts op over a shard's layout."""
        h, a_src, sd, s_src = args
        got = wa.window_forward(h, a_src, sd, drop, bl, SLOPE, s_src=s_src)
        want = wa.window_forward_plain(h, a_src, sd, drop, bl, SLOPE,
                                       s_src=s_src)
        hold_all(f"{label} window_forward (parts)", ("num", "den", "cap'"),
                 got[:3], want[:3], "window_forward")
        got = wa.window_backward(h, a_src, sd, drop, bl, SLOPE, g, None,
                                 dden, None, True, normalize=False,
                                 s_src=s_src)
        want = wa.window_backward_plain(h, a_src, sd, drop, bl, SLOPE, g,
                                        None, dden, None, True,
                                        normalize=False, s_src=s_src)
        if got[0].shape != h.shape:
            fail(f"{label}: window_backward_parts' d(h) of shape "
                 f"{tuple(got[0].shape)}, not the table's {tuple(h.shape)}")
        hold_all(f"{label} window_backward_parts",
                 ("d_h", "d_drop", "d_s_dst", "d_a_src"), got, want,
                 "window_backward_parts", 0.0)
        return wa.window_forward(h, a_src, sd, None, bl, SLOPE,
                                 s_src=s_src)[:3]

    def drop_mask(slots, nh):
        return ((torch.rand((slots, nh), generator=gen, device=dev)
                 >= DROPOUT).float() / (1.0 - DROPOUT))

    def hold_dst_shards(label, graph, part, branch, nh, f):
        """The dst-owned branch's kernels on each of DST_K shards of
        `graph` partitioned by destination (N / DST_K rows, the h table's
        N rows): forward and backward against their plain versions with
        dropout; then the shards' normalised outputs without dropout (the
        global cap' the largest shard cap', one bound B for all), joined
        in row order, against the unsharded layer's op on the graph."""
        graph = graph.to(dev)
        g2, eps_ = partition_edges_by_dst(graph.to("cpu"), DST_K, **part)
        n_, d = g2.num_nodes, nh * f
        rows = n_ // DST_K
        h = torch.randn((n_, d), generator=gen, device=dev)
        a_src = torch.randn((d, nh), generator=gen, device=dev) / d ** 0.5
        s_dst = torch.randn((n_, nh), generator=gen, device=dev)
        s_src = v5.source_scores(h, a_src)
        s_eff = (s_dst - (s_src.max() + s_dst.max())).contiguous()

        def table_logits(snd, rcv, emask):
            score = (seg.gather_rows(s_src, snd)
                     + seg.gather_rows(s_dst, rcv))
            return torch.where(
                emask[:, None],
                torch.nn.functional.leaky_relu(score, PF_SLOPE),
                torch.full_like(score, ta.NEG_INF)).contiguous()

        outs, parts, real = [], [], []
        for j in range(DST_K):
            sh = dst_shard(g2, j, DST_K).to(dev)
            rcv = (sh.receivers - j * rows).contiguous()
            real.append(sh.num_real_edges)
            g = torch.randn((rows, d), generator=gen, device=dev)
            tag = f"{label} shard {j}/{DST_K}"
            if branch == "table":
                lg = table_logits(sh.senders, sh.receivers, sh.edge_mask)
                fwd = (lg, h, drop_mask(eps_, nh), sh.senders, rcv, rows,
                       sh.num_real_edges, 0.0)
                got = ta.table_forward(*fwd, dst_ptr=sh.dst_ptr)
                want = ta.table_forward_plain(*fwd)
                hold_all(f"{tag} table_forward", ("out", "den"), got, want,
                         "table_forward")
                bwd = (*fwd[:3], sh.senders, rcv, sh.num_real_edges, 0.0, g,
                       want[0], want[1], True)
                got = ta.table_backward(*bwd, src_order=sh.src_order,
                                        src_ptr=sh.src_ptr)
                want = ta.table_backward_by_sender_plain(
                    *bwd, sh.src_order, sh.src_ptr)
                if got[0].shape != h.shape:
                    fail(f"{tag}: table_backward's d(h) of shape "
                         f"{tuple(got[0].shape)}")
                hold_all(f"{tag} table_backward",
                         ("d_h", "d_logits", "d_drop"), got, want,
                         "table_backward", 0.0)
                outs.append(ta.table_forward(
                    lg, h, None, sh.senders, rcv, rows, sh.num_real_edges,
                    0.0, dst_ptr=sh.dst_ptr)[0])
                continue
            dden = torch.randn((rows, nh), generator=gen, device=dev)
            sd = s_eff[j * rows:(j + 1) * rows].contiguous()
            bl = sh.block_layout
            acc = []
            if branch in ("v7", "hybrid"):
                acc.append(hold_window_parts(
                    f"{tag} ({bl.num_real} of {bl.num_slots} slots real)",
                    (h, a_src, sd, s_src), bl, g, dden,
                    drop_mask(bl.num_slots, nh)))
            lists = []
            if branch == "v5":
                lists = [(sh.senders, rcv, sh.src_order, sh.num_real_edges,
                          sh.dst_ptr, sh.src_ptr)]
            elif branch == "hybrid":
                lists = [(bl.rem_send, bl.rem_recv, bl.rem_order, bl.rem_e,
                          bl.rem_dst_ptr, bl.rem_src_ptr)]
            for snd, rcv_, order, er, dptr, sptr in lists:
                acc.append(hold_v5_parts(
                    f"{tag} ({er} real edges of {snd.shape[0]})",
                    (h, a_src, sd, s_src, snd, rcv_, order, er, dptr, sptr),
                    g, dden, drop_mask(snd.shape[0], nh)))
            parts.append((sum(p[0] for p in acc), sum(p[1] for p in acc),
                          torch.stack([p[2] for p in acc]).max()))
        if branch == "table":
            joined = torch.cat(outs)
            want = ta.table_forward(
                table_logits(graph.senders, graph.receivers,
                             graph.edge_mask), h, None, graph.senders,
                graph.receivers, n_, graph.num_real_edges, 0.0,
                dst_ptr=graph.dst_ptr)[0]
            key = "table_forward"
        else:
            cap_g = torch.stack([p[2] for p in parts]).max()
            joined = torch.cat([epilogue(torch, num, den, cap_g, f, 1e-8)[0]
                                for num, den, _ in parts])
            if branch == "v7":
                want = wa.fused_gat_window_v7(h, a_src, s_dst, None,
                                              graph.block_layout, None, n_,
                                              nh, f, 1e-8, SLOPE)
                key = "window_forward"
            else:
                want = v5.fused_gat_table_autocap(
                    h, a_src, s_dst, None, graph.senders, graph.receivers,
                    graph.src_order, graph.num_real_edges, None, n_, nh, f,
                    1e-8, SLOPE, src_ptr=graph.src_ptr,
                    dst_ptr=graph.dst_ptr)
                key = "v5_forward"
        torch.cuda.synchronize()
        rem = ("" if branch != "hybrid" else
               f", remainders {g2.block_layout.rem_count.tolist()}")
        print(f"[dst-owned] {label}: {DST_K} shards of {rows} rows and "
              f"{eps_} edge slots ({real} real edges{rem}); the joined "
              f"outputs against the unsharded layer's op")
        hold(f"{label} joined", joined, want, errs[key])

    with knobs(F32):
        for label, graph, part, branch, (nh, f) in (
                ("Cora", cora, {}, "v5", SHAPES["Cora"][0]),
                ("Pubmed RCM", pubmed_cpu, dict(src_windows=True), "v7",
                 SHAPES["Pubmed"][0]),
                ("Pubmed cluster", hybrid_cpu,
                 dict(src_windows=True, hybrid=True), "hybrid",
                 SHAPES["Pubmed"][0]),
                ("PPI paper_faithful", ppi, {}, "table",
                 SHAPES["PPI"][0])):
            print(f"[kernels] dst-owned shards of {label}, {nh}x{f} "
                  f"({branch})")
            hold_dst_shards(f"{label} {nh}x{f}", graph, part, branch, nh, f)

    # empty edge lists: the last of DST_K shards of a 32-node bucket of 24
    # real nodes holds only padding rows; the parts ops give zeros, cap'
    # -1e30 and code 0 as the JAX ops do, launch nothing, and have no
    # gradient
    rng_ = np.random.default_rng(1)
    tiny = TT.canonicalize(
        rng_.normal(size=(24, 16)).astype(np.float32),
        np.repeat(np.arange(24), 3), rng_.integers(0, 24, 72),
        node_bucket=32, edge_bucket=128, pad_multiple=32)
    tg2, _ = partition_edges_by_dst(tiny, DST_K, pad_multiple=32,
                                    src_windows=True, nb=128, eb=128)
    empty = dst_shard(tg2, DST_K - 1, DST_K).to(dev)
    if empty.num_real_edges or empty.block_layout.num_real:
        fail("the padded bucket's last shard has real edges")
    rows_e = tg2.num_nodes // DST_K
    leaves = [torch.randn(shape, generator=gen, device=dev).requires_grad_()
              for shape in ((tg2.num_nodes, 16), (16, 2), (rows_e, 2))]
    rcv = (empty.receivers - (DST_K - 1) * rows_e).contiguous()
    before = dict(build.LAUNCHES)
    for op, run in (
            ("v5_sweep1_parts", lambda: v5.v5_sweep1_parts(
                *leaves, None, empty.senders, rcv, empty.src_order, 0,
                rows_e, 2, 8, 1e-8, SLOPE, tg2.num_nodes,
                dst_ptr=empty.dst_ptr, src_ptr=empty.src_ptr)),
            ("v7_sweep1_parts", lambda: wa.v7_sweep1_parts(
                *leaves, None, empty.block_layout, rows_e, 2, 8, 1e-8,
                SLOPE, tg2.num_nodes))):
        num, den, cap, code = run()
        (num.sum() + den.sum() + cap).backward()
        torch.cuda.synchronize()
        grads = [t.grad for t in leaves]
        if (num.any() or den.any() or cap.item() != -1.0000000150474662e30
                or int(code) != 0 or any(not torch.isfinite(x).all()
                                         or x.any() for x in grads)):
            fail(f"{op} over no edges: not (0, 0, -1e30, 0) with zero "
                 f"gradients")
        for t in leaves:
            t.grad = None
        print(f"[dst-owned] {op} over a shard without edges on the card: "
              f"num 0, den 0, cap' {cap.item():.6e}, code 0, zero "
              f"gradients")
    if dict(build.LAUNCHES) != before:
        fail("a parts op over no edges launched a kernel")

    if "--checks-only" in sys.argv[1:]:
        print("chip_smoke: --checks-only: every kernel built and held "
              "against its plain version; no fit, no timing, no result line")
        return 0

    elapsed("3")
    # -- 3. the main paths: train each stand-in ----------------------------
    def cell_data(dataset, cfg):
        """(train batches, validation batches, reshuffle) as cli.train
        builds them."""
        if dataset == "Cora" and cfg.sampling_fanouts:
            sampled = cli_train.neighbour_sampler(cora_raw, cfg)
            return sampled.epoch(0), [cora], sampled.epoch
        if dataset == "Cora":
            return [cora], [cora], None
        if dataset == "Pubmed":
            graph = hybrid if cfg.reorder == "cluster" else pubmed
            return [graph], [graph], None
        train, val, _ = inductive[dataset]
        batcher = loader.InductiveBatcher(train, cfg.batch_size, seed=0)
        val_data = loader.InductiveBatcher(val, cfg.batch_size,
                                           shuffle=False).epoch()
        return batcher.epoch(0), val_data, batcher.epoch

    def make_trainer(dataset, overrides, max_epochs):
        """(config, trainer, train batches, validation batches, reshuffle)
        of one fit from seed 0, as cli.train sets it up."""
        cfg = get_config(dataset, num_epochs=max_epochs, device="cuda",
                         **overrides)
        plateau = (O.ReduceLROnPlateau(factor=0.5, patience=5, min_lr=1e-6)
                   if dataset == "PATTERN" else None)
        task = make_task(dataset, attention_reward=cfg.attention_reward,
                         attention_penalty=cfg.attention_penalty)
        trainer = Trainer(cfg=cfg.gat_config(), task=task,
                          learning_rate=cfg.learning_rate,
                          weight_decay=cfg.l2_reg, max_epochs=cfg.num_epochs,
                          patience=cfg.patience, plateau=plateau, seed=0,
                          device="cuda",
                          backend=("naive" if cfg.layer_type == "naive"
                                   else cfg.backend))
        return (cfg, trainer) + cell_data(dataset, cfg)

    fits, launches, per_epoch = {}, {k: 0 for k in REPLACES}, {}

    def train_cell(name, spec, fit):
        """Fit one cell through `fit` (trainer, train batches, validation
        batches, reshuffle) -> TrainResult, the launch counters set to 0
        just before and read just after; check the loss, the layer paths
        and every kernel's launches; evaluate; return (config, trainer,
        final parameters, first train batch)."""
        dataset, overrides, max_epochs, path, layers = spec
        cfg, trainer, train_data, val_data, reshuffle = make_trainer(
            dataset, overrides, max_epochs)
        env = CELL_ENV.get(name, {})
        gat.PATH_TRACE.clear()
        build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        with knobs(env):
            result = fit(trainer, train_data, val_data, reshuffle)
        torch.cuda.synchronize()
        wall = time.time() - t0
        ran = dict(build.LAUNCHES)
        trace = set(gat.PATH_TRACE)
        hist = result.history
        epochs = len(hist)
        losses = [r["train_loss"] for r in hist]
        val_key = next(k for k in hist[-1]
                       if k.startswith("val_") and k != "val_loss")
        print(f"[train] {name}{''.join(f' {k}={v}' for k, v in env.items())}"
              f": {epochs} epochs of {len(train_data)} train "
              f"and {len(val_data)} validation batches in {wall:.3f} s "
              f"({wall / epochs * 1e3:.3f} ms/epoch incl. the host's "
              f"batching and the per-epoch metric sync); train_loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; {val_key} "
              f"{hist[-1][val_key]:.4f}; paths {sorted(trace)}; launches "
              f"{ran}")
        if not all(math.isfinite(v) for v in losses) or \
                not math.isfinite(hist[-1][val_key]):
            fail(f"{name}: train loss or {val_key} is not finite")
        if not losses[-1] < losses[0]:
            fail(f"{name}: train loss did not fall")
        forwards = layers * (len(train_data) + len(val_data)) * epochs
        traced = path.split()[0]
        if trace != {traced} or len(gat.PATH_TRACE) != forwards:
            fail(f"{name}: layer paths {sorted(trace)} x "
                 f"{len(gat.PATH_TRACE)}, expected {traced} x {forwards}")
        per_epoch[name] = launches_per_epoch(path, layers, len(train_data),
                                             len(val_data))
        for k, per in per_epoch[name].items():
            if ran[k] != per * epochs:
                fail(f"{name}: {k}: {ran[k]} launches on the main path, "
                     f"expected {per * epochs} ({layers} layers x batches, "
                     f"validation forwards included)")
            launches[k] += ran[k]
        test_data = val_data
        if dataset in inductive:      # as cli.train: test batches of one graph
            test_data = loader.InductiveBatcher(
                inductive[dataset][2], 1, shuffle=False).epoch()
        with knobs(env):
            metrics = trainer.evaluate(result.params, test_data)
        print(f"[train] {name}: best epoch {result.best_epoch}, best "
              f"val_loss {result.best_val_loss:.4f}, {metrics}")
        if not all(math.isfinite(v) for v in metrics.values()):
            fail(f"{name}: test metrics are not finite")
        return cfg, trainer, result.final_params, train_data[0].to(dev)

    for name, spec in CELLS.items():
        fits[name] = train_cell(
            name, spec, lambda tr, td, vd, rs: tr.fit_epochs(td, vd,
                                                             reshuffle=rs))

    elapsed("4")
    # -- 4. kernel paths against the plain segment path on the card --------
    def logits_and_grads(trainer, params, graph):
        """The logits and the gradients of the training loss as the step
        takes it (the regulariser's norm included where the task has
        one), without dropout."""
        for p in gat.parameters(params):
            p.grad = None
        loss, logits, _ = trainer.train_loss(params, graph, training=False)
        loss.backward()
        torch.cuda.synchronize()
        return (logits.detach(),
                [p.grad.clone() for p in gat.parameters(params)])

    def hold_model(name, label, lk, gk, lo, go, tol):
        """Logits at max(1, |logits|), and (a trained model's gradients
        are small, and d(a) is a sum of cancelling terms) each gradient
        at the largest gradient's magnitude, not at 1 and not at its own;
        within tol. Returns the logits' relative difference."""
        gscale = max(float(y.abs().max()) for y in go)
        rel = []
        for what, x, y, floor in ([("logits", lk, lo, 1.0)] + [
                (f"grad param {i}", x, y, gscale)
                for i, (x, y) in enumerate(zip(gk, go))]):
            err, scale = max_err(x, y, floor)
            rel.append(err / scale)
            print(f"  {what}: max_abs_err {err:.3e} (scale {scale:.3e})")
            if not scale > 0.0:
                fail(f"{name} vs {label}: {what} all zeros, nothing to hold")
            if not err <= tol * scale:
                fail(f"{name}: {what} differs from the {label} path: {err} "
                     f"> {tol} x {scale}")
        return rel[0]

    def attention_of(trainer, params, graph, backend):
        """The model's alpha of each layer and its attention norm on
        `backend`, without dropout."""
        with torch.no_grad():
            _, att = gat.gat_model_apply(params, trainer.cfg, graph,
                                         device=dev, backend=backend,
                                         return_attention=True)
            norm = gat.calc_attention_norm(graph, att)
        torch.cuda.synchronize()
        return att, norm

    def hold_attention(name, trainer, params, graph, env):
        """A regularised model's alpha of each layer, (E, heads) over the
        graph's edges and 0 on its padding edges, within REL_TOL (alpha
        lies in [0, 1]) and its attention norm within REL_TOL of its own
        magnitude, on the kernel path against the segment path and the
        naive layer."""
        with knobs(env):
            att_k, norm_k = attention_of(trainer, params, graph, "kernel")
        pad = ~graph.edge_mask
        for i, (alpha, heads) in enumerate(zip(
                att_k, trainer.cfg.num_heads_per_layer)):
            if alpha.shape != (graph.num_edges, heads) or \
                    not torch.isfinite(alpha).all() or \
                    bool(alpha[pad].any()):
                fail(f"{name}: layer {i}'s alpha of shape "
                     f"{tuple(alpha.shape)}, not finite or not 0 on the "
                     f"padding edges")
        for backend in ("segment", "naive"):
            att_o, norm_o = attention_of(trainer, params, graph, backend)
            errs_a = [max_err(x, y)[0] for x, y in zip(att_k, att_o)]
            err_n = abs(float(norm_k) - float(norm_o))
            print(f"[model] {name}: kernel path vs {backend} path, alpha "
                  f"per layer max_abs_err {[f'{e:.3e}' for e in errs_a]}, "
                  f"attention norm {float(norm_k):.6e} vs "
                  f"{float(norm_o):.6e}")
            if not max(errs_a) <= REL_TOL:
                fail(f"{name}: alpha differs from the {backend} path's: "
                     f"{errs_a}")
            if not err_n <= REL_TOL * abs(float(norm_o)):
                fail(f"{name}: the attention norm differs from the "
                     f"{backend} path's: {float(norm_k)} vs "
                     f"{float(norm_o)}")

    def float32_env(env):
        """The same cell's knobs with its bfloat16 ones dropped and the
        windowed op's contraction pinned to float32."""
        return {**{k: v for k, v in env.items() if k not in BF16_KNOBS},
                **F32}

    refs = {}
    for name, (cfg, trainer, params, graph) in fits.items():
        refs[name] = Trainer(cfg=cfg.gat_config(), task=trainer.task,
                             learning_rate=0.0, device="cuda",
                             backend="segment")
        env = CELL_ENV.get(name, {})
        bf16 = "bf16" in name
        with knobs(env):
            lk, gk = logits_and_grads(trainer, params, graph)
        shape = ((graph.num_nodes,) if trainer.task.squeeze_output
                 else (graph.num_nodes, cfg.num_classes))
        if lk.shape != shape or not torch.isfinite(lk).all():
            fail(f"{name}: logits of shape {tuple(lk.shape)} or not finite")
        if bf16:
            # the same model in float32 on the kernel path and on the
            # segment path: the bfloat16 model within BF16_TOL of both,
            # and further from the float32 kernel path than 10x the
            # float32 paths' own difference (the mode is live)
            f32 = float32_env(env)
            outs = {}
            for label, other in (("float32 kernel", trainer),
                                 ("float32 segment", refs[name])):
                gat.PATH_TRACE.clear()
                with knobs(f32):
                    outs[label] = logits_and_grads(other, params, graph)
                print(f"[model] {name}: bfloat16 kernel path vs {label} "
                      f"path {gat.PATH_TRACE} on the card")
                rel = hold_model(name, label, lk, gk, *outs[label], BF16_TOL)
                if label == "float32 kernel":
                    live = rel
            print(f"[model] {name}: float32 kernel path vs float32 segment "
                  f"path on the card")
            noise = hold_model(name, "float32 segment",
                               *outs["float32 kernel"],
                               *outs["float32 segment"], REL_TOL)
            print(f"[model] {name}: the bfloat16 logits differ from the "
                  f"float32 kernel path's by {live:.3e} of their scale, the "
                  f"float32 paths' by {noise:.3e}")
            if not live > 10.0 * noise:
                fail(f"{name}: the bfloat16 mode is not live ({live} <= 10 x "
                     f"{noise})")
            continue
        others = [("segment", refs[name], graph, {})]
        if {"GAT_TPU_V10", "GAT_TPU_V5_MERGED"} & set(env):
            # the same model on the single-sweep kernel path
            others.append(("single-sweep kernel", trainer, graph,
                           {k: v for k, v in env.items()
                            if k not in ("GAT_TPU_V10",
                                         "GAT_TPU_V5_MERGED")}))
        if graph.block_layout is not None:
            others.append(("v5 kernel", trainer,
                           graph.replace(block_layout=None), env))
        for label, other, other_graph, other_env in others:
            gat.PATH_TRACE.clear()
            with knobs(other_env):
                lo, go = logits_and_grads(other, params, other_graph)
            print(f"[model] {name}: {trainer.backend} path vs {label} "
                  f"path {gat.PATH_TRACE} on the card")
            hold_model(name, label, lk, gk, lo, go, REL_TOL)
        if trainer.task.attention_coef != 0.0:
            hold_attention(name, trainer, params, graph, env)

    elapsed("4b")
    # -- 4b. run-to-run reproducibility ------------------------------------
    # The port's kernels sum in fixed orders and the kernel path's gathers
    # reduce their gradients through segment_sum_sorted, so two fits from
    # one seed must agree bit for bit: every epoch's losses and metrics,
    # every parameter.
    def one_step_report(name, dataset, overrides):
        """Where two fits differ: the gradients of one step, twice, from
        the same parameters and the same generator state."""
        _, trainer, train_data, _, _ = make_trainer(dataset, overrides, 1)
        params, graph = trainer.init_params(), train_data[0].to(dev)
        runs = []
        for _ in range(2):
            for q in gat.parameters(params):
                q.grad = None
            loss, logits, _ = trainer.train_loss(
                params, graph, generator=trainer.dropout_generator())
            loss.backward()
            torch.cuda.synchronize()
            runs.append([logits.detach()] + [q.grad.clone() for q in
                                             gat.parameters(params)])
        for i, (x, y) in enumerate(zip(*runs)):
            what = "logits" if i == 0 else f"grad param {i - 1}"
            print(f"[repro] {name}: one step twice: {what} "
                  f"{'equal bits' if torch.equal(x, y) else 'DIFFER'} "
                  f"(max abs diff {float((x - y).abs().max()):.3e})")

    def repro_fit(name, epochs, **trainer_kw):
        """(history, final parameters) of a fit of cell `name` from seed
        0, the trainer's fields in trainer_kw replaced."""
        dataset, overrides = CELLS[name][:2]
        _, trainer, train_data, val_data, reshuffle = make_trainer(
            dataset, overrides, epochs)
        trainer = dataclasses.replace(trainer, **trainer_kw)
        with knobs(CELL_ENV.get(name, {})):
            result = trainer.fit_epochs(train_data, val_data,
                                        reshuffle=reshuffle)
        torch.cuda.synchronize()
        return result.history, gat.parameters(result.final_params)

    for name, epochs in REPRO_EPOCHS.items():
        (hist_a, par_a), (hist_b, par_b) = (repro_fit(name, epochs)
                                            for _ in range(2))
        same_hist = hist_a == hist_b
        same_par = all(torch.equal(x, y) for x, y in zip(par_a, par_b))
        print(f"[repro] {name}: two fits of {epochs} epochs from seed 0: "
              f"histories {'equal' if same_hist else 'DIFFER'}, parameters "
              f"{'equal bits' if same_par else 'DIFFER'}; train_loss "
              f"{[r['train_loss'] for r in hist_a]}")
        if not (same_hist and same_par):
            dataset, overrides = CELLS[name][:2]
            with knobs(CELL_ENV.get(name, {})):
                one_step_report(name, dataset, overrides)
            fail(f"{name}: two fits from one seed differ")

    # The prefetch thread builds a reshuffled fit's next epoch on the host
    # and touches no torch generator: the fit gives the same bits without
    # it.
    for name, epochs in PREFETCH_REPRO.items():
        (hist_a, par_a), (hist_b, par_b) = (
            repro_fit(name, epochs, prefetch=on) for on in (True, False))
        same = hist_a == hist_b and all(torch.equal(x, y)
                                        for x, y in zip(par_a, par_b))
        print(f"[repro] {name}: fits of {epochs} epochs from seed 0 with "
              f"and without the prefetch thread: histories and parameters "
              f"{'equal bits' if same else 'DIFFER'}")
        if not same:
            fail(f"{name}: the fit with the prefetch thread differs from "
                 f"the fit without it")
    # the iterator's own copies (put=True: a side stream, an event the
    # consumer's stream waits on, record_stream), which no fit takes
    batches = loader.InductiveBatcher(inductive["PPI"][0], 2,
                                      seed=0).epoch(0)
    fetched = list(PrefetchIterator(batches, depth=2, device=dev))
    same = len(fetched) == len(batches) and all(
        torch.equal(getattr(a, k), getattr(b.to(dev), k))
        for a, b in zip(fetched, batches)
        for k in ("x", "senders", "receivers", "y", "src_ptr", "dst_ptr"))
    print(f"[repro] PrefetchIterator(put=True) over an epoch of PPI batches: "
          f"{len(fetched)} batches on {fetched[0].device}, "
          f"{'equal' if same else 'DIFFERENT'} to copies on this thread")
    if not same or fetched[0].device != dev:
        fail("PrefetchIterator's copies differ from the batches")

    # The CSR offsets carried on the Graph spare launches, not bits: one
    # Cora fit with them and one without (the wrappers derive them per
    # call), and the trained model's logits and gradients both ways.
    runs = []
    bare = cora.replace(src_ptr=None, dst_ptr=None)
    for graph in (cora, bare):
        _, trainer, _, _, _ = make_trainer("Cora", {}, 5)
        result = trainer.fit_epochs([graph], [graph])
        runs.append((result.history, gat.parameters(result.final_params)))
    (hist_a, par_a), (hist_b, par_b) = runs
    grads = [logits_and_grads(trainer, result.final_params, g)
             for g in (cora, bare)]
    identical = (hist_a == hist_b
                 and all(torch.equal(x, y) for x, y in zip(par_a, par_b))
                 and torch.equal(grads[0][0], grads[1][0])
                 and all(torch.equal(x, y)
                         for x, y in zip(grads[0][1], grads[1][1])))
    print(f"[repro] Cora, 5 epochs from seed 0 with and without the "
          f"graph's offsets: histories, parameters, logits and gradients "
          f"{'equal bits' if identical else 'DIFFER'}; train_loss "
          f"{[r['train_loss'] for r in hist_a]}")
    if not identical:
        fail("Cora: the fit with the graph's offsets differs from the fit "
             "without them")

    elapsed("4c")
    # -- 4c. the sharded path: fits, holds, reproducibility, step times -----
    # Trainer.fit_sharded over a (data, edge) mesh of one rank: a one-rank
    # NCCL process group on the card, so that every collective of the
    # cut-neighbourhood layer and of the sharded step is a real NCCL call
    import torch.distributed as dist
    from gat_pytorch_tpu_torch.parallel import (DropoutGenerators,
                                                make_mesh,
                                                make_sharded_train_step,
                                                multihost, shard_batch)
    from gat_pytorch_tpu_torch.ops import collectives as C

    def sharded_logits_and_grads(trainer, params, shard, mesh, backend,
                                 dst_owned=False):
        """The sharded model's logits and gradients of its train loss (the
        sharded step's, the regulariser included, without the update), in
        the cut-neighbourhood or the dst-owned layout."""
        for q in gat.parameters(params):
            q.grad = None
        coef = trainer.task.attention_coef
        out = gat.gat_model_apply(params, trainer.cfg, shard,
                                  device=dev, backend=backend,
                                  edge_axis=mesh.edge, dst_owned=dst_owned,
                                  return_attention=coef != 0.0)
        logits = out[0] if coef != 0.0 else out
        loss = trainer.task.loss(logits, shard, "train")
        if coef != 0.0:
            loss = loss + coef * gat.calc_attention_norm(
                shard, out[1], edge_axis=mesh.edge, dst_owned=dst_owned)
        loss.backward()
        C.psum_grads(gat.parameters(params), mesh.data)
        torch.cuda.synchronize()
        return (logits.detach(),
                [q.grad.clone() for q in gat.parameters(params)])

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    multihost.initialize(f"tcp://127.0.0.1:{port}", 1, 0, device="cuda")
    try:
        mesh = make_mesh()
        print(f"[sharded] one-rank {dist.get_backend()} process group, mesh "
              f"{mesh.shape}")
        sharded = {}
        for name, spec in SHARDED_CELLS.items():
            sharded[name] = train_cell(
                name, spec, lambda tr, td, vd, rs: tr.fit_sharded(
                    mesh, td, vd, reshuffle=rs))

        # the trained sharded model against the single-device kernel path
        # and the sharded segment path, on the same parameters
        for name, (cfg, trainer, params, graph) in sharded.items():
            shard = shard_batch([graph], mesh)[0]
            env = CELL_ENV.get(name, {})
            with knobs(env):
                lk, gk = sharded_logits_and_grads(trainer, params, shard,
                                                  mesh, "kernel")
            if lk.shape != (graph.num_nodes, cfg.num_classes) or \
                    not torch.isfinite(lk).all():
                fail(f"{name}: logits of shape {tuple(lk.shape)} or not "
                     f"finite")
            if "bf16" in name:
                f32 = float32_env(env)
                with knobs(f32):
                    outs = {"float32 single-device kernel": logits_and_grads(
                                trainer, params, graph),
                            "float32 sharded segment":
                                sharded_logits_and_grads(
                                    trainer, params, shard, mesh, "segment"),
                            "float32 sharded kernel":
                                sharded_logits_and_grads(
                                    trainer, params, shard, mesh, "kernel")}
                for label in ("float32 single-device kernel",
                              "float32 sharded segment"):
                    print(f"[model] {name}: bfloat16 sharded kernel path vs "
                          f"{label} path on the card")
                    rel = hold_model(name, label, lk, gk, *outs[label],
                                     BF16_TOL)
                    if label == "float32 single-device kernel":
                        live = rel
                print(f"[model] {name}: float32 sharded kernel path vs "
                      f"float32 single-device kernel path on the card")
                noise = hold_model(name, "float32 single-device kernel",
                                   *outs["float32 sharded kernel"],
                                   *outs["float32 single-device kernel"],
                                   REL_TOL)
                print(f"[model] {name}: the bfloat16 logits differ from the "
                      f"float32 single-device kernel path's by {live:.3e} of "
                      f"their scale, the float32 sharded path's by "
                      f"{noise:.3e}")
                if not live > 10.0 * noise:
                    fail(f"{name}: the bfloat16 mode is not live ({live} <= "
                         f"10 x {noise})")
                continue
            for label, fn in (
                    ("single-device kernel",
                     lambda: logits_and_grads(trainer, params, graph)),
                    ("sharded segment",
                     lambda: sharded_logits_and_grads(trainer, params, shard,
                                                      mesh, "segment"))):
                gat.PATH_TRACE.clear()
                with knobs(env):
                    lo, go = fn()
                print(f"[model] {name}: sharded kernel path vs {label} path "
                      f"{gat.PATH_TRACE} on the card")
                hold_model(name, label, lk, gk, lo, go, REL_TOL)

        # two sharded fits from one seed give the same bits
        name, epochs = SHARDED_REPRO
        dataset, overrides = SHARDED_CELLS[name][:2]
        runs = []
        for _ in range(2):
            _, trainer, train_data, val_data, reshuffle = make_trainer(
                dataset, overrides, epochs)
            with knobs(CELL_ENV.get(name, {})):
                result = trainer.fit_sharded(mesh, train_data, val_data,
                                             reshuffle=reshuffle)
            torch.cuda.synchronize()
            runs.append((result.history,
                         gat.parameters(result.final_params)))
        (hist_a, par_a), (hist_b, par_b) = runs
        same_hist = hist_a == hist_b
        same_par = all(torch.equal(x, y) for x, y in zip(par_a, par_b))
        print(f"[repro] {name}: two fits of {epochs} epochs from seed 0: "
              f"histories {'equal' if same_hist else 'DIFFER'}, parameters "
              f"{'equal bits' if same_par else 'DIFFER'}; train_loss "
              f"{[r['train_loss'] for r in hist_a]}")
        if not (same_hist and same_par):
            fail(f"{name}: two sharded fits from one seed differ")

        # the sharded step beside the single-device step of the same model
        for name, (cfg, trainer, params, graph) in sharded.items():
            shard = shard_batch([graph], mesh)[0]
            env = CELL_ENV.get(name, {})
            opt = torch.optim.Adam(gat.parameters(params), lr=0.0)
            gens = DropoutGenerators.for_rank(trainer.seed + 1, mesh, dev)
            dgen = trainer.dropout_generator()
            routes = [(f"sharded {backend} path",
                       make_sharded_train_step(trainer.cfg, trainer.task,
                                               mesh, backend=backend), ev)
                      for backend, ev in (("kernel", env),
                                          ("segment", float32_env(env)))]
            steps = [(label, under(ev, lambda st=st: st(params, opt, [shard],
                                                         gens)))
                     for label, st, ev in routes]
            steps.insert(1, ("single-device kernel path", under(
                env, lambda: trainer.train_step(params, opt, graph, dgen))))
            times = [step_time_ms(torch, step) for _, step in steps]
            print(f"[time] {name} train step (forward, loss, backward, "
                  f"Adam) on {card}: " + ", ".join(
                      f"{label} {t:.4f} ms"
                      for (label, _), t in zip(steps, times)))
            for i, ((label, step), t) in enumerate(zip(steps, times)):
                profile_steps(torch, step, t, f"{name} {label}",
                              top=12 if i == 0 else 0)

        # -- the dst-owned layout on the same group: fits, holds, a
        # reproducibility pair, and its step beside the cut-neighbourhood
        # step of the same cell with the collectives of each
        def dst_shard_of(graph):
            """This rank's dst shard of `graph` over the edge axis, with
            per-shard block layouts where the graph has one (as
            fit_sharded(dst_owned=True) builds them), on the card."""
            bl = graph.block_layout
            g2, _ = partition_edges_by_dst(
                graph.to("cpu"), mesh.edge.size, src_windows=bl is not None,
                hybrid=bl is not None and bl.rem_send is not None)
            return dst_shard(g2, mesh.edge.index, mesh.edge.size).to(dev)

        owned = {}
        for name, spec in DST_CELLS.items():
            owned[name] = train_cell(
                name, spec, lambda tr, td, vd, rs: tr.fit_sharded(
                    mesh, td, vd, reshuffle=rs, dst_owned=True))
        for name, (cfg, trainer, params, graph) in owned.items():
            shard = dst_shard_of(graph)
            env = CELL_ENV.get(name, {})
            with knobs(env):
                lk, gk = sharded_logits_and_grads(trainer, params, shard,
                                                  mesh, "kernel", True)
            if lk.shape != (graph.num_nodes, cfg.num_classes) or \
                    not torch.isfinite(lk).all():
                fail(f"{name}: logits of shape {tuple(lk.shape)} or not "
                     f"finite")
            for label, fn in (
                    ("single-device kernel",
                     lambda: logits_and_grads(trainer, params, graph)),
                    ("dst-owned segment",
                     lambda: sharded_logits_and_grads(
                         trainer, params, shard, mesh, "segment", True))):
                gat.PATH_TRACE.clear()
                with knobs(env):
                    lo, go = fn()
                print(f"[model] {name}: dst-owned kernel path vs {label} "
                      f"path {gat.PATH_TRACE} on the card")
                hold_model(name, label, lk, gk, lo, go, REL_TOL)

        name, epochs = DST_REPRO
        dataset, overrides = DST_CELLS[name][:2]
        runs = []
        for _ in range(2):
            _, trainer, train_data, val_data, reshuffle = make_trainer(
                dataset, overrides, epochs)
            with knobs(CELL_ENV.get(name, {})):
                result = trainer.fit_sharded(mesh, train_data, val_data,
                                             reshuffle=reshuffle,
                                             dst_owned=True)
            torch.cuda.synchronize()
            runs.append((result.history,
                         gat.parameters(result.final_params)))
        (hist_a, par_a), (hist_b, par_b) = runs
        same_hist = hist_a == hist_b
        same_par = all(torch.equal(x, y) for x, y in zip(par_a, par_b))
        print(f"[repro] {name}: two fits of {epochs} epochs from seed 0: "
              f"histories {'equal' if same_hist else 'DIFFER'}, parameters "
              f"{'equal bits' if same_par else 'DIFFER'}; train_loss "
              f"{[r['train_loss'] for r in hist_a]}")
        if not (same_hist and same_par):
            fail(f"{name}: two dst-owned fits from one seed differ")

        for name, (cfg, trainer, params, graph) in owned.items():
            env = CELL_ENV.get(name, {})
            opt = torch.optim.Adam(gat.parameters(params), lr=0.0)
            gens = DropoutGenerators.for_rank(trainer.seed + 1, mesh, dev)
            steps = []
            for label, batch, dst_owned in (
                    ("dst-owned kernel path", dst_shard_of(graph), True),
                    ("cut-neighbourhood kernel path",
                     shard_batch([graph], mesh)[0], False)):
                st = make_sharded_train_step(trainer.cfg, trainer.task, mesh,
                                             dst_owned=dst_owned)
                steps.append((label, under(
                    env, lambda st=st, b=batch: st(params, opt, [b], gens))))
            for label, step in steps:
                with C.recording() as calls:
                    step()
                kinds = {}
                for kind, shape, dtype in calls:
                    key = f"{kind} {list(shape)} {str(dtype)[6:]}"
                    kinds[key] = kinds.get(key, 0) + 1
                print(f"[collectives] {name} {label}: {len(calls)} a step, "
                      f"{C.collective_bytes(calls)} bytes: {kinds}")
            # in turns (dst-owned, cut, cut, dst-owned): the host-bound
            # step drifts within a call
            runs = ([], [])
            for i in (0, 1, 1, 0):
                runs[i].append(step_time_ms(torch, steps[i][1]))
            times = [sum(r) / len(r) for r in runs]
            print(f"[time] {name} train step (forward, loss, backward, "
                  f"Adam) on {card}, in turns: " + ", ".join(
                      f"{label} {t:.4f} ms ({r[0]:.4f}, {r[1]:.4f})"
                      for (label, _), t, r in zip(steps, times, runs)))
            for (label, step), t in zip(steps, times):
                profile_steps(torch, step, t, f"{name} {label}",
                              top=12 if label.startswith("dst") else 0)
    finally:
        dist.destroy_process_group()

    elapsed("4d")
    # -- 4d. checkpoints, resume, the CLI's load route, metrics logging -----
    # In a temporary directory under build/ (gitignored), removed after.
    class Recorder:
        """A logger that keeps the histogram tags it is given."""
        def __init__(self):
            self.tags = set()

        def log_scalars(self, step, row):
            pass

        def log_histogram(self, step, tag, values):
            self.tags.add(tag)

        def close(self):
            pass

    os.makedirs(ROOT_BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT_BUILD) \
            as tmp:
        # a Cora fit of 10 epochs, snapshots every 5, its rows to JSONL
        ck_dir = os.path.join(tmp, "fit")
        jsonl = os.path.join(tmp, "rows.jsonl")
        _, trainer, _, _, _ = make_trainer("Cora", {}, 10)
        trainer = dataclasses.replace(trainer, checkpoint_dir=ck_dir,
                                      checkpoint_every_n_epochs=5,
                                      metrics_file=jsonl)
        result = trainer.fit_epochs([cora], [cora])
        files = sorted(os.listdir(ck_dir))
        if files != ["best", "epoch-10", "epoch-5"]:
            fail(f"Cora checkpoints: {files}, expected best, epoch-5 and "
                 f"epoch-10")
        rows = [json.loads(line) for line in open(jsonl)]
        if rows != [{"step": r["epoch"], **r} for r in result.history]:
            fail("Cora: the JSONL rows differ from the history")
        # resumed from epoch-5 (the Adam state and the CUDA generator's
        # state restored), 5 more steps give the fit's final parameters
        state = trainer.resume_state(os.path.join(ck_dir, "epoch-5"))
        resumed_at = state.step
        if resumed_at != 5 or state.generator.device != dev:
            fail(f"Cora resume: step {resumed_at} on "
                 f"{state.generator.device}")
        for _ in range(5):
            trainer.train_step(state.params, state.opt, cora, state.generator)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(
            gat.parameters(state.params),
            gat.parameters(result.final_params)))
        print(f"[checkpoint] Cora, 10 epochs with snapshots every 5: {files}; "
              f"the JSONL rows equal the history; resumed from epoch-5 "
              f"(step {resumed_at}) and 5 train steps: parameters "
              f"{'equal bits' if same else 'DIFFER'} to the fit's final ones")
        if not same:
            fail("Cora: the run resumed from epoch-5 differs from the "
                 "uninterrupted fit")
        # cli.train: a run, then --exec_type load on its checkpoint
        outs = []
        for exec_type in ("train", "load"):
            config = get_config("Cora", num_epochs=10, device="cuda",
                                synthetic=True, exec_type=exec_type,
                                checkpoint_dir=os.path.join(tmp, "cli"))
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                metrics = cli_train.run(config)
            line = json.loads(out.getvalue().strip().splitlines()[-1])
            outs.append((metrics, line))
        (trained, _), (loaded, printed) = outs
        tests = {k: v for k, v in trained.items() if k.startswith("test_")}
        print(f"[checkpoint] cli.train Cora, 10 epochs: {tests}; "
              f"--exec_type load printed {printed}")
        if not tests or printed != tests or loaded != tests:
            fail("cli.train --exec_type load did not print the train run's "
                 "test metrics")
        # the gradient and attention histograms (a recording logger; the
        # card's machine has no tensorboard) leave the fit's bits as they
        # were: their dropout masks come from a clone of the generator
        rec = Recorder()
        runs = []
        for track in (True, False):
            _, trainer, _, _, _ = make_trainer("Cora", {}, 5)
            if track:
                trainer = dataclasses.replace(
                    trainer, tensorboard_dir=os.path.join(tmp, "tb"),
                    track_grads=True)
            with mock.patch.object(Trainer, "_logger", lambda self: rec):
                res = trainer.fit_epochs([cora], [cora])
            runs.append((res.history, gat.parameters(res.final_params)))
        (hist_a, par_a), (hist_b, par_b) = runs
        same = hist_a == hist_b and all(torch.equal(x, y)
                                        for x, y in zip(par_a, par_b))
        print(f"[checkpoint] Cora, 5 epochs with and without track_grads "
              f"(histograms {sorted(rec.tags)}): histories and parameters "
              f"{'equal bits' if same else 'DIFFER'}")
        if not same or not {"grad/layers/0/W",
                            "unnormalised_attention_layer_1"} <= rec.tags:
            fail("Cora: the fit with track_grads differs from the fit "
                 "without, or logged no histograms")

        elapsed("4e")
        # -- 4e. the native graphcore library, attention visualisation
        # (cli/vis.py's loading and extraction; the figures need
        # matplotlib, which the CPU tests hold) and the profiling utilities
        check_graphcore(np, core, datasets, sampling, cli_train, get_config,
                        inductive["PPI"][0], cora_raw, card)
        vis = {}
        for vis_name, (vis_set, vis_over, vis_path) in VIS_GRAPHS.items():
            run_cfg = get_config(vis_set, **vis_over)
            vis_cfg = run_cfg.gat_config()
            snapshot = (os.path.join(ck_dir, "epoch-5")
                        if vis_name == "Cora" else None)
            vis_params = cli_vis._load_params(snapshot, vis_cfg, run_cfg,
                                              "cuda")
            vis_graph = cli_vis.get_test_graph(vis_set, True, "cuda")
            vis[vis_name] = (vis_cfg, vis_params, vis_graph)
            weights = "epoch-5 snapshot" if snapshot else "seed 0"
            hold_vis(torch, np, vis_attention, gat, build,
                     f"{vis_name} ({weights})", vis_params, vis_cfg,
                     vis_graph, vis_path, launches)
        vis_cfg, vis_params, vis_graph = vis["Cora"]
        _, vis_trainer, _, _, _ = make_trainer("Cora", {}, 3)
        check_profiling(torch, prof_utils, vis_attention, gat, O, vis_trainer,
                        vis_params, vis_cfg, vis_graph,
                        os.path.join(tmp, "trace"), card)

    elapsed("5")
    # -- 5. timings ---------------------------------------------------------
    timing = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
                      bytes=0, ops=0) for k in REPLACES}
    # the GATv2 entries: check_gatv2's times at the benchmark cell's graph;
    # the paper form's logits: check_paper_logits's
    for k, t in {**gatv2_times, **paper_times}.items():
        timing[k].update(t)

    def time_rows(label, rows, into_json):
        """Time each row's kernel, plain version and library call;
        into_json: True, False, or the names whose times the result line
        reports from this call."""
        for k, (kern, plain, lib, nbytes, ops, *whole) in rows.items():
            km, pm = time_ms(torch, kern), time_ms(torch, plain)
            lm = time_ms(torch, lib) if lib is not None else None
            bm, by = bound_ms(nbytes, ops)
            # a backward entry is timed given its op's table; beside it,
            # the same call computing the table first
            with_pass = ("" if not whole else f" (with its score pass "
                         f"{time_ms(torch, whole[0]):.4f})")
            print(f"[time] {k} {label}: kernel_ms {km:.4f}{with_pass} "
                  f"plain_ms {pm:.4f} library_ms "
                  f"{'null' if lm is None else f'{lm:.4f}'} bound_us "
                  f"{bm * 1e3:.3f} ({by})")
            if into_json is not True and (not into_json
                                          or k not in into_json):
                continue
            t = timing[k]
            t["ms"] += km
            t["plain_ms"] += pm
            t["bound_ms"] += bm
            t["bytes"] += nbytes
            t["ops"] += ops
            if lm is not None:
                t["library_ms"] = (t["library_ms"] or 0.0) + lm

    def given(args):
        """A backward's keywords as the op calls it on the main path: the
        source-score table its forward computed (the timed call of a
        backward entry includes no score pass; a forward's does)."""
        return dict(s_src=v5.source_scores(args[0], args[1]))

    # bytes: every input read once, every output written once (float32 and
    # int32 = 4 bytes); ops: this run's real edges, and the products that
    # depend on the sender alone once a sender
    def attention_ops(n_src, e_edges, d, nh, sums=False):
        """(forward, backward) operations of an op over e_edges real edges
        and n_src senders. Forward, timed with its score pass: the sender's
        dot h @ a_src once a sender (2 d nh), per edge the weighted row
        (2 d) and the per-head terms. Backward, given the table: per edge
        its d(h) row's d(raw) @ a_src^T (2 d nh, the row is per edge), q
        and the coefficient's row (4 d) and the per-head terms, and where
        it sums d(h) by sender itself (sums) the row's add (d); d(a_src)
        = h^T S once a sender (2 d nh; S the per-sender sums of d(raw))."""
        dots = 2 * n_src * d * nh
        return (dots + e_edges * (2 * d + 4 * nh),
                dots + e_edges * (2 * d * nh + (5 if sums else 4) * d
                                  + 10 * nh))

    def v5_time_rows(graph, c):
        """The v5 kernels and the d(h) reduce at one case of check_v5, as
        the main path calls them (the Graph's offsets and sender runs
        where it carries them; a backward given its op's table). The
        backward, the whole call with d(h) per node: reads h, a_src, the
        score tables, the mask and, over the real edges, the receivers,
        the sender order, the sender and receiver offsets, g, out, den
        and eps'; writes d(h) per node, d(mask) over all E edges (zeros
        past E_real), d(s_dst) and d(a_src)."""
        n_, e_ = graph.num_nodes, graph.num_edges
        snd_, order_ = graph.senders, graph.src_order
        nh, d = c["nh"], c["nh"] * c["f"]
        fa, ba, rows = c["fwd_args"], c["bwd_args"], c["rows"]
        dm = e_ * nh if c["drop"] else 0      # the mask in, d(mask) out
        b_fwd = 4 * (n_ * d + d * nh + n_ * nh + dm + 2 * e_
                     + n_ * d + n_ * nh + 2)
        er = graph.num_real_edges
        dm_r = er * nh if c["drop"] else 0
        b_bwd = 4 * (n_ * d + d * nh + 2 * n_ * nh + dm_r + 2 * er
                     + 2 * (n_ + 1) + 2 * n_ * d + n_ * nh + 1 + n_ * d + dm
                     + n_ * nh + d * nh)
        # the parts mode reads d(num) and d(den) in place of g, out, den, eps'
        b_parts = b_bwd - 4 * (n_ * d + 1)
        pa = c["parts_args"]
        dst_ptr = getattr(graph, "dst_ptr", None)
        kw = given(ba) | c["runs"] | ({} if dst_ptr is None
                                      else {"dst_ptr": dst_ptr})
        o_fwd, o_bwd = attention_ops(n_, er, d, nh, sums=True)
        ids_sorted = snd_.index_select(0, order_.long())
        snd_l = snd_.long()
        # the d(h) reduce as the main path calls it: by the graph's
        # offsets where it carries them, over its real rows
        src_ptr = getattr(graph, "src_ptr", None)
        return {
            "v5_forward": (lambda: v5.v5_forward(*fa),
                           lambda: v5.v5_forward_plain(*fa), None,
                           b_fwd, o_fwd),
            "v5_backward": (lambda: v5.v5_backward(*ba, **kw),
                            lambda: v5.v5_backward_by_sender_plain(*ba),
                            None, b_bwd, o_bwd,
                            lambda: v5.v5_backward(*ba)),
            "v5_backward_parts": (
                lambda: v5.v5_backward(*pa, normalize=False, **kw),
                lambda: v5.v5_backward_by_sender_plain(*pa,
                                                       normalize=False),
                None, b_parts, o_bwd,
                lambda: v5.v5_backward(*pa, normalize=False)),
            "segment_sum_rows": (
                lambda: ss.dh_reduce(rows, order_, snd_, n_, er,
                                     src_ptr=src_ptr),
                lambda: ss.segment_rows_plain(rows, order_, ids_sorted, n_),
                lambda: torch.zeros((n_, d), device=dev).index_add_(
                    0, snd_l[:er], rows[:er]),
                4 * (er * d + er + n_ + 1 + n_ * d), er * d),
        }

    def table_time_rows(graph, c):
        """The table kernels at one case of check_table, as the main path
        calls them (the Graph's offsets). The kernels read nothing of an
        edge e >= E_real, so the edge inputs are counted over the real
        edges. Forward: reads the logits, h, the mask, the senders and
        the receiver offsets, writes out and den; per real edge nh exp and
        a d-wide multiply-add. table_dden: reads g, out and den, writes
        dden; a multiply-add per element. The backward (the whole call:
        table_dden and the pass by sender) reads h, g, out, den, the
        logits, the mask, the receivers, the sender order and offsets and
        writes d(h) and, over all E edges (zeros past E_real), d(logits)
        and d(mask); per real edge a d-wide dot, a d-wide product and add,
        and the per-head terms. The rows it gathers (g per real edge, as
        the forward gathers h) come from L2 and are not in the bound."""
        n_, e_, er = graph.num_nodes, graph.num_edges, graph.num_real_edges
        nh, d = c["nh"], c["nh"] * c["f"]
        fa, fk, ba, runs, da = (c["fwd_args"], c["fwd_kw"], c["bwd_args"],
                                c["runs"], c["dden_args"])
        masks = 1 + (1 if c["drop"] else 0)
        b_fwd = 4 * (masks * er * nh + n_ * d + er + n_ + 1 + n_ * d
                     + n_ * nh)
        b_dden = 4 * (2 * n_ * d + 2 * n_ * nh)
        b_bwd = 4 * (4 * n_ * d + n_ * nh + masks * er * nh + 2 * er + n_
                     + 1 + masks * e_ * nh)
        return {
            "table_forward": (lambda: ta.table_forward(*fa, **fk),
                              lambda: ta.table_forward_plain(*fa), None,
                              b_fwd, er * (2 * d + 3 * nh) + n_ * d),
            "table_dden": (lambda: ta.table_dden(*da),
                           lambda: ta.table_dden_plain(*da), None, b_dden,
                           2 * n_ * d),
            "table_backward": (
                lambda: ta.table_backward(*ba, **runs),
                lambda: ta.table_backward_by_sender_plain(*ba, **runs), None,
                b_bwd, er * (4 * d + 8 * nh) + 2 * n_ * d),
        }

    # row 3 runs on no Cora layer since the backward sums d(h) by sender:
    # its result-line time is PPI's (below), timed on its own
    V5_JSON = ("v5_forward", "v5_backward")
    for c in cora_cases:
        time_rows(f"Cora {c['nh']}x{c['f']}", v5_time_rows(cora, c),
                  into_json=V5_JSON)

    def score_time_rows(h, a):
        """The source-score pass on one table: h read once, a_src read,
        the table written; a multiply-add per (row, element, head). The
        library call is torch.mm of a float32 table (none takes a bfloat16
        table with float32 a_src)."""
        n_, d = h.shape
        nh = a.shape[1]
        bf16 = h.dtype == torch.bfloat16
        return {("source_scores_bf16" if bf16 else "source_scores"): (
            lambda: v5.source_scores(h, a),
            lambda: v5.source_scores_plain(h, a),
            None if bf16 else (lambda: torch.mm(h, a)),
            n_ * d * h.element_size() + 4 * (d * nh + n_ * nh),
            2 * n_ * d * nh)}

    # the result line: the Cora fit's tables (both element types); the
    # Pubmed and PPI fits' beside them
    for c in cora_cases:
        h, a = c["fwd_args"][:2]
        for table in (h, h.to(torch.bfloat16)):
            time_rows(f"Cora {c['nh']}x{c['f']}", score_time_rows(table, a),
                      into_json=True)
    for label, cases in (("Pubmed", pubmed_cases), ("PPI", ppi_v5_cases)):
        for c in cases:
            h, a = c["fwd_args"][:2]
            time_rows(f"{label} {c['nh']}x{c['f']}", score_time_rows(h, a),
                      into_json=False)
    # rows 3 and 4 at the Cora and PPI layer shapes (the Pubmed layout's
    # below), each four ways: as the main path calls them, the kernel
    # alone, without the graph's offsets, and index_add_ over the real rows
    for graph, cases, label in ((cora, cora_cases, "Cora"),
                                (ppi, ppi_v5_cases, "PPI")):
        er = graph.num_real_edges
        snd_real = graph.senders[:er].long()
        for c in cases:
            rows = c["rows"]
            time_dh_rows(torch, ss, f"{label} {c['nh']}x{c['f']}", rows,
                         graph.src_order, graph.src_ptr, graph.num_nodes,
                         senders=graph.senders, e_real=er,
                         lib=lambda g=graph, r=rows, s=snd_real, e=er:
                         torch.zeros((g.num_nodes, r.shape[1]),
                                     device=dev).index_add_(0, s, r[:e]))

    def two_phase_time_rows(c, entries, keys, n_, slots, idx, real_edges,
                            rows_out, idx_bwd=None):
        """The three 2-phase entries at one case of check_two_phase. idx:
        the index words the op reads (v5: senders and receivers, window:
        send, dst_perm and dst_ptr); rows_out: the d(h) rows written;
        idx_bwd: the backward's index words where they differ (the
        backwards by sender, which write d(h) per node and sum it
        themselves: the window's recv, src_perm, src_ptr, dst_perm,
        dst_ptr; the v5 op's v5_bwd_idx). The cap pass reads the
        tables and the index, the forward also the mask and the cap and
        writes out and den, the backward reads g, out, den besides and
        writes d(h), d(mask), d(s_dst), d(a_src) and d(cap)."""
        nh, d = c["nh"], c["nh"] * c["f"]
        dm = slots * nh
        base = n_ * d + d * nh + n_ * nh + idx
        base_bwd = base if idx_bwd is None else base - idx + idx_bwd
        o_fwd, o_bwd = attention_ops(n_, real_edges, d, nh,
                                     sums=idx_bwd is not None)
        ca, fa, ba = c["cap_args"], c["fwd_args"], c["bwd_args"]
        cap_k, cap_p, fwd_k, fwd_p, bwd_k, bwd_p = entries
        kw = given(ba)
        return {
            keys[0]: (lambda: cap_k(*ca), lambda: cap_p(*ca), None,
                      4 * (base + 2),
                      2 * n_ * d * nh + real_edges * 2 * nh),
            keys[1]: (lambda: fwd_k(*fa), lambda: fwd_p(*fa), None,
                      4 * (base + dm + 1 + n_ * d + n_ * nh), o_fwd),
            keys[2]: (lambda: bwd_k(*ba, **kw), lambda: bwd_p(*ba), None,
                      4 * (base_bwd + n_ * nh + dm + 1 + 2 * n_ * d
                           + n_ * nh + rows_out * d + dm + n_ * nh + d * nh
                           + 1),
                      o_bwd, lambda: bwd_k(*ba)),
        }

    def v5_bwd_idx(graph):
        """The v5 backward's index words: the receivers and the sender
        order over the real edges, the sender and receiver offsets."""
        return 2 * graph.num_real_edges + 2 * (graph.num_nodes + 1)

    # the v5 backward writes d(h) per node (rows_out = n)
    for c in cora_two:
        time_rows(f"Cora {c['nh']}x{c['f']} 2-phase", two_phase_time_rows(
            c, v5_two_phase_entries(cora), V5_TWO, cora.num_nodes,
            cora.num_edges, 2 * cora.num_edges, cora.num_real_edges,
            cora.num_nodes, v5_bwd_idx(cora)), into_json=True)
    for c in pubmed_two:
        time_rows(f"Pubmed {c['nh']}x{c['f']} 2-phase", two_phase_time_rows(
            c, window_two_phase_entries(bl), W_TWO, np_, e7,
            2 * e7 + np_ + 1, e7_real, np_, W_BWD_IDX), into_json=True)
    for c in hybrid_two:
        he = hybrid.num_edges
        time_rows(f"Pubmed cluster {c['nh']}x{c['f']} 2-phase (the v6 form)",
                  two_phase_time_rows(
                      c, v5_two_phase_entries(hybrid), V5_TWO,
                      hybrid.num_nodes, he, 2 * he, hybrid.num_real_edges,
                      hybrid.num_nodes, v5_bwd_idx(hybrid)), into_json=False)

    def window_time_rows(layout, n_, c):
        """The window kernels at one case of check_window. Inputs h,
        a_src, s_dst, drop, send, dst_perm, dst_ptr; the backward (by
        sender) also the source-score table, g, out, den, eps' (parts
        mode: d(num), d(den)) and the index words recv, src_perm, src_ptr,
        dst_perm, dst_ptr, and writes d(h) per node, d(mask), d(s_dst) and
        d(a_src)."""
        nh, d = c["nh"], c["nh"] * c["f"]
        fa, ba, pa = c["fwd_args"], c["bwd_args"], c["parts_args"]
        slots, slots_real = layout.num_slots, layout.num_real
        b_in = n_ * d + d * nh + n_ * nh + slots * nh
        b_fwd = 4 * (b_in + 2 * slots + n_ + 1 + n_ * d + n_ * nh + 2)
        idx_bwd = 2 * slots + slots_real + 2 * (n_ + 1)
        b_bwd = 4 * (b_in + idx_bwd + n_ * nh + 2 * n_ * d + n_ * nh + 1
                     + n_ * d + slots * nh + n_ * nh + d * nh)
        o_fwd = attention_ops(n_, slots_real, d, nh)[0]
        o_bwd = attention_ops(n_, slots_real, d, nh, sums=True)[1]
        kw = given(ba)
        return {
            "window_forward": (lambda: wa.window_forward(*fa),
                               lambda: wa.window_forward_plain(*fa), None,
                               b_fwd, o_fwd),
            "window_backward": (lambda: wa.window_backward(*ba, **kw),
                                lambda: wa.window_backward_plain(*ba), None,
                                b_bwd, o_bwd,
                                lambda: wa.window_backward(*ba)),
            "window_backward_parts": (
                lambda: wa.window_backward(*pa, normalize=False, **kw),
                lambda: wa.window_backward_plain(*pa, normalize=False), None,
                b_bwd - 4 * (n_ * d + 1), o_bwd,
                lambda: wa.window_backward(*pa, normalize=False)),
        }

    send_real = bl.send[real].long()
    plain = loader.transductive_graph(raw).to(dev)   # Pubmed, not reordered
    drop5 = ((torch.rand((plain.num_edges, 8), generator=gen, device=dev)
              >= DROPOUT).float() / (1.0 - DROPOUT))
    for c in pubmed_cases:
        nh, f, d = c["nh"], c["f"], c["nh"] * c["f"]
        fa, ba, rows = c["fwd_args"], c["bwd_args"], c["rows"]
        rows_real = rows[real]
        time_rows(f"Pubmed {nh}x{f}", window_time_rows(bl, np_, c),
                  into_json=("window_forward", "window_backward"))
        # the v5 kernels on the same inputs, for the question whether the
        # layout buys anything on this card: on the reordered graph's
        # dst-sorted edge list, and on the graph as it comes
        for tag, gph in (("RCM order", pubmed), ("input order", plain)):
            fa5 = (fa[0], fa[1], fa[2], drop5[:, :nh].contiguous(),
                   gph.senders, gph.receivers, gph.num_real_edges, SLOPE)
            num, den, cap, _ = v5.v5_forward(*fa5)
            ba5 = fa5 + (ba[6],) + epilogue(torch, num, den, cap, f, 1e-8)[:1]
            ba5 += (den, ba[9], True)
            print(f"[time] v5 kernels at Pubmed {nh}x{f}, {tag}: forward "
                  f"{time_ms(torch, lambda: v5.v5_forward(*fa5)):.4f} ms, "
                  f"backward "
                  f"{time_ms(torch, lambda: v5.v5_backward(*ba5)):.4f} ms")
        # rows 3 and 4 at this path's shapes, by the layout's offsets
        time_dh_rows(torch, ss, f"Pubmed {nh}x{f}", rows, bl.src_perm,
                     bl.src_ptr, np_,
                     lib=lambda rr=rows_real, d=d: torch.zeros(
                         (np_, d), device=dev).index_add_(0, send_real, rr))
    # the hybrid cell: the window kernels over the in-window slots and the
    # v5 kernels over the remainder; the result line takes the two parts
    # backward modes from here, where the main path launches them
    for cw, c5 in zip(hybrid_cases, rem_cases):
        label = f"Pubmed hybrid {cw['nh']}x{cw['f']}"
        time_rows(f"{label}, {hb.num_real} in-window edges",
                  window_time_rows(hb, hybrid.num_nodes, cw),
                  into_json=("window_backward_parts",))
        time_rows(f"{label}, {hb.rem_e} remainder edges",
                  v5_time_rows(remainder, c5),
                  into_json=("v5_backward_parts",))

    def sorted_time_rows(vals, ids, n_):
        """The sorted segment sum on one case of check_sorted_sum: values
        and ids read once, the table written once; one add per value."""
        e_, d = vals.shape
        ids_l = ids.long()
        return {"segment_sum_sorted": (
            lambda: ss.segment_sum_sorted(vals, ids, n_),
            lambda: ss.segment_sum_sorted_plain(vals, ids, n_),
            lambda: torch.zeros((n_, d), device=dev).index_add_(
                0, ids_l, vals),
            4 * (e_ * d + e_ + n_ * d), e_ * d)}

    # by ids, every row read (PPI's receivers with the sink's padding
    # rows, and the Pubmed widths)
    for label, cases in sorted_cases.items():
        n_ = ppi.num_nodes if label.startswith("PPI") else hybrid.num_nodes
        for d, (vals, ids) in cases.items():
            time_rows(f"{label} D={d} ({ids.shape[0]} rows, {n_} segments, "
                      f"by ids)", sorted_time_rows(vals, ids, n_),
                      into_json=False)

    def main_path_sorted_rows(vals, row_ids, n_, **kw):
        """The sorted sum as a score gather's backward calls it on the
        main path: the Graph's offsets, the real rows alone (kw: order and
        ptr, or ptr and row_limit); row_ids: each row's segment, for
        index_add_ over the real rows. Bytes: the real rows, the order
        where there is one, the offsets, the table written."""
        er_, d = ppi.num_real_edges, vals.shape[1]
        ids_l = row_ids[:er_].long()
        order_words = er_ if "order" in kw else 0
        return {"segment_sum_sorted": (
            lambda: ss.segment_sum_sorted(vals, None, n_, **kw),
            lambda: ss.segment_sum_sorted_plain(vals, None, n_, **kw),
            lambda: torch.zeros((n_, d), device=dev).index_add_(
                0, ids_l, vals[:er_]),
            4 * (er_ * d + order_words + n_ + 1 + n_ * d), er_ * d)}

    # the result line: the score widths of the PPI paper_faithful fit, by
    # receiver as the main path calls it; by sender beside it
    for d in ppi_heads:
        vals = torch.randn((ppi.num_edges, d), generator=gen, device=dev)
        label = (f"PPI by receiver D={d} ({ppi.num_real_edges} real rows, "
                 f"{ppi.num_nodes} segments, the Graph's offsets)")
        time_rows(label, main_path_sorted_rows(
            vals, ppi.receivers, ppi.num_nodes, ptr=ppi.dst_ptr,
            row_limit=ppi.num_real_edges), into_json=True)
        label = (f"PPI by sender D={d} ({ppi.num_real_edges} real rows, "
                 f"{ppi.num_nodes} segments, the Graph's offsets)")
        time_rows(label, main_path_sorted_rows(
            vals, ppi.senders, ppi.num_nodes, order=ppi.src_order,
            ptr=ppi.src_ptr), into_json=False)
    # the table kernels at the PPI widths (the JSON line's times), and
    # beside them the v5 kernels and the reduce on the same batch
    for ct, c5 in zip(ppi_table_cases, ppi_v5_cases):
        label = f"PPI {ct['nh']}x{ct['f']}"
        time_rows(label, table_time_rows(ppi, ct), into_json=True)
        # row 2 at the widths the PPI fit launches it (by sender); row 3's
        # result-line time from here, timed on its own
        time_rows(label, v5_time_rows(ppi, c5),
                  into_json=("segment_sum_rows",))
    for c in ppi_two:
        pe, per_ = ppi.num_edges, ppi.num_real_edges
        time_rows(f"PPI {c['nh']}x{c['f']} 2-phase", two_phase_time_rows(
            c, v5_two_phase_entries(ppi), V5_TWO, ppi.num_nodes, pe, 2 * pe,
            per_, ppi.num_nodes, v5_bwd_idx(ppi)), into_json=False)
    time_rows("Cora 8x8 with dropout", table_time_rows(cora, cora_table_case),
              into_json=False)
    # both ops on one small batch: the JAX package takes the table op
    # under 4096 edges and v5 above, for the TPU's launch cost; these
    # times are what a gate for this card would be decided on
    for ct, c5 in zip(pattern_table_cases, pattern_v5_cases):
        label = (f"PATTERN {ct['nh']}x{ct['f']} "
                 f"({pattern.num_real_edges} real edges)")
        time_rows(label, table_time_rows(pattern, ct), into_json=False)
        time_rows(label, v5_time_rows(pattern, c5), into_json=False)

    # the bfloat16 modes, at the cases of phase 2d: the work of the float32
    # row of the same entry and shape (its bytes and operations), less the
    # h table's two bytes an element where the kernel reads a bfloat16
    # table; the feature-major d(h) reduce beside row 3's
    def mode_rows(f32_rows, specs):
        """{key: (kernel, plain, library, bytes, ops[, with its score
        pass])} from specs {key: (the float32 row's key, kernel, plain,
        rounding, table rows x width[, the call with its score pass])}."""
        rows = {}
        for key, (f32_key, kern, plain, rnd, table_elems,
                  *whole) in specs.items():
            _, _, lib, nbytes, ops, *_ = f32_rows[f32_key]
            rows[key] = (kern, plain, lib,
                         nbytes - (2 * table_elems if rnd.table else 0), ops,
                         *whole)
        return rows

    for c, c32 in zip(cora_modes, cora_cases):
        nh, f, d = c["nh"], c["f"], c["nh"] * c["f"]
        fa, ba = c["fwd_args"], c["bwd_args"]
        rf, rb = c["rounding"], c["bwd_rounding"]
        rows, snd_, order_ = c32["rows"], cora.senders, cora.src_order
        ids_sorted = snd_.index_select(0, order_.long())
        time_rows(f"Cora {nh}x{f} [{mode_tag(rf)}]", mode_rows(
            v5_time_rows(cora, c32), {
                "v5_forward_bf16": (
                    "v5_forward", lambda: v5.v5_forward(*fa, rounding=rf),
                    lambda: v5.v5_forward_plain(*fa, rounding=rf), rf,
                    cora.num_nodes * d),
                "v5_backward_bf16": (
                    "v5_backward",
                    lambda kw=given(ba) | c32["runs"] | {
                        "dst_ptr": cora.dst_ptr}: v5.v5_backward(
                            *ba, rounding=rb, **kw),
                    lambda: v5.v5_backward_by_sender_plain(*ba, rounding=rb),
                    rb, cora.num_nodes * d,
                    lambda: v5.v5_backward(*ba, rounding=rb)),
                "segment_sum_rows_t": (
                    "segment_sum_rows",
                    lambda: ss.dh_reduce(rows, order_, snd_, cora.num_nodes,
                                         cora.num_real_edges, True,
                                         src_ptr=cora.src_ptr),
                    lambda: ss.segment_rows_t_plain(rows, order_, ids_sorted,
                                                    cora.num_nodes),
                    FLOAT32, 0)}), into_json=True)
        # each rounding point of the forward alone (printed only)
        fp = c["f32_args"]
        for rnd in V5_MODES[:2]:
            fr = (rnd.table_of(fp[0]),) + fp[1:]
            time_rows(f"Cora {nh}x{f} [{mode_tag(rnd)}]", mode_rows(
                v5_time_rows(cora, c32), {"v5_forward_bf16": (
                    "v5_forward", lambda: v5.v5_forward(*fr, rounding=rnd),
                    lambda: v5.v5_forward_plain(*fr, rounding=rnd), rnd,
                    cora.num_nodes * d)}), into_json=False)
    # row 2 at PATTERN's widths in the table mode (printed only)
    for c, c32 in zip(pattern_v5_modes, pattern_v5_cases):
        ba, rb = c["bwd_args"], c["bwd_rounding"]
        time_rows(f"PATTERN {c['nh']}x{c['f']} [{mode_tag(rb)}]", mode_rows(
            v5_time_rows(pattern, c32), {"v5_backward_bf16": (
                "v5_backward",
                lambda kw=given(ba) | c32["runs"] | {
                    "dst_ptr": pattern.dst_ptr}: v5.v5_backward(
                        *ba, rounding=rb, **kw),
                lambda: v5.v5_backward_by_sender_plain(*ba, rounding=rb), rb,
                pattern.num_nodes * c["nh"] * c["f"],
                lambda: v5.v5_backward(*ba, rounding=rb))}),
                  into_json=False)
    for c, c32 in zip(cora_two_modes, cora_two):
        ca, fa, ba, rnd = (c["cap_args"], c["fwd_args"], c["bwd_args"],
                           c["rounding"])
        cap_k, cap_p, fwd_k, fwd_p, bwd_k, bwd_p = v5_two_phase_entries(cora)
        elems = cora.num_nodes * c["nh"] * c["f"]
        label = f"Cora {c['nh']}x{c['f']} 2-phase [{mode_tag(rnd)}]"
        time_rows(label, mode_rows(
            two_phase_time_rows(c32, v5_two_phase_entries(cora), V5_TWO,
                                cora.num_nodes, cora.num_edges,
                                2 * cora.num_edges, cora.num_real_edges,
                                cora.num_nodes, v5_bwd_idx(cora)), {
                "v5_cap_bf16": ("v5_cap", lambda: cap_k(*ca, rounding=rnd),
                                lambda: cap_p(*ca), rnd, elems),
                "v5_forward_two_phase_bf16": (
                    "v5_forward_two_phase", lambda: fwd_k(*fa, rnd),
                    lambda: fwd_p(*fa, rnd), rnd, elems),
                "v5_backward_two_phase_bf16": (
                    "v5_backward_two_phase",
                    lambda kw=given(ba): bwd_k(*ba, rnd, **kw),
                    lambda: bwd_p(*ba, rnd), rnd, elems,
                    lambda: bwd_k(*ba, rnd))}), into_json=True)
    for c, cr, c32, c2, c232, cw, cw32, c5, c532, c6, c632 in zip(
            pubmed_modes, pubmed_rows_modes, pubmed_cases, pubmed_two_modes,
            pubmed_two, hybrid_modes, hybrid_cases, rem_modes, rem_cases,
            v6_modes, hybrid_two):
        nh, f, d = c["nh"], c["f"], c["nh"] * c["f"]
        # the packed window (the result line's), and GAT_TPU_V12=0's rows
        # mode (printed only: no fit runs it)
        for cm, into in ((c, True), (cr, False)):
            fa, ba, rnd = cm["fwd_args"], cm["bwd_args"], cm["rounding"]
            time_rows(f"Pubmed {nh}x{f} [{mode_tag(rnd)}]", mode_rows(
                window_time_rows(bl, np_, c32), {
                    "window_forward_bf16": (
                        "window_forward",
                        lambda: wa.window_forward(*fa, rounding=rnd),
                        lambda: wa.window_forward_plain(*fa, rounding=rnd),
                        rnd, np_ * d),
                    "window_backward_bf16": (
                        "window_backward",
                        lambda kw=given(ba): wa.window_backward(
                            *ba, rounding=rnd, **kw),
                        lambda: wa.window_backward_plain(*ba, rounding=rnd),
                        rnd, np_ * d,
                        lambda: wa.window_backward(*ba, rounding=rnd))}),
                into_json=into)
        fa2, ba2, r2 = c2["fwd_args"], c2["bwd_args"], c2["rounding"]
        _, _, fwd_k, fwd_p, bwd_k, bwd_p = window_two_phase_entries(bl)
        time_rows(f"Pubmed {nh}x{f} 2-phase [{mode_tag(r2)}]", mode_rows(
            two_phase_time_rows(c232, window_two_phase_entries(bl), W_TWO,
                                np_, e7, 2 * e7 + np_ + 1, e7_real, np_,
                                W_BWD_IDX), {
                "window_forward_two_phase_bf16": (
                    "window_forward_two_phase", lambda: fwd_k(*fa2, r2),
                    lambda: fwd_p(*fa2, r2), r2, np_ * d),
                "window_backward_two_phase_bf16": (
                    "window_backward_two_phase",
                    lambda kw=given(ba2): bwd_k(*ba2, r2, **kw),
                    lambda: bwd_p(*ba2, r2), r2, np_ * d,
                    lambda: bwd_k(*ba2, r2))}), into_json=True)
        # the hybrid cell's two parts modes, where the main path runs them
        nhy = hybrid.num_nodes
        pa, rw = cw["parts_args"], cw["rounding"]
        time_rows(f"Pubmed hybrid {nh}x{f}, {hb.num_real} in-window edges "
                  f"[{mode_tag(rw)}]", mode_rows(
                      window_time_rows(hb, nhy, cw32), {
                          "window_backward_parts_bf16": (
                              "window_backward_parts",
                              lambda kw=given(pa): wa.window_backward(
                                  *pa, normalize=False, rounding=rw, **kw),
                              lambda: wa.window_backward_plain(
                                  *pa, normalize=False, rounding=rw), rw,
                              nhy * d, lambda: wa.window_backward(
                                  *pa, normalize=False, rounding=rw))}),
                  into_json=True)
        p5, r5 = c5["bwd_args"], c5["bwd_rounding"]
        time_rows(f"Pubmed hybrid {nh}x{f}, {hb.rem_e} remainder edges "
                  f"[{mode_tag(r5)}]", mode_rows(
                      v5_time_rows(remainder, c532), {
                          "v5_backward_parts_bf16": (
                              "v5_backward_parts",
                              lambda kw=given(p5) | c532["runs"] | {
                                  "dst_ptr": hb.rem_dst_ptr}: v5.v5_backward(
                                  *p5, normalize=False, rounding=r5, **kw),
                              lambda: v5.v5_backward_by_sender_plain(
                                  *p5, normalize=False, rounding=r5), r5,
                              nhy * d, lambda: v5.v5_backward(
                                  *p5, normalize=False, rounding=r5))}),
                  into_json=True)
        # the v6 form's mode on the v5 2-phase kernels (the result line
        # takes those entries' times from Cora, as for float32)
        fa6, ba6, r6 = c6["fwd_args"], c6["bwd_args"], c6["rounding"]
        _, _, fwd_k, fwd_p, bwd_k, bwd_p = v5_two_phase_entries(hybrid)
        he = hybrid.num_edges
        time_rows(f"Pubmed cluster {nh}x{f} 2-phase (the v6 form) "
                  f"[{mode_tag(r6)}]", mode_rows(
                      two_phase_time_rows(c632, v5_two_phase_entries(hybrid),
                                          V5_TWO, nhy, he, 2 * he,
                                          hybrid.num_real_edges, nhy,
                                          v5_bwd_idx(hybrid)), {
                          "v5_forward_two_phase_bf16": (
                              "v5_forward_two_phase",
                              lambda: fwd_k(*fa6, r6),
                              lambda: fwd_p(*fa6, r6), r6, nhy * d),
                          "v5_backward_two_phase_bf16": (
                              "v5_backward_two_phase",
                              lambda kw=given(ba6): bwd_k(*ba6, r6, **kw),
                              lambda: bwd_p(*ba6, r6), r6, nhy * d,
                              lambda: bwd_k(*ba6, r6))}),
                  into_json=False)
    for ct, ct32 in zip(ppi_table_modes, ppi_table_cases):
        nh, f, d = ct["nh"], ct["f"], ct["nh"] * ct["f"]
        fa, ba, rf, rb = (ct["fwd_args"], ct["bwd_args"], ct["rounding"],
                          ct["bwd_rounding"])
        time_rows(f"PPI {nh}x{f} [{mode_tag(rf)}]", mode_rows(
            table_time_rows(ppi, ct32), {
                "table_forward_bf16": (
                    "table_forward",
                    lambda: ta.table_forward(*fa, rounding=rf,
                                             **ct["fwd_kw"]),
                    lambda: ta.table_forward_plain(*fa, rounding=rf), rf,
                    ppi.num_nodes * d),
                "table_backward_bf16": (
                    "table_backward",
                    lambda: ta.table_backward(*ba, rb, **ct["runs"]),
                    lambda: ta.table_backward_by_sender_plain(
                        *ba, **ct["runs"]), rb,
                    ppi.num_nodes * d)}), into_json=True)
        fp = ct["f32_args"]
        for rnd in V5_MODES[:2]:
            fr = (fp[0], rnd.table_of(fp[1])) + fp[2:]
            time_rows(f"PPI {nh}x{f} [{mode_tag(rnd)}]", mode_rows(
                table_time_rows(ppi, ct32), {"table_forward_bf16": (
                    "table_forward",
                    lambda: ta.table_forward(*fr, rounding=rnd,
                                             **ct["fwd_kw"]),
                    lambda: ta.table_forward_plain(*fr, rounding=rnd), rnd,
                    ppi.num_nodes * d)}), into_json=False)

    # the v2 kernels: the JSON line's times at the PPI widths without a
    # mask in the partial mode, as the sharded PPI paper_faithful fit runs
    # them: h_src holds the real edges' rows alone (1024 floats an edge:
    # their byte bound is not small); the normalised mode and the Cora
    # shapes beside them. The kernels read nothing of an edge e >= E_real,
    # so the inputs are counted over the real edges: the logits, h_src,
    # the mask and the receivers; the forward writes num (or out) and den,
    # the backward reads g and d(den) (the normalised mode also out) and
    # writes d(logits) and d(mask) (E rows, zeros past E_real) and d(h_src)
    # (E_real rows). Per real edge the forward does nh exp and a d-wide
    # multiply-add, the backward a d-wide dot and a d-wide product and the
    # per-head terms.
    def v2_time_rows(graph, c, mode):
        n_, e_, er = graph.num_nodes, graph.num_edges, graph.num_real_edges
        nh, d = c["nh"], c["nh"] * c["f"]
        fa, ba = c[f"fwd_{mode}"], c[f"bwd_{mode}"]
        h_real = fa[1][:er].contiguous()
        fa, ba = (fa[0], h_real) + fa[2:], (ba[0], h_real) + ba[2:]
        dm_in = er * nh if c["drop"] else 0
        dm_out = e_ * nh if c["drop"] else 0
        b_in = er * nh + er * d + dm_in + er
        b_out = n_ * d if mode == "normalised" else 0
        # the forward as the sharded layer calls it: the shard's offsets
        # (n + 1 words) in place of the receivers
        dp = graph.dst_ptr
        return {
            "v2_forward": (lambda: sa.v2_forward(*fa, dst_ptr=dp),
                           lambda: sa.v2_forward_plain(*fa), None,
                           4 * (b_in - er + n_ + 1 + n_ * d + n_ * nh),
                           er * (2 * d + 3 * nh)),
            "v2_backward": (lambda: sa.v2_backward(*ba),
                            lambda: sa.v2_backward_plain(*ba), None,
                            4 * (b_in + n_ * d + b_out + n_ * nh + er * d
                                 + e_ * nh + dm_out),
                            er * (3 * d + 8 * nh)),
        }, fa

    for label, c in v2_cases.items():
        graph = ppi if label.startswith("PPI") else cora
        json_case = label.startswith("PPI") and not c["drop"]
        for mode in ("partial", "normalised"):
            rows, fa = v2_time_rows(graph, c, mode)
            time_rows(f"{label} {mode}", rows,
                      into_json=json_case and mode == "partial")
            time_rows(f"{label} {mode} [{mode_tag(V2_BF16)}]", mode_rows(
                rows, {"v2_forward_bf16": (
                    "v2_forward",
                    lambda fa=fa, dp=graph.dst_ptr: sa.v2_forward(
                        *fa, V2_BF16, dst_ptr=dp),
                    lambda fa=fa: sa.v2_forward_plain(*fa, V2_BF16),
                    V2_BF16, 0)}),
                into_json=json_case and mode == "partial")

    def remainder_by_segment_ops(h, a_src, s_eff, drop, send, recv, order,
                                 e_real, n_, nh, f, eps=1e-8, slope=SLOPE,
                                 num_src_nodes=None, **_):
        """The parts of v5_sweep1_parts from plain segment ops under
        autograd, as the JAX package computes a small remainder. Timing
        only: no path of the package."""
        e_ = send.shape[0]
        mask = (torch.arange(e_, device=h.device) < e_real)[:, None]
        raw_ = seg.gather_rows(h @ a_src, send) + seg.gather_rows(s_eff, recv)
        ex = torch.where(mask, torch.exp(slope * raw_),
                         torch.zeros_like(raw_))
        w = ex if drop is None else ex * drop
        rows = seg.gather_rows(h, send).view(e_, nh, f) * w[:, :, None]
        cap = torch.where(mask, raw_,
                          torch.full_like(raw_, float("-inf"))).max()
        return (seg.segment_sum(rows.reshape(e_, nh * f), recv, n_),
                seg.segment_sum(ex, recv, n_), cap, None)

    def with_segment_remainder(step):
        def run():
            kernel_parts = v5.v5_sweep1_parts
            v5.v5_sweep1_parts = remainder_by_segment_ops
            try:
                return step()
            finally:
                v5.v5_sweep1_parts = kernel_parts
        return run

    for name, (cfg, trainer, params, graph) in fits.items():
        opt = torch.optim.Adam(gat.parameters(params), lr=0.0)
        dgen = trainer.dropout_generator()
        env = CELL_ENV.get(name, {})
        routes = [(f"{trainer.backend} path", trainer, graph, env),
                  ("segment path", refs[name], graph, {})]
        if "bf16" in name:
            # the same model and graph in float32
            routes.insert(1, ("float32 kernel path", trainer, graph,
                              float32_env(env)))
        elif graph.block_layout is not None:
            routes.insert(1, ("v5 kernel path", trainer,
                              graph.replace(block_layout=None), env))
        if "bf16" not in name and {"GAT_TPU_V10",
                                   "GAT_TPU_V5_MERGED"} & set(env):
            # the same model and graph on the single-sweep kernel path
            routes.insert(1, ("single-sweep kernel path", trainer, graph,
                              {k: v for k, v in env.items()
                               if k not in ("GAT_TPU_V10",
                                            "GAT_TPU_V5_MERGED")}))
        if name == "Pubmed cluster":
            # the same model on the RCM-ordered graph takes the windowed op
            routes.insert(1, ("v7 kernel path on the RCM-ordered graph",
                              trainer, pubmed, env))
        if trainer.task.attention_coef != 0.0:
            # the same model and graph without the regulariser: what it
            # costs a step
            routes.insert(1, ("kernel path without the regulariser",
                              dataclasses.replace(trainer, task=(
                                  dataclasses.replace(trainer.task,
                                                      attention_coef=0.0))),
                              graph, env))
        if trainer.backend == "naive":
            # the same model on the kernel path
            routes.insert(1, ("v5 kernel path", dataclasses.replace(
                trainer, backend="kernel"), graph, env))
        if name == "PATTERN":
            # without src_order the same model takes the table op (and
            # sorts the senders itself in every backward)
            routes.insert(1, ("table kernel path", trainer,
                              graph.replace(src_order=None), {}))
        if name == "Cora sampled":
            # the same model's step on the full graph
            routes.insert(1, ("full-graph Cora step", trainer, cora, env))
        if name in ("Cora", "Pubmed", "PPI paper_faithful", "PPI"):
            # the wrappers deriving the offsets per call, as before the
            # Graph carried them (the launches a step they cost)
            routes.insert(1, ("kernel path without the graph's offsets",
                              trainer, graph.replace(src_ptr=None,
                                                     dst_ptr=None), env))
        steps = [(label, under(ev, lambda tr=tr, gr=gr: tr.train_step(
                     params, opt, gr, dgen)))
                 for label, tr, gr, ev in routes]
        if name == "Pubmed cluster":
            # what a gate on the remainder's size would be decided on
            steps.insert(1, ("hybrid with the remainder through plain "
                             "segment ops (timing only)",
                             with_segment_remainder(steps[0][1])))
        times = [step_time_ms(torch, step) for _, step in steps]
        print(f"[time] {name} train step (forward, loss, backward, Adam) on "
              f"{card}: " + ", ".join(f"{label} {t:.4f} ms" for (label, _), t
                                      in zip(steps, times)))
        for i, ((label, step), t) in enumerate(zip(steps, times)):
            profile_steps(torch, step, t, f"{name} {label}",
                          top=12 if i == 0 else 0)

    # the host's share of the sampled and batched fits: an epoch with and
    # without the prefetch thread (fits of 3 epochs in turns: on, off, off,
    # on), the host build of a sampled epoch, and one save_checkpoint at
    # Cora's and PPI's widths
    for name in PREFETCH_REPRO:
        dataset, overrides = CELLS[name][:2]
        walls = {True: [], False: []}
        for on in (True, False, False, True):
            _, trainer, train_data, val_data, reshuffle = make_trainer(
                dataset, overrides, 3)
            trainer = dataclasses.replace(trainer, prefetch=on)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.fit_epochs(train_data, val_data, reshuffle=reshuffle)
            torch.cuda.synchronize()
            walls[on].append((time.perf_counter() - t0) / 3 * 1e3)
        print(f"[time] {name} epoch ({len(train_data)} train batches, "
              f"reshuffled on the host, and {len(val_data)} validation) on "
              f"{card}: with the prefetch thread building the next epoch "
              f"{walls[True]} ms, without "
              f"{walls[False]} ms (mean {np.mean(walls[True]):.1f} against "
              f"{np.mean(walls[False]):.1f})")
    sampler = cli_train.neighbour_sampler(cora_raw, fits["Cora sampled"][0])
    builds = []
    for i in range(5):
        t0 = time.perf_counter()
        epoch = sampler.epoch(i)
        builds.append((time.perf_counter() - t0) * 1e3)
    print(f"[time] Cora sampled: host build of an epoch ({len(epoch)} "
          f"subgraphs in a bucket of {epoch[0].num_nodes} nodes and "
          f"{epoch[0].num_edges} edges; real nodes "
          f"{[int(g.node_mask.sum()) for g in epoch]}, real edges "
          f"{[g.num_real_edges for g in epoch]}): "
          f"{[round(b, 1) for b in builds]} ms; its copy to the card "
          f"{time_host(lambda: [g.to(dev) for g in epoch]):.2f} ms")
    os.makedirs(ROOT_BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT_BUILD) \
            as tmp:
        for name in ("Cora", "PPI"):
            cfg, trainer, params, graph = fits[name]
            trainer = dataclasses.replace(trainer, checkpoint_dir=tmp)
            opt = O.adam_l2(gat.parameters(params), 0.0)
            gen = trainer.dropout_generator()
            trainer.train_step(params, opt, graph, gen)   # Adam's moments
            state = TrainState(params, opt, gen)
            saves = [time_host(lambda: trainer.save_checkpoint(
                state, 0, 1.0, name=name)) for _ in range(5)]
            size = os.path.getsize(os.path.join(tmp, name))
            print(f"[time] save_checkpoint at {name}'s width "
                  f"({sum(p.numel() for p in gat.parameters(params))} "
                  f"parameters, a file of {size} bytes) on {card}: "
                  f"{[round(t, 2) for t in saves]} ms")

    elapsed("6")
    # -- 6. results ---------------------------------------------------------
    kernels = []
    for k in REPLACES:
        t = timing[k]
        _, by = bound_ms(t["bytes"], t["ops"])
        per = ", ".join(f"{name} {per_epoch[name][k]}" for name in per_epoch)
        print(f"[kernel] {k}: kernel_ms {t['ms']:.4f} plain_ms "
              f"{t['plain_ms']:.4f} library_ms {t['library_ms']} bound_us "
              f"{t['bound_ms'] * 1e3:.3f} (both layer shapes of its path "
              f"summed: v5 Cora's, segment_sum_rows PPI's, window "
              f"Pubmed's, "
              f"table PPI's, the parts modes the hybrid Pubmed layout's and "
              f"its remainder's, segment_sum_sorted PPI's score widths by "
              f"receiver with the Graph's offsets, the v5 "
              f"2-phase entries Cora's, the window 2-phase "
              f"entries Pubmed's, each bfloat16 mode its entry's, "
              f"segment_sum_rows_t Cora's, the v2 entries PPI's in the "
              f"partial mode, the gatv2 entries the {GATV2_CELL} graph's "
              f"at its layer shapes); launches {launches[k]} over the "
              f"{len(per_epoch)} fits and phase 4e's forwards (per epoch: "
              f"{per})")
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k],
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": max(errs[k]), "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": by, "library_ms": t["library_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
