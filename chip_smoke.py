#!/usr/bin/env python3
"""The PyTorch port's main path on one CUDA card, end to end.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``mmlspark_tpu_torch/csrc`` (nvcc,
sm_90a) and its host library from ``mmlspark_tpu_torch/native/
data_plane.cpp`` (the host C++ compiler; binning), then:

  1. device: the card's name and power limit, torch/CUDA versions,
     kernel and host-library build times and the ptxas report;
  2. kernel vs plain: the level-histogram kernel (float32 stats summed
     in fixed point) against its plain PyTorch version at the HIGGS
     bench shape (N=2,000,000, F=28, B=255), and at the ranking and
     multiclass paths' widths (MSLR's 260,000 x 136; Covertype's
     581,012 x 54, whose rows the kernels stage byte by byte), for every
     level width of a depth-6 tree — bitwise on integer-valued and on float stats, and
     bitwise between two launches — with CUDA-event timings of the
     kernel (an event pair per call, and ``device_ms``), the plain
     version and one float32 ``index_add_`` call, one call's device time
     by kernel (partition, histogram, dequantization), and the bound from
     bytes and operations; then the kernel's uint16-id instance (max_bin
     above 256: tiles of bins on a grid axis of their own) at the bench's
     2M rows with B = 511, 1,023 and 4,095, and at F = 27 (54-byte rows,
     staged id by id) with B = 1,023, every level width, bitwise against
     its plain version on integer and float stats and between two
     launches, with event-pair, device and plain times, the byte bound and
     at B = 1,023 the ``index_add_`` call; and the width-1 call of the
     leaf-wise builder, a node's membership as ``live`` (every row, half
     of them, 2%), at B = 63 on uint8 ids and B = 1,023 on uint16 ids,
     bitwise against its plain version and between two launches, timed
     the same way;
  3. main path: ``BinMapper.fit`` / ``transform``, ``train`` (binary,
     num_leaves=63, max_depth=6, 20 trees) and ``predict_binned`` on the
     2M rows, with the histogram kernel's launch count over the fit
     (each iteration one replay of the captured boosting step,
     ``models/gbdt/step.py``) and ``tree_score``'s over the scoring, the
     training logloss per tree, two fits bitwise equal, the captured fit
     bitwise the same step run uncaptured (``train(capture=False)``),
     the capture's seconds, launches per replay and graph pool bytes,
     and fit / scoring rates;
  4. profile: a 5-tree bench-shape fit under torch.profiler, replayed
     (the captured step) and uncaptured — device time by kernel (the
     profiler records each kernel of a replayed graph) and the device's
     idle share;
  5. card vs CPU: the same fit at 100k rows and 5 trees on ``cuda`` and
     on ``cpu`` through the port;
  6. quantized kernel vs plain: the int16 (q16) and int8 (q8)
     level-histogram kernel against its plain version at the three
     shapes of phase 2 for every level width — bitwise, and bitwise between two
     launches — with CUDA-event timings of the kernel, the plain
     version and one int64 ``index_add_`` call, one call's device time
     by kernel (partition, histogram, dequantization), and the byte
     bound; the uint16-id instance at phase 2's uint16 cases (q16; q8 at
     the bench's B = 1,023), bitwise and timed as there; the int32
     window (q16, 40,000,000 rows of +32000 in bin 0, so a CTA's run in
     one node passes what an int32 cell holds: bitwise against the plain
     version and between two launches); and the atomic opcodes in the
     built kernel's SASS (native ``ATOMS.ADD``, no CAS loop);
  7. quantized main path: the 20-tree bench fit under
     ``MMLSPARK_TORCH_HIST_QUANT=q16`` (then q8), with the kernels'
     launch counts over each fit, the training logloss per tree, host
     syncs, two fits bitwise equal, and the fit rate (first, the
     quantization exponent ``_pow2_scale`` on the card against the CPU,
     bit for bit, and its host syncs); then the f32 and
     the q16 fit with ``MMLSPARK_TORCH_HIST_SUB=1``, and the kernels'
     device time per tree with subtraction off and on (torch.profiler);
  8. card vs CPU, quantized: the 100k-row 5-tree fit under q16 on
     ``cuda`` and on ``cpu``;
  8a. sampling path: bagging (0.5, every iteration), pos/neg bagging
     (0.5 / 0.3), ``feature_fraction`` 0.5, GOSS and rf (bagging 0.5)
     on the bench fit, float32 and q8: two fits bitwise equal, 120
     histogram launches each through the replays, the booster's logloss
     falling (rf: from the base score), each fit's wall; both histogram
     kernels bitwise against their plain versions on a bagged ``live``
     and on GOSS-amplified grads at every level width; the rf booster's
     ``tree_score`` (weights 1/20) bitwise its plain version; each
     sampled fit card vs CPU at 100k rows and 5 trees (roots equal,
     logloss within 1e-4 relative);
  9. flash kernels vs plain: ``csrc/flash_attn.cu`` (float32) and
     ``csrc/flash_attn_sm90.cu`` (every bfloat16 call: wgmma, TMA, a
     producer warp; in place, or on copies staged for TMA) against
     ``flash_attention_reference`` (TF32 off) at the repo's attention A/B
     shape (b=4, n=2048, h=8, d=64; ``tools/tpu_day.sh``), causal and
     not, in float32 and bfloat16, at d=16, 32, 33, 36, 96 and 128 (bf16;
     float32 at 16, 33, 64, 96 and 128), with cross and ragged lengths,
     scores far outside exp's range, a packed-qkv view, a (b, h, n, d)
     view and a misaligned view (staged) — within rtol 2e-4 / atol 2e-5
     in float32 and that plus one bf16 step in bfloat16, two launches
     bitwise equal, the route each case took (counter deltas) — with
     device times of the call, of its staging copies and of
     ``scaled_dot_product_attention``, CUDA-event timings of the plain
     version, the bound, and at the A/B shape the host's microseconds per
     call (200 calls, no synchronise);
 10. SDPA backends: ``scaled_dot_product_attention`` at the A/B shape
     (causal) in float32 and bfloat16 under each backend alone — which
     accept the call, their times, their max abs error against the plain
     version, and which one the default call matches bit for bit;
 11. attention path: ``fused_attention`` (causal) at the A/B shape in
     float32 and bfloat16 (and bfloat16 at d=32 and through a misaligned
     view, both on ``flash_attn_sm90.cu``, the second staged) and at b=1,
     n=16384, h=8, d=64 in both types, one kernel launch per call (of the
     route it expects; ``flash_attn.cu`` never for bfloat16), against
     ``blockwise_attention``, with the times of both (the flash-vs-
     blockwise A/B), and the refusal of inputs that require grad;
 12. attention, distributed: a one-rank NCCL group runs
     ``ring_attention`` and ``ulysses_attention`` (which launches the
     kernel through ``fused_attention``) against ``blockwise_attention``;
 13. estimator path (run after phase 8): ``LightGBMClassifier`` fit and
     transform over a ``DataFrame`` of the 2M bench rows (20 trees,
     num_leaves 63, max_depth 6) — the fit's wall and its split into
     extraction, binning and ``train``, the launches of each histogram
     kernel over the fit, the booster bit for bit equal to a direct
     ``train`` on the same mapper; the C++ binning bit for bit its numpy
     version on the 2M rows, each timed alone; the transform's wall and
     its ``tree_score`` launches, its columns
     bitwise equal to ``booster.predict`` and the numpy tail, to the
     ``binnedScoring`` transform wherever each feature's float32 bin is its
     bin (elsewhere raw scoring rounds the edge to float32, as in the JAX
     package; the rows are counted), and to a saved and loaded model's; an
     early-stopping fit (10% of the rows validate, 60 iterations,
     learning rate 1.0): the trees kept, the stop rule replayed over the
     evals, the host syncs against the same fit without early stopping;
     two q16 fits (120 quantized launches, bitwise equal); and a card
     vs CPU estimator fit on 100,000 rows;
 14. serving path (after phase 13): the serving bench's flagship model
     (``tools/bench_serving.py``: 100,000 HIGGS-shaped rows,
     ``LightGBMClassifier(numIterations=100, numLeaves=63, maxBin=255)``)
     fitted on the card (600 ``level_hist`` launches, no quantized one),
     saved and loaded (example 01's flow); the binned scorer at every
     rung of the ladder 1..64, bitwise equal between the card, the CPU
     and ``predict_binned`` (and card vs CPU under bf16 autocast), with
     its device time (behind a spin kernel), event-pair and host time
     per batch and its launches per batch (one ``tree_score`` kernel and
     the two copies); request-thread binning µs per row (C++);
     ``ServingServer`` (batch 64, 2 ms, queue 256, 5 s timeout)
     under 64 keep-alive clients in a closed loop for 5 s, with
     ``MMLSPARK_TORCH_SERVE_BINNED=on`` and ``off``: QPS, p50/p99,
     503/504, mean batch size, the plane's counters, ``tree_score``
     launches and a loaded batch's scoring time against the scorer's
     alone; the same load again from 64 clients in a child process
     (the server then has the interpreter lock to itself); 256 rows with
     ``__id__`` through each arm and through ``serve_continuous``,
     replies bitwise equal to ``transform`` (off) or to the
     ``binnedScoring`` transform and to ``transform`` wherever each
     float32 bin is its bin (on, continuous); 500 sequential
     keep-alive requests to the continuous server (p50/p99); and the
     model's string imported and served through ``derive_binning``,
     replies bitwise equal to its own plan's;
 14a. categorical path (after phase 14): ``LightGBMClassifier`` with
     ``categoricalSlotIndexes=[0, 1, 2, 3]`` on the 2M bench-width rows
     whose columns 0-3 are integer categories of 4, 30, 200 and 1,000
     values (``categorical_data``; 20 trees, 63 leaves, depth 6,
     ``maxBin=255``), and with ``zeroAsMissing`` on the bench rows with
     30% exact zeros: each fit's wall and split, 120 histogram launches,
     the logloss falling, two fits bitwise equal; the categorical
     booster bitwise a direct ``train`` on the estimator's config and
     bins, captured and uncaptured; card vs CPU at 100,000 rows (roots
     equal, a categorical root's left set too, logloss within 1e-4
     relative); a 2M-row ``transform`` with ``leafPredictionCol`` (its
     ``tree_score`` launches by route: two of the decision route), the
     leaf slots bitwise the plain version's and scoring back to the raw
     score bit for bit; a 100,000-row ``transform`` with
     ``featuresShapCol`` (rows summing to the raw score within 1e-3,
     card vs CPU within rtol 1e-4 / atol 1e-5) and the times of
     ``leaf_index``, ``contrib`` and ``contrib_saabas``; both models
     served (``ServingServer``, binned plane ``auto``): the categorical
     one refused by the binned plane and served through ``transform``,
     the zero-as-missing one binned through the zero premap, replies
     bitwise ``transform`` (the binned one's where each float32 bin is
     its bin);
 14b. ranking path (``tools/bench_ranker.py``'s configuration,
     BASELINE.json's LightGBMRanker lambdarank): 2,000 MSLR-shaped
     queries of 80-180 documents (about 260,000 rows x 136 features,
     graded 0-4, ``make_mslr_shaped``) fitted by ``LightGBMRanker``
     (lambdarank, 100 trees, 63 leaves, depth 6, ``maxBin=255``,
     ``evalAt=[10]``, ``maxPosition=30``): 600 ``level_hist`` launches,
     NDCG@10 at or above the bench's floor of 0.6 and above the first
     tree's, two fits bitwise, a direct ``train`` captured and
     uncaptured bitwise the estimator's trees, the lambdarank grads'
     device time per call and share of a step's device time
     (torch.profiler), peak device memory; the skewed variant (8-1,200
     documents, 20 trees); early stopping on a tenth of the queries
     against the replayed rule; card vs CPU at 200 queries and 5 trees
     (roots equal, NDCG within 1e-4 relative); the ranker served with
     the binned plane ``on``, replies bitwise the ``binnedScoring``
     transform and ``transform`` where the float32 bins agree;
 14c. multiclass path: 581,012 Covertype-shaped rows x 54 columns
     (``covertype_data``: 10 continuous, one-hot groups of 4 and 40; 7
     classes at Covertype's shares) fitted by ``LightGBMClassifier``
     (multiclass for 7 labels, 20 iterations of 7 trees, 63 leaves,
     depth 6, ``maxBin=255``): 840 ``level_hist`` launches,
     ``multi_logloss`` falling, two fits bitwise, captured and
     uncaptured bitwise, the step's idle share (torch.profiler), the
     transform's ``tree_score`` launches and probability rows summing to
     1 within 1e-6; the fit under bagging 0.5 and under GOSS; card vs
     CPU at 100,000 rows and 5 iterations (every class's roots equal,
     ``multi_logloss`` within 1e-4 relative); served with the binned
     plane ``on`` as 14b. Every fit runs with ``MMLSPARK_TORCH_EFB=off``:
     the histograms scan all 54 columns, rows staged byte by byte, as in
     the phase's earlier runs (EFB is 14d's); beside them the plan that
     ``auto`` would make of these rows, on the card, and its time;
 14d. breadth path (ROADMAP A7's in-step settings, at the bench's shape,
     20 trees): ``max_bin=1023`` on uint16 ids (the f32, q16 and q8 fits:
     two fits bitwise, captured bitwise uncaptured, 6 launches of the
     uint16 kernel per replay, thresholds past bin 255; ``predict_binned``
     on the 2M uint16 rows bitwise ``tree_score``'s plain version; a
     ``LightGBMClassifier(maxBin=1023)`` fit and transform, served binned
     with replies bitwise the transforms); monotone constraints (+1 on
     features 0-1, -1 on 2-3), ``extra_trees``,
     ``feature_fraction_by_node=0.7`` and all three, each captured bitwise
     uncaptured with 120 launches, 4,096 rows swept over every bin of each
     constrained feature with no raw score stepping against it, every
     split of a by-node fit inside its node's subset drawn again from the
     tree's stream, card vs CPU at 100,000 rows and 5 trees; EFB on
     1,000,000 rows of 28 dense and 256 one-hot columns (fields of 16, 32,
     64 and 144 values): the plan and its time, the unbundled histogram
     against the direct one at every level width (counts and every cell
     but the members' default bins bitwise, those within float32
     rounding; the bundled kernel's device ms per tree, bound, plain
     version's and ``index_add_`` time beside the direct one's), the histogram
     kernels' device ms per tree and ``train`` s with ``MMLSPARK_TORCH_EFB``
     auto and off, final loglosses within 1e-4;
 14e. leaf-wise path (``MMLSPARK_TORCH_GROW_POLICY=leafwise``, the host
     loop; LightGBM's GPU-performance HIGGS settings,
     ``docs/GPU-Performance.rst``: the bench's 2M x 28 rows at
     ``max_bin=63``, binary, 255 leaves, ``max_depth`` unset (depth cap
     8), learning rate 0.1, ``min_sum_hessian_in_leaf=100``, 20 trees):
     the fit's wall, its width-1 ``level_hist`` launches against the
     builder's count, per tree the histogram kernel's device ms
     (torch.profiler over 3 trees), the split search's and the host
     reads' host ms, the logloss falling, two fits bitwise, the same fit
     depthwise (wall, logloss), ``tree_score`` on the depth-8 booster
     bitwise its plain version, card vs CPU at 100,000 rows and 5 trees
     (L2: every tree equal; binary: roots equal);
 14f. DART path (the host loop): the bench fit with
     ``boosting_type="dart"`` and LightGBM's default drops on the
     float32 and q8 planes (120 launches each, two fits bitwise, drops
     drawn, the wall against the captured gbdt fit's), a
     ``LightGBMClassifier(boostingType="dart")`` on the 2M rows with 10%
     validating and ``earlyStoppingRound=3`` (the stop; its transform
     through ``tree_score.cu`` bitwise the plain version), card vs CPU at
     100,000 rows and 5 trees (tree weights and roots equal, logloss
     within 1e-4);
 14g. out-of-core path (``models/gbdt/ooc.py``): 4,000,000 × 28 rows of
     the bench's generator (the reference's auto threshold at HIGGS's
     width), binary, 63 leaves, depth 6, 20 trees, default knobs:
     ``train`` streams by itself (16 chunks, q16), its trees bitwise the
     in-core q16 fit, and with subtraction on bitwise that in-core fit
     with one binned chunk corrupted (``spill.read``) and repaired from
     the rows; the chunk-merge entry's launches against the builder's
     count (20 × 6 × 16); a ``train_ooc`` fit over a spill written chunk
     by chunk with ``fit_streaming`` edges, no array of all the rows;
     each fit's wall, device peak and host RSS growth, and the host
     seconds of reads, pinning, waits and store writes; the entry bitwise
     its plain version chunk by chunk and in one pass (uint8 at B = 255,
     uint16 at 1,023) with its time per 262,144-row chunk call, bound and
     ``index_add_``; a 3-tree uint16 streamed fit bitwise its in-core
     fit; a 5-iteration ``LightGBMRegressor`` streamed through ``train``;
     a 2-tree streamed fit profiled (device ms by kernel, uploads);
 14h. int32 kernels (``max_bin`` past 65,536): both histogram kernels'
     int32 instances against their plain versions at 2M × 28 with B =
     70,000, 131,072 and 131,072 skewed (90% of each feature's rows in
     one bin), every level width, the float32 plane on integer and float
     stats, q16 at each case and q8 at B = 131,072, bitwise and between
     two launches, with event-pair, device, plain and ``index_add_``
     times and the byte bound; the chunk-merge entry on int32 ids (4
     chunks of 262,144 rows, B = 131,072) held as in 14g;
 14i. int32 path: ``LightGBMClassifier(maxBin=131072,
     binSampleCount=2000000)`` on the bench's 2M rows (every column past
     65,536 bins, int32 ids) fit and transform, raw and binned, its
     binned serving plane's replies; ``train`` on its mapper (f32: two
     fits bitwise, captured bitwise uncaptured, the estimator's booster;
     q16, q8), 120 launches of the int32 instance per fit, each fit's
     wall and device peak under ``trainer.in_core_bytes``, the logloss
     falling, and a profiled 3-tree fit (device ms by kernel);
     ``predict_binned`` on the 2M int32 rows through the wide bin nodes,
     bitwise its plain version; a leaf-wise (8 leaves), a
     DART and a streamed fit at 200,000 rows, B = 70,000, 3 trees, the
     streamed one bitwise the in-core q16 fit;
 15. tree scorer vs plain (after phase 14c): ``csrc/tree_score.cu``
     against ``score_cuda.tree_score_reference``, bit for bit and between
     two launches: the served model at every rung 1..64 (autocast off
     and bf16; uint8, uint16 and int32 bin ids; the staged batch too) and
     on both sides of the plan crossover, the main path's booster at its
     2M binned rows, at one row, at 2M + 7 rows and at 2M raw rows with
     NaN (``predict``), random boosters of three classes (the cluster
     plan), ten classes, 1,000 trees (tree chunks), depth 16 (the global
     route) and none, each plan forced on the other's inputs; the
     decision route (scores and leaf slots) on the categorical model's
     2M rows and at 1..16,384 rows in each plan, and on random boosters
     of every decision byte with category bitsets (K=1 also at 2M rows,
     K=3, depth 16) over rows with NaN, 0.0, -0.0, negative, fractional
     and unseen categories, each plan forced; the wide bin nodes (thresholds
     and int32 ids past 65,535, K = 3; split features past 32,767 on uint8,
     uint16 and int32 ids) in each plan that fits, their staged batch at every
     rung, and the int32 path's booster at its 2M int32 rows; each case's plan
     on a line of its own; at rung 64 and at 2M rows the device time, the
     event-pair time, the launches of one call (profiler), the bound and the
     plain version's time; and both plans' device time at 1..16,384 rows (the
     crossover);
 16. objectives path (after phase 13): ``LightGBMRegressor`` fit and
     transform on the 2M bench rows (20 trees, num_leaves 63, max_depth
     6, max_bin 255) under each of regression_l1, huber, fair, poisson,
     quantile, mape, gamma and tweedie, each on labels it models
     (continuous values, counts, positive reals) from the rows' signal:
     the fit's wall, ``train`` time and the objective's device time per
     call and share of it, 120 ``level_hist`` launches per fit, the
     default metric falling from tree 1 to tree 20 (except gamma's and
     tweedie's, the l2 of a log-scale score) and the objective's own loss
     falling (computed here from the scores of the first tree and of all
     20), two fits bitwise equal, one ``tree_score`` launch per
     transform, predictions the link of ``booster.predict`` (``exp`` for
     poisson, gamma and tweedie, positive), and a card vs CPU fit on
     100,000 rows (5 trees: roots equal, final metric within 1e-4);
 17. custom objective path: a torch ``fobj`` calling the port's huber
     gives the ``objective="huber"`` booster bit for bit, a numpy
     ``fobj`` (L2 through ``.cpu().numpy()``) the ``"regression"``
     one, with each fit's wall and the numpy fit's host syncs per tree;
 18. checkpoint path: ``checkpointInterval=5`` over 20 trees in a
     temporary directory — an uninterrupted fit (120 launches, each
     segment's write + crc32 time, the overhead over the monolithic
     fit), a fit killed by an armed ``gbdt.train_step`` raise at hit 11
     (the directory then holds checkpoints 5 and 10 with their
     sidecars and the fingerprint) and resumed, bitwise the
     uninterrupted one; a flipped byte in ``checkpoint_10.txt`` makes the
     resume fall back to checkpoint 5 with the warning, bitwise again;
     the monolithic fit compared, with the rows that route apart under
     ROADMAP C3 counted (bitwise required where there are none); a
     3-tree fit with ``gbdt.level_hist`` armed to zero each histogram on
     the card (no split, no host sync beyond a clean fit's); and an
     unarmed fault point's cost per call and per fit;
 19. refresh path (after phase 15; ``bench.py --refresh-latency``'s
     width): a ``LightGBMRegressor`` (100,000 × 28 float32 rows, 30
     trees, 63 leaves, ``maxBin=63``, ``minDataInLeaf=20``) served by a
     ``ServingServer`` (batch 64, 2 ms) and a ``RefreshController``: one
     warm generation, then a timed one — the wall from data arrival to
     the new model serving, ``refit_s``, ``swap_s``, ``downtime_s``,
     ``level_hist`` launches per refit and ``tree_score`` launches per
     probe; replies after the swap bitwise the new generation's; an armed
     ``registry.swap`` corrupt rolled back with the replies unchanged; a
     restarted controller on the newest generation; a refit killed at
     the middle of its second 10-tree segment and retried, bitwise the
     unkilled one;
 20. fleet path (``bench.py --refresh-under-load``'s width): a 2-worker
     ``ServingFleet`` of a 50,000-row 20-tree regressor with a
     ``FleetSupervisor`` (2..2); 8 closed-loop clients for 6 s idle,
     then during a co-located low-priority refit, then during
     ``swap_model_fleet``: p50/p99 by stage, the refit's yields, each
     worker's flip downtime, 503/504 replies; no client error and every
     reply bitwise the generation its worker served then; a
     ``serving.worker_kill`` death restarted by the supervisor (two
     workers serve); a hedging ``FleetClient`` ejects a worker with
     ``gray_delay_ms`` set, replies bitwise; ``drain`` with 16 accepted
     requests returns True, each replied bitwise;
 21. multi-device GBDT (``dist_gbdt_path``, after phase 12): the float32
     kernel's sums entries (amax, int64 sums into an accumulator, one
     rounding) against their plain versions at 2M x 28 with B = 255
     (every width, timed, the int64 ``index_add_`` beside), 1,023 and
     131,072 — the sums of uneven shards (1M + 1M, 1.5M + 0.5M) bitwise
     one pass's, the rounded sums bitwise the one-call entry's; on a
     one-rank NCCL mesh the bench fit under the data, voting (top_k 28)
     and feature learners, each bitwise the serial uncaptured fit, the
     sums entries' launches counted over them, and a meshed
     ``LightGBMClassifier`` fit and ``transform`` bitwise the unmeshed
     model's; two gloo ranks on this card (``--dist-rank``) fitting the
     data and data_sharded learners, each rank bitwise the serial fit and
     its histogram bytes ``hist_reduction_bytes``; each fit's warm wall
     (the median of 3 after an untimed first run) against the serial
     uncaptured fit's, timed beside it in the same loop, and a level's
     all-reduce time over NCCL and over gloo.

Each phase prints one JSON line. Any failure exits non-zero and prints
no result. Without a CUDA card it exits 2 at once. The last lines are
the kernel table, the ``nvidia-smi`` name/power line, and
``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import json
import os
import pickle
import re
import subprocess
import sys
import threading
import time
import traceback
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

N, F, B = 2_000_000, 28, 255
WIDTHS = (1, 2, 4, 8, 16, 32)        # the six levels of a depth-6 tree
# the histogram kernels' shapes: the bench's, and the widths the ranking
# and multiclass paths give them (MSLR's 136 features: four 32-feature
# slices and one of 8; Covertype's 54, whose rows are not whole 32-bit
# words, so the kernels stage them byte by byte)
HIST_SHAPES = {"bench": (N, F), "mslr": (260_000, 136),
               "covertype": (581_012, 54)}
TREES = 20
REPS = 20
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and
# float32 outside the tensor cores (the histogram's adds; the quantized
# kernel's int32 adds are held to the same scalar rate)
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32_EPS = 2.0 ** -24
QUANTS = {"q16": ("int16", 32000), "q8": ("int8", 120)}
# attention: the repo's flash-vs-blockwise A/B (tools/tpu_day.sh:112-142)
# and its long-context length (ROUND4_NOTES.md:121: n=16384 "needs real
# chips"); dense tensor-core peaks: bfloat16 (the bf16 function's
# operation bound) and TF32 (a note beside the float32 bound)
FLASH_AB = (4, 2048, 8, 64)
FLASH_LONG = (1, 16384, 8, 64)
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(torch, fn, reps=REPS, warmup=3):
    """Median CUDA-event time of ``fn`` in ms over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in times]))


@contextlib.contextmanager
def knobs(quant="off", sub="0"):
    """The port's histogram knobs for the fits inside the block."""
    names = {"MMLSPARK_TORCH_HIST_QUANT": quant,
             "MMLSPARK_TORCH_HIST_SUB": sub}
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(names)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def count_syncs(torch, fn):
    """Host syncs made by ``fn()``: CUDA sync debug mode warns once for
    every synchronizing call."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def first_sync_site(torch, fn):
    """Where ``fn()`` first synchronizes with the host (CUDA sync debug
    mode ``error`` raises at the syncing call): the innermost frame of
    the port's code, or None where it makes no sync."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return None
    except RuntimeError as e:
        frames = [f for f in traceback.extract_tb(e.__traceback__)
                  if "mmlspark_tpu_torch" in f.filename]
        if not frames:
            return repr(e)[:300]
        f = frames[-1]
        return f"{os.path.basename(f.filename)}:{f.lineno} {f.line}"
    finally:
        torch.cuda.set_sync_debug_mode("default")


def device_ms_by_kernel(torch, fn):
    """(wall ms, {kernel name: device ms}) of ``fn()`` under
    torch.profiler, names without template arguments."""
    wall_ms, by_name, _ = profile_ms(torch, fn)
    return wall_ms, by_name


def kernel_name(name):
    """A profiled kernel's name without namespace noise or template
    arguments."""
    base = name.replace("(anonymous namespace)::", "")
    return re.sub(r"[<(].*$", "", base).strip()


def profile_ms(torch, fn):
    """(wall ms, {kernel name: device ms}, {host op: self ms}) of
    ``fn()`` under torch.profiler, kernel names without template
    arguments."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            name = kernel_name(e.name)
            by_name[name] = by_name.get(name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    host = {e.key: e.self_cpu_time_total / 1e3 for e in prof.key_averages()
            if e.self_cpu_time_total > 0}
    return wall_ms, by_name, host


def device_ms(torch, fn, reps=REPS, warmup=3, batches=3):
    """Device time of one call of ``fn`` in ms, back to back: a spin
    kernel (``torch.cuda._sleep``) holds the stream while the host
    enqueues ``reps`` calls, so the CUDA events around them time the
    device's work alone, with no host time between calls (the device's
    own gaps between kernels count). If the host took longer to enqueue
    than the spin lasted, the batch is run again with a longer spin.
    The median of ``batches`` batches. Unlike an event pair around each
    call, it does not grow when the host's work per call outlasts the
    device's; unlike summing a profiler's kernel records, it cannot
    miss a kernel."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin, times = 1 << 24, []
    while len(times) < batches:
        held, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        held.record()
        torch.cuda._sleep(spin)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if host_ms >= held.elapsed_time(start):
            spin *= 4
            if spin > 1 << 30:
                raise AssertionError("the host never enqueued a batch within "
                                     "the spin")
            continue
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


# the kernels of the histogram wrappers: the histograms, the float32
# plane's partition (plan_count, plan_scan, plan_scatter), and the
# dequantization
HIST_KERNELS = ("level_hist", "plan_", "dequantize")


def hist_device_ms(by_name):
    return sum(v for k, v in by_name.items()
               if any(h in k for h in HIST_KERNELS))


def top(by_name, k):
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:k])


BOOSTER_ARRAYS = ("split_feature", "threshold_bin", "threshold_value",
                  "node_value", "count", "tree_weights")


def boosters_equal(a, b):
    return not arrays_differing(a, b)


def arrays_differing(a, b):
    return [k for k in BOOSTER_ARRAYS
            if not np.array_equal(getattr(a, k), getattr(b, k))]


def phase_device(ctx):
    import torch

    from mmlspark_tpu_torch.native import bindings
    t0 = time.perf_counter()
    reports = bindings.build()
    build_s = time.perf_counter() - t0
    # the host library (C++ binning), built by the host compiler
    t0 = time.perf_counter()
    host_lib = bindings.build_host("data_plane")
    host_build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln
                    or "entry function" in ln]
             for name, log in reports.items()}
    ctx["kind"] = torch.cuda.get_device_name(0)
    ctx["smi"] = nvidia_smi_line()
    return {"nvidia_smi": ctx["smi"], "torch": torch.__version__,
            "cuda": torch.version.cuda, "kind": ctx["kind"],
            "count": torch.cuda.device_count(),
            "kernel_build_s": build_s, "ptxas": ptxas,
            "host_library": os.path.basename(host_lib),
            "host_build_s": host_build_s}


def phase_kernel(ctx):
    """Level-histogram kernel vs its plain version at each of
    ``HIST_SHAPES``: the fixed-point sums are the same bits in any order,
    so bitwise on every stat, and between two launches."""
    import torch

    ctx["hist_rows_by_shape"] = {}
    for name, (n, f) in HIST_SHAPES.items():
        rows = kernel_rows(torch, n, f, name)
        ctx["hist_rows_by_shape"][name] = rows
        if name == "bench":
            ctx["hist_rows"] = rows
        torch.cuda.empty_cache()
    ctx["hist_u16"] = u16_cases(torch, "f32")
    torch.cuda.empty_cache()
    ctx["hist_width1"] = width1_rows(torch)
    return {"widths": list(WIDTHS), "shapes": HIST_SHAPES,
            "all_bitwise": True,
            "u16_per_tree": u16_summary(ctx["hist_u16"]),
            "width1_member_ms": {
                f"{r['ids']}_b{r['b']}_share{r['member_share']}":
                r["kernel_device_ms"] for r in ctx["hist_width1"]}}


# uint16 bin ids (max_bin above 256): the bench's rows at three bin counts;
# an odd feature count, whose 54-byte rows start at either half of a
# 4-byte word; and the bench's shape with 90% of each feature's rows in one
# bin (its own), as a sparse column puts them in its default bin: rows of
# one warp instruction then add into the same cell
HIST_U16 = (("bench", N, F, 511), ("bench", N, F, 1023),
            ("bench", N, F, 4095), ("odd_f", N, 27, 1023),
            ("skewed", N, F, 1023))
U16_LIBRARY_B = 1023      # the bin count whose index_add_ is timed
U16_REPS = 5
U16_SKEW = 0.9            # the skewed case's share of rows in one bin


def u16_ids(torch, gen, n, f, b, dev, skew=0.0):
    """(n, f) uint16 bin ids in [0, b): ``i32_ids`` (randint takes no
    uint16) narrowed through int16's bits."""
    return i32_ids(torch, gen, n, f, b, dev, skew).to(torch.int16).view(
        torch.uint16)


def i32_ids(torch, gen, n, f, b, dev, skew=0.0):
    """(n, f) int32 bin ids in [0, b): uniform, or with a share ``skew``
    of each feature's rows in one bin of its own."""
    ids = torch.randint(0, b, (n, f), generator=gen, device=dev,
                        dtype=torch.int32)
    if skew:
        default = torch.randint(0, b, (1, f), generator=gen, device=dev,
                                dtype=torch.int32)
        ids = torch.where(torch.rand((n, f), generator=gen, device=dev)
                          < skew, default, ids)
    return ids


def u16_cases(torch, plane, cases=HIST_U16, widths=WIDTHS, bin_bytes=2):
    """Each case of ``cases`` (uint16 ids, or int32 ids where
    ``bin_bytes`` is 4) on ``plane`` ("f32", "q16" or "q8"): {case: rows
    per width}, each kernel bitwise its plain version and between two
    launches (``u16_row``)."""
    out = {}
    for shape, n, f, b in cases:
        out[f"{shape}_b{b}"] = [u16_row(torch, plane, n, f, b, width, shape,
                                        bin_bytes)
                                for width in widths]
        torch.cuda.empty_cache()
    return out


def u16_row(torch, plane, N, F, B, width, shape, bin_bytes=2):
    """One level width of a histogram kernel on uint16 ids (int32 ids
    where ``bin_bytes`` is 4) against its plain version: integer-valued
    and float stats on the f32 plane (fixed point: bitwise on both), the
    trainer's quantized stats on q16 / q8; bitwise between two launches;
    event-pair, device and plain times, the bound from bytes and
    operations, and at ``U16_LIBRARY_B`` (every int32 case) the
    ``index_add_`` call."""
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(B + F + width)
    binned = (u16_ids if bin_bytes == 2 else i32_ids)(
        torch, gen, N, F, B, dev,
        skew=U16_SKEW if shape == "skewed" else 0.0)
    live = (torch.rand(N, generator=gen, device=dev) < 0.9).float()
    local = torch.randint(0, width, (N,), generator=gen, device=dev)
    if plane == "f32":
        gi = torch.randint(-4, 5, (N,), generator=gen, device=dev).float()
        hi = torch.randint(0, 5, (N,), generator=gen, device=dev).float()
        g = torch.randn(N, generator=gen, device=dev)
        h = torch.rand(N, generator=gen, device=dev) * 0.9 + 0.1
        stats = (g, h)
        call = H.level_histogram
        plain = H.level_histogram_reference
        extra = ()
        exact = bool(torch.equal(
            H.level_histogram(binned, gi, hi, live, local, width, F, B),
            plain(binned, gi, hi, live, local, width, F, B)))
        kept = live != 0
    else:
        dtype_name, qmax = QUANTS[plane]
        dtype = getattr(torch, dtype_name)
        g = torch.round(torch.randn(N, generator=gen, device=dev)
                        .clamp(-4, 4) * (qmax / 4)).to(dtype)
        h = torch.round(torch.rand(N, generator=gen, device=dev)
                        * qmax).to(dtype)
        stats = (g, h)
        call = H.level_histogram_quant
        plain = H.level_histogram_quant_reference
        extra = (torch.full((), 2.0 ** -12, device=dev),
                 torch.full((), 2.0 ** -14, device=dev))
        exact = True
        kept = live > 0
    args = (binned, *stats, live, local, width, F, B, *extra)
    k1 = call(*args)
    k2 = call(*args)
    p = plain(*args)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(k1, p))
    repeat = bool(torch.equal(k1, k2))
    err = float((k1 - p).abs().max().item())
    del k1, k2, p
    kernel_ms = time_ms(torch, lambda: call(*args), reps=U16_REPS)
    kernel_device_ms = device_ms(torch, lambda: call(*args), reps=U16_REPS)
    plain_ms = time_ms(torch, lambda: plain(*args), reps=3, warmup=1)
    library_ms = None
    if (B == U16_LIBRARY_B and shape == "bench") or bin_bytes == 4:
        idx = H.flat_index(binned, local, F, B)
        if plane == "f32":
            src = torch.stack([g * live, h * live, live], -1)
            acc_dtype = torch.float32
        else:
            gate = kept.long()
            src = torch.stack([g.long() * gate, h.long() * gate, gate], -1)
            acc_dtype = torch.int64
        src = src[:, None, :].expand(N, F, 3).reshape(-1, 3)
        library_ms = time_ms(torch, lambda: torch.zeros(
            (width * F * B, 3), dtype=acc_dtype, device=dev).index_add_(
                0, idx, src), reps=U16_REPS)
        del idx, src
    in_bytes = sum(t.numel() * t.element_size()
                   for t in (binned, *stats, live, local))
    out_bytes = width * F * B * 3 * 4
    ops = 3 * F * int(kept.sum().item())
    bytes_ms = (in_bytes + out_bytes) / MEM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    # the launch's geometry, from the kernel's library: CTAs, SMs, CTAs
    # per SM, slices, tiles, features per slice
    geometry = H.launch_geometry("f32" if plane == "f32" else "quant", F, B,
                                 bin_bytes)
    ids = "uint16" if bin_bytes == 2 else "int32"
    row = {"plane": plane, "ids": ids, "shape": shape, "n": N, "f": F,
           "b": B,
           "width": width, "bitwise": bitwise, "bitwise_int": exact,
           "repeat_bitwise": repeat, "max_abs_err": err,
           "geometry": geometry,
           "kernel_ms": kernel_ms, "kernel_device_ms": kernel_device_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": in_bytes + out_bytes, "ops": ops}
    emit({"phase": f"kernel_{'u16' if bin_bytes == 2 else 'i32'}_vs_plain",
          **row})
    if not (bitwise and exact and repeat):
        raise AssertionError(f"{plane} histogram on {ids} ids disagrees "
                             f"with its plain version: {row}")
    if geometry["ctas"] > geometry["sms"] * geometry["per_sm"]:
        raise AssertionError(f"{plane} histogram on {ids} ids launches "
                             f"past one wave: {geometry}")
    return row


def u16_summary(cases):
    """Per case the sums over the level widths (one depth-6 tree)."""
    out = {}
    for name, rows in cases.items():
        out[name] = {k: sum(r[k] for r in rows) for k in (
            "kernel_ms", "kernel_device_ms", "plain_ms", "bound_ms")}
        lib = [r["library_ms"] for r in rows]
        out[name]["library_ms"] = None if None in lib else sum(lib)
        out[name]["geometry"] = rows[0]["geometry"]
    return out


def kernel_rows(torch, N, F, shape):
    """One row per level width of ``level_hist`` against its plain
    version at N rows of F features (``phase_kernel``)."""
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    binned = torch.randint(0, B, (N, F), generator=gen, device=dev,
                           dtype=torch.uint8)
    live = (torch.rand(N, generator=gen, device=dev) < 0.9).float()
    # integer-valued stats in [-4, 4]: every partial sum is an integer of
    # magnitude <= 4N = 8e6 < 2^24, exact in float32 in any order
    gi = torch.randint(-4, 5, (N,), generator=gen, device=dev).float()
    hi = torch.randint(0, 5, (N,), generator=gen, device=dev).float()
    gf = torch.randn(N, generator=gen, device=dev)
    hf = torch.rand(N, generator=gen, device=dev) * 0.9 + 0.1
    rows = []
    for width in WIDTHS:
        local = torch.randint(0, width, (N,), generator=gen, device=dev)
        args = (width, F, B)
        k_int = H.level_histogram(binned, gi, hi, live, local, *args)
        p_int = H.level_histogram_reference(binned, gi, hi, live, local, *args)
        k = H.level_histogram(binned, gf, hf, live, local, *args)
        k2 = H.level_histogram(binned, gf, hf, live, local, *args)
        p = H.level_histogram_reference(binned, gf, hf, live, local, *args)
        # the float bound of any float32 order, kept beside the bitwise
        # gates: a float32 sum of k terms in any order is within about
        # (k-1)*u*sum|x| of the exact sum (u = 2^-24), so two orders
        # differ by under 2(k-1)*u*sum|x|; 4*k*u*sum|x| per cell also
        # covers the rounding of sum|x| itself
        absum = H.level_histogram_reference(binned, gf.abs(), hf.abs(), live,
                                            local, *args)
        bound = 4.0 * p[..., 2:3] * F32_EPS * absum
        err = (k - p).abs()
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(k_int, p_int))
        bitwise_float = bool(torch.equal(k, p))
        repeat = bool(torch.equal(k, k2))
        within = bool((err[..., :2] <= bound[..., :2]).all())
        counts_exact = bool(torch.equal(k[..., 2], p[..., 2]))
        del k2

        idx = H.flat_index(binned, local, F, B)
        src = torch.stack([gf * live, hf * live, live], -1)[:, None, :] \
            .expand(N, F, 3).reshape(-1, 3)
        kernel_ms = time_ms(torch, lambda: H.level_histogram(
            binned, gf, hf, live, local, *args))
        kernel_device_ms = device_ms(torch, lambda: H.level_histogram(
            binned, gf, hf, live, local, *args))
        # one call's device time by kernel: the partition (count, scan,
        # scatter), the histogram, the dequantization, torch's fills
        _, split = device_ms_by_kernel(torch, lambda: H.level_histogram(
            binned, gf, hf, live, local, *args))
        plain_ms = time_ms(torch, lambda: H.level_histogram_reference(
            binned, gf, hf, live, local, *args))
        library_ms = time_ms(torch, lambda: torch.zeros(
            (width * F * B, 3), device=dev).index_add_(0, idx, src))
        del idx, src
        in_bytes = sum(t.numel() * t.element_size()
                       for t in (binned, gf, hf, live, local))
        out_bytes = width * F * B * 3 * 4
        ops = 3 * F * int(live.sum().item())
        bytes_ms = (in_bytes + out_bytes) / MEM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        row = {"shape": shape, "n": N, "f": F, "width": width,
               "bitwise_int": bitwise,
               "bitwise_float": bitwise_float, "repeat_bitwise": repeat,
               "float_within_bound": within, "counts_exact": counts_exact,
               "max_abs_err": float(err.max().item()),
               "kernel_ms": kernel_ms, "kernel_device_ms": kernel_device_ms,
               "plain_ms": plain_ms,
               "library_ms": library_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes": in_bytes + out_bytes, "ops": ops,
               "device_ms_by_kernel": split}
        emit({"phase": "kernel_vs_plain", **row})
        rows.append(row)
        if not (bitwise and bitwise_float and repeat and within
                and counts_exact):
            raise AssertionError(f"level_hist disagrees with its plain "
                                 f"version at width {width}: {row}")
    return rows


_made = {}


def make_data(n, seed=0):
    """The bench's HIGGS-shaped synthetic problem (bench.py): made once
    per (n, seed), a copy for each caller."""
    if (n, seed) not in _made:
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(n, F)).astype(np.float32)
        logit = (x[:, 0] * 1.2 - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
                 + 0.3 * np.sin(x[:, 4] * 3))
        y = (logit + rng.normal(size=n) * 0.5 > 0).astype(np.float64)
        _made[(n, seed)] = (x, y)
    x, y = _made[(n, seed)]
    return x.copy(), y.copy()


def phase_main(ctx):
    import torch

    from mmlspark_tpu_torch import BinMapper, TrainConfig, train
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.models.gbdt import score_cuda as S

    x, y = make_data(N)
    t0 = time.perf_counter()
    mapper = BinMapper.fit(x[:100_000], max_bin=255)
    binned = mapper.transform(x)
    bin_upper = mapper.bin_upper_values(255)
    bin_s = time.perf_counter() - t0
    cfg = TrainConfig(objective="binary", num_iterations=TREES,
                      num_leaves=63, max_depth=6, min_data_in_leaf=20)

    def syncs_of(num_trees):
        """Host syncs in a fit of ``num_trees`` trees."""
        return count_syncs(torch, lambda: train(
            binned, y, dataclasses.replace(cfg, num_iterations=num_trees),
            bin_upper=bin_upper))

    # the boosting loop must not wait on the device: after a warm-up fit
    # (one-off start-up syncs), a 1-tree and a 3-tree fit make the same
    # syncs — set-up and the final transfer only
    syncs_of(1)
    syncs = {t: syncs_of(t) for t in (1, 3)}
    if syncs[1] != syncs[3]:
        raise AssertionError(f"host syncs grow with the tree count: {syncs}")
    torch.cuda.synchronize()

    H.hist_kernel_launches = H.hist_quant_kernel_launches = 0
    S.tree_score_launches = 0
    S.tree_score_plan_launches.update(rows=0, cluster=0)
    t0 = time.perf_counter()
    result = train(binned, y, cfg, bin_upper=bin_upper)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = H.hist_kernel_launches
    quant_launches = H.hist_quant_kernel_launches
    ctx["launches"] = {"level_hist": launches}
    ctx["main_inputs"] = (binned, y, bin_upper, cfg)
    ctx["main_fit_rate"] = N * TREES / fit_s / 1e6
    # the fixed-point histogram makes the float32 fit reproducible
    reproducible = boosters_equal(
        result.booster, train(binned, y, cfg, bin_upper=bin_upper).booster)
    # each iteration one replay of the captured step, bitwise the same
    # step run uncaptured (train's own capture=False)
    H.hist_kernel_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    uncaptured = train(binned, y, cfg, bin_upper=bin_upper, capture=False)
    torch.cuda.synchronize()
    uncaptured_s = time.perf_counter() - t0
    uncaptured_launches = H.hist_kernel_launches
    captured_bitwise = boosters_equal(result.booster, uncaptured.booster)
    capture = step_capture_stats(torch, cfg)

    booster = result.booster
    lls = [e["train_binary_logloss"] for e in result.evals]
    binned_d = torch.as_tensor(binned.astype(np.uint8), device="cuda")
    booster.predict_binned(binned_d[:1000])          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = booster.predict_binned(binned_d)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    # the warm-up and the 2M-row call: one tree_score launch each
    score_launches = S.tree_score_launches
    ctx["launches"]["tree_score"] = score_launches
    ctx["main_booster"] = booster
    # the same booster on a small slice scored on the CPU: same per-tree
    # float32 ops in the same order, so bitwise equal
    small = binned[:100_000].astype(np.uint8)
    cpu_scores = booster.predict_binned(small, device="cpu")
    expected = TREES * cfg.effective_depth
    out = {"bin_s": bin_s, "fit_s": fit_s, "score_s": score_s,
           "trees": booster.num_trees, "launches": launches,
           "tree_score_launches": score_launches,
           "tree_score_plan_launches": dict(S.tree_score_plan_launches),
           "expected_launches": expected,
           "syncs_per_fit": syncs[3], "two_fits_bitwise": reproducible,
           "step": result.step_stats, "capture": capture,
           "uncaptured_fit_s": uncaptured_s,
           "uncaptured_launches": uncaptured_launches,
           "captured_bitwise_uncaptured": captured_bitwise,
           "logloss_first": lls[0], "logloss_last": lls[-1],
           "fit_mrow_trees_per_s": N * booster.num_trees / fit_s / 1e6,
           "score_mrow_trees_per_s": N * booster.num_trees / score_s / 1e6,
           "card": ctx["smi"]}
    if launches != expected or quant_launches:
        raise AssertionError(f"level_hist launched {launches} times in the "
                             f"fit, expected {expected}; level_hist_quant "
                             f"{quant_launches}, expected 0")
    if score_launches != 2 or S.tree_score_plan_launches["rows"] != 2:
        raise AssertionError(f"two predict_binned calls launched tree_score "
                             f"{score_launches} times "
                             f"({S.tree_score_plan_launches}), expected 2 "
                             f"under the rows plan")
    if not all(b <= a + 1e-7 for a, b in zip(lls, lls[1:])) \
            or not lls[-1] < lls[0]:
        raise AssertionError(f"training logloss does not fall: {lls}")
    if not reproducible:
        raise AssertionError("two float32 fits gave different boosters")
    if not (result.step_stats["captured"] and captured_bitwise
            and uncaptured_launches == expected
            and not uncaptured.step_stats["captured"]):
        raise AssertionError(f"the captured fit ({result.step_stats}) is not "
                             f"the uncaptured one: bitwise "
                             f"{captured_bitwise}, launches "
                             f"{uncaptured_launches}")
    if tuple(scores.shape) != (N,) or not bool(torch.isfinite(scores).all()):
        raise AssertionError("scores are not finite of shape (N,)")
    if not torch.equal(scores[:100_000].cpu(), cpu_scores):
        raise AssertionError("card and CPU scoring of one booster differ")
    return out


def step_capture_stats(torch, cfg):
    """The cached captured step of ``cfg``'s fits: the seconds its
    capture took, the histogram launches one replay holds, and its graph
    pool's bytes (the caching allocator's segments of that pool)."""
    from mmlspark_tpu_torch.models.gbdt import step as S

    steps = [st for st in S.cached_steps()
             if st.key is not None and st.key[4] == S._loop_only(cfg)]
    if not steps:
        return {"cached": False}
    st = steps[-1]
    pool = tuple(st.graph.pool())
    segments = torch.cuda.memory_snapshot()
    if segments and "segment_pool_id" in segments[0]:
        pool_bytes = sum(seg["total_size"] for seg in segments
                         if tuple(seg["segment_pool_id"]) == pool)
    else:
        pool_bytes = "not measured"
    return {"cached": True, "capture_s": st.capture_s,
            "launches_per_replay": st.tally, "graph_pool_bytes": pool_bytes,
            "cached_steps": len(S.cached_steps())}


def phase_profile(ctx):
    """Where a bench-shape fit's device time goes: a 5-tree fit under
    torch.profiler (binned matrix already on the card), device time by
    kernel name and the device's idle share of the fit's wall time."""
    import torch

    from mmlspark_tpu_torch import train

    binned, y, bin_upper, cfg = ctx["main_inputs"]
    cfg = dataclasses.replace(cfg, num_iterations=5)
    binned_d = torch.as_tensor(binned.astype(np.uint8), device="cuda")
    out = {"trees": 5}
    # the fit as it runs (each iteration a replay of the cached captured
    # step: CUPTI records every kernel of a replayed graph, so the device
    # time by kernel is read as for eager launches), then the same step
    # uncaptured
    for arm, capture in (("captured", True), ("uncaptured", False)):
        wall_ms, by_name = device_ms_by_kernel(
            torch, lambda: train(binned_d, y, cfg, bin_upper=bin_upper,
                                 capture=capture))
        busy_ms = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        hist_ms = hist_device_ms(by_name)
        out[arm] = {
            "wall_ms": wall_ms,
            "device_busy_ms": busy_ms if busy_ms else "not measured",
            "device_idle_share": 1 - busy_ms / wall_ms if busy_ms
            else "not measured",
            "level_hist_ms": hist_ms,
            "level_hist_share_of_busy": hist_ms / busy_ms if busy_ms
            else "not measured",
            "kernel_names": len(by_name),
            "top_ms": dict(top)}
    if not out["captured"]["level_hist_ms"]:
        raise AssertionError("the profile of the replayed fit holds no "
                             f"histogram kernel: {out['captured']}")
    return out


def phase_card_vs_cpu(ctx):
    from mmlspark_tpu_torch import BinMapper, TrainConfig, train

    x, y = make_data(100_000, seed=1)
    mapper = BinMapper.fit(x, max_bin=255)
    binned = mapper.transform(x)
    cfg = TrainConfig(objective="binary", num_iterations=5, num_leaves=63,
                      max_depth=6, min_data_in_leaf=20)
    res = {dev: train(binned, y, cfg, device=dev) for dev in ("cuda", "cpu")}
    a, b = res["cuda"].booster, res["cpu"].booster
    roots_equal = (np.array_equal(a.split_feature[:, 0], b.split_feature[:, 0])
                   and np.array_equal(a.threshold_bin[:, 0],
                                      b.threshold_bin[:, 0]))
    ll = {dev: r.evals[-1]["train_binary_logloss"] for dev, r in res.items()}
    # the histograms are the same bits on both devices (fixed point); the
    # objective and split finding reduce in another order on the card:
    # float32 rounding only, far below 1e-4 relative
    rel = abs(ll["cuda"] - ll["cpu"]) / abs(ll["cpu"])
    names = ("split_feature", "threshold_bin", "node_value", "count")
    trees_equal = int(sum(all(np.array_equal(getattr(a, k)[t],
                                             getattr(b, k)[t])
                              for k in names)
                          for t in range(a.num_trees)))
    out = {"roots_equal": roots_equal, "trees_equal_in_every_array":
           trees_equal, "trees": a.num_trees, "logloss_cuda": ll["cuda"],
           "logloss_cpu": ll["cpu"], "rel_diff": rel, "tol": 1e-4}
    if not roots_equal or rel > 1e-4:
        raise AssertionError(f"card and CPU fits disagree: {out}")
    return out


def phase_kernel_quant(ctx):
    """Quantized level-histogram kernel vs its plain version at each of
    ``HIST_SHAPES``, q16 and q8, every level width: bitwise, and bitwise
    between two launches on the same inputs."""
    import torch

    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    ctx["quant_rows_by_shape"] = {}
    for name, (n, f) in HIST_SHAPES.items():
        rows = kernel_quant_rows(torch, n, f, name)
        ctx["quant_rows_by_shape"][name] = rows
        if name == "bench":
            ctx["quant_rows"] = rows
        torch.cuda.empty_cache()
    # uint16 ids: q16 at every case, q8 at the bench's 1,023 bins
    ctx["quant_u16"] = {"q16": u16_cases(torch, "q16"),
                        "q8": u16_cases(torch, "q8", cases=[
                            c for c in HIST_U16 if c[0] == "bench"
                            and c[3] == U16_LIBRARY_B])}
    torch.cuda.empty_cache()
    return {"quants": list(QUANTS), "widths": list(WIDTHS),
            "shapes": HIST_SHAPES, "all_bitwise": True,
            "u16_per_tree": {q: u16_summary(c)
                             for q, c in ctx["quant_u16"].items()},
            "window": quant_window_case(torch, H),
            "sass_atomics": quant_sass_atomics()}


def kernel_quant_rows(torch, N, F, shape):
    """Rows by plane of ``level_hist_quant`` against its plain version at
    N rows of F features, every level width (``phase_kernel_quant``)."""
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    binned = torch.randint(0, B, (N, F), generator=gen, device=dev,
                           dtype=torch.uint8)
    live = (torch.rand(N, generator=gen, device=dev) < 0.9).float()
    rows = {}
    for quant, (dtype_name, qmax) in QUANTS.items():
        dtype = getattr(torch, dtype_name)
        # the trainer's quantization of normal grads and uniform hess
        gq = torch.round(torch.randn(N, generator=gen, device=dev)
                         .clamp(-4, 4) * (qmax / 4)).to(dtype)
        hq = torch.round(torch.rand(N, generator=gen, device=dev)
                         * qmax).to(dtype)
        gsi = torch.full((), 2.0 ** -12, device=dev)
        hsi = torch.full((), 2.0 ** -14, device=dev)
        rows[quant] = []
        for width in WIDTHS:
            local = torch.randint(0, width, (N,), generator=gen, device=dev)
            args = (binned, gq, hq, live, local, width, F, B, gsi, hsi)
            k1 = H.level_histogram_quant(*args)
            k2 = H.level_histogram_quant(*args)
            p = H.level_histogram_quant_reference(*args)
            torch.cuda.synchronize()
            bitwise = bool(torch.equal(k1, p))
            repeat = bool(torch.equal(k1, k2))
            err = float((k1 - p).abs().max().item())

            idx = H.flat_index(binned, local, F, B)
            gate = (live > 0).long()
            src = torch.stack([gq.long() * gate, hq.long() * gate, gate],
                              -1)[:, None, :].expand(N, F, 3).reshape(-1, 3)
            kernel_ms = time_ms(torch, lambda: H.level_histogram_quant(*args))
            kernel_device_ms = device_ms(
                torch, lambda: H.level_histogram_quant(*args))
            # one call's device time by kernel: the partition (count, scan,
            # scatter), the histogram, the dequantization, torch's fills
            _, split = device_ms_by_kernel(
                torch, lambda: H.level_histogram_quant(*args))
            plain_ms = time_ms(torch, lambda: H.level_histogram_quant_reference(
                *args))
            library_ms = time_ms(torch, lambda: torch.zeros(
                (width * F * B, 3), dtype=torch.int64,
                device=dev).index_add_(0, idx, src))
            del idx, src
            in_bytes = sum(t.numel() * t.element_size()
                           for t in (binned, gq, hq, live, local))
            out_bytes = width * F * B * 3 * 4
            ops = 3 * F * int(gate.sum().item())
            bytes_ms = (in_bytes + out_bytes) / MEM_BYTES_PER_S * 1e3
            ops_ms = ops / F32_OPS_PER_S * 1e3
            row = {"shape": shape, "n": N, "f": F, "quant": quant,
                   "width": width, "bitwise": bitwise,
                   "repeat_bitwise": repeat, "max_abs_err": err,
                   "kernel_ms": kernel_ms,
                   "kernel_device_ms": kernel_device_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations",
                   "bytes": in_bytes + out_bytes, "ops": ops,
                   "device_ms_by_kernel": split}
            emit({"phase": "kernel_quant_vs_plain", **row})
            rows[quant].append(row)
            if not (bitwise and repeat):
                raise AssertionError(f"level_hist_quant[{quant}] disagrees "
                                     f"at {shape}, width {width}: {row}")
    return rows


def quant_window_case(torch, H):
    """q16 at 40,000,000 rows, F=4, every row +32000 in bin 0: a CTA's run
    in one node passes the W = 65,535 rows an int32 cell holds at
    2^15 per row, so the kernel must flush mid-node; a missed flush wraps.
    Bitwise against the plain version and between two launches, widths 1
    and 2."""
    n, f = 40_000_000, 4
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    binned = torch.zeros((n, f), dtype=torch.uint8, device=dev)
    stat = torch.full((n,), 32000, dtype=torch.int16, device=dev)
    live = torch.ones(n, device=dev)
    gsi = torch.full((), 2.0 ** -12, device=dev)
    out = {"rows": n, "features": f, "window_rows": H.quant_window(16)}
    for width in (1, 2):
        local = torch.randint(0, width, (n,), generator=gen, device=dev)
        args = (binned, stat, stat, live, local, width, f, B, gsi, gsi)
        k1 = H.level_histogram_quant(*args)
        k2 = H.level_histogram_quant(*args)
        p = H.level_histogram_quant_reference(*args)
        torch.cuda.synchronize()
        row = {"bitwise": bool(torch.equal(k1, p)),
               "repeat_bitwise": bool(torch.equal(k1, k2)),
               "grad_sum_bin0": float(k1[0, 0, 0, 0].item()),
               "plain_grad_sum_bin0": float(p[0, 0, 0, 0].item())}
        out[f"width_{width}"] = row
        del p, k1, k2, local
        if not (row["bitwise"] and row["repeat_bitwise"]):
            raise AssertionError(f"level_hist_quant wraps past the int32 "
                                 f"window at width {width}: {row}")
    return out


def quant_sass_atomics():
    """The atomic opcodes in the SASS of the built ``level_hist_quant``
    library (``cuobjdump -sass``): its int32 cells must take native shared
    adds (``ATOMS.ADD``), never a CAS loop (``ATOMS.CAST.SPIN``)."""
    from mmlspark_tpu_torch.native import bindings
    cuobjdump = os.path.join(os.path.dirname(bindings.nvcc_path()),
                             "cuobjdump")
    sass = subprocess.run(
        [cuobjdump, "-sass", str(bindings.library_path("level_hist_quant"))],
        capture_output=True, text=True, timeout=120, check=True).stdout
    atomics = {}
    for op in re.findall(r"\b((?:ATOMS|ATOM|RED)\.[A-Z0-9.]+)", sass):
        atomics[op] = atomics.get(op, 0) + 1
    if "ATOMS.ADD" not in atomics or any("CAS" in op for op in atomics):
        raise AssertionError(f"level_hist_quant's shared adds are not "
                             f"native: {atomics}")
    return atomics


def phase_main_quant(ctx):
    """The bench fit on the quantized plane, and both planes with
    histogram subtraction."""
    import torch

    from mmlspark_tpu_torch import train
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H

    binned, y, bin_upper, cfg = ctx["main_inputs"]
    expected = TREES * cfg.effective_depth
    out = {"card": ctx["smi"]}

    def fit(quant, sub, trees=TREES):
        """One timed fit; the kernels' launches counted from 0."""
        with knobs(quant, sub):
            H.hist_kernel_launches = H.hist_quant_kernel_launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = train(binned, y,
                        dataclasses.replace(cfg, num_iterations=trees),
                        bin_upper=bin_upper)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
        lls = [e["train_binary_logloss"] for e in res.evals]
        if not all(b <= a + 1e-7 for a, b in zip(lls, lls[1:])) \
                or not lls[-1] < lls[0]:
            raise AssertionError(f"{quant}/sub={sub}: training logloss does "
                                 f"not fall: {lls}")
        # the plane and subtraction asked for, no bundles (dense rows), in
        # core (the card has room for the in-core fit)
        want = {"grow_policy": "depthwise", "hist_quant": quant,
                "subtract": sub == "1", "efb_bundles": 0,
                "efb_bundled_features": 0, "ooc": False,
                "ooc_reason": "auto: the in-core fit fits in device memory"}
        if res.hist_stats != want:
            raise AssertionError(f"ran {res.hist_stats}, asked for {want}")
        return res, fit_s, (H.hist_kernel_launches,
                            H.hist_quant_kernel_launches), lls

    # the quantization exponent: the same bits on the card as on the CPU
    # over powers of two (and qmax times them), 3 ulps either side, and
    # no host sync in a call once the threshold table is on the card
    from mmlspark_tpu_torch.models.gbdt.trainer import _pow2_scale
    base = np.float32(np.ldexp(1.0, np.arange(-120, 120)))
    with np.errstate(over="ignore"):
        grid = np.concatenate([base, base * 32000, base * 120])
    grid = grid[np.isfinite(grid) & (grid > 0)]
    steps = [grid]
    for direction in (np.inf, 0):
        g = grid
        for _ in range(3):
            g = np.nextafter(g, np.float32(direction))
            steps.append(g)
    grid = torch.from_numpy(np.unique(np.concatenate(steps)))
    same = True
    for qmax in (32000.0, 120.0):
        card = [t.cpu() for t in _pow2_scale(grid.cuda(), qmax)]
        host = _pow2_scale(grid, qmax)
        same &= all(torch.equal(a, b) for a, b in zip(card, host))
    one = grid[:1].cuda()
    syncs = count_syncs(torch, lambda: _pow2_scale(one, 32000.0))
    out["pow2_scale"] = {"grid_values": int(grid.numel()),
                         "card_equals_cpu": same, "syncs_per_call": syncs}
    if not same or syncs:
        raise AssertionError(f"_pow2_scale on the card: {out['pow2_scale']}")

    ctx["launches"]["level_hist_quant"] = {}
    sub_off = {}
    for quant in QUANTS:
        with knobs(quant, "0"):
            train(binned, y, dataclasses.replace(cfg, num_iterations=1),
                  bin_upper=bin_upper)                     # warm-up
            syncs = {t: count_syncs(torch, lambda t=t: train(
                binned, y, dataclasses.replace(cfg, num_iterations=t),
                bin_upper=bin_upper)) for t in (1, 3)}
        if syncs[1] != syncs[3]:
            raise AssertionError(f"{quant}: host syncs grow with the tree "
                                 f"count: {syncs}")
        first, fit_s, (f32_n, quant_n), lls = fit(quant, "0")
        second, _, _, _ = fit(quant, "0")
        if (f32_n, quant_n) != (0, expected):
            raise AssertionError(f"{quant} fit launched level_hist {f32_n} "
                                 f"and level_hist_quant {quant_n} times, "
                                 f"expected 0 and {expected}")
        reproducible = boosters_equal(first.booster, second.booster)
        if not reproducible:
            raise AssertionError(f"two {quant} fits gave different boosters")
        ctx["launches"]["level_hist_quant"][quant] = quant_n
        sub_off[quant] = first.booster
        out[quant] = {"fit_s": fit_s, "launches": quant_n,
                      "f32_launches": f32_n, "syncs_per_fit": syncs[3],
                      "two_fits_bitwise": reproducible,
                      "logloss_first": lls[0], "logloss_last": lls[-1],
                      "fit_mrow_trees_per_s": N * TREES / fit_s / 1e6}

    # subtraction on, both planes: fit rate, and the kernels' device
    # time per tree (5-tree profiled fits) with subtraction off and on
    for quant in ("off", "q16"):
        res, fit_s, counts, lls = fit(quant, "1")
        launched = counts[1] if quant == "q16" else counts[0]
        if launched != expected:
            raise AssertionError(f"{quant}/sub=1 launched {counts}")
        row = {"fit_s": fit_s, "launches": launched,
               "logloss_last": lls[-1],
               "fit_mrow_trees_per_s": N * TREES / fit_s / 1e6}
        if quant == "q16":
            # the derived sibling is parent - smaller in float32, so node
            # values may move in the last bits where bin sums round
            row["arrays_differing_from_sub_off"] = arrays_differing(
                res.booster, sub_off["q16"])
            row["trees_equal_to_sub_off"] = \
                not row["arrays_differing_from_sub_off"]
        binned_d = torch.as_tensor(binned.astype(np.uint8), device="cuda")
        for sub in ("0", "1"):
            with knobs(quant, sub):
                wall_ms, by_name = device_ms_by_kernel(torch, lambda: train(
                    binned_d, y, dataclasses.replace(cfg, num_iterations=5),
                    bin_upper=bin_upper))
            hist_ms = hist_device_ms(by_name)
            row[f"hist_ms_per_tree_sub{sub}"] = hist_ms / 5
            row[f"profiled_wall_ms_per_tree_sub{sub}"] = wall_ms / 5
        out[f"sub_{quant}"] = row
    return out


# phase sampling_path: the sampled fits at the bench shape, each a
# config of the bench's binary fit
SAMPLED = {
    "bagging": dict(bagging_fraction=0.5, bagging_freq=1),
    "pos_neg": dict(pos_bagging_fraction=0.5, neg_bagging_fraction=0.3,
                    bagging_freq=1),
    "feature_fraction": dict(feature_fraction=0.5),
    "goss": dict(boosting_type="goss"),
    "rf": dict(boosting_type="rf", bagging_fraction=0.5, bagging_freq=1),
}


def logloss(raw, y):
    p = np.clip(1 / (1 + np.exp(-raw.astype(np.float64))), 1e-15, 1 - 1e-15)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log1p(-p)))


def booster_logloss(booster, binned_d, y, trees=None):
    """Logloss of the booster's scores on the card (``tree_score``);
    ``trees``: only the first ones (0: the base score alone), each
    weighted as one tree of ``trees`` where the booster averages its
    trees (rf)."""
    if trees == 0:
        return logloss(np.full(len(y), booster.init_score), y)
    if trees is not None:
        averaged = booster.tree_weights[0] != 1.0
        booster = booster.slice_iterations(0, trees)
        if averaged:
            booster = dataclasses.replace(
                booster, tree_weights=np.full(trees, 1 / trees, np.float32))
    return logloss(booster.predict_binned(binned_d).cpu().numpy(), y)


def phase_sampling(ctx):
    """Bagging, pos/neg bagging, feature_fraction, GOSS and rf at the
    bench shape (2M x 28, 20 trees), on the float32 and the q8 plane:
    two fits bitwise equal, 120 histogram launches each through the
    replays of the captured step, the loss of the booster falling from
    its first tree to all 20, and the fit's wall; each histogram kernel
    against its plain version on a bagged ``live`` (every level width)
    and on GOSS-amplified grads (q8 under the fit's shared scales); the
    rf booster's ``tree_score`` (weights 1/20) against its plain
    version; and each sampled fit on the card against the CPU at
    ``card_vs_cpu``'s size."""
    import torch

    from mmlspark_tpu_torch import BinMapper, train
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.models.gbdt import objectives, sampling
    from mmlspark_tpu_torch.models.gbdt import score_cuda as S
    from mmlspark_tpu_torch.models.gbdt.trainer import _pow2_scale

    binned, y, bin_upper, cfg = ctx["main_inputs"]
    binned_d = torch.as_tensor(binned.astype(np.uint8), device="cuda")
    expected = TREES * cfg.effective_depth
    out, failures = {"card": ctx["smi"]}, []
    launches = {"level_hist": 0, "level_hist_quant": 0}
    boosters = {}
    for quant in ("off", "q8"):
        for name, kw in SAMPLED.items():
            c = dataclasses.replace(cfg, **kw)
            fits = []
            for _ in range(2):
                with knobs(quant, "0"):
                    H.hist_kernel_launches = H.hist_quant_kernel_launches = 0
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = train(binned, y, c, bin_upper=bin_upper)
                    torch.cuda.synchronize()
                    fits.append((res, time.perf_counter() - t0,
                                 H.hist_kernel_launches,
                                 H.hist_quant_kernel_launches))
            (a, fit_s, f32_n, q_n), (b, again_s, _, _) = fits
            launched = q_n if quant == "q8" else f32_n
            launches["level_hist_quant" if quant == "q8"
                     else "level_hist"] += launched
            # the loss falls: from the first tree to all 20 (rf, whose
            # trees each fit the base score: from the base score alone)
            first = booster_logloss(a.booster, binned_d, y,
                                    trees=0 if name == "rf" else 1)
            last = booster_logloss(a.booster, binned_d, y)
            row = {"fit_s": fit_s, "second_fit_s": again_s,
                   "launches": launched,
                   "other_plane_launches": f32_n if quant == "q8" else q_n,
                   "step": a.step_stats,
                   "two_fits_bitwise": boosters_equal(a.booster, b.booster),
                   "logloss_first": first, "logloss_all": last,
                   "tree_weights": sorted(set(a.booster.tree_weights
                                              .tolist()))}
            out[f"{name}[{quant}]"] = row
            boosters[(name, quant)] = a.booster
            if not (row["two_fits_bitwise"] and launched == expected
                    and row["other_plane_launches"] == 0
                    and a.step_stats["captured"] and last < first):
                failures.append(f"{name}[{quant}]: {row}")
    ctx["launches"]["sampling_path"] = launches

    # the kernels on the sampled path's inputs: a bag as live, and GOSS
    # grads (amplified rows, the rest zero) quantized as build_tree does
    n = binned_d.shape[0]
    bag_cfg = dataclasses.replace(cfg, **SAMPLED["bagging"])
    bag = sampling.bag_mask(sampling.draw(sampling.bag_keys(bag_cfg, 0), n,
                                          "cuda"),
                            torch.zeros(n, device="cuda"), bag_cfg)
    labels = torch.as_tensor(y, dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    # grads at spread scores, so |g| has a real top-rate quantile
    g, h = objectives.binary(torch.randn(n, generator=gen, device="cuda"),
                             labels)
    goss_cfg = dataclasses.replace(cfg, boosting_type="goss")
    mult = sampling.goss_mult(g, sampling.draw(
        sampling.goss_keys(goss_cfg, 0), n, "cuda"), None, goss_cfg)
    keep = (mult > 0).float()
    gg, hh = g * mult, h * mult
    gs, gsi = _pow2_scale(torch.max(torch.abs(gg)), 120.0)
    hs, hsi = _pow2_scale(torch.max(torch.abs(hh)), 120.0)
    gq = torch.round(gg * gs).to(torch.int8)
    hq = torch.round(hh * hs).to(torch.int8)
    kernels = {}
    for width in WIDTHS:
        local = torch.randint(0, width, (n,), generator=gen, device="cuda")
        args = (width, F, B)
        cases = {
            "level_hist[bagged live]": (
                lambda: H.level_histogram(binned_d, gg, hh, bag, local,
                                          *args),
                lambda: H.level_histogram_reference(binned_d, gg, hh, bag,
                                                    local, *args)),
            "level_hist[goss grads]": (
                lambda: H.level_histogram(binned_d, gg, hh, keep, local,
                                          *args),
                lambda: H.level_histogram_reference(binned_d, gg, hh, keep,
                                                    local, *args)),
            "level_hist_quant[q8, goss grads]": (
                lambda: H.level_histogram_quant(binned_d, gq, hq, keep,
                                                local, *args, gsi, hsi),
                lambda: H.level_histogram_quant_reference(
                    binned_d, gq, hq, keep, local, *args, gsi, hsi)),
            "level_hist_quant[q8, bagged live]": (
                lambda: H.level_histogram_quant(binned_d, gq, hq, bag,
                                                local, *args, gsi, hsi),
                lambda: H.level_histogram_quant_reference(
                    binned_d, gq, hq, bag, local, *args, gsi, hsi)),
        }
        for label, (kernel, plain) in cases.items():
            got, again, want = kernel(), kernel(), plain()
            ok = bool(torch.equal(got, want) and torch.equal(got, again))
            err = float((got - want).abs().max().item())
            row = kernels.setdefault(label, {"bitwise": True,
                                             "max_abs_err": 0.0})
            row["bitwise"] &= ok
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if not ok:
                failures.append(f"{label} at width {width}: err {err}")
    kernels["bag_kept_share"] = float(bag.mean().item())
    kernels["goss_kept_share"] = float(keep.mean().item())
    if not 0.2 <= kernels["goss_kept_share"] < 0.5:
        failures.append(f"GOSS kept {kernels['goss_kept_share']} of the "
                        f"rows; expected about 0.2 + 0.8 * 0.125")
    out["kernels_vs_plain"] = kernels

    # rf's transform: tree_score with weights 1/20 against its plain version
    rf = boosters[("rf", "off")]
    tables = rf._scorer(False, "off", "cuda").tables
    S.tree_score_launches = 0
    got = S.tree_score(binned_d, tables)
    rf_launches = S.tree_score_launches
    want = S.tree_score_reference(binned_d, tables)
    rf_ok = bool(torch.equal(got, want))
    out["rf_tree_score"] = {"bitwise": rf_ok, "launches": rf_launches,
                            "max_abs_err": float((got - want).abs().max()
                                                 .item()),
                            "tree_weights": sorted(set(
                                rf.tree_weights.tolist()))}
    ctx["rf_score_err"] = out["rf_tree_score"]["max_abs_err"]
    if not rf_ok or rf_launches != 1:
        failures.append(f"rf tree_score: {out['rf_tree_score']}")

    # card vs CPU at card_vs_cpu's size: the histograms are the same bits
    # on both devices and so are the draws; the objective and split
    # finding reduce in other orders, so roots equal and the loss within
    # 1e-4 relative, as card_vs_cpu holds the unsampled fit
    x, yc = make_data(100_000, seed=1)
    bc = BinMapper.fit(x, max_bin=255).transform(x)
    bcd = torch.as_tensor(bc.astype(np.uint8), device="cuda")
    vs = {}
    for name, kw in SAMPLED.items():
        c = dataclasses.replace(cfg, num_iterations=5, **kw)
        res = {dev: train(bc, yc, c, device=dev) for dev in ("cuda", "cpu")}
        a, b = res["cuda"].booster, res["cpu"].booster
        roots = (np.array_equal(a.split_feature[:, 0], b.split_feature[:, 0])
                 and np.array_equal(a.threshold_bin[:, 0],
                                    b.threshold_bin[:, 0]))
        lla = booster_logloss(a, bcd, yc)
        llb = booster_logloss(b, bcd, yc)
        vs[name] = {"roots_equal": roots, "logloss_cuda": lla,
                    "logloss_cpu": llb, "rel_diff": abs(lla - llb) / llb}
        if not roots or vs[name]["rel_diff"] > 1e-4:
            failures.append(f"card vs CPU {name}: {vs[name]}")
    out["card_vs_cpu"] = vs
    if failures:
        raise AssertionError(f"sampling_path: {failures}")
    return out


def phase_card_vs_cpu_quant(ctx):
    from mmlspark_tpu_torch import BinMapper, TrainConfig, train

    x, y = make_data(100_000, seed=1)
    mapper = BinMapper.fit(x, max_bin=255)
    binned = mapper.transform(x)
    cfg = TrainConfig(objective="binary", num_iterations=5, num_leaves=63,
                      max_depth=6, min_data_in_leaf=20)
    with knobs("q16", "0"):
        res = {dev: train(binned, y, cfg, device=dev)
               for dev in ("cuda", "cpu")}
    a, b = res["cuda"].booster, res["cpu"].booster
    roots_equal = (np.array_equal(a.split_feature[:, 0], b.split_feature[:, 0])
                   and np.array_equal(a.threshold_bin[:, 0],
                                      b.threshold_bin[:, 0]))
    names = ("split_feature", "threshold_bin", "node_value", "count")
    trees_equal = int(sum(all(np.array_equal(getattr(a, k)[t],
                                             getattr(b, k)[t])
                              for k in names)
                          for t in range(a.num_trees)))
    ll = {dev: r.evals[-1]["train_binary_logloss"] for dev, r in res.items()}
    rel = abs(ll["cuda"] - ll["cpu"]) / abs(ll["cpu"])
    out = {"roots_equal": roots_equal, "trees_equal_in_every_array":
           trees_equal, "trees": a.num_trees, "logloss_cuda": ll["cuda"],
           "logloss_cpu": ll["cpu"], "rel_diff": rel, "tol": 1e-4,
           "note": "histograms are exact integers on both devices and "
                   "the scales the same bits; the objective and split "
                   "finding may differ by an ulp between devices, so full "
                   "equality is not required"}
    if not roots_equal or rel > 1e-4:
        raise AssertionError(f"card and CPU q16 fits disagree: {out}")
    return out


def replay_stop_rule(values, esr, higher_better):
    """The early-stopping rule over one metric's per-iteration values,
    written out here apart from the port's: (best iteration, iterations
    run), the second None while the rule has not fired."""
    best, best_j, since = None, -1, 0
    for j, v in enumerate(values):
        if best is None or (v > best if higher_better else v < best):
            best, best_j, since = v, j, 0
        else:
            since += 1
            if since >= esr:
                return best_j, j + 1
    return best_j, None


def phase_estimator(ctx):
    """The estimator layer at the bench shape: ``LightGBMClassifier``
    fit and transform over a ``DataFrame`` of the 2M HIGGS-shaped rows,
    held to a direct ``train`` on the same mapper, its transforms to
    ``booster.predict`` and the numpy tail; early stopping, q16 and card
    vs CPU."""
    import tempfile

    import torch

    from mmlspark_tpu_torch import (BinMapper, DataFrame, LightGBMClassifier,
                                    TrainConfig, train)
    from mmlspark_tpu_torch.core.pipeline import PipelineStage
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.models.gbdt import score_cuda as S

    x, y = make_data(N)
    df = DataFrame({"features": x, "label": y})
    params = dict(numIterations=TREES, numLeaves=63, maxDepth=6,
                  minDataInLeaf=20, maxBin=255)
    est = LightGBMClassifier(**params)
    est.fit(DataFrame({"features": x[:10_000], "label": y[:10_000]}))
    out = {"card": ctx["smi"]}

    torch.cuda.synchronize()
    H.hist_kernel_launches = H.hist_quant_kernel_launches = 0
    t0 = time.perf_counter()
    model = est.fit(df)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = (H.hist_kernel_launches, H.hist_quant_kernel_launches)
    phases = model.get_all_instrumentation()
    train_s = sum(phases.get(k, 0.0) for k in
                  ("dataPreparation", "training", "validation"))
    out.update({
        "fit_s": fit_s, "extract_s": phases.get("extract"),
        "binning_s": phases.get("binning"), "train_s": train_s,
        "other_s": fit_s - phases.get("extract", 0.0)
        - phases.get("binning", 0.0) - train_s,
        "fit_mrow_trees_per_s": N * TREES / fit_s / 1e6,
        "train_mrow_trees_per_s": N * TREES / train_s / 1e6,
        "main_path_train_mrow_trees_per_s": ctx["main_fit_rate"],
        "launches": launches[0], "quant_launches": launches[1]})
    ctx["launches"]["estimator_path"] = launches[0]
    # the fit's binning runs the port's C++ (native/data_plane.cpp): bit
    # for bit its numpy version on the 2M rows, each timed alone
    t0 = time.perf_counter()
    ids = model.bin_mapper.transform(x, np.uint8)
    cpp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = np.concatenate([
        model.bin_mapper._transform_python(np.asarray(x[s:s + 65536],
                                                      np.float64))
        for s in range(0, N, 65536)])
    numpy_s = time.perf_counter() - t0
    out["binning"] = {"cpp_s": cpp_s, "numpy_s": numpy_s,
                      "cpp_bitwise_numpy": bool(np.array_equal(ids, plain)),
                      "host_cpus": len(os.sched_getaffinity(0))}
    del ids, plain
    if not out["binning"]["cpp_bitwise_numpy"]:
        raise AssertionError("the C++ binning differs from its numpy "
                             "version on the 2M rows")
    expected = TREES * 6
    if launches != (expected, 0):
        raise AssertionError(f"the estimator fit launched level_hist and "
                             f"level_hist_quant {launches} times, expected "
                             f"({expected}, 0)")

    # the same mapper and a direct train: the same booster bit for bit
    x64 = x.astype(np.float64)
    sample = x64 if N <= 200_000 else x64[np.random.default_rng(0).choice(
        N, 200_000, replace=False)]
    mapper = BinMapper.fit(sample, max_bin=255)
    if any(not np.array_equal(a, b) for a, b in
           zip(mapper.upper_edges, model.bin_mapper.upper_edges)):
        raise AssertionError("the estimator's BinMapper is not the one "
                             "fitted on its row sample")
    cfg = TrainConfig(objective="binary", num_iterations=TREES,
                      num_leaves=63, max_depth=6, min_data_in_leaf=20)
    direct = train(mapper.transform(x64), y, cfg,
                   bin_upper=mapper.bin_upper_values(255)).booster
    del x64, sample
    differing = arrays_differing(model.booster, direct)
    out["arrays_differing_from_direct_train"] = differing
    if differing:
        raise AssertionError(f"the estimator's booster differs from a "
                             f"direct train in {differing}")

    # transform: raw scores on the card, then the numpy tail
    frame = DataFrame({"features": x})
    model.transform(DataFrame({"features": x[:1000]}))     # warm-up
    torch.cuda.synchronize()
    S.tree_score_launches = 0
    t0 = time.perf_counter()
    scored = model.transform(frame)
    out["transform_s"] = time.perf_counter() - t0
    out["transform_tree_score_launches"] = S.tree_score_launches
    if not S.tree_score_launches:
        raise AssertionError("the transform launched no tree_score kernel")
    out["transform_mrow_trees_per_s"] = N * TREES / out["transform_s"] / 1e6
    raw = model.booster.predict(x).cpu().numpy()
    prob = 1.0 / (1.0 + np.exp(-raw))
    probs = np.stack([1 - prob, prob], axis=1)
    pred = model.classes_[np.argmax(probs, axis=1)].astype(np.float64)
    tail_bitwise = (np.array_equal(scored["probability"], probs)
                    and np.array_equal(scored["prediction"], pred))
    # binnedScoring routes as training did (float64 x <= edge, by bin
    # ids); raw scoring compares float32(x) with float32(edge), as the
    # JAX package's predict does, which is the same where each of a
    # row's float32 bins (searchsorted on the float32 edges) is its bin:
    # bitwise on those rows, and binned bitwise to predict_binned + tail
    binned_scored = model.copy(binnedScoring=True).transform(frame)
    bins = model.bin_mapper.transform(x)
    bins32 = np.stack([np.searchsorted(e.astype(np.float32), x[:, f],
                                       side="left") + 1
                       for f, e in enumerate(model.bin_mapper.upper_edges)],
                      axis=1)
    ambiguous = (bins32 != bins).any(axis=1)
    braw = model.booster.predict_binned(bins.astype(np.uint8)).cpu().numpy()
    bprob = 1.0 / (1.0 + np.exp(-braw))
    differ = np.zeros(N, bool)
    for c in ("rawPrediction", "probability", "prediction"):
        ne = binned_scored[c] != scored[c]
        differ |= ne.any(axis=1) if ne.ndim == 2 else ne
    binned_bitwise = (not (differ & ~ambiguous).any()
                      and np.array_equal(binned_scored["probability"][:, 1],
                                         bprob))
    out["binned_vs_raw"] = {
        "rows_with_a_float32_bin_change": int(ambiguous.sum()),
        "rows_scored_differently": int(differ.sum())}
    del bins, bins32
    with tempfile.TemporaryDirectory() as tmp:
        model.save(os.path.join(tmp, "model"))
        loaded = PipelineStage.load(os.path.join(tmp, "model"))
    reloaded = loaded.transform(frame)
    load_bitwise = all(np.array_equal(reloaded[c], scored[c])
                       for c in scored.columns)
    out.update({"transform_is_predict_and_tail": tail_bitwise,
                "binned_transform_bitwise_where_bins_agree": binned_bitwise,
                "saved_and_loaded_transform_bitwise": load_bitwise,
                "loaded_model_device": str(loaded._device)})
    if not (tail_bitwise and binned_bitwise and load_bitwise):
        raise AssertionError(f"transforms differ: {out}")
    del scored, binned_scored, reloaded

    # early stopping: 10% of the rows validate, learning rate 1.0
    valid = np.random.default_rng(2).random(N) < 0.1
    es_params = dict(params, numIterations=60, learningRate=1.0,
                     validationIndicatorCol="valid")
    vdf = df.with_column("valid", valid)
    flat = count_syncs(torch, lambda: LightGBMClassifier(
        **dict(es_params, numIterations=3)).fit(vdf))
    es = LightGBMClassifier(**es_params, earlyStoppingRound=5)
    es_model = None

    def fit_es():
        nonlocal es_model
        es_model = es.fit(vdf)

    es_syncs = count_syncs(torch, fit_es)
    evals = es_model.evals_result
    vals = [e["valid0_binary_logloss"] for e in evals]
    replay_best, replay_stop = replay_stop_rule(vals, 5, False)
    best = es_model.best_iteration
    turned = replay_stop is not None
    # trees are cut after the best iteration whether or not the rule fired
    kept_ok = es_model.booster.num_trees == best + 1
    out["early_stopping"] = {
        "best_iteration": best, "replayed_best_iteration": replay_best,
        "iterations_run": len(evals), "trees_kept": es_model.booster.num_trees,
        "metric_turned": turned,
        "note": None if turned else "the validation logloss never turned "
                                    "at this shape; the replay still holds",
        "syncs": es_syncs, "syncs_without_early_stopping": flat,
        "sync_limit": flat + -(-60 // 8),  # one sync per block of 8
        "valid_logloss_first": vals[0], "valid_logloss_best": vals[best]}
    limit = flat + -(-60 // 8)
    if (replay_best != best or not kept_ok or es_syncs > limit
            or len(evals) != (replay_stop if turned else 60)):
        raise AssertionError(f"early stopping: {out['early_stopping']}")
    del es_model, vdf

    # q16: the quantized kernel on every level, two fits bitwise equal
    with knobs("q16", "0"):
        H.hist_kernel_launches = H.hist_quant_kernel_launches = 0
        q1 = est.fit(df)
        q_launches = (H.hist_kernel_launches, H.hist_quant_kernel_launches)
        q2 = est.fit(df)
    q_bitwise = boosters_equal(q1.booster, q2.booster)
    out["q16"] = {"launches": q_launches[1], "f32_launches": q_launches[0],
                  "two_fits_bitwise": q_bitwise}
    ctx["launches"]["estimator_path_q16"] = q_launches[1]
    if q_launches != (0, expected) or not q_bitwise:
        raise AssertionError(f"q16 estimator fits: {out['q16']}")

    # card vs CPU on a 100,000-row slice, 5 trees
    small = DataFrame({"features": x[:100_000], "label": y[:100_000]})
    small_params = dict(params, numIterations=5)
    res = {dev: LightGBMClassifier(**small_params).set_device(dev).fit(small)
           for dev in ("cuda", "cpu")}
    a, b = res["cuda"].booster, res["cpu"].booster
    roots_equal = (np.array_equal(a.split_feature[:, 0], b.split_feature[:, 0])
                   and np.array_equal(a.threshold_bin[:, 0],
                                      b.threshold_bin[:, 0]))
    ll = {dev: m.evals_result[-1]["train_binary_logloss"]
          for dev, m in res.items()}
    rel = abs(ll["cuda"] - ll["cpu"]) / abs(ll["cpu"])
    out["card_vs_cpu"] = {"roots_equal": roots_equal, "logloss_cuda":
                          ll["cuda"], "logloss_cpu": ll["cpu"],
                          "rel_diff": rel, "tol": 1e-4}
    if not roots_equal or rel > 1e-4:
        raise AssertionError(f"card and CPU estimator fits disagree: "
                             f"{out['card_vs_cpu']}")
    return out


# the regression objectives of LightGBMRegressor at the bench width, each
# with the labels it models: continuous values, counts, positive reals
OBJECTIVES = (("regression_l1", "continuous"), ("huber", "continuous"),
              ("fair", "continuous"), ("poisson", "counts"),
              ("quantile", "continuous"), ("mape", "continuous"),
              ("gamma", "positive"), ("tweedie", "counts"))
# objectives whose default metric is l2 of the raw (log-scale) score
# against the labels, as in the JAX package: it need not fall
LOG_SCALE_L2 = ("gamma", "tweedie")
ALPHA, RHO, FAIR_C = 0.9, 1.5, 1.0      # LightGBMRegressor's defaults


def objective_labels(x, kind, seed):
    """Labels for a regression objective from the bench rows' signal."""
    rng = np.random.default_rng(seed)
    core = (x[:, 0] * 1.2 - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
            + 0.3 * np.sin(x[:, 4] * 3)).astype(np.float64)
    if kind == "continuous":
        return core + 0.5 * rng.normal(size=len(x))
    clipped = np.clip(core, -3.0, 3.0)
    if kind == "counts":
        return rng.poisson(np.exp(0.5 * clipped)).astype(np.float64)
    return rng.gamma(2.0, np.exp(0.3 * clipped) / 2.0)


def objective_loss(name, raw, y):
    """The mean loss whose gradient each objective is, written out here
    apart from the port (float64 on the host)."""
    raw = np.asarray(raw, np.float64)
    d = raw - y
    a = np.abs(d)
    if name == "regression_l1":
        loss = a
    elif name == "huber":
        loss = np.where(a <= ALPHA, 0.5 * d * d, ALPHA * (a - 0.5 * ALPHA))
    elif name == "fair":
        loss = FAIR_C ** 2 * (a / FAIR_C - np.log1p(a / FAIR_C))
    elif name == "poisson":
        loss = np.exp(raw) - y * raw
    elif name == "quantile":
        loss = np.maximum(ALPHA * -d, (ALPHA - 1) * -d)
    elif name == "mape":
        loss = a / np.maximum(np.abs(y), 1.0)
    elif name == "gamma":
        loss = y * np.exp(-raw) + raw
    else:
        loss = (-y * np.exp((1 - RHO) * raw) / (1 - RHO)
                + np.exp((2 - RHO) * raw) / (2 - RHO))
    return float(loss.mean())


def phase_objectives(ctx):
    """``LightGBMRegressor`` fit and transform under each regression
    objective at the bench width (2M x 28, max_bin 255, 63 leaves,
    depth 6, 20 trees): level_hist launches, the metric and the
    objective's own loss over the trees, two fits bitwise equal, one
    tree_score launch per transform, log-link predictions, and card vs
    CPU on 100,000 rows."""
    import torch

    from mmlspark_tpu_torch import DataFrame, LightGBMRegressor
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.models.gbdt import objectives as O
    from mmlspark_tpu_torch.models.gbdt import score_cuda as S
    from mmlspark_tpu_torch.models.gbdt import trainer as T

    x, _ = make_data(N)
    params = dict(numIterations=TREES, numLeaves=63, maxDepth=6,
                  minDataInLeaf=20, maxBin=255)
    expected = TREES * 6
    out = {"card": ctx["smi"], "objectives": {}}
    launches = {"level_hist": 0, "tree_score": 0}
    for i, (name, kind) in enumerate(OBJECTIVES):
        y = objective_labels(x, kind, seed=10 + i)
        df = DataFrame({"features": x, "label": y})
        est = LightGBMRegressor(objective=name, **params)
        torch.cuda.synchronize()
        H.hist_kernel_launches = H.hist_quant_kernel_launches = 0
        t0 = time.perf_counter()
        model = est.fit(df)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = (H.hist_kernel_launches, H.hist_quant_kernel_launches)
        launches["level_hist"] += fit_launches[0]
        again = est.fit(df)
        phases = model.get_all_instrumentation()
        train_s = sum(phases.get(k, 0.0) for k in
                      ("dataPreparation", "training", "validation"))
        # the objective's device time per call on the fit's first scores
        cfg = T.TrainConfig(objective=name, alpha=ALPHA,
                            tweedie_variance_power=RHO)
        kw = T._objective_kwargs(cfg)
        fn = O.get_objective(name)
        raw0 = torch.full((N,), model.booster.init_score,
                          dtype=torch.float32, device="cuda")
        y_d = torch.as_tensor(y, dtype=torch.float32, device="cuda")
        obj_ms = time_ms(torch, lambda: fn(raw0, y_d, None, **kw))
        metric = [k for k in model.evals_result[0] if k != "iteration"][0]
        m_first = model.evals_result[0][metric]
        m_last = model.evals_result[-1][metric]

        frame = DataFrame({"features": x})
        torch.cuda.synchronize()
        S.tree_score_launches = 0
        t0 = time.perf_counter()
        pred = model.transform(frame)["prediction"]
        transform_s = time.perf_counter() - t0
        score_launches = S.tree_score_launches
        launches["tree_score"] += score_launches
        raw = model.booster.predict(x).cpu().numpy()
        raw1 = model.booster.slice_iterations(0, 1).predict(x).cpu().numpy()
        log_link = name in ("poisson", "gamma", "tweedie")
        want = np.exp(raw) if log_link else raw
        link_ok = bool(np.array_equal(pred, want.astype(np.float64))
                       and (not log_link or (pred > 0).all()))
        loss_1, loss_20 = (objective_loss(name, r, y) for r in (raw1, raw))

        # card vs CPU on the first 100,000 rows, 5 trees
        small = DataFrame({"features": x[:100_000], "label": y[:100_000]})
        res = {dev: LightGBMRegressor(objective=name, **dict(
            params, numIterations=5)).set_device(dev).fit(small)
            for dev in ("cuda", "cpu")}
        a, b = res["cuda"].booster, res["cpu"].booster
        roots_equal = bool(
            np.array_equal(a.split_feature[:, 0], b.split_feature[:, 0])
            and np.array_equal(a.threshold_bin[:, 0], b.threshold_bin[:, 0]))
        mv = {dev: r.evals_result[-1][metric] for dev, r in res.items()}
        rel = abs(mv["cuda"] - mv["cpu"]) / abs(mv["cpu"])
        row = {
            "labels": kind, "fit_s": fit_s, "train_s": train_s,
            "binning_s": phases.get("binning"),
            "objective_ms_per_call": obj_ms,
            "objective_share_of_train": TREES * obj_ms / 1e3 / train_s,
            "launches": fit_launches[0], "quant_launches": fit_launches[1],
            "metric": metric, "metric_first": m_first, "metric_last": m_last,
            "loss_tree1": loss_1, "loss_tree20": loss_20,
            "two_fits_bitwise": boosters_equal(model.booster, again.booster),
            "transform_s": transform_s,
            "transform_tree_score_launches": score_launches,
            "prediction_is_link_of_raw": link_ok,
            "card_vs_cpu": {"roots_equal": roots_equal,
                            "metric_cuda": mv["cuda"], "metric_cpu": mv["cpu"],
                            "rel_diff": rel, "tol": 1e-4}}
        out["objectives"][name] = row
        falls = (name in LOG_SCALE_L2 or m_last < m_first) \
            and loss_20 < loss_1
        if (fit_launches != (expected, 0) or not falls
                or not row["two_fits_bitwise"] or score_launches != 1
                or not link_ok or not roots_equal or rel > 1e-4
                or not np.isfinite(pred).all() or pred.shape != (N,)):
            raise AssertionError(f"objective {name}: {row}")
        del df, model, again, pred, raw, raw1, res, y_d, raw0
    ctx["launches"]["objectives_path"] = launches["level_hist"]
    ctx["launches"]["objectives_path_tree_score"] = launches["tree_score"]
    out["launches"] = launches
    return out


def phase_custom_objective(ctx):
    """Custom objectives at the bench width: a torch ``fobj`` calling the
    port's own huber against ``objective="huber"``, and a numpy ``fobj``
    (L2 through ``.cpu().numpy()``) against ``objective="regression"`` —
    bitwise — with the numpy fit's wall and host syncs per tree against
    the built-in fit's."""
    import torch

    from mmlspark_tpu_torch import DataFrame, LightGBMRegressor
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.models.gbdt import objectives as O

    x, _ = make_data(N)
    y = objective_labels(x, "continuous", seed=30)
    df = DataFrame({"features": x, "label": y})
    params = dict(numIterations=TREES, numLeaves=63, maxDepth=6,
                  minDataInLeaf=20, maxBin=255)

    def torch_huber(preds, labels, weights):
        return O.huber(preds, labels, weights, alpha=0.9)

    def numpy_l2(preds, labels, weights):
        p = preds.cpu().numpy()
        return p - labels.cpu().numpy(), np.ones_like(p)

    def fit(**kw):
        """(model, wall s, level_hist launches) of one fit."""
        torch.cuda.synchronize()
        H.hist_kernel_launches = 0
        t0 = time.perf_counter()
        model = LightGBMRegressor(**params, **kw).fit(df)
        torch.cuda.synchronize()
        return model, time.perf_counter() - t0, H.hist_kernel_launches

    huber, huber_s, huber_n = fit(objective="huber")
    custom, custom_s, custom_n = fit(fobj=torch_huber)
    l2, l2_s, l2_n = fit()
    npy, npy_s, npy_n = fit(fobj=numpy_l2)
    syncs = {k: count_syncs(torch, lambda: LightGBMRegressor(
        **dict(params, numIterations=3), **kw).fit(df))
        for k, kw in (("builtin", {}), ("numpy_fobj", {"fobj": numpy_l2}))}
    ctx["launches"]["custom_objective_path"] = custom_n + npy_n
    out = {
        "card": ctx["smi"],
        "torch_fobj_bitwise_huber": boosters_equal(custom.booster,
                                                   huber.booster),
        "numpy_fobj_bitwise_l2": boosters_equal(npy.booster, l2.booster),
        "fit_s": {"huber": huber_s, "torch_fobj_huber": custom_s,
                  "regression": l2_s, "numpy_fobj_l2": npy_s},
        "launches": {"huber": huber_n, "torch_fobj_huber": custom_n,
                     "regression": l2_n, "numpy_fobj_l2": npy_n},
        "syncs_3_trees": syncs,
        "numpy_fobj_syncs_per_tree": (syncs["numpy_fobj"]
                                      - syncs["builtin"]) / 3}
    if not (out["torch_fobj_bitwise_huber"] and out["numpy_fobj_bitwise_l2"]
            and set(out["launches"].values()) == {TREES * 6}):
        raise AssertionError(f"custom objectives: {out}")
    return out


def phase_checkpoint(ctx):
    """Checkpointed fits at the bench width (interval 5, 20 trees): an
    uninterrupted one; one killed by an armed ``gbdt.train_step`` raise at
    hit 11 and resumed (bitwise); one resumed past a flipped byte in the
    newest checkpoint (falls back a generation, bitwise); the monolithic
    fit beside them with the rows that route apart (ROADMAP C3); each
    segment's write + crc time; an unarmed fault point's cost."""
    import tempfile

    import torch

    from mmlspark_tpu_torch import DataFrame, LightGBMRegressor
    from mmlspark_tpu_torch.core import faults, serialize
    from mmlspark_tpu_torch.core.logging_utils import SINK, reset_warn_once
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H

    x, _ = make_data(N)
    y = objective_labels(x, "continuous", seed=40)
    df = DataFrame({"features": x, "label": y})
    params = dict(numIterations=TREES, numLeaves=63, maxDepth=6,
                  minDataInLeaf=20, maxBin=255, checkpointInterval=5)
    writes = []
    real_write = serialize.atomic_write

    def timed_write(path, data, mode="w"):
        t0 = time.perf_counter()
        real_write(path, data, mode)
        writes.append((os.path.basename(path), t0, time.perf_counter()))

    def fit(ckdir, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = LightGBMRegressor(**dict(params, **kw),
                                  checkpointDir=ckdir).fit(df)
        torch.cuda.synchronize()
        return model, time.perf_counter() - t0

    def listing(ckdir):
        return sorted(os.listdir(ckdir))

    out = {"card": ctx["smi"]}
    with tempfile.TemporaryDirectory() as tmp:
        # monolithic, then uninterrupted with each write timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mono = LightGBMRegressor(**{k: v for k, v in params.items()
                                    if k != "checkpointInterval"}).fit(df)
        torch.cuda.synchronize()
        mono_s = time.perf_counter() - t0
        serialize.atomic_write = timed_write
        H.hist_kernel_launches = 0
        try:
            full, full_s = fit(os.path.join(tmp, "full"))
        finally:
            serialize.atomic_write = real_write
        full_launches = H.hist_kernel_launches
        ctx["launches"]["checkpoint_path"] = full_launches
        starts = {name: t for name, t, _ in writes}
        ends = {name: t for name, _, t in writes}
        seg_ms = {n: (ends[f"checkpoint_{n}.txt.crc32"]
                      - starts[f"checkpoint_{n}.txt"]) * 1e3
                  for n in (5, 10, 15, 20)}
        # killed at hit 11 (the first iteration of the third segment)
        ck = os.path.join(tmp, "killed")
        killed = False
        try:
            with faults.injected("gbdt.train_step", "raise", nth=11):
                fit(ck)
        except faults.FaultInjected:
            killed = True
        after_kill = listing(ck)
        resumed, resumed_s = fit(ck)
        # a flipped byte in the newest checkpoint: back to checkpoint 5
        rot = os.path.join(tmp, "rot")
        fit(rot, numIterations=10)
        path = os.path.join(rot, "checkpoint_10.txt")
        raw = bytearray(open(path, "rb").read())
        raw[-16] ^= 0x01
        open(path, "wb").write(bytes(raw))
        latest = LightGBMRegressor._latest_checkpoint(rot)
        reset_warn_once()
        SINK.drain()
        rotted, _ = fit(rot)
        warned = [e["key"] for e in SINK.drain()
                  if e.get("event") == "degradation"]
    # the rows whose float32 bins are not their bins route apart between
    # a resumed segment's raw-threshold warm start and the binned fit
    m = mono.bin_mapper
    bins = m.transform(x)
    bins32 = np.stack([np.searchsorted(e.astype(np.float32), x[:, f],
                                       side="left") + 1
                       for f, e in enumerate(m.upper_edges)], axis=1)
    apart = int((bins32 != bins).any(axis=1).sum())
    del bins, bins32
    mono_equal = boosters_equal(full.booster, mono.booster)

    def same_model(a, b):
        """A resumed fit against the uninterrupted one: the model string
        and every array but ``threshold_bin``, which trees loaded from a
        model string do not carry (in both packages)."""
        return (a.get_model_string() == b.get_model_string()
                and arrays_differing(a.booster, b.booster)
                in ([], ["threshold_bin"]))
    # an armed corrupt on the card: torch ops on the histogram's device,
    # no host sync beyond a clean fit's; zeroed histograms split nothing
    small = dict(params, numIterations=3)
    small.pop("checkpointInterval")
    clean_syncs = count_syncs(torch, lambda: LightGBMRegressor(
        **small).fit(df))
    broken = {}

    def corrupted_fit():
        with faults.injected("gbdt.level_hist", "corrupt", count=None,
                             corrupt=torch.zeros_like):
            broken["model"] = LightGBMRegressor(**small).fit(df)
    corrupt_syncs = count_syncs(torch, corrupted_fit)
    corrupt_splits = int((broken["model"].booster.split_feature >= 0).sum())
    # an unarmed fault point: one flag check per call
    calls = 200_000
    t0 = time.perf_counter()
    for _ in range(calls):
        faults.fault_point("gbdt.train_step")
    point_ns = (time.perf_counter() - t0) / calls * 1e9
    per_fit = TREES + TREES * 6          # train_step + level_hist hits
    out.update({
        "launches": full_launches, "fit_s": full_s,
        "monolithic_fit_s": mono_s,
        "checkpoint_overhead_s": full_s - mono_s,
        "segment_write_crc_ms": seg_ms,
        "killed_by_fault": killed, "after_kill": after_kill,
        "resumed_bitwise": same_model(resumed, full),
        "resumed_fit_s": resumed_s,
        "bitrot_latest": [latest[0], os.path.basename(latest[1])],
        "bitrot_warned": [k.rsplit("/", 1)[-1] for k in warned],
        "bitrot_resume_bitwise": same_model(rotted, full),
        "monolithic": {"bitwise": mono_equal,
                       "rows_routed_apart": apart,
                       "arrays_differing": arrays_differing(full.booster,
                                                            mono.booster)},
        "corrupt_on_card": {"syncs": corrupt_syncs,
                            "clean_syncs": clean_syncs,
                            "splits": corrupt_splits},
        "unarmed_fault_point_ns": point_ns,
        "fault_points_per_fit": per_fit,
        "fault_point_share_of_fit": per_fit * point_ns * 1e-9 / mono_s})
    want_kill = ["checkpoint_10.txt", "checkpoint_10.txt.crc32",
                 "checkpoint_5.txt", "checkpoint_5.txt.crc32",
                 "checkpoint_meta.json"]
    if (full_launches != TREES * 6 or not killed or after_kill != want_kill
            or not out["resumed_bitwise"] or latest[0] != 5
            or not any(k.startswith("gbdt.checkpoint_bitrot.")
                       for k in warned)
            or not out["bitrot_resume_bitwise"]
            or (apart == 0 and not mono_equal)
            or corrupt_syncs > clean_syncs or corrupt_splits):
        raise AssertionError(f"checkpoints: {out}")
    return out


# the serving bench's flagship model (tools/bench_serving.py:57-70) and
# its sustained run (:161-270): 64 keep-alive clients, a 256-row pool
SERVE_ROWS, SERVE_TREES, SERVE_CLIENTS, SERVE_SECONDS = 100_000, 100, 64, 5.0
SERVE_POOL, SERVE_SEQUENTIAL = 256, 500
SERVER_ARGS = dict(max_batch_size=64, max_latency_ms=2.0, max_queue=256,
                   request_timeout_s=5.0)


def serving_data(n, seed=0):
    """tools/bench_serving.py's rows and label rule (float64)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, F))
    y = (x[:, 0] - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
         + rng.normal(size=n) * 0.5 > 0).astype(np.float64)
    return x, y


# what one call of the scorer shows the profiler: the tree_score kernel,
# the copy in and the copy out
SCORE_CALL = (1, 2)


def profile_counts(torch, fn):
    """(kernels, copies, device busy ms) of one ``fn()`` under
    torch.profiler: kernel records and memcpy records apart. On the card
    a profile was found to lose its first few device records (a profile
    led by spin kernels kept all but three of them, and the call after
    them whole), which made a count of one call vary between runs and
    read no kernel at all; so 64 spin kernels go first and are not
    counted. A staged batch's records were also found missing from three
    profiles in a row with nothing after them, so 64 more spin kernels
    follow the call, so that it is not the profile's last work either."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        for _ in range(64):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    kernels = copies = 0
    busy = 0.0
    for e in prof.events():
        if str(e.device_type).endswith("CUDA") \
                and "spin_kernel" not in e.name:
            if e.name.startswith("Memcpy") or e.name.startswith("Memset"):
                copies += 1
            else:
                kernels += 1
            busy += e.time_range.elapsed_us() / 1e3
    return kernels, copies, busy


def kernel_counts(torch, fn, want=SCORE_CALL):
    """``profile_counts`` of one ``fn()``, profiled again (5 profiles at
    most) while it reads fewer kernels or copies than ``want``: a lost
    record only ever lowers a count (three profiles of a staged batch in
    a row once read none), so a reading at or above ``want`` is returned
    at once and the caller's gate holds it to ``want``."""
    for _ in range(5):
        got = profile_counts(torch, fn)
        if got[0] >= want[0] and got[1] >= want[1]:
            break
    return got


def post_rows(server, bodies, threads=16):
    """(status, reply) of each pre-encoded body, over ``threads``
    keep-alive connections."""
    import http.client

    out = [None] * len(bodies)

    def worker(k):
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=30)
        try:
            for i in range(k, len(bodies), threads):
                conn.request("POST", server.api_path, body=bodies[i],
                             headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                body = r.read()
                out[i] = (r.status, json.loads(body) if r.status == 200
                          else body.decode(errors="replace"))
        finally:
            conn.close()

    ts = [threading.Thread(target=worker, args=(k,)) for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    return out


def sustained(server, bodies, clients, duration_s):
    """tools/bench_serving.py's closed loop: ``clients`` keep-alive
    connections send single-row requests back to back for
    ``duration_s``; a 503 is honoured for 2 ms, then retried."""
    import http.client
    import socket

    barrier = threading.Barrier(clients + 1)
    stop_at = [0.0]
    results = [None] * clients

    def client(idx):
        lat, ok, r503, t504, other, errs = [], 0, 0, 0, 0, 0
        conn, i = None, idx
        barrier.wait()
        while time.perf_counter() < stop_at[0]:
            if conn is None:
                conn = http.client.HTTPConnection(server.host, server.port,
                                                  timeout=10)
                try:
                    conn.connect()
                    conn.sock.setsockopt(socket.IPPROTO_TCP,
                                         socket.TCP_NODELAY, 1)
                except OSError:
                    conn, errs = None, errs + 1
                    time.sleep(0.01)
                    continue
            t0 = time.perf_counter()
            try:
                conn.request("POST", server.api_path,
                             body=bodies[i % len(bodies)],
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                resp.read()
                status = resp.status
            except Exception:
                conn.close()
                conn, errs = None, errs + 1
                continue
            i += clients
            if status == 200:
                ok += 1
                lat.append((time.perf_counter() - t0) * 1e3)
            elif status == 503:
                r503 += 1
                time.sleep(0.002)
            elif status == 504:
                t504 += 1
            else:
                other += 1
            if resp.getheader("Connection", "").lower() == "close":
                conn.close()
                conn = None
        if conn is not None:
            conn.close()
        results[idx] = (lat, ok, r503, t504, other, errs)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(clients)]
    for t in threads:
        t.start()
    barrier.wait()
    t_start = time.perf_counter()
    stop_at[0] = t_start + duration_s
    for t in threads:
        t.join(timeout=duration_s + 30)
    wall = time.perf_counter() - t_start
    done = [r for r in results if r]
    lat = sorted(v for r in done for v in r[0])
    ok = sum(r[1] for r in done)
    return {"clients": clients, "seconds": wall, "qps": ok / wall,
            "p50_ms": lat[len(lat) // 2] if lat else None,
            "p99_ms": lat[max(0, -(-99 * len(lat) // 100) - 1)]
            if lat else None,
            "ok": ok, "rejected_503": sum(r[2] for r in done),
            "timeout_504": sum(r[3] for r in done),
            "other_status": sum(r[4] for r in done),
            "client_errors": sum(r[5] for r in done),
            "clients_finished": len(done)}


def sustained_in_child(server, bodies, clients, duration_s):
    """``sustained`` with the clients in a spawned child process, so
    they share no interpreter lock with the server."""
    import concurrent.futures
    import multiprocessing
    import types

    target = types.SimpleNamespace(host=server.host, port=server.port,
                                   api_path=server.api_path)
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        return pool.submit(sustained, target, bodies, clients,
                           duration_s).result(timeout=duration_s + 120)


def replies_against(replies, want, rows_ok=None):
    """Rows whose reply differs, column by column, from the frame
    ``want`` (JSON carries a float64 repr exactly, so == is bitwise);
    only rows where ``rows_ok`` holds, when given."""
    bad = []
    for i, (status, reply) in enumerate(replies):
        if rows_ok is not None and not rows_ok[i]:
            continue
        if status != 200 or reply.get("id") != i:
            bad.append(i)
            continue
        for c in want.columns:
            if c == "features":
                continue
            v = want[c][i]
            v = v.tolist() if isinstance(v, np.ndarray) else float(v)
            if reply.get(c) != v:
                bad.append(i)
                break
    return bad


def phase_serving(ctx):
    """The binned serving plane on the card: the serving bench's
    flagship model fitted, saved and loaded (example 01's flow), the
    binned scorer at every rung (card vs CPU vs ``predict_binned``,
    bitwise; device and host time, launches), request-thread binning,
    the batched server under 64 closed-loop clients with the binned
    plane on and off, the continuous server, and an imported model
    string served through ``derive_binning``."""
    import tempfile

    import torch

    from mmlspark_tpu_torch import DataFrame, LightGBMClassifier
    from mmlspark_tpu_torch.core.env import (INFER_AUTOCAST, SERVE_BINNED,
                                             env_override)
    from mmlspark_tpu_torch.core.pipeline import PipelineStage
    from mmlspark_tpu_torch.io.serving import (ServingServer, _BinnedPlane,
                                               serve_continuous)
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.models.gbdt import score_cuda as S
    from mmlspark_tpu_torch.models.gbdt.estimators import \
        LightGBMClassificationModel
    from mmlspark_tpu_torch.parallel.inference import (bucket_for,
                                                       bucket_ladder)

    out = {"card": ctx["smi"]}
    failures = []
    x, y = serving_data(SERVE_ROWS)
    est = LightGBMClassifier(numIterations=SERVE_TREES, numLeaves=63,
                             maxBin=255)
    torch.cuda.synchronize()
    H.hist_kernel_launches = H.hist_quant_kernel_launches = 0
    t0 = time.perf_counter()
    model = est.fit(DataFrame({"features": x, "label": y}))
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    launches = (H.hist_kernel_launches, H.hist_quant_kernel_launches)
    out["fit_launches"] = {"level_hist": launches[0],
                           "level_hist_quant": launches[1]}
    ctx["launches"]["serving_path"] = launches[0]
    depth = model.booster.max_depth
    out["trees"], out["max_depth"] = model.booster.num_trees, depth
    if launches != (SERVE_TREES * 6, 0) or depth != 6:
        failures.append(f"the fit launched level_hist / level_hist_quant "
                        f"{launches} times at depth {depth}, expected "
                        f"({SERVE_TREES * 6}, 0) at depth 6")
    with tempfile.TemporaryDirectory() as tmp:
        model.save(os.path.join(tmp, "gbdt-model"))
        loaded = PipelineStage.load(os.path.join(tmp, "gbdt-model"))
    out["loaded_device"] = str(loaded.resolved_device())

    # the scorer at every rung: card, CPU and predict_binned bitwise
    ladder = bucket_ladder(SERVER_ARGS["max_batch_size"])
    pool = x[:SERVE_POOL]
    plan = loaded.serving_binned_plan()
    bins = plan.bin_rows(pool)
    cpu_scorer = loaded.booster.predict_binned_scorer("off", "cpu")
    with env_override(INFER_AUTOCAST, "bf16"):
        plan16 = loaded.serving_binned_plan()
    cpu16 = loaded.booster.predict_binned_scorer("bf16", "cpu")
    plane = _BinnedPlane(plan, ladder)
    rungs = {}
    for b in ladder:
        xb = bins[:b]
        card = plan.score(xb).cpu().numpy()
        same = (np.array_equal(card, cpu_scorer(xb).numpy())
                and np.array_equal(
                    card, loaded.booster.predict_binned(xb).cpu().numpy()))
        same16 = np.array_equal(plan16.score(xb).cpu().numpy(),
                                cpu16(xb).numpy())
        reps = 50
        t0 = time.perf_counter()
        for _ in range(reps):
            plan.score(xb).cpu()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
        kernels, copies, busy = kernel_counts(
            torch, lambda: plan.score(xb).cpu())
        # device time from bins already on the card: a pageable copy
        # from the host waits for the stream (and so for device_ms's
        # spin kernel); host_ms counts the copies. The batches behind
        # the spin stay under the card's queue of pending launches
        # (about 1,024), past which the host would wait for the spin.
        xd = torch.as_tensor(xb).cuda()
        rungs[b] = {"bitwise_card_cpu_predict_binned": same,
                    "bf16_bitwise_card_cpu": same16,
                    "device_ms": device_ms(torch, lambda: plan.score(xd),
                                           reps=768 // max(kernels, 1)),
                    "event_ms": time_ms(torch, lambda: plan.score(xb)),
                    "host_ms": host_ms, "kernel_busy_ms": busy,
                    "launches": kernels, "copies": copies}
        # what the server runs: the rung's staged batch, one library call
        # (copy in, kernel, copy out, wait), then the reply columns
        batch = plane._batch(b)
        batch.x[:] = xb
        staged = rungs[b]["staged"] = {
            "bitwise": bool(np.array_equal(plane._score(batch, b), card))}
        t0 = time.perf_counter()
        for _ in range(reps):
            plane._score(batch, b)
        staged["host_ms"] = (time.perf_counter() - t0) * 1e3 / reps
        staged["launches"], staged["copies"], _ = kernel_counts(
            torch, lambda: plane._score(batch, b))
        rows = list(xb)
        t0 = time.perf_counter()
        for _ in range(reps):
            plane.score_rows(rows)
        staged["score_rows_ms"] = (time.perf_counter() - t0) * 1e3 / reps
        if not (same and same16 and staged["bitwise"]):
            failures.append(f"the scorer at rung {b} differs between the "
                            f"card, the CPU, predict_binned and the staged "
                            f"batch")
        if ((kernels, copies) != SCORE_CALL
                or (staged["launches"], staged["copies"]) != SCORE_CALL):
            failures.append(f"the scorer at rung {b} launched {kernels} "
                            f"kernels and {copies} copies per call and "
                            f"{staged['launches']} and {staged['copies']} "
                            f"per staged batch, expected {SCORE_CALL} "
                            f"(tree_score, the copy in and out)")
    out["rungs"] = rungs
    ctx["served"] = (loaded.booster, bins)
    out["bf16_max_abs_vs_f32"] = float(np.max(np.abs(
        plan16.score(bins).cpu().numpy().astype(np.float64)
        - plan.score(bins).cpu().numpy())))

    # the off arm's scoring: transform of one full batch (the per-tree
    # walk on the card, then the numpy tail)
    batch_frame = DataFrame({"features": pool[:SERVER_ARGS["max_batch_size"]]})
    loaded.transform(batch_frame)
    t0 = time.perf_counter()
    for _ in range(5):
        loaded.transform(batch_frame)
    out["transform_ms_per_full_batch"] = (time.perf_counter() - t0) * 1e3 / 5
    out["transform_launches_per_full_batch"] = kernel_counts(
        torch, lambda: loaded.transform(batch_frame))[0]
    if out["transform_launches_per_full_batch"] != 1:
        failures.append(f"transform of a full batch launched "
                        f"{out['transform_launches_per_full_batch']} "
                        f"kernels, expected 1 (tree_score)")

    # request-thread binning (the port's C++), microseconds per row
    payloads = [{"features": row.tolist()} for row in pool]
    t0 = time.perf_counter()
    for _ in range(4):
        for p in payloads:
            plane.bin_row(p)
    out["bin_row_us"] = (time.perf_counter() - t0) * 1e6 / (4 * len(pool))

    # what the replies must equal
    frame = DataFrame({"features": pool})
    raw_t = loaded.transform(frame)
    binned_t = loaded.copy(binnedScoring=True).transform(frame)
    bins32 = np.stack([np.searchsorted(e.astype(np.float32), pool[:, f],
                                       side="left") + 1
                       for f, e in enumerate(loaded.bin_mapper.upper_edges)],
                      axis=1)
    exact = ~(bins32 != loaded.bin_mapper.transform(pool)).any(axis=1)
    out["rows_with_a_float32_bin_change"] = int((~exact).sum())
    id_bodies = [json.dumps({"features": row.tolist(), "__id__": i}).encode()
                 for i, row in enumerate(pool)]
    load_bodies = [json.dumps({"features": row.tolist()}).encode()
                   for row in pool]

    def check_arm(name, replies, binned):
        want = binned_t if binned else raw_t
        bad = replies_against(replies, want)
        raw_bad = replies_against(replies, raw_t, exact) if binned else bad
        codes = sorted({s for s, _ in replies})
        res = {"status_codes": codes, "rows_differing": len(bad),
               "rows_differing_from_raw_where_bins_agree": len(raw_bad)}
        if binned:
            res["rows_differing_from_raw"] = len(
                replies_against(replies, raw_t))
        if bad or raw_bad or codes != [200]:
            failures.append(f"{name}: replies {res}")
        return res

    servers = []
    try:
        for mode in ("on", "off"):
            arm = {}
            with env_override(SERVE_BINNED, mode):
                parity = ServingServer(loaded, **SERVER_ARGS).start()
                servers.append(parity)
                loadsrv = ServingServer(loaded, reply_col="prediction",
                                        max_connections=SERVE_CLIENTS + 8,
                                        **SERVER_ARGS).start()
                servers.append(loadsrv)
            arm["replies"] = check_arm(f"arm {mode}",
                                       post_rows(parity, id_bodies),
                                       mode == "on")
            seen0 = (loadsrv._models["default"].plane.shapes_seen
                     if mode == "on" else None)
            # the method: the 64 clients are threads of this process
            S.tree_score_launches = 0
            S.tree_score_plan_launches.update(rows=0, cluster=0)
            arm["sustained"] = sustained(loadsrv, load_bodies,
                                         SERVE_CLIENTS, SERVE_SECONDS)
            arm["sustained"]["tree_score_launches"] = S.tree_score_launches
            arm["sustained"]["tree_score_plan_launches"] = dict(
                S.tree_score_plan_launches)
            ctx["launches"][f"serving_path_{mode}"] = S.tree_score_launches
            load_stats = dict(loadsrv._models["default"].stats)
            # beside it, the same load from a child process: the server
            # then has the interpreter lock to itself
            S.tree_score_launches = 0
            arm["sustained_child_clients"] = sustained_in_child(
                loadsrv, load_bodies, SERVE_CLIENTS, SERVE_SECONDS)
            child = arm["sustained_child_clients"]
            child["tree_score_launches"] = S.tree_score_launches
            after = loadsrv._models["default"].stats
            child_batches = (after["binned_batches"]
                             + after["generic_batches"]
                             - load_stats["binned_batches"]
                             - load_stats["generic_batches"])
            child["mean_batch"] = (after["served"] - load_stats["served"]) \
                / max(child_batches, 1)
            child["score_ms_per_batch"] = (after["score_s"]
                                           - load_stats["score_s"]) * 1e3 \
                / max(child_batches, 1)
            for tag, srv, st in (
                    ("parity", parity, dict(parity._models["default"].stats)),
                    ("load", loadsrv, load_stats)):
                served = srv._models["default"]
                batches = st["binned_batches"] + st["generic_batches"]
                arm[f"{tag}_server"] = {
                    "binned_active": served.plane is not None,
                    "shapes_seen": (served.plane.shapes_seen
                                    if served.plane else None),
                    "mean_batch": st["served"] / max(batches, 1),
                    **{k: st[k] for k in (
                        "served", "errors", "timeouts", "rejected",
                        "binned_batches", "generic_batches",
                        "binned_fallbacks", "shed_deadline")},
                    # where a batch's time went, on the scoring thread
                    "queue_wait_ms_per_request":
                        st["queue_wait_s"] * 1e3 / max(st["served"], 1),
                    "score_ms_per_batch": st["score_s"] * 1e3
                    / max(batches, 1),
                    "reply_ms_per_batch": st["reply_s"] * 1e3
                    / max(batches, 1)}
                srv.stop()
                s_ = arm[f"{tag}_server"]
                ok = (s_["errors"] == 0 and s_["timeouts"] == 0
                      and s_["shed_deadline"] == 0)
                if mode == "on":
                    ok = ok and (s_["binned_active"]
                                 and s_["binned_fallbacks"] == 0
                                 and s_["generic_batches"] == 0
                                 and s_["shapes_seen"] == len(ladder))
                else:
                    ok = ok and s_["binned_batches"] == 0
                if not ok:
                    failures.append(f"arm {mode}, {tag} server: {s_}")
            # a loaded batch's scoring against the same work alone: the
            # plane's score_rows at the mean batch's rung (on), one
            # transform of a full batch (off)
            alone = (rungs[bucket_for(round(arm["load_server"]["mean_batch"]),
                                      ladder)]["staged"]["score_rows_ms"]
                     if mode == "on" else out["transform_ms_per_full_batch"])
            arm["score_ms_per_loaded_batch_over_alone"] = \
                arm["load_server"]["score_ms_per_batch"] / alone
            if not arm["sustained"]["tree_score_plan_launches"]["cluster"]:
                failures.append(f"arm {mode}: no served batch took the "
                                f"cluster plan")
            for sus in (arm["sustained"], child):
                if (sus["timeout_504"] or sus["other_status"]
                        or sus["client_errors"] or not sus["ok"]
                        or not sus["tree_score_launches"]
                        or (mode == "on" and seen0 != len(ladder))):
                    failures.append(f"arm {mode} sustained run: {sus}")
            out[f"batched_{mode}"] = arm

        # the continuous server, held as the on arm, then 500 sequential
        # keep-alive single-row requests
        cont = serve_continuous(loaded)
        servers.append(cont)
        cres = {"replies": check_arm("continuous",
                                     post_rows(cont, id_bodies), True)}
        import http.client
        conn = http.client.HTTPConnection(cont.host, cont.port, timeout=30)
        lat = []
        try:
            for i in range(SERVE_SEQUENTIAL):
                t0 = time.perf_counter()
                conn.request("POST", cont.api_path,
                             body=load_bodies[i % len(load_bodies)],
                             headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                r.read()
                if r.status == 200:
                    lat.append((time.perf_counter() - t0) * 1e3)
        finally:
            conn.close()
        lat.sort()
        served = cont._models["default"]
        cres.update({
            "sequential": len(lat), "p50_ms": lat[len(lat) // 2],
            "p99_ms": lat[max(0, -(-99 * len(lat) // 100) - 1)],
            "binned_active": served.plane is not None,
            "shapes_seen": served.plane.shapes_seen if served.plane else None,
            **{k: served.stats[k] for k in (
                "served", "errors", "binned_batches", "generic_batches",
                "binned_fallbacks")}})
        cont.stop()
        if (len(lat) != SERVE_SEQUENTIAL or not cres["binned_active"]
                or cres["errors"] or cres["generic_batches"]
                or cres["binned_fallbacks"]):
            failures.append(f"continuous server: {cres}")
        out["continuous"] = cres

        # an imported model string plans through derive_binning
        imported = LightGBMClassificationModel.load_native_model_from_string(
            loaded.get_model_string())
        iplan = imported.serving_binned_plan()
        iraw = iplan.score(iplan.bin_rows(pool)).cpu().numpy()
        iwant = DataFrame(iplan.finish(iraw))
        with env_override(SERVE_BINNED, "on"):
            isrv = ServingServer(imported, **SERVER_ARGS).start()
        servers.append(isrv)
        ireplies = post_rows(isrv, id_bodies)
        ist = dict(isrv._models["default"].stats)
        isrv.stop()
        ibad = replies_against(ireplies, iwant)
        out["imported"] = {
            "derived": imported.bin_mapper is None,
            "rows_differing_from_its_plan": len(ibad),
            "rows_differing_from_loaded_binned": len(replies_against(
                ireplies, binned_t)),
            **{k: ist[k] for k in ("served", "errors", "binned_batches",
                                   "generic_batches", "binned_fallbacks")}}
        if (ibad or ist["generic_batches"] or ist["errors"]
                or ist["binned_fallbacks"] or imported.bin_mapper is not None):
            failures.append(f"imported model: {out['imported']}")
    finally:
        for srv in servers:
            srv.stop()
    if failures:
        raise AssertionError(json.dumps({"failures": failures, **out},
                                        default=str))
    return out


# the categorical cell: the bench's width (2M x 28, max_bin 255, binary,
# 63 leaves, depth 6, 20 trees) with columns 0-3 integer categories of
# these cardinalities (4 takes one-vs-rest splits; 1,000 is above
# max_bin - 2, so its rarest categories overflow to bin 0)
CAT_CARDS = (4, 30, 200, 1000)
CAT_SLOTS = [0, 1, 2, 3]
SHAP_ROWS = 100_000
ZERO_SHARE = 0.3


def categorical_data(n, seed=0):
    """The bench's rows (``make_data``) with columns 0-3 replaced by
    integer categories of ``CAT_CARDS`` values, and labels from each
    category's effect beside the numeric signal."""
    x, _ = make_data(n, seed)
    rng = np.random.default_rng(seed + 1000)
    logit = 0.8 * x[:, 4] - 0.6 * x[:, 5] + 0.4 * x[:, 6] * x[:, 7]
    for c, card in enumerate(CAT_CARDS):
        cats = rng.integers(0, card, n)
        effect = rng.normal(scale=1.5 if card <= 30 else 0.7, size=card)
        logit = logit + effect[cats]
        x[:, c] = cats
    y = (logit + rng.normal(size=n) * 0.5 > 0).astype(np.float64)
    return x, y


def zero_data(n, seed=0):
    """The bench's rows and labels with ``ZERO_SHARE`` of the values set
    to exactly 0.0 (after the labels are drawn)."""
    x, y = make_data(n, seed)
    x[np.random.default_rng(seed + 2000).random(x.shape) < ZERO_SHARE] = 0.0
    return x, y


CAT_ARRAYS = BOOSTER_ARRAYS + ("decision_type", "cat_bitset")


def cat_arrays_differing(a, b):
    """``arrays_differing`` over the decision bits and bitsets too; NaN
    thresholds (categorical nodes, missing-bin splits) compare equal."""
    out = []
    for k in CAT_ARRAYS:
        u, v = getattr(a, k), getattr(b, k)
        if (u is None) != (v is None) or (u is not None and not np.array_equal(
                u, v, equal_nan=u.dtype.kind == "f")):
            out.append(k)
    return out


def left_set(booster, t, m):
    """The category values a categorical node sends left."""
    words = booster.cat_bitset[t, m].astype(np.uint64)
    return [int(w * 32 + i) for w in range(len(words)) for i in range(32)
            if (int(words[w]) >> i) & 1]


def leaves_score_back(booster, leaves, raw):
    """Whether leaf slots (N, T) give the float32 raw scores: each tree's
    leaf value times its weight folded in tree order from init_score,
    each add rounded once (ROADMAP C9), bit for bit."""
    nv, w = booster.node_value, booster.tree_weights
    acc = np.full(leaves.shape[0], np.float32(booster.init_score),
                  np.float32)
    for t in range(booster.num_trees):
        acc = (acc.astype(np.float64) + nv[t, leaves[:, t]].astype(np.float64)
               * np.float64(w[t])).astype(np.float32)
    return bool(np.array_equal(acc, raw))


def phase_categorical(ctx):
    """Categorical features and zero-as-missing on the card, from fit to
    explanation: ``LightGBMClassifier`` with ``categoricalSlotIndexes``
    on the 2M bench-width rows whose columns 0-3 are categories
    (``categorical_data``), and with ``zeroAsMissing`` on the bench rows
    with 30% exact zeros; each fit's histogram launches (120), its loss
    falling, two fits bitwise equal, the categorical booster equal to a
    direct ``train`` captured and uncaptured; card vs CPU at 100,000
    rows (roots equal, a categorical root's left set too, final logloss
    within 1e-4 relative); a 2M-row ``transform`` with
    ``leafPredictionCol`` (the decision route of ``tree_score.cu``,
    launches by route, the leaf slots bitwise its plain version and
    scoring back to the raw score) and a 100,000-row one with
    ``featuresShapCol`` (rows summing to the raw score within 1e-3, card
    vs CPU); both models served (the categorical one through
    ``transform``, the binned plane refusing it; the zero-as-missing one
    binned through the zero premap), replies bitwise ``transform``."""
    import torch

    from mmlspark_tpu_torch import DataFrame, LightGBMClassifier, train
    from mmlspark_tpu_torch.io.serving import ServingServer
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.models.gbdt import score_cuda as S

    out = {"card": ctx["smi"]}
    failures = []
    params = dict(numIterations=TREES, numLeaves=63, maxDepth=6,
                  minDataInLeaf=20, maxBin=255)
    expected = TREES * 6

    def fit(est, frame):
        torch.cuda.synchronize()
        H.hist_kernel_launches = H.hist_quant_kernel_launches = 0
        t0 = time.perf_counter()
        model = est.fit(frame)
        torch.cuda.synchronize()
        return model, time.perf_counter() - t0, (
            H.hist_kernel_launches, H.hist_quant_kernel_launches)

    def fit_stats(name, est, x, y):
        """Two fits of ``est`` on the rows (after a 10,000-row warm-up):
        the first model and its record; failures noted."""
        est.fit(DataFrame({"features": x[:10_000], "label": y[:10_000]}))
        frame = DataFrame({"features": x, "label": y})
        model, fit_s, launches = fit(est, frame)
        again, _, _ = fit(est, frame)
        lls = [e["train_binary_logloss"] for e in model.evals_result]
        phases = model.get_all_instrumentation()
        rec = {"fit_s": fit_s, "extract_s": phases.get("extract"),
               "binning_s": phases.get("binning"),
               "train_s": sum(phases.get(k, 0.0) for k in (
                   "dataPreparation", "training", "validation")),
               "launches": launches[0], "quant_launches": launches[1],
               "logloss_first": lls[0], "logloss_last": lls[-1],
               "two_fits_bitwise": not cat_arrays_differing(model.booster,
                                                            again.booster)}
        if launches != (expected, 0):
            failures.append(f"{name}: launches {launches}")
        if not all(b <= a + 1e-7 for a, b in zip(lls, lls[1:])) \
                or not lls[-1] < lls[0]:
            failures.append(f"{name}: the logloss does not fall: {lls}")
        if not rec["two_fits_bitwise"]:
            failures.append(f"{name}: two fits differ")
        return model, rec

    # -- the categorical fit ---------------------------------------------
    x, y = categorical_data(N)
    est = LightGBMClassifier(categoricalSlotIndexes=CAT_SLOTS, **params)
    model, rec = fit_stats("categorical", est, x, y)
    b = model.booster
    rec["categorical_nodes"] = int(((b.decision_type & 1) == 1).sum())
    rec["categorical_roots"] = int(((b.decision_type[:, 0] & 1) == 1).sum())
    rec["bitset_words"] = int(b.cat_bitset.shape[2])
    rec["categories_binned"] = [len(c) for c in
                                model.bin_mapper.categories[:4]]
    if not rec["categorical_nodes"]:
        failures.append("the categorical fit made no categorical split")
    # the same trees from a direct train on the estimator's config and
    # bins, captured (one replay per iteration) and uncaptured
    cfg = est._train_config("binary", categorical_features=CAT_SLOTS)
    binned = model.bin_mapper.transform(x.astype(np.float64), np.uint8)
    bin_upper = model.bin_mapper.bin_upper_values(255)
    direct = train(binned, y, cfg, bin_upper=bin_upper)
    uncaptured = train(binned, y, cfg, bin_upper=bin_upper, capture=False)
    rec["direct_captured"] = direct.step_stats["captured"]
    rec["arrays_differing_from_direct_train"] = cat_arrays_differing(
        b, direct.booster)
    rec["captured_bitwise_uncaptured"] = not cat_arrays_differing(
        direct.booster, uncaptured.booster)
    if (rec["arrays_differing_from_direct_train"]
            or not rec["captured_bitwise_uncaptured"]
            or not rec["direct_captured"]
            or uncaptured.step_stats["captured"]):
        failures.append(f"categorical: direct / uncaptured train: {rec}")
    del binned
    out["categorical_fit"] = rec

    # card vs CPU on a 100,000-row slice, 5 trees
    small = DataFrame({"features": x[:100_000], "label": y[:100_000]})
    res = {dev: LightGBMClassifier(categoricalSlotIndexes=CAT_SLOTS,
                                   **dict(params, numIterations=5))
           .set_device(dev).fit(small) for dev in ("cuda", "cpu")}
    a, c = res["cuda"].booster, res["cpu"].booster
    roots_equal = (np.array_equal(a.split_feature[:, 0], c.split_feature[:, 0])
                   and np.array_equal(a.threshold_bin[:, 0],
                                      c.threshold_bin[:, 0])
                   and np.array_equal(a.decision_type[:, 0],
                                      c.decision_type[:, 0]))
    cat_roots = [t for t in range(a.num_trees)
                 if a.decision_type[t, 0] & 1]
    roots_equal = roots_equal and all(
        left_set(a, t, 0) == left_set(c, t, 0) for t in cat_roots)
    ll = {dev: m.evals_result[-1]["train_binary_logloss"]
          for dev, m in res.items()}
    rel = abs(ll["cuda"] - ll["cpu"]) / abs(ll["cpu"])
    out["card_vs_cpu"] = {"roots_equal": roots_equal,
                          "categorical_roots": len(cat_roots),
                          "logloss_cuda": ll["cuda"],
                          "logloss_cpu": ll["cpu"], "rel_diff": rel,
                          "tol": 1e-4}
    if not roots_equal or rel > 1e-4:
        failures.append(f"card vs CPU: {out['card_vs_cpu']}")

    # -- the zero-as-missing fit ------------------------------------------
    xz, yz = zero_data(N, seed=3)
    zest = LightGBMClassifier(zeroAsMissing=True, **params)
    zmodel, zrec = fit_stats("zero_as_missing", zest, xz, yz)
    zb = zmodel.booster
    zrec["zero_premap_mode"] = zb.zero_premap_mode
    if zb.zero_premap_mode != "all_left" or not np.array_equal(
            zb.decision_type, np.where(zb.split_feature >= 0, 6, 0)):
        failures.append(f"zero_as_missing: bits {zrec}")
    out["zero_as_missing_fit"] = zrec

    # -- transform: 2M rows with leaf slots, 100,000 with SHAP ---------------
    frame = DataFrame({"features": x})
    lmodel = model.copy(leafPredictionCol="leaves")
    lmodel.transform(DataFrame({"features": x[:1000]}))     # warm-up
    torch.cuda.synchronize()
    S.tree_score_launches = 0
    S.tree_score_plan_launches.update(rows=0, cluster=0)
    S.tree_score_route_launches.update(bin=0, wide=0, raw=0, decision=0)
    t0 = time.perf_counter()
    scored = lmodel.transform(frame)
    transform_s = time.perf_counter() - t0
    routes = dict(S.tree_score_route_launches)
    ctx["launches"]["categorical_path_tree_score"] = routes["decision"]
    leaves = scored["leaves"].astype(np.int64)
    raw = scored["rawPrediction"][:, 1].astype(np.float32)
    tables = b._scorer(True, "off", "cuda", decision=True).tables
    plain = S.tree_score_reference(torch.as_tensor(x).cuda(), tables,
                                   leaves=True)[1].cpu().numpy()
    out["transform"] = {
        "rows": N, "transform_s": transform_s,
        "tree_score_launches_by_route": routes,
        "tree_score_plan_launches": dict(S.tree_score_plan_launches),
        "leaves_shape": list(leaves.shape),
        "leaves_bitwise_plain": bool(np.array_equal(leaves, plain)),
        "leaves_score_back_to_raw": leaves_score_back(b, leaves, raw),
        "leaf_index_ms": time_ms(torch, lambda: b.leaf_index(x, "cuda"),
                                 reps=5, warmup=1)}
    del plain
    if (routes != {"bin": 0, "wide": 0, "raw": 0, "decision": 2}
            or not out["transform"]["leaves_bitwise_plain"]
            or not out["transform"]["leaves_score_back_to_raw"]
            or leaves.shape != (N, TREES) or not np.isfinite(raw).all()):
        failures.append(f"transform: {out['transform']}")
    del scored, leaves

    smodel = model.copy(featuresShapCol="shap")
    sframe = DataFrame({"features": x[:SHAP_ROWS]})
    smodel.transform(DataFrame({"features": x[:1000]}))     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shap_scored = smodel.transform(sframe)
    shap_s = time.perf_counter() - t0
    shap = shap_scored["shap"]
    sraw = shap_scored["rawPrediction"][:, 1]
    xs = torch.as_tensor(x[:SHAP_ROWS]).cuda()
    card = b.contrib(x[:2000], "cuda").cpu().numpy()
    cpu = b.contrib(x[:2000], "cpu").numpy()
    saabas = b.contrib_saabas(x[:SHAP_ROWS], "cuda").cpu().numpy()
    out["shap"] = {
        "rows": SHAP_ROWS, "transform_s": shap_s,
        "shape": list(shap.shape),
        "sum_max_abs_err": float(np.abs(shap.sum(axis=1) - sraw).max()),
        "sum_tol": 1e-3,
        "card_vs_cpu_max_abs_err": float(np.abs(card - cpu).max()),
        "card_vs_cpu_tol": "rtol 1e-4, atol 1e-5",
        "saabas_sum_max_abs_err": float(np.abs(saabas.sum(axis=1)
                                               - sraw).max()),
        "contrib_ms": time_ms(torch, lambda: b.contrib(xs, "cuda"), reps=3,
                              warmup=1),
        "contrib_saabas_ms": time_ms(
            torch, lambda: b.contrib_saabas(xs, "cuda"), reps=3, warmup=1)}
    if (shap.shape != (SHAP_ROWS, F + 1) or out["shap"]["sum_max_abs_err"]
            > 1e-3 or out["shap"]["saabas_sum_max_abs_err"] > 1e-3
            or not np.allclose(card, cpu, rtol=1e-4, atol=1e-5)):
        failures.append(f"shap: {out['shap']}")
    del shap_scored, xs

    # -- serving: the categorical model through transform, the zero-as-
    # missing one binned through the premap; replies bitwise transform
    def served(m, rows):
        bodies = [json.dumps({"features": row.tolist(), "__id__": i}).encode()
                  for i, row in enumerate(rows)]
        server = ServingServer(m, **SERVER_ARGS).start()
        try:
            replies = post_rows(server, bodies)
            health = server._health()
        finally:
            server.stop()
        return replies, health["binned"]

    pool = x[:256]
    replies, binned_health = served(model, pool)
    want = model.transform(DataFrame({"features": pool}))
    bad = replies_against(replies, want)
    out["serving_categorical"] = {"binned": binned_health,
                                  "rows_differing_from_transform": len(bad)}
    if bad or binned_health["active"]:
        failures.append(f"serving categorical: {out['serving_categorical']}")
    zpool = xz[:256]
    replies, binned_health = served(zmodel, zpool)
    zframe = DataFrame({"features": zpool})
    zwant = zmodel.copy(binnedScoring=True).transform(zframe)
    zraw = zmodel.transform(zframe)
    premapped = np.where(zpool == 0.0, np.nan, zpool).astype(np.float64)
    bins = zmodel.bin_mapper.transform(premapped)
    bins32 = np.stack([np.where(np.isnan(premapped[:, f]), 0,
                                np.searchsorted(e.astype(np.float32),
                                                premapped[:, f].astype(
                                                    np.float32),
                                                side="left") + 1)
                       for f, e in enumerate(zmodel.bin_mapper.upper_edges)],
                      axis=1)
    exact = ~(bins32 != bins).any(axis=1)
    zbad = replies_against(replies, zwant)
    zraw_bad = replies_against(replies, zraw, exact)
    out["serving_zero_as_missing"] = {
        "binned": binned_health, "rows_differing_from_binned_transform":
        len(zbad), "rows_with_a_float32_bin_change": int((~exact).sum()),
        "rows_differing_from_transform_where_bins_agree": len(zraw_bad)}
    if zbad or zraw_bad or not binned_health["active"]:
        failures.append(f"serving zero_as_missing: "
                        f"{out['serving_zero_as_missing']}")

    ctx["categorical"] = (b, x)
    if failures:
        raise AssertionError(json.dumps({"failures": failures, **out},
                                        default=str))
    return out


def make_mslr_shaped(n_queries, f=136, seed=0, skewed=False):
    """``tools/bench_ranker.py``'s MSLR-WEB30K-shaped data (that tool
    imports the JAX package, so the generator is copied here): queries
    of 80-180 documents (``skewed``: log-uniform 8-1,200, as real MSLR's
    long tail), graded 0-4 by per-query quantiles of a hidden sparse
    linear utility plus noise."""
    rng = np.random.default_rng(seed)
    if skewed:
        sizes = np.exp(rng.uniform(np.log(8), np.log(1200),
                                   size=n_queries)).astype(np.int64)
    else:
        sizes = rng.integers(80, 181, size=n_queries)
    n = int(sizes.sum())
    x = rng.normal(size=(n, f)).astype(np.float64)
    w_true = rng.normal(size=f) * (rng.random(f) < 0.15)  # sparse signal
    util = x @ w_true + 0.5 * rng.normal(size=n)
    group_ids = np.repeat(np.arange(n_queries), sizes)
    labels = np.zeros(n)
    start = 0
    for qs in sizes:
        u = util[start:start + qs]
        qt = np.quantile(u, [0.5, 0.75, 0.9, 0.97])
        labels[start:start + qs] = np.searchsorted(qt, u)
        start += qs
    return x, labels, group_ids


# UCI Covertype (581,012 rows; the usual LightGBM multiclass benchmark):
# 10 continuous columns, then 4 and 40 one-hot groups (wilderness area,
# soil type); the seven cover types' shares in per cent
COVER_ROWS = 581_012
COVER_SHARES = (36.5, 48.8, 6.2, 0.5, 1.6, 3.0, 3.5)


def covertype_data(n, seed=0):
    """Covertype-shaped rows made from ``seed`` (no download): labels at
    Covertype's class shares; per class, shifted Gaussian continuous
    columns and its own draws of the two one-hot groups."""
    rng = np.random.default_rng(seed)
    p = np.asarray(COVER_SHARES) / sum(COVER_SHARES)
    y = rng.choice(len(p), size=n, p=p)
    centers = rng.normal(size=(len(p), 10)) * 0.6
    x = np.zeros((n, 54), np.float32)
    x[:, :10] = centers[y] + rng.normal(size=(n, 10))
    for first, width, conc in ((10, 4, 1.0), (14, 40, 0.3)):
        probs = rng.dirichlet(np.full(width, conc), size=len(p))
        pick = (rng.random(n)[:, None]
                > np.cumsum(probs, axis=1)[y]).sum(axis=1)
        x[np.arange(n), first + np.minimum(pick, width - 1)] = 1.0
    return x, y.astype(np.float64)


def rows_binned_alike(mapper, x):
    """Rows whose every value bins alike in float64 (training and binned
    scoring) and in float32 (raw scoring; ROADMAP C8)."""
    x = np.asarray(x, np.float64)
    bins = mapper.transform(x)
    bins32 = np.stack([np.where(np.isnan(x[:, f]), 0, np.searchsorted(
        e.astype(np.float32), x[:, f].astype(np.float32), side="left") + 1)
        for f, e in enumerate(mapper.upper_edges)], axis=1)
    return ~(bins32 != bins).any(axis=1)


def served_binned_on(model, rows):
    """(replies, the binned plane's health) of ``rows`` posted to a
    ``ServingServer`` with ``MMLSPARK_TORCH_SERVE_BINNED=on``."""
    from mmlspark_tpu_torch.core.env import SERVE_BINNED, env_override
    from mmlspark_tpu_torch.io.serving import ServingServer

    bodies = [json.dumps({"features": row.tolist(), "__id__": i}).encode()
              for i, row in enumerate(rows)]
    with env_override(SERVE_BINNED, "on"):
        server = ServingServer(model, **SERVER_ARGS).start()
        try:
            replies = post_rows(server, bodies)
            health = server._health()
        finally:
            server.stop()
    return replies, health["binned"]


def serving_record(model, rows):
    """Served replies (binned plane ``on``) against the ``binnedScoring``
    transform on every row and the raw ``transform`` on rows that bin
    alike; the record and whether it holds."""
    from mmlspark_tpu_torch import DataFrame

    replies, health = served_binned_on(model, rows)
    frame = DataFrame({"features": rows})
    binned = replies_against(
        replies, model.copy(binnedScoring=True).transform(frame))
    alike = rows_binned_alike(model.bin_mapper, rows)
    raw = replies_against(replies, model.transform(frame), alike)
    rec = {"rows": len(rows), "binned": health,
           "rows_differing_from_binned_transform": len(binned),
           "rows_with_a_float32_bin_change": int((~alike).sum()),
           "rows_differing_from_transform_where_bins_agree": len(raw)}
    return rec, not binned and not raw and health["active"]


def fit_counted(torch, est, frame):
    """(model, wall s, level_hist launches, level_hist_quant launches,
    peak device bytes) of one estimator fit."""
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    H.hist_kernel_launches = H.hist_quant_kernel_launches = 0
    t0 = time.perf_counter()
    model = est.fit(frame)
    torch.cuda.synchronize()
    return (model, time.perf_counter() - t0, H.hist_kernel_launches,
            H.hist_quant_kernel_launches, torch.cuda.max_memory_allocated())


def scorer_held(torch, S, label, tables, xd):
    """``tree_score`` on a phase's own model and rows ``xd`` held against
    its plain version on the card, bit for bit, and two launches against
    each other, with the plan it takes (printed). (record, scores,
    ok)."""
    plan = S._plan_for(xd.shape[0], xd.shape[1], xd.dtype, tables,
                       xd.device)
    got, again = S.tree_score(xd, tables), S.tree_score(xd, tables)
    want = S.tree_score_reference(xd, tables)
    rec = {"case": label, "rows": xd.shape[0], "features": xd.shape[1],
           "dtype": str(xd.dtype).replace("torch.", ""),
           "trees": tables.num_trees, "classes": tables.num_class,
           "route": tables.route, "plan": dataclasses.astuple(plan),
           "bitwise_plain": bool(torch.equal(got, want)),
           "two_launches_bitwise": bool(torch.equal(got, again))}
    emit({"phase": "tree_score_case", **rec})
    return rec, got, rec["bitwise_plain"] and rec["two_launches_bitwise"]


def scorers_held(torch, S, model, x, binned, transform_raw):
    """The transform's scorer (raw rows as float32, routed as
    ``predict`` routes them) and the served binned plane's (uint8 bin
    ids) held by :func:`scorer_held` at the phase's rows; the raw
    route's scores against the transform's raw scores, bit for bit.
    (records, ok)."""
    b = model.scoring_booster
    raw_tables = b._scorer(True, "off", "cuda",
                           decision=b.decision_type is not None).tables
    bin_tables = b.predict_binned_scorer("off", "cuda").tables
    xd = torch.as_tensor(x).to(torch.float32).to("cuda").contiguous()
    raw_rec, got, raw_ok = scorer_held(torch, S, "transform", raw_tables,
                                       xd)
    raw_rec["transform_bitwise"] = bool(np.array_equal(
        got.cpu().numpy(), transform_raw))
    del xd, got
    bin_rec, _, bin_ok = scorer_held(
        torch, S, "binned", bin_tables,
        torch.as_tensor(binned, device="cuda"))
    return ([raw_rec, bin_rec],
            raw_ok and bin_ok and raw_rec["transform_bitwise"])


def fit_record(model, wall_s, rows):
    phases = model.get_all_instrumentation()
    train_s = sum(phases.get(k, 0.0) for k in (
        "dataPreparation", "training", "validation"))
    return {"fit_s": wall_s, "extract_s": phases.get("extract"),
            "binning_s": phases.get("binning"), "train_s": train_s,
            "trees": model.booster.num_trees,
            "fit_mrow_trees_per_s": rows * model.booster.num_trees
            / train_s / 1e6}


def step_profile(torch, fn, iterations):
    """A fit's device busy time and idle share under torch.profiler, and
    its busy ms per iteration."""
    wall_ms, by_name = device_ms_by_kernel(torch, fn)
    busy = sum(by_name.values())
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy if busy else "not measured",
            "device_idle_share": 1 - busy / wall_ms if busy
            else "not measured",
            "busy_ms_per_iteration": busy / iterations if busy
            else "not measured",
            "level_hist_ms": hist_device_ms(by_name),
            "top_ms": top(by_name, 8)}


RANK_QUERIES = 2000
RANK_TREES = 100
RANK_PARAMS = dict(numIterations=RANK_TREES, numLeaves=63, maxDepth=6,
                   minDataInLeaf=20, maxBin=255, evalAt=[10], maxPosition=30,
                   groupCol="query")


def phase_ranking(ctx):
    """Learning to rank on the card at ``tools/bench_ranker.py``'s
    configuration (BASELINE.json's LightGBMRanker lambdarank, MSLR-shaped:
    2,000 queries of 80-180 documents, 136 features, graded 0-4;
    lambdarank, 100 trees, 63 leaves, depth 6, ``maxBin=255``,
    ``evalAt=[10]``, ``maxPosition=30``): a ``LightGBMRanker`` fit (600
    ``level_hist`` launches), NDCG@10 of the model at or above the
    bench's floor of 0.6 and above the first tree's, two fits bitwise,
    the same trees from a direct ``train`` captured and uncaptured, the
    lambdarank grads' device time per call and share of a step's
    (torch.profiler), peak device memory; the skewed variant (8-1,200
    documents, 20 trees); early stopping on a validation tenth of the
    queries against the replayed rule; card vs CPU at 200 queries and 5
    trees; the ranker served with the binned plane ``on``."""
    import torch

    from mmlspark_tpu_torch import (BinMapper, DataFrame, LightGBMRanker,
                                    train)
    from mmlspark_tpu_torch.models.gbdt import metrics, objectives
    from mmlspark_tpu_torch.models.gbdt import score_cuda as S

    out = {"card": ctx["smi"]}
    failures = []
    x, y, gid = make_mslr_shaped(RANK_QUERIES)
    n = len(y)
    frame = DataFrame({"features": x, "label": y, "query": gid})
    est = LightGBMRanker(**RANK_PARAMS)
    model, wall, launches, qlaunches, peak = fit_counted(torch, est, frame)
    again, wall2, _, _, _ = fit_counted(torch, est, frame)
    ctx["launches"]["ranking_path"] = launches
    ctx["launches"]["ranking_path_quant"] = qlaunches
    b = model.booster
    rec = {"rows": n, "queries": RANK_QUERIES,
           "first_fit": fit_record(model, wall, n),
           **fit_record(again, wall2, n), "launches": launches,
           "quant_launches": qlaunches, "expected_launches": RANK_TREES * 6,
           "peak_device_bytes": peak,
           "two_fits_bitwise": boosters_equal(b, again.booster)}
    evals = [e["train_ndcg@10"] for e in model.evals_result]
    torch.cuda.synchronize()
    S.tree_score_launches = 0
    scores = model.transform(DataFrame({"features": x}))["prediction"]
    ctx["launches"]["ranking_path_tree_score"] = S.tree_score_launches
    ndcg = float(metrics.ndcg_at(10)(
        torch.as_tensor(scores, dtype=torch.float32, device="cuda"),
        torch.as_tensor(y, dtype=torch.float32, device="cuda"),
        group_ids=gid))
    rec.update({"ndcg@10": ndcg, "ndcg@10_floor": 0.6,
                "train_ndcg@10_first_tree": evals[0],
                "train_ndcg@10_last_tree": evals[-1],
                "tree_score_launches": S.tree_score_launches})
    if launches != RANK_TREES * 6 or qlaunches:
        failures.append(f"launches {launches}, quantized {qlaunches}")
    if not ndcg >= 0.6 or not evals[-1] > evals[0]:
        failures.append(f"NDCG@10 {ndcg}, by tree {evals[0]} -> {evals[-1]}")
    if not rec["two_fits_bitwise"]:
        failures.append("two ranker fits differ")
    if (not np.isfinite(scores).all() or scores.shape != (n,)
            or S.tree_score_launches != 1):
        failures.append(f"transform: {S.tree_score_launches} tree_score "
                        f"launches, scores of shape {scores.shape}")

    # the same trees from a direct train, captured and uncaptured
    cfg = est._train_config("lambdarank", eval_at=(10,),
                            lambdarank_truncation_level=30)
    binned = model.bin_mapper.transform(x, np.uint8)
    bin_upper = model.bin_mapper.bin_upper_values(255)
    direct = train(binned, y, cfg, bin_upper=bin_upper, group_ids=gid)
    uncaptured = train(binned, y, cfg, bin_upper=bin_upper, group_ids=gid,
                       capture=False)
    rec["direct_captured"] = direct.step_stats["captured"]
    rec["arrays_differing_from_direct_train"] = arrays_differing(
        b, direct.booster)
    rec["captured_bitwise_uncaptured"] = boosters_equal(direct.booster,
                                                        uncaptured.booster)
    if (rec["arrays_differing_from_direct_train"]
            or not rec["captured_bitwise_uncaptured"]
            or not rec["direct_captured"]
            or uncaptured.step_stats["captured"]):
        failures.append(f"direct / uncaptured train: {rec}")

    # tree_score at the ranker's rows (K = 1, F = 136): the transform's
    # raw route and the served binned plane, each against its plain version
    rec["tree_score_held"], ok = scorers_held(torch, S, model, x, binned,
                                              scores)
    if not ok:
        failures.append(f"tree_score: {rec['tree_score_held']}")

    # the lambdarank grads alone, and their share of a step's device time
    binned_d = torch.as_tensor(binned, device="cuda")
    raw_d = torch.as_tensor(scores, dtype=torch.float32, device="cuda")
    y_d = torch.as_tensor(y, dtype=torch.float32, device="cuda")
    lay = objectives.layout_to(objectives.make_group_layout(gid), "cuda")

    def grads():
        return objectives.lambdarank(raw_d, y_d, None, group_layout=lay,
                                     truncation_level=30)

    # device time of the grads' kernels over 5 calls (torch.profiler),
    # beside the event-pair time of one call
    grads()
    _, by_name = device_ms_by_kernel(torch, lambda: [grads()
                                                     for _ in range(5)])
    grad_ms = sum(by_name.values()) / 5 if by_name else "not measured"
    rec["lambdarank_grad_event_ms"] = time_ms(torch, grads, reps=10)
    rec["lambdarank_grad_host_syncs"] = count_syncs(torch, grads)
    rec["lambdarank_grad_sync_site"] = first_sync_site(torch, grads)
    rec["lambdarank_grad_top_ms"] = {k: v / 5 for k, v in
                                     top(by_name, 6).items()}
    cfg5 = dataclasses.replace(cfg, num_iterations=5)
    prof = step_profile(torch, lambda: train(
        binned_d, y, cfg5, bin_upper=bin_upper, group_ids=gid), 5)
    per_it = prof["busy_ms_per_iteration"]
    rec["lambdarank_grad_ms_per_call"] = grad_ms
    rec["profile_5_trees"] = prof
    rec["lambdarank_share_of_step_device_ms"] = (
        grad_ms / per_it if isinstance(per_it, float)
        and isinstance(grad_ms, float) else "not measured")
    rec["layout_buckets"] = [list(r.shape) for r, _ in lay]
    out["fit"] = rec
    del binned_d, direct, uncaptured

    # the skewed variant: log-uniform 8-1,200 documents, 20 trees
    xs, ys, gs = make_mslr_shaped(RANK_QUERIES, skewed=True, seed=1)
    sfr = DataFrame({"features": xs, "label": ys, "query": gs})
    sest = LightGBMRanker(**dict(RANK_PARAMS, numIterations=20))
    smodel, swall, slaunch, _, speak = fit_counted(torch, sest, sfr)
    sev = [e["train_ndcg@10"] for e in smodel.evals_result]
    slay = objectives.make_group_layout(gs)
    out["skewed"] = {"rows": len(ys), **fit_record(smodel, swall, len(ys)),
                     "launches": slaunch, "peak_device_bytes": speak,
                     "largest_group": int(np.bincount(gs).max()),
                     "layout_buckets": [list(r.shape) for r, _ in slay],
                     "train_ndcg@10_first_tree": sev[0],
                     "train_ndcg@10_last_tree": sev[-1]}
    if slaunch != 20 * 6 or not sev[-1] > sev[0]:
        failures.append(f"skewed: {out['skewed']}")
    del xs, ys, gs, sfr, smodel

    # early stopping on the validation queries' ndcg@10
    val = np.isin(gid, np.arange(0, RANK_QUERIES, 10))
    vest = LightGBMRanker(**dict(RANK_PARAMS, learningRate=0.3,
                                 earlyStoppingRound=5,
                                 validationIndicatorCol="val"))
    vmodel = vest.fit(DataFrame({"features": x, "label": y, "query": gid,
                                 "val": val}))
    vals = [e["valid0_ndcg@10"] for e in vmodel.evals_result]
    best, stopped = replay_stop_rule(vals, 5, higher_better=True)
    # trees are cut after the best iteration whether or not the rule fired
    vrec = {"iterations_run": len(vals), "best_iteration":
            vmodel.best_iteration, "replayed": [best, stopped],
            "metric_turned": stopped is not None,
            "trees": vmodel.booster.num_trees,
            "valid_ndcg@10_first": vals[0], "valid_ndcg@10_best": vals[best]}
    if (vmodel.best_iteration != best or (stopped or RANK_TREES) != len(vals)
            or vmodel.booster.num_trees != best + 1):
        failures.append(f"early stopping: {vrec}")
    out["early_stopping"] = vrec

    # card vs CPU: 200 queries, 5 trees
    xc, yc, gc = make_mslr_shaped(200, seed=2)
    cmap = BinMapper.fit(xc, max_bin=255)
    bc = cmap.transform(xc)
    c5 = dataclasses.replace(cfg, num_iterations=5)
    res = {dev: train(bc, yc, c5, group_ids=gc, device=dev)
           for dev in ("cuda", "cpu")}
    a, c = res["cuda"].booster, res["cpu"].booster
    roots_equal = (np.array_equal(a.split_feature[:, 0], c.split_feature[:, 0])
                   and np.array_equal(a.threshold_bin[:, 0],
                                      c.threshold_bin[:, 0]))
    nd = {dev: r.evals[-1]["train_ndcg@10"] for dev, r in res.items()}
    rel = abs(nd["cuda"] - nd["cpu"]) / abs(nd["cpu"])
    out["card_vs_cpu"] = {"rows": len(yc), "roots_equal": roots_equal,
                          "ndcg_cuda": nd["cuda"], "ndcg_cpu": nd["cpu"],
                          "rel_diff": rel, "tol": 1e-4}
    if not roots_equal or rel > 1e-4:
        failures.append(f"card vs CPU: {out['card_vs_cpu']}")

    # served with the binned plane on
    out["serving"], ok = serving_record(model, x[:256])
    if not ok:
        failures.append(f"serving: {out['serving']}")
    if failures:
        raise AssertionError(json.dumps({"failures": failures, **out},
                                        default=str))
    return out


COVER_ITERATIONS = 20
COVER_PARAMS = dict(numIterations=COVER_ITERATIONS, numLeaves=63,
                    maxDepth=6, maxBin=255)


def phase_multiclass(ctx):
    """``multiclass_fits`` with bundling off, so that its histograms scan
    Covertype's 54 columns (the byte-staged rows of an odd width), and
    the EFB plan ``auto`` would make of its rows: bundles, width and the
    plan's time on the card."""
    import torch

    from mmlspark_tpu_torch import BinMapper
    from mmlspark_tpu_torch.core.env import EFB, env_override
    from mmlspark_tpu_torch.ops import efb

    with env_override(EFB, "off"):
        out = multiclass_fits(ctx)
    x, _ = covertype_data(COVER_ROWS)
    mapper = BinMapper.fit(x[:200_000], max_bin=255)
    binned_d = torch.as_tensor(mapper.transform(x, np.uint8), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = efb.plan_bundles(binned_d, 255, mode="auto")
    torch.cuda.synchronize()
    out["efb_auto_plan"] = {
        "plan_on_card_s": time.perf_counter() - t0,
        "efb_bundles": 0 if plan is None else len(plan.bundles),
        "efb_bundled_features": 0 if plan is None
        else plan.n_bundled_features,
        "bundled_width": 54 if plan is None else plan.n_cols}
    return out


def multiclass_fits(ctx):
    """Multiclass on the card at Covertype's shape (581,012 rows x 54
    columns, 7 classes at its shares; ``covertype_data``):
    ``LightGBMClassifier`` with its default objective (multiclass for 7
    labels), 20 iterations of 7 trees, 63 leaves, depth 6, ``maxBin=255``
    — 840 ``level_hist`` launches, ``multi_logloss`` falling, two fits
    bitwise, the same trees from a direct ``train`` captured and
    uncaptured, the step's idle share (torch.profiler), the transform's
    ``tree_score`` launches and probability rows summing to 1 within
    1e-6; the same fit under bagging 0.5 and under GOSS; card vs CPU at
    100,000 rows and 5 iterations; the model served with the binned
    plane ``on``."""
    import torch

    from mmlspark_tpu_torch import DataFrame, LightGBMClassifier, train
    from mmlspark_tpu_torch.models.gbdt import score_cuda as S

    out = {"card": ctx["smi"]}
    failures = []
    k = len(COVER_SHARES)
    expected = COVER_ITERATIONS * k * 6
    x, y = covertype_data(COVER_ROWS)
    n = len(y)
    frame = DataFrame({"features": x, "label": y})

    def falls(vals):
        return (all(b <= a + 1e-7 for a, b in zip(vals, vals[1:]))
                and vals[-1] < vals[0])

    est = LightGBMClassifier(**COVER_PARAMS)
    model, wall, launches, qlaunches, peak = fit_counted(torch, est, frame)
    again, wall2, _, _, _ = fit_counted(torch, est, frame)
    ctx["launches"]["multiclass_path"] = launches
    ctx["launches"]["multiclass_path_quant"] = qlaunches
    b = model.booster
    lls = [e["train_multi_logloss"] for e in model.evals_result]
    rec = {"rows": n, "classes": k, "class_counts":
           np.bincount(y.astype(int)).tolist(),
           "first_fit": fit_record(model, wall, n),
           **fit_record(again, wall2, n), "launches": launches,
           "quant_launches": qlaunches, "expected_launches": expected,
           "peak_device_bytes": peak, "num_class": b.num_class,
           "multi_logloss_first": lls[0], "multi_logloss_last": lls[-1],
           "two_fits_bitwise": boosters_equal(b, again.booster)}
    if launches != expected or qlaunches:
        failures.append(f"launches {launches}, quantized {qlaunches}")
    if b.num_class != k or b.num_trees != COVER_ITERATIONS * k:
        failures.append(f"booster: {b.num_class} classes, {b.num_trees} "
                        "trees")
    if not falls(lls):
        failures.append(f"multi_logloss does not fall: {lls}")
    if not rec["two_fits_bitwise"]:
        failures.append("two multiclass fits differ")

    cfg = est._train_config("multiclass", num_class=k)
    binned = model.bin_mapper.transform(x.astype(np.float64), np.uint8)
    bin_upper = model.bin_mapper.bin_upper_values(255)
    direct = train(binned, y, cfg, bin_upper=bin_upper)
    uncaptured = train(binned, y, cfg, bin_upper=bin_upper, capture=False)
    rec["direct_captured"] = direct.step_stats["captured"]
    rec["arrays_differing_from_direct_train"] = arrays_differing(
        b, direct.booster)
    rec["captured_bitwise_uncaptured"] = boosters_equal(direct.booster,
                                                        uncaptured.booster)
    if (rec["arrays_differing_from_direct_train"]
            or not rec["captured_bitwise_uncaptured"]
            or not rec["direct_captured"]
            or uncaptured.step_stats["captured"]):
        failures.append(f"direct / uncaptured train: {rec}")
    binned_d = torch.as_tensor(binned, device="cuda")
    rec["profile_5_iterations"] = step_profile(torch, lambda: train(
        binned_d, y, dataclasses.replace(cfg, num_iterations=5),
        bin_upper=bin_upper), 5)
    del binned_d, direct, uncaptured

    # transform: probabilities, one tree_score launch per batch
    torch.cuda.synchronize()
    S.tree_score_launches = 0
    t0 = time.perf_counter()
    scored = model.transform(DataFrame({"features": x}))
    rec["transform_s"] = time.perf_counter() - t0
    ctx["launches"]["multiclass_path_tree_score"] = S.tree_score_launches
    probs = scored["probability"]
    rec["tree_score_launches"] = S.tree_score_launches
    rec["probability_row_sum_max_err"] = float(np.abs(probs.sum(axis=1)
                                                      - 1.0).max())
    rec["accuracy"] = float(np.mean(scored["prediction"] == y))
    if (probs.shape != (n, k) or rec["probability_row_sum_max_err"] > 1e-6
            or not np.isfinite(scored["rawPrediction"]).all()
            or S.tree_score_launches != 1):
        failures.append(f"transform: {rec}")
    # tree_score at the 7-class model's rows (K = 7, F = 54): the
    # transform's raw route and the served binned plane, each against its
    # plain version
    rec["tree_score_held"], ok = scorers_held(
        torch, S, model, x, binned, scored["rawPrediction"])
    if not ok:
        failures.append(f"tree_score: {rec['tree_score_held']}")
    out["fit"] = rec
    del scored, probs

    # the same fit under bagging 0.5 and under GOSS
    for name, extra in (("bagging", dict(baggingFraction=0.5,
                                         baggingFreq=1)),
                        ("goss", dict(boostingType="goss"))):
        m, w, la, _, _ = fit_counted(
            torch, LightGBMClassifier(**COVER_PARAMS, **extra), frame)
        ll = [e["train_multi_logloss"] for e in m.evals_result]
        out[name] = {**fit_record(m, w, n), "launches": la,
                     "multi_logloss_first": ll[0],
                     "multi_logloss_last": ll[-1]}
        if la != expected or not ll[-1] < ll[0]:
            failures.append(f"{name}: {out[name]}")

    # card vs CPU: 100,000 rows, 5 iterations
    small = DataFrame({"features": x[:100_000], "label": y[:100_000]})
    res = {dev: LightGBMClassifier(**dict(COVER_PARAMS, numIterations=5))
           .set_device(dev).fit(small) for dev in ("cuda", "cpu")}
    a, c = res["cuda"].booster, res["cpu"].booster
    roots_equal = (np.array_equal(a.split_feature[:, 0], c.split_feature[:, 0])
                   and np.array_equal(a.threshold_bin[:, 0],
                                      c.threshold_bin[:, 0]))
    ll = {dev: m.evals_result[-1]["train_multi_logloss"]
          for dev, m in res.items()}
    rel = abs(ll["cuda"] - ll["cpu"]) / abs(ll["cpu"])
    out["card_vs_cpu"] = {"rows": 100_000, "trees": a.num_trees,
                          "roots_equal": roots_equal,
                          "multi_logloss_cuda": ll["cuda"],
                          "multi_logloss_cpu": ll["cpu"], "rel_diff": rel,
                          "tol": 1e-4}
    if not roots_equal or rel > 1e-4 or a.num_trees != 5 * k:
        failures.append(f"card vs CPU: {out['card_vs_cpu']}")

    out["serving"], ok = serving_record(model, x[:256].astype(np.float64))
    if not ok:
        failures.append(f"serving: {out['serving']}")
    if failures:
        raise AssertionError(json.dumps({"failures": failures, **out},
                                        default=str))
    return out


# breadth_path: the bench fit under each in-step setting (ROADMAP A7),
# then all three; max_bin=1023 on uint16 ids; EFB on one-hot data
BREADTH_WIDE = 1023
BREADTH_SETTINGS = {
    "monotone": dict(monotone_constraints=(1, 1, -1, -1)),
    "extra_trees": dict(extra_trees=True),
    "by_node": dict(feature_fraction_by_node=0.7),
    "all_three": dict(monotone_constraints=(1, 1, -1, -1), extra_trees=True,
                      feature_fraction_by_node=0.7),
}
SWEEP_ROWS = 4096
ONEHOT_ROWS = 1_000_000
ONEHOT_FIELDS = (16, 32, 64, 144)


def onehot_data(n, seed=0):
    """The bench's 28 HIGGS-shaped float32 columns, then one-hot fields of
    16, 32, 64 and 144 values (one 1.0 per row per field), as a
    OneHotEncoder -> VectorAssembler pipeline hands them to LightGBM; the
    label from the dense columns' logit plus an effect per category."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, F)).astype(np.float32)
    logit = (x[:, 0] * 1.2 - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
             + 0.3 * np.sin(x[:, 4] * 3))
    blocks = [x]
    for k in ONEHOT_FIELDS:
        cat = rng.integers(0, k, size=n)
        logit = logit + rng.normal(size=k)[cat] * 0.5
        block = np.zeros((n, k), np.float32)
        block[np.arange(n), cat] = 1.0
        blocks.append(block)
    y = (logit + rng.normal(size=n) * 0.5 > 0).astype(np.float64)
    return np.hstack(blocks), y


def u16_to_card(torch, a):
    """A uint16 numpy matrix on the card (through int16's bits: torch
    converts little to or from uint16)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).to(
        "cuda").view(torch.uint16)


def counted_fit(torch, fn):
    """(result, wall s, {counter: launches}) of ``fn()``, the histogram
    counters set to 0 just before it."""
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H

    names = ("hist_kernel_launches", "hist_u16_kernel_launches",
             "hist_i32_kernel_launches", "hist_quant_kernel_launches",
             "hist_quant_u16_kernel_launches",
             "hist_quant_i32_kernel_launches")
    torch.cuda.synchronize()
    for name in names:
        setattr(H, name, 0)
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, {n: getattr(H, n) for n in names}


def sweep_violation(torch, booster, binned_d, rows, feature, direction):
    """The largest step against ``direction`` of the raw score (exact:
    0.0 where there is none) when ``feature``'s bin sweeps every bin of
    the fit with the other bins of each of ``rows`` fixed; one
    ``predict_binned`` call on the card."""
    top = int(binned_d[:, feature].max().item()) + 1
    probe = binned_d[rows].repeat_interleave(top, dim=0)
    probe[:, feature] = torch.arange(top, device="cuda").repeat(
        len(rows)).to(probe.dtype)
    raw = booster.predict_binned(probe).reshape(len(rows), top)
    return float((-(raw[:, 1:] - raw[:, :-1]) * direction).max().item())


def node_masks_hold(torch, booster, cfg):
    """Every split of a ``feature_fraction_by_node`` fit lies in its
    node's feature subset, drawn again here from the tree's stream
    (``sampling.tree_keys``) exactly as the fit drew it: (splits checked,
    splits outside)."""
    from mmlspark_tpu_torch.models.gbdt import sampling

    depth = cfg.effective_depth
    f = booster.num_features
    checked = outside = 0
    for t in range(booster.num_trees):
        sf = booster.split_feature[t]
        for d in range(depth):
            width = 2 ** d
            mask = sampling.node_feature_mask(sampling.draw(
                sampling.tree_keys(cfg, 0, t) + (sampling.NODE_FEATURES, d),
                width * f, torch.device("cuda")).reshape(width, f), None,
                cfg.feature_fraction_by_node).cpu().numpy()
            for i in range(width):
                feat = sf[width - 1 + i]
                if feat >= 0:
                    checked += 1
                    outside += int(not mask[i, feat])
    return checked, outside


def phase_breadth(ctx):
    """A7's in-step breadth at the bench's shape (2,000,000 x 28 float32,
    binary, 63 leaves, depth 6, 20 trees): (a) ``max_bin=1023`` on uint16
    ids — the f32 and q16 fits (two fits bitwise, bitwise the uncaptured
    step, 6 launches of the uint16 kernel per replay), ``predict_binned``
    on the uint16 rows bitwise ``tree_score``'s plain version, and a
    ``LightGBMClassifier(maxBin=1023)`` fit, transform and binned serving
    plane; (b) monotone constraints (+1 on features 0-1, -1 on 2-3),
    ``extra_trees``, ``feature_fraction_by_node=0.7`` and all three: each
    fit captured bitwise uncaptured, 120 launches, every constrained
    feature swept over its bins for 4,096 rows with no raw score moving
    against its direction, every split of a by-node fit inside its
    node's drawn subset, card vs CPU at 100,000 rows and 5 trees; (c) EFB
    on 1,000,000 rows of 28 dense and 256 one-hot columns (fields of 16,
    32, 64 and 144): the plan, its time and width, the unbundled level
    histogram against the direct one (counts and every other cell
    bitwise, default bins within float32 rounding) at every level width,
    with the bundled and the direct histogram's device ms per tree, the
    bundled one's bound and ``index_add_`` time, the fit's histogram
    kernels' device ms per tree and ``train`` s with
    ``MMLSPARK_TORCH_EFB`` at auto and off, and their final loglosses
    within 1e-4."""
    import torch

    from mmlspark_tpu_torch import (BinMapper, DataFrame, LightGBMClassifier,
                                    TrainConfig, train)
    from mmlspark_tpu_torch.core.env import EFB, env_override
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.models.gbdt import score_cuda as S
    from mmlspark_tpu_torch.models.gbdt import trainer as T
    from mmlspark_tpu_torch.ops import efb
    from mmlspark_tpu_torch.ops.ingest import binned_ingest_dtype

    out = {"card": ctx["smi"]}
    failures = []
    expected = TREES * 6

    # (a) max_bin=1023 on uint16 ids
    x, y = make_data(N)
    mapper = BinMapper.fit(x[:100_000], max_bin=BREADTH_WIDE)
    binned = mapper.transform(x, np.uint16)
    bin_upper = mapper.bin_upper_values(BREADTH_WIDE)
    _, _, _, main_cfg = ctx["main_inputs"]
    cfg = dataclasses.replace(main_cfg, max_bin=BREADTH_WIDE)
    wide = {"max_bin": BREADTH_WIDE, "largest_bin": int(binned.max()),
            "bytes": int(binned.nbytes)}
    for plane, counter in (("off", "hist_u16_kernel_launches"),
                           ("q16", "hist_quant_u16_kernel_launches"),
                           ("q8", "hist_quant_u16_kernel_launches")):
        with knobs(quant=plane):
            # the first fit captures the step; the second replays it
            r2 = train(binned, y, cfg, bin_upper=bin_upper)
            r1, wall, launches = counted_fit(torch, lambda: train(
                binned, y, cfg, bin_upper=bin_upper))
            r3 = train(binned, y, cfg, bin_upper=bin_upper, capture=False)
        lls = [e["train_binary_logloss"] for e in r1.evals]
        rec = {"fit_s": wall, "capture_s": r2.step_stats["capture_s"],
               "launches": launches,
               "launches_per_replay": launches[counter] / TREES,
               "captured": r1.step_stats["captured"],
               "two_fits_bitwise": boosters_equal(r1.booster, r2.booster),
               "captured_bitwise_uncaptured": boosters_equal(r1.booster,
                                                             r3.booster),
               "logloss_first": lls[0], "logloss_last": lls[-1],
               "thresholds_past_255": int((r1.booster.threshold_bin
                                           > 255).sum())}
        wide[plane] = rec
        ctx["launches"][f"breadth_path_u16_{plane}"] = launches[counter]
        if (launches[counter] != expected
                or sum(launches.values()) != expected
                or not (rec["two_fits_bitwise"] and rec["captured"]
                        and rec["captured_bitwise_uncaptured"])
                or not lls[-1] < lls[0] or not rec["thresholds_past_255"]):
            failures.append(f"max_bin=1023 {plane}: {rec}")
        if plane == "off":
            booster = r1.booster
    binned_d = u16_to_card(torch, binned)
    tables = booster.predict_binned_scorer("off", "cuda").tables
    wide["tree_score"], got, ok = scorer_held(torch, S, "uint16", tables,
                                              binned_d)
    wide["predict_binned_bitwise"] = bool(torch.equal(
        booster.predict_binned(binned_d), got))
    if not ok or not wide["predict_binned_bitwise"]:
        failures.append(f"uint16 scoring: {wide['tree_score']}")
    del got
    frame = DataFrame({"features": x, "label": y})
    est = LightGBMClassifier(numIterations=TREES, numLeaves=63, maxDepth=6,
                             maxBin=BREADTH_WIDE)
    model, wall, launches = counted_fit(torch, lambda: est.fit(frame))
    t0 = time.perf_counter()
    scored = model.transform(DataFrame({"features": x}))
    wide["estimator"] = {**fit_record(model, wall, N), "launches": launches,
                         "transform_s": time.perf_counter() - t0,
                         "binned_ids": str(np.dtype(binned_ingest_dtype(
                             model.bin_mapper.max_num_bins)))}
    wide["serving"], ok = serving_record(model, x[:256].astype(np.float64))
    if (not ok or launches["hist_u16_kernel_launches"] != expected
            or not np.isfinite(scored["rawPrediction"]).all()):
        failures.append(f"maxBin=1023 estimator: {wide['estimator']}, "
                        f"{wide['serving']}")
    out["max_bin_1023"] = wide
    del binned_d, scored, model, binned

    # (b) the settings on the bench fit, max_bin=255
    binned, y, bin_upper, main_cfg = ctx["main_inputs"]
    binned_d = torch.as_tensor(binned, device="cuda")
    rows = torch.as_tensor(np.random.default_rng(7).choice(
        N, SWEEP_ROWS, replace=False), device="cuda")
    x1, y1 = make_data(100_000, seed=1)
    m1 = BinMapper.fit(x1, max_bin=255)
    b1 = m1.transform(x1)
    settings = {}
    for name, extra in BREADTH_SETTINGS.items():
        c = dataclasses.replace(main_cfg, **extra)
        first = train(binned, y, c, bin_upper=bin_upper)     # captures
        res, wall, launches = counted_fit(torch, lambda: train(
            binned, y, c, bin_upper=bin_upper))
        unc = train(binned, y, c, bin_upper=bin_upper, capture=False)
        lls = [e["train_binary_logloss"] for e in res.evals]
        rec = {"fit_s": wall, "capture_s": first.step_stats["capture_s"],
               "two_fits_bitwise": boosters_equal(first.booster,
                                                  res.booster),
               "launches": launches["hist_kernel_launches"],
               "captured": res.step_stats["captured"],
               "captured_bitwise_uncaptured": boosters_equal(res.booster,
                                                             unc.booster),
               "logloss_first": lls[0], "logloss_last": lls[-1],
               "features_split_on": sorted({int(f) for f in np.unique(
                   res.booster.split_feature) if f >= 0})}
        ok = (rec["launches"] == expected and rec["captured"]
              and rec["two_fits_bitwise"]
              and rec["captured_bitwise_uncaptured"] and lls[-1] < lls[0])
        if c.has_monotone:
            rec["sweep_rows"] = SWEEP_ROWS
            rec["worst_step_against"] = {
                str(f): sweep_violation(torch, res.booster, binned_d, rows, f,
                                        d)
                for f, d in enumerate(c.monotone_constraints) if d}
            ok = ok and all(v <= 0.0 for v in
                            rec["worst_step_against"].values())
        if c.feature_fraction_by_node < 1.0:
            rec["splits_checked"], rec["splits_outside_node_subset"] = \
                node_masks_hold(torch, res.booster, c)
            ok = ok and not rec["splits_outside_node_subset"]
        c5 = dataclasses.replace(c, num_iterations=5)
        pair = {dev: train(b1, y1, c5, device=dev) for dev in ("cuda", "cpu")}
        a, b = pair["cuda"].booster, pair["cpu"].booster
        ll = {dev: r.evals[-1]["train_binary_logloss"]
              for dev, r in pair.items()}
        rec["card_vs_cpu"] = {
            "rows": 100_000, "trees": 5,
            "roots_equal": bool(np.array_equal(a.split_feature[:, 0],
                                               b.split_feature[:, 0])
                                and np.array_equal(a.threshold_bin[:, 0],
                                                   b.threshold_bin[:, 0])),
            "logloss_cuda": ll["cuda"], "logloss_cpu": ll["cpu"],
            "rel_diff": abs(ll["cuda"] - ll["cpu"]) / abs(ll["cpu"]),
            "tol": 1e-4}
        ok = (ok and rec["card_vs_cpu"]["roots_equal"]
              and rec["card_vs_cpu"]["rel_diff"] <= 1e-4)
        settings[name] = rec
        emit({"phase": "breadth_setting", "setting": name, **rec})
        if not ok:
            failures.append(f"{name}: {rec}")
    ctx["launches"]["breadth_path_settings"] = sum(
        r["launches"] for r in settings.values())
    out["settings"] = settings
    del binned_d

    # (c) EFB on one-hot data
    xo, yo = onehot_data(ONEHOT_ROWS)
    mo = BinMapper.fit(xo[:100_000], max_bin=255)
    bo = mo.transform(xo, np.uint8)
    del xo
    # the plan and the bundling, each on the card as ``train`` makes them
    # (``trainer.plan_efb``); the unbundled histograms below hold both
    bo_d = torch.as_tensor(bo, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = efb.plan_bundles(bo_d, 255, mode="auto")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bu_d = efb.apply_plan(bo_d, plan)
    torch.cuda.synchronize()
    bundle_s = time.perf_counter() - t0
    rec = {"rows": ONEHOT_ROWS, "columns": bo.shape[1],
           "bytes": int(bo.nbytes), "plan_on_card_s": plan_s,
           "bundle_on_card_s": bundle_s,
           "efb_bundles": len(plan.bundles),
           "efb_bundled_features": plan.n_bundled_features,
           "bundled_width": plan.n_cols}
    if (len(plan.bundles) != len(ONEHOT_FIELDS)
            or plan.n_bundled_features != sum(ONEHOT_FIELDS)):
        failures.append(f"EFB plan: {rec}")
    # the unbundled level histogram against the direct one, widths 1 and 8
    gen = torch.Generator(device="cuda").manual_seed(3)
    g = torch.randn(ONEHOT_ROWS, generator=gen, device="cuda")
    h = torch.rand(ONEHOT_ROWS, generator=gen, device="cuda") + 0.1
    live = torch.ones(ONEHOT_ROWS, device="cuda")
    maps = efb.device_maps(plan, "cuda")
    md = np.zeros((bo.shape[1], 255), bool)
    md[[m.feature for bd in plan.bundles for m in bd],
       [m.default_bin for bd in plan.bundles for m in bd]] = True
    md_d = torch.as_tensor(md, device="cuda")
    hist_rec, per_tree = {}, {}
    for width in WIDTHS:
        local = torch.randint(0, width, (ONEHOT_ROWS,), generator=gen,
                              device="cuda")
        args = (g, h, live, local, width)
        direct = H.level_histogram(bo_d, *args, bo.shape[1], 255)
        unb = T._unbundle_hist(H.level_histogram(
            bu_d, *args, plan.n_cols, 255), maps, bo.shape[1], 255)
        absum = H.level_histogram(bu_d[:, :1].contiguous(), g.abs(), h.abs(),
                                  live, local, width, 1, 255)[:, 0].sum(1)
        err = (unb - direct).abs()
        bound = 4.0 * F32_EPS * absum[:, None, None, :]
        # the bundled matrix's histogram: the kernel, its bound (bytes:
        # the bundled ids, stats and node ids read once, the histogram
        # written once; 3 adds per live pair) and one f32 index_add_
        idx = H.flat_index(bu_d, local, plan.n_cols, 255)
        src = torch.stack([g * live, h * live, live], -1)[:, None, :] \
            .expand(ONEHOT_ROWS, plan.n_cols, 3).reshape(-1, 3)
        nbytes = (sum(t.numel() * t.element_size()
                      for t in (bu_d, g, h, live, local))
                  + width * plan.n_cols * 255 * 3 * 4)
        ops = 3 * plan.n_cols * ONEHOT_ROWS
        r = {
            "counts_bitwise": bool(torch.equal(unb[..., 2], direct[..., 2])),
            "other_cells_bitwise": bool(torch.equal(
                unb[:, ~md_d], direct[:, ~md_d])),
            "default_bins_max_abs_err": float(err[:, md_d].max().item()),
            "default_bins_within_bound": bool(
                (err[..., :2] <= bound[..., :2]).all().item()),
            "direct_device_ms": device_ms(torch, lambda: H.level_histogram(
                bo_d, *args, bo.shape[1], 255)),
            "bundled_device_ms": device_ms(torch, lambda: H.level_histogram(
                bu_d, *args, plan.n_cols, 255)),
            "bundled_bound_ms": max(nbytes / MEM_BYTES_PER_S,
                                    ops / F32_OPS_PER_S) * 1e3,
            "bundled_plain_ms": time_ms(
                torch, lambda: H.level_histogram_reference(
                    bu_d, *args, plan.n_cols, 255), reps=3, warmup=1),
            "bundled_library_ms": time_ms(torch, lambda: torch.zeros(
                (width * plan.n_cols * 255, 3), device="cuda").index_add_(
                    0, idx, src), reps=5)}
        del idx, src
        hist_rec[f"width_{width}"] = r
        for k in ("direct_device_ms", "bundled_device_ms",
                  "bundled_bound_ms", "bundled_plain_ms",
                  "bundled_library_ms"):
            per_tree[k] = per_tree.get(k, 0.0) + r[k]
        if not (r["counts_bitwise"] and r["other_cells_bitwise"]
                and r["default_bins_within_bound"]):
            failures.append(f"unbundled histogram at width {width}: {r}")
    hist_rec["per_tree"] = per_tree
    ctx["efb_hist_per_tree"] = per_tree
    rec["histogram"] = hist_rec
    del bo_d, bu_d, direct, unb
    cfg_o = dataclasses.replace(main_cfg, max_bin=255)
    fits = {}
    for mode in ("auto", "off"):
        with env_override(EFB, mode):
            first = train(bo, yo, cfg_o)                     # captures
            res, wall, launches = counted_fit(torch, lambda: train(
                bo, yo, cfg_o))
            _, by_name = device_ms_by_kernel(torch, lambda: train(
                bo, yo, dataclasses.replace(cfg_o, num_iterations=5)))
        copies = sum(v for k, v in by_name.items() if "Memcpy" in k)
        fits[mode] = {"train_s": wall,
                      "capture_s": first.step_stats["capture_s"],
                      "two_fits_bitwise": boosters_equal(first.booster,
                                                         res.booster),
                      "launches": launches["hist_kernel_launches"],
                      "hist_stats": res.hist_stats,
                      "hist_device_ms_per_tree": hist_device_ms(by_name) / 5,
                      # kernels only: the 5-tree fit's copies (the rows'
                      # upload) apart
                      "device_busy_ms_per_tree":
                          (sum(by_name.values()) - copies) / 5,
                      "copies_ms_5_trees": copies,
                      "top_device_ms_5_trees": top(by_name, 8),
                      "logloss_last":
                          res.evals[-1]["train_binary_logloss"]}
    rec["fits"] = fits
    rec["logloss_abs_diff"] = abs(fits["auto"]["logloss_last"]
                                  - fits["off"]["logloss_last"])
    ctx["launches"]["breadth_path_efb"] = fits["auto"]["launches"]
    if (rec["logloss_abs_diff"] > 1e-4
            or fits["auto"]["hist_stats"]["efb_bundles"] != len(ONEHOT_FIELDS)
            or fits["off"]["hist_stats"]["efb_bundles"] != 0
            or fits["auto"]["launches"] != expected
            or not all(f["two_fits_bitwise"] for f in fits.values())):
        failures.append(f"EFB: {rec}")
    out["efb"] = rec
    if failures:
        raise AssertionError(json.dumps({"failures": failures, **out},
                                        default=str))
    return out


# the leaf-wise and DART paths: LightGBM's GPU-performance HIGGS settings
# (docs/GPU-Performance.rst: max_bin 63, num_leaves 255, learning_rate
# 0.1, min_data_in_leaf 1, min_sum_hessian_in_leaf 100; max_depth unset,
# so the port's depth cap is 8) on the bench's 2M x 28 rows, cut to 20
# trees
LEAF_BINS = 63
LEAF_PARAMS = dict(objective="binary", num_iterations=TREES, num_leaves=255,
                   max_depth=-1, max_bin=LEAF_BINS, learning_rate=0.1,
                   min_sum_hessian_in_leaf=100.0, min_data_in_leaf=1)
LEAF_PROFILE_TREES = 3
# width-1 calls on a node's membership (the leaf-wise builder's): the
# root (every row), a node of half the rows and one of 2% of them
MEMBER_SHARES = (1.0, 0.5, 0.02)
WIDTH1_BINS = ((LEAF_BINS, "uint8"), (1023, "uint16"))


@contextlib.contextmanager
def grow_policy(policy):
    """``MMLSPARK_TORCH_GROW_POLICY`` for the fits inside the block."""
    name = "MMLSPARK_TORCH_GROW_POLICY"
    saved = os.environ.get(name)
    os.environ[name] = policy
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def width1_rows(torch, bins=WIDTH1_BINS, shares=MEMBER_SHARES):
    """``level_hist`` at width 1 with a node's membership as ``live`` (the
    leaf-wise builder's call) on the bench's 2M x 28 rows, at each (B, id
    dtype) of ``bins`` (B = 63 uint8 and B = 1,023 uint16 ids unless
    given), for each share of ``shares``: bitwise against its plain
    version on float stats, bitwise between two launches, with
    event-pair, device, plain and ``index_add_`` times, the bound (the
    bytes the kernel must move: ``live`` of every row, the member rows'
    ids, grad, hess and node index, the output; the adds of the member
    rows) and the launch's grid."""
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    dev = torch.device("cuda")
    rows = []
    make = {"uint8": lambda gen, b: torch.randint(
                0, b, (N, F), generator=gen, device=dev, dtype=torch.uint8),
            "uint16": lambda gen, b: u16_ids(torch, gen, N, F, b, dev),
            "int32": lambda gen, b: i32_ids(torch, gen, N, F, b, dev)}
    for b, ids in bins:
        gen = torch.Generator(device=dev).manual_seed(b)
        binned = make[ids](gen, b)
        g = torch.randn(N, generator=gen, device=dev)
        h = torch.rand(N, generator=gen, device=dev) * 0.9 + 0.1
        local = torch.zeros(N, dtype=torch.int32, device=dev)
        # each row's node at depth 6 of a random routing: a share of the
        # rows is one node's membership
        u = torch.rand(N, generator=gen, device=dev)
        geometry = H.launch_geometry("f32", F, b, binned.element_size())
        for share in shares:
            live = (u < share).float()
            args = (binned, g, h, live, local, 1, F, b)
            k1, k2 = H.level_histogram(*args), H.level_histogram(*args)
            p = H.level_histogram_reference(*args)
            torch.cuda.synchronize()
            bitwise, repeat = bool(torch.equal(k1, p)), bool(
                torch.equal(k1, k2))
            err = float((k1 - p).abs().max().item())
            del k1, k2, p
            kernel_ms = time_ms(torch, lambda: H.level_histogram(*args))
            kernel_device_ms = device_ms(torch,
                                         lambda: H.level_histogram(*args))
            plain_ms = time_ms(torch, lambda: H.level_histogram_reference(
                *args), reps=3, warmup=1)
            idx = H.flat_index(binned, local, F, b)
            src = torch.stack([g * live, h * live, live], -1)[:, None, :] \
                .expand(N, F, 3).reshape(-1, 3)
            library_ms = time_ms(torch, lambda: torch.zeros(
                (F * b, 3), device=dev).index_add_(0, idx, src))
            del idx, src
            # the kernel reads a row past its live flag only where the
            # row is a member: count this run's members
            members = int(live.sum().item())
            row_bytes = F * binned.element_size() + sum(
                t.element_size() for t in (g, h, local))
            in_bytes = live.numel() * live.element_size() + \
                members * row_bytes
            out_bytes = F * b * 3 * 4
            ops = 3 * F * members
            bytes_ms = (in_bytes + out_bytes) / MEM_BYTES_PER_S * 1e3
            ops_ms = ops / F32_OPS_PER_S * 1e3
            row = {"n": N, "f": F, "b": b, "ids": ids, "width": 1,
                   "member_share": share, "geometry": geometry,
                   "bitwise": bitwise,
                   "repeat_bitwise": repeat, "max_abs_err": err,
                   "kernel_ms": kernel_ms,
                   "kernel_device_ms": kernel_device_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations"}
            emit({"phase": "kernel_width1_vs_plain", **row})
            rows.append(row)
            if not (bitwise and repeat):
                raise AssertionError(f"level_hist at width 1 on a node's "
                                     f"membership disagrees: {row}")
        del binned
        torch.cuda.empty_cache()
    return rows


def leafwise_inputs():
    x, y = make_data(N)
    from mmlspark_tpu_torch import BinMapper
    mapper = BinMapper.fit(x[:100_000], max_bin=LEAF_BINS)
    return mapper.transform(x), y, mapper.bin_upper_values(LEAF_BINS)


def phase_leafwise(ctx):
    """Leaf-wise growth (``MMLSPARK_TORCH_GROW_POLICY=leafwise``) at
    LightGBM's GPU-performance HIGGS settings on the bench's 2M x 28
    rows (``LEAF_PARAMS``, 20 trees): the fit's wall, its histogram
    launches (one width-1 ``level_hist`` call per histogrammed node, the
    counter against the builder's own count), the per-tree split of the
    time into the histogram kernel's device ms (torch.profiler over a
    3-tree fit), the split search and the host reads (the builder's host
    clocks), the logloss falling, two fits bitwise equal, the same fit
    depthwise (wall, logloss), ``tree_score`` on the depth-8 booster
    bitwise its plain version, and card vs CPU at 100,000 rows and 5
    trees: L2 trees equal in every array (the objective, the histograms,
    the host's split search and the routing are the same bits on both),
    binary roots equal."""
    import torch

    from mmlspark_tpu_torch import TrainConfig, train
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.models.gbdt import score_cuda as S

    binned, y, bin_upper = leafwise_inputs()
    cfg = TrainConfig(**LEAF_PARAMS)
    binned_d = torch.as_tensor(binned, device="cuda")
    out = {"params": LEAF_PARAMS, "effective_depth": cfg.effective_depth,
           "card": ctx["smi"]}
    failures = []
    with grow_policy("leafwise"):
        train(binned, y, TrainConfig(**dict(LEAF_PARAMS, num_iterations=1)),
              bin_upper=bin_upper)                         # warm-up
        torch.cuda.synchronize()
        H.hist_kernel_launches = H.hist_quant_kernel_launches = 0
        H.hist_u16_kernel_launches = 0
        t0 = time.perf_counter()
        res = train(binned, y, cfg, bin_upper=bin_upper)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = H.hist_kernel_launches
        quant_launches = H.hist_quant_kernel_launches + \
            H.hist_u16_kernel_launches
        again = train(binned, y, cfg, bin_upper=bin_upper)
        prof_cfg = dataclasses.replace(cfg, num_iterations=LEAF_PROFILE_TREES)
        prof = {}

        def profiled():
            prof["res"] = train(binned, y, prof_cfg, bin_upper=bin_upper)

        wall_ms, by_name = device_ms_by_kernel(torch, profiled)
    ctx["launches"]["leafwise_path"] = launches
    loop = res.step_stats["host_loop"]
    ploop = prof["res"].step_stats["host_loop"]
    busy = sum(by_name.values())
    lls = [e["train_binary_logloss"] for e in res.evals]
    booster = res.booster
    leaves = (booster.split_feature >= 0).sum(axis=1) + 1
    out.update({
        "fit_s": fit_s, "trees": booster.num_trees,
        "hist_stats": res.hist_stats, "host_loop": loop,
        "launches": launches, "launches_per_tree": launches / TREES,
        "other_hist_launches": quant_launches,
        "leaves_per_tree": [int(v) for v in leaves],
        "two_fits_bitwise": boosters_equal(booster, again.booster),
        "logloss_first": lls[0], "logloss_last": lls[-1],
        "per_tree": {
            "wall_ms": wall_ms / LEAF_PROFILE_TREES,
            "hist_kernel_device_ms": hist_device_ms(by_name)
            / LEAF_PROFILE_TREES,
            "device_busy_ms": busy / LEAF_PROFILE_TREES if busy
            else "not measured",
            "device_idle_share": 1 - busy / wall_ms if busy
            else "not measured",
            "hist_calls": ploop["hist_calls"] / LEAF_PROFILE_TREES,
            "host_reads": ploop["host_reads"] / LEAF_PROFILE_TREES,
            "split_search_ms": ploop["search_s"] * 1e3 / LEAF_PROFILE_TREES,
            "hist_enqueue_ms": ploop["hist_s"] * 1e3 / LEAF_PROFILE_TREES,
            "host_read_wait_ms": ploop["read_s"] * 1e3 / LEAF_PROFILE_TREES,
            "top_ms": {k: v / LEAF_PROFILE_TREES
                       for k, v in top(by_name, 8).items()}},
        "unprofiled_per_tree_ms": fit_s * 1e3 / TREES,
        "unprofiled_split_search_ms_per_tree": loop["search_s"] * 1e3 / TREES,
        "unprofiled_host_read_wait_ms_per_tree": loop["read_s"] * 1e3 / TREES,
    })
    if (launches != loop["hist_calls"] or quant_launches
            or res.hist_stats["grow_policy"] != "leafwise"):
        failures.append(f"launches {launches} (builder {loop['hist_calls']}),"
                        f" other kernels {quant_launches}, "
                        f"{res.hist_stats}")
    if leaves.max() > 255 or leaves.max() < 100:
        failures.append(f"leaves per tree {leaves.tolist()}")
    if not out["two_fits_bitwise"]:
        failures.append("two leaf-wise fits differ")
    if not (all(b <= a + 1e-7 for a, b in zip(lls, lls[1:]))
            and lls[-1] < lls[0]):
        failures.append(f"logloss does not fall: {lls}")

    # the same fit depthwise (the captured step: 8 levels, widths to 128)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    depth = train(binned, y, cfg, bin_upper=bin_upper)
    torch.cuda.synchronize()
    out["depthwise"] = {
        "fit_s": time.perf_counter() - t0,
        "grow_policy": depth.hist_stats["grow_policy"],
        "logloss_last": depth.evals[-1]["train_binary_logloss"],
        "leaves_per_tree_max": int(((depth.booster.split_feature >= 0)
                                    .sum(axis=1) + 1).max())}

    # tree_score on the depth-8 booster (511 slots, leaves at uneven
    # depths): bitwise its plain version at the 2M binned rows, and its
    # logloss the fit's last
    tables = booster.predict_binned_scorer("off", "cuda").tables
    rec, scores, ok = scorer_held(torch, S, "leafwise_2M", tables, binned_d)
    out["tree_score"] = rec
    scored_ll = logloss(scores.cpu().numpy(), y)
    out["scored_logloss"] = scored_ll
    if not ok or abs(scored_ll - lls[-1]) > 1e-5 * abs(lls[-1]):
        failures.append(f"tree_score on the leaf-wise booster: {rec}, "
                        f"logloss {scored_ll} against {lls[-1]}")
    del scores, binned_d

    # card vs CPU at 100,000 rows and 5 trees
    small = binned[:100_000]
    cvc = {}
    with grow_policy("leafwise"):
        for objective, label in (("regression", y[:100_000] * 2.0 - 1.0),
                                 ("binary", y[:100_000])):
            c = TrainConfig(**dict(LEAF_PARAMS, objective=objective,
                                   num_iterations=5))
            res2 = {dev: train(small, label, c, bin_upper=bin_upper,
                               device=dev) for dev in ("cuda", "cpu")}
            a, b = res2["cuda"].booster, res2["cpu"].booster
            equal = int(sum(all(np.array_equal(getattr(a, k)[t],
                                               getattr(b, k)[t])
                                for k in BOOSTER_ARRAYS)
                            for t in range(a.num_trees)))
            cvc[objective] = {"trees": a.num_trees,
                              "trees_equal_in_every_array": equal,
                              "roots_equal": bool(np.array_equal(
                                  a.split_feature[:, 0],
                                  b.split_feature[:, 0]))}
    out["card_vs_cpu"] = cvc
    if (cvc["regression"]["trees_equal_in_every_array"] != 5
            or not cvc["binary"]["roots_equal"]):
        failures.append(f"card and CPU leaf-wise fits differ: {cvc}")
    if failures:
        emit({"phase": "leafwise_path_detail", **out})
        raise AssertionError("; ".join(failures))
    return out


DART_ES = dict(numIterations=60, learningRate=1.0, earlyStoppingRound=3,
               numLeaves=63, maxDepth=6, maxBin=255, boostingType="dart")


def phase_dart(ctx):
    """DART (``boosting_type="dart"``, LightGBM's default drop settings:
    drop_rate 0.1, skip_drop 0.5, max_drop 50) on the bench fit (2M x
    28, 63 leaves, depth 6, 20 trees) through the host loop, on the
    float32 and q8 planes: each fit's wall against the captured gbdt
    fit's, 120 launches of the plane's kernel, two fits bitwise, the
    tree weights (drops drawn), the logloss of the DART ensemble at the
    end below the base score's; a ``LightGBMClassifier(boostingType=
    "dart")`` fit on the 2M rows with 10% validating and
    ``earlyStoppingRound`` 3 (60 iterations at learning rate 1.0): the
    stop, its ``transform`` through ``tree_score.cu`` bitwise its plain
    version; card vs CPU at 100,000 rows and 5 trees (L2 leaf-wise:
    every array of all 5 trees equal; L2 depthwise: splits and counts
    equal, node values within 1e-5 of the largest; binary: weights and roots
    equal, logloss within 1e-4 relative). The kept per-tree
    predictions: 20 x 8 MB on the card."""
    import torch

    from mmlspark_tpu_torch import (BinMapper, DataFrame, LightGBMClassifier,
                                    TrainConfig, train)
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.models.gbdt import score_cuda as S

    binned, y, bin_upper, cfg = ctx["main_inputs"]
    dart = dataclasses.replace(cfg, boosting_type="dart")
    binned_d = torch.as_tensor(binned.astype(np.uint8), device="cuda")
    out = {"card": ctx["smi"]}
    failures = []
    ctx["launches"]["dart_path"] = {}
    for quant in ("off", "q8"):
        with knobs(quant=quant):
            train(binned, y, cfg, bin_upper=bin_upper)   # gbdt, captured
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gbdt = train(binned, y, cfg, bin_upper=bin_upper)
            torch.cuda.synchronize()
            gbdt_s = time.perf_counter() - t0
            torch.cuda.reset_peak_memory_stats()
            H.hist_kernel_launches = H.hist_quant_kernel_launches = 0
            t0 = time.perf_counter()
            res = train(binned, y, dart, bin_upper=bin_upper)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            launches = (H.hist_kernel_launches, H.hist_quant_kernel_launches)
            again = train(binned, y, dart, bin_upper=bin_upper)
        plane = "f32" if quant == "off" else quant
        mine = launches[0] if quant == "off" else launches[1]
        ctx["launches"]["dart_path"][plane] = mine
        w = res.booster.tree_weights
        ll_end = booster_logloss(res.booster, binned_d, y)
        ll_base = booster_logloss(res.booster, binned_d, y, trees=0)
        rec = {"fit_s": fit_s, "gbdt_fit_s": gbdt_s,
               "dart_over_gbdt": fit_s / gbdt_s, "launches": mine,
               "other_plane_launches": launches[1] if quant == "off"
               else launches[0],
               "captured": res.step_stats["captured"],
               "hist_stats": res.hist_stats,
               "two_fits_bitwise": boosters_equal(res.booster,
                                                  again.booster),
               "tree_weights": [float(v) for v in w],
               "iterations_dropping": int(np.sum(w[:-1] < 1.0)),
               "logloss_base": ll_base, "logloss_end": ll_end,
               "gbdt_logloss_end": gbdt.evals[-1]["train_binary_logloss"],
               "peak_device_bytes": peak}
        out[plane] = rec
        if (mine != TREES * cfg.effective_depth or rec["other_plane_launches"]
                or rec["captured"] or not rec["two_fits_bitwise"]
                or not (w < 1.0).any() or not ll_end < ll_base
                or res.hist_stats["hist_quant"] != quant):
            failures.append(f"{plane} dart fit: {rec}")

    # the estimator: a validation set and early stopping
    x, _ = make_data(N)
    valid = np.random.default_rng(2).random(N) < 0.1
    frame = DataFrame({"features": x, "label": y, "valid": valid})
    H.hist_kernel_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = LightGBMClassifier(**DART_ES,
                               validationIndicatorCol="valid").fit(frame)
    torch.cuda.synchronize()
    est = {"fit_s": time.perf_counter() - t0,
           "trees": model.booster.num_trees,
           "best_iteration": model.best_iteration,
           "iterations_run": len(model.evals_result),
           "launches": H.hist_kernel_launches}
    ctx["launches"]["dart_path"]["estimator"] = H.hist_kernel_launches
    S.tree_score_launches = 0
    scored = model.transform(DataFrame({"features": x}))
    est["transform_tree_score_launches"] = S.tree_score_launches
    b = model.scoring_booster
    tables = b._scorer(True, "off", "cuda",
                       decision=b.decision_type is not None).tables
    xd = torch.as_tensor(x, device="cuda").to(torch.float32).contiguous()
    rec, got, ok = scorer_held(torch, S, "dart_transform", tables, xd)
    est["tree_score"] = rec
    est["transform_bitwise_tree_score"] = bool(np.array_equal(
        scored["rawPrediction"][:, 1], got.cpu().numpy()))
    out["estimator"] = est
    del xd, got, scored
    if not (ok and est["transform_bitwise_tree_score"]
            and est["iterations_run"] < 60
            and est["trees"] == est["best_iteration"] + 1
            and est["transform_tree_score_launches"] == 1):
        failures.append(f"dart estimator: {est}")

    # card vs CPU at 100,000 rows and 5 trees, drops drawn (skip_drop 0).
    # L2 grown leaf-wise: every array of every tree equal (the objective,
    # the histograms, the drops and rescaling, and the host's float64
    # split search are the same bits on both). L2 depthwise: the weights
    # and every tree's splits and counts equal, node values within 1e-5
    # of the largest |node value| (the card's split finding sums in
    # another order: ulps of a node's sums, which nearly cancel in some).
    # Binary depthwise: its sigmoid differs by ulps too (C10): weights and
    # roots equal, the logloss within 1e-4 relative
    xs, ys = make_data(100_000, seed=1)
    mapper = BinMapper.fit(xs, max_bin=255)
    small = mapper.transform(xs)
    cvc = {}
    for case, objective, policy in (
            ("l2_leafwise", "regression", "leafwise"),
            ("l2_depthwise", "regression", "depthwise"),
            ("binary_depthwise", "binary", "depthwise")):
        c = dataclasses.replace(dart, objective=objective, num_iterations=5,
                                skip_drop=0.0)
        label = ys * 2.0 - 1.0 if objective == "regression" else ys
        with grow_policy(policy):
            res2 = {dev: train(small, label, c, device=dev)
                    for dev in ("cuda", "cpu")}
        a, b2 = res2["cuda"].booster, res2["cpu"].booster

        def same(names, t):
            return all(np.array_equal(getattr(a, k)[t], getattr(b2, k)[t])
                       for k in names)
        nv_a, nv_b = (np.nan_to_num(v.node_value.astype(np.float64))
                      for v in (a, b2))
        scale = float(np.abs(nv_b).max())
        rec = {"grow_policy": res2["cuda"].hist_stats["grow_policy"],
               "weights_equal": bool(np.array_equal(a.tree_weights,
                                                    b2.tree_weights)),
               "tree_weights": [float(v) for v in a.tree_weights],
               "roots_equal": bool(np.array_equal(a.split_feature[:, 0],
                                                  b2.split_feature[:, 0])
                                   and np.array_equal(a.threshold_bin[:, 0],
                                                      b2.threshold_bin[:, 0])),
               "trees_equal_in_every_array": int(sum(
                   same(BOOSTER_ARRAYS, t) for t in range(a.num_trees))),
               "trees_with_equal_splits_and_counts": int(sum(
                   same(("split_feature", "threshold_bin", "count"), t)
                   for t in range(a.num_trees))),
               "node_value_max_abs_diff": float(np.abs(nv_a - nv_b).max()),
               "node_value_max_abs": scale}
        rec["node_value_diff_over_max"] = \
            rec["node_value_max_abs_diff"] / scale
        if objective == "binary":
            ll = {dev: r.evals[-1]["train_binary_logloss"]
                  for dev, r in res2.items()}
            rec.update({"logloss_cuda": ll["cuda"], "logloss_cpu": ll["cpu"],
                        "rel_diff": abs(ll["cuda"] - ll["cpu"])
                        / abs(ll["cpu"])})
        cvc[case] = rec
    out["card_vs_cpu"] = cvc
    leaf, depth, binary = (cvc["l2_leafwise"], cvc["l2_depthwise"],
                           cvc["binary_depthwise"])
    if not (all(r["weights_equal"] for r in cvc.values())
            and (np.asarray(leaf["tree_weights"]) < 1.0).any()
            and leaf["grow_policy"] == "leafwise"
            and leaf["trees_equal_in_every_array"] == 5
            and depth["trees_with_equal_splits_and_counts"] == 5
            and depth["node_value_diff_over_max"] <= 1e-5
            and binary["roots_equal"] and binary["rel_diff"] <= 1e-4):
        failures.append(f"card and CPU dart fits differ: {cvc}")
    if failures:
        emit({"phase": "dart_path_detail", **out})
        raise AssertionError("; ".join(failures))
    return out


# out-of-core training (phase ooc_path): the reference's auto threshold
# (MMLSPARK_TPU_OOC_ROWS) at HIGGS's width, in the trainer's default
# chunks (trainer.OOC_CHUNK_ROWS): 15 of 262,144 rows and one of 67,840
OOC_ROWS = 4_000_000
OOC_CHUNK = 262_144
OOC_CHUNKS = -(-OOC_ROWS // OOC_CHUNK)
OOC_SUMS_CHUNKS = 4                 # the sums entry's check: 4 chunks
OOC_U16_TREES = 3
OOC_ESTIMATOR_TREES = 5
OOC_PROFILE_TREES = 2
OOC_KNOBS = ("MMLSPARK_TORCH_OOC", "MMLSPARK_TORCH_HIST_QUANT",
             "MMLSPARK_TORCH_HIST_SUB")


def rss_bytes():
    """This process's resident set, from /proc/self/statm."""
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


@contextlib.contextmanager
def rss_growth(every_s=0.05):
    """Samples the resident set on a thread while the block runs; yields a
    dict whose ``"growth"`` is then the largest sample minus the one
    before the block (bytes)."""
    out, stop = {"before": rss_bytes(), "peak": 0}, threading.Event()

    def sample():
        while not stop.is_set():
            out["peak"] = max(out["peak"], rss_bytes())
            stop.wait(every_s)

    thread = threading.Thread(target=sample, name="chip-smoke-rss",
                              daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join()
        out["peak"] = max(out["peak"], rss_bytes())
        out["growth"] = out["peak"] - out["before"]


@contextlib.contextmanager
def ooc_env(**values):
    """The out-of-core and histogram knobs for the block: each of
    ``OOC_KNOBS`` unset (the default) unless given (by its name's last
    word: ooc, quant, sub)."""
    from mmlspark_tpu_torch.core.env import env_override
    short = {"ooc": OOC_KNOBS[0], "quant": OOC_KNOBS[1], "sub": OOC_KNOBS[2]}
    with contextlib.ExitStack() as stack:
        for key, name in short.items():
            stack.enter_context(env_override(name, values.get(key)))
        yield


def ooc_counts(H):
    return {"sums": H.hist_quant_sums_kernel_launches,
            "sums_u16": H.hist_quant_sums_u16_kernel_launches,
            "sums_i32": H.hist_quant_sums_i32_kernel_launches,
            "dequant": H.hist_quant_dequant_launches,
            "quant": H.hist_quant_kernel_launches,
            "quant_u16": H.hist_quant_u16_kernel_launches,
            "quant_i32": H.hist_quant_i32_kernel_launches,
            "f32": H.hist_kernel_launches}


def measured(torch, H, fn):
    """(result, record) of ``fn()``: its wall, the device memory it
    allocated at its peak above what was allocated before, its host RSS
    growth and the histogram launches it made (every counter set to 0
    just before it, read just after)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    H.hist_quant_sums_kernel_launches = 0
    H.hist_quant_sums_u16_kernel_launches = 0
    H.hist_quant_sums_i32_kernel_launches = 0
    H.hist_quant_dequant_launches = 0
    H.hist_quant_kernel_launches = H.hist_quant_u16_kernel_launches = 0
    H.hist_quant_i32_kernel_launches = 0
    H.hist_kernel_launches = 0
    with rss_growth() as rss:
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return res, {"wall_s": wall,
                 "device_peak_bytes": torch.cuda.max_memory_allocated() - base,
                 "host_rss_growth_bytes": rss["growth"],
                 "launches": ooc_counts(H)}


@contextlib.contextmanager
def card_filled(torch, leave):
    """The card with about ``leave`` bytes free for the block: a ballast
    tensor takes the rest of what ``trainer.device_free_bytes`` reports,
    so ``MMLSPARK_TORCH_OOC=auto`` sees a card too small for a fit that
    needs more. Yields the free bytes the trainer then sees."""
    from mmlspark_tpu_torch.models.gbdt import trainer as T
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    ballast = torch.empty(T.device_free_bytes(dev) - leave,
                          dtype=torch.uint8, device=dev)
    try:
        yield T.device_free_bytes(dev)
    finally:
        del ballast
        torch.cuda.empty_cache()


def ooc_time_shares(res, wall):
    """The streamed fit's host seconds (``step_stats["ooc"]``) and their
    shares of its wall: chunk reads with their crc32 and the copies into
    pinned memory on the prefetch thread (overlapped with the rest), the
    caller's waits for a chunk and its device-to-store writes."""
    t = res.step_stats["ooc"]
    return {**t, **{f"{k}_share": t[k] / wall for k in (
        "read_s", "stage_s", "wait_s", "store_s")}}


def sums_rows(torch, H, ids, b):
    """The chunk-merge entry (``level_histogram_quant_sums``) against its
    plain version on ``OOC_SUMS_CHUNKS`` chunks of the bench's width, q16,
    every level width: the chunks added one by one into one accumulator,
    one call over all the rows and the plain version equal bit for bit;
    the dequantized merge (``dequantize_sums``) bitwise the one-pass
    kernel (``level_histogram_quant``) and the plain dequantization. One
    chunk call timed (event pair, device), its plain version, the
    ``index_add_`` of the same sums into the accumulator, the bound."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    n = OOC_SUMS_CHUNKS * OOC_CHUNK
    if ids == "uint8":
        binned = torch.randint(0, b, (n, F), generator=gen, device=dev,
                               dtype=torch.uint8)
    elif ids == "int32":
        binned = torch.randint(0, b, (n, F), generator=gen, device=dev,
                               dtype=torch.int32)
    else:
        binned = torch.randint(0, b, (n, F), generator=gen, device=dev,
                               dtype=torch.int16).view(torch.uint16)
    live = (torch.rand(n, generator=gen, device=dev) < 0.9).float()
    qmax = QUANTS["q16"][1]
    gq = torch.round(torch.randn(n, generator=gen, device=dev)
                     .clamp(-4, 4) * (qmax / 4)).to(torch.int16)
    hq = torch.round(torch.rand(n, generator=gen, device=dev)
                     * qmax).to(torch.int16)
    gsi = torch.full((), 2.0 ** -12, device=dev)
    hsi = torch.full((), 2.0 ** -14, device=dev)
    spans = [(s, s + OOC_CHUNK) for s in range(0, n, OOC_CHUNK)]
    rows = []
    for width in WIDTHS:
        local = torch.randint(0, width, (n,), generator=gen, device=dev)

        def part(s, e):
            return (binned[s:e], gq[s:e], hq[s:e], live[s:e], local[s:e],
                    width, F, b)

        acc = torch.zeros((width, F, b, 3), dtype=torch.int64, device=dev)
        for s, e in spans:
            H.level_histogram_quant_sums(*part(s, e), acc)
        one = H.level_histogram_quant_sums(
            *part(0, n), torch.zeros_like(acc))
        plain = H.level_histogram_quant_sums_reference(*part(0, n))
        hist = H.dequantize_sums(acc, gsi, hsi)
        full = H.level_histogram_quant(*part(0, n), gsi, hsi)
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(acc, one) and torch.equal(acc, plain)
                       and torch.equal(hist, full) and torch.equal(
                           hist, H.dequantize_reference(acc, gsi, hsi)))
        err = float((hist - full).abs().max().item())
        del one, plain, full

        chunk = part(*spans[0])
        run = torch.zeros_like(acc)
        kernel_ms = time_ms(torch, lambda: H.level_histogram_quant_sums(
            *chunk, run))
        kernel_device_ms = device_ms(
            torch, lambda: H.level_histogram_quant_sums(*chunk, run))
        plain_ms = time_ms(torch, lambda: run.add_(
            H.level_histogram_quant_sums_reference(*chunk)))
        c_bin, c_gq, c_hq, c_live, c_local = chunk[:5]
        idx = H.flat_index(c_bin, c_local, F, b)
        gate = (c_live > 0).long()
        src = torch.stack([c_gq.long() * gate, c_hq.long() * gate, gate],
                          -1)[:, None, :].expand(OOC_CHUNK, F, 3).reshape(
                              -1, 3)
        flat = run.view(-1, 3)
        library_ms = time_ms(torch, lambda: flat.index_add_(0, idx, src))
        del idx, src
        in_bytes = sum(t.numel() * t.element_size() for t in chunk[:5])
        # Read and write of the accumulator cells the chunk can touch:
        # the whole accumulator, or three int64 cells per kept pair
        # where the chunk's pairs are fewer than its cells.
        kept_pairs = F * int(gate.sum().item())
        acc_bytes = 2 * min(acc.numel(), 3 * kept_pairs) \
            * acc.element_size()
        ops = 3 * kept_pairs
        bytes_ms = (in_bytes + acc_bytes) / MEM_BYTES_PER_S * 1e3
        ops_ms = ops / F32_OPS_PER_S * 1e3
        row = {"ids": ids, "b": b, "width": width, "chunk_rows": OOC_CHUNK,
               "f": F, "chunks": OOC_SUMS_CHUNKS, "bitwise": bitwise,
               "max_abs_err": err, "kernel_ms": kernel_ms,
               "kernel_device_ms": kernel_device_ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bytes": in_bytes + acc_bytes, "ops": ops}
        emit({"phase": "ooc_sums_vs_plain", **row})
        rows.append(row)
        if not bitwise:
            raise AssertionError(f"the sums entry disagrees: {row}")
    return rows


def streamed_chunks(n, seed=1000):
    """The bench's generator chunk by chunk (seed + i for chunk i): no
    array of all the rows is made."""
    for i, s in enumerate(range(0, n, OOC_CHUNK)):
        rng = np.random.default_rng(seed + i)
        x = rng.normal(size=(min(OOC_CHUNK, n - s), F)).astype(np.float32)
        logit = (x[:, 0] * 1.2 - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
                 + 0.3 * np.sin(x[:, 4] * 3))
        y = (logit + rng.normal(size=len(x)) * 0.5 > 0).astype(np.float32)
        yield x, y


def flip_middle(payload):
    """The ``spill.read`` fault's corruption: one bit of the payload."""
    b = bytearray(payload)
    b[len(b) // 2] ^= 0x10
    return bytes(b)


def phase_ooc(ctx):
    """Out-of-core training (``models/gbdt/ooc.py``) at 4,000,000 x 28
    rows of the bench's generator (the reference's auto threshold at
    HIGGS's width), binary, 63 leaves, depth 6, 20 trees, ``max_bin``
    255, default knobs: (i) on a card left (by a ballast tensor) with
    half the bytes the in-core fit needs (``trainer.in_core_bytes``),
    ``train`` streams by itself (16 chunks of up to 262,144 rows, q16),
    its trees bitwise the same rows' in-core q16 fit; with the card's
    room the default fit stays in-core (float32), and the estimate
    holds both in-core fits' measured peaks; under
    ``MMLSPARK_TORCH_OOC=on`` with ``MMLSPARK_TORCH_HIST_SUB=1`` the
    streamed fit is bitwise that in-core fit,
    (iii) with one binned chunk corrupted on its first read (the
    ``spill.read`` fault) and repaired from the rows; the sums entry's
    launches against the builder's count (20 x 6 x 16); (ii) a
    ``train_ooc`` fit over a spill written chunk by chunk from the
    generator with ``fit_streaming`` edges (no array of all the rows), its
    logloss falling; each fit's wall, device peak above its start and
    host RSS growth; (iv) the sums entry bitwise its plain version (uint8
    ids at B = 255 and uint16 at 1,023, chunk by chunk = one pass) with
    its times and bound, and a 3-tree uint16 (``max_bin`` 1023) streamed
    fit at 1,048,576 rows bitwise its in-core fit; (v) a
    ``LightGBMRegressor`` (5 iterations) on the 4M rows streamed through
    ``train`` (``on``); and a 2-tree streamed fit under torch.profiler: device
    time by kernel and uploads per tree."""
    import tempfile

    import torch

    from mmlspark_tpu_torch import (BinMapper, DataFrame, LightGBMRegressor,
                                    TrainConfig, train)
    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.models.gbdt import ooc
    from mmlspark_tpu_torch.models.gbdt import step as step_mod
    from mmlspark_tpu_torch.models.gbdt import trainer as T
    from mmlspark_tpu_torch.ops.ingest import ChunkStore, SpillWriter

    x, y = make_data(OOC_ROWS)
    mapper = BinMapper.fit(x[:100_000], max_bin=B)
    binned = mapper.transform(x, np.uint8)
    bin_upper = mapper.bin_upper_values(B)
    cfg = TrainConfig(objective="binary", num_iterations=TREES,
                      num_leaves=63, max_depth=6, min_data_in_leaf=20)
    depth = cfg.effective_depth
    expected = TREES * depth * OOC_CHUNKS
    records, out = {}, {"card": ctx["smi"], "rows": OOC_ROWS, "f": F,
                        "chunks": OOC_CHUNKS}

    def fit(**knobs):
        with ooc_env(**knobs):
            return measured(torch, H, lambda: train(binned, y, cfg,
                                                     bin_upper=bin_upper))

    # (i) the default path on a card left with half the bytes the in-core
    # fit needs: train streams by itself; then the in-core q16 fit of the
    # same rows, and with the card's room the default fit stays in-core
    # (float32 plane)
    need = T.in_core_bytes(OOC_ROWS, F, B, 2 ** (depth - 1))
    # the trainer's free measure counts a freed tensor's cached segment
    # (the default pool's), as the allocator would reuse it
    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    free0 = T.device_free_bytes(dev)
    held = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    free_held = T.device_free_bytes(dev)
    del held
    free_cached = T.device_free_bytes(dev)
    out["free_bytes_empty_held_cached"] = [free0, free_held, free_cached]
    if abs(free_cached - free0) > (64 << 20) \
            or abs(free0 - free_held - (1 << 30)) > (64 << 20):
        raise AssertionError(f"device_free_bytes: {free0} free, {free_held} "
                             f"with 1 GiB held, {free_cached} once freed")
    with card_filled(torch, need // 2) as free:
        streamed, records["default"] = fit()
    st = streamed.hist_stats
    out.update({"in_core_estimate_bytes": need, "filled_card_free_bytes": free})
    if not (free < need and st["ooc"] and st["n_chunks"] == OOC_CHUNKS
            and st["chunk_rows"] == OOC_CHUNK and st["hist_quant"] == "q16"
            and not st["hist_subtract"] and not st["subtract"]):
        raise AssertionError(f"the default 4M-row fit with {free} bytes "
                             f"free (in-core need {need}) did not stream: "
                             f"{st}")
    launches = records["default"]["launches"]
    ctx["launches"]["ooc_path"] = launches
    if launches["sums"] != expected or launches["quant"] \
            or launches["dequant"] != TREES * depth:
        raise AssertionError(f"the streamed fit launched {launches}; "
                             f"expected {expected} sums calls, "
                             f"{TREES * depth} dequantizations")
    in_core, records["in_core_q16"] = fit(ooc="off", quant="q16")
    if in_core.hist_stats["ooc_reason"] != "MMLSPARK_TORCH_OOC=off":
        raise AssertionError(f"in-core fit: {in_core.hist_stats}")
    differ = arrays_differing(streamed.booster, in_core.booster)
    roomy, records["default_in_core_f32"] = fit()
    if roomy.hist_stats["ooc"] or roomy.hist_stats["hist_quant"] != "off" \
            or roomy.hist_stats["ooc_reason"] != (
                "auto: the in-core fit fits in device memory"):
        raise AssertionError(f"default fit with room: {roomy.hist_stats}")
    # the estimate auto decides by holds the in-core fits' measured peaks
    peaks = [records[k]["device_peak_bytes"]
             for k in ("in_core_q16", "default_in_core_f32")]
    out["in_core_peak_bytes_per_row"] = [
        (p - 2 * OOC_ROWS * F) / OOC_ROWS for p in peaks]
    if max(peaks) > need:
        raise AssertionError(f"in-core peaks {peaks} above the estimate "
                             f"{need} (trainer.IN_CORE_ROW_BYTES)")
    del roomy
    # subtraction on, one binned chunk corrupted: hit 17 is the first read
    # of binned chunk 0 (the first tree's amax pass reads the 16 carry
    # chunks first), verified under MMLSPARK_TORCH_SPILL_VERIFY=auto
    with faults.injected("spill.read", "corrupt", nth=OOC_CHUNKS + 1,
                         count=1, corrupt=flip_middle):
        repaired, records["sub_repaired"] = fit(ooc="on", sub="1")
        fired = faults.fired("spill.read")
    in_core_sub, records["in_core_q16_sub"] = fit(ooc="off", quant="q16",
                                                  sub="1")
    differ_sub = arrays_differing(repaired.booster, in_core_sub.booster)
    rs = repaired.hist_stats
    out.update({
        "default_hist_stats": st, "default_time": ooc_time_shares(
            streamed, records["default"]["wall_s"]),
        "bitwise_in_core": not differ,
        "sub_bitwise_in_core": not differ_sub,
        "repairs": rs["spill_repairs"], "corrupt_fired": fired,
        "sub_time": ooc_time_shares(repaired,
                                    records["sub_repaired"]["wall_s"]),
        "expected_sums_launches": expected})
    if differ or differ_sub or not rs["hist_subtract"] \
            or rs["spill_repairs"] != 1 or fired != 1:
        raise AssertionError(f"streamed vs in-core: {differ} / "
                             f"{differ_sub}; repair {rs}, fired {fired}")
    if records["sub_repaired"]["launches"]["sums"] != expected:
        raise AssertionError(f"sub fit: {records['sub_repaired']}")
    lls = [booster_logloss(streamed.booster,
                           torch.as_tensor(binned[:500_000], device="cuda"),
                           y[:500_000], trees=t) for t in (1, TREES)]
    if not lls[1] < lls[0]:
        raise AssertionError(f"logloss does not fall: {lls}")
    out["logloss_first_last_500k"] = lls
    del streamed, repaired, in_core, in_core_sub
    step_mod.clear_step_cache()

    # (ii) the streamed path: a spill written chunk by chunk
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ooc-")
    try:
        t0 = time.perf_counter()
        edges = BinMapper.fit_streaming(
            (xc for xc, _ in streamed_chunks(OOC_ROWS)), max_bin=B)
        edges_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        writer = SpillWriter(os.path.join(tmp, "binned"), dtype=np.uint8)
        labels = ChunkStore(os.path.join(tmp, "labels"), "y")
        for i, (xc, yc) in enumerate(streamed_chunks(OOC_ROWS)):
            writer.append(edges.transform(xc, np.uint8))
            labels.put(i, yc)
        spill = writer.finalize()
        write_s = time.perf_counter() - t0
        with ooc_env():
            res, records["streamed"] = measured(
                torch, H, lambda: ooc.train_ooc(
                    spill, labels, cfg,
                    bin_upper=edges.bin_upper_values(B),
                    work_dir=os.path.join(tmp, "state")))
        # the logloss over every chunk, one chunk on the card at a time
        first = res.booster.slice_iterations(0, 1)
        raw1, raw, ys = [], [], []
        for i in range(spill.num_chunks):
            chunk = torch.as_tensor(np.array(spill.read(i)), device="cuda")
            raw1.append(first.predict_binned(chunk).cpu().numpy())
            raw.append(res.booster.predict_binned(chunk).cpu().numpy())
            ys.append(np.asarray(labels.get(i)))
        ys = np.concatenate(ys)
        s_lls = [logloss(np.concatenate(raw1), ys),
                 logloss(np.concatenate(raw), ys)]
        if not (res.hist_stats["ooc"] and s_lls[1] < s_lls[0]
                and records["streamed"]["launches"]["sums"] == expected):
            raise AssertionError(f"streamed fit: {res.hist_stats}, "
                                 f"{records['streamed']}, logloss {s_lls}")
        out["streamed"] = {"fit_streaming_s": edges_s, "spill_write_s": write_s,
                           "logloss_first_last": s_lls,
                           "time": ooc_time_shares(
                               res, records["streamed"]["wall_s"]),
                           "spill_verify_s": res.hist_stats["spill_verify_s"],
                           "spill_verify_chunks":
                               res.hist_stats["spill_verify_chunks"]}
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)

    # (iv) the sums entry against its plain version; a uint16 streamed fit
    ctx["ooc_sums_rows"] = sums_rows(torch, H, "uint8", B)
    ctx["ooc_sums_u16_rows"] = sums_rows(torch, H, "uint16", BREADTH_WIDE)
    torch.cuda.empty_cache()
    n16 = OOC_SUMS_CHUNKS * OOC_CHUNK
    wide = BinMapper.fit(x[:100_000], max_bin=BREADTH_WIDE)
    binned16 = wide.transform(x[:n16], np.uint16)
    cfg16 = dataclasses.replace(cfg, max_bin=BREADTH_WIDE,
                                num_iterations=OOC_U16_TREES)
    with ooc_env(ooc="on"):
        s16, records["u16_streamed"] = measured(
            torch, H, lambda: train(binned16, y[:n16], cfg16))
    with ooc_env(ooc="off", quant="q16"):
        i16, records["u16_in_core"] = measured(
            torch, H, lambda: train(binned16, y[:n16], cfg16))
    differ16 = arrays_differing(s16.booster, i16.booster)
    want16 = OOC_U16_TREES * depth * OOC_SUMS_CHUNKS
    ctx["launches"]["ooc_path_u16"] = records["u16_streamed"]["launches"]
    out["u16_bitwise_in_core"] = not differ16
    if differ16 or records["u16_streamed"]["launches"]["sums_u16"] != want16:
        raise AssertionError(f"uint16 streamed fit: {differ16}, "
                             f"{records['u16_streamed']}")
    del binned16

    # (v) the estimator: LightGBMRegressor on the 4M rows streams
    frame = DataFrame({"features": x, "label": y})
    with ooc_env(ooc="on"):
        model, records["estimator"] = measured(
            torch, H, lambda: LightGBMRegressor(
                numIterations=OOC_ESTIMATOR_TREES, numLeaves=63,
                maxDepth=6).fit(frame))
    want = OOC_ESTIMATOR_TREES * depth * OOC_CHUNKS
    if records["estimator"]["launches"]["sums"] != want \
            or model.booster.num_trees != OOC_ESTIMATOR_TREES \
            or not np.isfinite(model.booster.node_value).all():
        raise AssertionError(f"estimator fit: {records['estimator']}")
    del frame, model

    # where a streamed fit's device time goes: a 2-tree fit profiled
    short = dataclasses.replace(cfg, num_iterations=OOC_PROFILE_TREES)
    with ooc_env(ooc="on"):
        wall_ms, by_name, host = profile_ms(
            torch, lambda: train(binned, y, short, bin_upper=bin_upper))
    per_tree = {k: v / OOC_PROFILE_TREES for k, v in by_name.items()}
    out["profile_per_tree"] = {
        "wall_ms": wall_ms / OOC_PROFILE_TREES,
        "hist_kernels_ms": hist_device_ms(per_tree),
        "uploads_ms": sum(v for k, v in per_tree.items() if "HtoD" in k),
        "downloads_ms": sum(v for k, v in per_tree.items() if "DtoH" in k),
        "device_ms": sum(per_tree.values()), "top": top(per_tree, 8)}
    out["fits"] = records
    _made.pop((OOC_ROWS, 0), None)
    return out


# int32 bin ids (max_bin past 65,536): the bench's rows at 65,537 (the
# fewest bins that take int32 ids), 70,000 and 131,072 bins, and at
# 131,072 with 90% of each feature's rows in one bin (one cell per feature
# and node takes most adds); one level at width 128 and B = 70,000 (a
# deeper tree's); the leaf-wise builder's width-1 call on 2% of the rows
HIST_I32 = (("bench", N, F, 65_537), ("bench", N, F, 70_000),
            ("bench", N, F, 131_072), ("skewed", N, F, 131_072))
I32_WIDE_LEVEL = (("bench", N, F, 70_000),)
I32_WIDE_WIDTH = 128
I32_WIDTH1 = ((131_072, "int32"),)
I32_WIDTH1_SHARES = (0.02,)
INT32_BINS = 131_072                # the int32 path's max_bin
# the int32 path's leaf-wise, DART and streamed fits: rows, max_bin, trees
INT32_SMALL = (200_000, 70_000, 3)


def phase_kernel_i32(ctx):
    """The int32-id instances of both histogram kernels (max_bin past
    65,536; ``level_hist_common.cuh``'s tiles of bins over node-ordered
    columns) against their plain versions at ``HIST_I32``, every level
    width, bitwise (the f32 plane on integer and on float stats, q16 at
    every case and q8 at B = 131,072) and between two launches, with
    event-pair, device, plain and ``index_add_`` times, the byte bound
    and each launch's grid; one level at width ``I32_WIDE_WIDTH`` (f32
    and q16) and the width-1 call on 2% of the rows (f32), held alike;
    and the quantized kernel's chunk-merge entry on int32 ids (4 chunks
    of 262,144 rows, B = 131,072), held as phase ``ooc_path`` holds
    it."""
    import torch

    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H

    ctx["hist_i32"] = u16_cases(torch, "f32", HIST_I32, bin_bytes=4)
    ctx["quant_i32"] = {
        "q16": u16_cases(torch, "q16", HIST_I32, bin_bytes=4),
        "q8": u16_cases(torch, "q8", HIST_I32[2:3], bin_bytes=4)}
    torch.cuda.empty_cache()
    ctx["i32_wide_level"] = {
        plane: u16_cases(torch, plane, I32_WIDE_LEVEL,
                         widths=(I32_WIDE_WIDTH,), bin_bytes=4)
        for plane in ("f32", "q16")}
    torch.cuda.empty_cache()
    ctx["i32_width1"] = width1_rows(torch, I32_WIDTH1, I32_WIDTH1_SHARES)
    torch.cuda.empty_cache()
    ctx["ooc_sums_i32_rows"] = sums_rows(torch, H, "int32", INT32_BINS)
    torch.cuda.empty_cache()
    times = ("kernel_ms", "kernel_device_ms", "plain_ms", "library_ms",
             "bound_ms")
    return {"widths": list(WIDTHS), "cases": HIST_I32, "all_bitwise": True,
            "f32_per_tree": u16_summary(ctx["hist_i32"]),
            "quant_per_tree": {q: u16_summary(c)
                               for q, c in ctx["quant_i32"].items()},
            f"level_width_{I32_WIDE_WIDTH}": {
                plane: u16_summary(c)
                for plane, c in ctx["i32_wide_level"].items()},
            "width1_member": [{k: r[k] for k in (
                "b", "member_share", "geometry", *times)}
                for r in ctx["i32_width1"]],
            "sums_per_chunk_call": {m: sum(r[m] for r in ctx[
                "ooc_sums_i32_rows"]) for m in times},
            "sums_geometry": H.launch_geometry("quant", F, INT32_BINS, 4),
            "card": ctx["smi"]}


def phase_int32(ctx):
    """int32 bin ids on the main path at the bench's 2,000,000 x 28 rows:
    a ``LightGBMClassifier(maxBin=131072, binSampleCount=2000000)`` fit
    (its ``BinMapper`` fitted on every row, so most columns have more
    than 65,536 bins and the ids are int32) and transform (raw and
    ``binnedScoring``), and its binned serving plane's replies; ``train``
    (binary, 63 leaves, depth 6, 20 trees) on the estimator's mapper: the
    float32 plane (two fits bitwise, bitwise the uncaptured step and the
    estimator's booster), then q16 and q8, with each fit's launches of the
    int32 instances, wall, device peak (held under
    ``trainer.in_core_bytes``) and logloss, and a profiled 3-tree float32
    fit; ``predict_binned`` on the 2M
    int32 rows through the scorer's wide nodes, bitwise its plain
    version; then a leaf-wise (8 leaves), a DART and a streamed
    (``MMLSPARK_TORCH_OOC=on``) fit at 200,000 rows, B = 70,000 and 3
    trees, the streamed one bitwise the in-core q16 fit."""
    import torch

    from mmlspark_tpu_torch import (BinMapper, DataFrame, LightGBMClassifier,
                                    TrainConfig, train)
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.models.gbdt import score_cuda as S
    from mmlspark_tpu_torch.models.gbdt import step as step_mod
    from mmlspark_tpu_torch.models.gbdt import trainer as T

    out = {"card": ctx["smi"]}
    failures = []
    expected = TREES * 6
    x, y = make_data(N)

    # the estimator: its binning sample is every row
    frame = DataFrame({"features": x, "label": y})
    est = LightGBMClassifier(numIterations=TREES, numLeaves=63, maxDepth=6,
                             minDataInLeaf=20, maxBin=INT32_BINS,
                             binSampleCount=N)
    model, wall, launches = counted_fit(torch, lambda: est.fit(frame))
    t0 = time.perf_counter()
    scored = model.transform(DataFrame({"features": x}))
    est_rec = {**fit_record(model, wall, N), "launches": launches,
               "transform_s": time.perf_counter() - t0}
    ctx["launches"]["int32_path_estimator"] = \
        launches["hist_i32_kernel_launches"]
    mapper = model.bin_mapper
    t0 = time.perf_counter()
    binned = mapper.transform(x)
    bins = [mapper.num_bins(f) for f in range(F)]
    out["binning"] = {"transform_s": time.perf_counter() - t0,
                      "dtype": str(binned.dtype), "bins_per_feature": bins,
                      "features_past_65536": sum(b > 65_536 for b in bins)}
    if binned.dtype != np.int32 or out["binning"]["features_past_65536"] \
            <= F // 2:
        failures.append(f"binning: {out['binning']}")

    bin_upper = mapper.bin_upper_values(INT32_BINS)
    cfg = TrainConfig(objective="binary", num_iterations=TREES,
                      num_leaves=63, max_depth=6, min_data_in_leaf=20,
                      max_bin=INT32_BINS)
    need = T.in_core_bytes(N, F, INT32_BINS, 2 ** (cfg.effective_depth - 1))
    fits = {}
    for plane, counter in (("off", "hist_i32_kernel_launches"),
                           ("q16", "hist_quant_i32_kernel_launches"),
                           ("q8", "hist_quant_i32_kernel_launches")):
        with knobs(quant=plane):
            # no captured step held over (the estimator's): the first fit
            # captures its own (iteration 0 runs uncaptured, every later
            # one replays the graph), so its peak holds the graph's pool
            step_mod.clear_step_cache()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            res, wall, launches = counted_fit(torch, lambda: train(
                binned, y, cfg, bin_upper=bin_upper))
            peak = torch.cuda.max_memory_allocated() - base
            # the float32 plane: a second fit replays the cached step, and
            # the same step runs uncaptured
            again = (train(binned, y, cfg, bin_upper=bin_upper)
                     if plane == "off" else None)
            unc = (train(binned, y, cfg, bin_upper=bin_upper, capture=False)
                   if plane == "off" else None)
        lls = [e["train_binary_logloss"] for e in res.evals]
        rec = {"fit_s": wall, "capture_s": res.step_stats["capture_s"],
               "fit_mrow_trees_per_s": N * TREES / wall / 1e6,
               "device_peak_bytes": peak, "in_core_estimate_bytes": need,
               "launches": launches,
               "captured": res.step_stats["captured"],
               "logloss_first": lls[0], "logloss_last": lls[-1],
               "largest_threshold": int(res.booster.threshold_bin.max())}
        if plane == "off":
            rec.update({
                "two_fits_bitwise": boosters_equal(res.booster,
                                                   again.booster),
                "captured_bitwise_uncaptured": boosters_equal(
                    res.booster, unc.booster)})
        fits[plane] = rec
        emit({"phase": "int32_path_fit", "plane": plane, **rec})
        ctx["launches"][f"int32_path_{plane}"] = launches[counter]
        if (launches[counter] != expected
                or sum(launches.values()) != expected
                or not (rec["captured"] and rec.get("two_fits_bitwise", True)
                        and rec.get("captured_bitwise_uncaptured", True))
                or not all(b <= a + 1e-7 for a, b in zip(lls, lls[1:]))
                or not lls[-1] < lls[0] or peak > need):
            failures.append(f"int32 {plane} fit: {rec}")
        if plane == "off":
            booster = res.booster
        del res, again, unc
    out["fits"] = fits
    # where a float32 tree's time goes: device busy by kernel over a
    # profiled 3-tree fit (histograms against split finding)
    out["profile_3_trees"] = step_profile(torch, lambda: train(
        binned, y, dataclasses.replace(cfg, num_iterations=3),
        bin_upper=bin_upper), 3)

    # predict_binned on the 2M int32 rows: the wide route (thresholds past
    # 65,534), bitwise its plain version
    binned_d = torch.as_tensor(binned, device="cuda")
    tables = booster.predict_binned_scorer("off", "cuda").tables
    booster.predict_binned(binned_d[:1000])              # warm-up
    torch.cuda.synchronize()
    S.tree_score_route_launches.update(bin=0, wide=0, raw=0, decision=0)
    t0 = time.perf_counter()
    scores = booster.predict_binned(binned_d)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    routes = dict(S.tree_score_route_launches)
    ctx["launches"]["int32_path_tree_score"] = routes["wide"]
    rec, got, ok = scorer_held(torch, S, "int32 2M", tables, binned_d)
    rec.update({"wide": tables.wide, "predict_binned_s": score_s,
                "routes": routes,
                "predict_binned_bitwise": bool(torch.equal(scores, got)),
                "finite": bool(torch.isfinite(scores).all())})
    out["predict_binned"] = rec
    if not (ok and tables.wide and routes["wide"] == 1
            and rec["predict_binned_bitwise"] and rec["finite"]):
        failures.append(f"int32 scoring: {rec}")
    ctx["int32"] = (booster, binned_d)
    del got, scores

    # the estimator's booster is the direct fit's; its transform's
    # probability is predict's raw score and the numpy tail, binnedScoring's
    # is predict_binned's on the int32 ids (the wide route); the binned
    # serving plane's replies
    raw = model.booster.predict(x).cpu().numpy()
    braw = model.booster.predict_binned(binned_d).cpu().numpy()
    binned_scored = model.copy(binnedScoring=True).transform(
        DataFrame({"features": x}))
    est_rec.update({
        "arrays_differing_from_direct_train": arrays_differing(
            model.booster, booster),
        "transform_bitwise_predict": bool(np.array_equal(
            scored["probability"][:, 1], 1.0 / (1.0 + np.exp(-raw)))),
        "binned_transform_bitwise_predict_binned": bool(np.array_equal(
            binned_scored["probability"][:, 1],
            1.0 / (1.0 + np.exp(-braw))))})
    est_rec["serving"], ok = serving_record(model,
                                            x[:256].astype(np.float64))
    out["estimator"] = est_rec
    if (not ok or est_rec["launches"]["hist_i32_kernel_launches"] != expected
            or sum(est_rec["launches"].values()) != expected
            or est_rec["arrays_differing_from_direct_train"]
            or not est_rec["transform_bitwise_predict"]
            or not est_rec["binned_transform_bitwise_predict_binned"]):
        failures.append(f"maxBin={INT32_BINS} estimator: {est_rec}")
    del scored, binned_scored, model, frame

    # leaf-wise, DART and streamed fits at a reduced size
    rows, small_bins, trees = INT32_SMALL
    xs, ys = make_data(rows, seed=2)
    m2 = BinMapper.fit(xs, max_bin=small_bins)
    b2 = m2.transform(xs)
    up2 = m2.bin_upper_values(small_bins)
    c2 = dataclasses.replace(cfg, num_iterations=trees, max_bin=small_bins)
    small = {}
    with grow_policy("leafwise"):
        # 8 leaves: LeafwiseBuilder reads each (F, B, 3) histogram back to
        # the host and scans it there (the leaf-wise residual)
        res, wall, launches = counted_fit(torch, lambda: train(
            b2, ys, dataclasses.replace(c2, num_leaves=8), bin_upper=up2))
    small["leafwise"] = {"fit_s": wall, "launches": launches,
                         "grow_policy": res.hist_stats["grow_policy"],
                         "trees": res.booster.num_trees}
    if (res.hist_stats["grow_policy"] != "leafwise"
            or launches["hist_i32_kernel_launches"] < trees
            or sum(launches.values()) != launches["hist_i32_kernel_launches"]):
        failures.append(f"int32 leaf-wise fit: {small['leafwise']}")
    res, wall, launches = counted_fit(torch, lambda: train(
        b2, ys, dataclasses.replace(c2, boosting_type="dart"),
        bin_upper=up2))
    small["dart"] = {"fit_s": wall, "launches": launches,
                     "tree_weights": res.booster.tree_weights.tolist()}
    if launches["hist_i32_kernel_launches"] != trees * 6 \
            or sum(launches.values()) != trees * 6:
        failures.append(f"int32 DART fit: {small['dart']}")
    with ooc_env(ooc="on", quant="q16"):
        streamed, rec = measured(torch, H, lambda: train(
            b2, ys, c2, bin_upper=up2))
    with ooc_env(ooc="off", quant="q16"):
        in_core = train(b2, ys, c2, bin_upper=up2)
    small["streamed"] = {**rec, "ooc": streamed.hist_stats["ooc"],
                         "n_chunks": streamed.hist_stats["n_chunks"],
                         "arrays_differing_from_in_core_q16":
                             arrays_differing(streamed.booster,
                                              in_core.booster)}
    ctx["launches"]["int32_path_ooc_sums"] = rec["launches"]["sums_i32"]
    if (not streamed.hist_stats["ooc"]
            or rec["launches"]["sums_i32"] < trees * 6
            or rec["launches"]["sums"] or rec["launches"]["sums_u16"]
            or small["streamed"]["arrays_differing_from_in_core_q16"]):
        failures.append(f"int32 streamed fit: {small['streamed']}")
    out["reduced"] = {"rows": rows, "max_bin": small_bins, "trees": trees,
                      **small}
    if failures:
        emit({"phase": "int32_path_detail", **out})
        raise AssertionError("; ".join(failures))
    return out


def random_booster(seed, trees, depth, k, max_bin, features=F, wide=False):
    """A random full-layout ensemble (the root splits, a node below an
    internal node with probability 0.8) over ``features`` features, tree
    weights 0.3..1.7: the class fold of ``k`` classes, deep and shallow
    leaves. Bin thresholds lie below ``max_bin`` and, unless ``wide``,
    below 65535, the largest a 32-bit packed bin node takes as a real
    threshold (``score_cuda.pack_nodes``); ``wide``: every root splits on
    one of the last two features and at a threshold in the top half of
    ``max_bin``, so features past 32,767 and thresholds past 65,534 are
    met where ``features`` and ``max_bin`` reach them."""
    from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays

    rng = np.random.default_rng(seed)
    m = 2 ** (depth + 1) - 1
    sf = np.full((trees, m), -1, np.int32)
    tb = np.zeros((trees, m), np.int32)
    tv = np.full((trees, m), np.inf)
    for t in range(trees):
        for node in range(2 ** depth - 1):
            if node == 0 or (sf[t, (node - 1) // 2] >= 0
                             and rng.random() < 0.8):
                sf[t, node] = rng.integers(features)
                tb[t, node] = rng.integers(max_bin if wide
                                           else min(max_bin, 65535))
                tv[t, node] = np.round(rng.normal(), 2)
        if wide:
            sf[t, 0] = features - 1 - t % 2
            tb[t, 0] = rng.integers(max_bin // 2, max_bin)
    return BoosterArrays(
        split_feature=sf, threshold_bin=tb, threshold_value=tv,
        node_value=rng.normal(size=(trees, m)).astype(np.float32),
        count=np.zeros((trees, m), np.float32),
        tree_weights=rng.uniform(0.3, 1.7, trees).astype(np.float32),
        max_depth=depth, num_features=features, num_class=k,
        init_score=0.123456789)


def random_decision_booster(seed, trees, depth, k, words):
    """``random_booster`` with LightGBM decision bits at every split (each
    numeric byte and categorical ones, chosen at random) and random
    category bitsets of ``words`` words; categorical nodes carry a NaN
    threshold, as loaded model strings do."""
    booster = random_booster(seed, trees, depth, k, 255)
    rng = np.random.default_rng(seed + 500)
    internal = booster.split_feature >= 0
    dt = np.where(internal, rng.choice([0, 1, 2, 3, 4, 6, 8, 9, 10, 11, 12,
                                        14], internal.shape), 0)
    tv = np.where((dt & 1) == 1, np.nan, booster.threshold_value)
    return dataclasses.replace(
        booster, decision_type=dt.astype(np.int8), threshold_value=tv,
        cat_bitset=rng.integers(0, 2 ** 32, internal.shape + (words,),
                                dtype=np.uint64).astype(np.uint32))


def decision_rows(rng, n, words):
    """Raw float32 rows for decision boosters: values on the thresholds'
    grid, categories (negative ones, and ones past the bitsets: unseen),
    fractional categories, NaN, 0.0 and -0.0."""
    x = np.round(rng.normal(size=(n, F)), 2).astype(np.float32)
    kind = rng.random((n, F), dtype=np.float32)
    cats = rng.integers(-3, words * 32 + 8, (n, F)).astype(np.float32)
    x = np.where(kind < 0.35, cats, x)
    x = np.where((kind >= 0.35) & (kind < 0.45), cats + np.float32(0.5), x)
    x[(kind >= 0.90) & (kind < 0.93)] = 0.0
    x[(kind >= 0.93) & (kind < 0.95)] = -0.0
    x[kind >= 0.95] = np.nan
    return x


def score_bound(torch, S, x, tables, leaves=False):
    """(bound ms, "bytes" or "operations", bytes, operations) of one
    tree_score call: the input, the tables the kernel reads (packed nodes
    and the products leaf * weight; the decision route's bitsets, and its
    leaf map where it writes leaf slots) and the output (the leaf slots
    too) each moved once over the memory rate, against the walks'
    compares (each row's depth in each tree, from the plain routing of
    the original tables: the steps the scan takes before its node stays)
    plus an add per (row, tree) over the float32 rate."""
    n, t = x.shape[0], tables.num_trees
    read = [tables.nodes, tables.products]
    if tables.decision:
        read.append(tables.bits)
        if leaves:
            read.append(tables.leaf_slot)
    nbytes = (x.numel() * x.element_size()
              + sum(v.numel() * v.element_size() for v in read)
              + n * tables.num_class * 4 + (n * t * 4 if leaves else 0))
    # each walk's steps before its leaf: the last-level slot's depth less
    # the always-left steps of a leaf pushed down its left spine
    thr = S.unpack_nodes(tables)[-2 if tables.decision else 1]
    always_left = (torch.inf if tables.raw else S.ALWAYS_LEFT_WIDE
                   if tables.wide else S.ALWAYS_LEFT_BIN)
    offsets = (torch.arange(t, device=x.device) * tables.num_nodes)[None, :]
    steps = 0
    for s in range(0, n, 1 << 18):
        node = S.leaf_nodes(x[s:s + (1 << 18)], tables)
        depth = torch.floor(torch.log2(node.double() + 1)).long()
        for _ in range(tables.max_depth):
            parent = (node - 1) // 2
            pushed = (node % 2 == 1) & (thr[parent.clamp_min(0) + offsets]
                                        == always_left)
            depth -= pushed.long()
            node = torch.where(pushed, parent, node)
        steps += int(depth.sum().item())
    ops = steps + n * t
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", nbytes, ops)


def phase_kernel_score(ctx):
    """tree_score against its plain version on the card, bit for bit:
    the served model at every rung 1..64 (autocast off and bf16; uint8,
    uint16 and int32 bin ids; the launch and the staged batch the server
    scores), on the two sides of the plan crossover (4,200 and 4,201
    rows) and on rows of 29 bytes (staged element by element, also from
    a base off a word), the main path's booster at its 2M binned rows, at one
    row, at 2M + 7 rows and at the 2M raw rows with NaN (``predict``),
    random boosters: three classes (uint16 / int32 ids, raw rows; the
    cluster plan at 1 and 64 rows), ten classes (passes of four classes),
    1,000 trees (tree chunks), depth 16 (the global route) and no trees;
    both plans forced on the same inputs; two launches bitwise equal and
    each case's plan printed. At rung 64 and at 2M rows: device time
    (calls behind a spin kernel), event-pair time, launches per call from
    the profiler, the bound and the plain version's time. Then the plan
    crossover: both plans' device time at 1..16,384 rows for the served
    model, its first 40 trees and the main booster."""
    import torch

    from mmlspark_tpu_torch.models.gbdt import score_cuda as S
    from mmlspark_tpu_torch.parallel.inference import bucket_ladder

    served, pool_bins = ctx["served"]
    main = ctx["main_booster"]
    binned = ctx["main_inputs"][0]
    dtypes = {"uint8": torch.uint8, "uint16": torch.uint16,
              "int32": torch.int32}
    failures, checked = [], 0

    def check(label, tables, xd, plan=None):
        nonlocal checked
        if plan is None:
            plan = S._plan_for(xd.shape[0], xd.shape[1], xd.dtype, tables,
                               xd.device)
            got, again = S.tree_score(xd, tables), S.tree_score(xd, tables)
        else:
            got, again = S._launch(xd, tables, plan), S._launch(xd, tables,
                                                                plan)
        want = S.tree_score_reference(xd, tables)
        checked += 1
        ok = bool(torch.equal(got, want) and torch.equal(got, again))
        emit({"phase": "kernel_score_case", "case": label, "bitwise": ok,
              "plan": dataclasses.astuple(plan)})
        if not ok:
            failures.append(label)

    def timed(label, scorer, xd, host_x, leaves=False):
        """The times of one call at ``xd`` (with the leaf slots where
        ``leaves``), and the profiler's launches of one
        ``scorer(host_x)`` brought to the host (the copies in and out)."""
        t = scorer.tables
        want = (1, 3) if leaves else SCORE_CALL
        kernels, copies, busy = kernel_counts(
            torch, (lambda: [v.cpu() for v in scorer(host_x, leaves=True)])
            if leaves else (lambda: scorer(host_x).cpu()), want)
        bound, by, nbytes, ops = score_bound(torch, S, xd, t, leaves)
        scores = ((lambda: S.tree_score(xd, t, True)[0]) if leaves
                  else (lambda: S.tree_score(xd, t)))
        row = {"case": label, "rows": xd.shape[0], "trees": t.num_trees,
               "dtype": str(xd.dtype).replace("torch.", ""),
               "plan": dataclasses.astuple(S._plan_for(
                   xd.shape[0], xd.shape[1], xd.dtype, t, xd.device)),
               "route": t.route, "leaves": leaves,
               "kernel_ms": time_ms(torch,
                                    lambda: S.tree_score(xd, t, leaves)),
               "kernel_device_ms": device_ms(
                   torch, lambda: S.tree_score(xd, t, leaves)),
               "plain_ms": time_ms(
                   torch, lambda: S.tree_score_reference(xd, t, leaves),
                   reps=5, warmup=1),
               "bound_ms": bound, "bound_by": by, "bytes": nbytes,
               "ops": ops, "launches_per_call": kernels,
               "copies_per_call": copies, "kernel_busy_ms": busy,
               "max_abs_err": float((scores().double()
                                     - S.tree_score_reference(xd, t)
                                     .double()).abs().max().item())}
        emit({"phase": "kernel_score_timing", **row})
        if (kernels, copies) != want:
            failures.append(f"{label}: {kernels} kernels and {copies} "
                            f"copies per call, expected {want}")
        return row

    def check_decision(label, tables, xd, plan=None):
        """The decision route: scores and leaf slots bitwise the plain
        version's, the scores-only launch the same, two launches equal."""
        nonlocal checked
        if plan is None:
            plan = S._plan_for(xd.shape[0], xd.shape[1], xd.dtype, tables,
                               xd.device)
            got, again = (S.tree_score(xd, tables, True) for _ in range(2))
            alone = S.tree_score(xd, tables)
        else:
            got, again = (S._launch(xd, tables, plan, leaves=True)
                          for _ in range(2))
            alone = S._launch(xd, tables, plan)
        want = S.tree_score_reference(xd, tables, leaves=True)
        checked += 1
        ok = bool(all(torch.equal(u, v) for u, v in zip(got, want))
                  and all(torch.equal(u, v) for u, v in zip(got, again))
                  and torch.equal(alone, want[0]))
        emit({"phase": "kernel_score_case", "case": label, "bitwise": ok,
              "route": "decision", "plan": dataclasses.astuple(plan)})
        if not ok:
            failures.append(label)

    def decision_plans(label, tables, xd):
        """``check_decision`` under the chosen plan, the rows plan and
        the cluster plan where it fits."""
        n, k = xd.shape[0], tables.num_class
        check_decision(label, tables, xd)
        shape = (n, tables.num_trees, tables.num_nodes, k, torch.float32, F)
        check_decision(f"{label}, rows plan", tables, xd,
                       S.rows_plan(*shape))
        cluster = S.cluster_plan(*shape)
        if cluster is not None:
            check_decision(f"{label}, cluster plan", tables, xd, cluster)

    # the served model at every rung, both arms, every bin dtype, and the
    # staged batch the server scores (copy in, kernel, copy out, one call)
    for autocast in ("off", "bf16"):
        scorer = served.predict_binned_scorer(autocast, "cuda")
        for b in bucket_ladder(SERVER_ARGS["max_batch_size"]):
            for name, dt in dtypes.items():
                xd = torch.as_tensor(pool_bins[:b]).to(dt).cuda()
                check(f"served {autocast} rung {b} {name}", scorer.tables,
                      xd)
                batch = scorer.staged_batch(b, F, np.dtype(name))
                batch.x[:] = pool_bins[:b]
                scorer.score_staged(batch)
                checked += 1
                if not np.array_equal(batch.out[:, 0], S.tree_score_reference(
                        xd, scorer.tables).cpu().numpy()):
                    failures.append(f"served {autocast} rung {b} {name} "
                                    f"staged")
    scorer = served.predict_binned_scorer("off", "cuda")
    rung64 = timed("served, rung 64, uint8", scorer,
                   torch.as_tensor(pool_bins[:64]).cuda(), pool_bins[:64])
    rung_ms = {}
    for b in bucket_ladder(SERVER_ARGS["max_batch_size"]):
        xd = torch.as_tensor(pool_bins[:b]).cuda()
        rung_ms[b] = device_ms(torch, lambda: S.tree_score(xd, scorer.tables))
    # both sides of the crossover, and each plan forced on the other's side
    for n in (S.cluster_rows(100), S.cluster_rows(100) + 1):
        xd = torch.as_tensor(binned[:n].astype(np.uint8)).cuda()
        check(f"served {n} rows", scorer.tables, xd)
    xd = torch.as_tensor(pool_bins[:64]).cuda()
    check("served rung 64, rows plan", scorer.tables, xd,
          S.rows_plan(64, 100, scorer.tables.num_nodes, 1, torch.uint8, F))
    # rows of 29 bytes: staged element by element (no whole words), also
    # from a base off a word
    wide = torch.cat([torch.as_tensor(binned[:100_001].astype(np.uint8)),
                      torch.zeros((100_001, 1), dtype=torch.uint8)], 1)
    wide = wide.cuda()
    for n in (64, 100_000):
        check(f"served {n} rows of 29 bytes", scorer.tables, wide[:n])
        check(f"served {n} rows of 29 bytes off a word", scorer.tables,
              wide.view(-1)[1:1 + n * (F + 1)].view(n, F + 1))

    # the main path's booster at its 2M rows: bin ids and raw rows
    for autocast in ("off", "bf16"):
        tables = main.predict_binned_scorer(autocast, "cuda").tables
        for name, dt in dtypes.items():
            check(f"main {autocast} 2M {name}", tables,
                  torch.as_tensor(binned).to(dt).cuda())
    main_tables = main.predict_binned_scorer("off", "cuda").tables
    main_bins = torch.as_tensor(binned.astype(np.uint8)).cuda()
    check("main 1 row", main_tables, main_bins[:1])
    check("main 2M + 7 rows", main_tables,
          torch.cat([main_bins, main_bins[:7]]))
    check("main 1000 rows, cluster plan", main_tables, main_bins[:1000],
          S.cluster_plan(1000, main.num_trees, main_tables.num_nodes, 1,
                         torch.uint8, F))
    full = timed("main path, 2M rows, uint8",
                 main.predict_binned_scorer("off", "cuda"), main_bins,
                 binned[:64].astype(np.uint8))
    x, _ = make_data(N)
    x[np.random.default_rng(5).random(x.shape) < 0.01] = np.nan
    raw = main._scorer(True, "off", "cuda")
    xd = torch.as_tensor(x).cuda()
    check("main raw 2M with NaN", raw.tables, xd)
    full_raw = timed("main path, 2M raw rows with NaN (predict)", raw, xd,
                     x[:64])
    del xd, main_bins

    # random boosters: the class fold of three and of ten classes (passes
    # of four), 1,000 trees (tree chunks), depth 16 (the global route)
    rng = np.random.default_rng(6)
    cases = (("K=3", 7, 100, 6, 3, {"uint16": 1000, "int32": 70_000},
              (1, 64, 100_003)),
             ("K=10", 8, 40, 5, 10, {"uint8": 255}, (64, 100_003)),
             ("1000 trees", 9, 1000, 6, 1, {"uint8": 255}, (64, 100_003)),
             ("depth 16", 10, 6, 16, 1, {"uint16": 1000}, (64, 100_003)))
    for label, seed, trees, depth, k, bins_of, sizes in cases:
        for name, max_bin in bins_of.items():
            synth = random_booster(seed, trees, depth, k, max_bin)
            for autocast in ("off", "bf16"):
                tables = synth.predict_binned_scorer(autocast, "cuda").tables
                for n in sizes:
                    bins = rng.integers(0, max_bin + 1, size=(n, F))
                    check(f"{label} {autocast} {n} {name}", tables,
                          torch.as_tensor(bins).to(dtypes[name]).cuda())
        rows = np.round(rng.normal(size=(100_003, F)), 2)
        rows[rng.random(rows.shape) < 0.05] = np.nan
        for n in sizes:
            check(f"{label} raw {n}", synth._scorer(True, "off",
                                                     "cuda").tables,
                  torch.as_tensor(rows[:n].astype(np.float32)).cuda())
    one = random_booster(11, 1, 3, 1, 255)
    none = dataclasses.replace(one, **{k: getattr(one, k)[:0]
                                       for k in BOOSTER_ARRAYS})
    # the wide route (8-byte bin nodes): thresholds and ids past 65,535 on
    # int32 ids; split features past 32,767 on uint8, uint16 and int32 ids
    # (rows of 40,001 features take the global route); the chosen plan,
    # then the rows and the cluster plan where it fits; the staged batch
    for label, seed, trees, depth, k, max_bin, feats, names, sizes in (
            ("wide K=3", 15, 100, 6, 3, INT32_BINS, F, ("int32",),
             (1, 64, 4096, 100_003)),
            ("wide feature 40,000", 16, 60, 5, 1, 255, 40_001,
             ("uint8", "uint16", "int32"), (1, 64, 1024)),
            ("wide feature 40,000 past 65,535", 17, 40, 4, 2, 70_000,
             40_001, ("int32",), (1, 64, 1024))):
        synth = random_booster(seed, trees, depth, k, max_bin, feats, True)
        for autocast in ("off", "bf16"):
            tables = synth.predict_binned_scorer(autocast, "cuda").tables
            if not tables.wide:
                failures.append(f"{label}: narrow tables")
            for name in names:
                for n in sizes:
                    xd = torch.as_tensor(rng.integers(
                        0, max_bin + 1, size=(n, feats))).to(
                            dtypes[name]).cuda()
                    check(f"{label} {autocast} {n} {name}", tables, xd)
                    if autocast != "off" or n > 4096:
                        continue
                    shape = (n, trees, tables.num_nodes, k, dtypes[name],
                             feats)
                    check(f"{label} {n} {name}, rows plan", tables, xd,
                          S.rows_plan(*shape, wide=True))
                    cluster = S.cluster_plan(*shape, wide=True)
                    if cluster is not None:
                        check(f"{label} {n} {name}, cluster plan", tables,
                              xd, cluster)
        del xd
    wide_scorer = random_booster(15, 100, 6, 3, INT32_BINS, F,
                                 True).predict_binned_scorer("off", "cuda")
    for b in bucket_ladder(SERVER_ARGS["max_batch_size"]):
        batch = wide_scorer.staged_batch(b, F, np.dtype("int32"))
        batch.x[:] = rng.integers(0, INT32_BINS + 1, size=(b, F))
        wide_scorer.score_staged(batch)
        checked += 1
        if not np.array_equal(batch.out, S.tree_score_reference(
                torch.as_tensor(batch.x).cuda(),
                wide_scorer.tables).cpu().numpy()):
            failures.append(f"wide K=3 rung {b} staged")
    # the int32 path's booster at its 2M int32 rows (phase int32_path)
    int32_booster, int32_bins = ctx["int32"]
    int32_scorer = int32_booster.predict_binned_scorer("off", "cuda")
    check("int32 path 2M int32 (wide)", int32_scorer.tables, int32_bins)
    full_wide = timed("int32 path, 2M int32 rows (wide route)",
                      int32_scorer, int32_bins, int32_bins[:64].cpu().numpy())
    del int32_bins
    for n in (5, 100_000):
        check(f"no trees {n}",
              none.predict_binned_scorer("off", "cuda").tables,
              torch.as_tensor(binned[:n].astype(np.uint8)).cuda())

    # the decision route: the categorical model at its 2M rows (scores,
    # and scores with leaf slots), and random boosters of every decision
    # byte with categorical nodes, on rows with NaN, 0.0, negative,
    # fractional and unseen categories, in every plan at 1..16,384 rows
    # and at 2M rows
    cat_booster, cat_x = ctx["categorical"]
    cat_scorer = cat_booster._scorer(True, "off", "cuda", decision=True)
    cat_xd = torch.as_tensor(cat_x).cuda()
    check_decision("categorical model 2M", cat_scorer.tables, cat_xd)
    check_decision("categorical model 2M + 7", cat_scorer.tables,
                   torch.cat([cat_xd, cat_xd[:7]]))
    for n in (1, 64, 1024, 4096, 16384):
        decision_plans(f"categorical model {n}", cat_scorer.tables,
                       cat_xd[:n])
    cat_2m = timed("categorical model, 2M raw rows (decision route)",
                   cat_scorer, cat_xd, cat_x[:64])
    cat_2m_leaves = timed("categorical model, 2M raw rows, leaf slots",
                          cat_scorer, cat_xd, cat_x[:64], leaves=True)
    del cat_xd
    for label, seed, trees, depth, k, words, big in (
            ("decision", 12, 100, 6, 1, 2, True),
            ("decision K=3", 13, 60, 5, 3, 1, False),
            ("decision depth 16", 14, 4, 16, 1, 3, False)):
        synth = random_decision_booster(seed, trees, depth, k, words)
        tables = synth._scorer(True, "off", "cuda", decision=True).tables
        rows = torch.as_tensor(decision_rows(
            rng, N if big else 16384, words)).cuda()
        for n in (1, 64, 1024, 4096, 16384):
            decision_plans(f"{label} {n}", tables, rows[:n])
        if big:
            check_decision(f"{label} 2M", tables, rows)
        del rows

    # the crossover: both plans at each batch size
    crossover = []
    for label, booster in (
            ("served, 100 trees", served),
            ("served, first 40 trees", served.slice_iterations(0, 40)),
            ("main, 20 trees", main)):
        tables = booster.predict_binned_scorer("off", "cuda").tables
        for n in (1, 64, 1024, 4096, 8192, 16384):
            xs = torch.as_tensor(binned[:n].astype(np.uint8)).cuda()
            row = {"booster": label, "rows": n,
                   "chosen": S._plan_for(n, F, torch.uint8, tables,
                                         xs.device).regime}
            for regime, plan in (
                    ("rows", S.rows_plan(n, tables.num_trees,
                                         tables.num_nodes, 1, torch.uint8,
                                         F)),
                    ("cluster", S.cluster_plan(n, tables.num_trees,
                                               tables.num_nodes, 1,
                                               torch.uint8, F))):
                row[f"{regime}_ms"] = device_ms(
                    torch, lambda: S._launch(xs, tables, plan))
            crossover.append(row)
            emit({"phase": "kernel_score_crossover", **row})

    torch.cuda.synchronize()
    ctx["score_rows"] = {"rung64": rung64, "2M": full, "2M_raw": full_raw,
                         "decision_2M": cat_2m,
                         "decision_2M_leaves": cat_2m_leaves,
                         "wide_2M": full_wide}
    out = {"cases_bitwise": checked - len(failures), "cases": checked,
           "rung_device_ms": rung_ms, "rung64": rung64, "main_2M": full,
           "main_2M_raw": full_raw, "wide_2M": full_wide,
           "decision_2M": cat_2m,
           "decision_2M_leaves": cat_2m_leaves, "crossover": crossover,
           "card": ctx["smi"]}
    if failures:
        raise AssertionError(json.dumps({"failures": failures, **out},
                                        default=str))
    return out


# the streaming refresh and train-while-serve benches of the JAX package
# (bench.py:437-517 --refresh-latency, :519-700 --refresh-under-load):
# windows of 28 float32 features, a LightGBMRegressor of 63 leaves on 63
# bins, served with batches of 64 rows or 2 ms
REFRESH_ROWS, REFRESH_TREES = 100_000, 30
FLEET_ROWS, FLEET_TREES, FLEET_CLIENTS, FLEET_SECONDS = 50_000, 20, 8, 6.0
REFRESH_PARAMS = dict(numLeaves=63, maxBin=63, minDataInLeaf=20, seed=0)
REFRESH_SERVER = dict(max_batch_size=64, max_latency_ms=2.0)
REFRESH_POOL = 256


def refresh_window(rng, n, shift):
    """bench.py's refresh window: rows shifted by ``shift``, labels a
    fixed function of them."""
    x = (rng.normal(size=(n, F)) + shift).astype(np.float32)
    y = x[:, 0] - 0.5 * x[:, 1] + 0.25 * x[:, 2] * x[:, 3]
    return x, y


def cuda_sync(torch, device):
    if device is None:
        torch.cuda.synchronize()


def served_values(model, served, rows):
    """What a server's entry replies for ``rows``: the ``binnedScoring``
    transform while it has a binned plane, else ``transform``."""
    from mmlspark_tpu_torch import DataFrame

    m = model.copy(binnedScoring=True) if served.plane is not None else model
    return np.asarray(m.transform(DataFrame({"features": rows}))
                      .col("prediction"), dtype=np.float64)


def replies_equal(replies, want):
    """Rows (of ``post_rows`` replies to ``__id__`` bodies) whose reply is
    not 200 or differs from ``want`` (float64 reprs: == is bitwise)."""
    return [i for i, (status, reply) in enumerate(replies)
            if status != 200 or reply.get("id") != i
            or reply.get("prediction") != float(want[i])]


def phase_refresh(ctx):
    """The streaming refresh loop on the card at ``bench.py
    --refresh-latency``'s width: a served ``LightGBMRegressor`` (100,000
    rows, 30 trees), one warm generation, then a timed one (data arrival
    to the refreshed model serving, its refit and swap), the kernels'
    launches per refit and per probe; the replies after the swap bitwise
    the new generation's; an armed ``registry.swap`` corrupt rolled back
    with the old replies unchanged; a restarted controller on the newest
    generation; a refit killed mid-segment and retried equal to an
    unkilled one."""
    import tempfile

    import torch

    from mmlspark_tpu_torch import DataFrame, LightGBMRegressor
    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.core.pipeline import Transformer
    from mmlspark_tpu_torch.io import (RefreshController, ServingServer,
                                       SwapFailed)
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.models.gbdt import score_cuda as S

    device = ctx.get("device")
    rng = np.random.default_rng(0)
    est = LightGBMRegressor(numIterations=REFRESH_TREES,
                            **REFRESH_PARAMS).set_device(device)
    x0, y0 = refresh_window(rng, REFRESH_ROWS, 0.0)
    model = est.fit(DataFrame({"features": x0, "label": y0}))
    pool = x0[:REFRESH_POOL].astype(np.float64)
    bodies = [json.dumps({"features": row.tolist(), "__id__": i}).encode()
              for i, row in enumerate(pool)]
    out = {"card": ctx["smi"], "rows": REFRESH_ROWS,
           "new_trees": REFRESH_TREES}
    failures = []

    class Broken(Transformer):
        def _transform(self, df):
            raise RuntimeError("corrupted swap payload")

    def corrupt(served):
        served.plane = None
        served.binned_supported = False
        served.model = Broken()
        return served

    with tempfile.TemporaryDirectory() as td:
        gens = os.path.join(td, "gens")
        server = ServingServer(model, **REFRESH_SERVER).start()
        try:
            entry = server._models["default"]
            out["generation0_binned"] = entry.plane is not None
            ctrl = RefreshController(est, model, gens, server=server,
                                     refresh_interval_s=10_000,
                                     min_refit_rows=REFRESH_ROWS)
            ctrl.observe(*refresh_window(rng, REFRESH_ROWS, 0.5))
            warm = ctrl.refresh()
            if warm.swap_error:
                failures.append(f"warm swap: {warm.swap_error}")
            x1, y1 = refresh_window(rng, REFRESH_ROWS, 1.0)
            H.hist_kernel_launches = 0
            S.tree_score_launches = 0
            cuda_sync(torch, device)
            t0 = time.perf_counter()
            ctrl.observe(x1, y1)
            result = ctrl.refresh()
            wall = time.perf_counter() - t0
            refit_hist, refresh_score = (H.hist_kernel_launches,
                                         S.tree_score_launches)
            if result.swap_error:
                failures.append(f"timed swap: {result.swap_error}")
            entry = server._models["default"]
            S.tree_score_launches = 0
            server._probe(entry, {"features": x1[-1].tolist()})
            probe_score = S.tree_score_launches
            new_want = served_values(result.model, entry, pool)
            bad_new = replies_equal(post_rows(server, bodies), new_want)
            # an armed registry.swap corrupt: rolled back, replies kept
            before = post_rows(server, bodies)
            rolled = False
            with faults.injected("registry.swap", "corrupt",
                                 corrupt=corrupt):
                try:
                    server.swap_model("default", model, probe_payload={
                        "features": x0[0].tolist()})
                except SwapFailed:
                    rolled = True
            after = post_rows(server, bodies)
            health = server._health()
            # a restarted controller resumes the newest generation
            again = RefreshController(est, model, gens,
                                      refresh_interval_s=10_000)
            resumed = (again.generation == result.generation
                       and again.model.get_model_string()
                       == result.model.get_model_string())
        finally:
            server.stop()

        # a refit killed at the middle of its second segment, retried
        seg = REFRESH_TREES // 3

        def refit(name, kill):
            c = RefreshController(est, model, os.path.join(td, name),
                                  refresh_interval_s=10_000,
                                  min_refit_rows=REFRESH_ROWS,
                                  segment_interval=seg)
            c.observe(x1, y1)
            killed = False
            if kill:
                try:
                    with faults.injected("gbdt.train_step", "raise",
                                         nth=seg + seg // 2):
                        c.refresh(swap=False)
                except faults.FaultInjected:
                    killed = True
            return c.refresh(swap=False).model, killed

        clean, _ = refit("clean", False)
        retried, killed = refit("killed", True)
    out.update({
        "wall_s": wall, "refit_s": result.refit_s,
        "swap_s": result.swap["swap_s"] if result.swap else None,
        "downtime_s": result.swap["downtime_s"] if result.swap else None,
        "warm_wall_s": warm.total_s, "generation": result.generation,
        "generation_binned": entry.plane is not None,
        "level_hist_launches_per_refit": refit_hist,
        "tree_score_launches_per_refresh": refresh_score,
        "tree_score_launches_per_probe": probe_score,
        "replies_differing_after_swap": len(bad_new),
        "corrupt_swap_rolled_back": rolled,
        "replies_unchanged_after_rollback": before == after,
        "health_after_rollback": {k: health[k] for k in (
            "status", "swaps", "swap_rollbacks")},
        "restart_resumes_newest": resumed,
        "killed_mid_segment": killed,
        "killed_refit_bitwise": (retried.get_model_string()
                                 == clean.get_model_string())})
    ctx["launches"]["refresh_path"] = refit_hist
    ctx["launches"]["refresh_path_tree_score"] = refresh_score + probe_score
    if (failures or bad_new or not rolled or before != after
            or health["status"] != "ok" or health["swap_rollbacks"] != 1
            or not resumed or not killed
            or not out["killed_refit_bitwise"] or refit_hist == 0
            or refresh_score == 0 or probe_score != 1):
        raise AssertionError(f"refresh: {failures} {out}")
    return out


def offered_load(servers, bodies, clients, until):
    """``bench.py --refresh-under-load``'s closed loop: ``clients``
    threads post single rows round-robin over the workers (a connection
    per request) until ``until()``. Returns one (row, worker, t_sent,
    t_replied, status, prediction) per request and the client errors."""
    import urllib.error
    import urllib.request

    records, errors = [], []
    stop = threading.Event()
    lock = threading.Lock()

    def client(k):
        url = servers[k % len(servers)].url
        i = k
        while not stop.is_set():
            row = i % len(bodies)
            i += clients
            t0 = time.perf_counter()
            try:
                req = urllib.request.Request(
                    url, data=bodies[row],
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=10) as r:
                    status, pred = r.status, json.loads(r.read())[
                        "prediction"]
            except urllib.error.HTTPError as e:
                status, pred = e.code, None
            except Exception as e:
                with lock:
                    errors.append(repr(e))
                continue
            with lock:
                records.append((row, k % len(servers), t0,
                                time.perf_counter(), status, pred))

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(clients)]
    for t in threads:
        t.start()
    while not until():
        time.sleep(0.01)
    stop.set()
    for t in threads:
        t.join(timeout=15)
    return records, errors


def post_status(url, body, reply=False):
    """One POST: its status (a connection error's name where it had
    none), with the decoded reply when ``reply``."""
    import urllib.error
    import urllib.request

    try:
        req = urllib.request.Request(
            url, data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            status, got = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, got = e.code, None
    except Exception as e:
        status, got = type(e).__name__, None
    return (status, got) if reply else status


def latency_pctls(records):
    lat = np.asarray([(r[3] - r[2]) * 1e3 for r in records
                      if r[4] == 200], dtype=np.float64)
    if not len(lat):
        return None, None
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))


def phase_fleet(ctx):
    """Train while serving on the card at ``bench.py
    --refresh-under-load``'s width: a 2-worker ``ServingFleet`` of a
    50,000-row, 20-tree regressor under ``FleetSupervisor`` (2..2), 8
    closed-loop clients idle for 6 s, then during a co-located
    low-priority refit, then during ``swap_model_fleet``; p50/p99 by
    stage, the refit's yields, each worker's flip downtime, the 503/504
    deltas. Gates: no client error; every reply bitwise the generation
    its worker served then; a ``serving.worker_kill`` death restarted by
    the supervisor with two workers serving; ``drain`` with requests in
    flight returns True and drops none; a ``FleetClient`` ejects a
    worker with ``gray_delay_ms`` set and its replies stay bitwise."""
    import tempfile

    from mmlspark_tpu_torch import DataFrame, LightGBMRegressor
    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.io import (FleetClient, FleetSupervisor,
                                       RefreshController, ServingFleet)
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.models.gbdt import score_cuda as S

    device = ctx.get("device")
    rng = np.random.default_rng(0)
    est = LightGBMRegressor(numIterations=FLEET_TREES,
                            **REFRESH_PARAMS).set_device(device)
    x0, y0 = refresh_window(rng, FLEET_ROWS, 0.0)
    model = est.fit(DataFrame({"features": x0, "label": y0}))
    pool = x0[:REFRESH_POOL].astype(np.float64)
    bodies = [json.dumps({"features": row.tolist()}).encode() for row in pool]
    id_bodies = [json.dumps({"features": row.tolist(), "__id__": i}).encode()
                 for i, row in enumerate(pool)]
    out = {"card": ctx["smi"], "rows": FLEET_ROWS, "new_trees": FLEET_TREES,
           "clients": FLEET_CLIENTS}
    failures = []

    def mismatches(records, want_of):
        """Replies that equal no generation allowed at their time."""
        bad = 0
        for row, _, t0, t1, status, pred in records:
            if status == 200 and pred not in want_of(t0, t1, row):
                bad += 1
        return bad

    fleet = ServingFleet(model, num_servers=2, **REFRESH_SERVER).start()
    sup = FleetSupervisor(fleet, min_workers=2, max_workers=2,
                          heartbeat_s=0.2, dead_after_misses=2)
    try:
        with tempfile.TemporaryDirectory() as td:
            servers = list(fleet.servers)
            old_want = served_values(model, servers[0]._models["default"],
                                     pool)
            ctrl = RefreshController(est, model, td, server=servers[0],
                                     priority="low",
                                     refresh_interval_s=10_000,
                                     min_refit_rows=FLEET_ROWS)
            S.tree_score_launches = 0
            # stage 1: idle, at the offered load
            t_end = time.perf_counter() + FLEET_SECONDS
            idle, idle_err = offered_load(servers, bodies, FLEET_CLIENTS,
                                          lambda: time.perf_counter()
                                          >= t_end)
            # stage 2: the same load while the refit runs beside it
            window1 = refresh_window(rng, FLEET_ROWS, 0.5)
            ctrl.observe(*window1)
            done, box = threading.Event(), {}

            def refit():
                try:
                    box["result"] = ctrl.refresh(swap=False)
                except Exception as e:
                    box["error"] = repr(e)
                finally:
                    done.set()

            H.hist_kernel_launches = 0
            threading.Thread(target=refit, daemon=True).start()
            during, refit_err = offered_load(servers, bodies, FLEET_CLIENTS,
                                             done.is_set)
            refit_hist = H.hist_kernel_launches
            if "error" in box:
                raise AssertionError(f"refit failed: {box['error']}")
            new_model = box["result"].model
            old_bad = mismatches(idle + during,
                                 lambda t0, t1, row: (old_want[row],))
            # the kill drill: a worker dies mid-batch, the supervisor
            # restarts it, and both workers serve generation 0
            faults.arm("serving.worker_kill", "raise", count=1)
            killed_reply = post_status(servers[1].url, bodies[0])
            faults.disarm("serving.worker_kill")
            for _ in range(sup.dead_after_misses):
                sup.tick()
            servers = list(fleet.servers)
            restart = {"killed_reply": killed_reply,
                       "deaths": sup.stats()["deaths"],
                       "workers": len(servers),
                       "rows_differing": sum(len(replies_equal(
                           post_rows(s, id_bodies), old_want))
                           for s in servers)}
            # stage 3: the fleet-wide swap under the same load
            sdone, sbox = threading.Event(), {}
            t_swap = [None, None]

            def swap():
                t_swap[0] = time.perf_counter()
                try:
                    sbox["result"] = sup.swap_model_fleet(
                        "default", new_model,
                        probe_payload={"features": pool[0].tolist()})
                except Exception as e:
                    sbox["error"] = repr(e)
                finally:
                    t_swap[1] = time.perf_counter()
                    sdone.set()

            threading.Thread(target=swap, daemon=True).start()
            swapping, swap_err = offered_load(servers, bodies,
                                              FLEET_CLIENTS, sdone.is_set)
            if "error" in sbox:
                raise AssertionError(f"fleet swap failed: {sbox['error']}")
            new_want = served_values(new_model,
                                     servers[0]._models["default"], pool)

            def allowed(t0, t1, row):
                if t1 < t_swap[0]:
                    return (old_want[row],)
                if t0 > t_swap[1]:
                    return (new_want[row],)
                return (old_want[row], new_want[row])

            swap_bad = mismatches(swapping, allowed)
            after_bad = sum(len(replies_equal(post_rows(s, id_bodies),
                                              new_want)) for s in servers)
            score_launches = S.tree_score_launches
            # gray: one worker slow but alive; a hedging client ejects it
            servers[0].gray_delay_ms = 150.0
            client = FleetClient(fleet.registry_url, timeout=5.0,
                                 hedging=True, deadline_ms=5000.0,
                                 hedge_delay_ms=30.0)
            gray_bad = 0
            for i in range(24):
                if client.score({"features": pool[i].tolist()})[
                        "prediction"] != float(new_want[i]):
                    gray_bad += 1
            servers[0].gray_delay_ms = 0.0
            gray = {"slow_ejections": client.stats["slow_ejections"],
                    "hedges_fired": client.stats["hedges_fired"],
                    "rows_differing": gray_bad}
            # drain with 16 accepted requests queued or in flight behind
            # slow batches: every one is replied, bitwise
            victim = servers[1]
            victim.gray_delay_ms = 50.0
            admitted0 = victim._health()["admitted"]
            drain_replies = [None] * 16

            def one(i):
                drain_replies[i] = post_status(victim.url, id_bodies[i],
                                               reply=True)

            ts = [threading.Thread(target=one, args=(i,), daemon=True)
                  for i in range(16)]
            for t in ts:
                t.start()
            deadline = time.perf_counter() + 10.0
            while (victim._health()["admitted"] - admitted0 < 16
                   and time.perf_counter() < deadline):
                time.sleep(0.001)
            fleet.remove_worker(victim)
            drained = victim.drain(timeout_s=10.0)
            for t in ts:
                t.join(timeout=15)
            victim.stop()
            drain = {"drained": drained,
                     "accepted": victim._health()["admitted"] - admitted0,
                     "rows_differing": len(replies_equal(
                         drain_replies, new_want[:16]))}
            ctrl.close()
            # the same refit with no load beside it, for the ratio
            alone = RefreshController(est, model, os.path.join(td, "alone"),
                                      refresh_interval_s=10_000,
                                      min_refit_rows=FLEET_ROWS)
            alone.observe(*window1)
            alone_result = alone.refresh(swap=False)
            alone_bitwise = (alone_result.model.get_model_string()
                             == new_model.get_model_string())
    finally:
        sup.stop()
        fleet.stop()
    p50_idle, p99_idle = latency_pctls(idle)
    p50_refit, p99_refit = latency_pctls(during)
    p50_swap, p99_swap = latency_pctls(swapping)
    records = idle + during + swapping
    errors = idle_err + refit_err + swap_err
    non200 = sum(1 for r in records if r[4] != 200)
    statuses = [r[4] for r in records]
    swap_result = sbox["result"]
    out.update({
        "idle": {"requests": len(idle), "p50_ms": p50_idle,
                 "p99_ms": p99_idle},
        "refit": {"requests": len(during), "p50_ms": p50_refit,
                  "p99_ms": p99_refit,
                  "refit_s": box["result"].refit_s,
                  "refit_alone_s": alone_result.refit_s,
                  "refit_alone_bitwise": alone_bitwise,
                  "refit_yields": ctrl.stats["refit_yields"],
                  "refit_yield_s": ctrl.stats["refit_yield_s"]},
        "swap": {"requests": len(swapping), "p50_ms": p50_swap,
                 "p99_ms": p99_swap, "fleet_swap_s": swap_result["swap_s"],
                 "per_worker_downtime_ms": {
                     wk: t["downtime_s"] * 1e3
                     for wk, t in swap_result["per_worker"].items()}},
        "p99_refit_over_idle": (p99_refit / p99_idle
                                if p99_idle and p99_refit else None),
        "client_errors": len(errors), "client_error_kinds":
            sorted(set(e.split("(")[0] for e in errors)),
        "non_200": non200,
        "replies_503": statuses.count(503),
        "replies_504": statuses.count(504),
        "replies_not_their_generation": old_bad + swap_bad,
        "rows_differing_after_swap": after_bad,
        "level_hist_launches_refit": refit_hist,
        "tree_score_launches_served": score_launches,
        "restart": restart, "gray": gray, "drain": drain})
    ctx["launches"]["fleet_path"] = refit_hist
    ctx["launches"]["fleet_path_tree_score"] = score_launches
    if (errors or non200 or old_bad or swap_bad or after_bad
            or refit_hist == 0 or score_launches == 0
            or restart["deaths"] != 1 or restart["workers"] != 2
            or restart["rows_differing"] or gray["slow_ejections"] < 1
            or gray_bad or not drained or drain["accepted"] != 16
            or not alone_bitwise
            or drain["rows_differing"]):
        raise AssertionError(f"fleet: {failures} {out}")
    return out


def flash_bound(b, n, nk, h, d, causal, dtype):
    """The least time for the flash function: q, k, v read once and the
    output written once, over the memory rate; 4*d operations per
    unmasked (query, key) pair, over the peak rate for the input type:
    float32 outside the tensor cores (the function is specified in full
    float32, as the TPU kernel computes it), bfloat16 on the tensor
    cores. The TF32 tensor-core time is a note only."""
    if causal:   # top-left aligned: query i sees min(i + 1, nk) keys
        m = min(n, nk)
        pairs = m * (m + 1) // 2 + (n - m) * nk
    else:
        pairs = n * nk
    ops = 4 * b * h * d * pairs
    nbytes = (2 * n + 2 * nk) * b * h * d * dtype.itemsize
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    rate = BF16_OPS_PER_S if str(dtype) == "torch.bfloat16" \
        else F32_OPS_PER_S
    ops_ms = ops / rate * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops, "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "tf32_ops_ms": ops / TF32_OPS_PER_S * 1e3}


def bf16_step_misses(torch, a, b, atol, rtol=0.0):
    """How many elements of two bfloat16 results do not agree as two
    float32 results within ``atol + rtol*|b|``, each then rounded once to
    bfloat16: that plus one bf16 step (2^-8 of the larger magnitude's power
    of two)."""
    a, b = a.float(), b.float()
    _, exp = torch.frexp(torch.maximum(a.abs(), b.abs()))
    step = torch.ldexp(torch.ones_like(a), exp - 8)
    return int(((a - b).abs() > step + atol + rtol * b.abs()).sum())


def within_bf16_step(torch, a, b, atol, rtol=0.0):
    return bf16_step_misses(torch, a, b, atol, rtol) == 0


def exact_attention(torch, q, k, v, causal):
    """The function in float64 from the same (rounded) inputs, dense: the
    value both float32 computations approximate."""
    q, k, v = (x.double().transpose(1, 2) for x in (q, k, v))
    s = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    if causal:
        n, nk = s.shape[-2:]
        keep = torch.arange(nk, device=s.device)[None, :] \
            <= torch.arange(n, device=s.device)[:, None]
        s = s.masked_fill(~keep, float("-inf"))
    return (torch.softmax(s, dim=-1) @ v).transpose(1, 2)


def attention_inputs(torch, shape, dtype, seed, nk=None, scale=1.0,
                     layout="contiguous"):
    """Seeded normal q, k, v (q and k times ``scale``) in one of the
    layouts a caller may pass: ``contiguous`` (b, n, h, d) tensors;
    ``packed`` views into one (b, n, 3, h, d) tensor; ``bhnd`` (b, h, n,
    d) tensors seen as (b, n, h, d); ``misaligned`` tensors whose base is
    one element past an allocation (2 bytes for bf16: off TMA's 16)."""
    b, n, h, d = shape
    nk = n if nk is None else nk
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def mk(length, s):
        x = torch.randn((b, length, h, d), generator=gen, device="cuda") * s
        if layout == "bhnd":
            return x.transpose(1, 2).contiguous().to(dtype).transpose(1, 2)
        if layout == "misaligned":
            flat = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
            view = flat[1:].view(x.shape)
            view.copy_(x)
            return view
        return x.to(dtype)
    if layout == "packed":
        if nk != n:
            raise ValueError("a packed qkv tensor has one length")
        qkv = torch.randn((b, n, 3, h, d), generator=gen, device="cuda")
        qkv[:, :, :2] *= scale
        qkv = qkv.to(dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return mk(n, scale), mk(nk, scale), mk(nk, 1.0)


def host_us_per_call(torch, fn, calls=200):
    """Host microseconds per call over ``calls`` calls with no synchronise
    between them: what the wrapper costs the host, which sets the pace of
    back-to-back calls when it exceeds the kernel's time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def phase_kernel_flash(ctx):
    """Both flash kernels vs their plain version: every case within the
    stated tolerance, two launches bitwise equal and of the kernel the
    case expects, times beside the bound."""
    import torch
    import torch.nn.functional as TF

    from mmlspark_tpu_torch.parallel import flash as FL
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 matmuls are on: the plain version must "
                             "run in full float32")
    f32, bf16 = torch.float32, torch.bfloat16
    b, n, h, d = FLASH_AB
    sm90, staged, simt = FL.SM90, FL.SM90_STAGED, FL.SIMT
    cases = [  # name, shape, nk, dtype, causal, score scale, layout, route
        ("ab_f32_causal", FLASH_AB, None, f32, True, 1.0, "contiguous", simt),
        ("ab_f32", FLASH_AB, None, f32, False, 1.0, "contiguous", simt),
        ("ab_bf16_causal", FLASH_AB, None, bf16, True, 1.0, "contiguous",
         sm90),
        ("ab_bf16", FLASH_AB, None, bf16, False, 1.0, "contiguous", sm90),
        ("ab_bf16_causal_misaligned", FLASH_AB, None, bf16, True, 1.0,
         "misaligned", staged),
        ("d16_causal", (b, n, h, 16), None, f32, True, 1.0, "contiguous",
         simt),
        ("d16_bf16_causal", (b, n, h, 16), None, bf16, True, 1.0,
         "contiguous", sm90),
        ("d128_causal", (b, n, h, 128), None, f32, True, 1.0, "contiguous",
         simt),
        ("d128_bf16_causal", (b, n, h, 128), None, bf16, True, 1.0,
         "contiguous", sm90),
        ("cross_512x2048", (b, 512, h, d), 2048, f32, False, 1.0,
         "contiguous", simt),
        ("cross_512x2048_causal", (b, 512, h, d), 2048, f32, True, 1.0,
         "contiguous", simt),
        ("cross_512x2048_bf16", (b, 512, h, d), 2048, bf16, False, 1.0,
         "contiguous", sm90),
        ("cross_512x2048_bf16_causal", (b, 512, h, d), 2048, bf16, True,
         1.0, "contiguous", sm90),
        ("ragged_1000x1500_bf16_causal", (b, 1000, h, d), 1500, bf16, True,
         1.0, "contiguous", sm90),
        ("ragged_1500x1000_bf16_d128", (b, 1500, h, 128), 1000, bf16, False,
         1.0, "contiguous", sm90),
        ("large_scores_x30", FLASH_AB, None, f32, False, 30.0, "contiguous",
         simt),
        ("packed_qkv_bf16_causal", FLASH_AB, None, bf16, True, 1.0, "packed",
         sm90),
        ("bhnd_view_bf16_causal", FLASH_AB, None, bf16, True, 1.0, "bhnd",
         sm90),
        ("large_scores_x30_bf16", FLASH_AB, None, bf16, False, 30.0,
         "contiguous", sm90),
        # appended, so the cases above keep their seeds
        ("d32_bf16_causal", (b, n, h, 32), None, bf16, True, 1.0,
         "contiguous", sm90),
        ("d36_bf16_causal", (b, n, h, 36), None, bf16, True, 1.0,
         "contiguous", staged),
        ("d33_bf16_causal", (b, n, h, 33), None, bf16, True, 1.0,
         "contiguous", staged),
        ("d96_bf16_causal", (b, n, h, 96), None, bf16, True, 1.0,
         "contiguous", sm90),
        ("ragged_1000x1500_causal", (b, 1000, h, d), 1500, f32, True, 1.0,
         "contiguous", simt),
        ("d33_causal", (b, n, h, 33), None, f32, True, 1.0, "contiguous",
         simt),
        ("d96_causal", (b, n, h, 96), None, f32, True, 1.0, "contiguous",
         simt),
    ]
    rows = {}
    for seed, (name, shape, nk, dtype, causal, scale, layout,
               kernel) in enumerate(cases):
        q, k, v = attention_inputs(torch, shape, dtype, 10 + seed, nk, scale,
                                   layout)
        # ragged lengths: one block each, so flash_attention's block check
        # passes (the kernels tile by themselves)
        blocks = {} if shape[1] % 128 == 0 and k.shape[1] % 128 == 0 \
            else {"block_q": shape[1], "block_k": k.shape[1]}

        def call():
            return FL.flash_attention(q, k, v, causal=causal, **blocks)
        total0, sm90_0, staged0 = (FL.flash_kernel_launches,
                                   FL.flash_sm90_launches,
                                   FL.flash_staged_calls)
        k1, k2 = call(), call()
        torch.cuda.synchronize()
        sm90_n = FL.flash_sm90_launches - sm90_0
        staged_n = FL.flash_staged_calls - staged0
        launched = {sm90: sm90_n - staged_n, staged: staged_n,
                    simt: FL.flash_kernel_launches - total0 - sm90_n}
        p = FL.flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = (k1.float() - p.float()).abs()
        extra = {}
        if dtype == f32:
            within = bool((err <= 2e-5 + 2e-4 * p.abs()).all())
            tol = "rtol 2e-4, atol 2e-5"
        elif scale == 1.0:
            within = within_bf16_step(torch, k1, p, 2e-5, 2e-4)
            tol = "rtol 2e-4, atol 2e-5, plus one bf16 step"
        else:
            # scores x30 (|s| ~ 1e3): the plain version and the kernel sum
            # q.k in other orders, and near ties then move an output by
            # more than the gate, for the plain version as well: both are
            # held to the float64 value, and the kernel may miss the gate
            # against it at no more outputs than the plain version does
            exact = exact_attention(torch, q, k, v, causal)
            misses = bf16_step_misses(torch, k1, exact, 2e-5, 2e-4)
            plain_misses = bf16_step_misses(torch, p, exact, 2e-5, 2e-4)
            within = misses <= plain_misses
            tol = ("rtol 2e-4, atol 2e-5, plus one bf16 step, against the "
                   "float64 value: misses at no more outputs than the "
                   "plain version")
            extra = {
                "gate_misses_vs_float64": misses,
                "plain_gate_misses_vs_float64": plain_misses,
                "gate_misses_vs_plain": bf16_step_misses(
                    torch, k1, p, 2e-5, 2e-4),
                "outputs": k1.numel(),
                "max_abs_err_vs_float64": float(
                    (k1.double() - exact).abs().max()),
                "plain_max_abs_err_vs_float64": float(
                    (p.double() - exact).abs().max())}
            del exact
        repeat = bool(torch.equal(k1, k2))
        finite = bool(torch.isfinite(k1).all())
        routed = launched == {r: 2 if r == kernel else 0 for r in launched}
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def sdpa():
            return TF.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal)
        row = {"case": name, "shape": list(shape),
               "nk": k.shape[1], "dtype": str(dtype).split(".")[-1],
               "causal": causal, "layout": layout, "kernel": kernel,
               "launched": launched, "routed": routed, "within": within,
               "tol": tol, **extra, "repeat_bitwise": repeat,
               "finite": finite,
               "max_abs_err": float(err.max().item()),
               "call_ms": time_ms(torch, call),
               "plain_ms": time_ms(torch, lambda: FL.flash_attention_reference(
                   q, k, v, causal=causal), reps=5, warmup=1),
               "library_ms": device_ms(torch, sdpa),
               "library_call_ms": time_ms(torch, sdpa),
               **flash_bound(shape[0], shape[1], k.shape[1], shape[2],
                             shape[3], causal, q.dtype)}
        # device time of the call, and for a staged route that of its
        # staging copies alone
        row["kernel_ms"] = device_ms(torch, call)
        if kernel == staged:
            row["staging_ms"] = device_ms(torch, lambda: [
                FL.stage_for_tma(t) for t in (q, k, v)])
            row["flash_kernel_ms"] = row["kernel_ms"] - row["staging_ms"]
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        row["vs_library"] = row["kernel_ms"] / row["library_ms"]
        if name.startswith("ab_"):
            row["host_us_per_call"] = host_us_per_call(torch, call)
        del qt, kt, vt
        emit({"phase": "kernel_flash_vs_plain", **row})
        rows[name] = row
        if not (within and repeat and finite and routed):
            raise AssertionError(f"flash case {name} failed: {row}")
    ctx["flash_rows"] = rows
    return {"cases": list(rows), "all_agree": True, "card": ctx["smi"]}


def phase_sdpa_backends(ctx):
    """The yardstick: ``scaled_dot_product_attention`` at the A/B shape
    (causal) in float32 and bfloat16 under each backend alone. Which
    backends take the call, their device and call times and their max abs
    error against the plain version (float32 in full: TF32 would show as
    an error of about 1e-3), and which backend the default call matches
    bit for bit."""
    import torch
    import torch.nn.functional as TF
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from mmlspark_tpu_torch.parallel import flash as FL
    out = {"card": ctx["smi"]}
    for seed, dtype in enumerate((torch.float32, torch.bfloat16)):
        q, k, v = attention_inputs(torch, FLASH_AB, dtype, 60 + seed)
        ref = FL.flash_attention_reference(q, k, v, causal=True).float()
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def sdpa():
            return TF.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=True)
        default = sdpa()
        rows = {"default": {
            "ms": device_ms(torch, sdpa), "call_ms": time_ms(torch, sdpa),
            "max_abs_err": float(
                (default.transpose(1, 2).float() - ref).abs().max())}}
        for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                     "CUDNN_ATTENTION", "MATH"):
            backend = getattr(SDPBackend, name, None)
            if backend is None:
                rows[name] = {"accepted": False,
                              "reason": "not in this PyTorch"}
                continue

            def forced(backend=backend):
                with sdpa_kernel([backend]):
                    return sdpa()
            try:
                got = forced()
                torch.cuda.synchronize()
            except RuntimeError as e:
                rows[name] = {"accepted": False, "reason": str(e)[:300]}
                continue
            rows[name] = {
                "accepted": True, "ms": device_ms(torch, forced),
                "call_ms": time_ms(torch, forced),
                "max_abs_err": float(
                    (got.transpose(1, 2).float() - ref).abs().max()),
                "equals_default": bool(torch.equal(got, default))}
        rows["default_is"] = [n for n, r in rows.items()
                              if isinstance(r, dict)
                              and r.get("equals_default")]
        out[str(dtype).split(".")[-1]] = rows
    return out


def phase_attention_path(ctx):
    """``fused_attention`` through the kernels at the A/B shape (float32
    and bfloat16, and bfloat16 at d=32 and through a misaligned view, the
    second on copies staged for TMA) and at n=16384, counted by route,
    against the blockwise loop. No bfloat16 call may launch
    ``flash_attn.cu``."""
    import torch

    from mmlspark_tpu_torch.parallel import attention as AT
    from mmlspark_tpu_torch.parallel import flash as FL
    f32, bf16 = torch.float32, torch.bfloat16
    b, n, h, _ = FLASH_AB
    # name, shape, dtype, layout, reps, route, kernel-table key
    runs = [
        ("ab_f32", FLASH_AB, f32, "contiguous", 20, FL.SIMT,
         "flash_attn[f32]"),
        ("ab_bf16", FLASH_AB, bf16, "contiguous", 20, FL.SM90,
         "flash_attn_sm90[bf16]"),
        ("ab_bf16_d32", (b, n, h, 32), bf16, "contiguous", 20, FL.SM90,
         "flash_attn_sm90[bf16]"),
        ("long_f32", FLASH_LONG, f32, "contiguous", 3, FL.SIMT,
         "flash_attn[f32]"),
        ("long_bf16", FLASH_LONG, bf16, "contiguous", 3, FL.SM90,
         "flash_attn_sm90[bf16]"),
        # appended, so the runs above keep their seeds
        ("ab_bf16_misaligned", FLASH_AB, bf16, "misaligned", 20,
         FL.SM90_STAGED, "flash_attn_sm90[bf16,staged]")]
    out = {"card": ctx["smi"]}
    launches = {"flash_attn[f32]": 0, "flash_attn_sm90[bf16]": 0,
                "flash_attn_sm90[bf16,staged]": 0, "flash_attn[bf16]": 0}
    for seed, (name, shape, dtype, layout, reps, route,
               kernel) in enumerate(runs):
        q, k, v = attention_inputs(torch, shape, dtype, 30 + seed,
                                   layout=layout)
        FL.flash_kernel_launches = FL.flash_sm90_launches = 0
        FL.flash_staged_calls = 0
        fused = AT.fused_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        sm90, staged = FL.flash_sm90_launches, FL.flash_staged_calls
        counts = {FL.SIMT: FL.flash_kernel_launches - sm90,
                  FL.SM90: sm90 - staged, FL.SM90_STAGED: staged}
        if dtype == f32:
            launches["flash_attn[f32]"] += counts[FL.SIMT]
        else:
            launches["flash_attn[bf16]"] += counts[FL.SIMT]
            launches["flash_attn_sm90[bf16]"] += counts[FL.SM90]
            launches["flash_attn_sm90[bf16,staged]"] += counts[FL.SM90_STAGED]
        ref = AT.blockwise_attention(q.float(), k.float(), v.float(),
                                     causal=True)
        if dtype == f32:
            agree = bool(torch.allclose(fused, ref, rtol=0, atol=1e-4))
        else:
            agree = within_bf16_step(torch, fused, ref.to(dtype), 1e-4)
        bs, ns, hs, ds = shape
        fused_ms = time_ms(torch, lambda: AT.fused_attention(
            q, k, v, causal=True), reps=reps)
        blockwise_ms = time_ms(torch, lambda: AT.blockwise_attention(
            q, k, v, causal=True), reps=reps, warmup=1)
        useful = 2 * bs * hs * ns * ns * ds   # the A/B script's causal count
        row = {"shape": list(shape), "dtype": str(dtype).split(".")[-1],
               "layout": layout, "route": route, "kernel": kernel,
               "launches": counts,
               "agrees_with_blockwise": agree,
               "max_abs_diff": float((fused.float() - ref).abs().max()),
               "fused_ms": fused_ms, "blockwise_ms": blockwise_ms,
               "fused_causal_tflops": useful / fused_ms / 1e9,
               "blockwise_causal_tflops": useful / blockwise_ms / 1e9}
        if name == "ab_bf16":
            # ten back-to-back calls under the profiler: the device's
            # share of the wall, by kernel, and the host's time by op
            def ten():
                for _ in range(10):
                    AT.fused_attention(q, k, v, causal=True)
            wall, device, host = profile_ms(torch, ten)
            busy = sum(device.values())
            row.update(profiled_wall_ms_10_calls=wall, device_busy_ms=busy,
                       device_idle_share=1 - busy / wall,
                       device_ms_by_kernel=top(device, 4),
                       host_self_ms_by_op=top(host, 8))
        out[name] = row
        if counts[route] != 1 or sum(counts.values()) != 1 or not agree:
            raise AssertionError(f"fused_attention {name}: {row}")
    if launches["flash_attn[bf16]"]:
        raise AssertionError(f"a bfloat16 call launched flash_attn.cu: "
                             f"{launches}")
    q, k, v = attention_inputs(torch, FLASH_AB, torch.float32, 40)
    try:
        AT.fused_attention(q.requires_grad_(), k, v, causal=True)
        raise AssertionError("the kernel path took an input requiring grad")
    except RuntimeError as e:
        out["requires_grad_refused"] = str(e)
    ctx["launches"]["flash_attn"] = launches
    return out


def phase_attention_dist(ctx):
    """Ring and Ulysses on a one-rank NCCL group; Ulysses launches the
    kernel through ``fused_attention``. Each call is also profiled
    (device time by kernel, host self time by op, the device's idle
    share) and timed without the shard-length check, to split its cost
    over the single-device call. Several ranks are held by the gloo
    tests on the CPU."""
    import shutil
    import tempfile
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from mmlspark_tpu_torch.parallel import attention as AT
    from mmlspark_tpu_torch.parallel import flash as FL
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=120))
    try:
        q, k, v = attention_inputs(torch, FLASH_AB, torch.float32, 50)
        ref = AT.blockwise_attention(q, k, v, causal=True)
        out = {"backend": dist.get_backend(), "world_size": 1,
               "card": ctx["smi"]}
        for name, fn in (("ring", AT.ring_attention),
                         ("ulysses", AT.ulysses_attention)):
            FL.flash_kernel_launches = 0
            got = fn(q, k, v, causal=True)
            torch.cuda.synchronize()
            count = FL.flash_kernel_launches
            agree = bool(torch.allclose(got, ref, rtol=0, atol=1e-4))

            def call():
                return fn(q, k, v, causal=True)
            row = {"launches": count, "agrees_with_blockwise": agree,
                   "max_abs_diff": float((got - ref).abs().max()),
                   "ms": time_ms(torch, call, reps=5, warmup=1)}
            length_check = AT._sequence_length
            AT._sequence_length = lambda chunk, group, size, dev: \
                chunk * size
            try:
                row["ms_without_shard_check"] = time_ms(torch, call, reps=5,
                                                        warmup=1)
            finally:
                AT._sequence_length = length_check
            wall, device, host = profile_ms(torch, call)
            busy = sum(device.values())
            row.update(profiled_wall_ms=wall, device_busy_ms=busy,
                       device_idle_share=1 - busy / wall,
                       device_ms_by_kernel=top(device, 8),
                       host_self_ms_by_op=top(host, 10))
            out[name] = row
            if not agree:
                raise AssertionError(f"{name}_attention disagrees: {out}")
        if out["backend"] != "nccl" or out["ulysses"]["launches"] != 1:
            raise AssertionError(f"Ulysses did not launch the kernel once "
                                 f"over NCCL: {out}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return out


# --- multi-device GBDT (parallel_modes.py) -----------------------------------

# the float32 kernel's sums entries: the bench shape's every width (timed),
# B = 1,023 (uint16 ids) and B = 131,072 (int32 ids) at two widths; each
# case's rows also summed as uneven shards (1M + 1M, 1.5M + 0.5M)
DIST_SUMS_CASES = (("bench", 255, WIDTHS), ("b1023", 1023, (1, 32)),
                   ("b131072", 131_072, (1, 4)))
DIST_SPLITS = (N // 2, 3 * N // 4)
DIST_TOPK = 28
DIST_WORLD = 2
DIST_RANK_TIMEOUT_S = 300
# timed repeats of each fit after its first (untimed, counted) run; each
# repeat times the serial uncaptured fit beside the meshed ones
DIST_REPS = 3


def fit_wall(torch, fit):
    """(result, wall seconds) of ``fit()``, the card synchronized on both
    sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fit()
    torch.cuda.synchronize()
    return r, time.perf_counter() - t0


def dist_ids(torch, gen, b, dev):
    if b <= 256:
        return torch.randint(0, b, (N, F), generator=gen, device=dev,
                             dtype=torch.uint8)
    return (u16_ids if b <= 65_536 else i32_ids)(torch, gen, N, F, b, dev)


def dist_sums_rows(torch):
    """One row per (case, width) of the sums entries against their plain
    versions: the amax entry's maxima, the sums entry's int64 sums (bitwise
    the plain ``index_add_`` sums, and the sums of the rows as uneven
    shards bitwise the whole rows'), the rounding entry bitwise the
    one-call entry's histogram; with the times of the three entries (an
    event pair per call, and device time), the plain versions and an int64
    ``index_add_`` of the same sums, and the sums entry's bound."""
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    gf = torch.randn(N, generator=gen, device=dev)
    hf = torch.rand(N, generator=gen, device=dev) * 0.9 + 0.1
    live = (torch.rand(N, generator=gen, device=dev) < 0.9).float()
    rows = []
    for case, b, widths in DIST_SUMS_CASES:
        binned = dist_ids(torch, gen, b, dev)
        for width in widths:
            local = torch.randint(0, width, (N,), generator=gen, device=dev)
            args = (width, F, b)
            amax = H.level_histogram_amax(gf, hf, live)
            amax_ok = bool(torch.equal(
                amax, H.level_histogram_amax_reference(gf, hf, live)))
            exps = H.fixed_point_exponents(amax, N)

            def sums(lo=0, hi=N, acc=None):
                acc = acc if acc is not None else torch.zeros(
                    (width, F, b, 3), dtype=torch.int64, device=dev)
                return H.level_histogram_sums(
                    binned[lo:hi], gf[lo:hi], hf[lo:hi], live[lo:hi],
                    local[lo:hi], *args, exps, acc)

            whole = sums()
            plain = H.level_histogram_sums_reference(binned, gf, hf, live,
                                                     local, *args, exps)
            split_ok = True
            for cut in DIST_SPLITS:
                acc = sums(0, cut)
                split_ok &= bool(torch.equal(sums(cut, N, acc), whole))
                # the shard's own maxima and count: one shard's rows
                sub = H.level_histogram_amax(gf[:cut], hf[:cut], live[:cut])
                split_ok &= bool((sub <= amax).all())
            rounded = H.fixed_point_round(whole, exps)
            one_call = H.level_histogram(binned, gf, hf, live, local, *args)
            row = {"case": case, "b": b, "width": width,
                   "amax_bitwise": amax_ok,
                   "sums_bitwise_plain": bool(torch.equal(whole, plain)),
                   "uneven_shards_bitwise": split_ok,
                   "round_bitwise_one_call": bool(torch.equal(
                       rounded.view(torch.int32), one_call.view(torch.int32))),
                   "max_abs_err": float((rounded - one_call).abs().max())}
            del plain, one_call
            acc = torch.zeros((width, F, b, 3), dtype=torch.int64, device=dev)
            row["sums_ms"] = time_ms(torch, lambda: sums(acc=acc), reps=5,
                                     warmup=1)
            row["sums_device_ms"] = device_ms(torch, lambda: sums(acc=acc),
                                              reps=5, warmup=1, batches=2)
            row["amax_ms"] = time_ms(torch, lambda: H.level_histogram_amax(
                gf, hf, live), reps=5, warmup=1)
            row["round_ms"] = time_ms(torch, lambda: H.fixed_point_round(
                whole, exps), reps=5, warmup=1)
            row["round_device_ms"] = device_ms(
                torch, lambda: H.fixed_point_round(whole, exps), reps=5,
                warmup=1, batches=2)
            if case == "bench":
                row["plain_ms"] = time_ms(
                    torch, lambda: H.level_histogram_sums_reference(
                        binned, gf, hf, live, local, *args, exps), reps=3,
                    warmup=1)
                idx = H.flat_index(binned, local, F, b)
                terms = torch.round(torch.stack([gf * live, hf * live, live],
                                                -1).double()
                                    * H.pow2(exps)).long()
                src = terms[:, None, :].expand(N, F, 3).reshape(-1, 3)
                flat = acc.view(-1, 3)
                row["library_ms"] = time_ms(
                    torch, lambda: flat.index_add_(0, idx, src), reps=3,
                    warmup=1)
                del idx, src, terms
            # the sums entry's function: the inputs once, the accumulator
            # read and written; three adds per kept (row, feature)
            in_bytes = sum(t.numel() * t.element_size()
                           for t in (binned, gf, hf, live, local))
            acc_bytes = 2 * width * F * b * 3 * 8
            ops = 3 * F * int(live.sum().item())
            bytes_ms = (in_bytes + acc_bytes) / MEM_BYTES_PER_S * 1e3
            ops_ms = ops / F32_OPS_PER_S * 1e3
            row.update(bound_ms=max(bytes_ms, ops_ms),
                       bound_by="bytes" if bytes_ms >= ops_ms
                       else "operations")
            del acc, whole, rounded
            emit({"phase": "dist_sums_vs_plain", **row})
            rows.append(row)
            if not (row["amax_bitwise"] and row["sums_bitwise_plain"]
                    and row["uneven_shards_bitwise"]
                    and row["round_bitwise_one_call"]):
                raise AssertionError(f"the sums entries disagree: {row}")
    return rows


def collective_ms(torch, mesh, reps=5):
    """Per level width, the median wall ms of one all-reduce of the
    level's int64 sums (28 features, 255 bins) over the mesh's ``dp``
    axis, synchronized."""
    from mmlspark_tpu_torch.parallel import mesh as M
    out = {}
    for width in WIDTHS:
        acc = torch.ones((width, F, B, 3), dtype=torch.int64, device="cuda")
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            M.all_reduce(mesh, acc, tag="timing")
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[width] = float(np.median(times[1:]))
    return out


def dist_fit_record(r, first_s, serial):
    return {"first_wall_s": first_s,
            "bitwise_serial": boosters_equal(r.booster, serial.booster),
            "differing": arrays_differing(r.booster, serial.booster),
            "hist_stats": r.hist_stats, "trees": r.booster.num_trees}


def add_walls(rec, walls, serial_walls):
    """``rec`` with the warm walls of its fit and of the serial
    uncaptured fit timed beside them: each run and the medians."""
    wall, serial_s = float(np.median(walls)), float(np.median(serial_walls))
    rec.update(walls_s=walls, wall_s=wall, serial_uncaptured_walls_s=
               serial_walls, serial_uncaptured_s=serial_s,
               wall_over_serial=wall / serial_s)
    return rec


def dist_rank_main(rank, world, store, data_dir):
    """One gloo rank of phase ``dist_gbdt_path`` on ``cuda:0``: the data
    and data_sharded fits of the bench rows, their histogram bytes and
    launches (first fit), their warm walls beside rank 0's serial
    uncaptured fit, and each level's all-reduce time; each rank writes
    them."""
    import dataclasses as dc
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from mmlspark_tpu_torch import train
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.parallel import mesh as M

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=120))
    try:
        with open(os.path.join(data_dir, "inputs.pkl"), "rb") as fh:
            binned, y, bin_upper, cfg = pickle.load(fh)
        mesh = M.create_mesh()
        out = {"collective_ms_per_level": collective_ms(torch, mesh)}
        modes = (("data", "off"), ("data_sharded", "on"))

        def fit(shard):
            os.environ["MMLSPARK_TORCH_HIST_SHARD"] = shard
            return train(binned, y, dc.replace(cfg), bin_upper=bin_upper,
                         mesh=mesh)

        # each mode's first fit: counted, its bytes and trees kept
        for mode, shard in modes:
            before = mesh.bytes.get("hist", 0)
            H.hist_sums_kernel_launches = 0
            r, first_s = fit_wall(torch, lambda: fit(shard))
            out[mode] = {"first_wall_s": first_s, "walls_s": [],
                         "booster": r.booster, "hist_stats": r.hist_stats,
                         "hist_bytes": mesh.bytes.get("hist", 0) - before,
                         "sums_launches": H.hist_sums_kernel_launches,
                         "repeats_bitwise": True}
        # then warm: rank 0's serial uncaptured fit (the others wait at
        # the barrier) beside each mode's fit, DIST_REPS times
        out["serial_uncaptured_walls_s"] = []
        for _ in range(DIST_REPS):
            dist.barrier()
            if rank == 0:
                _, wall = fit_wall(torch, lambda: train(
                    binned, y, cfg, bin_upper=bin_upper, capture=False))
                out["serial_uncaptured_walls_s"].append(wall)
            dist.barrier()
            for mode, shard in modes:
                r, wall = fit_wall(torch, lambda: fit(shard))
                out[mode]["walls_s"].append(wall)
                out[mode]["repeats_bitwise"] &= boosters_equal(
                    r.booster, out[mode]["booster"])
        out["bytes"] = dict(mesh.bytes)
        with open(os.path.join(data_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(out, fh)
    finally:
        dist.destroy_process_group()


def phase_dist_gbdt(ctx):
    """Multi-device GBDT at the main path's full width (the 2M x 28 bench
    fit, 20 trees, 63 leaves, depth 6): the sums entries of the float32
    kernel against their plain versions (``dist_sums_rows``); on a
    one-rank NCCL mesh the data, voting (top_k 28) and feature learners
    and a meshed ``LightGBMClassifier`` fit and transform, each bitwise
    the serial uncaptured fit (the estimator: the unmeshed model's
    scores), the sums entry's launches counted over them; two gloo ranks
    on this card (NCCL refuses two ranks on one device) fitting data and
    data_sharded, each rank's trees bitwise the serial fit's and its
    histogram bytes ``hist_reduction_bytes``; each fit's warm wall
    (median of ``DIST_REPS`` after its first, counted run) against the
    serial uncaptured fit's, timed beside it in the same loop (on rank 0
    for the gloo ranks), and each level's all-reduce time."""
    import dataclasses as dc
    import shutil
    import tempfile
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from mmlspark_tpu_torch import DataFrame, LightGBMClassifier, train
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    from mmlspark_tpu_torch.models.gbdt import parallel_modes as PM
    from mmlspark_tpu_torch.parallel import mesh as M

    binned, y, bin_upper, cfg = ctx["main_inputs"]
    out = {"card": ctx["smi"]}
    rows = dist_sums_rows(torch)
    ctx["dist_sums_rows"] = rows
    out["sums_per_tree"] = {
        m: sum(r[m] for r in rows if r["case"] == "bench")
        for m in ("sums_ms", "sums_device_ms", "amax_ms", "round_ms",
                  "round_device_ms", "plain_ms", "library_ms", "bound_ms")}

    def serial_fit():
        return train(binned, y, cfg, bin_upper=bin_upper, capture=False)

    serial, serial_first_s = fit_wall(torch, serial_fit)
    out["serial_uncaptured_first_s"] = serial_first_s

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    procs = []
    try:
        # --- P = 1 over NCCL, in this process ------------------------------
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl",
                                world_size=1, rank=0,
                                timeout=timedelta(seconds=120))
        try:
            mesh = M.create_mesh()
            out["nccl_collective_ms_per_level"] = collective_ms(torch, mesh)
            counters = ("hist_sums_kernel_launches", "hist_amax_launches",
                        "hist_round_launches")
            for name in counters:
                setattr(H, name, 0)
            modes = {"data": {},
                     "voting": {"tree_learner": "voting",
                                "top_k": DIST_TOPK},
                     "feature": {"tree_learner": "feature"}}

            def mesh_fit(kw):
                return train(binned, y, dc.replace(cfg, **kw),
                             bin_upper=bin_upper, mesh=mesh)

            # each learner's first fit: counted and held to the serial bits
            fits = {}
            for mode, kw in modes.items():
                r, first_s = fit_wall(torch, lambda: mesh_fit(kw))
                fits[mode] = dist_fit_record(r, first_s, serial)
            launches = {name: getattr(H, name) for name in counters}
            out["nccl_launches"] = launches
            ctx["launches"]["dist_gbdt_path"] = launches
            # then warm, the serial uncaptured fit beside each learner's
            walls = {mode: [] for mode in ("serial", *modes)}
            for _ in range(DIST_REPS):
                walls["serial"].append(fit_wall(torch, serial_fit)[1])
                for mode, kw in modes.items():
                    walls[mode].append(fit_wall(torch,
                                                lambda: mesh_fit(kw))[1])
            for mode in modes:
                add_walls(fits[mode], walls[mode], walls["serial"])
            out["nccl_fits"] = fits
            # the estimator: meshed fit and transform against unmeshed
            x, _ = make_data(N)
            frame = DataFrame({"features": x, "label": y})
            params = dict(numIterations=TREES, numLeaves=63, maxDepth=6,
                          minDataInLeaf=20)
            plain_model = LightGBMClassifier(**params).fit(frame)
            t0 = time.perf_counter()
            model = LightGBMClassifier(
                parallelism="data_parallel", **params).set_mesh(mesh).fit(
                    frame)
            est_fit_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = np.asarray(model.transform(frame).col("rawPrediction"))
            est_transform_s = time.perf_counter() - t0
            want = np.asarray(plain_model.transform(frame).col(
                "rawPrediction"))
            out["estimator"] = {
                "fit_s": est_fit_s, "transform_s": est_transform_s,
                "model_bitwise": (model.get_model_string()
                                  == plain_model.get_model_string()),
                "scores_bitwise": bool(np.array_equal(got, want)),
                "shard_metadata": model.shard_metadata()}
        finally:
            dist.destroy_process_group()

        # --- P = 2 over gloo, two ranks on this card ----------------------
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as fh:
            pickle.dump((binned, y, bin_upper, cfg), fh)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-rank",
             str(rank), str(DIST_WORLD), os.path.join(tmp, "gloo"), tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(DIST_WORLD)]
        logs = [p.communicate(timeout=DIST_RANK_TIMEOUT_S)[0] for p in procs]
        out["gloo_ranks_s"] = time.perf_counter() - t0
        for rank, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                raise AssertionError(f"gloo rank {rank} failed:\n"
                                     f"{log[-4000:]}")
        ranks = []
        for rank in range(DIST_WORLD):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as fh:
                ranks.append(pickle.load(fh))
        gloo = {"collective_ms_per_level":
                ranks[0]["collective_ms_per_level"]}
        for mode in ("data", "data_sharded"):
            want_bytes = PM.hist_reduction_bytes(
                F, cfg.max_bin, cfg.effective_depth, DIST_WORLD,
                mode == "data_sharded", cell_bytes=8) * TREES
            recs = [r[mode] for r in ranks]
            gloo[mode] = add_walls({
                "first_wall_s": [r["first_wall_s"] for r in recs],
                "rank_walls_s": [r["walls_s"] for r in recs],
                "bitwise_serial": [boosters_equal(r["booster"],
                                                  serial.booster)
                                   for r in recs],
                "repeats_bitwise": [r["repeats_bitwise"] for r in recs],
                "hist_bytes": [r["hist_bytes"] for r in recs],
                "hist_reduction_bytes": want_bytes,
                "sums_launches": [r["sums_launches"] for r in recs],
                "hist_shard": recs[0]["hist_stats"]["hist_shard"]},
                # a fit ends when its slowest rank does
                [max(w) for w in zip(*(r["walls_s"] for r in recs))],
                ranks[0]["serial_uncaptured_walls_s"])
        out["gloo_p2"] = gloo
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    expected = TREES * cfg.effective_depth
    bad = [m for m, f in out["nccl_fits"].items() if not f["bitwise_serial"]]
    bad += [f"gloo_{m}" for m in ("data", "data_sharded")
            if not all(out["gloo_p2"][m]["bitwise_serial"])
            or not all(out["gloo_p2"][m]["repeats_bitwise"])
            or any(b != out["gloo_p2"][m]["hist_reduction_bytes"]
                   for b in out["gloo_p2"][m]["hist_bytes"])
            or any(n != expected for n in out["gloo_p2"][m]["sums_launches"])]
    est = out["estimator"]
    if not (est["model_bitwise"] and est["scores_bitwise"]):
        bad.append("estimator")
    if out["nccl_launches"]["hist_sums_kernel_launches"] != 3 * expected \
            or not all(out["nccl_launches"].values()):
        bad.append("launches")
    if bad:
        raise AssertionError(f"multi-device GBDT disagrees ({bad}): {out}")
    return out


def kernel_table(ctx):
    def entry(name, source, replaces, launches, rows):
        # times summed over the six level widths of one depth-6 tree
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["kernel_ms"] for r in rows),
            "device_ms": sum(r["kernel_device_ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations",
            "library_ms": sum(r["library_ms"] for r in rows),
            "per": "sum over widths " + ",".join(map(str, WIDTHS))
                   + "; ms: an event pair per call (host included where it"
                   " outlasts the device), device_ms: calls queued behind"
                   " a spin kernel",
        }

    def at_shapes(rows_by_shape):
        # per tree at the ranking and multiclass paths' widths
        out = {}
        for shape, rows in rows_by_shape.items():
            if shape != "bench":
                e = entry("", "", "", 0, rows)
                out[shape] = {"n": rows[0]["n"], "f": rows[0]["f"],
                              **{k: e[k] for k in (
                                  "max_abs_err", "ms", "device_ms",
                                  "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")}}
        return out

    kernels = [entry("level_hist", "mmlspark_tpu_torch/csrc/level_hist.cu",
                     "mmlspark_tpu/models/gbdt/hist_pallas.py:60",
                     ctx["launches"]["level_hist"], ctx["hist_rows"])]
    kernels[0]["at_shapes"] = at_shapes(ctx["hist_rows_by_shape"])
    for quant in QUANTS:
        kernels.append(entry(
            f"level_hist_quant[{quant}]",
            "mmlspark_tpu_torch/csrc/level_hist_quant.cu",
            "mmlspark_tpu/models/gbdt/hist_pallas.py:204",
            ctx["launches"]["level_hist_quant"][quant],
            ctx["quant_rows"][quant]))
        kernels[-1]["at_shapes"] = at_shapes(
            {k: v[quant] for k, v in ctx["quant_rows_by_shape"].items()})
    # the uint16-id instances (max_bin above 256), counted apart: times at
    # the bench's 2M x 28 and B = 1,023 (per tree, as above), launches
    # over phase breadth_path's max_bin=1023 fits; the other bin counts
    # and the odd feature count beside them
    def u16_kernel(name, source, replaces, launches, cases):
        e = entry(name, source, replaces, launches, cases["bench_b1023"])
        e["per"] = ("sum over widths " + ",".join(map(str, WIDTHS))
                    + " at N=2M, F=28, B=1023, uint16 ids; ms: an event "
                    "pair per call, device_ms: calls queued behind a spin "
                    "kernel")
        e["at_bins"] = {k: {m: sum(r[m] for r in rows) for m in (
            "kernel_ms", "kernel_device_ms", "plain_ms", "bound_ms")}
            for k, rows in cases.items() if k != "bench_b1023"}
        return e

    kernels.append(u16_kernel(
        "level_hist[u16]", "mmlspark_tpu_torch/csrc/level_hist.cu",
        "mmlspark_tpu/models/gbdt/hist_pallas.py:60",
        ctx["launches"]["breadth_path_u16_off"], ctx["hist_u16"]))
    for quant in QUANTS:
        kernels.append(u16_kernel(
            f"level_hist_quant[{quant},u16]",
            "mmlspark_tpu_torch/csrc/level_hist_quant.cu",
            "mmlspark_tpu/models/gbdt/hist_pallas.py:204",
            ctx["launches"][f"breadth_path_u16_{quant}"],
            ctx["quant_u16"][quant]))
    # launches over the ranking path's 100-tree ranker fit (600) and the
    # multiclass path's 20-iteration, 7-class fit (840); those fits run
    # the float32 plane, and the quantized kernels' one counter (both
    # planes) is checked to stay at 0 there
    for kernel in kernels[:3]:
        quantized = kernel["name"] != "level_hist"
        for path in ("ranking_path", "multiclass_path"):
            kernel[f"launches_{path}"] = ctx["launches"][
                f"{path}_quant" if quantized else path]
    # launches over the estimator path's 20-tree fits (phase
    # estimator_path; its q16 fit for the quantized kernel)
    kernels[0]["launches_estimator_path"] = ctx["launches"]["estimator_path"]
    kernels[1]["launches_estimator_path"] = \
        ctx["launches"]["estimator_path_q16"]
    # launches over the served model's 100-tree fit (phase serving_path)
    kernels[0]["launches_serving_path"] = ctx["launches"]["serving_path"]
    # launches over the regression objectives' 8 fits, the two custom
    # objective fits and the uninterrupted checkpointed fit
    for path in ("objectives_path", "custom_objective_path",
                 "checkpoint_path"):
        kernels[0][f"launches_{path}"] = ctx["launches"][path]
    # launches over the timed refit of refresh_path (30 trees) and the
    # co-located refit of fleet_path (20 trees)
    for path in ("refresh_path", "fleet_path"):
        kernels[0][f"launches_{path}"] = ctx["launches"][path]
    # launches over sampling_path's first fit of each sampled config (5
    # configs of 20 trees per plane; replays of the captured step)
    kernels[0]["launches_sampling_path"] = \
        ctx["launches"]["sampling_path"]["level_hist"]
    kernels[2]["launches_sampling_path"] = \
        ctx["launches"]["sampling_path"]["level_hist_quant"]
    # launches over breadth_path's setting fits (uint8 ids) and its
    # one-hot EFB fit, whose histograms scan the bundled matrix
    kernels[0]["launches_breadth_path"] = \
        ctx["launches"]["breadth_path_settings"]
    kernels[0]["launches_breadth_path_efb"] = \
        ctx["launches"]["breadth_path_efb"]
    # the same kernel on the one-hot rows' bundled matrix (1M x 32 of 284
    # columns), per tree (widths 1..32), beside the direct matrix's time
    kernels[0]["efb_bundled_per_tree"] = ctx["efb_hist_per_tree"]
    # launches over leafwise_path's 20-tree leaf-wise fit (one width-1
    # call per histogrammed node) and dart_path's 20-tree f32 DART fit (6
    # per tree) and its early-stopped estimator fit; the q8 DART fit's
    # quantized launches; the width-1 calls on a node's membership
    # (phase kernel, uint8 at B = 63 and uint16 at B = 1,023), per call
    kernels[0]["launches_leafwise_path"] = ctx["launches"]["leafwise_path"]
    kernels[0]["launches_dart_path"] = ctx["launches"]["dart_path"]["f32"]
    kernels[0]["launches_dart_path_estimator"] = \
        ctx["launches"]["dart_path"]["estimator"]
    kernels[2]["launches_dart_path"] = ctx["launches"]["dart_path"]["q8"]
    kernels[0]["width1_member_calls"] = {
        f"{r['ids']}_b{r['b']}_share{r['member_share']}": {k: r[k] for k in (
            "kernel_ms", "kernel_device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_abs_err")}
        for r in ctx["hist_width1"]}
    # the quantized kernel's chunk-merge entry (out of core): its launches
    # over phase ooc_path's default 4M-row fit (20 trees x 6 levels x 16
    # chunks) and the uint16 streamed fit; times per 262,144-row chunk
    # call summed over the six level widths, at F = 28, B = 255 (uint8
    # ids) and beside them B = 1,023 (uint16)
    ooc_launches = ctx["launches"]["ooc_path"]
    kernels[1]["launches_ooc_path_sums"] = ooc_launches["sums"]
    kernels[4]["launches_ooc_path_sums"] = \
        ctx["launches"]["ooc_path_u16"]["sums_u16"]
    sums = entry("level_hist_quant_sums[q16]",
                 "mmlspark_tpu_torch/csrc/level_hist_quant.cu",
                 "mmlspark_tpu/models/gbdt/hist_pallas.py:204",
                 ooc_launches["sums"], ctx["ooc_sums_rows"])
    sums.update({
        "replaces_also": "mmlspark_tpu/models/gbdt/ooc.py:210",
        "dequant_launches": ooc_launches["dequant"],
        "launches_u16": ctx["launches"]["ooc_path_u16"]["sums_u16"],
        "u16_b1023": {m: sum(r[m] for r in ctx["ooc_sums_u16_rows"])
                      for m in ("kernel_ms", "kernel_device_ms", "plain_ms",
                                "bound_ms", "library_ms", "max_abs_err")},
        "per": "one 262,144-row chunk call (F=28, B=255, uint8 ids, q16) "
               "summed over widths " + ",".join(map(str, WIDTHS))
               + ", adding into a running int64 accumulator (bound: the "
               "chunk's inputs read once, the accumulator cells it can "
               "touch read and written); library_ms: one int64 index_add_ of the same "
               "sums into it; launches from phase ooc_path's default fit"})
    kernels.append(sums)
    # the int32-id instances (max_bin past 65,536; level_hist_common.cuh's
    # walk), counted apart: times per tree at the bench's 2M x 28 and B =
    # 131,072 (the other cases beside them), launches over phase
    # int32_path's fits at B = 131,072; the chunk-merge entry on int32 ids
    # per 262,144-row chunk call, launches over its streamed fit
    def i32_kernel(name, source, replaces, launches, cases):
        e = entry(name, source, replaces, launches, cases["bench_b131072"])
        e["per"] = ("sum over widths " + ",".join(map(str, WIDTHS))
                    + " at N=2M, F=28, B=131072, int32 ids; ms: an event "
                    "pair per call, device_ms: calls queued behind a spin "
                    "kernel; library_ms: one index_add_ of the same sums")
        e["at_bins"] = {k: {m: sum(r[m] for r in rows) for m in (
            "kernel_ms", "kernel_device_ms", "plain_ms", "bound_ms",
            "library_ms")}
            for k, rows in cases.items() if k != "bench_b131072"}
        return e

    kernels.append(i32_kernel(
        "level_hist[i32]", "mmlspark_tpu_torch/csrc/level_hist.cu",
        "mmlspark_tpu/models/gbdt/hist_pallas.py:60",
        ctx["launches"]["int32_path_off"], ctx["hist_i32"]))
    kernels[-1]["launches_int32_path_estimator"] = \
        ctx["launches"]["int32_path_estimator"]
    # one level of a deeper tree, and the leaf-wise width-1 call on 2% of
    # the rows, per call
    kernels[-1][f"at_width_{I32_WIDE_WIDTH}"] = {
        k: v for k, v in u16_summary(ctx["i32_wide_level"]["f32"])[
            f"bench_b{I32_WIDE_LEVEL[0][3]}"].items() if k != "geometry"}
    kernels[-1]["width1_member"] = [{k: r[k] for k in (
        "b", "member_share", "kernel_ms", "kernel_device_ms", "plain_ms",
        "library_ms", "bound_ms")} for r in ctx["i32_width1"]]
    for quant in QUANTS:
        kernels.append(i32_kernel(
            f"level_hist_quant[{quant},i32]",
            "mmlspark_tpu_torch/csrc/level_hist_quant.cu",
            "mmlspark_tpu/models/gbdt/hist_pallas.py:204",
            ctx["launches"][f"int32_path_{quant}"],
            ctx["quant_i32"][quant]))
    sums_i32 = entry("level_hist_quant_sums[q16,i32]",
                     "mmlspark_tpu_torch/csrc/level_hist_quant.cu",
                     "mmlspark_tpu/models/gbdt/hist_pallas.py:204",
                     ctx["launches"]["int32_path_ooc_sums"],
                     ctx["ooc_sums_i32_rows"])
    sums_i32.update({
        "replaces_also": "mmlspark_tpu/models/gbdt/ooc.py:210",
        "per": "one 262,144-row chunk call (F=28, B=131072, int32 ids, "
               "q16) summed over widths " + ",".join(map(str, WIDTHS))
               + ", adding into a running int64 accumulator (bound: as "
               "the uint8 entry's, three cells per kept pair); launches "
               "from phase int32_path's streamed fit (200,000 rows, "
               "B=70,000, 3 trees)"})
    kernels.append(sums_i32)
    # the float32 kernel's sums entry (row 1d: rows split over ranks):
    # its launches over phase dist_gbdt_path's three one-rank NCCL fits
    # (the gloo ranks' are in that phase's record); times per tree at the
    # bench shape, the uint16 and int32 cases beside them
    d_rows = ctx["dist_sums_rows"]
    bench = [r for r in d_rows if r["case"] == "bench"]
    d_launches = ctx["launches"]["dist_gbdt_path"]
    kernels.append({
        "name": "level_hist_sums", "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/level_hist.cu",
        "replaces": "mmlspark_tpu/models/gbdt/hist_pallas.py:60",
        "launches": d_launches["hist_sums_kernel_launches"],
        "amax_launches": d_launches["hist_amax_launches"],
        "round_launches": d_launches["hist_round_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in d_rows),
        "ms": sum(r["sums_ms"] for r in bench),
        "device_ms": sum(r["sums_device_ms"] for r in bench),
        "plain_ms": sum(r["plain_ms"] for r in bench),
        "bound_ms": sum(r["bound_ms"] for r in bench),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in bench)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in bench),
        "amax_ms": sum(r["amax_ms"] for r in bench),
        "round_ms": sum(r["round_ms"] for r in bench),
        "round_device_ms": sum(r["round_device_ms"] for r in bench),
        "at_bins": {f"{r['case']}_w{r['width']}": {k: r[k] for k in (
            "sums_ms", "sums_device_ms", "round_ms", "bound_ms")}
            for r in d_rows if r["case"] != "bench"},
        "per": "the sums entry (adding the int64 sums into an accumulator) "
               "summed over widths " + ",".join(map(str, WIDTHS))
               + " at N=2M, F=28, B=255, uint8 ids; bound: the inputs once "
               "and the accumulator read and written; library_ms: one int64 "
               "index_add_ of the same terms; amax_ms / round_ms: the other "
               "two entries of a rank's level"})
    # tree_score replaces an XLA scan, not a Pallas kernel: the row of
    # the main path's 2M-row call, beside the served model's rung 64
    score = ctx["score_rows"]
    kernels.append({
        "name": "tree_score", "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/tree_score.cu",
        "replaces": "mmlspark_tpu/models/gbdt/booster.py:269",
        "replaces_also": "mmlspark_tpu/models/gbdt/booster.py:223",
        "launches": ctx["launches"]["tree_score"],
        "launches_serving_path": {arm: ctx["launches"][f"serving_path_{arm}"]
                                  for arm in ("on", "off")},
        "launches_objectives_path":
            ctx["launches"]["objectives_path_tree_score"],
        # the timed refresh (warm starts) and one probe; fleet_path's
        # served batches over its three load stages
        "launches_refresh_path": ctx["launches"]["refresh_path_tree_score"],
        "launches_fleet_path": ctx["launches"]["fleet_path_tree_score"],
        "max_abs_err": max(r["max_abs_err"] for r in score.values()),
        "ms": score["2M"]["kernel_ms"],
        "device_ms": score["2M"]["kernel_device_ms"],
        "plain_ms": score["2M"]["plain_ms"],
        "bound_ms": score["2M"]["bound_ms"],
        "bound_by": score["2M"]["bound_by"],
        "library_ms": None,
        "rung64": {k: score["rung64"][k] for k in (
            "kernel_ms", "kernel_device_ms", "plain_ms", "bound_ms",
            "bound_by", "launches_per_call", "copies_per_call", "plan")},
        "plan": score["2M"]["plan"],
        "raw_2M": {k: score["2M_raw"][k] for k in (
            "kernel_ms", "kernel_device_ms", "plain_ms", "bound_ms",
            "bound_by", "plan")},
        # the decision route (csrc/tree_score.cu, x code 6) on the
        # categorical model's 2M raw rows, alone and with leaf slots; it
        # also replaces _go_left_fn (booster.py:162) and leaf_index_fn
        # (:452); launches over phase categorical_path's 2M transform
        "replaces_decision_route": "mmlspark_tpu/models/gbdt/booster.py:162",
        "replaces_leaf_index": "mmlspark_tpu/models/gbdt/booster.py:452",
        "launches_categorical_path":
            ctx["launches"]["categorical_path_tree_score"],
        # one transform each: the ranker's 260,000 rows (K = 1, F = 136)
        # and the 7-class model's 581,012 rows (K = 7)
        "launches_ranking_path": ctx["launches"]["ranking_path_tree_score"],
        "launches_multiclass_path":
            ctx["launches"]["multiclass_path_tree_score"],
        **{key: {k: score[key][k] for k in (
            "kernel_ms", "kernel_device_ms", "plain_ms", "bound_ms",
            "bound_by", "plan", "launches_per_call", "copies_per_call")}
           for key in ("decision_2M", "decision_2M_leaves")},

        "per": "one call on the main path's 20-tree booster at its 2M "
               "uint8 rows (rung64: the served 100-tree model at 64 rows); "
               "launches from phase main_path (predict_binned) and the "
               "serving_path sustained runs; no single PyTorch call "
               "computes this function",
    })
    # the wide bin-node route of the same kernel (8-byte nodes, ids
    # compared unclamped), its own template instances
    wide = score["wide_2M"]
    kernels.append({
        "name": "tree_score[wide]", "route": "cuda",
        "source": "mmlspark_tpu_torch/csrc/tree_score.cu",
        "replaces": "mmlspark_tpu/models/gbdt/booster.py:269",
        "launches": ctx["launches"]["int32_path_tree_score"],
        "max_abs_err": wide["max_abs_err"], "ms": wide["kernel_ms"],
        "device_ms": wide["kernel_device_ms"], "plain_ms": wide["plain_ms"],
        "bound_ms": wide["bound_ms"], "bound_by": wide["bound_by"],
        "library_ms": None, "plan": wide["plan"],
        "per": "one call on phase int32_path's 20-tree booster (thresholds "
               "past 65,534) at its 2M int32 rows; launches from that "
               "phase's predict_binned; no single PyTorch call computes "
               "this function"})
    flash = ctx["flash_rows"]
    # flash_attn.cu takes float32 only: every bfloat16 call runs
    # flash_attn_sm90.cu, in place or staged
    for name, case, source in (
            ("flash_attn[f32]", "ab_f32_causal", "flash_attn.cu"),
            ("flash_attn_sm90[bf16]", "ab_bf16_causal",
             "flash_attn_sm90.cu"),
            ("flash_attn_sm90[bf16,staged]", "ab_bf16_causal_misaligned",
             "flash_attn_sm90.cu")):
        row = flash[case]
        extra = ({"staging_ms": row["staging_ms"]} if "staging_ms" in row
                 else {})
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mmlspark_tpu_torch/csrc/{source}",
            "replaces": "mmlspark_tpu/parallel/flash.py:24",
            "launches": ctx["launches"]["flash_attn"][name],
            "max_abs_err": max(r["max_abs_err"] for r in flash.values()
                               if r["dtype"] == row["dtype"]
                               and r["kernel"] == row["kernel"]),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], **extra,
            "per": f"one call at b=4, n=2048, h=8, d=64, causal ({case}); "
                   f"launches from phase attention_path",
        })
    return {"kernels": kernels}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import mmlspark_tpu_torch  # noqa: F401  (fails outside the repo)

    ctx = {}
    failed = []
    for name, fn in (("device", phase_device), ("kernel", phase_kernel),
                     ("main_path", phase_main), ("profile", phase_profile),
                     ("card_vs_cpu", phase_card_vs_cpu),
                     ("kernel_quant", phase_kernel_quant),
                     ("main_path_quant", phase_main_quant),
                     ("card_vs_cpu_quant", phase_card_vs_cpu_quant),
                     ("sampling_path", phase_sampling),
                     ("estimator_path", phase_estimator),
                     ("objectives_path", phase_objectives),
                     ("custom_objective_path", phase_custom_objective),
                     ("checkpoint_path", phase_checkpoint),
                     ("serving_path", phase_serving),
                     ("categorical_path", phase_categorical),
                     ("ranking_path", phase_ranking),
                     ("multiclass_path", phase_multiclass),
                     ("breadth_path", phase_breadth),
                     ("leafwise_path", phase_leafwise),
                     ("dart_path", phase_dart),
                     ("ooc_path", phase_ooc),
                     ("kernel_i32", phase_kernel_i32),
                     ("int32_path", phase_int32),
                     ("kernel_score", phase_kernel_score),
                     ("refresh_path", phase_refresh),
                     ("fleet_path", phase_fleet),
                     ("kernel_flash", phase_kernel_flash),
                     ("sdpa_backends", phase_sdpa_backends),
                     ("attention_path", phase_attention_path),
                     ("attention_dist", phase_attention_dist),
                     ("dist_gbdt_path", phase_dist_gbdt)):
        t0 = time.perf_counter()
        try:
            out = fn(ctx)
            emit({"phase": name, "ok": True,
                  "seconds": time.perf_counter() - t0, **out})
        except Exception as e:  # report every phase, then fail
            traceback.print_exc()
            emit({"phase": name, "ok": False, "error": repr(e)})
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    emit(kernel_table(ctx))
    print(ctx["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": ctx["kind"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        # one gloo rank of phase dist_gbdt_path (started by that phase)
        dist_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                       sys.argv[5])
        sys.exit(0)
    sys.exit(main())
