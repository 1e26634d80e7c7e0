#!/usr/bin/env python3
"""Smoke run of dglke_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card, the torch and CUDA versions, and the nvcc builds of the
     kernel sources in dglke_tpu_torch/ops/csrc/ (one nvcc per source, all
     started together), timed;
  2. each kernel against its plain PyTorch version at the shapes its main
     path gives it, with its time, the plain version's time, one PyTorch
     call as yardstick where one computes the same function, and its bound:
     K1 and K2 at the TransE_l2 flagship shapes (FB15k width: 14,951 x 400
     entity table, 1,345 x 400 relation table, 3,000 entity ids and 1,000
     relation ids per step), K1 in its one-warp-per-row shape there; K1's
     two launch shapes exact and timed in turns across widths 256-16,384
     (the measurement behind rows.GATHER_WIDE_MIN); K3 at RESCAL's FB15k
     shapes (1,345 x 250,000 relation table, 1,000 ids, 500-wide factors)
     on its cluster route, with the cluster size chosen, the other size and
     the tiles route held to the plain version and timed in turns, the max
     active clusters, and the stock route for the same update (the gradient
     materialized, then K2); K1 on the 1 MB relation rows, both shapes and
     dtypes exact at a width that is and one that is not a multiple of 4,
     timed in three rounds beside torch.index_select, and K1 with the sum
     of |x|^3 (RESCAL's relation regularization value: the wide shape's
     rows, the sum against fp64, two calls bit-equal) timed beside them
     and beside the wide shape then three PyTorch passes; K3's routes away from
     hidden 500: the cluster route at hidden 32 and at a ragged 7 x 13
     width, each with one segment longer than the staged factors hold, and
     the tiles route at hidden 1,000 (K3's outputs are bit-identical when
     it is fed torch.sort's sids and order in place of the grouping's);
     the id grouping bit-exact against torch.sort(stable=True) on ids at
     the main paths' shapes and at its edges (all equal, a permutation,
     n = 1 and 33, n at the one-block limit, 2^14 and 2^14 + 1 rows, a
     Freebase-sized id range), and on its tiles route above 8,192 ids (one
     past the limit, WN18's 12,288 ids at 2 ranks, a Freebase owner's
     24,000 at 8 ranks in both id dtypes, all equal, a permutation, 2^20
     ids over 2^14 and over 2^31 - 1 rows, five tiles, one tile forced),
     timed beside torch.sort and the plain grouping (the one-block route
     at the flagship's ids with each pass width, the tiles route at
     12,288, 24,000 and 2^20 ids by kernel); K2 on every route (one warp
     per segment; one block per segment, at TransR's 1,000 x 160,000
     projection rows) in both dtypes, Adagrad and the plain row add, also
     over 12,288 and 24,000 ids (the tiles route's grouping), within
     tolerance of plain, two runs bit-identical, untouched rows unchanged;
     the whole K2 call timed in turns beside index_add_ and the plain
     version at five shapes, with its time split between the grouping and
     the update; K2 over 12,288 ids captured in a CUDA graph on the shared
     capture stream and replayed, bit-equal to the eager call
     (phase_group_capture); K3 over 9,000 relation ids (its grouping on
     the tiles route) held to its plain version;
  2b. the device pipeline's fused call (models/pipeline_step.py) as one
     CUDA graph a group, against the group function called eagerly on the
     same initial tables: every table, its Adagrad state and the logs bit
     for bit, the launch counts equal, one graph (two at s = 1) and a
     replay for every group after the first: the flagship in fp32, with
     --compute_dtype bfloat16 and with --async_update, RESCAL with K3 in
     the graph, TransR (hidden 200), 320 flagship steps on the phase-3
     data's 300,000 edges whose groups straddle the epoch, and s = 1 on
     2,500 edges whose batches straddle it.  The fed call
     (models/fed_step.py) against the eager steps on the same batches, bit
     for bit: host tables on mapped memory (host_graph_parity, against
     host_step: the flagship, with edge weights, TransR's projection,
     RESCAL's row route, RotatE), and the host-fed route on 1,500 edges
     (fed_graph_parity: --async_update at s = 10, and s = 1).  Every
     single-device CLI run below must take the graph route of its feed:
     its graphs and replays are read from its log (graph_route) and held
     to one graph and max_step / s - 1 replays on the device pipeline (s =
     1 must not reach it on one device), two graphs and max_step - 1
     replays on host tables, one graph (two at s = 1) and max_step / s - 1
     replays on the host-fed route, with its launch counts held to
     EXPECTED_LAUNCHES through the replays; the step profiles of the
     flagship (fp32, bf16), RESCAL and wikikg2 run on both routes, with the
     graph launches a step and the peak allocation;
  2c. the eval's fused calls (models/eval_step.py: a group of eval batches
     a call, one CUDA graph a call shape, replayed), against the group
     functions called eagerly, batched alike (each tail group padded to its
     call shape), on the same fresh tables at full width: the
     ranks (top-10 positions) bit for bit, the launches equal, a graph for
     each call shape called twice or more and a replay for each later call
     (phase_eval_graphs): the filtered full-entity flagship, RotatE raw (a
     broadcast form, its block following the group's rows), TransR (hidden
     200), RESCAL (hidden 500), sampled eval filtered by its keep masks and
     with neg_deg_sample (a padded tail group of 29 batches), the candidate
     protocol (1,001 candidates) in Valid and Test mode; each at
     examples/fb15k.sh's --batch_size_eval 16 on the phase-3 data.  After
     phase 3c (whose trace is counted before this phase's CUDA-only
     profiler session), the eval at the recipe's size (phase_eval_recipe):
     dglke_tpu_torch-eval over phase 3's checkpoint on FB15k's 59,071 test
     triples at batch 16, filtered, with planted hubs in its train split
     (filter widths 8 to 16,384, a bucket of two chunks), its launches and
     eval graphs held; then the fused route again and the per-batch route
     as the trainer ran it before its fused calls (per_batch_ranks) on
     the same tables: seconds a split, device busy share, peak memory,
     MRR, the ranks equal but at near ties (counted).  Every single-device
     CLI run's eval graph line is held to EXPECTED_EVAL_GRAPHS
     (eval_graphs), host-table runs' included.  Host mode's eval calls
     (phase_host_eval_graphs: host_table.py's pos/side and block calls
     and the sampled group call, K1 reading the mapped tables inside the
     graphs) on mapped host tables, two evals on each route, against the
     same calls run eagerly: the ranks bit for bit and equal to the card
     tables' evaluate, the launches equal, a graph a memo key: TransE_l2
     filtered over 50,000 entities (four blocks, the tail early), with
     5,000 test triples (two query chunks a block), RotatE raw (59
     blocks), TransR filtered, and the sampled eval filtered and with
     neg_deg_sample;
  3. the TransE_l2 main path: dglke_tpu_torch.cli.train.main on an
     FB15k-shaped synthetic dataset with the flagship flags and --test,
     with the launch counts read around that run only and held to
     EXPECTED_LAUNCHES; then two flagship steps on the card against the
     CPU's plain path; then a flagship step on the host clock, and under
     torch.profiler the device's busy share and the kernels by device time;
  3b. --compute_dtype bfloat16: the flagship through the CLI with the flag
     (the same 1,000 steps, data and eval; launch counts those of the fp32
     run; the tables fp32), its test MRR and HITS@10 beside the fp32
     run's; RESCAL with the flag (BF16_RESCAL_STEPS steps, the stock route:
     K3 never, K2 on the 250,000-wide relation rows); the step profiles of
     both beside their fp32 ones; one bf16 step of TransE_l2, RESCAL and
     TransR (examples/fb15k.sh, hidden 200) in each direction against the
     CPU's on the same tables, at the CPU test's bf16 tolerances;
  3c. --profile: the flagship through dglke_tpu_torch-train --profile DIR,
     200 steps: the Chrome trace parses, its spans (one a replayed group)
     cover the steps [2s, 4s), and it lists K1, the grouping and K2, run
     inside the CUDA graph, by their CUDA names as many times as those
     steps x their launches a step; the tables bit-equal to the same
     run's without --profile (a trace with no device event is taken once
     more); then the same run with --valid every 50 steps at batch 16
     (phase_valid_graphs): training graph and eval graphs in one run, the
     eval graphs captured in the first Valid eval and replayed by the
     later ones, the tables bit-equal to the run without eval;
  4. the same CLI run with --async_update (launch counts held), and a
     dataset smaller than two batches (1,500 train edges at batch 1,000)
     through the CLI, which must take the host-fed route, launch K1, the
     grouping and K2 every step, and train; and an odd --max_step (step
     group size 1) on the phase-3 data, which on one device must take the
     host-fed route too (phase_step_one); both host-fed runs replay the fed
     call's CUDA graphs (graph_route); then the host-fed step profile at the
     flagship, s = 1, on both routes (phase_fed_profile);
  5. the RESCAL main path, the same three parts as phase 3: the CLI with
     the flags of examples/fb15k.sh (hidden 500), --max_step 1000 and
     --test on the same data, its launch counts read around that run only
     and held to EXPECTED_LAUNCHES (the relation update goes through K3,
     never K2); two full-width steps on the card against the CPU; the
     step profile;
  5b. the serving path over the checkpoints phases 3 and 5 wrote, each
     request's launch counts read around it alone and held to
     EXPECTED_LAUNCHES (K1 only), its seconds and scores per second
     printed, its output held to the CPU's on a cut (equal ids but at near
     ties, scores within SERVE_RTOL): dglke_tpu_torch-predict for
     TransE_l2 (batch_head over 16 heads x 1,345 relations x 14,951 tails;
     100,000 triples triplet_wise, plain and logsigmoid) and RESCAL (all
     over 8 heads x 8 relations x 14,951 tails: K1's wide shape on the
     1 MB relation rows), dglke_tpu_torch-emb_sim (cosine batch_left for
     1,000 left rows; all 14,951^2 pairs), the object API
     (TransE_l2Model(...).load, link_predict with exclude_mode="exclude"
     and the training graph attached), the device's busy share over one
     link_predict, and exact ties planted in the entity table listed lower
     id first;
  6. the ogbl-wikikg2 TransE_l2 recipe (examples/wikikg2.sh:11-14: batch
     512, 128 negatives, hidden 500, gamma 30, -adv -a 1.0, lr 0.25,
     -rc 1e-9, --no_eval_filter --test --batch_size_eval 32
     --neg_sample_size_eval 500) through the CLI on a synthetic dataset at
     ogbl-wikikg2's published shape, 2,500,604 entities and 535
     relations (a 5.0 GB entity table), served through the port's ogb
     loader by a stand-in `ogb.linkproppred` module (the script needs
     neither the `ogb` package nor the dataset files).  Cuts: 1,000 steps
     (the recipe runs 20,000), 2,000,000 train edges (16,109,182), 20,000
     test triples (598,543); --no_save_emb (no 5 GB checkpoint written).
     Its launch counts are held to EXPECTED_LAUNCHES.  On the trained
     state: the sampled ranks of the first 8 test batches in both modes
     against the CPU's on the same rows, equal but at near ties (counted);
     the candidate protocol, 2,000 queries x 1,001 candidates (wikikg90M's
     count, rows listing a candidate twice), in Valid and Test mode, ranks
     and top-10 positions against the CPU's, equal but at near ties; the
     sampled eval and the candidate protocol timed on the fused route and on
     the per-batch route (phase_wiki_eval_routes, phase_candidates); the
     sampled ranks of the two routes equal but at near ties (counted), the
     candidate ranks and top-10 of the fused route equal on every row to
     those of the card's own scores at its call shape; K1
     and the whole K2 call at the path's entity shape (1,536 ids over the
     5.0 GB table, cold in L2) in turns beside index_select / index_add_
     and the plain versions, with the bounds.  Then two full-width steps
     on the card against the CPU, and the step profile;
  6b. host-resident tables (--mix_cpu_gpu).  The chunked save
     (utils/io.py:_save_table) of the wikikg2 path's 5.0 GB entity table
     and of a bf16 copy, read back with np.load (bit-equal; equal to the
     fp32 upcast), the card's allocation during each save under one chunk.
     K1 and K2 on tables in mapped host memory (rows.map_host) held to
     their plain versions: K1 at the flagship's 3,000 ids x 400 and on
     1,000 of TransR's 160,000-wide projection rows (in the mapped shape
     and the one a table on the card takes), K2
     from K1's rows, Adagrad and the plain row add; each timed beside its
     bound over the host link (the PCIe generation and width nvidia-smi
     reports), its plain version and the staging route (the JAX package's
     host design written in PyTorch).  The flagship through the CLI with
     --mix_cpu_gpu (1,000 steps, filtered test eval; launch counts held),
     its checkpoint through dglke_tpu_torch-eval in host mode (adopted
     from config.json) and with --no_mix_cpu_gpu on the card: the filtered
     ranks of all three identical, each host eval printing its eval graph
     line; the training run replays one CUDA graph a step (two graphs).
     The same flagship with --valid every 50 of 200 steps
     (phase_host_valid): the host eval's graphs captured in the second
     Valid eval and replayed by the later ones, the tables bit-equal to
     the run without eval.  Two host steps on the card against the CPU;
     the host step profile on both routes (the fed call's graph and
     host_step);
  7. the planted quality gate of every family on the card (MRR >= 0.85,
     HITS@10 >= 0.99, the JAX package's calibrated configs), in fp32 and
     with --compute_dtype bfloat16, side by side;
  7d. beside phase 7, in a process of its own on the host (``--ldg-worker``):
     the native LDG partitioner at Freebase scale, planted_line_big with
     86,054,152 entities and 344,214,592 train edges, k = 4, twice: every
     node assigned, no part over 1.5 n / k, the cut recounted equal and
     below a random assignment's, the two runs bit-equal; after phase 7c,
     dglke_tpu_torch-partition -k 2 (native LDG) on the flagship-shaped
     data and dglke_tpu_torch-train --dist --partition_path on two ranks
     sharing the card, launches exact on each;
  7c. multi-device training (--dist): the card has to hold every rank, and
     NCCL takes one rank a card, so two rank processes of this script
     share cuda:0 over host-staged gloo (``--dist-worker``; torch's
     launcher variables, a free localhost port, a timeout, only their own
     PIDs killed).  One step of each plan (vocab-sharded, replicated) at
     the flagship shapes and at RESCAL's (K3 on every replica) against
     one device's step on the 2,000-row global batch, replicas bit-equal
     across ranks; the same at WN18's DistMult recipe (40,943 x 512, batch
     2,048 a rank: each owner's or replica's entity update groups 12,288
     ids on the grouping's tiles route), each first step's tiles-route
     groupings counted; WN18's DistMult recipe through the CLI under each
     plan (50 and 20 steps), launches exact on each rank (phase_dist_wn18);
     the flagship under --dist on 2 ranks x batch 1,000,
     each plan, 100 steps and the filtered test eval, the metrics of both
     ranks equal to one device's dglke_tpu_torch-eval of the npy
     checkpoint written through rank 0; RESCAL under --dist (vocab), 100
     steps; ogbl-wikikg2 at full width (2,500,604 x 500, 2.5 GB a rank)
     under --dist --table_sharding vocab, 100 steps saved every 50
     (--sharded_ckpt) and resumed for 50 with the sampled test eval, the
     loaded tables bit-equal to the saved ones (the gloo phases run each
     step group eagerly as one call, on the fixed-capacity route); and
     --dist on one rank over NCCL on the graph route (phase_dist_nccl:
     one CUDA graph a step group, the collectives inside): the flagship
     under each plan and RESCAL under the vocab plan through the CLI,
     bit-equal to the runs without --dist, then a replayed group against
     the eager group at full width, bit for bit, both routes timed, and
     the vocab plan's test eval of the flagship checkpoint as EvalCalls
     graphs, its integer ranks one device's.  Launches exact on every
     rank; each rank's host ms, collective bytes and collective ms per
     step printed (not multi-card numbers);
  7b. the capacity run: the Freebase TransE_l2 recipe
     (examples/freebase.sh:8-11) with --mix_cpu_gpu through the CLI at
     FB_ENT entities, an entity table larger than the card (cuts listed at
     FB_ENT), launch counts held through the graph replays; the host-table
     init and mapping seconds, the sampled test eval, a 50-step profile
     after 50 on both routes, a filtered
     full-entity host eval of 1,000 test triples streaming the table
     through the card once, on the graph route and on the eager baseline
     (capacity_full_eval: seconds and streaming rate of each, a window of
     blocks traced and split into copy, math and idle, the ranks equal,
     one block's staging copy timed alone), and the card's peak
     allocation held under HOST_PEAK_CEILING;
  8. the kernel summary: a `kernels:` line, one JSON line of per-kernel
     numbers, the card's name and power limit, and the result line.

Everything it writes goes under build/chip_smoke/ and is removed at the
end; the kernels are built under build/dglke_tpu_torch/.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
from itertools import islice
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and fp32 outside the
# tensor cores; at the card's full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

N_ENT, N_REL, DIM = 14951, 1345, 400
BATCH, NEG = 1000, 200
N_ENT_IDS = 2 * BATCH + (BATCH // NEG) * NEG      # [h | t | neg] = 3,000
LR = 0.25

# The two main paths' configurations: TransE_l2 as bench.py:188-201 runs
# it, RESCAL as examples/fb15k.sh:29-31 runs it (default regularization,
# coef 2e-6 and norm 3).
TRANSE = dict(model_name="TransE_l2", hidden_dim=DIM, gamma=19.9, lr=LR,
              batch_size=BATCH, neg_sample_size=NEG,
              neg_adversarial_sampling=True, regularization_coef=1e-9)
RESCAL = dict(model_name="RESCAL", hidden_dim=500, gamma=24.0, lr=0.03,
              batch_size=BATCH, neg_sample_size=NEG,
              neg_adversarial_sampling=True, regularization_coef=2e-6,
              regularization_norm=3)
RESCAL_WIDTH = RESCAL["hidden_dim"] ** 2             # 250,000 per relation
# The ogbl-wikikg2 TransE_l2 recipe (examples/wikikg2.sh:11-14) at the
# published shape: 2,500,604 entities and 535 relations, hidden 500, so
# the entity table is 2,500,604 x 500 fp32 = 5.0 GB and no row of it stays
# in the 50 MB L2.  Cut: 1,000 steps (the recipe runs 20,000), 2,000,000
# train edges (16,109,182), 20,000 test triples (598,543).
WIKI_ENT, WIKI_REL = 2_500_604, 535
WIKI_TRAIN, WIKI_TEST = 2_000_000, 20_000
WIKI = dict(model_name="TransE_l2", hidden_dim=500, gamma=30.0, lr=0.25,
            batch_size=512, neg_sample_size=128,
            neg_adversarial_sampling=True, adversarial_temperature=1.0,
            regularization_coef=1e-9)
WIKI_EVAL_BATCH, WIKI_EVAL_NEG = 32, 500
WIKI_ENT_IDS = 2 * 512 + (512 // 128) * 128          # [h | t | neg] = 1,536
# The candidate protocol on the trained wikikg2 state: wikikg90M's
# published 1,001 candidates for each of 2,000 queries.
CAND_QUERIES, CAND_K = 2000, 1001
# A row is a near tie where another score lies within TIE_RTOL x (|score|
# + gamma) of the one it is compared with: the card and the CPU round the
# scores apart, and only there may their ranks differ.  TransE's score is
# gamma - distance, so its rounding error follows gamma + |score|, not
# |score| (a score near 0 carries the error of a distance near gamma; at
# gamma 30 the bound is ~3.1e-5, some 16 fp32 ulps of 30).  The sampled
# check also counts the rows within POS_RTOL |pos|.
TIE_RTOL, POS_RTOL = 1e-6, 1e-5
RESCAL_EVAL_BATCH = 500
MAIN_STEPS = 1000
# The RESCAL main path's test MRR on its seeded data (PRs 2 and 3 gave it
# to all printed digits); a change of summation order in an update may move
# the ranks a little, not more than this.
RESCAL_MRR, MRR_TOL = 0.7841296576120397, 0.01
# Launches in each main path's run alone (1,000 steps, then the test eval):
# K1 twice per step (entity and relation rows) and 8 times in the eval
# (the 2,000 test triples at batch 500 are 4 batches a mode, all of filter
# width 8: one group call a mode, trainer._mega_eval, each gathering the
# rows of h, t and r and the 14,951 candidate rows); K2 once per step for
# each table it updates, and the id grouping once before each K2 and each
# K3 call (never torch.sort).  RESCAL's relation update goes through K3 on
# every step and never through K2, and its relation gather is K1 with the
# sum of |x|^3 and the product R t or h^T R (gather_rows_matvec, counted
# under gather_rows, gather_rows_pow_sum and gather_rows_matvec).
#
# TransE_l2 with --async_update launches the same: each step's entity
# update is applied once, one step late inside each group of 10 steps (the
# last at the group's end), and an empty pending update launches nothing.
# The host-fed run (1,500 train edges, under two batches, 100 steps, no
# eval) launches two K1, two groupings and two K2 a step (in 9 replays of
# its group of 10 after the first).
#
# Every TransE_l2 run in fp32 (the Logsigmoid loss, no neg_deg_sample)
# computes its loss and row gradients by the fused route's two kernels a
# step (ops/transe_l2.py, counted under transe_l2_loss); RESCAL, bf16
# compute and the other families never launch them.
#
# wikikg2: two K1, two groupings and two K2 a step over 1,000 steps; the
# sampled test eval of 20,000 triples in batches of 32 is 625 batches a
# mode, ranked in groups of 32 batches (trainer.EVAL_GROUP, the tail group
# padded): 20 calls a mode, each two K1 (the entity rows [h | t | neg], the
# relation rows), so 80 K1 in the eval.
EXPECTED_LAUNCHES = {
    "TransE_l2": {"gather_rows": 2008, "gather_rows_pow_sum": 0,
                  "gather_rows_matvec": 0, "group_ids": 2000,
                  "group_ids_tiles": 0,
                  "sparse_adagrad_rows": 2000, "outer_adagrad_update": 0,
                  "transe_l2_loss": 2000},
    "TransE_l2 async": {"gather_rows": 2008, "group_ids": 2000,
                        "group_ids_tiles": 0, "sparse_adagrad_rows": 2000,
                        "outer_adagrad_update": 0, "transe_l2_loss": 2000},
    "TransE_l2 host-fed": {"gather_rows": 200, "group_ids": 200,
                           "group_ids_tiles": 0, "sparse_adagrad_rows": 200,
                           "outer_adagrad_update": 0, "transe_l2_loss": 200},
    "RESCAL": {"gather_rows": 2008, "gather_rows_pow_sum": 1000,
               "gather_rows_matvec": 1000, "group_ids": 2000,
               "group_ids_tiles": 0,
               "sparse_adagrad_rows": 1000, "outer_adagrad_update": 1000,
               "transe_l2_loss": 0},
    "wikikg2": {"gather_rows": 2080, "group_ids": 2000, "group_ids_tiles": 0,
                "sparse_adagrad_rows": 2000, "outer_adagrad_update": 0,
                "transe_l2_loss": 2000},
}
# The eval's CUDA graphs a run captures and replays (phase 2c), summed over
# its evals: each static call shape's first call runs eagerly, its second
# captures, and it and every later one replay.  The main paths' test evals
# make one call a mode (nothing captured); wikikg2's sampled eval makes 20
# calls a mode (one graph each, 19 replays).  EVAL_RECIPE_GRAPHS below adds
# the recipe-size eval.
EXPECTED_EVAL_GRAPHS = {"TransE_l2": (0, 0), "TransE_l2 async": (0, 0),
                        "TransE_l2 bf16": (0, 0), "RESCAL": (0, 0),
                        "wikikg2": (2, 38)}
# Step group size 1 on one device (an odd --max_step): the host-fed
# TrainSampler, as in the JAX package, a step launching K1, the grouping
# and K2 twice each.  S1_STEPS steps on the phase-3 data, no eval.
S1_STEPS = 301
EXPECTED_LAUNCHES["TransE_l2 s = 1"] = {
    "gather_rows": 2 * S1_STEPS, "group_ids": 2 * S1_STEPS,
    "group_ids_tiles": 0, "sparse_adagrad_rows": 2 * S1_STEPS,
    "outer_adagrad_update": 0, "transe_l2_loss": 2 * S1_STEPS}
# Host-resident tables (--mix_cpu_gpu): each step gathers the entity and
# the relation rows from the mapped host tables (K1 x 2) and writes both
# back (a grouping and K2 each), 1,000 steps: the first eagerly, the rest
# in CUDA graph replays, which add their capture's counts.  The
# flagship's filtered full-entity test eval gathers, for each of its two
# directions, the
# queries' [h | t] entity rows and their relation rows (K1 x 2); the table
# streams through the card by plain copies, no kernel.  The capacity run's
# sampled test eval (2,000 triples, batches of 1,000) is 2 batches a mode,
# one grouped call a mode (host_table.py), two K1 each.
for _label in ("TransE_l2 host", "Freebase host"):
    EXPECTED_LAUNCHES[_label] = {"gather_rows": 2004, "group_ids": 2000,
                                 "group_ids_tiles": 0,
                                 "sparse_adagrad_rows": 2000,
                                 "outer_adagrad_update": 0,
                                 "transe_l2_loss": 2000}
HOST_PATHS = ("TransE_l2 host", "Freebase host")
# Their evals take the eval graphs too: the flagship's filtered test eval
# makes one pos/side call a direction and one block call (its 14,951
# entities fit one block), the capacity run's sampled test eval one group
# call a mode: each key called once, nothing captured.
for _label in HOST_PATHS:
    EXPECTED_EVAL_GRAPHS[_label] = (0, 0)
# The capacity run: the Freebase TransE_l2 recipe (examples/freebase.sh:
# 8-11: batch 1,000, 200 negatives, hidden 400, gamma 10, lr 0.1, -rc 1e-9,
# -adv; --batch_size_eval 1000 --neg_sample_size_eval 1000, filtered,
# --no_save_emb) with --mix_cpu_gpu.  Cut: 55,000,000 of Freebase's
# 86,054,151 entities (docs/format_out.md:24), so the entity table is
# 55,000,000 x 400 fp32 = 88.0 GB, larger than the card's 80 GB, where the
# whole 137.7 GB table does not fit the host memory of a one-H100 machine
# with MemTotal 108.45 GB (printed by phase_capacity); 14,824 relations as
# published; 2,000,000 train edges (~305 M), 2,000 test triples (~17 M),
# 1,000 steps (the recipe runs 2,560,000); then a full-entity eval of 1,000
# of the test triples.
FB_ENT, FB_REL = 55_000_000, 14_824
FB = dict(model_name="TransE_l2", hidden_dim=400, gamma=10.0, lr=0.1,
          batch_size=1000, neg_sample_size=200,
          neg_adversarial_sampling=True, regularization_coef=1e-9)
FB_TRAIN, FB_TEST, FB_FULL_EVAL = 2_000_000, 2_000, 1_000
FB_EVAL_BATCH = FB_EVAL_NEG = 1000
# Byte offsets into a table from here on need more than 32 bits: K1 is held
# on the capacity run's rows on both sides of it.
FAR_OFFSET = 1 << 32
# What the card may hold at once in host mode: rows of a step, an eval
# block and its scores; far below any table it exists for.
HOST_PEAK_CEILING = 2 << 30
# The serving runs: K1 gathers a request's rows once, whatever the exec
# mode (models/infer.py:scored_blocks, sim_topk): heads, relations and
# tails for predict and link_predict (a "*" slot gathers the whole table;
# RESCAL's 8 relation rows of 250,000 take the wide shape), the left and
# the right rows for emb_sim; nothing of training launches.
for _label, _k1 in (("predict TransE_l2 batch_head", 3),
                    ("predict TransE_l2 triplet_wise", 3),
                    ("predict TransE_l2 logsigmoid", 3),
                    ("predict RESCAL all", 3), ("emb_sim batch_left", 2),
                    ("emb_sim all", 2), ("link_predict exclude", 3)):
    EXPECTED_LAUNCHES[_label] = {"gather_rows": _k1, "group_ids": 0,
                                 "group_ids_tiles": 0,
                                 "sparse_adagrad_rows": 0,
                                 "outer_adagrad_update": 0,
                                 "transe_l2_loss": 0}
# The serving requests, at the width of the checkpoints the TransE_l2 and
# RESCAL main paths write: 16 heads x 1,345 relations x 14,951 tails
# (batch_head), 100,000 triples, RESCAL's 8 heads x 8 relations x 14,951
# tails, 1,000 left rows x 14,951 (cosine), all 14,951^2 pairs; top 10.
SERVE_K, SERVE_HEADS, SERVE_TRIPLES = 10, 16, 100_000
RESCAL_HEADS = RESCAL_RELS = 8
SIM_LEFT = 1000
# The CPU recomputes a cut of each request: the first SERVE_CUT heads (or
# left rows) where the blocks stand alone, the whole request where it is
# cheap (triplets, RESCAL's 8 x 8), SIM_CUT left rows of the all-pairs
# similarity on both devices.  Scores: |card - CPU| <= SERVE_RTOL (|s| +
# scale), scale gamma for link scores and 1 for similarities (cuBLAS, the
# CPU's BLAS and cdist sum in other orders); ids equal but at near ties.
SERVE_CUT, SIM_CUT, SERVE_RTOL = 2, 1000, 1e-5

# Stated tolerances.  K1 moves bits: exact.  K2 sums each id's segment in
# a fixed order, the plain version adds per occurrence:
# fp32 within rtol 1e-5 / atol 1e-6.  With a bf16 table both sum each
# touched row in fp32 and round once: within one bf16 ulp (plus atol 1e-6,
# for fp32 sums that cancel near zero).
K2_RTOL, K2_ATOL = 1e-5, 1e-6
# K3 sums each id's segment in a fixed order and subtracts once; its plain
# version adds per occurrence (index_add_): fp32 within rtol 1e-5 / atol
# 1e-6, and two runs bit-identical.
K3_RTOL, K3_ATOL = 1e-5, 1e-6
# K3 is also held on this many relation ids (its grouping's tiles route);
# the plain version materializes their [9,000, 250,000] gradient, 9 GB.
K3_WIDE_IDS = 9000
# outer_update.cu and group_ids.cu with their phase stamps compiled in
# (k3_phases, group_phases).
K3_STAMPED = Path(ROOT, "dglke_tpu_torch", "ops", "csrc",
                  "outer_update_stamps.cu")
GROUP_STAMPED = Path(ROOT, "dglke_tpu_torch", "ops", "csrc",
                     "group_ids_stamps.cu")


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time of one fn() call, back to back, on CUDA events: what a
    caller waits, host launch overhead included (inputs stay warm in L2, as
    they are inside a train step)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_events(prof):
    import torch
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms_by_kernel(fn, iters: int = 50, attempts: int = 3) -> dict:
    """Device time of one fn() call by kernel, from a torch.profiler trace
    of `iters` calls (host overhead excluded).  A trace that holds no
    device event at all is taken again, up to `attempts` traces: on the
    card the profiler's device tracing now and then returns an empty
    trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {e.key: e.self_device_time_total / iters / 1e3
               for e in _kernel_events(prof)}
        if out:
            return out
        print("  (torch.profiler returned no device event; tracing again)")
    return out


def device_ms(fn, iters: int = 50) -> float:
    """Device time of one fn() call: the sum of the kernels it runs."""
    ms = sum(device_ms_by_kernel(fn, iters).values())
    if ms <= 0:
        fail("torch.profiler recorded no device time")
    return ms


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulps(got, want, atol: float = K2_ATOL) -> float:
    """Largest |got - want| in units of (one bf16 ulp of `want` + atol);
    at most 1 means within the stated bf16 tolerance."""
    import torch
    want = want.float()
    mag = torch.clamp(want.abs(), min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(torch.max((got.float() - want).abs() / (ulp + atol)))


# ---------------------------------------------------------------------------
# Phase 1


def phase_build():
    import torch
    from dglke_tpu_torch.ops import outer_update, rows, transe_l2
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    rows.build_libraries(rows.SOURCE, rows.GROUP_SOURCE, outer_update.SOURCE,
                         transe_l2.SOURCE, K3_STAMPED, GROUP_STAMPED)
    rows.load_library(rows.SOURCE, rows.SIGNATURES)
    rows.load_library(rows.GROUP_SOURCE, rows.GROUP_SIGNATURES)
    rows.load_library(outer_update.SOURCE, outer_update.SIGNATURES)
    rows.load_library(transe_l2.SOURCE, transe_l2.SIGNATURES)
    print(f"kernel builds (in parallel) + load: {time.time() - t0:.2f} s")
    for src, log in rows.build_logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                        "warning")):
                print(f"  nvcc {src}: {line.strip()}")


# ---------------------------------------------------------------------------
# Phase 2


def phase_kernels():
    """K1 against its plain version at the flagship shapes; returns its
    numbers for the JSON line."""
    import torch
    from dglke_tpu_torch.ops import rows
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    table = torch.randn((N_ENT, DIM), generator=gen, device=dev) * 0.05
    rel_table = torch.randn((N_REL, DIM), generator=gen, device=dev) * 0.05
    ent_ids = torch.randint(0, N_ENT, (N_ENT_IDS,), generator=gen,
                            device=dev, dtype=torch.int32)
    rel_ids = torch.randint(0, N_REL, (BATCH,), generator=gen, device=dev,
                            dtype=torch.int32)
    n_unique = int(torch.unique(ent_ids).numel())
    n_rel_unique = int(torch.unique(rel_ids).numel())
    print(f"entity ids: {N_ENT_IDS} ({n_unique} distinct); relation ids: "
          f"{BATCH} ({n_rel_unique} distinct)")

    # -- K1: row gather ------------------------------------------------------
    if rows.gather_shape(DIM) != "warp":
        fail(f"K1 at the flagship width {DIM} must keep one warp per row")
    for name, tab, ids in (("entity fp32", table, ent_ids),
                           ("entity bf16", table.to(torch.bfloat16), ent_ids),
                           ("relation fp32", rel_table, rel_ids)):
        got = rows.gather_rows(tab, ids, DIM)
        want = rows.gather_rows_plain(tab, ids, DIM)
        torch.cuda.synchronize()
        if got.dtype != torch.float32 or not torch.equal(got, want):
            fail(f"K1 gather_rows {name}: differs from its plain version")
        print(f"K1 gather_rows {name} [{ids.numel()} ids]: exact")
    k1_err = float((rows.gather_rows(table, ent_ids, DIM)
                    - rows.gather_rows_plain(table, ent_ids, DIM))
                   .abs().max())
    k1 = {n: (device_ms(f), call_ms(f)) for n, f in (
        ("kernel", lambda: rows.gather_rows(table, ent_ids, DIM)),
        ("plain", lambda: rows.gather_rows_plain(table, ent_ids, DIM)),
        ("index_select", lambda: torch.index_select(table, 0, ent_ids)))}
    k1_bytes = N_ENT_IDS * 4 + n_unique * DIM * 4 + N_ENT_IDS * DIM * 4
    k1_bound, k1_by = bound_ms(k1_bytes, 0)
    bf = table.to(torch.bfloat16)
    k1_bf = device_ms(lambda: rows.gather_rows(bf, ent_ids, DIM))
    k1_rel = device_ms(lambda: rows.gather_rows(rel_table, rel_ids, DIM))
    print(f"K1 gather_rows entity fp32 (warp shape), device ms (ms per call "
          f"with host overhead): " + ", ".join(f"{n} {d:.4f} ({c:.4f})"
                                               for n, (d, c) in k1.items())
          + f"; bound {k1_bound:.4f} ({k1_by}, {k1_bytes / 1e6:.2f} MB), "
          f"{100 * k1_bound / k1['kernel'][0]:.1f}% of it, "
          f"{k1_bytes / k1['kernel'][0] / 1e9:.3f} TB/s; kernel on entity "
          f"bf16 {k1_bf:.4f}, on relation fp32 [{BATCH} ids] {k1_rel:.4f}")

    return [
        {"name": "gather_rows", "route": "cuda",
         "source": "dglke_tpu_torch/ops/csrc/rows.cu",
         "replaces": "dglke_tpu/ops/pallas/rows.py:89",
         "launches": None, "max_abs_err": k1_err, "ms": k1["kernel"][0],
         "plain_ms": k1["plain"][0], "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1["index_select"][0]},
    ]


# The fused TransE_l2 loss route's shapes (b, chunks, K, D): the FB15k
# recipe's 5 chunks of 200 x 200 negatives x 400 and ogbl-wikikg2's 4 of
# 128 x 128 x 500, the benchmark's two TransE cells.
TRANSE_L2_SHAPES = {"fb15k": (1000, 5, 200, 400),
                    "wikikg2": (512, 4, 128, 500)}


def phase_transe_l2_kernels():
    """The fused TransE_l2 loss route (ops/transe_l2.py: its PyTorch sums
    and its two kernels) at both shapes of TRANSE_L2_SHAPES, in both
    orientations, against its plain version on the same rows: every log
    value within rtol 1e-5, every row gradient within 1e-5 of its largest
    element (the products add their fp32 terms in another order than
    cuBLAS).  Timed in turns with the autograd route it replaces (the
    library column), the plain version apart; returns the entry for the
    JSON line, its launches summed from the main paths' transe_l2_loss
    counts."""
    import torch
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.models.ke_model import KEModel
    from dglke_tpu_torch.ops import rows, transe_l2
    dev = torch.device("cuda")
    shapes, errs = {}, []
    for name, (b, c, k, d) in TRANSE_L2_SHAPES.items():
        gen = torch.Generator(dev)
        gen.manual_seed(0)
        ent = (torch.rand((2 * b + c * k, d), generator=gen, device=dev)
               - 0.5) * 0.12
        rel = (torch.rand((b, d), generator=gen, device=dev) - 0.5) * 0.12
        chunks = dict(b=b, num_chunks=c, chunk_size=b // c,
                      neg_sample_size=k)
        call = dict(gamma=19.9, adversarial=True, temperature=1.0,
                    share=1.0, reg_coef=1e-9, reg_pow=3)
        for neg_head in (False, True):
            args = dict(chunks, **call, neg_head=neg_head)
            before = rows.launches["transe_l2_loss"]
            got = transe_l2.loss_and_grads(ent, rel, None, **args)
            want = transe_l2.loss_and_grads_plain(ent, rel, None, **args)
            torch.cuda.synchronize()
            if rows.launches["transe_l2_loss"] != before + \
                    transe_l2.LAUNCHES:
                fail(f"transe_l2_loss {name}: the call counted "
                     f"{rows.launches['transe_l2_loss'] - before} launches")
            if list(got[1]) != list(want[1]):
                fail(f"transe_l2_loss {name}: log keys {list(got[1])}")
            for key in want[1]:
                g, w = float(got[1][key]), float(want[1][key])
                if abs(g - w) > 1e-5 * abs(w):
                    fail(f"transe_l2_loss {name} neg_head={neg_head}: "
                         f"{key} {g} against the plain version's {w}")
            for part, g, w in zip(("entity", "relation"), got[2:], want[2:]):
                err, scale = float((g - w).abs().max()), float(
                    w.abs().max())
                if err > 1e-5 * scale:
                    fail(f"transe_l2_loss {name} neg_head={neg_head}: "
                         f"{part} gradients off by {err}, above 1e-5 of "
                         f"their largest element {scale}")
                errs.append(err)
            print(f"transe_l2_loss {name} [{c} x {b // c} x {k} x {d}] "
                  f"neg_head={neg_head}: logs within rtol 1e-5, gradients "
                  f"within 1e-5 of their largest element (largest gap "
                  f"{max(errs[-2:]):.3e}) of the plain version")
        args = dict(chunks, **call, neg_head=False)
        cfg = KGEConfig(model_name="TransE_l2", hidden_dim=d, batch_size=b,
                        neg_sample_size=k, gamma=19.9,
                        neg_adversarial_sampling=True,
                        adversarial_temperature=1.0,
                        regularization_coef=1e-9, regularization_norm=3)
        model = KEModel(cfg, 100, 10, device="cuda")
        model._transe_l2_fused = lambda *a, **kw: False   # autograd
        turns = _in_turns({
            "route": lambda: transe_l2.loss_and_grads(ent, rel, None,
                                                      **args),
            "autograd": lambda: model._rows_loss_and_grads(
                ent, rel, None, None, **chunks, neg_head=False)}, 50)
        by_kernel = device_ms_by_kernel(
            lambda: transe_l2.loss_and_grads(ent, rel, None, **args))
        kernels_ms = sum(v for key, v in by_kernel.items()
                         if "transe_l2_" in key)
        plain = device_ms(lambda: transe_l2.loss_and_grads_plain(
            ent, rel, None, **args), iters=10)
        n_bytes = 4 * (2 * (3 * b + c * k) * d + 2 * b * d + 4 * b * k)
        bound, by = bound_ms(n_bytes, 6 * b * k * d)
        shapes[name] = {"ms": turns["route"], "kernels_ms": kernels_ms,
                        "plain_ms": plain, "library_ms": turns["autograd"],
                        "bound_ms": bound, "bound_by": by}
        print(f"transe_l2_loss {name}, device ms: the route "
              f"{turns['route']:.5f} (its two kernels {kernels_ms:.5f}), "
              f"the autograd route {turns['autograd']:.5f} (in turns), "
              f"plain {plain:.5f}; bound {bound:.5f} ({by}, "
              f"{6 * b * k * d / 1e9:.3f} GFLOP, {n_bytes / 1e6:.2f} MB), "
              f"the kernels at {100 * bound / kernels_ms:.1f}% of it")
    return {"name": "transe_l2_loss", "route": "cuda",
            "source": "dglke_tpu_torch/ops/csrc/transe_l2.cu",
            "replaces": None, "launches": None, "max_abs_err": max(errs),
            **shapes["fb15k"], "wikikg2": shapes["wikikg2"],
            "counter": "transe_l2_loss"}


def _flagship_ids(seed: int):
    """The flagship's entity ids (3,000 over 14,951 rows) and relation ids
    (1,000 over 1,345), uniform, int32 on the card."""
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(seed)
    ent = torch.randint(0, N_ENT, (N_ENT_IDS,), generator=gen, device=dev,
                        dtype=torch.int32)
    rel = torch.randint(0, N_REL, (BATCH,), generator=gen, device=dev,
                        dtype=torch.int32)
    return gen, ent, rel


def _in_turns(fns: dict, iters: int) -> dict:
    """Device ms of each fn, timed in turns (a, b, c, c, b, a): the mean of
    its two rounds."""
    out = {k: [] for k in fns}
    for k in (*fns, *reversed(fns)):
        out[k].append(device_ms(fns[k], iters=iters))
    return {k: sum(v) / len(v) for k, v in out.items()}


def check_grouping(label: str, ids, n_rows: int, plan=None) -> None:
    """rows.group_ids (or rows.launch_group along ``plan``) bit-exact
    against torch.sort(ids.int32, stable=True), its segments equal to the
    plain grouping's."""
    import torch
    from dglke_tpu_torch.ops import rows
    if plan is None:
        plan = rows.plan_group(ids.numel(), n_rows)
        got = rows.group_ids(ids, n_rows)
    else:
        got = rows.launch_group(ids, n_rows, plan)
    sids, order = torch.sort(ids.to(torch.int32), stable=True)
    plain = rows.group_ids_plain(ids)
    torch.cuda.synchronize()
    c = int(plain.count)
    if not (torch.equal(got.sids, sids) and torch.equal(got.order, order)):
        fail(f"group_ids {label}: differs from torch.sort(stable=True)")
    if not (int(got.count) == c
            and torch.equal(got.heads[:c + 1], plain.heads[:c + 1])
            and torch.equal(got.seg_ids[:c], plain.seg_ids[:c])
            and torch.equal(got.seg_first[:c], plain.seg_first[:c])):
        fail(f"group_ids {label}: segments differ from the plain grouping")
    print(f"group_ids {label} [{ids.numel()} {str(ids.dtype)[6:]} ids over "
          f"{n_rows} rows, {c} segments; {plan}, {plan.kernels} kernel(s)]: "
          f"bit-exact against torch.sort(stable=True)")


def group_phases(label: str, ids, n_rows: int) -> None:
    """Where the grouping's time goes: the stamped build of group_ids.cu
    (thread 0 reads %globaltimer after the block's barrier that ends each
    phase) run on the same ids."""
    import ctypes
    import torch
    from dglke_tpu_torch.ops import rows
    lib = rows.load_library(GROUP_STAMPED, {
        **rows.GROUP_SIGNATURES,
        "dglke_group_stamps": ([ctypes.c_void_p], ctypes.c_int)})
    main_source, rows.GROUP_SOURCE = rows.GROUP_SOURCE, GROUP_STAMPED
    try:
        for _ in range(3):
            rows.group_ids(ids, n_rows)
        torch.cuda.synchronize()
    finally:
        rows.GROUP_SOURCE = main_source
    stamps = np.zeros(5, np.uint64)
    rows.check_launch(lib.dglke_group_stamps(stamps.ctypes.data), "stamps")
    ns = np.diff(stamps.astype(np.int64))
    names = ("load and check", "block radix sort", "head flags, sids and "
             "order stored", "heads placed and stored")
    print(f"group_ids {label} by phase, from the stamped build, us: "
          + ", ".join(f"{n} {t / 1e3:.3f}" for n, t in zip(names, ns))
          + f"; {float(ns.sum()) / 1e3:.3f} in all")


# The tiles route's cases (above the one-block limit): WN18's entity ids
# at 2 ranks (2 x 6,144, examples/wn18.sh:15-17), a Freebase owner's
# (examples/freebase.sh:8-11 at the reference's 8 GPUs: 8 x 3,000 ids over
# its 10,756,769-row shard, 24 bits), and 2^20 ids.
TILES_TIMED = ((12_288, 40_943), (24_000, 10_756_769), (1 << 20, 1 << 14))


def phase_group():
    """The id grouping bit-exact against torch.sort at the main paths'
    shapes and at its edges, on both routes; its time beside torch.sort's
    and the plain grouping's, in turns, and the one-block kernel's by
    phase.  Returns its two entries for the JSON line (the one-block route
    at the flagship ids, the tiles route at 12,288)."""
    import torch
    from dglke_tpu_torch.ops import rows
    gen, ent_ids, rel_ids = _flagship_ids(4)
    dev = ent_ids.device
    limit = rows.GROUP_BLOCK_MAX

    def uniform(n_rows, n, dtype=torch.int32, edges=True):
        ids = torch.randint(0, n_rows, (n,), generator=gen, device=dev,
                            dtype=dtype)
        if edges and n >= 2:
            ids[0], ids[-1] = n_rows - 1, 0     # the range's two ends
        return ids

    for label, ids, n_rows in (
            ("flagship entity", ent_ids, N_ENT),
            ("flagship entity as int64", ent_ids.long(), N_ENT),
            ("flagship relation", rel_ids, N_REL),
            ("all equal", torch.full((N_ENT_IDS,), 4321, dtype=torch.int32,
                                     device=dev), N_ENT),
            ("permuted arange", torch.randperm(
                N_ENT_IDS, generator=gen, device=dev).to(torch.int32),
             N_ENT_IDS),
            ("n = 1", ent_ids[:1], N_ENT),
            ("n = 33", ent_ids[:33], N_ENT),
            ("n at the one-block limit", uniform(N_ENT, limit), N_ENT),
            ("n_rows = 2^14", uniform(1 << 14, N_ENT_IDS), 1 << 14),
            ("n_rows = 2^14 + 1", uniform((1 << 14) + 1, N_ENT_IDS),
             (1 << 14) + 1),
            ("Freebase id range", uniform(86_054_151, N_ENT_IDS,
                                          torch.int64), 86_054_151),
            # the tiles route
            ("n one past the limit (two tiles, one nearly empty)",
             uniform(N_ENT, limit + 1), N_ENT),
            ("WN18 entity ids at 2 ranks", uniform(40_943, 12_288), 40_943),
            ("a Freebase owner's shard at 8 ranks",
             uniform(10_756_769, 24_000), 10_756_769),
            ("Freebase id range, 24,000 ids", uniform(
                86_054_151, 24_000, torch.int64), 86_054_151),
            ("all equal, 20,000 ids", torch.full(
                (20_000,), 4321, dtype=torch.int32, device=dev), N_ENT),
            ("permuted arange, 30,000 ids", torch.randperm(
                30_000, generator=gen, device=dev).to(torch.int32), 30_000),
            ("2^20 ids over 2^14 rows (long segments)",
             uniform(1 << 14, 1 << 20), 1 << 14),
            ("2^20 ids over 2^31 - 1 rows", uniform((1 << 31) - 1, 1 << 20),
             (1 << 31) - 1),
            ("five tiles (three passes)", uniform(40_943, 5 * limit - 7),
             40_943)):
        check_grouping(label, ids, n_rows)
    # The tiles route with no merge pass, forced on one tile.
    check_grouping("tiles route forced on one tile (no merge pass)", ent_ids,
                   N_ENT, rows.GroupPlan("tiles", 14, tiles=1, passes=0))

    # Times at the flagship shapes: the kernel, torch.sort and the plain
    # grouping in turns; the kernel by phase.  Then the tiles route.
    out = {}
    cases = [("entity", ent_ids, N_ENT), ("relation", rel_ids, N_REL)] + [
        (f"{n} ids", uniform(n_rows, n), n_rows) for n, n_rows in TILES_TIMED]
    for label, ids, n_rows in cases:
        plan = rows.plan_group(ids.numel(), n_rows)
        ms = _in_turns({
            "kernel": lambda: rows.group_ids(ids, n_rows),
            "torch.sort": lambda: torch.sort(ids, stable=True),
            "plain": lambda: rows.group_ids_plain(ids)}, iters=50)
        host = {k: call_ms(f) for k, f in (
            ("group_ids", lambda: rows.group_ids(ids, n_rows)),
            ("torch.sort", lambda: torch.sort(ids, stable=True)))}
        segs = int(rows.group_ids_plain(ids).count)
        n = ids.numel()
        nbytes = 4 * n + 4 * n + 8 * n + 4 * (segs + 1) + 8 * segs + 4
        bound, by = bound_ms(nbytes, 0)
        print(f"group_ids {label} [{n} ids over {n_rows} rows, {segs} "
              f"segments, {plan}, {plan.kernels} kernel(s)], device ms in "
              f"turns: " + ", ".join(f"{k} {v:.5f}" for k, v in ms.items())
              + f"; ms per call with host overhead: group_ids "
              f"{host['group_ids']:.5f}, torch.sort {host['torch.sort']:.5f}"
              f"; bound {bound:.6f} ({by}, {nbytes} B)")
        if plan.route == "block":
            group_phases(label, ids, n_rows)
        else:
            split = device_ms_by_kernel(lambda: rows.group_ids(ids, n_rows))
            print(f"group_ids {label}, the tiles route by kernel, device ms: "
                  + ", ".join(f"{k[:60]} {v:.5f}" for k, v in split.items())
                  + f"; launch latency, not the {bound:.6f} ms byte bound, "
                  f"sets the floor of its {plan.kernels} launches")
        out[label] = (ms["kernel"], ms["plain"], ms["torch.sort"], bound, by)

    def entry(name: str, label: str) -> dict:
        ms, plain, lib, bound, by = out[label]
        return {"name": name, "route": "cuda",
                "source": "dglke_tpu_torch/ops/csrc/group_ids.cu",
                "replaces": "dglke_tpu/ops/pallas/rows.py:227",
                "launches": None, "max_abs_err": 0.0, "ms": ms,
                "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                "library_ms": lib}

    return [entry("group_ids", "entity"),
            entry("group_ids_tiles", f"{TILES_TIMED[0][0]} ids")]


def check_k2(label: str, table, ss0, ids, grads, adagrad: bool,
             plain64: bool = False) -> float:
    """K2 (sparse_adagrad_rows, or scatter_add_rows without ss0) against its
    plain version: fp32 within K2_RTOL / K2_ATOL, a bf16 table within one
    bf16 ulp + K2_ATOL; two runs bit-identical; rows no id names unchanged.
    plain64: the plain version runs in float64 and is rounded once to the
    table's dtype (for segments so long that the fp32 plain version's own
    sum of per-occurrence deltas strays past the tolerance).  Returns the
    max |diff| of the table."""
    import torch
    from dglke_tpu_torch.ops import rows

    def run(kernel: bool):
        wide = torch.float64 if plain64 and not kernel else None
        emb = table.to(wide) if wide else table.clone()
        state = (ss0.to(wide) if wide else ss0.clone()) if adagrad else None
        g = grads.to(wide) if wide else grads
        if adagrad:
            fn = rows.sparse_adagrad_rows if kernel else rows.sparse_adagrad_plain
            fn(emb, state, ids, g, LR)
        else:
            fn = rows.scatter_add_rows if kernel else rows.scatter_add_plain
            fn(emb, ids, g)
        torch.cuda.synchronize()
        if wide:
            emb = emb.to(table.dtype)
            state = state.float() if adagrad else None
        return emb, state

    (ek, sk), (ep, sp) = run(True), run(False)
    name = "sparse_adagrad_rows" if adagrad else "scatter_add_rows"
    what = f"K2 {name} {label} {str(table.dtype)[6:]}"
    err = float((ek.float() - ep.float()).abs().max())
    if table.dtype == torch.float32:
        if not torch.allclose(ek, ep, rtol=K2_RTOL, atol=K2_ATOL):
            fail(f"{what}: max |diff| {err} outside rtol {K2_RTOL} atol "
                 f"{K2_ATOL}")
        tol = f"within rtol {K2_RTOL} / atol {K2_ATOL} of plain"
    else:
        ulps = bf16_ulps(ek, ep)
        if ulps > 1.0:
            fail(f"{what}: {ulps:.3f} times the bound of one bf16 ulp + atol "
                 f"{K2_ATOL} from the plain version")
        tol = f"within one bf16 ulp + atol {K2_ATOL} of plain ({ulps:.3f})"
    if adagrad and not torch.allclose(sk, sp, rtol=K2_RTOL, atol=K2_ATOL):
        fail(f"{what} state_sum: max |diff| {float((sk - sp).abs().max())}")
    ek2, sk2 = run(True)
    if not (torch.equal(ek, ek2) and (not adagrad or torch.equal(sk, sk2))):
        fail(f"{what}: two runs differ")
    untouched = torch.ones(table.shape[0], dtype=torch.bool,
                           device=table.device)
    untouched[ids.long()] = False
    if not bool(untouched.any()) or not torch.equal(ek[untouched],
                                                    table[untouched]) or (
            adagrad and not torch.equal(sk[untouched], ss0[untouched])):
        fail(f"{what}: no untouched row, or one changed")
    print(f"{what} [{ids.numel()} ids, {table.shape[0]} x {table.shape[1]}, "
          f"{rows.plan_update(table.shape[1])}]: {tol} (max |diff| "
          f"{err:.3g}); two runs bit-identical; untouched rows unchanged")
    return err


def phase_k2():
    """K2 on every route and both dtypes, Adagrad and the plain row add,
    held to its plain version, on batches on both routes of the grouping;
    the whole call timed in turns beside index_add_ and the plain version
    at the flagship entity and relation shapes, RESCAL's entity shape,
    TransR's projection shape and 12,288 ids at the flagship width, with
    its device time split by kernel.  Returns its numbers for the JSON
    line (the flagship entity shape)."""
    import torch
    from dglke_tpu_torch.ops import rows
    gen, ent_ids, rel_ids = _flagship_ids(0)
    dev = ent_ids.device
    # 40% of the batch on one id, the rest uniform, shuffled.
    heavy = torch.randint(0, N_ENT, (N_ENT_IDS,), generator=gen, device=dev,
                          dtype=torch.int32)
    heavy[:2 * N_ENT_IDS // 5] = 77
    heavy = heavy[torch.randperm(N_ENT_IDS, generator=gen, device=dev)]
    heavy_rel = rel_ids.clone()
    heavy_rel[::3] = 5
    wide_ids = torch.randint(0, N_ENT, (24_000,), generator=gen, device=dev,
                             dtype=torch.int32)
    # The batches with long segments (1,200 and 334 occurrences of one id)
    # take gradients on a grid of 2^-10, whose sums are exact in fp32 in
    # any order, and are held to the plain version run in float64: the
    # fp32 plain version adds 1,200 rounded deltas one by one.
    shapes = (  # label, rows, width, ids, gradients on the grid
        ("flagship entity", N_ENT, DIM, ent_ids, False),
        ("flagship relation", N_REL, DIM, rel_ids, False),
        ("RESCAL entity", N_ENT, RESCAL["hidden_dim"], ent_ids, False),
        ("heavy duplicates (40% one id)", N_ENT, DIM, heavy, True),
        ("width 402 (no 16-byte path)", N_REL, 402, rel_ids, False),
        ("TransR projection", N_REL, DIM * DIM, rel_ids, False),
        ("width 2,050, a third one id", N_REL, 2050, heavy_rel, True),
        # above the one-block grouping's limit: the tiles route
        ("flagship width, 12,288 ids", N_ENT, DIM, wide_ids[:12_288], False),
        ("flagship width, 24,000 ids", N_ENT, DIM, wide_ids, False),
        ("RESCAL entity, 24,000 ids", N_ENT, RESCAL["hidden_dim"], wide_ids,
         False))
    tables = {}
    k2_err = 0.0
    for label, n_rows, width, ids, grid in shapes:
        table = torch.randn((n_rows, width), generator=gen, device=dev) * 0.05
        grads = torch.randn((ids.numel(), width), generator=gen,
                            device=dev) * 0.1
        if grid:
            grads = torch.round(grads * 1024) / 1024
        ss0 = torch.rand((n_rows,), generator=gen, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            tab = table.to(dtype)
            for adagrad in (True, False):
                err = check_k2(label, tab, ss0 if adagrad else None, ids,
                               grads, adagrad, plain64=grid)
                if dtype == torch.float32:
                    k2_err = max(k2_err, err)
        if label in ("flagship entity", "flagship relation", "RESCAL entity",
                     "TransR projection", "flagship width, 12,288 ids"):
            tables[label] = (table, ss0, ids, grads)
        else:
            del table, grads

    out = {}
    for label, (table, ss0, ids, grads) in tables.items():
        n, width = ids.numel(), table.shape[1]
        wide = width > rows.UPDATE_WARP_MAX
        emb, state, ids64 = table.clone(), ss0.clone(), ids.long()
        fns = {"kernel": lambda: rows.sparse_adagrad_rows(emb, state, ids,
                                                          grads, LR),
               "index_add_": lambda: emb.index_add_(0, ids64, grads),
               "plain": lambda: rows.sparse_adagrad_plain(emb, state, ids,
                                                          grads, LR)}
        ms = _in_turns(fns, iters=5 if wide else 50)
        split = device_ms_by_kernel(fns["kernel"], iters=5 if wide else 50)
        host = {k: call_ms(fns[k], iters=20 if wide else 200)
                for k in ("kernel", "index_add_")}
        uniq = int(torch.unique(ids).numel())
        nbytes = n * 4 + n * width * 4 + 2 * uniq * width * 4 + 2 * uniq * 4
        nops = 3 * n * width + 3 * uniq * width
        bound, by = bound_ms(nbytes, nops)
        print(f"K2 sparse_adagrad_rows {label} fp32 [{n} ids, {uniq} "
              f"distinct, {table.shape[0]} x {width}], device ms in turns: "
              + ", ".join(f"{k} {v:.5f}" for k, v in ms.items())
              + f"; the kernel call by kernel: " + ", ".join(
                  f"{k[:40]} {v:.5f}" for k, v in split.items())
              + f"; ms per call with host overhead: kernel "
              f"{host['kernel']:.5f}, index_add_ {host['index_add_']:.5f}; "
              f"bound {bound:.6f} ({by}, {nbytes / 1e6:.3f} MB), "
              f"{100 * bound / ms['kernel']:.1f}% of it; "
              f"{'not slower' if ms['kernel'] <= ms['index_add_'] else 'SLOWER'}"
              f" than index_add_")
        out[label] = (ms, bound, by)
        del emb, state
    del tables
    torch.cuda.empty_cache()
    ms, bound, by = out["flagship entity"]
    return {"name": "sparse_adagrad_rows", "route": "cuda",
            "source": "dglke_tpu_torch/ops/csrc/rows.cu",
            "replaces": "dglke_tpu/ops/pallas/rows.py:227",
            "launches": None, "max_abs_err": k2_err, "ms": ms["kernel"],
            "plain_ms": ms["plain"], "bound_ms": bound, "bound_by": by,
            "library_ms": ms["index_add_"]}


def phase_group_capture():
    """K2 over 12,288 ids (the tiles route's grouping) captured in a CUDA
    graph on the shared capture stream (models/cuda_graphs.py) and
    replayed, as the --dist step graph runs it on a card a rank: the table
    and state_sum bit-equal to the same call run eagerly, the capture's
    launch counts those of the eager call."""
    import torch
    from dglke_tpu_torch.models import cuda_graphs
    from dglke_tpu_torch.ops import rows
    gen, ent_ids, _ = _flagship_ids(5)
    dev = ent_ids.device
    ids = torch.randint(0, N_ENT, (12_288,), generator=gen, device=dev,
                        dtype=torch.int32)
    grads = torch.randn((12_288, DIM), generator=gen, device=dev) * 0.1
    table = torch.randn((N_ENT, DIM), generator=gen, device=dev) * 0.05
    ss0 = torch.rand((N_ENT,), generator=gen, device=dev)
    eager = (table.clone(), ss0.clone())
    before = dict(rows.launches)
    rows.sparse_adagrad_rows(*eager, ids, grads, LR)
    torch.cuda.synchronize()
    want = rows.take_launches(before)
    # the first run on the capture stream, on copies; then the capture
    warm = (table.clone(), ss0.clone())
    stream, _ = cuda_graphs.run_on_capture_stream(
        dev, lambda: rows.sparse_adagrad_rows(*warm, ids, grads, LR))
    graphed = (table.clone(), ss0.clone())
    graph, _, counts = cuda_graphs.capture(
        lambda: rows.sparse_adagrad_rows(*graphed, ids, grads, LR), stream)
    if not (torch.equal(graphed[0], table) and torch.equal(graphed[1], ss0)):
        fail("K2 capture: the capture changed the table")
    graph.replay()
    torch.cuda.synchronize()
    if counts != want or want["group_ids_tiles"] != 1:
        fail(f"K2 capture: launches {counts} captured, {want} eagerly")
    for what, got, exp in (("table", graphed[0], eager[0]),
                           ("state_sum", graphed[1], eager[1]),
                           ("the warm-up's table", warm[0], eager[0])):
        if not torch.equal(got, exp):
            fail(f"K2 capture over 12,288 ids: {what} differs from the "
                 f"eager call's")
    print(f"K2 sparse_adagrad_rows over 12,288 ids "
          f"({rows.plan_group(12_288, N_ENT)}) captured on the capture "
          f"stream and replayed: table and state_sum bit-equal to the eager "
          f"call; the capture's launches {{"
          + ", ".join(f"{k}: {v}" for k, v in counts.items() if v)
          + "} those of the eager call")
    del graph


def phase_gather_shapes():
    """K1's two launch shapes across widths, each exact against the plain
    version, timed in turns (warp, wide, wide, warp): the measurement
    behind rows.GATHER_WIDE_MIN.  3,000 ids into a 4,096-row fp32 table."""
    import torch
    from dglke_tpu_torch.ops import rows
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(2)
    ids = torch.randint(0, 4096, (N_ENT_IDS,), generator=gen, device=dev,
                        dtype=torch.int32)
    print(f"K1 shape sweep [{N_ENT_IDS} ids, 4,096-row fp32 table], device "
          f"ms warp / wide (threshold {rows.GATHER_WIDE_MIN}):")
    for width in (256, 512, 1024, 2048, 4096, 8192, 16384):
        table = torch.randn((4096, width), generator=gen, device=dev)
        want = rows.gather_rows_plain(table, ids, width)
        ms = {"warp": [], "wide": []}
        for shape in ("warp", "wide", "wide", "warp"):
            run = lambda s=shape: rows.launch_gather(table, ids, width, s)  # noqa: E731
            if not torch.equal(run(), want):
                fail(f"K1 {shape} shape at width {width}: differs from its "
                     f"plain version")
            ms[shape].append(device_ms(run, iters=20))
        warp, wide = (sum(v) / 2 for v in ms.values())
        print(f"  width {width}: warp {warp:.5f}, wide {wide:.5f}; chosen "
              f"{rows.gather_shape(width)}, faster "
              f"{'wide' if wide < warp else 'warp'}")
        del table, want


def k3_phases(state, ids, a, b, lr, coef, norm) -> None:
    """Where a segment's time goes on K3's cluster route: the stamped build
    of outer_update.cu (thread 0 of each CTA reads %globaltimer at six
    points of each of its first 128 segments) run on the same inputs."""
    import ctypes
    import torch
    from dglke_tpu_torch.ops import outer_update, rows
    lib = rows.load_library(K3_STAMPED, {
        **outer_update.SIGNATURES,
        "dglke_outer_stamps": ([ctypes.c_void_p, ctypes.c_void_p],
                               ctypes.c_int)})
    main_source, outer_update.SOURCE = outer_update.SOURCE, K3_STAMPED
    try:
        for _ in range(3):
            outer_update.outer_adagrad_update(state, ids, a, b, lr, coef, norm)
        torch.cuda.synchronize()
    finally:
        outer_update.SOURCE = main_source
    stamps = np.zeros((1024, 128, 6), np.uint64)
    segs = np.zeros(1024, np.uint32)
    rows.check_launch(lib.dglke_outer_stamps(stamps.ctypes.data,
                                             segs.ctypes.data), "stamps")
    ctas = int((segs > 0).sum())
    per = [stamps[i, :min(int(segs[i]), 128)].astype(np.int64)
           for i in range(ctas)]
    us = np.concatenate([np.diff(p, axis=1) for p in per]) / 1e3
    gap = np.concatenate([p[1:, 0] - p[:-1, 5] for p in per]) / 1e3
    names = ("load issued, factors staged", "slice's bulk load waited",
             "pass 1 and block sum", "partial exchange (barrier, next ids)",
             "pass 2, new slice stored", "to the next segment")
    cols = [us[:, k] for k in range(5)] + [gap]
    first = np.array([p[0, 0] for p in per], np.int64)
    last = np.array([p[-1, 5] for p in per], np.int64)
    t0 = first.min()
    print(f"K3 cluster route by phase, from the stamped build: {ctas} CTAs, "
          f"{int(segs[:ctas].min())}-{int(segs[:ctas].max())} segments each "
          f"(mean {float(segs[:ctas].mean()):.1f}); us per segment, mean "
          f"(median): " + ", ".join(
              f"{n} {float(c.mean()):.3f} ({float(np.median(c)):.3f})"
              for n, c in zip(names, cols))
          + f"; sum of means {float(sum(c.mean() for c in cols)):.3f}; "
          f"first segments start within {(first.max() - t0) / 1e3:.1f} us, "
          f"last ones end {(last.min() - t0) / 1e3:.1f}-"
          f"{(last.max() - t0) / 1e3:.1f} us after the first start")


def check_k3(label, table, ss0, ids, a, b, lr, coef, norm, plan=None):
    """K3 (along `plan`, or the wrapper's own route) against its plain
    version within K3_RTOL / K3_ATOL, two runs bit-identical, rows no id
    names unchanged.  Returns the max |diff|."""
    import torch
    from dglke_tpu_torch.ops import outer_update
    from dglke_tpu_torch.ops.embedding import EmbeddingState

    def run(kernel: bool):
        t = EmbeddingState(table.clone(), ss0.clone())
        if not kernel:
            outer_update.outer_adagrad_plain(t.emb, t.state_sum, ids, a, b,
                                             lr, coef, norm)
        elif plan is None:
            outer_update.outer_adagrad_update(t, ids, a, b, lr, coef, norm)
        else:
            outer_update.launch_outer(t, ids, a, b, lr, coef, norm, plan)
        torch.cuda.synchronize()
        return t

    got, want = run(True), run(False)
    err = 0.0
    for what, x, y in (("table", got.emb, want.emb),
                       ("state_sum", got.state_sum, want.state_sum)):
        if not torch.allclose(x, y, rtol=K3_RTOL, atol=K3_ATOL):
            fail(f"K3 {label} {what}: max |diff| "
                 f"{float((x - y).abs().max())} outside rtol {K3_RTOL} atol "
                 f"{K3_ATOL}")
        err = max(err, float((x - y).abs().max()))
    again = run(True)
    if not (torch.equal(got.emb, again.emb)
            and torch.equal(got.state_sum, again.state_sum)):
        fail(f"K3 {label}: two runs differ")
    untouched = torch.ones(table.shape[0], dtype=torch.bool,
                           device=table.device)
    untouched[ids.long()] = False
    if not bool(untouched.any()) or not (
            torch.equal(got.emb[untouched], table[untouched])
            and torch.equal(got.state_sum[untouched], ss0[untouched])):
        fail(f"K3 {label}: no untouched row, or one changed")
    print(f"K3 {label}: within rtol {K3_RTOL} / atol {K3_ATOL} of plain "
          f"(max |diff| {err:.3g}); two runs bit-identical; untouched rows "
          f"unchanged")
    return err


def phase_outer_routes():
    """K3's routes away from RESCAL's FB15k width, each held to its plain
    version: the cluster route at hidden 32 (as in the planted gates) with
    one segment longer than the staged factors hold, at a ragged 7 x 13
    width (no 16-byte path), and the tiles route at hidden 1,000."""
    import torch
    from dglke_tpu_torch.ops import outer_update
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(3)
    lr, coef, norm = (RESCAL[k] for k in ("lr", "regularization_coef",
                                          "regularization_norm"))
    for da, db, n_rows, n_ids in ((32, 32, 64, 1000), (7, 13, 64, 300),
                                  (1000, 1000, 64, 100)):
        plan = outer_update.plan_outer(da, db)
        table = torch.empty((n_rows, da * db), device=dev).uniform_(
            -0.2, 0.2, generator=gen)
        ss0 = torch.rand((n_rows,), generator=gen, device=dev)
        ids = torch.randint(0, n_rows - 4, (n_ids,), generator=gen,
                            device=dev, dtype=torch.int32)
        hot = plan.stage_occ + 8         # a segment longer than the staging
        ids[:hot] = 5
        a = torch.randn((n_ids, da), generator=gen, device=dev) * 0.3
        b = torch.randn((n_ids, db), generator=gen, device=dev) * 0.3
        check_k3(f"{plan.route} route at {da} x {db} [{n_rows} rows, {n_ids} "
                 f"ids, one id {hot + int((ids[hot:] == 5).sum())} times; "
                 f"{plan}]", table, ss0, ids, a, b, lr, coef, norm)
        del table


def phase_outer():
    """K3 against its plain version at RESCAL's FB15k shapes, two runs
    bit-identical; its time beside the plain version's, the bound, the
    tiles route, both cluster sizes that hold the row, and the stock route
    for the same update (the gradient materialized, then K2), which is also
    held to its plain version here.  K1 on the 1 MB relation rows in both
    shapes and dtypes, with the sum of |x|^p against the wide shape then
    the three PyTorch passes, and with the sum and RESCAL's product against
    the sum then torch.bmm.  Returns K3's numbers for the JSON line and
    K1's wide-row numbers."""
    import torch
    from dglke_tpu_torch.ops import outer_update, rows
    from dglke_tpu_torch.ops.embedding import EmbeddingState
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(1)
    d = RESCAL["hidden_dim"]
    lr, coef, norm = (RESCAL[k] for k in ("lr", "regularization_coef",
                                          "regularization_norm"))
    table = torch.empty((N_REL, RESCAL_WIDTH), device=dev).uniform_(
        -0.052, 0.052, generator=gen)       # RESCAL's emb_init (24 + 2) / 500
    ss0 = torch.rand((N_REL,), generator=gen, device=dev)
    ids = torch.randint(0, N_REL, (BATCH,), generator=gen, device=dev,
                        dtype=torch.int32)
    a = torch.randn((BATCH, d), generator=gen, device=dev) * 0.1
    b = torch.randn((BATCH, d), generator=gen, device=dev) * 0.1
    n_unique = int(torch.unique(ids).numel())
    print(f"K3 shapes: relation table {N_REL} x {RESCAL_WIDTH} fp32, {BATCH} "
          f"ids ({n_unique} distinct), factors {BATCH} x {d} twice, coef "
          f"{coef}, norm {norm}")

    plan = outer_update.plan_outer(d, d)
    if plan.route != "cluster":
        fail(f"K3 at hidden {d} must take the cluster route, got {plan}")
    alt = outer_update.plan_outer(d, d, cluster=8 if plan.cluster == 16
                                  else 16)
    for p in (plan, alt):
        print(f"K3 cluster route at hidden {d}{'' if p is plan else ' (alternative)'}: "
              f"{p.cluster} CTAs x {p.slice} elements ({4 * p.slice} B), "
              f"factors of up to {p.stage_occ} occurrences staged, "
              f"{p.smem_bytes} B of shared memory per CTA; max active "
              f"clusters {outer_update.cluster_occupancy(p)}")
    k3_err = check_k3(f"outer_adagrad_update, cluster route at hidden {d} "
                      f"[{N_REL} rows, {BATCH} ids]", table, ss0, ids, a, b,
                      lr, coef, norm)
    # The grouping's (sids, order) are torch.sort's bits: K3 fed either
    # gives the same table and state, bit for bit.
    fed = {}
    for what, grouping in (("group_ids", None),
                           ("torch.sort", rows.group_ids_plain(ids))):
        t = EmbeddingState(table.clone(), ss0.clone())
        outer_update.launch_outer(t, ids, a, b, lr, coef, norm, plan,
                                  grouping=grouping)
        fed[what] = t
    torch.cuda.synchronize()
    if not (torch.equal(fed["group_ids"].emb, fed["torch.sort"].emb)
            and torch.equal(fed["group_ids"].state_sum,
                            fed["torch.sort"].state_sum)):
        fail("K3: the grouping kernel's ids and torch.sort's give different "
             "bits")
    print("K3 cluster route fed the grouping kernel's (sids, order) and "
          "torch.sort's: bit-identical table and state")
    del fed, t
    # Above the one-block grouping's limit: 9,000 relation ids (RESCAL
    # under --dist at 9 ranks of batch 1,000 all-gathers as many), grouped
    # on the tiles route; the last 45 rows stay untouched.
    wide = torch.randint(0, N_REL - 45, (K3_WIDE_IDS,), generator=gen,
                         device=dev, dtype=torch.int32)
    fa = torch.randn((K3_WIDE_IDS, d), generator=gen, device=dev) * 0.1
    fb = torch.randn((K3_WIDE_IDS, d), generator=gen, device=dev) * 0.1
    check_k3(f"outer_adagrad_update, cluster route at hidden {d} [{N_REL} "
             f"rows, {K3_WIDE_IDS} ids; grouping "
             f"{rows.plan_group(K3_WIDE_IDS, N_REL)}]", table, ss0, wide, fa,
             fb, lr, coef, norm)
    del wide, fa, fb
    torch.cuda.empty_cache()
    tiles = outer_update.OuterPlan("tiles")
    for p in (alt, tiles):
        check_k3(f"{p.route} route{f' of {p.cluster} CTAs' if p.cluster else ''}"
                 f" at hidden {d}", table, ss0, ids, a, b, lr, coef, norm,
                 plan=p)

    # The stock route: the [B, 250,000] gradient materialized (outer
    # product + the regularization gradient), then K2 on 1 MB rows.
    def stock_grad():
        g = torch.einsum("bi,bj->bij", a, b).reshape(BATCH, -1)
        return g + outer_update.reg_grad(table[ids.long()], coef, norm)

    g = stock_grad()
    ek, sk = table.clone(), ss0.clone()
    rows.sparse_adagrad_rows(ek, sk, ids, g, lr)
    ep, sp = table.clone(), ss0.clone()
    rows.sparse_adagrad_plain(ep, sp, ids, g, lr)
    torch.cuda.synchronize()
    k2_err = float((ek - ep).abs().max())
    if not (torch.allclose(ek, ep, rtol=K2_RTOL, atol=K2_ATOL)
            and torch.allclose(sk, sp, rtol=K2_RTOL, atol=K2_ATOL)):
        fail(f"K2 sparse_adagrad_rows on RESCAL rows: max |diff| {k2_err} "
             f"from plain")
    k2_ms = device_ms(lambda: rows.sparse_adagrad_rows(ek, sk, ids, g, lr),
                      iters=10)
    print(f"K2 sparse_adagrad_rows on {BATCH} RESCAL rows of "
          f"{RESCAL_WIDTH}: within rtol {K2_RTOL} / atol {K2_ATOL} of plain "
          f"(max |diff| {k2_err:.3g}); device ms {k2_ms:.4f} on the "
          f"materialized gradient")
    del ek, ep, g

    state = EmbeddingState(table.clone(), ss0.clone())
    k3_ms = device_ms(lambda: outer_update.outer_adagrad_update(
        state, ids, a, b, lr, coef, norm), iters=20)
    k3_call = call_ms(lambda: outer_update.outer_adagrad_update(
        state, ids, a, b, lr, coef, norm), iters=20, warmup=2)
    # The routes in turns on the same inputs (chosen, alternative, tiles,
    # tiles, alternative, chosen).
    routes = {f"cluster of {plan.cluster} (chosen)": plan,
              f"cluster of {alt.cluster}": alt, "tiles (three launches)": tiles}
    route_ms = {k: [] for k in routes}
    for k in (*routes, *reversed(routes)):
        route_ms[k].append(device_ms(
            lambda p=routes[k]: outer_update.launch_outer(
                state, ids, a, b, lr, coef, norm, p), iters=20))
    plain_ms = device_ms(lambda: outer_update.outer_adagrad_plain(
        state.emb, state.state_sum, ids, a, b, lr, coef, norm), iters=3)
    stock_ms = device_ms(lambda: rows.sparse_adagrad_rows(
        state.emb, state.state_sum, ids, stock_grad(), lr), iters=5)
    group_ms = device_ms(lambda: rows.group_ids(ids, N_REL))
    sort_ms = device_ms(lambda: torch.sort(ids, stable=True))
    # Bytes: each distinct row read and written once, state_sum likewise,
    # ids and factors read once.  Operations: per occurrence and element,
    # g = a*b + reg', g^2 summed, g summed (5); per distinct element reg'
    # (5) and the update (3).
    k3_bytes = (2 * n_unique * RESCAL_WIDTH * 4 + 2 * n_unique * 4
                + BATCH * 4 + 2 * BATCH * d * 4)
    k3_ops = 5 * BATCH * RESCAL_WIDTH + 8 * n_unique * RESCAL_WIDTH
    k3_bound, k3_by = bound_ms(k3_bytes, k3_ops)
    print(f"K3 outer_adagrad_update, device ms: kernel {k3_ms:.4f} "
          f"({100 * k3_bound / k3_ms:.1f}% of the bound, "
          f"{k3_bytes / k3_ms / 1e9:.3f} TB/s; its id grouping alone "
          f"{group_ms:.5f}, torch.sort {sort_ms:.5f}; {k3_call:.4f} per call "
          f"with host overhead), plain "
          f"{plain_ms:.4f}, stock route (gradient materialized, then K2) "
          f"{stock_ms:.4f}; bound {k3_bound:.4f} ({k3_by}, "
          f"{k3_bytes / 1e9:.3f} GB, {k3_ops / 1e9:.2f} GFLOP); no single "
          f"PyTorch call computes this update")
    print("K3 routes in turns, device ms: " + ", ".join(
        f"{k} {' / '.join(f'{t:.4f}' for t in v)}"
        for k, v in route_ms.items()))
    k3_phases(state, ids, a, b, lr, coef, norm)

    # K1 on the main path's relation gather: 1,000 rows of 1 MB, both
    # shapes and dtypes exact; a width that is not a multiple of 4 or of
    # the wide chunk.
    if rows.gather_shape(RESCAL_WIDTH) != "wide":
        fail(f"K1 at width {RESCAL_WIDTH} must take the wide shape")
    bf = state.emb.to(torch.bfloat16)
    for name, tab in (("fp32", state.emb), ("bf16", bf)):
        for dim in (RESCAL_WIDTH, RESCAL_WIDTH - 3):
            want = rows.gather_rows_plain(tab, ids, dim)
            for shape in rows.GATHER_SHAPES:
                if not torch.equal(rows.launch_gather(tab, ids, dim, shape),
                                   want):
                    fail(f"K1 {shape} shape on RESCAL rows ({name}, dim "
                         f"{dim}): differs from its plain version")
            del want
        print(f"K1 gather_rows on {BATCH} RESCAL rows {name}, dims "
              f"{RESCAL_WIDTH} and {RESCAL_WIDTH - 3}: both shapes exact")
    k1_bf = device_ms(lambda: rows.gather_rows(bf, ids), iters=20)
    del bf
    # K1 with the sum of |x|^p (the relation rows' regularization value on
    # RESCAL's factored route): the plain wide shape's rows, the sum within
    # 1e-6 of fp64's, two calls bit-equal.
    if not rows.fused_pow_sum(state.emb, ids, RESCAL_WIDTH, norm):
        fail("K1 on RESCAL rows must take the fused sum")
    (got, total), (_, total2) = (rows.gather_rows_pow_sum(state.emb, ids, norm)
                                 for _ in range(2))
    want = want_sum = float(torch.sum(torch.abs(
        state.emb[ids.long()].double()) ** norm))
    three = float(rows.pow_sum_plain(got, norm))
    if (not torch.equal(got, rows.launch_gather(state.emb, ids, RESCAL_WIDTH,
                                                "wide"))
            or not torch.equal(total.view(torch.int32),
                               total2.view(torch.int32))
            or abs(float(total) - want) > 1e-6 * want):
        fail(f"K1 with the sum: rows differ from the wide shape's, or sums "
             f"{float(total)!r} / {float(total2)!r} against fp64 {want!r}")
    print(f"K1 with the sum of |x|^{norm} on {BATCH} RESCAL rows: rows exact, "
          f"two calls bit-equal; sum {float(total)!r}, fp64 {want!r} "
          f"(rel {(float(total) - want) / want:.3e}), the three passes "
          f"{three!r} (rel {(three - want) / want:.3e})")
    del got, total, total2
    # K1 with the sum and RESCAL's product (gather_rows_matvec): R v and
    # v^T R of each 500 x 500 row with a vector of the factors, within 1e-6
    # of fp64 (relative to the sum of its terms' magnitudes), the plain wide
    # shape's rows, the sum within 1e-6 of fp64's, two calls bit-equal.
    if not rows.fused_matvec(state.emb, ids, a, RESCAL_WIDTH, norm):
        fail("K1 on RESCAL rows must take the fused product")
    mats = state.emb[ids.long()].double().reshape(BATCH, d, d)
    for head in (True, False):
        (got, total, tmp), (_, _, tmp2) = (rows.gather_rows_matvec(
            state.emb, ids, a, head, norm) for _ in range(2))
        want = rows.matvec_plain(mats.reshape(BATCH, -1), a.double(), head)
        scale = rows.matvec_plain(mats.abs().reshape(BATCH, -1),
                                  a.double().abs(), head)
        gap = float(((tmp.double() - want).abs() / scale).max())
        if (not torch.equal(got, rows.launch_gather(state.emb, ids,
                                                    RESCAL_WIDTH, "wide"))
                or not torch.equal(tmp.view(torch.int32),
                                   tmp2.view(torch.int32))
                or gap > 1e-6
                or abs(float(total) - want_sum) > 1e-6 * want_sum):
            fail(f"K1 with the product ({'R v' if head else 'v^T R'}): rows "
                 f"differ from the wide shape's, two calls differ, or the "
                 f"product is {gap:.3e} from fp64 (relative to its terms), "
                 f"the sum {float(total)!r} against fp64 {want_sum!r}")
        rel = (float(total) - want_sum) / want_sum
        print(f"K1 with the sum and {'R v' if head else 'v^T R'} on {BATCH} "
              f"RESCAL rows: rows exact, two calls bit-equal; product within "
              f"{gap:.3e} of fp64 (relative to its terms), sum "
              f"{float(total)!r} (rel {rel:.3e})")
    del mats, got, total, tmp, tmp2, want, scale
    gather_fns = {
        "wide": lambda: rows.launch_gather(state.emb, ids, RESCAL_WIDTH,
                                           "wide"),
        "warp (one per row)": lambda: rows.launch_gather(
            state.emb, ids, RESCAL_WIDTH, "warp"),
        "index_select": lambda: torch.index_select(state.emb, 0, ids),
        "wide with the sum": lambda: rows.gather_rows_pow_sum(
            state.emb, ids, norm),
        "wide, then three passes": lambda: rows.pow_sum_plain(
            rows.launch_gather(state.emb, ids, RESCAL_WIDTH, "wide"), norm),
        "wide with the sum and R v": lambda: rows.gather_rows_matvec(
            state.emb, ids, a, True, norm),
        "wide with the sum, then torch.bmm": lambda: rows.matvec_plain(
            rows.gather_rows_pow_sum(state.emb, ids, norm)[0], a, True)}
    # Three rounds in turns, each on the profiler's device clock and on
    # CUDA events around back-to-back calls.
    gather_ms = {k: [] for k in gather_fns}
    gather_ev = {k: [] for k in gather_fns}
    for r in range(3):
        for k in (gather_fns if r % 2 == 0 else reversed(gather_fns)):
            gather_ms[k].append(device_ms(gather_fns[k], iters=20))
            gather_ev[k].append(call_ms(gather_fns[k], iters=20, warmup=3))
    k1_ms, _, k1_lib, k1_sum, k1_three, k1_mv, k1_bmm = (
        sum(v) / len(v) for v in gather_ms.values())
    k1_ev, _, k1_lib_ev, *_ = (sum(v) / len(v) for v in gather_ev.values())
    k1_bytes = BATCH * 4 + (n_unique + BATCH) * RESCAL_WIDTH * 4
    k1_bound, k1_by = bound_ms(k1_bytes, 0)
    print(f"K1 gather_rows on {BATCH} RESCAL rows of {RESCAL_WIDTH} fp32, "
          f"three rounds in turns, device ms (CUDA events ms per call): "
          + ", ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)} ("
                      f"{' / '.join(f'{t:.4f}' for t in gather_ev[k])})"
                      for k, v in gather_ms.items())
          + f"; bound {k1_bound:.4f} ({k1_by}, {k1_bytes / 1e9:.3f} GB); "
          f"wide {100 * k1_bound / k1_ms:.1f}% of it, "
          f"{k1_bytes / k1_ms / 1e9:.3f} TB/s; wide on the bf16 table "
          f"{k1_bf:.4f}")
    print(f"K1 wide against index_select on RESCAL rows, mean of three: "
          f"device {k1_ms:.4f} vs {k1_lib:.4f} ms, CUDA events {k1_ev:.4f} vs "
          f"{k1_lib_ev:.4f} ms: {'not slower' if k1_ms <= k1_lib else 'SLOWER'}")
    print(f"K1 with the sum on RESCAL rows, mean of three: device "
          f"{k1_sum:.4f} ms against the plain wide shape's {k1_ms:.4f} "
          f"({100 * k1_bound / k1_sum:.1f}% of K1's bound) and the wide "
          f"shape then the three passes {k1_three:.4f}")
    print(f"K1 with the sum and R v on RESCAL rows, mean of three: device "
          f"{k1_mv:.4f} ms ({100 * k1_bound / k1_mv:.1f}% of K1's bound) "
          f"against the sum then torch.bmm's {k1_bmm:.4f}")
    del state, table
    torch.cuda.empty_cache()
    k3 = {"name": "outer_adagrad_update", "route": "cuda",
          "source": "dglke_tpu_torch/ops/csrc/outer_update.cu",
          "replaces": "dglke_tpu/ops/pallas/outer_update.py:118",
          "launches": None, "max_abs_err": k3_err, "ms": k3_ms,
          "plain_ms": plain_ms, "bound_ms": k3_bound, "bound_by": k3_by,
          "library_ms": None}
    k1_wide = {"wide_ms": k1_ms, "wide_library_ms": k1_lib,
               "wide_bound_ms": k1_bound}
    return k3, k1_wide


# ---------------------------------------------------------------------------
# Phases 3 to 6: the main paths


def _write_udd(path: str, ds) -> None:
    """A dataset in the udd_hrt layout."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "entities.tsv"), "w") as f:
        f.writelines(f"{i}\te{i}\n" for i in range(ds.n_entities))
    with open(os.path.join(path, "relations.tsv"), "w") as f:
        f.writelines(f"{i}\tr{i}\n" for i in range(ds.n_relations))
    for split in ("train", "valid", "test"):
        h, r, t = getattr(ds, split)
        np.savetxt(os.path.join(path, f"{split}.tsv"),
                   np.stack([h, r, t], axis=1), fmt="%d", delimiter="\t")


def _synthetic_udd(name: str, n_entities: int, n_relations: int,
                   n_train: int, n_valid: int, n_test: int) -> str:
    """A synthetic dataset (data.dataset.synthetic_dataset, seed 0) under
    WORK/name in the udd_hrt layout, written once; returns its directory."""
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    path = os.path.join(WORK, name)
    if not os.path.isdir(path):
        _write_udd(path, synthetic_dataset(
            n_entities=n_entities, n_relations=n_relations, n_train=n_train,
            n_valid=n_valid, n_test=n_test, seed=0))
    return path


def _fb15k_shaped(name: str, n_train: int, n_valid: int = 1000,
                  n_test: int = 2000) -> str:
    """An FB15k-shaped synthetic dataset (14,951 / 1,345) under WORK/name."""
    return _synthetic_udd(name, N_ENT, N_REL, n_train, n_valid, n_test)


def _udd_args(path: str):
    return ["--data_path", path, "--format", "udd_hrt", "--data_files",
            "entities.tsv", "relations.tsv", "train.tsv", "valid.tsv",
            "test.tsv"]


def _floats(pattern: str, text: str):
    return [float(x) for x in re.findall(pattern, text)]


def _recipe_flags(recipe: dict):
    flags = ["--model_name", recipe["model_name"],
             "--hidden_dim", str(recipe["hidden_dim"]),
             "--gamma", str(recipe["gamma"]), "--lr", str(recipe["lr"]),
             "--batch_size", str(recipe["batch_size"]),
             "--neg_sample_size", str(recipe["neg_sample_size"]),
             "-rc", str(recipe["regularization_coef"])]
    if "adversarial_temperature" in recipe:
        flags += ["-a", str(recipe["adversarial_temperature"])]
    return flags + (["-adv"] if recipe["neg_adversarial_sampling"] else [])


def run_cli(label: str, argv: list, trained=None):
    """dglke_tpu_torch-train with ``argv`` on the card, its launch counts
    read around that run only and held to EXPECTED_LAUNCHES[label]; the
    losses must be finite.  Returns (counts, printed text, the trained
    model and state); ``trained``, a dict, also receives the run's config
    and dataset."""
    from dglke_tpu_torch.cli import train as train_cli
    from dglke_tpu_torch.ops import rows
    print(f"{label}: dglke_tpu_torch-train " + " ".join(argv))
    trained = {} if trained is None else trained
    real_train = train_cli.train

    def keep(*args, **kwargs):
        out = real_train(*args, **kwargs)
        trained["config"], trained["dataset"] = args[0], args[1]
        trained["model"], trained["state"] = out[0], out[1]
        return out

    out = io.StringIO()
    train_cli.train = keep
    try:
        rows.reset_launches()
        with contextlib.redirect_stdout(out):
            rc = train_cli.main(argv)
        counts = dict(rows.launches)
    finally:
        train_cli.train = real_train
    text = out.getvalue()
    print(text.rstrip())
    if rc != 0:
        fail(f"{label}: train CLI returned {rc}")
    losses = _floats(r"average loss: (\S+)", text)
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"{label}: loss not finite: {losses}")
    want = EXPECTED_LAUNCHES[label]
    if any(counts[k] != v for k, v in want.items()):
        fail(f"{label}: launches {counts}, expected {want}")
    graphs = graph_route(label, argv, text)
    if graphs is not None:
        print(f"{label}: {graphs[0]} steps a group, {graphs[1]} CUDA "
              f"graph(s) captured, {graphs[2]} replays; launches held "
              f"through the replays")
    evals = eval_graphs(label, text)
    if evals is not None:
        print(f"{label}: eval CUDA graphs {evals[0]} captured, {evals[1]} "
              f"replays, as expected")
    return counts, text, trained["model"], trained["state"]


def graph_route(label: str, argv: list, text: str):
    """A single-device run must take the CUDA graph route of its feed: its
    log's route line says so, and its last lines give the graphs captured
    and the replays.  The device pipeline: one graph and max_step / s - 1
    replays (the first group runs eagerly); step group size 1 must not
    reach it on one device (it takes the host-fed route, as the JAX package
    does).  Host tables: two graphs (head-first and tail-first steps) and
    max_step - 1 replays.  The host-fed route: one graph (two at s = 1) and
    max_step / s - 1 replays.  Returns (s, graphs, replays), or None for a
    --dist run."""
    if "--dist" in argv:
        return None
    max_step = int(argv[argv.index("--max_step") + 1])
    route = re.search(r"device-resident pipeline: (\d+) steps a group"
                      r"(, one CUDA graph)?", text)
    fed = re.search(r"host-fed TrainSampler \([^)]*\): (\d+) steps a group",
                    text)
    if "--mix_cpu_gpu" in argv:
        if "[proc 0]host tables: one CUDA graph a step" not in text:
            fail(f"{label}: host tables did not take the CUDA graph route")
        s, graphs = 1, 2
    elif route is not None:
        if route.group(2) is None:
            fail(f"{label}: the single-device pipeline did not take the "
                 f"CUDA graph route")
        s, graphs = int(route.group(1)), 1
        if s == 1:
            fail(f"{label}: step group size 1 took the device pipeline on "
                 f"one device, not the host-fed route")
    elif fed is not None:
        s = int(fed.group(1))
        graphs = 2 if s == 1 else 1
    else:
        fail(f"{label}: no training route line")
    want = (graphs, max_step // s - 1)
    got = re.search(r"\[proc 0\]CUDA graphs: (\d+) captured, (\d+) replays",
                    text)
    if got is None or (int(got.group(1)), int(got.group(2))) != want:
        fail(f"{label}: CUDA graphs {got and got.groups()}, expected "
             f"{want} (captured, replays)")
    return (s,) + want


def eval_graphs(label: str, text: str):
    """The eval CUDA graph lines of a run's log ("[0]Test eval CUDA graphs:
    N captured, M replays", one for each eval), summed and held to
    EXPECTED_EVAL_GRAPHS[label]; a run not listed there (no eval,
    --dist) must print none.  Returns (captured, replays) or
    None."""
    lines = re.findall(r"\w+ eval CUDA graphs: (\d+) captured, (\d+) "
                       r"replays", text)
    got = (tuple(sum(int(x[i]) for x in lines) for i in (0, 1)) if lines
           else None)
    want = EXPECTED_EVAL_GRAPHS.get(label)
    if got != want:
        fail(f"{label}: eval CUDA graphs (captured, replays) {got}, "
             f"expected {want}")
    return got


def phase_main_path(recipe: dict, batch_size_eval: int,
                    steps: int = MAIN_STEPS, extra=(), label=None,
                    metrics=None):
    """dglke_tpu_torch-train on the card with the recipe's flags (and
    ``extra``) on the FB15k-shaped data, 1,000 steps and --test; returns the
    launch counts of that run only.  ``metrics``, a dict, receives the test
    MRR and HITS@10 and the triples/s under ``label``."""
    name = recipe["model_name"]
    label = label or name
    argv = ["--dataset", "fb15k_shaped",
            *_udd_args(_fb15k_shaped("data", n_train=300_000)),
            *_recipe_flags(recipe), "--max_step", str(steps),
            "--log_interval", str(steps // 4), "--batch_size_eval",
            str(batch_size_eval), "--test", *extra,
            "--save_path", os.path.join(WORK, "ckpts")]
    counts, text, _, _ = run_cli(f"{label}", argv)
    losses = _floats(r"average loss: (\S+)", text)
    mrr = _floats(r"\[0\]Test average MRR: (\S+)", text)
    train_s = _floats(r"training takes (\S+) seconds", text)
    eval_s = _floats(r"\[0\]Test takes (\S+) seconds", text)
    if len(mrr) != 1 or not 0.0 < mrr[0] <= 1.0:
        fail(f"{label} main path: test MRR {mrr} outside (0, 1]")
    if name == "RESCAL" and abs(mrr[0] - RESCAL_MRR) > MRR_TOL:
        fail(f"RESCAL main path: test MRR {mrr[0]!r} further than {MRR_TOL} "
             f"from {RESCAL_MRR!r}")
    print(f"{label} main path: {steps} steps, "
          f"{steps * BATCH / train_s[0]:.1f} triples/s (host clock over the "
          f"whole loop, first step included), test eval {eval_s[0]:.3f} s, "
          f"MRR {mrr[0]!r}, last loss {losses[-1]:.4f}; launches {counts}")
    if metrics is not None:
        metrics[label] = (mrr[0], _floats(r"\[0\]Test average HITS@10: "
                                          r"(\S+)", text)[0],
                          steps * BATCH / train_s[0])
    return counts


def phase_host_fed():
    """A dataset smaller than two batches (1,500 FB15k-shaped train edges,
    batch 1,000) through the CLI on the card: it must take the host-fed
    route, launch K1, the grouping and K2 every step, and train."""
    steps = 100
    argv = ["--dataset", "fb15k_small",
            *_udd_args(_fb15k_shaped("small", n_train=1500, n_valid=10,
                                     n_test=10)),
            *_recipe_flags(TRANSE), "--max_step", str(steps),
            "--log_interval", str(steps // 2), "--no_save_emb",
            "--save_path", os.path.join(WORK, "ckpts")]
    counts, text, _, state = run_cli("TransE_l2 host-fed", argv)
    if "host-fed TrainSampler (1500 train edges" not in text:
        fail("host-fed run: the trainer did not take the host-fed route")
    losses = _floats(r"average loss: (\S+)", text)
    if state.step != steps or not losses[-1] < losses[0]:
        fail(f"host-fed run: {state.step} steps, losses {losses}")
    print(f"host-fed run: {steps} steps on 1,500 train edges at batch "
          f"{BATCH}, loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches "
          f"{counts}")
    return counts


def _cpu_copy(state):
    """The state's tables copied to the CPU."""
    from dglke_tpu_torch.models.ke_model import TrainState
    from dglke_tpu_torch.ops.embedding import EmbeddingState

    def table(t):
        return None if t is None else EmbeddingState(
            t.emb.to("cpu", copy=True), t.state_sum.to("cpu", copy=True))

    return TrainState(table(state.entity), table(state.relation),
                      step=state.step, projection=table(state.projection))


def phase_step_parity(recipe: dict, n_ent: int = N_ENT, n_rel: int = N_REL):
    """One step in each corruption direction on the card and on the CPU
    (the plain versions), from identical tables and ids, at the recipe's
    full width: every table, Adagrad state and the loss within rtol 1e-4 /
    atol 1e-5 (cuBLAS and the CPU sum in other orders; the first Adagrad
    step scales each gradient row to unit RMS, so it carries those
    differences into the tables at full size)."""
    import torch
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.models.ke_model import KEModel
    name = recipe["model_name"]
    cfg = KGEConfig(**recipe)
    batch = cfg.batch_size
    n_neg = cfg.num_chunks * cfg.neg_sample_size
    rng = np.random.default_rng(1)
    gpu_model = KEModel(cfg, n_ent, n_rel, device="cuda")
    cpu_model = KEModel(cfg, n_ent, n_rel, device="cpu")
    gpu_state = gpu_model.init_state()
    state = _cpu_copy(gpu_state)
    cpu_s = 0.0
    for neg_head in (True, False):
        ids = [rng.integers(0, n, size).astype(np.int32) for n, size in
               ((n_ent, batch), (n_rel, batch), (n_ent, batch),
                (n_ent, n_neg))]
        t0 = time.time()
        _, clog = cpu_model.train_step(
            state, *(torch.from_numpy(x) for x in ids), None,
            neg_head=neg_head)
        cpu_s += time.time() - t0
        _, glog = gpu_model.train_step(
            gpu_state, *(torch.from_numpy(x).cuda() for x in ids), None,
            neg_head=neg_head)
        pairs = [("loss", glog["loss"], clog["loss"])]
        for table in ("entity", "relation"):
            g, c = getattr(gpu_state, table), getattr(state, table)
            pairs += [(f"{table} emb", g.emb, c.emb),
                      (f"{table} state_sum", g.state_sum, c.state_sum)]
        for what, a, b in pairs:
            b = b.to(a.device)          # compared on the card: 5 GB tables
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-5):
                fail(f"{name} step parity ({'head' if neg_head else 'tail'})"
                     f": {what} on the card differs from the CPU by "
                     f"{float((a - b).abs().max())}")
    print(f"{name} step parity [{n_ent} x {n_rel}]: two full-width steps "
          f"(batch {batch}) on the card match the CPU's plain path within "
          f"rtol 1e-4 / atol 1e-5 (CPU side {cpu_s:.1f} s)")
    del gpu_state, state
    torch.cuda.empty_cache()


GROUP_S = 10   # steps a group in the direct runs, as the CLI runs choose
# What the fused calls of phase 2b after its first (GRAPH_CASES) may leave
# allocated on the card once they are gone.
GRAPH_MEM_SLACK = 1 << 20
GRAPH_CASES = 13


def phase_step_profile(recipe: dict, steps: int, n_ent: int = N_ENT,
                       n_rel: int = N_REL, route: str = "eager"):
    """Where a step's time goes, on one route: "eager" (DevicePipeline
    steps one at a time, each op launched from Python) or "graph" (the
    fused call, groups of GROUP_S steps, one CUDA graph replayed a group
    after a first eager group and its capture).  The host clock over
    `steps` steps, then torch.profiler over the same number for the
    device's busy share, the kernels by device time and the graph
    launches; the card's peak allocation over the timed steps, and its
    peak reserved memory (a graph's private pool stays reserved between
    replays, where nothing is allocated).  Returns (host ms, device busy
    ms, kernels, graph launches) a step, the peak allocated MB and the
    peak reserved MB."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    from dglke_tpu_torch.models.ke_model import KEModel
    from dglke_tpu_torch.models.pipeline_step import DevicePipelineStep
    from dglke_tpu_torch.trainer import DevicePipeline
    name = recipe["model_name"] + (
        " bf16" if recipe.get("compute_dtype") == "bfloat16" else "")
    cfg = KGEConfig(**recipe)
    batch = cfg.batch_size
    ds = synthetic_dataset(n_ent, n_rel, n_train=100_000, seed=0)
    model = KEModel(cfg, n_ent, n_rel, device="cuda")
    state = model.init_state()
    pipe = DevicePipeline(model, ds, batch,
                          cfg.num_chunks * cfg.neg_sample_size, seed=0)
    fused = DevicePipelineStep(model, pipe, GROUP_S)

    def run(n):
        nonlocal state
        if route == "graph":
            for _ in range(n // GROUP_S):
                state, _ = fused(state)
        else:
            for _ in range(n):
                state, _ = pipe.run_step(state)
        torch.cuda.synchronize()

    run(steps)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(steps)
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    reserved_mb = torch.cuda.max_memory_reserved() / 2**20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(steps)
    kern = _kernel_events(prof)
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    n_kern = sum(e.count for e in kern) / steps
    graph_launches = sum(e.count for e in prof.key_averages()
                         if e.key == "cudaGraphLaunch") / steps
    if route == "graph" and not (graph_launches and fused.replays):
        fail(f"{name} graph-route profile: no CUDA graph was launched")
    print(f"{name} step profile, {route} route [{n_ent} x {n_rel}, batch "
          f"{batch}; {card_line()}]: {step_ms:.4f} ms per step on the host "
          f"clock ({batch * 1e3 / step_ms:.1f} triples/s); device busy "
          f"{busy:.4f} ms per step ({100 * busy / step_ms:.1f}%, idle "
          f"{100 - 100 * busy / step_ms:.1f}%); {n_kern:.1f} kernels and "
          f"{graph_launches:.2f} graph launches per step; peak allocated "
          f"{peak_mb:.1f} MB, reserved {reserved_mb:.1f} MB")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3 / steps:.4f} ms/step "
              f"x{e.count / steps:.1f}  {e.key[:90]}")
    del state, model, fused, pipe
    torch.cuda.empty_cache()
    return step_ms, busy, n_kern, graph_launches, peak_mb, reserved_mb


def print_route_profiles(profiles: dict) -> None:
    """Each path's step on the graph route beside the eager route."""
    for name in sorted({k[:-len(" graph")] for k in profiles
                        if k.endswith(" graph")}):
        (hg, dg, kg, lg, mg, rg), (he, de, ke, le, me, re_) = (
            profiles[name + " graph"], profiles[name])
        print(f"{name} step, CUDA graph against eager [{card_line()}]: host "
              f"{hg:.4f} / {he:.4f} ms, device busy {dg:.4f} / {de:.4f} ms, "
              f"busy share {100 * dg / hg:.1f}% / {100 * de / he:.1f}%, "
              f"kernels {kg:.1f} / {ke:.1f} and graph launches {lg:.2f} / "
              f"{le:.2f} a step, peak allocated {mg:.1f} / {me:.1f} MB, "
              f"reserved {rg:.1f} / {re_:.1f} MB")


def _same_tables(label: str, a, b) -> None:
    for table in ("entity", "relation", "projection"):
        x, y = getattr(a, table), getattr(b, table)
        if x is None:
            continue
        for part in ("emb", "state_sum"):
            u, v = getattr(x, part), getattr(y, part)
            if not (u.dtype == v.dtype and (u == v).all()):
                fail(f"{label}: the {table} {part} differs between the "
                     f"CUDA graph and the eager group")


def graph_parity(label: str, recipe: dict, s: int, groups: int,
                 n_train: int = 100_000, n_valid: int = 0, n_test: int = 0,
                 n_ent: int = N_ENT, n_rel: int = N_REL) -> None:
    """``groups`` groups of ``s`` steps of the recipe at full width, from
    the same initial tables, through the fused call (the first group eager
    on its capture stream, then its CUDA graph(s) replayed) and through the
    group function called eagerly on the default stream: every table, its
    Adagrad state and the logs bit-equal, the launch counts equal, one
    graph (two at s = 1) and groups - 1 replays."""
    import torch
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    from dglke_tpu_torch.models.ke_model import KEModel
    from dglke_tpu_torch.models.pipeline_step import DevicePipelineStep
    from dglke_tpu_torch.ops import rows
    from dglke_tpu_torch.trainer import DevicePipeline
    cfg = KGEConfig(**recipe)
    ds = synthetic_dataset(n_ent, n_rel, n_train=n_train, n_valid=n_valid,
                           n_test=n_test, seed=0)
    model = KEModel(cfg, n_ent, n_rel, device="cuda")
    init = model.init_state()
    neg_total = cfg.num_chunks * cfg.neg_sample_size
    out = {}
    t0 = time.time()
    for route in ("graph", "eager"):
        state = _clone(init)
        pipe = DevicePipeline(model, ds, cfg.batch_size, neg_total,
                              seed=cfg.seed)
        fused = DevicePipelineStep(model, pipe, s)
        rows.reset_launches()
        logs = []
        for _ in range(groups):
            if route == "graph":
                state, log = fused(state)
                logs.append(torch.stack([log[k] for k in fused.keys]))
            else:
                pipe.begin_group(s)
                logs.append(fused.group(state))
                pipe.end_group(s)
        torch.cuda.synchronize()
        out[route] = (state, torch.cat(logs, 1), dict(rows.launches),
                      len(fused.graphs), fused.replays, pipe.epoch)
    (g, glog, gl, graphs, replays, epochs), (e, elog, el, _, _, _) = (
        out["graph"], out["eager"])
    _same_tables(label, g, e)
    if not torch.equal(glog, elog):
        fail(f"{label}: the logs differ between the CUDA graph and the "
             f"eager group")
    if gl != el or not any(gl.values()):
        fail(f"{label}: launches {gl} on the graph route, {el} eager")
    if (graphs, replays) != (2 if s == 1 else 1, groups - 1):
        fail(f"{label}: {graphs} graphs, {replays} replays")
    if g.step != e.step or g.step != init.step + s * groups:
        fail(f"{label}: steps {g.step} / {e.step}")
    print(f"{label}: {groups} groups of {s} steps through {graphs} CUDA "
          f"graph(s) ({replays} replays) bit-equal to the eager group "
          f"function (every table, its Adagrad state, {glog.shape[0]} logs "
          f"a step), launches equal ({gl}); {epochs} epoch(s) of "
          f"{n_train} edges passed; {time.time() - t0:.1f} s")
    del init, out, g, e
    torch.cuda.empty_cache()


def _weighted(ds):
    """``ds`` with per-edge weights (edge importance) on its train split."""
    n = ds.n_train
    ds.train = ds.train[:3] + (np.linspace(0.5, 2.0, n).astype(np.float32),)
    return ds


def _same_logs(label: str, a: list, b: list) -> None:
    import torch
    for k in a[0]:
        if not torch.equal(torch.cat([x[k].reshape(-1) for x in a]),
                           torch.cat([x[k].reshape(-1) for x in b])):
            fail(f"{label}: the {k} logs differ between the CUDA graph and "
                 f"the eager steps")


def host_graph_parity(label: str, recipe: dict, steps: int,
                      weights: bool = False) -> None:
    """``steps`` host-table steps of the recipe at full width (N_ENT x
    N_REL) on mapped host tables, from the same initial tables and the
    same TrainSampler batches, through the host-table fed call
    (host_table.host_fed_step: the first step eager on its capture stream,
    then two CUDA graphs, head-first and tail-first, replayed) and through
    host_table.host_step, the eager step: every table, its Adagrad state
    and the logs bit-equal, the launches equal, 2 graphs and steps - 1
    replays."""
    import torch
    from dglke_tpu_torch import host_table
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    from dglke_tpu_torch.data.sampler import TrainSampler
    from dglke_tpu_torch.models.fed_step import pack_batch
    from dglke_tpu_torch.models.ke_model import KEModel
    from dglke_tpu_torch.ops import rows
    cfg = KGEConfig(**recipe, mix_cpu_gpu=True)
    ds = synthetic_dataset(N_ENT, N_REL, n_train=100_000, seed=0)
    if weights:
        ds = _weighted(ds)
    model = KEModel(cfg, N_ENT, N_REL, device="cuda")
    init = host_table.init_host_state(KEModel(cfg, N_ENT, N_REL,
                                              device="cpu"), seed=1)
    batches = list(islice(TrainSampler(ds, cfg.batch_size,
                                       cfg.neg_sample_size, seed=1), steps))
    t0 = time.time()
    out = {}
    for route in ("graph", "eager"):
        state = _host_copy(model, init, "cuda")
        fused = host_table.host_fed_step(model)
        rows.reset_launches()
        logs = []
        for i, batch in enumerate(batches):
            if route == "graph":
                logs.append(fused(state, [pack_batch(batch, True)], i)[1])
            else:
                logs.append(host_table.host_step(model, state, batch))
        torch.cuda.synchronize()
        out[route] = (state, logs, dict(rows.launches), len(fused.graphs),
                      fused.replays)
    (g, glogs, gl, graphs, replays), (e, elogs, el, _, _) = (out["graph"],
                                                             out["eager"])
    _same_tables(label, g, e)
    _same_logs(label, glogs, elogs)
    if gl != el or not any(gl.values()):
        fail(f"{label}: launches {gl} on the graph route, {el} eager")
    if (graphs, replays) != (2, steps - 1) or not g.step == e.step == steps:
        fail(f"{label}: {graphs} graphs, {replays} replays, steps "
             f"{g.step} / {e.step}")
    print(f"{label}: {steps} host-table steps on mapped tables through "
          f"{graphs} CUDA graphs ({replays} replays) bit-equal to "
          f"host_step (every table, its Adagrad state, the logs), launches "
          f"equal ({gl}); {time.time() - t0:.1f} s")
    del init, out, g, e
    gc.collect()


def fed_graph_parity(label: str, recipe: dict, s: int, groups: int,
                     n_train: int) -> None:
    """``groups`` host-fed groups of ``s`` TrainSampler batches of the
    recipe at full width, from the same initial tables, through the fed
    call (models/fed_step.py: the first group eager on its capture stream,
    then its CUDA graph(s) replayed) and through its group function called
    eagerly on the default stream: every table, its Adagrad state and the
    logs bit-equal, the launches equal, one graph (two at s = 1) and
    groups - 1 replays."""
    import torch
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    from dglke_tpu_torch.data.sampler import TrainSampler
    from dglke_tpu_torch.models.fed_step import FedStep, pack_batch
    from dglke_tpu_torch.models.ke_model import KEModel
    from dglke_tpu_torch.ops import rows
    cfg = KGEConfig(**recipe)
    ds = synthetic_dataset(N_ENT, N_REL, n_train=n_train, seed=0)
    model = KEModel(cfg, N_ENT, N_REL, device="cuda")
    init = model.init_state()
    sampler = TrainSampler(ds, cfg.batch_size, cfg.neg_sample_size, seed=1)
    batches = [[next(sampler) for _ in range(s)] for _ in range(groups)]
    t0 = time.time()
    out = {}
    for route in ("graph", "eager"):
        state = _clone(init)
        fused = FedStep(model, s)
        rows.reset_launches()
        logs = []
        for i, group in enumerate(batches):
            packed = [pack_batch(x, True) for x in group]
            if route == "graph":
                logs.append(fused(state, packed, i * s)[1])
            else:
                fused._stage(packed)
                group_logs = fused.group(state)
                logs.append(dict(zip(fused.keys, group_logs)))
        torch.cuda.synchronize()
        out[route] = (state, logs, dict(rows.launches), len(fused.graphs),
                      fused.replays)
    (g, glogs, gl, graphs, replays), (e, elogs, el, _, _) = (out["graph"],
                                                             out["eager"])
    _same_tables(label, g, e)
    _same_logs(label, glogs, elogs)
    if gl != el or not any(gl.values()):
        fail(f"{label}: launches {gl} on the graph route, {el} eager")
    if ((graphs, replays) != (2 if s == 1 else 1, groups - 1)
            or not g.step == e.step == s * groups):
        fail(f"{label}: {graphs} graphs, {replays} replays, steps "
             f"{g.step} / {e.step}")
    print(f"{label}: {groups} host-fed groups of {s} steps on {n_train} "
          f"train edges through {graphs} CUDA graph(s) ({replays} replays) "
          f"bit-equal to the eager group function (every table, its "
          f"Adagrad state, the logs), launches equal ({gl}); "
          f"{time.time() - t0:.1f} s")
    del init, out, g, e
    torch.cuda.empty_cache()


def _warm_cublas() -> None:
    """A cuBLAS product and a batched product in fp32 and in bf16, each
    forward on this thread and backward on autograd's, on the default
    stream and on the fused calls' capture stream: the pairs of a thread's
    handle and a stream the fused calls and their eager twins use (the
    fused TransE_l2 loss runs no backward, so the fp32 flagship alone
    leaves autograd's pairs unmade)."""
    import torch
    from dglke_tpu_torch.models.cuda_graphs import capture_stream
    dev = torch.device("cuda")
    main = torch.cuda.current_stream(dev)
    for stream in (main, capture_stream(dev)):
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.ones((2, 64, 64), device=dev, dtype=dtype,
                               requires_grad=True)
                (torch.bmm(x, x).sum() + (x[0] @ x[1]).sum()).backward()
        main.wait_stream(stream)
    torch.cuda.synchronize()


def phase_graph_parity() -> None:
    """The CUDA graph route against the eager group function, bit for
    bit: the flagship in fp32, with --compute_dtype bfloat16 and with
    --async_update; RESCAL with K3 in the graph; TransR (hidden 200); a
    few hundred flagship steps on the phase-3 data's 300,000 edges whose
    groups straddle the epoch; and s = 1 on 2,500 edges, whose batches
    straddle it (head-first and tail-first groups: two graphs).  Then the
    fed call (models/fed_step.py) against the eager steps: host tables
    (host_graph_parity: the flagship on mapped tables, with edge weights,
    TransR's projection, RESCAL's row route, RotatE's checkpointed scores)
    and the host-fed route on 1,500 edges, under two batches
    (fed_graph_parity: --async_update at s = 10, and s = 1).  The
    card's allocation after the first case and after the last must agree
    within GRAPH_MEM_SLACK: a fused call's graphs, pools and capture
    stream hold nothing once it is gone (torch keeps a cuBLAS workspace,
    ~64 MB, for each pair of a thread's handle and a stream that runs a
    cuBLAS call, for the rest of the process; _warm_cublas makes those of
    every pair the cases use before the base is taken)."""
    import torch
    _warm_cublas()
    graph_parity("graph parity TransE_l2", TRANSE, GROUP_S, 4)
    gc.collect()
    base = torch.cuda.memory_allocated()
    graph_parity("graph parity TransE_l2 bf16",
                 dict(TRANSE, compute_dtype="bfloat16"), GROUP_S, 4)
    graph_parity("graph parity TransE_l2 async",
                 dict(TRANSE, async_update=True), GROUP_S, 4)
    graph_parity("graph parity RESCAL", RESCAL, GROUP_S, 3)
    graph_parity("graph parity TransR", TRANSR, GROUP_S, 3)
    graph_parity("graph parity TransE_l2 epoch", TRANSE, 16, 20,
                 n_train=300_000, n_valid=1000, n_test=2000)
    graph_parity("graph parity TransE_l2 s = 1", TRANSE, 1, 8,
                 n_train=2_500)
    host_graph_parity("host graph parity TransE_l2", TRANSE, 8)
    host_graph_parity("host graph parity TransE_l2 impts", TRANSE, 4,
                      weights=True)
    host_graph_parity("host graph parity TransR", TRANSR, 4)
    host_graph_parity("host graph parity RESCAL", RESCAL, 4)
    host_graph_parity("host graph parity RotatE", ROTATE, 4)
    fed_graph_parity("host-fed graph parity TransE_l2 async",
                     dict(TRANSE, async_update=True), GROUP_S, 4,
                     n_train=1500)
    fed_graph_parity("host-fed graph parity TransE_l2 s = 1", TRANSE, 1, 8,
                     n_train=1500)
    gc.collect()
    grown = torch.cuda.memory_allocated() - base
    print(f"graph parity: the card's allocation grew by {grown} bytes over "
          f"{GRAPH_CASES} fused calls after the first")
    if grown > GRAPH_MEM_SLACK:
        fail(f"graph parity: {grown} bytes still allocated after "
             f"{GRAPH_CASES} fused calls, above {GRAPH_MEM_SLACK}")


# ---------------------------------------------------------------------------
# Phase 2c: the eval's fused calls

# examples/fb15k.sh evaluates every FB15k recipe at --batch_size_eval 16.
EVAL_BATCH = 16
# RotatE as examples/fb15k.sh:41-43 trains it (hidden 200, -de): a
# broadcast score form, whose eval block shrinks with the group's rows.
ROTATE = dict(model_name="RotatE", hidden_dim=200, gamma=12.0, lr=0.009,
              batch_size=2048, neg_sample_size=256,
              neg_adversarial_sampling=True, regularization_coef=1e-7,
              double_ent=True)
# The recipe-size eval: FB15k's published test split, 59,071 triples,
# filtered, at EVAL_BATCH, over phase 3's flagship checkpoint.  Its train
# split (the filter's) is phase 3's 300,000 edges plus planted hubs, FB15k's
# kind of (h, r) and (r, t) pairs with hundreds to thousands of answers:
# (the corrupted side, the fixed entity, the relation, its answers, the
# test triples drawn from them).  The 6,400 test triples of the widest
# hub fill 400 batches of filter width 16,384, more than one chunk of
# _MEGA_BUDGET holds (384 batches); the others add the widths 4,096, 1,024
# and 256; the rest of the split is the generator's, of width 8.
EVAL_TEST = 59_071
# The per-batch route (~2 x 10^5 kernels a split) is profiled over its
# first EVAL_PROFILE_CUT batches a mode only: a trace of the whole split
# takes longer than the rest of the phase.
EVAL_PROFILE_CUT = 1000
EVAL_HUBS = (("tail", 7, 3, 9000, 6400), ("tail", 11, 5, 3000, 64),
             ("head", 13, 9, 700, 64), ("tail", 17, 12, 200, 64))


def per_batch_ranks(model, state, samplers):
    """The eval as the trainer ran it before its fused calls, the
    baseline of phase 2c: a full-entity batch a call and sampled batches
    in unpadded groups of 32, each call's inputs uploaded from pageable
    numpy, eagerly; the ranks read back once at the end.  Returns the rank
    array."""
    import torch
    dev = model.device
    out = []
    for sampler in samplers:
        it = iter(sampler)
        while True:
            group = list(islice(it, 32))
            if not group:
                break
            if "neg" in group[0]:
                def stack(k, group=group):
                    return torch.as_tensor(np.stack([b[k] for b in group]),
                                           device=dev)
                n_valid = [b["n_valid"] for b in group]
                ranks = model.eval_ranks_sampled(
                    state, stack("h"), stack("r"), stack("t"), stack("neg"),
                    stack("neg_keep") if "neg_keep" in group[0] else None,
                    neg_head=group[0]["neg_head"],
                    neg_deg_sample=group[0]["neg_deg_sample"],
                    n_valid=torch.as_tensor(n_valid, device=dev))
                out += [ranks[i, :n] for i, n in enumerate(n_valid)]
                continue
            for b in group:
                h, r, t = (torch.as_tensor(b[k], device=dev)
                           for k in ("h", "r", "t"))
                if "filter_ids" in b:
                    fid = torch.as_tensor(b["filter_ids"], device=dev)
                    fm = torch.as_tensor(b["filter_mask"], device=dev)
                else:
                    fid = torch.zeros((len(b["h"]), 8), dtype=torch.int32,
                                      device=dev)
                    fm = torch.zeros((len(b["h"]), 8), dtype=torch.uint8,
                                     device=dev)
                out.append(model.eval_ranks(state, h, r, t, fid, fm,
                                            neg_head=b["neg_head"])
                           [:b["n_valid"]])
    return torch.cat(out).cpu().numpy()


def per_batch_candidates(model, state, sampler, top: bool) -> np.ndarray:
    """The candidate protocol as the trainer ran it before its fused calls
    (the baseline): a batch a call, uploaded from pageable numpy, eagerly;
    the answers' ranks, or with ``top`` the top-10 positions."""
    import torch
    from dglke_tpu_torch.models.ke_model import candidate_ranks, candidate_top
    dev = model.device
    b = sampler.batch_size
    out = []
    for beg in range(0, len(sampler.hr), b):
        hr = torch.as_tensor(sampler.hr[beg:beg + b], device=dev)
        cand = torch.as_tensor(sampler.cand[beg:beg + b], device=dev)
        scores = model.candidate_scores(state, hr[:, 0], hr[:, 1], cand)
        if top:
            out.append(candidate_top(scores))
        else:
            ans = torch.as_tensor(sampler.ans[beg:beg + b], device=dev)
            out.append(candidate_ranks(scores, ans))
    return torch.cat(out).cpu().numpy()


def _eval_ranks_of(fn):
    """The rank array an evaluate call hands combine_rank_metrics."""
    with _RankLog() as log:
        fn()
    (ranks,) = log.ranks
    return ranks


def eager_calls(model):
    """The eval graphs' baseline for ``model``: an EvalCalls whose every
    call runs its group function eagerly on the current stream, its memo
    key counted, batched as the graph route batches."""
    from dglke_tpu_torch.models.eval_step import EvalCalls

    class EagerCalls(EvalCalls):
        def _call(self, state, static, fn, args):
            self.keys[self._key(state, static, args)] += 1
            return fn(*args)

    return EagerCalls(model)


def eval_graph_parity(label: str, recipe: dict, run) -> None:
    """The recipe's eval at full width on fresh tables, through the eval's
    fused calls twice: batched as for graphs, every call's group function
    eagerly on the default stream (eager_calls), then the graph route
    (each call shape eager once on the capture stream, captured at its
    second call, replayed from there).  ``run(cfg, model, state)`` returns
    the outputs (rank arrays, top-10 positions).  They must be bit-equal,
    the launch
    counts equal, the memo keys the same, and the graphs and replays those
    the keys' call counts give: a graph for each key called twice or more,
    a replay for each call after a key's first."""
    import torch
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.models.eval_step import EvalCalls
    from dglke_tpu_torch.models.ke_model import KEModel
    from dglke_tpu_torch.ops import rows

    cfg = KGEConfig(**recipe)
    model = KEModel(cfg, N_ENT, N_REL, device="cuda")
    state = model.init_state()
    out = {}
    for route in ("eager", "graph"):
        model.eval_calls = calls = (EvalCalls(model) if route == "graph"
                                    else eager_calls(model))
        rows.reset_launches()
        t0 = time.perf_counter()
        res = run(cfg, model, state)
        torch.cuda.synchronize()
        out[route] = (res, dict(rows.launches), calls.captured,
                      calls.replays, dict(calls.keys),
                      time.perf_counter() - t0)
    (g, gl, cap, rep, keys, gs), (e, el, ecap, erep, ekeys, es) = (
        out["graph"], out["eager"])
    if len(g) != len(e) or not all(a.shape == b.shape and np.array_equal(
            a, b) for a, b in zip(g, e)):
        fail(f"{label}: the outputs of the CUDA graphs differ from the "
             f"eager group functions'")
    if gl != el or not gl["gather_rows"]:
        fail(f"{label}: launches {gl} on the graph route, {el} eager")
    want = (sum(n >= 2 for n in keys.values()),
            sum(n - 1 for n in keys.values()))
    if keys != ekeys or (cap, rep) != want or not cap or (ecap, erep) != (
            0, 0):
        fail(f"{label}: {cap} graphs, {rep} replays (the keys' calls give "
             f"{want}); eager {ecap}, {erep}")
    print(f"{label}: {sum(keys.values())} calls of {len(keys)} call shapes; "
          f"{cap} CUDA graph(s) captured, {rep} replays, outputs "
          f"({', '.join(str(a.shape) for a in g)}) bit-equal to the eager "
          f"group functions, launches equal ({gl}); {gs:.2f} s graph route "
          f"(captures included), {es:.2f} s eager")
    del model, state, out
    torch.cuda.empty_cache()


def phase_eval_graphs() -> None:
    """Phase 2c's bit-equality cases, on the phase-3 data (2,000 test
    triples) at EVAL_BATCH: the filtered full-entity flagship; RotatE raw
    (a broadcast form: the block width follows the group's rows); TransR
    (hidden 200); RESCAL (hidden 500); sampled eval (500 negatives,
    filtered by the keep masks; and with neg_deg_sample), 125 batches a
    mode in groups of 32 whose last group of 29 is padded; the candidate
    protocol (2,000 queries x 1,001 candidates, batch 32) in Valid and Test
    mode."""
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    from dglke_tpu_torch.data.sampler import FilterIndex
    from dglke_tpu_torch.trainer import (
        CandidateEvalSampler,
        candidate_outputs,
        evaluate,
    )
    quiet = lambda *a: None  # noqa: E731
    ds = synthetic_dataset(n_entities=N_ENT, n_relations=N_REL,
                           n_train=300_000, n_valid=1000, n_test=2000,
                           seed=0)
    fi = FilterIndex(ds)

    def full(cfg, model, state):
        return [_eval_ranks_of(lambda: evaluate(
            cfg, ds, model, state, "test",
            filter_index=fi if cfg.eval_filter else None, log=quiet))]

    for label, recipe in (
            ("TransE_l2 filtered", TRANSE),
            ("RotatE raw", dict(ROTATE, no_eval_filter=True)),
            ("TransR filtered", TRANSR), ("RESCAL filtered", RESCAL),
            ("sampled filtered", dict(TRANSE,
                                      neg_sample_size_eval=WIKI_EVAL_NEG)),
            ("sampled neg_deg_sample", dict(
                TRANSE, neg_sample_size_eval=WIKI_EVAL_NEG,
                neg_deg_sample_eval=True, no_eval_filter=True))):
        eval_graph_parity(f"eval graphs {label}",
                          dict(recipe, batch_size_eval=EVAL_BATCH), full)

    def candidates(cfg, model, state):
        sampler = CandidateEvalSampler(_candidates(ds), cfg.batch_size_eval)
        return [candidate_outputs(model.eval_calls, state, sampler, top=top,
                                  phase=phase)
                for top, phase in ((False, "Valid"), (True, "Test"))]

    eval_graph_parity("eval graphs candidates Valid and Test",
                      dict(TRANSE, batch_size_eval=WIKI_EVAL_BATCH),
                      candidates)


# Host mode's eval calls (host_table.py), the cases of
# phase_host_eval_graphs on mapped host tables.  The block is 16,384
# entities for the matmul forms, so 50,000 stream in four blocks, the
# tail starting early at row 33,616; 5,000 test triples a direction are
# over the 4,096 rows a chunk holds at that block (_Q_CAP_BYTES), so each
# block makes two chunks a direction; RotatE's and TransR's blocks follow
# the queries' rows (256 and 512 at 2,000 triples: 59 and 30 blocks).
HOST_EVAL_ENT = 50_000


def host_eval_graph_parity(label: str, recipe: dict, n_ent: int,
                           n_test: int) -> None:
    """The recipe's test eval on mapped host tables of ``n_ent`` entities
    at full width (drawn as host mode draws them), twice on each route:
    the eager baseline (eager_calls: the same calls and staging copies,
    every call's group function run eagerly), then the graph route (each
    memo key eager once on the capture stream, captured at its second
    call, replayed from there).  The integer ranks must be equal on both
    routes and in both evals, the launches equal (K1 counted through the
    replays), the memo keys the same, and the graphs and replays those the
    keys' calls give; and the ranks those of trainer.evaluate on copies
    of the tables on the card."""
    import torch
    from dglke_tpu_torch import host_table
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    from dglke_tpu_torch.data.sampler import FilterIndex
    from dglke_tpu_torch.models.eval_step import EvalCalls
    from dglke_tpu_torch.models.ke_model import KEModel, TrainState
    from dglke_tpu_torch.ops import rows
    from dglke_tpu_torch.ops.embedding import EmbeddingState
    from dglke_tpu_torch.trainer import evaluate
    cfg = KGEConfig(**dict(recipe, batch_size_eval=EVAL_BATCH,
                           mix_cpu_gpu=True))
    ds = synthetic_dataset(n_entities=n_ent, n_relations=N_REL,
                           n_train=100_000, n_valid=100, n_test=n_test,
                           seed=0)
    fi = FilterIndex(ds) if cfg.eval_filter else None
    model = KEModel(cfg, n_ent, N_REL, device="cuda")
    init = host_table.init_host_state(KEModel(cfg, n_ent, N_REL,
                                              device="cpu"), seed=1)
    state = _host_copy(model, init, "cuda")
    out = {}
    for route in ("eager", "graph"):
        model.eval_calls = calls = (EvalCalls(model) if route == "graph"
                                    else eager_calls(model))
        rows.reset_launches()
        lines = []
        t0 = time.perf_counter()
        ranks = [_eval_ranks_of(lambda: evaluate(
            cfg, ds, model, state, "test", filter_index=fi,
            log=lines.append)) for _ in range(2)]
        torch.cuda.synchronize()
        out[route] = (ranks, dict(rows.launches), calls.captured,
                      calls.replays, dict(calls.keys),
                      time.perf_counter() - t0, lines)
    (g, gl, cap, rep, keys, gs, lines), (e, el, ecap, erep, ekeys, es, _) = (
        out["graph"], out["eager"])
    if not all(np.array_equal(g[0], x) for x in g[1:] + e):
        fail(f"{label}: host eval ranks differ between the routes or the "
             f"two evals")
    if gl != el or not gl["gather_rows"]:
        fail(f"{label}: launches {gl} on the graph route, {el} eager")
    want = (sum(n >= 2 for n in keys.values()),
            sum(n - 1 for n in keys.values()))
    if keys != ekeys or (cap, rep) != want or not cap or (ecap, erep) != (
            0, 0):
        fail(f"{label}: {cap} graphs, {rep} replays (the keys' calls give "
             f"{want}); eager {ecap}, {erep}")
    # each key makes half its calls in each eval: in the first, a key of
    # two or more calls an eval captures and replays all but its first;
    # in the second, the keys of one call an eval capture, and every call
    # replays
    said = [tuple(map(int, x)) for x in re.findall(
        r"\[0\]Test eval CUDA graphs: (\d+) captured, (\d+) replays",
        "\n".join(lines))]
    half = [n // 2 for n in keys.values()]
    if said != [(sum(n >= 2 for n in half), sum(n - 1 for n in half)),
                (sum(n == 1 for n in half), sum(half))]:
        fail(f"{label}: eval graph lines {said}, the keys' calls {half}")
    blocks = sum(n for k, n in keys.items() if k[0] == "host_block") // 2

    def card(t):
        return None if t is None else EmbeddingState(t.emb.cuda(),
                                                     t.state_sum.cuda())

    dev_state = TrainState(card(state.entity), card(state.relation),
                           projection=card(state.projection))
    model.eval_calls = EvalCalls(model)
    on_card = _eval_ranks_of(lambda: evaluate(
        cfg, ds, model, dev_state, "test", filter_index=fi, log=lambda *a:
        None))
    if not np.array_equal(on_card, g[0]):
        fail(f"{label}: host eval ranks differ from the card tables' "
             f"({int((on_card != g[0]).sum())} of {len(on_card)} rows)")
    print(f"{label}: {len(g[0])} ranks a host eval on mapped tables "
          f"({n_ent} x {model.entity_dim}); {sum(keys.values())} calls of "
          f"{len(keys)} memo keys over two evals ({blocks} blocks an eval); "
          f"{cap} CUDA graph(s) captured, {rep} replays; ranks equal to the "
          f"eager calls' and to the card tables' evaluate, launches equal "
          f"({gl}); {gs:.2f} s graph route (captures included), {es:.2f} s "
          f"eager")
    del model, state, dev_state, out, init
    gc.collect()
    torch.cuda.empty_cache()


def phase_host_eval_graphs() -> None:
    """Phase 2c on host tables, host_eval_graph_parity of: TransE_l2
    filtered over HOST_EVAL_ENT entities (four blocks), with 2,000 test
    triples and with 5,000 (two chunks a block a direction); RotatE raw
    and TransR filtered (the projection read from its mapped table) at
    N_ENT; and the sampled eval at N_ENT, filtered and with
    neg_deg_sample (raw): 125 batches a mode, groups of 32, the last
    padded."""
    sampled = dict(TRANSE, neg_sample_size_eval=WIKI_EVAL_NEG)
    for label, recipe, n_ent, n_test in (
            ("TransE_l2 filtered, 4 blocks", TRANSE, HOST_EVAL_ENT, 2000),
            ("TransE_l2 filtered, 2 chunks a block", TRANSE, HOST_EVAL_ENT,
             5000),
            ("RotatE raw", dict(ROTATE, no_eval_filter=True), N_ENT, 2000),
            ("TransR filtered", TRANSR, N_ENT, 2000),
            ("sampled filtered", sampled, N_ENT, 2000),
            ("sampled neg_deg_sample raw", dict(
                sampled, neg_deg_sample_eval=True, no_eval_filter=True),
             N_ENT, 2000)):
        host_eval_graph_parity(f"host eval graphs {label}", recipe, n_ent,
                               n_test)


def _fb15k_recipe_eval(name: str) -> str:
    """The recipe-size eval's dataset under WORK/name (EVAL_TEST test
    triples, the planted EVAL_HUBS), written once; returns its
    directory."""
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    path = os.path.join(WORK, name)
    if os.path.isdir(path):
        return path
    n_hub = sum(hub[4] for hub in EVAL_HUBS)
    ds = synthetic_dataset(n_entities=N_ENT, n_relations=N_REL,
                           n_train=300_000, n_valid=1000,
                           n_test=EVAL_TEST - n_hub, seed=0)
    rng = np.random.RandomState(11)
    train, test = [ds.train], [ds.test]
    for side, e, r, n, n_test in EVAL_HUBS:
        many = rng.choice(N_ENT, n, replace=False)
        one, rel = np.full(n, e), np.full(n, r)
        tri = (one, rel, many) if side == "tail" else (many, rel, one)
        train.append(tri)
        test.append(tuple(x[:n_test] for x in tri))
    ds.train, ds.test = (tuple(np.concatenate([p[k] for p in parts])
                               for k in range(3)) for parts in (train, test))
    _write_udd(path, ds)
    return path


def _busy_s(fn, cpu: bool = True) -> float:
    """Seconds of kernel time on the card while ``fn`` runs
    (torch.profiler; ``cpu`` False traces the CUDA activity alone, for a
    run of ~10^5 eager kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in _kernel_events(prof)) / 1e6


def _full_near_ties(model, state, dataset, idx) -> np.ndarray:
    """For full-entity rank rows ``idx`` (head-mode rows of the test split,
    then tail-mode rows), whether another entity's score lies within
    TIE_RTOL (|pos| + gamma) of the positive score (fp32, on the card)."""
    import torch
    n_test = len(dataset.test[0])
    out = np.zeros(len(idx), bool)
    sf, dev = model.score_fn, state.entity.emb.device
    cand = state.entity.emb[:, :model.entity_dim].float()
    for j, i in enumerate(idx):
        neg_head = bool(i < n_test)
        h, r, t = (torch.as_tensor(x[i % n_test:i % n_test + 1], device=dev)
                   for x in dataset.test)
        pos, side, rel, _ = model._eval_pos_side(state, h, r, t,
                                                 neg_head=neg_head)
        s = sf.neg_score(side, rel, cand, neg_head=neg_head, num_chunks=1,
                         chunk_size=1, neg_sample_size=len(cand)).reshape(-1)
        gap = (s - pos).abs()
        gap[int((h if neg_head else t)[0])] = float("inf")   # itself
        out[j] = bool((gap <= TIE_RTOL * (pos.abs() + model.config.gamma))
                      .any())
    return out


EVAL_RECIPE = "TransE_l2 eval recipe"
# Its calls (counted by the same batching on the CPU): tail mode, 3,282
# batches of width 8 in 103 groups of 32, 401 of width 16,384 in two
# chunks of 12 groups (the second padded), and a group each at 4,096 and
# 256; head mode, 3,687 batches of width 8 in 116 groups and one group at
# 1,024: 246 calls of 4 K1 each (h, t and r rows, the 14,951 candidate
# rows), in 6 call shapes, three of them called more than once.
EXPECTED_LAUNCHES[EVAL_RECIPE] = {"gather_rows": 984, "group_ids": 0,
                                  "group_ids_tiles": 0,
                                  "sparse_adagrad_rows": 0,
                                  "outer_adagrad_update": 0,
                                  "transe_l2_loss": 0}
EXPECTED_EVAL_GRAPHS[EVAL_RECIPE] = (3, 240)


def phase_eval_recipe():
    """The filtered full-entity eval at the FB15k recipe's size:
    dglke_tpu_torch-eval over phase 3's flagship checkpoint on EVAL_TEST
    test triples at --batch_size_eval EVAL_BATCH (the planted hubs give
    five filter widths and a bucket of two chunks), its launches held to
    EXPECTED_LAUNCHES and its eval graphs to EXPECTED_EVAL_GRAPHS; then on
    the same tables the fused route again (every call replayed) and the
    per-batch route (per_batch_ranks): seconds a split, peak
    memory, device busy seconds (torch.profiler) and busy share, MRR; the
    ranks equal to the per-batch route's but on rows with a near tie,
    which are counted.  Returns the launch counts of the CLI run."""
    import torch
    from dglke_tpu_torch.cli import eval as eval_cli
    from dglke_tpu_torch.data.sampler import EvalSampler, FilterIndex
    from dglke_tpu_torch.models.ke_model import metrics_from_ranks
    from dglke_tpu_torch.ops import rows
    from dglke_tpu_torch.trainer import evaluate
    data = _fb15k_recipe_eval("eval_recipe")
    ckpt = os.path.join(WORK, "ckpts", "TransE_l2_fb15k_shaped_0")
    argv = [*_udd_args(data), "--model_path", ckpt, "--batch_size_eval",
            str(EVAL_BATCH)]
    print(f"{EVAL_RECIPE}: dglke_tpu_torch-eval " + " ".join(argv))
    got = {}
    real = eval_cli.evaluate

    def keep(cfg, dataset, model, state, *args, **kwargs):
        got.update(cfg=cfg, dataset=dataset, model=model, state=state)
        return real(cfg, dataset, model, state, *args, **kwargs)

    out = io.StringIO()
    eval_cli.evaluate = keep
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rows.reset_launches()
        with _RankLog() as ranks, contextlib.redirect_stdout(out):
            rc = _cli(eval_cli.main, argv)
        counts = dict(rows.launches)
    finally:
        eval_cli.evaluate = real
    text = out.getvalue()
    print(text.rstrip())
    if rc != 0:
        fail(f"{EVAL_RECIPE}: eval CLI returned {rc}")
    want = EXPECTED_LAUNCHES[EVAL_RECIPE]
    if any(counts[k] != v for k, v in want.items()):
        fail(f"{EVAL_RECIPE}: launches {counts}, expected {want}")
    captured, replays = eval_graphs(EVAL_RECIPE, text)
    cli_s = _floats(r"\[0\]Test takes (\S+) seconds", text)[0]
    cli_peak = (torch.cuda.max_memory_allocated() / 2**20,
                torch.cuda.max_memory_reserved() / 2**20)
    cfg, dataset, model, state = (got[k] for k in ("cfg", "dataset",
                                                   "model", "state"))
    fused = ranks.ranks[0]
    fi = FilterIndex(dataset)

    def samplers():
        return [EvalSampler(dataset, "test", cfg.batch_size_eval, mode, fi)
                for mode in ("head", "tail")]

    n_calls = sum(model.eval_calls.keys.values())
    n_shapes = len(model.eval_calls.keys)
    t0 = time.perf_counter()
    n_batches = sum(1 for s in samplers() for _ in s)
    sampler_s = time.perf_counter() - t0
    quiet = lambda *a: None  # noqa: E731

    def fused_run():
        return _eval_ranks_of(lambda: evaluate(
            cfg, dataset, model, state, "test", filter_index=fi, log=quiet))

    def cut_run():
        return per_batch_ranks(model, state, [islice(s, EVAL_PROFILE_CUT)
                                         for s in samplers()])

    routes = {}
    for route, run, profiled in (
            ("fused", fused_run, fused_run),
            ("per-batch", lambda: per_batch_ranks(model, state, samplers()),
             cut_run)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() / 2**20,
                torch.cuda.max_memory_reserved() / 2**20)
        # the busy share over the profiled run's own unprofiled seconds
        t0 = time.perf_counter()
        if profiled is not run:
            profiled()
            torch.cuda.synchronize()
        profiled_s = (time.perf_counter() - t0 if profiled is not run
                      else secs)
        routes[route] = (r, secs, peak, _busy_s(profiled,
                                                cpu=route == "fused"),
                         profiled_s)
    if not np.array_equal(routes["fused"][0], fused):
        fail(f"{EVAL_RECIPE}: the fused route's replayed ranks differ from "
             f"its first run's")
    base = routes["per-batch"][0]
    idx = np.nonzero(fused != base)[0]
    near = _full_near_ties(model, state, dataset, idx)
    if not near.all():
        fail(f"{EVAL_RECIPE}: {len(idx)} ranks differ from the per-batch "
             f"route's, {int((~near).sum())} of them with no near tie "
             f"(rows {idx[~near][:5].tolist()})")
    print(f"{EVAL_RECIPE} [{card_line()}]: {len(fused)} ranks (2 x "
          f"{EVAL_TEST} test triples, batch {EVAL_BATCH}, filtered); the "
          f"CLI's fused route {cli_s:.3f} s a split (first calls and "
          f"captures included), {captured} graphs captured, {replays} "
          f"replays, {n_calls} calls in {n_shapes} call shapes, peak "
          f"allocated "
          f"{cli_peak[0]:.1f} MB, reserved {cli_peak[1]:.1f} MB; MRR "
          f"{metrics_from_ranks(fused)['MRR']!r} fused, "
          f"{metrics_from_ranks(base)['MRR']!r} per batch; ranks differing "
          f"from the per-batch route's: {len(idx)}, all at near ties; "
          f"the EvalSampler alone (both routes' host work before any call) "
          f"{sampler_s:.4f} s for its {n_batches} batches")
    for route, (_, secs, peak, busy, busy_of) in routes.items():
        over = ("" if busy_of == secs else
                f" over its first {EVAL_PROFILE_CUT} batches a mode "
                f"({busy_of:.4f} s)")
        share = (f"device busy{over} {busy:.4f} s ({100 * busy / busy_of:.1f}"
                 f"%, idle {100 - 100 * busy / busy_of:.1f}%)" if busy
                 else "device busy not measured (no kernel in the trace)")
        print(f"{EVAL_RECIPE}, {route} route [{card_line()}]: {secs:.4f} s "
              f"a split, {share}, peak allocated {peak[0]:.1f} MB, reserved "
              f"{peak[1]:.1f} MB")
    del got, model, state, routes
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_step_one():
    """Step group size 1 on one device (an odd --max_step, S1_STEPS steps on
    the phase-3 data) through the CLI: the host-fed TrainSampler, as the
    JAX package takes it there, with its sample / update line, two CUDA
    graphs (head-first and tail-first steps, graph_route) and its launches
    held through the replays."""
    argv = ["--dataset", "fb15k_shaped",
            *_udd_args(_fb15k_shaped("data", n_train=300_000)),
            *_recipe_flags(TRANSE), "--max_step", str(S1_STEPS),
            "--log_interval", str(S1_STEPS), "--no_save_emb",
            "--save_path", os.path.join(WORK, "ckpts")]
    counts, text, _, state = run_cli("TransE_l2 s = 1", argv)
    if ("host-fed TrainSampler (step group size 1): 1 steps a group"
            not in text or not re.search(r"\[proc 0\]sample: \S+, update: ",
                                         text)):
        fail("s = 1 run: the trainer did not take the host-fed route")
    if state.step != S1_STEPS:
        fail(f"s = 1 run: {state.step} steps")
    print(f"s = 1 run: {S1_STEPS} steps through the host-fed TrainSampler "
          f"on {300_000} train edges, one fed call a step; launches "
          f"{counts}")
    return counts


def phase_wiki_eval_routes(ds, model, state):
    """wikikg2's sampled test eval (20,000 triples x 2 modes, 500
    negatives, batch 32) on the trained state on both routes: the fused
    route (its graphs captured in the CLI run, every call replayed) and
    the per-batch route's (per_batch_ranks); seconds a split, the ranks
    equal but on rows with a near tie (a score within TIE_RTOL (|pos| +
    gamma) of the positive), counted."""
    import torch
    from dglke_tpu_torch.data.sampler import EvalSampler
    from dglke_tpu_torch.ops import rows
    from dglke_tpu_torch.trainer import evaluate
    cfg = model.config
    quiet = lambda *a: None  # noqa: E731

    def samplers():
        return [EvalSampler(ds, "test", cfg.batch_size_eval, mode, None,
                            seed=cfg.seed,
                            neg_sample_size=cfg.neg_sample_size_eval)
                for mode in ("head", "tail")]

    out = {}
    for route in ("fused", "per-batch"):
        t0 = time.perf_counter()
        if route == "fused":
            r = _eval_ranks_of(lambda: evaluate(cfg, ds, model, state,
                                                "test", log=quiet))
        else:
            r = per_batch_ranks(model, state, samplers())
        torch.cuda.synchronize()
        out[route] = (r, time.perf_counter() - t0)
    (fused, fs), (base, bs) = out["fused"], out["per-batch"]
    differ = np.nonzero(fused != base)[0]
    n_near = 0
    if len(differ):
        b = cfg.batch_size_eval
        batches = [x for s in samplers() for x in s]
        n_mode = len(batches) // 2
        sf, dev = model.score_fn, state.entity.emb.device
        for i in differ:
            mode, row = divmod(int(i), len(ds.test[0]))
            batch = batches[mode * n_mode + row // b]
            j = row % b
            ids = [torch.as_tensor(batch[k][j:j + 1], device=dev)
                   for k in ("h", "r", "t")]
            pos, side, rel, _ = model._eval_pos_side(
                state, *ids, neg_head=batch["neg_head"])
            neg = rows.gather_rows(state.entity.emb, torch.as_tensor(
                batch["neg"], device=dev), model.entity_dim)
            s = sf.neg_score(side, rel, neg, neg_head=batch["neg_head"],
                             num_chunks=1, chunk_size=1,
                             neg_sample_size=len(batch["neg"]))
            n_near += bool(((s.reshape(-1) - pos).abs()
                            <= TIE_RTOL * (pos.abs() + cfg.gamma)).any())
        if n_near != len(differ):
            fail(f"wikikg2 sampled eval: {len(differ)} ranks differ between "
                 f"the routes, {len(differ) - n_near} with no near tie")
    print(f"wikikg2 sampled eval, both routes [{card_line()}]: "
          f"{len(fused)} ranks; fused {fs:.4f} s a split (graphs replayed), "
          f"per-batch (eager, unpadded groups) {bs:.4f} s; "
          f"{len(differ)} ranks differ, all at near ties")


# ---------------------------------------------------------------------------
# The serving path


def _read_tsv(path: str, n_ids: int):
    """A predict / emb_sim TSV: ids [rows, n_ids] int64, scores float32."""
    with open(path) as f:
        next(f)
        rows = [ln.rstrip("\n").split("\t") for ln in f]
    return (np.array([r[:n_ids] for r in rows], dtype=np.int64),
            np.array([r[-1] for r in rows], dtype=np.float32))


def hold_to_cpu(label: str, card, cpu_blocks, scale: float) -> None:
    """The card's first result blocks (ids [b*K, c], scores) against the
    CPU's top K + 1 of the same blocks: scores within SERVE_RTOL (|s| +
    scale); ids equal but at a near tie, another CPU score of the block
    within TIE_RTOL (|s| + scale)."""
    ids, s = card
    differ = near_rows = 0
    err = 0.0
    for b, (c_ids, c_s) in enumerate(cpu_blocks):
        g_ids, g_s = ids[b * SERVE_K:(b + 1) * SERVE_K], \
            s[b * SERVE_K:(b + 1) * SERVE_K]
        want = c_s[:SERVE_K]
        if g_s.shape != want.shape:
            fail(f"{label}: block {b} has {len(g_s)} rows, the CPU "
                 f"{len(want)}")
        gap = np.abs(g_s.astype(np.float64) - want)
        err = max(err, float(gap.max()))
        if (gap > SERVE_RTOL * (np.abs(want) + scale)).any():
            fail(f"{label}: block {b} scores differ from the CPU's by "
                 f"{gap.max()}")
        for i in np.flatnonzero((g_ids != c_ids[:SERVE_K]).any(1)):
            differ += 1
            near = np.abs(c_s - c_s[i]) <= TIE_RTOL * (abs(c_s[i]) + scale)
            if near.sum() < 2:
                fail(f"{label}: block {b} row {i} differs from the CPU's "
                     f"({g_ids[i]} against {c_ids[i]}) with no near tie")
        near_rows += int(sum((np.abs(c_s - x) <= TIE_RTOL * (abs(x) + scale))
                             .sum() > 1 for x in want))
    print(f"  {label} against the CPU on {len(cpu_blocks)} block(s): max "
          f"|score card - CPU| {err:.3g}; {differ} of "
          f"{len(cpu_blocks) * SERVE_K} rows differ, all at near ties "
          f"({near_rows} rows with one)")


def _ties_lower_first(label: str, flat: np.ndarray, s: np.ndarray) -> None:
    """Within each result block, equal scores come lower flat index
    first."""
    for b in range(0, len(s), SERVE_K):
        fb, sb = flat[b:b + SERVE_K], s[b:b + SERVE_K]
        for x in np.unique(sb):
            if (np.diff(fb[sb == x]) <= 0).any():
                fail(f"{label}: equal scores out of index order: "
                     f"{fb[sb == x]}")


def serve_run(label: str, fn, n_scores: int):
    """One serving request on the card, its launch counts read around it
    alone and held to EXPECTED_LAUNCHES[label]; prints its seconds and
    scores per second.  Returns (counts, fn's result)."""
    import torch
    from dglke_tpu_torch.ops import rows
    rows.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(rows.launches)
    want = EXPECTED_LAUNCHES[label]
    if any(counts[k] != v for k, v in want.items()):
        fail(f"{label}: launches {counts}, expected {want}")
    print(f"{label}: {secs:.3f} s, {n_scores} scores, "
          f"{n_scores / secs:.1f} scores/s; launches {counts}")
    return counts, result


def _cli(main, argv) -> int:
    rc = main(argv)
    if rc != 0:
        fail(f"CLI {argv[:4]} returned {rc}")
    return rc


def phase_serving():
    """The serving path on the card over the checkpoints the TransE_l2 and
    RESCAL main paths wrote: dglke_tpu_torch-predict (TransE_l2 batch_head
    over 16 heads x all relations x all tails; 100,000 triples
    triplet_wise, plain and logsigmoid; RESCAL all over 8 heads x 8
    relations x all tails, K1's wide shape), dglke_tpu_torch-emb_sim
    (cosine batch_left for 1,000 left rows; all 14,951^2 pairs) and the
    object API (link_predict batch_head with exclude_mode="exclude" and the
    training graph attached).  Each run's launches are held to
    EXPECTED_LAUNCHES and its output to the CPU's on a cut; the card's
    exact ties (planted duplicate rows) come out lower index first.
    Returns the launch counts of each run."""
    import torch
    from dglke_tpu_torch.cli import emb_sim as emb_sim_cli
    from dglke_tpu_torch.cli import predict as predict_cli
    from dglke_tpu_torch.data.dataset import get_dataset
    from dglke_tpu_torch.models import TransE_l2Model
    from dglke_tpu_torch.models.infer import EmbSimInfer, ScoreInfer
    from dglke_tpu_torch.utils.io import load_config_json
    t_phase = time.perf_counter()
    ck = os.path.join(WORK, "ckpts")
    transe = os.path.join(ck, "TransE_l2_fb15k_shaped_0")
    rescal = os.path.join(ck, "RESCAL_fb15k_shaped_0")
    d = os.path.join(WORK, "serve")
    os.makedirs(d, exist_ok=True)
    data = os.path.join(WORK, "data")
    ds = get_dataset(data, "fb15k_shaped", "udd_hrt", "\t",
                     ["entities.tsv", "relations.tsv", "train.tsv",
                      "valid.tsv", "test.tsv"])
    rng = np.random.default_rng(3)
    first = np.unique(ds.train[0][:1000], return_index=True)[1]
    heads = ds.train[0][np.sort(first)[:SERVE_HEADS]]
    trip = [x[:SERVE_TRIPLES] for x in ds.train]
    r_heads = heads[:RESCAL_HEADS]
    r_rels = np.unique(ds.train[1][:1000])[:RESCAL_RELS]
    left = rng.choice(N_ENT, SIM_LEFT, replace=False)

    def ids_file(name, ids):
        path = os.path.join(d, f"{name}.list")
        np.savetxt(path, ids, fmt="%d")
        return path

    def tsv(name):
        return os.path.join(d, f"{name}.tsv")

    t_gamma = TRANSE["gamma"]
    paths = {}

    # -- predict TransE_l2 batch_head: 16 x 1,345 x 14,951 -----------------
    label = "predict TransE_l2 batch_head"
    argv = ["--model_path", transe, "--format", "h_*_*", "--data_files",
            ids_file("heads", heads), "--exec_mode", "batch_head",
            "--topK", str(SERVE_K), "--output", tsv("batch_head")]
    paths[label], _ = serve_run(label, lambda: _cli(predict_cli.main, argv),
                                SERVE_HEADS * N_REL * N_ENT)
    card = _read_tsv(tsv("batch_head"), 3)
    if card[0].shape != (SERVE_HEADS * SERVE_K, 3) or not np.isfinite(
            card[1]).all():
        fail(f"{label}: TSV {card[0].shape}, finite {np.isfinite(card[1])}")
    _ties_lower_first(label, card[0][:, 1] * N_ENT + card[0][:, 2], card[1])
    cpu = ScoreInfer("cpu", load_config_json(transe), transe, "none")
    cpu.load_model()
    hold_to_cpu(label, card, [(np.stack(b[:3], 1), b[3]) for b in cpu.topK(
        heads[:SERVE_CUT], None, None, "batch_head", SERVE_K + 1)], t_gamma)

    # -- predict TransE_l2 triplet_wise, plain and logsigmoid ---------------
    files = [ids_file(n, x) for n, x in zip(("th", "tr", "tt"), trip)]
    for label, sfunc in (("predict TransE_l2 triplet_wise", "none"),
                         ("predict TransE_l2 logsigmoid", "logsigmoid")):
        argv = ["--model_path", transe, "--format", "h_r_t", "--data_files",
                *files, "--exec_mode", "triplet_wise", "--topK",
                str(SERVE_K), "--score_func", sfunc, "--output", tsv(sfunc)]
        paths[label], _ = serve_run(
            label, lambda: _cli(predict_cli.main, argv), SERVE_TRIPLES)
        cpu = ScoreInfer("cpu", load_config_json(transe), transe, sfunc)
        cpu.load_model()
        (h, r, t, s), = cpu.topK(*trip, "triplet_wise", SERVE_K + 1)
        hold_to_cpu(label, _read_tsv(tsv(sfunc), 3),
                    [(np.stack([h, r, t], 1), s)], t_gamma)
    del cpu

    # -- predict RESCAL all: 8 x 8 x 14,951, K1 on 1 MB relation rows -------
    label = "predict RESCAL all"
    argv = ["--model_path", rescal, "--format", "h_r_*", "--data_files",
            ids_file("rh", r_heads), ids_file("rr", r_rels), "--exec_mode",
            "all", "--topK", str(SERVE_K), "--output", tsv("rescal")]
    paths[label], _ = serve_run(label, lambda: _cli(predict_cli.main, argv),
                                RESCAL_HEADS * RESCAL_RELS * N_ENT)
    torch.cuda.empty_cache()
    cpu = ScoreInfer("cpu", load_config_json(rescal), rescal, "none")
    cpu.load_model()
    (h, r, t, s), = cpu.topK(r_heads, r_rels, None, "all", SERVE_K + 1)
    del cpu
    hold_to_cpu(label, _read_tsv(tsv("rescal"), 3),
                [(np.stack([h, r, t], 1), s)], RESCAL["gamma"])

    # -- emb_sim over the TransE_l2 entity table -----------------------------
    emb_file = os.path.join(transe, "fb15k_shaped_TransE_l2_entity.npy")
    label = "emb_sim batch_left"
    argv = ["--emb_file", emb_file, "--format", "l_*", "--data_files",
            ids_file("left", left), "--exec_mode", "batch_left",
            "--sim_func", "cosine", "--topK", str(SERVE_K), "--output",
            tsv("batch_left")]
    paths[label], _ = serve_run(label, lambda: _cli(emb_sim_cli.main, argv),
                                SIM_LEFT * N_ENT)
    card = _read_tsv(tsv("batch_left"), 2)
    _ties_lower_first(label, card[0][:, 1], card[1])
    cpu = EmbSimInfer("cpu", emb_file, "cosine")
    cpu.load_emb()
    hold_to_cpu(label, card, [(np.stack(b[:2], 1), b[2]) for b in cpu.topK(
        left[:SERVE_CUT], None, bcast=True, k=SERVE_K + 1)], 1.0)

    label = "emb_sim all"
    argv = ["--emb_file", emb_file, "--format", "*", "--exec_mode", "all",
            "--topK", str(SERVE_K), "--output", tsv("all")]
    paths[label], _ = serve_run(label, lambda: _cli(emb_sim_cli.main, argv),
                                N_ENT * N_ENT)
    card = _read_tsv(tsv("all"), 2)
    _ties_lower_first(label, card[0][:, 0] * N_ENT + card[0][:, 1], card[1])
    cut = np.arange(SIM_CUT)
    on_card = EmbSimInfer("cuda", emb_file, "cosine")
    on_card.load_emb()
    (l, r, s), = on_card.topK(cut, None, k=SERVE_K)
    (cl, cr, cs), = cpu.topK(cut, None, k=SERVE_K + 1)
    hold_to_cpu(f"{label} (first {SIM_CUT} left rows)",
                (np.stack([l, r], 1), s), [(np.stack([cl, cr], 1), cs)], 1.0)
    del on_card, cpu
    torch.cuda.empty_cache()

    # -- the object API: link_predict with the training graph excluded ------
    label = "link_predict exclude"
    model = TransE_l2Model(gamma=t_gamma)
    model.load(transe)
    model.attach_graph(ds)
    kw = dict(head=heads, exec_mode="batch_head", topk=SERVE_K)
    paths[label], res = serve_run(
        label, lambda: model.link_predict(exclude_mode="exclude", **kw),
        SERVE_HEADS * N_REL * N_ENT)
    masked = model.link_predict(**{**kw, "topk": 4 * SERVE_K},
                                exclude_mode="mask")
    dropped = 0
    for (h, r, t, s, _), (mh, mr, mt, ms, mask) in zip(res, masked):
        if model.graph.contains(h, r, t).any():
            fail(f"{label}: a known edge was not excluded")
        keep = np.flatnonzero(~mask)[:SERVE_K]
        dropped += int(mask[:keep[-1] + 1].sum() if len(keep) else mask.sum())
        if len(keep) == SERVE_K and not (np.array_equal(h, mh[keep])
                                         and np.array_equal(t, mt[keep])
                                         and np.array_equal(r, mr[keep])):
            fail(f"{label}: the excluded top-K is not the masked list "
                 f"without its known edges")
    cpu_model = TransE_l2Model(device="cpu", gamma=t_gamma)
    cpu_model.load(transe)
    cpu_model.attach_graph(ds)
    cpu_res = cpu_model.link_predict(
        exclude_mode="exclude", **{**kw, "head": heads[:SERVE_CUT],
                                   "topk": SERVE_K + 1})
    del cpu_model
    hold_to_cpu(label, (np.concatenate([np.stack(b[:3], 1) for b in res]),
                        np.concatenate([b[3] for b in res])),
                [(np.stack(b[:3], 1), b[3]) for b in cpu_res], t_gamma)
    print(f"  {label}: {dropped} known edges excluded ahead of the "
          f"{SERVE_HEADS} x {SERVE_K} results")
    serving_busy(model, kw)
    serving_ties(model)
    del model
    torch.cuda.empty_cache()
    print(f"serving phase: {time.perf_counter() - t_phase:.1f} s, the CPU "
          f"checks included")
    return paths


def serving_busy(model, kw) -> None:
    """The device's busy share over one link_predict (exclude) under
    torch.profiler: kernel time over the call's host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.link_predict(exclude_mode="exclude", **kw)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kern = _kernel_events(prof)
        if kern:
            break
        print("  (torch.profiler returned no device event; tracing again)")
    else:
        fail("torch.profiler recorded no device time over link_predict")
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    print(f"link_predict exclude under torch.profiler: {wall:.3f} ms host, "
          f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%, idle "
          f"{100 - 100 * busy / wall:.1f}%), "
          f"{sum(e.count for e in kern)} kernels")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  {e.self_device_time_total / 1e3:.4f} ms x{e.count}  "
              f"{e.key[:90]}")


def serving_ties(model) -> None:
    """Exact ties on the card: three copies of the best tail of (head 7,
    relation 3) planted in the entity table.  The copies score the same,
    bit for bit; the top 2 and the top 4 (the boundary inside the tie and
    after it) list them lower id first; and the cosine neighbours of the
    row list it and its copies lower id first too."""
    ent = model.entity_embed.cpu().numpy()
    rel = model.relation_embed.cpu().numpy()
    (_, _, best, _, _), = model.link_predict(head=[7], rel=[3], topk=1)
    best = int(best[0])
    copies = sorted({(best + k * 4099) % N_ENT for k in (1, 2, 3)})
    ent[copies] = ent[best]
    model.load_emb(ent, rel)
    group = sorted([best, *copies])
    for k in (2, 4):
        (_, _, t, s, _), = model.link_predict(head=[7], rel=[3], topk=k)
        if t.tolist() != group[:k] or len(set(s.tolist())) != 1:
            fail(f"planted ties (link_predict top {k}): tails {t.tolist()} "
                 f"scores {s.tolist()}, expected {group[:k]} tied")
        (_, r, s), = model.embed_sim(left=[best], sfunc="cosine", topk=k)
        if r.tolist() != group[:k] or len(set(s.tolist())) != 1:
            fail(f"planted ties (embed_sim top {k}): {r.tolist()} "
                 f"{s.tolist()}, expected {group[:k]} tied")
    print(f"planted ties on the card: entity {best} and copies {copies} "
          f"score the same bit for bit and come lower id first in the top "
          f"2 and 4 (link_predict and cosine embed_sim)")


# ---------------------------------------------------------------------------
# The ogbl-wikikg2 path


def _wikikg2_dataset():
    """A synthetic dataset at ogbl-wikikg2's published shape (cut as
    WIKI_TRAIN and WIKI_TEST say)."""
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    return synthetic_dataset(n_entities=WIKI_ENT, n_relations=WIKI_REL,
                             n_train=WIKI_TRAIN, n_valid=1000,
                             n_test=WIKI_TEST, seed=0, name="wikikg2")


def _serve_as_ogb(ds) -> None:
    """Register an `ogb.linkproppred` module whose LinkPropPredDataset
    serves ``ds`` in ogb's layout (the edge split dicts; num_nodes and an
    [E, 1] edge_reltype), so that the CLI loads it through its ogb loader:
    the script needs neither the `ogb` package nor the wikikg2 files."""
    import types

    class LinkPropPredDataset:
        def __init__(self, name, root):
            if name != "ogbl-wikikg2":
                fail(f"the ogb stand-in serves ogbl-wikikg2, not {name}")

        def get_edge_split(self):
            return {split: dict(zip(("head", "relation", "tail"),
                                    getattr(ds, split)))
                    for split in ("train", "valid", "test")}

        def __getitem__(self, i):
            return {"num_nodes": ds.n_entities,
                    "edge_reltype": ds.train[1][:, None]}

    ogb = types.ModuleType("ogb")
    ogb.linkproppred = types.ModuleType("ogb.linkproppred")
    ogb.linkproppred.LinkPropPredDataset = LinkPropPredDataset
    sys.modules["ogb"] = ogb
    sys.modules["ogb.linkproppred"] = ogb.linkproppred


def phase_wikikg2():
    """The ogbl-wikikg2 TransE_l2 recipe through the CLI on the card, at
    the published shape, with the recipe's sampled eval (--test
    --neg_sample_size_eval 500, unfiltered); returns (launch counts, the
    dataset, the trained model and state)."""
    ds = _wikikg2_dataset()
    _serve_as_ogb(ds)
    steps = MAIN_STEPS
    argv = ["--dataset", "wikikg2", "--data_path", WORK, "--format",
            "built_in", *_recipe_flags(WIKI), "--max_step", str(steps),
            "--log_interval", str(steps // 4), "--no_eval_filter", "--test",
            "--batch_size_eval", str(WIKI_EVAL_BATCH),
            "--neg_sample_size_eval", str(WIKI_EVAL_NEG), "--no_save_emb",
            "--save_path", os.path.join(WORK, "ckpts")]
    counts, text, model, state = run_cli("wikikg2", argv)
    mrr = _floats(r"\[0\]Test average MRR: (\S+)", text)
    train_s = _floats(r"training takes (\S+) seconds", text)
    eval_s = _floats(r"\[0\]Test takes (\S+) seconds", text)
    losses = _floats(r"average loss: (\S+)", text)
    if len(mrr) != 1 or not 0.0 < mrr[0] <= 1.0:
        fail(f"wikikg2 main path: test MRR {mrr} outside (0, 1]")
    if f"|Train|: {WIKI_TRAIN}" not in text:
        fail("wikikg2 main path: the ogb loader did not serve the dataset")
    print(f"wikikg2 main path [{WIKI_ENT} x {WIKI['hidden_dim']} entity "
          f"table, {tuple(state.entity.emb.shape)} "
          f"{str(state.entity.emb.dtype)[6:]}]: {steps} steps, "
          f"{steps * WIKI['batch_size'] / train_s[0]:.1f} triples/s (host "
          f"clock over the whole loop, first step included), sampled test "
          f"eval of {WIKI_TEST} triples x 2 modes {eval_s[0]:.3f} s, MRR "
          f"{mrr[0]!r}, last loss {losses[-1]:.4f}; launches {counts}")
    return counts, ds, model, state


def phase_sampled_ranks(ds, model, state, n_batches: int = 8):
    """The sampled ranks of the first test batches in both modes on the
    card (one grouped call, as the eval makes it) against the CPU: the
    rows are gathered on the card, only they are copied to the CPU, and
    the CPU ranks them with the same row-level core.  Ranks must be equal
    but on rows with a near tie (a kept score within TIE_RTOL (|pos| +
    gamma) of the positive score); the counts of those rows and of the rows
    within POS_RTOL |pos| are printed."""
    import torch
    from itertools import islice
    from dglke_tpu_torch.data.sampler import EvalSampler
    from dglke_tpu_torch.models.ke_model import KEModel
    from dglke_tpu_torch.ops import rows
    cfg = model.config
    cpu = KEModel(cfg, ds.n_entities, ds.n_relations, device="cpu")
    sf = cpu.score_fn
    dev = state.entity.emb.device
    for mode in ("head", "tail"):
        sampler = EvalSampler(ds, "test", cfg.batch_size_eval, mode, None,
                              seed=cfg.seed,
                              neg_sample_size=cfg.neg_sample_size_eval)
        batches = list(islice(sampler, n_batches))
        neg_head = mode == "head"

        def stack(k, batches=batches):
            return torch.as_tensor(np.stack([b[k] for b in batches]),
                                   device=dev)

        h, r, t, neg = (stack(k) for k in ("h", "r", "t", "neg"))
        got = model.eval_ranks_sampled(state, h, r, t, neg, None,
                                       neg_head=neg_head).cpu()
        g, b = h.shape
        ent = rows.gather_rows(state.entity.emb, torch.cat(
            [h.reshape(-1), t.reshape(-1), neg.reshape(-1)]),
            cpu.entity_dim).cpu()
        rel = rows.gather_rows(state.relation.emb, r.reshape(-1),
                               cpu.relation_dim).cpu()
        h_rows, t_rows = ent[:g * b], ent[g * b:2 * g * b]
        neg_rows = ent[2 * g * b:]
        want = cpu._rows_eval_ranks_sampled(
            h_rows.reshape(g, b, -1), t_rows.reshape(g, b, -1),
            rel.reshape(g, b, -1), None, neg_rows.reshape(g, -1,
                                                          h_rows.shape[1]),
            None, neg_head=neg_head)
        pos = sf.pos_score(h_rows, rel, t_rows).reshape(g, b, 1)
        s = sf.neg_score(t_rows if neg_head else h_rows, rel, neg_rows,
                         neg_head=neg_head, num_chunks=g, chunk_size=b,
                         neg_sample_size=neg.shape[1]).reshape(g, b, -1)
        gap = (s - pos).abs()
        near = (gap <= TIE_RTOL * (pos.abs() + cfg.gamma)).any(-1)
        near_pos = (gap <= POS_RTOL * pos.abs()).any(-1)
        differ = got != want
        if bool((differ & ~near).any()):
            fail(f"sampled ranks ({mode}): {int(differ.sum())} rows differ "
                 f"from the CPU's, {int((differ & ~near).sum())} of them "
                 f"with no near tie")
        print(f"sampled ranks ({mode}), first {g} test batches of {b} x "
              f"{neg.shape[1]} negatives: {int((~differ).sum())} of {g * b} "
              f"equal to the CPU's, {int(differ.sum())} differing, all at "
              f"near ties; rows with a score within {POS_RTOL} |pos| of "
              f"pos: {int(near_pos.sum())}, within {TIE_RTOL} (|pos| + "
              f"gamma): {int(near.sum())}")


def _candidates(ds, seed: int = 0):
    """A wikikg90M-style candidate split over the test triples: CAND_K
    uniform candidates a query with its true tail at t_correct_index.
    Every 4th row lists the answer twice (after it), every 4th from the
    second lists another candidate twice: exact ties."""
    rng = np.random.RandomState(seed)
    h, r, t = (x[:CAND_QUERIES] for x in ds.test)
    cand = rng.randint(0, ds.n_entities, (CAND_QUERIES, CAND_K))
    ans = rng.randint(0, CAND_K - 1, CAND_QUERIES)
    cand[np.arange(CAND_QUERIES), ans] = t
    cand[0::4, CAND_K - 1] = t[0::4]
    cand[1::4, CAND_K - 1] = cand[1::4, 3]
    return {"h,r->t": {"hr": np.stack([h, r], axis=1),
                       "t_candidate": cand, "t_correct_index": ans}}


def phase_candidates(model, state, ds):
    """The candidate protocol on the trained state: CAND_QUERIES queries x
    CAND_K candidates through evaluate_candidates in Valid and in Test
    mode on the card, then the same rows scored and ranked on the CPU (the
    tables copied there).  Exact ties: the card must score the two copies
    of a candidate listed twice the same, bit for bit, rank an answer
    listed twice at 3 or worse, and list tied copies lower position first.
    Ranks and top-10 positions must equal the CPU's but on rows with a
    near tie on the CPU (another candidate, a copy included, within
    TIE_RTOL (|score| + gamma) of the score compared: the CPU's dot may
    round a copy apart).  The fused route (evaluate_candidates: its first
    run captures, a second replays) and the per-batch route
    (per_batch_candidates) are timed.  The fused route's ranks and top-10
    must equal, on every row, those of the card's own scores of the
    batches at the fused route's call shape (the tail batch padded as
    candidate_outputs pads it, with copies of the split's first query:
    the split is one chunk), and the exact-tie checks hold on the fused
    route's outputs."""
    import pickle
    import torch
    from dglke_tpu_torch.models.ke_model import (
        KEModel,
        candidate_ranks,
        candidate_top,
        metrics_from_ranks,
    )
    from dglke_tpu_torch.trainer import (
        CandidateEvalSampler,
        candidate_outputs,
        evaluate_candidates,
    )
    cfg = model.config
    sampler = CandidateEvalSampler(_candidates(ds), cfg.batch_size_eval)
    quiet = lambda *a: None  # noqa: E731
    t0 = time.perf_counter()
    with _RankLog() as rank_log:
        metrics = evaluate_candidates(model, state, sampler, mode="Valid",
                                      log=quiet)
    valid_s = time.perf_counter() - t0
    (fused_ranks,) = rank_log.ranks
    out_dir = os.path.join(WORK, "candidates")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    evaluate_candidates(model, state, sampler, mode="Test",
                        save_path=out_dir, log=quiet)
    test_s = time.perf_counter() - t0
    with open(os.path.join(out_dir, "test_0.pkl"), "rb") as f:
        top_card = pickle.load(f)["h,r->t"]["t_pred_top10"]
    if top_card.shape != (CAND_QUERIES, 10) or top_card.dtype != np.int32:
        fail(f"candidate Test pkl: {top_card.shape} {top_card.dtype}")
    routes = {}
    for top in (False, True):
        for route in ("fused", "per-batch"):
            t0 = time.perf_counter()
            if route == "fused":
                candidate_outputs(model.eval_calls, state, sampler, top=top,
                                  phase="Test" if top else "Valid")
            else:
                per_batch_candidates(model, state, sampler, top)
            torch.cuda.synchronize()
            routes[("Test" if top else "Valid", route)] = (
                time.perf_counter() - t0)

    cpu = KEModel(cfg, ds.n_entities, ds.n_relations, device="cpu")
    cpu_state = _cpu_copy(state)
    hr = torch.from_numpy(sampler.hr)
    cand = torch.from_numpy(sampler.cand)
    ans = torch.from_numpy(sampler.ans).long()
    s_card, s_cpu = [], []
    b = cfg.batch_size_eval
    # the fused route's batches: the tail padded to a whole batch with
    # copies of the split's first query
    at = torch.cat([torch.arange(CAND_QUERIES),
                    torch.zeros(-CAND_QUERIES % b, dtype=torch.long)])
    for beg in range(0, CAND_QUERIES, b):
        sl = slice(beg, beg + b)
        rows = at[beg:beg + b]
        s_card.append(model.candidate_scores(
            state, hr[rows, 0].cuda(), hr[rows, 1].cuda(),
            cand[rows].cuda()).cpu()[:len(hr[sl])])
        s_cpu.append(cpu.candidate_scores(cpu_state, hr[sl, 0], hr[sl, 1],
                                          cand[sl]))
    del cpu_state
    s_card, s_cpu = torch.cat(s_card), torch.cat(s_cpu)
    card_ranks = candidate_ranks(s_card, ans)
    if metrics_from_ranks(card_ranks.numpy()) != metrics:
        fail("candidate Valid metrics differ from the card's own ranks")
    for what, bad in (
            ("ranks", fused_ranks != card_ranks.numpy()),
            ("top-10", (top_card != candidate_top(s_card).numpy()).any(1))):
        if bad.any():
            fail(f"candidate {what}: the fused route differs from the "
                 f"card's own scores at its call shape on {int(bad.sum())} "
                 f"rows (rows {np.nonzero(bad)[0][:5].tolist()})")

    # exact ties on the card
    rows_a = torch.arange(0, CAND_QUERIES, 4)       # the answer twice
    rows_b = torch.arange(1, CAND_QUERIES, 4)       # candidate 3 twice
    last = CAND_K - 1
    n_dup = len(rows_a) + len(rows_b)
    copies = {dev: int((s[rows_a, last] == s[rows_a, ans[rows_a]]).sum()
                       + (s[rows_b, last] == s[rows_b, 3]).sum())
              for dev, s in (("card", s_card), ("cpu", s_cpu))}
    if copies["card"] != n_dup:
        fail(f"candidate scores: the card scores {copies['card']} of {n_dup} "
             f"candidates listed twice the same")
    if not (fused_ranks[rows_a.numpy()] >= 3).all():
        fail("candidate ranks: an answer listed twice ranked above 3")
    for i in rows_b.tolist():
        tied = [int(p) for p in top_card[i] if p in (3, last)]
        if tied != sorted(tied):
            fail(f"candidate top-10 row {i}: tied copies out of order {tied}")

    # the card against the CPU
    near_rank, near_top = _candidate_near_ties(s_cpu, ans, cfg.gamma)
    bad_rank = card_ranks != candidate_ranks(s_cpu, ans)
    bad_top = torch.from_numpy((top_card != candidate_top(s_cpu).numpy())
                               .any(1))
    for what, bad, near in (("ranks", bad_rank, near_rank),
                            ("top-10", bad_top, near_top)):
        if bool((bad & ~near).any()):
            rows = torch.nonzero(bad & ~near).flatten().tolist()[:5]
            fail(f"candidate {what}: {int(bad.sum())} rows differ from the "
                 f"CPU's, {int((bad & ~near).sum())} of them with no near "
                 f"tie (rows {rows})")
    print(f"candidate protocol [{CAND_QUERIES} queries x {CAND_K} "
          f"candidates, {len(rows_a)} rows listing the answer twice, "
          f"{len(rows_b)} another candidate twice]: Valid MRR "
          f"{metrics['MRR']!r} in {valid_s:.3f} s, Test top-10 pkl in "
          f"{test_s:.3f} s; copies scored the same: card {copies['card']}, "
          f"CPU {copies['cpu']} of {n_dup}; max |score card - CPU| "
          f"{float((s_card - s_cpu).abs().max()):.3g} (scores "
          f"{float(s_cpu.min()):.3f} to {float(s_cpu.max()):.3f}); against "
          f"the CPU: ranks {int((~bad_rank).sum())} equal, "
          f"{int(bad_rank.sum())} differing, all at near ties "
          f"({int(near_rank.sum())} rows with one); top-10 "
          f"{int((~bad_top).sum())} equal, {int(bad_top.sum())} differing, "
          f"all at near ties ({int(near_top.sum())} rows with one)")
    print(f"candidate protocol, both routes [{card_line()}]: "
          + "; ".join(f"{mode} fused {routes[(mode, 'fused')]:.4f} s "
                      f"(graphs replayed), per-batch "
                      f"{routes[(mode, 'per-batch')]:.4f} s"
                      for mode in ("Valid", "Test")))


def _candidate_near_ties(s, ans, gamma: float):
    """Rows of candidate scores ``s`` [N, K] with a near tie (within
    TIE_RTOL (|score| + gamma)): at the answer's score (another candidate,
    a copy included), and among the top 11 scores."""
    import torch
    n = s.shape[0]
    tol = TIE_RTOL * (s.abs() + gamma)
    pos = torch.gather(s, 1, ans[:, None])
    gap = (s - pos).abs()
    gap[torch.arange(n), ans] = float("inf")
    near_rank = (gap <= torch.gather(tol, 1, ans[:, None])).any(1)
    srt = torch.sort(s, dim=1, descending=True).values[:, :11]
    near_top = ((srt[:, :-1] - srt[:, 1:])
                <= TIE_RTOL * (srt[:, 1:].abs() + gamma)).any(1)
    return near_rank, near_top


def phase_wiki_kernels(state):
    """K1 and the whole K2 call at the wikikg2 path's entity shape (1,536
    ids over the 2,500,604 x 500 fp32 table, 5.0 GB), cold in L2: each call
    takes the next of 64 id batches (uniform, 197 MB of distinct rows in
    all, four times the L2), in turns beside index_select / index_add_ and
    the plain versions, with the bounds.  Returns the numbers for the JSON
    line."""
    import itertools
    import torch
    from dglke_tpu_torch.ops import rows
    emb, ss = state.entity.emb, state.entity.state_sum
    dev, dim = emb.device, emb.shape[1]
    gen = torch.Generator(dev)
    gen.manual_seed(5)
    pool = [torch.randint(0, WIKI_ENT, (WIKI_ENT_IDS,), generator=gen,
                          device=dev, dtype=torch.int32) for _ in range(64)]
    pool64 = [ids.long() for ids in pool]
    grads = torch.randn((WIKI_ENT_IDS, dim), generator=gen, device=dev) * 0.1
    uniq = float(np.mean([torch.unique(x).numel() for x in pool]))
    n = WIKI_ENT_IDS

    def cycling(fn, ids_pool):
        it = itertools.cycle(ids_pool)
        return lambda: fn(next(it))

    for ids in pool[:2]:
        if not torch.equal(rows.gather_rows(emb, ids, dim),
                           rows.gather_rows_plain(emb, ids, dim)):
            fail("K1 at the wikikg2 shape: differs from its plain version")
    k1 = _in_turns({
        "kernel": cycling(lambda i: rows.gather_rows(emb, i, dim), pool),
        "index_select": cycling(lambda i: torch.index_select(emb, 0, i),
                                pool64),
        "plain": cycling(lambda i: rows.gather_rows_plain(emb, i, dim),
                         pool)}, iters=64)
    k1_bytes = n * 4 + uniq * dim * 4 + n * dim * 4
    k1_bound, k1_by = bound_ms(k1_bytes, 0)
    k2 = _in_turns({
        "kernel": cycling(lambda i: rows.sparse_adagrad_rows(
            emb, ss, i, grads, LR), pool),
        "index_add_": cycling(lambda i: emb.index_add_(0, i, grads), pool64),
        "plain": cycling(lambda i: rows.sparse_adagrad_plain(
            emb, ss, i, grads, LR), pool)}, iters=64)
    split = device_ms_by_kernel(cycling(lambda i: rows.sparse_adagrad_rows(
        emb, ss, i, grads, LR), pool), iters=64)
    k2_bytes = n * 4 + n * dim * 4 + 2 * uniq * dim * 4 + 2 * uniq * 4
    k2_bound, k2_by = bound_ms(k2_bytes, 3 * n * dim + 3 * uniq * dim)
    print(f"K1 gather_rows at the wikikg2 shape [{n} ids ({uniq:.1f} "
          f"distinct on average) over {WIKI_ENT} x {dim} fp32, cold L2], "
          f"device ms in turns: " + ", ".join(f"{k} {v:.5f}"
                                             for k, v in k1.items())
          + f"; bound {k1_bound:.6f} ({k1_by}, {k1_bytes / 1e6:.3f} MB), "
          f"{100 * k1_bound / k1['kernel']:.1f}% of it; "
          f"{'not slower' if k1['kernel'] <= k1['index_select'] else 'SLOWER'}"
          f" than index_select")
    print(f"K2 sparse_adagrad_rows at the wikikg2 shape [{n} ids over "
          f"{WIKI_ENT} x {dim} fp32, cold L2], device ms in turns: "
          + ", ".join(f"{k} {v:.5f}" for k, v in k2.items())
          + "; the kernel call by kernel: " + ", ".join(
              f"{k[:40]} {v:.5f}" for k, v in split.items())
          + f"; bound {k2_bound:.6f} ({k2_by}, {k2_bytes / 1e6:.3f} MB), "
          f"{100 * k2_bound / k2['kernel']:.1f}% of it; "
          f"{'not slower' if k2['kernel'] <= k2['index_add_'] else 'SLOWER'}"
          f" than index_add_ (the add alone)")
    return ({"wikikg2_ms": k1["kernel"], "wikikg2_plain_ms": k1["plain"],
             "wikikg2_library_ms": k1["index_select"],
             "wikikg2_bound_ms": k1_bound},
            {"wikikg2_ms": k2["kernel"], "wikikg2_plain_ms": k2["plain"],
             "wikikg2_library_ms": k2["index_add_"],
             "wikikg2_bound_ms": k2_bound})


# ---------------------------------------------------------------------------
# Phase 6b: host-resident tables (--mix_cpu_gpu)


def pcie_bytes_per_s() -> float:
    """The host link's rate each way, from the generation and width the
    card reports (nvidia-smi, printed): 4 GB/s a lane at Gen5 (64 GB/s at
    x16), half that a generation down.  The link idles at a lower
    generation, so the maximum is taken.  Where nvidia-smi reports the link
    as [N/A], the H100's host interface by its data sheet: PCIe Gen5 x16."""
    q = ("pcie.link.gen.current,pcie.link.width.current,"
         "pcie.link.gen.max,pcie.link.width.max")
    out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip()
    print(f"PCIe link (nvidia-smi --query-gpu={q}):\n  "
          + out.replace("\n", "\n  "))
    vals = [v.strip() for v in out.splitlines()[1].split(",")]
    gen, width = ((int(vals[2]), int(vals[3])) if vals[2].isdigit()
                  and vals[3].isdigit() else (5, 16))
    rate = 4e9 / 2 ** (5 - gen) * width
    print(f"  bound taken at Gen{gen} x{width}: {rate / 1e9:.0f} GB/s each "
          f"way")
    return rate


def host_ms(fn, iters: int = 20) -> float:
    """Mean ms of fn() on the host clock, synchronised at both ends."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def check_k2_mapped(label: str, table, ss0, ids, grads, adagrad: bool):
    """K2 on a mapped host table (and its mapped state_sum), given K1's
    rows at the ids as the host step gives them, against its plain version
    on CPU copies of the same inputs: within K2_RTOL / K2_ATOL; two runs
    bit-identical; untouched rows unchanged.  table and ss0 are numpy
    arrays, ids and grads on the card."""
    import torch
    from dglke_tpu_torch.ops import rows

    def run(mapped):
        emb = rows.host_zeros(table.shape)
        emb[...] = table
        state = None
        if adagrad:
            state = rows.host_zeros(ss0.shape)
            state[...] = ss0
        if not mapped:
            emb_t = torch.from_numpy(emb)
            ss_t = torch.from_numpy(state) if adagrad else None
            i, g = ids.cpu(), grads.cpu()
            if adagrad:
                rows.sparse_adagrad_plain(emb_t, ss_t, i, g, LR)
            else:
                rows.scatter_add_plain(emb_t, i, g)
        else:
            emb_t = rows.map_host(emb)
            ss_t = rows.map_host(state) if adagrad else None
            got = rows.gather_rows(emb_t, ids)
            if adagrad:
                rows.sparse_adagrad_rows(emb_t, ss_t, ids, grads, LR,
                                         rows=got)
            else:
                rows.scatter_add_rows(emb_t, ids, grads, rows=got)
        torch.cuda.synchronize()
        # plain copies: the mapped ranges are released with the arrays
        return (emb_t.clone(), None if ss_t is None else ss_t.clone())

    (ep, sp) = run(False)
    name = "sparse_adagrad_rows" if adagrad else "scatter_add_rows"
    what = f"K2 {name} {label} on a mapped host table"
    ek, sk = run(True)
    err = float((ek - ep).abs().max())
    if not torch.allclose(ek, ep, rtol=K2_RTOL, atol=K2_ATOL):
        fail(f"{what}: max |diff| {err} outside rtol {K2_RTOL} atol "
             f"{K2_ATOL}")
    if adagrad and not torch.allclose(sk, sp, rtol=K2_RTOL, atol=K2_ATOL):
        fail(f"{what} state_sum: max |diff| {float((sk - sp).abs().max())}")
    e2, s2 = run(True)
    if not (torch.equal(e2, ek) and (not adagrad or torch.equal(s2, sk))):
        fail(f"{what}: two runs differ")
    untouched = torch.ones(table.shape[0], dtype=torch.bool)
    untouched[ids.long().cpu()] = False
    base = torch.from_numpy(table)
    if not bool(untouched.any()) or not torch.equal(ek[untouched],
                                                    base[untouched]):
        fail(f"{what}: no untouched row, or one changed")
    print(f"{what} [{ids.numel()} ids, {table.shape[0]} x {table.shape[1]}, "
          f"{rows.plan_update(table.shape[1])}], from K1's rows: within "
          f"rtol {K2_RTOL} / atol {K2_ATOL} of plain (max |diff| "
          f"{err:.3g}); two runs bit-identical; untouched rows unchanged")
    return err


def host_facts(arrays) -> str:
    """The host facts the mapped kernels' times move with: what pages back
    ``arrays`` (and the transparent huge page mode), and the IOMMU units
    the host lists."""
    from dglke_tpu_torch.ops import rows
    try:
        units = sorted(os.listdir("/sys/class/iommu")) or "none listed"
    except OSError:
        units = "no /sys/class/iommu"
    return (f"host facts: mapped tables {rows.host_pages(arrays)}; IOMMU "
            f"units: {units}")


# Id sets a timing cycles through on a mapped table: a step's ids are new
# every step, and the same ids call after call keep their translations
# warm on the card, which flatters a shape on a large table.
FRESH_SETS = 16


def fresh_ids(ids, n_rows: int, sets: int = FRESH_SETS) -> list:
    """``ids`` and sets - 1 more of its size, uniform over n_rows rows."""
    import torch
    gen = torch.Generator(ids.device)
    gen.manual_seed(sets)
    return [ids] + [torch.randint(0, n_rows, ids.shape, generator=gen,
                                  device=ids.device, dtype=ids.dtype)
                    for _ in range(sets - 1)]


def cycling(fn, args: list):
    """A callable that calls fn on the next of ``args`` each time."""
    it = [0]

    def call():
        it[0] += 1
        return fn(*args[it[0] % len(args)])
    return call


def _time_k2(table, ss_t, id_sets, grads, iters: int) -> float:
    """ms a call of K2 on a mapped table on CUDA events, each call on the
    next of ``id_sets`` and given K1's rows at those ids, gathered once
    before (each call updates the table in place)."""
    from dglke_tpu_torch.ops import rows
    args = [(i, rows.gather_rows(table, i)) for i in id_sets]
    return call_ms(cycling(lambda i, got: rows.sparse_adagrad_rows(
        table, ss_t, i, grads, LR, rows=got), args), iters=iters, warmup=2)


MAPPED_SWEEP = (1, 3, 100, 384, 401, 2047, 5000)


def mapped_shape_sweep() -> None:
    """K1's mapped shape bit-equal to its plain version on small mapped
    tables in fp32 and bf16, at the widths MAPPED_SWEEP, each in a table
    whose pitch is 5 elements above the width and whose memory starts 16
    bytes past a line, at ids that include the first and the last row (the
    windows at the table's two ends)."""
    import torch
    from dglke_tpu_torch.ops import rows
    n_rows = 300
    for dtype in (torch.float32, torch.bfloat16):
        for width in MAPPED_SWEEP:
            pitch = width + 5
            size = torch.tensor([], dtype=dtype).element_size()
            raw = rows.host_zeros((n_rows * pitch * size + 16,), np.uint8)
            table = torch.from_numpy(raw[16:]).view(dtype).view(n_rows, pitch)
            table.copy_(torch.randn(n_rows, pitch).to(dtype))
            tab_t = rows.map_host(raw)
            ids = torch.cat([torch.tensor([0, n_rows - 1]),
                             torch.randint(0, n_rows, (998,))]).int()
            for dim in (width, max(1, width - 2)):
                got = rows.launch_gather(table[:, :width], ids.cuda(), dim,
                                         "mapped",
                                         rows.mapped_address(table))
                torch.cuda.synchronize()
                if not torch.equal(got.cpu(), rows.gather_rows_plain(
                        table[:, :width], ids, dim)):
                    fail(f"K1 mapped shape, {dtype} width {width} dim {dim} "
                         f"pitch {pitch}: differs from its plain version")
            del tab_t, table, raw
    gc.collect()
    print(f"K1 mapped shape on mapped tables in fp32 and bf16 at widths "
          f"{MAPPED_SWEEP} (pitch + 5, memory 16 B past a line, the first "
          f"and last rows among the ids): bit-equal to plain")


def phase_host_kernels():
    """K1 and K2 on tables in mapped host memory (rows.map_host of
    rows.host_zeros arrays, as host mode places them), held to their plain
    versions on the same inputs: K1 at the flagship's 3,000 ids x 400 and
    on 1,000 of TransR's 160,000-wide projection rows, in the mapped shape
    (whole lines through shared memory) and the shape a table on the card
    takes, timed in turns on CUDA events, at the flagship on fresh ids each
    call (fresh_ids); at the flagship the mapped shape also on the same
    table in numpy's own memory (16 bytes off a line), in turns.  K2 from
    K1's rows (a warp per segment at the flagship; a block per segment on
    the projection rows), Adagrad and the plain row add, held to plain and
    timed.  Each is timed beside its bound over the host link, its
    plain version on the CPU, the JAX package's design written in PyTorch
    (the staging route: index_select into a pinned buffer and one copy to
    the card; the gradients copied back and the plain update on the CPU),
    and the copy engine's rate for the whole mapped table.  Returns the two
    kernels' JSON entries."""
    import torch
    from dglke_tpu_torch.ops import rows
    link = pcie_bytes_per_s()
    mapped_shape_sweep()
    _, ent_ids, rel_ids = _flagship_ids(0)
    dev = ent_ids.device
    rng = np.random.default_rng(4)
    ent_np = (rng.standard_normal((N_ENT, DIM), np.float32) * 0.05)
    ss_np = rng.random(N_ENT, np.float32)
    proj_np = rng.standard_normal((N_REL, DIM * DIM), np.float32)
    proj_ss = rng.random(N_REL, np.float32)
    out = {}
    for label, tab_np, ss, ids in (
            ("flagship entity", ent_np, ss_np, ent_ids),
            ("TransR projection", proj_np, proj_ss, rel_ids)):
        width = tab_np.shape[1]
        t0 = time.time()
        host = rows.host_zeros(tab_np.shape)
        host[...] = tab_np
        table = rows.map_host(host)
        reg_s = time.time() - t0
        ss_host = rows.host_zeros(ss.shape)
        ss_host[...] = ss
        ss_t = rows.map_host(ss_host)
        print(host_facts([host, ss_host]))
        ids_cpu = ids.cpu()
        want = rows.gather_rows_plain(table, ids_cpu, width)
        chosen = rows.gather_shape(width, mapped=True)
        # the chosen shape and the one a card table takes
        shapes = (chosen, rows.gather_shape(width))
        for shape in shapes:
            got = rows.launch_gather(table, ids, width, shape,
                                     rows.mapped_address(table))
            torch.cuda.synchronize()
            if not torch.equal(got.cpu(), want):
                fail(f"K1 {shape} on a mapped {label} table: differs from "
                     f"its plain version")
            del got
        if not torch.equal(rows.gather_rows(table, ids, width).cpu(), want):
            fail(f"K1 gather_rows on a mapped {label} table: differs")
        # CUDA events around back-to-back calls: each call is device-bound
        # (the link), and torch.profiler's device trace of kernels on
        # mapped memory came back empty or partial on the card
        iters = 50 if width < rows.GATHER_WIDE_MIN else 5
        # fresh ids a call at the flagship, as a step gathers them
        id_sets = (fresh_ids(ids, tab_np.shape[0])
                   if width < rows.GATHER_WIDE_MIN else [ids])
        sets = [(i,) for i in id_sets]
        fns = {s: cycling(lambda i, s=s: rows.launch_gather(
            table, i, width, s, rows.mapped_address(table)), sets)
            for s in shapes}
        placed = None
        if width < rows.GATHER_WIDE_MIN:
            # the same rows in numpy's own memory, as tables were placed
            # before host_zeros
            placed = np.empty(tab_np.shape, np.float32)
            placed[...] = tab_np
            np_table = rows.map_host(placed)
            if not torch.equal(rows.gather_rows(np_table, ids, width).cpu(),
                               want):
                fail(f"K1 on a mapped {label} table in numpy's memory: "
                     f"differs")
            fns[f"{chosen}, numpy's memory (+{placed.ctypes.data % 128} B)"] \
                = cycling(lambda i: rows.gather_rows(np_table, i, width),
                          sets)
        ms = {s: [] for s in fns}
        for s in (*fns, *reversed(fns)):
            ms[s].append(call_ms(fns[s], iters=iters, warmup=2))
        ms = {s: sum(v) / len(v) for s, v in ms.items()}
        del fns
        if placed is not None:
            del np_table, placed
        k1 = ms[chosen]
        plain = host_ms(lambda: rows.gather_rows_plain(table, ids_cpu,
                                                       width), iters=iters)
        pinned = torch.empty((ids.numel(), width), pin_memory=True)
        staged_out = torch.empty((ids.numel(), width), device=dev)
        ids64 = ids_cpu.long()

        def staged():
            torch.index_select(table, 0, ids64, out=pinned)
            staged_out.copy_(pinned, non_blocking=True)
        staged_ms = host_ms(staged, iters=iters)
        del pinned, staged_out
        # the copy engine's rate for a plain copy of the whole mapped table
        # (the full-entity host eval's block uploads): the link's practical
        # ceiling on this machine
        whole = torch.empty(table.shape, device=dev)
        copy_ms = call_ms(lambda: whole.copy_(table, non_blocking=True),
                          iters=iters // 5 or 1, warmup=1)
        del whole
        copy_rate = table.numel() * 4 / copy_ms / 1e6
        uniq = int(torch.unique(ids_cpu).numel())
        link_bytes = uniq * width * 4
        hbm_bytes = ids.numel() * 4 + ids.numel() * width * 4
        bound = max(link_bytes / link * 1e3, hbm_bytes / HBM_BYTES_PER_S * 1e3)
        print(f"K1 gather_rows on a mapped {label} table [{ids.numel()} ids "
              f"({uniq} distinct), {tab_np.shape[0]} x {width} fp32 in host "
              f"memory, mapped in {reg_s:.3f} s], shape {chosen}: exact; "
              f"ms per call {k1:.5f} (CUDA events; in turns: "
              + ", ".join(f"{s} {v:.5f}" for s, v in ms.items()) + ")"
              + f"; bound {bound:.5f} (bytes: {link_bytes / 1e6:.3f} MB over "
              f"the link), {100 * bound / k1:.1f}% of it, "
              f"{link_bytes / k1 / 1e6:.2f} GB/s; plain on the CPU "
              f"{plain:.4f} ms; staging route (index_select into pinned + "
              f"copy) {staged_ms:.4f} ms on the host clock; the copy engine "
              f"on the whole mapped table {copy_ms:.4f} ms "
              f"({copy_rate:.2f} GB/s)")
        if ms[chosen] > min(ms[s] for s in shapes):
            print(f"  note: {chosen} is not the faster shape here")
        # K2 on the same table: Adagrad and the plain row add
        grads = torch.randn((ids.numel(), width), device=dev) * 0.1
        err = max(check_k2_mapped(label, tab_np, ss, ids, grads, True),
                  check_k2_mapped(label, tab_np, None, ids, grads, False))
        k2 = _time_k2(table, ss_t, id_sets, grads, iters)
        got = rows.gather_rows(table, ids)
        k2_split = device_ms_by_kernel(lambda: rows.sparse_adagrad_rows(
            table, ss_t, ids, grads, LR, rows=got),
            iters=iters) or {"no trace": 0.0}
        del got
        g_cpu, ss_cpu = grads.cpu(), torch.from_numpy(ss.copy())
        cpu_tab = table.clone()
        k2_plain = host_ms(lambda: rows.sparse_adagrad_plain(
            cpu_tab, ss_cpu, ids_cpu, g_cpu, LR), iters=3)
        g_pin = torch.empty(grads.shape, pin_memory=True)

        def staged_k2():
            g_pin.copy_(grads)
            rows.sparse_adagrad_plain(cpu_tab, ss_cpu, ids_cpu, g_pin, LR)
        k2_staged = host_ms(staged_k2, iters=3)
        del g_pin, cpu_tab
        k2_link = uniq * (width + 1) * 4        # each way
        k2_hbm = ids.numel() * (width + 1) * 4
        k2_bound = max(k2_link / link * 1e3, k2_hbm / HBM_BYTES_PER_S * 1e3)
        print(f"K2 sparse_adagrad_rows on a mapped {label} table, from "
              f"K1's rows: ms per call {k2:.5f} (CUDA events; "
              f"torch.profiler by kernel: "
              + ", ".join(f"{k[:40]} {v:.5f}" for k, v in k2_split.items())
              + f"); bound {k2_bound:.5f} (bytes: {k2_link / 1e6:.3f} MB "
              f"each way over the link), {100 * k2_bound / k2:.1f}% of it; "
              f"plain on the CPU {k2_plain:.4f} ms; staging route (gradients "
              f"to pinned memory + the plain update on the CPU) "
              f"{k2_staged:.4f} ms on the host clock")
        out[label] = dict(k1=k1, k1_plain=plain, k1_bound=bound,
                          k1_staged=staged_ms, k2=k2, k2_plain=k2_plain,
                          k2_bound=k2_bound, k2_staged=k2_staged, err=err,
                          shapes=ms, copy=copy_rate)
        del table, ss_t, grads, host, ss_host
    gc.collect()
    if rows._mapped:
        fail(f"mapped ranges left after the phase: {len(rows._mapped)}")
    f, p = out["flagship entity"], out["TransR projection"]
    common = {"route": "cuda", "source": "dglke_tpu_torch/ops/csrc/rows.cu",
              "launches": None, "bound_by": "bytes", "paths": HOST_PATHS}
    return [
        {"name": "gather_rows (mapped host table)",
         "counter": "gather_rows", "shape": rows.gather_shape(DIM, True),
         "replaces": "dglke_tpu/ops/pallas/rows.py:89", "max_abs_err": 0.0,
         "ms": f["k1"], "plain_ms": f["k1_plain"], "bound_ms": f["k1_bound"],
         "library_ms": f["k1_staged"],
         "copy_engine_gb_s": f["copy"], "transr_projection_ms": p["k1"],
         "transr_projection_bound_ms": p["k1_bound"],
         "transr_projection_library_ms": p["k1_staged"],
         "shapes_ms": f["shapes"], "transr_projection_shapes_ms": p["shapes"],
         **common},
        {"name": "sparse_adagrad_rows (mapped host table)",
         "counter": "sparse_adagrad_rows",
         "replaces": "dglke_tpu/ops/pallas/rows.py:227",
         "max_abs_err": max(f["err"], p["err"]), "ms": f["k2"],
         "plain_ms": f["k2_plain"], "bound_ms": f["k2_bound"],
         "library_ms": f["k2_staged"], "transr_projection_ms": p["k2"],
         "transr_projection_bound_ms": p["k2_bound"],
         "transr_projection_library_ms": p["k2_staged"], **common},
    ]


class _RankLog:
    """Keeps the rank arrays every eval hands to
    trainer.combine_rank_metrics (the device path's and the host path's)
    while active."""

    def __init__(self):
        self.ranks = []

    def __enter__(self):
        from dglke_tpu_torch import trainer
        self.real = trainer.combine_rank_metrics

        def keep(ranks, *args, **kwargs):
            self.ranks.append(np.asarray(ranks).copy())
            return self.real(ranks, *args, **kwargs)
        trainer.combine_rank_metrics = keep
        return self

    def __exit__(self, *exc):
        from dglke_tpu_torch import trainer
        trainer.combine_rank_metrics = self.real


def phase_host_main():
    """The flagship through dglke_tpu_torch-train with --mix_cpu_gpu (the
    TransE_l2 recipe, 1,000 steps, the filtered full-entity test eval) with
    its launch counts held to EXPECTED_LAUNCHES; then its checkpoint
    through dglke_tpu_torch-eval twice: adopting host mode from its
    config.json, and with --no_mix_cpu_gpu on the card.  The three filtered
    rank arrays must be identical.  Returns the launch counts."""
    from dglke_tpu_torch.cli import eval as eval_cli
    data = _fb15k_shaped("data", n_train=300_000)
    save = os.path.join(WORK, "host_ckpts")
    argv = ["--dataset", "fb15k_shaped", *_udd_args(data),
            *_recipe_flags(TRANSE), "--max_step", str(MAIN_STEPS),
            "--log_interval", str(MAIN_STEPS // 4), "--batch_size_eval",
            "500", "--test", "--mix_cpu_gpu", "--save_path", save]
    ranks = _RankLog()
    with ranks:
        counts, text, _, state = run_cli("TransE_l2 host", argv)
    if "pinned and mapped for cuda" not in text:
        fail("host main path: the tables were not mapped for the card")
    if type(state).__name__ != "HostState" or state.entity.emb.is_cuda:
        fail("host main path: the trained tables are not in host memory")
    mrr = _floats(r"\[0\]Test average MRR: (\S+)", text)
    train_s = _floats(r"training takes (\S+) seconds", text)
    eval_s = _floats(r"\[0\]Test takes (\S+) seconds", text)
    print(f"TransE_l2 host main path: {MAIN_STEPS} steps, "
          f"{MAIN_STEPS * BATCH / train_s[0]:.1f} triples/s (host clock over "
          f"the whole loop, first step included), test eval {eval_s[0]:.3f} "
          f"s, MRR {mrr[0]!r}; launches {counts}")
    ckpt = os.path.join(save, "TransE_l2_fb15k_shaped_0")
    for extra, host in (((), True), (("--no_mix_cpu_gpu",), False)):
        out = io.StringIO()
        t0 = time.time()
        with ranks, contextlib.redirect_stdout(out):
            _cli(eval_cli.main, [*_udd_args(data), "--model_path", ckpt,
                                 "--batch_size_eval", "500", *extra])
        said = "host-resident tables" in out.getvalue()
        if said != host:
            fail(f"dglke_tpu_torch-eval {' '.join(extra)}: host mode "
                 f"{said}, expected {host}")
        how = " ".join(extra) or "(adopts the saved mix_cpu_gpu)"
        mrr = _floats(r"Test average MRR: (\S+)", out.getvalue())
        said = re.findall(r"\[0\]Test eval CUDA graphs: .*",
                          out.getvalue())
        if len(said) != 1:
            fail(f"dglke_tpu_torch-eval {how}: eval graph lines {said}")
        print(f"dglke_tpu_torch-eval {how}: {time.time() - t0:.3f} s, "
              f"{'host' if host else 'device'} tables, MRR {mrr}; "
              f"{said[0]}")
    if len(ranks.ranks) != 3 or not all(
            np.array_equal(ranks.ranks[0], r) for r in ranks.ranks[1:]):
        fail(f"host main path: filtered ranks differ between the training "
             f"run's host eval, the eval CLI in host mode and on the card "
             f"({[len(r) for r in ranks.ranks]} rows)")
    print(f"filtered ranks of {len(ranks.ranks[0])} rows identical: the "
          f"training run's host eval, dglke_tpu_torch-eval adopting host "
          f"mode, and dglke_tpu_torch-eval --no_mix_cpu_gpu on the card")
    return counts


def _host_copy(model, state, device: str):
    """A HostState of fresh numpy copies of ``state``'s tables, mapped
    when ``device`` is the card."""
    from dglke_tpu_torch import host_table
    import torch

    def table(t):
        return None if t is None else host_table._host_embedding(
            t.emb.numpy().copy(), t.state_sum.numpy().copy(),
            torch.device(device))

    return host_table.HostState(table(state.entity), table(state.relation),
                                table(state.projection), state.step)


def phase_host_step_parity(recipe: dict):
    """One host step in each corruption direction on the card (K1 and K2
    on mapped tables) and on the CPU (the plain versions), from identical
    tables and the same TrainSampler batches: every table, Adagrad state
    and the loss within rtol 1e-4 / atol 1e-5, as phase_step_parity."""
    import torch
    from dglke_tpu_torch import host_table
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    from dglke_tpu_torch.data.sampler import TrainSampler
    from dglke_tpu_torch.models.ke_model import KEModel
    cfg = KGEConfig(**recipe, mix_cpu_gpu=True)
    gpu_model = KEModel(cfg, N_ENT, N_REL, device="cuda")
    cpu_model = KEModel(cfg, N_ENT, N_REL, device="cpu")
    cpu_state = host_table.init_host_state(cpu_model, seed=1)
    gpu_state = _host_copy(gpu_model, cpu_state, "cuda")
    ds = synthetic_dataset(N_ENT, N_REL, n_train=100_000, seed=0)
    sampler = TrainSampler(ds, cfg.batch_size, cfg.neg_sample_size, seed=1)
    for _ in range(2):
        batch = next(sampler)
        glog = host_table.host_step(gpu_model, gpu_state, batch)
        clog = host_table.host_step(cpu_model, cpu_state, batch)
        torch.cuda.synchronize()
        pairs = [("loss", glog["loss"].cpu(), clog["loss"])]
        for name in ("entity", "relation"):
            g, c = getattr(gpu_state, name), getattr(cpu_state, name)
            pairs += [(f"{name} emb", g.emb, c.emb),
                      (f"{name} state_sum", g.state_sum, c.state_sum)]
        side = "head" if batch["neg_head"] else "tail"
        for what, a, b in pairs:
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-5):
                fail(f"host step parity ({side}): {what} differs by "
                     f"{float((a - b).abs().max())}")
    print(f"TransE_l2 host step parity [{N_ENT} x {N_REL}]: two steps (batch "
          f"{cfg.batch_size}) on mapped host tables on the card match the "
          f"CPU's plain path within rtol 1e-4 / atol 1e-5")
    del gpu_state, cpu_state
    gc.collect()


def phase_host_profile(label: str, model, state, ds, steps: int = 50,
                       routes=("graph", "eager")):
    """Where a host-fed step's time goes (one TrainSampler batch a step: on
    host tables when ``state`` is a HostState, else the host-fed route on
    tables on the card), on both routes in turn: the fed call ("graph": one
    CUDA graph replayed a step, fed by a trainer.HostFeed as the trainers
    feed it) and the eager step ("eager": the batch sampled inline, then
    host_step, or on the host-fed route the fed call's group function
    called eagerly).  For each, the host clock over ``steps`` steps after
    as many to warm up, then torch.profiler over ``steps`` more for the
    device's busy share and the kernels by device time; then the two side
    by side.  Returns {route: (host ms per step, busy share)}."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dglke_tpu_torch import host_table
    from dglke_tpu_torch.data.sampler import TrainSampler
    from dglke_tpu_torch.models.fed_step import FedStep, pack_batch
    from dglke_tpu_torch.trainer import HostFeed
    cfg = model.config
    host = getattr(state, "is_host", False)
    out = {}
    for route in routes:
        calls = [0]
        if route == "graph":
            feed = HostFeed(model, ds, cfg.batch_size, cfg.neg_sample_size,
                            seed=2)
            fused = (host_table.host_fed_step(model) if host
                     else FedStep(model, 1))

            def one():
                fused(state, feed.take(1), state.step)
        else:
            sampler = TrainSampler(ds, cfg.batch_size, cfg.neg_sample_size,
                                   seed=2)
            eager = FedStep(model, 1)

            def one():
                if host:
                    host_table.host_step(model, state, next(sampler))
                else:
                    eager._stage([pack_batch(next(sampler), True)])
                    eager.group(state)

        def run(n):
            for _ in range(n):
                one()
            calls[0] += n
            torch.cuda.synchronize()

        run(steps)
        t0 = time.perf_counter()
        run(steps)
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                run(steps)
            kern = _kernel_events(prof)
            if kern:
                break
            print("  (torch.profiler returned no device event; tracing "
                  "again)")
        busy = sum(e.self_device_time_total for e in kern) / 1e3 / steps
        n_kern = sum(e.count for e in kern) / steps
        if route == "graph":
            feed.close()
            launched = sum(e.count for e in prof.key_averages()
                           if e.key == "cudaGraphLaunch") / steps
            if (len(fused.graphs), fused.replays) != (2, calls[0] - 1) \
                    or launched != 1:
                fail(f"{label} profile: {len(fused.graphs)} graphs, "
                     f"{fused.replays} replays, {launched} graph launches "
                     f"a step")
        print(f"{label} step profile, {route} route [batch "
              f"{cfg.batch_size}; {card_line()}]: {step_ms:.4f} ms per step "
              f"on the host clock ({cfg.batch_size * 1e3 / step_ms:.1f} "
              f"triples/s); device busy {busy:.4f} ms per step "
              f"({100 * busy / step_ms:.1f}%, idle "
              f"{100 - 100 * busy / step_ms:.1f}%); {n_kern:.1f} kernels per "
              f"step")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  {e.self_device_time_total / 1e3 / steps:.4f} ms/step "
                  f"x{e.count / steps:.1f}  {e.key[:90]}")
        out[route] = (step_ms, busy, n_kern)
    if len(out) == 2:
        (hg, dg, kg), (he, de, ke) = out["graph"], out["eager"]
        print(f"{label} step, CUDA graph against eager [{card_line()}]: "
              f"host {hg:.4f} / {he:.4f} ms, device busy {dg:.4f} / "
              f"{de:.4f} ms, busy share {100 * dg / hg:.1f}% / "
              f"{100 * de / he:.1f}%, kernels {kg:.1f} / {ke:.1f} a step")
    return {k: (v[0], v[1] / v[0]) for k, v in out.items()}


def phase_host_flagship_profile():
    """The host step profile at the flagship shape: fresh host tables of
    14,951 x 400 and 1,345 x 400, mapped, on 100,000 train edges."""
    from dglke_tpu_torch import host_table
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    from dglke_tpu_torch.models.ke_model import KEModel
    model = KEModel(KGEConfig(**TRANSE, mix_cpu_gpu=True), N_ENT, N_REL,
                    device="cuda")
    state = host_table.init_host_state(model, seed=0)
    ds = synthetic_dataset(N_ENT, N_REL, n_train=100_000, seed=0)
    phase_host_profile("TransE_l2 host", model, state, ds)
    del state
    gc.collect()


def phase_fed_profile():
    """The host-fed step profile at the flagship shape, s = 1 (the route of
    phase 4's s = 1 run, C6): tables on the card, 100,000 train edges."""
    import torch
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    from dglke_tpu_torch.models.ke_model import KEModel
    model = KEModel(KGEConfig(**TRANSE), N_ENT, N_REL, device="cuda")
    state = model.init_state()
    ds = synthetic_dataset(N_ENT, N_REL, n_train=100_000, seed=0)
    phase_host_profile("TransE_l2 host-fed s = 1", model, state, ds)
    del state, model
    torch.cuda.empty_cache()


def _write_freebase(path: str) -> None:
    """A dataset in the port's Freebase layout (data/dataset.py:
    _load_freebase): count-only entity2id.txt / relation2id.txt, integer
    triples in h-t-r order; the triples from synthetic_dataset at
    FB_ENT x FB_REL."""
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    ds = synthetic_dataset(n_entities=FB_ENT, n_relations=FB_REL,
                           n_train=FB_TRAIN, n_valid=1000, n_test=FB_TEST,
                           seed=0, name="Freebase")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "entity2id.txt"), "w") as f:
        f.write(f"{FB_ENT}\n")
    with open(os.path.join(path, "relation2id.txt"), "w") as f:
        f.write(f"{FB_REL}\n")
    for split in ("train", "valid", "test"):
        h, r, t = getattr(ds, split)
        np.savetxt(os.path.join(path, f"{split}.txt"),
                   np.stack([h, t, r], axis=1), fmt="%d", delimiter="\t")


def _meminfo_gb(key: str) -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def phase_capacity_parity(model, state, ds):
    """K1 and K2 held to their plain versions on the capacity run's trained
    tables in mapped host memory (the entity table FB_ENT x 400, larger
    than the card).  K1 gathers N_ENT_IDS entity ids drawn over all FB_ENT
    rows, among them the rows on both sides of byte offset FAR_OFFSET
    (4 GiB) and the last row, and 1,000 relation ids: bit-equal to the host's
    own rows at those ids.  Then one host step (host_table.host_step) of a
    TrainSampler batch, whose entity ids run over the 26 bits of FB_ENT - 1
    that the grouping sorts: the touched entity and relation rows and
    their state_sum entries must match sparse_adagrad_plain applied, with
    the step's row gradients (KEModel.loss_and_grads on the same tables
    and batch), to CPU copies of only those rows, ids remapped to compact
    indices, within K2_RTOL / K2_ATOL; 1,000 rows of each table that the
    step does not touch stay bit-equal."""
    import torch
    from dglke_tpu_torch import host_table
    from dglke_tpu_torch.data.sampler import TrainSampler
    from dglke_tpu_torch.models.fed_step import pack_batch, unpack_batch
    from dglke_tpu_torch.ops import rows
    from dglke_tpu_torch.ops.embedding import gather_rows
    rng = np.random.default_rng(5)
    past_4g = -(-FAR_OFFSET // (model.entity_dim * 4))   # first row past it
    if past_4g >= FB_ENT:
        fail(f"capacity run: the entity table ends before byte offset "
             f"{FAR_OFFSET}")
    picks = {"entity": np.concatenate([
        [0, past_4g - 1, past_4g, FB_ENT - 1],
        rng.integers(0, FB_ENT, N_ENT_IDS - 4)]),
        "relation": rng.integers(0, FB_REL, 1000)}
    for name, ids in picks.items():
        table = getattr(state, name)
        ids = torch.from_numpy(ids.astype(np.int32))
        got = gather_rows(table, ids.cuda(), table.emb.shape[1])
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), table.emb[ids.long()]):
            fail(f"capacity run: K1 on the mapped {name} table differs from "
                 f"its rows on the host")
    print(f"capacity run: K1 on the mapped tables, {N_ENT_IDS} entity ids "
          f"over all {FB_ENT} rows (rows {past_4g - 1} and {past_4g} on both "
          f"sides of byte offset {FAR_OFFSET}, row {FB_ENT - 1}) and 1,000 "
          f"relation "
          f"ids: bit-equal to the host's rows")

    cfg = model.config
    batch = next(iter(TrainSampler(ds, cfg.batch_size, cfg.neg_sample_size,
                                   seed=3)))
    packed, _, neg_head, b = pack_batch(batch, pin=False)
    h, r, t, neg = unpack_batch(packed.cuda(), b)
    _, _, (ent_ids, g_ent, g_rel, _) = model.loss_and_grads(
        state, h, r, t, neg, None, neg_head=neg_head)
    updates = [(state.entity, ent_ids, g_ent), (state.relation, r, g_rel)]
    torch.cuda.synchronize()
    held = []
    for table, ids, grads in updates:
        uniq, inv = torch.unique(ids.long().cpu(), return_inverse=True)
        other = rng.integers(0, table.emb.shape[0], 1000)
        other = torch.from_numpy(other[~np.isin(other, uniq.numpy())])
        held.append((uniq, inv, grads.cpu(), table.emb[uniq].clone(),
                     table.state_sum[uniq].clone(), other,
                     table.emb[other].clone()))
    host_table.host_step(model, state, batch)
    torch.cuda.synchronize()
    for name, (table, ids, _), (uniq, inv, g, emb, ss, other, rest) in zip(
            ("entity", "relation"), updates, held):
        rows.sparse_adagrad_plain(emb, ss, inv, g, cfg.lr)
        got_emb, got_ss = table.emb[uniq], table.state_sum[uniq]
        err = float((got_emb - emb).abs().max())
        if not (torch.allclose(got_emb, emb, rtol=K2_RTOL, atol=K2_ATOL)
                and torch.allclose(got_ss, ss, rtol=K2_RTOL, atol=K2_ATOL)):
            fail(f"capacity run: the host step's {name} rows differ from "
                 f"sparse_adagrad_plain by {err} (state_sum "
                 f"{float((got_ss - ss).abs().max())})")
        if not torch.equal(table.emb[other], rest):
            fail(f"capacity run: the host step changed untouched {name} "
                 f"rows")
        print(f"capacity run: one host step's {name} write-back ({len(ids)} "
              f"ids, {len(uniq)} rows, ids up to {int(uniq.max())}, "
              f"{int(uniq.max()).bit_length()} bits) within rtol {K2_RTOL} "
              f"/ atol {K2_ATOL} of sparse_adagrad_plain on CPU copies of "
              f"the touched rows (max |diff| {err:.3g}); {len(other)} "
              f"untouched rows unchanged")
    capacity_kernels(state.entity, cfg.lr, rng)


def capacity_kernels(ent, lr: float, rng) -> None:
    """K1 and K2 on the capacity run's entity table, on CUDA events, at
    N_ENT_IDS random ids over all FB_ENT rows: K1 bit-equal to the host's
    rows; K2 from K1's rows changes the touched rows (restored after), then
    is timed with zero gradients, which leave every bit of the table as it
    was."""
    import torch
    from dglke_tpu_torch.ops import rows
    print(host_facts([ent.emb.numpy(), ent.state_sum.numpy()]))
    ids = torch.from_numpy(rng.integers(0, FB_ENT, N_ENT_IDS).astype(
        np.int32)).cuda()
    width = ent.emb.shape[1]
    ids_cpu = ids.long().cpu()
    if not torch.equal(rows.gather_rows(ent.emb, ids).cpu(),
                       ent.emb[ids_cpu]):
        fail("capacity run: K1 differs from the host's rows")
    id_sets = fresh_ids(ids, FB_ENT)
    k1 = call_ms(cycling(lambda i: rows.gather_rows(ent.emb, i),
                         [(i,) for i in id_sets]), iters=50, warmup=2)
    grads = torch.randn((N_ENT_IDS, width), device="cuda") * 0.1
    uniq = torch.unique(ids_cpu)
    saved = (ent.emb[uniq].clone(), ent.state_sum[uniq].clone())
    rows.sparse_adagrad_rows(ent.emb, ent.state_sum, ids, grads, lr,
                             rows=rows.gather_rows(ent.emb, ids))
    torch.cuda.synchronize()
    if torch.equal(ent.emb[uniq], saved[0]):
        fail("capacity run: K2 changed no row")
    ent.emb[uniq], ent.state_sum[uniq] = saved
    touched = torch.unique(torch.cat(id_sets).long().cpu())
    before = ent.emb[touched]
    k2 = _time_k2(ent.emb, ent.state_sum, id_sets, torch.zeros_like(grads),
                  50)
    torch.cuda.synchronize()
    if not (torch.equal(ent.emb[uniq], saved[0])
            and torch.equal(ent.state_sum[uniq], saved[1])
            and torch.equal(ent.emb[touched], before)):
        fail("capacity run: zero gradients changed the table")
    print(f"capacity run: on the {FB_ENT} x {width} mapped table, "
          f"{N_ENT_IDS} random ids ({len(uniq)} distinct) over all rows, "
          f"fresh ones each call from {len(id_sets)} sets, ms a call (CUDA "
          f"events): K1 {rows.gather_shape(width, True)} {k1:.5f} "
          f"(bit-equal to the host's rows); K2 from K1's rows {k2:.5f}")


# The full eval's window of blocks traced for its copy / math / idle split
# (phase_capacity): HOST_WINDOW block calls from the HOST_WINDOW_AT-th.
HOST_WINDOW_AT, HOST_WINDOW = 1000, 64


def _union_us(spans) -> float:
    """Microseconds covered by the union of (start, end) spans."""
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _window_split(model, run, label: str) -> dict:
    """``run()`` (a full host eval on ``model``) with torch.profiler
    tracing the card over its block calls [HOST_WINDOW_AT, + HOST_WINDOW):
    the window's device timeline, from its first device event to its last,
    split into copy (the staging copies), math (the kernels), both at once,
    and idle.  Returns the split in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    calls = model.eval_calls
    real = calls.host_block
    seen = [0]
    prof = profile(activities=[ProfilerActivity.CUDA])

    def block(*args, **kwargs):
        if seen[0] == HOST_WINDOW_AT:
            prof.start()
        real(*args, **kwargs)
        seen[0] += 1
        if seen[0] == HOST_WINDOW_AT + HOST_WINDOW:
            torch.cuda.synchronize()
            prof.stop()

    calls.host_block = block
    try:
        run()
    finally:
        del calls.host_block
    if seen[0] < HOST_WINDOW_AT + HOST_WINDOW:
        fail(f"{label}: {seen[0]} block calls, under the traced window")
    path = os.path.join(WORK, "host_eval_window.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    spans = {"kernel": [], "gpu_memcpy": []}
    for e in events:
        if e.get("cat") in spans and "dur" in e:
            spans[e["cat"]].append((float(e["ts"]),
                                    float(e["ts"]) + float(e["dur"])))
    every = spans["kernel"] + spans["gpu_memcpy"]
    if not spans["kernel"] or not spans["gpu_memcpy"]:
        fail(f"{label}: the window's trace holds {len(spans['kernel'])} "
             f"kernels and {len(spans['gpu_memcpy'])} copies")
    wall = max(b for _, b in every) - min(a for a, _ in every)
    copy, math_, busy = (_union_us(x) for x in (
        spans["gpu_memcpy"], spans["kernel"], every))
    out = {"wall": wall / 1e3, "copy": copy / 1e3, "math": math_ / 1e3,
           "both": (copy + math_ - busy) / 1e3, "idle": (wall - busy) / 1e3,
           "kernels": len(spans["kernel"]),
           "copies": len(spans["gpu_memcpy"])}
    print(f"{label}, blocks {HOST_WINDOW_AT}-"
          f"{HOST_WINDOW_AT + HOST_WINDOW - 1} traced [{card_line()}]: "
          f"{out['wall']:.3f} ms of device timeline "
          f"({out['wall'] / HOST_WINDOW:.4f} a block): copy "
          f"{out['copy']:.3f} ms, math {out['math']:.3f} ms, "
          f"both at once {out['both']:.3f} ms, idle {out['idle']:.3f} ms "
          f"({100 * out['idle'] / out['wall']:.1f}%; busy "
          f"{100 * busy / wall:.1f}%); {out['kernels']} kernels, "
          f"{out['copies']} copies")
    return out


def capacity_full_eval(cfg, ds, model, state, table: int) -> None:
    """The capacity run's filtered full-entity host eval (FB_FULL_EVAL
    test triples x 2 modes against all FB_ENT entities) on both routes:
    the graph route (the model's eval calls, its memo fresh) and the eager
    baseline (eager_calls), each timed once whole and once with a window
    of blocks traced (_window_split); their ranks must be equal in all
    four evals.  Then one block's staging copy timed alone."""
    import torch
    from dglke_tpu_torch.host_table import evaluate_host
    from dglke_tpu_torch.models.eval_step import EvalCalls
    out, ranks = {}, []
    for route in ("graph", "eager"):
        model.eval_calls = (EvalCalls(model) if route == "graph"
                            else eager_calls(model))
        lines = []

        def run():
            with _RankLog() as log:
                m = evaluate_host(cfg, ds, model, state, "test",
                                  log=lines.append)
            torch.cuda.synchronize()
            ranks.extend(log.ranks)
            return m

        t0 = time.perf_counter()
        m = run()
        full_s = time.perf_counter() - t0
        calls = model.eval_calls
        blocks = sum(n for k, n in calls.keys.items()
                     if k[0] == "host_block")
        (rows_, width), = calls.staging
        split = _window_split(model, run, f"capacity run: full eval, "
                                          f"{route} route")
        out[route] = (full_s, split)
        said = [x for x in lines if "eval CUDA graphs" in x]
        print(f"capacity run: filtered full-entity host eval, {route} "
              f"route [{card_line()}]: {FB_FULL_EVAL} test triples x 2 "
              f"modes against {FB_ENT} entities in {full_s:.3f} s ({blocks} "
              f"blocks of {rows_} rows); the table streamed through the "
              f"card once at {table / full_s / 1e9:.2f} GB/s (eval "
              f"seconds included); "
              f"MRR {m['MRR']!r}, HITS@10 {m['HITS@10']!r}; "
              f"{said or 'no graph line'}")
        if route == "graph" and (calls.captured < 2 or not said):
            fail(f"capacity run: the full eval captured {calls.captured} "
                 f"graphs ({said})")
    if len(ranks) != 4 or not all(np.array_equal(ranks[0], r)
                                  for r in ranks[1:]):
        fail("capacity run: the full eval's ranks differ between the "
             "routes or the runs")
    (gs, gw), (es, ew) = out["graph"], out["eager"]
    print(f"capacity run: full eval, CUDA graph against eager "
          f"[{card_line()}]: {gs:.3f} / {es:.3f} s, {table / gs / 1e9:.2f} / "
          f"{table / es / 1e9:.2f} GB/s; window busy "
          f"{100 * (1 - gw['idle'] / gw['wall']):.1f}% / "
          f"{100 * (1 - ew['idle'] / ew['wall']):.1f}%, device ms a block "
          f"{gw['wall'] / HOST_WINDOW:.4f} / {ew['wall'] / HOST_WINDOW:.4f}; "
          f"{len(ranks[0])} ranks equal in all four evals")
    # one block's staging copy alone, from rows across the table
    buf = model.eval_calls.staging[(rows_, width)][0]
    emb = state.entity.emb
    starts = np.linspace(0, FB_ENT - rows_, 20).astype(np.int64)
    buf.copy_(emb[:rows_], non_blocking=True)
    torch.cuda.synchronize()
    begin = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    begin.record()
    for a in starts:
        buf.copy_(emb[int(a):int(a) + rows_], non_blocking=True)
    end.record()
    end.synchronize()
    ms = begin.elapsed_time(end) / len(starts)
    print(f"capacity run: one block's staging copy alone [{card_line()}]: "
          f"{rows_} x {width} fp32 ({rows_ * width * 4} B) in {ms:.4f} ms, "
          f"{rows_ * width * 4 / ms / 1e6:.2f} GB/s (CUDA events, "
          f"{len(starts)} blocks across the table)")


def phase_capacity():
    """The Freebase TransE_l2 recipe (examples/freebase.sh:8-11) with
    --mix_cpu_gpu through dglke_tpu_torch-train --dataset Freebase
    --format built_in, at FB_ENT entities x 400 fp32: an entity table
    larger than the card's memory, in host memory, mapped for the card.
    Then K1 and K2 held to their plain versions on those tables
    (phase_capacity_parity), a 50-step profile after 50, and a filtered
    full-entity host eval of FB_FULL_EVAL test triples over the same
    table.  The card's peak allocation over all of it must stay under
    HOST_PEAK_CEILING.  Returns the launch counts of the CLI run."""
    import dataclasses
    import resource
    import torch
    card = torch.cuda.get_device_properties(0).total_memory
    table = FB_ENT * FB["hidden_dim"] * 4
    print(f"capacity run: entity table {FB_ENT} x {FB['hidden_dim']} fp32 = "
          f"{table} bytes ({table / 1e9:.2f} GB) against the card's "
          f"{card} bytes ({card / 1e9:.2f} GB), {table / card:.3f}x; host "
          f"MemTotal {_meminfo_gb('MemTotal'):.2f} GB, MemAvailable "
          f"{_meminfo_gb('MemAvailable'):.2f} GB; RLIMIT_MEMLOCK (ulimit -l) "
          f"{resource.getrlimit(resource.RLIMIT_MEMLOCK)}")
    if table <= card:
        fail(f"capacity run: the entity table ({table} B) is not larger "
             f"than the card ({card} B)")
    # why the host tables are not allocated by torch's pinned allocator:
    # it rounds a request up (to a power of two in the versions seen)
    ask = (3 << 30) + 4096
    pinned = torch.empty(ask, dtype=torch.uint8, pin_memory=True)
    held = torch.cuda.host_memory_stats()["allocated_bytes.current"]
    print(f"  torch's pinned allocator: a request of {ask} bytes holds "
          f"{held} bytes ({held / ask:.3f}x)")
    del pinned
    getattr(torch._C, "_host_emptyCache", lambda: None)()
    t0 = time.time()
    _write_freebase(os.path.join(WORK, "Freebase"))
    print(f"  Freebase layout written in {time.time() - t0:.1f} s "
          f"({FB_TRAIN} train, {FB_TEST} test triples)")
    argv = ["--dataset", "Freebase", "--data_path", WORK, "--format",
            "built_in", *_recipe_flags(FB), "--max_step", str(MAIN_STEPS),
            "--log_interval", str(MAIN_STEPS // 4), "--test",
            "--batch_size_eval", str(FB_EVAL_BATCH),
            "--neg_sample_size_eval", str(FB_EVAL_NEG), "--no_save_emb",
            "--mix_cpu_gpu", "--save_path", os.path.join(WORK, "ckpts")]
    torch.cuda.reset_peak_memory_stats()
    trained = {}
    counts, text, model, state = run_cli("Freebase host", argv, trained)
    init = re.search(r"host tables: (\d+) bytes drawn in (\S+) s; (.+?) in "
                     r"(\S+) s; (.+)", text)
    if init.group(3) != "pinned and mapped for cuda":
        fail("capacity run: the tables were not mapped for the card")
    train_s = _floats(r"training takes (\S+) seconds", text)
    eval_s = _floats(r"\[0\]Test takes (\S+) seconds", text)
    mrr = _floats(r"\[0\]Test average MRR: (\S+)", text)
    if len(mrr) != 1 or not 0.0 < mrr[0] <= 1.0:
        fail(f"capacity run: sampled test MRR {mrr} outside (0, 1]")
    print(f"capacity run: host tables of {init.group(1)} bytes drawn in "
          f"{init.group(2)} s ({int(init.group(1)) / max(float(init.group(2)), 1e-3) / 1e9:.2f}"
          f" GB/s), pinned and mapped in {init.group(4)} s, "
          f"{init.group(5)}; {MAIN_STEPS} "
          f"steps in {train_s[0]:.3f} s ({MAIN_STEPS * FB['batch_size'] / train_s[0]:.1f}"
          f" triples/s, host clock, first step included); sampled test eval "
          f"({FB_TEST} triples x 2 modes, {FB_EVAL_NEG} negatives, filtered) "
          f"{eval_s[0]:.3f} s, MRR {mrr[0]!r}; launches {counts}")
    ds = trained["dataset"]
    phase_capacity_parity(model, state, ds)
    phase_host_profile("Freebase host", model, state, ds)
    cfg = dataclasses.replace(trained["config"], neg_sample_size_eval=-1,
                              eval_percent=FB_FULL_EVAL / FB_TEST)
    capacity_full_eval(cfg, ds, model, state, table)
    peak = torch.cuda.max_memory_allocated()
    print(f"capacity run: the card's peak allocation over the run, the "
          f"profile and the full eval {peak} bytes ({peak / 1e9:.3f} GB; "
          f"ceiling {HOST_PEAK_CEILING / 1e9:.3f} GB, the table "
          f"{table / 1e9:.2f} GB)")
    if peak > HOST_PEAK_CEILING:
        fail(f"capacity run: {peak} bytes allocated on the card, above the "
             f"ceiling {HOST_PEAK_CEILING}")
    del state, model, ds, trained
    gc.collect()
    return counts


def phase_chunked_save(model, state):
    """The chunked save (utils/io.py:_save_table) of the wikikg2 path's
    2,500,604 x 500 fp32 entity table on the card, and of a bf16 copy of
    it: each read back with np.load, the fp32 one bit-equal to the card's
    table and the bf16 one equal to its fp32 upcast; the card's allocation
    during each save stays under one chunk (_STREAM_CHUNK)."""
    import dataclasses
    import torch
    from dglke_tpu_torch.models.ke_model import TrainState
    from dglke_tpu_torch.ops.embedding import EmbeddingState
    from dglke_tpu_torch.utils import io as pt_io
    emb = state.entity.emb
    for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        cfg = dataclasses.replace(model.config, emb_dtype=str(dtype)[6:],
                                  dataset="wikikg2")
        table = emb if dtype == torch.float32 else emb.to(dtype)
        st = TrainState(EmbeddingState(table, state.entity.state_sum),
                        state.relation, step=state.step)
        path = os.path.join(WORK, f"save_{label}")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        pt_io.save_model(cfg, model, st, save_path=path)
        secs = time.time() - t0
        added = torch.cuda.max_memory_allocated() - base
        got = np.load(os.path.join(path, "wikikg2_TransE_l2_entity.npy"),
                      mmap_mode="r")
        if got.shape != tuple(emb.shape) or got.dtype != np.float32:
            fail(f"chunked save {label}: {got.shape} {got.dtype}")
        step = 1 << 18
        for a in range(0, emb.shape[0], step):
            want = table[a:a + step].float().cpu().numpy()
            if not np.array_equal(got[a:a + step], want):
                fail(f"chunked save {label}: rows {a}.. differ from the "
                     f"card's table")
        if added >= pt_io._STREAM_CHUNK:
            fail(f"chunked save {label}: the save allocated {added} bytes "
                 f"on the card, not under one chunk")
        print(f"chunked save of the wikikg2 entity table, {label} "
              f"({tuple(emb.shape)}, {table.numel() * table.element_size() / 1e9:.2f}"
              f" GB on the card, {got.nbytes / 1e9:.2f} GB fp32 npy): "
              f"{secs:.3f} s ({got.nbytes / secs / 1e9:.2f} GB/s), read back "
              f"{'bit-equal to the table' if label == 'fp32' else 'equal to its fp32 upcast'}"
              f"; the card allocated {added} bytes during the save "
              f"(one chunk: {pt_io._STREAM_CHUNK})")
        del got, table, st
        shutil.rmtree(path, ignore_errors=True)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 7c: multi-device training (--dist, dglke_tpu_torch/parallel/)
#
# The machine has one card, and NCCL takes one rank a card, so the ranks of
# these phases share cuda:0 and their collectives run over gloo through
# host memory (parallel/collectives.py); the NCCL route runs at one rank.
# Each rank is a process of its own, started from this script
# (``--dist-worker``) with torch's launcher variables; it calls the normal
# entry points (cli.train.main, or the plan's step for the parity checks)
# and prints one RESULT line: its launch counts, the collective bytes and
# ms and the host ms per step of its training loop, and digests of its
# tables.  None of their numbers is a multi-card number.

DIST_RANKS = 2
DIST_TIMEOUT = 900          # seconds a rank set may take, then killed
DIST_STEPS = 100            # the flagship under --dist, each plan (cut
# from 500 when the bf16, profile and LDG phases joined the script, and
# from 200 when the one-rank NCCL phase grew to the graph route's cases)
DIST_RESCAL_STEPS = 50      # RESCAL under --dist (K3 on every replica; cut
# from 100 with DIST_STEPS)
# wikikg2 under --dist --table_sharding vocab: 100 steps saved every 50
# (--sharded_ckpt), then resumed for 50 more with the recipe's sampled
# test eval (cut from 200, 100 and 100 with DIST_STEPS)
DIST_WIKI_STEPS, DIST_WIKI_EVERY, DIST_WIKI_RESUME = 100, 50, 50
NCCL_STEPS = 100            # --dist on one rank over NCCL, each case
# The direct cases at one NCCL rank (_worker_nccl): the flagship under each
# plan and RESCAL under the vocab plan, NCCL_GROUPS groups of GROUP_S steps
# on the graph route against the group function called eagerly, then
# NCCL_TIMED groups timed on each route.
NCCL_CASES = (("TransE_l2", "vocab"), ("TransE_l2", "replicated"),
              ("RESCAL", "vocab"))
NCCL_GROUPS, NCCL_TIMED = 5, 5
DIST_TIMED = 20             # steps timed after each plan's parity step
DIST_NOTE = ("2 ranks sharing one H100 over host-staged gloo: not a "
             "multi-card number")
# The plan's step against one device's step on the card (shapes differ:
# cuBLAS may take other kernels for the half batch, as for phase 3's step
# against the CPU).
DIST_RTOL, DIST_ATOL = 1e-4, 1e-5
# Launches of each rank, read around its whole CLI run.  A step launches
# K1 twice (the entity rows, on their owner's shard or the rank's replica;
# the relation rows), a grouping and K2 for each table it updates (the
# entity update on the owner's shard, or over the all-gathered list of
# 2 x 3,000 ids on every replica; the relation update over 2 x 1,000), and
# on RESCAL K3 (with its grouping) in place of the relation K2.  The
# flagship's filtered test eval of 2,000 triples at batch 500, a group
# call a mode (trainer._mega_eval, eagerly over gloo): over the
# vocab-sharded table every rank ranks all 4 batches of a mode in one
# call, 2 K1 each (the routed [h | t] rows; the relation rows), scoring its
# own rows in slices; over replicas each rank ranks its stride, 2 batches
# a mode in one call of 4 K1 (h, t, the relation rows and the 14,951
# candidate rows).  wikikg2's sampled test eval of 20,000 triples: every
# rank ranks all 40 groups of batches, 2 K1 each.  On the vocab plan's
# fixed-capacity route every owner launches K1 and K2 on all n x C slots
# it receives, pads included, so the counts do not depend on the ids.  At
# one rank over NCCL (no eval) the steps run in CUDA graph replays, which
# add their capture's counts, and the run without --dist takes the
# single-device graph route: the same counts.
for _label, _k1, _steps in (("TransE_l2 dist vocab", 4, DIST_STEPS),
                            ("TransE_l2 dist replicated", 8, DIST_STEPS),
                            ("wikikg2 dist save", 0, DIST_WIKI_STEPS),
                            ("wikikg2 dist resume", 80, DIST_WIKI_RESUME),
                            ("TransE_l2 nccl", 0, NCCL_STEPS),
                            ("TransE_l2 nccl replicated", 0, NCCL_STEPS),
                            ("TransE_l2 nccl baseline", 0, NCCL_STEPS)):
    EXPECTED_LAUNCHES[_label] = {"gather_rows": 2 * _steps + _k1,
                                 "group_ids": 2 * _steps,
                                 "group_ids_tiles": 0,
                                 "sparse_adagrad_rows": 2 * _steps,
                                 "outer_adagrad_update": 0,
                                 "transe_l2_loss": 2 * _steps}
for _label, _steps in (("RESCAL dist vocab", DIST_RESCAL_STEPS),
                       ("RESCAL nccl", NCCL_STEPS),
                       ("RESCAL nccl baseline", NCCL_STEPS)):
    EXPECTED_LAUNCHES[_label] = {
        "gather_rows": 2 * _steps, "gather_rows_pow_sum": _steps,
        "gather_rows_matvec": _steps, "group_ids": 2 * _steps,
        "group_ids_tiles": 0,
        "sparse_adagrad_rows": _steps, "outer_adagrad_update": _steps,
        "transe_l2_loss": 0}
# WN18's DistMult recipe under --dist (examples/wn18.sh:15-17: batch 2,048,
# 128 negatives, hidden 512, gamma 20, -adv, -rc 1e-6, lr 0.14) at WN18's
# published shape, 40,943 entities and 18 relations (its 141,442 train
# edges; 1,000 valid and 2,000 test triples), on synthetic data made as
# _fb15k_shaped makes FB15k's.  A step gathers 3 x 2,048 entity ids a
# rank, so at 2 ranks each owner (vocab) or replica (replicated) groups
# 12,288 entity ids a step on the grouping's tiles route; the relation
# update over 2 x 2,048 ids stays on the one-block route.  Cut:
# DIST_WN18_STEPS steps a plan (the recipe runs 20,000), no eval.
WN18_ENT, WN18_REL, WN18_TRAIN = 40_943, 18, 141_442
DISTMULT_WN18 = dict(model_name="DistMult", hidden_dim=512, gamma=20.0,
                     lr=0.14, batch_size=2048, neg_sample_size=128,
                     neg_adversarial_sampling=True, regularization_coef=1e-6)
DIST_WN18_STEPS = {"vocab": 50, "replicated": 20}
for _ts, _steps in DIST_WN18_STEPS.items():
    EXPECTED_LAUNCHES[f"DistMult WN18 dist {_ts}"] = {
        "gather_rows": 2 * _steps, "group_ids": _steps,
        "group_ids_tiles": _steps, "sparse_adagrad_rows": 2 * _steps,
        "outer_adagrad_update": 0, "transe_l2_loss": 0}
# The cases of the one-step parity (phase_dist_step_parity): recipe, its
# table sizes, and the tiles-route groupings of a plan's first step on a
# rank (the entity update's, above 8,192 ids) and of one device's.
STEP_CASES = ((TRANSE, N_ENT, N_REL, 0, 0), (RESCAL, N_ENT, N_REL, 0, 0),
              (DISTMULT_WN18, WN18_ENT, WN18_REL, 1, 1))


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(name: str, spec: dict, world: int = DIST_RANKS):
    """Start ``world`` rank processes of this script in worker mode with
    ``spec``, each with torch's launcher variables (ranks on this host, the
    rendezvous on a free localhost port); wait for them under DIST_TIMEOUT
    and kill only the processes started here.  Prints rank 0's output
    and the others' tails; returns each rank's RESULT dict and output."""
    os.makedirs(WORK, exist_ok=True)
    spec_path = os.path.join(WORK, f"dist_{name}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    port = _free_port()
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(world))
        log = open(os.path.join(WORK, f"dist_{name}.rank{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dist-worker",
             spec_path], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT))
    t0 = time.time()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, DIST_TIMEOUT - (time.time() - t0)))
    except subprocess.TimeoutExpired:
        fail(f"dist {name}: the ranks did not finish in {DIST_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for log in logs:
        log.seek(0)
        texts.append(log.read())
        log.close()
    print(f"dist {name}: {world} rank(s), {time.time() - t0:.1f} s")
    for rank, (p, text) in enumerate(zip(procs, texts)):
        shown = text if rank == 0 else "\n".join(text.splitlines()[-4:])
        print("\n".join(f"  [rank {rank}] {ln}" for ln in shown.splitlines()
                        if not ln.startswith("RESULT ")))
        if p.returncode != 0:
            fail(f"dist {name}: rank {rank} exited {p.returncode}")
    out = []
    for rank, text in enumerate(texts):
        lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
        if len(lines) != 1:
            fail(f"dist {name}: rank {rank} printed no result")
        out.append(json.loads(lines[0][len("RESULT "):]))
    return out, texts


def _digest(state) -> dict:
    """blake2b of every table and Adagrad state of a TrainState (this
    rank's part), read to the host in 64 MB chunks, and its step."""
    import hashlib

    import torch
    out = {"step": int(state.step)}
    tables = {"entity": state.entity, "relation": state.relation,
              "projection": state.projection}
    for name, t in tables.items():
        if t is None:
            continue
        for part, x in (("", t.emb), ("_state", t.state_sum)):
            h = hashlib.blake2b(digest_size=16)
            flat = x.reshape(x.shape[0], -1)
            step = max(1, (64 << 20) // max(1, flat[:1].numel() * 4))
            for a in range(0, flat.shape[0], step):
                h.update(flat[a:a + step].contiguous().view(
                    torch.uint8).cpu().numpy().tobytes())
            out[name + part] = h.hexdigest()
    return out


def _worker_cli(spec: dict) -> dict:
    """dglke_tpu_torch-train with spec["argv"] on this rank; its launch
    counts around the whole run, per-step numbers of its training loop,
    digests of the tables it trained (and of those it loaded)."""
    import torch
    from dglke_tpu_torch.cli import train as train_cli
    from dglke_tpu_torch.ops import rows
    if spec.get("ogb"):
        _serve_as_ogb(_wikikg2_dataset())
    seen = {}
    real = {k: getattr(train_cli, k) for k in
            ("init_distributed", "train", "load_sharded")}

    def init(*a, **k):
        seen["comm"] = real["init_distributed"](*a, **k)
        return seen["comm"]

    def train(*a, **k):
        comm = seen["comm"]
        torch.cuda.synchronize()
        comm.reset_counters()
        t0 = time.perf_counter()
        out = real["train"](*a, **k)
        torch.cuda.synchronize()
        seen["train_s"] = time.perf_counter() - t0
        seen["coll"] = comm.counters()
        seen["steps"] = a[0].max_step
        seen["final"] = _digest(out[1])
        return out

    def load(*a, **k):
        state = real["load_sharded"](*a, **k)
        seen["loaded"] = _digest(state)
        return state

    for k, f in (("init_distributed", init), ("train", train),
                 ("load_sharded", load)):
        setattr(train_cli, k, f)
    rows.reset_launches()
    try:
        with _RankLog() as ranks:
            rc = train_cli.main(spec["argv"])
    finally:
        for k, f in real.items():
            setattr(train_cli, k, f)
    comm, steps = seen["comm"], max(1, seen["steps"])
    return {"rc": rc, "launches": dict(rows.launches),
            "eval_ranks": [r.tolist() for r in ranks.ranks],
            "backend": comm.backend, "layout": comm.layout,
            "host_ms_per_step": seen["train_s"] * 1e3 / steps,
            "coll_bytes_per_step": seen["coll"]["bytes"] / steps,
            "final": seen["final"], "loaded": seen.get("loaded")}


def _clone(state):
    from dglke_tpu_torch.models.ke_model import TrainState
    from dglke_tpu_torch.ops.embedding import EmbeddingState

    def table(t):
        return None if t is None else EmbeddingState(t.emb.clone(),
                                                      t.state_sum.clone())

    return TrainState(table(state.entity), table(state.relation),
                      step=state.step, projection=table(state.projection))


def _worker_step(spec: dict) -> dict:
    """One step of each plan at full width on this rank's slice of a
    global batch, against one device's step on the whole batch (both on
    the card, from the same tables), for each of STEP_CASES, with the
    tiles-route groupings of each first step; then DIST_TIMED steps on the
    host clock with the plan's collective counters."""
    import torch
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.models.ke_model import KEModel
    from dglke_tpu_torch.ops import rows
    from dglke_tpu_torch.parallel.mesh import ShardingPlan, init_distributed
    comm = init_distributed("cuda")
    rank, world, dev = comm.rank, comm.world, comm.device
    out = {"backend": comm.backend, "layout": comm.layout, "cases": {}}

    def tiles_of(step):
        before = rows.launches["group_ids_tiles"]
        step()
        return rows.launches["group_ids_tiles"] - before

    for recipe, n_ent, n_rel, _, _ in STEP_CASES:
        cfg = KGEConfig(**recipe)
        b, n_neg = cfg.batch_size, cfg.num_chunks * cfg.neg_sample_size
        rng = np.random.default_rng(11)
        ids = [torch.from_numpy(rng.integers(0, n, world * size).astype(
            np.int32)).to(dev) for n, size in
            ((n_ent, b), (n_rel, b), (n_ent, b), (n_ent, n_neg))]
        mine = [x[rank * len(x) // world:(rank + 1) * len(x) // world]
                for x in ids]
        one = KEModel(cfg, n_ent, n_rel, device=dev)
        full = one.init_state()
        ref = _clone(full)
        one_tiles = tiles_of(lambda: one.train_step(ref, *ids, None,
                                                    neg_head=True))
        for ts in ("vocab", "replicated"):
            plan = ShardingPlan(comm, ts, n_ent)
            model = KEModel(cfg, n_ent, n_rel, plan=plan)
            state = plan.shard_state(_clone(full))
            tiles = tiles_of(lambda: model.train_step(state, *mine, None,
                                                      neg_head=True))
            lo, n_real = plan.lo, plan.n_real
            worst = {}
            for name in ("entity", "relation"):
                got, want = getattr(state, name), getattr(ref, name)
                rows_ = slice(lo, lo + n_real) if name == "entity" and \
                    plan.vocab else slice(None)
                for part, g, w in (("", got.emb, want.emb[rows_]),
                                   ("_state", got.state_sum,
                                    want.state_sum[rows_])):
                    g = g[:n_real] if name == "entity" and plan.vocab else g
                    worst[name + part] = [
                        float((g - w).abs().max()),
                        bool(torch.allclose(g, w, rtol=DIST_RTOL,
                                            atol=DIST_ATOL))]
            digest = _digest(state)
            # steady steps on the host clock, with the collective counters
            torch.cuda.synchronize()
            comm.reset_counters()
            t0 = time.perf_counter()
            for i in range(DIST_TIMED):
                model.train_step(state, *mine, None, neg_head=i % 2 == 0)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / DIST_TIMED
            c = comm.counters()
            out["cases"][f"{recipe['model_name']} {ts}"] = {
                "worst": worst, "digest": digest, "host_ms_per_step": ms,
                "tiles": [tiles, one_tiles],
                "coll_bytes_per_step": c["bytes"] / DIST_TIMED}
            del state, model
        del full, ref, one
        torch.cuda.empty_cache()
    comm.close()
    return out


def _nccl_route(comm, fused, pipe, state, route: str, groups: int):
    """``groups`` groups of the fused call on ``route``: "graph" (its CUDA
    graph replayed after a first eager group on the capture stream) or
    "eager" (the group function called on the default stream).  Returns
    the logs [K, groups * s]."""
    import torch
    logs = []
    for _ in range(groups):
        if route == "graph":
            _, log = fused(state)
            logs.append(torch.stack([log[k] for k in fused.keys]))
        else:
            pipe.begin_group(fused.s)
            logs.append(fused.group(state))
            pipe.end_group(fused.s)
    torch.cuda.synchronize()
    return torch.cat(logs, 1)


def _worker_nccl(spec: dict) -> dict:
    """One rank over NCCL.  First dglke_tpu_torch-train with each of
    spec["runs"] ((label, argv) pairs; each run's result as _worker_cli
    gives it, with its printed text).  Then each of NCCL_CASES at full
    width, from the same tables: NCCL_GROUPS groups of GROUP_S steps through the fused call on
    its graph route and through its group function called eagerly (every
    table, its Adagrad state and the logs bit-equal; launches and
    collective bytes equal; one graph, NCCL_GROUPS - 1 replays; the bytes
    a replay adds), then NCCL_TIMED groups on each route on the host
    clock and NCCL_TIMED under torch.profiler (busy share, kernels and
    graph launches a step), the peak allocation over the timed groups.
    Then the vocab plan's filtered test eval of the checkpoint
    spec["ckpt"] (2,000 triples at batch 500), twice (its calls' second
    run captures their graphs), against one device's eval of the same
    checkpoint: the integer ranks equal."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    from dglke_tpu_torch.data.sampler import FilterIndex
    from dglke_tpu_torch.models.ke_model import KEModel
    from dglke_tpu_torch.models.pipeline_step import DevicePipelineStep
    from dglke_tpu_torch.ops import rows
    from dglke_tpu_torch.parallel.mesh import ShardingPlan, init_distributed
    from dglke_tpu_torch.trainer import DevicePipeline, evaluate
    from dglke_tpu_torch.utils.io import load_model_state
    runs = {}
    for label, argv in spec["runs"]:
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            runs[label] = _worker_cli({"argv": argv})
        runs[label]["text"] = text.getvalue()
    comm = init_distributed("cuda")
    out = {"backend": comm.backend, "layout": comm.layout, "cases": {},
           "runs": runs}
    ds = synthetic_dataset(N_ENT, N_REL, n_train=300_000, n_valid=1000,
                           n_test=2000, seed=0)
    for family, ts in NCCL_CASES:
        cfg = KGEConfig(**(TRANSE if family == "TransE_l2" else RESCAL))
        plan = ShardingPlan(comm, ts, N_ENT)
        model = KEModel(cfg, N_ENT, N_REL, plan=plan)
        init = plan.init_state(model)
        neg_total = cfg.num_chunks * cfg.neg_sample_size
        res, snaps = {}, {}
        t_case = time.perf_counter()
        for route in ("graph", "eager"):
            state = _clone(init)
            pipe = DevicePipeline(model, ds, cfg.batch_size, neg_total,
                                  seed=cfg.seed)
            fused = DevicePipelineStep(model, pipe, GROUP_S)
            if not fused.on_graphs:
                raise RuntimeError(f"{family} {ts}: not on the graph route")
            rows.reset_launches()
            comm.reset_counters()
            logs = _nccl_route(comm, fused, pipe, state, route, NCCL_GROUPS)
            launches, coll = dict(rows.launches), comm.counters()["bytes"]
            snaps[route] = _clone(state)
            graphs, replays = len(fused.graphs), fused.replays
            per_replay = [g.comm_bytes for g in fused.graphs.values()]
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            _nccl_route(comm, fused, pipe, state, route, NCCL_TIMED)
            host_ms = ((time.perf_counter() - t0) * 1e3
                       / (NCCL_TIMED * GROUP_S))
            peak_mb = torch.cuda.max_memory_allocated() / 2**20
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _nccl_route(comm, fused, pipe, state, route, NCCL_TIMED)
            kern = _kernel_events(prof)
            steps = NCCL_TIMED * GROUP_S
            res[route] = {
                "logs": logs.cpu().numpy().tobytes().hex(),
                "launches": launches, "coll_bytes": coll,
                "graphs": graphs, "replays": replays,
                "bytes_a_replay": per_replay, "host_ms": host_ms,
                "busy_ms": sum(e.self_device_time_total
                               for e in kern) / 1e3 / steps,
                "kernels": sum(e.count for e in kern) / steps,
                "graph_launches": sum(
                    e.count for e in prof.key_averages()
                    if e.key == "cudaGraphLaunch") / steps,
                "peak_mb": peak_mb}
            del state, pipe, fused
        g, e = snaps["graph"], snaps["eager"]
        res["same_tables"] = all(
            torch.equal(getattr(getattr(g, t), part),
                        getattr(getattr(e, t), part))
            for t in ("entity", "relation") for part in ("emb", "state_sum"))
        res["same_step"] = (g.step == e.step
                            == init.step + NCCL_GROUPS * GROUP_S)
        res["seconds"] = time.perf_counter() - t_case
        out["cases"][f"{family} {ts}"] = res
        del init, model, plan, snaps, g, e
        torch.cuda.empty_cache()
    # the vocab plan's test eval of the checkpoint, twice, against one
    # device's eval of it
    t_eval = time.perf_counter()
    cfg = KGEConfig(**TRANSE, dataset="fb15k_shaped", batch_size_eval=500)
    index = FilterIndex(ds)
    got = {}
    for name, plan in (("vocab", ShardingPlan(comm, "vocab", N_ENT)),
                       ("one device", None)):
        model = KEModel(cfg, N_ENT, N_REL, plan=plan,
                        device=None if plan else comm.device)
        state = load_model_state(cfg, model, spec["ckpt"])
        evals = []
        for _ in range(2 if plan else 1):
            with _RankLog() as ranks:
                t0 = time.perf_counter()
                evaluate(cfg, ds, model, state, "test", filter_index=index,
                         log=lambda *a: None, plan=plan)
                torch.cuda.synchronize()
            evals.append({"ranks": ranks.ranks[0].tolist(),
                          "s": time.perf_counter() - t0})
        calls = model.eval_calls
        got[name] = {"evals": evals, "captured": calls.captured,
                     "replays": calls.replays,
                     "on_graphs": calls.on_graphs(state)}
        del model, state
    got["seconds"] = time.perf_counter() - t_eval
    out["eval"] = got
    comm.close()
    return out


def dist_worker(spec_path: str) -> int:
    """One rank of a dist phase (``chip_smoke.py --dist-worker spec``)."""
    with open(spec_path) as f:
        spec = json.load(f)
    result = {"step": _worker_step, "nccl": _worker_nccl}.get(
        spec["kind"], _worker_cli)(spec)
    print("RESULT " + json.dumps(result))
    return 0


def _rank_numbers(label: str, res) -> None:
    """The two numbers of each rank: host ms per step on the host clock
    and collective bytes per step."""
    for rank, r in enumerate(res):
        print(f"{label} rank {rank}: host {r['host_ms_per_step']:.4f} ms a "
              f"step (host clock), collectives "
              f"{r['coll_bytes_per_step']:.0f} bytes a step")


def _hold_launches(label: str, res) -> dict:
    """Each rank's launches held to EXPECTED_LAUNCHES[label]; returns their
    sum over the ranks."""
    want = EXPECTED_LAUNCHES[label]
    total = dict.fromkeys(want, 0)
    for rank, r in enumerate(res):
        got = r["launches"]
        if any(got[k] != v for k, v in want.items()):
            fail(f"{label} rank {rank}: launches {got}, expected {want}")
        for k in want:
            total[k] += got[k]
    print(f"{label}: launches exact on every rank ({want} a rank)")
    return total


def _hold_backend(label: str, res, backend: str, layout: str) -> None:
    for rank, r in enumerate(res):
        if (r["backend"], r["layout"]) != (backend, layout):
            fail(f"{label} rank {rank}: backend {r['backend']} "
                 f"({r['layout']}), expected {backend} ({layout})")


def _hold_gloo_route(label: str, text: str) -> None:
    """Two ranks sharing the card over gloo run each step group eagerly as
    one call: rank 0's route line says so, and no graph line follows."""
    if not re.search(r"device-resident pipeline: \d+ steps a group, 2 ranks "
                     r"x \d+ rows a step, each group eagerly \(gloo\)", text):
        fail(f"{label}: rank 0 did not print the eager gloo route line")
    if "CUDA graphs:" in text:
        fail(f"{label}: a CUDA graph line over gloo")


def phase_dist_step_parity():
    """Two ranks sharing cuda:0 (gloo): one step of each plan at the
    flagship shapes (14,951 x 400, 1,000 rows and 1,000 negatives a rank),
    at RESCAL's (hidden 500: K3 on every replica) and at WN18's DistMult
    recipe (40,943 x 512, 2,048 rows and 2,048 negatives a rank: each
    owner's or replica's entity update over 12,288 ids on the grouping's
    tiles route) against one device's step on the global batch, also on
    the card, within DIST_RTOL / DIST_ATOL; replicated tables bit-equal
    across the ranks; the tiles-route groupings of each first step exact;
    then DIST_TIMED steps of each plan with their per-rank numbers."""
    res, _ = run_ranks("step", {"kind": "step"})
    _hold_backend("dist step", res, "gloo", "2 ranks share cuda:0")
    card = card_line()
    want_tiles = {r["model_name"]: [plan, one]
                  for r, _, _, plan, one in STEP_CASES}
    for case in res[0]["cases"]:
        tiles = want_tiles[case.split()[0]]
        for rank, r in enumerate(res):
            if r["cases"][case]["tiles"] != tiles:
                fail(f"dist step {case} rank {rank}: tiles-route groupings "
                     f"[a rank's first step, one device's step] "
                     f"{r['cases'][case]['tiles']}, expected {tiles}")
        for rank, r in enumerate(res):
            for what, (diff, ok) in r["cases"][case]["worst"].items():
                if not ok:
                    fail(f"dist step {case} rank {rank}: {what} differs "
                         f"from one device's step by {diff}")
        d0, d1 = (r["cases"][case]["digest"] for r in res)
        same = [k for k in d0 if k != "step" and d0[k] == d1[k]]
        want = ["relation", "relation_state"] + (
            ["entity", "entity_state"] if case.endswith("replicated")
            else [])
        if sorted(same) != sorted(want):
            fail(f"dist step {case}: bit-equal across ranks {same}, "
                 f"expected exactly {want}")
        worst = max(v[0] for r in res for v in r["cases"][case]["worst"]
                    .values())
        print(f"dist step {case}: both ranks within rtol {DIST_RTOL} / "
              f"atol {DIST_ATOL} of one device's step on the global batch "
              f"(max |diff| {worst:.3g}); replicated tables bit-equal "
              f"across ranks: {', '.join(sorted(want))}; tiles-route "
              f"groupings of the first step {tiles[0]} a rank, {tiles[1]} "
              f"on one device")
        _rank_numbers(f"dist step {case} [{DIST_NOTE}; {card}]",
                      [r["cases"][case] for r in res])


def _dist_flagship(label: str, table_sharding: str, recipe: dict,
                   steps: int, test: bool, data: str | None = None,
                   dataset: str = "fb15k_shaped"):
    """The recipe on the FB15k-shaped data (or ``dataset`` at ``data``)
    through dglke_tpu_torch-train --dist on two ranks sharing the card;
    returns (results, texts, the checkpoint directory)."""
    data = data or _fb15k_shaped("data", n_train=300_000)
    save = os.path.join(WORK, "dist_" + label.replace(" ", "_"))
    argv = ["--dist", "--table_sharding", table_sharding,
            "--dataset", dataset, *_udd_args(data),
            *_recipe_flags(recipe), "--max_step", str(steps),
            "--log_interval", str(steps // 2), "--save_path", save]
    argv += (["--test", "--batch_size_eval", "500"] if test
             else ["--no_save_emb"])
    res, texts = run_ranks(label.replace(" ", "_"),
                           {"kind": "cli", "argv": argv})
    _hold_backend(label, res, "gloo", "2 ranks share cuda:0")
    if f"Using 2-rank mesh (tables: {table_sharding}; backend gloo: 2 "\
            f"ranks share cuda:0)" not in texts[0]:
        fail(f"{label}: rank 0 did not print its mesh line")
    _hold_gloo_route(label, texts[0])
    losses = _floats(r"average loss: (\S+)", texts[0])
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"{label}: loss not finite: {losses}")
    return res, texts, os.path.join(save,
                                    f"{recipe['model_name']}_{dataset}_0")


def phase_dist_flagship():
    """The flagship under --dist on 2 ranks x batch 1,000, each plan,
    DIST_STEPS steps and the filtered test eval: launches exact on each
    rank, the metrics equal on both ranks and equal to one device's
    dglke_tpu_torch-eval of the npy checkpoint written at the end (the
    vocab plan's 14,951 rows leave one shard padded); then RESCAL under
    --dist (vocab) for DIST_RESCAL_STEPS steps, K3 on every replica.
    Returns the launch counts summed over the ranks, by path."""
    from dglke_tpu_torch.cli import eval as eval_cli
    paths = {}
    card = card_line()
    for ts in ("vocab", "replicated"):
        label = f"TransE_l2 dist {ts}"
        res, texts, ckpt = _dist_flagship(label, ts, TRANSE, DIST_STEPS,
                                          test=True)
        paths[label] = _hold_launches(label, res)
        metrics = [dict(re.findall(rf"\[{r}\]Test average (\S+): (\S+)",
                                   texts[r])) for r in range(DIST_RANKS)]
        out = io.StringIO()
        with contextlib.redirect_stdout(out), _RankLog() as one_ranks:
            _cli(eval_cli.main, [*_udd_args(_fb15k_shaped(
                "data", n_train=300_000)), "--model_path", ckpt,
                "--batch_size_eval", "500"])
        one = dict(re.findall(r"\[0\]Test average (\S+): (\S+)",
                              out.getvalue()))
        (want,) = one_ranks.ranks
        # Every rank ranks all batches over the vocab-sharded table, its
        # stride of them over replicas; the integer ranks must be one
        # device's, all of them.  The replicas add their partial sums of
        # 1/rank, which rounds the MRR in another order than one device's
        # mean: there the MRR is held through the ranks it comes from.
        got = [np.asarray(r["eval_ranks"][0]) for r in res]
        same = (all(np.array_equal(g, want) for g in got) if ts == "vocab"
                else np.array_equal(np.sort(np.concatenate(got)),
                                    np.sort(want)))
        keys = list(one) if ts == "vocab" else [k for k in one
                                                 if k != "MRR"]
        if not one or not same or any({k: m.get(k) for k in keys} != {
                k: one[k] for k in keys} for m in metrics):
            fail(f"{label}: test metrics {metrics} (ranks equal: {same}) on "
                 f"the ranks, {one} from one device's eval of the npy "
                 f"checkpoint")
        print(f"{label}: {DIST_STEPS} steps of 2 x {BATCH} rows; the "
              f"{len(want)} filtered test ranks and the metrics on both "
              f"ranks equal one device's eval of the npy checkpoint written "
              f"through rank 0: MRR {one['MRR']} ({metrics[0]['MRR']} on "
              f"the ranks), HITS@10 {one['HITS@10']}")
        _rank_numbers(f"{label} [{DIST_NOTE}; {card}]", res)
    label = "RESCAL dist vocab"
    res, _, _ = _dist_flagship(label, "vocab", RESCAL, DIST_RESCAL_STEPS,
                               test=False)
    paths[label] = _hold_launches(label, res)
    d0, d1 = (r["final"] for r in res)
    if d0["relation"] != d1["relation"] or \
            d0["relation_state"] != d1["relation_state"]:
        fail("RESCAL dist vocab: the relation replicas differ across ranks")
    print("RESCAL dist vocab: the 1,345 x 250,000 relation replicas "
          "bit-equal across ranks after K3 on each")
    _rank_numbers(f"{label} [{DIST_NOTE}; {card}]", res)
    return paths


def phase_dist_wn18():
    """WN18's DistMult recipe (DISTMULT_WN18) under --dist on 2 ranks
    sharing the card, each plan through dglke_tpu_torch-train for
    DIST_WN18_STEPS steps: losses finite, the eager gloo route, launches
    exact on each rank (the entity update's grouping on the tiles route
    once a step), each rank's host ms a step.  Returns the launch counts
    summed over the ranks, by path."""
    data = _synthetic_udd("wn18_shaped", WN18_ENT, WN18_REL, WN18_TRAIN,
                          1000, 2000)
    card = card_line()
    paths = {}
    for ts, steps in DIST_WN18_STEPS.items():
        label = f"DistMult WN18 dist {ts}"
        res, _, _ = _dist_flagship(label, ts, DISTMULT_WN18, steps,
                                   test=False, data=data,
                                   dataset="wn18_shaped")
        paths[label] = _hold_launches(label, res)
        print(f"{label}: {steps} steps of 2 x {DISTMULT_WN18['batch_size']} "
              f"rows, {WN18_ENT} x {DISTMULT_WN18['hidden_dim']} fp32; each "
              f"rank's entity update grouped 12,288 ids a step on the tiles "
              f"route ({steps} group_ids_tiles a rank)")
        _rank_numbers(f"{label} [{DIST_NOTE}; {card}]", res)
    return paths


def phase_dist_wikikg2():
    """ogbl-wikikg2 at full width (2,500,604 x 500 fp32, 2.5 GB a rank)
    under --dist --table_sharding vocab on two ranks, the recipe of
    examples/wikikg2.sh:11-14 through the stand-in ogb module (the cuts of
    phase 6): DIST_WIKI_STEPS steps with --sharded_ckpt --save_interval
    DIST_WIKI_EVERY, then resumed from that checkpoint for
    DIST_WIKI_RESUME steps with the sampled test eval.  The step counter
    goes on, and the tables each rank loads are bit-equal to those it
    saved.  Returns the launch counts summed over the ranks, by path."""
    save = os.path.join(WORK, "dist_wiki")
    common = ["--dist", "--table_sharding", "vocab", "--dataset", "wikikg2",
              "--data_path", WORK, "--format", "built_in",
              *_recipe_flags(WIKI), "--no_eval_filter",
              "--batch_size_eval", str(WIKI_EVAL_BATCH),
              "--neg_sample_size_eval", str(WIKI_EVAL_NEG),
              "--log_interval", str(DIST_WIKI_EVERY)]
    card = card_line()
    paths = {}
    first, _ = run_ranks("wiki_save", {"kind": "cli", "ogb": True, "argv": [
        *common, "--max_step", str(DIST_WIKI_STEPS), "--sharded_ckpt",
        "--save_interval", str(DIST_WIKI_EVERY), "--save_path", save]})
    paths["wikikg2 dist save"] = _hold_launches("wikikg2 dist save", first)
    ckpt = os.path.join(save, "TransE_l2_wikikg2_0")
    second, texts = run_ranks("wiki_resume", {
        "kind": "cli", "ogb": True, "argv": [
            *common, "--max_step", str(DIST_WIKI_RESUME), "--init_from",
            ckpt, "--test", "--no_save_emb", "--save_path",
            os.path.join(WORK, "dist_wiki_resume")]})
    paths["wikikg2 dist resume"] = _hold_launches("wikikg2 dist resume",
                                                  second)
    _hold_gloo_route("wikikg2 dist resume", texts[0])
    for rank, (a, b) in enumerate(zip(first, second)):
        if a["final"] != b["loaded"]:
            fail(f"wikikg2 dist rank {rank}: the tables loaded "
                 f"{b['loaded']} differ from those saved {a['final']}")
        if b["final"]["step"] != DIST_WIKI_STEPS + DIST_WIKI_RESUME:
            fail(f"wikikg2 dist rank {rank}: step {b['final']['step']} "
                 f"after the resume")
    mrr = [_floats(rf"\[{r}\]Test average MRR: (\S+)", texts[r])
           for r in range(DIST_RANKS)]
    if len(mrr[0]) != 1 or mrr[0] != mrr[1] or not 0 < mrr[0][0] <= 1:
        fail(f"wikikg2 dist: sampled test MRR {mrr} on the ranks")
    print(f"wikikg2 dist [{WIKI_ENT} x {WIKI['hidden_dim']} fp32, "
          f"{-(-WIKI_ENT // DIST_RANKS)} rows a rank]: saved at steps "
          f"{DIST_WIKI_EVERY} and {DIST_WIKI_STEPS} (--sharded_ckpt), "
          f"resumed on 2 ranks with every table bit-equal to the saved one "
          f"(blake2b of each rank's shard and replicas), step "
          f"{DIST_WIKI_STEPS} -> {DIST_WIKI_STEPS + DIST_WIKI_RESUME}; "
          f"sampled test MRR {mrr[0][0]!r} on both ranks")
    for name, res in (("save", first), ("resume", second)):
        _rank_numbers(f"wikikg2 dist {name} [{DIST_NOTE}; {card}]", res)
    return paths


def dist_graph_route(label: str, text: str, steps: int) -> None:
    """A --dist run at one NCCL rank takes the graph route: its route line
    says so, and it captures one graph and replays it steps / GROUP_S - 1
    times."""
    if (f"device-resident pipeline: {GROUP_S} steps a group, 1 ranks x "
            f"{BATCH} rows a step, one CUDA graph") not in text:
        fail(f"{label}: no graph route line")
    got = re.search(r"\[proc 0\]CUDA graphs: (\d+) captured, (\d+) replays",
                    text)
    want = (1, steps // GROUP_S - 1)
    if got is None or (int(got.group(1)), int(got.group(2))) != want:
        fail(f"{label}: CUDA graphs {got and got.groups()}, expected {want}")


def phase_dist_nccl():
    """--dist on one rank over NCCL, on the graph route: the flagship
    under each plan and RESCAL under the vocab plan (K3 in the graph),
    NCCL_STEPS steps each through the CLI, against the same runs without
    --dist on the same seed: the backend line says nccl, the route line
    and the graph line say one CUDA graph, launches exact, and every table
    bit-equal.  The three runs and the direct cases (nccl_direct) share
    one rank process.  Returns the launch counts by path."""
    data = _fb15k_shaped("data", n_train=300_000)
    paths, digests, runs = {}, {}, []
    for family, recipe in (("TransE_l2", TRANSE), ("RESCAL", RESCAL)):
        argv = ["--dataset", "fb15k_shaped", *_udd_args(data),
                *_recipe_flags(recipe), "--max_step", str(NCCL_STEPS),
                "--log_interval", str(NCCL_STEPS)]
        label = f"{family} nccl baseline"
        counts, _, _, state = run_cli(label, [*argv, "--no_save_emb"])
        paths[label] = counts
        digests[family] = _digest(state)
        del state
        for ts in ("vocab", "replicated") if family == "TransE_l2" else (
                "vocab",):
            label = f"{family} nccl" + (" replicated" if ts != "vocab"
                                        else "")
            save = (["--save_path", os.path.join(WORK, "nccl")]
                    if label == "TransE_l2 nccl" else ["--no_save_emb"])
            runs.append((label, ["--dist", "--table_sharding", ts, *argv,
                                 *save]))
    gc.collect()
    import torch
    torch.cuda.empty_cache()
    res = nccl_direct(os.path.join(WORK, "nccl", "TransE_l2_fb15k_shaped_0"),
                      runs)
    card = card_line()
    for label, argv in runs:
        r = res["runs"][label]
        ts = argv[argv.index("--table_sharding") + 1]
        family = label.split()[0]
        print(f"{label}: dglke_tpu_torch-train " + " ".join(argv))
        print("\n".join(f"  [rank 0] {ln}" for ln in r["text"].splitlines()))
        _hold_backend(label, [r], "nccl", "one card a rank")
        if f"Using 1-rank mesh (tables: {ts}; backend nccl: one card a "\
                f"rank)" not in r["text"]:
            fail(f"{label}: no nccl mesh line")
        dist_graph_route(label, r["text"], NCCL_STEPS)
        paths[label] = _hold_launches(label, [r])
        if r["final"] != digests[family]:
            fail(f"{label}: tables {r['final']} differ from the run "
                 f"without --dist {digests[family]}")
        print(f"{label}: {NCCL_STEPS} steps on 1 rank over NCCL, one CUDA "
              f"graph replayed {NCCL_STEPS // GROUP_S - 1} times; every "
              f"table bit-equal to the run without --dist")
        _rank_numbers(f"{label} [1 rank over NCCL; {card}]", [r])
    return paths


def nccl_direct(ckpt: str, runs=()) -> dict:
    """One rank over NCCL (_worker_nccl): the CLI ``runs`` ((label, argv)
    pairs, checked by the caller), then the direct cases and their
    checks: each case's group replayed bit-equal to the eager group,
    launches and collective bytes equal, both routes' numbers printed; the
    vocab plan's test eval of ``ckpt`` (written by one of ``runs``) as
    graphs, its ranks one device's.  Returns the rank's result."""
    card = card_line()
    (res,), _ = run_ranks("nccl", {"kind": "nccl", "ckpt": ckpt,
                                   "runs": list(runs)}, world=1)
    _hold_backend("nccl direct", [res], "nccl", "one card a rank")
    for case, r in res["cases"].items():
        g, e = r["graph"], r["eager"]
        label = f"{case} nccl group"
        if not (r["same_tables"] and r["same_step"]):
            fail(f"{label}: the tables differ between the CUDA graph and "
                 f"the eager group")
        if g["logs"] != e["logs"]:
            fail(f"{label}: the logs differ between the CUDA graph and the "
                 f"eager group")
        if g["launches"] != e["launches"] or not any(g["launches"].values()):
            fail(f"{label}: launches {g['launches']} on the graph route, "
                 f"{e['launches']} eager")
        if g["coll_bytes"] != e["coll_bytes"] or not g["coll_bytes"]:
            fail(f"{label}: collective bytes {g['coll_bytes']} on the graph "
                 f"route, {e['coll_bytes']} eager")
        if (g["graphs"], g["replays"]) != (1, NCCL_GROUPS - 1):
            fail(f"{label}: {g['graphs']} graphs, {g['replays']} replays")
        print(f"{label}: {NCCL_GROUPS} groups of {GROUP_S} steps through one "
              f"CUDA graph ({g['replays']} replays) bit-equal to the eager "
              f"group function (every table, its Adagrad state, the logs); "
              f"launches equal ({g['launches']}); collective bytes equal, "
              f"{g['coll_bytes']} in all, {g['bytes_a_replay'][0]} added by "
              f"each replay; {r['seconds']:.1f} s")
        print(f"{case} nccl step, CUDA graph against eager [1 rank over "
              f"NCCL; {card}]: host {g['host_ms']:.4f} / {e['host_ms']:.4f} "
              f"ms a step, device busy {g['busy_ms']:.4f} / "
              f"{e['busy_ms']:.4f} ms, busy share "
              f"{100 * g['busy_ms'] / g['host_ms']:.1f}% / "
              f"{100 * e['busy_ms'] / e['host_ms']:.1f}%, kernels "
              f"{g['kernels']:.1f} / {e['kernels']:.1f} and graph launches "
              f"{g['graph_launches']:.2f} / {e['graph_launches']:.2f} a "
              f"step, graphs {g['graphs']} / {e['graphs']}, replays "
              f"{g['replays']} / {e['replays']} (over the parity groups), "
              f"peak allocated {g['peak_mb']:.1f} / {e['peak_mb']:.1f} MB")
    ev = res["eval"]
    (want,) = [x["ranks"] for x in ev["one device"]["evals"]]
    vocab = ev["vocab"]
    if not vocab["on_graphs"] or (vocab["captured"],
                                  vocab["replays"]) != (2, 2):
        fail(f"nccl eval: on graphs {vocab['on_graphs']}, "
             f"{vocab['captured']} captured, {vocab['replays']} replays; "
             f"expected 2 and 2")
    for i, x in enumerate(vocab["evals"]):
        if x["ranks"] != want:
            fail(f"nccl eval {i}: the vocab plan's ranks differ from one "
                 f"device's")
    print(f"TransE_l2 nccl eval [1 rank over NCCL; {card}]: the vocab plan's "
          f"filtered test eval of the checkpoint ({len(want)} ranks, 2,000 "
          f"triples x 2 modes at batch 500) eagerly "
          f"({vocab['evals'][0]['s']:.3f} s) and as EvalCalls graphs "
          f"({vocab['evals'][1]['s']:.3f} s; {vocab['captured']} captured, "
          f"{vocab['replays']} replays): integer ranks equal to one "
          f"device's eval ({ev['one device']['evals'][0]['s']:.3f} s); "
          f"{ev['seconds']:.1f} s with the filter index")
    return res


# ---------------------------------------------------------------------------
# Phase 3b: --compute_dtype bfloat16 training

BF16 = ("--compute_dtype", "bfloat16")
# TransR as examples/fb15k.sh runs it (hidden 200: 40,000-wide projection
# rows), for the bf16 step against the CPU.
TRANSR = dict(model_name="TransR", hidden_dim=200, gamma=8.0, lr=0.015,
              batch_size=BATCH, neg_sample_size=NEG,
              neg_adversarial_sampling=True, regularization_coef=5e-8)
# RESCAL under bf16 compute takes the stock route, as in the JAX package:
# no K3; the relation rows' gradient [1,000 x 250,000] goes through the
# grouping and K2's block route.  BF16_RESCAL_STEPS steps, no eval.
BF16_RESCAL_STEPS = 200
EXPECTED_LAUNCHES["TransE_l2 bf16"] = dict(EXPECTED_LAUNCHES["TransE_l2"],
                                          transe_l2_loss=0)
EXPECTED_LAUNCHES["RESCAL bf16"] = {
    "gather_rows": 2 * BF16_RESCAL_STEPS, "gather_rows_pow_sum": 0,
    "gather_rows_matvec": 0, "group_ids": 2 * BF16_RESCAL_STEPS,
    "group_ids_tiles": 0, "sparse_adagrad_rows": 2 * BF16_RESCAL_STEPS,
    "outer_adagrad_update": 0, "transe_l2_loss": 0}
# The CPU test's tolerances (tests/test_torch_compute_bf16.py), in bf16
# roundings (2^-8): each table's update within 8 of the largest update
# (RotatE's 32 does not apply here), the Adagrad state's increment within
# 16, the loss within 2 relative.
BF16_ULP = 2.0 ** -8
# The bf16 flagship's test MRR against the fp32 run's on the same data: a
# sanity bound (bf16 scores move the training, not the eval); the gap
# itself is printed.
BF16_MRR_TOL = 0.05


def phase_bf16_main(fp32_metrics: dict):
    """The flagship with --compute_dtype bfloat16 through the CLI on the
    phase-3 data (1,000 steps, filtered test eval), launches held (those of
    the fp32 run), the tables fp32; its test metrics beside the fp32
    run's.  Then RESCAL with the flag, BF16_RESCAL_STEPS steps on the
    stock route (K3 never, K2 on the relation rows).  Returns the launch
    counts by path."""
    import torch
    metrics = {}
    paths = {"TransE_l2 bf16": phase_main_path(
        TRANSE, batch_size_eval=500, extra=BF16, label="TransE_l2 bf16",
        metrics=metrics)}
    (mrr, hits, rate), (mrr32, hits32, rate32) = (
        metrics["TransE_l2 bf16"], fp32_metrics["TransE_l2"])
    print(f"TransE_l2 bf16 against fp32 on the same data: test MRR "
          f"{mrr!r} / {mrr32!r} (gap {mrr - mrr32:+.6f}), HITS@10 {hits!r} / "
          f"{hits32!r}; {rate:.1f} / {rate32:.1f} triples/s (CLI loop)")
    if abs(mrr - mrr32) > BF16_MRR_TOL:
        fail(f"TransE_l2 bf16: test MRR {mrr!r} further than {BF16_MRR_TOL} "
             f"from the fp32 run's {mrr32!r}")
    argv = ["--dataset", "fb15k_shaped",
            *_udd_args(_fb15k_shaped("data", n_train=300_000)),
            *_recipe_flags(RESCAL), *BF16, "--max_step",
            str(BF16_RESCAL_STEPS), "--log_interval",
            str(BF16_RESCAL_STEPS // 2), "--no_save_emb",
            "--save_path", os.path.join(WORK, "bf16_ckpts")]
    counts, text, model, state = run_cli("RESCAL bf16", argv)
    if model._rescal_factored(state):
        fail("RESCAL bf16: the factored route (K3) was taken")
    if {state.entity.emb.dtype, state.relation.emb.dtype} != {
            torch.float32}:
        fail("RESCAL bf16: the tables are not fp32")
    train_s = _floats(r"training takes (\S+) seconds", text)[0]
    print(f"RESCAL bf16 (stock route, K2 on the 1,000 x {RESCAL_WIDTH} "
          f"relation rows a step): {BF16_RESCAL_STEPS} steps, "
          f"{BF16_RESCAL_STEPS * BATCH / train_s:.1f} triples/s (CLI loop); "
          f"launches {counts}")
    paths["RESCAL bf16"] = counts
    return paths


def print_bf16_profiles(profiles: dict) -> None:
    for name in ("TransE_l2", "RESCAL"):
        (h32, d32, k32), (h16, d16, k16) = (profiles[name][:3],
                                            profiles[name + " bf16"][:3])
        print(f"{name} step, bf16 compute against fp32 [{card_line()}]: "
              f"device busy {d16:.4f} / {d32:.4f} ms, host {h16:.4f} / "
              f"{h32:.4f} ms, busy share {100 * d16 / h16:.1f}% / "
              f"{100 * d32 / h32:.1f}%, kernels {k16:.1f} / {k32:.1f} a step")


def phase_bf16_step_parity(recipe: dict, n_ent: int = N_ENT,
                           n_rel: int = N_REL):
    """One bf16-compute step in each corruption direction on the card
    (cuBLAS' bf16 products with fp32 out) and on the CPU (the plain
    versions, products of upcast bf16), each from the same fp32 tables:
    every table's update and Adagrad increment and the loss within the CPU
    test's bf16 tolerances; the tables stay fp32."""
    import torch
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.models.ke_model import KEModel
    name = recipe["model_name"]
    cfg = KGEConfig(**recipe, compute_dtype="bfloat16")
    batch = cfg.batch_size
    n_neg = cfg.num_chunks * cfg.neg_sample_size
    rng = np.random.default_rng(2)
    gpu_model = KEModel(cfg, n_ent, n_rel, device="cuda")
    cpu_model = KEModel(cfg, n_ent, n_rel, device="cpu")
    init = gpu_model.init_state()
    worst = {}
    for neg_head in (True, False):
        ids = [rng.integers(0, n, size).astype(np.int32) for n, size in
               ((n_ent, batch), (n_rel, batch), (n_ent, batch),
                (n_ent, n_neg))]
        gpu_state, cpu_state = _clone(init), _cpu_copy(init)
        _, glog = gpu_model.train_step(
            gpu_state, *(torch.from_numpy(x).cuda() for x in ids), None,
            neg_head=neg_head)
        _, clog = cpu_model.train_step(
            cpu_state, *(torch.from_numpy(x) for x in ids), None,
            neg_head=neg_head)
        g, c = float(glog["loss"]), float(clog["loss"])
        if abs(g - c) > 2 * BF16_ULP * abs(c):
            fail(f"{name} bf16 step: loss {g!r} on the card, {c!r} on the "
                 f"CPU")
        for table in ("entity", "relation", "projection"):
            t0, tg, tc = (getattr(s, table) for s in (init, gpu_state,
                                                      cpu_state))
            if t0 is None:
                continue
            if tg.emb.dtype != torch.float32:
                fail(f"{name} bf16 step: the {table} table is {tg.emb.dtype}")
            for part, k in (("emb", 8), ("state_sum", 16)):
                base = getattr(t0, part)
                dg = getattr(tg, part) - base
                dc = getattr(tc, part).to(base.device) - base
                scale = float(dc.abs().max())
                err = float((dg - dc).abs().max())
                worst[f"{table} {part}"] = max(
                    worst.get(f"{table} {part}", 0.0),
                    err / (BF16_ULP * scale) if scale else 0.0)
                if err > k * BF16_ULP * scale:
                    fail(f"{name} bf16 step ({'head' if neg_head else 'tail'})"
                         f": the {table} {part} update differs from the "
                         f"CPU's by {err} (largest update {scale})")
        del gpu_state, cpu_state
    print(f"{name} bf16 step parity [{n_ent} x {n_rel}, hidden "
          f"{recipe['hidden_dim']}]: one step in each direction on the card "
          f"within the CPU test's tolerance of the CPU's (largest "
          f"difference, in bf16 roundings of the largest update: "
          + ", ".join(f"{k} {v:.3f}" for k, v in worst.items()) + ")")
    del init
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 3c: --profile

PROFILE_STEPS = 200
# dglke_tpu_torch-train --profile DIR on the flagship, PROFILE_STEPS steps,
# no eval: two K1, two groupings and two K2 a step.  The same run without
# --profile, for the bit-equal tables.
for _label in ("TransE_l2 profile", "TransE_l2 profile baseline"):
    EXPECTED_LAUNCHES[_label] = {"gather_rows": 2 * PROFILE_STEPS,
                                 "group_ids": 2 * PROFILE_STEPS,
                                 "group_ids_tiles": 0,
                                 "sparse_adagrad_rows": 2 * PROFILE_STEPS,
                                 "outer_adagrad_update": 0,
                                 "transe_l2_loss": 2 * PROFILE_STEPS}
# The same 200 steps with --valid every VALID_EVERY steps at
# --batch_size_eval 16: each of the 4 filtered Valid evals (1,000 triples,
# 63 batches a mode, all of filter width 8) makes 2 group calls a mode of
# 4 K1 each; the first eval captures one graph a mode at its second call,
# the later evals replay.
VALID_EVERY = 50
EXPECTED_LAUNCHES["TransE_l2 valid"] = {
    "gather_rows": 2 * PROFILE_STEPS + 64, "group_ids": 2 * PROFILE_STEPS,
    "group_ids_tiles": 0, "sparse_adagrad_rows": 2 * PROFILE_STEPS,
    "outer_adagrad_update": 0, "transe_l2_loss": 2 * PROFILE_STEPS}
EXPECTED_EVAL_GRAPHS["TransE_l2 valid"] = (2, 14)
# The same on host tables (--mix_cpu_gpu), with and without --valid: each
# Valid eval (1,000 triples) makes one pos/side call a direction (two K1
# each) and one block call; the first eval runs the three keys eagerly,
# the second captures them, and every later call replays.
EXPECTED_LAUNCHES["TransE_l2 host valid"] = {
    "gather_rows": 2 * PROFILE_STEPS + 16, "group_ids": 2 * PROFILE_STEPS,
    "group_ids_tiles": 0, "sparse_adagrad_rows": 2 * PROFILE_STEPS,
    "outer_adagrad_update": 0, "transe_l2_loss": 2 * PROFILE_STEPS}
EXPECTED_EVAL_GRAPHS["TransE_l2 host valid"] = (3, 9)
EXPECTED_LAUNCHES["TransE_l2 host valid baseline"] = dict(
    EXPECTED_LAUNCHES["TransE_l2 host valid"], gather_rows=2 * PROFILE_STEPS)
HOST_PATHS += ("TransE_l2 host valid", "TransE_l2 host valid baseline")
# The hand-written kernels a flagship step launches, by the name the trace
# gives them, and how many times a step (K1, K2: entity and relation rows;
# the fused loss route's two).
PROFILE_KERNELS = {"gather_rows_vec4": 2, "group_ids": 2,
                   "segment_update_warp": 2, "transe_l2_rows": 1,
                   "transe_l2_grads": 1}


def _profile_run(label: str, trace_dir=None):
    save = os.path.join(WORK, label.replace(" ", "_"))
    argv = ["--dataset", "fb15k_shaped",
            *_udd_args(_fb15k_shaped("data", n_train=300_000)),
            *_recipe_flags(TRANSE), "--max_step", str(PROFILE_STEPS),
            "--log_interval", str(PROFILE_STEPS // 4), "--save_path", save]
    if trace_dir is not None:
        argv += ["--profile", trace_dir]
    counts, text, _, _ = run_cli(label, argv)
    return counts, text, os.path.join(save, "TransE_l2_fb15k_shaped_0")


def _trace_kernels(path: str):
    """(the steps the step spans cover, device kernel events by name) of a
    Chrome trace: a ``step N`` span covers step N, a replayed group's
    ``steps N-M`` span the steps N to M."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    steps = []
    for e in events:
        m = re.fullmatch(r"steps? (\d+)(?:-(\d+))?", str(e.get("name")))
        if e.get("cat") == "user_annotation" and m:
            steps += range(int(m.group(1)), int(m.group(2) or m.group(1)) + 1)
    steps.sort()
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    return steps, kernels


def phase_profile():
    """The flagship through dglke_tpu_torch-train --profile DIR, 200 steps
    on the CUDA graph route: the trace parses, its spans (one a replayed
    group) cover the window's steps [2s, 4s), and it lists the hand-written
    kernels of the graph's replays by their CUDA names, each as many times
    as the window's steps x its launches a step; the checkpoint is bit-equal to
    the same run's without --profile.  A trace with no device event is
    taken once more (said so), and fails if empty again.  Returns the
    launch counts by path."""
    paths = {}
    for attempt in range(2):
        trace_dir = os.path.join(WORK, f"trace{attempt}")
        shutil.rmtree(os.path.join(WORK, "TransE_l2_profile"),
                      ignore_errors=True)
        counts, text, ckpt = _profile_run("TransE_l2 profile", trace_dir)
        if "[proc 0]profiler trace written" not in text:
            fail("profile run: no '[proc 0]profiler trace written' line")
        path = os.path.join(trace_dir, "trace_rank0.json")
        steps, kernels = _trace_kernels(path)
        if kernels:
            break
        print("profile run: the trace holds no device event; running it "
              "again")
    else:
        fail("profile run: the trace holds no device event, twice")
    paths["TransE_l2 profile"] = counts
    s = len(steps) // 2
    if not steps or steps != list(range(2 * s, 4 * s)):
        fail(f"profile run: the trace's steps are {steps}, not [2s, 4s)")
    found = {want: sum(c for k, c in kernels.items() if want in k)
             for want in PROFILE_KERNELS}
    short = {k: n for k, n in found.items()
             if n != PROFILE_KERNELS[k] * len(steps)}
    if short:
        keep = os.path.join(ROOT, "build", "profile_trace.json")
        shutil.copy(path, keep)
        fail(f"profile run: {found} times in the trace, expected "
             f"{len(steps)} steps x {PROFILE_KERNELS}; "
             f"{sum(kernels.values())} device kernels in all; the trace is "
             f"kept as {keep}")
    print(f"profile run: {os.path.getsize(path)} bytes of Chrome trace, "
          f"steps {steps[0]}-{steps[-1]} (s = {s}); hand-written kernels "
          f"by name: {found} ({len(steps)} steps x {PROFILE_KERNELS}); "
          f"{sum(kernels.values())} device kernels in all")
    counts, _, plain = _profile_run("TransE_l2 profile baseline")
    paths["TransE_l2 profile baseline"] = counts
    for table in ("entity", "entity_state", "relation", "relation_state"):
        f = f"fb15k_shaped_TransE_l2_{table}.npy"
        if not np.array_equal(np.load(os.path.join(ckpt, f)),
                              np.load(os.path.join(plain, f))):
            fail(f"profile run: {f} differs from the run without --profile")
    print("profile run: every saved table bit-equal to the run without "
          "--profile")
    paths["TransE_l2 valid"] = phase_valid_graphs(plain)
    return paths


def phase_valid_graphs(plain: str):
    """Training graphs and eval graphs in one run: the flagship's 200 steps
    on the CUDA graph route with --valid every VALID_EVERY steps (the eval
    graphs captured in the first Valid eval and replayed by the later
    ones, EXPECTED_EVAL_GRAPHS), launches held, and every saved table
    bit-equal to the run without eval (``plain``, its checkpoint).
    Returns the launch counts."""
    save = os.path.join(WORK, "TransE_l2_valid")
    argv = ["--dataset", "fb15k_shaped",
            *_udd_args(_fb15k_shaped("data", n_train=300_000)),
            *_recipe_flags(TRANSE), "--max_step", str(PROFILE_STEPS),
            "--log_interval", str(PROFILE_STEPS // 4), "--valid",
            "--eval_interval", str(VALID_EVERY), "--batch_size_eval",
            str(EVAL_BATCH), "--save_path", save]
    counts, text, _, _ = run_cli("TransE_l2 valid", argv)
    evals = len(re.findall(r"\[0\]Valid takes", text))
    if evals != PROFILE_STEPS // VALID_EVERY:
        fail(f"valid run: {evals} Valid evals")
    ckpt = os.path.join(save, "TransE_l2_fb15k_shaped_0")
    for table in ("entity", "entity_state", "relation", "relation_state"):
        f = f"fb15k_shaped_TransE_l2_{table}.npy"
        if not np.array_equal(np.load(os.path.join(ckpt, f)),
                              np.load(os.path.join(plain, f))):
            fail(f"valid run: {f} differs from the run without eval")
    print(f"valid run: {PROFILE_STEPS} steps through the training graph with "
          f"{evals} Valid evals through the eval graphs between its "
          f"replays; every saved table bit-equal to the run without eval")
    return counts


def phase_host_valid():
    """Host tables' training graphs and eval graphs in one run: the
    flagship with --mix_cpu_gpu, PROFILE_STEPS steps with --valid every
    VALID_EVERY (the host eval's graphs captured in the second Valid eval
    and replayed by the later ones, EXPECTED_EVAL_GRAPHS), launches held,
    and every saved table bit-equal to the same run's without --valid.
    Returns the launch counts by path."""
    data = _fb15k_shaped("data", n_train=300_000)
    paths, ckpts = {}, []
    for label, extra in (
            ("TransE_l2 host valid", ["--valid", "--eval_interval",
                                      str(VALID_EVERY)]),
            ("TransE_l2 host valid baseline", [])):
        save = os.path.join(WORK, label.replace(" ", "_"))
        argv = ["--dataset", "fb15k_shaped", *_udd_args(data),
                *_recipe_flags(TRANSE), "--max_step", str(PROFILE_STEPS),
                "--log_interval", str(PROFILE_STEPS // 4), "--mix_cpu_gpu",
                *extra, "--save_path", save]
        paths[label], text, _, _ = run_cli(label, argv)
        ckpts.append(os.path.join(save, "TransE_l2_fb15k_shaped_0"))
        evals = len(re.findall(r"\[0\]Valid takes", text))
        if evals != (PROFILE_STEPS // VALID_EVERY if extra else 0):
            fail(f"{label}: {evals} Valid evals")
    for table in ("entity", "entity_state", "relation", "relation_state"):
        f = f"fb15k_shaped_TransE_l2_{table}.npy"
        if not np.array_equal(*(np.load(os.path.join(c, f))
                                for c in ckpts)):
            fail(f"host valid run: {f} differs from the run without eval")
    print(f"host valid run: {PROFILE_STEPS} host-table steps through the "
          f"training graphs with {PROFILE_STEPS // VALID_EVERY} Valid evals "
          f"through the host eval's graphs between their replays; every "
          f"saved table bit-equal to the run without eval")
    return paths


# ---------------------------------------------------------------------------
# Phase 7d: the native LDG partitioner at Freebase scale, and the partition
# path end to end

# planted_line_big(21,513,538 clusters of 4): 86,054,152 entities (Freebase:
# 86,054,151) and 344,216,592 edges (Freebase's train split: 338,586,276).
LDG_CLUSTERS, LDG_PER, LDG_K = 21_513_538, 4, 4
LDG_TIMEOUT = 900
DIST_PART_STEPS = 100
EXPECTED_LAUNCHES["TransE_l2 dist partition"] = {
    "gather_rows": 2 * DIST_PART_STEPS, "group_ids": 2 * DIST_PART_STEPS,
    "group_ids_tiles": 0, "sparse_adagrad_rows": 2 * DIST_PART_STEPS,
    "outer_adagrad_update": 0, "transe_l2_loss": 2 * DIST_PART_STEPS}


def ldg_worker() -> int:
    """``chip_smoke.py --ldg-worker``: the native LDG (k = LDG_K) on the
    Freebase-scale planted line graph, on the host, twice; prints one
    RESULT line.  Runs in its own process beside the card phases, so that
    its ~20 GB are gone before the capacity run."""
    import resource
    from dglke_tpu_torch.data import native
    from dglke_tpu_torch.data.dataset import planted_line_big
    t0 = time.time()
    native.load()
    build_s = time.time() - t0
    t0 = time.time()
    ds = planted_line_big(n_clusters=LDG_CLUSTERS, per=LDG_PER)
    h, _, t = ds.train
    n = ds.n_entities
    h, t = h.astype(np.int64), t.astype(np.int64)
    gen_s = time.time() - t0
    t0 = time.time()
    a1, c1 = native.ldg_partition_native(h, t, n, LDG_K, 0)
    s1 = time.time() - t0
    # the second run (ctypes lets go of the GIL) beside the numpy checks
    second = {}

    def again():
        t0 = time.time()
        second["run"] = native.ldg_partition_native(h, t, n, LDG_K, 0)
        second["s"] = time.time() - t0

    thread = threading.Thread(target=again)
    thread.start()
    sizes = np.bincount(a1, minlength=LDG_K)
    recount = int(np.count_nonzero(a1[h] != a1[t]))
    rand = np.random.RandomState(0).randint(0, LDG_K, n).astype(np.int32)
    rand_cut = int(np.count_nonzero(rand[h] != rand[t]))
    thread.join()
    (a2, c2), s2 = second["run"], second["s"]
    print("RESULT " + json.dumps({
        "n_nodes": n, "n_edges": len(h), "build_s": build_s, "gen_s": gen_s,
        "ldg_s": [s1, s2], "cut": c1, "cut2": c2, "recount": recount,
        "random_cut": rand_cut, "sizes": sizes.tolist(),
        "min_assign": int(a1.min()), "bit_equal": bool(np.array_equal(a1, a2)),
        "peak_rss_gb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1e6}))
    return 0


def start_ldg():
    """The LDG worker, started now; phase_ldg collects it."""
    os.makedirs(WORK, exist_ok=True)
    log = open(os.path.join(WORK, "ldg.log"), "w+")
    proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                             "--ldg-worker"], cwd=ROOT, stdout=log,
                            stderr=subprocess.STDOUT)
    return proc, log, time.time()


def phase_ldg(started) -> None:
    """The native LDG at Freebase scale (86,054,152 nodes, 344,216,592
    edges), on the machine's host: every node assigned, the largest part
    at most 1.5 n / k, the returned cut equal to the cut recounted in
    numpy and below a random assignment's, a second run bit-equal."""
    proc, log, t0 = started
    try:
        proc.wait(timeout=max(1.0, LDG_TIMEOUT - (time.time() - t0)))
    except subprocess.TimeoutExpired:
        fail(f"native LDG: not done in {LDG_TIMEOUT} s")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    log.seek(0)
    text = log.read()
    log.close()
    lines = [ln for ln in text.splitlines() if ln.startswith("RESULT ")]
    if proc.returncode != 0 or len(lines) != 1:
        fail(f"native LDG worker exited {proc.returncode}:\n{text[-3000:]}")
    r = json.loads(lines[0][len("RESULT "):])
    n, k = r["n_nodes"], LDG_K
    if r["min_assign"] < 0 or sum(r["sizes"]) != n:
        fail(f"native LDG: not every node assigned ({r['sizes']})")
    if max(r["sizes"]) > 1.5 * n / k:
        fail(f"native LDG: a part of {max(r['sizes'])} nodes, over 1.5 n/k")
    if r["cut"] != r["recount"] or r["cut"] != r["cut2"]:
        fail(f"native LDG: cut {r['cut']} / {r['cut2']}, recounted "
             f"{r['recount']}")
    if not r["cut"] < r["random_cut"]:
        fail(f"native LDG: cut {r['cut']} not below random {r['random_cut']}")
    if not r["bit_equal"]:
        fail("native LDG: a second run assigned differently")
    print(f"native LDG at Freebase scale [{n:,} nodes, {r['n_edges']:,} "
          f"edges, k = {k}; host of the card's machine]: build "
          f"{r['build_s']:.2f} s, graph {r['gen_s']:.2f} s, LDG "
          f"{r['ldg_s'][0]:.2f} s (alone) and {r['ldg_s'][1]:.2f} s (beside "
          f"the numpy checks; bit-equal), cut "
          f"{r['cut']:,} (recounted equal; random assignment "
          f"{r['random_cut']:,}), parts {r['sizes']}, peak RSS "
          f"{r['peak_rss_gb']:.2f} GB")


def phase_dist_partition():
    """dglke_tpu_torch-partition -k 2 (LDG, native) on the flagship-shaped
    dataset, then dglke_tpu_torch-train --dist --partition_path on two
    ranks sharing the card over gloo, DIST_PART_STEPS steps: launches
    exact on each rank.  Returns the launch counts summed over the ranks."""
    from dglke_tpu_torch.cli import partition as partition_cli
    data = _fb15k_shaped("data", n_train=300_000)
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        rc = partition_cli.main(["--dataset", "fb15k_shaped", "--data_path",
                                 data, "--format", "udd_hrt", "--data_files",
                                 "entities.tsv", "relations.tsv",
                                 "train.tsv", "valid.tsv", "test.tsv",
                                 "-k", "2"])
    if rc != 0:
        fail(f"dglke_tpu_torch-partition returned {rc}")
    print(f"dglke_tpu_torch-partition -k 2 (native LDG): "
          f"{time.time() - t0:.2f} s; " + out.getvalue().strip()
          .splitlines()[-1])
    label = "TransE_l2 dist partition"
    argv = ["--dist", "--table_sharding", "vocab", "--dataset",
            "fb15k_shaped", "--data_path", data, "--partition_path",
            os.path.join(data, "fb15k_shaped"), *_recipe_flags(TRANSE),
            "--max_step", str(DIST_PART_STEPS), "--log_interval",
            str(DIST_PART_STEPS // 2), "--no_save_emb", "--save_path",
            os.path.join(WORK, "dist_partition")]
    res, texts = run_ranks("partition", {"kind": "cli", "argv": argv})
    _hold_backend(label, res, "gloo", "2 ranks share cuda:0")
    _hold_gloo_route(label, texts[0])
    losses = _floats(r"average loss: (\S+)", texts[0])
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"{label}: loss not finite: {losses}")
    paths = {label: _hold_launches(label, res)}
    _rank_numbers(f"{label} [{DIST_NOTE}; {card_line()}]", res)
    return paths


# ---------------------------------------------------------------------------
# Phase 7

# tests/test_planted_quality.py:27-46: (model, structure, overrides)
PLANTED_BASE = dict(hidden_dim=32, gamma=6.0, lr=0.25, batch_size=128,
                    neg_sample_size=32, max_step=1500, batch_size_eval=16,
                    log_interval=10**9, neg_adversarial_sampling=True,
                    regularization_coef=1e-9, seed=7, dataset="synthetic")
PLANTED = [
    ("TransE_l2", "line", dict(gamma=4.0, max_step=2000)),
    ("TransE_l1", "line", dict(gamma=8.0)),
    ("TransR", "line", dict(hidden_dim=16, lr=0.15)),
    ("RotatE", "line", dict(double_ent=True, lr=0.1)),
    ("DistMult", "cliques", dict(neg_adversarial_sampling=False,
                                 regularization_coef=2e-6, lr=0.15)),
    ("ComplEx", "cycle", dict(neg_adversarial_sampling=False,
                              regularization_coef=2e-6, lr=0.15)),
    ("SimplE", "cycle", dict(neg_adversarial_sampling=False,
                             regularization_coef=2e-6, lr=0.15)),
    ("RESCAL", "cycle", dict(hidden_dim=16, lr=0.1,
                             neg_adversarial_sampling=False)),
]


def phase_planted():
    """The gate of every family in fp32 and with --compute_dtype bfloat16
    (the CPU test holds the port's bf16 runs to it wherever the JAX
    package's pass; both pass in every family at this size), side by
    side."""
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.data.dataset import planted_dataset
    from dglke_tpu_torch.trainer import evaluate, train
    quiet = lambda *a: None  # noqa: E731
    for name, structure, overrides in PLANTED:
        ds = planted_dataset(structure,
                             n_clusters=8 if structure == "cycle" else 10)
        out = []
        for dtype in ("float32", "bfloat16"):
            cfg = KGEConfig(**{**PLANTED_BASE, "model_name": name,
                               **overrides, "compute_dtype": dtype})
            t0 = time.time()
            model, state, _ = train(cfg, ds, log=quiet)
            m = evaluate(cfg, ds, model, state, "test", log=quiet)
            if m["MRR"] < 0.85 or m["HITS@10"] < 0.99:
                fail(f"planted {name} {dtype} gate failed on the card: {m}")
            out.append(f"{dtype} MRR {m['MRR']:.4f}, HITS@10 "
                       f"{m['HITS@10']:.4f} ({time.time() - t0:.1f} s)")
        print(f"planted {name} ({structure}) gate (MRR >= 0.85, HITS@10 >= "
              f"0.99, {cfg.max_step} steps + eval): " + "; ".join(out))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from dglke_tpu_torch.ops import rows  # noqa: F401  (fails outside the repo)
    shutil.rmtree(WORK, ignore_errors=True)
    start = time.time()

    def lap(name: str) -> None:
        print(f"[{time.time() - start:.1f} s of the script] {name} "
              f"done", flush=True)

    try:
        phase_build()
        lap("build")
        kernels = phase_kernels()
        group, tiles = phase_group()
        kernels.append(group)
        kernels.append(phase_k2())
        phase_group_capture()
        phase_gather_shapes()
        k3, k1_wide = phase_outer()
        kernels[0].update(k1_wide)
        kernels += [k3, tiles]
        kernels.append(phase_transe_l2_kernels())
        phase_outer_routes()
        lap("phase 2")
        phase_graph_parity()
        lap("phase 2b")
        phase_eval_graphs()
        lap("phase 2c")
        phase_host_eval_graphs()
        lap("phase 2c on host tables")
        main_metrics = {}
        paths = {"TransE_l2": phase_main_path(TRANSE, batch_size_eval=500,
                                              metrics=main_metrics)}
        lap("phase 3's main path")
        phase_step_parity(TRANSE)
        profiles = {"TransE_l2": phase_step_profile(TRANSE, steps=50),
                    "TransE_l2 graph": phase_step_profile(TRANSE, steps=50,
                                                          route="graph")}
        paths.update(phase_bf16_main(main_metrics))
        for route in ("eager", "graph"):
            profiles["TransE_l2 bf16" + (" graph" if route == "graph"
                                         else "")] = phase_step_profile(
                dict(TRANSE, compute_dtype="bfloat16"), steps=50,
                route=route)
        phase_bf16_step_parity(TRANSE)
        lap("phase 3, 3b")
        paths.update(phase_profile())
        lap("phase 3c")
        # after phase 3c: its trace's kernel count is read before the
        # per-batch route's CUDA-only profiler session here
        paths[EVAL_RECIPE] = phase_eval_recipe()
        lap("phase 2c at the recipe's size")
        paths["TransE_l2 async"] = phase_main_path(
            TRANSE, batch_size_eval=500, extra=("--async_update",),
            label="TransE_l2 async")
        paths["TransE_l2 host-fed"] = phase_host_fed()
        paths["TransE_l2 s = 1"] = phase_step_one()
        phase_fed_profile()
        lap("phase 4")
        paths["RESCAL"] = phase_main_path(RESCAL,
                                          batch_size_eval=RESCAL_EVAL_BATCH)
        phase_step_parity(RESCAL)
        profiles["RESCAL"] = phase_step_profile(RESCAL, steps=20)
        profiles["RESCAL graph"] = phase_step_profile(RESCAL, steps=20,
                                                      route="graph")
        profiles["RESCAL bf16"] = phase_step_profile(
            dict(RESCAL, compute_dtype="bfloat16"), steps=20)
        phase_bf16_step_parity(RESCAL)
        phase_bf16_step_parity(TRANSR)
        print_bf16_profiles(profiles)
        lap("phase 5")
        paths.update(phase_serving())
        lap("phase 5b")
        paths["wikikg2"], ds, model, state = phase_wikikg2()
        phase_sampled_ranks(ds, model, state)
        phase_wiki_eval_routes(ds, model, state)
        phase_candidates(model, state, ds)
        k1_wiki, k2_wiki = phase_wiki_kernels(state)
        kernels[0].update(k1_wiki)
        kernels[2].update(k2_wiki)
        phase_chunked_save(model, state)
        lap("phase 6")
        del ds, model, state
        phase_step_parity(WIKI, n_ent=WIKI_ENT, n_rel=WIKI_REL)
        for route in ("eager", "graph"):
            profiles["wikikg2" + (" graph" if route == "graph" else "")] = \
                phase_step_profile(WIKI, steps=50, n_ent=WIKI_ENT,
                                   n_rel=WIKI_REL, route=route)
        print_route_profiles(profiles)
        lap("phase 6 profiles")
        gc.collect()
        torch.cuda.empty_cache()
        kernels += phase_host_kernels()
        paths["TransE_l2 host"] = phase_host_main()
        paths.update(phase_host_valid())
        phase_host_step_parity(TRANSE)
        phase_host_flagship_profile()
        lap("phase 6b")
        # the native LDG runs on the host beside the planted gates, and is
        # done before the capacity run needs the host's memory
        ldg = start_ldg()
        phase_planted()
        phase_ldg(ldg)
        lap("phases 7 and 7d")
        # the ranks' processes take the card next: free what this one holds
        gc.collect()
        torch.cuda.empty_cache()
        phase_dist_step_parity()
        paths.update(phase_dist_flagship())
        paths.update(phase_dist_wn18())
        paths.update(phase_dist_wikikg2())
        paths.update(phase_dist_nccl())
        paths.update(phase_dist_partition())
        lap("phase 7c")
        gc.collect()
        # pinned staging buffers cached by torch go back to the host first
        getattr(torch._C, "_host_emptyCache", lambda: None)()
        paths["Freebase host"] = phase_capacity()
        lap("phase 7b")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    # launches: the sum over the main-path runs, each read around its own
    # run only; a kernel on mapped host tables over the host paths, the
    # same kernel on the card's own memory over the others
    for k in kernels:
        counter = k.pop("counter", k["name"])
        on = k.pop("paths", None) or [
            p for p in paths if p not in HOST_PATHS
            or k["name"] not in ("gather_rows", "sparse_adagrad_rows")]
        k["launches"] = sum(paths[p][counter] for p in on)
        k["launches_by_path"] = {p: paths[p][counter] for p in on}
        if k["launches"] <= 0:
            fail(f"kernel {k['name']} was launched on no main path")
    print("kernels: " + ", ".join(
        f"{k['name']} ({k['route']}, launches "
        + " + ".join(f"{n} {p}" for p, n in k["launches_by_path"].items())
        + ")" for k in kernels))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dist-worker":
        sys.exit(dist_worker(sys.argv[2]))
    if sys.argv[1:] == ["--ldg-worker"]:
        sys.exit(ldg_worker())
    sys.exit(main())
