#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

  1. card    the GPU's name and power limit, as nvidia-smi gives them;
  2. build   every CUDA kernel from the sources in tlsan_tpu_torch/csrc/,
             one nvcc per source, all started together (K3's dh = 8
             variant without dropout and both of K3b's dh = 8 variants must
             not spill; K3b's registers and spills logged per variant);
  3. kernel  each kernel against its plain PyTorch version on the card
             (TF32 off), with lengths 0, 1 and the full length: K1
             (fwa_fwd) at the serving shapes B=128, S=10 and S=25, and
             B=37, S=17; K2 (fwa_bwd) at the training shapes B=32, S=10 and
             S=25, and B=37, S=17, also against autograd of the plain
             forward, through FWAFunction (K1 forward, K2 backward); both
             twice for bitwise repeatability, with a length above S too, and
             at the edges of their one-warp-per-(row, head) mapping (S = 1,
             32, 33 and 64 at B=37, the largest S of the first designs at
             B=4, heads of 16 and 32 features); then an empty kernel's
             device time, the launch floor, and K1 and K2 at B=8192, S=25
             beside their bound (a scale check); K3 (mha_fwd) at the
             ATRank shapes B=128 and B=32 with (Tq, Tk) = (96, 96) and
             (1, 96), and B=37 (17, 17), self-attention (queries is keys)
             and cross-attention, twice for bitwise repeatability, and
             MHAFunction's gradients against autograd of the plain version,
             also at the edges of its cluster-per-row mapping (B = 1 and
             200, heads of 16 and 32 features, T = 129 and 256, readouts
             over 256 keys); a cluster the card refuses must raise; the
             table of clusters the card runs at once against the card, for
             K3 and K3b; K3b (mha_bwd; its plan and layout logged and the
             layout held against the kernel's) at every one of those
             shapes against the plain
             backward (multihead_attention_backward_reference), with and
             without a dropout mask, twice for bitwise repeatability, and
             MHAFunction's gradients (K3, then K3b) against autograd, all to
             MHA_GRAD_TOL of each entry's terms' magnitudes; times of each (device time from the profiler,
             per-call time from CUDA events; K3b's at the train step's B=32),
             and the card's bound;
     dropout K1 and K2 at the train step's shapes (B=32, S=10 and 25)
             and K3 and K3b at B=32, (96, 96) self-attention and (1, 96)
             readout, with keep masks at rate 0.1 drawn on the card, against their
             plain versions given the same masks (KERNEL_TOL; K2 to its
             error scale; FWAFunction and MHAFunction gradients against
             autograd), the dispatchers against the plain versions drawing
             from a generator in the same state, bitwise repeatable, every
             mask's keep share within 5 binomial deviations; per-call,
             device and plain times of the masked kernels and their bound
             (the masks' bytes added) beside the unmasked kernels';
     widths  the wide variants, at shapes of the width grid (every D with
             any H dividing it): K1 and K2 at heads of 64 to 1024
             features and B=32, 128, S=10, 25 and past a chunk of steps;
             K3 and K3b at heads of 64 features, D=256, 512 and 1024 at
             (96, 96), (128, 128), (1, 96) and (1, 256), D=50 in 5 and 2
             heads, 300 keys, K3's wide variant with several key and
             feature chunks, a float at a time, both projection tiles and
             in several passes (bit for bit against one), K3b in shared
             memory and in device memory; each against its plain
             version with and without dropout masks (K1 and K3 to
             KERNEL_TOL, or KERNEL_TOL · (1 + the output's magnitude) at
             heads of 128 features and more and D past 256; K2 and K3b to
             their error scales), at R=2 against single launches bit for
             bit, FWAFunction and MHAFunction against autograd, 201 calls
             equal at each timed shape, per-call, device and plain times at
             five shapes (K1, K2, K3) or four (K3b) beside the bound
             (a wide K1's or K2's launches summed into one call).  After the
             families' phases, seven configurations at the Electronics
             catalog (ATRank num_heads=1; hidden_units=256, 512 and 1024
             in 8 heads with item and category embeddings of half that;
             TLSAN num_heads=1; TLSAN hidden_units=128 and 1024 in one
             head, its item, category and user embeddings half that
             wide): one chunk of 100 steps
             of batch 32, a bulk recommend of 4,000 users (launches exact,
             512 users as the CPU serves them), 20 steps against the CPU
             (PARITY_TOL; lr 0.1 for TLSAN, 0.01 for ATRank, 0.001 at D =
             1024), a profiled chunk of ATRank in one head and at D = 512
             and of TLSAN at D = 1024 (the attention kernels' device
             shares); in the cli
             phase train.cli --model atrank --num_heads 1 for one epoch at
             batch 128 on the Digital-Music fixture, K3 and K3b counted
             exactly;
  4. path    per family (TLSAN, ATRank, then the seven baselines below)
             at the reference widths (TLSAN and ATRank: D=64, H=8, 32-wide
             embeddings, one block; TLSAN Ls=10, Ts=24; ATRank T=96) and the Electronics catalog (39,991 users, 22,048 items,
             673 categories; SURVEY.md dataset table), seeded random
             weights: checkpoint.save, Recommender.from_model_dir on cuda and
             on cpu, the HTTP service on 127.0.0.1 (healthz, a single and an
             8-request POST, 1,000 (TLSAN) or 500 (ATRank) timed single-user
             POSTs), then bulk recommends of 4,000 featurized users over a
             window of at least 3 s.  The kernel launch counts must rise by
             exactly the family's launches per request batch (TLSAN: K1 2,
             the long and the short tower; ATRank: K3 2 a block, the
             self-attention and the readout) and no other kernel may
             launch; the answers must match the same checkpoint served on
             the CPU through the plain versions;
  5. train   per family, the same model and catalog trained by
             `Trainer.train()` on the card: 9,600 seeded rows with a planted
             structure (a tenth with an empty history), 4,096 test users,
             TrainConfig defaults (sgd, lr 1.0, clip 5.0, batch 32, test
             batch 128) but 100 steps a chunk, eval and histogram summaries
             every 100 steps, a save gate of 0 and one epoch.  Launches a
             train step, an eval batch (AUC and top-k) and a summary are
             counted exactly (TLSAN: K1 2 / 4 / 2 and K2 2 a step; ATRank:
             K3 2 / 5 / 2 a block and K3b 2 a block a step, none in
             evaluation or serving); the loss must fall and the AUC end above 0.5 and the
             initial one; a second Trainer must restore the step and
             schedule count and evaluate bit for bit as the last save did;
             20 steps from the same start must agree with the CPU plain
             path.  Then train examples/s over a window of at least 3 s,
             eval users/s, and one profiled chunk;
  6. ext     after every family's path and train: the rest of the
             Trainer at the Electronics catalog, the reference widths and
             one seeded start a comparison: TLSAN 200 touched-row SGD
             steps against 200 dense ones in f32 (params within rtol
             2e-3, atol 2e-5, mean loss 1e-3) and in bf16 (2e-2, 2e-3,
             1e-2), with the idle share of one profiled sparse chunk;
             ATRank 100 sparse Adam steps against dense Adam in bf16
             (moments within rtol 5e-2, atol 2e-4 / 1e-7, params 1e-1);
             LSPM 200 touched-row SGD steps against dense in f32;
             Adadelta (lr 1.0) and RMSProp (lr 1e-3), 100 dense TLSAN
             steps each, against the CPU port within PARITY_TOL; the auto
             gate on an 80,000-item catalog (119,991 rows: sparse engages
             for SGD at batch 32, Adam at batch 256 stays dense), with 100
             dense and 100 sparse steps there in f32 and in bf16.  K1/K2/K3
             counted exactly in every run; examples/s of each logged;
  7. local   K1, K2, K3 and K3b against their plain versions at the per-rank
             shapes of a dp=2 mesh (B=64 a request batch, B=16 a train
             step), with times and bounds: K4, the kernels per rank;
  8. mesh    every family on ONE dp=2 × mp=2 world of four ranks (a
             single spawn): on one card four processes over Gloo with
             CUDA tensors, on four or more cards one a rank over NCCL
             (logged).  Per family each rank trains with `Trainer(dp=2, mp=2)` from the seed of
             a single-process Trainer on the card: 20 steps (lr 1.0 for
             TLSAN, 0.1 for ATRank; losses and every unpadded parameter
             within PARITY_TOL of the single process), one epoch of
             100-step chunks with evaluations of 1,024 test users (loss
             falls, AUC ends above 0.5 and its start), an evaluation equal
             to the single process's of the saved weights, and a timed
             chunk; then serves 1,000 featurized users with
             `Recommender(mesh=...)` (ids equal to
             the single-device Recommender's up to ties, scores within
             SCORE_TOL).  Every rank's K1/K2/K3 launches are counted
             exactly; a rank that fails, or a world past its time limit,
             fails the run.  The seven baselines on the same world: per
             family a Trainer(dp=2, mp=2) from the seed takes
             5 steps at lr 0.1 (`programs.chunk_program`), digests a
             summary, evaluates its 1,024 test users and saves; one
             process on the card does the same (losses and every unpadded
             parameter within PARITY_TOL, the metrics within one test
             user), and `Recommender(mesh=...)` serves the save to 1,024
             featurized users as one device does; no rank launches K1, K2
             or K3.  The three production legs of the JAX package's
             dry run (`programs.PRODUCTION_LEGS`: TLSAN sparse SGD in
             bf16, ATRank sparse Adam in bf16, LSPM sparse SGD in f32) on
             the same world: 20 steps, an evaluation and a save each,
             against one process on the card (f32: loss 1e-3, params rtol
             2e-3, atol 2e-5; bf16 SGD as the ext phase; bf16 Adam: each
             moment tree within a quarter of its norm, the params within
             2·lr a step), launches exact;
  8b. dropout the Trainer with dropout 0.1 for TLSAN and ATRank (the train
             phase's 300 steps and evaluations; K1/K2 and K3 launches exact,
             the losses finite, evaluation equal to rate 0 bit for bit); a
             TLSAN dp=2 leg with dropout (every rank takes its rows of the
             global batch's masks) against one process (PARITY_TOL); a
             fan-out of 4 seeds with dropout for TLSAN and ATRank (ATRank
             at FANOUT_PARITY_LR), each replica against a Trainer at its
             seed (PARITY_TOL), launches exact;
  8c. migrate the JAX package's TLSAN --model_dir (the committed fixture
             tlsan_tpu_torch/tools/fixtures/jax_tlsan/, written by
             tests/test_torch_checkpoint_jax.py: Adam, 3 steps, a 30-item
             catalog) resumed by the port's Trainer, whose next 5 steps with
             K1/K2 give the JAX Trainer's parameters (1e-4; b2 to the walk
             bound), and served by serve.cli --model_dir as the JAX
             Recommender serves it.  The TF migration tools need
             TensorFlow, which the card's machine lacks: they run in the
             CPU tests only (tests/test_torch_tf_import.py);
  9. cli     the three command lines in-process through their main(argv),
             as a user runs them, with no pandas: data.cli download (a
             file:// base URL), convert and remap of seeded SNAP dumps
             (tools/snap_fixture.py) that must remap to exactly the
             Electronics counts (39,991 users, 22,048 items, 673
             categories, 561,100 reviews; filtered rows and an asin
             without meta on top); train.cli --model tlsan for one epoch
             at the reference widths and batch 128 from a cold cache (the native builder
             must run; chunks of 500, evaluations every 1,000 steps; K1
             and K2 counted exactly for the steps, evaluations and
             summaries; AUC must rise; latest and sidecar written); then
             serve.cli --k 50 --out for every test user from a cache hit,
             its first 512 users as the CPU Recommender serves them, and
             `python -m tlsan_tpu_torch.bench.http` at its defaults (2,000
             requests in POSTs of 128) on that model_dir; then
             on a Digital-Music-sized fixture (1,659 users, 1,583 items,
             53 categories, 28,852 reviews) train.cli --model atrank (K3
             exact), --model tlsan --dropout 0.1 and --model atrank
             --dropout 0.1 (batch 128; the kernels with the masks,
             launches exact),
             and --model tlsan in one process and on a dp=2 × mp=2
             world (every evaluation within 1e-4), --model tlsan --profile
             (its trace of three chunks names fwa_fwd_kernel and
             fwa_bwd_kernel; their launches counted), and every family's
             prepare with the native builder byte for byte as the numpy
             builders give it.  One line a stage with its seconds;
  10. fanout  the replica fan-out (train/ensemble.py), R replicas in one
             launch of each kernel: K1, K2, K3 and K3b with a replica axis of
             weights at R = 1, 3 and 8 (the train step's B=32, the AUC
             pass's B=128, B=37 and edges of their mappings) against their
             plain versions on each replica (KERNEL_TOL; K2 to its error
             scale; K3b to MHA_GRAD_TOL) and against single launches on each
             replica's slice, bit for bit (K3 where the plan's cluster size
             is the same for R·B rows as for B, else within KERNEL_TOL),
             bitwise
             repeatable, with per-call and device times of one replica
             launch, one single launch and R of them, and the bound at R;
             FWAFunction and MHAFunction under torch.func.vmap (one launch
             each way, gradients against autograd of the plain version under
             vmap).
             Then TLSAN, ATRank and LSPM fan-outs of 8 seeds at the
             Electronics catalog on the train phase's planted rows: each
             replica's 20 steps against a Trainer at its seed
             (PARITY_TOL), the per-replica AUC against the single
             evaluator on the same weights (within one test user), TLSAN
             lr_scales [1, 2] against Trainers at lr and 2·lr and a bf16
             fan-out of 2 seeds against bf16 Trainers, launches
             exact (TLSAN K1 2 and K2 2 a step, ATRank K3 2 and K3b 2 a
             block a step, LSPM none, whatever R is; an AUC batch K1 2 or
             K3 3),
             replica-examples/s of a 100-step chunk at R = 1 and R = 8
             beside the Trainer's, the idle share of one profiled R = 8
             chunk; and `python -m tlsan_tpu_torch.train.ensemble` on the
             cli phase's Digital-Music file, 2 seeds, one epoch (one JSON
             line with the JAX fan-out's keys, K1/K2 exact);
  11. bench   the benchmark entry points (tlsan_tpu_torch/bench/) as
             subprocesses from the repository's root, at reduced sizes:
             bench.train on the tracked Digital_Music cache (--steps 400
             --steps_per_call 200 --baseline_steps 20) in f32 and bf16,
             exactly 2 K1 and 2 K2 launches a timed step and no plain FWA
             on the card; bench.kernels --big_batch 2048 (each kernel
             checked against its plain version before it is timed, 32
             rows); bench.roofline --steps_per_call 50 (only its full
             step's time and the idle share of a full chunk, in (0, 1),
             are read: its stage deltas at this K are within the host's
             noise); bench.http --reqs 256 on the migration fixture, a
             check of the path.  Each JSON line's keys, metric name,
             device (the card's nvidia-smi line) and positive finite
             values;
  12. summary per family one line of train examples/s, eval users/s, bulk
             users/s, HTTP p50/p99 and idle shares beside the card's name
             and power limit, and of the fan-out's readings; the whole
             run's wall time; one JSON line of per-kernel numbers (with the
             fanout phase's replica fields, the dropout phase's masked
             fields and the dropout paths' launches, and the widths phase's
             wide_* fields); then the device line last.

The seven baselines (SHAN, PACA, BPR-MF, LSPM, CNN, Bi-LSTM, CSAN) run
phases 4 and 5 after TLSAN and ATRank, at the reference widths of their
flag tables (SURVEY.md §2.6) and the same catalog: SHAN and PACA 32-wide
items (SHAN Ls=96, Ts=24; PACA 90 positions, 10 kernels), BPR-MF 64-wide
users against item(32)⊕cate(32), LSPM k=5, CNN T=80 with ten towers of 32
filters, Bi-LSTM 64 hidden units at T=96, CSAN hidden_units 32 at T=96.
They launch no kernel of the port, so every one of their phases checks
that the K1, K2 and K3 counts do not move.  Their depths are shallower:
200 timed HTTP POSTs (Bi-LSTM 100), a 2 s bulk window, the CPU check on
the first 512 bulk users and every HTTP answer; 200 train steps of batch
32 in chunks of 50 (Bi-LSTM, whose step is some 8,000 launches: 50 in
chunks of 10, evaluated every 50)
on rows planted on 16 items and 8 categories with negatives from the
whole catalog, evaluations of 1,024 test users every 100 steps, 1 s train
and eval windows, 10 steps against the CPU plain path.

It needs the repository's tlsan_tpu_torch package beside it and CUDA; it
imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
from typing import Callable

import numpy as np
import torch

from tlsan_tpu_torch.bench.bounds import (
    F32_FLOPS_PER_S,
    HBM_BYTES_PER_S,
    bound_ms,
    card_line,
    device_profile,
    fwa_bound,
    fwa_bwd_bound,
    idle_share,
    mha_bound,
    mha_bwd_bound,
)
from tlsan_tpu_torch.core.config import ModelConfig, TrainConfig
from tlsan_tpu_torch.data import cli as data_cli
from tlsan_tpu_torch.data import native
from tlsan_tpu_torch.data.batcher import Batches, epoch_index, round8
from tlsan_tpu_torch.data.remap import load_category
from tlsan_tpu_torch.models import get_model
from tlsan_tpu_torch.models.atrank import ATRank
from tlsan_tpu_torch.models.tlsan import TLSAN
from tlsan_tpu_torch.ops.cuda import build
from tlsan_tpu_torch.ops.cuda import fwa as cuda_fwa
from tlsan_tpu_torch.ops.cuda import mha as cuda_mha
from tlsan_tpu_torch.tools.widths import WIDTHS_FWA, WIDTHS_MHA
from tlsan_tpu_torch.ops.feature_attention import (
    feature_wise_attention_reference,
    fwa_backward_error_scale,
    fwa_backward_reference,
)
from tlsan_tpu_torch.ops.multihead_attention import (
    multihead_attention_backward_error_scale,
    multihead_attention_backward_reference,
    multihead_attention_reference,
)
from tlsan_tpu_torch.parallel import programs
from tlsan_tpu_torch.parallel.multihost import run_local
from tlsan_tpu_torch.serve import cli as serve_cli
from tlsan_tpu_torch.serve.featurize import featurize_many
from tlsan_tpu_torch.serve.http import RecommendService, serve
from tlsan_tpu_torch.serve.recommender import Recommender
from tlsan_tpu_torch.train import checkpoint
from tlsan_tpu_torch.train import cli as train_cli
from tlsan_tpu_torch.train import ensemble
from tlsan_tpu_torch.train.ensemble import ReplicaFanout
from tlsan_tpu_torch.train.evaluate import Evaluator
from tlsan_tpu_torch.train.loop import Trainer
from tlsan_tpu_torch.tools.snap_fixture import write_snap_fixture

SEED = 1234
KERNEL_TOL = 1e-5    # f32 parity, the bar of tests/test_pallas_{fwa,mha}.py
# K2 against its plain version and autograd: the bars of the JAX backward
# test (tests/test_pallas_fwa.py:58-61), rtol taken of the magnitude of the
# terms each entry sums, since the sums run in another order (_max_err)
BWD_RTOL, BWD_ATOL = 1e-5, 1e-6
# K3b against the plain backward and MHAFunction against autograd: the bar
# of tests/test_pallas_mha.py:46-47, atol and rtol, the rtol taken of the
# magnitude of the terms each entry sums (_mha_grad_err), as K2's is: an
# f32 weight gradient of K3b, of the plain backward and of autograd each
# miss the float64 gradient by a few ε of that magnitude, which a bar
# relative to the value (allclose) does not allow where the terms cancel
MHA_GRAD_TOL = 1e-5
SCORE_TOL = 1e-4     # kernel path vs CPU plain path, after a 64-wide product
HTTP_SCORE_TOL = 1.5e-4  # HTTP scores travel rounded to 4 decimals
# Electronics after preprocessing (SURVEY.md dataset statistics)
USERS, ITEMS, CATES = 39_991, 22_048, 673
LS, TS, BATCH, K = 10, 24, 128, 50
D, H = 64, 8
# ATRank's history cap: the reference's 90 events (tlsan_tpu/data/builders.py), padded
# to a multiple of 8 as the JAX package's packers do
T_ATRANK = round8(90)
# main-path FWA shapes per request batch: long tower S=Ls, short tower S=Ts+1
MAIN_SHAPES = [(BATCH, LS), (BATCH, TS + 1)]
# the edges of K1/K2's one-warp-per-(row, head) mapping: one step, a full
# warp of steps, one past it and two warps' worth (B=37), the largest S the
# first designs took (K1 301, K2 181) at B=4, and heads of 16 and 32
# features; shapes are (B, S) at D, H or (B, S, D, H)
FWA_EDGES = [(37, 1), (37, 32), (37, 33), (37, 64), (37, 17, 64, 4), (37, 17, 128, 4),
             (4, 40, 128, 4)]
KERNEL_SHAPES = MAIN_SHAPES + [(37, 17)] + FWA_EDGES + [(4, 301)]
BULK_USERS = 4_000   # not a multiple of 128: the last batch has 0-length rows
BULK_WINDOW_S = 3.0  # bulk users/s: every user served over one window

# training (TrainConfig defaults: batch 32, test batch 128)
TRAIN_B, TEST_B = 32, 128
# main-path FWA shapes per train step: long tower S=Ls, short tower S=Ts+1
TRAIN_SHAPES = [(TRAIN_B, LS), (TRAIN_B, TS + 1)]
BWD_SHAPES = TRAIN_SHAPES + [(37, 17)] + FWA_EDGES + [(4, 181)]
# a scale check, not a main-path shape: 52 MB of x, where bytes dominate
FWA_SCALE = (8192, TS + 1)
# main-path K3 shapes (B, Tq, Tk) per request batch and per train step:
# the self-attention block and the 1-query readout
MHA_MAIN = [(BATCH, T_ATRANK, T_ATRANK), (BATCH, 1, T_ATRANK)]
MHA_TRAIN = [(TRAIN_B, T_ATRANK, T_ATRANK), (TRAIN_B, 1, T_ATRANK)]
# the edges of K3's cluster-per-row mapping, (B, Tq, Tk) at D, H or
# (B, Tq, Tk, D, H): one row (clusters of 8) and 200 rows (clusters of 1),
# heads of 16 and 32 features, T past 128 (groups of 32 lanes), T = 256
# (at B=200 the shared memory takes clusters of 4) and the readout over
# 256 keys; heads of 12 and 15 features (K3b's resident generic variant,
# at clusters of 4 and, with padded head columns, of 1), 600 query rows
# over 17 keys and 600 over 600 (K3 past 256 keys; K3b streamed in shared
# memory, the latter in query blocks of 2) and 700 over 700 (K3b streamed
# in device memory, MHA_BWD_GLOBAL)
MHA_BWD_GLOBAL = (3, 700, 700)
# K3b's calls at the train step's shapes that must all equal the first: a
# race between a cluster's CTAs shows as a call that differs
MHA_BWD_REPEATS = 200
MHA_EDGES = [(1, T_ATRANK, T_ATRANK), (1, 1, T_ATRANK), (200, T_ATRANK, T_ATRANK),
             (200, 1, T_ATRANK), (37, 17, 17, 64, 4), (37, 17, 17, 128, 4),
             (37, 129, 129), (4, 256, 256), (200, 256, 256), (37, 1, 256),
             (9, 7, 250, 64, 4), (37, 17, 17, 48, 4), (37, 17, 17, 60, 4),
             (3, 600, 17), (3, 600, 600), MHA_BWD_GLOBAL]
MHA_SHAPES = MHA_MAIN + MHA_TRAIN + [(37, 17, 17)] + MHA_EDGES
TRAIN_ROWS, TEST_USERS, STEPS_PER_CALL = 9_600, 4_096, 100
EMPTY_HISTORY_SHARE = 0.1  # rows with sl = 0
PLANTED_CATES = 128  # categories the seeded rows use, of the catalog's 673
PARITY_STEPS = 20
DROPOUT = 0.1  # the dropout phases' rate
# GPU (kernels, atomics in the gathers' backward) against the CPU plain
# path after 20 steps of lr 1.0: f32 sums in other orders, amplified by
# training
PARITY_TOL = 1e-4
TRAIN_WINDOW_S = 3.0
EVAL_WINDOW_S = 2.0
EVAL_EVERY = 100  # steps between evaluations

# the seven baselines (SHAN, PACA, BPR-MF, LSPM, CNN, Bi-LSTM, CSAN): the
# same catalog at shallower depths, so that the whole run stays near 450 s
PAIRWISE = ("bpr", "lspm")  # (i, j) pairs, no label
LS_SHAN = T_ATRANK  # SHAN's long history, at the prefix families' cap
T_PACA = 90         # round8(90) capped at paca_max_len (train/cli.py:131-137)
T_CNN = 80          # the CLI's CNN history cap (train/cli.py:145)
LSPM_K = 5
PLANTED_ITEMS = 16  # the items the baselines' seeded rows use (see below)
BASE_PLANTED_CATES = 8
# Bi-LSTM's step is some 8,000 launches (96 steps × 2 directions, forward
# and backward): 50 steps in chunks of 10 with evaluations every 50, and 100
# timed HTTP POSTs
BILSTM_TRAIN_ROWS, BILSTM_STEPS_PER_CALL, BILSTM_EVAL_EVERY = 1_600, 10, 50
BILSTM_LATENCY_REQUESTS = 100
BASE_LATENCY_REQUESTS = 200  # p99 is the 2nd slowest
BASE_BULK_WINDOW_S = 2.0
BASE_CPU_CHECK_USERS = 512   # 4 whole batches: the CPU runs CSAN's [B,T,T,E] slowly
BASE_TRAIN_ROWS, BASE_TEST_USERS, BASE_STEPS_PER_CALL = 6_400, 1_024, 50
BASE_PARITY_STEPS = 10
BASE_TRAIN_WINDOW_S, BASE_EVAL_WINDOW_S = 1.0, 1.0
# their mesh: 5 steps at lr 0.1 from one process's seed, then an
# evaluation and a save of 1,024 test users, served to 1,024 users
MESH_BASE_STEPS, MESH_BASE_LR, MESH_BASE_USERS = 5, 0.1, 1_024

# the mesh: dp=2 × mp=2, each rank with half of every batch's rows
MESH_DP, MESH_MP = 2, 2
MESH_SERVE_B, MESH_TRAIN_B = BATCH // MESH_DP, TRAIN_B // MESH_DP
# one timed chunk and one timed serving call, evaluations of 1,024 test
# users and 1,000 users served: the whole run stays near 600 s
MESH_TIMED_CHUNKS, MESH_SERVE_CALLS = 1, 1
MESH_TEST_USERS, MESH_BULK_USERS = 1_024, 1_000  # a partial last batch
MESH_TIMEOUT_S = 480
# K4's per-rank shapes: K1 and K2 at the local rows of a request batch and
# a train step, K3 likewise
LOCAL_FWA = [(MESH_SERVE_B, LS), (MESH_SERVE_B, TS + 1)]
LOCAL_FWA_TRAIN = [(MESH_TRAIN_B, LS), (MESH_TRAIN_B, TS + 1)]
LOCAL_MHA = [(MESH_SERVE_B, T_ATRANK, T_ATRANK), (MESH_SERVE_B, 1, T_ATRANK)]
LOCAL_MHA_TRAIN = [(MESH_TRAIN_B, T_ATRANK, T_ATRANK), (MESH_TRAIN_B, 1, T_ATRANK)]

# the cli phase: seeded SNAP dumps that remap to exactly these counts
# (users, items, categories, reviews; SURVEY.md dataset table)
CLI_FIXTURES = {"Electronics": (USERS, ITEMS, CATES, 561_100),
                "Digital_Music": (1_659, 1_583, 53, 28_852)}
CLI_CPU_CHECK_USERS = 512
# the Electronics epoch at batch 128: 2,375 steps where batch 32 took 9,500
# (70-101 s of the run), still 500 a chunk and three evaluations
CLI_ELECTRONICS_BATCH = 128
CLI_MESH_EVAL_FREQ = 200
CLI_MESH_TOL = 1e-4
CLI_FAMILIES = ("tlsan", "atrank", "shan", "csan", "lspm", "paca", "cnn",
                "bilstm", "bpr")

# the ext phase: the rest of the Trainer (sparse updates, bf16, Adam,
# Adadelta, RMSProp, the auto gate, profile_trace)
EXT_STEPS = 200        # sparse against dense, TLSAN (f32 and bf16) and LSPM
EXT_ADAM_STEPS = 100   # ATRank, sparse Adam against dense Adam, in bf16
EXT_OPT_STEPS = 100    # Adadelta and RMSProp on the card against the CPU
EXT_GATE_ITEMS = 80_000  # + the 39,991 users: 119,991 rows ≥ sparse_auto_rows
EXT_GATE_STEPS = 100   # the readings at the 80,000-item catalog
EXT_PROFILE_STEPS = 100  # the profiled sparse chunk
ADAM_LR = 0.01         # the JAX dry run's Adam rate (__graft_entry__.py:213)
# sparse against dense: tests/test_sparse.py:101-106 (f32), :271-274
# (bf16), :298-316 (Adam in bf16: the moments tight, the parameters to
# the walk of its near-zero-grad leaves)
SPARSE_RTOL, SPARSE_ATOL, SPARSE_LOSS_RTOL = 2e-3, 2e-5, 1e-3
BF16_RTOL, BF16_ATOL, BF16_LOSS_RTOL = 2e-2, 2e-3, 1e-2
ADAM_BF16_MU, ADAM_BF16_NU, ADAM_MOMENT_RTOL, ADAM_WALK = 2e-4, 1e-7, 5e-2, 1e-1
# the production legs on the mesh world: 20 steps of each; Adam's moment
# trees in bf16 within a quarter of their norm (tests/test_torch_sparse_mesh.py)
MESH_LEG_STEPS = 20
MESH_BF16_MOMENT_NORM = 0.25
# the cli phase's train.cli --profile run: chunks of 20, three traced
CLI_PROFILE_STEPS_PER_CALL = 20

# the fanout phase: R replicas in one launch of each kernel.  The kernels
# at R = 1, 3 and 8 on the fan-out's shapes (a train step at B=32, its AUC
# pass at B=128), B=37 and the edges of their mappings where R of them fit;
# the path at R = 8 (the README's seed envelope), 20 steps of each replica
# against a Trainer at its seed, lr_scales [1, 2], examples/s of a 100-step
# chunk at R = 1 and R = 8 and the idle share of one; the command line on
# the cli phase's Digital-Music fixture, 2 seeds, one epoch
FANOUT_R = 8
FANOUT_SEEDS = [SEED + r for r in range(FANOUT_R)]
FANOUT_KERNEL_RS = (1, 3, FANOUT_R)
FANOUT_FWA = TRAIN_SHAPES + MAIN_SHAPES + [(37, 17), (37, 1), (37, 33), (37, 17, 128, 4)]
FANOUT_MHA = MHA_TRAIN + MHA_MAIN + [(37, 17, 17), (1, T_ATRANK, T_ATRANK),
                                     (37, 1, 256), (9, 7, 250, 64, 4)]
# the parity runs' lr: each family's parity lr, ATRank's 0.01.  A replica
# launch of R·B rows takes another K3 cluster size and a batched product
# rounds otherwise than a single one, so at R = 8 a replica starts one ulp
# from its Trainer (at R = 1 the two are bit for bit); TLSAN stays there,
# while at lr 0.1 and 1.0 an ATRank ReLU unit within rounding of its kink
# flips within 20 steps and the two part by 1e-4 and more (PERF.md §6)
FANOUT_PARITY_LR = {"atrank": 0.01}
FANOUT_LR_SCALES = [1.0, 2.0]
FANOUT_CLI_SEEDS = ["1", "2"]

KERNELS = [{"name": "fwa_fwd", "route": "cuda",
            "source": "tlsan_tpu_torch/csrc/fwa_fwd.cu",
            "replaces": "tlsan_tpu/ops/pallas/fwa.py:40"},
           {"name": "fwa_bwd", "route": "cuda",
            "source": "tlsan_tpu_torch/csrc/fwa_bwd.cu",
            "replaces": "tlsan_tpu/ops/pallas/fwa.py:125"},
           {"name": "mha_fwd", "route": "cuda",
            "source": "tlsan_tpu_torch/csrc/mha_fwd.cu",
            "replaces": "tlsan_tpu/ops/pallas/mha.py:47"},
           {"name": "mha_bwd", "route": "cuda",
            "source": "tlsan_tpu_torch/csrc/mha_bwd.cu",
            "replaces": "tlsan_tpu/ops/pallas/mha.py:153"}]
# K4 has no source of its own: each rank runs K1/K2 (TLSAN) or K3/K3b
# (ATRank) on its rows; its numbers are those at the per-rank request-batch
# shapes
K4 = [{"name": "fwa_per_rank", "route": "cuda",
       "source": "tlsan_tpu_torch/csrc/fwa_fwd.cu",
       "replaces": "tlsan_tpu/ops/pallas/sharded.py:22",
       "kernels": ("fwa_fwd", "fwa_bwd")},
      {"name": "mha_per_rank", "route": "cuda",
       "source": "tlsan_tpu_torch/csrc/mha_fwd.cu",
       "replaces": "tlsan_tpu/ops/pallas/sharded.py:37",
       "kernels": ("mha_fwd", "mha_bwd")}]


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, stamped with the seconds since start."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def phase_card() -> str:
    line = card_line()
    print(line, flush=True)  # as nvidia-smi gives it, on a line of its own
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return line


def _variants(report: str, name: str) -> dict:
    """The ptxas report's (registers, spill stores, spill loads) of each
    variant of `name`'s kernel, by its template arguments ((DH, DROP) for
    K3 and K3b, (DH, ONE, DROP) for K1 and K2), and of its wide variant (a
    kernel `name`_wide_kernel, or K3b's WIDE argument) as ("wide", DROP),
    K3b's streamed ones as ("stream", DROP) and ("stream_wide", DROP); K1's,
    K2's and K3's wide variants are several kernels
    `name`_wide_<phase>_kernel, each ("wide_<phase>", DROP), DROP -1 where
    the phase has one variant, an int template argument N (K3's projection
    tile) as ("wide_<phase>_N", -1); a variant whose report does not parse
    is missing."""
    lines, out = report.splitlines(), {}
    for i, line in enumerate(lines):
        m = re.search(rf"{name}_kernelI((?:L[ib]\d+E)+)E", line)
        w = re.search(rf"{name}_wide_(?:([a-z0-9]+(?:_[a-z0-9]+)*?)_)?kernel"
                      r"(?:ILb([01])E|ILi(\d+)E)?", line)
        if not (m or w) or "Function properties for" not in line or i + 2 >= len(lines):
            continue
        if w:
            phase = ("wide" + (f"_{w.group(1)}" if w.group(1) else "")
                     + (f"_{w.group(3)}" if w.group(3) else ""))
            key = (phase, int(w.group(2)) if w.group(2) else -1)
        else:
            key = tuple(int(a) for a in re.findall(r"L[ib](\d+)E", m.group(1)))
            if name == cuda_mha.BWD_SOURCE:  # (DH, DROP, WIDE, STREAM)
                kind = ("stream_wide" if key[2] else "stream") if key[3] else "wide"
                key = (kind, key[1]) if key[2] or key[3] else key[:2]
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", lines[i + 1])
        regs = re.search(r"Used (\d+) registers", lines[i + 2])
        if spill and regs:
            out[key] = (int(regs.group(1)), int(spill.group(1)), int(spill.group(2)))
    return out


def phase_build() -> None:
    """Build every kernel; K3's dh = 8 variant without dropout and both of
    K3b's dh = 8 variants must not spill.  Every variant's registers and
    spills are logged, the wide variants' among them, which must exist."""
    t0 = time.perf_counter()
    reports = build.build([cuda_fwa.SOURCE, cuda_fwa.BWD_SOURCE, cuda_mha.SOURCE,
                           cuda_mha.BWD_SOURCE])
    log(f"build: {sorted(reports) or 'all cached'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "ptxas" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    # the dh = 8 variants must not spill: K3's without dropout, both of
    # K3b's; K3's dropout variant's report is logged (PERF.md: a few bytes,
    # a speed matter)
    for name, drops in ((cuda_fwa.SOURCE, ()), (cuda_fwa.BWD_SOURCE, ()),
                        (cuda_mha.SOURCE, (0,)), (cuda_mha.BWD_SOURCE, (0, 1))):
        if name not in reports:
            continue
        variants = _variants(reports[name], name)
        for key, (regs, stores, loads) in sorted(variants.items(), key=str):
            log(f"build: {name} variant {key} (dh or 'wide', ..., dropout): {regs} "
                f"registers, {stores} bytes spill stores, {loads} bytes spill loads")
        for drop in (0, 1):
            if not any(str(k[0]).startswith("wide") and k[1] == drop for k in variants):
                raise AssertionError(f"{name}: no report of its wide variant "
                                     f"(dropout={bool(drop)})")
        for drop in drops:
            if variants.get((8, drop), (0, 1, 1))[1:] != (0, 0):
                raise AssertionError(f"{name}'s dh = 8 variant (dropout={bool(drop)}) "
                                     f"spills: {variants.get((8, drop))}")


# ------------------------------------------------------------ launch counts


def reset_launches() -> None:
    programs.reset_launches()


def launch_counts() -> dict:
    return programs.launch_counts()


def expect_launches(before: dict, want: dict, what: str) -> dict:
    """The counts now must exceed `before` by exactly `want` (kernel →
    launches; a kernel not named must not have launched)."""
    now = launch_counts()
    got = {k: now[k] - before[k] for k in now}
    full = {k: want.get(k, 0) for k in now}
    if got != full:
        raise AssertionError(f"{what}: launches {got}, expected {full}")
    return now


def _times(per_unit: dict, n: int) -> dict:
    return {k: v * n for k, v in per_unit.items()}


def _plus(*counts: dict) -> dict:
    return {k: sum(c.get(k, 0) for c in counts) for k in launch_counts()}


# ------------------------------------------------------------------ kernels


def _fwa_shape(shape):
    """(B, S, D, H) of a K1/K2 shape given as (B, S) or (B, S, D, H)."""
    return (*shape, D, H)[:4]


def _fwa_inputs(B: int, S: int, seed: int, d: int = D, h: int = H):
    """x, lengths and the weights on the card; lengths 0, 1, S and, where B
    allows, S + 3 (more than the steps: nothing masked) in the first rows."""
    rng = np.random.default_rng(seed)
    dh = d // h
    lengths = rng.integers(0, S + 1, B).astype(np.int32)
    lengths[:4] = [0, 1, S, S + 3][:min(B, 4)]
    arrays = [rng.normal(size=(B, S, d)), lengths,
              rng.normal(size=(dh, dh)) * 0.3, rng.normal(size=(dh,)) * 0.1,
              rng.normal(size=(dh, dh)) * 0.3, rng.normal(size=(dh,)) * 0.1]
    return [torch.from_numpy(a.astype(np.int32 if i == 1 else np.float32)).cuda()
            for i, a in enumerate(arrays)]


def _cuda_ms(fn, iters: int = 100, warmup: int = 20, repeats: int = 5) -> float:
    """ms a call of fn: CUDA events around `iters` back-to-back calls, the
    median of `repeats` such runs (a host that is shared spreads single
    runs widely)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return float(np.median(runs))


def _device_ms(fn, kernel: str, calls: int = 50) -> str:
    """Device ms a call of fn (one launch) in the kernels whose names hold
    `kernel` (every variant of a template), over `calls` calls, from the
    profiler."""
    _, prof = device_profile(lambda: [fn() for _ in range(calls)])
    us = [us for key, (_, us) in prof.items() if kernel in key]
    return f"{1e-3 * sum(us) / calls:.6f}" if us else "not measured (no device events)"


def _device_split(fn, kernel: str, calls: int = 10) -> str:
    """Device ms a call of fn in each kernel whose name holds `kernel`, by
    the name from `kernel` on (a template's arguments kept), from the
    profiler: where a call's time goes among its launches."""
    _, prof = device_profile(lambda: [fn() for _ in range(calls)])
    split = {}
    for key, (_, us) in prof.items():
        if kernel in key:
            name = key[key.index(kernel):].split("(")[0]
            split[name] = split.get(name, 0.0) + 1e-3 * us / calls
    return ", ".join(f"{k} {v:.6f}" for k, v in sorted(split.items())) or "no device events"


def _summed(main: dict, worst: float) -> dict:
    ms, by = bound_ms((main.pop("bytes_ms"), main.pop("ops_ms")))
    return dict(main, max_abs_err=worst, bound_ms=ms, bound_by=by)


def _add(main: dict, kernel_ms, plain_ms, bytes_ms, ops_ms) -> None:
    for key, v in (("ms", kernel_ms), ("plain_ms", plain_ms),
                   ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
        main[key] = main.get(key, 0.0) + v


def _fwa_tag(kernel: str, B: int, S: int, d: int, h: int) -> str:
    return f"{kernel} B={B} S={S}" + ("" if (d, h) == (D, H) else f" D={d} H={h}")


def phase_kernel(shapes=KERNEL_SHAPES, main_shapes=MAIN_SHAPES) -> dict:
    """K1 against its plain version at every shape.  The returned times are
    per request batch: the sum over the two main-path launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst, main = 0.0, {}
    for i, shape in enumerate(shapes):
        B, S, d, h = _fwa_shape(shape)
        what = _fwa_tag("fwa_fwd", B, S, d, h)
        x, lengths, w1, b1, w2, b2 = _fwa_inputs(B, S, SEED + i, d, h)
        got = cuda_fwa.fwa_forward(x, lengths, h, w1, b1, w2, b2)
        again = cuda_fwa.fwa_forward(x, lengths, h, w1, b1, w2, b2)
        want = feature_wise_attention_reference(x, lengths, h, w1, b1, w2, b2)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: non-finite output")
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: two calls differ")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{what}: max abs err {err:.3e}")
        # a length-0 row is a uniform softmax over all S: the mean of x
        mean_err = float((got[0] - x[0].mean(0)).abs().max())
        if not mean_err <= KERNEL_TOL:
            raise AssertionError(f"{what}: the length-0 row is {mean_err:.3e} "
                                 "from the mean of x")
        kernel_ms = _cuda_ms(lambda: cuda_fwa.fwa_forward(x, lengths, h, w1, b1, w2, b2))
        plain_ms = _cuda_ms(lambda: feature_wise_attention_reference(
            x, lengths, h, w1, b1, w2, b2))
        bytes_ms, ops_ms = fwa_bound(B, S, d, h)
        device_ms = _device_ms(
            lambda: cuda_fwa.fwa_forward(x, lengths, h, w1, b1, w2, b2), "fwa_fwd_kernel")
        log(f"kernel {what}: max_abs_err={err:.3e} "
            f"kernel_ms={kernel_ms:.6f} device_ms={device_ms} plain_ms={plain_ms:.6f} "
            f"bound_us={1e3 * max(bytes_ms, ops_ms):.4f} "
            f"(bytes {1e3 * bytes_ms:.4f} us, operations {1e3 * ops_ms:.4f} us); "
            f"bitwise repeatable")
        if (B, S, d, h) in map(_fwa_shape, main_shapes):
            _add(main, kernel_ms, plain_ms, bytes_ms, ops_ms)
    return _summed(main, worst)


def _max_err(got, want, scale, what: str) -> float:
    """Max abs error over the gradient tuples; raises where an entry is off
    by more than atol + rtol · (Σ of its terms' magnitudes), the error
    bound of an f32 sum (fwa_backward_error_scale: db2 sums terms that
    cancel to 0, so a bar relative to its value would test noise)."""
    worst = 0.0
    for name, a, b, sc in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want, scale):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: non-finite {name}")
        err = (a - b).abs()
        if not bool((err <= BWD_ATOL + BWD_RTOL * sc).all()):
            raise AssertionError(
                f"{what}: {name} max abs err {float(err.max()):.3e} beyond "
                f"atol {BWD_ATOL} + rtol {BWD_RTOL} of its terms' magnitudes")
        worst = max(worst, float(err.max()))
    return worst


def phase_kernel_bwd(shapes=BWD_SHAPES, main_shapes=TRAIN_SHAPES) -> dict:
    """K2 against its plain version, autograd of the plain forward and
    itself, and FWAFunction against autograd.  The returned times are per
    train step: the sum over the two main-path launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst, main = 0.0, {}
    for i, shape in enumerate(shapes):
        B, S, d, h = _fwa_shape(shape)
        x, lengths, w1, b1, w2, b2 = _fwa_inputs(B, S, SEED + 10 + i, d, h)
        g = torch.from_numpy(np.random.default_rng(SEED + 20 + i).normal(
            size=(B, d)).astype(np.float32)).cuda()
        args = (x, lengths, h, w1, b1, w2, b2, g)
        what = _fwa_tag("fwa_bwd", B, S, d, h)
        got = cuda_fwa.fwa_backward(*args)
        again = cuda_fwa.fwa_backward(*args)
        torch.cuda.synchronize()
        for a, b in zip(got, again):
            if not torch.equal(a, b):
                raise AssertionError(f"{what}: two calls differ")
        scale = fwa_backward_error_scale(*args)
        worst = max(worst, _max_err(got, fwa_backward_reference(*args), scale,
                                    what + " vs fwa_backward_reference"))
        leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        out = feature_wise_attention_reference(leaves[0], lengths, h, *leaves[1:])
        auto = torch.autograd.grad(out, leaves, g)
        worst = max(worst, _max_err(got, auto, scale, what + " vs autograd"))
        # a length-0 row (row 0) still gets a gradient through the mask's add
        if not bool(got[0][0].abs().max() > 0):
            raise AssertionError(f"{what}: the length-0 row got no gradient")
        # FWAFunction (K1 forward, K2 backward) on a non-contiguous g
        leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        out_fn = cuda_fwa.FWAFunction.apply(leaves[0], lengths, h, *leaves[1:])
        if not float((out_fn - out).detach().abs().max()) <= KERNEL_TOL:
            raise AssertionError(f"{what}: FWAFunction forward differs")
        g_nc = g.t().contiguous().t()
        worst = max(worst, _max_err(torch.autograd.grad(out_fn, leaves, g_nc),
                                    auto, scale, what + " FWAFunction vs autograd"))

        kernel_ms = _cuda_ms(lambda: cuda_fwa.fwa_backward(*args))
        plain_ms = _cuda_ms(lambda: fwa_backward_reference(*args))
        bytes_ms, ops_ms = fwa_bwd_bound(B, S, d, h)
        device_ms = _device_ms(lambda: cuda_fwa.fwa_backward(*args), "fwa_bwd_kernel")
        log(f"kernel {what}: max_abs_err={worst:.3e} "
            f"kernel_ms={kernel_ms:.6f} device_ms={device_ms} plain_ms={plain_ms:.6f} "
            f"bound_us={1e3 * max(bytes_ms, ops_ms):.4f} "
            f"(bytes {1e3 * bytes_ms:.4f} us, operations {1e3 * ops_ms:.4f} us); "
            f"bitwise repeatable")
        if (B, S, d, h) in map(_fwa_shape, main_shapes):
            _add(main, kernel_ms, plain_ms, bytes_ms, ops_ms)
    return _summed(main, worst)


def phase_fwa_scale() -> None:
    """The launch floor (an empty kernel's device time) and K1 and K2 at one
    large shape, FWA_SCALE, where bytes dominate the bound: right, and
    their device time beside the bound.  A scale check; not a main path."""
    lib = cuda_fwa._library()

    def empty():
        err = lib.fwa_empty_launch(torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"empty launch failed: {lib.fwa_error_string(err).decode()}")

    log(f"kernel fwa_empty_kernel: device_ms={_device_ms(empty, 'fwa_empty_kernel')} "
        f"(the floor of a launch's device time)")
    B, S = FWA_SCALE
    x, lengths, w1, b1, w2, b2 = _fwa_inputs(B, S, SEED + 50)
    g = torch.from_numpy(np.random.default_rng(SEED + 51).normal(
        size=(B, D)).astype(np.float32)).cuda()
    args = (x, lengths, H, w1, b1, w2, b2)
    err = float((cuda_fwa.fwa_forward(*args)
                 - feature_wise_attention_reference(*args)).abs().max())
    if not err <= KERNEL_TOL:
        raise AssertionError(f"fwa_fwd B={B} S={S}: max abs err {err:.3e}")
    bwd_err = _max_err(cuda_fwa.fwa_backward(*args, g), fwa_backward_reference(*args, g),
                       fwa_backward_error_scale(*args, g), f"fwa_bwd B={B} S={S}")
    for name, kernel, fn, (bytes_ms, ops_ms), e in (
            ("fwa_fwd", "fwa_fwd_kernel", lambda: cuda_fwa.fwa_forward(*args),
             fwa_bound(B, S), err),
            ("fwa_bwd", "fwa_bwd_kernel", lambda: cuda_fwa.fwa_backward(*args, g),
             fwa_bwd_bound(B, S), bwd_err)):
        device_ms = _device_ms(fn, kernel)
        bound_ms = max(bytes_ms, ops_ms)
        share = (f"{bound_ms / float(device_ms):.3f}"
                 if device_ms[0].isdigit() else "not measured")
        log(f"kernel {name} B={B} S={S} (scale check): max_abs_err={e:.3e} "
            f"device_ms={device_ms} bound_ms={bound_ms:.6f} "
            f"(bytes {bytes_ms:.6f} ms, operations {ops_ms:.6f} ms); "
            f"share of the bound {share}")


def _mha_shape(shape):
    """(B, Tq, Tk, D, H) of a K3 shape given as (B, Tq, Tk) or (B, Tq, Tk, D, H)."""
    return (*shape, D, H)[:5]


def _mha_inputs(B: int, Tq: int, Tk: int, self_attention: bool, seed: int,
                d: int = D):
    """(queries, keys, q_len, k_len, weights) on the card at width d (the
    heads split it, so the inputs do not depend on their number); lengths
    in the first rows: queries T, 0, 1 and, for cross-attention, keys 0,
    Tk, 1, so that a single row is a full query and a length-0 row occurs
    (self-attention: row 1); with self_attention, keys is queries and k_len
    is q_len, as ATRank's self blocks call it."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    def lens(T, first):
        n = rng.integers(0, T + 1, B).astype(np.int32)
        n[:min(B, 3)] = first[:min(B, 3)]
        return torch.from_numpy(n).cuda()

    queries = f32(rng.normal(size=(B, Tq, d)))
    q_len = lens(Tq, [Tq, 0, 1])
    if self_attention:
        keys, k_len = queries, q_len
    else:
        keys, k_len = f32(rng.normal(size=(B, Tk, d))), lens(Tk, [0, Tk, 1])
    weights = {}
    for name in cuda_mha.WEIGHTS:
        if name.startswith("w"):
            weights[name] = f32(rng.normal(size=(d, d)) * 0.2)
        elif name == "ln_gamma":
            weights[name] = f32(1.0 + 0.1 * rng.normal(size=d))
        else:
            weights[name] = f32(0.1 * rng.normal(size=d))
    return queries, keys, q_len, k_len, weights


def _refused_cluster_raises() -> None:
    """A launch the card refuses (a cluster of 16 CTAs, above the portable
    8) raises RuntimeError, counts no launch and falls back to nothing."""
    q, k, ql, kl, w = _mha_inputs(2, 1, T_ATRANK, False, SEED + 29)
    plan = cuda_mha.launch_plan(2, 1, T_ATRANK, D, H)
    bad = dataclasses.replace(plan, cs=16, grid=2 * 16)
    real, before = cuda_mha.launch_plan, cuda_mha.launches
    cuda_mha.launch_plan = lambda *shape: bad
    try:
        cuda_mha.mha_forward(q, k, ql, kl, H, *(w[n] for n in cuda_mha.WEIGHTS))
    except RuntimeError as e:
        log(f"kernel mha_fwd: a cluster of 16 is refused and raises: {e}")
    else:
        raise AssertionError("mha_fwd: a cluster of 16 CTAs did not raise")
    finally:
        cuda_mha.launch_plan = real
    if cuda_mha.launches != before:
        raise AssertionError("mha_fwd: a refused launch was counted")


def _active_clusters_match() -> None:
    """launch_plan's and backward_plan's table of the clusters the card runs
    at once (cuda_mha.ACTIVE_CLUSTERS) against cudaOccupancyMaxActiveClusters
    on this card for K3 and for K3b, at one and at two CTAs an SM."""
    got = ctypes.c_int()
    smem = {2: 60_000, 1: 150_000}  # bytes a CTA that leave 2 and 1 CTAs an SM
    for name, fn in (("mha_fwd", cuda_mha._library().mha_fwd_active_clusters),
                     ("mha_bwd", cuda_mha._bwd_library().mha_bwd_active_clusters)):
        for (cs, per_sm), want in cuda_mha.ACTIVE_CLUSTERS.items():
            assert cuda_mha.ctas_per_sm(smem[per_sm]) == per_sm
            err = fn(cs, smem[per_sm], ctypes.byref(got))
            if err != 0 or got.value != want:
                raise AssertionError(
                    f"{name}: {got.value} clusters of {cs} at {per_sm} CTAs an SM run at "
                    f"once (error {err}); the plans assume {want}")
    log(f"kernel mha_fwd, mha_bwd: active clusters as the plans assume: "
        f"{cuda_mha.ACTIVE_CLUSTERS}")


def _bwd_plan_line(B: int, Tq: int, Tk: int, d: int, h: int, self_attention: bool) -> str:
    """K3b's plan at a shape, its layout and stage held against the
    kernel's own (make_layout and make_stream_layout in csrc/mha_bwd.cu,
    which refuse a launch whose layout differs)."""
    plan = cuda_mha.backward_plan(B, Tq, Tk, d, h, 1, self_attention)
    stage = ctypes.c_int()
    floats = cuda_mha._bwd_library().mha_bwd_layout_floats(
        Tq, Tk, d, h, d // h, plan.cs, plan.qb, plan.mode, int(plan.alias),
        ctypes.byref(stage))
    if (floats, stage.value) != (plan.per_cta, plan.stage):
        raise AssertionError(f"mha_bwd B={B} Tq={Tq} Tk={Tk}: the kernel's layout is "
                             f"{floats} + {stage.value} floats, backward_plan's "
                             f"{plan.per_cta} + {plan.stage}")
    design = ("resident", "streamed by heads", "streamed by rows")[plan.mode]
    where = "device memory" if plan.work else "shared memory"
    return (f"{design}, {plan.clusters} clusters of {plan.cs}, query blocks of {plan.qb}, "
            f"{where}, smem {plan.smem}")


def _mha_grad_err(got, want, scale, what: str) -> float:
    """Max abs error over gradient tuples (K3b's ten, or autograd's leaves);
    raises where an entry is off by more than MHA_GRAD_TOL · (1 + the Σ of
    its terms' magnitudes), multihead_attention_backward_error_scale."""
    worst = 0.0
    for i, (a, b, sc) in enumerate(zip(got, want, scale)):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{what}: non-finite gradient {i}")
        err = (a - b).abs()
        if not bool((err <= MHA_GRAD_TOL * (1.0 + sc)).all()):
            raise AssertionError(
                f"{what}: gradient {i} off by {float(err.max()):.3e}, beyond "
                f"{MHA_GRAD_TOL} · (1 + its terms' magnitudes)")
        worst = max(worst, float(err.max()))
    return worst


def _mha_scale(q, ql, k, kl, h, w, g, self_attention: bool, rate=0.0, mask=None,
               leaves: bool = False):
    """K3b's error scales (multihead_attention_backward_error_scale); with
    `leaves`, as autograd returns the leaves (queries[, keys], weights...):
    self-attention's queries and keys summed."""
    sc = multihead_attention_backward_error_scale(q, ql, k, kl, h, w, g, rate, mask)
    if leaves and self_attention:
        return (sc[0] + sc[1], *sc[2:])
    return sc


def _mha_function_err(q, k, ql, kl, h, w, g, self_attention: bool, what: str) -> float:
    """MHAFunction's gradients (K3 forward, K3b backward) against autograd
    of the plain version, held by `_mha_grad_err`."""
    grads = []
    for fn in (cuda_mha.MHAFunction.apply, None):
        x = q.clone().requires_grad_(True)
        y = x if self_attention else k.clone().requires_grad_(True)
        ws = [w[n].clone().requires_grad_(True) for n in cuda_mha.WEIGHTS]
        if fn is None:
            out, _ = multihead_attention_reference(
                x, ql, y, kl, h, dict(zip(cuda_mha.WEIGHTS, ws)))
        else:
            out = fn(x, y, ql, kl, h, *ws)
        leaves = [x, *ws] if self_attention else [x, y, *ws]
        grads.append(torch.autograd.grad(out, leaves, g))
    return _mha_grad_err(*grads, _mha_scale(q, ql, k, kl, h, w, g, self_attention, leaves=True),
                         f"{what}: MHAFunction vs autograd")


def _backward_launches(q, k, ql, kl, h, w, g, self_attention: bool) -> str:
    """The device launches (kernels and copies, from the profiler) of one
    MHAFunction backward, and of the route it replaced: the plain forward
    recomputed and its autograd backward."""
    counts = []
    for fn in (cuda_mha.MHAFunction.apply, None):
        x = q.clone().requires_grad_(True)
        y = x if self_attention else k.clone().requires_grad_(True)
        ws = [w[n].clone().requires_grad_(True) for n in cuda_mha.WEIGHTS]
        leaves = [x, *ws] if self_attention else [x, y, *ws]

        def plain():
            return multihead_attention_reference(x, ql, y, kl, h,
                                                 dict(zip(cuda_mha.WEIGHTS, ws)))[0]

        if fn is None:  # the recompute runs inside the profiled backward
            def work():
                return torch.autograd.grad(plain(), leaves, g)
        else:
            out = fn(x, y, ql, kl, h, *ws)

            def work():
                return torch.autograd.grad(out, leaves, g)
        _, prof = device_profile(work)
        counts.append(sum(n for n, _ in prof.values()))
    return (f"MHAFunction's backward {counts[0]} device launches (K3b and autograd's "
            f"own), the plain recompute and its autograd {counts[1]}")


def phase_kernel_mha(shapes=MHA_SHAPES, main_shapes=MHA_MAIN,
                     bwd_main_shapes=MHA_TRAIN) -> tuple:
    """K3 against its plain version and itself; K3b against the plain
    backward, with and without a dropout mask, and itself; MHAFunction's
    gradients (K3, then K3b) against autograd, at every shape, self- and
    cross-attention; a refused cluster launch must raise.  K3b must have
    run its resident design's generic variant, and its streamed design in
    shared memory and (at MHA_BWD_GLOBAL) in device memory.  Returns K3's row and K3b's: K3's times per request batch (the sum over the two
    main-path launches: self-attention and readout), K3b's per train step
    (B = 32); the other shapes are logged, K3b's untimed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst, main = 0.0, {}
    worst_b, main_b = 0.0, {}
    placed = set()  # K3b's (design, in device memory, a specialised head width) that ran
    mains = [_mha_shape(m) for m in main_shapes]
    bwd_mains = [_mha_shape(m) for m in bwd_main_shapes]
    _active_clusters_match()
    for i, shape in enumerate(shapes):
        B, Tq, Tk, d, h = _mha_shape(shape)
        for self_attention in ([True, False] if Tq == Tk else [False]):
            plan = cuda_mha.launch_plan(B, Tq, Tk, d, h, self_attention)
            q, k, ql, kl, w = _mha_inputs(B, Tq, Tk, self_attention, SEED + 30 + i, d)
            args = (q, k, ql, kl, h, *(w[n] for n in cuda_mha.WEIGHTS))
            what = (f"mha_fwd B={B} Tq={Tq} Tk={Tk}"
                    + ("" if (d, h) == (D, H) else f" D={d} H={h}")
                    + f" {'self' if self_attention else 'cross'}")
            got = cuda_mha.mha_forward(*args)
            again = cuda_mha.mha_forward(*args)
            want, _ = multihead_attention_reference(q, ql, k, kl, h, w)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{what}: non-finite output")
            if not torch.equal(got, again):
                raise AssertionError(f"{what}: two calls differ")
            err = float((got - want).abs().max())
            worst = max(worst, err)
            if not err <= KERNEL_TOL:
                raise AssertionError(f"{what}: max abs err {err:.3e}")

            # K3b against the plain backward, without and with a keep mask
            g = torch.from_numpy(np.random.default_rng(SEED + 40 + i).normal(
                size=(B, Tq, d)).astype(np.float32)).cuda()
            bwd = what.replace("mha_fwd", "mha_bwd")
            bplan = cuda_mha.backward_plan(B, Tq, Tk, d, h, 1, self_attention)
            if shape == MHA_BWD_GLOBAL and not bplan.work:
                raise AssertionError(f"{bwd}: planned in shared memory, not device memory")
            placed.add((bplan.mode, bool(bplan.work), d // h in (8, 16, 32)))
            gen = torch.Generator(device="cuda").manual_seed(SEED + 45 + i)
            for mask in (None, torch.rand((B, h, Tq, Tk), generator=gen, device="cuda")
                         < 1.0 - DROPOUT):
                drop = () if mask is None else (mask, 1.0 - DROPOUT)
                got_b = cuda_mha.mha_backward(*args, g, *drop)
                again_b = cuda_mha.mha_backward(*args, g, *drop)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got_b, again_b)):
                    raise AssertionError(f"{bwd}: two calls differ")
                rate = 0.0 if mask is None else DROPOUT
                want_b = multihead_attention_backward_reference(q, ql, k, kl, h, w, g, rate,
                                                                mask)
                worst_b = max(worst_b, _mha_grad_err(
                    got_b, want_b, _mha_scale(q, ql, k, kl, h, w, g, False, rate, mask),
                    bwd + ("" if mask is None else f" dropout {DROPOUT}")))

            # MHAFunction's gradients (K3 forward, K3b backward) against
            # autograd of the plain version
            worst_b = max(worst_b, _mha_function_err(q, k, ql, kl, h, w, g, self_attention,
                                                     what))

            kernel_ms = _cuda_ms(lambda: cuda_mha.mha_forward(*args))
            plain_ms = _cuda_ms(lambda: multihead_attention_reference(
                q, ql, k, kl, h, w))
            bytes_ms, ops_ms = mha_bound(B, Tq, Tk, self_attention, d)
            device_ms = _device_ms(lambda: cuda_mha.mha_forward(*args), "mha_fwd_kernel")
            log(f"kernel {what}: cluster {plan.cs} group {plan.group} smem "
                f"{plan.smem}: max_abs_err={err:.3e} kernel_ms={kernel_ms:.6f} "
                f"device_ms={device_ms} plain_ms={plain_ms:.6f} "
                f"bound_us={1e3 * max(bytes_ms, ops_ms):.4f} "
                f"(bytes {1e3 * bytes_ms:.4f} us, operations {1e3 * ops_ms:.4f} us); "
                f"bitwise repeatable; MHAFunction gradients match autograd")
            msg = (f"kernel {bwd}: {_bwd_plan_line(B, Tq, Tk, d, h, self_attention)}: "
                   f"max_abs_err={worst_b:.3e} (so far) with and without dropout; bitwise "
                   f"repeatable")
            # the main path: self-attention at Tq = Tk, the readout at Tq = 1
            is_main = self_attention == (Tq == Tk)
            if (B, Tq, Tk, d, h) in mains and is_main:
                _add(main, kernel_ms, plain_ms, bytes_ms, ops_ms)
            if (B, Tq, Tk, d, h) in bwd_mains and is_main:
                run = lambda: cuda_mha.mha_backward(*args, g)  # noqa: E731
                b_ms = _cuda_ms(run)
                b_plain = _cuda_ms(lambda: multihead_attention_backward_reference(
                    q, ql, k, kl, h, w, g))
                b_bytes, b_ops = mha_bwd_bound(B, Tq, Tk, self_attention, d)
                b_dev = _device_ms(run, "mha_bwd_kernel")
                first = run()
                for n in range(MHA_BWD_REPEATS):
                    if not all(torch.equal(a, b) for a, b in zip(run(), first)):
                        raise AssertionError(f"{bwd}: call {n + 2} of "
                                             f"{MHA_BWD_REPEATS + 1} differs from the first")
                _add(main_b, b_ms, b_plain, b_bytes, b_ops)
                msg += (f"; {MHA_BWD_REPEATS + 1} calls equal; kernel_ms={b_ms:.6f} "
                        f"device_ms={b_dev} plain_ms={b_plain:.6f} "
                        f"bound_us={1e3 * max(b_bytes, b_ops):.4f} (bytes "
                        f"{1e3 * b_bytes:.4f} us, operations {1e3 * b_ops:.4f} us); "
                        + _backward_launches(q, k, ql, kl, h, w, g, self_attention))
            log(msg)
    if shapes is MHA_SHAPES:
        resident = cuda_mha.RESIDENT
        for what, ran in (("the resident generic variant",
                           lambda m, w, spec: m == resident and not spec),
                          ("the streamed design in shared memory",
                           lambda m, w, spec: m != resident and not w),
                          ("the streamed design in device memory",
                           lambda m, w, spec: m != resident and w)):
            if not any(ran(*p) for p in placed):
                raise AssertionError(f"mha_bwd: no shape ran {what}")
    _refused_cluster_raises()
    return _summed(main, worst), _summed(main_b, worst_b)


def _keep_share_ok(mask: torch.Tensor, keep: float, what: str) -> float:
    """The share of kept entries of one dropout mask, which must lie within
    5 binomial standard deviations of `keep`."""
    n = mask.numel()
    share = float(mask.float().mean())
    if not abs(share - keep) <= 5.0 * (keep * (1.0 - keep) / n) ** 0.5:
        raise AssertionError(f"{what}: keep share {share:.6f} of {n} draws, "
                             f"expected {keep} within 5 binomial deviations")
    return share


def _drop_row(main: dict, worst: float, plain: dict) -> dict:
    """The dropout fields of a kernel's row: the masked kernel's per-call,
    device and plain times and bound over the main path's launches, its
    max abs err, and the unmasked per-call and device times of the same
    run beside them."""
    out = _summed(main, worst)
    return {"dropout_ms": out["ms"], "dropout_device_ms": out["device_ms"],
            "dropout_plain_ms": out["plain_ms"], "dropout_bound_ms": out["bound_ms"],
            "dropout_bound_by": out["bound_by"], "dropout_max_abs_err": worst,
            "nodrop_ms": plain["ms"], "nodrop_device_ms": plain["device_ms"]}


def _device_sum(a, b):
    """Two device readings summed, or the first that was not measured."""
    try:
        return f"{float(a) + float(b):.6f}"
    except ValueError:
        return a if not a[0].isdigit() else b


def phase_dropout() -> dict:
    """Dropout on the card: K1 and K2 at the train step's shapes (B = 32,
    S = 10 and 25) and K3 and K3b at B = 32, (96, 96) self-attention and
    (1, 96) readout, rate DROPOUT, each with keep masks drawn on the card and
    against its plain version given the same masks (KERNEL_TOL; K2 and K3b,
    and MHAFunction's gradients against autograd, to their error scales);
    the dispatchers
    against the plain version drawing from a generator with the same state
    (the same masks, drawn the same way); bitwise repeatable; every mask's
    keep share within 5 binomial deviations of 1 − rate.  Per-call, device
    and plain times of the masked kernels and their bound (the masks'
    bytes added), beside the unmasked kernels' times in the same run.
    Returns each kernel's dropout fields, summed over the step's launches."""
    from tlsan_tpu_torch.ops.feature_attention import draw_masks, feature_wise_attention
    from tlsan_tpu_torch.ops.multihead_attention import draw_mask, multihead_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    keep = 1.0 - DROPOUT
    rows = {}
    for kernel in ("fwa_fwd", "fwa_bwd"):
        worst, main, plain_main = 0.0, {}, {}
        for i, (B, S) in enumerate(TRAIN_SHAPES):
            x, lengths, w1, b1, w2, b2 = _fwa_inputs(B, S, SEED + 50 + i)
            gen = torch.Generator(device="cuda").manual_seed(SEED + 60 + i)
            state = gen.get_state()
            masks = draw_masks(x, H, DROPOUT, gen)
            for m in masks:
                _keep_share_ok(m, keep, f"{kernel} B={B} S={S} mask")
            what = f"{kernel} B={B} S={S} dropout {DROPOUT}"
            fwd = (x, lengths, H, w1, b1, w2, b2)
            g = torch.from_numpy(np.random.default_rng(SEED + 70 + i).normal(
                size=(B, D)).astype(np.float32)).cuda()
            if kernel == "fwa_fwd":
                run = lambda: cuda_fwa.fwa_forward(*fwd, *masks, keep)  # noqa: E731
                nodrop = lambda: cuda_fwa.fwa_forward(*fwd)  # noqa: E731
                plain = lambda: feature_wise_attention_reference(  # noqa: E731
                    *fwd, dropout_rate=DROPOUT, keep_masks=masks)
                got, again, want = run(), run(), plain()
                torch.cuda.synchronize()
                if not bool(torch.isfinite(got).all()) or not torch.equal(got, again):
                    raise AssertionError(f"{what}: non-finite, or two calls differ")
                err = float((got - want).abs().max())
                if not err <= KERNEL_TOL:
                    raise AssertionError(f"{what}: max abs err {err:.3e}")
                if float((got - nodrop()).abs().max()) == 0.0:
                    raise AssertionError(f"{what}: the masks changed nothing")
                # the dispatcher draws the same masks from the same state
                gen.set_state(state)
                disp = feature_wise_attention(*fwd, DROPOUT, gen)
                gen.set_state(state)
                ref = feature_wise_attention_reference(*fwd, dropout_rate=DROPOUT,
                                                       generator=gen)
                err = max(err, float((disp - ref).abs().max()))
                if not err <= KERNEL_TOL:
                    raise AssertionError(f"{what}: the dispatcher is {err:.3e} "
                                         "from the plain version on the same draws")
                bytes_ms, ops_ms = fwa_bound(B, S)
                ops_ms *= (4 * (D // H) + 11) / (4 * (D // H) + 9)  # x_in, m1_in
            else:
                run = lambda: cuda_fwa.fwa_backward(*fwd, g, *masks, keep)  # noqa: E731
                nodrop = lambda: cuda_fwa.fwa_backward(*fwd, g)  # noqa: E731
                plain = lambda: fwa_backward_reference(  # noqa: E731
                    *fwd, g, keep_masks=masks, dropout_rate=DROPOUT)
                got, again = run(), run()
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{what}: two calls differ")
                scale = fwa_backward_error_scale(*fwd, g, keep_masks=masks,
                                                 dropout_rate=DROPOUT)
                err = _max_err(got, plain(), scale, what + " vs fwa_backward_reference")
                # FWAFunction (K1 and K2 with the masks) against autograd
                leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
                auto = torch.autograd.grad(feature_wise_attention_reference(
                    leaves[0], lengths, H, *leaves[1:], dropout_rate=DROPOUT,
                    keep_masks=masks), leaves, g)
                err = max(err, _max_err(got, auto, scale, what + " vs autograd"))
                leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
                out = cuda_fwa.FWAFunction.apply(leaves[0], lengths, H, *leaves[1:],
                                                 *masks, DROPOUT)
                err = max(err, _max_err(torch.autograd.grad(out, leaves, g), auto, scale,
                                        what + " FWAFunction vs autograd"))
                bytes_ms, ops_ms = fwa_bwd_bound(B, S)
                ops_ms *= (12 * (D // H) + 23) / (12 * (D // H) + 18)
            bytes_ms += 1e3 * 2 * B * S * D / HBM_BYTES_PER_S  # the masks' bytes
            worst = max(worst, err)
            name = f"{kernel}_kernel"
            kernel_ms, nodrop_ms = _cuda_ms(run), _cuda_ms(nodrop)
            device_ms, nodrop_dev = _device_ms(run, name), _device_ms(nodrop, name)
            plain_ms = _cuda_ms(plain)
            log(f"dropout {what}: max_abs_err={err:.3e} kernel_ms={kernel_ms:.6f} "
                f"device_ms={device_ms} plain_ms={plain_ms:.6f} "
                f"bound_us={1e3 * max(bytes_ms, ops_ms):.4f}; unmasked "
                f"kernel_ms={nodrop_ms:.6f} device_ms={nodrop_dev}; bitwise repeatable")
            _add(main, kernel_ms, plain_ms, bytes_ms, ops_ms)
            main["device_ms"] = _device_sum(main.get("device_ms", "0"), device_ms)
            plain_main["ms"] = plain_main.get("ms", 0.0) + nodrop_ms
            plain_main["device_ms"] = _device_sum(plain_main.get("device_ms", "0"),
                                                  nodrop_dev)
        rows[kernel] = _drop_row(main, worst, plain_main)

    worst, main, plain_main = 0.0, {}, {}
    worst_b, main_b, plain_main_b = 0.0, {}, {}
    for i, (B, Tq, Tk) in enumerate(MHA_TRAIN):
        self_attention = Tq == Tk
        q, k, ql, kl, w = _mha_inputs(B, Tq, Tk, self_attention, SEED + 80 + i)
        ws = [w[n] for n in cuda_mha.WEIGHTS]
        gen = torch.Generator(device="cuda").manual_seed(SEED + 90 + i)
        state = gen.get_state()
        mask = draw_mask(q, k, H, DROPOUT, gen)
        _keep_share_ok(mask, keep, f"mha_fwd B={B} Tq={Tq} Tk={Tk} mask")
        what = f"mha_fwd B={B} Tq={Tq} Tk={Tk} dropout {DROPOUT}"
        run = lambda: cuda_mha.mha_forward(q, k, ql, kl, H, *ws, mask, keep)  # noqa: E731
        nodrop = lambda: cuda_mha.mha_forward(q, k, ql, kl, H, *ws)  # noqa: E731
        plain = lambda: multihead_attention_reference(  # noqa: E731
            q, ql, k, kl, H, w, DROPOUT, keep_mask=mask)
        got, again, (want, _) = run(), run(), plain()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()) or not torch.equal(got, again):
            raise AssertionError(f"{what}: non-finite, or two calls differ")
        err = float((got - want).abs().max())
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{what}: max abs err {err:.3e}")
        gen.set_state(state)
        disp = multihead_attention(q, ql, k, kl, H, w, DROPOUT, gen)
        gen.set_state(state)
        ref, _ = multihead_attention_reference(q, ql, k, kl, H, w, DROPOUT, gen)
        err = max(err, float((disp - ref).abs().max()))
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{what}: the dispatcher is {err:.3e} from the plain "
                                 "version on the same draws")
        # MHAFunction's gradients with the mask against autograd
        g = torch.from_numpy(np.random.default_rng(SEED + 100 + i).normal(
            size=(B, Tq, D)).astype(np.float32)).cuda()
        grads = []
        for kernel_fn in (True, False):
            x = q.clone().requires_grad_(True)
            y = x if self_attention else k.clone().requires_grad_(True)
            lw = [t.clone().requires_grad_(True) for t in ws]
            out = (cuda_mha.MHAFunction.apply(x, y, ql, kl, H, *lw, mask, DROPOUT)
                   if kernel_fn else multihead_attention_reference(
                       x, ql, y, kl, H, dict(zip(cuda_mha.WEIGHTS, lw)), DROPOUT,
                       keep_mask=mask)[0])
            grads.append(torch.autograd.grad(out, [x, *lw] if self_attention
                                             else [x, y, *lw], g))
        worst_b = max(worst_b, _mha_grad_err(
            *grads, _mha_scale(q, ql, k, kl, H, w, g, self_attention, DROPOUT, mask,
                               leaves=True), f"{what}: MHAFunction vs autograd"))
        # K3b with the mask: against the plain backward, itself, unmasked
        brun = lambda: cuda_mha.mha_backward(q, k, ql, kl, H, *ws, g, mask, keep)  # noqa: E731
        bnodrop = lambda: cuda_mha.mha_backward(q, k, ql, kl, H, *ws, g)  # noqa: E731
        bplain = lambda: multihead_attention_backward_reference(  # noqa: E731
            q, ql, k, kl, H, w, g, DROPOUT, mask)
        got_b, again_b = brun(), brun()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got_b, again_b)):
            raise AssertionError(f"mha_bwd B={B} Tq={Tq} Tk={Tk} dropout: two calls differ")
        b_err = _mha_grad_err(got_b, bplain(), _mha_scale(q, ql, k, kl, H, w, g, False,
                                                           DROPOUT, mask),
                              f"mha_bwd B={B} Tq={Tq} Tk={Tk} dropout")
        worst_b = max(worst_b, b_err)
        b_bytes, b_ops = mha_bwd_bound(B, Tq, Tk, self_attention)
        b_bytes += 1e3 * B * H * Tq * Tk / HBM_BYTES_PER_S  # the mask's bytes
        b_ops += 1e3 * 2 * B * H * Tq * Tk / F32_FLOPS_PER_S  # its selects in dV and dP
        b_ms, b_nodrop = _cuda_ms(brun), _cuda_ms(bnodrop)
        b_dev, b_nodrop_dev = _device_ms(brun, "mha_bwd_kernel"), _device_ms(bnodrop,
                                                                             "mha_bwd_kernel")
        b_plain = _cuda_ms(bplain)
        log(f"dropout mha_bwd B={B} Tq={Tq} Tk={Tk} dropout {DROPOUT}: max_abs_err="
            f"{b_err:.3e} kernel_ms={b_ms:.6f} device_ms={b_dev} plain_ms={b_plain:.6f} "
            f"bound_us={1e3 * max(b_bytes, b_ops):.4f}; unmasked kernel_ms={b_nodrop:.6f} "
            f"device_ms={b_nodrop_dev}; bitwise repeatable")
        _add(main_b, b_ms, b_plain, b_bytes, b_ops)
        main_b["device_ms"] = _device_sum(main_b.get("device_ms", "0"), b_dev)
        plain_main_b["ms"] = plain_main_b.get("ms", 0.0) + b_nodrop
        plain_main_b["device_ms"] = _device_sum(plain_main_b.get("device_ms", "0"),
                                                b_nodrop_dev)
        worst = max(worst, err)
        bytes_ms, ops_ms = mha_bound(B, Tq, Tk, self_attention)
        bytes_ms += 1e3 * B * H * Tq * Tk / HBM_BYTES_PER_S  # the mask's bytes
        ops_ms += 1e3 * B * H * Tq * Tk / F32_FLOPS_PER_S  # its select
        kernel_ms, nodrop_ms = _cuda_ms(run), _cuda_ms(nodrop)
        device_ms = _device_ms(run, "mha_fwd_kernel")
        nodrop_dev = _device_ms(nodrop, "mha_fwd_kernel")
        plain_ms = _cuda_ms(plain)
        log(f"dropout {what} {'self' if self_attention else 'cross'}: "
            f"max_abs_err={err:.3e} kernel_ms={kernel_ms:.6f} device_ms={device_ms} "
            f"plain_ms={plain_ms:.6f} bound_us={1e3 * max(bytes_ms, ops_ms):.4f}; "
            f"unmasked kernel_ms={nodrop_ms:.6f} device_ms={nodrop_dev}; bitwise "
            f"repeatable; MHAFunction gradients match autograd")
        _add(main, kernel_ms, plain_ms, bytes_ms, ops_ms)
        main["device_ms"] = _device_sum(main.get("device_ms", "0"), device_ms)
        plain_main["ms"] = plain_main.get("ms", 0.0) + nodrop_ms
        plain_main["device_ms"] = _device_sum(plain_main.get("device_ms", "0"), nodrop_dev)
    rows["mha_fwd"] = _drop_row(main, worst, plain_main)
    rows["mha_bwd"] = _drop_row(main_b, worst_b, plain_main_b)
    return rows


# ------------------------------------------------------------------ families


def _tlsan_requests(rng: np.random.Generator, n: int):
    """Raw (item, day) event streams over several days; some users have a
    single day, some a last session longer than Ts."""
    reqs = []
    for u in rng.integers(0, USERS, n):
        n_days = int(rng.integers(1, 9))
        days = np.sort(rng.choice(np.arange(15_000, 16_500), n_days, replace=False))
        per_day = rng.integers(1, 8, n_days)
        if rng.random() < 0.1:
            per_day[-1] = 30
        events = [[int(i), int(d)] for d, m in zip(days, per_day)
                  for i in rng.integers(0, ITEMS, m)]
        reqs.append({"user": int(u), "events": events})
    return reqs


def _atrank_requests(rng: np.random.Generator, n: int):
    """Raw (item, day) event streams of 1–40 events, a tenth of them longer
    than T (100–150 events), over spans of up to 6,000 days, so that
    events older than 4,096 days (bucket 12) occur; some users have a
    single day."""
    reqs = []
    for u in rng.integers(0, USERS, n):
        n_events = int(rng.integers(100, 151) if rng.random() < 0.1
                       else rng.integers(1, 41))
        span = int(rng.integers(1, 6_000)) if rng.random() < 0.9 else 1
        days = np.sort(rng.integers(16_500 - span, 16_501, n_events))
        reqs.append({"user": int(u), "events": [
            [int(i), int(d)] for i, d in zip(rng.integers(0, ITEMS, n_events), days)]})
    return reqs


def _planted_cates(rng: np.random.Generator, items: int,
                   cates: int = PLANTED_CATES) -> np.ndarray:
    """Each item's category: one of the first `cates`, of the item's parity."""
    return (2 * rng.integers(0, cates // 2, items)
            + np.arange(items) % 2).astype(np.int32)


def _of_parity(rng, items, parity, shape):
    return (2 * rng.integers(0, items // 2, shape)
            + parity.reshape(parity.shape + (1,) * (len(shape) - 1))).astype(np.int32)


def tlsan_train_data(rng: np.random.Generator, users: int, items: int,
                     n_train: int, n_test: int):
    """Seeded TLSAN train and test sets with the planted structure of
    tests/test_train.py:18-39: whether a row's label is 1 decides whether
    its item has the parity the user likes.  Histories, the user's dominant
    category and each item's category carry that parity too (category
    parity = item parity), so the user tower can learn it.  The rows belong
    to `n_test` users, the test set's, as in a leave-last-out split; a
    share of the rows has an empty long-term history (sl = 0).  Items and
    users fall in the first `PLANTED_CATES` categories of the catalog's, so
    each category is seen often enough in 300 steps to learn the parity."""
    cate_list = _planted_cates(rng, items)

    def rows(u):
        n = len(u)
        liked = (1 - u % 2).astype(np.int32)  # tests/test_train.py's rule
        sl = rng.integers(1, LS + 1, n).astype(np.int32)
        sl[rng.random(n) < EMPTY_HISTORY_SHARE] = 0
        return dict(u=u.astype(np.int32),
                    c=(2 * rng.integers(0, PLANTED_CATES // 2, n) + liked).astype(np.int32),
                    hist_i=_of_parity(rng, items, liked, (n, LS)),
                    hist_t=rng.uniform(0.1, 1.0, (n, LS)).astype(np.float32),
                    hist_i_new=_of_parity(rng, items, liked, (n, TS)),
                    sl=sl, sl_new=rng.integers(1, TS + 1, n).astype(np.int32)), liked

    test_users = rng.choice(users, n_test, replace=False)
    train, liked = rows(test_users[rng.integers(0, n_test, n_train)])
    y = rng.integers(0, 2, n_train)
    train["y"] = y.astype(np.float32)
    train["i"] = _of_parity(rng, items, np.where(y == 1, liked, 1 - liked), (n_train,))
    test, liked = rows(test_users)
    test["i"] = _of_parity(rng, items, liked, (n_test,))
    test["j"] = _of_parity(rng, items, 1 - liked, (n_test,))
    return Batches(train, n_train), Batches(test, n_test), cate_list


def atrank_train_data(rng: np.random.Generator, users: int, items: int,
                      n_train: int, n_test: int):
    """Seeded ATRank train and test sets in the prefix layout (u, hist_i,
    sl, hist_t int32 buckets 0..12, i, y / j) with a planted rule: a user's
    history items have the parity the user likes, and a row's label is 1
    exactly when its query item has that parity, so the readout can learn
    it from the history alone (ATRank has no user embedding).  Categories
    carry the item parity.  A share of the rows has an empty history
    (sl = 0), where the label is a coin flip."""
    cate_list = _planted_cates(rng, items)
    T = T_ATRANK

    def rows(u):
        n = len(u)
        liked = (1 - u % 2).astype(np.int32)
        sl = rng.integers(1, T + 1, n).astype(np.int32)
        sl[rng.random(n) < EMPTY_HISTORY_SHARE] = 0
        hist_i = _of_parity(rng, items, liked, (n, T))
        hist_i[np.arange(T)[None, :] >= sl[:, None]] = 0  # zero padding
        hist_t = rng.integers(0, 13, (n, T)).astype(np.int32)
        hist_t[np.arange(T)[None, :] >= sl[:, None]] = 0
        return dict(u=u.astype(np.int32), hist_i=hist_i, sl=sl, hist_t=hist_t), liked

    test_users = rng.choice(users, n_test, replace=False)
    train, liked = rows(test_users[rng.integers(0, n_test, n_train)])
    y = rng.integers(0, 2, n_train)
    train["y"] = y.astype(np.float32)
    train["i"] = _of_parity(rng, items, np.where(y == 1, liked, 1 - liked), (n_train,))
    test, liked = rows(test_users)
    test["i"] = _of_parity(rng, items, liked, (n_test,))
    test["j"] = _of_parity(rng, items, 1 - liked, (n_test,))
    return Batches(train, n_train), Batches(test, n_test), cate_list


@dataclasses.dataclass(frozen=True)
class Family:
    """One model family's main paths: its configuration, its request and
    training data, its HTTP latency sample, and the kernel launches of a
    request batch, a train step, an eval batch (AUC and top-k passes) and
    a histogram summary."""
    name: str
    model: type
    cfg: ModelConfig
    requests: Callable  # (rng, n) → raw request dicts
    train_data: Callable  # (rng, users, items, n_train, n_test) → (train, test, cate_list)
    latency_requests: int
    per_batch: dict
    per_step: dict
    per_eval_batch: dict
    per_summary: dict
    # the mesh's 20-step parity run: ATRank's ReLU units sit within f32
    # rounding of 0 often enough that at lr 1.0 one flips within a few
    # steps wherever two runs round differently (B=16 a rank against 32),
    # and the gap then grows past 1e-4; at lr 0.1 both stay at rounding
    # level (tests/test_torch_atrank.py:366-368 has the same finding)
    parity_lr: float = 1.0
    # the depth of each phase (the seven baselines run shallower ones)
    bulk_window_s: float = BULK_WINDOW_S
    cpu_check_users: int = BULK_USERS  # bulk users checked against the CPU
    train_rows: int = TRAIN_ROWS
    eval_every: int = EVAL_EVERY
    test_users: int = TEST_USERS
    steps_per_call: int = STEPS_PER_CALL
    parity_steps: int = PARITY_STEPS
    train_window_s: float = TRAIN_WINDOW_S
    eval_window_s: float = EVAL_WINDOW_S


TLSAN_FAMILY = Family(
    "tlsan", TLSAN,
    ModelConfig(model="tlsan", user_count=USERS, item_count=ITEMS,
                cate_count=CATES, Ls=LS, Ts=TS, hidden_units=D, num_heads=H,
                num_blocks=1),
    _tlsan_requests, tlsan_train_data, 1_000,  # p99 is the 10th slowest
    per_batch={"fwa_fwd": 2}, per_step={"fwa_fwd": 2, "fwa_bwd": 2},
    per_eval_batch={"fwa_fwd": 4}, per_summary={"fwa_fwd": 2})

ATRANK_BLOCKS = 1
ATRANK_FAMILY = Family(
    "atrank", ATRank,
    ModelConfig(model="atrank", user_count=USERS, item_count=ITEMS,
                cate_count=CATES, max_length=T_ATRANK, hidden_units=D,
                num_heads=H, num_blocks=ATRANK_BLOCKS),
    _atrank_requests, atrank_train_data, 500,  # p99 is the 5th slowest
    # self-attention + readout a forward; the AUC pass encodes once and
    # reads out twice, the top-k pass once; the backward launches K3b once
    # an attention, and serving and evaluation never
    per_batch={"mha_fwd": 2 * ATRANK_BLOCKS},
    per_step={"mha_fwd": 2 * ATRANK_BLOCKS, "mha_bwd": 2 * ATRANK_BLOCKS},
    per_eval_batch={"mha_fwd": 5 * ATRANK_BLOCKS},
    per_summary={"mha_fwd": 2 * ATRANK_BLOCKS}, parity_lr=0.1)


def baseline_train_data(name: str):
    """(rng, users, items, n_train, n_test) → (train, test, cate_list): the
    seeded rows of one baseline family in its packers' layout, with the
    planted rule of `atrank_train_data` (history items of the parity the
    user likes; a label of 1, or the pair's positive, exactly when the
    item has that parity; categories carry it).  Histories and positives
    use the first PLANTED_ITEMS items of the catalog (five of the seven
    read items without categories, and 200 steps see each of 22,048 items
    a few times only); negatives — a label-0 item, a pair's j — come from
    the whole catalog, as the reference's builders draw them
    (`_gen_neg_list`), so every family also sees the planted items'
    popularity.  A tenth of the rows has an empty history (sl = 0);
    padding is zeros, as the packers leave it (LSPM's window
    right-aligned); BPR-MF's rows are (u, i, j) alone."""

    def make(rng: np.random.Generator, users: int, items: int, n_train: int,
             n_test: int):
        cate_list = _planted_cates(rng, items, BASE_PLANTED_CATES)
        planted = PLANTED_ITEMS

        def history(n, liked, width, empty=EMPTY_HISTORY_SHARE):
            sl = rng.integers(1, width + 1, n).astype(np.int32)
            sl[rng.random(n) < empty] = 0
            ids = _of_parity(rng, planted, liked, (n, width))
            ids[np.arange(width)[None, :] >= sl[:, None]] = 0
            return ids, sl

        def rows(u):
            n = len(u)
            liked = (1 - u % 2).astype(np.int32)
            out = {"u": u.astype(np.int32)}
            if name == "shan":
                out["hist_i"], out["sl"] = history(n, liked, LS_SHAN)
                out["hist_i_new"], out["sl_new"] = history(n, liked, TS, empty=0.0)
            elif name == "paca":
                del out["u"]  # PACA's packers carry no user (PACA/input.py)
                out["hist_i"], out["sl"] = history(n, liked, T_PACA)
            elif name == "lspm":
                ids, sl = history(n, liked, LSPM_K)
                out["hist_i"] = np.ascontiguousarray(ids[:, ::-1])  # right-aligned
                out["sl"] = sl
            elif name != "bpr":
                T = T_CNN if name == "cnn" else T_ATRANK
                out["hist_i"], out["sl"] = history(n, liked, T)
                pad = np.arange(T)[None, :] >= out["sl"][:, None]
                if name == "cnn":
                    out["hist_t"] = rng.integers(0, 13, (n, T)).astype(np.int32)
                    out["hist_t"][pad] = 0
                elif name == "csan":  # day deltas, oldest first, as featurize gives
                    gaps = rng.integers(0, 30, (n, T))
                    delta = 1 + np.cumsum(gaps[:, ::-1], axis=1)[:, ::-1]
                    out["hist_t"] = np.where(pad, 0, delta).astype(np.float32)
            return out, liked

        test_users = rng.choice(users, n_test, replace=False)
        train, liked = rows(test_users[rng.integers(0, n_test, n_train)])
        pos = _of_parity(rng, planted, liked, (n_train,))
        neg = _of_parity(rng, items, 1 - liked, (n_train,))
        if name in PAIRWISE:
            train["i"], train["j"] = pos, neg
        else:
            y = rng.integers(0, 2, n_train)
            train["y"] = y.astype(np.float32)
            train["i"] = np.where(y == 1, pos, neg)
        test, liked = rows(test_users)
        test["i"] = _of_parity(rng, planted, liked, (n_test,))
        test["j"] = _of_parity(rng, items, 1 - liked, (n_test,))
        return Batches(train, n_train), Batches(test, n_test), cate_list

    return make


def _baseline(name: str, **cfg) -> Family:
    """A baseline family at the reference widths: plain PyTorch, no kernel
    launch on any of its paths, and the shallower depths."""
    return Family(
        name, get_model(name),
        ModelConfig(model=name, user_count=USERS, item_count=ITEMS, cate_count=CATES,
                    **cfg),
        _atrank_requests, baseline_train_data(name), BASE_LATENCY_REQUESTS,
        per_batch={}, per_step={}, per_eval_batch={}, per_summary={},
        parity_lr=MESH_BASE_LR, bulk_window_s=BASE_BULK_WINDOW_S,
        cpu_check_users=BASE_CPU_CHECK_USERS, train_rows=BASE_TRAIN_ROWS,
        test_users=BASE_TEST_USERS, steps_per_call=BASE_STEPS_PER_CALL,
        parity_steps=BASE_PARITY_STEPS, train_window_s=BASE_TRAIN_WINDOW_S,
        eval_window_s=BASE_EVAL_WINDOW_S)


# the seven baselines at the reference widths (SURVEY.md §2.6 flag tables):
# 32-wide item, cate and user embeddings where they have them
BASELINES = [
    _baseline("shan", Ls=LS_SHAN, Ts=TS),
    _baseline("paca", Ls=T_PACA, paca_max_len=T_PACA),
    _baseline("bpr"),  # 64-wide users against item(32)⊕cate(32)
    _baseline("lspm", lspm_k=LSPM_K, regulation_rate=1e-2),
    # ten towers of 32 filters, heights 1..10, over T = 80 (train/cli.py:145)
    _baseline("cnn", max_length=T_CNN, hidden_units=D),
    dataclasses.replace(_baseline("bilstm", max_length=T_ATRANK, lstm_hidden_units=64),
                        train_rows=BILSTM_TRAIN_ROWS,
                        steps_per_call=BILSTM_STEPS_PER_CALL,
                        eval_every=BILSTM_EVAL_EVERY,
                        latency_requests=BILSTM_LATENCY_REQUESTS),
    _baseline("csan", max_length=T_ATRANK, hidden_units=32),
]


# --------------------------------------------------------------------- paths


def assert_topk_match(ids_a, sc_a, ids_b, sc_b, atol):
    """Scores agree to `atol` position by position; ids agree except inside
    groups of scores equal to `atol` (top-k may order ties either way)."""
    np.testing.assert_allclose(sc_a, sc_b, rtol=0, atol=atol)
    for r in range(len(ids_a)):
        for j in np.flatnonzero(ids_a[r] != ids_b[r]):
            tied = np.isclose(sc_a[r], sc_a[r, j], rtol=0, atol=atol)
            if not (ids_b[r, j] in set(ids_a[r][tied]) or tied[-1]):
                raise AssertionError(f"top-k ids differ at row {r}, rank {j}")


def _http(url: str, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        if r.status != 200:
            raise AssertionError(f"{url}: HTTP {r.status}")
        return json.loads(r.read())


def _log_profile(tag: str, what: str, wall_ms: float, prof: dict) -> float:
    """Logs the profiled call's device time by kernel; returns its idle
    share."""
    busy_ms = 1e-3 * sum(us for _, us in prof.values())
    idle = idle_share(wall_ms, prof)
    log(f"{tag}: profiled {what}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle share {idle:.3f}")
    for key, (cnt, us) in sorted(prof.items(), key=lambda kv: -kv[1][1])[:8]:
        log(f"  {1e-3 * us:9.3f} ms {cnt:5d}x  {key[:110]}")
    # the port's kernels, every template variant summed, in or out of the top
    for kernel in ("fwa_fwd_kernel", "fwa_bwd_kernel", "mha_fwd_kernel"):
        hits = [(cnt, us) for key, (cnt, us) in prof.items() if kernel in key]
        if hits:
            log(f"  {kernel}: {1e-3 * sum(us for _, us in hits):.3f} ms in "
                f"{sum(cnt for cnt, _ in hits)} launches")
    return idle


def phase_path(tmp: str, fam: Family) -> dict:
    cfg, tag = fam.cfg, f"path {fam.name}"
    model = fam.model(cfg, "cpu").init_params(torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    cate_list = rng.integers(0, CATES, ITEMS).astype(np.int32)
    checkpoint.save(tmp, fam.name, 0, model, None, cfg, best=True)
    rec = Recommender.from_model_dir(tmp, cate_list, device="cuda",
                                     batch_size=BATCH, k=K)
    cpu_rec = Recommender.from_model_dir(tmp, cate_list, device="cpu",
                                         batch_size=BATCH, k=K)
    single = fam.requests(rng, 1)[0]
    several = fam.requests(rng, 8)
    timed = fam.requests(rng, fam.latency_requests)
    bulk = featurize_many(fam.name, cfg, fam.requests(rng, BULK_USERS),
                          cate_list=cate_list)
    if fam.name == "atrank" and not ((bulk["hist_t"] == 12).any()
                                     and (bulk["sl"] == T_ATRANK).any()):
        raise AssertionError("the ATRank requests lack bucket 12 or a full history")

    service = RecommendService(rec, fam.name, rec.cfg, cate_list)
    stop = threading.Event()
    worker = service.start_worker_thread(stop)
    httpd = serve(service, port=0, host="127.0.0.1")
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    n_batches = -(-BULK_USERS // BATCH)

    def batches(n):
        return _times(fam.per_batch, n)

    try:
        reset_launches()  # the serving path starts here
        n = launch_counts()
        health = _http(url + "/healthz")
        if health.get("status") != "ok" or health.get("catalog_items") != ITEMS:
            raise AssertionError(f"healthz: {health}")
        n = expect_launches(n, {}, "healthz")
        answers = [(_http(url + "/v1/recommend", single), [single])]
        n = expect_launches(n, batches(1), "single request")
        answers.append((_http(url + "/v1/recommend", {"requests": several}), several))
        n = expect_launches(n, batches(1), "8 requests")
        latency_ms = []
        for req in timed:
            t0 = time.perf_counter()
            _http(url + "/v1/recommend", req)
            latency_ms.append(1e3 * (time.perf_counter() - t0))
        n = expect_launches(n, batches(len(timed)), "timed single requests")
        ids, scores = rec.recommend(bulk)  # warm-up, checked below
        n = expect_launches(n, batches(n_batches), "bulk recommend")
        calls, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < fam.bulk_window_s:
            rec.recommend(bulk)
            calls += 1
        window_s = time.perf_counter() - t0
        n = expect_launches(n, batches(calls * n_batches), "bulk recommend window")
        wall_ms, prof = device_profile(lambda: rec.recommend(bulk))
        expect_launches(n, batches(n_batches), "profiled bulk recommend")
        launches = launch_counts()  # the serving path ends here
    finally:
        httpd.shutdown()
        httpd.server_close()
        stop.set()
        worker.join(timeout=30)
        server.join(timeout=30)
    users_per_s = calls * BULK_USERS / window_s
    p50, p99 = np.percentile(latency_ms, [50, 99])
    log(f"{tag}: HTTP latency of {len(timed)} sequential single-user "
        f"requests: p50 {p50:.3f} ms, p99 {p99:.3f} ms, max {max(latency_ms):.3f} ms")
    log(f"{tag}: bulk recommend of {BULK_USERS} users in {n_batches} batches of "
        f"{BATCH}, {calls} calls in {window_s:.3f} s: {users_per_s:.1f} users/s")
    idle = _log_profile(tag, "bulk recommend", wall_ms, prof)

    # the same checkpoint on the CPU, through the plain versions: the first
    # cpu_check_users users (whole batches of 128, so the same batches)
    if ids.shape != (BULK_USERS, K) or not np.isfinite(scores).all():
        raise AssertionError(f"bulk: shape {ids.shape} or non-finite scores")
    m = fam.cpu_check_users
    want_ids, want_scores = cpu_rec.recommend({k: v[:m] for k, v in bulk.items()})
    assert_topk_match(want_ids, want_scores, ids[:m], scores[:m], SCORE_TOL)
    for body, reqs in answers:
        want_ids, want_scores = cpu_rec.recommend(
            featurize_many(fam.name, cfg, reqs, cate_list=cate_list))
        got = body["results"]
        if len(got) != len(reqs):
            raise AssertionError(f"HTTP gave {len(got)} results for {len(reqs)}")
        assert_topk_match(want_ids, want_scores,
                          np.array([r["items"] for r in got]),
                          np.array([r["scores"] for r in got]), HTTP_SCORE_TOL)
    log(f"{tag}: launches {launches}; GPU answers match the CPU plain "
        f"path (scores to {SCORE_TOL}, ids up to ties) for {m} bulk users "
        f"and every HTTP answer")
    return {"launches": launches, "users_per_s": users_per_s, "http_p50_ms": p50,
            "http_p99_ms": p99, "serve_idle_share": idle}


def _records(model_dir: str):
    with open(os.path.join(model_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_train(tmp: str, fam: Family) -> dict:
    cfg, tag = fam.cfg, f"train {fam.name}"
    # a loss record and a summary every chunk, an evaluation every 100 steps
    tc = TrainConfig(model_dir=os.path.join(tmp, "train"), max_epochs=1,
                     steps_per_call=fam.steps_per_call, eval_freq=fam.eval_every,
                     display_freq=fam.steps_per_call,
                     summary_freq=fam.steps_per_call, best_after_step=0,
                     save_auc_gate=0.0, seed=SEED)
    assert (tc.train_batch_size, tc.test_batch_size) == (TRAIN_B, TEST_B)
    train, test, cate_list = fam.train_data(np.random.default_rng(SEED + 1), USERS,
                                            ITEMS, fam.train_rows, fam.test_users)
    eval_batches = -(-fam.test_users // TEST_B)

    def work(steps=0, evals=0, summaries=0):
        return _plus(_times(fam.per_step, steps),
                     _times(fam.per_eval_batch, evals * eval_batches),
                     _times(fam.per_summary, summaries))

    reset_launches()  # the train path starts here
    t0 = time.perf_counter()
    trainer = Trainer(fam.model, cfg, tc, cate_list, train, test, device="cuda")
    trainer.train()
    train_s = time.perf_counter() - t0
    recs = _records(tc.model_dir)
    evals = [r for r in recs if r["kind"] in ("eval", "final")]
    losses = [r["loss"] for r in recs if r["kind"] == "train"]
    steps = trainer.step
    summaries = len(losses)  # a summary with every loss record
    n = expect_launches(_plus(), work(steps, len(evals), summaries), "Trainer.train")
    if steps != fam.train_rows // TRAIN_B or trainer.opt_state.count != steps:
        raise AssertionError(f"step {steps}, schedule count {trainer.opt_state.count}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"chunk losses {losses} are not finite and falling")
    final = evals[-1]
    if not final["auc"] > max(0.5, evals[0]["auc"]):
        raise AssertionError(f"AUC after training {final['auc']} is not above "
                             f"0.5 and the initial {evals[0]['auc']}")
    if not os.path.exists(os.path.join(tc.model_dir, checkpoint.BEST)):
        raise AssertionError("no best save happened")
    log(f"{tag}: Trainer.train() of {steps} steps and {len(evals)} evaluations "
        f"in {train_s:.3f} s; chunk losses {losses}; AUC "
        f"{[round(r['auc'], 6) for r in evals]}; final {json.dumps(final)}")

    # eval users/s over whole evaluations (each ends in a read to the host)
    evals_done, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < fam.eval_window_s:
        trainer.evaluate()
        evals_done += 1
    eval_s = time.perf_counter() - t0
    n = expect_launches(n, work(evals=evals_done), "evaluate")

    # train examples/s over a window of whole chunks, after a warm-up chunk
    chunks = torch.from_numpy(trainer._epoch_index(1)).cuda()
    trainer._train_chunk(chunks[0])
    torch.cuda.synchronize()
    done, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < fam.train_window_s:
        trainer._train_chunk(chunks[done % len(chunks)])
        done += 1
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    n = expect_launches(n, work(steps=(done + 1) * fam.steps_per_call), "train window")
    wall_ms, prof = device_profile(lambda: trainer._train_chunk(chunks[0]))
    n = expect_launches(n, work(steps=fam.steps_per_call), "profiled chunk")

    # resume: a second Trainer on the same model_dir
    resumed = Trainer(fam.model, cfg, dataclasses.replace(tc, from_scratch=False),
                      cate_list, train, test, device="cuda")
    if resumed.step != steps or resumed.opt_state.count != steps:
        raise AssertionError(f"resumed at step {resumed.step}, count "
                             f"{resumed.opt_state.count}; saved at {steps}")
    again = resumed.evaluate()
    if again != {k: v for k, v in final.items() if k not in ("kind", "step", "wall_s")}:
        raise AssertionError(f"resumed evaluation {again} differs from the saved {final}")
    expect_launches(n, work(evals=1), "resumed evaluate")
    launches = launch_counts()
    trainer.close()
    resumed.close()  # the train path ends here

    examples_per_s = done * fam.steps_per_call * TRAIN_B / window_s
    log(f"{tag}: {done} chunks of {fam.steps_per_call} steps of {TRAIN_B} in "
        f"{window_s:.3f} s: {examples_per_s:.1f} train examples/s")
    eval_users_per_s = evals_done * fam.test_users / eval_s
    log(f"{tag}: {evals_done} evaluate() of {fam.test_users} users (AUC and top-50 "
        f"over {ITEMS} items) in {eval_s:.3f} s: {eval_users_per_s:.1f} eval users/s")
    idle = _log_profile(tag, f"chunk of {fam.steps_per_call} steps", wall_ms, prof)
    log(f"{tag}: resumed at step {steps} (count {steps}); its evaluation equals "
        f"the last save's bit for bit; launches {launches}")

    # the same start trained on the CPU through the plain versions
    worst = _cpu_parity(tmp, fam, cfg, dataclasses.replace(tc, tb_histograms=False),
                        (cate_list, train, test),
                        trainer._epoch_index(0)[0][:fam.parity_steps], "parity")
    log(f"{tag}: {fam.parity_steps} steps on the card (kernels) and on the CPU "
        f"(plain) agree: max abs diff {worst:.3e} over losses and every "
        f"parameter (rtol = atol = {PARITY_TOL})")
    return {"launches": launches, "examples_per_s": examples_per_s,
            "eval_users_per_s": eval_users_per_s, "train_idle_share": idle}


def _cpu_parity(tmp: str, fam: Family, cfg, tc, data, idx, tag: str) -> float:
    """The steps of the index chunk `idx` from one start on the card and on
    the CPU (the plain versions), by Trainers of `tc` on `data` (cate_list,
    train, test): losses and every parameter within PARITY_TOL.  Returns
    the largest difference.  The CPU run takes torch's deterministic
    algorithms: on several threads its embedding gradients' scatter-add
    (index_put_ with accumulate) sums in a varying order: two CPU runs of
    ATRank's 20 steps at D = 512 on 8 threads parted by 3.5e-4, where the
    H100's runs are bit for bit equal."""
    out = {}
    for device in ("cuda", "cpu"):
        was = (torch.are_deterministic_algorithms_enabled(),
               torch.is_deterministic_algorithms_warn_only_enabled())
        if device == "cpu":
            torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            tr = Trainer(fam.model, cfg, dataclasses.replace(
                tc, model_dir=os.path.join(tmp, f"parity_{device}")), *data, device=device)
            losses = tr._train_chunk(torch.as_tensor(idx).to(device))
        finally:
            torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        out[device] = (losses.cpu(), {k: v.detach().cpu() for k, v in
                                      tr.model.state_dict().items()})
        tr.close()
    (lg, pg), (lc, pc) = out["cuda"], out["cpu"]
    worst = float((lg - lc).abs().max())
    if not torch.allclose(lg, lc, rtol=PARITY_TOL, atol=PARITY_TOL):
        raise AssertionError(f"{tag}: losses differ by {worst:.3e}: {lg} vs {lc}")
    for name in pg:
        diff = float((pg[name] - pc[name]).abs().max())
        worst = max(worst, diff)
        if not torch.allclose(pg[name], pc[name], rtol=PARITY_TOL, atol=PARITY_TOL):
            raise AssertionError(f"{tag}: {name} differs by {diff:.3e}")
    return worst


# ---------------------------------------------------------------------- ext


def _ext_run(tmp: str, fam: Family, data, tag: str, steps: int, device="cuda",
             cfg=None, **over):
    """A fresh Trainer of `fam` from the seed on `device` takes the first
    `steps` batches of epoch 0 as one chunk.  Returns (trainer, losses on
    the CPU, whole state on the CPU, seconds of the chunk, its launches);
    on the card the launches must be `fam.per_step` a step exactly."""
    train, test, cate_list = data
    tc = TrainConfig(model_dir=os.path.join(tmp, tag), max_epochs=1,
                     steps_per_call=steps, eval_freq=10**9, best_after_step=0,
                     tb_histograms=False, seed=SEED, **over)
    tr = Trainer(fam.model, cfg or fam.cfg, tc, cate_list, train, test, device=device)
    idx = torch.from_numpy(tr._epoch_index(0)[0][:steps]).to(device)
    if device == "cuda":
        torch.cuda.synchronize()
    n = launch_counts()
    t0 = time.perf_counter()
    losses = tr._train_chunk(idx)
    if device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if device == "cuda":
        expect_launches(n, _times(fam.per_step, steps), f"ext {tag}")
    state = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
    return tr, losses.cpu(), state, dt, _times(fam.per_step, steps)


def _worst(got: dict, want: dict) -> float:
    return max(float((got[k] - want[k]).abs().max()) for k in want)


def _check_close(tag: str, got: dict, want: dict, rtol: float, atol: float,
                 skip=()) -> float:
    for k, w in want.items():
        if k not in skip and not torch.allclose(got[k], w, rtol=rtol, atol=atol):
            raise AssertionError(f"{tag}: {k} differs by "
                                 f"{float((got[k] - w).abs().max()):.3e}")
    return _worst(got, want)


def _slot_states(tr) -> dict:
    return {s: {n: t.detach().cpu() for n, t in zip(tr._names, ts)}
            for s, ts in tr.opt_state.slots.items()}


def _sparse_pair(tmp: str, fam: Family, data, steps: int, card: str, **over):
    """`fam` from one seeded start, `steps` dense steps against `steps`
    touched-row steps on the card.  Returns (dense run, sparse run), each
    (trainer, losses, state, seconds, launches)."""
    runs = []
    for use_sparse in (False, True):
        runs.append(_ext_run(tmp, fam, data, f"{fam.name}_{use_sparse}_"
                             + "_".join(map(str, over.values())), steps,
                             sparse_updates=use_sparse, **over))
        if runs[-1][0]._use_sparse != use_sparse:
            raise AssertionError(f"ext {fam.name}: sparse_updates={use_sparse} "
                                 "did not take")
    for label, (_, _, _, dt, _) in zip(("dense", "sparse"), runs):
        log(f"ext {fam.name} {over} ({card}): {steps} {label} steps of {TRAIN_B} "
            f"in {dt:.3f} s: {steps * TRAIN_B / dt:.1f} train examples/s")
    return runs


def phase_ext(tmp: str, card: str) -> list:
    """The rest of the Trainer on the card at the Electronics catalog and
    the reference widths, from one seeded start each: TLSAN's touched-row
    SGD against the dense step in f32 and in bf16, ATRank's sparse Adam
    against dense Adam in bf16, LSPM's sparse SGD against dense; Adadelta
    and RMSProp against the CPU port; the auto gate at an 80,000-item
    catalog, with dense and sparse readings there; the idle share of one
    profiled sparse chunk.  K1/K2/K3 counted exactly in every run.
    Returns the launches of each run."""
    runs = []
    tlsan = TLSAN_FAMILY.train_data(np.random.default_rng(SEED + 1), USERS, ITEMS,
                                    TRAIN_ROWS, TEST_USERS)
    for dtype, rtol, atol, loss_rtol in (("float32", SPARSE_RTOL, SPARSE_ATOL,
                                          SPARSE_LOSS_RTOL),
                                         ("bfloat16", BF16_RTOL, BF16_ATOL,
                                          BF16_LOSS_RTOL)):
        dense, sp = _sparse_pair(tmp, TLSAN_FAMILY, tlsan, EXT_STEPS, card,
                                 compute_dtype=dtype)
        runs += [dense[4], sp[4]]
        worst = _check_close(f"ext tlsan sparse {dtype}", sp[2], dense[2], rtol, atol)
        ld, ls = float(dense[1].mean()), float(sp[1].mean())
        if not abs(ls - ld) <= loss_rtol * abs(ld):
            raise AssertionError(f"ext tlsan sparse {dtype}: mean loss {ls} against {ld}")
        if dtype == "bfloat16" and any(v.dtype != torch.float32 for v in sp[2].values()):
            raise AssertionError("ext tlsan bf16: a master parameter is not f32")
        log(f"ext tlsan {dtype}: {EXT_STEPS} touched-row steps against dense: "
            f"params within {worst:.3e} (rtol {rtol}, atol {atol}), mean loss "
            f"{ls:.6f} against {ld:.6f}")
        if dtype == "float32":  # the idle share of one profiled sparse chunk
            tr = sp[0]
            idx = torch.from_numpy(tr._epoch_index(1)[0][:EXT_PROFILE_STEPS]).cuda()
            n = launch_counts()
            wall_ms, prof = device_profile(lambda: tr._train_chunk(idx))
            expect_launches(n, _times(TLSAN_FAMILY.per_step, EXT_PROFILE_STEPS),
                            "ext profiled sparse chunk")
            runs.append(_times(TLSAN_FAMILY.per_step, EXT_PROFILE_STEPS))
            _log_profile(f"ext tlsan ({card})",
                         f"sparse chunk of {EXT_PROFILE_STEPS} steps", wall_ms, prof)
        dense[0].close()
        sp[0].close()

    # ATRank: sparse Adam against dense Adam, both in bf16
    atrank = ATRANK_FAMILY.train_data(np.random.default_rng(SEED + 1), USERS, ITEMS,
                                      TRAIN_ROWS, TEST_USERS)
    dense, sp = _sparse_pair(tmp, ATRANK_FAMILY, atrank, EXT_ADAM_STEPS, card,
                             optimizer="adam", learning_rate=ADAM_LR,
                             compute_dtype="bfloat16")
    runs += [dense[4], sp[4]]
    slots_d, slots_s = _slot_states(dense[0]), _slot_states(sp[0])
    worst_mu = _check_close("ext atrank adam bf16 mu", slots_s["mu"], slots_d["mu"],
                            ADAM_MOMENT_RTOL, ADAM_BF16_MU)
    worst_nu = _check_close("ext atrank adam bf16 nu", slots_s["nu"], slots_d["nu"],
                            ADAM_MOMENT_RTOL, ADAM_BF16_NU)
    walk = _worst(sp[2], dense[2])
    if not walk < ADAM_WALK:
        raise AssertionError(f"ext atrank adam bf16: params walked {walk:.3e} apart")
    log(f"ext atrank adam bf16: {EXT_ADAM_STEPS} touched-row steps against dense: "
        f"mu within {worst_mu:.3e}, nu within {worst_nu:.3e}, params {walk:.3e}")
    dense[0].close()
    sp[0].close()

    # LSPM: touched-row SGD in f32 (its auxiliary vocab tables short_w, long_w)
    lspm = next(f for f in BASELINES if f.name == "lspm")
    lspm_data = lspm.train_data(np.random.default_rng(SEED + 1), USERS, ITEMS,
                                TRAIN_ROWS, TEST_USERS)
    dense, sp = _sparse_pair(tmp, lspm, lspm_data, EXT_STEPS, card)
    worst = _check_close("ext lspm sparse", sp[2], dense[2], SPARSE_RTOL, SPARSE_ATOL)
    ld, ls = float(dense[1].mean()), float(sp[1].mean())
    if not abs(ls - ld) <= SPARSE_LOSS_RTOL * abs(ld):
        raise AssertionError(f"ext lspm sparse: mean loss {ls} against {ld}")
    log(f"ext lspm: {EXT_STEPS} touched-row steps against dense: params within "
        f"{worst:.3e}, mean loss {ls:.6f} against {ld:.6f}")
    dense[0].close()
    sp[0].close()

    # Adadelta and RMSProp: the card against the CPU port
    for optimizer, lr in (("adadelta", 1.0), ("rmsprop", 1e-3)):
        out = {}
        for device in ("cuda", "cpu"):
            tr, losses, state, dt, n = _ext_run(
                tmp, TLSAN_FAMILY, tlsan, f"{optimizer}_{device}", EXT_OPT_STEPS,
                device=device, optimizer=optimizer, learning_rate=lr,
                sparse_updates=False)
            out[device] = (losses, state, _slot_states(tr))
            if device == "cuda":
                runs.append(n)
                log(f"ext tlsan {optimizer} ({card}): {EXT_OPT_STEPS} steps in "
                    f"{dt:.3f} s: {EXT_OPT_STEPS * TRAIN_B / dt:.1f} train examples/s")
            tr.close()
        (lg, pg, sg), (lc, pc, sc) = out["cuda"], out["cpu"]
        if not torch.allclose(lg, lc, rtol=PARITY_TOL, atol=PARITY_TOL):
            raise AssertionError(f"ext {optimizer}: losses {lg} against the CPU's {lc}")
        worst = _check_close(f"ext {optimizer}", pg, pc, PARITY_TOL, PARITY_TOL)
        for slot in sg:
            worst = max(worst, _check_close(f"ext {optimizer} {slot}", sg[slot],
                                            sc[slot], PARITY_TOL, PARITY_TOL))
        log(f"ext tlsan {optimizer}: {EXT_OPT_STEPS} steps at lr {lr} on the card "
            f"and on the CPU agree to {worst:.3e} (losses, params, slots)")

    # the auto gate at 80,000 items, and the readings there
    big = TLSAN_FAMILY.train_data(np.random.default_rng(SEED + 3), USERS,
                                  EXT_GATE_ITEMS, TRAIN_ROWS, TEST_USERS)
    cfg = dataclasses.replace(TLSAN_FAMILY.cfg, item_count=EXT_GATE_ITEMS)
    gate = Trainer(TLSAN_FAMILY.model, cfg, TrainConfig(
        model_dir=os.path.join(tmp, "gate_adam"), optimizer="adam",
        train_batch_size=256, tb_histograms=False), big[2], big[0], big[1],
        device="cuda")
    if gate._use_sparse:
        raise AssertionError("auto gate: adam at batch 256 engaged sparse")
    gate.close()
    for dtype in ("float32", "bfloat16"):
        for forced in (False, None):  # None: the auto gate must engage it
            tr, _, _, dt, n = _ext_run(tmp, TLSAN_FAMILY, big, f"gate_{dtype}_{forced}",
                                       EXT_GATE_STEPS, cfg=cfg, sparse_updates=forced,
                                       compute_dtype=dtype)
            runs.append(n)
            if tr._use_sparse != (forced is None):
                raise AssertionError(f"auto gate at {EXT_GATE_ITEMS + USERS} rows: "
                                     f"sparse {tr._use_sparse}")
            tr.close()
            log(f"ext tlsan {EXT_GATE_ITEMS} items {dtype} ({card}): "
                f"{EXT_GATE_STEPS} {'dense' if forced is False else 'sparse (auto)'} "
                f"steps of {TRAIN_B} in {dt:.3f} s: "
                f"{EXT_GATE_STEPS * TRAIN_B / dt:.1f} train examples/s")
    log(f"ext auto gate: sparse engaged at {EXT_GATE_ITEMS + USERS} vocab rows "
        "(sgd, batch 32), dense kept for adam at batch 256")
    return runs


# --------------------------------------------------------------------- mesh


def mesh_setup():
    """(backend, device) of the mesh's ranks: one card a rank over NCCL
    when there are four cards, else four processes on card 0 over Gloo,
    which takes CUDA tensors for all_reduce (NCCL refuses two ranks of one
    communicator on one card)."""
    if torch.cuda.device_count() >= MESH_DP * MESH_MP:
        log("mesh: 4 ranks, one card each, over NCCL")
        return "nccl", "cuda"
    log("mesh: 4 ranks on one card (cuda:0), over Gloo with CUDA tensors")
    return "gloo", "cuda:0"


def phase_kernel_local() -> dict:
    """K4: K1, K2, K3 and K3b against their plain versions at the per-rank
    shapes; the returned times are per local request batch (B=64)."""
    fwa = phase_kernel(LOCAL_FWA + LOCAL_FWA_TRAIN, LOCAL_FWA)
    bwd = phase_kernel_bwd(LOCAL_FWA_TRAIN, LOCAL_FWA_TRAIN)
    mha, mha_bwd = phase_kernel_mha(LOCAL_MHA + LOCAL_MHA_TRAIN, LOCAL_MHA, LOCAL_MHA_TRAIN)
    fwa["max_abs_err"] = max(fwa["max_abs_err"], bwd["max_abs_err"])
    mha["max_abs_err"] = max(mha["max_abs_err"], mha_bwd["max_abs_err"])
    return {"fwa_per_rank": fwa, "mha_per_rank": mha}


def _mesh_family(tmp: str, fam: Family) -> dict:
    """One family's inputs to the mesh world, its jobs there, and the
    single process's 20 steps on the card to hold them against."""
    cfg = fam.cfg
    tc = TrainConfig(model_dir=os.path.join(tmp, "mesh"), max_epochs=1,
                     steps_per_call=STEPS_PER_CALL, eval_freq=STEPS_PER_CALL,
                     summary_freq=STEPS_PER_CALL, best_after_step=0,
                     save_auc_gate=0.0, seed=SEED, dp=MESH_DP, mp=MESH_MP)
    train, test, cate_list = fam.train_data(np.random.default_rng(SEED + 1), USERS,
                                            ITEMS, TRAIN_ROWS, TEST_USERS)
    test = Batches({k: v[:MESH_TEST_USERS] for k, v in test.arrays.items()},
                   MESH_TEST_USERS)  # the first of the one-device phases' users
    idx = epoch_index(TRAIN_ROWS, TRAIN_B, STEPS_PER_CALL, 0, SEED)[0][:PARITY_STEPS]
    bulk = featurize_many(fam.name, cfg, fam.requests(np.random.default_rng(SEED + 2),
                                                      MESH_BULK_USERS), cate_list=cate_list)

    # one process on the card, from the same seed
    one = Trainer(fam.model, cfg, dataclasses.replace(
        tc, dp=1, mp=1, tb_histograms=False, model_dir=os.path.join(tmp, "one"),
        learning_rate=fam.parity_lr), cate_list, train, test, device="cuda")
    want_losses = one._train_chunk(torch.from_numpy(idx).cuda()).cpu()
    want_state = {k: v.detach().cpu() for k, v in one.model.state_dict().items()}
    one.close()
    jobs = ((programs.train_program, dict(cfg=cfg, tc=tc, cate_list=cate_list,
                                          train=train, test=test, parity_idx=idx,
                                          parity_lr=fam.parity_lr,
                                          timed_chunks=MESH_TIMED_CHUNKS)),
            (programs.serve_program, dict(model_dir=tc.model_dir, cate_list=cate_list,
                                          requests=bulk, k=K, batch_size=BATCH,
                                          calls=MESH_SERVE_CALLS)))
    return dict(fam=fam, tc=tc, train=train, test=test, cate_list=cate_list,
                bulk=bulk, want_losses=want_losses, want_state=want_state,
                jobs=jobs)


def phase_mesh(tmp: str, fams, baselines, backend: str, device: str) -> list:
    """Every family's mesh paths on ONE dp=2 × mp=2 world (a single
    spawn): `fams` (TLSAN, ATRank) train and serve in full, `baselines`
    as `phase_mesh_baselines` sets out, and the three production legs as
    `phase_mesh_legs` does; each is held against one process on the card.
    Returns each of `fams`' launches over the ranks, then the legs'."""
    runs = [_mesh_family(os.path.join(tmp, fam.name), fam) for fam in fams]
    base_tmp = os.path.join(tmp, "baselines")
    base_jobs, base_runs = _mesh_baseline_jobs(base_tmp, baselines)
    leg_jobs, leg_runs = _mesh_leg_jobs(os.path.join(tmp, "legs"))
    t0 = time.perf_counter()
    ranks = run_local(programs.sequence, MESH_DP, MESH_MP, backend, device,
                      MESH_TIMEOUT_S, *[job for run in runs for job in run["jobs"]],
                      *base_jobs, *leg_jobs)
    world_s = time.perf_counter() - t0
    log(f"mesh: one world of {MESH_DP}x{MESH_MP} ranks ({backend}, {device}) for "
        f"{[fam.name for fam in (*fams, *baselines)]} in {world_s:.3f} s")
    out = [_mesh_check(run, [r[2 * i:2 * i + 2] for r in ranks], backend, device)
           for i, run in enumerate(runs)]
    n_base = 2 * len(runs) + len(base_jobs)
    phase_mesh_baselines(base_tmp, base_runs, [r[2 * len(runs):n_base] for r in ranks])
    out.append({"launches": phase_mesh_legs(leg_runs, [r[n_base:] for r in ranks])})
    return out


def _mesh_check(run: dict, ranks: list, backend: str, device: str) -> dict:
    """One family's results on every rank against the single process."""
    fam, tc, train, test = run["fam"], run["tc"], run["train"], run["test"]
    cfg, cate_list, bulk, tag = fam.cfg, run["cate_list"], run["bulk"], f"mesh {fam.name}"
    want_losses, want_state = run["want_losses"], run["want_state"]
    trained, served = ranks[0]

    # launches: every rank, every part, exactly
    recs = _records(tc.model_dir)
    evals = [r for r in recs if r["kind"] in ("eval", "final")]
    losses = [r["loss"] for r in recs if r["kind"] == "train"]
    eval_batches = -(-MESH_TEST_USERS // TEST_B)
    serve_batches = -(-MESH_BULK_USERS // BATCH)

    def work(steps=0, evals_=0, summaries=0, batches=0):
        return _plus(_times(fam.per_step, steps),
                     _times(fam.per_eval_batch, evals_ * eval_batches),
                     _times(fam.per_summary, summaries),
                     _times(fam.per_batch, batches))

    want = {"parity": work(steps=PARITY_STEPS),
            "train": work(steps=trained["step"], evals_=len(evals),
                          summaries=len(losses)),
            "evaluate": work(evals_=1),
            "chunks": work(steps=MESH_TIMED_CHUNKS * STEPS_PER_CALL),
            "first": work(batches=serve_batches),
            "calls": work(batches=MESH_SERVE_CALLS * serve_batches)}
    total = _plus()
    for r, (tr_r, sv_r) in enumerate(ranks):
        for part, got in list(tr_r["launches"].items()) + list(sv_r["launches"].items()):
            full = {k: got.get(k, 0) for k in total}
            if full != want[part]:
                raise AssertionError(f"{tag}: rank {r} {part}: launches {full}, "
                                     f"expected {want[part]}")
            total = _plus(total, full)
        if not (np.array_equal(sv_r["ids"], served["ids"])
                and np.array_equal(sv_r["scores"], served["scores"])):
            raise AssertionError(f"{tag}: rank {r} answered otherwise than rank 0")

    # 20 steps against the single process
    worst = float((torch.from_numpy(trained["parity_losses"]) - want_losses).abs().max())
    if not torch.allclose(torch.from_numpy(trained["parity_losses"]), want_losses,
                          rtol=PARITY_TOL, atol=PARITY_TOL):
        raise AssertionError(f"{tag}: parity losses differ by {worst:.3e}")
    for name, v in want_state.items():
        got = torch.from_numpy(trained["parity_state"][name])
        diff = float((got - v).abs().max())
        worst = max(worst, diff)
        if not torch.allclose(got, v, rtol=PARITY_TOL, atol=PARITY_TOL):
            raise AssertionError(f"{tag}: parity: {name} differs by {diff:.3e}")

    # learning
    if trained["step"] != TRAIN_ROWS // TRAIN_B or trained["count"] != trained["step"]:
        raise AssertionError(f"{tag}: step {trained['step']}, count {trained['count']}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{tag}: chunk losses {losses} are not finite and falling")
    if not evals[-1]["auc"] > max(0.5, evals[0]["auc"]):
        raise AssertionError(f"{tag}: AUC {[r['auc'] for r in evals]} did not rise")
    if trained["pad_max"] != 0.0:
        raise AssertionError(f"{tag}: padding rows moved ({trained['pad_max']})")

    # the mesh's save, restored in one process, evaluates as the mesh did
    restored = Trainer(fam.model, cfg, dataclasses.replace(
        tc, dp=1, mp=1, from_scratch=False), cate_list, train, test, device="cuda")
    again = restored.evaluate()
    restored.close()
    if restored.step != trained["step"] or again != trained["metrics"]:
        raise AssertionError(f"{tag}: one process evaluates the save at step "
                             f"{restored.step} as {again}, the mesh {trained['metrics']}")

    # serving against the single-device Recommender on the same save
    rec = Recommender.from_model_dir(tc.model_dir, cate_list, device="cuda",
                                     batch_size=BATCH, k=K)
    want_ids, want_scores = rec.recommend(bulk)
    if served["ids"].shape != (MESH_BULK_USERS, K) or not np.isfinite(served["scores"]).all():
        raise AssertionError(f"{tag}: served {served['ids'].shape}, or non-finite")
    assert_topk_match(want_ids, want_scores, served["ids"], served["scores"], SCORE_TOL)

    examples_per_s = MESH_TIMED_CHUNKS * STEPS_PER_CALL * TRAIN_B / trained["chunks_s"]
    users_per_s = MESH_SERVE_CALLS * MESH_BULK_USERS / served["calls_s"]
    log(f"{tag}: its Trainer.train() {trained['train_s']:.3f} s; {PARITY_STEPS} steps at lr {fam.parity_lr} agree "
        f"with one process to {worst:.3e}; chunk losses {losses}; AUC "
        f"{[round(r['auc'], 6) for r in evals]}; the save evaluates in one "
        f"process as on the mesh: {json.dumps(again)}")
    where = "4 ranks on one card" if backend == "gloo" else "a card a rank"
    log(f"{tag}: {MESH_TIMED_CHUNKS} chunks of {STEPS_PER_CALL} steps of "
        f"{TRAIN_B} ({MESH_TRAIN_B} a rank) in {trained['chunks_s']:.3f} s: "
        f"{examples_per_s:.1f} train examples/s ({where})")
    log(f"{tag}: {MESH_SERVE_CALLS} bulk recommends of {MESH_BULK_USERS} users "
        f"({MESH_SERVE_B} rows a rank a batch) in {served['calls_s']:.3f} s: "
        f"{users_per_s:.1f} users/s; ids equal the single-device "
        f"Recommender's up to ties, scores within {SCORE_TOL}; launches over "
        f"the ranks {total}")
    return {"launches": total, "examples_per_s": examples_per_s,
            "users_per_s": users_per_s}


def _mesh_baseline_jobs(tmp: str, fams):
    """The baselines' jobs on the mesh world, and what their check needs."""
    jobs, runs = [], []
    for fam in fams:
        cfg = fam.cfg
        tc = TrainConfig(model_dir=os.path.join(tmp, fam.name), max_epochs=1,
                         steps_per_call=MESH_BASE_STEPS, learning_rate=MESH_BASE_LR,
                         best_after_step=0, save_auc_gate=0.0, seed=SEED,
                         dp=MESH_DP, mp=MESH_MP)
        train, test, cate_list = fam.train_data(np.random.default_rng(SEED + 1), USERS,
                                                ITEMS, fam.train_rows, fam.test_users)
        idx = epoch_index(fam.train_rows, TRAIN_B, MESH_BASE_STEPS, 0, SEED)[0]
        requests = featurize_many(fam.name, cfg, fam.requests(
            np.random.default_rng(SEED + 2), MESH_BASE_USERS), cate_list=cate_list)
        jobs.append((programs.chunk_program, dict(cfg=cfg, tc=tc, cate_list=cate_list,
                                                  train=train, test=test, idx=idx)))
        jobs.append((programs.serve_program, dict(model_dir=tc.model_dir,
                                                  cate_list=cate_list,
                                                  requests=requests, k=K,
                                                  batch_size=BATCH)))
        runs.append((fam, tc, train, test, cate_list, idx, requests))
    return jobs, runs


def _leg_family(name: str) -> Family:
    return {"tlsan": TLSAN_FAMILY, "atrank": ATRANK_FAMILY,
            **{f.name: f for f in BASELINES}}[name]


def _mesh_leg_jobs(tmp: str):
    """The JAX package's three production legs (`programs.PRODUCTION_LEGS`:
    TLSAN sparse SGD in bf16, ATRank sparse Adam in bf16, LSPM sparse SGD
    in f32) as jobs of the mesh world: each a fresh Trainer(dp=2, mp=2)
    from the seed takes MESH_LEG_STEPS steps, evaluates MESH_TEST_USERS
    and saves (`programs.production_leg`)."""
    jobs, runs = [], []
    for name, optimizer, dtype in programs.PRODUCTION_LEGS:
        fam = _leg_family(name)
        train, test, cate_list = fam.train_data(np.random.default_rng(SEED + 1), USERS,
                                                ITEMS, TRAIN_ROWS, TEST_USERS)
        test = Batches({k: v[:MESH_TEST_USERS] for k, v in test.arrays.items()},
                       MESH_TEST_USERS)
        tc = TrainConfig(model_dir=os.path.join(tmp, f"leg_{name}"), max_epochs=1,
                         steps_per_call=MESH_LEG_STEPS, tb_histograms=False,
                         best_after_step=0, save_auc_gate=0.0, seed=SEED,
                         dp=MESH_DP, mp=MESH_MP)
        idx = epoch_index(TRAIN_ROWS, TRAIN_B, MESH_LEG_STEPS, 0, SEED)[0]
        jobs.append((programs.production_leg, dict(
            cfg=fam.cfg, tc=tc, cate_list=cate_list, train=train, test=test, idx=idx,
            optimizer=optimizer, dtype=dtype)))
        runs.append((fam, optimizer, dtype, tc, train, test, cate_list, idx))
    return jobs, runs


def _tree_rel(got: dict, want: dict) -> float:
    """‖got − want‖ / ‖want‖ over every entry of two trees of arrays."""
    diff = sum(float(np.sum(np.square(got[k] - w, dtype=np.float64)))
               for k, w in want.items())
    norm = sum(float(np.sum(np.square(w, dtype=np.float64))) for w in want.values())
    return float(np.sqrt(diff / max(norm, 1e-300)))


def phase_mesh_legs(runs, ranks) -> dict:
    """The production legs' results on the mesh world against one process
    on the card from the same seed (the leg's config at dp = mp = 1): f32
    losses within 1e-3 and parameters within rtol 2e-3, atol 2e-5
    (tests/test_sparse.py:200-206); the bf16 legs to the bf16 bounds,
    Adam's moments tightly and its parameters to their walk; every rank's
    K1/K2/K3 launches exact.  Returns the launches over the ranks."""
    total = _plus()
    for f, (fam, optimizer, dtype, tc, train, test, cate_list, idx) in enumerate(runs):
        tag = f"mesh leg {fam.name}/{optimizer}/{dtype}"
        legs = [r[f] for r in ranks]
        eval_batches = -(-MESH_TEST_USERS // TEST_B)
        want = {"chunk": _times(fam.per_step, MESH_LEG_STEPS),
                "evaluate": _times(fam.per_eval_batch, eval_batches)}
        for r, leg in enumerate(legs):
            if not leg["sparse"]:
                raise AssertionError(f"{tag}: rank {r} did not engage the sparse step")
            for part, got in leg["launches"].items():
                full = {k: got.get(k, 0) for k in total}
                if full != _plus(want[part]):
                    raise AssertionError(f"{tag}: rank {r} {part}: launches {full}, "
                                         f"expected {_plus(want[part])}")
                total = _plus(total, full)
        one = Trainer(fam.model, fam.cfg, programs.leg_config(dataclasses.replace(
            tc, dp=1, mp=1, model_dir=tc.model_dir + "_one"), optimizer, dtype),
            cate_list, train, test, device="cuda")
        losses = one._train_chunk(torch.from_numpy(idx).cuda()).cpu().numpy()
        state = {k: v.detach().cpu() for k, v in one.model.state_dict().items()}
        slots = _slot_states(one)
        one.close()
        got = {k: torch.from_numpy(v) for k, v in legs[0]["state"].items()}
        bf16 = dtype == "bfloat16"
        loss_rtol = BF16_LOSS_RTOL if bf16 else SPARSE_LOSS_RTOL
        if not np.allclose(legs[0]["losses"], losses, rtol=loss_rtol, atol=0):
            raise AssertionError(f"{tag}: losses {legs[0]['losses']} against {losses}")
        if optimizer == "adam" and bf16:
            # Adam's update on a near-zero-grad entry is about ±lr, its sign
            # set by rounding: two runs part by at most 2·lr a step
            worst = _worst(got, state)
            if not worst < 2 * ADAM_LR * MESH_LEG_STEPS:
                raise AssertionError(f"{tag}: params walked {worst:.3e} apart")
            # a rank rounds each weight gradient's sum over its half of
            # the rows to bf16 before the dp sum: each moment tree within a
            # quarter of its norm (tests/test_torch_sparse_mesh.py)
            for slot in ("mu", "nu"):
                saved = legs[0]["opt_state"]["slots"][slot]
                rel = _tree_rel(saved, {k: v.numpy() for k, v in slots[slot].items()})
                if not rel <= MESH_BF16_MOMENT_NORM:
                    raise AssertionError(f"{tag}: {slot} differs by {rel:.3e} of "
                                         "its norm")
        elif bf16:
            worst = _check_close(tag, got, state, BF16_RTOL, BF16_ATOL)
        else:
            worst = _check_close(tag, got, state, SPARSE_RTOL, SPARSE_ATOL)
        if legs[0]["pad_max"] != 0.0:
            raise AssertionError(f"{tag}: padding rows moved ({legs[0]['pad_max']})")
        log(f"{tag}: {MESH_LEG_STEPS} touched-row steps on the 4-rank world agree "
            f"with one process on the card to {worst:.3e}; AUC "
            f"{legs[0]['metrics']['auc']:.6f}; launches exact on every rank")
    return total


def phase_mesh_baselines(tmp: str, runs, ranks) -> None:
    """The seven baselines' results on the mesh world: per family, a
    Trainer(dp=2, mp=2) from the seed took MESH_BASE_STEPS steps at lr
    0.1, digested a summary, evaluated its test users and saved
    (`programs.chunk_program`); then `Recommender(mesh=...)` served the
    save to MESH_BASE_USERS featurized users (`programs.serve_program`).
    One process on the card does the same: the losses and every unpadded
    parameter must agree within PARITY_TOL, the metrics within one test
    user, the served ids up to ties with scores within SCORE_TOL; no rank
    may launch K1, K2 or K3."""
    none = {"fwa_fwd": 0, "fwa_bwd": 0, "mha_fwd": 0, "mha_bwd": 0}
    for f, (fam, tc, train, test, cate_list, idx, requests) in enumerate(runs):
        tag = f"mesh {fam.name}"
        stepped = [r[2 * f] for r in ranks]
        served = [r[2 * f + 1] for r in ranks]
        for r, (st, sv) in enumerate(zip(stepped, served)):
            for part, got in list(st["launches"].items()) + list(sv["launches"].items()):
                if got != none:
                    raise AssertionError(f"{tag}: rank {r} {part} launched {got}")
            if not (np.array_equal(sv["ids"], served[0]["ids"])
                    and np.array_equal(sv["scores"], served[0]["scores"])):
                raise AssertionError(f"{tag}: rank {r} answered otherwise than rank 0")
        # one process on the card, from the same seed
        one = Trainer(fam.model, fam.cfg, dataclasses.replace(
            tc, dp=1, mp=1, model_dir=os.path.join(tmp, fam.name + "_one")),
            cate_list, train, test, device="cuda")
        losses = one._train_chunk(torch.from_numpy(idx).cuda()).cpu()
        metrics = one.evaluate()
        state = {k: v.detach().cpu() for k, v in one.model.state_dict().items()}
        one.close()
        worst = float((torch.from_numpy(stepped[0]["losses"]) - losses).abs().max())
        if not torch.allclose(torch.from_numpy(stepped[0]["losses"]), losses,
                              rtol=PARITY_TOL, atol=PARITY_TOL):
            raise AssertionError(f"{tag}: losses {stepped[0]['losses']} against {losses}")
        for name, v in state.items():
            got = torch.from_numpy(stepped[0]["state"][name])
            diff = float((got - v).abs().max())
            worst = max(worst, diff)
            if not torch.allclose(got, v, rtol=PARITY_TOL, atol=PARITY_TOL):
                raise AssertionError(f"{tag}: {name} differs by {diff:.3e}")
        # a pos − neg difference at the rounding edge may flip one user
        off = max(abs(stepped[0]["metrics"][k] - metrics[k]) for k in metrics)
        if off > 1.0 / fam.test_users + 1e-9:
            raise AssertionError(f"{tag}: metrics {stepped[0]['metrics']} against "
                                 f"one process's {metrics}")
        if stepped[0]["pad_max"] != 0.0:
            raise AssertionError(f"{tag}: padding rows moved ({stepped[0]['pad_max']})")
        rec = Recommender.from_model_dir(tc.model_dir, cate_list, device="cuda",
                                         batch_size=BATCH, k=K)
        want_ids, want_scores = rec.recommend(requests)
        ids, scores = served[0]["ids"], served[0]["scores"]
        if ids.shape != (MESH_BASE_USERS, K) or not np.isfinite(scores).all():
            raise AssertionError(f"{tag}: served {ids.shape}, or non-finite")
        assert_topk_match(want_ids, want_scores, ids, scores, SCORE_TOL)
        log(f"{tag}: {MESH_BASE_STEPS} steps at lr {MESH_BASE_LR} agree with one "
            f"process to {worst:.3e} over losses and every parameter; metrics "
            f"within {off:.3e} (auc {stepped[0]['metrics']['auc']:.6f}); "
            f"{MESH_BASE_USERS} users served as one device serves them; no "
            f"K1/K2/K3 launch on any rank")


# ---------------------------------------------------------------------- CLI


class _Tee:
    """sys.stdout's stand-in while a command line runs in-process: writes
    go through and are kept, so the header lines can be read."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _run_cli(main_fn, argv):
    """`main_fn(argv)` in this process; returns (its result, its stdout)."""
    tee = _Tee(sys.stdout)
    sys.stdout = tee
    try:
        return main_fn(argv), "".join(tee.lines)
    finally:
        sys.stdout = tee.out


def _header(out: str) -> dict:
    """The train CLI's header line (model=... builder=...) as a dict."""
    line = next(ln for ln in out.splitlines() if ln.startswith("model="))
    return dict(field.split("=", 1) for field in line.split())


def _cli_summaries(steps: int, k: int, display_freq: int, summary_freq: int) -> int:
    """Histogram summaries of an epoch of `steps` in chunks of `k`, at the
    Trainer's cadence (train/loop.py::Trainer.train)."""
    since_display = since_summary = n = 0
    for _ in range(steps // k):
        since_display += k
        since_summary += k
        if since_display >= display_freq:
            since_display = 0
            if since_summary >= summary_freq:
                since_summary, n = 0, n + 1
    return n


def cli_data(tmp: str, category: str, card: str) -> str:
    """The seeded SNAP dumps of `category` through data.cli's download (a
    file:// base URL), convert and remap; the remap must give the
    fixture's counts exactly, with no pandas loaded.  Returns the data
    directory."""
    users, items, cates, reviews = CLI_FIXTURES[category]
    snap, raw = os.path.join(tmp, f"snap_{category}"), os.path.join(tmp, f"raw_{category}")
    data_dir = os.path.join(tmp, "Data")
    t0 = time.perf_counter()
    want = write_snap_fixture(snap, category, users, items, cates, reviews, seed=SEED)
    times = {"fixture": time.perf_counter() - t0}
    stages = [
        ("download", ["download", "--category", category, "--out", raw,
                      "--base_url", pathlib.Path(snap).as_uri()]),
        ("convert", ["convert",
                     "--reviews", os.path.join(raw, f"reviews_{category}_5.json.gz"),
                     "--meta", os.path.join(raw, f"meta_{category}.json.gz"),
                     "--out", raw]),
        ("remap", ["remap", "--reviews", os.path.join(raw, "reviews.npz"),
                   "--meta", os.path.join(raw, "meta.npz"),
                   "--out", os.path.join(data_dir, f"{category}.npz")])]
    for stage, argv in stages:
        t0 = time.perf_counter()
        with warnings.catch_warnings():  # the fixture's asin without meta
            warnings.filterwarnings("ignore", "dropping .* no metadata")
            rc, _ = _run_cli(data_cli.main, argv)
        times[stage] = time.perf_counter() - t0
        if rc:
            raise AssertionError(f"data.cli {stage} exited {rc}")
    counts = dataclasses.asdict(load_category(os.path.join(data_dir, f"{category}.npz"))[3])
    if counts != want:
        raise AssertionError(f"remap of the {category} fixture: {counts}, expected {want}")
    if "pandas" in sys.modules:
        raise AssertionError("the data pipeline loaded pandas")
    log(f"cli data {category} ({card}): " + ", ".join(
        f"{k} {v:.3f} s" for k, v in times.items())
        + f"; remapped to {counts} with no pandas loaded")
    return data_dir


def _cli_train(data_dir: str, model_dir: str, category: str, fam: Family,
               extra=(), check_launches: bool = True, profile_steps: int = 0):
    """One epoch of train.cli for `fam`'s model on the card; the launch
    counts must be exact for the steps, evaluations and summaries run
    (`check_launches`: in this process), and the `profile_steps` that
    --profile's trace runs on copies.  Returns (header, eval records,
    epoch record, launches)."""
    argv = ["--model", fam.name, "--dataset", category, "--data_dir", data_dir,
            "--max_epochs", "1", "--model_dir", model_dir, *extra]
    reset_launches()  # the train CLI's path starts here
    _, out = _run_cli(train_cli.main, argv)
    launches = launch_counts()  # and ends here
    recs = _records(model_dir)
    evals = [r for r in recs if r["kind"] in ("eval", "final")]
    epoch = next(r for r in recs if r["kind"] == "epoch")
    steps, head = evals[-1]["step"], {}
    if check_launches:  # a spawned world's ranks print the header and launch
        head = _header(out)
        test_batches = -(-int(head["test"]) // TEST_B)
        summaries = _cli_summaries(steps, int(head["steps_per_call"]), 100,
                                   1000)  # the CLI's default cadences
        want = _plus(_times(fam.per_step, steps + profile_steps),
                     _times(fam.per_eval_batch, len(evals) * test_batches),
                     _times(fam.per_summary, summaries))
        if launches != want:
            raise AssertionError(
                f"train.cli {fam.name}: launches {launches}, expected {want} "
                f"({steps} steps, {len(evals)} evaluations of {test_batches} "
                f"batches, {summaries} summaries)")
    if not evals[-1]["auc"] > evals[0]["auc"]:
        raise AssertionError(f"train.cli {fam.name}: AUC {evals[0]['auc']} → "
                             f"{evals[-1]['auc']} did not rise")
    for name in (checkpoint.LATEST, f"{fam.name}-{steps}.ckpt", f"{fam.name}-{steps}.json"):
        if not os.path.exists(os.path.join(model_dir, name)):
            raise AssertionError(f"train.cli {fam.name}: no {name} under {model_dir}")
    return head, evals, epoch, launches


def phase_cli(tmp: str, card: str) -> list:
    """The three command lines in-process, as a user runs them: data.cli
    from seeded SNAP dumps to the category file, train.cli and serve.cli
    at the Electronics scale (TLSAN), then ATRank and the dp=2 × mp=2
    mesh on a Digital-Music-sized fixture, and every family's prepare
    with the native builder against the numpy builders.  Returns the
    launches of each path driven."""
    runs = []
    os.environ["TLSAN_DATA_CACHE"] = os.path.join(tmp, "cache")  # starts cold
    data_dir = cli_data(tmp, "Electronics", card)
    if not native.available():
        raise AssertionError("the native builder does not build on this host")

    # TLSAN at the reference widths: one epoch, K1/K2 counted exactly
    model_dir = os.path.join(tmp, "tlsan_Electronics")
    t0 = time.perf_counter()
    head, evals, epoch, launches = _cli_train(
        data_dir, model_dir, "Electronics", TLSAN_FAMILY,
        ["--eval_freq", "1000", "--train_batch_size", str(CLI_ELECTRONICS_BATCH)])
    runs.append(launches)
    if head["builder"] != "native" or head["steps_per_call"] != "500":
        raise AssertionError(f"train.cli header {head}: expected the native "
                             "builder and 500 steps a chunk")
    log(f"cli train tlsan Electronics ({card}): {head['train']} rows, "
        f"{evals[-1]['step']} steps in {time.perf_counter() - t0:.3f} s; "
        f"cold prepare (native) {head['prepare_s']} s; "
        f"{epoch['examples_per_s']:.1f} train examples/s over the epoch with "
        f"{len(evals) - 1} evaluations of {head['test']} users inside; AUC "
        f"{[round(r['auc'], 6) for r in evals]}; launches {launches}")

    # serve.cli on that model_dir: every test user, from a cache hit
    recs_path = os.path.join(tmp, "recs.jsonl")
    reset_launches()  # the serve CLI's path starts here
    metric, _ = _run_cli(serve_cli.main, [
        "--model_dir", model_dir, "--dataset", "Electronics", "--data_dir",
        data_dir, "--k", str(K), "--out", recs_path, "--show", "0"])
    n_users = int(head["test"])
    runs.append(expect_launches(_plus(), _times(TLSAN_FAMILY.per_batch,
                                                2 * -(-n_users // BATCH)),
                                "serve.cli"))  # a warm-up and a timed call
    if metric["builder"] != "cache":
        raise AssertionError(f"serve.cli's prepare was a {metric['builder']}, not a cache hit")
    with open(recs_path) as f:
        recs = [json.loads(line) for line in f]
    if len(recs) != n_users:
        raise AssertionError(f"serve.cli wrote {len(recs)} lines for {n_users} users")
    prep = train_cli.prepare("tlsan", os.path.join(data_dir, "Electronics.npz"),
                             ModelConfig(model="tlsan"))  # the same cache entry
    first = {k: v[:CLI_CPU_CHECK_USERS] for k, v in prep.test.arrays.items()
             if k not in ("i", "j")}
    cpu = Recommender.from_model_dir(model_dir, prep.cate_list, device="cpu", k=K)
    ids_c, sc_c = cpu.recommend(first)
    ids_g = np.array([r["items"] for r in recs[:CLI_CPU_CHECK_USERS]])
    sc_g = np.array([r["scores"] for r in recs[:CLI_CPU_CHECK_USERS]], np.float32)
    if [r["user"] for r in recs[:CLI_CPU_CHECK_USERS]] != first["u"].tolist():
        raise AssertionError("serve.cli's users are not the test rows in order")
    assert_topk_match(ids_g, sc_g, ids_c, sc_c, SCORE_TOL)
    log(f"cli serve tlsan Electronics ({card}): {n_users} users, "
        f"{metric['value']:.1f} users/s (top-{K} over {metric['catalog']} items); "
        f"prepare warm (cache hit) {metric['prepare_s']:.3f} s; the first "
        f"{CLI_CPU_CHECK_USERS} users as the CPU serves them (scores to "
        f"{SCORE_TOL}, as written to 4 decimals)")
    # the HTTP benchmark at its defaults on this model, as a user runs it
    # (a subprocess: its launches are not this process's)
    line = json.loads(_bench("http", "--model_dir", model_dir, "--dataset",
                             "Electronics", "--data_dir", data_dir)[-1])
    check_http(line, card, ITEMS)

    # ATRank and the mesh on a Digital-Music-sized fixture
    data_dir = cli_data(tmp, "Digital_Music", card)
    t0 = time.perf_counter()
    head, evals, epoch, launches = _cli_train(
        data_dir, os.path.join(tmp, "atrank_Digital_Music"), "Digital_Music",
        ATRANK_FAMILY)
    runs.append(launches)
    log(f"cli train atrank Digital_Music ({card}): {head['train']} rows, "
        f"{evals[-1]['step']} steps in {time.perf_counter() - t0:.3f} s; "
        f"{epoch['examples_per_s']:.1f} train examples/s over the epoch; AUC "
        f"{[round(r['auc'], 6) for r in evals]}; launches {launches}")
    # --dropout: both attention families train with the masks in K1/K2 and
    # K3 (ATRank at batch 128: a quarter of the steps of the run above)
    for fam, extra in ((TLSAN_FAMILY, []), (ATRANK_FAMILY, ["--train_batch_size", "128"])):
        t0 = time.perf_counter()
        head, evals_d, epoch, launches = _cli_train(
            data_dir, os.path.join(tmp, f"{fam.name}_dropout"), "Digital_Music", fam,
            ["--dropout", str(DROPOUT), *extra])
        runs.append(launches)
        log(f"cli train {fam.name} --dropout {DROPOUT} Digital_Music ({card}): "
            f"{evals_d[-1]['step']} steps in {time.perf_counter() - t0:.3f} s; AUC "
            f"{[round(r['auc'], 6) for r in evals_d]}; launches {launches}")
    one_dir, mesh_dir = (os.path.join(tmp, f"tlsan_{w}") for w in ("one", "mesh"))
    extra = ["--eval_freq", str(CLI_MESH_EVAL_FREQ), "--best_after_step", "0"]
    t0 = time.perf_counter()
    head, evals_one, epoch, launches = _cli_train(data_dir, one_dir, "Digital_Music",
                                                  TLSAN_FAMILY, extra)
    runs.append(launches)
    log(f"cli train tlsan Digital_Music ({card}): {head['train']} rows, "
        f"{evals_one[-1]['step']} steps in {time.perf_counter() - t0:.3f} s; "
        f"{epoch['examples_per_s']:.1f} train examples/s over the epoch; AUC "
        f"{[round(r['auc'], 6) for r in evals_one]}; launches {launches}")
    # --profile: a torch.profiler trace of three chunks, on copies, before
    # the epoch; the trace must name K1 and K2
    profile_dir = os.path.join(tmp, "tlsan_profile")
    t0 = time.perf_counter()
    head, evals_p, _, launches = _cli_train(
        data_dir, profile_dir, "Digital_Music", TLSAN_FAMILY,
        ["--profile", "--steps_per_call", str(CLI_PROFILE_STEPS_PER_CALL),
         "--eval_freq", "1000"], profile_steps=3 * CLI_PROFILE_STEPS_PER_CALL)
    runs.append(launches)
    trace = os.path.join(profile_dir, "profile", "trace.json")
    with open(trace, "rb") as f:
        text = f.read()
    missing = [k for k in (b"fwa_fwd_kernel", b"fwa_bwd_kernel") if k not in text]
    if missing:
        raise AssertionError(f"train.cli --profile: {trace} names no {missing}")
    log(f"cli train tlsan --profile Digital_Music ({card}): a trace of "
        f"{3 * CLI_PROFILE_STEPS_PER_CALL} steps ({len(text)} bytes, naming "
        f"fwa_fwd_kernel and fwa_bwd_kernel) and the epoch in "
        f"{time.perf_counter() - t0:.3f} s; AUC {[round(r['auc'], 6) for r in evals_p]}; "
        f"launches {launches}")
    backend, device = mesh_setup()
    t0 = time.perf_counter()
    _, _, _, mesh_launches = _cli_train(
        data_dir, mesh_dir, "Digital_Music", TLSAN_FAMILY,
        [*extra, "--dp", str(MESH_DP), "--mp", str(MESH_MP), "--dist_backend",
         backend, "--device", device], check_launches=False)
    mesh_s = time.perf_counter() - t0
    if any(mesh_launches.values()):  # the ranks launch; this process must not
        raise AssertionError(f"the spawning process launched {mesh_launches}")
    evals_mesh = [r for r in _records(mesh_dir) if r["kind"] in ("eval", "final")]
    worst = 0.0
    for a, b in zip(evals_one, evals_mesh, strict=True):
        if a["step"] != b["step"] or a.keys() != b.keys():
            raise AssertionError(f"mesh evaluation {b} against one process's {a}")
        worst = max([worst] + [abs(a[k] - b[k]) for k in a
                               if k not in ("kind", "step", "wall_s")])
    if worst > CLI_MESH_TOL:
        raise AssertionError(f"the mesh's metrics differ from one process's by {worst:.3e}")
    log(f"cli train tlsan Digital_Music --dp {MESH_DP} --mp {MESH_MP} "
        f"--dist_backend {backend} ({card}): {len(evals_mesh)} evaluations "
        f"within {worst:.3e} of one process (tolerance {CLI_MESH_TOL}); the "
        f"world's run {mesh_s:.3f} s")

    # every family's prepare: the card host's native builder against numpy
    path = os.path.join(data_dir, "Digital_Music.npz")
    t0 = time.perf_counter()
    for name in CLI_FAMILIES:
        cfg = ModelConfig(model=name, hidden_units=32 if name == "csan" else D)
        fast = train_cli.prepare(name, path, cfg, use_cache=False)
        native.available, available = (lambda: False), native.available
        try:
            slow = train_cli.prepare(name, path, cfg, use_cache=False)
        finally:
            native.available = available
        if (fast.builder, slow.builder) != ("native", "numpy") or fast.cfg != slow.cfg:
            raise AssertionError(f"prepare {name}: {fast.builder} {fast.cfg} "
                                 f"against {slow.builder} {slow.cfg}")
        for split in ("train", "test"):
            a, b = getattr(fast, split), getattr(slow, split)
            if a.n != b.n or a.arrays.keys() != b.arrays.keys() or any(
                    a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k])
                    for k in a.arrays):
                raise AssertionError(f"prepare {name}: native {split} arrays "
                                     "differ from the numpy builders'")
    log(f"cli prepare ({card}): the native builder equals the numpy builders "
        f"byte for byte for {len(CLI_FAMILIES)} families on Digital_Music in "
        f"{time.perf_counter() - t0:.3f} s")
    del os.environ["TLSAN_DATA_CACHE"]
    return runs


# ------------------------------------------------------------------ dropout

DROPOUT_FANOUT_R = 4
MIGRATE = pathlib.Path(__file__).resolve().parent / "tlsan_tpu_torch/tools/fixtures/jax_tlsan"
MIGRATE_DATASET = "Tiny"
# the JAX Trainer's configuration that wrote the fixture
# (tests/test_torch_checkpoint_jax.py::FIXTURE_TC), and its split of steps
MIGRATE_TC = dict(optimizer="adam", learning_rate=0.01, train_batch_size=32,
                  test_batch_size=32, max_epochs=1, steps_per_call=3,
                  eval_freq=10**9, best_after_step=0, tb_histograms=False,
                  sparse_updates=False)
MIGRATE_PRE_STEPS, MIGRATE_K = 3, 10
# Adam's update of an exactly-zero gradient (FWA's b2) is sign-like rounding
# noise and walks apart between any two programs by up to lr a step
# (tests/test_torch_sparse.py's walk bound)
MIGRATE_WALK_LEAVES, MIGRATE_WALK_BOUND = ("long.0.b2", "short.0.b2"), 1e-1
MIGRATE_TOL = 1e-4  # tests/test_torch_optim.py's Adam chunk against the JAX Trainer


def _dropout_trainer(tmp: str, fam: Family, card: str) -> dict:
    """`fam`'s Trainer.train() with dropout DROPOUT on the card: the train
    phase's rows and cadence (300 steps of batch 32, evaluations every
    100), the launches of a step and an eval batch exact (the kernels take
    the masks: nothing falls back), the losses finite and the final AUC
    above 0.5; evaluation draws no mask (the weights evaluated as a model
    at rate 0 give the same AUC, bit for bit), and the train loss does
    (with a generator it differs from the loss without).  Returns the
    path's launches."""
    tag = f"dropout train {fam.name}"
    cfg = dataclasses.replace(fam.cfg, dropout=DROPOUT)
    tc = TrainConfig(model_dir=os.path.join(tmp, f"{fam.name}_dropout"), max_epochs=1,
                     steps_per_call=fam.steps_per_call, eval_freq=fam.eval_every,
                     display_freq=fam.steps_per_call, best_after_step=0,
                     save_auc_gate=0.0, tb_histograms=False, seed=SEED)
    train, test, cate_list = fam.train_data(np.random.default_rng(SEED + 1), USERS,
                                            ITEMS, fam.train_rows, fam.test_users)
    eval_batches = -(-fam.test_users // TEST_B)
    reset_launches()  # the dropout train path starts here
    t0 = time.perf_counter()
    tr = Trainer(fam.model, cfg, tc, cate_list, train, test, device="cuda")
    tr.train()
    train_s = time.perf_counter() - t0
    recs = _records(tc.model_dir)
    evals = [r for r in recs if r["kind"] in ("eval", "final")]
    losses = [r["loss"] for r in recs if r["kind"] == "train"]
    launches = expect_launches(_plus(), _plus(
        _times(fam.per_step, tr.step), _times(fam.per_eval_batch, len(evals) * eval_batches)),
        f"{tag}: Trainer.train")  # and ends here
    if tr.step != fam.train_rows // TRAIN_B or not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: step {tr.step}, losses {losses}")
    if not evals[-1]["auc"] > 0.5:
        raise AssertionError(f"{tag}: final AUC {evals[-1]['auc']}")
    model0 = fam.model(fam.cfg, "cuda")
    model0.load_state_dict(tr.model.state_dict())
    ev0 = Evaluator(fam.cfg, tr.cate_list, test, TEST_B, "cuda")
    auc, auc0 = tr.evaluator.auc(tr.model), ev0.auc(model0)
    batch = {k: v[:TRAIN_B] for k, v in tr.train_data.items()}
    with torch.no_grad():
        dropped = tr.model.loss(batch, tr.cate_list,
                                torch.Generator(device="cuda").manual_seed(SEED))
        plain = tr.model.loss(batch, tr.cate_list)
    expect_launches(launches, _plus(_times(PER_AUC_BATCH[fam.name], 2 * eval_batches),
                                    _times(fam.per_summary, 2)), f"{tag}: checks")
    if auc != auc0 or float(dropped) == float(plain):
        raise AssertionError(f"{tag}: AUC {auc} against {auc0} at rate 0; loss "
                             f"{float(dropped)} with masks, {float(plain)} without")
    log(f"{tag} ({card}): {tr.step} steps in {train_s:.3f} s, chunk losses "
        f"{[round(x, 4) for x in losses]}, AUC {[round(r['auc'], 6) for r in evals]}; "
        f"eval equals rate 0 bit for bit ({auc:.6f}); launches {launches}")
    tr.close()
    return launches


def _dropout_mesh(tmp: str, backend: str, device: str, card: str) -> dict:
    """One TLSAN dp=2 leg with dropout DROPOUT (programs.chunk_program:
    MESH_LEG_STEPS global batches of TRAIN_B rows from the seed; every rank
    draws the global batch's masks and keeps its rows) against one process
    on the card: losses and every parameter within PARITY_TOL; each rank's
    K1/K2 launches exact.  Returns the ranks' chunk launches, summed."""
    fam = TLSAN_FAMILY
    cfg = dataclasses.replace(fam.cfg, dropout=DROPOUT)
    train, test, cate_list = fam.train_data(np.random.default_rng(SEED + 1), USERS,
                                            ITEMS, fam.train_rows, 1_024)
    idx = np.random.default_rng(SEED + 5).integers(0, train.n, (MESH_LEG_STEPS, TRAIN_B))
    tc = TrainConfig(model_dir=os.path.join(tmp, "mesh_dropout"), dp=MESH_DP, mp=1,
                     tb_histograms=False, sparse_updates=False, seed=SEED)
    t0 = time.perf_counter()
    ranks = run_local(programs.chunk_program, MESH_DP, 1, backend, device, MESH_TIMEOUT_S,
                      cfg=cfg, tc=tc, cate_list=cate_list, train=train, test=test, idx=idx)
    world_s = time.perf_counter() - t0
    for r in ranks:
        if r["launches"]["chunk"] != _plus(_times(fam.per_step, MESH_LEG_STEPS)):
            raise AssertionError(f"dropout mesh rank {r['rank']}: launches "
                                 f"{r['launches']['chunk']}")
    tr = Trainer(fam.model, cfg, dataclasses.replace(
        tc, dp=1, model_dir=os.path.join(tmp, "one_dropout")), cate_list, train, test,
        device="cuda")
    losses = tr._train_chunk(torch.from_numpy(idx).cuda()).cpu().numpy()
    worst = float(np.abs(ranks[0]["losses"] - losses).max())
    if not worst <= PARITY_TOL:
        raise AssertionError(f"dropout mesh: losses {ranks[0]['losses']} against one "
                             f"process's {losses}")
    got = {k: torch.from_numpy(v).cuda() for k, v in ranks[0]["state"].items()}
    worst = max(worst, _check_close("dropout mesh", got, {
        k: v.detach() for k, v in tr.model.state_dict().items()}, PARITY_TOL, PARITY_TOL))
    tr.close()
    log(f"dropout mesh tlsan dp={MESH_DP} ({backend}, {card}): {MESH_LEG_STEPS} steps "
        f"at dropout {DROPOUT} within {worst:.3e} of one process (losses and every "
        f"parameter; tolerance {PARITY_TOL}); the world's run {world_s:.3f} s")
    return _plus(*(r["launches"]["chunk"] for r in ranks))


def _dropout_fanout(tmp: str, fam: Family, card: str) -> dict:
    """A fan-out of DROPOUT_FANOUT_R seeds with dropout DROPOUT on the card
    (each replica's masks from its own generator): PARITY_STEPS steps, each
    replica against a Trainer at its seed with the same dropout
    (PARITY_TOL), at FANOUT_PARITY_LR; launches exact whatever R is.
    Returns the fan-out chunk's launches."""
    tag = f"dropout fanout {fam.name}"
    cfg = dataclasses.replace(fam.cfg, dropout=DROPOUT)
    train, test, cate_list = fam.train_data(np.random.default_rng(SEED + 1), USERS,
                                            ITEMS, fam.train_rows, 1_024)
    tc = TrainConfig(model_dir=os.path.join(tmp, f"fan_{fam.name}"), max_epochs=1,
                     steps_per_call=STEPS_PER_CALL, eval_freq=10**9, best_after_step=0,
                     tb_histograms=False, seed=SEED,
                     learning_rate=FANOUT_PARITY_LR.get(fam.name, fam.parity_lr))
    seeds = FANOUT_SEEDS[:DROPOUT_FANOUT_R]
    # construction records the forward's draw shapes (one forward)
    fan = ReplicaFanout(fam.model, cfg, tc, cate_list, train, test, seeds, device="cuda")
    chunks = torch.from_numpy(fan._epoch_index(0)).cuda()
    reset_launches()  # the fan-out's dropout path starts here
    losses = fan._fan_chunk(chunks[0][:, :PARITY_STEPS]).cpu()
    launches = expect_launches(_plus(), _times(fam.per_step, PARITY_STEPS),
                               f"{tag}: {PARITY_STEPS} steps")  # and ends here
    worst = 0.0
    for r, seed in enumerate(seeds):
        tr = Trainer(fam.model, cfg, dataclasses.replace(
            tc, seed=seed, model_dir=os.path.join(tmp, f"fan_{fam.name}_{seed}")),
            cate_list, train, test, device="cuda")
        loss = tr._train_chunk(chunks[0][r, :PARITY_STEPS]).mean().cpu()
        if not abs(float(loss - losses[r])) <= PARITY_TOL * (1 + abs(float(loss))):
            raise AssertionError(f"{tag} replica {r}: loss {float(losses[r])} against "
                                 f"the Trainer's {float(loss)}")
        worst = max(worst, abs(float(loss - losses[r])), _check_close(
            f"{tag} replica {r}", {k: v[r].detach() for k, v in fan.params.items()},
            {k: v.detach() for k, v in tr.model.named_parameters()},
            PARITY_TOL, PARITY_TOL))
        tr.close()
    log(f"{tag} ({card}): {DROPOUT_FANOUT_R} replicas at dropout {DROPOUT}, each "
        f"within {worst:.3e} of a Trainer at its seed after {PARITY_STEPS} steps at lr "
        f"{tc.learning_rate} (tolerance {PARITY_TOL}); launches {launches}")
    return launches


def phase_migrate(tmp: str, card: str) -> dict:
    """The JAX package's TLSAN --model_dir (the committed fixture: Adam, 3
    steps, a 30-item catalog) on the card: the port's Trainer resumes it
    (step, schedule count and moments) and its next steps, with K1 and K2
    counted exactly, give the JAX Trainer's parameters (MIGRATE_TOL; FWA's
    b2 to the walk bound); serve.cli --model_dir on it gives the JAX
    Recommender's top-k (HTTP_SCORE_TOL: scores printed to 4 decimals).
    Returns the path's launches."""
    model_dir = os.path.join(tmp, "jax_model_dir")
    shutil.copytree(MIGRATE / "model_dir", model_dir)
    data_dir = str(MIGRATE / "Data")
    os.environ["TLSAN_DATA_CACHE"] = "0"
    try:
        prep = train_cli.prepare("tlsan", os.path.join(data_dir, f"{MIGRATE_DATASET}.npz"),
                                 ModelConfig(model="tlsan"))
        tc = TrainConfig(model_dir=model_dir, from_scratch=False, **MIGRATE_TC)
        reset_launches()  # the migrate path starts here
        tr = Trainer(TLSAN, prep.cfg, tc, prep.cate_list, prep.train, prep.test,
                     device="cuda")
        if tr.step != MIGRATE_PRE_STEPS or tr.opt_state.count != MIGRATE_PRE_STEPS:
            raise AssertionError(f"migrate: restored step {tr.step}, count "
                                 f"{tr.opt_state.count}")
        with np.load(MIGRATE / "continue.npz") as c:
            steps = len(c["idx"])
            loss = float(tr._train_chunk(torch.from_numpy(c["idx"]).cuda()).mean())
            want = {k[len("param."):]: c[k] for k in c.files if k.startswith("param.")}
            want_loss = float(c["loss"])
        n = expect_launches(_plus(), _times(TLSAN_FAMILY.per_step, steps), "migrate resume")
        worst = abs(loss - want_loss)
        if not worst <= PARITY_TOL * (1 + abs(want_loss)):
            raise AssertionError(f"migrate: loss {loss} against the JAX Trainer's {want_loss}")
        got = {k: v.detach().cpu().numpy() for k, v in tr.model.state_dict().items()}
        if got.keys() != want.keys():
            raise AssertionError("migrate: the parameters' names differ")
        for k, w in want.items():
            err = float(np.abs(got[k] - w).max())
            bar = (MIGRATE_WALK_BOUND if k in MIGRATE_WALK_LEAVES
                   else MIGRATE_TOL * (1 + float(np.abs(w).max())))
            if not err <= bar:
                raise AssertionError(f"migrate: {k} differs from the JAX Trainer's by {err:.3e}")
            if k not in MIGRATE_WALK_LEAVES:
                worst = max(worst, err)
        tr.close()
        out = os.path.join(tmp, "migrate_recs.jsonl")
        _run_cli(serve_cli.main, ["--model_dir", str(MIGRATE / "model_dir"), "--dataset",
                                  MIGRATE_DATASET, "--data_dir", data_dir, "--k",
                                  str(MIGRATE_K), "--out", out, "--device", "cuda"])
        launches = launch_counts()  # and ends here
    finally:
        del os.environ["TLSAN_DATA_CACHE"]
    with open(out) as f:
        rows = [json.loads(line) for line in f]
    with np.load(MIGRATE / "topk.npz") as t:
        want_ids, want_sc = t["ids"], t["scores"]
    users = len(want_ids)
    # serve.cli recommends every user twice (a warm-up and the timed pass)
    expect_launches(n, _times(TLSAN_FAMILY.per_batch, 2 * -(-users // 128)), "migrate serve")
    if len(rows) != users:
        raise AssertionError(f"migrate: serve.cli wrote {len(rows)} users of {users}")
    assert_topk_match(np.array([r["items"] for r in rows]),
                      np.array([r["scores"] for r in rows]), want_ids, want_sc,
                      HTTP_SCORE_TOL)
    log(f"migrate ({card}): the JAX package's TLSAN --model_dir resumed at step "
        f"{MIGRATE_PRE_STEPS} (Adam moments and count), {steps} steps within {worst:.3e} "
        f"of the JAX Trainer's (tolerance {MIGRATE_TOL}; b2 to the walk bound); "
        f"serve.cli gives the JAX Recommender's top-{MIGRATE_K} for {users} users "
        f"(scores within {HTTP_SCORE_TOL}); launches {launches}")
    return launches


def phase_dropout_paths(tmp: str, card: str, backend: str, device: str) -> list:
    """Dropout on the main paths: the Trainer (TLSAN and ATRank), one dp=2
    mesh leg (TLSAN) and the fan-out (TLSAN and ATRank) on the card.
    Returns each path's launches."""
    t0 = time.perf_counter()
    runs = [_dropout_trainer(tmp, fam, card) for fam in (TLSAN_FAMILY, ATRANK_FAMILY)]
    runs.append(_dropout_mesh(tmp, backend, device, card))
    runs += [_dropout_fanout(tmp, fam, card) for fam in (TLSAN_FAMILY, ATRANK_FAMILY)]
    log(f"dropout paths: in {time.perf_counter() - t0:.1f} s")
    return runs


# ------------------------------------------------------------------ fanout

# launches of one AUC pass's batch (the fan-out evaluates the AUC alone):
# TLSAN's pair logits are one user forward; ATRank encodes once and reads
# out twice
PER_AUC_BATCH = {"tlsan": {"fwa_fwd": 2}, "atrank": {"mha_fwd": 3 * ATRANK_BLOCKS}}


def _replica_fwa_inputs(R: int, shape, seed: int):
    """K1/K2's inputs for R replicas, each `_fwa_inputs` of its own seed,
    stacked on a leading axis: (x, lengths, num_heads, w1, b1, w2, b2), g."""
    B, S, d, h = _fwa_shape(shape)
    x, lengths, w1, b1, w2, b2 = (torch.stack(ts) for ts in zip(
        *[_fwa_inputs(B, S, seed + r, d, h) for r in range(R)]))
    g = torch.from_numpy(np.random.default_rng(seed + 99).normal(
        size=(R, B, d)).astype(np.float32)).cuda()
    return (x, lengths, h, w1, b1, w2, b2), g


def _replica_mha_inputs(R: int, B: int, Tq: int, Tk: int, self_attention: bool,
                        seed: int, d: int):
    """K3's arguments for R replicas, each `_mha_inputs` of its own seed,
    stacked on a leading axis (self-attention: keys is queries)."""
    per = [_mha_inputs(B, Tq, Tk, self_attention, seed + r, d) for r in range(R)]
    q = torch.stack([p[0] for p in per])
    k = q if self_attention else torch.stack([p[1] for p in per])
    q_len = torch.stack([p[2] for p in per])
    k_len = q_len if self_attention else torch.stack([p[3] for p in per])
    ws = [torch.stack([p[4][n] for p in per]) for n in cuda_mha.WEIGHTS]
    return q, k, q_len, k_len, ws


def _slice(args, r):
    """Replica r's arguments of a replica call."""
    return tuple(t[r] if torch.is_tensor(t) else t for t in args)


def _replica_times(kernel: str, replica, single, singles) -> dict:
    """Per-call ms (CUDA events) of one replica launch, one single launch
    and R single launches; device ms (the profiler) of the replica launch
    and of the R singles."""
    return {"ms": _cuda_ms(replica), "single_ms": _cuda_ms(single),
            "singles_ms": _cuda_ms(singles),
            "device_ms": _device_ms(replica, kernel),
            "singles_device_ms": _device_ms(singles, kernel)}


def _add_replica(main: dict, times: dict, bounds) -> None:
    for key, v in (*times.items(), ("bytes_ms", bounds[0]), ("ops_ms", bounds[1])):
        if isinstance(v, float):
            main[key] = main.get(key, 0.0) + v


def _replica_row(main: dict, worst: float, tag: str) -> dict:
    """The kernel line's replica fields from the summed main-path times."""
    bound_ms = max(main["bytes_ms"], main["ops_ms"])
    log(f"kernel {tag} at R={FANOUT_R} (the two main-path launches of a train "
        f"step, summed): replica launch {main['ms']:.6f} ms a call against one "
        f"single launch {main['single_ms']:.6f} ms and {FANOUT_R} of them "
        f"{main['singles_ms']:.6f} ms; bound {bound_ms:.6f} ms "
        f"({'bytes' if main['bytes_ms'] >= main['ops_ms'] else 'operations'})")
    return {"replicas": FANOUT_R, "replica_ms": main["ms"],
            "replica_single_ms": main["single_ms"],
            "replica_singles_ms": main["singles_ms"],
            "replica_bound_ms": bound_ms, "replica_max_abs_err": worst}


def phase_fanout_kernels() -> dict:
    """K1, K2, K3 and K3b with a replica axis of weights at R = 1, 3 and 8:
    against their plain versions on each replica, against single launches
    on each replica's slice (bit for bit for K1, K2 and K3b, and for K3
    where the plan's cluster size is the same for R·B rows as for B),
    bitwise repeatable; FWAFunction's and MHAFunction's vmap rules on the
    card (one launch each way, gradients against autograd of the plain
    version under vmap);
    times and bounds at R = 8.  Returns each kernel's replica fields."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = {}
    worst_f = worst_b = 0.0
    main_f, main_b = {}, {}
    train_main = [_fwa_shape(s) for s in TRAIN_SHAPES]
    for i, shape in enumerate(FANOUT_FWA):
        B, S, d, h = _fwa_shape(shape)
        for R in FANOUT_KERNEL_RS:
            what = f"replica {_fwa_tag('fwa', B, S, d, h)} R={R}"
            args, g = _replica_fwa_inputs(R, shape, SEED + 100 + 10 * i)
            got, again = cuda_fwa.fwa_forward(*args), cuda_fwa.fwa_forward(*args)
            bwd, bwd_again = cuda_fwa.fwa_backward(*args, g), cuda_fwa.fwa_backward(*args, g)
            torch.cuda.synchronize()
            if not torch.equal(got, again) or not all(
                    torch.equal(a, b) for a, b in zip(bwd, bwd_again)):
                raise AssertionError(f"{what}: two calls differ")
            for r in range(R):
                one = _slice(args, r)
                if not torch.equal(cuda_fwa.fwa_forward(*one), got[r]):
                    raise AssertionError(f"{what}: K1 replica {r} differs from a single launch")
                err = float((got[r] - feature_wise_attention_reference(*one)).abs().max())
                if not err <= KERNEL_TOL:
                    raise AssertionError(f"{what}: K1 replica {r} max abs err {err:.3e}")
                worst_f = max(worst_f, err)
                mine = [t[r] for t in bwd]
                if not all(torch.equal(a, b) for a, b in
                           zip(cuda_fwa.fwa_backward(*one, g[r]), mine)):
                    raise AssertionError(f"{what}: K2 replica {r} differs from a single launch")
                worst_b = max(worst_b, _max_err(
                    mine, fwa_backward_reference(*one, g[r]),
                    fwa_backward_error_scale(*one, g[r]), f"{what} K2 replica {r}"))
            msg = (f"kernel {what}: K1 and K2 each replica within tolerance of the "
                   f"plain version and bit for bit a single launch; bitwise repeatable")
            if R == FANOUT_R and (B, S, d, h) in train_main:
                slices = [_slice(args, r) for r in range(R)]
                times_f = _replica_times(
                    "fwa_fwd_kernel", lambda: cuda_fwa.fwa_forward(*args),
                    lambda: cuda_fwa.fwa_forward(*slices[0]),
                    lambda: [cuda_fwa.fwa_forward(*a) for a in slices])
                times_b = _replica_times(
                    "fwa_bwd_kernel", lambda: cuda_fwa.fwa_backward(*args, g),
                    lambda: cuda_fwa.fwa_backward(*slices[0], g[0]),
                    lambda: [cuda_fwa.fwa_backward(*a, g[r]) for r, a in enumerate(slices)])
                bf = [R * v for v in fwa_bound(B, S, d, h)]
                bb = [R * v for v in fwa_bwd_bound(B, S, d, h)]
                _add_replica(main_f, times_f, bf)
                _add_replica(main_b, times_b, bb)
                msg += (f"; K1 {times_f} bound {max(bf):.6f} ms; K2 {times_b} bound "
                        f"{max(bb):.6f} ms")
            log(msg)
    rows["fwa_fwd"] = _replica_row(main_f, worst_f, "fwa_fwd")
    rows["fwa_bwd"] = _replica_row(main_b, worst_b, "fwa_bwd")

    # FWAFunction's vmap rule on the card: one K1 and one K2 launch for R
    # replicas, the lengths shared, gradients as autograd of the plain
    # version under vmap gives them
    B, S = TRAIN_SHAPES[1]
    (x, lengths, h, w1, b1, w2, b2), g = _replica_fwa_inputs(3, (B, S), SEED + 190)
    grads = []
    for fn in (cuda_fwa.FWAFunction.apply, feature_wise_attention_reference):
        leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        n = launch_counts()
        out = torch.func.vmap(lambda x, w1, b1, w2, b2: fn(x, lengths[0], h, w1, b1, w2, b2))(
            *leaves)
        grads.append(torch.autograd.grad(out, leaves, g))
        if fn is not feature_wise_attention_reference:
            expect_launches(n, {"fwa_fwd": 1, "fwa_bwd": 1}, "FWAFunction under vmap")
    for r in range(3):
        one = (x[r], lengths[0], h, w1[r], b1[r], w2[r], b2[r])
        _max_err([t[r] for t in grads[0]], [t[r] for t in grads[1]],
                 fwa_backward_error_scale(*one, g[r]), f"FWAFunction under vmap replica {r}")
    log("kernel fwa: FWAFunction under vmap (3 replicas, shared lengths) is one K1 and "
        "one K2 launch; its gradients match autograd of the plain version under vmap")

    worst, main = 0.0, {}
    worst_k3b, main_k3b = 0.0, {}
    mha_main = [_mha_shape(m) for m in MHA_TRAIN]
    for i, shape in enumerate(FANOUT_MHA):
        B, Tq, Tk, d, h = _mha_shape(shape)
        for self_attention in ([True, False] if Tq == Tk else [False]):
            for R in FANOUT_KERNEL_RS:
                what = (f"replica mha_fwd B={B} Tq={Tq} Tk={Tk}"
                        + ("" if (d, h) == (D, H) else f" D={d} H={h}")
                        + f" {'self' if self_attention else 'cross'} R={R}")
                q, k, ql, kl, ws = _replica_mha_inputs(R, B, Tq, Tk, self_attention,
                                                       SEED + 200 + 10 * i, d)
                args = (q, k, ql, kl, h, *ws)
                got, again = cuda_mha.mha_forward(*args), cuda_mha.mha_forward(*args)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"{what}: two calls differ")
                cs_r = cuda_mha.launch_plan(R * B, Tq, Tk, d, h, self_attention).cs
                cs_1 = cuda_mha.launch_plan(B, Tq, Tk, d, h, self_attention).cs
                single_err = 0.0
                for r in range(R):
                    one = _slice(args, r)
                    single = cuda_mha.mha_forward(*one)
                    if cs_r == cs_1 and not torch.equal(single, got[r]):
                        raise AssertionError(f"{what}: replica {r} differs from a "
                                             f"single launch of the same cluster size")
                    single_err = max(single_err, float((single - got[r]).abs().max()))
                    want, _ = multihead_attention_reference(
                        one[0], one[2], one[1], one[3], h, dict(zip(cuda_mha.WEIGHTS, one[5:])))
                    err = float((got[r] - want).abs().max())
                    if not err <= KERNEL_TOL or not single_err <= KERNEL_TOL:
                        raise AssertionError(f"{what}: replica {r} max abs err {err:.3e}, "
                                             f"{single_err:.3e} from a single launch")
                    worst = max(worst, err)
                # K3b: the replica launch is bit for bit R single launches
                # (its grid depends on the rows a replica alone)
                g = torch.from_numpy(np.random.default_rng(SEED + 250 + 10 * i + R).normal(
                    size=(R, B, Tq, d)).astype(np.float32)).cuda()
                bwd, bwd_again = cuda_mha.mha_backward(*args, g), cuda_mha.mha_backward(*args, g)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(bwd, bwd_again)):
                    raise AssertionError(f"{what}: K3b's two calls differ")
                for r in range(R):
                    one = _slice(args, r)
                    mine = [t[r] for t in bwd]
                    if not all(torch.equal(a, b) for a, b in
                               zip(cuda_mha.mha_backward(*one, g[r]), mine)):
                        raise AssertionError(f"{what}: K3b replica {r} differs from a "
                                             "single launch")
                    fwd = (one[0], one[2], one[1], one[3], h,
                           dict(zip(cuda_mha.WEIGHTS, one[5:])), g[r])
                    worst_k3b = max(worst_k3b, _mha_grad_err(
                        mine, multihead_attention_backward_reference(*fwd),
                        multihead_attention_backward_error_scale(*fwd),
                        f"{what} K3b replica {r}"))
                msg = (f"kernel {what}: clusters of {cs_r} (a single launch {cs_1}); each "
                       f"replica within tolerance of the plain version and "
                       + ("bit for bit" if cs_r == cs_1 else f"{single_err:.3e} from")
                       + " a single launch; K3b each replica within tolerance of the plain "
                       "backward and bit for bit a single launch; bitwise repeatable")
                if R == FANOUT_R and (B, Tq, Tk, d, h) in mha_main and \
                        self_attention == (Tq == Tk):
                    slices = [_slice(args, r) for r in range(R)]
                    times = _replica_times(
                        "mha_fwd_kernel", lambda: cuda_mha.mha_forward(*args),
                        lambda: cuda_mha.mha_forward(*slices[0]),
                        lambda: [cuda_mha.mha_forward(*a) for a in slices])
                    bounds = [R * v for v in mha_bound(B, Tq, Tk, self_attention, d)]
                    _add_replica(main, times, bounds)
                    times_b = _replica_times(
                        "mha_bwd_kernel", lambda: cuda_mha.mha_backward(*args, g),
                        lambda: cuda_mha.mha_backward(*slices[0], g[0]),
                        lambda: [cuda_mha.mha_backward(*a, g[r]) for r, a in enumerate(slices)])
                    bounds_b = [R * v for v in mha_bwd_bound(B, Tq, Tk, self_attention, d)]
                    _add_replica(main_k3b, times_b, bounds_b)
                    msg += (f"; K3 {times} bound {max(bounds):.6f} ms; K3b {times_b} bound "
                            f"{max(bounds_b):.6f} ms")
                log(msg)
    rows["mha_fwd"] = _replica_row(main, worst, "mha_fwd")
    rows["mha_bwd"] = _replica_row(main_k3b, worst_k3b, "mha_bwd")

    # MHAFunction's vmap rule on the card: self-attention stays one tensor,
    # one K3 and one K3b launch for R replicas, gradients as autograd of the
    # plain version under vmap
    B, Tq, Tk = MHA_TRAIN[0]
    q, _, ql, _, ws = _replica_mha_inputs(3, B, Tq, Tk, True, SEED + 290, D)
    g = torch.from_numpy(np.random.default_rng(SEED + 291).normal(
        size=tuple(q.shape)).astype(np.float32)).cuda()
    grads = []
    for fn in (cuda_mha.MHAFunction.apply, None):
        leaves = [t.clone().requires_grad_(True) for t in (q, *ws)]
        n = launch_counts()

        def one(x, ln, *w):
            if fn is None:
                return multihead_attention_reference(x, ln, x, ln, H,
                                                     dict(zip(cuda_mha.WEIGHTS, w)))[0]
            return fn(x, x, ln, ln, H, *w)

        out = torch.func.vmap(one)(leaves[0], ql, *leaves[1:])
        grads.append(torch.autograd.grad(out, leaves, g))
        if fn is not None:
            expect_launches(n, {"mha_fwd": 1, "mha_bwd": 1}, "MHAFunction under vmap")
    _mha_grad_err(*grads, _mha_scale(q, ql, q, ql, H, dict(zip(cuda_mha.WEIGHTS, ws)), g,
                                     True, leaves=True), "MHAFunction under vmap")
    log("kernel mha_fwd: MHAFunction under vmap (3 replicas, self-attention) is one K3 "
        "and one K3b launch; its gradients match autograd of the plain version under vmap")
    return rows


def _fanout_family(tmp: str, fam: Family, data, card: str) -> dict:
    """`fam`'s fan-out of FANOUT_R seeds on the card, at FANOUT_PARITY_LR:
    each replica's 20 steps against a Trainer at its seed (a fan-out of one
    replica bit for bit), the per-replica AUC against the
    single evaluator on the same weights, launches exact whatever R is
    (the kernels take the replica axis), replica-examples/s of a 100-step
    chunk at R = 1 and R = FANOUT_R beside the Trainer's, and the idle
    share of one profiled chunk.  Returns the path's launches and
    readings."""
    tag = f"fanout {fam.name}"
    train, test, cate_list = data
    tc = TrainConfig(model_dir=os.path.join(tmp, fam.name), max_epochs=1,
                     steps_per_call=STEPS_PER_CALL, eval_freq=10**9,
                     best_after_step=0, tb_histograms=False, seed=SEED,
                     learning_rate=FANOUT_PARITY_LR.get(fam.name, fam.parity_lr))
    per_auc = PER_AUC_BATCH.get(fam.name, {})
    auc_batches = -(-test.n // TEST_B)
    reset_launches()  # the fan-out path starts here
    n = launch_counts()
    t0 = time.perf_counter()
    fan, fan1 = (ReplicaFanout(fam.model, fam.cfg, tc, cate_list, train, test, seeds,
                               device="cuda")
                 for seeds in (FANOUT_SEEDS, FANOUT_SEEDS[:1]))
    chunks = torch.from_numpy(fan._epoch_index(0)).cuda()  # [n_chunks, R, K, B]
    chunks1 = torch.from_numpy(fan1._epoch_index(0)).cuda()
    losses = fan._fan_chunk(chunks[0][:, :PARITY_STEPS]).cpu()
    n = expect_launches(n, _times(fam.per_step, PARITY_STEPS),
                        f"{tag}: {PARITY_STEPS} steps of {FANOUT_R} replicas")
    fan1._fan_chunk(chunks1[0][:, :PARITY_STEPS])
    n = expect_launches(n, _times(fam.per_step, PARITY_STEPS),
                        f"{tag}: {PARITY_STEPS} steps of one replica")
    aucs = fan.auc()
    n = expect_launches(n, _times(per_auc, auc_batches), f"{tag}: the replica AUC")
    setup_s = time.perf_counter() - t0
    worst = worst_auc = 0.0
    for r, seed in enumerate(FANOUT_SEEDS):
        tr = Trainer(fam.model, fam.cfg, dataclasses.replace(
            tc, seed=seed, model_dir=os.path.join(tmp, f"{fam.name}_{seed}")),
            cate_list, train, test, device="cuda")
        loss = tr._train_chunk(chunks[0][r, :PARITY_STEPS]).mean().cpu()
        n = expect_launches(n, _times(fam.per_step, PARITY_STEPS), f"{tag}: Trainer {seed}")
        single = {k: v.detach() for k, v in tr.model.named_parameters()}
        if r == 0 and not all(torch.equal(fan1.params[k][0], v) for k, v in single.items()):
            raise AssertionError(f"{tag}: a fan-out of one replica is not bit for bit "
                                 f"the Trainer at its seed after {PARITY_STEPS} steps")
        worst = max(worst, abs(float(loss - losses[r])), _check_close(
            f"{tag} replica {r}", {k: v[r].detach() for k, v in fan.params.items()},
            single, PARITY_TOL, PARITY_TOL))
        if not abs(float(loss - losses[r])) <= PARITY_TOL * (1 + abs(float(loss))):
            raise AssertionError(f"{tag} replica {r}: loss {float(losses[r])} against "
                                 f"the Trainer's {float(loss)}")
        # the single evaluator on the replica's own weights
        with torch.no_grad():
            for k, p in tr.model.named_parameters():
                p.copy_(fan.params[k][r])
        auc_one = tr.evaluator.auc(tr.model)
        n = expect_launches(n, _times(per_auc, auc_batches), f"{tag}: evaluator {seed}")
        worst_auc = max(worst_auc, abs(auc_one - float(aucs[r])))
        tr.close()
    if not worst_auc <= 1.0 / test.n + 1e-9:
        raise AssertionError(f"{tag}: replica AUCs {aucs} differ from the single "
                             f"evaluator's by {worst_auc} (more than one test user)")
    log(f"{tag} ({card}): {FANOUT_R} replicas (seeds {FANOUT_SEEDS}) set up and "
        f"{PARITY_STEPS} steps in {setup_s:.3f} s; each replica within {worst:.3e} of a "
        f"Trainer at its seed after {PARITY_STEPS} steps at lr {tc.learning_rate} "
        f"(losses and every parameter; tolerance {PARITY_TOL}), one replica alone bit "
        f"for bit; replica AUCs {np.round(aucs, 6).tolist()} within "
        f"{worst_auc:.6f} of the single evaluator on the same weights; launches "
        f"{fam.per_step or 'none'} a step and {per_auc or 'none'} an AUC batch, "
        f"whatever R is")

    # replica-examples/s of one chunk at R = 1 and R = FANOUT_R, after a
    # warm-up chunk each, beside the Trainer's in the same run
    K = STEPS_PER_CALL
    rates = {}
    tr = Trainer(fam.model, fam.cfg, dataclasses.replace(
        tc, model_dir=os.path.join(tmp, f"{fam.name}_timed")), cate_list, train, test,
        device="cuda")
    for label, run, R in (("trainer", lambda c: tr._train_chunk(chunks1[c][0]), 1),
                          ("R=1", lambda c: fan1._fan_chunk(chunks1[c]), 1),
                          (f"R={FANOUT_R}", lambda c: fan._fan_chunk(chunks[c]), FANOUT_R)):
        run(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(1 % len(chunks))
        torch.cuda.synchronize()
        rates[label] = R * K * TRAIN_B / (time.perf_counter() - t0)
    n = expect_launches(n, _times(fam.per_step, 6 * K), f"{tag}: timed chunks")
    wall_ms, prof = device_profile(lambda: fan._fan_chunk(chunks[2 % len(chunks)]))
    n = expect_launches(n, _times(fam.per_step, K), f"{tag}: profiled chunk")
    launches = launch_counts()  # the fan-out path ends here
    tr.close()
    log(f"{tag} ({card}): one {K}-step chunk of batch {TRAIN_B}: Trainer "
        f"{rates['trainer']:.1f} examples/s; fan-out R=1 {rates['R=1']:.1f}, "
        f"R={FANOUT_R} {rates[f'R={FANOUT_R}']:.1f} replica-examples/s "
        f"({rates[f'R={FANOUT_R}'] / rates['trainer']:.2f}x the Trainer)")
    idle = _log_profile(tag, f"R={FANOUT_R} chunk of {K} steps", wall_ms, prof)
    return {"launches": launches, "rates": rates, "idle_share": idle}


def _fanout_tlsan_variants(tmp: str, data, card: str) -> dict:
    """TLSAN on the card, 20 steps each: replicas of one seed at lr_scales
    [1, 2] against Trainers at lr and 2·lr (PARITY_TOL), and a bf16
    fan-out of 2 seeds (the attention dispatchers' bf16 branch under vmap:
    K1/K2 in f32 between casts) against bf16 Trainers at its seeds (the ext
    phase's bf16 bounds)."""
    train, test, cate_list = data
    fam = TLSAN_FAMILY
    tc = TrainConfig(model_dir=os.path.join(tmp, "variants"), max_epochs=1,
                     steps_per_call=PARITY_STEPS, eval_freq=10**9, best_after_step=0,
                     tb_histograms=False, seed=SEED)
    reset_launches()  # the variants' path starts here
    worst, runs = {}, 0
    for what, seeds, scales, over, (rtol, atol) in (
            ("lr_scales", [SEED] * len(FANOUT_LR_SCALES), FANOUT_LR_SCALES, {},
             (PARITY_TOL, PARITY_TOL)),
            ("bf16", FANOUT_SEEDS[:2], None, {"compute_dtype": "bfloat16"},
             (BF16_RTOL, BF16_ATOL))):
        ftc = dataclasses.replace(tc, **over)
        fan = ReplicaFanout(fam.model, fam.cfg, ftc, cate_list, train, test, seeds, scales,
                            device="cuda")
        idx = torch.from_numpy(fan._epoch_index(0)[0]).cuda()
        losses = fan._fan_chunk(idx).cpu()
        runs += 1 + len(seeds)  # the fan-out's chunk and a Trainer's a seed
        worst[what] = 0.0
        for r, seed in enumerate(seeds):
            tr = Trainer(fam.model, fam.cfg, dataclasses.replace(
                ftc, seed=seed, learning_rate=(scales[r] if scales else 1.0) * tc.learning_rate,
                model_dir=os.path.join(tmp, f"{what}_{r}")), cate_list, train, test,
                device="cuda")
            loss = tr._train_chunk(idx[r]).mean().cpu()
            if not abs(float(loss - losses[r])) <= atol + rtol * abs(float(loss)):
                raise AssertionError(f"fanout {what} replica {r}: loss {float(losses[r])} "
                                     f"against the Trainer's {float(loss)}")
            worst[what] = max(worst[what], abs(float(loss - losses[r])), _check_close(
                f"fanout {what} replica {r}", {k: v[r].detach() for k, v in fan.params.items()},
                {k: v.detach() for k, v in tr.model.named_parameters()}, rtol, atol))
            tr.close()
    launches = expect_launches(_plus(), _times(fam.per_step, runs * PARITY_STEPS),
                               "fanout tlsan variants")  # and ends here
    log(f"fanout tlsan ({card}): lr_scales {FANOUT_LR_SCALES}, each replica within "
        f"{worst['lr_scales']:.3e} of a Trainer at its scaled lr after {PARITY_STEPS} "
        f"steps (tolerance {PARITY_TOL}); bf16, each replica within {worst['bf16']:.3e} "
        f"of a bf16 Trainer at its seed (rtol {BF16_RTOL}, atol {BF16_ATOL})")
    return launches


def _fanout_cli(tmp: str, card: str) -> dict:
    """`python -m tlsan_tpu_torch.train.ensemble` in-process on the cli
    phase's Digital-Music category file: 2 seeds, one epoch, one JSON line
    with the JAX fan-out's keys; K1 and K2 counted exactly."""
    data_dir = os.path.join(tmp, "Data")
    os.environ["TLSAN_DATA_CACHE"] = os.path.join(tmp, "cache")
    try:
        reset_launches()  # the command line's path starts here
        t0 = time.perf_counter()
        result, out = _run_cli(ensemble.main, [
            "--model", "tlsan", "--dataset", "Digital_Music", "--data_dir", data_dir,
            "--seeds", *FANOUT_CLI_SEEDS, "--max_epochs", "1", "--eval_freq", "1000"])
        launches = launch_counts()  # and ends here
    finally:
        del os.environ["TLSAN_DATA_CACHE"]
    lines = out.strip().splitlines()
    head = dict(f.split("=", 1) for f in
                next(ln for ln in lines if ln.startswith("fanout model=")).split()[1:])
    printed = json.loads(lines[-1])
    want_keys = {"seeds", "lr_scales", "best_auc", "best_step", "mean_best", "range",
                 "wall_s", "compile_s", "post_compile_wall_s", "replica_examples_per_s",
                 "post_compile_replica_examples_per_s"}
    if set(printed) != want_keys or head.get("device") != "cuda":
        raise AssertionError(f"ensemble main printed {sorted(printed)}, header {head}")
    steps = epoch_index(int(head["train"]), TRAIN_B, 100, 0, 1).shape
    steps = steps[0] * steps[1]
    evals = len(result["curves"]) + 1
    want = _plus(_times(TLSAN_FAMILY.per_step, steps),
                 _times(PER_AUC_BATCH["tlsan"], evals * -(-int(head["test"]) // TEST_B)))
    if launches != want:
        raise AssertionError(f"ensemble main: launches {launches}, expected {want}")
    log(f"fanout cli tlsan Digital_Music ({card}): {len(FANOUT_CLI_SEEDS)} seeds, "
        f"{steps} steps in {time.perf_counter() - t0:.3f} s; {json.dumps(printed)}; "
        f"launches {launches}")
    return launches


def phase_fanout(tmp: str, card: str):
    """The replica fan-out on the card: the kernels' replica axis, then
    TLSAN, ATRank and LSPM fan-outs at the Electronics catalog, lr_scales,
    and the command line.  Returns (the kernels' replica fields, each
    path's launches, the readings)."""
    t0 = time.perf_counter()
    rows = phase_fanout_kernels()
    paths, readings = [], {}
    lspm = next(fam for fam in BASELINES if fam.name == "lspm")
    for fam in (TLSAN_FAMILY, ATRANK_FAMILY, lspm):
        data = fam.train_data(np.random.default_rng(SEED + 1), USERS, ITEMS,
                              fam.train_rows, fam.test_users)
        out = _fanout_family(tmp, fam, data, card)
        paths.append(out.pop("launches"))
        readings[fam.name] = out
        if fam is TLSAN_FAMILY:
            paths.append(_fanout_tlsan_variants(tmp, data, card))
    paths.append(_fanout_cli(tmp, card))
    log(f"fanout: in {time.perf_counter() - t0:.1f} s")
    return rows, paths, readings

# ------------------------------------------------------------------- bench

# the benchmark entry points (tlsan_tpu_torch/bench/) at reduced sizes, run
# from the repository's root on its tracked Digital_Music cache
BENCH_TRAIN = ["--steps", "400", "--steps_per_call", "200", "--baseline_steps", "20"]
BENCH_TIMEOUT_S = 300


def _bench(module: str, *argv: str) -> list:
    """`python -m tlsan_tpu_torch.bench.<module> argv` from the repository's
    root; its stdout lines (it must exit 0 within BENCH_TIMEOUT_S)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"tlsan_tpu_torch.bench.{module}", *argv],
        cwd=pathlib.Path(__file__).resolve().parent, capture_output=True,
        text=True, timeout=BENCH_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"bench.{module} {' '.join(argv)} exited "
                             f"{proc.returncode}:\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    for line in proc.stderr.splitlines():
        log(f"  bench.{module}: {line}")
    log(f"bench.{module} {' '.join(argv)}: {time.perf_counter() - t0:.1f} s")
    return proc.stdout.splitlines()


def _positive(what: str, line: dict, keys) -> None:
    for key in keys:
        v = line[key]
        if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0):
            raise AssertionError(f"{what}: {key} = {v!r}, not a positive number")


def _keys(what: str, line: dict, want) -> None:
    if set(line) != set(want):
        raise AssertionError(f"{what}: keys {sorted(line)}, expected {sorted(want)}")


def phase_bench(card: str) -> None:
    """The four entry points as a user runs them: bench.train in f32 and
    bf16 (K1 2 and K2 2 a timed step, the plain version in none),
    bench.kernels (every row checked against its plain version before its
    timing), bench.roofline and bench.http on the migration fixture."""
    steps = 3 * int(BENCH_TRAIN[1])
    for dtype, suffix in (("f32", ""), ("bf16", "_bf16")):
        what = f"bench.train {dtype}"
        line = json.loads(_bench("train", *BENCH_TRAIN, "--compute_dtype", dtype)[-1])
        _keys(what, line, ("metric", "value", "unit", "vs_baseline",
                           "vs_reference_measured", "device", "launches"))
        if line["metric"] != f"tlsan_train_examples_per_sec_Digital_Music_b32{suffix}":
            raise AssertionError(f"{what}: metric {line['metric']}")
        _positive(what, line, ("value", "vs_baseline"))
        if (line["unit"], line["vs_reference_measured"], line["device"]) != (
                "examples/s", None, card):
            raise AssertionError(f"{what}: {line}")
        want = {"fwa_fwd": 2 * steps, "fwa_bwd": 2 * steps, "fwa_plain": 0,
                "steps": steps}
        if line["launches"] != want:
            raise AssertionError(f"{what}: launches {line['launches']}, expected {want}")
        log(f"{what} ({card}): {line['value']} examples/s, vs_baseline "
            f"{line['vs_baseline']}, launches {line['launches']}")

    out = _bench("kernels", "--big_batch", "2048")
    rows = [json.loads(r) for r in out if r.startswith("{")]
    tags = [f"{op}.{d}.{v}" for op in ("fwa", "mha") for d in ("fwd", "bwd")
            for v in ("cuda", "plain")]
    if sorted({r["kernel"] for r in rows}) != sorted(tags) or len(rows) != 4 * 8:
        raise AssertionError(f"bench.kernels: rows {[r['kernel'] for r in rows]}")
    for r in rows:
        what = f"bench.kernels {r['kernel']} B={r['B']}"
        _positive(what, r, ("us", "raw_us", "gbps", "sol_frac", "bound_us"))
        if r["device"] != card or r["bound_by"] not in ("bytes", "operations"):
            raise AssertionError(f"{what}: {r}")
    for r in out[out.index("") + 1:]:
        log(f"  bench.kernels: {r}")

    # at this K the stage deltas are within the host's noise: only the
    # full step and the idle share are read
    out = _bench("roofline", "--steps_per_call", "50")
    line = json.loads(out[-1])
    what = "bench.roofline"
    _keys(what, line, ("metric", "full_us_per_step", "gather_us", "fwd_delta_us",
                       "bwd_delta_us", "opt_delta_us", "sparse_us_per_step",
                       "dense_bytes_mb", "minimal_bytes_mb", "full_pct_hbm_sol",
                       "examples_per_s", "idle_share", "device"))
    _positive(what, line, ("full_us_per_step", "idle_share"))
    if (line["metric"], line["device"]) != ("roofline_Digital_Music_b32", card) \
            or not line["idle_share"] < 1:
        raise AssertionError(f"{what}: {line}")
    log(f"{what} ({card}): full step {line['full_us_per_step']:.1f} µs, idle "
        f"share {line['idle_share']:.3f}")

    # the migration fixture's 30 items: a check of the path, not a size
    check_http(json.loads(_bench(
        "http", "--model_dir", str(MIGRATE / "model_dir"), "--dataset", "Tiny",
        "--data_dir", str(MIGRATE / "Data"), "--reqs", "256")[-1]), card, 30)


def check_http(line: dict, card: str, catalog: int) -> None:
    """bench.http's last line: its keys, positive values, the defaults'
    batch and k, the catalog of the model served and the card."""
    what = "bench.http"
    _keys(what, line, ("metric", "value", "unit", "p50_single_request_ms",
                       "batch", "k", "catalog", "device"))
    _positive(what, line, ("value", "p50_single_request_ms"))
    if (line["metric"], line["unit"], line["batch"], line["k"], line["catalog"],
            line["device"]) != ("serve_http_requests_per_sec", "requests/s",
                                128, 10, catalog, card):
        raise AssertionError(f"{what}: {line}")
    log(f"{what} ({card}): {line['value']} requests/s, p50 "
        f"{line['p50_single_request_ms']} ms, catalog {catalog}")


# ------------------------------------------------------------------- widths
#
# The wide variants' shapes (tlsan_tpu_torch/tools/widths.py).  The weights
# are scaled by the fan-in (std 0.3·√(8/dh) for the head maps, 0.2·√(64/D)
# for the projections, the reference widths' own at dh = 8 and D = 64), as a
# model's initialisation scales them, so that every width sees scores of
# the same spread.
# the shapes whose times go to the kernels line and PERF.md (K1/K2 at heads
# of 64, 128 and 1024 features, both towers' S at 1024; K3 at one head, D =
# 512 and 1024 in 8 heads, D = 50 in 5 and the one-head readout; K3b's
# streamed design at four shapes, among them D = 256 and the D = 512
# readout)
WIDTHS_TIMED = {"fwa_fwd": [(32, 10, 64, 1), (128, 25, 128, 2), (32, 25, 128, 1),
                            (32, 10, 1024, 1), (32, 25, 1024, 1)],
                "fwa_bwd": [(32, 10, 64, 1), (128, 25, 128, 2), (32, 25, 128, 1),
                            (32, 10, 1024, 1), (32, 25, 1024, 1)],
                "mha_fwd": [(32, 96, 96, 64, 1), (32, 96, 96, 512, 8), (8, 96, 96, 1024, 8),
                            (32, 96, 96, 50, 5), (32, 1, 96, 64, 1)],
                "mha_bwd": [(32, 96, 96, 64, 1), (32, 96, 96, 512, 8), (32, 96, 96, 256, 8),
                            (32, 1, 96, 512, 8)]}
WIDTHS_REPEATS = 200  # calls at one train shape that must all equal the first
WIDTHS_R = 2          # the replica axis


def _wide_tol(dh: int, d: int, want: torch.Tensor) -> float:
    """K1's and K3's bar: KERNEL_TOL, or KERNEL_TOL · (1 + the output's
    magnitude) for heads of 128 features and more and for D past 256,
    whose dot products and LayerNorm sums add 128 to 512 rounded terms (at
    D = 512 in heads of one feature the plain version and K3 part by
    1.4e-5 on outputs of magnitude 4)."""
    long = dh >= 128 or d > 256
    return KERNEL_TOL * (1.0 + float(want.abs().max())) if long else KERNEL_TOL


def _widths_fwa_inputs(B: int, S: int, d: int, h: int, seed: int):
    x, lengths, w1, b1, w2, b2 = _fwa_inputs(B, S, seed, d, h)
    fan = math.sqrt(8.0 / (d // h))
    return x, lengths, w1 * fan, b1, w2 * fan, b2


def _widths_mha_inputs(B: int, Tq: int, Tk: int, self_attention: bool, seed: int, d: int):
    q, k, ql, kl, w = _mha_inputs(B, Tq, Tk, self_attention, seed, d)
    fan = math.sqrt(64.0 / d)
    return q, k, ql, kl, {n: t * fan if n.startswith("w") else t for n, t in w.items()}


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _repeat_equal(fn, what: str) -> None:
    first = fn()
    for n in range(WIDTHS_REPEATS):
        if not _same(fn(), first):
            raise AssertionError(f"{what}: call {n + 2} of {WIDTHS_REPEATS + 1} differs "
                                 "from the first")


def _widths_time(row: dict, name: str, fn, plain, bounds, kernel: str) -> str:
    """Per-call ms (CUDA events, fewer calls than the main shapes': a wide
    call takes up to milliseconds), device ms and the plain version's,
    added to `row`; returns the log's words."""
    ms = _cuda_ms(fn, iters=10, warmup=3, repeats=3)
    plain_ms = _cuda_ms(plain, iters=10, warmup=3, repeats=3)
    device_ms = _device_ms(fn, kernel, calls=10)
    _add(row, ms, plain_ms, *bounds)
    return (f"kernel_ms={ms:.6f} device_ms={device_ms} plain_ms={plain_ms:.6f} "
            f"bound_us={1e3 * max(bounds):.4f} (bytes {1e3 * bounds[0]:.4f} us, "
            f"operations {1e3 * bounds[1]:.4f} us)")


def phase_widths_fwa() -> tuple:
    """K1 and K2 at WIDTHS_FWA against their plain versions, with and
    without dropout masks, at R = WIDTHS_R against single launches (bit for
    bit) and the plain version, bitwise repeatable; FWAFunction against
    autograd.  Returns the two kernels' rows of the wide variant."""
    rows = {"fwa_fwd": {}, "fwa_bwd": {}}
    worst = {"fwa_fwd": 0.0, "fwa_bwd": 0.0}
    variants = set()
    for i, (B, S, d, h) in enumerate(WIDTHS_FWA):
        dh = d // h
        x, lengths, w1, b1, w2, b2 = _widths_fwa_inputs(B, S, d, h, SEED + 200 + i)
        g = torch.from_numpy(np.random.default_rng(SEED + 300 + i).normal(
            size=(B, d)).astype(np.float32)).cuda()
        fargs = (x, lengths, h, w1, b1, w2, b2)
        what = _fwa_tag("fwa_fwd", B, S, d, h)
        plan, bplan = cuda_fwa.launch_plan(B, S, d, h), cuda_fwa.launch_plan(B, S, d, h, True)
        variants.add(plan.wide)
        gen = torch.Generator(device="cuda").manual_seed(SEED + 400 + i)
        shape = (B, S, h, dh)
        masks = tuple(torch.rand(shape, generator=gen, device="cuda") < 1.0 - DROPOUT
                      for _ in range(2))
        for drop in ((), masks):
            rate = DROPOUT if drop else 0.0
            kd = (*drop, 1.0 - DROPOUT) if drop else ()
            tag = what + (f" dropout {DROPOUT}" if drop else "")
            got = cuda_fwa.fwa_forward(*fargs, *kd)
            want = feature_wise_attention_reference(*fargs, dropout_rate=rate,
                                                    keep_masks=drop or None)
            torch.cuda.synchronize()
            if not torch.equal(got, cuda_fwa.fwa_forward(*fargs, *kd)):
                raise AssertionError(f"{tag}: two calls differ")
            err, bar = float((got - want).abs().max()), _wide_tol(dh, d, want)
            if not err <= bar:
                raise AssertionError(f"{tag}: max abs err {err:.3e} above {bar:.3e}")
            worst["fwa_fwd"] = max(worst["fwa_fwd"], err)
            got_b = cuda_fwa.fwa_backward(*fargs, g, *kd)
            if not _same(got_b, cuda_fwa.fwa_backward(*fargs, g, *kd)):
                raise AssertionError(f"{tag.replace('fwa_fwd', 'fwa_bwd')}: two calls differ")
            worst["fwa_bwd"] = max(worst["fwa_bwd"], _max_err(
                got_b, fwa_backward_reference(*fargs, g, drop or None, rate),
                fwa_backward_error_scale(*fargs, g, drop or None, rate),
                tag.replace("fwa_fwd", "fwa_bwd")))
        # FWAFunction (K1, then K2) against autograd of the plain version
        leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        auto = torch.autograd.grad(feature_wise_attention_reference(
            leaves[0], lengths, h, *leaves[1:]), leaves, g)
        leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
        fn = torch.autograd.grad(cuda_fwa.FWAFunction.apply(leaves[0], lengths, h, *leaves[1:]),
                                 leaves, g)
        worst["fwa_bwd"] = max(worst["fwa_bwd"], _max_err(
            fn, auto, fwa_backward_error_scale(*fargs, g), what + " FWAFunction vs autograd"))
        # the replica axis: R launches' worth in one, each replica bit for
        # bit its single launch
        (rx, rl, _, *rw), rg = _replica_fwa_inputs(WIDTHS_R, (B, S, d, h), SEED + 500 + i)
        fan = math.sqrt(8.0 / dh)
        rw = [rw[0] * fan, rw[1], rw[2] * fan, rw[3]]
        rargs = (rx, rl, h, *rw)
        rep, rep_b = cuda_fwa.fwa_forward(*rargs), cuda_fwa.fwa_backward(*rargs, rg)
        for r in range(WIDTHS_R):
            one = _slice(rargs, r)
            if not torch.equal(rep[r], cuda_fwa.fwa_forward(*one)):
                raise AssertionError(f"{what} R={WIDTHS_R}: replica {r} differs from its launch")
            if not _same([t[r] for t in rep_b], cuda_fwa.fwa_backward(*one, rg[r])):
                raise AssertionError(f"{what} R={WIDTHS_R}: replica {r}'s K2 differs")
            err = float((rep[r] - feature_wise_attention_reference(*one)).abs().max())
            if not err <= _wide_tol(dh, d, rep[r]):
                raise AssertionError(f"{what} R={WIDTHS_R}: replica {r} off by {err:.3e}")
        if plan.wide:
            k1 = ("K1 fused, a CTA a batch row" if plan.fused else
                  f"K1 tiled, {plan.grid} tiles a product in {plan.passes} pass(es)")
            mapping = (f"wide: {k1}; K2 tiled, {bplan.grid} tiles a product, its weight "
                       f"gradients in {bplan.splits} split(s)")
        else:
            mapping = f"warp a unit (K2 grid {bplan.grid}, smem {bplan.smem})"
        msg = (f"widths {what}: plan {mapping}: "
               f"plain, dropout, R={WIDTHS_R} "
               f"and FWAFunction agree; max abs err K1 {worst['fwa_fwd']:.3e} K2 "
               f"{worst['fwa_bwd']:.3e} (so far)")
        if (B, S, d, h) in WIDTHS_TIMED["fwa_fwd"]:
            _repeat_equal(lambda: (cuda_fwa.fwa_forward(*fargs),), what)
            _repeat_equal(lambda: cuda_fwa.fwa_backward(*fargs, g), what + " K2")
            msg += (f"; {WIDTHS_REPEATS + 1} calls of each equal; K1 "
                    + _widths_time(rows["fwa_fwd"], "fwa_fwd",
                                   lambda: cuda_fwa.fwa_forward(*fargs),
                                   lambda: feature_wise_attention_reference(*fargs),
                                   fwa_bound(B, S, d, h), "fwa_fwd_wide")
                    + "; K2 "
                    + _widths_time(rows["fwa_bwd"], "fwa_bwd",
                                   lambda: cuda_fwa.fwa_backward(*fargs, g),
                                   lambda: fwa_backward_reference(*fargs, g),
                                   fwa_bwd_bound(B, S, d, h), "fwa_bwd_wide"))
        log(msg)
    if variants != {True, False}:
        raise AssertionError(f"widths: the FWA shapes ran the variants {variants}")
    return {k: _summed(rows[k], worst[k]) for k in rows}


# what K3's wide variant must have run at WIDTHS_MHA (`_wide_features`)
WIDE_FEATURES = ("several key chunks", "several feature chunks", "a float at a time",
                 "64 x 128 tiles", "32 x 64 tiles", "query blocks of 32", "query blocks of 16",
                 "query blocks of 1")


def _wide_features(plan, Tk: int, d: int, h: int) -> set:
    """The paths of K3's wide variant that `plan` takes (WIDE_FEATURES)."""
    dh = d // h
    return {name for name, on in (
        ("several key chunks", Tk > plan.kc), ("several feature chunks", dh > plan.fc),
        ("a float at a time", d % 4 or dh % 4), ("64 x 128 tiles", plan.big),
        ("32 x 64 tiles", not plan.big), (f"query blocks of {plan.qb}", True)) if on}


def _wide_plan_line(plan) -> str:
    return (f"wide, {plan.passes} pass(es) of {plan.pass_reps} x {plan.pass_rows} rows; "
            f"projections {plan.proj_grid} CTAs of "
            f"{'64 x 128' if plan.big else '32 x 64'} tiles; attention {plan.grid} CTAs of "
            f"{plan.qb} query rows of a head, {plan.kc} keys and {plan.fc} features staged, "
            f"smem {plan.smem}")


def _wide_passes(B: int, Tq: int, Tk: int, d: int, h: int, seed: int) -> str:
    """K3's wide variant in several passes, with the scratch's cap cut so
    that a pass holds 3 batch rows of one replica, then 1 row of one of
    R = WIDTHS_R replicas: bit for bit the outputs of one pass (a row's
    arithmetic does not depend on its pass)."""
    q, k, ql, kl, w = _widths_mha_inputs(B, Tq, Tk, True, seed, d)
    args = (q, k, ql, kl, h, *(w[n] for n in cuda_mha.WEIGHTS))
    rq, rk, rql, rkl, rws = _replica_mha_inputs(WIDTHS_R, B, Tq, Tk, True, seed + 1, d)
    fan = math.sqrt(64.0 / d)
    rargs = (rq, rk, rql, rkl, h,
             *(t * fan if n.startswith("w") else t for n, t in zip(cuda_mha.WEIGHTS, rws)))
    one, rep = cuda_mha.mha_forward(*args), cuda_mha.mha_forward(*rargs)
    cap, per_row = cuda_mha.WIDE_SCRATCH_FLOATS, (Tq + 2 * Tk) * d
    out = []
    try:
        for floats, fn, want, R in ((3 * per_row, args, one, 1), (per_row, rargs, rep, WIDTHS_R)):
            cuda_mha.WIDE_SCRATCH_FLOATS = floats
            cuda_mha.launch_plan.cache_clear()
            plan = cuda_mha.launch_plan(R * B, Tq, Tk, d, h, True, R)
            if plan.passes < 2:
                raise AssertionError(f"K3 wide passes: {plan} runs one pass")
            if not torch.equal(cuda_mha.mha_forward(*fn), want):
                raise AssertionError(f"K3 wide at B={B} ({Tq}, {Tk}) D={d} H={h} R={R}: "
                                     f"{plan.passes} passes differ from one")
            out.append(f"R={R}: {plan.passes} passes of {plan.pass_reps} x {plan.pass_rows} rows")
    finally:
        cuda_mha.WIDE_SCRATCH_FLOATS = cap
        cuda_mha.launch_plan.cache_clear()
    return ", ".join(out)


def phase_widths_mha() -> tuple:
    """K3 and K3b at WIDTHS_MHA, self- and cross-attention, as
    phase_widths_fwa holds K1 and K2; MHAFunction against autograd.  K3
    must have run every path of its wide variant (WIDE_FEATURES), and in
    several passes bit for bit as in one (`_wide_passes`).  Returns the
    two kernels' rows of the wide variant."""
    rows = {"mha_fwd": {}, "mha_bwd": {}}
    worst = {"mha_fwd": 0.0, "mha_bwd": 0.0}
    placed = set()
    for i, (B, Tq, Tk, d, h) in enumerate(WIDTHS_MHA):
        for self_attention in ([True, False] if Tq == Tk else [False]):
            plan = cuda_mha.launch_plan(B, Tq, Tk, d, h, self_attention)
            bplan = cuda_mha.backward_plan(B, Tq, Tk, d, h, 1, self_attention)
            if plan.wide:
                placed |= _wide_features(plan, Tk, d, h)
            q, k, ql, kl, w = _widths_mha_inputs(B, Tq, Tk, self_attention, SEED + 600 + i, d)
            args = (q, k, ql, kl, h, *(w[n] for n in cuda_mha.WEIGHTS))
            g = torch.from_numpy(np.random.default_rng(SEED + 700 + i).normal(
                size=(B, Tq, d)).astype(np.float32)).cuda()
            what = (f"mha_fwd B={B} Tq={Tq} Tk={Tk} D={d} H={h} "
                    f"{'self' if self_attention else 'cross'}")
            bwd = what.replace("mha_fwd", "mha_bwd")
            gen = torch.Generator(device="cuda").manual_seed(SEED + 800 + i)
            for mask in (None, torch.rand((B, h, Tq, Tk), generator=gen, device="cuda")
                         < 1.0 - DROPOUT):
                drop = () if mask is None else (mask, 1.0 - DROPOUT)
                rate = 0.0 if mask is None else DROPOUT
                tag = "" if mask is None else f" dropout {DROPOUT}"
                got = cuda_mha.mha_forward(*args, *drop)
                want, _ = multihead_attention_reference(q, ql, k, kl, h, w, rate,
                                                        keep_mask=mask)
                torch.cuda.synchronize()
                if not torch.equal(got, cuda_mha.mha_forward(*args, *drop)):
                    raise AssertionError(f"{what}{tag}: two calls differ")
                err, bar = float((got - want).abs().max()), _wide_tol(d // h, d, want)
                if not bool(torch.isfinite(got).all()) or not err <= bar:
                    raise AssertionError(f"{what}{tag}: max abs err {err:.3e} above {bar:.3e}")
                worst["mha_fwd"] = max(worst["mha_fwd"], err)
                got_b = cuda_mha.mha_backward(*args, g, *drop)
                if not _same(got_b, cuda_mha.mha_backward(*args, g, *drop)):
                    raise AssertionError(f"{bwd}{tag}: two calls differ")
                worst["mha_bwd"] = max(worst["mha_bwd"], _mha_grad_err(
                    got_b, multihead_attention_backward_reference(q, ql, k, kl, h, w, g, rate,
                                                                  mask),
                    _mha_scale(q, ql, k, kl, h, w, g, False, rate, mask), bwd + tag))
            worst["mha_bwd"] = max(worst["mha_bwd"], _mha_function_err(
                q, k, ql, kl, h, w, g, self_attention, what))
            # the replica axis
            rq, rk, rql, rkl, rws = _replica_mha_inputs(WIDTHS_R, B, Tq, Tk, self_attention,
                                                        SEED + 900 + i, d)
            fan = math.sqrt(64.0 / d)
            rws = [t * fan if n.startswith("w") else t for n, t in zip(cuda_mha.WEIGHTS, rws)]
            rargs = (rq, rk, rql, rkl, h, *rws)
            rg = torch.from_numpy(np.random.default_rng(SEED + 950 + i).normal(
                size=(WIDTHS_R, B, Tq, d)).astype(np.float32)).cuda()
            rep, rep_b = cuda_mha.mha_forward(*rargs), cuda_mha.mha_backward(*rargs, rg)
            for r in range(WIDTHS_R):
                one = _slice(rargs, r)
                single = cuda_mha.mha_forward(*one)
                same_cs = (cuda_mha.launch_plan(WIDTHS_R * B, Tq, Tk, d, h, self_attention).cs
                           == cuda_mha.launch_plan(B, Tq, Tk, d, h, self_attention).cs)
                if same_cs and not torch.equal(rep[r], single):
                    raise AssertionError(f"{what} R={WIDTHS_R}: replica {r} differs")
                if not float((rep[r] - single).abs().max()) <= _wide_tol(d // h, d, single):
                    raise AssertionError(f"{what} R={WIDTHS_R}: replica {r} off its launch")
                if not _same([t[r] for t in rep_b], cuda_mha.mha_backward(*one, rg[r])):
                    raise AssertionError(f"{bwd} R={WIDTHS_R}: replica {r} differs")
            msg = (f"widths {what}: K3 "
                   f"{_wide_plan_line(plan) if plan.wide else f'row-split cluster {plan.cs}'}; K3b "
                   f"{_bwd_plan_line(B, Tq, Tk, d, h, self_attention)}: plain, dropout, "
                   f"R={WIDTHS_R} and MHAFunction agree; max abs err K3 "
                   f"{worst['mha_fwd']:.3e} K3b {worst['mha_bwd']:.3e} (so far)")
            main_path = self_attention == (Tq == Tk)
            if (B, Tq, Tk, d, h) in WIDTHS_TIMED["mha_fwd"] and main_path:
                _repeat_equal(lambda: (cuda_mha.mha_forward(*args),), what)
                msg += (f"; {WIDTHS_REPEATS + 1} calls of K3 equal; K3 "
                        + _widths_time(rows["mha_fwd"], "mha_fwd",
                                       lambda: cuda_mha.mha_forward(*args),
                                       lambda: multihead_attention_reference(q, ql, k, kl, h, w),
                                       mha_bound(B, Tq, Tk, self_attention, d),
                                       "mha_fwd_wide")
                        + " (device ms by kernel: "
                        + _device_split(lambda: cuda_mha.mha_forward(*args), "mha_fwd_wide")
                        + ")")
            if (B, Tq, Tk, d, h) in WIDTHS_TIMED["mha_bwd"] and main_path:
                _repeat_equal(lambda: cuda_mha.mha_backward(*args, g), bwd)
                msg += (f"; {WIDTHS_REPEATS + 1} calls of K3b equal; K3b "
                        + _widths_time(rows["mha_bwd"], "mha_bwd",
                                       lambda: cuda_mha.mha_backward(*args, g),
                                       lambda: multihead_attention_backward_reference(
                                           q, ql, k, kl, h, w, g),
                                       mha_bwd_bound(B, Tq, Tk, self_attention, d),
                                       "mha_bwd_kernel"))
            log(msg)
    missing = set(WIDE_FEATURES) - placed
    if missing:
        raise AssertionError(f"widths: K3's wide variant never ran with {sorted(missing)}")
    log(f"widths: K3's wide variant in passes: {_wide_passes(32, 96, 96, 512, 8, SEED + 990)}")
    return {k: _summed(rows[k], worst[k]) for k in rows}


# the configurations of the widths phase, at the Electronics catalog:
# (family, ModelConfig fields over the reference's)
WIDTHS_CONFIGS = [("atrank", dict(num_heads=1)),
                  ("atrank", dict(itemid_embedding_size=128, cateid_embedding_size=128,
                         hidden_units=256, num_heads=8)),
                  ("atrank", dict(itemid_embedding_size=256, cateid_embedding_size=256,
                         hidden_units=512, num_heads=8)),
                  ("tlsan", dict(num_heads=1)),
                  ("tlsan", dict(itemid_embedding_size=64, cateid_embedding_size=64,
                                 userid_embedding_size=64, hidden_units=128,
                                 num_heads=1)),
                  ("atrank", dict(itemid_embedding_size=512, cateid_embedding_size=512,
                                  hidden_units=1024, num_heads=8)),
                  ("tlsan", dict(itemid_embedding_size=512, cateid_embedding_size=512,
                                 userid_embedding_size=512, hidden_units=1024,
                                 num_heads=1))]
# the configurations whose chunk is profiled, by (family, hidden_units):
# K3's and K3b's device share (ATRank in one head and at D = 512), K1's and
# K2's (TLSAN)
WIDTHS_PROFILED = (("atrank", 64), ("atrank", 512), ("tlsan", 1024))
# the kernels whose device share a profiled chunk logs: (name, substring of
# their device functions' names)
WIDTHS_SHARES = {"atrank": (("K3", "mha_fwd"), ("K3b", "mha_bwd_kernel")),
                 "tlsan": (("K1", "fwa_fwd"), ("K2", "fwa_bwd"))}
WIDTHS_PARITY_LR = {"tlsan": 0.1, "atrank": 0.01}  # the ReLU-kink rule (ROADMAP §3)
# From it on, ATRank's 20 steps at WIDTHS_PARITY_LR are held against the
# card's own plain backward, a step's gradients at a time (`_card_plain_
# parity`), and the CPU check runs at a tenth of the rate besides: at D =
# 1024, 20 steps at lr 0.01 on an H100 part from the CPU by 1.2e-3 with K3b
# and with the plain backward alike (sums in another order, grown through
# ReLU kink flips over the steps)
WIDTHS_KINK_D = 1024


def _widths_parity_lr(name: str, cfg) -> float:
    """The rate of a configuration's 20-step check against the CPU."""
    lr = WIDTHS_PARITY_LR[name]
    return lr / 10 if name == "atrank" and cfg.hidden_units >= WIDTHS_KINK_D else lr
WIDTHS_CPU_CHECK_USERS = 512


def _plain_mha_backward(queries, keys, q_len, k_len, num_heads, *rest):
    """`cuda_mha.mha_backward`'s function by its plain version
    (multihead_attention_backward_reference) on the same tensors: what
    MHAFunction's backward runs on the card in place of K3b."""
    n = len(cuda_mha.WEIGHTS)
    w, g, drop = rest[:n], rest[n], rest[n + 1:]
    mask, keep = drop if drop else (None, 1.0)
    return multihead_attention_backward_reference(
        queries, q_len, keys, k_len, num_heads, dict(zip(cuda_mha.WEIGHTS, w)), g,
        0.0 if mask is None else 1.0 - keep, mask)


def _card_plain_parity(tmp: str, fam: Family, cfg, tc, data, idx, tag: str) -> float:
    """The steps of the index chunk `idx` (a device tensor) by a Trainer of
    `tc` on the card: at each, from the same parameters, the gradients of
    the batch's loss with K3b and with its plain version on the card
    (`_plain_mha_backward`) agree within PARITY_TOL, then the step is taken
    with K3b.  Both gradients are taken at one point, so no drift between
    two runs (ReLU kinks crossed in one and not the other) enters.  Returns
    the largest difference."""
    tr = Trainer(fam.model, cfg, dataclasses.replace(
        tc, model_dir=os.path.join(tmp, "card_plain")), *data, device="cuda")
    xs = {k: v[idx] for k, v in tr.train_data.items()}
    worst = 0.0
    for s in range(idx.shape[0]):
        batch = {k: v[s] for k, v in xs.items()}
        grads = []
        for backward in (cuda_mha.mha_backward, _plain_mha_backward):
            kept, cuda_mha.mha_backward = cuda_mha.mha_backward, backward
            try:
                for p in tr.params:
                    p.grad = None
                tr._forward("loss", batch, tr._masks).backward()
            finally:
                cuda_mha.mha_backward = kept
            grads.append([None if p.grad is None else p.grad.detach().to_dense().clone()
                          for p in tr.params])
        for i, (got, want) in enumerate(zip(*grads)):
            if got is None or want is None:
                if got is not want:
                    raise AssertionError(f"{tag}: step {s}: gradient {i} is missing once")
                continue
            diff = float((got - want).abs().max())
            worst = max(worst, diff)
            if not torch.allclose(got, want, rtol=PARITY_TOL, atol=PARITY_TOL):
                raise AssertionError(f"{tag}: step {s}: gradient {i} differs from the "
                                     f"plain backward's by {diff:.3e}")
        tr._train_chunk(idx[s:s + 1])
    tr.close()
    return worst


def _attention_share(trace: str, name: str) -> str:
    """The device time of a Trainer.profile_trace chunk (its Chrome trace's
    kernel events) and the shares of family `name`'s attention kernels
    (WIDTHS_SHARES) in it."""
    with open(trace) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel" and "dur" in e]
    if not events:
        raise AssertionError(f"{trace}: no device kernel in the trace")
    total = sum(e["dur"] for e in events)
    parts = [(k, sum(e["dur"] for e in events if sub in e["name"]))
             for k, sub in WIDTHS_SHARES[name]]
    return (f"{len(events)} kernels, {total / 1e3:.3f} ms on the device; "
            + ", ".join(f"{k} {us / 1e3:.3f} ms ({us / total:.3f})" for k, us in parts))


def phase_widths_models(card: str) -> list:
    """The WIDTHS_CONFIGS on the card at the Electronics catalog, from
    the seed: Trainer takes a warm-up step and one chunk of STEPS_PER_CALL
    steps of batch 32 on the train phase's planted rows (examples/s of the
    chunk; finite losses; launches exact: no plain version runs on the
    card), the model is saved and served by
    Recommender.from_model_dir to BULK_USERS featurized users in bulk
    (launches exact; the first WIDTHS_CPU_CHECK_USERS as the CPU serves
    the same save), and PARITY_STEPS steps from the same start agree with
    the CPU plain path within PARITY_TOL at `_widths_parity_lr`; ATRank
    from WIDTHS_KINK_D on also takes them at WIDTHS_PARITY_LR against the
    card's plain backward (`_card_plain_parity`).  Returns the launches of
    each configuration's path."""
    runs = []
    for name, over in WIDTHS_CONFIGS:
        fam = TLSAN_FAMILY if name == "tlsan" else ATRANK_FAMILY
        cfg = dataclasses.replace(fam.cfg, **over)
        tag = f"widths {name} {over}"
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            train, test, cate_list = fam.train_data(np.random.default_rng(SEED + 1), USERS,
                                                    ITEMS, fam.train_rows, fam.test_users)
            tc = TrainConfig(model_dir=os.path.join(tmp, "train"), max_epochs=1,
                             steps_per_call=STEPS_PER_CALL, best_after_step=0,
                             save_auc_gate=0.0, seed=SEED, tb_histograms=False)
            reset_launches()  # the configuration's path starts here
            trainer = Trainer(fam.model, cfg, tc, cate_list, train, test, device="cuda")
            idx = torch.from_numpy(trainer._epoch_index(0)[0]).cuda()
            trainer._train_chunk(idx[:1])  # a warm-up step
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            losses = trainer._train_chunk(idx)
            torch.cuda.synchronize()
            rate = STEPS_PER_CALL * TRAIN_B / (time.perf_counter() - t1)
            losses = losses.cpu()
            n = expect_launches(_plus(), _times(fam.per_step, 1 + STEPS_PER_CALL),
                                f"{tag}: a chunk")
            if not bool(torch.isfinite(losses).all()):
                raise AssertionError(f"{tag}: non-finite losses {losses}")
            profiled, laps = "", {"train": time.perf_counter() - t0}
            if (name, cfg.hidden_units) in WIDTHS_PROFILED:
                trainer.profile_trace(1, out_dir=os.path.join(tmp, "profile"))
                n = expect_launches(n, _times(fam.per_step, STEPS_PER_CALL),
                                    f"{tag}: the profiled chunk")
                profiled = "; profiled chunk: " + _attention_share(
                    os.path.join(tmp, "profile", "trace.json"), name)
                laps["profile"] = time.perf_counter() - t0 - sum(laps.values())
            checkpoint.save(tmp, name, STEPS_PER_CALL, trainer.model, None, cfg, best=True)
            trainer.close()
            bulk = featurize_many(name, cfg, fam.requests(np.random.default_rng(SEED),
                                                          BULK_USERS), cate_list=cate_list)
            rec = Recommender.from_model_dir(tmp, cate_list, device="cuda",
                                             batch_size=BATCH, k=K)
            ids, scores = rec.recommend(bulk)
            n = expect_launches(n, _times(fam.per_batch, -(-BULK_USERS // BATCH)),
                                f"{tag}: bulk recommend")
            runs.append(n)
            if ids.shape != (BULK_USERS, K) or not np.isfinite(scores).all():
                raise AssertionError(f"{tag}: bulk shape {ids.shape} or non-finite scores")
            m = WIDTHS_CPU_CHECK_USERS
            cpu_rec = Recommender.from_model_dir(tmp, cate_list, device="cpu",
                                                 batch_size=BATCH, k=K)
            want_ids, want_scores = cpu_rec.recommend({k: v[:m] for k, v in bulk.items()})
            assert_topk_match(want_ids, want_scores, ids[:m], scores[:m], SCORE_TOL)
            laps["serve"] = time.perf_counter() - t0 - sum(laps.values())
            # PARITY_STEPS steps on the card and on the CPU from one start
            worst = _cpu_parity(tmp, fam, cfg, dataclasses.replace(
                tc, learning_rate=_widths_parity_lr(name, cfg)), (cate_list, train, test),
                idx[:PARITY_STEPS].cpu(), f"{tag}: parity")
            card_plain = ""
            if name == "atrank" and cfg.hidden_units >= WIDTHS_KINK_D:
                lr = WIDTHS_PARITY_LR[name]
                diff = _card_plain_parity(tmp, fam, cfg, dataclasses.replace(
                    tc, learning_rate=lr), (cate_list, train, test), idx[:PARITY_STEPS],
                    f"{tag}: against the card's plain backward")
                card_plain = (f"; {PARITY_STEPS} steps at lr {lr}, each step's gradients "
                              f"within {diff:.3e} of the card's plain backward's")
        d, h = cfg.hidden_units, cfg.num_heads
        plans = (f"K1 {cuda_fwa.launch_plan(TRAIN_B, LS, d, h)}" if name == "tlsan" else
                 f"K3 {cuda_mha.launch_plan(TRAIN_B, T_ATRANK, T_ATRANK, d, h, True)}")
        log(f"{tag} ({card}): {STEPS_PER_CALL} steps at {rate:.1f} train examples/s "
            f"(host clock, one chunk after a warm-up step), losses "
            f"{float(losses[:10].mean()):.6f} → {float(losses[-10:].mean()):.6f} (means of "
            f"the first and last 10); {BULK_USERS} users served, the first {m} as the CPU "
            f"serves them; {PARITY_STEPS} steps at lr {_widths_parity_lr(name, cfg)} within "
            f"{worst:.3e} of the CPU{card_plain}; launches {n}; in "
            f"{time.perf_counter() - t0:.1f} s ("
            + ", ".join(f"{k} {v:.1f}" for k, v in laps.items())
            + f", parity {time.perf_counter() - t0 - sum(laps.values()):.1f}); "
            f"{plans}{profiled}")
    return runs


def phase_widths_cli(tmp: str, card: str) -> dict:
    """`train.cli --model atrank --num_heads 1` for one epoch at batch 128
    (a quarter of batch 32's steps, as the cli phase's dropout run) on the
    cli phase's Digital-Music category file, K3 and K3b counted exactly
    (the wide variants: heads of 64 features)."""
    os.environ["TLSAN_DATA_CACHE"] = os.path.join(tmp, "cache")
    try:
        t0 = time.perf_counter()
        head, evals, _, launches = _cli_train(
            os.path.join(tmp, "Data"), os.path.join(tmp, "atrank_heads_1"), "Digital_Music",
            ATRANK_FAMILY, ["--num_heads", "1", "--train_batch_size", "128"])
    finally:
        del os.environ["TLSAN_DATA_CACHE"]
    log(f"widths cli train atrank --num_heads 1 Digital_Music ({card}): {head['train']} "
        f"rows, {evals[-1]['step']} steps in {time.perf_counter() - t0:.3f} s; AUC "
        f"{[round(r['auc'], 6) for r in evals]}; launches {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    kernels = {"fwa_fwd": phase_kernel(), "fwa_bwd": phase_kernel_bwd()}
    kernels["mha_fwd"], kernels["mha_bwd"] = phase_kernel_mha()
    phase_fwa_scale()
    dropout_rows = phase_dropout()
    t0 = time.perf_counter()
    widths_rows = {**phase_widths_fwa(), **phase_widths_mha()}
    log(f"widths: the wide variants in {time.perf_counter() - t0:.1f} s")
    local = phase_kernel_local()
    runs, meshed, numbers = [], [], {}
    for fam in (TLSAN_FAMILY, ATRANK_FAMILY, *BASELINES):
        t0 = time.perf_counter()
        for phase in (phase_path, phase_train):
            with tempfile.TemporaryDirectory() as tmp:
                out = phase(tmp, fam)
            runs.append(out.pop("launches"))
            numbers.setdefault(fam.name, {}).update(out)
        log(f"{fam.name}: path and train in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    widths_runs = phase_widths_models(card)
    log(f"widths: the {len(WIDTHS_CONFIGS)} configurations in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        runs.extend(phase_ext(tmp, card))
        log(f"ext: in {time.perf_counter() - t0:.1f} s")
    backend, device = mesh_setup()
    with tempfile.TemporaryDirectory() as tmp:
        meshed += [out["launches"] for out in phase_mesh(
            tmp, (TLSAN_FAMILY, ATRANK_FAMILY), BASELINES, backend, device)]
    with tempfile.TemporaryDirectory() as tmp:
        dropout_runs = phase_dropout_paths(tmp, card, backend, device)
    with tempfile.TemporaryDirectory() as tmp:
        runs.append(phase_migrate(tmp, card))
    with tempfile.TemporaryDirectory() as tmp:
        runs.extend(phase_cli(tmp, card))
        # the widths phase's command line reads the cli phase's Digital-Music file
        widths_runs.append(phase_widths_cli(tmp, card))
        # the fan-out's command line reads the cli phase's Digital-Music file
        replica_rows, fanout_paths, fanout = phase_fanout(tmp, card)
    t0 = time.perf_counter()
    phase_bench(card)
    log(f"bench: in {time.perf_counter() - t0:.1f} s")
    for name, n in numbers.items():
        log(f"family {name} ({card}): train {n['examples_per_s']:.1f} examples/s, "
            f"eval {n['eval_users_per_s']:.1f} users/s, bulk {n['users_per_s']:.1f} "
            f"users/s, HTTP p50 {n['http_p50_ms']:.3f} ms p99 {n['http_p99_ms']:.3f} ms, "
            f"idle share {n['train_idle_share']:.3f} (train chunk) "
            f"{n['serve_idle_share']:.3f} (bulk recommend)")
    for name, n in fanout.items():
        rates = n["rates"]
        log(f"fanout {name} ({card}): Trainer {rates['trainer']:.1f} examples/s; "
            f"R=1 {rates['R=1']:.1f}, R={FANOUT_R} {rates[f'R={FANOUT_R}']:.1f} "
            f"replica-examples/s; idle share {n['idle_share']:.3f} (R={FANOUT_R} chunk)")
    # launches summed over the one-device paths (the baselines' are 0, as
    # their phases check); K1's times are at the
    # serving shapes (B=128), K2's at the training shapes (B=32), K3's at
    # the serving shapes (B=128), each per batch (both towers, or the
    # self-attention and the readout).  K4's launches are every rank's on
    # the two mesh paths, its times per rank at B=64.  The replica fields
    # are the fanout phase's: times at R = 8 on the train-step shapes
    # (B=32), summed over the step's two launches, and the launches of the
    # fan-out paths (K4: none, the fan-out runs on one device)
    launches, mesh_launches = _plus(*runs, *widths_runs), _plus(*meshed)
    # the widths fields: the wide variants at two grid shapes each
    # (WIDTHS_TIMED, summed), their worst error over WIDTHS_FWA and
    # WIDTHS_MHA, and the launches of the widths phase's paths
    wide_launches = _plus(*widths_runs)
    no_wide = dict.fromkeys(("wide_shapes", "wide_ms", "wide_plain_ms", "wide_bound_ms",
                             "wide_bound_by", "wide_max_abs_err"))
    fanout_launches = _plus(*fanout_paths)
    no_replicas = dict.fromkeys(next(iter(replica_rows.values())))
    # the dropout fields: the masked kernels at the train step's shapes (per
    # step: both towers, or the self-attention and the readout), and the
    # launches of the dropout paths (Trainer, mesh leg, fan-out)
    dropout_launches = _plus(*dropout_runs)
    no_dropout = dict.fromkeys(next(iter(dropout_rows.values())))

    def row(meta, k, n, replica):
        return dict({key: v for key, v in meta.items() if key != "kernels"},
                    launches=n, max_abs_err=k["max_abs_err"], ms=k["ms"],
                    plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
                    bound_by=k["bound_by"], library_ms=None, **replica)

    def wide(name):
        w = widths_rows[name]
        return {"wide_shapes": [list(t) for t in WIDTHS_TIMED[name]], "wide_ms": w["ms"],
                "wide_plain_ms": w["plain_ms"], "wide_bound_ms": w["bound_ms"],
                "wide_bound_by": w["bound_by"], "wide_max_abs_err": w["max_abs_err"],
                "wide_launches": wide_launches[name]}

    line = [row(meta, kernels[meta["name"]], launches[meta["name"]],
                dict(replica_rows[meta["name"]],
                     replica_launches=fanout_launches[meta["name"]],
                     **dropout_rows[meta["name"]],
                     dropout_launches=dropout_launches[meta["name"]], **wide(meta["name"])))
            for meta in KERNELS]
    line += [row(meta, local[meta["name"]],
                 sum(mesh_launches[k] for k in meta["kernels"]),
                 dict(no_replicas, replica_launches=0, **no_dropout,
                      dropout_launches=0, **no_wide, wide_launches=0)) for meta in K4]
    log(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
