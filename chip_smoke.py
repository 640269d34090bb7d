#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (`amid_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, `nvcc` and `nvidia-smi`; imports nothing of JAX or the
JAX package. Phases, in order (any failure ends the run with a non-zero exit
code and no result line):

1. the card's name and power limit; build every CUDA kernel of the serving
   and training paths from `amid_tpu_torch/csrc/` (eight sources, the
   attention paths' four native bf16 sources (one-head pair and long
   paths) and the fp32 long paths' builds for padded head widths, one
   `nvcc` each, all started together), timing the build;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the main paths' shapes, with its time beside the plain version's, one
   PyTorch library call's (a yardstick the port never calls) and the card's
   bound for the same work. Kernel and library call are each timed three
   ways: `kernel_ms` / `library_ms`, back-to-back public calls between CUDA
   events (at a launch-sized shape this reads the host's cost per call);
   `device_ms` / `library_device_ms`, the mean over the replay of a CUDA
   graph of 20 captured calls (the device alone); `host_us` /
   `library_host_us`, wall time per un-synced call (the host alone). The
   host-dependent two are the least of three rounds. Attention forward: causal bias with 8 heads at
   T=150 and T=20, at rate 0 and at training's rate 0.5 (all timed); a
   key-padding bias with 4 heads of width 32 and a fully masked row; the
   row statistics the forward writes under autograd against the plain
   version's; the dropout mask read out and compared element for element
   (library: `scaled_dot_product_attention`, with the same dropout rate).
   BERT4Rec's key-padding shapes at T=300 and T=600 (4 heads of 32), and
   T=600 at training's rate 0.1 (library: SDPA at `dropout_p=0.1`). The
   long forward (`csrc/attention_fwd_long.cu`) against its plain version
   in key tiles (`attention_fwd_stats_streamed_plain`), out and row
   statistics, two calls bit-equal: key padding with a fully masked row at
   dh=32, T=1,200 and T=600, rates 0 and 0.1; causal at dh=16, T=1,600;
   dh=64 at T=600; then both forward paths' `device_ms` at B=256, rate 0,
   key padding and causal, T=150 to 800 at dh 32 and 16 (`fwd_crossover`
   records: the numbers behind `forward_route`'s table of crossovers; the
   sweep is `fwd_crossover_sweep`, run by `tools/route_sweeps.py`).
   Attention backward: dq, dk, dv at the same cases from the plain
   forward's residuals (out, row max, 1 / row sum), the fully masked row
   included, each computed twice and required bit-equal (library: the
   backward of `scaled_dot_product_attention` through autograd); the
   long-sequence path at BERT4Rec's B=256, h=4, dh=32, T=600 with a fully
   masked row, at rate 0 and 0.1, and at T=1,200 fed the long forward's
   row statistics; both paths, timed in full, at T=300
   (dh=32) and T=150 (dh=16); then both paths' `device_ms` at T=150, 200,
   256, 300, 368 and 512 for head widths 32, 16, 64 and 8, wherever the
   one-sweep kernel holds the shape, and with SASRec's causal bias at dh=16
   from T=150 to 600, where C2DSR's views put its encoder (`bwd_crossover`
   records: the numbers behind `backward_route`'s table of crossovers, which
   sends a shape to the long path where it was the faster or where the
   one-sweep kernel cannot hold it); at T=150, and over four more draws at
   dh=64, both paths and the plain fp32 version against the plain version in
   fp64 (`BWD_ATOL_DH64`). The two
   attention bounds take the TF32 tensor-core peak (the kernels' products
   are 3xTF32). Unique-row scatters, fused (three arrays) and single: V=894,820,
   D=128, U=11,264 and 77,824 with a sentinel tail and rows 0 and V-1, bit
   for bit, untouched rows unchanged (library: `index_copy_` on pre-filtered
   ids). Embedding gather from the 894,820-row table:
   one lookup per launch at [256, 999], [256, 150] and [256, 20] ids, and the
   model's groups, one launch each: both sequences of a feature pass (2 x
   [256, 150], 2 x [256, 20]) and target with negatives straight into one
   [256, 1+K, 128] block (K = 999 and 1); bit for bit, with clamped
   out-of-range ids and the gradient of a group (library: `index_select` on
   the concatenated ids). The gather's backward (`embedding_gather_grad`)
   at a training step's shapes, left-padded T=150 and T=20 histories and
   target with a negative into the 894,820-row table, and the lazy step's
   two shapes into its 11,264-row leaf, against the plain version in fp64
   (no further than `index_add_` in fp32, GRAD_SLACK), two calls bit-equal
   and bit-equal to `embedding_gather_grad_ordered` (library:
   `index_put_(accumulate=True)`, and `index_add_` beside it; each kernel
   of a call timed apart from a `torch.profiler` trace). Scoring head at C=1000 and C=2, one user
   representation a launch and both in one launch (`scoring_head_pair`,
   what the model calls: against two calls of the plain version, and its
   eight gradients against autograd through the plain pair; no library call
   computes it). Max-affinity, bf16 inputs: the blocked kernel at N=M=150
   (B=C=256 and B=C=64) and at N=M=20, the small-N kernel at N=M=20 (all
   timed; library: the chunked `matmul` + `amax` on bf16 inputs, several
   calls; the bound is the bf16 tensor-core peak), a doubled time axis, then
   both kernels at ragged batches, N != M, peers straddling bank tiles and
   slices and every compiled width, bit-equal to each other (the crossover
   of the dispatch, both kernels' `device_ms` at B=C=256, D=128, N=M from 8
   to 80, is `affinity_crossover_sweep`, run by `tools/route_sweeps.py`);
3. the serving path at the full width of the `run.sh` model (SASRec, InterComp
   ts2=0.4, DR heads, emb 128, hid 32, batch 256, 2 blocks, 8 heads) at the
   amazon shape T=150 with the 894,820-row item table, random weights from
   a seeded generator: `serve.user_representations` (the attention kernel
   must launch 4 times: 2 towers x 2 blocks), checked against the same model
   with kernels='torch' (InterComp gates first), then `serve.full_catalog_topk`
   with k=100 for both domains over the whole table, checked against a dense
   oracle for 8 users; then the feature pass again at T=20. Every gate check
   runs twice: at ts2=0.4, where no gate opens at random weights, and at a
   threshold chosen so that between 5% and 95% of the gates are open. Then
   the same in pairwise mode (`comp_broadcast_quirk=False`, gates [256, 256]
   from the max-affinity kernels) at T=20 and T=150, against a reference
   model whose affinity is `max_affinity_plain`; the number of gates that
   the bf16 affinity flips against the fp32 one is printed as information;
4. the training path at the same width on synthetic packed data made from a
   numpy seed (`amid_tpu_torch/data/synthetic.py`: item ids over the whole
   894,820-row table, pools of the real size; 16 batches of 256 a phase, 4
   evaluation batches): `train.loop.run_seed` for one epoch of the DR
   schedule (phase A, evaluation with 999 negatives, phase B, evaluation)
   with (a) T=20 and the lazy table Adam, (b) T=150 and dense Adam, on the
   fast loops (the default: each step kind a CUDA graph, captured after one
   eager step and replayed), counting every kernel launch on the device
   (the graphs add their captured launches at each replay), and beside it
   the per-step loop from the same seed, whose metrics are reported;
   then, step by step, one phase-A step, one phase-B step and one evaluation
   batch of a `kernels='cuda'` model against the same step of a
   `kernels='torch'` model from the same state, batch and key (4 forward and
   4 backward attention launches and 2 gather launches per step, one fused
   scatter launch per lazy
   step, three single launches with `fused_scatter=False`, first `loss_cls`
   near ln 2, no table gradient on the lazy path), and the ms per step;
   then four replayed steps of each phase and a replayed evaluation pass
   against the same steps taken eagerly from the same state, batches and
   keys (`graph_steps`); with STEP_TIMING (`tools/step_timings.py`; off
   here) then wall ms, device ms (a `torch.profiler` trace) and the device's
   idle share per step kind, eager and replayed (`step_timing`,
   `amid_tpu_torch/profile_step.py`'s functions; phases 7 and 8 likewise);
5. the pairwise-mode trainer from its CLI: `amid_tpu_torch.train_sr_dr.main`
   with `--comp_broadcast_quirk False --kernels cuda` on synthetic CSV files
   written to a temporary directory in the reference's format, (a) T=20 with
   the lazy table Adam (small-N affinity kernel), (b) T=150 with dense Adam
   (blocked affinity kernel): CSV -> packed datasets -> phase A, evaluation
   with 999 negatives, phase B, evaluation, on the fast loops (the JAX CLI's
   defaults: it checkpoints, async, and the run must leave
   `checkpoint/seed0/0.pt`) and again with `--fast_train False
   --fast_eval False`, counting every kernel launch; then the checks of
   phase 4 in pairwise mode, the step-level ones against a
   `kernels='torch'` model whose affinity is `max_affinity_plain`;
6. gate flips at trained weights: `run_seed` in pairwise mode for 3 epochs
   (fast loops) at T=20 and T=150, then the InterComp gates of the trained
   model from the kernels' bf16 affinity against those of the fp32
   affinity, counted at ts2=0.4 and at an opened threshold (information);
7. the BERT4Rec and GRU4Rec backbones: the run.sh model with `--model`
   swapped (BERT4Rec: 2 blocks of 4 heads, FFN 512, dropout 0.1, the d2-mask
   quirk; GRU4Rec: hidden width 128). Serving at T=150 (top-100 against the
   dense oracle) and T=20 against a `kernels='torch'` model, user 0's
   domain-2 history all id 0 (BERT4Rec masks every key of its rows),
   BERT4Rec in pairwise mode at T=150 (gates from K6) and BERT4Rec with
   InnerComp and InterComp at T=300 (encoder T=1,200, the long forward);
   `run_seed` for one epoch of the DR schedule on the fast loops at T=20
   (lazy Adam) and T=150 (dense), with its launches against
   `expected_launches`, then phase 4's step-level checks, replayed steps
   against eager ones and step timings; for BERT4Rec at T=150 also
   replayed steps bit-equal to eager ones on three more data draws, with
   the forward on each of its two kernels; BERT4Rec's pairwise step checks
   at T=150; BERT4Rec with InnerComp and InterComp at T=150, whose encoder
   sees T=600: one epoch of `run_seed` (its backward on the long path) and
   one phase-A step and one evaluation batch against the `kernels='torch'`
   model, then its step timings;
8. C2DSR (`--isC2DSR True`, cl_w 0.1, dense Adam): the run.sh model at
   T=150 (views at 300), pairwise SASRec at T=20 (views at 40: K7 with 4
   users a slot), BERT4Rec with InterComp at T=150 (encoder 300, views
   600 on the long paths) and GRU4Rec at T=20: one epoch
   of `run_seed` on the
   fast loops with its launches against `expected_launches` (three feature
   passes a phase-A step, the views' at their own length and backward
   route), phase 4's step-level checks against the `kernels='torch'` model
   and the step timings (and for the run.sh model replayed steps against
   eager ones); then BERT4Rec with InnerComp and InterComp at T=150, whose
   views reach T=1,200 at dh=32, beyond the one-head forward kernel, on the
   long forward and backward: one epoch of `run_seed` at B=256 with its
   launches and peak memory, the step-level checks against the
   `kernels='torch'` model at B=32 (where the plain step fits) and the step
   timings at B=256;
9. checkpoints (`train/checkpoint.py`), the profiler (`utils/profiler.py`)
   and the native CSV reader (`data/native.py`), the run.sh model at T=20
   with the lazy table Adam (a 2.29 GB state: the 894,820-row table and two
   slots of its `mu`/`nu`): each payload (full, bf16_moments, params_only)
   saved async twice and restored into the moved state (bytes on disk, the
   seconds `save()` blocks and the wait, the restore's seconds; the values
   as saved); `run_seed` with checkpoints for 1 epoch, resumed to 2, resumed
   to 3 (start epochs 1 and 2), the first run's `examples_per_s` (the
   StepTimer) beside the phase-A-only rate the port reported before it;
   the roll-back under replay: a NaN written into a DR head's weight after
   epoch 1's main evaluation, phase B's replayed steps trip the latch, the
   run rolls back to checkpoint 0 and its later losses are finite; a
   restore into the tensors captured graphs read (lazy T=20 and dense
   pairwise T=150 phase A): replays after the restore bit-equal to replays
   after the save, params_only zeroing moments and counts; `run_seed` with
   `profile_steps=3`, whose trace must name the kernels of the path; a
   27,000-row synthetic CSV packed by the native reader (the repository's
   library, or one built into `_build/`) and by the Python reader, the
   arrays equal, both times;
10. the precision flags: each bf16-operand mode (K1's native bf16 kernels,
   one-head and long, K5's bf16 flag), on 3 draws a case, against an fp64 oracle of its own rounding
   points, its plain bf16 version and (that version) an fp64 oracle of the
   JAX kernel's rounding, each within the case's limit (BF16_LIMITS), with
   the fp32 build at the same inputs outside the oracle's limit; timed
   beside the fp32 mode at the same shape (library: SDPA on bf16 q, k, v;
   bound at the bf16 peak) (the bf16 crossover sweeps, `fwd_crossover_bf16`
   and `bwd_crossover_bf16` records behind the routes' bf16 tables, are
   `bf16_crossover_sweeps`, run by `tools/route_sweeps.py`);
   `--bf16 True` on the run.sh model at T=20 (lazy, quirk) and T=150
   (dense, pairwise) and on BERT4Rec at T=150 (encoder T=300: the bf16
   one-head forward and long backward): `run_seed`
   with its launches on the bf16 kernels, an eager phase-A and phase-B step
   against the kernels='torch' bf16 model (losses, updates, moments),
   replayed steps bit-equal to eager ones, the
   feature pass against the fp32 model's and the replayed phase A beside
   fp32's; `--remat True` at T=150: a step bit-equal to the step without
   remat (8 attention forwards: the recompute), replayed remat steps
   bit-equal to eager ones, and the replayed phase A's time and peak memory
   with and without remat at batch 256 and 1,024; the owed many-step check
   (`bf16_drift`): 100 phase-A steps of `--bf16` BERT4Rec at T=150 and 50
   of `--bf16` SASRec at T=150 (the one-head pair) with
   the kernels and with the plain versions from one seed, BERT4Rec's fp32
   pair beside them, the loss gap every 10 steps and HIT/NDCG@10 of one
   evaluation, each bf16 pair's final losses within 1% of each other, and
   every 10 steps the bf16 kernels on that step's own attention inputs
   against their fp64 oracles;
11. the parallel layer (`amid_tpu_torch/parallel/`, `mesh_phase`) on a
   world of one NCCL rank (the card is one H100): K1's dropout row offset on
   every path, fp32 and bf16, forward and backward (a launch on rows [b0:]
   at `row_offset=b0` bit-equal to those rows of the whole launch, and
   within the plain version's tolerance at that offset), K2/K3 at a row
   shard's local ids (negative ones and the sentinel dropped) against their
   plain versions; `run_seed` for one epoch of the DR schedule off the mesh
   and on a 1x1 mesh at full width (gspmd T=20 lazy, gspmd T=150 pairwise,
   shard_map T=150 per step, BERT4Rec T=150 gspmd on both long K1 paths),
   metrics within 1e-5 (bit equality printed), launches against
   `expected_launches`, the gspmd runs' fast loops replaying graphs that
   captured the collectives; the replayed phase-A step off and on the mesh
   at T=20 and T=150 (wall and device ms, NCCL kernels and copies a step
   from the trace, peak memory);
12. K1 at every head width up to 128 (`width_kernel_phase`,
   `width_config_phase`): all six attention paths
   (the one-head forward and one-sweep backward, the fp32 long forward and
   backward, the native bf16 one-head and long kernels) at dh 12, 24, 48
   (padded to the template widths 16, 32, 64) and 128, causal and key
   padding, rates 0 and 0.1, B=256, against their plain versions (fp32:
   `kernel_plain`'s tolerances, the row statistics at LONG_STATS_ATOL, the
   backward at `bwd_atol`; bf16: BF16_LIMITS of the path's existing case,
   the fp32 build outside it), each timed but the rate-0.1 cases at dh 24
   and 48 (device_ms, host_us, SDPA, the bound) (both paths' device time
   at dh=128, the routes' dh=128 entries, is `width_crossover_sweeps`, run
   by `tools/route_sweeps.py`); then
   configuration (a), BERT4Rec at
   `--emb_dim 512` (4 heads of 128) and `--seq_len 150` (encoder T=300: both
   long paths at dh=128), dense Adam: serving (feature pass and top-100),
   `run_seed` on the fast loops, the step-level checks against
   `kernels='torch'`, replayed steps (phase A, phase B, evaluation)
   bit-equal to eager ones and the replayed phase A's time, fp32 and
   `--bf16`; and configuration (b), the run.sh SASRec at `--emb_dim 96` (8
   heads of 12: the one-head pair at a padded width) at T=20 lazy and T=150
   dense, quirk and pairwise: the CLI for a few steps with `--kernels auto`,
   the step-level checks and replayed steps bit-equal to eager ones;
13. the widths the JAX kernels take beyond those (`wide_kernel_phase`,
   `wide_config_phase`): K1's fp32 long forward and backward at head width
   256 (B=256, 4 heads, T=300, key padding and causal, rates 0 and 0.1)
   against their plain versions at dh=128's tolerances (the backward also
   against fp64), and its bf16 long pair at the same inputs against its
   plain versions and fp64 oracles (BF16_LIMITS), K6/K7 at D 20, 136 and
   1,024 and N=M 20 and 150 and K6 at N=700 (several blocks a user), K5's
   column-chunked kernel at D=1,024 and its wide kernel at (D, H) of
   (1,024, 64) in both modes, (2,048, 32) and (1,026, 32), each timed with
   its bound, the plain version's and the library call's time; then
   configuration (c), BERT4Rec at `--emb_dim 1024` (4 heads of 256) and
   `--seq_len 150` with InterComp in pairwise mode: serving (the feature
   pass against `kernels='torch'`, top-100), `run_seed` on the fast loops
   at T=150 dense and T=20 lazy with their launches (the long K1 pair at
   dh=256, K6 and K7 at D=1,024), the step-level checks against
   `kernels='torch'` and the replayed phase A's time and peak memory;
   configuration (d), (c) under `--bf16` with `--hid_dim 64` at T=150
   dense (the bf16 long K1 pair at dh=256, K5's wide kernel): serving,
   `run_seed` with its launches, the step check against `kernels='torch'`
   and replayed steps bit-equal to eager ones (its replayed phase A's time
   with STEP_TIMING, `tools/step_timings.py wide_config`); and configuration
   (a) in pairwise mode (`--emb_dim 512 --comp_broadcast_quirk False`):
   replayed phase-A steps through K6 at D=512.

It prints a JSON line of per-kernel numbers, the total wall time, the
`nvidia-smi` name and power line, and last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet) for the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # without tensor cores
TF32_TENSOR_FLOPS = 495e12  # dense TF32 on the tensor cores (the attention kernels' 3xTF32)
BF16_TENSOR_FLOPS = 989e12  # dense bf16 on the tensor cores

ATOL, RTOL = 1e-5, 1e-4  # forward kernel vs plain, fp32
# backward: dk and dv of a key sum one term a query; in a row with few kept
# keys each term carries the cancellation of dP - D (3xTF32 products against
# an fp32 row sum), so the error grows with the queries summed: 2e-5 up to
# T=150, BWD_ATOL * T / 150 beyond (bwd_atol). At dh=64 the start is
# BWD_ATOL_DH64, from five draws at B=256, T=150, key padding, held against
# the plain version in fp64 (NVIDIA H100 80GB HBM3): both paths' errors
# against fp64 are those of dh=8 and 32 (dv 2.6e-5 to 4.3e-5: 3xTF32
# products; the plain fp32 version's 0.5e-5 to 1.3e-5), but the largest
# |kernel - plain| - RTOL |plain| reached 2.3e-5; twice that, rounded up.
# It holds every head width above 32 (templates 64 and 128): at dh=128
# (B=256, T=64 and 300, causal, rates 0 and 0.1; NVIDIA H100 80GB HBM3,
# 700.00 W) the kernels' errors against fp64 were 1.1e-5 to 3.8e-5, as at
# dh=64 (the plain version's 2.3e-6 to 8.1e-6), and |kernel - plain| - RTOL
# |plain| reached 1.9e-5, the largest error 3.0e-5 (dk, T=64, key padding).
# At dh=256 (the fp32 long pair alone; B=256, h=4, T=300, key padding and
# causal, rates 0 and 0.1; NVIDIA H100 80GB HBM3, 700.00 W) it holds too, once
# the 96 products of a stage's score sum into four partial accumulators
# (`attention_long.cuh::products_raw`): the errors against fp64 then read
# 1.7e-5 to 6.4e-5 and |kernel - plain| - RTOL |plain| up to 3.1e-5 per
# T=150 over twelve readings (`wide_kernel_phase`,
# `tools/wide_attention_draws.py`); with one accumulator they read up to
# 1.45e-4 and 6.7e-5, above this tolerance, and the forward's 1 / row sum up
# to 3.6e-6, above LONG_STATS_ATOL
BWD_ATOL = 2e-5
BWD_ATOL_DH64 = 5e-5
DH64_DRAWS = 4  # more dh=64 draws held against fp64 (`kernel_case_bwd` `*_draw*` records)
# forward's row max and 1 / row sum vs plain: 1e-6 relative, and 1e-6 absolute
# for a max near 0 (the scores themselves agree to about 5e-7)
STATS_ATOL, STATS_RTOL = 1e-6, 1e-6
# the long forward's row max and 1 / row sum vs plain, absolute: its scores
# are wgmma's fp32 sums of 3xTF32 products; the row max came within 5.7e-6
# of plain at dh=64, T=600 (3.8e-6 at dh=32, T=600 and 1,200), 1 / row sum
# within 9.2e-7 (B=256, NVIDIA H100 80GB HBM3); twice that, rounded up
LONG_STATS_ATOL = {"row_max": 1.2e-5, "row_inv_sum": 2e-6}
FEATURE_TOL = 1e-4  # whole feature pass, kernel model vs plain model
SCORE_ATOL = 1e-5  # scoring head vs plain: sigmoid outputs in (0, 1), fp32 sums
# max-affinity vs plain: same bf16 inputs and exact products, fp32 sums over
# D=128 in another order, |A| up to about 60 for unit-normal inputs
AFF_ATOL, AFF_RTOL = 1e-4, 1e-5
SMALLN_SWEEP = (8, 16, 20, 24, 32, 40, 48, 64, 80)  # N=M of the K6/K7 crossover
# the backward route's crossover: T swept at each head width (heads of D=128),
# wherever the one-sweep kernel holds the shape
BWD_SWEEP_T = (150, 200, 256, 300, 368, 512)
BWD_SWEEP_HEADS = (4, 8, 2, 16)  # dh 32, 16, 64, 8
FWD_SWEEP_T = (150, 300, 368, 512, 600, 800)  # the forward route's crossover, dh 32 and 16
# the bf16 crossovers: the same T, 40 (BERT4Rec's encoder at T=20) and, for
# the forward, 1,200; the native bf16 one-head kernels hold every T here at
# these widths (the forward T <= 1,440 at dh=32)
BF16_FWD_SWEEP_T = (40, *FWD_SWEEP_T, 1200)
BF16_BWD_SWEEP_T = (40, *BWD_SWEEP_T)
OPEN_SHARE = (0.05, 0.95)  # share of open gates the opened-threshold check needs
TOPK_RTOL, TOPK_ATOL = 1e-5, 1e-6  # catalog top-k vs dense oracle
FLAGSHIP = dict(
    backbone="sasrec", emb_dim=128, hid_dim=32, batch_size=256, seq_len=150,
    is_itc=True, ts2=0.4, is_dr=True, comp_broadcast_quirk=True,
    sasrec_blocks=2, sasrec_heads=8, item_length=447410,
)
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "attention_fwd": ("amid_tpu_torch/csrc/attention_fwd.cu",
                      "amid_tpu/ops/pallas_attention.py:99"),
    "attention_fwd_long": ("amid_tpu_torch/csrc/attention_fwd_long.cu",
                           "amid_tpu/ops/pallas_attention.py:99"),
    "attention_bwd": ("amid_tpu_torch/csrc/attention_bwd.cu",
                      "amid_tpu/ops/pallas_attention.py:118"),
    "attention_bwd_long": ("amid_tpu_torch/csrc/attention_bwd_long.cu",
                           "amid_tpu/ops/pallas_attention.py:118"),
    "scatter_set_unique3": ("amid_tpu_torch/csrc/scatter_rows.cu",
                            "amid_tpu/ops/pallas_scatter.py:68"),
    "scatter_set_unique": ("amid_tpu_torch/csrc/scatter_rows.cu",
                           "amid_tpu/ops/pallas_scatter.py:49"),
    "embedding_gather": ("amid_tpu_torch/csrc/gather_rows.cu",
                         "amid_tpu/ops/pallas_embedding.py:30"),
    # the gather's backward, which the JAX package leaves to XLA's scatter-add
    "embedding_gather_grad": ("amid_tpu_torch/csrc/gather_rows.cu",
                              "amid_tpu/ops/pallas_embedding.py:75"),
    "scoring_head": ("amid_tpu_torch/csrc/scoring_head.cu",
                     "amid_tpu/ops/pallas_scoring.py:69"),
    "max_affinity_blocked": ("amid_tpu_torch/csrc/affinity.cu",
                             "amid_tpu/ops/pallas_affinity.py:39"),
    "max_affinity_smalln": ("amid_tpu_torch/csrc/affinity.cu",
                            "amid_tpu/ops/pallas_affinity.py:127"),
    # the bf16-operand modes (the model's --bf16): K1's native bf16 sources,
    # one-head and long, the kernel's bf16 flag (K5)
    "attention_fwd_bf16": ("amid_tpu_torch/csrc/attention_fwd_bf16.cu",
                           "amid_tpu/ops/pallas_attention.py:99"),
    "attention_fwd_long_bf16": ("amid_tpu_torch/csrc/attention_fwd_long_bf16.cu",
                                "amid_tpu/ops/pallas_attention.py:99"),
    "attention_bwd_bf16": ("amid_tpu_torch/csrc/attention_bwd_bf16.cu",
                           "amid_tpu/ops/pallas_attention.py:118"),
    "attention_bwd_long_bf16": ("amid_tpu_torch/csrc/attention_bwd_long_bf16.cu",
                                "amid_tpu/ops/pallas_attention.py:118"),
    "scoring_head_bf16": ("amid_tpu_torch/csrc/scoring_head.cu",
                          "amid_tpu/ops/pallas_scoring.py:69"),
}
# training phase: one step of a kernels='cuda' model against the same step of
# a kernels='torch' model (same state, batch and key, dropout 0.5 on)
# |loss difference|; for C2DSR's loss_cl, and the loss that holds it, relative
# to the value where it exceeds 1: loss_cl sums dot products of pooled
# features and reaches about 30 on BERT4Rec, where it is also held against an
# fp64 step (`loss_cl_fp64`); every other metric keeps the absolute 1e-5
# (`losses_agree`)
LOSS_TOL = 1e-5
MOMENT_TOL = 2e-4  # max |difference| of a moment array over its max |value|
# Adam's first update is lr * g / (|g| + eps): nearly lr * sign(g), so an
# element whose gradient is at rounding level may move the other way. Updated
# values are compared element-wise at UPDATE_ATOL and at most UPDATE_SHARE of
# the elements may differ by more.
UPDATE_ATOL, UPDATE_SHARE = 1e-6, 1e-3
LN2_TOL = 0.05  # first loss_cls vs ln 2
TRAIN_ROWS, VAL_ROWS, DR_ROWS = 4096, 1024, 4096  # 16 + 16 steps, 4 eval batches, twice
GRAPH_STEPS = 4  # graph_steps: the eager step, the captured one and two replays
RANKS_EQUAL_SHARE = 0.999  # replayed vs eager evaluation batch, same weights and key
# step_timing: eager steps timed and traced per step kind (a replay chunk: 16);
# 5 since the script's time on a slow host neared its limit (10 before)
TIMED_STEPS = 5
# whether phases 4, 7 and 8 trace their steps (`step_timing`): off here, where
# the traces took 247.5 s of the script's 1,096 s (NVIDIA H100 80GB HBM3,
# 700.00 W); `tools/step_timings.py` runs those phases with them on
STEP_TIMING = False
FLIP_EPOCHS = 3  # phase 6: epochs of training before the gates are counted
# phase 10, the bf16-operand modes. Each case is read as norms over its
# outputs, ||x - y|| / ||y|| in fp64 (the largest over BF16_DRAWS draws and,
# for a backward or the scoring pair, over its outputs):
#   kernel_oracle: the bf16 build against an fp64 oracle of its own rounding
#     points (the forwards round each key chunk's unnormalised exp(S - m),
#     `bf16_attention_kernel_oracle`; the backwards and K5 round where the
#     JAX kernel and the plain version round);
#   kernel_plain: the bf16 build against the plain bf16 version;
#   plain_oracle: the plain bf16 version against an fp64 oracle of the JAX
#     kernel's rounding.
# The fp32 build, read at the same inputs (`fp32_oracle`, the least over the
# draws), is the control: it must fail the case's kernel_oracle limit, so a
# case shows that the bf16 build ran. The forwards' kernel_plain limits
# cannot show it (the fp32 build reads 2.7e-3 to 3.4e-3 there, the bf16
# build 1.7e-3 to 2.3e-3: one rounding point apart); the backwards' and
# K5's do (fp32 5.0e-3 and 1.2e-3). Limits per case, (kernel_oracle,
# kernel_plain, plain_oracle): four times the case's largest reading over
# 16 draws (two runs of 3 and one of 10; B=256, oracles on 32 rows; NVIDIA
# H100 80GB HBM3, 700.00 W), rounded up. The readings were 6e-8 to 9.1e-5
# against the kernels' own oracle; the fp32 build's 6.0e-4 to 5.2e-3, 11x
# to 40x each case's limit
BF16_LIMITS = {
    "bf16_causal_T150_h8_rate0.0": (9e-5, 8e-3, 2e-4),
    "bf16_causal_T150_h8_rate0.5": (8e-5, 8e-3, 2e-4),
    "bf16_causal_T20_h8_rate0.0": (6e-5, 7e-3, 1e-4),
    "bf16_causal_T20_h8_rate0.5": (2e-4, 7e-3, 9e-5),
    "bf16_long_keypad_T600_h4_rate0.1": (2e-4, 1e-2, 3e-4),
    "bf16_long_keypad_T1200_h4_rate0.1": (2e-4, 1e-2, 2e-4),
    "bf16_bwd_causal_T150_h8_rate0.5": (4e-4, 8e-5, 4e-4),
    "bf16_bwd_causal_T20_h8_rate0.0": (4e-4, 3e-4, 4e-4),
    "bf16_bwd_long_keypad_T600_h4_rate0.1": (2e-4, 2e-4, 2e-4),
    "bf16_scoring_pair_C1000": (3e-5, 4e-5, 4e-5),
    "bf16_scoring_pair_C2": (4e-5, 1e-4, 1e-4),
    # the card tests' native long cases (tests/test_torch_cuda.py: every head
    # width, key padding and causal, rates 0 and 0.1, T of 300, 600 and
    # 1,000 at B=8): 4x the largest reading of 9 such cases over 3 draws
    # (2.8e-5 / 2.4e-3 / 4.0e-5 forward, 9.6e-5 / 5.0e-5 / 9.6e-5 backward;
    # the fp32 build 2.9e-3 and 4.3e-3 at the least; NVIDIA H100 80GB HBM3,
    # 700.00 W), rounded up
    "bf16_long_native": (1.2e-4, 1e-2, 2e-4),
    "bf16_bwd_long_native": (4e-4, 3e-4, 4e-4),
    # phase 13's bf16 long pair at template width 256 (B=256, h=4, T=300, key
    # padding and causal, rates 0 and 0.1) and K5's wide kernel in bf16
    # (D=1,024, H=64, C=1000 and 2): 4x the largest reading, rounded up, over
    # the draws of `tools/wide_bf16_draws.py` (3 a case) and phase 13's (1)
    # and, for K5, 6 more of the same arithmetic; forward 4.8e-5 / 2.3e-3 /
    # 5.0e-5, backward 7.6e-5 / 2.5e-5 / 7.6e-5, K5 C=1000 1.0e-5 / 3.0e-5 /
    # 3.0e-5, C=2 1.9e-5 / 5.4e-5 / 5.4e-5; the fp32 builds 2.7e-3, 4.2e-3,
    # 5.4e-4 and 9.2e-4 at the least (NVIDIA H100 80GB HBM3, 700.00 W)
    "bf16_long_dh256": (2e-4, 1e-2, 2e-4),
    "bf16_bwd_long_dh256": (3.1e-4, 1.1e-4, 3.1e-4),
    "bf16_scoring_wide_C1000": (5e-5, 1.2e-4, 1.2e-4),
    "bf16_scoring_wide_C2": (8e-5, 2.2e-4, 2.2e-4),
}
# a bf16 step, kernels='cuda' against kernels='torch' (`bf16_step_check`):
# losses 2.0e-5 apart at most (T=150 pairwise), held at 5x. The forward
# kernels round P where the plain version does not, a bf16 rounding's
# difference that every later bf16 product carries on, so the gradients
# differ far more than in fp32 (MOMENT_TOL): in phase A and B of T=20 lazy,
# T=150 pairwise and BERT4Rec T=150, updated elements more than UPDATE_ATOL
# apart up to 12.5% (BERT4Rec's touched table rows, phase A), moments up to
# 6.3e-2 of their largest value (BERT4Rec's dense nu, phase B). The step is
# deterministic; twice the largest reading, rounded up
BF16_LOSS_TOL = 1e-4
BF16_UPDATE_SHARE = 0.25
BF16_MOMENT_TOL = 0.13
# the bf16 feature pass against the fp32 model's, of its largest value:
# 1.6e-3 measured (T=20 and T=150), held at about 3x
BF16_FEATURE_TOL = 5e-3


class SmokeFailure(RuntimeError):
    pass


def bwd_atol(t: int, dh: int) -> float:
    """The backward's absolute tolerance at sequence length t and head width
    dh (BWD_ATOL, BWD_ATOL_DH64 from dh=33 on: the template widths 64, 128
    and 256)."""
    return (BWD_ATOL_DH64 if dh > 32 else BWD_ATOL) * max(1.0, t / 150)


def losses_agree(key: str, a: float, ref: dict) -> bool:
    """Metric `key`, of value a, within LOSS_TOL of ref[key]: relative to
    |ref[key]| where it exceeds 1 for C2DSR's loss_cl and for the loss that
    holds it (metrics with a loss_cl), absolute for every other metric."""
    b = float(ref[key])
    relative = key == "loss_cl" or (key == "loss" and "loss_cl" in ref)
    return abs(a - b) <= LOSS_TOL * (max(1.0, abs(b)) if relative else 1.0)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls."""
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


GRAPH_CALLS, GRAPH_REPLAYS = 20, 5  # calls captured into one CUDA graph, replays timed


def graph_ms(torch, fn) -> float:
    """Mean device time of fn() in ms with the host out of the way: GRAPH_CALLS
    calls are captured into one CUDA graph (a wrapper launches on the current
    stream, which is the capturing one) and the replay is timed with events.
    fn must not synchronise. Repeated calls find small inputs in the L2 cache."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (GRAPH_CALLS * GRAPH_REPLAYS)


def host_us(torch, fn, iters: int) -> float:
    """Wall time per call of fn() in microseconds on the host alone: the queue
    is drained first and nothing waits for the device in between."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / iters * 1e6


ROUNDS = 3  # the host is shared and swings: kernel_ms and host_us are the least of 3 rounds


def timings(torch, fn, iters: int, library: bool = False, rounds: int = ROUNDS) -> dict:
    """The three times of one call: back-to-back public calls between events
    (`kernel_ms`: the larger of what the host and the device need per call),
    the device alone (`device_ms`, a graph replay) and the host alone
    (`host_us`). The two that depend on the host are the least of `rounds`
    rounds of `iters` calls. A library call's keys carry the prefix `library_`."""
    ms = min(cuda_ms(torch, fn, iters) for _ in range(rounds))
    host = min(host_us(torch, fn, iters) for _ in range(rounds))
    if library:
        return {"library_ms": ms, "library_device_ms": graph_ms(torch, fn),
                "library_host_us": host}
    return {"kernel_ms": ms, "device_ms": graph_ms(torch, fn), "host_us": host}


def bound(nbytes, flops, peak_flops=FP32_FLOPS):
    """Least time (ms) for `nbytes` of traffic and `flops` operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def attention_bound(b, t, d, heads, bias_numel, peak=TF32_TENSOR_FLOPS):
    """Least time (ms) of one attention forward on the card, and its limit:
    q, k, v, bias read and o written (the row statistics are the kernel's
    choice, not counted); Q.K^T and P.V at `peak`, the TF32 tensor-core
    peak for fp32 operands."""
    dh = d // heads
    nbytes = 4 * (4 * b * t * d + bias_numel)
    return bound(nbytes, 4 * b * heads * t * t * dh, peak)


def attention_bwd_bound(b, t, d, heads, bias_numel, peak=TF32_TENSOR_FLOPS):
    """Least time (ms) of one attention backward: q, k, v, dO, bias read,
    dq, dk, dv written (out and the row statistics, residuals of the kernels'
    choosing, not counted); five products of 2*T*T*dh operations per head at
    `peak`, the TF32 tensor-core peak for fp32 operands."""
    dh = d // heads
    return bound(4 * (7 * b * t * d + bias_numel), 10 * b * heads * t * t * dh, peak)


def scatter_bound(n_arrays, rows_written, width, n_ids):
    """Least time (ms) of a unique-row scatter: every written row read once
    and written once, the ids read once. Pure data movement."""
    return bound(n_arrays * 2 * rows_written * width * 4 + 4 * n_ids, 0)


def gather_bound(n, width):
    """A row gather: n rows read and written once, the ids (int32) read once."""
    return bound(2 * n * width * 4 + 4 * n, 0)


def gather_grad_bound(n, rows, width):
    """The gather's backward: n gradient rows and their ids (int32) read
    once, the [rows, width] table (zeros and sums) written once."""
    return bound(n * width * 4 + 4 * n + rows * width * 4, 0)


def scoring_bound(b, c, d, h, users=1, peak=FP32_FLOPS):
    """The scoring head for `users` user representations against the same
    candidates: the users, the items (once), both weight halves, b1, w2, b2
    read, [users, B, C] written; the item product once, the user product and
    the output product per user, at `peak`."""
    nbytes = 4 * (users * b * d + b * c * d + 2 * h * d + 2 * h + 1 + users * b * c)
    return bound(nbytes, 2 * b * c * d * h + users * (2 * b * d * h + 2 * b * c * h), peak)


def affinity_bound(b, c, n, m, d):
    """Max-affinity: both fp32 inputs read, [B, C] written; 2*B*C*N*M*D
    operations against the bf16 tensor-core peak."""
    return bound(4 * ((b * n + c * m) * d + b * c), 2 * b * c * n * m * d,
                 BF16_TENSOR_FLOPS)




def expected_launches(cfg, train_steps=0, eval_batches=0, feature_passes=0,
                      lazy_adam=False, fused_scatter=True, c2dsr_steps=0):
    """Kernel launches of a kernels='cuda' model of `cfg` (two towers): per
    forward the attention forward once a block and tower (SASRec and
    BERT4Rec: 4; GRU4Rec: none), on the path `forward_route` takes at the
    encoder's length and head width (the one-head kernel or the long
    forward), 2 gathers (both sequences in one launch,
    target and negatives in another; 1 on a features-only pass), 1 scoring
    launch per head (both user representations in one launch; 3 heads with
    DR), and in pairwise mode 2 affinity launches per comp module pair
    (InnerComp at T, InterComp at the length it sees; the small-N kernel
    where `smalln_faster(N, D)`, else the blocked one); per train step the
    backward once a block and tower, on the path `backward_route` takes at
    the encoder's length and head width (the one-sweep kernel or the long
    path), and on the lazy path the table write-back. `c2dsr_steps` of the
    train steps are C2DSR phase-A steps: each adds two features-only passes
    over the views (2L), forward and backward, whose encoder length (and so
    forward and backward routes) and affinity lengths are those of 2L, not
    of L."""
    from amid_tpu_torch.config import encoder_length
    from amid_tpu_torch.models.amid import head_width
    from amid_tpu_torch.ops.affinity import smalln_faster
    from amid_tpu_torch.ops.attention import backward_route, forward_route
    from amid_tpu_torch.ops.precision import resolve_precision

    blocks = {"gru4rec": 0, "bert4rec": cfg.bert_blocks}.get(cfg.backbone, cfg.sasrec_blocks)
    counts = dict.fromkeys(KERNELS, 0)
    precision = resolve_precision(cfg)  # the routes' tables and the bf16 builds' counts
    mode = "_bf16" if precision == "bf16" else ""
    # SASRec's remat runs each block's attention forward again in the backward
    remat = 2 if cfg.remat and cfg.backbone == "sasrec" else 1

    def feature_passes_at(t, n, backward):
        """n passes over sequences of length t through both towers."""
        if blocks:
            t_enc, dh = encoder_length(cfg, t), head_width(cfg)
            long = forward_route(t_enc, dh, precision) == "long"
            counts[("attention_fwd_long" if long else "attention_fwd") + mode] += (
                2 * blocks * n * (remat if backward else 1))
            if backward:
                long = backward_route(t_enc, dh, precision) == "long"
                counts[("attention_bwd_long" if long else "attention_bwd") + mode] += (
                    2 * blocks * n)
        if not cfg.comp_broadcast_quirk:
            for m in [t] * cfg.is_inc + [t * (2 if cfg.is_inc else 1)] * cfg.is_itc:
                counts["max_affinity_smalln" if smalln_faster(m, cfg.emb_dim)
                       else "max_affinity_blocked"] += 2 * n

    t = cfg.seq_len
    feature_passes_at(t, train_steps, True)
    feature_passes_at(t, eval_batches + feature_passes, False)
    feature_passes_at(2 * t, 2 * c2dsr_steps, True)
    forwards = train_steps + eval_batches
    scatters = train_steps if lazy_adam else 0
    counts["scatter_set_unique3"] = scatters if fused_scatter else 0
    counts["scatter_set_unique"] = 0 if fused_scatter else 3 * scatters
    counts["embedding_gather"] = 2 * forwards + feature_passes + 2 * c2dsr_steps
    counts["embedding_gather_grad"] = 2 * train_steps + 2 * c2dsr_steps
    counts["scoring_head" + mode] = (3 if cfg.is_dr else 1) * forwards
    return counts


def reset_counts() -> None:
    """Every kernel's launch count to 0 (`amid_tpu_torch/ops/launches.py`)."""
    from amid_tpu_torch.ops import launches

    launches.reset()


def read_counts() -> dict:
    """Launches on the device by kernel: a CUDA graph adds what its capture
    counted at each replay."""
    from amid_tpu_torch.ops import launches

    return launches.read()


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(torch, gen):
    import torch.nn.functional as F

    from amid_tpu_torch.ops import attention as attention_ops
    from amid_tpu_torch.ops.attention import (
        attention_fwd_stats_plain, attention_fwd_stats_streamed_plain, attention_plain,
        dropout_keep_mask, forward_route, fused_attention,
    )

    def qkv(b, t, d):
        return [torch.randn(b, t, d, device="cuda", generator=gen) for _ in range(3)]

    def causal(t):
        return torch.triu(torch.full((t, t), -1e9, device="cuda"), diagonal=1)[None, None]

    def compare(name, q, k, v, bias, heads, seed=0, rate=0.0, timed=True, path=None):
        """The forward against its plain version: `fused_attention` (the path
        `forward_route` takes), or with `path` that path through
        `_launch_forward`. The long path's plain version is
        `attention_fwd_stats_streamed_plain` in its key tiles (a tile at a
        time: it holds T=1,600 where a [B, h, T, T] block at rate 0.1 would
        not fit), the one-head kernel's `attention_plain` and
        `attention_fwd_stats_plain`."""
        b, t, d = q.shape
        dh = d // heads
        route = path or forward_route(t, dh)
        if path is None:
            def fwd():
                return fused_attention(q, k, v, bias, seed, heads, rate)
        else:
            def fwd():
                return attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, False,
                                                     path)[0]
        if route == "long":
            def plain_stats():
                return attention_fwd_stats_streamed_plain(q, k, v, bias, seed, heads, rate,
                                                          32 if dh == 64 else 64)

            def plain():
                return plain_stats()[0]
        else:
            def plain_stats():
                return attention_fwd_stats_plain(q, k, v, bias, seed, heads, rate)

            def plain():
                return attention_plain(q, k, v, bias, seed, heads, rate)
        with torch.no_grad():
            got = fwd()
            want = plain()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            require(torch.isfinite(got).all().item(), f"{name}: non-finite kernel output")
            require(torch.allclose(got, want, atol=ATOL, rtol=RTOL),
                    f"{name}: kernel vs plain max_abs_err {err}")
            require(torch.equal(fwd(), got), f"{name}: two forward calls differ")
            # the forward as training launches it: with the row statistics
            stats = attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, True, route)
            want_stats = plain_stats()
            require(torch.equal(stats[0], got), f"{name}: out differs with statistics")
            stats_errs = {}
            for n, g, w in zip(("row_max", "row_inv_sum"), stats[1:], want_stats[1:]):
                stats_errs[n] = (g - w).abs().max().item()
                atol = LONG_STATS_ATOL[n] if route == "long" else STATS_ATOL
                require(torch.allclose(g, w, atol=atol, rtol=STATS_RTOL),
                        f"{name}: kernel vs plain {n} max_abs_err {stats_errs[n]}")
            rec = {"case": name, "shape": list(q.shape), "bias": list(bias.shape),
                   "heads": heads, "rate": rate, "path": route, "max_abs_err": err,
                   "stats_max_abs_err": stats_errs}
            del stats, want_stats
            if timed:
                iters = 50 if t <= 600 else 20
                rec.update(timings(torch, fwd, iters))
                rec["plain_ms"] = cuda_ms(torch, plain, *((20, 3) if t <= 600 else (5, 1)))

                def split(x):
                    return x.view(b, t, heads, dh).transpose(1, 2)

                qh, kh, vh = split(q), split(k), split(v)
                if rate == 0.0:  # with dropout the library draws its own mask
                    lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)
                    rec["library_max_abs_err"] = (
                        lib.transpose(1, 2).reshape(b, t, d) - want).abs().max().item()
                rec.update(timings(
                    torch, lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, attn_mask=bias, dropout_p=rate), iters, library=True))
                rec["bound_ms"], rec["bound_by"] = attention_bound(
                    b, t, d, heads, bias.numel())
        emit({"kernel_case": rec})
        return rec

    B, D = 256, 128
    cases = {}
    for t in (150, 20):
        q, k, v = qkv(B, t, D)
        cases[t] = compare(f"causal_T{t}_h8", q, k, v, causal(t), 8)

    # key padding, 4 heads of width 32, row 0 with every key masked: the
    # softmax over an all -1e9 row is uniform (as in JAX), so that row's
    # output is the mean of v over all keys.
    t = 150
    q, k, v = qkv(B, t, D)
    lens = torch.randint(1, t + 1, (B,), device="cuda", generator=gen)
    key_ok = torch.arange(t, device="cuda")[None, :] >= (t - lens[:, None])
    key_ok[0] = False
    bias = torch.where(key_ok, 0.0, -1e9)[:, None, None, :]
    cases["keypad"] = compare("keypad_T150_h4", q, k, v, bias, 4)
    with torch.no_grad():
        got = fused_attention(q, k, v, bias, 0, 4, 0.0)
    want_row = v[0].mean(dim=0, keepdim=True).expand(t, D)
    require(torch.allclose(got[0], want_row, atol=ATOL, rtol=RTOL),
            "fully masked row is not the uniform average of v")
    # BERT4Rec's encoder lengths at amazon's T=150: 300 (InterComp), 600
    # (InnerComp and InterComp); the same key padding, row 0 fully masked
    for t in (300, 600):
        q, k, v = qkv(B, t, D)
        cases[f"keypad_T{t}"] = compare(f"keypad_T{t}_h4", q, k, v, keypad_bias(torch, gen, B, t),
                                        4)

    # dropout at rate 0.5 (training's rate), with the seed as training passes
    # it (a one-element int64 tensor on the card, read by the kernel through
    # a pointer): the outputs agree at the full causal shapes, and the mask
    # itself, read out through one-hot values (an int seed there), equals
    # the plain version's element for element
    step_seed = torch.tensor([1234], dtype=torch.int64, device="cuda")
    for t in (150, 20):
        q, k, v = qkv(B, t, D)
        cases[f"rate0.5_T{t}"] = compare(f"causal_T{t}_h8_rate0.5", q, k, v, causal(t), 8,
                                         seed=step_seed, rate=0.5)
    # BERT4Rec's T=600 encoder trains at rate 0.1 (library: SDPA at
    # dropout_p=0.1, which draws its own mask)
    q, k, v = qkv(B, 600, D)
    cases["keypad_T600_rate0.1"] = compare("keypad_T600_h4_rate0.1", q, k, v,
                                           keypad_bias(torch, gen, B, 600), 4, seed=step_seed,
                                           rate=0.1)
    # the long forward (csrc/attention_fwd_long.cu): BERT4Rec's key padding at
    # dh=32 with row 0 fully masked, at T=1,200 (C2DSR's views with both
    # comps) and T=600 (the main pass), at rate 0 and training's 0.1;
    # SASRec's causal bias at dh=16 and T=1,600 (past the one-head kernel's
    # 1,448); dh=64 at T=600 (past its 424)
    for t in (1200, 600):
        q, k, v = qkv(B, t, D)
        bias = keypad_bias(torch, gen, B, t)
        for rate in (0.0, 0.1):
            tag = f"_rate{rate}" if rate else ""
            cases[f"long_T{t}{tag}"] = compare(f"long_keypad_T{t}_h4{tag}", q, k, v, bias, 4,
                                               seed=step_seed, rate=rate, path="long")
        with torch.no_grad():
            got = attention_ops._launch_forward(q, k, v, bias, 0, 4, 0.0, False, "long")[0]
        require(torch.allclose(got[0], v[0].mean(dim=0, keepdim=True).expand(t, D), atol=ATOL,
                               rtol=RTOL),
                f"long forward T={t}: the fully masked row is not the uniform average of v")
    q, k, v = qkv(B, 1600, D)
    cases["long_causal_T1600"] = compare("long_causal_T1600_h8", q, k, v, causal(1600), 8,
                                         path="long")
    q, k, v = qkv(B, 600, D)
    cases["long_T600_h2"] = compare("long_keypad_T600_h2", q, k, v,
                                    keypad_bias(torch, gen, B, 600), 2, path="long")
    t, heads, dh, seed = 20, 4, 32, 977
    q, k, _ = qkv(B, t, D)
    v = torch.zeros(B, t, D, device="cuda")
    for h in range(heads):
        v[:, torch.arange(t), h * dh + torch.arange(t)] = 1.0
    zero_bias = torch.zeros(1, 1, 1, t, device="cuda")
    with torch.no_grad():
        out = fused_attention(q, k, v, zero_bias, seed, heads, 0.5)
    got_mask = out.view(B, t, heads, dh)[..., :t].permute(0, 2, 1, 3) != 0
    want_mask = dropout_keep_mask(seed, B, heads, t, 0.5, "cuda")
    require(torch.equal(got_mask, want_mask), "kernel dropout mask != plain mask")
    kept = want_mask.float().mean().item()
    sigma = math.sqrt(0.25 / want_mask.numel())
    require(abs(kept - 0.5) <= 3 * sigma, f"kept share {kept} not within 3 sigma of 0.5")
    emit({"dropout_mask": {"equal": True, "kept_share": kept, "sigma": sigma,
                           "elements": want_mask.numel()}})
    return cases


def fwd_crossover_sweep(torch, gen):
    """The forward route's crossover: both paths' device time at B=256,
    D=128, rate 0, key padding and causal, at dh 32 and 16 and each T of
    FWD_SWEEP_T (`fwd_crossover` records: the numbers behind
    `ops/attention.py::LONG_FWD_FASTER_FROM`); the two kernels' outputs
    agree. Run by `tools/route_sweeps.py`, not by `main`."""
    from amid_tpu_torch.ops import attention as attention_ops
    from amid_tpu_torch.ops.attention import forward_route

    B, D = FLAGSHIP["batch_size"], FLAGSHIP["emb_dim"]

    def qkv(b, t, d):
        return (torch.randn(b, t, d, device="cuda", generator=gen) for _ in range(3))

    def causal(t):
        return torch.triu(torch.full((t, t), -1e9, device="cuda"), diagonal=1)[None, None]

    for heads in (4, 8):
        dh = D // heads
        for kind in ("keypad", "causal"):
            for t in FWD_SWEEP_T:
                q, k, v = qkv(B, t, D)
                bias = keypad_bias(torch, gen, B, t) if kind == "keypad" else causal(t)
                outs, ms = {}, {}
                for p in ("sweep", "long"):
                    def fwd(p=p):
                        return attention_ops._launch_forward(q, k, v, bias, 0, heads, 0.0, False,
                                                             p)[0]
                    with torch.no_grad():
                        outs[p] = fwd()
                    ms[p] = graph_ms(torch, fwd)
                diff = (outs["long"] - outs["sweep"]).abs().max().item()
                require(torch.allclose(outs["long"], outs["sweep"], atol=ATOL, rtol=RTOL),
                        f"fwd_crossover T={t} dh={dh} {kind}: the paths differ by {diff}")
                emit({"fwd_crossover": {
                    "T": t, "dh": dh, "bias": kind, "route": forward_route(t, dh),
                    "measured_faster": min(ms, key=ms.get),
                    **{f"{p}_device_ms": v for p, v in ms.items()}, "max_abs_diff": diff}})


def keypad_bias(torch, gen, b, t):
    """A key-padding bias [B, 1, 1, T] of random lengths 1..T, left padded,
    with batch row 0's every key masked (m = -1e9 and P = 1/T there)."""
    lens = torch.randint(1, t + 1, (b,), device="cuda", generator=gen)
    key_ok = torch.arange(t, device="cuda")[None, :] >= (t - lens[:, None])
    key_ok[0] = False
    return torch.where(key_ok, 0.0, -1e9)[:, None, None, :]


def backward_kernel_phase(torch, gen):
    """The backward paths against the plain version: the one-sweep kernel at
    SASRec's shapes and a key-padding case; the long-sequence path at
    BERT4Rec's T=600 (h=4, dh=32; rate 0 and training's 0.1) and at T=1,200
    fed the long forward's statistics; both paths,
    timed in full, at BERT4Rec's T=300 (dh=32) and SASRec's T=150 (dh=16);
    then both paths' `device_ms` at every T of BWD_SWEEP_T and head width of
    BWD_SWEEP_HEADS where both take the shape, and with the causal bias at
    dh=16 up to T=600 (`bwd_crossover`), the numbers behind
    `backward_route`'s table (`ops/attention.py::LONG_FASTER_FROM`); at
    T=150 and over DH64_DRAWS more draws at dh=64, errors against fp64."""
    import torch.nn.functional as F

    from amid_tpu_torch.ops import attention as attention_ops
    from amid_tpu_torch.ops.attention import (
        attention_backward, attention_bwd_plain, attention_fwd_stats_plain, backward_route,
        long_faster, sweep_fits,
    )

    def causal(t):
        return torch.triu(torch.full((t, t), -1e9, device="cuda"), diagonal=1)[None, None]

    def compare(name, b, t, d, bias, heads, seed=0, rate=0.0, timed=True, path=None,
                fp64=False, long_forward=False):
        q, k, v, dout = (torch.randn(b, t, d, device="cuda", generator=gen)
                         for _ in range(4))
        # the residuals (out and the row statistics) of the plain forward, for
        # both; with `long_forward` those of the long forward kernel
        if long_forward:
            res = attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, True, "long")
        else:
            res = attention_fwd_stats_plain(q, k, v, bias, seed, heads, rate)
        got = attention_backward(q, k, v, bias, *res, dout, seed, heads, rate, path)
        want = attention_bwd_plain(q, k, v, bias, *res, dout, seed, heads, rate)
        again = attention_backward(q, k, v, bias, *res, dout, seed, heads, rate, path)
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                f"{name}: two backward calls differ")
        torch.cuda.synchronize()
        names = ("dq", "dk", "dv")
        errs = {n: (g - w).abs().max().item() for n, g, w in zip(names, got, want)}
        atol = bwd_atol(t, d // heads)
        for n, g, w in zip(errs, got, want):
            require(torch.isfinite(g).all().item(), f"{name}: non-finite {n}")
            require(torch.allclose(g, w, atol=atol, rtol=RTOL),
                    f"{name}: kernel vs plain {n} max_abs_err {errs[n]} (atol {atol})")
        rec = {"case": name, "shape": [b, t, d], "bias": list(bias.shape), "heads": heads,
               "rate": rate, "path": path or backward_route(t, d // heads),
               "max_abs_err": max(errs.values()), "errs": errs, "bwd_atol": atol,
               # max over elements of |kernel - plain| - RTOL |plain|: the atol it passes at
               "atol_needed": max(((g - w).abs() - RTOL * w.abs()).max().item()
                                  for g, w in zip(got, want))}
        if fp64:  # the plain fp32 version and the kernel against the plain one in fp64
            wide = [x.double() for x in (q, k, v, bias)]
            exact = attention_bwd_plain(*wide, *attention_fwd_stats_plain(*wide, seed, heads, rate),
                                        dout.double(), seed, heads, rate)
            # a fully masked batch row (every key at -1e9) is another function in
            # fp64: fp32 spaces numbers near 1e9 by 64 and loses its scores
            rows = ~(bias <= -1e8).reshape(bias.shape[0], -1).all(dim=1)
            rows = rows.expand(b) if rows.numel() == 1 else rows
            for which, grads in (("plain", want), ("kernel", got)):
                rec[f"{which}_vs_fp64"] = {n: (g[rows].double() - w[rows]).abs().max().item()
                                           for n, g, w in zip(names, grads, exact)}
        if timed == "device":  # the crossover sweep: the device alone
            rec["device_ms"] = graph_ms(torch, lambda: attention_backward(
                q, k, v, bias, *res, dout, seed, heads, rate, path))
        elif timed:
            dh = d // heads
            rec.update(timings(torch, lambda: attention_backward(
                q, k, v, bias, *res, dout, seed, heads, rate, path), 20))
            rec["plain_ms"] = cuda_ms(torch, lambda: attention_bwd_plain(
                q, k, v, bias, *res, dout, seed, heads, rate), *((10, 3) if t <= 300 else (3, 1)))

            def split(x):
                return x.view(b, t, heads, dh).transpose(1, 2)

            qh, kh, vh = (split(x).detach().requires_grad_() for x in (q, k, v))
            gh = split(dout)

            def sdpa_fwd():
                return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias,
                                                      dropout_p=rate)

            if rate == 0.0:  # with dropout the library draws its own mask
                lib = torch.autograd.grad(sdpa_fwd(), (qh, kh, vh), gh)
                rec["library_max_abs_err"] = max(
                    (g.transpose(1, 2).reshape(b, t, d) - w).abs().max().item()
                    for g, w in zip(lib, want))
            both = timings(torch, lambda: torch.autograd.grad(sdpa_fwd(), (qh, kh, vh), gh),
                         20, library=True)
            with torch.no_grad():
                fwd_only = timings(torch, sdpa_fwd, 20, library=True)
            # backward alone: forward + backward less the forward
            rec.update({key: both[key] - fwd_only[key] for key in both})
            rec["bound_ms"], rec["bound_by"] = attention_bwd_bound(
                b, t, d, heads, bias.numel())
        emit({"kernel_case_bwd": rec})
        return rec

    B, D = 256, 128
    cases = {t: compare(f"bwd_causal_T{t}_h8", B, t, D, causal(t), 8) for t in (150, 20)}
    # key padding, 4 heads of width 32, batch row 0 with every key masked
    # (m = -1e9 and P = 1/T on that row)
    cases["keypad"] = compare("bwd_keypad_T150_h4", B, 150, D, keypad_bias(torch, gen, B, 150), 4)
    step_seed = torch.tensor([1234], dtype=torch.int64, device="cuda")
    for t in (150, 20):  # training's rate and seed
        cases[f"rate0.5_T{t}"] = compare(f"bwd_causal_T{t}_h8_rate0.5", B, t, D, causal(t), 8,
                                         seed=step_seed, rate=0.5)
    # the long path at BERT4Rec's T=600, which no other path takes
    bias = keypad_bias(torch, gen, B, 600)
    require(backward_route(600, 32) == "long", "T=600, dh=32 does not take the long path")
    cases["long_T600"] = compare("bwd_long_keypad_T600_h4", B, 600, D, bias, 4)
    cases["long_T600_rate0.1"] = compare("bwd_long_keypad_T600_h4_rate0.1", B, 600, D, bias, 4,
                                         seed=step_seed, rate=0.1)
    # and at T=1,200, C2DSR's views of BERT4Rec with both comps, fed the long
    # forward's row statistics
    cases["long_T1200"] = compare("bwd_long_keypad_T1200_h4", B, 1200, D,
                                  keypad_bias(torch, gen, B, 1200), 4, long_forward=True)
    # both paths where both take the shape, timed in full: BERT4Rec's T=300
    # (dh=32) and SASRec's T=150 (dh=16)
    for t, heads in ((300, 4), (150, 8)):
        bias = keypad_bias(torch, gen, B, t)
        for p in ("sweep", "long"):
            cases[f"{p}_T{t}_h{heads}"] = compare(f"bwd_{p}_keypad_T{t}_h{heads}", B, t, D, bias,
                                                  heads, path=p)
    # the crossover sweep: both paths' device time wherever both take the
    # shape; at T=150 both paths and the plain version against fp64
    for heads in BWD_SWEEP_HEADS:
        dh = D // heads
        for t in BWD_SWEEP_T:
            if not sweep_fits(t, dh):
                continue
            both = {p: cases.get(f"{p}_T{t}_h{heads}") for p in ("sweep", "long")}
            if both["sweep"] is None:
                bias = keypad_bias(torch, gen, B, t)
                for p in both:
                    both[p] = cases[f"{p}_T{t}_h{heads}"] = compare(
                        f"bwd_{p}_keypad_T{t}_h{heads}", B, t, D, bias, heads, path=p,
                        timed="device", fp64=t == 150)
            ms = {p: c["device_ms"] for p, c in both.items()}
            emit({"bwd_crossover": {
                "T": t, "dh": dh, "bias": "keypad", "route": backward_route(t, dh),
                "long_faster": long_faster(t, dh),
                "measured_faster": min(ms, key=ms.get),
                **{f"{p}_device_ms": v for p, v in ms.items()},
                **{f"{p}_max_abs_err": c["max_abs_err"] for p, c in both.items()},
                **{f"{p}_atol_needed": c["atol_needed"] for p, c in both.items()},
                **{f"{p}_{w}_vs_fp64": c[f"{w}_vs_fp64"] for p, c in both.items()
                   for w in ("plain", "kernel") if f"{w}_vs_fp64" in c}}})
    # dh=64 (no model of the repo uses it) over more draws, both paths and the
    # plain version against fp64: the measurement behind BWD_ATOL_DH64
    for draw in range(DH64_DRAWS):
        bias = keypad_bias(torch, gen, B, 150)
        for p in ("sweep", "long"):
            cases[f"{p}_T150_h2_draw{draw}"] = compare(
                f"bwd_{p}_keypad_T150_h2_draw{draw}", B, 150, D, bias, 2, path=p, timed=False,
                fp64=True)
    # SASRec's causal bias at dh=16, where C2DSR's views put its encoder
    # (T=300; T=600 with InnerComp): both paths' device time wherever the
    # one-sweep kernel holds the shape, the long path's alone beyond
    for t in (*BWD_SWEEP_T, 600):
        paths = ("sweep", "long") if sweep_fits(t, 16) else ("long",)
        got = {p: compare(f"bwd_{p}_causal_T{t}_h8", B, t, D, causal(t), 8, path=p,
                          timed="device") for p in paths}
        ms = {p: c["device_ms"] for p, c in got.items()}
        emit({"bwd_crossover": {
            "T": t, "dh": 16, "bias": "causal", "route": backward_route(t, 16),
            "long_faster": long_faster(t, 16), "measured_faster": min(ms, key=ms.get),
            **{f"{p}_device_ms": v for p, v in ms.items()},
            **{f"{p}_max_abs_err": c["max_abs_err"] for p, c in got.items()}}})
    return cases


def scatter_kernel_phase(torch, gen):
    from amid_tpu_torch.ops.scatter import (
        scatter_set_unique, scatter_set_unique3, scatter_set_unique3_plain,
        scatter_set_unique_plain,
    )

    V, D = 2 * FLAGSHIP["item_length"], FLAGSHIP["emb_dim"]
    tabs = [torch.randn(V, D, device="cuda", generator=gen) for _ in range(3)]
    refs = [t.clone() for t in tabs]
    original = tabs[0].clone()
    cases = {}
    for U in (11264, 77824):
        # sorted unique ids with rows 0 and V-1, then a sentinel tail of V
        real = torch.randperm(V, device="cuda", generator=gen)[: U - U // 10]
        ids = torch.unique(torch.cat([real, torch.tensor([0, V - 1], device="cuda")]))
        n_real = ids.numel()
        ids = torch.cat([ids, torch.full((U - n_real,), V, device="cuda")]).to(torch.int32)
        rows = [torch.randn(U, D, device="cuda", generator=gen) for _ in range(3)]
        kept = ids[:n_real].long()
        kept_rows = [r[:n_real] for r in rows]

        scatter_set_unique3(*tabs, ids, *rows)
        scatter_set_unique3_plain(*refs, ids, *rows)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(tabs, refs)):
            require(torch.equal(a, b), f"scatter_set_unique3 U={U}: array {i} != plain")
        require(torch.equal(tabs[0][kept], rows[0][:n_real]), "scatter: written rows differ")
        untouched = torch.ones(V, dtype=torch.bool, device="cuda")
        untouched[kept] = False
        require(torch.equal(tabs[0][untouched], original[untouched]),
                f"scatter_set_unique3 U={U}: an untouched row changed")
        rec3 = {"case": f"scatter3_U{U}", "V": V, "D": D, "U": U, "rows_written": n_real,
                "max_abs_err": 0.0,
                **timings(torch, lambda: scatter_set_unique3(*tabs, ids, *rows), 50),
                "plain_ms": cuda_ms(
                    torch, lambda: scatter_set_unique3_plain(*refs, ids, *rows), 20),
                **timings(torch, lambda: [
                    t.index_copy_(0, kept, r) for t, r in zip(refs, kept_rows)], 50,
                    library=True)}
        rec3["bound_ms"], rec3["bound_by"] = scatter_bound(3, n_real, D, U)
        emit({"kernel_case_scatter": rec3})

        single = torch.randn(U, D, device="cuda", generator=gen)
        scatter_set_unique(tabs[1], ids, single)
        scatter_set_unique_plain(refs[1], ids, single)
        torch.cuda.synchronize()
        require(torch.equal(tabs[1], refs[1]), f"scatter_set_unique U={U} != plain")
        rec1 = {"case": f"scatter1_U{U}", "V": V, "D": D, "U": U, "rows_written": n_real,
                "max_abs_err": 0.0,
                **timings(torch, lambda: scatter_set_unique(tabs[1], ids, single), 50),
                "plain_ms": cuda_ms(
                    torch, lambda: scatter_set_unique_plain(refs[1], ids, single), 20),
                **timings(torch, lambda: refs[1].index_copy_(0, kept, single[:n_real]), 50,
                        library=True)}
        rec1["bound_ms"], rec1["bound_by"] = scatter_bound(1, n_real, D, U)
        emit({"kernel_case_scatter": rec1})
        original[kept] = rows[0][:n_real]  # what the timed calls left in tabs[0]
        cases[U] = {"scatter_set_unique3": rec3, "scatter_set_unique": rec1}
    return cases


def gather_kernel_phase(torch, gen):
    from amid_tpu_torch.ops.embedding import (
        embedding_gather, embedding_gather_many, embedding_gather_many_plain,
        embedding_gather_plain,
    )

    V, D = 2 * FLAGSHIP["item_length"], FLAGSHIP["emb_dim"]
    B = FLAGSHIP["batch_size"]
    table = torch.randn(V, D, device="cuda", generator=gen)

    def make_ids(*shape):
        ids = torch.randint(0, V, shape, device="cuda", generator=gen).to(torch.int32)
        ids.view(-1)[:2] = torch.tensor([0, V - 1], dtype=torch.int32, device="cuda")
        return ids

    def record(name, rows, got, want, kernel, plain, library):
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            require(g.shape == w.shape, f"gather {name}: shape {tuple(g.shape)}")
            require(torch.equal(g, w), f"gather {name}: kernel != plain")
        rec = {"case": name, "V": V, "D": D, "rows": rows, "max_abs_err": 0.0,
               **timings(torch, kernel, 50), "plain_ms": cuda_ms(torch, plain, 50),
               **timings(torch, library, 50, library=True)}
        rec["bound_ms"], rec["bound_by"] = gather_bound(rows, D)
        emit({"kernel_case_gather": rec})
        return rec

    cases = {}
    with torch.no_grad():
        # one lookup per launch
        for shape in ((B, 999), (B, 150), (B, 20)):
            ids = make_ids(*shape)
            flat = ids.reshape(-1)
            cases[shape[1]] = record(
                f"gather_{shape[0]}x{shape[1]}", flat.numel(),
                [embedding_gather(table, ids)], [embedding_gather_plain(table, ids)],
                lambda: embedding_gather(table, ids),
                lambda: embedding_gather_plain(table, ids),
                lambda: torch.index_select(table, 0, flat))
        # the model's groups: both sequences of a feature pass in one launch
        for t in (150, 20):
            pair = [make_ids(B, t), make_ids(B, t)]
            flat = torch.cat([i.reshape(-1) for i in pair])
            cases[f"pair{t}"] = record(
                f"gather_pair_{B}x{t}", flat.numel(),
                embedding_gather_many(table, pair), embedding_gather_many_plain(table, pair),
                lambda: embedding_gather_many(table, pair),
                lambda: embedding_gather_many_plain(table, pair),
                lambda: torch.index_select(table, 0, flat))
        # target and negatives into one [B, 1+K, D] block (evaluation, training)
        for k in (999, 1):
            group = [make_ids(B), make_ids(B, k)]
            flat = torch.cat([group[0][:, None], group[1]], dim=1).reshape(-1)
            got = embedding_gather_many(table, group, concat=True)
            require(tuple(got.shape) == (B, 1 + k, D) and got.is_contiguous(),
                    f"gather cand {k}: shape {tuple(got.shape)}")
            cases[f"cand{k}"] = record(
                f"gather_cand_{B}x{1 + k}", flat.numel(), [got],
                [embedding_gather_many_plain(table, group, concat=True)],
                lambda: embedding_gather_many(table, group, concat=True),
                lambda: embedding_gather_many_plain(table, group, concat=True),
                lambda: torch.index_select(table, 0, flat))
    # ids outside [0, V) are clamped, int64 ids and a narrow, unaligned table too
    wild = torch.tensor([-5, 0, V - 1, V, V + 7], device="cuda")
    clamped = torch.tensor([0, 0, V - 1, V - 1, V - 1], device="cuda")
    require(torch.equal(embedding_gather(table, wild), table[clamped]),
            "gather: out-of-range ids are not clamped")
    narrow = torch.randn(100, 7, device="cuda", generator=gen)
    ids = torch.randint(0, 100, (3, 5), device="cuda", generator=gen)
    require(torch.equal(embedding_gather(narrow, ids), narrow[ids]), "gather: narrow table")
    # backward: duplicated ids add up, within a lookup and across a group's lookups
    small = torch.randn(50, D, device="cuda", generator=gen, requires_grad=True)
    ids = torch.randint(0, 50, (64, 9), device="cuda", generator=gen)
    upstream = torch.randn(64, 9, D, device="cuda", generator=gen)
    (got_g,) = torch.autograd.grad(embedding_gather(small, ids), small, upstream)
    (want_g,) = torch.autograd.grad(embedding_gather_plain(small, ids), small, upstream)
    require(torch.allclose(got_g, want_g, atol=1e-5, rtol=1e-5), "gather: backward != plain")
    group = [ids[:, 0], ids[:, 1:].contiguous()]
    grads = [torch.autograd.grad((fn(small, group, concat=True) * upstream).sum(), small)[0]
             for fn in (embedding_gather_many, embedding_gather_many_plain)]
    require(torch.allclose(grads[0], want_g, atol=1e-5, rtol=1e-5)
            and torch.allclose(grads[1], want_g, atol=1e-5, rtol=1e-5),
            "gather: a group's backward != plain")
    return cases


# the gather's backward against its plain version in fp64: no further from it
# than the plain fp32 version (`index_add_`), give or take GRAD_SLACK. The
# padding row of left-padded histories sums tens of thousands of gradient
# rows, so either fp32 order parts from fp64 by up to about 1e-3 there
GRAD_SLACK = 1e-5


def kernel_parts_us(torch, fn, calls: int = 20) -> dict:
    """Device microseconds per call of each kernel `fn` launches, by name,
    from a `torch.profiler` trace of `calls` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    parts = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0:  # a kernel's name without its namespace, template and parameters
            m = re.search(r"(\w+)[<(]", ev.key)
            name = m.group(1) if m else ev.key
            parts[name] = parts.get(name, 0.0) + us / calls
    return parts


def gather_grad_kernel_phase(torch, gen):
    """The gather's backward (`embedding_gather_grad`) against its plain
    version at a training step's shapes, the 894,820-row table: both
    sequences of a T=150 and a T=20 step, left-padded histories (the padding
    row takes most of the rows), and target with one negative; then the lazy
    step's own shape, where the gradient goes to the [U, D] leaf of the
    step's unique rows (`train/lazy.py`, U = `_unique_budget`: 11,264 at
    T=20), both sequences of a T=20 step and target with a negative at their
    positions among those rows (`lazy_*` cases; the plain version is
    `index_add_` on a [U, D] table); two calls bit-equal, and equal bit for
    bit to `embedding_gather_grad_ordered` (the kernel's order in plain
    PyTorch). Library: `index_put_(accumulate=True)` (deterministic too),
    and beside it `index_add_` (atomics; `index_add_*` keys). Each case's
    `parts_us` is the device time of each kernel a call launches, from a
    `torch.profiler` trace (the tile pass and the row pass)."""
    from amid_tpu_torch.ops.embedding import (
        embedding_gather_grad, embedding_gather_grad_ordered, embedding_gather_grad_plain,
    )
    from amid_tpu_torch.train.lazy import _unique_budget

    V, D = 2 * FLAGSHIP["item_length"], FLAGSHIP["emb_dim"]
    B = FLAGSHIP["batch_size"]

    def padded(t):
        """[B, t] histories of lengths 1..t, left-padded with row 0."""
        ids = torch.randint(1, V, (B, t), device="cuda", generator=gen)
        lens = torch.randint(1, t + 1, (B, 1), device="cuda", generator=gen)
        pad = torch.arange(t, device="cuda")[None, :] < t - lens
        return torch.where(pad, 0, ids)

    cases = {}

    def case(name, ids, v):
        flat = ids.reshape(-1).to(torch.int32)
        g = torch.randn(flat.numel(), D, device="cuda", generator=gen)
        got, again = (embedding_gather_grad(flat, g, v) for _ in range(2))
        exact = embedding_gather_grad_plain(flat, g.double(), v)
        err = (got - exact).abs().max().item()
        plain_err = (embedding_gather_grad_plain(flat, g, v) - exact).abs().max().item()
        require(torch.equal(got, again), f"gather grad {name}: two calls differ")
        require(torch.equal(got, embedding_gather_grad_ordered(flat, g, v)),
                f"gather grad {name}: not the sums of embedding_gather_grad_ordered")
        require(err <= plain_err + GRAD_SLACK,
                f"gather grad {name}: {err} from fp64, the plain fp32 version {plain_err}")
        longest = int(torch.unique(flat, return_counts=True)[1].max())
        keys = flat.long()
        index_add = timings(torch, lambda: torch.zeros(v, D, device="cuda").index_add_(
            0, keys, g), 20, library=True)
        rec = {"case": f"gather_grad_{name}", "V": v, "D": D, "rows": flat.numel(),
               "longest_run": longest, "max_abs_err": err, "plain_max_abs_err": plain_err,
               "ordered_bit_equal": True,
               **timings(torch, lambda: embedding_gather_grad(flat, g, v), 20),
               "plain_ms": cuda_ms(torch, lambda: embedding_gather_grad_plain(flat, g, v), 20),
               **timings(torch, lambda: torch.zeros(v, D, device="cuda").index_put_(
                   (keys,), g, accumulate=True), 5, library=True),
               **{k.replace("library", "index_add"): x for k, x in index_add.items()},
               "parts_us": kernel_parts_us(torch, lambda: embedding_gather_grad(flat, g, v))}
        rec["bound_ms"], rec["bound_by"] = gather_grad_bound(flat.numel(), v, D)
        emit({"kernel_case_gather_grad": rec})
        cases[name] = rec

    for name, ids in (("pair150", torch.cat([padded(150), padded(150)], 1)),
                      ("pair20", torch.cat([padded(20), padded(20)], 1)),
                      ("cand2", torch.randint(0, V, (B, 2), device="cuda", generator=gen))):
        case(name, ids, V)
    # the lazy step: positions among the step's unique rows, a [U, D] leaf
    u = _unique_budget(B, 20, 1)
    seqs = torch.cat([padded(20), padded(20)], 1).reshape(-1)
    cand = torch.randint(0, V, (2 * B,), device="cuda", generator=gen)
    _, pos = torch.unique(torch.cat([cand, seqs]), return_inverse=True)
    require(int(pos.max()) < u, f"gather grad lazy: {int(pos.max()) + 1} rows, budget {u}")
    case("lazy_pair20", pos[cand.numel():], u)
    case("lazy_cand2", pos[:cand.numel()], u)
    # a narrow table, ids out of range (clamped), a run across many blocks
    ids = torch.cat([torch.full((1000,), 3, device="cuda"),
                     torch.tensor([-4, 0, 9, 12], device="cuda")])
    g = torch.randn(ids.numel(), 7, device="cuda", generator=gen)
    got = embedding_gather_grad(ids, g, 10)
    require(torch.allclose(got, embedding_gather_grad_plain(ids, g, 10), atol=1e-4)
            and torch.equal(got, embedding_gather_grad_ordered(ids, g, 10)),
            "gather grad: narrow table")  # row 3 sums 1,001 terms near 1
    return cases


def scoring_kernel_phase(torch, gen):
    from amid_tpu_torch.ops.scoring import (
        scoring_head, scoring_head_pair, scoring_head_pair_plain, scoring_head_plain,
    )

    B, D, H = FLAGSHIP["batch_size"], FLAGSHIP["emb_dim"], FLAGSHIP["hid_dim"]

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    fc1 = rand(H, 2 * D, scale=(2 * D) ** -0.5)  # the halves are views, as in the head
    params = (fc1[:, :D], fc1[:, D:], rand(H, scale=0.1), rand(1, H, scale=H ** -0.5),
              rand(1, scale=0.1))
    cases = {}
    for c in (1000, 2):
        user, other, items = rand(B, D), rand(B, D), rand(B, c, D)
        with torch.no_grad():
            got = scoring_head(user, items, *params)
            want = scoring_head_plain(user, items, *params)
            pair = scoring_head_pair(user, other, items, *params)
            want_pair = (want, scoring_head_plain(other, items, *params))
            torch.cuda.synchronize()
            for name, outs, wants, fn, plain, users in (
                    (f"scoring_C{c}", (got,), (want,),
                     lambda: scoring_head(user, items, *params),
                     lambda: scoring_head_plain(user, items, *params), 1),
                    (f"scoring_pair_C{c}", pair, want_pair,
                     lambda: scoring_head_pair(user, other, items, *params),
                     lambda: (scoring_head_plain(user, items, *params),
                              scoring_head_plain(other, items, *params)), 2)):
                err = max((g - w).abs().max().item() for g, w in zip(outs, wants))
                require(all(torch.isfinite(g).all().item() and tuple(g.shape) == (B, c)
                            for g in outs), f"{name}: non-finite output or wrong shape")
                require(err <= SCORE_ATOL, f"{name}: kernel vs plain max_abs_err {err}")
                rec = {"case": name, "shape": [B, c, D], "H": H, "users": users,
                       "max_abs_err": err, **timings(torch, fn, 50),
                       "plain_ms": cuda_ms(torch, plain, 20), "library_ms": None}
                rec["bound_ms"], rec["bound_by"] = scoring_bound(B, c, D, H, users)
                emit({"kernel_case_scoring": rec})
                cases[name] = rec
    # the gradients against autograd through the plain version (C=2, the
    # training shape; sums over B*C in another order): all seven of one user,
    # all eight of the pair (both users' terms summed into fc1)
    user, other, items = rand(B, D), rand(B, D), rand(B, 2, D)
    leaves = [x.detach().clone().requires_grad_()
              for x in (user, other, items, fc1, *params[2:])]

    def grads(fn, paired):
        u, o, it, w, b1, w2, b2 = leaves
        rest = (w[:, :D], w[:, D:], b1, w2, b2)
        if paired:
            o1, o2 = fn(u, o, it, *rest)
            loss = (o1 * o1).sum() + o2.sum()
        else:
            loss = (fn(u, it, *rest) ** 2).sum()
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    for paired, fn, plain in ((False, scoring_head, scoring_head_plain),
                              (True, scoring_head_pair, scoring_head_pair_plain)):
        for name, g, w in zip(("user", "other", "items", "fc1", "b1", "w2", "b2"),
                              grads(fn, paired), grads(plain, paired)):
            if w is None:  # the single head does not read `other`
                continue
            require(torch.allclose(g, w, atol=1e-5, rtol=1e-4),
                    f"scoring backward (pair={paired}): d{name} differs by "
                    f"{(g - w).abs().max().item()}")
    return cases


def affinity_compare(torch, name, fn, a, b, timed=True, iters=20):
    """One affinity kernel `fn` against `max_affinity_plain` at AFF_ATOL /
    AFF_RTOL; with `timed` its times, the plain version's, the library
    route's (chunked `matmul` + `amax` on bf16 inputs) and the bound. Emits
    a `kernel_case_affinity` record; returns it and the kernel's output."""
    from amid_tpu_torch.ops.affinity import max_affinity_plain, max_affinity_xla

    got, want = fn(a, b), max_affinity_plain(a, b)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    require(tuple(got.shape) == (a.shape[0], b.shape[0]), f"{name}: shape")
    require(torch.allclose(got, want, atol=AFF_ATOL, rtol=AFF_RTOL),
            f"{name}: kernel vs plain max_abs_err {err}")
    rec = {"case": name, "a": list(a.shape), "b": list(b.shape), "max_abs_err": err}
    if timed:
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        rec.update(timings(torch, lambda: fn(a, b), iters))
        rec["plain_ms"] = cuda_ms(torch, lambda: max_affinity_plain(a, b), 5)
        # several library calls: 32 chunked matmuls and amax reductions
        rec.update(timings(torch, lambda: max_affinity_xla(a16, b16), 5, library=True))
        rec["bound_ms"], rec["bound_by"] = affinity_bound(
            a.shape[0], b.shape[0], a.shape[1], b.shape[1], a.shape[2])
    emit({"kernel_case_affinity": rec})
    return rec, got


def affinity_kernel_phase(torch, gen):
    from amid_tpu_torch.ops.affinity import (
        max_affinity_blocked, max_affinity_smalln, smalln_faster,
    )

    D = FLAGSHIP["emb_dim"]

    def compare(name, fn, a, b, timed=True):
        return affinity_compare(torch, name, fn, a, b, timed)

    def pair(bsz, c, n, m, d=D):
        return (torch.randn(bsz, n, d, device="cuda", generator=gen),
                torch.randn(c, m, d, device="cuda", generator=gen))

    cases = {"max_affinity_blocked": {}, "max_affinity_smalln": {}}
    B = FLAGSHIP["batch_size"]
    a, b = pair(B, B, 150, 150)
    require(not smalln_faster(150), "smalln_faster(150) should be False")
    cases["max_affinity_blocked"][150], _ = compare("blocked_T150", max_affinity_blocked, a, b)
    # a batch smaller than the card: 16 query groups, 8 slices of the peers
    compare("blocked_T150_B64", max_affinity_blocked, *pair(64, 64, 150, 150))
    a, b = pair(B, B, 20, 20)
    require(smalln_faster(20), "smalln_faster(20) should be True")
    cases["max_affinity_blocked"][20], k6 = compare("blocked_T20", max_affinity_blocked, a, b)
    cases["max_affinity_smalln"][20], k7 = compare("smalln_T20", max_affinity_smalln, a, b)
    require(torch.equal(k6, k7), "blocked and small-N kernels differ at T=20")
    compare("blocked_T300", max_affinity_blocked, *pair(4, 6, 300, 300), timed=False)
    compare("blocked_11x13_T150", max_affinity_blocked, *pair(11, 13, 150, 150), timed=False)
    # both kernels, bit-equal: ragged batches (no padding rows), N != M, peers
    # that straddle bank tiles and slices, 8, 4 and 2 users a slot of K7,
    # one user against one long peer, every compiled width
    for name, shape, d in (("11x13", (11, 13, 20, 20), D), ("N33_M9", (5, 7, 33, 9), D),
                           ("37x300_N20_M9", (37, 300, 20, 9), D),
                           ("N80_M20", (256, 256, 80, 20), D), ("N7_M64", (3, 5, 7, 64), D),
                           ("N1_M150", (1, 1, 1, 150), D), ("N17_M24_D16", (3, 4, 17, 24), 16),
                           ("N40_M48_D64", (9, 5, 40, 48), 64)):
        a, b = pair(*shape, d=d)
        _, k6 = compare(f"blocked_{name}", max_affinity_blocked, a, b, timed=False)
        _, k7 = compare(f"smalln_{name}", max_affinity_smalln, a, b, timed=False)
        require(torch.equal(k6, k7), f"blocked and small-N kernels differ at {name}")
    return cases


def affinity_crossover_sweep(torch, gen):
    """The dispatch's crossover: both affinity kernels' device time at
    B=C=256, D=128 and N=M of SMALLN_SWEEP, bit-equal (`affinity_crossover`
    records: the numbers behind `ops/affinity.py::smalln_faster`). Run by
    `tools/route_sweeps.py`, not by `main`."""
    from amid_tpu_torch.ops.affinity import (
        max_affinity_blocked, max_affinity_smalln, smalln_faster,
    )

    B, D = FLAGSHIP["batch_size"], FLAGSHIP["emb_dim"]

    def pair(bsz, c, n, m, d=D):
        return (torch.randn(bsz, n, d, device="cuda", generator=gen),
                torch.randn(c, m, d, device="cuda", generator=gen))

    for n in SMALLN_SWEEP:
        a, b = pair(B, B, n, n)
        k6, k7 = max_affinity_blocked(a, b), max_affinity_smalln(a, b)
        torch.cuda.synchronize()
        require(torch.equal(k6, k7), f"blocked and small-N kernels differ at N=M={n}")
        rec = {"n": n, "m": n,
               "blocked_device_ms": graph_ms(torch, lambda: max_affinity_blocked(a, b)),
               "smalln_device_ms": graph_ms(torch, lambda: max_affinity_smalln(a, b)),
               "smalln_faster": smalln_faster(n)}
        rec["smalln_was_faster"] = rec["smalln_device_ms"] < rec["blocked_device_ms"]
        emit({"affinity_crossover": rec})


# ---------------------------------------------------------------------------
# phase 3: the serving path at full width
# ---------------------------------------------------------------------------

def make_batch(cfg, rng):
    """User histories of random length 1..T, left-padded with pad_id
    (data/packed.py::seq_pad_trunc); d1 and d2 ids from their halves of the
    shared table."""
    b, t = cfg.batch_size, cfg.seq_len
    ranges = {"seq_d1": (0, cfg.item_length),
              "seq_d2": (cfg.item_length + 2, cfg.item_table_size)}
    batch = {}
    for key, (lo, hi) in ranges.items():
        seqs = np.full((b, t), cfg.pad_id, np.int64)
        for row, n in enumerate(rng.integers(1, t + 1, b)):
            seqs[row, t - n:] = rng.integers(lo, hi, n)
        batch[key] = seqs
    return batch


GATED = ("itc_d1", "itc_d2")  # the InterComp modules of the run.sh model


def opened_threshold(probs):
    """(threshold, reachable): a gate threshold at which between 5% and 95%
    of `probs` (softmax values over 256 peers) are open, and whether one
    exists. First the uniform share 1/256, divided by 4 until enough gates
    open; failing that, the midpoint between neighbouring distinct values
    whose share of open gates is inside, the widest relative gap first, so
    that no probability lies near the threshold. Where ties leave no share
    inside (BERT4Rec's InterComp sees the raw embeddings, where every
    left-padded user's affinity is the pad row's own product, |e_pad|^2),
    the midpoint whose share lies nearest 1/2."""
    thr = 1.0 / probs.shape[-1]
    for _ in range(16):
        if OPEN_SHARE[0] <= (probs > thr).float().mean().item() <= OPEN_SHARE[1]:
            return thr, True
        thr /= 4.0
    flat = probs.flatten().double().sort().values
    s = flat.unique()
    require(s.numel() > 1, "every gate probability is the same: no threshold opens some")
    mids = (s[:-1] + s[1:]) / 2
    share = 1.0 - torch_searchsorted_share(flat, mids)
    gap = (s[1:] - s[:-1]) / s[1:]
    inside = (share >= OPEN_SHARE[0]) & (share <= OPEN_SHARE[1])
    if bool(inside.any()):
        return float(mids[int(gap.where(inside, -1.0).argmax())]), True
    return float(mids[int((share - 0.5).abs().argmin())]), False


def torch_searchsorted_share(sorted_flat, values):
    """The share of `sorted_flat` at or below each of `values`."""
    import torch

    return torch.searchsorted(sorted_flat, values, right=True).double() / sorted_flat.numel()


def as_plain_reference(ref):
    """Gives a kernels='torch' model the affinity kernels' arithmetic (bf16
    inputs, fp32 sums) in plain PyTorch, so that its pairwise gates are the
    reference of the kernel model's."""
    from amid_tpu_torch.ops.affinity import max_affinity_plain

    for name in GATED:
        getattr(ref, name).message.affinity = max_affinity_plain
    return ref


def gated_pass(model, batch):
    """`serve.user_representations` of `model` on `batch` and the inputs of
    its InterComp modules (GATED), by name."""
    from amid_tpu_torch.serve import user_representations

    inputs = {}
    hooks = [getattr(model, name).register_forward_hook(
        lambda mod, args, out, name=name: inputs.__setitem__(name, args)) for name in GATED]
    feats = user_representations(model, batch)
    for h in hooks:
        h.remove()
    return feats, inputs


def gates(model, inputs):
    """The InterComp gate decisions of `model` at the inputs `gated_pass` saw."""
    return {n: getattr(model, n).message.gate(*a) for n, a in inputs.items()}


def feature_check(torch, model, ref, batch, label):
    """Runs the feature pass on both models and compares InterComp gates
    first and then the features, twice: at the configured threshold, and at
    one chosen so that gates really open and close. Returns the kernel
    model's features and its first pass's launch counts."""
    from amid_tpu_torch.ops.affinity import max_affinity_xla

    def compare(tag):
        reset_counts()
        feats, inputs = gated_pass(model, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        ref_feats, ref_inputs = gated_pass(ref, batch)
        got, want = gates(model, inputs), gates(ref, ref_inputs)
        shares = {}
        for name in got:
            same = torch.equal(got[name], want[name])
            shares[name] = want[name].mean().item()
            emit({"intercomp_gate": {
                "pass": tag, "module": name, "equal": same,
                "threshold": getattr(ref, name).message.threshold,
                "gates": want[name].numel(), "open": int(got[name].sum().item()),
                "open_plain": int(want[name].sum().item()), "open_share": shares[name],
                "differing": int((got[name] != want[name]).sum().item())}})
            require(same, f"{tag}: InterComp gate flip in {name} between the kernel "
                          f"and plain models (a flip changes a user's message)")
        errs = [(f - r).abs().max().item() for f, r in zip(feats, ref_feats)]
        for f in feats:
            require(tuple(f.shape) == (model.cfg.batch_size, model.cfg.emb_dim),
                    f"{tag}: feature shape {tuple(f.shape)}")
            require(torch.isfinite(f).all().item(), f"{tag}: non-finite features")
        emit({"features": {"pass": tag, "max_abs_err_vs_plain": errs}})
        require(max(errs) <= FEATURE_TOL, f"{tag}: features differ from plain by {errs}")
        return feats, counts, ref_inputs, shares

    feats, counts, ref_inputs, _ = compare(label)

    # InterComp's inputs do not depend on its threshold: choose the opened
    # threshold from the plain model's probabilities, set it on both models,
    # and compare again. Where ties leave no share between 5% and 95%, some
    # gates must still be open and some closed.
    configured = {n: getattr(ref, n).message.threshold for n in GATED}
    probs = {n: getattr(ref, n).message.gate_probabilities(*ref_inputs[n]) for n in GATED}
    try:
        reachable = {}
        for n in GATED:
            thr, reachable[n] = opened_threshold(probs[n])
            getattr(model, n).message.threshold = getattr(ref, n).message.threshold = thr
        _, _, _, shares = compare(f"{label}_opened")
        for n, share in shares.items():
            if not reachable[n]:
                emit({"opened_threshold_tied": {"pass": f"{label}_opened", "module": n,
                                                "open_share": share}})
            require(OPEN_SHARE[0] <= share <= OPEN_SHARE[1] if reachable[n] else 0 < share < 1,
                    f"{label}: open share {share} of {n} at the opened threshold")
        if not model.cfg.comp_broadcast_quirk:
            # information only: the numerics change of bf16 inputs, seen as
            # gates that differ from those of the fp32 affinity
            for n in GATED:
                msg = getattr(ref, n).message
                fp32 = torch.softmax(max_affinity_xla(*ref_inputs[n]), dim=1) > msg.threshold
                emit({"bf16_vs_fp32_gates": {
                    "pass": f"{label}_opened", "module": n, "gates": fp32.numel(),
                    "differing": int((fp32 != (probs[n] > msg.threshold)).sum().item())}})
    finally:
        for n in GATED:
            getattr(model, n).message.threshold = configured[n]
            getattr(ref, n).message.threshold = configured[n]
    return feats, counts


def dense_topk(torch, u, table, head, k):
    w1, b1 = head["fc1.weight"], head["fc1.bias"]
    w2, b2 = head["fc2.weight"][0], head["fc2.bias"][0]
    d = u.shape[1]
    hidden = torch.relu((u @ w1[:, :d].T)[:, None, :] + (table @ w1[:, d:].T)[None] + b1)
    scores = torch.sigmoid(hidden @ w2 + b2)  # [n, V]
    return scores, torch.topk(scores, k, dim=1).values


def serve_check(torch, cfg, batch, label, topk=False):
    """One serving configuration on the card: `serve.user_representations`
    of a kernels='cuda' model against a kernels='torch' model from the same
    weights (`feature_check`; under `--bf16` `bf16_feature_check`; in
    pairwise mode the plain model's affinity is `max_affinity_plain`), its
    launches, and with `topk`
    `serve.full_catalog_topk` at k=100 for both domains over the whole
    table against a dense oracle for 8 users."""
    from amid_tpu_torch.models.amid import build_model
    from amid_tpu_torch.serve import user_representations

    model = build_model(cfg, seed=0)  # default device: cuda
    require(model.cfg.kernels == "cuda", f"kernels resolved to {model.cfg.kernels}")
    ref = build_model(dataclasses.replace(cfg, kernels="torch"), device="cuda")
    ref.load_state_dict(model.state_dict())
    if not cfg.comp_broadcast_quirk:
        as_plain_reference(ref)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    if cfg.use_bf16:
        (u_d1, u_d2), counts, gaps = bf16_feature_check(torch, model, ref, batch, label)
    else:
        ((u_d1, u_d2), counts), gaps = feature_check(torch, model, ref, batch, label), {}
    want = expected_launches(model.cfg, feature_passes=1)
    require(counts == want, f"{label}: feature pass launches {counts}, want {want}")
    rec = {"backbone": cfg.backbone, "T": cfg.seq_len, "pairwise": not cfg.comp_broadcast_quirk,
           "launches": counts, **gaps,
           "feature_ms": cuda_ms(torch, lambda: user_representations(model, batch), 10)}
    if topk:
        rec.update(topk_check(torch, model, (u_d1, u_d2), label))
    emit({"main_path": {"config": label, **rec}})
    del model, ref
    torch.cuda.empty_cache()
    return rec


def topk_check(torch, model, feats, label):
    """`serve.full_catalog_topk` at k=100 for both domains' features over the
    whole table against a dense oracle for 8 users, and its time."""
    from amid_tpu_torch.serve import full_catalog_topk

    table = model.item_embedding.detach()
    head = model.predict.state_dict()
    k = 100
    for dom, u in zip(("d1", "d2"), feats):
        scores, ids = full_catalog_topk(u, table, head, k=k)
        require(tuple(scores.shape) == (model.cfg.batch_size, k), f"{label} {dom}: top-k shape")
        require(torch.isfinite(scores).all().item(), f"{label} {dom}: non-finite top-k")
        require(bool((ids >= 0).all() and (ids < table.shape[0]).all()),
                f"{label} {dom}: item id out of range")
        dense, want_k = dense_topk(torch, u[:8], table, head, k)
        require(torch.allclose(scores[:8], want_k, rtol=TOPK_RTOL, atol=TOPK_ATOL),
                f"{label} {dom}: top-k scores differ from the dense oracle")
        # ids may differ from the oracle's only where scores tie
        require(torch.allclose(torch.gather(dense, 1, ids[:8]), want_k,
                               rtol=TOPK_RTOL, atol=TOPK_ATOL),
                f"{label} {dom}: top-k ids are not the dense oracle's")
    return {"catalog_rows": table.shape[0],
            "catalog_ms_per_domain": cuda_ms(
                torch, lambda: full_catalog_topk(feats[0], table, head, k=k), 5),
            "topk_vs_dense_oracle": "match (8 users, both domains)"}


def bf16_feature_check(torch, model, ref, batch, label):
    """The feature pass of a `--bf16` kernels='cuda' model against a
    kernels='torch' bf16 model from the same weights: the kernels round where
    the plain version does not, so at BF16_FEATURE_TOL of the features'
    largest value, over the users whose InterComp gates agree (the gates
    that differ are counted). Returns the kernel model's features, its
    launch counts and the comparison's record."""
    n_users, width = model.cfg.batch_size, model.cfg.emb_dim
    with torch.no_grad():
        reset_counts()
        feats, inputs = gated_pass(model, batch)
        torch.cuda.synchronize()
        counts = read_counts()
        ref_feats, ref_inputs = gated_pass(ref, batch)
        got, want = gates(model, inputs), gates(ref, ref_inputs)
    # a user whose gate decisions all agree in both modules
    agree = torch.ones(n_users, dtype=torch.bool, device="cuda")
    for n in GATED:
        agree &= (got[n] == want[n]).reshape(n_users, -1).all(dim=1)
    scale = max(r.abs().max().item() for r in ref_feats)
    gap = max((f[agree] - r[agree]).abs().max().item() for f, r in zip(feats, ref_feats))
    for f in feats:
        require(tuple(f.shape) == (n_users, width) and torch.isfinite(f).all().item(),
                f"{label}: feature shape {tuple(f.shape)} or non-finite features")
    require(int(agree.sum()) > 0 and gap <= BF16_FEATURE_TOL * scale,
            f"{label}: bf16 features {gap} from plain's (largest {scale}) over "
            f"{int(agree.sum())} users")
    return feats, counts, {
        "feature_gap": gap, "feature_scale": scale, "users_gates_agree": int(agree.sum()),
        "gates_differing": {n: int((got[n] != want[n]).sum()) for n in GATED}}


def main_path_phase(torch, rng):
    from amid_tpu_torch.config import ModelConfig

    results = {}
    cfg = ModelConfig(**FLAGSHIP)
    for t, pairwise in ((150, False), (20, False), (20, True), (150, True)):
        label = f"T{t}_pairwise" if pairwise else f"T{t}"
        cfg_t = dataclasses.replace(cfg, seq_len=t, comp_broadcast_quirk=not pairwise)
        results[label] = serve_check(torch, cfg_t, make_batch(cfg_t, rng), label,
                                     topk=t == 150 and not pairwise)
    return results


# ---------------------------------------------------------------------------
# phase 4: the training path at full width
# ---------------------------------------------------------------------------

def rel_to_max(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()


def make_steps(cfg, tcfg, kernels, fused_scatter=True):
    """A fresh model (seed 0) of `kernels` with its state and its phase-A,
    phase-B and evaluation steps, as `run_seed` builds them (C2DSR's phase A
    with `cl_w`; in pairwise mode a kernels='torch' model takes its affinity
    from `max_affinity_plain`)."""
    from amid_tpu_torch.models.amid import build_model
    from amid_tpu_torch.train import lazy, steps
    from amid_tpu_torch.train.optim import Adam

    model = build_model(dataclasses.replace(cfg, kernels=kernels), device="cuda", seed=0)
    if not cfg.comp_broadcast_quirk and kernels == "torch":
        as_plain_reference(model)
    tx, tx2 = Adam(tcfg.lr), Adam(tcfg.lr * tcfg.lr2)
    if tcfg.lazy_table_adam:
        state = lazy.init_lazy_state(dict(model.named_parameters()), tx, tx2)
        step_a = lazy.make_lazy_train_step(model, tx, dr_e_w=tcfg.dr_e_w,
                                           fused_scatter=fused_scatter)
        step_b = lazy.make_lazy_dr_r_step(model, tx2, fused_scatter=fused_scatter)
    else:
        state = steps.init_state(model, tx, tx2)
        step_a = steps.make_train_step(model, tx, dr_e_w=tcfg.dr_e_w,
                                       c2dsr_w=tcfg.cl_w if cfg.is_c2dsr else None)
        step_b = steps.make_dr_r_step(model, tx2)
    return model, state, step_a, step_b, steps.make_eval_step(model, tcfg.data.neg_nums)


DENSE_PARAM = {"sasrec": "enc_d1.attn.0.in_proj_weight",  # one encoder weight a backbone
               "bert4rec": "enc_d1.block.0.q.weight", "gru4rec": "enc_d1.gru.w_hh"}


def moments_of(state, slot, lazy_adam, dense_name):
    """The table's moments and one dense parameter's of optimizer `slot`."""
    opt = state.opt_state if slot == 1 else state.opt_state2
    if lazy_adam:
        return {"table_mu": opt.mu, "table_nu": opt.nu,
                "dense_mu": opt.dense_opt.mu[dense_name],
                "dense_nu": opt.dense_opt.nu[dense_name]}
    return {"table_mu": opt.mu["item_embedding"], "table_nu": opt.nu["item_embedding"],
            "dense_mu": opt.mu[dense_name], "dense_nu": opt.nu[dense_name]}


def step_checks(torch, cfg, tcfg, train_ds, val_ds, dr_ds, label):
    """One phase-A step, one phase-B step and one evaluation batch of a
    kernels='cuda' model against a kernels='torch' model from the same state,
    batch and key (in pairwise mode the plain model takes its affinity from
    `max_affinity_plain`); launch counts per step; ms per step."""
    from amid_tpu_torch.data.loader import BatchIterator
    from amid_tpu_torch.train import lazy
    from amid_tpu_torch.train.loop import _device_pools, _to_device

    is_lazy = tcfg.lazy_table_adam
    pairwise = not cfg.comp_broadcast_quirk

    def launches(**kw):
        return expected_launches(cfg, lazy_adam=is_lazy, **kw)

    def make(kernels, fused_scatter=True):
        return make_steps(cfg, tcfg, kernels, fused_scatter)

    t0 = time.perf_counter()
    model, state, step_a, step_b, eval_step = make("cuda")
    ref, rstate, rstep_a, rstep_b, reval_step = make("torch")
    ref.load_state_dict(model.state_dict())
    require(model.cfg.kernels == "cuda" and ref.cfg.kernels == "torch", "kernel routes")

    bs = cfg.batch_size
    batches = {name: [_to_device(b, "cuda") for b in BatchIterator(ds, bs, False)]
               for name, ds in (("train", train_ds), ("val", val_ds), ("dr", dr_ds))}
    pools = {name: _device_pools(ds, "cuda")
             for name, ds in (("train", train_ds), ("val", val_ds), ("dr", dr_ds))}
    dense_name = DENSE_PARAM[cfg.backbone]
    rec = {"config": label}

    def moments(st, slot):
        return moments_of(st, slot, is_lazy, dense_name)

    for phase, slot, split, fn, rfn, key in (("A", 1, "train", step_a, rstep_a, 1234),
                                            ("B", 2, "dr", step_b, rstep_b, 4321)):
        batch = batches[split][0]
        before = model.item_embedding.detach().clone()
        reset_counts()
        _, m = fn(state, batch, *pools[split], key)
        torch.cuda.synchronize()
        counts = read_counts()
        _, rm = rfn(rstate, batch, *pools[split], key)
        torch.cuda.synchronize()
        require(read_counts() == counts, f"{label} phase {phase}: the plain model launched a kernel")
        want = launches(train_steps=1, c2dsr_steps=int(phase == "A" and cfg.is_c2dsr))
        require(counts == want, f"{label} phase {phase}: launches {counts}, want {want}")
        for k, v in m.items():
            require(math.isfinite(float(v)), f"{label} phase {phase}: {k} = {float(v)}")
            require(losses_agree(k, float(v), rm),
                    f"{label} phase {phase}: {k} {float(v)} vs plain {float(rm[k])}")
        require(float(m["nonfinite"]) == 0.0, f"{label} phase {phase}: non-finite flag")
        if phase == "A":
            rec["first_loss_cls"] = float(m["loss_cls"])
            require(abs(rec["first_loss_cls"] - math.log(2)) <= LN2_TOL,
                    f"{label}: first loss_cls {rec['first_loss_cls']} is not near ln 2")
        if is_lazy:
            require(model.item_embedding.grad is None, f"{label}: the table took a gradient")
        moved = (model.item_embedding.detach() != before).any(dim=1)
        n_moved = int(moved.sum())
        # the rows a step touches: the lazy budget's, and C2DSR's corrupted items
        touched = lazy._unique_budget(bs, cfg.seq_len, 1) + bs * cfg.seq_len * (
            phase == "A" and cfg.is_c2dsr)
        require(0 < n_moved <= touched, f"{label} phase {phase}: {n_moved} table rows moved")
        shares = {}
        for name, got_p, want_p in (
                ("touched_table_rows", model.item_embedding.detach()[moved],
                 ref.item_embedding.detach()[moved]),
                (dense_name, dict(model.named_parameters())[dense_name].detach(),
                 dict(ref.named_parameters())[dense_name].detach())):
            share = ((got_p - want_p).abs() > UPDATE_ATOL).float().mean().item()
            require(share <= UPDATE_SHARE,
                    f"{label} phase {phase}: {share:.2e} of {name} differ from plain")
            shares[name] = share
        rels = {k: rel_to_max(v, moments(rstate, slot)[k])
                for k, v in moments(state, slot).items()}
        require(max(rels.values()) <= MOMENT_TOL,
                f"{label} phase {phase}: moments differ from plain: {rels}")
        rec[f"phase_{phase}"] = {"launches": counts, "rows_moved": n_moved,
                                 "losses": {k: float(v) for k, v in m.items()},
                                 "plain_losses": {k: float(v) for k, v in rm.items()},
                                 "update_mismatch_share": shares, "moment_rel_err": rels}

    # one evaluation batch
    vb = batches["val"][0]
    reset_counts()
    ev = eval_step(vb, *pools["val"], 99)
    torch.cuda.synchronize()
    counts = read_counts()
    rev = reval_step(vb, *pools["val"], 99)
    require(counts == launches(eval_batches=1), f"{label} eval: launches {counts}")
    require(abs(float(ev["loss_cls"]) - float(rev["loss_cls"])) <= LOSS_TOL,
            f"{label} eval: loss {float(ev['loss_cls'])} vs plain {float(rev['loss_cls'])}")
    ranks = ev["ranks_fixed"]
    require(tuple(ranks.shape) == (bs,) and bool((ranks >= 0).all())
            and bool((ranks <= tcfg.data.neg_nums).all()), f"{label} eval: ranks out of range")
    rec["eval"] = {"launches": counts, "loss_cls": float(ev["loss_cls"]),
                   "ranks_equal_share": (ranks == rev["ranks_fixed"]).float().mean().item()}

    if is_lazy:  # the three-launch control of the same step
        model3, state3, step3, _, _ = make("cuda", fused_scatter=False)
        reset_counts()
        step3(state3, batches["train"][0], *pools["train"], 1234)
        torch.cuda.synchronize()
        counts = read_counts()
        require(counts == launches(train_steps=1, fused_scatter=False),
                f"{label} fused_scatter=False: launches {counts}")
        rec["unfused_launches"] = counts
        del model3, state3, step3

    # ms per step, CUDA events after warm-up, cycling over the batches
    def cycle(fn, st, split, n):
        it = iter(range(10**9))
        return lambda: fn(st, batches[split][next(it) % n], *pools[split], 7)

    rec["phase_a_ms"] = cuda_ms(torch, cycle(step_a, state, "train", len(batches["train"])), 6, 2)
    rec["phase_b_ms"] = cuda_ms(torch, cycle(step_b, state, "dr", len(batches["dr"])), 6, 2)
    rec["eval_batch_ms"] = cuda_ms(
        torch, lambda: eval_step(batches["val"][0], *pools["val"], 7), 6, 2)
    rec["seconds"] = time.perf_counter() - t0
    emit({"train_steps": rec})
    return rec


def graph_checks(torch, cfg, tcfg, train_ds, val_ds, dr_ds, label, exact=False,
                 evaluate=True):
    """The fast loops' graphs against eager steps: GRAPH_STEPS steps of phase
    A, then of phase B, through a resident chunk runner (the first eager, the
    second captured and replayed, then replays), then (with `evaluate`) two
    evaluation passes over the val batches (graph replays) against the eval
    step batch by batch, on that model; then the same steps of a second
    kernels='cuda' model taken eagerly from the same state, batches and
    keys. Losses within LOSS_TOL (`losses_agree`), moments within
    MOMENT_TOL of their largest value; with `exact`, losses and moments
    bit-equal (every sum of a dense step runs in a fixed order, the gather's
    backward included). The replayed model is freed, but for the moments
    compared, before the eager one is built: at configuration (d)'s width
    two models and a captured step do not fit the card together."""
    from amid_tpu_torch.ops.rng import fold_in
    from amid_tpu_torch.train import steps
    from amid_tpu_torch.train.graphs import GraphPool
    from amid_tpu_torch.train.loop import STEP_KEYS, _device_pools, _resident

    bs = cfg.batch_size
    is_lazy = tcfg.lazy_table_adam
    dense_name = DENSE_PARAM[cfg.backbone]
    t0 = time.perf_counter()
    gmodel, gst, ga, gb, geval = make_steps(cfg, tcfg, "cuda")
    pool = GraphPool("cuda")
    rec = {"config": label}
    replayed = []  # per phase: its data, each step's losses, the moments after it
    try:
        for phase, slot, ds, gstep in (("A", 1, train_ds, ga), ("B", 2, dr_ds, gb)):
            arrays = _resident(ds.batch_arrays(), "cuda")
            pools = _device_pools(ds, "cuda")
            order = np.random.default_rng(slot).permutation(len(ds))[:GRAPH_STEPS * bs]
            perm = torch.as_tensor(order.astype(np.int32), device="cuda")
            runner = steps.make_resident_chunk_runner(gstep, bs, pool)
            losses = []
            for i in range(GRAPH_STEPS):
                _, m0, nf = runner(gst, arrays, perm, *pools, 77, range(i, i + 1),
                                   range(i, i + 1))
                require(float(nf) == 0.0, f"{label} graph phase {phase}: non-finite flag")
                losses.append({k: float(v) for k, v in m0.items()})
            graph = pool.graphs[-1]
            require(graph.replays == GRAPH_STEPS - 1,
                    f"{label} graph phase {phase}: {graph.replays} replays")
            moments = moments_of(gst, slot, is_lazy, dense_name)
            replayed.append((phase, slot, ds, order, losses, moments))
            rec[f"phase_{phase}"] = {"replays": graph.replays,
                                     "launches_per_replay": graph.captured}
        if evaluate:
            vpools = _device_pools(val_ds, "cuda")
            nb = len(val_ds) // bs
            idx = np.arange(nb * bs).reshape(nb, bs)
            stacked = {k: torch.as_tensor(v[idx], device="cuda")
                       for k, v in val_ds.batch_arrays().items() if k in STEP_KEYS}
            eval_all = steps.make_scanned_eval(gmodel, tcfg.data.neg_nums, pool)
            diffs, same = [], []
            for key in (10_000, 30_000):
                got = {k: v.clone() for k, v in eval_all(stacked, *vpools, key).items()}
                for i in range(nb):
                    want = geval({k: v[i] for k, v in stacked.items()}, *vpools,
                                 fold_in(key, i))
                    diffs.append(abs(float(got["loss_cls"][i]) - float(want["loss_cls"])))
                    same.append(
                        (got["ranks_fixed"][i] == want["ranks_fixed"]).float().mean().item())
            require(max(diffs) <= LOSS_TOL, f"{label} graph eval: loss differs by {max(diffs)}")
            require(min(same) >= RANKS_EQUAL_SHARE, f"{label} graph eval: ranks equal {min(same)}")
            rec["eval"] = {"loss_diff": max(diffs), "ranks_equal_share": min(same),
                           "replays": pool.graphs[-1].replays}
    finally:
        pool.close()
    del gmodel, gst, ga, gb, geval
    torch.cuda.empty_cache()
    _, est, ea, eb, _ = make_steps(cfg, tcfg, "cuda")
    for (phase, slot, ds, order, losses, moments), estep in zip(replayed, (ea, eb)):
        arrays = _resident(ds.batch_arrays(), "cuda")
        pools = _device_pools(ds, "cuda")
        perm = torch.as_tensor(order.astype(np.int32), device="cuda")
        diffs = []
        for i, m0 in enumerate(losses):
            batch = {k: v.index_select(0, perm[i * bs:(i + 1) * bs]) for k, v in arrays.items()}
            _, m = estep(est, batch, *pools, fold_in(77, i))
            diffs.append(max(abs(v - float(m[k])) for k, v in m0.items()))
            require(all(losses_agree(k, v, m) for k, v in m0.items())
                    and not (exact and diffs[-1] > 0.0),
                    f"{label} graph phase {phase} step {i}: replayed vs eager {m0} {m}")
        eager = moments_of(est, slot, is_lazy, dense_name)
        rels = {k: rel_to_max(v, eager[k]) for k, v in moments.items()}
        require(max(rels.values()) <= (0.0 if exact else MOMENT_TOL),
                f"{label} graph phase {phase}: moments differ from eager: {rels}")
        rec[f"phase_{phase}"].update(loss_diff=diffs, moment_rel_err=rels)
    rec["seconds"] = time.perf_counter() - t0
    emit({"graph_steps": rec})
    return rec


GRAPH_DRAWS = 3  # graph_draws: data draws of BERT4Rec T=150 per forward path


def graph_draws(torch, cfg, tcfg, label):
    """`graph_checks`' steps (no evaluation) of BERT4Rec at T=150 (encoder
    T=300, dh=32) on GRAPH_DRAWS more data draws, each with the forward on
    the long kernel (`forward_route`'s choice at this length) and on the
    one-head kernel (the route's table cleared for the call): replayed and
    eager steps bit-equal, whatever the data."""
    from amid_tpu_torch.data.synthetic import synth_packed
    from amid_tpu_torch.models.amid import head_width
    from amid_tpu_torch.ops import attention

    table = attention.LONG_FWD_FASTER_FROM
    out = {}
    for draw in range(GRAPH_DRAWS):
        rng = np.random.default_rng((3, draw))
        train_ds, val_ds, dr_ds = (synth_packed(cfg, rng, n)
                                   for n in (TRAIN_ROWS, VAL_ROWS, DR_ROWS))
        for path in ("long", "sweep"):
            attention.LONG_FWD_FASTER_FROM = table if path == "long" else {
                mode: {} for mode in table}
            try:
                require(attention.forward_route(cfg.enc_seq_len, head_width(cfg)) == path,
                        f"{label}: the forward route is not {path}")
                out[f"draw{draw}_{path}"] = graph_checks(
                    torch, cfg, tcfg, train_ds, val_ds, dr_ds, f"{label}_draw{draw}_{path}",
                    exact=True, evaluate=False)
            finally:
                attention.LONG_FWD_FASTER_FROM = table
            torch.cuda.empty_cache()
    return out


def step_timing(torch, cfg, tcfg, ds, label, timed_steps=TIMED_STEPS):
    """Wall ms, device ms and the device's idle share per step kind, eager
    (the per-step loop's steps) and replayed (the fast loops' graphs), from
    `profile_step.py`'s `step_kinds` and `measure` on a fresh model each,
    over `timed_steps` steps (a replay chunk: 16). Nothing (None) unless
    STEP_TIMING is on (`tools/step_timings.py`)."""
    from amid_tpu_torch.profile_step import measure, step_kinds
    from amid_tpu_torch.train.graphs import GraphPool

    if not STEP_TIMING:
        return None
    out = {}
    t0 = time.perf_counter()
    for fast in (False, True):
        pool = GraphPool("cuda") if fast else None
        loop_name = "replayed" if fast else "eager"
        try:
            for kind, (fn, per_call) in step_kinds(cfg, tcfg, ds, fast, pool).items():
                rec = measure(fn, per_call, -(-timed_steps // per_call), top=6)
                if rec["device_ms_per_step"] <= 0.0:  # the trace saw no kernel
                    rec.update(device_ms_per_step=None, device_idle_share=None,
                               note="device time not measured: the trace holds none")
                    require(not fast, f"{label} {kind}: the trace of eager steps is empty")
                emit({"step_timing": {"config": label, "step": kind, "loop": loop_name,
                                      **rec}})
                out[f"{kind}_{loop_name}"] = rec
        finally:
            if pool is not None:
                pool.close()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    emit({"step_timing_seconds": {"config": label, "seconds": out["seconds"]}})
    return out


def check_run(label, cfg, lazy_adam, counts, metrics, extra,
              rows=(TRAIN_ROWS, DR_ROWS, VAL_ROWS)):
    """Launch counts and metrics of one whole run of the DR schedule (phase
    A, evaluation, phase B, evaluation) over `rows` (train, DR, val)."""
    n_a, n_b, n_ev = (n // FLAGSHIP["batch_size"] for n in rows)
    want = expected_launches(cfg, train_steps=n_a + n_b, eval_batches=2 * n_ev,
                             lazy_adam=lazy_adam, c2dsr_steps=n_a if cfg.is_c2dsr else 0)
    require(counts == want, f"{label}: launches {counts}, want {want}")
    shown = ("hit_10_d1", "hit_10_d2", "ndcg_10_d1", "ndcg_10_d2", "mrr_d1", "mrr_d2")
    for k in shown:
        require(k in metrics and math.isfinite(metrics[k]) and 0.0 <= metrics[k] <= 1.0,
                f"{label}: metric {k} = {metrics.get(k)}")
    emit({"trainer_run": {"config": label, "steps": [n_a, n_b], "eval_batches": 2 * n_ev,
                          "launches": counts, **{k: metrics[k] for k in shown}, **extra}})


def training_phase(torch, rng):
    """Phase 4 (quirk mode, `run_seed` on packed data) and phase 5 (pairwise
    mode, the CLI on CSV files), each at T=20 lazy and T=150 dense, each run
    on the fast loops and then per step from the same seed."""
    import shutil
    import tempfile

    from amid_tpu_torch import train_sr_dr
    from amid_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
    from amid_tpu_torch.data.packed import load_dual_domain_csv
    from amid_tpu_torch.data.synthetic import synth_packed, write_synthetic_csvs
    from amid_tpu_torch.train.loop import run_seed

    loops = (("fast", True), ("per_step", False))
    results = {}
    for pairwise in (False, True):
        for t, lazy_adam in ((20, True), (150, False)):
            label = f"T{t}_{'lazy' if lazy_adam else 'dense'}" + ("_pairwise" if pairwise else "")
            cfg = ModelConfig(**{**FLAGSHIP, "seq_len": t, "comp_broadcast_quirk": not pairwise})
            work = tempfile.mkdtemp(prefix="chip_smoke_")
            data = DataConfig(dataset_type="synthetic", domain_type="d1_d2",
                              data_root=f"{work}/data", overlap_ratio=0.25, neg_nums=999)
            tcfg = TrainConfig(  # the fast loops are the defaults
                epochs=1, seeds=1, model_dir=f"{work}/model", lazy_table_adam=lazy_adam,
                nan_policy="halt", checkpoint=False, model=cfg, data=data)
            counts = {}
            try:
                if pairwise:
                    # the CLI as a user calls it, on CSV files in the reference's format
                    write_synthetic_csvs(data, cfg, rng, TRAIN_ROWS, VAL_ROWS, DR_ROWS)
                    argv = ["--comp_broadcast_quirk", "False", "--kernels", "cuda",
                            "--model", "sasrec", "--isItC", "True", "--ts2", "0.4",
                            "--seq_len", str(t), "--neg_nums", "999", "--overlap_ratio", "0.25",
                            "-ds", data.dataset_type, "-dm", data.domain_type,
                            "--data_root", data.data_root, "--epoch", "1", "--seeds", "1",
                            "--lazy_table_adam", str(lazy_adam)]
                    for name, fast in loops:
                        model_dir = f"{work}/model_{name}"
                        reset_counts()
                        t0 = time.perf_counter()
                        agg = train_sr_dr.main(  # default device: cuda
                            argv + ["-md", model_dir, "--fast_train", str(fast),
                                    "--fast_eval", str(fast)])
                        torch.cuda.synchronize()
                        seconds = time.perf_counter() - t0
                        counts[name] = read_counts()
                        require(Path(model_dir, "checkpoint", "seed0", "0.pt").exists(),
                                f"{label}: the CLI wrote no checkpoint (its default)")
                        check_run(f"{label} CLI {name}", cfg, lazy_adam, counts[name],
                                  {k: v["mean"] for k, v in agg.items()},
                                  {"loop": name, "seconds": seconds})
                    train_ds, val_ds, dr_ds = (
                        load_dual_domain_csv(path, t, cfg.pad_id, with_ob_label=ob)
                        for path, ob in ((data.train_csv(), False), (data.test_csv(), False),
                                         (data.train_dr_csv(), True)))
                else:
                    train_ds, val_ds, dr_ds = (synth_packed(cfg, rng, n)
                                               for n in (TRAIN_ROWS, VAL_ROWS, DR_ROWS))
                    for name, fast in loops:
                        run_cfg = dataclasses.replace(tcfg, fast_train=fast, fast_eval=fast,
                                                      model_dir=f"{work}/model_{name}")
                        reset_counts()
                        t0 = time.perf_counter()
                        best = run_seed(run_cfg, 0, train_ds, val_ds, dr_ds)  # on cuda
                        torch.cuda.synchronize()
                        seconds = time.perf_counter() - t0
                        counts[name] = read_counts()
                        check_run(f"{label} run_seed {name}", cfg, lazy_adam, counts[name],
                                  best, {"loop": name, "seconds": seconds,
                                         "examples_per_s": best["examples_per_s"]})
            finally:
                shutil.rmtree(work, ignore_errors=True)
            rec = step_checks(torch, cfg, tcfg, train_ds, val_ds, dr_ds, label)
            torch.cuda.empty_cache()
            rec["graph_steps"] = graph_checks(torch, cfg, tcfg, train_ds, val_ds, dr_ds, label)
            torch.cuda.empty_cache()
            rec["step_timing"] = step_timing(torch, cfg, tcfg, train_ds, label)
            launches = {k: sum(c[k] for c in counts.values()) for k in counts["fast"]}
            results[label] = {"launches": launches, **rec}
            torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 6: gate flips at trained weights
# ---------------------------------------------------------------------------

def gate_flip_phase(torch, rng):
    """`run_seed` in pairwise mode for FLIP_EPOCHS epochs of the DR schedule
    on the fast loops, at T=20 (lazy Adam, K7) and T=150 (dense, K6); then a
    feature pass of the trained model over 256 validation users and, per
    InterComp module, the gates of the kernels' bf16 affinity against those
    of the fp32 affinity (`max_affinity_xla`), at ts2=0.4 and at an opened
    threshold chosen from the fp32 probabilities. Information: a flip is a
    numerics change of the bf16 inputs, not a fault."""
    import shutil
    import tempfile

    from amid_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
    from amid_tpu_torch.data.synthetic import synth_packed
    from amid_tpu_torch.models.amid import build_model
    from amid_tpu_torch.ops.affinity import max_affinity_xla
    from amid_tpu_torch.serve import user_representations
    from amid_tpu_torch.train.loop import run_seed

    out = {}
    for t, lazy_adam in ((20, True), (150, False)):
        cfg = ModelConfig(**{**FLAGSHIP, "seq_len": t, "comp_broadcast_quirk": False})
        train_ds, val_ds, dr_ds = (synth_packed(cfg, rng, n)
                                   for n in (TRAIN_ROWS, VAL_ROWS, DR_ROWS))
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        tcfg = TrainConfig(epochs=FLIP_EPOCHS, seeds=1, model_dir=work, nan_policy="halt",
                           lazy_table_adam=lazy_adam, checkpoint=False, model=cfg,
                           data=DataConfig(neg_nums=999))
        trained = {}

        def keep(epoch, state, ev, phase):
            if epoch == FLIP_EPOCHS - 1 and phase == "post_dr":
                trained.update({k: v.detach().clone() for k, v in state.params.items()})
                trained["mrr"] = (ev["mrr_d1"], ev["mrr_d2"])

        try:
            run_seed(tcfg, 0, train_ds, val_ds, dr_ds, epoch_hook=keep)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        model = build_model(cfg, seed=1)
        with torch.no_grad():
            for name, param in model.named_parameters():
                param.copy_(trained[name])
        batch = {k: torch.as_tensor(val_ds.batch_arrays()[k][:cfg.batch_size], device="cuda")
                 for k in ("seq_d1", "seq_d2")}
        inputs = {}
        hooks = [getattr(model, n).register_forward_hook(
            lambda mod, args, res, n=n: inputs.__setitem__(n, args)) for n in GATED]
        user_representations(model, batch)
        for h in hooks:
            h.remove()
        rec = {"T": t, "epochs": FLIP_EPOCHS, "mrr_after": trained["mrr"]}
        with torch.no_grad():
            for n in GATED:
                msg = getattr(model, n).message
                bf16 = msg.gate_probabilities(*inputs[n])  # through K6 / K7
                fp32 = torch.softmax(max_affinity_xla(*inputs[n]), dim=1)
                for tag, thr in (("ts2", msg.threshold), ("opened", opened_threshold(fp32)[0])):
                    rec[f"{n}_{tag}"] = {
                        "threshold": thr, "gates": fp32.numel(),
                        "open_fp32": int((fp32 > thr).sum().item()),
                        "differing": int(((bf16 > thr) != (fp32 > thr)).sum().item())}
        emit({"gate_flips_trained": rec})
        out[t] = rec
        del model, trained
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 7: the BERT4Rec and GRU4Rec backbones at full width
# ---------------------------------------------------------------------------

BACKBONES = {  # the run.sh model with --model swapped (the JAX package's defaults)
    "bert4rec": dict(backbone="bert4rec", bert_blocks=2, bert_heads=4, bert_ff_dim=512,
                     bert_dropout=0.1, bert_d2_mask_quirk=True),
    "gru4rec": dict(backbone="gru4rec"),
}


def backbone_batch(cfg, rng):
    """`make_batch`'s users; user 0's domain-2 history is all id 0, so that
    BERT4Rec's key mask (`seq_d2 > 0`, both towers under the d2-mask quirk)
    masks every key of its rows."""
    batch = make_batch(cfg, rng)
    batch["seq_d2"][0] = 0
    return batch


def long_step_check(torch, cfg, tcfg, train_ds, val_ds, label):
    """BERT4Rec with InnerComp and InterComp at T=150, whose encoder sees
    T=600: one phase-A step and one evaluation batch of a kernels='cuda'
    model (the backward on the long path) against a kernels='torch' model
    from the same state, batch and key, with their launches."""
    from amid_tpu_torch.data.loader import BatchIterator
    from amid_tpu_torch.train.loop import _device_pools, _to_device

    model, state, step_a, _, eval_step = make_steps(cfg, tcfg, "cuda")
    ref, rstate, rstep_a, _, reval_step = make_steps(cfg, tcfg, "torch")
    ref.load_state_dict(model.state_dict())
    batch = _to_device(next(iter(BatchIterator(train_ds, cfg.batch_size, False))), "cuda")
    vbatch = _to_device(next(iter(BatchIterator(val_ds, cfg.batch_size, False))), "cuda")
    pools, vpools = _device_pools(train_ds, "cuda"), _device_pools(val_ds, "cuda")
    reset_counts()
    _, m = step_a(state, batch, *pools, 1234)
    torch.cuda.synchronize()
    counts = read_counts()
    _, rm = rstep_a(rstate, batch, *pools, 1234)
    want = expected_launches(cfg, train_steps=1)
    require(counts == want and counts["attention_bwd_long"] == 2 * cfg.bert_blocks,
            f"{label} phase A: launches {counts}, want {want}")
    for k, v in m.items():
        require(math.isfinite(float(v)) and abs(float(v) - float(rm[k])) <= LOSS_TOL,
                f"{label} phase A: {k} {float(v)} vs plain {float(rm[k])}")
    dense_name = DENSE_PARAM[cfg.backbone]
    rels = {k: rel_to_max(v, moments_of(rstate, 1, False, dense_name)[k])
            for k, v in moments_of(state, 1, False, dense_name).items()}
    require(max(rels.values()) <= MOMENT_TOL, f"{label} phase A: moments differ: {rels}")
    reset_counts()
    ev = eval_step(vbatch, *vpools, 99)
    torch.cuda.synchronize()
    ecounts = read_counts()
    rev = reval_step(vbatch, *vpools, 99)
    require(ecounts == expected_launches(cfg, eval_batches=1), f"{label} eval: {ecounts}")
    require(abs(float(ev["loss_cls"]) - float(rev["loss_cls"])) <= LOSS_TOL,
            f"{label} eval: loss {float(ev['loss_cls'])} vs plain {float(rev['loss_cls'])}")
    rec = {"config": label, "encoder_T": 4 * cfg.seq_len, "phase_A": {
        "launches": counts, "losses": {k: float(v) for k, v in m.items()},
        "moment_rel_err": rels}, "eval": {
        "launches": ecounts, "loss_cls": float(ev["loss_cls"]),
        "ranks_equal_share": (ev["ranks_fixed"] == rev["ranks_fixed"]).float().mean().item()},
        "phase_a_ms": cuda_ms(torch, lambda: step_a(state, batch, *pools, 7), 4, 1),
        "eval_batch_ms": cuda_ms(torch, lambda: eval_step(vbatch, *vpools, 7), 4, 1)}
    emit({"train_steps": rec})
    del model, ref, state, rstate
    torch.cuda.empty_cache()
    return rec


def backbone_phase(torch, rng):
    """Phase 7. For BERT4Rec and GRU4Rec at the run.sh width: serving at
    T=150 (with the catalog top-k) and T=20; `run_seed` for one epoch of the
    DR schedule on the fast loops at T=20 (lazy Adam) and T=150 (dense), with
    its launches, then the step-level checks against a kernels='torch'
    model, replayed steps against eager ones (at T=150 dense also
    `graph_draws`) and the step timings; BERT4Rec in pairwise mode at T=150
    (gates from K6), served and stepped; BERT4Rec with InnerComp and
    InterComp served at T=300 (encoder T=1,200: the long forward); and
    BERT4Rec with InnerComp and InterComp at T=150 (encoder T=600: the long
    paths), one epoch of `run_seed`, the step-level check and the step
    timings."""
    import shutil
    import tempfile

    from amid_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
    from amid_tpu_torch.data.synthetic import synth_packed
    from amid_tpu_torch.train.loop import run_seed

    out = {}

    def config(name, t, **kw):
        return ModelConfig(**{**FLAGSHIP, **BACKBONES[name], "seq_len": t, **kw})

    for name in BACKBONES:
        for t in (150, 20):
            cfg = config(name, t)
            out[f"serve_{name}_T{t}"] = serve_check(
                torch, cfg, backbone_batch(cfg, rng), f"{name}_T{t}", topk=t == 150)
    cfg = config("bert4rec", 150, comp_broadcast_quirk=False)
    out["serve_bert4rec_T150_pairwise"] = serve_check(
        torch, cfg, backbone_batch(cfg, rng), "bert4rec_T150_pairwise")
    # BERT4Rec with InnerComp and InterComp at seq_len=300: the encoder
    # attends over T=1,200, on the long forward
    cfg = config("bert4rec", 300, is_inc=True)
    out["serve_bert4rec_T300_inc_itc"] = serve_check(
        torch, cfg, backbone_batch(cfg, rng), "bert4rec_T300_inc_itc")

    runs = [(name, t, lazy_adam, {}) for name in BACKBONES
            for t, lazy_adam in ((20, True), (150, False))]
    # BERT4Rec with InnerComp and InterComp: the encoder at T=600
    runs += [("bert4rec", 150, False, {"comp_broadcast_quirk": False}),
             ("bert4rec", 150, False, {"is_inc": True})]
    for name, t, lazy_adam, kw in runs:
        cfg = config(name, t, **kw)
        label = (f"{name}_T{t}_{'lazy' if lazy_adam else 'dense'}"
                 + ("_pairwise" if not cfg.comp_broadcast_quirk else "")
                 + ("_inc_itc" if cfg.is_inc else ""))
        train_ds, val_ds, dr_ds = (synth_packed(cfg, rng, n)
                                   for n in (TRAIN_ROWS, VAL_ROWS, DR_ROWS))
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        tcfg = TrainConfig(epochs=1, seeds=1, model_dir=work, lazy_table_adam=lazy_adam,
                           nan_policy="halt", checkpoint=False, model=cfg,
                           data=DataConfig(neg_nums=999))  # the fast loops: the defaults
        rec = {}
        if kw.get("comp_broadcast_quirk", True):  # run_seed, on the fast loops
            try:
                reset_counts()
                t0 = time.perf_counter()
                best = run_seed(tcfg, 0, train_ds, val_ds, dr_ds)  # on cuda
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                rec["launches"] = read_counts()
                check_run(f"{label} run_seed fast", cfg, lazy_adam, rec["launches"], best,
                          {"loop": "fast", "seconds": seconds,
                           "examples_per_s": best["examples_per_s"]})
            finally:
                shutil.rmtree(work, ignore_errors=True)
            torch.cuda.empty_cache()
        if cfg.is_inc:
            rec["train_steps"] = long_step_check(torch, cfg, tcfg, train_ds, val_ds, label)
            torch.cuda.empty_cache()
            rec["step_timing"] = step_timing(torch, cfg, tcfg, train_ds, label, 4)
        else:
            rec["train_steps"] = step_checks(torch, cfg, tcfg, train_ds, val_ds, dr_ds, label)
            torch.cuda.empty_cache()
            if cfg.comp_broadcast_quirk:
                rec["graph_steps"] = graph_checks(torch, cfg, tcfg, train_ds, val_ds, dr_ds,
                                                  label)
                torch.cuda.empty_cache()
                # GRU4Rec's eager T=150 step is ~3,000 host launches (~0.3 s):
                # fewer steps keep the trace's processing short (2 since the
                # precision phase joined the run's time limit)
                slow = cfg.backbone == "gru4rec" and t == 150
                rec["step_timing"] = step_timing(torch, cfg, tcfg, train_ds, label,
                                                 2 if slow else TIMED_STEPS)
        if label == "bert4rec_T150_dense":
            rec["graph_draws"] = graph_draws(torch, cfg, tcfg, label)
        out[label] = rec
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8: C2DSR
# ---------------------------------------------------------------------------

C2DSR_RUNS = (  # label, the run.sh model's overrides, whether its replays are checked
    ("sasrec_T150", dict(seq_len=150), True),  # views at 300: the one-sweep backward
    ("sasrec_T20_pairwise", dict(seq_len=20, comp_broadcast_quirk=False), False),  # K7 at 40
    ("bert4rec_T150", dict(BACKBONES["bert4rec"], seq_len=150), False),  # views at 600: long
    ("gru4rec_T20", dict(BACKBONES["gru4rec"], seq_len=20), False),
)


def loss_cl_fp64(torch, cfg, tcfg, train_ds, phase_a):
    """The forward of `step_checks`' phase-A step (seed-0 weights, the first
    train batch, key 1234; `step.losses`, no gradient: the fp64 backward
    does not fit the card) on a kernels='torch' model in fp64, against the
    fp32 steps' metrics `phase_a`. Masks, seeds and items are drawn apart
    from the weights' dtype, so the draws are the same and only the rounding
    differs. The plain routes' float32 checks state the kernels' contract
    and are lifted for this model alone."""
    from unittest import mock

    from amid_tpu_torch.data.loader import BatchIterator
    from amid_tpu_torch.models.amid import build_model
    from amid_tpu_torch.ops import embedding, scoring
    from amid_tpu_torch.train import steps
    from amid_tpu_torch.train.loop import _device_pools, _to_device
    from amid_tpu_torch.train.optim import Adam

    model = build_model(dataclasses.replace(cfg, kernels="torch"), device="cuda",
                        seed=0).double()
    step = steps.make_train_step(model, Adam(tcfg.lr), dr_e_w=tcfg.dr_e_w, c2dsr_w=tcfg.cl_w)
    batch = _to_device(next(iter(BatchIterator(train_ds, cfg.batch_size, False))), "cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), mock.patch.object(embedding, "_check", lambda *a: None), \
            mock.patch.object(scoring, "_check", lambda *a: None):
        _, m = step.losses(batch, *_device_pools(train_ds, "cuda"), 1234)
    m = {k: float(v) for k, v in m.items()}
    cuda, plain = phase_a["losses"], phase_a["plain_losses"]
    rec = {"fp64": m, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           **{f"{name}_{k}_err": abs(got[k] - m[k]) for name, got in (("cuda", cuda),
                                                                     ("plain", plain))
              for k in ("loss_cl", "loss_cls")}}
    require(losses_agree("loss_cls", plain["loss_cls"], m),
            f"fp64 step: loss_cls {m['loss_cls']} vs plain {plain['loss_cls']}: not the "
            f"same weights and draws")
    for name, got in (("cuda", cuda), ("plain", plain)):
        require(losses_agree("loss_cl", got["loss_cl"], m),
                f"{name} loss_cl {got['loss_cl']} vs fp64 {m['loss_cl']}")
    del model, step
    return rec


def c2dsr_phase(torch, rng):
    """Phase 8. C2DSR with dense Adam (cl_w 0.1), the run.sh model at T=150,
    pairwise SASRec at T=20, BERT4Rec with InterComp at T=150 (one block)
    and GRU4Rec at T=20: one epoch of `run_seed` on the fast loops with its launches against
    `expected_launches` (the views at 2L: each phase-A step runs three
    feature passes), phase 4's step-level checks against a kernels='torch'
    model, the step timings (and for the run.sh model replayed steps against
    eager ones); then BERT4Rec with InnerComp and InterComp at T=150, whose
    views reach T=1,200 at dh=32 (`c2dsr_long_run`)."""
    import shutil
    import tempfile

    from amid_tpu_torch.config import DataConfig, ModelConfig, TrainConfig, encoder_length
    from amid_tpu_torch.data.synthetic import synth_packed
    from amid_tpu_torch.ops.affinity import smalln_plan
    from amid_tpu_torch.train.loop import run_seed

    out = {}
    for label, kw, replays in C2DSR_RUNS:
        label = f"c2dsr_{label}"
        cfg = ModelConfig(**{**FLAGSHIP, **kw, "is_c2dsr": True})
        train_ds, val_ds, dr_ds = (synth_packed(cfg, rng, n)
                                   for n in (TRAIN_ROWS, VAL_ROWS, DR_ROWS))
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        tcfg = TrainConfig(epochs=1, seeds=1, model_dir=work, nan_policy="halt",
                           checkpoint=False, model=cfg, data=DataConfig(neg_nums=999))
        rec = {"encoder_T": [encoder_length(cfg, cfg.seq_len),
                             encoder_length(cfg, 2 * cfg.seq_len)]}
        if not cfg.comp_broadcast_quirk:  # the views' gates: K7's users a slot at 2L
            rec["views_smalln_users"] = smalln_plan(256, 256, 2 * cfg.seq_len,
                                                    2 * cfg.seq_len, 128).users
            require(rec["views_smalln_users"] == 4, f"{label}: {rec['views_smalln_users']}")
        try:
            reset_counts()
            t0 = time.perf_counter()
            best = run_seed(tcfg, 0, train_ds, val_ds, dr_ds)  # on cuda, the fast loops
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            rec["launches"] = read_counts()
            require("loss_cl:" in Path(work, "log0.txt").read_text(),
                    f"{label}: run_seed did not log loss_cl")
            check_run(f"{label} run_seed fast", cfg, False, rec["launches"], best,
                      {"loop": "fast", "seconds": seconds,
                       "examples_per_s": best["examples_per_s"]})
        finally:
            shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
        rec["train_steps"] = step_checks(torch, cfg, tcfg, train_ds, val_ds, dr_ds, label)
        torch.cuda.empty_cache()
        if cfg.backbone == "bert4rec":  # the largest loss_cl, about 31: read in fp64
            rec["loss_cl_fp64"] = loss_cl_fp64(torch, cfg, tcfg, train_ds,
                                               rec["train_steps"]["phase_A"])
            emit({"loss_cl_fp64": {"config": label, **rec["loss_cl_fp64"]}})
            torch.cuda.empty_cache()
        if replays:
            rec["graph_steps"] = graph_checks(torch, cfg, tcfg, train_ds, val_ds, dr_ds, label)
            torch.cuda.empty_cache()
        rec["step_timing"] = step_timing(torch, cfg, tcfg, train_ds, label,
                                         4 if cfg.backbone != "sasrec" else TIMED_STEPS)
        out[label] = rec
        torch.cuda.empty_cache()

    out["c2dsr_bert4rec_T150_inc_itc"] = c2dsr_long_run(torch, rng)
    return out


C2DSR_CHECK_BATCH = 32  # the plain step keeps [B, h, T, T] blocks at T=1,200: 24 GB at 32


def c2dsr_long_run(torch, rng):
    """BERT4Rec with InnerComp, InterComp and C2DSR at T=150: the main pass
    attends over T=600, the views over T=1,200 at dh=32, past the one-head
    forward kernel's 800, on the long forward and the long backward. One
    epoch of `run_seed` at B=256 on the fast loops, its launches against
    `expected_launches` and its peak device memory, and that of one eager
    phase-A step (the model, its state and the step's); phase 4's step-level
    checks against a kernels='torch' model at B=C2DSR_CHECK_BATCH, where the
    plain step fits; then the step timings at B=256 (replayed phase A)."""
    import shutil
    import tempfile

    from amid_tpu_torch.config import DataConfig, ModelConfig, TrainConfig, encoder_length
    from amid_tpu_torch.data.synthetic import synth_packed
    from amid_tpu_torch.models.amid import head_width
    from amid_tpu_torch.ops.attention import backward_route, forward_route
    from amid_tpu_torch.train.loop import run_seed

    label = "c2dsr_bert4rec_T150_inc_itc"
    cfg = ModelConfig(**{**FLAGSHIP, **BACKBONES["bert4rec"], "seq_len": 150, "is_inc": True,
                         "is_c2dsr": True})
    views_t, dh = encoder_length(cfg, 2 * cfg.seq_len), head_width(cfg)
    require(views_t == 1200 and forward_route(views_t, dh) == "long"
            and backward_route(views_t, dh) == "long",
            f"{label}: the views' T={views_t} at dh={dh} is not on both long paths")
    rec = {"encoder_T": [encoder_length(cfg, cfg.seq_len), views_t]}
    train_ds, val_ds, dr_ds = (synth_packed(cfg, rng, n) for n in (TRAIN_ROWS, VAL_ROWS, DR_ROWS))
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    tcfg = TrainConfig(epochs=1, seeds=1, model_dir=work, nan_policy="halt", checkpoint=False,
                       model=cfg, data=DataConfig(neg_nums=999))
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        best = run_seed(tcfg, 0, train_ds, val_ds, dr_ds)  # on cuda, the fast loops
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rec["run_seed_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rec["launches"] = read_counts()
        require("loss_cl:" in Path(work, "log0.txt").read_text(),
                f"{label}: run_seed did not log loss_cl")
        check_run(f"{label} run_seed fast", cfg, False, rec["launches"], best,
                  {"loop": "fast", "seconds": seconds, "examples_per_s": best["examples_per_s"],
                   "peak_gib": rec["run_seed_peak_gib"]})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    # one eager phase-A step at B=256 on a fresh model: its peak device memory
    from amid_tpu_torch.data.loader import BatchIterator
    from amid_tpu_torch.train.loop import _device_pools, _to_device

    model, state, step_a, _, _ = make_steps(cfg, tcfg, "cuda")
    batch = _to_device(next(iter(BatchIterator(train_ds, cfg.batch_size, False))), "cuda")
    pools = _device_pools(train_ds, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_a(state, batch, *pools, 1234)
    torch.cuda.synchronize()
    rec["phase_a_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del model, state, step_a, batch, pools
    torch.cuda.empty_cache()
    small = dataclasses.replace(cfg, batch_size=C2DSR_CHECK_BATCH)
    rows = (2 * C2DSR_CHECK_BATCH, C2DSR_CHECK_BATCH, 2 * C2DSR_CHECK_BATCH)
    small_ds = [synth_packed(small, rng, n) for n in rows]
    torch.cuda.reset_peak_memory_stats()
    rec["train_steps"] = step_checks(torch, small, dataclasses.replace(tcfg, model=small),
                                     *small_ds, f"{label}_B{C2DSR_CHECK_BATCH}")
    rec["train_steps_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    rec["step_timing"] = step_timing(torch, cfg, tcfg, train_ds, label, 4)
    emit({"c2dsr_long": {"config": label, **{k: v for k, v in rec.items()
                                             if k not in ("train_steps", "step_timing")}}})
    return rec


# ---------------------------------------------------------------------------
# phase 9: checkpoints, resume, the roll-back, the trace, the timer, the reader
# ---------------------------------------------------------------------------

RESTORE_STEPS = 4  # restore_replay: replays after the save, and again after the restore
NATIVE_ROWS = 27_000  # the CSV size the native reader's docstring times
# kernel names the trace of a lazy T=20 run must hold: attention forward and
# backward, the gather, its backward (both sequences' 10,240 rows: the tile
# and row passes; target and negative, 512 rows: the one-launch kernel), the
# scoring head and the fused scatter
TRACE_KERNELS = ("attention_fwd_kernel", "attention_bwd_kernel", "gather_rows_kernel",
                 "grad_tiles_kernel", "grad_rows_kernel", "grad_direct_kernel",
                 "scoring_head_kernel", "scatter_rows_kernel")
NAN_PARAM = "predict_gfunc.fc1.weight"  # read by phase B's loss (the imputation head)


def payload_checks(torch, cfg, tcfg, train_ds, dr_ds, work):
    """Each payload of `CheckpointManager` (async) on the lazy T=20 state
    with both slots moved by two phase-A and two phase-B steps: bytes on
    disk, the seconds `save()` blocks (the first save allocates the pinned
    buffers, the second reuses them), the seconds to `wait_until_finished`,
    the seconds of a `restore` into the state after every leaf was moved;
    the restored leaves as saved (bf16_moments: the moments through
    bfloat16; params_only: zero moments and counts)."""
    from amid_tpu_torch.data.loader import BatchIterator
    from amid_tpu_torch.train.checkpoint import PAYLOADS, CheckpointManager, state_leaves
    from amid_tpu_torch.train.loop import _device_pools, _to_device

    _, state, step_a, step_b, _ = make_steps(cfg, tcfg, "cuda")
    for ds, step in ((train_ds, step_a), (dr_ds, step_b)):
        pools = _device_pools(ds, "cuda")
        for i, batch in zip(range(2), BatchIterator(ds, cfg.batch_size, False)):
            step(state, _to_device(batch, "cuda"), *pools, 300 + i)
    torch.cuda.synchronize()
    leaves = state_leaves(state)
    saved = {k: v.clone() for k, v in leaves.items()}
    out = {}
    for payload in PAYLOADS:
        mgr = CheckpointManager(str(work / f"payload_{payload}"), async_save=True,
                                payload=payload)
        rec = {"payload": payload, "save_block_s": [], "wait_s": []}
        try:
            for i in range(2):
                t0 = time.perf_counter()
                mgr.save(i, state)
                rec["save_block_s"].append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                mgr.wait_until_finished()
                rec["wait_s"].append(time.perf_counter() - t0)
            rec["bytes_on_disk"] = (work / f"payload_{payload}" / "1.pt").stat().st_size
            with torch.no_grad():
                for t in leaves.values():
                    t.add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            require(mgr.restore(state) is state, f"{payload}: restore made a new state")
            torch.cuda.synchronize()
            rec["restore_s"] = time.perf_counter() - t0
        finally:
            mgr.close()
        for k, v in leaves.items():
            want = saved[k]
            if not k.startswith("params/"):
                if payload == "params_only":
                    want = torch.zeros_like(want)
                elif payload == "bf16_moments" and want.dtype == torch.float32:
                    want = want.bfloat16().float()
            require(torch.equal(v, want), f"{payload}: {k} restored wrong")
            with torch.no_grad():
                v.copy_(saved[k])
        rec["state_bytes"] = sum(t.numel() * t.element_size() for t in leaves.values())
        emit({"checkpoint_payload": rec})
        out[payload] = rec
    return out


def restore_replay(torch, cfg, tcfg, ds, work, label):
    """A restore into the tensors a captured phase-A graph reads: two steps
    through a resident chunk runner (eager, then captured and replayed), a
    full save, RESTORE_STEPS replays with keys k1..kn (state S1); restore,
    the same replays (state S2): S1 and S2 equal bit for bit, every leaf.
    Then a params_only checkpoint restores the parameters and zero moments
    and counts."""
    from amid_tpu_torch.train import steps
    from amid_tpu_torch.train.checkpoint import CheckpointManager, state_leaves
    from amid_tpu_torch.train.graphs import GraphPool
    from amid_tpu_torch.train.loop import _device_pools, _resident

    bs, n = cfg.batch_size, RESTORE_STEPS
    t0 = time.perf_counter()
    _, state, step_a, _, _ = make_steps(cfg, tcfg, "cuda")
    arrays = _resident(ds.batch_arrays(), "cuda")
    pools = _device_pools(ds, "cuda")
    perm = torch.arange((2 + n) * bs, dtype=torch.int32, device="cuda")
    pool = GraphPool("cuda")
    full = CheckpointManager(str(work / f"{label}_full"), async_save=True)
    params_only = CheckpointManager(str(work / f"{label}_params_only"), payload="params_only")
    try:
        runner = steps.make_resident_chunk_runner(step_a, bs, pool)

        def run(i):
            _, _, nf = runner(state, arrays, perm, *pools, 17, range(i, i + 1), range(i, i + 1))
            require(float(nf) == 0.0, f"{label}: non-finite step {i}")

        def replays():
            for i in range(2, 2 + n):
                run(i)
            return {k: v.clone() for k, v in state_leaves(state).items()}

        run(0)
        run(1)
        full.save(1, state)
        s1 = replays()
        ptrs = {k: v.data_ptr() for k, v in state_leaves(state).items()}
        require(full.restore(state) is state, f"{label}: restore made a new state")
        require({k: v.data_ptr() for k, v in state_leaves(state).items()} == ptrs,
                f"{label}: restore moved a tensor")
        s2 = replays()
        replayed = pool.graphs[0].replays
        require(replayed == 1 + 2 * n, f"{label}: {replayed} replays")
        differ = [k for k, v in s1.items() if not torch.equal(v, s2[k])]
        require(not differ, f"{label}: replays after the restore differ: {differ[:5]}")
        params_only.save(2 + n, state)
        run(2)
        params_only.restore(state)
        for k, v in state_leaves(state).items():
            want = s2[k] if k.startswith("params/") else torch.zeros_like(v)
            require(torch.equal(v, want), f"{label}: params_only restored {k} wrong")
    finally:
        full.close()
        params_only.close()
        pool.close()
    rec = {"config": label, "replays": replayed, "leaves": len(s1), "bit_equal": True,
           "seconds": time.perf_counter() - t0}
    emit({"restore_replay": rec})
    return rec


def checkpoint_phase(torch, rng):
    """Phase 9: the checkpoint manager, resume, the roll-back on a
    non-finite loss, the trace and the step timer through `run_seed`, and
    the native CSV reader, at the run.sh model's width."""
    import shutil
    import tempfile

    from amid_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
    from amid_tpu_torch.data import native
    from amid_tpu_torch.data.packed import pack_rows, read_csv_python
    from amid_tpu_torch.data.synthetic import synth_packed, write_synthetic_csvs
    from amid_tpu_torch.train import loop

    cfg = ModelConfig(**{**FLAGSHIP, "seq_len": 20})
    train_ds, val_ds, dr_ds = (synth_packed(cfg, rng, n) for n in (TRAIN_ROWS, VAL_ROWS, DR_ROWS))
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))

    def tcfg(name, **kw):
        return TrainConfig(**{**dict(
            epochs=1, seeds=1, model_dir=str(work / name), lazy_table_adam=True,
            nan_policy="halt", checkpoint=True, checkpoint_every=1, checkpoint_async=True,
            model=cfg, data=DataConfig(neg_nums=999)), **kw})

    runs = {}

    def drive(label, run_cfg, epoch_hook=None):
        """run_seed on the main path, its launches counted from 0."""
        reset_counts()
        t0 = time.perf_counter()
        best = loop.run_seed(run_cfg, 0, train_ds, val_ds, dr_ds, epoch_hook=epoch_hook)
        torch.cuda.synchronize()
        runs[label] = {"launches": read_counts(), "seconds": time.perf_counter() - t0}
        for k in ("mrr_d1", "mrr_d2", "hit_10_d1", "hit_10_d2"):
            require(math.isfinite(best.get(k, math.nan)), f"{label}: metric {k}")
        return best

    try:
        # 1. payloads, then save and resume through run_seed
        payload_checks(torch, cfg, tcfg("payload"), train_ds, dr_ds, work)
        torch.cuda.empty_cache()
        # the phase-A-only number the port reported before the StepTimer:
        # phase A's chunks timed between synchronisations
        chunked, phase_a = loop._run_chunked, []

        def timed(runner, state, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = chunked(runner, state, *a)
            torch.cuda.synchronize()
            if a[6] == 0:  # idx_offset: phase A
                phase_a.append((a[2] * FLAGSHIP["batch_size"], time.perf_counter() - t0))
            return out

        loop._run_chunked = timed
        try:
            best = drive("resume_epoch0", tcfg("resume"))
        finally:
            loop._run_chunked = chunked
        examples, seconds = map(sum, zip(*phase_a))
        emit({"step_timer": {"examples_per_s": best["examples_per_s"],
                             "phase_a_only_examples_per_s": examples / seconds,
                             "phase_a_steps": examples // FLAGSHIP["batch_size"],
                             "run_seconds": runs["resume_epoch0"]["seconds"]}})
        ckpt_dir = work / "resume" / "checkpoint" / "seed0"
        for epochs in (2, 3):
            best = drive(f"resume_epoch{epochs - 1}", tcfg("resume", epochs=epochs, resume=True))
            require(best["start_epoch"] == epochs - 1,
                    f"resume to {epochs} epochs started at {best['start_epoch']}")
            require((ckpt_dir / f"{epochs - 1}.pt").exists(), f"epoch {epochs - 1} not saved")
        emit({"checkpoint_resume": {"start_epochs": [0, 1, 2], "files": sorted(
            p.name for p in ckpt_dir.iterdir())}})

        # 2. the roll-back under replay: NaN weights before epoch 1's phase B
        trained = {}

        def poison(epoch, state, ev, phase):
            if epoch == 1 and phase == "main":
                with torch.no_grad():
                    state.params[NAN_PARAM].fill_(float("nan"))
            if epoch == 1 and phase == "post_dr":
                trained["finite"] = all(bool(torch.isfinite(v).all())
                                        for v in state.params.values())

        drive("rollback", tcfg("rollback", epochs=2, nan_policy="restore", log_every=4),
              epoch_hook=poison)
        log = (work / "rollback" / "log0.txt").read_text()
        line = "non-finite train loss at epoch 1 step 0; rolled back to checkpoint 0"
        require(line in log, "the roll-back was not logged")
        after = log.split(line, 1)[1]
        losses = [float(x.split()[0].rstrip(",")) for x in after.split("loss_dr_r:")[1:]]
        require(losses and all(math.isfinite(x) for x in losses),
                f"losses after the roll-back: {losses}")
        require(trained.get("finite"), "weights after the roll-back are not finite")
        emit({"checkpoint_rollback": {"logged": line, "losses_after": losses}})

        # 3. restore into captured graphs, bit for bit
        restore_replay(torch, cfg, tcfg("r20"), synth_packed(
            cfg, rng, (2 + RESTORE_STEPS) * cfg.batch_size), work, "T20_lazy")
        torch.cuda.empty_cache()
        pair = ModelConfig(**{**FLAGSHIP, "comp_broadcast_quirk": False})
        restore_replay(
            torch, pair, tcfg("r150", lazy_table_adam=False, model=pair),
            synth_packed(pair, rng, (2 + RESTORE_STEPS) * pair.batch_size), work,
            "T150_dense_pairwise")
        torch.cuda.empty_cache()

        # 4. the trace of profile_steps
        drive("trace", tcfg("trace", profile_steps=3, checkpoint=False))
        traces = list((work / "trace" / "profile").glob("*.pt.trace.json"))
        require(len(traces) == 1, f"traces written: {traces}")
        text = traces[0].read_text()
        missing = [k for k in TRACE_KERNELS if k not in text]
        require(not missing, f"the trace names no {missing}")
        emit({"profile_trace": {"bytes": len(text), "kernels": list(TRACE_KERNELS)}})

        # 6. the native CSV reader against the Python one
        data = DataConfig(dataset_type="synthetic", domain_type="d1_d2",
                          data_root=str(work / "csv"), overlap_ratio=0.25)
        write_synthetic_csvs(data, cfg, rng, NATIVE_ROWS, 16)
        lib = native.library_path()
        require(lib is not None, "the native CSV reader does not load")
        t0 = time.perf_counter()
        fast = native.pack_csv_native(data.train_csv(), False, cfg.seq_len, cfg.pad_id,
                                      data.long_length)
        native_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        users, s1, s2, dom, _ = read_csv_python(data.train_csv(), False)
        slow = pack_rows(users, s1, s2, dom, None, cfg.seq_len, cfg.pad_id, data.long_length)
        python_s = time.perf_counter() - t0
        for k, v in slow.batch_arrays().items():
            require(np.array_equal(fast.batch_arrays()[k], v), f"native reader: {k} differs")
        require(np.array_equal(fast.pools, slow.pools)
                and np.array_equal(fast.pool_sizes, slow.pool_sizes), "native reader: pools")
        emit({"native_reader": {"rows": len(fast), "library": str(lib),
                                "native_s": native_s, "python_s": python_s}})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return runs


# ---------------------------------------------------------------------------
# phase 10: the precision flags (--bf16 / --matmul_precision bfloat16, --remat)
# ---------------------------------------------------------------------------

BF16_DRAWS = 3  # draws of each bf16 kernel case held against the fp64 oracle
ORACLE_ROWS = 32  # batch rows the fp64 oracle computes (rows are independent)
REMAT_BATCHES = (256, 1024)  # remat's memory and time: the run.sh batch, and one
# where the activations outweigh the table, its gradient and Adam's moments


def bf16_attention_oracle(torch, q, k, v, bias, seed, heads, rate):
    """The attention forward in fp64 with the JAX kernel's `mxu_bf16`
    rounding: bf16(Q) . bf16(K) summed in fp64, the bias added in fp32 (as
    both packages add it), softmax and dropout in fp64, then bf16(P dropped,
    as fp32) . bf16(V) in fp64."""
    from amid_tpu_torch.ops.attention import dropout_keep_mask

    b, t, d = q.shape
    dh = d // heads

    def r(x):
        return x.to(torch.bfloat16).double()

    def split(x):
        return x.reshape(b, t, heads, dh).transpose(1, 2)

    s = torch.matmul(r(split(q)), r(split(k)).transpose(-1, -2)) / math.sqrt(dh)
    p = torch.softmax((s.float() + bias).double(), dim=-1)
    if rate > 0.0:
        p = p * dropout_keep_mask(seed, b, heads, t, rate, q.device).double() / (1.0 - rate)
    return torch.matmul(r(p.float()), r(split(v))).transpose(1, 2).reshape(b, t, d)


def key_chunk(path: str, dh: int) -> int:
    """Keys a bf16 forward kernel takes per online-softmax step, at every
    head width: kChunk = 32 in `attention_fwd_bf16.cu`, a stage of
    kStageKeys in `attention_fwd_long_bf16.cu`
    (`ops/attention.py::LONG_BF16_STAGE_KEYS`)."""
    from amid_tpu_torch.ops.attention import LONG_BF16_STAGE_KEYS

    return 32 if path == "sweep" else LONG_BF16_STAGE_KEYS


def bf16_attention_kernel_oracle(torch, q, k, v, bias, seed, heads, rate, chunk):
    """The bf16 forward kernels' own arithmetic in fp64: scores of bf16(Q) .
    bf16(K), scaled and biased in fp32; an online softmax over `chunk` keys a
    step, where each key's exp(S - m), m the running maximum after its
    chunk, is dropped (times the fp32 1 / (1 - rate)) and rounded to bf16
    unnormalised, times bf16(V), carried to the row's final maximum and
    divided by the sum of the exps before rounding and dropout."""
    import torch.nn.functional as F

    from amid_tpu_torch.ops.attention import dropout_keep_mask

    b, t, d = q.shape
    dh = d // heads
    n = -(-t // chunk)

    def r(x):
        return x.float().to(torch.bfloat16).double()

    def split(x):
        return x.reshape(b, t, heads, dh).transpose(1, 2)

    s = torch.matmul(r(split(q)), r(split(k)).transpose(-1, -2)) / math.sqrt(dh)
    s = F.pad((s + bias.double()).float().double(), (0, n * chunk - t), value=-math.inf)
    s = s.view(b, heads, t, n, chunk)
    m = s.amax(-1).cummax(-1).values  # the running maximum after each chunk
    e = torch.exp(s - m[..., None])
    carry = torch.exp(m - m[..., -1:])[..., None]  # to the row's final maximum
    total = (e * carry).sum((-1, -2))
    carry = carry.expand(-1, -1, -1, -1, chunk).reshape(b, heads, t, n * chunk)[..., :t]
    e = e.reshape(b, heads, t, n * chunk)[..., :t]
    if rate > 0.0:
        keep = dropout_keep_mask(seed, b, heads, t, rate, q.device).double()
        e = e * keep * float(np.float32(1.0 / (1.0 - rate)))
    o = torch.matmul(r(e) * carry, r(split(v))) / total[..., None]
    return o.transpose(1, 2).reshape(b, t, d)


def bf16_attention_bwd_oracle(torch, q, k, v, bias, out, dout, seed, heads, rate):
    """dq, dk, dv in fp64 with the bf16 mode's rounding points (the plain
    version's and the kernels': the scores and the four gradient products on
    bf16 operands, D_i = rowsum(dO o O) of the forward's output)."""
    from amid_tpu_torch.ops.attention import dropout_keep_mask

    b, t, d = q.shape
    dh = d // heads

    def r(x):
        return x.float().to(torch.bfloat16).double()

    def split(x):
        return x.reshape(b, t, heads, dh).transpose(1, 2)

    def merge(x):
        return x.transpose(1, 2).reshape(b, t, d)

    qh, kh, vh, gh = (split(x) for x in (q, k, v, dout))
    s = torch.matmul(r(qh), r(kh).transpose(-1, -2)) / math.sqrt(dh)
    p = torch.softmax((s.float() + bias).double(), dim=-1)
    d_row = (gh.double() * split(out).double()).sum(-1, keepdim=True)
    dp = torch.matmul(r(gh), r(vh).transpose(-1, -2))
    pd = p
    if rate > 0.0:
        keep = dropout_keep_mask(seed, b, heads, t, rate, q.device).double() / (1.0 - rate)
        pd, dp = p * keep, dp * keep
    dv = torch.matmul(r(pd).transpose(-1, -2), r(gh))
    ds = p * (dp - d_row)
    dq = torch.matmul(r(ds), r(kh)) / math.sqrt(dh)
    dk = torch.matmul(r(ds).transpose(-1, -2), r(qh)) / math.sqrt(dh)
    return merge(dq), merge(dk), merge(dv)


def bf16_scoring_oracle(torch, u, items, wu, wi, b1, w2, b2):
    """The scoring head in fp64 with the bf16 mode's rounding points (the
    kernel's and the plain version's): u, Wu, the items, Wi, the hidden unit
    and w2 rounded to bf16."""
    def r(x):
        return x.float().to(torch.bfloat16).double()

    hid = torch.relu((r(u) @ r(wu).T)[:, None, :] + r(items) @ r(wi).T + b1.double())
    return torch.sigmoid((r(hid) @ r(w2).T)[..., 0] + b2.double())


def rel_norm(x, y) -> float:
    """||x - y|| / ||y|| in fp64, over the whole tensor."""
    y = y.double()
    return ((x.double() - y).norm() / y.norm()).item()


class Bf16Readings:
    """One bf16 case's readings over its draws and outputs (BF16_LIMITS):
    the largest kernel_oracle, kernel_plain, plain_oracle and fp32_plain,
    the least fp32_oracle (the control), and the bf16 build's largest
    |kernel - plain|."""

    def __init__(self):
        self.r = {"kernel_oracle": 0.0, "kernel_plain": 0.0, "plain_oracle": 0.0,
                  "fp32_oracle": math.inf, "fp32_plain": 0.0}
        self.max_abs_err = 0.0

    def draw(self, outputs):
        """outputs: (bf16 build, fp32 build, plain bf16, oracle of the kernel's
        rounding, oracle of JAX's rounding) per output of one draw; the
        oracles cover the first rows only."""
        ctl = 0.0
        for got, fp32, want, k_oracle, j_oracle in outputs:
            rows = k_oracle.shape[0]
            self.r["kernel_oracle"] = max(self.r["kernel_oracle"], rel_norm(got[:rows], k_oracle))
            self.r["kernel_plain"] = max(self.r["kernel_plain"], rel_norm(got, want))
            self.r["plain_oracle"] = max(self.r["plain_oracle"], rel_norm(want[:rows], j_oracle))
            self.r["fp32_plain"] = max(self.r["fp32_plain"], rel_norm(fp32, want))
            ctl = max(ctl, rel_norm(fp32[:rows], k_oracle))
            self.max_abs_err = max(self.max_abs_err, (got - want).abs().max().item())
        self.r["fp32_oracle"] = min(self.r["fp32_oracle"], ctl)

    def verdict(self, name, limits_of=None):
        """Requires every reading within the limits of case `limits_of` (the
        case `name` itself by default) and the fp32 build outside the
        kernel_oracle one; the readings and limits, for the record."""
        limits = dict(zip(("kernel_oracle", "kernel_plain", "plain_oracle"),
                          BF16_LIMITS[limits_of or name]))
        out = {"readings": dict(self.r), "limits": limits, "max_abs_err": self.max_abs_err}
        emit({"bf16_readings": {"case": name, **out}})
        for key, limit in limits.items():
            require(self.r[key] <= limit, f"{name}: {key} {self.r[key]} above {limit}")
        require(self.r["fp32_oracle"] > limits["kernel_oracle"],
                f"{name}: the fp32 build is within the bf16 limit "
                f"({self.r['fp32_oracle']} <= {limits['kernel_oracle']})")
        return out


def bf16_kernel_phase(torch, gen):
    """Phase 10(a): each bf16-operand mode against its plain bf16 version and
    fp64 oracles (BF16_LIMITS), BF16_DRAWS draws a case, the fp32 build at
    the same inputs as the control: K1's one-head forward (SASRec T=150 and
    T=20, h=8, causal, rates 0 and 0.5), its long forward (BERT4Rec T=600 and
    T=1,200, h=4, key padding, rate 0.1), the one-sweep backward (T=150,
    h=8, causal, rate 0.5; T=20, rate 0) and the long backward (T=600, h=4,
    key padding, rate 0.1), fed the plain forward's residuals; K5's pair at
    C=1000 and C=2. The first draw is timed (the fp32 build's `device_ms` at
    the same shape beside it; library: SDPA on bf16 q, k, v); `bound_ms` at
    the bf16 tensor-core peak (bf16 operands, fp32 sums: the function, and
    the native kernels' instructions)."""
    import torch.nn.functional as F

    from amid_tpu_torch.ops import attention as attention_ops
    from amid_tpu_torch.ops.attention import (
        attention_bwd_plain, attention_fwd_stats_plain, attention_fwd_stats_streamed_plain,
    )
    from amid_tpu_torch.ops.scoring import scoring_head_pair, scoring_head_pair_plain

    B, D, OB = 256, 128, ORACLE_ROWS
    cases = {}

    def causal(t):
        return torch.triu(torch.full((t, t), -1e9, device="cuda"), diagonal=1)[None, None]

    def keypad(t):
        return keypad_bias(torch, gen, B, t)

    def fwd_case(name, t, heads, bias_fn, rate, path):
        dh = D // heads
        readings = Bf16Readings()
        for draw in range(BF16_DRAWS):
            q, k, v = (torch.randn(B, t, D, device="cuda", generator=gen) for _ in range(3))
            bias = bias_fn(t)
            seed = 1000 + draw

            def fwd(bf16=True):
                return attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, False,
                                                     path, bf16=bf16)[0]

            def plain():
                if path == "long":
                    return attention_fwd_stats_streamed_plain(
                        q, k, v, bias, seed, heads, rate, key_chunk(path, dh), True)[0]
                return attention_fwd_stats_plain(q, k, v, bias, seed, heads, rate, True)[0]

            with torch.no_grad():
                got, fp32, want = fwd(), fwd(False), plain()
                require(torch.equal(fwd(), got), f"{name}: two bf16 calls differ")
                require(torch.isfinite(got).all().item(), f"{name}: non-finite output")
                rows = (q[:OB], k[:OB], v[:OB], bias[:OB], seed, heads, rate)
                readings.draw([(got, fp32, want,
                                bf16_attention_kernel_oracle(torch, *rows, key_chunk(path, dh)),
                                bf16_attention_oracle(torch, *rows))])
                stats = attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, True,
                                                      path, bf16=True)
                want_stats = attention_fwd_stats_plain(q[:OB], k[:OB], v[:OB], bias[:OB],
                                                       seed, heads, rate, True)
                for n, g, w in zip(("row_max", "row_inv_sum"), stats[1:], want_stats[1:]):
                    atol = LONG_STATS_ATOL[n] if path == "long" else STATS_ATOL
                    require(torch.allclose(g[:OB], w, atol=atol, rtol=STATS_RTOL),
                            f"{name}: bf16 {n} differs by {(g[:OB] - w).abs().max().item()}")
                del stats, want_stats, fp32
                if draw == 0:
                    iters = 50 if t <= 600 else 20
                    rec = {"case": name, "shape": [B, t, D], "heads": heads, "rate": rate,
                           "path": path, **timings(torch, fwd, iters)}
                    rec["fp32_device_ms"] = graph_ms(torch, lambda: fwd(False))
                    rec["plain_ms"] = cuda_ms(torch, plain, *((10, 2) if t <= 600 else (3, 1)))
                    qh, kh, vh = (x.view(B, t, heads, dh).transpose(1, 2).to(torch.bfloat16)
                                  for x in (q, k, v))
                    mask = bias.to(torch.bfloat16)
                    rec.update(timings(torch, lambda: F.scaled_dot_product_attention(
                        qh, kh, vh, attn_mask=mask, dropout_p=rate), iters, library=True))
                    rec["bound_ms"], rec["bound_by"] = attention_bound(
                        B, t, D, heads, bias.numel(), BF16_TENSOR_FLOPS)
                    del qh, kh, vh, mask
        rec.update(readings.verdict(name), draws=BF16_DRAWS)
        emit({"kernel_case_bf16": rec})
        cases[name] = rec

    def bwd_case(name, t, heads, bias_fn, rate, path):
        dh = D // heads
        readings = Bf16Readings()
        for draw in range(BF16_DRAWS):
            q, k, v, dout = (torch.randn(B, t, D, device="cuda", generator=gen)
                             for _ in range(4))
            bias = bias_fn(t)
            seed = 2000 + draw
            with torch.no_grad():
                out, m, inv = attention_fwd_stats_plain(q, k, v, bias, seed, heads, rate, True)

                def bwd(bf16=True):
                    return attention_ops._launch_backward(q, k, v, bias, out, m, inv, dout,
                                                          seed, heads, rate, path, bf16=bf16)

                def plain():
                    return attention_bwd_plain(q, k, v, bias, out, m, inv, dout, seed, heads,
                                               rate, True)

                got, fp32, want = bwd(), bwd(False), plain()
                require(all(torch.equal(a, b) for a, b in zip(bwd(), got)),
                        f"{name}: two bf16 backward calls differ")
                require(all(torch.isfinite(g).all().item() for g in got),
                        f"{name}: non-finite gradient")
                oracle = bf16_attention_bwd_oracle(torch, q[:OB], k[:OB], v[:OB], bias[:OB],
                                                   out[:OB], dout[:OB], seed, heads, rate)
                readings.draw(list(zip(got, fp32, want, oracle, oracle)))
                del oracle, fp32
                if draw == 0:
                    rec = {"case": name, "shape": [B, t, D], "heads": heads, "rate": rate,
                           "path": path, **timings(torch, bwd, 20)}
                    rec["fp32_device_ms"] = graph_ms(torch, lambda: bwd(False))
                    rec["plain_ms"] = cuda_ms(torch, plain, 3, 1)
            if draw == 0:  # the library's backward: forward + backward less the forward
                leaves = [x.view(B, t, heads, dh).transpose(1, 2).to(torch.bfloat16)
                          .detach().requires_grad_() for x in (q, k, v)]
                mask = bias.to(torch.bfloat16)
                g16 = dout.view(B, t, heads, dh).transpose(1, 2).to(torch.bfloat16)

                def sdpa_fwd():
                    return F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                                          dropout_p=rate)

                both = timings(torch, lambda: torch.autograd.grad(sdpa_fwd(), leaves, g16),
                               20, library=True)
                with torch.no_grad():
                    fwd_only = timings(torch, sdpa_fwd, 20, library=True)
                rec.update({key: both[key] - fwd_only[key] for key in both})
                rec["bound_ms"], rec["bound_by"] = attention_bwd_bound(
                    B, t, D, heads, bias.numel(), BF16_TENSOR_FLOPS)
                del leaves, g16, mask
        rec.update(readings.verdict(name), draws=BF16_DRAWS)
        emit({"kernel_case_bf16": rec})
        cases[name] = rec

    for t in (150, 20):
        for rate in (0.0, 0.5):
            fwd_case(f"bf16_causal_T{t}_h8_rate{rate}", t, 8, causal, rate, "sweep")
    for t in (600, 1200):
        fwd_case(f"bf16_long_keypad_T{t}_h4_rate0.1", t, 4, keypad, 0.1, "long")
    torch.cuda.empty_cache()
    bwd_case("bf16_bwd_causal_T150_h8_rate0.5", 150, 8, causal, 0.5, "sweep")
    bwd_case("bf16_bwd_causal_T20_h8_rate0.0", 20, 8, causal, 0.0, "sweep")
    bwd_case("bf16_bwd_long_keypad_T600_h4_rate0.1", 600, 4, keypad, 0.1, "long")
    torch.cuda.empty_cache()

    H = FLAGSHIP["hid_dim"]
    for c in (1000, 2):
        name = f"bf16_scoring_pair_C{c}"
        readings = Bf16Readings()
        for draw in range(BF16_DRAWS):
            fc1 = torch.randn(H, 2 * D, device="cuda", generator=gen) * (2 * D) ** -0.5
            params = (fc1[:, :D], fc1[:, D:], torch.randn(H, device="cuda", generator=gen) * 0.1,
                      torch.randn(1, H, device="cuda", generator=gen) * H ** -0.5,
                      torch.randn(1, device="cuda", generator=gen) * 0.1)
            user, other = (torch.randn(B, D, device="cuda", generator=gen) for _ in range(2))
            items = torch.randn(B, c, D, device="cuda", generator=gen)

            def fn(bf16=True):
                return scoring_head_pair(user, other, items, *params, bf16=bf16)

            def plain():
                return scoring_head_pair_plain(user, other, items, *params, bf16=True)

            with torch.no_grad():
                got, fp32, want = fn(), fn(False), plain()
                require(all(torch.equal(a, b) for a, b in zip(fn(), got)),
                        f"{name}: two calls differ")
                oracles = [bf16_scoring_oracle(torch, u, items, *params) for u in (user, other)]
                readings.draw(list(zip(got, fp32, want, oracles, oracles)))
                if draw == 0:
                    rec = {"case": name, "shape": [B, c, D], "H": H, "users": 2,
                           **timings(torch, fn, 50),
                           "fp32_device_ms": graph_ms(torch, lambda: fn(False)),
                           "plain_ms": cuda_ms(torch, plain, 20), "library_ms": None}
                    # the bf16 function at the bf16 peak; at the fp32 mode's
                    # peak (the CUDA cores') beside it
                    rec["bound_ms"], rec["bound_by"] = scoring_bound(B, c, D, H, 2,
                                                                     BF16_TENSOR_FLOPS)
                    rec["bound_fp32_ms"] = scoring_bound(B, c, D, H, 2)[0]
        rec.update(readings.verdict(name), draws=BF16_DRAWS)
        emit({"kernel_case_bf16": rec})
        cases[name] = rec
    return cases


def bf16_step_check(torch, cfg, tcfg, train_ds, dr_ds, label, fresh=False):
    """One phase-A and one phase-B step of a kernels='cuda' bf16 model
    against the kernels='torch' bf16 model from the same state, batch and
    key, as `step_checks` holds the fp32 steps, at the bf16 limits: the
    launches of the bf16 builds, every loss within BF16_LOSS_TOL, at most
    BF16_UPDATE_SHARE of the touched table rows' and of an encoder weight's
    updated elements more than UPDATE_ATOL apart, and the table's and that
    weight's Adam moments within BF16_MOMENT_TOL of their largest value.
    The phase-B step follows the phase-A step on each model's own state or,
    with `fresh`, starts from the initial state again, so that it holds
    that step's arithmetic alone and not the bf16 rounding the two phase-A
    updates already differ by."""
    from amid_tpu_torch.data.loader import BatchIterator
    from amid_tpu_torch.train.loop import _device_pools, _to_device

    is_lazy = tcfg.lazy_table_adam
    model, state, step_a, step_b, _ = make_steps(cfg, tcfg, "cuda")
    ref, rstate, rstep_a, rstep_b, _ = make_steps(cfg, tcfg, "torch")
    ref.load_state_dict(model.state_dict())
    dense_name = DENSE_PARAM[cfg.backbone]
    rec = {"config": label, "fresh_phase_b": fresh}
    for phase, slot, ds, fn, rfn, key in (("A", 1, train_ds, step_a, rstep_a, 1234),
                                          ("B", 2, dr_ds, step_b, rstep_b, 4321)):
        if phase == "B" and fresh:
            del model, state, ref, rstate
            torch.cuda.empty_cache()
            model, state, _, fn, _ = make_steps(cfg, tcfg, "cuda")
            ref, rstate, _, rfn, _ = make_steps(cfg, tcfg, "torch")
            ref.load_state_dict(model.state_dict())
        batch = _to_device(next(iter(BatchIterator(ds, cfg.batch_size, False))), "cuda")
        pools = _device_pools(ds, "cuda")
        before = model.item_embedding.detach().clone()
        reset_counts()
        _, m = fn(state, batch, *pools, key)
        torch.cuda.synchronize()
        counts = read_counts()
        _, rm = rfn(rstate, batch, *pools, key)
        torch.cuda.synchronize()
        want = expected_launches(cfg, train_steps=1, lazy_adam=is_lazy)
        require(counts == want, f"{label} phase {phase}: launches {counts}, want {want}")
        require(all(math.isfinite(float(v)) for v in m.values()),
                f"{label} phase {phase}: losses {m}")
        diffs = {k: abs(float(v) - float(rm[k])) for k, v in m.items()}
        moved = (model.item_embedding.detach() != before).any(dim=1)
        shares = {}
        for name, got_p, want_p in (
                ("touched_table_rows", model.item_embedding.detach()[moved],
                 ref.item_embedding.detach()[moved]),
                (dense_name, dict(model.named_parameters())[dense_name].detach(),
                 dict(ref.named_parameters())[dense_name].detach())):
            shares[name] = ((got_p - want_p).abs() > UPDATE_ATOL).float().mean().item()
        rels = {k: rel_to_max(v, moments_of(rstate, slot, is_lazy, dense_name)[k])
                for k, v in moments_of(state, slot, is_lazy, dense_name).items()}
        rec[f"phase_{phase}"] = {"launches": counts, "loss_diff": diffs,
                                 "losses": {k: float(v) for k, v in m.items()},
                                 "rows_moved": int(moved.sum()),
                                 "update_mismatch_share": shares, "moment_rel_err": rels}
        emit({"train_steps_bf16": {"config": label, "phase": phase, **rec[f"phase_{phase}"]}})
        require(int(moved.sum()) > 0, f"{label} phase {phase}: no table row moved")
        require(max(diffs.values()) <= BF16_LOSS_TOL,
                f"{label} phase {phase}: kernel vs plain losses {diffs}")
        require(max(shares.values()) <= BF16_UPDATE_SHARE,
                f"{label} phase {phase}: updates differ from plain: {shares}")
        require(max(rels.values()) <= BF16_MOMENT_TOL,
                f"{label} phase {phase}: moments differ from plain: {rels}")
    return rec


def replayed_phase_a(torch, cfg, tcfg, ds):
    """Wall ms, device ms (a trace) and peak device memory of the fast
    loops' replayed phase-A steps over `ds` (`profile_step.py`'s
    `step_kinds` and `measure`; a chunk is one pass over the batches, and
    at least 16 steps are timed); the memory allocated before, which the
    peak includes."""
    from amid_tpu_torch.profile_step import measure, step_kinds
    from amid_tpu_torch.train.graphs import GraphPool

    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    pool = GraphPool("cuda")
    try:
        fn, per_call = step_kinds(cfg, tcfg, ds, True, pool)["phase_a"]
        rec = measure(fn, per_call, max(1, -(-16 // per_call)), top=3)
        rec["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
        rec["allocated_before_bytes"] = before
    finally:
        pool.close()
    torch.cuda.empty_cache()
    return rec


def remat_step_check(torch, cfg, tcfg, ds, label):
    """One phase-A step from one key (dropout 0.5) with and without remat,
    from the same weights, batch and key: every loss, every updated
    parameter and both Adam moments of every leaf equal bit for bit (the
    moments carry every gradient); the remat step launches each attention
    forward twice (its recompute in the backward)."""
    from amid_tpu_torch.data.loader import BatchIterator
    from amid_tpu_torch.train.loop import _device_pools, _to_device

    batch = _to_device(next(iter(BatchIterator(ds, cfg.batch_size, False))), "cuda")
    pools = _device_pools(ds, "cuda")
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        _, state, step_a, _, _ = make_steps(c, tcfg, "cuda")
        reset_counts()
        _, m = step_a(state, batch, *pools, 4321)
        torch.cuda.synchronize()
        counts = read_counts()
        want = expected_launches(c, train_steps=1, lazy_adam=tcfg.lazy_table_adam)
        require(counts == want, f"{label} remat={remat}: launches {counts}, want {want}")
        out.append((m, state, counts))
    (m0, s0, _), (m1, s1, counts) = out
    differ = [k for k, v in m0.items() if not torch.equal(v, m1[k])]
    for name in s0.params:
        for what, a, b in (("param", s0.params[name], s1.params[name]),
                           ("mu", s0.opt_state.mu[name], s1.opt_state.mu[name]),
                           ("nu", s0.opt_state.nu[name], s1.opt_state.nu[name])):
            if not torch.equal(a, b):
                differ.append(f"{what} {name}")
    require(not differ, f"{label}: remat and no remat differ: {differ[:6]}")
    rec = {"config": label, "bit_equal": True, "leaves": len(s0.params),
           "launches_remat": counts, "loss": float(m1["loss"])}
    emit({"remat_step": rec})
    return rec


BF16_CROSS_REL = 1e-2  # the two bf16 forward paths' outputs, ||a - b|| / ||b||
BF16_CROSS_BWD_REL = 1e-3  # the two bf16 backward paths' gradients


def bf16_crossover_sweeps(torch, gen):
    """Phase 10(b): the bf16 routes' crossovers, the sweeps of phase 2 with
    the bf16 kernels: both forward paths' `device_ms` at B=256, D=128, rate
    0, key padding and causal, T in BF16_FWD_SWEEP_T at dh 32 and 16
    (`fwd_crossover_bf16`), both backward paths' at T in BF16_BWD_SWEEP_T
    for the head widths of BWD_SWEEP_HEADS wherever the bf16 one-sweep
    kernel holds the shape, key padding, and causal at dh=16 up to T=600
    (`bwd_crossover_bf16`): the numbers behind the "bf16" tables of
    `ops/attention.py`'s LONG_FWD_FASTER_FROM and LONG_FASTER_FROM. The two
    forwards round exp(S - m) at their own stages (32 and 64 keys), so their
    outputs agree to bf16 rounding (BF16_CROSS_REL); the two backwards
    round at the same points (BF16_CROSS_BWD_REL)."""
    from amid_tpu_torch.ops import attention as attention_ops
    from amid_tpu_torch.ops.attention import (
        attention_fwd_stats_plain, backward_route, forward_route, long_faster, sweep_fits,
    )

    B, D = 256, 128
    recs = []

    def causal(t):
        return torch.triu(torch.full((t, t), -1e9, device="cuda"), diagonal=1)[None, None]

    for heads in (4, 8):
        dh = D // heads
        for kind in ("keypad", "causal"):
            for t in BF16_FWD_SWEEP_T:
                q, k, v = (torch.randn(B, t, D, device="cuda", generator=gen) for _ in range(3))
                bias = keypad_bias(torch, gen, B, t) if kind == "keypad" else causal(t)
                outs, ms = {}, {}
                for p in ("sweep", "long"):
                    def fwd(p=p):
                        return attention_ops._launch_forward(q, k, v, bias, 0, heads, 0.0, False,
                                                             p, bf16=True)[0]
                    with torch.no_grad():
                        outs[p] = fwd()
                    ms[p] = graph_ms(torch, fwd)
                rel = rel_norm(outs["long"], outs["sweep"])
                require(rel <= BF16_CROSS_REL,
                        f"fwd_crossover_bf16 T={t} dh={dh} {kind}: the paths differ by {rel}")
                rec = {"T": t, "dh": dh, "bias": kind, "route": forward_route(t, dh, "bf16"),
                       "measured_faster": min(ms, key=ms.get),
                       **{f"{p}_device_ms": x for p, x in ms.items()}, "rel_diff": rel}
                emit({"fwd_crossover_bf16": rec})
                recs.append(("fwd", rec))
                del q, k, v, bias, outs

    def bwd_pair(t, heads, bias, paths):
        q, k, v, dout = (torch.randn(B, t, D, device="cuda", generator=gen) for _ in range(4))
        with torch.no_grad():
            out, m, inv = attention_fwd_stats_plain(q, k, v, bias, 0, heads, 0.0, True)
        grads, ms = {}, {}
        for p in paths:
            def bwd(p=p):
                return attention_ops._launch_backward(q, k, v, bias, out, m, inv, dout, 0,
                                                      heads, 0.0, p, bf16=True)
            grads[p] = bwd()
            ms[p] = graph_ms(torch, bwd)
        rel = 0.0
        if len(paths) == 2:
            rel = max(rel_norm(a, b) for a, b in zip(grads["long"], grads["sweep"]))
            require(rel <= BF16_CROSS_BWD_REL,
                    f"bwd_crossover_bf16 T={t} heads={heads}: the paths differ by {rel}")
        return ms, rel

    for heads in BWD_SWEEP_HEADS:
        dh = D // heads
        for t in BF16_BWD_SWEEP_T:
            if not sweep_fits(t, dh, "bf16"):
                continue
            ms, rel = bwd_pair(t, heads, keypad_bias(torch, gen, B, t), ("sweep", "long"))
            rec = {"T": t, "dh": dh, "bias": "keypad", "route": backward_route(t, dh, "bf16"),
                   "long_faster": long_faster(t, dh, "bf16"),
                   "measured_faster": min(ms, key=ms.get),
                   **{f"{p}_device_ms": x for p, x in ms.items()}, "rel_diff": rel}
            emit({"bwd_crossover_bf16": rec})
            recs.append(("bwd", rec))
            torch.cuda.empty_cache()
    for t in (*BF16_BWD_SWEEP_T, 600):
        paths = ("sweep", "long") if sweep_fits(t, 16, "bf16") else ("long",)
        ms, rel = bwd_pair(t, 8, causal(t), paths)
        rec = {"T": t, "dh": 16, "bias": "causal", "route": backward_route(t, 16, "bf16"),
               "long_faster": long_faster(t, 16, "bf16"), "measured_faster": min(ms, key=ms.get),
               **{f"{p}_device_ms": x for p, x in ms.items()}, "rel_diff": rel}
        emit({"bwd_crossover_bf16": rec})
        recs.append(("bwd", rec))
        torch.cuda.empty_cache()
    return recs


DRIFT_EVERY = 10  # bf16_drift: the loss gap's and the oracle checks' cadence
DRIFT_LOSS_REL = 0.01  # the bf16 pair's final losses within 1% of each other
# bf16_drift's runs: (config, ModelConfig overrides of FLAGSHIP, modes,
# phase-A steps). BERT4Rec (encoder T=300, dh=32) runs the bf16 one-head
# forward and the long backward (the routes' bf16 tables), SASRec (dh=16)
# the one-head pair. fp32 is the control pair, on BERT4Rec only, and SASRec
# takes 50 steps (the script's time)
DRIFT_RUNS = (
    ("bert4rec_T150_dense", {"seq_len": 150, **BACKBONES["bert4rec"]}, ("bf16", "fp32"), 100),
    ("sasrec_T150_dense", {"seq_len": 150}, ("bf16",), 50),
)
# the bf16 kernels on the runs' own attention inputs against the fp64
# oracles of their rounding, by direction and path: the kernel_oracle limits
# of the path's cases with dropout (both models train with it)
DRIFT_KERNEL_LIMITS = {("fwd", "sweep"): BF16_LIMITS["bf16_causal_T150_h8_rate0.5"][0],
                       ("fwd", "long"): BF16_LIMITS["bf16_long_keypad_T600_h4_rate0.1"][0],
                       ("bwd", "sweep"): BF16_LIMITS["bf16_bwd_causal_T150_h8_rate0.5"][0],
                       ("bwd", "long"): BF16_LIMITS["bf16_bwd_long_keypad_T600_h4_rate0.1"][0]}


def trajectory_attention(torch, probe, model, batch, pools, key, gen):
    """`probe` (a kernels='cuda' model, its state and its phase-A step),
    handed `model`'s weights, takes a step on `batch` with `key`, and its
    first attention block's inputs are kept. On them, the bf16 forward
    kernel against the fp64 oracle of its own rounding, and the bf16
    backward kernel (fed the plain residuals and a drawn dO) against its
    oracle, on the first ORACLE_ROWS rows: the norm ratios, by direction."""
    from amid_tpu_torch.ops import attention as attention_ops
    from amid_tpu_torch.ops.attention import (
        attention_fwd_stats_plain, backward_route, forward_route,
    )

    net, state, step = probe
    net.load_state_dict(model.state_dict())
    block = next(m for m in net.modules() if hasattr(m, "attend"))
    attend, seen = block.attend, []
    block.attend = lambda *a, **kw: seen.append(a) or attend(*a, **kw)
    try:
        step(state, batch, *pools, key)
    finally:
        block.attend = attend
    require(len(seen) > 0, "bf16_drift: the step called no attention block")
    q, k, v, bias, seed, heads, rate = (x.detach() if isinstance(x, torch.Tensor) else x
                                        for x in seen[0])
    b, t, d = q.shape
    OB = ORACLE_ROWS
    rows = (q[:OB], k[:OB], v[:OB], bias[:OB], seed, heads, rate)
    paths = {"fwd": forward_route(t, d // heads, "bf16"),
             "bwd": backward_route(t, d // heads, "bf16")}
    with torch.no_grad():
        out = attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, False,
                                            paths["fwd"], bf16=True)[0]
        own = bf16_attention_kernel_oracle(torch, *rows, key_chunk(paths["fwd"], d // heads))
        res = attention_fwd_stats_plain(q, k, v, bias, seed, heads, rate, True)
        dout = torch.randn(b, t, d, device="cuda", generator=gen)
        grads = attention_ops._launch_backward(q, k, v, bias, *res, dout, seed, heads, rate,
                                               paths["bwd"], bf16=True)
        oracle = bf16_attention_bwd_oracle(torch, *rows[:4], res[0][:OB], dout[:OB], seed,
                                           heads, rate)
    return {"T": t, "rate": rate, "paths": paths, "fwd": rel_norm(out[:OB], own),
            "bwd": max(rel_norm(g[:OB], o) for g, o in zip(grads, oracle))}


def bf16_drift_check(torch, rng):
    """Phase 10(e): how far bf16 training with the kernels parts from bf16
    training with the plain versions over many steps, for each run of
    DRIFT_RUNS: BERT4Rec at T=150, dense Adam (encoder T=300, dh=32: the
    paths the bf16 routes take), and the run.sh SASRec at T=150, dense Adam
    (dh=16: the one-head pair). The run's eager phase-A steps from one seed
    and one key a step over the same synthetic batches, with kernels='cuda'
    and kernels='torch', in bf16 and, as the control on BERT4Rec, in fp32;
    the loss gap of each pair every
    DRIFT_EVERY steps, and HIT/NDCG@10 of one evaluation of the validation
    rows at the end. The bf16 pair's final losses must lie within
    DRIFT_LOSS_REL of each other (a gap that grows step on step is a fault
    of the kernels). Neither that gap nor a loss or gradient of one step
    from shared weights tells a faulty kernel from a sound one at these
    weights: the loss sits near ln 2, and bf16 rounding moves the encoders'
    gradients as much as a dropout mask one key off does. So every
    DRIFT_EVERY steps of the bf16 kernel run, the bf16 kernels are also held
    to their fp64 oracles on that step's own attention inputs
    (`trajectory_attention`, DRIFT_KERNEL_LIMITS of the paths the routes
    take)."""
    from amid_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
    from amid_tpu_torch.data.loader import BatchIterator
    from amid_tpu_torch.data.synthetic import synth_packed
    from amid_tpu_torch.train.loop import _device_pools, _to_device
    from amid_tpu_torch.train.metrics import rank_metrics

    gen = torch.Generator(device="cuda")  # the trajectory checks' dO
    gen.manual_seed(int(rng.integers(2**31)))
    recs = {}
    for config, overrides, modes, steps in DRIFT_RUNS:
        base = ModelConfig(**{**FLAGSHIP, **overrides})
        train_ds, val_ds = (synth_packed(base, rng, n) for n in (TRAIN_ROWS, VAL_ROWS))
        batches = [_to_device(b, "cuda")
                   for b in BatchIterator(train_ds, base.batch_size, False)]
        val_batches = [_to_device(b, "cuda")
                       for b in BatchIterator(val_ds, base.batch_size, False)]
        pools = _device_pools(train_ds, "cuda")
        val_pools = _device_pools(val_ds, "cuda")
        rec = {"config": config, "steps": steps}
        kernel_readings = {}
        t0 = time.perf_counter()
        for mode in modes:
            cfg = dataclasses.replace(base, use_bf16=mode == "bf16")
            tcfg = TrainConfig(epochs=1, seeds=1, model_dir="", lazy_table_adam=False,
                               nan_policy="halt", checkpoint=False, model=cfg,
                               data=DataConfig(neg_nums=999))
            losses, evals = {}, {}
            for kernels in ("cuda", "torch"):
                model, state, step_a, _, eval_step = make_steps(cfg, tcfg, kernels)
                # the kernel model that takes the bf16 kernel run's attention inputs
                probe = make_steps(cfg, tcfg, "cuda")[:3] if (
                    mode, kernels) == ("bf16", "cuda") else None
                got = []
                for i in range(steps):
                    batch = batches[i % len(batches)]
                    if probe is not None and (i + 1) % DRIFT_EVERY == 0:
                        kernel_readings[str(i + 1)] = trajectory_attention(
                            torch, probe, model, batch, pools, 7000 + i, gen)
                    _, m = step_a(state, batch, *pools, 7000 + i)
                    got.append(m["loss"])
                del probe
                losses[kernels] = [float(x) for x in torch.stack(got).cpu()]
                ranks = [eval_step(b, *val_pools, 9000 + i)["ranks_fixed"]
                         for i, b in enumerate(val_batches)]
                metrics = rank_metrics(torch.cat(ranks).cpu().numpy())
                evals[kernels] = {k: metrics[k] for k in ("hit_10", "ndcg_10")}
                del model, state, step_a, eval_step
                torch.cuda.empty_cache()
            require(all(math.isfinite(x) for run in losses.values() for x in run),
                    f"bf16_drift {config} {mode}: a non-finite loss")
            gaps = [abs(a - b) for a, b in zip(losses["cuda"], losses["torch"])]
            rec[mode] = {
                "loss_gap_every": {str(i + 1): gaps[i]
                                   for i in range(DRIFT_EVERY - 1, steps, DRIFT_EVERY)},
                "final_loss": {k: run[-1] for k, run in losses.items()},
                "final_rel_gap": gaps[-1] / abs(losses["torch"][-1]),
                "eval": evals}
        limits = {what: DRIFT_KERNEL_LIMITS[(what, path)]
                  for what, path in kernel_readings[str(DRIFT_EVERY)]["paths"].items()}
        rec["bf16"]["kernel_oracle_every"] = kernel_readings
        rec["bf16"]["kernel_oracle_limits"] = limits
        rec["seconds"] = time.perf_counter() - t0
        emit({"bf16_drift": rec})
        for what, limit in limits.items():
            worst = max(x[what] for x in kernel_readings.values())
            require(worst <= limit, f"bf16_drift {config}: the bf16 {what} kernel reads "
                                    f"{worst} from its fp64 oracle on the run's own inputs, "
                                    f"above {limit}")
        require(rec["bf16"]["final_rel_gap"] <= DRIFT_LOSS_REL,
                f"bf16_drift {config}: the bf16 pair's final losses are "
                f"{rec['bf16']['final_rel_gap']} apart (relative), above {DRIFT_LOSS_REL}")
        recs[config] = rec
        del batches, val_batches, pools, val_pools
        torch.cuda.empty_cache()
    return recs


def precision_phase(torch, rng):
    """Phase 10: the precision flags at the run.sh width. (b) `--bf16 True`
    on the run.sh model at T=20 (lazy, quirk) and T=150 (dense, pairwise):
    `run_seed` on the fast loops (finite losses, metrics in [0, 1], the bf16
    builds' launches), one eager phase-A and phase-B step against the
    kernels='torch' bf16 model (`bf16_step_check`), replayed steps bit-equal
    to eager ones, the feature pass against the fp32 model's, and the
    replayed phase A beside fp32's. (c) BERT4Rec at T=150 under `--bf16
    True` (encoder T=300, dh=32: the bf16 routes take the one-head forward
    and the long backward): `run_seed`,
    the step check, replayed steps bit-equal to eager ones, the replayed
    phase A beside fp32's. (d) `--remat
    True` on the run.sh model at T=150, dense: one phase-A step with and
    without remat bit-equal, replayed remat steps bit-equal to eager ones,
    and the replayed phase A's time and peak memory with and without remat
    at the batches of REMAT_BATCHES."""
    import shutil
    import tempfile

    from amid_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
    from amid_tpu_torch.data.synthetic import synth_packed
    from amid_tpu_torch.models.amid import build_model
    from amid_tpu_torch.serve import user_representations
    from amid_tpu_torch.train.loop import run_seed

    runs = {}

    def tcfg_of(cfg, lazy_adam, work):
        return TrainConfig(epochs=1, seeds=1, model_dir=work, lazy_table_adam=lazy_adam,
                           nan_policy="halt", checkpoint=False, model=cfg,
                           data=DataConfig(neg_nums=999))

    configs = [("T20_lazy", dict(seq_len=20), True),
               ("T150_dense_pairwise", dict(seq_len=150, comp_broadcast_quirk=False), False),
               ("bert4rec_T150_dense", dict(seq_len=150, **BACKBONES["bert4rec"]), False)]
    for name, kw, lazy_adam in configs:
        label = f"bf16_{name}"
        cfg = ModelConfig(**{**FLAGSHIP, **kw, "use_bf16": True})
        train_ds, val_ds, dr_ds = (synth_packed(cfg, rng, n)
                                   for n in (TRAIN_ROWS, VAL_ROWS, DR_ROWS))
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        tcfg = tcfg_of(cfg, lazy_adam, work)
        rec = {}
        try:
            reset_counts()
            t0 = time.perf_counter()
            best = run_seed(tcfg, 0, train_ds, val_ds, dr_ds)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            rec["launches"] = read_counts()
            check_run(f"{label} run_seed fast", cfg, lazy_adam, rec["launches"], best,
                      {"loop": "fast", "seconds": seconds})
        finally:
            shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
        rec["train_steps"] = bf16_step_check(torch, cfg, tcfg, train_ds, dr_ds, label)
        rec["graph_steps"] = graph_checks(torch, cfg, tcfg, train_ds, val_ds, dr_ds, label,
                                          exact=True, evaluate=False)
        torch.cuda.empty_cache()
        gaps = {}
        if cfg.backbone == "sasrec":
            batch = make_batch(cfg, rng)
            feats = []
            for c in (cfg, dataclasses.replace(cfg, use_bf16=False)):
                model = build_model(c, seed=0)
                feats.append(user_representations(model, batch))
                del model
            gap = max((a - b).abs().max().item() for a, b in zip(*feats))
            scale = max(b.abs().max().item() for b in feats[1])
            require(gap <= BF16_FEATURE_TOL * scale,
                    f"{label}: bf16 features {gap} from fp32's (largest {scale})")
            gaps = {"feature_gap": gap, "feature_scale": scale}
            rec.update(gaps)
        timing = {}
        for mode, c in (("bf16", cfg), ("fp32", dataclasses.replace(cfg, use_bf16=False))):
            timing[mode] = replayed_phase_a(torch, c, tcfg, train_ds)
        rec["replayed_phase_a"] = timing
        emit({"bf16_model": {"config": label, **gaps,
                             **{f"{m}_{k}": v[k] for m, v in timing.items()
                                for k in ("wall_ms_per_step", "device_ms_per_step",
                                          "device_idle_share")}}})
        runs[label] = rec
        torch.cuda.empty_cache()

    # (d) remat on the run.sh model at T=150, dense Adam
    cfg = ModelConfig(**{**FLAGSHIP, "remat": True})
    train_ds, val_ds, dr_ds = (synth_packed(cfg, rng, n) for n in (TRAIN_ROWS, VAL_ROWS,
                                                                  DR_ROWS))
    tcfg = tcfg_of(cfg, False, "")
    rec = {"step": remat_step_check(torch, cfg, tcfg, train_ds, "remat_T150_dense")}
    rec["graph_steps"] = graph_checks(torch, cfg, tcfg, train_ds, val_ds, dr_ds,
                                      "remat_T150_dense", exact=True, evaluate=False)
    for bs in REMAT_BATCHES:
        for remat in (False, True):
            c = dataclasses.replace(cfg, batch_size=bs, remat=remat)
            ds = synth_packed(c, rng, max(TRAIN_ROWS, 4 * bs))
            t = replayed_phase_a(torch, c, tcfg_of(c, False, ""), ds)
            emit({"remat_timing": {"batch": bs, "remat": remat,
                                   **{k: t[k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                                        "device_idle_share",
                                                        "max_memory_allocated_bytes",
                                                        "allocated_before_bytes")}}})
            rec[f"B{bs}_remat{remat}"] = t
    runs["remat_T150_dense"] = rec
    return runs


# ---------------------------------------------------------------------------
# phase 11: the parallel layer on the card (a world of one NCCL rank)
# ---------------------------------------------------------------------------

MESH_ROWS = (1024, 512, 1024)  # train, val, DR rows: 4 + 4 steps, 2 evaluation batches
MESH_METRIC_TOL = 1e-5  # a mesh run's metrics against the same run off the mesh
OFFSET_ROWS, OFFSET_B0 = 64, 40  # K1's row-offset check: the batch, and its rows [b0:]
# K1's bf16 builds against their plain bf16 versions: the kernel_plain limits
# of BF16_LIMITS' cases at these paths and shapes
OFFSET_BF16_LIMITS = {("fwd", "sweep"): BF16_LIMITS["bf16_causal_T150_h8_rate0.5"][1],
                      ("fwd", "long"): BF16_LIMITS["bf16_long_native"][1],
                      ("bwd", "sweep"): BF16_LIMITS["bf16_bwd_causal_T150_h8_rate0.5"][1],
                      ("bwd", "long"): BF16_LIMITS["bf16_bwd_long_native"][1]}


def row_offset_checks(torch, gen):
    """K1's dropout row offset on every path (one-head and long, forward and
    backward, fp32 and bf16 builds), dropout 0.1: a launch on rows [b0:] with
    row_offset=b0 must equal, bit for bit, rows [b0:] of a launch on the
    whole batch at offset 0 (out and row statistics; dq, dk, dv), and the
    kernel at that offset its plain version at that offset (fp32: ATOL/RTOL,
    bwd_atol; bf16: the case's kernel_plain limit). The same rows at offset
    0 must differ: the offset keys the masks."""
    from amid_tpu_torch.ops import attention as attention_ops
    from amid_tpu_torch.ops.attention import (
        attention_bwd_plain, attention_fwd_stats_plain, attention_fwd_stats_streamed_plain,
    )

    B, D, b0, rate, seed = OFFSET_ROWS, 128, OFFSET_B0, 0.1, 4321
    rows = slice(b0, None)
    out = {}
    for path, t, heads in (("sweep", 150, 8), ("long", 600, 4)):
        dh = D // heads
        q, k, v, g = (torch.randn(B, t, D, device="cuda", generator=gen) for _ in range(4))
        if path == "sweep":
            bias = torch.triu(torch.full((t, t), -1e9, device="cuda"), diagonal=1)[None, None]
            part_bias = bias
        else:
            bias = keypad_bias(torch, gen, B, t)
            part_bias = bias[rows]
        for bf16 in (False, True):
            label = f"{path}_T{t}_h{heads}" + ("_bf16" if bf16 else "")
            with torch.no_grad():
                whole = attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, True,
                                                      path, bf16=bf16)
                part = attention_ops._launch_forward(q[rows], k[rows], v[rows], part_bias,
                                                     seed, heads, rate, True, path, bf16=bf16,
                                                     row_offset=b0)
                unshifted = attention_ops._launch_forward(q[rows], k[rows], v[rows], part_bias,
                                                          seed, heads, rate, False, path,
                                                          bf16=bf16)[0]
                fwd_equal = all(torch.equal(p, w[rows]) for p, w in zip(part, whole))
                require(fwd_equal, f"row offset {label}: the forward on rows [{b0}:] at "
                                   f"row_offset={b0} is not the whole launch's rows")
                require(not torch.equal(unshifted, whole[0][rows]),
                        f"row offset {label}: offset 0 drew the same masks")
                args = (q[rows], k[rows], v[rows], part_bias, seed, heads, rate)
                if path == "long":
                    plain = attention_fwd_stats_streamed_plain(
                        *args, key_chunk(path, dh) if bf16 else 64, bf16, row_offset=b0)
                else:
                    plain = attention_fwd_stats_plain(*args, bf16, row_offset=b0)
                if bf16:
                    fwd_err = rel_norm(part[0], plain[0])
                    require(fwd_err <= OFFSET_BF16_LIMITS[("fwd", path)],
                            f"row offset {label}: forward vs plain {fwd_err}")
                else:
                    fwd_err = (part[0] - plain[0]).abs().max().item()
                    require(torch.allclose(part[0], plain[0], atol=ATOL, rtol=RTOL),
                            f"row offset {label}: forward vs plain {fwd_err}")
                # the backward from the plain forward's residuals of the whole batch
                res = attention_fwd_stats_plain(q, k, v, bias, seed, heads, rate, bf16)
                grads = attention_ops._launch_backward(q, k, v, bias, *res, g, seed, heads, rate,
                                                       path, bf16=bf16)
                part_res = [x[rows] for x in res]
                part_grads = attention_ops._launch_backward(
                    q[rows], k[rows], v[rows], part_bias, *part_res, g[rows], seed, heads, rate,
                    path, bf16=bf16, row_offset=b0)
                bwd_equal = all(torch.equal(p, w[rows]) for p, w in zip(part_grads, grads))
                require(bwd_equal, f"row offset {label}: the backward on rows [{b0}:] at "
                                   f"row_offset={b0} is not the whole launch's rows")
                plain_grads = attention_bwd_plain(q[rows], k[rows], v[rows], part_bias,
                                                  *part_res, g[rows], seed, heads, rate, bf16,
                                                  row_offset=b0)
                if bf16:
                    bwd_err = max(rel_norm(p, w) for p, w in zip(part_grads, plain_grads))
                    require(bwd_err <= OFFSET_BF16_LIMITS[("bwd", path)],
                            f"row offset {label}: backward vs plain {bwd_err}")
                else:
                    bwd_err = max((p - w).abs().max().item()
                                  for p, w in zip(part_grads, plain_grads))
                    require(all(torch.allclose(p, w, atol=bwd_atol(t, dh), rtol=RTOL)
                                for p, w in zip(part_grads, plain_grads)),
                            f"row offset {label}: backward vs plain {bwd_err}")
            rec = {"case": label, "rows": B, "row_offset": b0, "rate": rate,
                   "forward_bit_equal": fwd_equal, "backward_bit_equal": bwd_equal,
                   ("fwd_rel_err" if bf16 else "fwd_max_abs_err"): fwd_err,
                   ("bwd_rel_err" if bf16 else "bwd_max_abs_err"): bwd_err}
            emit({"row_offset": rec})
            out[label] = rec
    return out


def shard_scatter_check(torch, gen):
    """K2 and K3 on the lazy Adam's shard-local ids: the second of two row
    shards of the 894,820-row table (V_local = 447,410, lo = V_local), the
    step's sorted unique ids minus lo (the first shard's negative, the
    sentinel past V_local), against the plain versions, bit for bit."""
    from amid_tpu_torch.ops.scatter import (
        scatter_set_unique, scatter_set_unique3, scatter_set_unique3_plain,
        scatter_set_unique_plain,
    )

    v_local, width, n = FLAGSHIP["item_length"], FLAGSHIP["emb_dim"], 11264
    lo = v_local
    uids = torch.randperm(2 * v_local, device="cuda", generator=gen)[:n - 64].sort().values
    uids = torch.cat([uids, torch.full((64,), 2 * v_local, device="cuda", dtype=uids.dtype)])
    ids = uids - lo
    rows = [torch.randn(n, width, device="cuda", generator=gen) for _ in range(3)]
    base = [torch.randn(v_local, width, device="cuda", generator=gen) for _ in range(3)]
    got, want = [b.clone() for b in base], [b.clone() for b in base]
    scatter_set_unique3(*got, ids, *rows)
    scatter_set_unique3_plain(*want, ids, *rows)
    got1, want1 = base[0].clone(), base[0].clone()
    scatter_set_unique(got1, ids, rows[0])
    scatter_set_unique_plain(want1, ids, rows[0])
    equal = all(torch.equal(a, b) for a, b in zip(got + [got1], want + [want1]))
    mine = int(((ids >= 0) & (ids < v_local)).sum())
    require(equal, "shard-local scatter: the kernels differ from the plain versions")
    require(0 < mine < n - 64 and bool((ids < 0).any()), "shard-local scatter: ids not mixed")
    rec = {"ids": n, "written_here": mine, "negative": int((ids < 0).sum()), "bit_equal": equal}
    emit({"shard_scatter": rec})
    return rec


def mesh_step_timing(torch, cfg, tcfg, ds, label, mesh):
    """The replayed phase-A step off and on the mesh
    (`amid_tpu_torch/mesh_check.py::phase_a_timing`, a chunk of 10 steps):
    wall ms, device ms, the NCCL kernels' and the copies' count and device
    ms a step from the trace, peak memory."""
    from amid_tpu_torch.mesh_check import phase_a_timing

    out = {}
    for where, m in (("off_mesh", None), ("mesh", mesh)):
        rec = phase_a_timing(cfg, tcfg, ds, m)
        require(rec["device_ms_per_step"] > 0.0, f"mesh timing {label} {where}: empty trace")
        emit({"mesh_step_timing": {"config": label, "where": where, **rec}})
        out[where] = rec
    return out


def mesh_phase(torch, rng):
    """Phase 11: the parallel layer (`amid_tpu_torch/parallel/`) at the
    run.sh width on a world of one NCCL rank. K1's row offset on every path
    and K2/K3 at shard-local ids; then `run_seed` for one epoch of the DR
    schedule (MESH_ROWS) off the mesh and on a 1x1 mesh, in four cases:
    gspmd T=20 lazy (quirk), gspmd T=150 dense pairwise (K6), shard_map
    T=150 dense (per step, both runs), BERT4Rec with InterComp T=150 gspmd
    (encoder T=300: both long K1 paths). Each mesh run's metrics must equal
    the off-mesh run's at MESH_METRIC_TOL (bit equality printed), and its
    launches `expected_launches`; the gspmd runs replay the fast loops'
    graphs with the collectives captured. Then the replayed phase-A step off
    and on the mesh at T=20 and T=150 (`mesh_step_timing`)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from amid_tpu_torch.config import DataConfig, MeshConfig, ModelConfig, TrainConfig
    from amid_tpu_torch.data.synthetic import synth_packed
    from amid_tpu_torch.parallel.distributed import (
        destroy_world, free_port, initialize_distributed,
    )
    from amid_tpu_torch.parallel.mesh import make_mesh
    from amid_tpu_torch.train.loop import run_seed

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    out = {"row_offset": row_offset_checks(torch, gen),
           "shard_scatter": shard_scatter_check(torch, gen)}
    require(not dist.is_initialized(), "mesh phase: a process group exists already")
    initialize_distributed(f"localhost:{free_port()}", 1, 0)  # the card: NCCL
    require(dist.get_backend() == "nccl", f"mesh phase: backend {dist.get_backend()}")
    cases = {  # label -> (model fields, lazy Adam, mesh_impl)
        "T20_lazy_gspmd": ({"seq_len": 20}, True, "gspmd"),
        "T150_dense_pairwise_gspmd": ({"seq_len": 150, "comp_broadcast_quirk": False}, False,
                                      "gspmd"),
        "T150_dense_shard_map": ({"seq_len": 150}, False, "shard_map"),
        "bert4rec_T150_gspmd": ({**BACKBONES["bert4rec"], "seq_len": 150}, False, "gspmd"),
    }
    n_a, n_ev, n_b = (n // FLAGSHIP["batch_size"] for n in MESH_ROWS)
    try:
        for label, (fields, lazy_adam, impl) in cases.items():
            cfg = ModelConfig(**{**FLAGSHIP, **fields})
            data = [synth_packed(cfg, rng, n) for n in MESH_ROWS]
            work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
            per_step = impl == "shard_map"  # shard_map keeps the per-step loops
            base = TrainConfig(epochs=1, seeds=1, model_dir=work, lazy_table_adam=lazy_adam,
                               nan_policy="halt", checkpoint=False, model=cfg,
                               data=DataConfig(neg_nums=999), fast_train=not per_step,
                               fast_eval=not per_step)
            runs = {}
            try:
                for where, tcfg in (("off_mesh", base), ("mesh", dataclasses.replace(
                        base, use_mesh=True, mesh_impl=impl, mesh=MeshConfig(1, 1)))):
                    torch.cuda.reset_peak_memory_stats()
                    reset_counts()
                    t0 = time.perf_counter()
                    best = run_seed(tcfg, 0, *data)  # on cuda
                    torch.cuda.synchronize()
                    runs[where] = {"best": best, "seconds": time.perf_counter() - t0,
                                   "launches": read_counts(),
                                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
            finally:
                shutil.rmtree(work, ignore_errors=True)
            want = expected_launches(cfg, train_steps=n_a + n_b, eval_batches=2 * n_ev,
                                     lazy_adam=lazy_adam)
            for where, r in runs.items():
                require(r["launches"] == want,
                        f"mesh {label} {where}: launches {r['launches']}, want {want}")
            keys = [k for k in runs["off_mesh"]["best"] if k.startswith(("hit_", "ndcg_", "mrr"))]
            diff = max(abs(runs["mesh"]["best"][k] - runs["off_mesh"]["best"][k]) for k in keys)
            require(diff <= MESH_METRIC_TOL, f"mesh {label}: metrics {diff} from off the mesh")
            rec = {"config": label, "impl": impl, "mesh": [1, 1], "lazy_adam": lazy_adam,
                   "loop": "per_step" if per_step else "fast", "steps": [n_a, n_b],
                   "eval_batches": 2 * n_ev, "max_metric_diff": diff,
                   "bit_equal": diff == 0.0,
                   **{f"{k}_mrr_d1": r["best"]["mrr_d1"] for k, r in runs.items()},
                   **{f"{k}_seconds": r["seconds"] for k, r in runs.items()},
                   **{f"{k}_peak_memory_gb": r["peak_memory_gb"] for k, r in runs.items()},
                   "launches": runs["mesh"]["launches"]}
            emit({"mesh_run": rec})
            out[label] = {**rec, "launches": {name: sum(r["launches"][name]
                                                        for r in runs.values())
                                              for name in KERNELS}}
            torch.cuda.empty_cache()
        mesh = make_mesh(MeshConfig(1, 1))
        for label, fields, lazy_adam in (("T20_lazy", {"seq_len": 20}, True),
                                         ("T150_dense_pairwise",
                                          {"seq_len": 150, "comp_broadcast_quirk": False},
                                          False)):
            cfg = ModelConfig(**{**FLAGSHIP, **fields})
            tcfg = TrainConfig(model=cfg, data=DataConfig(neg_nums=999),
                               lazy_table_adam=lazy_adam)
            ds = synth_packed(cfg, rng, 2560)
            out[f"timing_{label}"] = mesh_step_timing(torch, cfg, tcfg, ds, label, mesh)
    finally:
        destroy_world()
    return out


# ---------------------------------------------------------------------------
# phase 12: K1 at every head width up to 128
# ---------------------------------------------------------------------------

# head widths of the width phase and their heads: dh 12 is SASRec's 8 heads
# at --emb_dim 96 (template 16), dh 24 and 48 BERT4Rec's 4 at 96 and 192
# (templates 32 and 64), dh 128 BERT4Rec's 4 at 512 (configuration (a))
WIDTH_HEADS = {12: 8, 24: 4, 48: 4, 128: 4}
WIDTH_T = {"sweep": 150, "long": 300}  # the main paths' lengths: the encoder at L and at 2L
# batch rows of a case: 256 at the two configurations' own shapes (dh=128 on
# the long paths with key padding, (a); dh=12 on the one-head pair, causal,
# (b)), 64 elsewhere (the phase's time)
WIDTH_MAIN = {(128, "long", "keypad"), (12, "sweep", "causal")}
WIDTH_B = {True: 256, False: 64}
# the rate-0.1 cases timed: those at the configurations' widths (the mask
# does not see the width); the others are held to their plain versions
# untimed (their time gave way to phase 13's)
WIDTH_DROPOUT_DH = (12, 128)
# the one-sweep backward at dh=128 holds T <= 80 (`sweep_fits`): its cases take 64
WIDTH_BWD_SWEEP_T128 = 64
# the fp32 long forward at dh=128 takes its in-block kernel at one query
# block a head (T <= 128) and at two (T <= 256: BERT4Rec at --emb_dim 512
# below encoder T=300) with key padding, its pre-pass kernel beyond (T=300
# above) and at two with a causal bias: each side of the cut at both biases
WIDTH_INBLOCK_T = (100, 200)
# each bf16 case is held to BF16_LIMITS of the existing case of its path and
# dropout (the one-head cases were measured at T=150 and T=20, the native
# long ones at every head width of the card tests)
WIDTH_BF16_LIMITS = {
    ("fwd", "sweep", False): "bf16_causal_T150_h8_rate0.0",
    ("fwd", "sweep", True): "bf16_causal_T150_h8_rate0.5",
    ("fwd", "long", False): "bf16_long_native",
    ("fwd", "long", True): "bf16_long_native",
    ("bwd", "sweep", False): "bf16_bwd_causal_T20_h8_rate0.0",
    ("bwd", "sweep", True): "bf16_bwd_causal_T150_h8_rate0.5",
    ("bwd", "long", False): "bf16_bwd_long_native",
    ("bwd", "long", True): "bf16_bwd_long_native",
}
# dh=128, each mode up to the T its one-head kernels hold: the fp32 forward
# T <= 216 and backward T <= 80, the bf16 ones T <= 416 and T <= 128
WIDTH_FWD_SWEEP_T = {"fp32": (20, 40, 80, 150, 200), "bf16": (20, 40, 80, 150, 200, 300, 400)}
WIDTH_BWD_SWEEP_T = {"fp32": (20, 48, 64, 80), "bf16": (20, 48, 64, 80, 96, 128)}
# configuration (b)'s CLI runs: 4 phase-A and 4 phase-B steps, 2 evaluation batches
WIDTH_CLI_ROWS = (1024, 1024, 512)  # train, DR, val


def sdpa_timings(torch, rec, q, k, v, dout, bias, heads, rate, bf16, iters=10):
    """SDPA's times at an attention case's inputs, into `rec` (its
    `library_*` keys): the forward, or (with dout) the backward as forward +
    backward less the forward; on bf16 q, k, v in the bf16 mode."""
    import torch.nn.functional as F

    b, t, d = q.shape
    dt = torch.bfloat16 if bf16 else torch.float32
    split = [x.view(b, t, heads, d // heads).transpose(1, 2).to(dt) for x in (q, k, v)]
    mask = bias.to(dt)
    if dout is None:
        with torch.no_grad():
            rec.update(timings(torch, lambda: F.scaled_dot_product_attention(
                *split, attn_mask=mask, dropout_p=rate), iters, library=True, rounds=1))
        return
    leaves = [x.detach().requires_grad_() for x in split]
    g = dout.view(b, t, heads, d // heads).transpose(1, 2).to(dt)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(*leaves, attn_mask=mask, dropout_p=rate)

    both = timings(torch, lambda: torch.autograd.grad(sdpa_fwd(), leaves, g), iters,
                   library=True, rounds=1)
    with torch.no_grad():
        fwd_only = timings(torch, sdpa_fwd, iters, library=True, rounds=1)
    rec.update({key: both[key] - fwd_only[key] for key in both})


def width_kernel_phase(torch, gen):
    """Phase 12(a): the six attention paths at each head width of
    WIDTH_HEADS (D = dh * heads, B=256), causal and key padding (batch row
    0 fully masked), rates 0 and 0.1, fp32 and bf16, at B=256 on the
    configurations' shapes (WIDTH_MAIN) and B=64 elsewhere, against their
    plain versions: the forwards at T=150 (one-head) and T=300 (long), out and the
    row statistics, and the fp32 long forward at dh=128 also at each T of
    WIDTH_INBLOCK_T (either side of its in-block cut); the backwards from
    the plain forward's residuals at T=150 (one-sweep; T=64 at dh=128) and
    T=300 (long), two calls
    bit-equal, and in fp32 at dh=128 both the kernel and the plain version
    against the plain version in fp64. fp32: ATOL / RTOL, the statistics at
    LONG_STATS_ATOL, the gradients at `bwd_atol`; bf16: one draw a case held
    to WIDTH_BF16_LIMITS (`Bf16Readings`), the fp32 build at the same inputs
    outside the kernel_oracle limit. Every case but those at rate 0.1 off
    WIDTH_DROPOUT_DH is timed: `kernel_ms`,
    `device_ms`, `host_us` (one round of 10 calls), the plain version's ms,
    SDPA's (on bf16 q, k, v in bf16; its backward as forward + backward
    less the forward) and the bound (the TF32 peak in fp32, the bf16 peak
    in bf16)."""
    from amid_tpu_torch.ops import attention as attention_ops
    from amid_tpu_torch.ops.attention import (
        attention_bwd_plain, attention_fwd_stats_plain, attention_fwd_stats_streamed_plain,
        kernel_head_dim,
    )

    OB = ORACLE_ROWS
    cases = {}

    def causal(t):
        return torch.triu(torch.full((t, t), -1e9, device="cuda"), diagonal=1)[None, None]

    def library(rec, q, k, v, dout, bias, heads, rate, bf16):
        sdpa_timings(torch, rec, q, k, v, dout, bias, heads, rate, bf16)

    def timed(dh, rate):
        return rate == 0 or dh in WIDTH_DROPOUT_DH

    def fwd_case(dh, path, kind, rate, bf16, t=None):
        heads = WIDTH_HEADS[dh]
        d, t = dh * heads, t or WIDTH_T[path]
        B = WIDTH_B[(dh, path, kind) in WIDTH_MAIN]
        mode = "bf16" if bf16 else "fp32"
        name = f"width_{mode}_fwd_{path}_{kind}_T{t}_dh{dh}_rate{rate}"
        q, k, v = (torch.randn(B, t, d, device="cuda", generator=gen) for _ in range(3))
        bias = causal(t) if kind == "causal" else keypad_bias(torch, gen, B, t)
        seed = torch.tensor([4242], dtype=torch.int64, device="cuda")

        def fwd(b16=bf16):
            return attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, False, path,
                                                 bf16=b16)[0]

        def plain():
            if path == "long":
                return attention_fwd_stats_streamed_plain(
                    q, k, v, bias, seed, heads, rate,
                    key_chunk(path, dh) if bf16 else 64, bf16)[0]
            return attention_fwd_stats_plain(q, k, v, bias, seed, heads, rate, bf16)[0]

        rec = {"case": name, "mode": mode, "path": path, "dh": dh,
               "template_dh": kernel_head_dim(dh), "heads": heads, "shape": [B, t, d],
               "bias": kind, "rate": rate}
        with torch.no_grad():
            got, want = fwd(), plain()
            require(torch.equal(fwd(), got), f"{name}: two calls differ")
            require(torch.isfinite(got).all().item(), f"{name}: non-finite output")
            stats = attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, True, path,
                                                  bf16=bf16)
            require(torch.equal(stats[0], got), f"{name}: out differs with statistics")
            want_stats = attention_fwd_stats_plain(q[:OB], k[:OB], v[:OB], bias[:OB], seed,
                                                   heads, rate, bf16)
            errs = {}
            for n, g, w in zip(("row_max", "row_inv_sum"), stats[1:], want_stats[1:]):
                errs[n] = (g[:OB] - w).abs().max().item()
                require(torch.allclose(g[:OB], w, atol=LONG_STATS_ATOL[n], rtol=STATS_RTOL),
                        f"{name}: kernel vs plain {n} max_abs_err {errs[n]}")
            rec["stats_max_abs_err"] = errs
            del stats, want_stats
            if bf16:
                readings = Bf16Readings()
                rows = (q[:OB], k[:OB], v[:OB], bias[:OB], seed, heads, rate)
                readings.draw([(got, fwd(False), want,
                                bf16_attention_kernel_oracle(torch, *rows, key_chunk(path, dh)),
                                bf16_attention_oracle(torch, *rows))])
                rec.update(readings.verdict(name, WIDTH_BF16_LIMITS[("fwd", path, rate > 0)]))
            else:
                rec["max_abs_err"] = (got - want).abs().max().item()
                require(torch.allclose(got, want, atol=ATOL, rtol=RTOL),
                        f"{name}: kernel vs plain max_abs_err {rec['max_abs_err']}")
            del got, want
            if timed(dh, rate):
                rec.update(timings(torch, fwd, 10, rounds=1))
                rec["plain_ms"] = cuda_ms(torch, plain, 3, 1)
        if timed(dh, rate):
            library(rec, q, k, v, None, bias, heads, rate, bf16)
            peak = BF16_TENSOR_FLOPS if bf16 else TF32_TENSOR_FLOPS
            rec["bound_ms"], rec["bound_by"] = attention_bound(B, t, d, heads, bias.numel(),
                                                               peak)
        emit({"kernel_case_width": rec})
        cases[name] = rec

    def bwd_case(dh, path, kind, rate, bf16):
        heads = WIDTH_HEADS[dh]
        d = dh * heads
        t = WIDTH_BWD_SWEEP_T128 if path == "sweep" and dh == 128 else WIDTH_T[path]
        B = WIDTH_B[(dh, path, kind) in WIDTH_MAIN]
        mode = "bf16" if bf16 else "fp32"
        name = f"width_{mode}_bwd_{path}_{kind}_T{t}_dh{dh}_rate{rate}"
        q, k, v, dout = (torch.randn(B, t, d, device="cuda", generator=gen) for _ in range(4))
        bias = causal(t) if kind == "causal" else keypad_bias(torch, gen, B, t)
        seed = torch.tensor([2424], dtype=torch.int64, device="cuda")
        rec = {"case": name, "mode": mode, "path": path, "dh": dh,
               "template_dh": kernel_head_dim(dh), "heads": heads, "shape": [B, t, d],
               "bias": kind, "rate": rate}
        with torch.no_grad():
            res = attention_fwd_stats_plain(q, k, v, bias, seed, heads, rate, bf16)

            def bwd(b16=bf16):
                return attention_ops._launch_backward(q, k, v, bias, *res, dout, seed, heads,
                                                      rate, path, bf16=b16)

            def plain():
                return attention_bwd_plain(q, k, v, bias, *res, dout, seed, heads, rate, bf16)

            got, want = bwd(), plain()
            require(all(torch.equal(a, b) for a, b in zip(bwd(), got)),
                    f"{name}: two backward calls differ")
            require(all(torch.isfinite(g).all().item() for g in got),
                    f"{name}: non-finite gradient")
            names = ("dq", "dk", "dv")
            if bf16:
                readings = Bf16Readings()
                oracle = bf16_attention_bwd_oracle(torch, q[:OB], k[:OB], v[:OB], bias[:OB],
                                                   res[0][:OB], dout[:OB], seed, heads, rate)
                readings.draw(list(zip(got, bwd(False), want, oracle, oracle)))
                rec.update(readings.verdict(name, WIDTH_BF16_LIMITS[("bwd", path, rate > 0)]))
                del oracle
            else:
                atol = bwd_atol(t, dh)
                rec["errs"] = {n: (g - w).abs().max().item() for n, g, w in zip(names, got, want)}
                rec["max_abs_err"] = max(rec["errs"].values())
                rec["bwd_atol"] = atol
                rec["atol_needed"] = max(((g - w).abs() - RTOL * w.abs()).max().item()
                                         for g, w in zip(got, want))
                if dh == 128:  # the kernel and the plain version against fp64
                    wide = [x[:OB].double() for x in (q, k, v, bias)]
                    exact = attention_bwd_plain(
                        *wide, *attention_fwd_stats_plain(*wide, seed, heads, rate),
                        dout[:OB].double(), seed, heads, rate)
                    live = ~(bias[:OB] <= -1e8).reshape(bias[:OB].shape[0], -1).all(dim=1)
                    live = live.expand(OB) if live.numel() == 1 else live
                    for which, grads in (("plain", want), ("kernel", got)):
                        rec[f"{which}_vs_fp64"] = {
                            n: (g[:OB][live].double() - w[live]).abs().max().item()
                            for n, g, w in zip(names, grads, exact)}
                    del exact, wide
                for n, g, w in zip(names, got, want):
                    require(torch.allclose(g, w, atol=atol, rtol=RTOL),
                            f"{name}: kernel vs plain {n} max_abs_err {rec['errs'][n]} "
                            f"(atol {atol})")
            del got, want
            if timed(dh, rate):
                rec.update(timings(torch, bwd, 10, rounds=1))
                rec["plain_ms"] = cuda_ms(torch, plain, 3, 1)
        if timed(dh, rate):
            library(rec, q, k, v, dout, bias, heads, rate, bf16)
            peak = BF16_TENSOR_FLOPS if bf16 else TF32_TENSOR_FLOPS
            rec["bound_ms"], rec["bound_by"] = attention_bwd_bound(B, t, d, heads, bias.numel(),
                                                                   peak)
        emit({"kernel_case_width": rec})
        cases[name] = rec

    for dh in WIDTH_HEADS:
        for kind in ("causal", "keypad"):
            for rate in (0.0, 0.1):
                for bf16 in (False, True):
                    for path in ("sweep", "long"):
                        fwd_case(dh, path, kind, rate, bf16)
                        bwd_case(dh, path, kind, rate, bf16)
                    torch.cuda.empty_cache()
                for t in WIDTH_INBLOCK_T if dh == 128 else ():
                    fwd_case(dh, "long", kind, rate, False, t)
    return cases


def width_crossover_sweeps(torch, gen):
    """Phase 12(b): both forward paths' `device_ms` at dh=128 (B=256, D=512,
    rate 0) at the T of WIDTH_FWD_SWEEP_T, where the mode's one-head kernel
    holds the shape, and both backward paths' at WIDTH_BWD_SWEEP_T, where
    the mode's one-sweep kernel does, key padding and causal, fp32 and bf16; the two
    paths' outputs agree (`fwd_crossover` / `bwd_crossover` records with
    "dh": 128, and their `_bf16` twins: the numbers behind the dh=128
    entries of `ops/attention.py`'s LONG_FWD_FASTER_FROM and
    LONG_FASTER_FROM). Beyond those T the kernels' shared memory alone
    sends a shape to the long paths."""
    from amid_tpu_torch.ops import attention as attention_ops
    from amid_tpu_torch.ops.attention import (
        MODES, attention_fwd_stats_plain, backward_route, forward_route, forward_max_t,
        sweep_fits,
    )

    B, D, heads, dh = 256, 512, 4, 128
    for mode in MODES:
        fwd_t, bwd_t = WIDTH_FWD_SWEEP_T[mode], WIDTH_BWD_SWEEP_T[mode]
        require(max(fwd_t) <= forward_max_t(dh, mode),
                f"the {mode} one-head forward at dh=128 holds T<={forward_max_t(dh, mode)}")
        require(sweep_fits(max(bwd_t), dh, mode),
                f"the {mode} one-sweep backward at dh=128 does not hold T={max(bwd_t)}")

    def causal(t):
        return torch.triu(torch.full((t, t), -1e9, device="cuda"), diagonal=1)[None, None]

    for bf16 in (False, True):
        mode = "bf16" if bf16 else "fp32"
        tag = "_bf16" if bf16 else ""
        for kind in ("keypad", "causal"):
            for t in WIDTH_FWD_SWEEP_T[mode]:
                q, k, v = (torch.randn(B, t, D, device="cuda", generator=gen) for _ in range(3))
                bias = keypad_bias(torch, gen, B, t) if kind == "keypad" else causal(t)
                outs, ms = {}, {}
                for p in ("sweep", "long"):
                    def fwd(p=p):
                        return attention_ops._launch_forward(q, k, v, bias, 0, heads, 0.0, False,
                                                             p, bf16=bf16)[0]
                    with torch.no_grad():
                        outs[p] = fwd()
                    ms[p] = graph_ms(torch, fwd)
                diff = (outs["long"] - outs["sweep"]).abs().max().item()
                # in bf16 the paths round exp(S - m) at chunks of 32 and stages
                # of 64 keys: each is within its kernel_plain limit of the plain
                # version, so the two within the sum of the limits
                apart = rel_norm(outs["long"], outs["sweep"])
                require(apart <= BF16_LIMITS["bf16_long_native"][1] + BF16_LIMITS[
                    "bf16_causal_T150_h8_rate0.0"][1] if bf16 else
                        torch.allclose(outs["long"], outs["sweep"], atol=ATOL, rtol=RTOL),
                        f"fwd_crossover{tag} T={t} dh=128 {kind}: the paths differ by {diff} "
                        f"(relative norm {apart})")
                emit({f"fwd_crossover{tag}": {
                    "T": t, "dh": dh, "bias": kind, "route": forward_route(t, dh, mode),
                    "measured_faster": min(ms, key=ms.get),
                    **{f"{p}_device_ms": x for p, x in ms.items()}, "max_abs_diff": diff}})
            for t in WIDTH_BWD_SWEEP_T[mode]:
                q, k, v, dout = (torch.randn(B, t, D, device="cuda", generator=gen)
                                 for _ in range(4))
                bias = keypad_bias(torch, gen, B, t) if kind == "keypad" else causal(t)
                res = attention_fwd_stats_plain(q, k, v, bias, 0, heads, 0.0, bf16)
                outs, ms = {}, {}
                for p in ("sweep", "long"):
                    def bwd(p=p):
                        return attention_ops._launch_backward(q, k, v, bias, *res, dout, 0,
                                                              heads, 0.0, p, bf16=bf16)
                    outs[p] = bwd()
                    ms[p] = graph_ms(torch, bwd)
                pairs = list(zip(outs["long"], outs["sweep"]))
                diff = max((a - b).abs().max().item() for a, b in pairs)
                apart = max(rel_norm(a, b) for a, b in pairs)
                require(apart <= BF16_LIMITS["bf16_bwd_long_native"][1] + BF16_LIMITS[
                    "bf16_bwd_causal_T20_h8_rate0.0"][1] if bf16 else
                        all(torch.allclose(a, b, atol=bwd_atol(t, dh), rtol=RTOL)
                            for a, b in pairs),
                        f"bwd_crossover{tag} T={t} dh=128 {kind}: the paths differ by {diff} "
                        f"(relative norm {apart})")
                emit({f"bwd_crossover{tag}": {
                    "T": t, "dh": dh, "bias": kind, "route": backward_route(t, dh, mode),
                    "measured_faster": min(ms, key=ms.get),
                    **{f"{p}_device_ms": x for p, x in ms.items()}, "max_abs_diff": diff}})
            torch.cuda.empty_cache()


def width_config_phase(torch, rng):
    """Phase 12(c): the widths' configurations through the entry points a
    user calls, with kernels='auto' (cuda on the card) and no refusal.
    (a) BERT4Rec at `--emb_dim 512` (4 heads of 128, FFN 512) and
    `--seq_len 150` with InterComp (encoder T=300: both long paths at
    dh=128), dense Adam, fp32 and `--bf16`: serving (the feature pass
    against kernels='torch', top-100 over the 894,820-row table, fp32),
    `run_seed` for one epoch on the fast loops with its launches, one eager
    phase-A and phase-B step and one evaluation batch against the
    kernels='torch' model (`step_checks`, `bf16_step_check`), replayed
    steps of phase A, phase B and the evaluation pass against eager ones,
    the training steps bit-equal, and the replayed phase A's wall and device
    ms. (b) the run.sh SASRec at `--emb_dim 96` (8 heads of 12: the
    one-head kernels at template width 16), T=20 with the lazy table Adam
    and T=150 dense, quirk and pairwise: `train_sr_dr.main` on CSV files
    for a few steps (WIDTH_CLI_ROWS) with `--kernels auto`, its launches,
    then the step-level checks against kernels='torch', replayed steps
    bit-equal to eager ones, serving (the feature pass against
    kernels='torch') and the replayed phase A's wall and device ms. Returns
    the records of the runs (with their launches) and of the checks."""
    import shutil
    import tempfile

    from amid_tpu_torch import train_sr_dr
    from amid_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
    from amid_tpu_torch.data.packed import load_dual_domain_csv
    from amid_tpu_torch.data.synthetic import synth_packed, write_synthetic_csvs
    from amid_tpu_torch.models.amid import head_width
    from amid_tpu_torch.train.loop import run_seed

    out = {}
    # (a) BERT4Rec at --emb_dim 512
    for bf16 in (False, True):
        label = "bert4rec_D512_T150_dense" + ("_bf16" if bf16 else "")
        cfg = ModelConfig(**{**FLAGSHIP, **BACKBONES["bert4rec"], "emb_dim": 512,
                             "seq_len": 150, "use_bf16": bf16})
        require(head_width(cfg) == 128 and cfg.enc_seq_len == 300,
                f"{label}: dh={head_width(cfg)}, encoder T={cfg.enc_seq_len}")
        rec = {}
        if not bf16:
            rec["serve"] = serve_check(torch, cfg, backbone_batch(cfg, rng), label, topk=True)
        train_ds, val_ds, dr_ds = (synth_packed(cfg, rng, n)
                                   for n in (TRAIN_ROWS, VAL_ROWS, DR_ROWS))
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        tcfg = TrainConfig(epochs=1, seeds=1, model_dir=work, lazy_table_adam=False,
                           nan_policy="halt", checkpoint=False, model=cfg,
                           data=DataConfig(neg_nums=999))
        try:
            reset_counts()
            t0 = time.perf_counter()
            best = run_seed(tcfg, 0, train_ds, val_ds, dr_ds)  # on cuda, kernels='auto'
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            rec["launches"] = read_counts()
            check_run(f"{label} run_seed fast", cfg, False, rec["launches"], best,
                      {"loop": "fast", "seconds": seconds,
                       "examples_per_s": best["examples_per_s"]})
        finally:
            shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
        if bf16:  # phase B from the initial state: see bf16_step_check
            rec["train_steps"] = bf16_step_check(torch, cfg, tcfg, train_ds, dr_ds, label,
                                                 fresh=True)
        else:
            rec["train_steps"] = step_checks(torch, cfg, tcfg, train_ds, val_ds, dr_ds, label)
        torch.cuda.empty_cache()
        rec["graph_steps"] = graph_checks(torch, cfg, tcfg, train_ds, val_ds, dr_ds, label,
                                          exact=True)
        torch.cuda.empty_cache()
        rec["replayed_phase_a"] = replayed_phase_a(torch, cfg, tcfg, train_ds)
        emit({"width_config": {"config": label, **{
            k: rec["replayed_phase_a"][k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                                    "device_idle_share",
                                                    "max_memory_allocated_bytes")},
            **({"feature_ms": rec["serve"]["feature_ms"],
                "catalog_ms_per_domain": rec["serve"]["catalog_ms_per_domain"]}
               if "serve" in rec else {})}})
        out[label] = rec
        del train_ds, val_ds, dr_ds
        torch.cuda.empty_cache()

    # (b) the run.sh SASRec at --emb_dim 96, through the CLI
    for pairwise in (False, True):
        for t, lazy_adam in ((20, True), (150, False)):
            label = (f"sasrec_D96_T{t}_{'lazy' if lazy_adam else 'dense'}"
                     + ("_pairwise" if pairwise else ""))
            cfg = ModelConfig(**{**FLAGSHIP, "emb_dim": 96, "seq_len": t,
                                 "comp_broadcast_quirk": not pairwise})
            require(head_width(cfg) == 12, f"{label}: dh={head_width(cfg)}")
            work = tempfile.mkdtemp(prefix="chip_smoke_")
            data = DataConfig(dataset_type="synthetic", domain_type="d1_d2",
                              data_root=f"{work}/data", overlap_ratio=0.25, neg_nums=999)
            tcfg = TrainConfig(epochs=1, seeds=1, model_dir=f"{work}/model",
                               lazy_table_adam=lazy_adam, nan_policy="halt", checkpoint=False,
                               model=cfg, data=data)
            rec = {}
            try:
                n_train, n_dr, n_val = WIDTH_CLI_ROWS
                write_synthetic_csvs(data, cfg, rng, n_train, n_val, n_dr)
                argv = ["--kernels", "auto", "--model", "sasrec", "--emb_dim", "96",
                        "--comp_broadcast_quirk", str(not pairwise), "--isItC", "True",
                        "--ts2", "0.4", "--seq_len", str(t), "--neg_nums", "999",
                        "--overlap_ratio", "0.25", "-ds", data.dataset_type,
                        "-dm", data.domain_type, "--data_root", data.data_root,
                        "--epoch", "1", "--seeds", "1", "--lazy_table_adam", str(lazy_adam),
                        "-md", f"{work}/model_cli"]
                reset_counts()
                t0 = time.perf_counter()
                agg = train_sr_dr.main(argv)  # default device: cuda
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                rec["launches"] = read_counts()
                check_run(f"{label} CLI", cfg, lazy_adam, rec["launches"],
                          {k: v["mean"] for k, v in agg.items()},
                          {"loop": "fast", "seconds": seconds}, WIDTH_CLI_ROWS)
                train_ds, val_ds, dr_ds = (
                    load_dual_domain_csv(path, t, cfg.pad_id, with_ob_label=ob)
                    for path, ob in ((data.train_csv(), False), (data.test_csv(), False),
                                     (data.train_dr_csv(), True)))
            finally:
                shutil.rmtree(work, ignore_errors=True)
            rec["train_steps"] = step_checks(torch, cfg, tcfg, train_ds, val_ds, dr_ds, label)
            torch.cuda.empty_cache()
            rec["graph_steps"] = graph_checks(torch, cfg, tcfg, train_ds, val_ds, dr_ds, label,
                                              exact=True)
            torch.cuda.empty_cache()
            rec["serve"] = serve_check(torch, cfg, make_batch(cfg, rng), label)
            rec["replayed_phase_a"] = replayed_phase_a(torch, cfg, tcfg, train_ds)
            emit({"width_config": {"config": label, "feature_ms": rec["serve"]["feature_ms"], **{
                k: rec["replayed_phase_a"][k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                                        "device_idle_share",
                                                        "max_memory_allocated_bytes")}}})
            out[label] = rec
            torch.cuda.empty_cache()
    return out


# phase 13: the widths the JAX kernels take beyond the port's earlier limits.
# K1's long pair at head width 256, fp32 and bf16, on configuration (c)'s
# and (d)'s attention (BERT4Rec at --emb_dim 1024: B=256, 4 heads of 256,
# encoder T=300); K6/K7 at D not a multiple of 8 (20), above one 128-column
# plane (136) and at configuration (c)'s width (1,024), at N=M of T=20 and
# T=150, and at N=700 (beyond four slots a user: KC=8 at D=128, 12 at
# D=1,024, two and three blocks folding into one output); K5 at D=1,024 (the
# column-chunked kernel) and, on its wide kernel, at WIDE_SCORING's (D, H,
# bf16): configuration (d)'s (1,024, 64) in both modes, D=2,048 and D=1,026
# (not a multiple of 4) at H=32
WIDE_B, WIDE_HEADS, WIDE_DH, WIDE_T = 256, 4, 256, 300
WIDE_AFF_D = (20, 136, 1024)
WIDE_AFF_N = (20, 150)
WIDE_LONG_N, WIDE_LONG_B = 700, 16  # B=C=16: the bound at D=1,024 is 0.26 ms
WIDE_HID = 64  # configuration (d)'s --hid_dim
WIDE_SCORING = ((1024, WIDE_HID, True), (1024, WIDE_HID, False), (2048, 32, False),
                (1026, 32, False))


def wide_kernel_phase(torch, gen):
    """Phase 13(a): the new kernel instances against their plain versions,
    each timed (`kernel_ms`, `device_ms`, `host_us`), with the plain
    version's time, the library call's (SDPA; the chunked `matmul` + `amax`
    route for K6/K7; none for K5) and the bound. K1: the fp32 long forward
    and backward at WIDE_B, WIDE_HEADS heads of WIDE_DH, T=WIDE_T, key
    padding (batch row 0 fully masked) and causal, rates 0 and 0.1; the
    forward against `attention_fwd_stats_streamed_plain` at ATOL / RTOL, its
    row statistics at LONG_STATS_ATOL; the backward from the plain forward's
    residuals at `bwd_atol`, two calls bit-equal, and the kernel and the
    plain fp32 version against the plain version in fp64 on ORACLE_ROWS
    rows; both routes send the shape to the long paths. The bf16 long pair
    at the same inputs (`wide_bf16_*` cases): one draw a case held to
    BF16_LIMITS' "bf16_long_dh256" and "bf16_bwd_long_dh256" (the fp32
    build at the same inputs outside the kernel_oracle limit), the row
    statistics at LONG_STATS_ATOL, two calls bit-equal, SDPA on bf16 q, k, v
    and the bound at the bf16 peak. K6/K7 at WIDE_AFF_D x WIDE_AFF_N
    (B=C=256; K7 where `smalln_max_n(D)` takes N, bit-equal to K6) and K6 at
    N=M=WIDE_LONG_N, at AFF_ATOL / AFF_RTOL. K5's pair at D=1,024, C=1000
    and C=2, at SCORE_ATOL; and on its wide kernel at WIDE_SCORING, the
    fp32 cases at SCORE_ATOL, the bf16 one held to "bf16_scoring_wide_C*"
    (the fp32 mode as the control)."""
    from amid_tpu_torch.ops import attention as attention_ops
    from amid_tpu_torch.ops.affinity import (
        max_affinity_blocked, max_affinity_smalln, smalln_max_n,
    )
    from amid_tpu_torch.ops.attention import (
        LONG_BF16_STAGE_KEYS, MODES, attention_bwd_plain, attention_fwd_stats_plain,
        attention_fwd_stats_streamed_plain, backward_route, forward_route, long_head_dim,
    )
    from amid_tpu_torch.ops.scoring import (
        scoring_head_pair, scoring_head_pair_plain, scoring_head_plain, scoring_kernel, tile_cols,
    )

    OB = ORACLE_ROWS
    B, heads, dh, t = WIDE_B, WIDE_HEADS, WIDE_DH, WIDE_T
    d = heads * dh
    require(all(forward_route(t, dh, m) == backward_route(t, dh, m) == "long" for m in MODES)
            and long_head_dim(dh) == 256,
            f"dh={dh}: the routes must take the long paths at template width 256")
    cases = {"attention_fwd_long": {}, "attention_bwd_long": {}, "max_affinity_blocked": {},
             "max_affinity_smalln": {}, "scoring_head": {}, "attention_fwd_long_bf16": {},
             "attention_bwd_long_bf16": {}, "scoring_head_wide": {}}

    def bf16_cases(q, k, v, dout, bias, seed, kind, rate, base):
        """The bf16 long pair at dh=256 on one case's inputs."""
        name = f"wide_bf16_fwd_long_{kind}_T{t}_dh{dh}_rate{rate}"
        rec = {"case": name, "mode": "bf16", **base}

        def fwd(stats=False, bf16=True):
            return attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, stats,
                                                 "long", bf16=bf16)

        def plain_fwd():
            return attention_fwd_stats_streamed_plain(q, k, v, bias, seed, heads, rate,
                                                      LONG_BF16_STAGE_KEYS, True)[0]

        with torch.no_grad():
            got, want = fwd()[0], plain_fwd()
            require(torch.equal(fwd()[0], got), f"{name}: two calls differ")
            require(torch.isfinite(got).all().item(), f"{name}: non-finite output")
            stats = fwd(True)
            require(torch.equal(stats[0], got), f"{name}: out differs with statistics")
            rows = (q[:OB], k[:OB], v[:OB], bias[:OB], seed, heads, rate)
            want_stats = attention_fwd_stats_plain(*rows, True)
            rec["stats_max_abs_err"] = {}
            for n, g, w in zip(("row_max", "row_inv_sum"), stats[1:], want_stats[1:]):
                err = rec["stats_max_abs_err"][n] = (g[:OB] - w).abs().max().item()
                require(torch.allclose(g[:OB], w, atol=LONG_STATS_ATOL[n], rtol=STATS_RTOL),
                        f"{name}: kernel vs plain {n} max_abs_err {err}")
            readings = Bf16Readings()
            readings.draw([(got, fwd(bf16=False)[0], want,
                            bf16_attention_kernel_oracle(torch, *rows, LONG_BF16_STAGE_KEYS),
                            bf16_attention_oracle(torch, *rows))])
            rec.update(readings.verdict(name, "bf16_long_dh256"))
            del got, want, stats, want_stats
            rec.update(timings(torch, lambda: fwd()[0], 10, rounds=1))
            rec["plain_ms"] = cuda_ms(torch, plain_fwd, 2, 1)
        sdpa_timings(torch, rec, q, k, v, None, bias, heads, rate, True)
        rec["bound_ms"], rec["bound_by"] = attention_bound(B, t, d, heads, bias.numel(),
                                                           BF16_TENSOR_FLOPS)
        emit({"kernel_case_wide": rec})
        cases["attention_fwd_long_bf16"][name] = rec

        name = f"wide_bf16_bwd_long_{kind}_T{t}_dh{dh}_rate{rate}"
        rec = {"case": name, "mode": "bf16", **base}
        with torch.no_grad():
            res = attention_fwd_stats_plain(q, k, v, bias, seed, heads, rate, True)

            def bwd(bf16=True):
                return attention_ops._launch_backward(q, k, v, bias, *res, dout, seed, heads,
                                                      rate, "long", bf16=bf16)

            def plain_bwd():
                return attention_bwd_plain(q, k, v, bias, *res, dout, seed, heads, rate, True)

            got = bwd()
            require(all(torch.equal(a, b) for a, b in zip(bwd(), got)),
                    f"{name}: two backward calls differ")
            require(all(torch.isfinite(g).all().item() for g in got),
                    f"{name}: non-finite gradient")
            oracle = bf16_attention_bwd_oracle(torch, q[:OB], k[:OB], v[:OB], bias[:OB],
                                               res[0][:OB], dout[:OB], seed, heads, rate)
            readings = Bf16Readings()
            readings.draw(list(zip(got, bwd(False), plain_bwd(), oracle, oracle)))
            rec.update(readings.verdict(name, "bf16_bwd_long_dh256"))
            del got, oracle
            rec.update(timings(torch, bwd, 10, rounds=1))
            rec["plain_ms"] = cuda_ms(torch, plain_bwd, 2, 1)
        sdpa_timings(torch, rec, q, k, v, dout, bias, heads, rate, True)
        rec["bound_ms"], rec["bound_by"] = attention_bwd_bound(B, t, d, heads, bias.numel(),
                                                               BF16_TENSOR_FLOPS)
        emit({"kernel_case_wide": rec})
        cases["attention_bwd_long_bf16"][name] = rec
        del res
    for kind in ("keypad", "causal"):
        for rate in (0.0, 0.1):
            q, k, v, dout = (torch.randn(B, t, d, device="cuda", generator=gen)
                             for _ in range(4))
            bias = (torch.triu(torch.full((t, t), -1e9, device="cuda"), diagonal=1)[None, None]
                    if kind == "causal" else keypad_bias(torch, gen, B, t))
            seed = torch.tensor([4242], dtype=torch.int64, device="cuda")
            base = {"dh": dh, "template_dh": 256, "heads": heads, "shape": [B, t, d],
                    "bias": kind, "rate": rate, "path": "long"}

            def fwd(stats=False):
                return attention_ops._launch_forward(q, k, v, bias, seed, heads, rate, stats,
                                                     "long")

            def plain_fwd():
                return attention_fwd_stats_streamed_plain(q, k, v, bias, seed, heads, rate, 64)

            name = f"wide_fwd_long_{kind}_T{t}_dh{dh}_rate{rate}"
            rec = {"case": name, **base}
            with torch.no_grad():
                got, want = fwd()[0], plain_fwd()[0]
                require(torch.equal(fwd()[0], got), f"{name}: two calls differ")
                require(torch.isfinite(got).all().item(), f"{name}: non-finite output")
                stats = fwd(True)
                require(torch.equal(stats[0], got), f"{name}: out differs with statistics")
                want_stats = attention_fwd_stats_plain(q[:OB], k[:OB], v[:OB], bias[:OB], seed,
                                                       heads, rate)
                rec["stats_max_abs_err"] = {}
                for n, g, w in zip(("row_max", "row_inv_sum"), stats[1:], want_stats[1:]):
                    err = rec["stats_max_abs_err"][n] = (g[:OB] - w).abs().max().item()
                    require(torch.allclose(g[:OB], w, atol=LONG_STATS_ATOL[n], rtol=STATS_RTOL),
                            f"{name}: kernel vs plain {n} max_abs_err {err}")
                rec["max_abs_err"] = (got - want).abs().max().item()
                require(torch.allclose(got, want, atol=ATOL, rtol=RTOL),
                        f"{name}: kernel vs plain max_abs_err {rec['max_abs_err']}")
                del got, want, stats, want_stats
                rec.update(timings(torch, lambda: fwd()[0], 10, rounds=1))
                rec["plain_ms"] = cuda_ms(torch, plain_fwd, 2, 1)
            sdpa_timings(torch, rec, q, k, v, None, bias, heads, rate, False)
            rec["bound_ms"], rec["bound_by"] = attention_bound(B, t, d, heads, bias.numel())
            emit({"kernel_case_wide": rec})
            cases["attention_fwd_long"][name] = rec

            name = f"wide_bwd_long_{kind}_T{t}_dh{dh}_rate{rate}"
            rec = {"case": name, **base}
            with torch.no_grad():
                res = attention_fwd_stats_plain(q, k, v, bias, seed, heads, rate)

                def bwd():
                    return attention_ops._launch_backward(q, k, v, bias, *res, dout, seed,
                                                          heads, rate, "long")

                def plain_bwd():
                    return attention_bwd_plain(q, k, v, bias, *res, dout, seed, heads, rate)

                got, want = bwd(), plain_bwd()
                require(all(torch.equal(a, b) for a, b in zip(bwd(), got)),
                        f"{name}: two backward calls differ")
                require(all(torch.isfinite(g).all().item() for g in got),
                        f"{name}: non-finite gradient")
                names = ("dq", "dk", "dv")
                atol = bwd_atol(t, dh)
                rec["errs"] = {n: (g - w).abs().max().item() for n, g, w in zip(names, got, want)}
                rec["max_abs_err"], rec["bwd_atol"] = max(rec["errs"].values()), atol
                rec["atol_needed"] = max(((g - w).abs() - RTOL * w.abs()).max().item()
                                         for g, w in zip(got, want))
                wide = [x[:OB].double() for x in (q, k, v, bias)]
                exact = attention_bwd_plain(*wide, *attention_fwd_stats_plain(
                    *wide, seed, heads, rate), dout[:OB].double(), seed, heads, rate)
                live = ~(bias[:OB] <= -1e8).reshape(bias[:OB].shape[0], -1).all(dim=1)
                live = live.expand(OB) if live.numel() == 1 else live
                for which, grads in (("plain", want), ("kernel", got)):
                    rec[f"{which}_vs_fp64"] = {
                        n: (g[:OB][live].double() - w[live]).abs().max().item()
                        for n, g, w in zip(names, grads, exact)}
                del exact, wide
                for n, g, w in zip(names, got, want):
                    require(torch.allclose(g, w, atol=atol, rtol=RTOL),
                            f"{name}: kernel vs plain {n} max_abs_err {rec['errs'][n]} "
                            f"(atol {atol})")
                del got, want
                rec.update(timings(torch, bwd, 10, rounds=1))
                rec["plain_ms"] = cuda_ms(torch, plain_bwd, 2, 1)
            sdpa_timings(torch, rec, q, k, v, dout, bias, heads, rate, False)
            rec["bound_ms"], rec["bound_by"] = attention_bwd_bound(B, t, d, heads, bias.numel())
            emit({"kernel_case_wide": rec})
            cases["attention_bwd_long"][name] = rec
            del res
            torch.cuda.empty_cache()
            bf16_cases(q, k, v, dout, bias, seed, kind, rate, base)
            del q, k, v, dout
            torch.cuda.empty_cache()

    def pair(bsz, c, n, m, width):
        return (torch.randn(bsz, n, width, device="cuda", generator=gen),
                torch.randn(c, m, width, device="cuda", generator=gen))

    for width in WIDE_AFF_D:
        for n in WIDE_AFF_N:
            a, b = pair(256, 256, n, n, width)
            rec, k6 = affinity_compare(torch, f"wide_blocked_N{n}_D{width}", max_affinity_blocked,
                                       a, b, iters=10)
            cases["max_affinity_blocked"][(n, width)] = rec
            if n <= smalln_max_n(width):
                rec, k7 = affinity_compare(torch, f"wide_smalln_N{n}_D{width}",
                                           max_affinity_smalln, a, b, iters=10)
                require(torch.equal(k6, k7), f"blocked and small-N kernels differ at N={n}, "
                                             f"D={width}")
                cases["max_affinity_smalln"][(n, width)] = rec
            del a, b, k6
            torch.cuda.empty_cache()
    for width in (128, 1024):
        n = WIDE_LONG_N
        rec, _ = affinity_compare(torch, f"wide_blocked_N{n}_D{width}", max_affinity_blocked,
                                  *pair(WIDE_LONG_B, WIDE_LONG_B, n, n, width), iters=10)
        cases["max_affinity_blocked"][(n, width)] = rec

    width, hid = 1024, FLAGSHIP["hid_dim"]
    require(tile_cols(width, hid) < width, "K5 at D=1,024 takes the column-chunked kernel")

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device="cuda", generator=gen) * scale

    fc1 = rand(hid, 2 * width, scale=(2 * width) ** -0.5)
    params = (fc1[:, :width], fc1[:, width:], rand(hid, scale=0.1),
              rand(1, hid, scale=hid ** -0.5), rand(1, scale=0.1))
    for c in (1000, 2):
        user, other, items = rand(B, width), rand(B, width), rand(B, c, width)
        name = f"wide_scoring_pair_C{c}_D{width}"
        with torch.no_grad():
            got = scoring_head_pair(user, other, items, *params)

            def plain():
                return (scoring_head_plain(user, items, *params),
                        scoring_head_plain(other, items, *params))

            err = max((g - w).abs().max().item() for g, w in zip(got, plain()))
            require(all(torch.isfinite(g).all().item() and tuple(g.shape) == (B, c) for g in got),
                    f"{name}: non-finite output or wrong shape")
            require(err <= SCORE_ATOL, f"{name}: kernel vs plain max_abs_err {err}")
            rec = {"case": name, "shape": [B, c, width], "H": hid, "users": 2,
                   "tile_cols": tile_cols(width, hid), "max_abs_err": err,
                   **timings(torch, lambda: scoring_head_pair(user, other, items, *params), 20),
                   "plain_ms": cuda_ms(torch, plain, 5), "library_ms": None}
        rec["bound_ms"], rec["bound_by"] = scoring_bound(B, c, width, hid, 2)
        emit({"kernel_case_scoring": rec})
        cases["scoring_head"][c] = rec

    for width, hid, bf16 in WIDE_SCORING:
        require(scoring_kernel(width, hid) == "wide", f"K5 at D={width}, H={hid} takes "
                                                      f"{scoring_kernel(width, hid)}")
        fc1 = rand(hid, 2 * width, scale=(2 * width) ** -0.5)
        params = (fc1[:, :width], fc1[:, width:], rand(hid, scale=0.1),
                  rand(1, hid, scale=hid ** -0.5), rand(1, scale=0.1))
        for c in (1000, 2):
            user, other, items = rand(B, width), rand(B, width), rand(B, c, width)
            name = f"wide_scoring_pair_C{c}_D{width}_H{hid}" + ("_bf16" if bf16 else "")

            def fn(mode=bf16):
                return scoring_head_pair(user, other, items, *params, bf16=mode)

            def plain():
                return scoring_head_pair_plain(user, other, items, *params, bf16=bf16)

            rec = {"case": name, "mode": "bf16" if bf16 else "fp32", "shape": [B, c, width],
                   "H": hid, "users": 2, "kernel": "wide", "tile_cols": tile_cols(width, hid)}
            with torch.no_grad():
                got, want = fn(), plain()
                require(all(torch.equal(a, b) for a, b in zip(fn(), got)),
                        f"{name}: two calls differ")
                require(all(torch.isfinite(g).all().item() and tuple(g.shape) == (B, c)
                            for g in got), f"{name}: non-finite output or wrong shape")
                if bf16:
                    readings = Bf16Readings()
                    oracles = [bf16_scoring_oracle(torch, u, items, *params) for u in (user, other)]
                    readings.draw(list(zip(got, fn(False), want, oracles, oracles)))
                    rec.update(readings.verdict(name, f"bf16_scoring_wide_C{c}"))
                    del oracles
                else:
                    rec["max_abs_err"] = max((g - w).abs().max().item() for g, w in zip(got, want))
                    require(rec["max_abs_err"] <= SCORE_ATOL,
                            f"{name}: kernel vs plain max_abs_err {rec['max_abs_err']}")
                rec.update(timings(torch, fn, 20, rounds=1))
                rec["plain_ms"], rec["library_ms"] = cuda_ms(torch, plain, 3, 1), None
            # the bf16 mode's bound at the bf16 peak, the fp32 peak's beside it
            rec["bound_ms"], rec["bound_by"] = scoring_bound(
                B, c, width, hid, 2, BF16_TENSOR_FLOPS if bf16 else FP32_FLOPS)
            rec["bound_fp32_ms"] = scoring_bound(B, c, width, hid, 2)[0]
            emit({"kernel_case_scoring": rec})
            cases["scoring_head_wide"][(c, width, hid, bf16)] = rec
            del user, other, items, got, want
        torch.cuda.empty_cache()
    return cases


def wide_config_phase(torch, rng):
    """Phase 13(b): configuration (c), BERT4Rec at `--emb_dim 1024` (4 heads
    of 256, FFN 512 as configuration (a)) and `--seq_len 150` with
    InterComp in pairwise mode (`comp_broadcast_quirk=False`), fp32,
    through the entry points a user calls with kernels='auto' (cuda on the
    card) and no refusal: serving (the feature pass against kernels='torch',
    top-100 over the 894,820-row table); `run_seed` for one epoch on the
    fast loops at T=150 with dense Adam (encoder T=300: both long K1 paths
    at dh=256, K6 at D=1,024, K5's column-chunked kernel) and at T=20 with
    the lazy table Adam (encoder T=40, K7 at D=1,024), each with its
    launches against `expected_launches`; one eager phase-A and phase-B step
    and one evaluation batch of each against the kernels='torch' model
    (`step_checks`: the first losses at LOSS_TOL); the replayed phase A's
    wall and device ms and peak memory at T=150. Configuration (d), (c)
    under `--bf16` with `--hid_dim 64` (K1's bf16 long pair at dh=256, K5's
    wide kernel at D=1,024, H=64): serving (`serve_check`: the feature
    pass against the kernels='torch' bf16 model, top-100), `run_seed` for
    one epoch at T=150 with dense Adam and its launches, one eager phase-A
    and phase-B step against the kernels='torch' bf16 model
    (`bf16_step_check`), replayed steps bit-equal to eager ones
    (`graph_checks`), and with STEP_TIMING the replayed phase A's wall and
    device ms and peak memory. Then configuration (a) in pairwise mode
    (`--emb_dim 512 --comp_broadcast_quirk False`): replayed phase-A steps
    through K6 at D=512, with their launches. Returns the runs' records
    (with their launches)."""
    import shutil
    import tempfile

    from amid_tpu_torch.config import DataConfig, ModelConfig, TrainConfig
    from amid_tpu_torch.data.synthetic import synth_packed
    from amid_tpu_torch.models.amid import head_width
    from amid_tpu_torch.ops.scoring import scoring_kernel
    from amid_tpu_torch.train.loop import run_seed

    out = {}
    base = {**FLAGSHIP, **BACKBONES["bert4rec"], "emb_dim": 1024, "comp_broadcast_quirk": False}
    for t, lazy_adam in ((150, False), (20, True)):
        label = f"bert4rec_D1024_T{t}_{'lazy' if lazy_adam else 'dense'}_pairwise"
        cfg = ModelConfig(**{**base, "seq_len": t})
        require(head_width(cfg) == 256 and cfg.enc_seq_len == 2 * t,
                f"{label}: dh={head_width(cfg)}, encoder T={cfg.enc_seq_len}")
        rec = {}
        if t == 150:
            rec["serve"] = serve_check(torch, cfg, backbone_batch(cfg, rng), label, topk=True)
        train_ds, val_ds, dr_ds = (synth_packed(cfg, rng, n)
                                   for n in (TRAIN_ROWS, VAL_ROWS, DR_ROWS))
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        tcfg = TrainConfig(epochs=1, seeds=1, model_dir=work, lazy_table_adam=lazy_adam,
                           nan_policy="halt", checkpoint=False, model=cfg,
                           data=DataConfig(neg_nums=999))
        try:
            reset_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            best = run_seed(tcfg, 0, train_ds, val_ds, dr_ds)  # on cuda, kernels='auto'
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            rec["launches"] = read_counts()
            check_run(f"{label} run_seed fast", cfg, lazy_adam, rec["launches"], best,
                      {"loop": "fast", "seconds": seconds,
                       "examples_per_s": best["examples_per_s"],
                       "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
        finally:
            shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
        rec["train_steps"] = step_checks(torch, cfg, tcfg, train_ds, val_ds, dr_ds, label)
        torch.cuda.empty_cache()
        if t == 150:
            rec["replayed_phase_a"] = replayed_phase_a(torch, cfg, tcfg, train_ds)
            emit({"wide_config": {"config": label, **{
                k: rec["replayed_phase_a"][k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                                        "device_idle_share",
                                                        "max_memory_allocated_bytes")},
                "feature_ms": rec["serve"]["feature_ms"],
                "catalog_ms_per_domain": rec["serve"]["catalog_ms_per_domain"]}})
        out[label] = rec
        del train_ds, val_ds, dr_ds
        torch.cuda.empty_cache()

    # configuration (d): (c) under --bf16, with --hid_dim 64
    label = "bert4rec_D1024_H64_T150_dense_pairwise_bf16"
    cfg = ModelConfig(**{**base, "seq_len": 150, "hid_dim": WIDE_HID, "use_bf16": True})
    require(head_width(cfg) == 256 and scoring_kernel(cfg.emb_dim, cfg.hid_dim) == "wide",
            f"{label}: dh={head_width(cfg)}, K5 {scoring_kernel(cfg.emb_dim, cfg.hid_dim)}")
    rec = {"serve": serve_check(torch, cfg, backbone_batch(cfg, rng), label, topk=True)}
    train_ds, val_ds, dr_ds = (synth_packed(cfg, rng, n) for n in (TRAIN_ROWS, VAL_ROWS, DR_ROWS))
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    tcfg = TrainConfig(epochs=1, seeds=1, model_dir=work, lazy_table_adam=False,
                       nan_policy="halt", checkpoint=False, model=cfg,
                       data=DataConfig(neg_nums=999))
    try:
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        best = run_seed(tcfg, 0, train_ds, val_ds, dr_ds)  # on cuda, kernels='auto'
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rec["launches"] = read_counts()
        check_run(f"{label} run_seed fast", cfg, False, rec["launches"], best,
                  {"loop": "fast", "seconds": seconds, "examples_per_s": best["examples_per_s"],
                   "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    rec["train_steps"] = bf16_step_check(torch, cfg, tcfg, train_ds, dr_ds, label, fresh=True)
    torch.cuda.empty_cache()
    rec["graph_steps"] = graph_checks(torch, cfg, tcfg, train_ds, val_ds, dr_ds, label,
                                      exact=True, evaluate=False)
    torch.cuda.empty_cache()
    if STEP_TIMING:
        rec["replayed_phase_a"] = replayed_phase_a(torch, cfg, tcfg, train_ds)
        emit({"wide_config": {"config": label, **{
            k: rec["replayed_phase_a"][k] for k in ("wall_ms_per_step", "device_ms_per_step",
                                                    "device_idle_share",
                                                    "max_memory_allocated_bytes")},
            "feature_ms": rec["serve"]["feature_ms"],
            "catalog_ms_per_domain": rec["serve"]["catalog_ms_per_domain"]}})
    out[label] = rec
    del train_ds, val_ds, dr_ds
    torch.cuda.empty_cache()

    # configuration (a) in pairwise mode: replayed phase-A steps through K6 at D=512
    label = "bert4rec_D512_T150_dense_pairwise"
    cfg = ModelConfig(**{**base, "emb_dim": 512, "seq_len": 150})
    train_ds = synth_packed(cfg, rng, TRAIN_ROWS)
    tcfg = TrainConfig(epochs=1, seeds=1, model_dir="", lazy_table_adam=False,
                       nan_policy="halt", checkpoint=False, model=cfg,
                       data=DataConfig(neg_nums=999))
    reset_counts()
    replayed = replayed_phase_a(torch, cfg, tcfg, train_ds)
    counts = read_counts()
    require(counts["max_affinity_blocked"] > 0 and counts["attention_bwd_long"] > 0,
            f"{label}: replayed phase A launched K6 {counts['max_affinity_blocked']} times")
    emit({"wide_config": {"config": label, "launches": counts, **{
        k: replayed[k] for k in ("wall_ms_per_step", "device_ms_per_step", "device_idle_share",
                                 "max_memory_allocated_bytes")}}})
    out[label] = {"replayed_phase_a": replayed, "replay_launches": counts}
    return out


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    try:
        from amid_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the amid_tpu_torch package is missing ({e}); run from "
              f"the repository root", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32=False, "
          "torch.backends.cudnn.allow_tf32=False", flush=True)

    # phase 1: the card, then the kernels' build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"gpu: {smi}", flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    # every source, and the fp32 long attention paths' padded-width builds
    # (ops/_build.py's VARIANTS)
    sources = sorted({Path(src).stem for src, _ in KERNELS.values()} | set(_build.VARIANTS))
    _build.build(sources)
    print(f"build: {', '.join(sources)} in {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    def phase(fn, arg):
        """fn(torch, arg), its wall time printed (the run's budget is 1200 s)."""
        t = time.perf_counter()
        out = fn(torch, arg)
        torch.cuda.empty_cache()
        print(f"{fn.__name__}: {time.perf_counter() - t:.1f} s", flush=True)
        return out

    fwd = phase(kernel_phase, gen)
    bwd = phase(backward_kernel_phase, gen)
    scatter = phase(scatter_kernel_phase, gen)
    gather = phase(gather_kernel_phase, gen)
    gather_grad = phase(gather_grad_kernel_phase, gen)
    scoring = phase(scoring_kernel_phase, gen)
    affinity = phase(affinity_kernel_phase, gen)
    serving = phase(main_path_phase, np.random.default_rng(0))
    training = phase(training_phase, np.random.default_rng(1))
    phase(gate_flip_phase, np.random.default_rng(2))
    backbones = phase(backbone_phase, np.random.default_rng(3))
    c2dsr_runs = phase(c2dsr_phase, np.random.default_rng(4))
    checkpoint_runs = phase(checkpoint_phase, np.random.default_rng(5))
    bf16 = phase(bf16_kernel_phase, gen)
    precision_runs = phase(precision_phase, np.random.default_rng(6))
    phase(bf16_drift_check, np.random.default_rng(7))
    mesh_runs = phase(mesh_phase, np.random.default_rng(8))
    widths = phase(width_kernel_phase, gen)
    width_runs = phase(width_config_phase, np.random.default_rng(9))
    wides = phase(wide_kernel_phase, gen)
    wide_runs = phase(wide_config_phase, np.random.default_rng(10))

    # launches on the main paths: the serving passes, the run_seed runs and
    # the CLI runs (each on the fast loops and per step), the backbones'
    # serving passes and run_seed runs, phase 8's C2DSR run_seed runs, phase
    # 9's run_seed runs (resume, roll-back, trace), phase 11's run_seed runs
    # off and on the mesh, phase 12's serving pass, run_seed runs and CLI runs
    # at dh=128 and dh=12, each driven with the counts at 0 just before it
    # and read just after
    main_runs = [*training.values(), *serving.values(),
                 *(r for r in backbones.values() if "launches" in r), *c2dsr_runs.values(),
                 *checkpoint_runs.values(),
                 *(r for r in precision_runs.values() if "launches" in r),
                 *(r for r in mesh_runs.values() if "launches" in r),
                 *width_runs.values(),
                 *(r["serve"] for r in width_runs.values() if "serve" in r)]
    # configuration (c)'s and (d)'s runs: every attention launch of their
    # models is at dh=256 (fp32 in (c), bf16 in (d)), every affinity and
    # scoring launch at D=1,024 (K5 at H=32 in fp32 on the chunked kernel,
    # at H=64 in bf16 on the wide one)
    wide_main = [r for label, rec in wide_runs.items() if "D1024" in label
                 for r in (rec, rec.get("serve")) if r and "launches" in r]
    main_runs += wide_main
    launches = {name: sum(r["launches"][name] for r in main_runs) for name in KERNELS}
    # run_seed scatters fused; the single-array kernel's path is the lazy step
    # built with fused_scatter=False, driven once in step_checks
    launches["scatter_set_unique"] += training["T20_lazy"]["unfused_launches"][
        "scatter_set_unique"]
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was launched no time on the main paths")
    # the numbers of the row: the amazon shape (T=150) for attention and the
    # blocked affinity; C2DSR's views of BERT4Rec with both comps (T=1,200,
    # dh=32) for the long forward; the lazy path's shape for the scatters (U=11,264) and
    # the small-N affinity (T=20); the evaluation's shape for the gather
    # (target and 999 negatives of 256 users in one launch), a T=150 training
    # step's two sequences for its backward, and the scoring head (C=1000,
    # both user representations in one launch, as the model calls it)
    long_cases = [c for c in bwd.values() if c["path"] == "long"]
    rows = {"attention_fwd": (fwd[150], [c for c in fwd.values() if c["path"] == "sweep"]),
            "attention_fwd_long": (fwd["long_T1200"],
                                   [c for c in fwd.values() if c["path"] == "long"]),
            "attention_bwd": (bwd[150], [c for c in bwd.values() if c["path"] == "sweep"]),
            "attention_bwd_long": (bwd["long_T600"], long_cases),
            "scatter_set_unique3": (scatter[11264]["scatter_set_unique3"],
                                    [c["scatter_set_unique3"] for c in scatter.values()]),
            "scatter_set_unique": (scatter[11264]["scatter_set_unique"],
                                   [c["scatter_set_unique"] for c in scatter.values()]),
            "embedding_gather": (gather["cand999"], gather.values()),
            "embedding_gather_grad": (gather_grad["pair150"], gather_grad.values()),
            "scoring_head": (scoring["scoring_pair_C1000"], scoring.values()),
            "max_affinity_blocked": (affinity["max_affinity_blocked"][150],
                                     affinity["max_affinity_blocked"].values()),
            "max_affinity_smalln": (affinity["max_affinity_smalln"][20],
                                    affinity["max_affinity_smalln"].values())}
    # the bf16 modes: K1 at the shapes above, K5's pair at C=1000
    bf16_rows = {"attention_fwd_bf16": "bf16_causal_T150_h8_rate0.0",
                 "attention_fwd_long_bf16": "bf16_long_keypad_T1200_h4_rate0.1",
                 "attention_bwd_bf16": "bf16_bwd_causal_T150_h8_rate0.5",
                 "attention_bwd_long_bf16": "bf16_bwd_long_keypad_T600_h4_rate0.1",
                 "scoring_head_bf16": "bf16_scoring_pair_C1000"}
    for name, case in bf16_rows.items():
        kind = name.rsplit("_bf16", 1)[0]
        rows[name] = (bf16[case], [c for c in bf16.values()
                                   if c["case"].startswith("bf16_scoring") == (
                                       kind == "scoring_head")
                                   and c.get("path", "sweep") == ("long" if "long" in kind
                                                                  else "sweep")
                                   and ("bwd" in c["case"]) == ("bwd" in kind)])
    # phase 12's cases at the other head widths join their path's row
    for name, (c, every) in rows.items():
        kind = name.rsplit("_bf16", 1)[0]
        if not kind.startswith("attention"):
            continue
        direction = "bwd" if "bwd" in kind else "fwd"
        path = "long" if "long" in kind else "sweep"
        mode = "bf16" if name.endswith("_bf16") else "fp32"
        extra = [w for w in widths.values() if w["case"].startswith(
            f"width_{mode}_{direction}_{path}_")]
        rows[name] = (c, [*every, *extra])
    # phase 13's instances, rows of their own: the launches (by the count of
    # their wrapper) of configuration (c)'s and (d)'s runs, and their cases;
    # K1 at its training shape (key padding, rate 0.1), K6 at T=150, K7 at
    # T=20, K5's pair at C=1000
    wide_rows = {
        "attention_fwd_long_dh256": ("attention_fwd_long", "attention_fwd_long",
                                     "wide_fwd_long_keypad_T300_dh256_rate0.1"),
        "attention_bwd_long_dh256": ("attention_bwd_long", "attention_bwd_long",
                                     "wide_bwd_long_keypad_T300_dh256_rate0.1"),
        "max_affinity_blocked_D1024": ("max_affinity_blocked", "max_affinity_blocked",
                                       (150, 1024)),
        "max_affinity_smalln_D1024": ("max_affinity_smalln", "max_affinity_smalln", (20, 1024)),
        "scoring_head_D1024": ("scoring_head", "scoring_head", 1000),
        "attention_fwd_long_bf16_dh256": ("attention_fwd_long_bf16", "attention_fwd_long_bf16",
                                          "wide_bf16_fwd_long_keypad_T300_dh256_rate0.1"),
        "attention_bwd_long_bf16_dh256": ("attention_bwd_long_bf16", "attention_bwd_long_bf16",
                                          "wide_bf16_bwd_long_keypad_T300_dh256_rate0.1"),
        "scoring_head_wide": ("scoring_head_bf16", "scoring_head_wide",
                              (1000, 1024, WIDE_HID, True))}
    kernel_of = {name: name for name in rows}
    for name, (kernel, group, key) in wide_rows.items():
        launches[name] = sum(r["launches"][kernel] for r in wide_main)
        require(launches[name] > 0,
                f"{name} was launched no time on configuration (c)'s and (d)'s runs")
        rows[name] = (wides[group][key], wides[group].values())
        kernel_of[name] = kernel
    emit({"kernels": [{
        "name": name, "route": "cuda", "source": KERNELS[kernel_of[name]][0],
        "replaces": KERNELS[kernel_of[name]][1], "launches": launches[name],
        "max_abs_err": max(r["max_abs_err"] for r in every),
        "ms": c["kernel_ms"], "plain_ms": c["plain_ms"],
        "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "library_ms": c["library_ms"], "case": c["case"],
        "device_ms": c["device_ms"], "host_us": c["host_us"],
        **{k: c[k] for k in ("bound_fp32_ms",) if k in c},
    } for name, (c, every) in rows.items()]})
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
