#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from src/repro_torch/csrc, holds each one
against its plain PyTorch version at its path's shapes (f64 and f32 for the
GP kernels and their bf16-assembly variants, bf16 and f32 for flash
attention), times both, and drives each
path once through the user entry points:

* single output: ``fit_sbv`` (2 structure rounds x 3 Adam steps, f64) on
  200,000 points of the paper's 10-d synthetic GP, and ``predict_sbv`` on
  50,000 held-out points of the same realization;
* multi-output (VPPE): ``fit_sbv`` (2 x 3) on 200,000 MetaRVM trajectories
  with 32 outputs, and ``predict_sbv`` on 20,000 held-out ones;
* out of core: the 200,000 training points in an on-disk ``ArrayStore``,
  the streaming structure (mini-batch k-means, store-backed NNS, a plan of
  ~65,536-row pieces), value and gradient over the spool with its pieces
  on the device, half on the device, and on disk (prefetched and
  synchronous: all bitwise equal), one piece against many, then
  ``fit_sbv(store, None, cfg, stream_chunk=65536)`` (1 x 3) with its device
  memory and host RSS beside their models, the multi-output streaming fit
  (p = 32, n = 50,000, 1 x 2) and ``predict_sbv`` from the store (20,000
  points; the store-backed against the in-core streaming one on 2,000);
* distributed (paper Alg. 1) and multi-host (Alg. 2), on the streaming
  store: ``fit_sbv(distributed=(make_worker_mesh(4), "workers"))`` in core
  (1 x 3, the 4 workers sharing the card) with its loss and gradient and a
  bucketed evaluation against the serial ones, one 25,000-point prediction
  chunk over 4 shards against the serial chunk, the streaming fit over the
  mesh against the streaming phase's serial fit, ``python -m
  repro_torch.launch.fit_gp --distributed-hosts 2`` (2 rank processes on
  the card, gloo) against that fit, and ``predict_sbv(multihost=)`` on 2
  ranks (this script's ``--predict-rank`` mode) against the serial
  prediction of 20,000 points;
* the batched covariance kernel at B = 256 (the joint points of 256
  multi-output blocks) beside its earlier row-wise design and a ``fill_`` of
  the same bytes, its store paths and edges, and ``kernels.ops.matern_cov``
  once;
* the exact GP and paper Eq. 4 at Fig. 4's paper scale: ``kl_divergence``
  (n = 20,000, d = 10, bs = 10, m = 30) of the SBV and the isotropic BV
  structures, whose exact half assembles the dense covariance with the
  covariance kernel at B = 1 and whose Vecchia half is one likelihood
  launch, against the plain route; the kernel timed at that shape;
* buckets and the precision ladder, at the fit's initial parameters: the
  single-output structure in size-buckets (f64 against the uniform layout,
  and times), the bf16 and f32 variants per bucket against their plain
  versions, the probe's tiers, ``fit_sbv(n_buckets=4, precision="bf16")``
  (1 round x 3 steps), ``predict_sbv`` bucketed in f64 and bf16 on the
  50,000 points, the multi-output stats bucketed (f64, and the bf16 variant
  through ``packed_multi_stats``), and ``ops.matern_cov`` on bf16 points;
* LM serving: internlm2-1.8b at full width and depth in bf16 (weights from a
  seeded generator), a 4 x 4096-token prompt prefilled through
  ``training.serve.make_prefill_step`` and 32 greedy tokens through
  ``make_decode_step``, with the flash-attention kernel held against its
  plain version (bf16 and f32) at the path's shape and at its variants;
* LM training: the flash-attention backward kernels against autograd
  through the plain version at the training shape (4 x 2048 tokens) and
  variants, on the route ``flash_bwd_route`` gives ('wgmma' for bf16 at hd
  64 and 128, fed by the forward's row statistics), timed beside the
  scalar kernels (the 'scalar' route, its baseline) and the library's
  backward, the wgmma forward timed
  with and without the statistics, then ``python -m
  repro_torch.launch.train`` (``main``) on internlm2-1.8b at full width and
  depth in bf16 for 6 steps, 2 at grad_accum 2 and 2 with int8
  compression, and a checkpoint resume on the reduced config;
* serving's leftovers (ROADMAP item 12a): a bucketed continuous stream and
  a p = 32 drain batch on the multi-output index, each bitwise its
  synchronous loop, their chunk 0 held against the plain conditional;
* gemma2 serving (ROADMAP item 13.2): the forward kernel at hd 256 (its
  'wgmma' route) against its plain version at the path's global and local
  shapes (2 x 8192 tokens, window 4096 and 0, softcap 50), timed beside the
  scalar kernel it replaced (the 'scalar_bf16' route, uncounted) and the
  library call that computes the same function (``flex_attention``
  compiled, with a softcap ``score_mod``), then
  gemma2-9b at full width and depth in bf16, 2 x 8192-token prompts + 32
  greedy tokens, against its ``use_flash="never"`` route, its first 4
  layers against the same weights in f32, decode against a longer prefill;
* qwen2-moe serving (item 13.3): qwen2-moe-a2.7b at full width and depth
  (60 experts top-4 and a shared expert), 4 x 4096 + 32, against its never
  route, one MoE layer on the card against the CPU in f32, the MoE's share
  of a prefill layer;
* training both families at full width through ``launch.train.main``:
  the backward kernels at hd 256 (the 'wgmma' route) against autograd
  through the plain version at the gemma2 shapes first (timed beside the
  scalar kernels they replaced and autograd through ``flex_attention``),
  then gemma2 at 8
  layers on 1 x 8192 tokens and qwen2-moe at 4 layers on 4 x 2048 tokens,
  3 steps each;
* zamba2 serving (item 13.4): the forward kernel at hd 80 (its 'wgmma'
  route, zamba2's shared attention block) against its plain version at the
  path's shape (4 x 4096, H = Hkv = 32), its row statistics against the
  plain version's, timed beside the 'mma' kernel it replaced, the plain
  version and ``scaled_dot_product_attention`` (the same function here), then
  zamba2-2.7b at full width and depth (54 mamba2 layers, the shared block
  after every 6) in bf16, 4 x 4096 + 32 greedy tokens, against its
  ``use_flash="never"`` route, its first group against the same weights in
  f32, decode after a prefill against a longer prefill, one mamba2 layer on
  the card against the CPU, the SSD scan's share of a layer;
* rwkv6 serving (item 13.5): rwkv6-3b at full width and depth, 4 x 4096 +
  32, its first 2 layers against f32, decode against a longer prefill, one
  layer on the card against the CPU, the chunked time mix against its
  token loop, the WKV scan's share of a layer;
* training both at full width through ``launch.train.main``: the backward
  kernels at hd 80 (the 'wgmma' route, fed by the forward's statistics)
  against autograd through the plain version at 4 x 2048, timed beside the
  'scalar' kernels they replaced and the SDPA backward, then zamba2 at 12
  layers and rwkv6 at 8 on 4 x 2048 tokens, 3 steps each;
* meshes, tp and the dry run (item 13.6): the internlm2 serving path again
  at ``--mesh 1x16`` (tp = 16: its 8 KV heads cached twice each) and the
  qwen2-moe path at ``--mesh 1x8`` (tp = 8: 60 experts padded in place to
  64) on the weights of their tp = 1 runs, each held against that run
  (tokens, logits, the expanded cache bitwise, the kept MoE assignments),
  the dry run's reckoned parameter and cache bytes against the tensors on
  the card, and ``python -m repro_torch.launch.dryrun`` over every cell of
  both production meshes and one card in a subprocess (started in the
  background before the zamba2 phases, on the host alone, and read after
  them);
* the dense LM and the MoE split over rank processes (item 13.6), after
  the MoE's training phase: this script started four times
  (``--lm-rank``) on the card, the ranks joined in one gloo group whose
  collectives pass through the card's memory (each rank's exchange buffer
  opened by the others through CUDA IPC; gloo carries the barriers), each
  rank drawing only its shards of the seed-0 weights; first serving
  internlm2-1.8b at
  ``--mesh 1x4`` (the serving phase's weights and prompt, 8 decode steps
  teacher-forced on its tokens) at full width and depth and training it at
  ``--mesh 2x2`` at 8 layers (the training phase's first two batches,
  against a whole run at that depth), then
  serving qwen2-moe-a2.7b at ``--mesh 1x4`` at full width and depth (15
  experts a rank; the qwen2-moe serving phase's weights, prompt and
  tokens) and training it at ``--mesh 2x2`` at 4 layers (the whole
  qwen2-moe training run's weights and first two batches); each rank's
  flash forward and backward held at its local-head shapes, its shard
  bytes against the dry run's; tokens (but for one tie of the whole run's
  logits), logits, losses and the first step's gathered gradient against
  the whole-tensor runs (the gradient arbitrated by the same weights' f32
  gradient, a planted fault read against the same limit); the MoE's bf16
  logits arbitrated by the same weights' never route (a planted fault
  beyond), its first 2 layers' configuration served in f32 elementwise
  against the whole f32 model, its kept (token, expert) assignments per
  layer against the whole run's; the row-parallel products' GEMM times at
  the ranks' shapes; then, in the same four processes, the recurrent stacks
  in the reference's FULL_BATCH scan layout (rows over every axis, every
  head, through an all-to-all over 'model'): zamba2-2.7b at one group (6
  mamba2 layers and the shared block, hd 80 on 'wgmma') and rwkv6-3b at 2
  layers, full width, served at ``--mesh 1x4`` on their serving phases'
  prompts and trained at ``--mesh 2x2`` on 4 x 2048 tokens, against whole
  runs at those depths made in the phase: the bf16 logits arbitrated by the
  same weights in f32 (a planted fault, one rank's scan rows zeroed,
  beyond), the same configurations served in f32 at 2 x 1024 (the scan
  replicated over 'model': 2 rows do not divide it) within 1e-4 of the
  whole f32 model's largest logit, losses as for the dense LM and
  gradients arbitrated by the model axis' own order of sums; then the
  sharding rules' fallbacks (item 13.6a-c): qwen2-moe-a2.7b at full width
  and depth served at ``--mesh 2x2`` on a 4 x 64 prompt, whose dispatch
  groups straddle the data split (128 tokens a rank against a group of
  256, each decode step 2 against 4), held as its 1 x 4 serving is; and,
  in sixteen more rank processes (``--lm16-rank``) started beside those
  holds, minitron-4b (24 query heads, 1.5 a rank; its 8 cache heads do not
  divide 16, so the cache is split over its sequence) and rwkv6-3b (40
  heads, 2.5 a rank) at ``--mesh 1x16``, 2 layers at full width, served in
  bf16 on 4 x 1024 and in f32 on 2 x 1024 and held against whole runs.

Launch counts are set to 0 just before each path and read just after it.
It checks that every kernel of each path launched, that the outputs are
finite and right, and prints per-kernel numbers as one JSON line and, last,
``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when no CUDA device is visible, when
the repository's sources are not beside this file, or when any check fails.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# The main path's configuration (paper §6.1, Fig. 8's single-GPU widths).
D = 10
N_TRAIN = 200_000       # Fig. 8 goes to 500k; see the `reduced` line.
N_TEST = 50_000
M_FIT = 200
BS_PRED, M_PRED, N_SIMS, CHUNK = 25, 200, 1000, 25_000
OUTER, INNER = 2, 3
SEED = 0
DEVICE = "cuda"
# The multi-output path: MetaRVM trajectories at the repo's 32 outputs
# (fig7_metarvm --outputs 32), at the single-output path's n and m.
P_OUT, N_MULTI_TEST, MULTI_CHUNK = 32, 20_000, 10_000

# The LM serving path: internlm2-1.8b (serve.py's default arch), the batch
# of serve.py's default, the repo's train_4k sequence length, 32 new tokens.
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW = "internlm2-1.8b", 4, 4096, 32

# Published H100 peaks (NVIDIA data sheet): dense FLOP/s by operand type (f64
# on the tensor cores, f64 outside them, f32 outside them, bf16 on the
# tensor cores) and HBM bytes/s. The GP kernels' bf16-assembly variants
# compute in f32.
PEAKS = {"sxm": {"f64": 67e12, "f64_simt": 34e12, "f32": 67e12, "bf16": 989e12,
                 "hbm": 3.35e12},
         "pcie": {"f64": 51e12, "f64_simt": 25.6e12, "f32": 51e12, "bf16": 756e12,
                  "hbm": 2.0e12}}
# The buckets-and-ladder phase: bucket levels per dimension, as the
# reference's bucketed fit and prediction default to; its four predictions
# (uniform, bucketed f64, bucketed bf16 and bf16 on the plain route, each
# led by a host kNN at the initial beta = 0.5) run on the first
# N_LADDER_TEST held-out points, two chunks of CHUNK and the rest (cut from
# N_TEST: at 50,000 they took 193 s of a 1199.7 s run on a slow host).
N_BUCKETS = 4
N_LADDER_TEST = CHUNK + 1_000
# The exact-GP and KL phase: paper Fig. 4 at its paper scale
# (benchmarks/fig4_kl_mspe.py --scale paper: n = 20,000, bs = 10, m = 30).
N_EXACT, BS_EXACT, M_EXACT = 20_000, 10, 30
# The streaming (out-of-core) phase: the single-output path's n, blocks and
# m from an on-disk store in pieces of ~65,536 member + neighbour rows; the
# multi-output streaming fit at p = 32 on the first 50,000 MetaRVM rows;
# the store-backed prediction on 20,000 points in chunks of 10,000, and the
# store-backed against the in-core streaming prediction on 2,000.
STREAM_CHUNK, STREAM_INNER = 65_536, 3
N_MULTI_STREAM, MULTI_STREAM_INNER = 50_000, 2
N_STREAM_TEST, STREAM_PRED_CHUNK, N_STREAM_BITWISE = 20_000, 10_000, 2_000
# The distributed phase: the in-core and streaming fits over 4 workers and
# the multi-host fit and prediction on 2 rank processes, all on the one
# card; each rank's wall-clock limit and the rendezvous timeout.
N_WORKERS, DIST_INNER, N_RANKS, N_MH_TEST, RANK_TIMEOUT = 4, 3, 2, 20_000, 400
# The checkpoints, tuning and serving phase: the autotuner on a 20,000-row
# stride sample of the training set (the reference's default), the server at
# the main path's widths with its default chunk, 32 drain-mode requests over
# the 50,000 held-out points, 48 continuous-mode requests of log-uniform
# sizes in 1-8,192 (2 cancelled), and the serve CLI on 20,000 training points
# of the generator (cut from the main path's 200,000: each of its processes
# rebuilds the data) serving 50,000 points, alone and on 2 ranks.
TUNE_SAMPLE, TUNE_REPEATS, SERVE_CHUNK = 20_000, 3, 4096
N_DRAIN_REQ, N_CONT_REQ, N_CANCEL, MAX_REQ = 32, 48, 2, 8192
SERVE_CLI_TRAIN, SERVE_CLI_TEST = 20_000, 50_000
# The p = 32 drain batch on the multi-output path's index: 8 requests over
# the first 8,192 held-out MetaRVM points (two 4,096-point chunks).
N_MULTI_SERVE, N_MULTI_REQ = 8192, 8
# The LM training path: internlm2-1.8b at full width and depth, bf16, the
# batch of 4 x 2048 tokens (the repo's train shapes at batch 4), 6 steps at
# grad_accum 1, 2 at grad_accum 2, 2 with int8 compression; the resume check
# on the reduced config (a full-width checkpoint is ~23 GB of npz).
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 4, 2048, 6, 3e-4
# The gemma2 serving path: gemma2-9b at full width and depth, bf16, 2 x 8192-
# token prompts (its published context; at 4096 tokens its 4096-token window
# would mask nothing) + 32 greedy tokens. The f32 hold runs the same weights'
# first 4 layers (two local/global pairs; the f32 weights of all 42 take 37
# GB); the elementwise f32 hold and decode against a longer prefill run its
# first 2 (one pair) at a 4,500-token prompt, past the window.
G2_ARCH, G2_BATCH, G2_PROMPT, G2_NEW = "gemma2-9b", 2, 8192, 32
G2_F32_LAYERS, G2_DECODE_LAYERS, G2_DECODE_PROMPT = 4, 2, 4500
# The qwen2-moe serving path: qwen2-moe-a2.7b at full width and depth, bf16,
# at the internlm2 path's LM_BATCH x LM_PROMPT + LM_NEW; one MoE layer held on
# the card against the same layer on the CPU in f32 at 2 x 1024 tokens (two
# dispatch groups; the CPU takes ~1 s for it).
MOE_ARCH, MOE_HOLD_SHAPE = "qwen2-moe-a2.7b", (2, 1024)
# The qwen2-moe path against its use_flash="never" route, where a token whose
# router input moves by the routes' bf16 rounding may pick another expert: at
# most this share of the tokens routed otherwise in any one layer, and the
# last token's logits after all layers within this relative L2. Readings
# (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): 213-1,154 of 16,384
# tokens a layer (7.0 % at most, in layer 0), logits 7.71e-2 / 7.72e-2 in
# two runs; the limits are twice those.
MOE_REROUTED_MAX, MOE_LOGITS_REL = 0.14, 0.15
# Training the two families at full width through launch.train.main: gemma2
# at 8 layers (four local/global pairs) on 1 x 8192 tokens, qwen2-moe at 4
# layers on 4 x 2048 tokens (aux_weight 0.01, the default); 3 steps each.
G2_TRAIN_LAYERS, G2_TRAIN_BATCH, G2_TRAIN_SEQ = 8, 1, 8192
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 4, 4, 2048
FAMILY_TRAIN_STEPS = 3
# The attention-free and hybrid paths: zamba2-2.7b (54 mamba2 layers, the
# shared attention block after every 6: hd 80, the forward's and the
# backward's 'wgmma' routes) and rwkv6-3b (32 layers), each at full width and
# depth, bf16, at the internlm2 path's LM_BATCH x LM_PROMPT + LM_NEW. Holds:
# the f32 routes and decode after a prefill of SSM_F32_PROMPT tokens on
# zamba2's first group; one full-width layer in f32 on the card against the
# CPU at SSM_HOLD_SHAPE tokens (three SSD chunks, the last ragged; 19 WKV
# chunks); rwkv6's chunked time mix against its token loop on the card at 1 x
# RWKV_LOOP_TOKENS. Training at full width, 4 x 2048 tokens, 3 steps: zamba2
# at 12 layers (2 groups, the shared block applied twice), rwkv6 at 8, so
# that the functional Adam's copies (22 B a parameter) fit: 53 and 68 GB at
# full depth before activations.
ZAMBA_ARCH, RWKV_ARCH = "zamba2-2.7b", "rwkv6-3b"
SSM_F32_PROMPT, SSM_HOLD_SHAPE, RWKV_LOOP_TOKENS = 1000, (1, 300), 512
ZAMBA_TRAIN_LAYERS, RWKV_TRAIN_LAYERS = 12, 8
# Meshes, tp and the dry run (ROADMAP item 13.6): the internlm2 serving path
# at --mesh 1x16 (tp = 16: its 8 KV heads cached as 16) and the qwen2-moe
# path at --mesh 1x8 (tp = 8: 60 experts padded to 64), each on the weights
# of its tp = 1 phase; the dry run over every cell in a subprocess with
# DRYRUN_JOBS processes counting FLOPs, within DRYRUN_TIMEOUT seconds of its
# start (in the background, beside the sharded phase's holds, which time
# nothing that is reported).
LM_TP_MESH, MOE_TP_MESH = "1x16", "1x8"
DRYRUN_JOBS, DRYRUN_TIMEOUT = 6, 300
# The sharded LM (ROADMAP item 13.6): internlm2-1.8b split over four rank
# processes on the one card (gloo; the collectives' bytes moved on the card,
# ``collectives.DeviceExchange``), served at SHARD_SERVE_MESH on the serving phase's weights and
# prompt (its cache of LM_PROMPT + LM_NEW slots), decoded teacher-forced on
# that run's tokens for SHARD_DECODE steps, then trained at SHARD_TRAIN_MESH
# on the training phase's first batches (4 x 2048) for SHARD_TRAIN_STEPS
# steps at full depth; each rank's limit in seconds.
# The sharded MoE, in the same four rank processes after the dense work:
# qwen2-moe-a2.7b served at SHARD_SERVE_MESH at full width and depth (60 / 4
# = 15 experts a rank; the qwen2-moe serving phase's weights, prompt and
# tokens) and trained at SHARD_TRAIN_MESH at MOE_TRAIN_LAYERS (the whole
# qwen2-moe training run's weights and first SHARD_TRAIN_STEPS batches): its
# four ranks' reckoned peaks at the Adam update, 16.0 GB each, leave ~20 GB
# of the card's 85 GB.
# Its bf16 logits at full depth are held by their rows' mean relative L2
# to SHARD_MOE_RATIO times the same weights' never route's (routing flips
# set both; chip_smoke._moe_bf16_hold), and its first MOE_F32_LAYERS
# layers' configuration is served in f32 at MOE_HOLD_SHAPE, elementwise
# against the whole f32 model.
SHARD_SERVE_MESH, SHARD_TRAIN_MESH, SHARD_DECODE, SHARD_TRAIN_STEPS = "1x4", "2x2", 8, 2
SHARD_MOE_RATIO, MOE_F32_LAYERS = 2.0, 2
# The dense 2 x 2 training runs at SHARD_DENSE_TRAIN_LAYERS of internlm2's
# 24 layers, against a whole run at that depth made in the phase: cut when
# the MoE joined the phase, so that a run on a slow host stays inside its
# 1200 s (one took 1215.3 s with it at full depth on an NVIDIA H100 80GB
# HBM3 at 700 W, its host-bound GP phases 240 s slower than another's).
SHARD_DENSE_TRAIN_LAYERS = 8
SHARD_TIMEOUT = 600
# The recurrent stacks in the same four rank processes after the MoE work
# (ROADMAP item 13.6, FULL_BATCH): (label, architecture, layers, the serving
# phase's prompt seed): zamba2-2.7b at one group (attn_every = 6 mamba2
# layers and the shared block) and rwkv6-3b at 2 layers, full width, bf16,
# served at SHARD_SERVE_MESH and trained at SHARD_TRAIN_MESH, each against a
# whole run of its depth made in the phase; their f32 configurations (the
# group, SHARD_RWKV_F32_LAYERS rwkv6 layers) served at MOE_HOLD_SHAPE.
# rwkv6 ran at 4 layers until a run from the `git archive` of the tree took
# 1205.0 s on a slow host (NVIDIA H100 80GB HBM3, 700.00 W: its GP phases
# 238 s slower than another host's), over the 1200 s allowed. The
# bf16 logits are held by their rows' largest relative L2 to SHARD_REC_RATIO
# times the whole bf16 run's from the same weights in f32 (zamba2 amplifies
# rounding with depth, so the dense path's 3e-2 does not apply).
REC_SHARDED = (("zamba2", "zamba2-2.7b", 6, 7), ("rwkv6", "rwkv6-3b", 2, 11))
SHARD_RWKV_F32_LAYERS, SHARD_REC_RATIO = 2, 2.0
# The greedy tokens equal the whole run's but for at most
# SHARD_MAX_EXACT_TIES flips at exact ties of the whole run's logits (its
# argmax broke them by index; seed 0 has one for internlm2: row 1, position
# 4) and at most SHARD_MAX_TIES others, each where the whole run's two
# logits lie within one bf16 step. The cap on exact ties keeps a fault in
# how ties are broken in sight. Each leaf of the first
# step's gathered gradient lies no farther from the same weights' f32
# gradient than SHARD_GRAD_RATIO times the whole run's leaf does: a
# sharding error uncorrelated with the bf16 rounding passes only below
# sqrt(1.1^2 - 1) = 0.46 of the whole run's distance (~1.1e-2 at ~2.4e-2).
SHARD_MAX_TIES, SHARD_MAX_EXACT_TIES, SHARD_GRAD_RATIO = 1, 2, 1.1
# The sharding rules' fallbacks (ROADMAP items 13.6a-c). In the same four
# rank processes after the recurrent work: qwen2-moe-a2.7b at full width and
# depth served at SHARD_STRADDLE_MESH on the first SHARD_STRADDLE_SHAPE of
# the qwen2-moe serving phase's prompt, whose prefill straddles the data
# split (128 tokens a rank against a dispatch group of 256; each decode
# step 2 against 4), held as the 1 x 4 MoE serving is, against a whole run
# of that prompt made in the qwen2-moe serving phase. In SHARD16_MESH's 16
# rank processes, started beside the four ranks' holds (which time nothing
# reported) and let go to draw their shards and serve after them (the holds'
# whole f32 models and the sixteen ranks do not fit the card together):
# each of SHARD16 (label, architecture, layers, prompt seed) at
# full width, minitron-4b (24 query heads: 1.5 a rank; 8 cache heads,
# which 16 does not divide: the cache split over its sequence) and rwkv6-3b
# (40 heads: 2.5 a rank), served in bf16 at SHARD16_SHAPE (4 x 1024 +
# LM_NEW = 1056 slots, 66 a rank) and in f32 at MOE_HOLD_SHAPE, against
# whole runs made in the phase.
SHARD_STRADDLE_MESH, SHARD_STRADDLE_SHAPE = "2x2", (4, 64)
SHARD16_MESH, SHARD16_SHAPE = "1x16", (4, 1024)
SHARD16 = (("minitron", "minitron-4b", 2, 13), ("rwkv6x16", "rwkv6-3b", 2, 11))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 5, warm: int = 1, inner: int = 1) -> float:
    """Median milliseconds of one call of ``fn`` over ``reps`` pairs of CUDA
    events, each pair around ``inner`` calls back to back. With inner = 1
    the time includes the host's work before the launch (the device waits
    for it); with inner > 1 that work overlaps the previous call's kernel
    where the kernel is the longer, so a sub-millisecond kernel is timed
    by itself."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def ptxas_summary(nvcc_log: str, marker: str) -> list[str]:
    """The registers, spills and serialised-wgmma notes ptxas (-Xptxas=-v)
    printed for each kernel whose mangled name holds ``marker`` (a template
    argument, e.g. "Li80E"), one line per kernel: "name<args>: ..."."""
    found, name = {}, None
    for line in nvcc_log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry.group(1) if marker in entry.group(1) else None
            if name:
                found[name] = {"regs": "? registers", "spill": "? spills"}
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if name and spill:
            found[name]["spill"] = f"{spill.group(1)} B spill stores, {spill.group(2)} B spill loads"
        elif name and regs:
            found[name]["regs"] = f"{regs.group(1)} registers"
    out = []
    for mangled, r in found.items():
        # The kernel's name follows its length in the mangling, then its
        # template arguments (ints, bools, the element type).
        label = mangled
        for m in re.finditer(r"flash_(?:fwd|bwd)\w*?kernel(?=I)", mangled):
            if mangled[:m.start()].endswith(str(len(m.group(0)))):
                args = re.findall(r"Li(\d+)E|Lb([01])E|I(13__nv_bfloat16|f)",
                                  mangled[m.end():].split("EEv")[0] + "E")
                label = m.group(0) + "<" + ", ".join(
                    n or {"1": "true", "0": "false"}.get(b_) or
                    {"f": "float", "13__nv_bfloat16": "bf16"}[t] for n, b_, t in args) + ">"
                break
        serial = any("C7512" in ln and mangled in ln for ln in nvcc_log.splitlines())
        out.append(f"{label}: {r['regs']}, {r['spill']}, wgmma serialised (C7512): "
                   f"{'yes' if serial else 'no'}")
    return out


def card_peaks(name: str) -> dict:
    return PEAKS["pcie" if "PCIe" in name else "sxm"]


def loglik_work(packed_np, xb: int = 8, wb: int = 8) -> tuple[float, float]:
    """(flops, bytes) this run's data needs: factor/solve operations from
    the real per-block counts, each input read once, one scalar out.
    ``xb`` / ``wb`` are the bytes per coordinate / per working value (bf16
    variants: 2 / 4)."""
    m_b = packed_np.nn_mask.sum(axis=1).astype(float)
    bs_b = packed_np.blk_mask.sum(axis=1).astype(float)
    flops = float(np.sum(m_b ** 3 / 3 + m_b ** 2 * (bs_b + 1) + m_b * bs_b ** 2 + bs_b ** 3 / 3))
    nbytes = float(xb * (np.prod(packed_np.blk_x.shape) + np.prod(packed_np.nn_x.shape))
                   + wb * sum(a.size for a in (packed_np.blk_y, packed_np.blk_mask,
                                               packed_np.nn_y, packed_np.nn_mask)))
    return flops, nbytes + wb * packed_np.blk_x.shape[0]


def factor_traffic(n_pad: int, c_pad: int, extra: int, real_pts, real_cols,
                   wb: int = 8) -> tuple[float, float]:
    """Reckoned scratch traffic (bytes) of the factorizations of one kernel
    call, earlier design against tiled one. Each block's joint matrix has
    its points and ``extra`` observation rows, and ``c`` factored columns
    (all points for the likelihood and the stats, the neighbours for
    prediction). The earlier design (padded blocks: n_pad points, c_pad
    columns; right-looking 16-column panels) reads and writes the trailing
    lower part once per panel; the tiled one (masked points left out:
    ``real_pts`` points and ``real_cols`` columns per block; left-looking
    32-column panels) reads the finished factor L[j0:, :j0] once per panel.
    Both also write and read the assembled lower part once and write the
    factor once, counted at each design's own size."""
    low = lambda rows, cols: cols * rows - cols * (cols - 1) / 2  # lower part, rows >= cols
    rows = n_pad + extra
    old = sum(2 * low(rows - t, c_pad - t) for t in range(16, c_pad, 16)) + 3 * low(rows, c_pad)
    new = 0.0
    for pc, c in zip(np.asarray(real_pts, float), np.asarray(real_cols, float)):
        j0 = np.arange(32, c, 32)
        new += float(np.sum((pc + extra - j0) * j0)) + 3 * low(pc + extra, c)
    return wb * float(old) * len(real_pts), wb * new


def block_traffic(packed_np, extra: int = 1, wb: int = 8) -> tuple[float, float]:
    """``factor_traffic`` of a likelihood (extra = 1) or multi-output stats
    (extra = p) call on a ``PackedBlocks``."""
    p_pad = packed_np.nn_mask.shape[1] + packed_np.blk_mask.shape[1]
    pc = packed_np.nn_mask.sum(axis=1) + packed_np.blk_mask.sum(axis=1)
    return factor_traffic(p_pad, p_pad, extra, pc, pc, wb)


def predict_traffic(packed_np, wb: int = 8) -> tuple[float, float]:
    """``factor_traffic`` of a prediction call on a ``PackedPrediction``."""
    m_pad = packed_np.nn_mask.shape[1]
    m_real = packed_np.nn_mask.sum(axis=1)
    return factor_traffic(m_pad + packed_np.q_mask.shape[1], m_pad, 1,
                          m_real + packed_np.q_mask.sum(axis=1), m_real, wb)


def predict_work(packed_np, xb: int = 8, wb: int = 8) -> tuple[float, float]:
    m_b = packed_np.nn_mask.sum(axis=1).astype(float)
    bs_b = packed_np.q_mask.sum(axis=1).astype(float)
    flops = float(np.sum(m_b ** 3 / 3 + m_b ** 2 * (bs_b + 1) + m_b * bs_b))
    nbytes = float(xb * (np.prod(packed_np.q_x.shape) + np.prod(packed_np.nn_x.shape))
                   + wb * sum(a.size for a in (packed_np.q_mask, packed_np.nn_y,
                                               packed_np.nn_mask)))
    return flops, nbytes + 2 * wb * packed_np.q_mask.size


def multi_work(packed_np, xb: int = 8, wb: int = 8) -> tuple[float, float]:
    """(flops, bytes) of the multi-output stats: the single-output chain
    with p right-hand sides instead of one, from the real per-block counts;
    each input read once, (1 + p) values out per block."""
    m_b = packed_np.nn_mask.sum(axis=1).astype(float)
    bs_b = packed_np.blk_mask.sum(axis=1).astype(float)
    p = packed_np.blk_y.shape[2]
    flops = float(np.sum(m_b ** 3 / 3 + m_b ** 2 * (bs_b + p) + m_b * bs_b ** 2
                         + 2 * m_b * bs_b * p + bs_b ** 3 / 3 + bs_b ** 2 * p))
    nbytes = float(xb * (np.prod(packed_np.blk_x.shape) + np.prod(packed_np.nn_x.shape))
                   + wb * sum(a.size for a in (packed_np.blk_y, packed_np.blk_mask,
                                               packed_np.nn_y, packed_np.nn_mask)))
    return flops, nbytes + wb * packed_np.blk_x.shape[0] * (1 + p)


def cov_work(b: int, na: int, nb: int, d: int, itemsize: int) -> tuple[float, float]:
    """(flops, bytes) of the batched covariance: 2d for the distance and
    ~15 for the Matern polynomial per entry; inputs read once, output once."""
    return float(b * na * nb * (2 * d + 15)), float(itemsize * b * ((na + nb) * d + na * nb))


# Operations of one f64 covariance entry besides its dot product, counted
# for the function and not for one kernel's code (an FMA counts 2): the
# distance from the norms and the dot product (an add and an FMA: 3); the
# square root from a reciprocal-square-root estimate by a Newton step (3
# FMAs), a correction (2 FMAs) and a product (11); exp(-r) as a Cody-Waite
# reduction (3 FMAs), a degree-11 polynomial (11 FMAs) and the scaling by
# 2^j (29); the cubic of nu = 3.5 (3 FMAs: 6); the products by exp(-r) and
# sigma2 (2). f64 has no hardware sqrt or exp; in f32 each is one
# instruction, hence `cov_work`'s ~15.
MATERN_F64_OPS = 51


def cov_bound_f64(b: int, na: int, nb: int, d: int, peaks) -> tuple[float, str, float, float]:
    """(ms, what bounds it, flops, bytes) of the f64 covariance: its bytes
    as in `cov_work`, its operations priced by pipe: the dot product's 2d
    per entry at the f64 tensor peak (DMMA can take it), the other
    `MATERN_F64_OPS` at the FP64 rate outside the tensor cores."""
    n = float(b * na * nb)
    _, nbytes = cov_work(b, na, nb, d, 8)
    t_ops = (n * 2 * d / peaks["f64"] + n * MATERN_F64_OPS / peaks["f64_simt"]) * 1e3
    t_bytes = nbytes / peaks["hbm"] * 1e3
    bnd, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
    return bnd, by, n * (2 * d + MATERN_F64_OPS), nbytes


def flash_pairs(s: int, window: int = 0) -> float:
    """The (query, key) pairs causal attention at S = T computes: S^2 / 2
    (the causal half) without a window, sum_i min(i + 1, window) with one
    (gemma2's local layers: 0.75 S^2 / 2 at S = 2 window)."""
    if window <= 0 or window >= s:
        return s * s / 2.0
    return window * (window + 1) / 2.0 + (s - window) * float(window)


def flash_work(b: int, h: int, hkv: int, s: int, hd: int, itemsize: int,
               window: int = 0) -> tuple[float, float]:
    """(flops, bytes) of causal attention at S = T: 4 hd per allowed pair
    and head (Q K^T and P V; 2 B H S^2 hd without a window); Q, K, V read
    once, O written once."""
    return (4.0 * b * h * flash_pairs(s, window) * hd,
            float(itemsize * (2 * b * h + 2 * b * hkv) * s * hd))


def flash_bwd_work(b: int, h: int, hkv: int, s: int, hd: int, itemsize: int,
                   window: int = 0) -> tuple[float, float]:
    """(flops, bytes) of causal attention's backward at S = T: five products
    of 2 hd per allowed pair and head (recompute S, dP, dV, dK, dQ: 5 B H
    S^2 hd without a window); q, k, v, do read once, dq, dk, dv written
    once."""
    return (10.0 * b * h * flash_pairs(s, window) * hd,
            float(itemsize * (3 * b * h + 4 * b * hkv) * s * hd))


def flash_edge_queries(k, n_heads: int, s: int, window: int, beta: float = 2.0):
    """Queries whose softmax peaks on the keys at the mask's edges: q_i =
    beta * (k_i + k_{i+1} [+ k_{i-window}]), KV head h // n_rep. Causal
    attention then gives about v_i, and a kernel that lets in key i + 1 (or
    i - window), or skips the tile holding key i, is off by O(1)."""
    import torch

    b, hkv, t, hd = k.shape
    kf = k.float().repeat_interleave(n_heads // hkv, dim=1)
    i = torch.arange(s, device=k.device)
    q = torch.zeros(b, n_heads, s, hd, device=k.device)
    for off in (0, 1) + ((-window,) if window > 0 else ()):
        j = i + off
        ok = (j >= 0) & (j < t)
        q[:, :, ok] += kf[:, :, j[ok]]
    return (beta * q).to(k.dtype)


def row_rel_err(got, want) -> float:
    """The largest relative L2 error over output rows (one query of one
    head): ||got - want|| / ||want|| along head_dim."""
    d = (got.float() - want.float()).norm(dim=-1)
    return float((d / want.float().norm(dim=-1)).max())


# The backward kernel against autograd through the plain version: f32 per
# element within 1e-4 of the gradient's largest entry (the same f32 sums in
# other orders); bf16 per output row (one query or key of one head) in
# relative L2 within 1e-2, beside 3e-2 of the largest entry per element, as
# the bf16 forward is held (both sides compute in f32 and round once to
# bf16; the kernel takes D = sum_j P dP in f32, not do . o from the bf16
# output, and its 'wgmma' route rounds P and dS to bf16 as the operands of
# its products).
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
BWD_ROW_TOL = 1e-2


def grad_check(got, want) -> dict:
    """One gradient (dq, dk or dv) against the plain version's: the largest
    error over the largest |entry|, the largest relative L2 error over rows
    (rows whose norm is under 1e-3 of the largest row's are measured against
    that floor: fully masked rows carry dq = 0), and whether both are within
    ``BWD_TOL`` / ``BWD_ROW_TOL`` for the dtype."""
    import torch

    g, w = got.float(), want.float()
    scale = float(w.abs().max()) or 1.0
    rel = float((g - w).abs().max()) / scale
    rn = w.norm(dim=-1)
    row = float(((g - w).norm(dim=-1) / rn.clamp_min(1e-3 * float(rn.max()) or 1.0)).max())
    dt = str(want.dtype).split(".")[-1]
    ok = (bool(torch.isfinite(g).all()) and rel <= BWD_TOL[dt]
          and (dt == "float32" or row <= BWD_ROW_TOL))
    return dict(max_abs_err=float((g - w).abs().max()), scaled_err=rel, row_rel=row, ok=ok)


def bound_ms(flops: float, nbytes: float, peaks, kind: str = "f64") -> tuple[float, str]:
    t_ops, t_bytes = flops / peaks[kind] * 1e3, nbytes / peaks["hbm"] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def slice_blocks(packed, bs: int, m: int, bc: int | None = None):
    """A ragged sub-problem of real packed blocks: first ``bc`` blocks, first
    ``bs`` block slots and ``m`` neighbour slots (masks sliced with them)."""
    from repro_torch.core.packing import PackedBlocks

    sl = slice(None, bc)
    return PackedBlocks(
        blk_x=packed.blk_x[sl, :bs], blk_y=packed.blk_y[sl, :bs],
        blk_mask=packed.blk_mask[sl, :bs], nn_x=packed.nn_x[sl, :m], nn_y=packed.nn_y[sl, :m],
        nn_mask=packed.nn_mask[sl, :m], owners=packed.owners[sl])


def lm_serving_phase(dev, peaks, results: dict) -> dict:
    """internlm2-1.8b serving at full width and depth: the flash kernel
    against its plain version, the path through the entry points, the
    model against its plain attention route, and times. Returns the launch
    counts of the path run (prefill and decode)."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (ROUTES, flash_attention_cuda,
                                                     flash_attention_plain, flash_route)
    from repro_torch.kernels.flash_attention import _launch as flash_launch
    from repro_torch.models.model import init_params, prefill_step

    cfg = get_config(LM_ARCH)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    t = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    cache_len = LM_PROMPT + LM_NEW
    kv_bytes = 2 * cfg.n_layers * LM_BATCH * cache_len * cfg.n_kv_heads * cfg.head_dim * 2
    log(f"phase lm init: {time.perf_counter() - t:.2f} s; {LM_ARCH} at full width and depth "
        f"(L={cfg.n_layers}, d={cfg.d_model}, H/Hkv={cfg.n_heads}/{cfg.n_kv_heads}, "
        f"hd={cfg.head_dim}, d_ff={cfg.d_ff}, V={cfg.vocab}): {n_par / 1e9:.3f} B parameters, "
        f"{n_bytes / 1e9:.2f} GB; KV cache {kv_bytes / 1e9:.2f} GB")

    # 13. The kernel against its plain version, at the path's shape and its
    # variants; the reference's elementwise tolerances
    # (tests/test_flash_attention.py). bf16 outputs of random inputs are
    # ~0.03-0.07, so 3e-2 * (1 + |o|) is about their size; bf16 is also held
    # per output row in relative L2 (ROW_TOL: the kernel rounds exp(s - m)
    # to bf16 before P . V, about 2e-3 of a row), on the random inputs and
    # on edge inputs whose outputs are O(1) and hinge on the mask's edges.
    tol = {torch.bfloat16: 3e-2, torch.float32: 2e-5}
    row_tol = 1e-2
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def qkv(b, h, hkv, s, t_, hd, dtype):
        mk = lambda *sh: torch.randn(*sh, generator=gen, device=dev).to(dtype)
        return mk(b, h, s, hd), mk(b, hkv, t_, hd), mk(b, hkv, t_, hd)

    path = (LM_BATCH, cfg.n_heads, cfg.n_kv_heads, LM_PROMPT, LM_PROMPT, cfg.head_dim, True, 0, 0.0)
    cases = [("path", path),
             ("ragged", (2, 16, 8, 1000, 1000, 128, True, 0, 0.0)),
             ("noncausal", (2, 16, 8, 64, 512, 128, False, 0, 0.0)),
             ("window17", (2, 16, 8, 1000, 1000, 128, True, 17, 0.0)),
             ("softcap50", (2, 16, 8, 1000, 1000, 128, True, 0, 50.0)),
             ("hd64", (2, 16, 8, 1000, 1000, 64, True, 0, 0.0)),
             ("hd64_mha", (2, 32, 32, 1000, 1000, 64, True, 0, 0.0)),
             ("short_long", (2, 16, 8, 100, 2000, 128, True, 0, 0.0)),
             ("window_softcap", (2, 16, 8, 1000, 1000, 128, True, 300, 30.0)),
             ("hd80", (2, 16, 8, 1000, 1000, 80, True, 0, 0.0)),
             ("hd256", (2, 16, 8, 1000, 1000, 256, True, 0, 0.0))]
    flash_err = None
    for label, (b, h, hkv, s, t_, hd, causal, window, cap) in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = qkv(b, h, hkv, s, t_, hd, dtype)
            inputs = [("random", q)]
            if dtype == torch.bfloat16:
                inputs.append(("edge", flash_edge_queries(k, h, s, window)))
            for kind, qq in inputs:
                want = flash_attention_plain(qq, k, v, causal=causal, window=window, softcap=cap)
                got = flash_attention_cuda(qq, k, v, causal=causal, window=window, softcap=cap)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                bad = float(((got.float() - want.float()).abs()
                             - tol[dtype] * (1 + want.float().abs())).max())
                row = row_rel_err(got, want)
                log(f"flash {label} {str(dtype)[6:]} {kind}: B={b} H={h} Hkv={hkv} S={s} T={t_} "
                    f"hd={hd} causal={causal} window={window} softcap={cap}: "
                    f"max_abs_err={err:.3e} (tol {tol[dtype]:g}), row rel L2 max {row:.3e}"
                    + (f" (tol {row_tol:g})" if dtype == torch.bfloat16 else ""))
                check(bool(torch.isfinite(got).all()), f"flash {label}: non-finite kernel output")
                check(bad <= 0, f"flash {label} {dtype} {kind}: kernel vs plain max_abs_err "
                                f"{err:.3e} beyond rtol = atol = {tol[dtype]:g}")
                if dtype == torch.bfloat16:
                    check(row <= row_tol, f"flash {label} bf16 {kind}: kernel vs plain row "
                                          f"rel L2 {row:.3e} > {row_tol:g}")
                if label == "path" and dtype == torch.bfloat16 and kind == "random":
                    flash_err = err
                del want, got
            del q, k, v, inputs
    torch.cuda.empty_cache()

    # 14. The path through the entry points: prefill, then greedy decode.
    prompt = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, (LM_BATCH, LM_PROMPT)),
                             dtype=torch.int32, device=dev)
    served = _serve_path("lm", model, prompt, LM_NEW, cache_len,
                         hbm_ms=1e3 * (n_bytes + kv_bytes) / peaks["hbm"], keep=True)
    logits, t_prefill = served["logits"], served["prefill_s"]

    # 14b. Meshes and tp (ROADMAP item 13.6): the same weights and prompt at
    # --mesh 1x16 (tp = 16, the 8 KV heads cached twice each) against this
    # run, and the dry run's bytes at 1x1 against the card's tensors.
    t = time.perf_counter()
    card1 = _reckoned_vs_card("internlm2", "1x1", LM_BATCH, cache_len, model, served["cache"])
    hold = _tp_serving_hold("internlm2", model, prompt, LM_TP_MESH, cache_len, served, 3e-2)
    hold["seconds"] = time.perf_counter() - t
    results.setdefault("mesh_tp", {})["internlm2"] = dict(hold, card_1x1=card1)
    # The sharded phase holds its ranks against this run's tokens and logits.
    results["lm_whole"] = dict(tokens=served["tokens"].cpu(), logits=served["logits"].cpu(),
                               step_logits=[x.cpu() for x in served["step_logits"]],
                               cache_len=cache_len)
    for key in ("logits", "cache", "tokens", "step_logits"):
        del served[key]
    torch.cuda.empty_cache()

    # 15. The same weights through the plain attention route
    # (use_flash="never"), and both routes against the same weights in f32
    # (the kernel's f32 path), by _route_holds. The two bf16 routes round
    # different numbers: the kernel rounds the unnormalised exp(s - m_running)
    # to bf16 before P . V and divides by the f32 sum at the end; the never
    # route rounds the normalised P. Through L layers of bf16 activations at
    # d_model 2048 these differences grow, and the two routes lie about
    # equally far from the f32 model, so an elementwise 3e-2 between them
    # (the reference's reduced-size flash-vs-XLA prefill tolerance, tests/
    # test_flash_integration.py) does not hold at full width: it leaves out
    # ~4e-4 of the logits at L = 2 and ~2e-2 at L = 24.
    with torch.inference_mode():
        logits_never, _ = prefill_step(_sub_model(model, cfg.n_layers, use_flash="never"),
                                       prompt, cache_len)
        torch.cuda.synchronize()
        logits_32, _ = prefill_step(_sub_model(model, cfg.n_layers, dtype=torch.float32),
                                    prompt, cache_len)
    _route_holds(f"lm prefill logits ({cfg.n_layers} layers, bf16)", logits, logits_never,
                 logits_32)
    del logits, logits_never, logits_32
    torch.cuda.empty_cache()
    # A 2-layer full-width f32 model: the two routes elementwise, and decode
    # after a prefill of s tokens against a prefill of s + 1.
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    m2 = init_params(cfg2, torch.Generator(device=dev).manual_seed(SEED + 1), device=dev)
    _f32_holds("lm f32 2-layer", m2, prompt, min(1000, LM_PROMPT - 1))
    del m2
    torch.cuda.empty_cache()

    # 16. Times at the path's shape: the kernel, its plain version, and the
    # library call that computes the same function at S = T (timed here
    # only; the port never calls it).
    q, k, v = qkv(*path[:6], torch.bfloat16)
    # The earlier mma.sync design at the path's shape, kept callable for
    # this side-by-side timing (parent, change, change, parent): the same
    # function, held to the bf16 limits against the wgmma route.
    mma = lambda: flash_launch(ROUTES["mma"], q, k, v, True, 0, 0.0)
    got, base = flash_attention_cuda(q, k, v), mma()
    base_row = row_rel_err(got, base)
    check(base_row <= row_tol, f"flash wgmma vs mma baseline row rel L2 {base_row:.3e}")
    del got, base
    m1_ms = cuda_ms(mma)
    k_ms = cuda_ms(lambda: flash_attention_cuda(q, k, v))
    k2_ms = cuda_ms(lambda: flash_attention_cuda(q, k, v))
    m2_ms = cuda_ms(mma)
    # The same pair with 10 calls back to back per event pair, so that the
    # host's work before each launch (which the single calls include) runs
    # under the previous kernel: the kernels' own ratio.
    mb1_ms, kb1_ms, kb2_ms, mb2_ms = (
        cuda_ms(fn, inner=10) for fn in (mma, lambda: flash_attention_cuda(q, k, v),
                                         lambda: flash_attention_cuda(q, k, v), mma))
    with torch.inference_mode():
        p_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), reps=3)
    kx, vx = k.repeat_interleave(n_rep, dim=1), v.repeat_interleave(n_rep, dim=1)
    l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, kx, vx, is_causal=True))
    q32, k32, v32 = q.float(), k.float(), v.float()
    k32_ms = cuda_ms(lambda: flash_attention_cuda(q32, k32, v32))
    flops, nbytes = flash_work(*path[:4], path[5], 2)
    b_ms, b_by = bound_ms(flops, nbytes, peaks, "bf16")
    log(f"flash time at B={path[0]} H={path[1]} Hkv={path[2]} S=T={path[3]} hd={path[5]}: kernel "
        f"bf16 ({flash_route(q.dtype, path[5])} route) {k_ms:.3f} / {k2_ms:.3f} ms "
        f"({flops / k_ms / 1e9:.2f} TFLOP/s, {100 * b_ms / k_ms:.1f} % of the bound), f32 "
        f"{k32_ms:.3f} ms; earlier mma.sync kernel bf16 {m1_ms:.3f} / {m2_ms:.3f} ms (before / "
        f"after; wgmma / mma.sync {k_ms / m1_ms:.3f} / {k2_ms / m2_ms:.3f}; wgmma vs mma row rel "
        f"L2 {base_row:.3e}; back to back wgmma {kb1_ms:.4f} / {kb2_ms:.4f} ms, mma.sync "
        f"{mb1_ms:.4f} / {mb2_ms:.4f} ms, wgmma / mma.sync {kb1_ms / mb1_ms:.3f} / "
        f"{kb2_ms / mb2_ms:.3f}); plain bf16 {p_ms:.3f} ms; "
        f"scaled_dot_product_attention bf16 {l_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by}; "
        f"{flops:.3e} flop, {nbytes:.3e} B); {cfg.n_layers} calls per prefill = "
        f"{cfg.n_layers * k_ms / 1e3:.3f} s of the {t_prefill:.3f} s prefill")
    results["flash_attention"] = dict(max_abs_err=flash_err, ms=k_ms, plain_ms=p_ms,
                                      bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
                                      f32_ms=k32_ms, baseline_ms=[m1_ms, m2_ms],
                                      back_to_back_ms=[kb1_ms, kb2_ms],
                                      baseline_back_to_back_ms=[mb1_ms, mb2_ms])
    del q, k, v, kx, vx, q32, k32, v32, model
    torch.cuda.empty_cache()
    return served["launches"]


def _main_run(ttrain, argv) -> tuple:
    """``launch.train.main(argv)``: its final state and its per-step log."""
    log_ = []
    return ttrain.main(argv, log=log_), log_


def attn_applications(cfg) -> int:
    """Attention calls in one forward of ``cfg``'s stack: every layer of an
    attention stack, the shared block once per group of a hybrid, none in
    rwkv6."""
    if cfg.block_kind == "attn":
        return cfg.n_layers
    return cfg.n_layers // cfg.attn_every if cfg.attn_every else 0


def _train_run(dev, label: str, fn, steps: int, micro: int, n_attn: int, n_tok: int,
               note: str = "") -> tuple:
    """One training run, ``fn() -> (state, per-step log)``, with its
    launches counted and its peak device memory read: the losses and
    gradient norms are finite (a finite norm: every gradient leaf finite),
    and each microbatch launched the forward twice per attention
    application (``n_attn``: forward and remat recompute) and the backward
    once. ``note`` is printed after the peak. Returns (state, record,
    counts)."""
    import torch

    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t = time.perf_counter()
    state, log_ = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    c = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [r["loss"] for r in log_]
    norms = [r["grad_norm"] for r in log_]
    step_s = statistics.median(r["seconds"] for r in log_[1:]) if len(log_) > 1 else wall
    log(f"lm training {label}: {steps} steps in {wall:.2f} s; per step {step_s:.3f} s "
        f"(median after the first, which took {log_[0]['seconds']:.3f} s), "
        f"{n_tok / step_s:.0f} tokens/s; peak device memory {peak / 1e9:.2f} GB{note}; losses "
        f"{[round(x, 4) for x in losses]}; grad norms {[round(x, 4) for x in norms]}; "
        f"launches flash_attention {c['flash_attention']} "
        f"({c['flash_attention'] / steps:g} per step), flash_attention_bwd "
        f"{c['flash_attention_bwd']} ({c['flash_attention_bwd'] / steps:g} per step)")
    check(len(losses) == steps and all(math.isfinite(x) for x in losses + norms),
          f"lm training {label}: missing or non-finite loss or grad norm")
    check(c["flash_attention"] == steps * micro * 2 * n_attn,
          f"lm training {label}: {c['flash_attention']} forward launches, expected "
          f"{steps * micro * 2 * n_attn} (attention calls x (forward + remat recompute))")
    check(c["flash_attention_bwd"] == steps * micro * n_attn,
          f"lm training {label}: {c['flash_attention_bwd']} backward launches, expected "
          f"{steps * micro * n_attn}")
    rec = dict(seconds=wall, step_s=step_s, tokens_per_s=n_tok / step_s, peak_bytes=peak,
               losses=losses, grad_norms=norms)
    return state, rec, c


def lm_training_phase(dev, peaks, results: dict, work: str) -> dict:
    """LM training (ROADMAP item 13.1) on internlm2-1.8b at full width and
    depth: the flash-attention backward kernel against autograd through the
    plain version at the path's shape and its variants, and timed beside the
    library's backward; ``launch.train.main`` for 6 steps, then 2 at
    grad_accum 2, then 2 with int8 compression (``make_train_step(compress=
    True)``); a checkpoint resume on the reduced config. Returns the launch
    counts of the path's runs."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels.flash_attention import (_bwd_launch, flash_attention_bwd_cuda,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_cuda, flash_bwd_route)
    from repro_torch.launch import train as ttrain
    from repro_torch.models.model import TransformerLM, init_params, lm_loss
    from repro_torch.optim import adam_update
    from repro_torch.training.train_step import _bind, make_train_step, train_state_init

    cfg = get_config(LM_ARCH)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    mk = lambda *sh, dtype: torch.randn(*sh, generator=gen, device=dev).to(dtype)

    # 49. The backward kernels against autograd through the plain version,
    # at the path's shape (B = 4, H = 16, Hkv = 8, S = T = 2048, hd = 128,
    # causal) and at small variants (window, softcap, hd 64 and 80, GQA at
    # n_rep 4 off the tiles, S < T without causality, rows with no allowed
    # key, one row), through the route flash_bwd_route gives: bf16 at hd 64,
    # 80 and 128 on 'wgmma' (the forward's statistics computed first), the
    # rest on 'scalar'.
    path = (TRAIN_BATCH, cfg.n_heads, cfg.n_kv_heads, TRAIN_SEQ, TRAIN_SEQ, cfg.head_dim,
            True, 0, 0.0)
    cases = [("path", path), ("window", (1, 4, 2, 600, 600, 128, True, 100, 0.0)),
             ("softcap", (1, 4, 2, 300, 300, 128, True, 0, 30.0)),
             ("hd64", (1, 4, 2, 300, 300, 64, True, 0, 0.0)),
             ("hd80", (1, 4, 2, 300, 300, 80, True, 0, 0.0)),
             ("gqa4", (1, 8, 2, 333, 333, 128, True, 0, 0.0)),
             ("noncausal", (1, 4, 2, 200, 600, 128, False, 0, 0.0)),
             ("empty_rows", (1, 4, 2, 600, 100, 128, True, 50, 0.0)),
             ("one_row", (1, 4, 2, 1, 1, 64, True, 0, 0.0))]
    bwd_err = None
    for label, (b, h, hkv, s_, t_, hd, causal, window, cap) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = mk(b, h, s_, hd, dtype=dtype), mk(b, hkv, t_, hd, dtype=dtype), \
                mk(b, hkv, t_, hd, dtype=dtype)
            do = mk(b, h, s_, hd, dtype=dtype)
            got = flash_attention_bwd_cuda(q, k, v, do, causal=causal, window=window, softcap=cap)
            want = flash_attention_bwd_plain(q, k, v, do, causal=causal, window=window,
                                             softcap=cap)
            torch.cuda.synchronize()
            res = {n: grad_check(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
            log(f"flash_bwd {label} {str(dtype)[6:]} ({flash_bwd_route(dtype, hd)} route): B={b} "
                f"H={h} Hkv={hkv} S={s_} T={t_} hd={hd} causal={causal} window={window} "
                f"softcap={cap}: " + "; ".join(
                    f"{n} max_abs_err {r['max_abs_err']:.3e} ({r['scaled_err']:.2e} of the "
                    f"largest, row rel L2 {r['row_rel']:.2e})" for n, r in res.items())
                + f" (limits {BWD_TOL[str(dtype)[6:]]:g} of the largest"
                + (f", rows {BWD_ROW_TOL:g})" if dtype == torch.bfloat16 else ")"))
            check(all(r["ok"] for r in res.values()),
                  f"flash_bwd {label} {dtype}: kernel vs plain autograd {res}")
            if label == "path" and dtype == torch.bfloat16:
                bwd_err = max(r["max_abs_err"] for r in res.values())
            del q, k, v, do, got, want
    torch.cuda.empty_cache()

    # 50. Times at the path's shape: the 'wgmma' route, from the forward's
    # statistics as training calls it, beside the scalar kernels on the same
    # bf16 inputs (the 'scalar' route, uncounted: baseline, kernel, kernel,
    # baseline; first held against each other), the f32 route, the plain
    # version, and the library's backward (scaled_dot_product_attention on
    # the repeated KV; timed here only, the port never calls it); then the
    # wgmma forward with and without the statistics (10 calls back to back
    # per event pair: without, with, with, without).
    b, h, hkv, s_, _, hd = path[:6]
    q, k, v, do = (mk(b, h, s_, hd, dtype=torch.bfloat16), mk(b, hkv, s_, hd, dtype=torch.bfloat16),
                   mk(b, hkv, s_, hd, dtype=torch.bfloat16), mk(b, h, s_, hd, dtype=torch.bfloat16))
    _, stats = flash_attention_cuda(q, k, v, return_stats=True)
    kern = lambda: flash_attention_bwd_cuda(q, k, v, do, stats=stats)
    base = lambda: _bwd_launch("scalar", q, k, v, do, True, 0, 0.0)
    res = {n: grad_check(g, w) for n, g, w in zip(("dq", "dk", "dv"), kern(), base())}
    log("flash_bwd wgmma route vs the scalar kernels at the path shape: " + "; ".join(
        f"{n} {r['scaled_err']:.2e} of the largest, rows {r['row_rel']:.2e}"
        for n, r in res.items()))
    check(all(r["ok"] for r in res.values()), f"flash_bwd wgmma vs scalar baseline: {res}")
    b1_ms = cuda_ms(base)
    k_ms = cuda_ms(kern)
    k2_ms = cuda_ms(kern)
    b2_ms = cuda_ms(base)
    p_ms = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, do), reps=3)
    qx = q.detach().requires_grad_(True)
    kx = k.repeat_interleave(n_rep, dim=1).requires_grad_(True)
    vx = v.repeat_interleave(n_rep, dim=1).requires_grad_(True)
    ox = F.scaled_dot_product_attention(qx, kx, vx, is_causal=True)
    l_ms = cuda_ms(lambda: torch.autograd.grad(ox, (qx, kx, vx), do, retain_graph=True))
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    k32_ms = cuda_ms(lambda: flash_attention_bwd_cuda(q32, k32, v32, do32), reps=3)
    fwd = lambda: flash_attention_cuda(q, k, v)
    fwd_st = lambda: flash_attention_cuda(q, k, v, return_stats=True)
    f1_ms, s1_ms, s2_ms, f2_ms = (cuda_ms(fn, inner=10) for fn in (fwd, fwd_st, fwd_st, fwd))
    flops, nbytes = flash_bwd_work(b, h, hkv, s_, hd, 2)
    b_ms, b_by = bound_ms(flops, nbytes, peaks, "bf16")
    log(f"flash_bwd time at B={b} H={h} Hkv={hkv} S=T={s_} hd={hd} causal: kernel bf16 "
        f"({flash_bwd_route(q.dtype, hd)} route) {k_ms:.3f} / {k2_ms:.3f} ms "
        f"({flops / k_ms / 1e9:.2f} TFLOP/s of the function's work, {100 * b_ms / k_ms:.2f} % of "
        f"the bf16 bound), f32 ({flash_bwd_route(torch.float32, hd)} route) {k32_ms:.3f} ms; the "
        f"scalar kernels bf16 {b1_ms:.3f} / {b2_ms:.3f} ms (before / after; "
        f"{min(b1_ms, b2_ms) / max(k_ms, k2_ms):.1f}x the wgmma route's time); plain (autograd "
        f"through flash_attention_plain) bf16 {p_ms:.3f} ms; scaled_dot_product_attention "
        f"backward bf16 {l_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by}; {flops:.3e} flop, "
        f"{nbytes:.3e} B)")
    log(f"flash forward (wgmma route) at the training shape: {f1_ms:.4f} / {f2_ms:.4f} ms without "
        f"the statistics, {s1_ms:.4f} / {s2_ms:.4f} ms with them (before / after; "
        f"{100 * (min(s1_ms, s2_ms) / min(f1_ms, f2_ms) - 1):+.1f} %)")
    check(max(k_ms, k2_ms) < min(b1_ms, b2_ms),
          f"flash_bwd: the wgmma route ({k_ms:.3f} ms) is not faster than the scalar kernels "
          f"({b1_ms:.3f} ms)")
    results["flash_attention_bwd"] = dict(max_abs_err=bwd_err, ms=k_ms, plain_ms=p_ms,
                                          bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
                                          f32_ms=k32_ms, baseline_ms=[b1_ms, b2_ms],
                                          fwd_ms=[f1_ms, f2_ms], fwd_stats_ms=[s1_ms, s2_ms])
    del q, k, v, do, stats, qx, kx, vx, ox, q32, k32, v32, do32
    torch.cuda.empty_cache()

    # 51. The path: launch.train.main at full width and depth, 6 steps.
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    n_par = sum(p.numel() for p in TransformerLM(cfg, device="meta").parameters())
    log(f"phase lm training: {LM_ARCH} (L={cfg.n_layers}, d={cfg.d_model}, V={cfg.vocab}): "
        f"{n_par / 1e9:.3f} B parameters; bf16 params and grads {4 * n_par / 1e9:.2f} GB, f32 "
        f"moments {8 * n_par / 1e9:.2f} GB (reckoned)")
    route = flash_bwd_route(getattr(torch, cfg.dtype), cfg.head_dim)
    log(f"lm training: the attention backward's route is {route!r} ({cfg.dtype}, "
        f"hd {cfg.head_dim})")
    check(route == "wgmma", f"lm training: the path's attention backward route is {route!r}")
    argv = ["--arch", LM_ARCH, "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--lr", str(TRAIN_LR), "--device", str(dev)]
    counts = {"flash_attention": 0, "flash_attention_bwd": 0}
    out = {}

    def run(label, fn, steps, micro):
        state, rec, c = _train_run(dev, label, fn, steps, micro, cfg.n_layers, n_tok)
        for k_ in counts:
            counts[k_] += c[k_]
        out[label] = rec
        return state, rec["losses"]

    def main_run(extra):
        return _main_run(ttrain, argv + extra)

    state, losses = run("grad_accum 1", lambda: main_run(["--steps", str(TRAIN_STEPS)]),
                        TRAIN_STEPS, 1)
    lo, hi = 0.5 * math.log(cfg.vocab), 2.5 * math.log(cfg.vocab)
    check(lo < losses[0] < hi, f"lm training: first loss {losses[0]:.4f} outside "
                               f"[{lo:.3f}, {hi:.3f}] = [0.5, 2.5] log(vocab)")
    check(losses[-1] < losses[0], f"lm training: loss did not fall over {TRAIN_STEPS} steps "
                                  f"({losses})")
    # Where a step's time goes: the value and gradient, and the Adam update,
    # each timed apart (CUDA events, median of 3) on the trained state and
    # the stream's next batch.
    tok, lab = (torch.as_tensor(a, device=dev) for a in
                TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=17,
                            start_batch=TRAIN_STEPS).next())
    model = _bind(cfg, state.params)
    leaves = tuple(model.parameters())
    value_and_grad = lambda: torch.autograd.grad(lm_loss(model, tok, lab), leaves)
    grads = value_and_grad()
    vg_ms = cuda_ms(value_and_grad, reps=3, warm=0)
    adam_ms = cuda_ms(lambda: adam_update(grads, state.opt, state.params, TRAIN_LR), reps=3,
                      warm=0)
    log(f"lm training step split: value and gradient {vg_ms:.1f} ms (of which the attention "
        f"backward {cfg.n_layers} x {k_ms:.2f} = {cfg.n_layers * k_ms:.1f} ms), Adam update "
        f"{adam_ms:.1f} ms; the step {1e3 * out['grad_accum 1']['step_s']:.1f} ms on the host "
        f"clock")
    out["split_ms"] = dict(value_and_grad=vg_ms, adam=adam_ms,
                           attention_backward=cfg.n_layers * k_ms)
    del state, model, leaves, grads
    torch.cuda.empty_cache()
    run("grad_accum 2", lambda: main_run(["--steps", "2", "--grad-accum", "2"]), 2, 2)
    torch.cuda.empty_cache()

    def compressed():
        st = train_state_init(init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                                          device=dev))
        step = make_train_step(cfg, lr=TRAIN_LR, compress=True)
        stream = TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=17)
        err, log_ = None, []
        for i in range(2):
            t0 = time.perf_counter()
            st, m, err = step(st, *stream.next(), err)
            torch.cuda.synchronize()
            log_.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                         "seconds": time.perf_counter() - t0})
        check(all(bool(torch.isfinite(e).all()) for e in err), "int8 compression: bad error")
        return st, log_

    state, _ = run("int8 compression", compressed, 2, 1)
    del state
    torch.cuda.empty_cache()

    # 52. Resume on the reduced config: 4 steps straight, then 2 + resume 2.
    red = ["--reduced", "--batch", str(TRAIN_BATCH), "--seq", "256", "--device", str(dev),
           "--ckpt-every", "2"]
    straight = ttrain.main(red + ["--steps", "4", "--ckpt-dir", os.path.join(work, "a")])
    ttrain.main(red + ["--steps", "2", "--ckpt-dir", os.path.join(work, "b")])
    resumed = ttrain.main(red + ["--steps", "2", "--ckpt-dir", os.path.join(work, "b"),
                                 "--resume"])
    flat = lambda st: torch.cat([p.float().ravel() for p in st.params])
    a_, b_ = flat(straight), flat(resumed)
    rel = float(torch.linalg.norm(a_ - b_) / torch.linalg.norm(a_))
    log(f"lm training resume (reduced, 4 steps straight vs 2 + resume 2): steps "
        f"{straight.step} / {resumed.step}, params relative L2 difference {rel:.3e} (limit "
        f"1e-6), bitwise {bool(torch.equal(a_, b_))}")
    check(straight.step == resumed.step == 4, "lm training resume: step counts differ")
    check(rel <= 1e-6, f"lm training resume: params {rel:.3e} from the straight run")
    out["resume_rel"] = rel
    results["lm_training"] = out
    return counts


def _local_flash_holds(dev, b: int, h: int, hkv: int, s: int, hd: int, backward: bool,
                       seed: int) -> dict:
    """One rank's flash forward (and backward) on the 'wgmma' route at its
    local-head shape, against the plain version on the same bf16 inputs:
    the serving phase's elementwise and per-row limits, the backward's
    ``grad_check``. These launches are not the path's: the caller resets the
    counts before it drives the path."""
    import torch

    from repro_torch.kernels.flash_attention import (flash_attention, flash_attention_bwd_cuda,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_plain, flash_bwd_route,
                                                     flash_route)

    gen = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *sh: torch.randn(*sh, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = mk(b, h, s, hd), mk(b, hkv, s, hd), mk(b, hkv, s, hd)
    got, want = flash_attention(q, k, v), flash_attention_plain(q, k, v)
    err = float((got.float() - want.float()).abs().max())
    bad = float(((got.float() - want.float()).abs() - 3e-2 * (1 + want.float().abs())).max())
    row = row_rel_err(got, want)
    out = dict(shape=[b, h, hkv, s, hd], route=flash_route(q.dtype, hd), max_abs_err=err, row=row,
               ok=bool(torch.isfinite(got).all()) and bad <= 0 and row <= 1e-2)
    del got, want
    if backward:
        do = mk(b, h, s, hd)
        bwd = flash_attention_bwd_cuda if q.is_cuda else flash_attention_bwd_plain
        res = {n: grad_check(g, w) for n, g, w in
               zip(("dq", "dk", "dv"), bwd(q, k, v, do), flash_attention_bwd_plain(q, k, v, do))}
        out.update(bwd_route=flash_bwd_route(q.dtype, hd),
                   bwd_max_abs_err=max(r["max_abs_err"] for r in res.values()),
                   bwd_ok=all(r["ok"] for r in res.values()))
    return out


def _routing_recorder(n_calls: int):
    """A context in which ``MoE.routing`` keeps, for its first ``n_calls``
    calls, the (tokens, experts) bool matrix of the kept assignments (on
    the device; the caller moves them)."""
    import torch

    from repro_torch.models.moe import MoE

    seen = []
    orig = MoE.routing

    def routing(self, *a, **kw):
        r = orig(self, *a, **kw)
        if len(seen) < n_calls:
            g, gs, k = r.expert.shape
            kept = torch.zeros(g * gs, r.probs.shape[-1], dtype=torch.bool, device=r.keep.device)
            seen.append(kept.scatter_(1, r.expert.reshape(-1, k), r.keep.reshape(-1, k)))
        return r

    @contextlib.contextmanager
    def ctx():
        MoE.routing = routing
        try:
            yield seen
        finally:
            MoE.routing = orig

    return ctx()


def _rank_serve(world, dev, cfg, prompt_seed: int, work: str, tag: str,
                shape=(LM_BATCH, LM_PROMPT), flash: bool = True,
                mesh_name: str = SHARD_SERVE_MESH) -> dict:
    """One rank's serving at ``mesh_name``: its shards of the seed-0
    weights (``init_shards``; drawn four ranks at a time, as minitron-4b's
    whole embedding and its f32 draw, ~7 GB, would not fit the card sixteen
    times over), its rows of the ``prompt_seed`` prompt (the first ``shape`` of
    the LM_BATCH x LM_PROMPT one) prefilled, SHARD_DECODE steps decoded
    teacher-forced on the whole run's tokens (``DIR/<tag>_tokens.npy``);
    the gathered logits of each data rank's rows to
    ``DIR/<tag>_logits.d<data index>.npz``; then, with ``flash``, the flash
    forward at the heads the rank computes."""
    import torch

    from repro_torch.configs import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import lm_cell_bytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.collectives import MeshComm
    from repro_torch.sharding.placement import bind_shards, init_shards, shard_batch
    from repro_torch.training.serve import make_decode_step, make_prefill_step

    r = world.rank
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    mesh = make_mesh(mesh_name)
    comm = MeshComm(mesh, r, world)
    tp = mesh.shape["model"]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for turn in range(-(-world.size // 4)):
        if turn == r // 4:              # four ranks draw at a time
            shards = init_shards(cfg, gen, mesh, r, dev)
        if mesh.size > 4:
            comm.barrier()
    model = bind_shards(cfg, shards, mesh, r, comm)
    del shards
    sync()
    t_init = time.perf_counter() - t
    cache_len = shape[1] + LM_NEW
    prompt = torch.as_tensor(np.random.default_rng(prompt_seed).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))[:shape[0], :shape[1]], dtype=torch.int32,
        device=dev)
    prompt = shard_batch(prompt, mesh, r)
    forced = shard_batch(torch.as_tensor(np.load(os.path.join(work, f"{tag}_tokens.npy")),
                                         device=dev), mesh, r)
    prefill, decode = make_prefill_step(cfg, cache_len, tp=tp), make_decode_step(cfg, tp=tp)
    _, warm = prefill(model, prompt[:, :256])   # cuBLAS picks its algorithms per shape
    decode(model, prompt[:, :1], warm)
    del warm
    sync()
    ops.reset_launch_counts()
    comm.reset_stats()
    t = time.perf_counter()
    logits, cache = prefill(model, prompt)
    sync()
    t_prefill = time.perf_counter() - t
    pre, pre_comm = ops.launch_counts(), comm.summary()
    ops.reset_launch_counts()
    comm.reset_stats()
    steps = []
    t = time.perf_counter()
    for i in range(SHARD_DECODE):
        _, lg, cache = decode(model, forced[:, i:i + 1], cache)
        steps.append(lg)
    sync()
    t_decode = time.perf_counter() - t
    dec, dec_comm = ops.launch_counts(), comm.summary()
    rec = lm_cell_bytes(cfg, ShapeSpec("smoke", cache_len, shape[0], "decode"), mesh)
    attn = (model.layers[0].attn if cfg.block_kind == "attn"
            else model.shared_attn.attn if cfg.attn_every else None)
    heads = None
    if attn is not None:
        _, hq, _, nkv, _, _ = attn._local()
        heads = (hq, nkv if attn.aligned else hq)   # unaligned: a KV head per query head
    out = dict(
        mesh=mesh_name, prompt=list(shape), init_s=t_init, prefill_s=t_prefill, decode_s=t_decode,
        decode_ms=1e3 * t_decode / SHARD_DECODE, prefill_launches=pre, decode_launches=dec,
        prefill_collectives=pre_comm, decode_collectives=dec_comm,
        params=nbytes(model.parameters()), params_reckoned=rec["param_bytes"],
        cache=nbytes(v for v in cache.values() if torch.is_tensor(v)),
        cache_reckoned=rec["cache_bytes"],
        cache_shape={k: list(v.shape) for k, v in cache.items() if torch.is_tensor(v)},
        experts=model.layers[0].moe.w_gate.shape[0] if cfg.n_experts else 0,
        tokens=[torch.argmax(x, dim=-1).tolist() for x in [logits] + steps],
        peak=torch.cuda.max_memory_allocated(dev) if cuda else 0)
    coords = mesh.coords(r)
    if coords[mesh.axis_names.index("model")] == 0:
        np.savez(os.path.join(work, f"{tag}_logits.d{coords[0]}.npz"),
                 prefill=logits.float().cpu().numpy(),
                 steps=torch.stack(steps).float().cpu().numpy())
    del model, cache, logits, steps
    if cuda:
        torch.cuda.empty_cache()
    if flash:
        out["flash"] = _local_flash_holds(dev, prompt.shape[0], heads[0], heads[1], shape[1],
                                          cfg.head_dim, False, SEED + 20 + r)
    comm.barrier()
    return out


def _rank_train(world, dev, cfg, work: str, tag: str, flash: bool = True) -> dict:
    """One rank's training at SHARD_TRAIN_MESH: its shards of the seed-0
    weights and their Adam moments, SHARD_TRAIN_STEPS steps of
    ``make_train_step(comm=)`` on the first batches of ``TokenStream(seed=
    17)``; the first step's gradient shards to ``DIR/<tag>_grads.rank<r>.pt``
    (an MoE's kept (token, expert) assignments of that step's forward, per
    layer, to ``DIR/<tag>_kept.rank<r>.pt``); then, with ``flash``, the
    flash forward and backward at its local heads."""
    import torch

    from repro_torch.configs import ShapeSpec
    from repro_torch.data.tokens import TokenStream
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import lm_cell_bytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import lm_loss
    from repro_torch.sharding.collectives import MeshComm
    from repro_torch.sharding.placement import bind_shards, init_shards, shard_batch
    from repro_torch.training.train_step import make_train_step, train_state_init

    r = world.rank
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    mesh = make_mesh(SHARD_TRAIN_MESH)
    comm = MeshComm(mesh, r, world)
    tp = mesh.shape["model"]
    state = train_state_init(init_shards(cfg, torch.Generator(device=dev).manual_seed(SEED), mesh,
                                         r, dev))
    stream = TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=17)
    step = make_train_step(cfg, lr=TRAIN_LR, comm=comm)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    comm.reset_stats()
    log_, first = [], None
    for i in range(SHARD_TRAIN_STEPS):
        batch = stream.next()
        with _routing_recorder(cfg.n_layers if cfg.n_experts and i == 0 else 0) as kept:
            t = time.perf_counter()
            state, m = step(state, *batch)
            sync()
            log_.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                             seconds=time.perf_counter() - t))
        if i == 0:
            # The first step's gradient shards, read back from Adam's first
            # moment (mu = (1 - b1) g from zeros; f32, so within an ulp of
            # g) and held against the whole run's; outside the timed step.
            first = batch
            torch.save([(mu / (1.0 - 0.9)).to(p.dtype).cpu()
                        for mu, p in zip(state.opt.mu, state.params)],
                       os.path.join(work, f"{tag}_grads.rank{r}.pt"))
            if kept and mesh.coords(r)[1] == 0:
                torch.save([k.cpu() for k in kept], os.path.join(work, f"{tag}_kept.rank{r}.pt"))
    counts, coll = ops.launch_counts(), comm.summary()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    # The first batch's loss after the run, against its loss at the first step.
    bound = bind_shards(cfg, state.params, mesh, r, comm)
    with torch.no_grad():
        after = float(lm_loss(bound, *(shard_batch(torch.as_tensor(a, device=dev), mesh, r)
                                       for a in first)))
    del bound
    rec = lm_cell_bytes(cfg, ShapeSpec("smoke", TRAIN_SEQ, TRAIN_BATCH, "train"), mesh)
    p_bytes = nbytes(state.params)
    out = dict(
        mesh=SHARD_TRAIN_MESH, layers=cfg.n_layers, log=log_, launches=counts, collectives=coll,
        first_batch_after=after, params=p_bytes, params_reckoned=rec["param_bytes"],
        state=2 * p_bytes + nbytes(state.opt.mu) + nbytes(state.opt.nu),
        state_reckoned=rec["adam_state_bytes"], peak=peak,
        peak_reckoned=rec["adam_update_bytes"])
    del state, step
    if cuda:
        torch.cuda.empty_cache()
    if flash:
        out["flash"] = _local_flash_holds(dev, TRAIN_BATCH // mesh.shape["data"],
                                          cfg.n_heads // tp, cfg.n_kv_heads // tp, TRAIN_SEQ,
                                          cfg.head_dim, True, SEED + 30 + r)
    comm.barrier()
    return out


def lm_rank(work: str) -> int:
    """One rank of the sharded LM phase (``python3 chip_smoke.py --lm-rank
    DIR``, started by ``multihost.spawn_ranks``), on the card named in
    ``DIR/args.json``: internlm2-1.8b at full width and depth served at
    SHARD_SERVE_MESH (the serving phase's weights and prompt) and trained at
    SHARD_TRAIN_MESH at SHARD_DENSE_TRAIN_LAYERS (``_rank_serve``,
    ``_rank_train``), then qwen2-moe-a2.7b
    served at full width and depth at SHARD_SERVE_MESH (the qwen2-moe serving
    phase's weights and prompt; E / tp experts a rank), its first
    MOE_F32_LAYERS layers' configuration served in f32 at MOE_HOLD_SHAPE,
    and trained at
    MOE_TRAIN_LAYERS at SHARD_TRAIN_MESH (the whole qwen2-moe training run's
    weights and batches), then the recurrent stacks (``_rank_recurrent``),
    then qwen2-moe at SHARD_STRADDLE_MESH on SHARD_STRADDLE_SHAPE, in one
    process group; launches, seconds, collective counters, peaks and
    shard bytes (beside ``launch.dryrun``'s reckoning) to
    ``DIR/rank<r>.json``."""
    import dataclasses

    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.multihost import MultihostContext

    with open(os.path.join(work, "args.json")) as f:
        args = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    world = MultihostContext.from_env()
    dev = torch.device(args["device"])
    out = {"rank": world.rank}
    t = time.perf_counter()
    lm_cfg = get_config(LM_ARCH)
    out["serve"] = _rank_serve(world, dev, lm_cfg, 3, work, "lm")
    out["train"] = _rank_train(
        world, dev, dataclasses.replace(lm_cfg, n_layers=SHARD_DENSE_TRAIN_LAYERS), work, "lm")
    out["lm_s"] = time.perf_counter() - t
    t = time.perf_counter()
    moe_cfg = get_config(MOE_ARCH)
    out["moe_serve"] = _rank_serve(world, dev, moe_cfg, 5, work, "moe")
    out["moe_f32"] = _rank_serve(world, dev, dataclasses.replace(
        moe_cfg, n_layers=MOE_F32_LAYERS, dtype="float32"), 5, work, "moe32", MOE_HOLD_SHAPE,
        flash=False)
    out["moe_train"] = _rank_train(
        world, dev, dataclasses.replace(moe_cfg, n_layers=MOE_TRAIN_LAYERS), work, "moe")
    out["moe_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out.update(_rank_recurrent(world, dev, work))
    out["rec_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["moe_straddle"] = _rank_serve(world, dev, moe_cfg, 5, work, "moe22", SHARD_STRADDLE_SHAPE,
                                      mesh_name=SHARD_STRADDLE_MESH)
    out["straddle_s"] = time.perf_counter() - t
    with open(os.path.join(work, f"rank{world.rank}.json"), "w") as f:
        json.dump(out, f)
    world.shutdown()
    return 0


def lm16_rank(work: str) -> int:
    """One of the SHARD16_MESH ranks (``python3 chip_smoke.py --lm16-rank
    DIR``, started by ``multihost.spawn_ranks``), on the card named in
    ``DIR/args.json``: joined and its CUDA context made, it waits for
    ``DIR/go16`` (written after the four ranks' holds, which use much of
    the card), then each of SHARD16 is served at full width in bf16 at
    SHARD16_SHAPE and in f32 at MOE_HOLD_SHAPE (``_rank_serve``), teacher-
    forced on the whole runs' tokens; its records to ``DIR/rank16_<r>.json``."""
    import dataclasses

    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.multihost import MultihostContext

    with open(os.path.join(work, "args.json")) as f:
        args = json.load(f)
    torch.backends.cuda.matmul.allow_tf32 = False
    world = MultihostContext.from_env()
    dev = torch.device(args["device"])
    torch.zeros(1, device=dev)            # the context, while the main process holds
    gate, deadline = os.path.join(work, "go16"), time.monotonic() + SHARD_TIMEOUT
    while not os.path.exists(gate):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{gate} did not appear")
        time.sleep(0.2)
    out = {"rank": world.rank}
    t = time.perf_counter()
    for label, arch, n_layers, seed in SHARD16:
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        out[f"{label}_serve"] = _rank_serve(world, dev, cfg, seed, work, label, SHARD16_SHAPE,
                                            flash=cfg.block_kind == "attn",
                                            mesh_name=SHARD16_MESH)
        out[f"{label}_f32"] = _rank_serve(world, dev, dataclasses.replace(cfg, dtype="float32"),
                                          seed, work, f"{label}32", MOE_HOLD_SHAPE, flash=False,
                                          mesh_name=SHARD16_MESH)
    out["seconds"] = time.perf_counter() - t
    with open(os.path.join(work, f"rank16_{world.rank}.json"), "w") as f:
        json.dump(out, f)
    world.shutdown()
    return 0


def _rank_recurrent(world, dev, work: str) -> dict:
    """One rank's recurrent stacks (REC_SHARDED): each served at
    SHARD_SERVE_MESH in bf16 (its rows of the serving phase's prompt, the
    scans' rows over every axis) and, at MOE_HOLD_SHAPE, in f32 (2 rows: the
    scans replicated over 'model'), teacher-forced on the whole runs' tokens
    (``DIR/<label>_tokens.npy``, ``DIR/<label>32_tokens.npy``), and trained
    at SHARD_TRAIN_MESH (``_rank_serve``, ``_rank_train``); zamba2's flash
    forward and backward held at its local heads (hd 80)."""
    import dataclasses

    from repro_torch.configs import get_config

    out = {}
    for label, arch, n_layers, seed in REC_SHARDED:
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        flash = cfg.attn_every > 0
        out[f"{label}_serve"] = _rank_serve(world, dev, cfg, seed, work, label, flash=flash)
        f32 = dataclasses.replace(cfg, dtype="float32",
                                  n_layers=n_layers if flash else SHARD_RWKV_F32_LAYERS)
        out[f"{label}_f32"] = _rank_serve(world, dev, f32, seed, work, f"{label}32",
                                          MOE_HOLD_SHAPE, flash=False)
        out[f"{label}_train"] = _rank_train(world, dev, cfg, work, label, flash=flash)
    return out


def _coll_line(summary: dict) -> str:
    """``axis: op calls / MB / s`` of a rank's collective counters."""
    return "; ".join(f"{a} " + ", ".join(f"{op} {v['calls']} / {v['bytes'] / 1e6:.1f} MB / "
                                          f"{v['seconds']:.3f} s" for op, v in ops.items()
                                          if v["calls"])
                     for a, ops in summary.items() if any(v["calls"] for v in ops.values()))


def _row_parallel_gemms(dev, cfg, prefill_collectives: dict) -> dict:
    """The row-parallel products (``wo``, ``w_down``) of one rank at the
    sharded phase's two meshes, timed three ways on the same bf16 operands:
    the f32 accumulator as output (``layers.matmul_f32``, the port's), the
    operands widened to f32 (an f32 GEMM) and a bf16 output (bf16
    partials); the first held against the second. Beside them, the bytes
    one rank's 'model' all-reduces of a prefill move with f32 partials (the
    run's; the sum's all-to-all moves the partials, its all-gather the bf16
    sums) and with bf16 ones, and their seconds at the rate that rank's
    counters measured."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import matmul_f32

    out = {}
    for label, mesh_name, tokens in (("prefill", SHARD_SERVE_MESH, LM_BATCH * LM_PROMPT),
                                     ("train", SHARD_TRAIN_MESH, TRAIN_BATCH * TRAIN_SEQ)):
        mesh = make_mesh(mesh_name)
        tp, tokens = mesh.shape["model"], tokens // mesh.shape["data"]
        g = torch.Generator(device=dev).manual_seed(SEED + 40)
        for name, d_in in (("wo", cfg.n_heads * cfg.head_dim // tp), ("w_down", cfg.d_ff // tp)):
            x = torch.randn(tokens, d_in, generator=g, device=dev).bfloat16()
            w = (torch.randn(d_in, cfg.d_model, generator=g, device=dev) * d_in ** -0.5).bfloat16()
            wide = x.float() @ w.float()
            rel = float(torch.linalg.norm(matmul_f32(x, w) - wide) / torch.linalg.norm(wide))
            ms = [cuda_ms(f) for f in (lambda: matmul_f32(x, w), lambda: x.float() @ w.float(),
                                       lambda: x @ w)]
            out[f"{label} {name}"] = dict(shape=[tokens, d_in, cfg.d_model], rel=rel,
                                          ms_f32_out=ms[0], ms_widened=ms[1], ms_bf16_out=ms[2])
            del x, w, wide
    tp = make_mesh(SHARD_SERVE_MESH).shape["model"]
    piece = (tp - 1) * LM_BATCH * LM_PROMPT * cfg.d_model // tp
    ar = prefill_collectives["model"]["all_reduce"]
    sums = 2 * cfg.n_layers                               # wo and w_down in every layer
    other = ar["bytes"] - sums * piece * (4 + 2)          # the embedding's sum
    out["prefill all_reduce"] = dict(
        bytes_f32=ar["bytes"], bytes_bf16=other + sums * piece * (2 + 2), seconds=ar["seconds"],
        seconds_bf16_at_rate=ar["seconds"] * (other + sums * piece * 4) / ar["bytes"])
    return out


def _rank_logits(work: str, tag: str) -> tuple:
    """The ranks' gathered logits (``_rank_serve``): the prefill's (B, V)
    and the decode steps' (SHARD_DECODE, B, V), every data rank's rows in
    row order."""
    import glob

    import torch

    files = sorted(glob.glob(os.path.join(work, f"{tag}_logits.d*.npz")),
                   key=lambda f: int(f.rsplit(".d", 1)[1][:-len(".npz")]))
    pre, steps = [], []
    for f in files:
        with np.load(f) as z:
            pre.append(z["prefill"])
            steps.append(z["steps"])
    return torch.as_tensor(np.concatenate(pre)), torch.as_tensor(np.concatenate(steps, 1))


def _sharded_serving_holds(label: str, cfg, whole: dict, sv: list, work: str, tag: str,
                           whole_times: str, hold, mesh_name: str = SHARD_SERVE_MESH) -> dict:
    """The ranks' serving at ``mesh_name`` (``sv``: each rank's record)
    against the whole run (``whole``: its tokens and logits): the same
    greedy tokens but for SHARD_MAX_EXACT_TIES exact ties of the whole
    run's logits and SHARD_MAX_TIES near-ties,
    the prefill and decode logits per row within 3e-2 in relative L2 (an
    MoE: ``_moe_bf16_hold`` instead; a recurrent stack:
    ``_recurrent_bf16_hold``), every rank's shard bytes equal to the dry
    run's, an MoE's E / tp experts a rank, its flash forward held at its
    local heads (where the stack has attention), and the path's launches;
    at ``mesh_name``, whose data ranks' rows are put together (the tokens
    of a data rank's rows the same on each of its model ranks). Failures go
    to ``hold``; a mesh of more than four ranks logs its first and last
    rank and the spread of the others."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import padded_experts

    mesh = make_mesh(mesh_name)
    pre, steps = _rank_logits(work, tag)
    want = [whole["logits"]] + whole["step_logits"][:SHARD_DECODE]
    got = [pre] + list(steps)
    row = lambda x, y: float(((x - y).float().norm(dim=-1) / y.float().norm(dim=-1)).max())
    rels = [row(x, y) for x, y in zip(got, want)]
    wtok = whole["tokens"]
    by_data = {}
    for r, x in enumerate(sv):
        by_data.setdefault(mesh.coords(r)[0], []).append(x["tokens"])
    same = all(t == ts[0] for ts in by_data.values() for t in ts)
    toks = torch.cat([torch.as_tensor(by_data[d][0]) for d in sorted(by_data)],
                     dim=1).to(wtok.dtype)                       # (1 + steps, B)
    tokens_equal = bool(torch.equal(toks.T, wtok[:, :SHARD_DECODE + 1]))
    # Where the greedy token differs, the whole run's margin between its
    # token and the sharded run's, beside one bf16 step (ulp) at that
    # logit's magnitude (the logits are bf16 products): a flip is a tie of
    # the whole run when the margin is within that step.
    flips = []
    for j, (x, y) in enumerate(zip(got, want)):
        for b in range(y.shape[0]):
            tw, ts = int(wtok[b, j]), int(toks[j, b])
            if tw != ts:
                top = max(abs(float(y[b, tw])), abs(float(y[b, ts])))
                flips.append(dict(row=b, position=j, whole=tw, sharded=ts,
                                  margin=float(y[b, tw] - y[b, ts]),
                                  bf16_step=math.ldexp(1.0, math.frexp(top)[1] - 8),
                                  row_max_diff=float((x[b] - y[b]).abs().max())))
    log(f"{label} serving --mesh {mesh_name} ({len(sv)} ranks on the card): prefill "
        f"{sv[0]['prompt'][0]}x{sv[0]['prompt'][1]} "
        f"{[round(x['prefill_s'], 3) for x in sv]} s per rank, decode "
        f"{SHARD_DECODE} teacher-forced steps {[round(x['decode_ms'], 2) for x in sv]} ms per "
        f"step ({whole_times}); shards drawn in {[round(x['init_s'], 2) for x in sv]} s; tokens "
        f"equal to the whole run's {tokens_equal} (the same on every rank {same}); logits row "
        f"rel L2 prefill {rels[0]:.3e}, decode max {max(rels[1:]):.3e}"
        f"{'' if cfg.n_experts or cfg.block_kind != 'attn' else ' (limit 3e-2)'}; cache "
        f"{sv[0]['cache_shape']} per rank; peak device memory per rank "
        f"{[round(x['peak'] / 1e9, 2) for x in sv]} GB")
    n_attn = attn_applications(cfg)
    if len(sv) > 4:
        log(f"{label} serving ranks 1-{len(sv) - 2} (logged: 0 and {len(sv) - 1}): params "
            f"{sorted({x['params'] for x in sv})} B, cache {sorted({x['cache'] for x in sv})} B, "
            f"peaks {min(x['peak'] for x in sv) / 1e9:.2f}-{max(x['peak'] for x in sv) / 1e9:.2f}"
            f" GB, flash launches in the prefill "
            f"{sorted({x['prefill_launches']['flash_attention'] for x in sv})}")
    for r, x in enumerate(sv):
        fl = x.get("flash")
        hold(x["prefill_launches"]["flash_attention"] == n_attn
             and x["decode_launches"]["flash_attention"] == 0,
             f"{label} serving rank {r}: flash launches {x['prefill_launches']} / "
             f"{x['decode_launches']}, expected {n_attn} in the prefill, 0 in decode")
        hold(x["params"] == x["params_reckoned"] and x["cache"] == x["cache_reckoned"],
             f"{label} serving rank {r}: shard bytes {x['params']} / {x['cache']} differ from "
             f"the dry run's {x['params_reckoned']} / {x['cache_reckoned']}")
        hold(n_attn == 0 or (fl is not None and fl["ok"] and fl["route"] == "wgmma"),
             f"{label} serving rank {r}: flash at the local heads {fl}")
        if cfg.n_experts:
            tp = mesh.shape["model"]
            hold(x["experts"] * tp == padded_experts(cfg, tp),
                 f"{label} serving rank {r}: {x['experts']} experts a layer, not "
                 f"{padded_experts(cfg, tp)} / {tp}")
        if len(sv) > 4 and r not in (0, len(sv) - 1):
            continue
        log(f"{label} serving rank {r}: prefill collectives {_coll_line(x['prefill_collectives'])}"
            f"; decode collectives {_coll_line(x['decode_collectives'])}; launches prefill "
            f"{x['prefill_launches']['flash_attention']}, decode "
            f"{x['decode_launches']['flash_attention']}; params {x['params']:,} B (dry run "
            f"{x['params_reckoned']:,}), cache {x['cache']:,} B (dry run {x['cache_reckoned']:,})"
            + (f"; {x['experts']} experts a layer" if cfg.n_experts else "")
            + (f"; flash at the local heads {fl['shape']} ({fl['route']}): max_abs_err "
               f"{fl['max_abs_err']:.3e}, row rel L2 {fl['row']:.3e}" if fl else ""))
    hold(same, f"{label} serving: the ranks' tokens differ")
    if cfg.n_experts or cfg.block_kind != "attn":
        rows = [((x - y).float().norm(dim=-1) / y.float().norm(dim=-1)).tolist()
                for x, y in zip(got, want)]
        bf16_hold = _moe_bf16_hold if cfg.n_experts else _recurrent_bf16_hold
        out = bf16_hold(label, rows, flips, whole["yardstick"], hold)
        return dict(out, logits_rel=rels, tokens_equal=tokens_equal, flips=flips)
    # Where the whole run's two logits are equal (margin 0), its argmax
    # broke the tie by index and either token is its greedy choice: such a
    # flip counts apart, up to SHARD_MAX_EXACT_TIES (minitron-4b's 256,000
    # bf16 logits tie exactly at the top twice in 36 tokens on the H100).
    exact = [f for f in flips if f["margin"] == 0.0]
    near = [f for f in flips if f["margin"] != 0.0]
    ties = (len(exact) <= SHARD_MAX_EXACT_TIES and len(near) <= SHARD_MAX_TIES
            and all(f["margin"] <= f["bf16_step"] for f in near))
    log(f"{label} serving: tokens differing from the whole run's: {flips or 'none'} (allowed: "
        f"at most {SHARD_MAX_EXACT_TIES} at an exact tie of the whole run's logits, at most "
        f"{SHARD_MAX_TIES} other, within one bf16 step of a tie)")
    hold(tokens_equal or ties,
         f"{label} serving: tokens {toks.T.tolist()} against the whole run's "
         f"{wtok[:, :SHARD_DECODE + 1].tolist()}, not at most {SHARD_MAX_EXACT_TIES} exact and "
         f"{SHARD_MAX_TIES} near ties: {flips}")
    hold(max(rels) <= 3e-2, f"{label} serving: logits row rel L2 {max(rels):.3e} > 3e-2")
    return dict(logits_rel=rels, tokens_equal=tokens_equal, flips=flips)


def _moe_bf16_hold(label: str, rows: list, flips: list, yard: dict, hold) -> dict:
    """The MoE's bf16 serving hold at full depth. A token whose router input
    moves by a rounding may pick another expert, so two correct bf16 runs
    of qwen2-moe lie far apart at full depth (the serving phase's never
    route: 7.7e-2 in the prefill's logits), and the dense path's limits
    (3e-2 a row, one tie) do not apply. The sharded run's logits rows
    (``rows``: per position, per row, relative L2 from the whole run's)
    are held by their mean to SHARD_MOE_RATIO times the never route's
    (``yard``, from ``moe_serving_phase``: the same weights, prompt and
    forced tokens), and a planted fault (one rank's 15 experts giving no
    output) must lie beyond that limit; the flipped greedy tokens are
    printed beside the never route's."""
    mean = lambda rs: statistics.fmean(v for r in rs for v in r)
    got, never, fault = mean(rows), mean(yard["never"]["rels"]), mean(yard["fault"]["rels"])
    limit = SHARD_MOE_RATIO * never
    log(f"{label} serving (bf16, full depth): logits rows' relative L2 from the whole run's, "
        f"mean over the prefill and {SHARD_DECODE} decode steps {got:.3e} (max "
        f"{max(max(r) for r in rows):.3e}); the never route's {never:.3e} (max "
        f"{max(max(r) for r in yard['never']['rels']):.3e}), the planted fault's {fault:.3e}; "
        f"limit {SHARD_MOE_RATIO:g} x the never route's = {limit:.3e}; greedy tokens differing "
        f"from the whole run's: {len(flips)} (the never route's {yard['never']['flips']}, the "
        f"fault's {yard['fault']['flips']}, of {len(rows) * len(rows[0])}); per position "
        f"(max over rows) {[round(max(r), 4) for r in rows]}, the never route's "
        f"{[round(max(r), 4) for r in yard['never']['rels']]}")
    hold(got <= limit, f"{label} serving: logits rows lie {got:.3e} from the whole run's on "
                       f"average, more than {SHARD_MOE_RATIO:g} x the never route's {never:.3e}")
    hold(fault > limit, f"{label} serving: the planted fault ({fault:.3e}) passes the bf16 "
                        f"hold's limit {limit:.3e}")
    return dict(rows_mean=got, never_mean=never, fault_mean=fault, never_flips=yard["never"]
                ["flips"], fault_flips=yard["fault"]["flips"])


def _recurrent_bf16_hold(label: str, rows: list, flips: list, yard: dict, hold) -> dict:
    """A recurrent stack's bf16 serving hold at the sharded run's depth.
    Seed-initialised, zamba2 amplifies rounding with depth (ROADMAP's
    tolerance note: ~8e-2 between bf16 and f32 on one group), so the dense
    path's 3e-2 does not apply. The sharded run's logits rows (``rows``:
    per position, per row, relative L2 from the whole run's) are held by
    their largest to SHARD_REC_RATIO times the largest of the whole bf16
    run's from the same weights in f32 (``yard["f32"]``, teacher-forced on
    the same tokens), and a planted fault (``yard["fault"]``: the whole run
    with the chunk scan's output zeroed on the rows one rank holds, in every
    layer) must lie beyond that limit."""
    top = lambda rs: max(v for r in rs for v in r)
    got, f32, fault = top(rows), top(yard["f32"]["rels"]), top(yard["fault"]["rels"])
    limit = SHARD_REC_RATIO * f32
    log(f"{label} serving (bf16): logits rows' relative L2 from the whole run's, largest over "
        f"the prefill and {SHARD_DECODE} decode steps {got:.3e} (mean "
        f"{statistics.fmean(v for r in rows for v in r):.3e}); the whole run's from the same "
        f"weights in f32 {f32:.3e}, the planted fault's {fault:.3e}; limit {SHARD_REC_RATIO:g} x "
        f"the f32 distance = {limit:.3e}; greedy tokens differing from the whole run's: "
        f"{len(flips)} (the f32 run's {yard['f32']['flips']}, the fault's "
        f"{yard['fault']['flips']}); per position (max over rows) "
        f"{[round(max(r), 4) for r in rows]}, the f32 run's "
        f"{[round(max(r), 4) for r in yard['f32']['rels']]}")
    hold(got <= limit, f"{label} serving: logits rows lie up to {got:.3e} from the whole run's, "
                       f"more than {SHARD_REC_RATIO:g} x the f32 distance {f32:.3e}")
    hold(fault > limit, f"{label} serving: the planted fault ({fault:.3e}) passes the bf16 "
                        f"hold's limit {limit:.3e}")
    return dict(rows_max=got, f32_max=f32, fault_max=fault, f32_flips=yard["f32"]["flips"],
                fault_flips=yard["fault"]["flips"])


def _sharded_f32_hold(dev, label: str, cfg, whole: dict, work: str, hold, tag: str = "moe32",
                      prompt_seed: int = 5, scaled: bool = False) -> dict:
    """The serving arithmetic at full width without bf16's sensitivity:
    ``cfg`` (qwen2-moe at MOE_F32_LAYERS layers, or a recurrent stack's
    configuration, in f32, seed-0 weights) served whole here and by the
    ranks (``_rank_logits``), both on the first
    MOE_HOLD_SHAPE of the bf16 path's prompt (``prompt_seed``) and decoded
    teacher-forced on its tokens: the greedy tokens equal and the logits
    elementwise at rtol = atol = 1e-4 (the f32 routes' limit,
    ``_f32_holds``), or, with ``scaled`` (the recurrent stacks), within
    1e-4 of the largest logit (the CPU tests' f32 limit): zamba2's group
    amplifies f32 rounding past the elementwise limit even between two whole
    runs (the whole f32 group served row by row lay 1.958e-4 from itself
    served at once on an NVIDIA H100 80GB HBM3 at 700 W)."""
    import torch

    from repro_torch.models.model import init_params, prefill_step, serve_step

    b, s = MOE_HOLD_SHAPE
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    prompt = torch.as_tensor(np.random.default_rng(prompt_seed).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))[:b, :s], dtype=torch.int32, device=dev)
    forced = whole["tokens"][:b].to(dev)
    with torch.inference_mode():
        logits, cache = prefill_step(model, prompt, s + LM_NEW)
        want = [logits.cpu()]
        for i in range(SHARD_DECODE):
            logits, cache = serve_step(model, forced[:, i:i + 1], cache)
            want.append(logits.cpu())
    del model, cache, logits
    torch.cuda.empty_cache()
    pre, steps = _rank_logits(work, tag)
    got = [pre] + list(steps)
    err = max(float((x - y).abs().max()) for x, y in zip(got, want))
    same = all(torch.equal(x.argmax(-1), y.argmax(-1)) for x, y in zip(got, want))
    if scaled:
        limit = 1e-4 * max(float(y.abs().max()) for y in want)
        close, rule = err <= limit, f"limit 1e-4 of the largest logit = {limit:.3e}"
    else:
        close = all(torch.allclose(x, y, rtol=1e-4, atol=1e-4) for x, y in zip(got, want))
        rule = "limit 1e-4 + 1e-4 |x|"
    log(f"{label} serving (f32, {cfg.n_layers} layers at full width, {b}x{s} + {SHARD_DECODE} "
        f"teacher-forced steps) against the whole f32 model: logits max_abs_err {err:.3e} "
        f"({rule}), greedy tokens equal {same}")
    hold(close and same, f"{label} serving f32: logits {err:.3e} from the whole model's, or "
                         f"greedy tokens differ ({same})")
    return dict(f32_max_abs=err, f32_tokens_equal=same)


# The whole model's matrices a run sharded over 'model' splits by rows
# (row-parallel: their products summed over 'model') and by columns
# (column-parallel: their input's gradient summed over 'model', ``to_model``),
# as ``sharding.rules`` lays them out.
ROW_PARALLEL_LEAVES = (".wo", ".w_down", ".w_cm_2")
COLUMN_PARALLEL_LEAVES = (".wq", ".wk", ".wv", ".w_gate", ".w_up", ".wr", ".wg", ".wz", ".wx",
                          ".w_lora_b", ".w_cm_1", ".w_cm_r", "lm_head")


@contextlib.contextmanager
def _model_axis_arithmetic(model, tp: int):
    """A context in which the whole ``model`` forms its products in the
    order of sums and roundings a run sharded over a model axis of ``tp``
    has, and changes nothing else (no shards, layout or collectives):

    * a row-parallel product ``x @ w`` (ROW_PARALLEL_LEAVES) as the f32
      partial products of ``tp`` blocks of w's input rows (``matmul_f32``,
      whose backward is the sharded run's), added in rank order and rounded
      once to x's dtype (``layers.row_parallel``);
    * a column-parallel product (COLUMN_PARALLEL_LEAVES) as ``tp`` products
      with blocks of w's columns, concatenated, its input's gradient as the
      ``tp`` blocks' partials, each rounded to x's dtype, added in f32 in
      rank order and rounded once (``to_model``'s backward,
      ``MeshComm.all_reduce``).

    The leaves' module attributes become views of the same storage in a
    tensor type that forms these products (``__dict__``, ahead of the
    parameters), so the gradients still go to the parameters and a
    recomputed forward forms the same products. The context fails if a
    leaf was never multiplied so."""
    import torch

    from repro_torch.models.layers import matmul_f32

    def blocks(parts):
        acc = None
        for part in parts:
            acc = part if acc is None else acc + part
        return acc

    class ColumnGrad(torch.autograd.Function):
        """Zeros of x @ w's shape, added to the products with ``x.detach()``
        (whose backward forms w's gradient); backward, x's gradient from
        the ``tp`` column blocks' rounded partials."""

        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(w)
            ctx.dtype = x.dtype
            return x.new_zeros(x.shape[:-1] + (w.shape[1],))

        @staticmethod
        def backward(ctx, g):
            (w,) = ctx.saved_tensors
            n = w.shape[1] // tp
            dx = blocks((g[..., j * n:(j + 1) * n] @ w[:, j * n:(j + 1) * n].T).float()
                        for j in range(tp))
            return dx.to(ctx.dtype), None

    hit, kind = set(), {}

    class Split(torch.Tensor):
        @classmethod
        def __torch_function__(cls, func, types, args=(), kwargs=None):
            with torch._C.DisableTorchFunctionSubclass():
                if (getattr(func, "__name__", "") in ("matmul", "__matmul__") and len(args) == 2
                        and type(args[1]) is cls and type(args[0]) is not cls):
                    x, w = args
                    hit.add(id(w))
                    if kind[id(w)] == "column":
                        n = w.shape[1] // tp
                        return (torch.cat([x.detach() @ w[:, j * n:(j + 1) * n]
                                           for j in range(tp)], -1)
                                + ColumnGrad.apply(x, w.detach()))
                    n = w.shape[0] // tp
                    return blocks(matmul_f32(x[..., i * n:(i + 1) * n], w[i * n:(i + 1) * n])
                                  for i in range(tp)).to(x.dtype)
                return func(*args, **(kwargs or {}))

    views = []
    for name, p in model.named_parameters():
        role = ("row" if name.endswith(ROW_PARALLEL_LEAVES) else
                "column" if name.endswith(COLUMN_PARALLEL_LEAVES) else None)
        if role and p.dim() == 2:
            owner, _, leaf = name.rpartition(".")
            owner = model.get_submodule(owner) if owner else model
            view = p.as_subclass(Split)
            kind[id(view)] = role
            owner.__dict__[leaf] = view
            views.append((owner, leaf, name))
    check(bool(views), "_model_axis_arithmetic: the model has no row- or column-parallel leaf")
    try:
        yield
        missed = [name for o, leaf, name in views if id(o.__dict__[leaf]) not in hit]
        check(not missed, f"_model_axis_arithmetic: leaves never multiplied so: {missed}")
    finally:
        for owner, leaf, _ in views:
            del owner.__dict__[leaf]


def _sharded_training_holds(dev, label: str, cfg, w_losses: list, whole_step_s: float,
                            tr: list, work: str, tag: str, hold, model_axis: bool = False) -> dict:
    """The ranks' training at SHARD_TRAIN_MESH (``tr``: each rank's record)
    against the whole run of ``cfg`` (its losses ``w_losses``): each step's
    loss within 1e-2 (relative), losses finite and the first batch's
    falling, and each gathered leaf of the first step's gradient no farther
    from the same weights' f32 gradient than SHARD_GRAD_RATIO times the
    whole model's (a planted fault, the gradient without its reduction over
    'data', read against the same limit); every rank's shard bytes equal to
    the dry run's, its flash kernels held at its local-head shapes (where
    the stack has attention) and the path's launches. For an MoE, how many
    kept (token, expert) assignments
    of each layer in the first step's forward differ from the whole run's.
    With ``model_axis`` (the recurrent stacks) the whole model is also run
    in the mesh's order of sums and roundings, with no shard, collective or
    layout: each data rank's row block in the model axis' arithmetic
    (``_model_axis_arithmetic``), the blocks' gradients averaged; a leaf whose
    ratio there passes SHARD_GRAD_RATIO (rwkv6's bonus ``u_bonus`` in its
    first layer, a sum over every token whose whole-run distance is the
    smallest of its leaves) is held to SHARD_GRAD_RATIO times that ratio;
    every other leaf keeps SHARD_GRAD_RATIO. The references are made here,
    after the ranks have freed the card."""
    import torch

    from repro_torch.data.tokens import TokenStream
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import init_params, lm_loss
    from repro_torch.sharding.placement import assemble, parameter_specs

    tmesh = make_mesh(SHARD_TRAIN_MESH)
    n_ranks = tmesh.size
    # The whole model's gradient at the first batch, at the ranks' weights
    # (its MoE routing kept), and the same weights' gradient in f32: the
    # arbiter of the two bf16 ones.
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    tok, lab = (torch.as_tensor(a, device=dev) for a in
                TokenStream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=17).next())
    grad_at = lambda m, x, y: [g.detach() for g in torch.autograd.grad(lm_loss(m, x, y),
                                                                       tuple(m.parameters()))]
    with _routing_recorder(cfg.n_layers if cfg.n_experts else 0) as kept_whole:
        grads_w = grad_at(model, tok, lab)
    kept_whole = [k.cpu() for k in kept_whole]
    m32 = _sub_model(model, cfg.n_layers, dtype=torch.float32)
    grads_32 = grad_at(m32, tok, lab)
    del m32
    names_specs = list(parameter_specs(model, tmesh).items())
    rel = lambda x, y: float(torch.linalg.norm(x.float() - y) / torch.linalg.norm(y))
    w32 = {n: rel(w, f) for (n, _), w, f in zip(names_specs, grads_w, grads_32)}
    limit = {n: SHARD_GRAD_RATIO for n in w32}
    rows = TRAIN_BATCH // tmesh.shape["data"]
    if model_axis:
        # The mean of the data ranks' row blocks' gradients, each in the
        # model axis' arithmetic, rounded to the leaf's dtype.
        with _model_axis_arithmetic(model, tmesh.shape["model"]):
            parts = [grad_at(model, tok[i:i + rows], lab[i:i + rows])
                     for i in range(0, TRAIN_BATCH, rows)]
        axis_ratio = {n: rel((sum(p[i].float() for p in parts) / len(parts)).to(g.dtype), f)
                      / w32[n] for i, ((n, _), g, f) in enumerate(zip(names_specs, grads_w,
                                                                       grads_32))}
        del parts
        limit = {n: SHARD_GRAD_RATIO * (r if r > SHARD_GRAD_RATIO else 1.0)
                 for n, r in axis_ratio.items()}
    # A planted fault, read against the same limit: the gradient of data
    # rank 0's rows alone (the mean loss over them), as a step that took its
    # own rows' mean and dropped its reduction over 'data' would leave.
    fault = grad_at(model, tok[:rows], lab[:rows])
    fault_ratio = {n: rel(g, f) / w32[n] for (n, _), g, f in zip(names_specs, fault, grads_32)}
    del model, fault, tok, lab
    torch.cuda.empty_cache()

    losses = [e["loss"] for e in tr[0]["log"]]
    w_losses = w_losses[:SHARD_TRAIN_STEPS]
    loss_rels = [abs(x - y) / abs(y) for x, y in zip(losses, w_losses)]
    after = tr[0]["first_batch_after"]
    shards = [torch.load(os.path.join(work, f"{tag}_grads.rank{r}.pt")) for r in range(n_ranks)]
    g_rel, g32 = {}, {}
    for i, (name, spec) in enumerate(names_specs):
        g = assemble([s[i] for s in shards], spec, tmesh).to(dev).float()
        g_rel[name], g32[name] = rel(g, grads_w[i].float()), rel(g, grads_32[i])
    del shards, grads_w, grads_32
    torch.cuda.empty_cache()
    worst = max(g_rel, key=g_rel.get)
    ratio = {n: g32[n] / w32[n] for n in g32}
    big = max(ratio, key=ratio.get)
    far = max(ratio, key=lambda n: ratio[n] / limit[n])
    some = list(g_rel)[:3] + list(g_rel)[-12:]
    log(f"{label} training: against the same weights' f32 gradient, the sharded run's leaves "
        f"lie at rel L2 median {statistics.median(g32.values()):.3e}, max {max(g32.values()):.3e}"
        f"; the whole run's at median {statistics.median(w32.values()):.3e}, max "
        f"{max(w32.values()):.3e}; the largest ratio {ratio[big]:.3f} ({big}: {g32[big]:.3e} "
        f"against {w32[big]:.3e}); by leaf (sharded vs whole, sharded vs f32, whole vs f32): "
        + ", ".join(f"{n} {g_rel[n]:.2e}/{g32[n]:.2e}/{w32[n]:.2e}" for n in some))
    kept_diff = None
    if cfg.n_experts:
        # Data rank d's ranks of model index 0 kept the routing of its rows,
        # tokens [d T, (d + 1) T) of the whole batch's (b, s) order.
        kept_diff, kept_n = [0] * cfg.n_layers, [0] * cfg.n_layers
        for r in range(n_ranks):
            d, m = tmesh.coords(r)
            if m:
                continue
            for layer, k in enumerate(torch.load(os.path.join(work, f"{tag}_kept.rank{r}.pt"))):
                w = kept_whole[layer][d * k.shape[0]:(d + 1) * k.shape[0]]
                kept_diff[layer] += int((k != w).sum())
                kept_n[layer] += int(w.sum())
        log(f"{label} training: kept (token, expert) assignments of the first step's forward "
            f"differing from the whole run's, per layer: {kept_diff} of {kept_n} (a near-tie at "
            f"the router's argmax flips one where the row-parallel sums round the hidden states "
            f"otherwise; each flip counts twice: the assignment lost and the one gained)")
    n_tok = TRAIN_BATCH * TRAIN_SEQ
    step_s = [[round(e["seconds"], 3) for e in x["log"]] for x in tr]
    log(f"{label} training --mesh {SHARD_TRAIN_MESH} ({cfg.n_layers} layers): "
        f"{SHARD_TRAIN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens, seconds per step per "
        f"rank {step_s} (whole run {whole_step_s:.3f} s); losses {losses} against the whole "
        f"run's {w_losses} (relative {[f'{x:.2e}' for x in loss_rels]}, limit 1e-2); the first "
        f"batch's loss {losses[0]:.6f} at the first step, {after:.6f} after the run; grad norms "
        f"{[e['grad_norm'] for e in tr[0]['log']]}; the first step's gathered gradient rel L2 "
        f"against the whole run's: max {g_rel[worst]:.3e} ({worst}), median "
        f"{statistics.median(g_rel.values()):.3e} over {len(g_rel)} leaves; peak device memory "
        f"per rank {[round(x['peak'] / 1e9, 2) for x in tr]} GB (reckoned at the Adam update "
        f"{tr[0]['peak_reckoned'] / 1e9:.2f} GB)")
    n_attn = attn_applications(cfg)
    for r, x in enumerate(tr):
        c, fl = x["launches"], x.get("flash")
        log(f"{label} training rank {r}: collectives over {SHARD_TRAIN_STEPS} steps "
            f"{_coll_line(x['collectives'])}; launches flash_attention {c['flash_attention']}, "
            f"flash_attention_bwd {c['flash_attention_bwd']}; params {x['params']:,} B (dry run "
            f"{x['params_reckoned']:,}), params, grads and moments {x['state']:,} B (dry run "
            f"{x['state_reckoned']:,})"
            + (f"; flash at the local heads {fl['shape']} ({fl['route']} / {fl['bwd_route']}): "
               f"forward max_abs_err {fl['max_abs_err']:.3e}, backward "
               f"{fl['bwd_max_abs_err']:.3e}" if fl else ""))
        hold(c["flash_attention"] == SHARD_TRAIN_STEPS * 2 * n_attn
             and c["flash_attention_bwd"] == SHARD_TRAIN_STEPS * n_attn,
             f"{label} training rank {r}: launches {c}, expected "
             f"{SHARD_TRAIN_STEPS * 2 * n_attn} forward and {SHARD_TRAIN_STEPS * n_attn} backward")
        hold(x["params"] == x["params_reckoned"] and x["state"] == x["state_reckoned"],
             f"{label} training rank {r}: shard bytes {x['params']} / {x['state']} differ "
             f"from the dry run's {x['params_reckoned']} / {x['state_reckoned']}")
        hold(n_attn == 0 or (fl is not None and fl["ok"] and fl["bwd_ok"]
                             and fl["bwd_route"] == "wgmma"),
             f"{label} training rank {r}: flash at the local heads {fl}")
        hold([e["loss"] for e in x["log"]] == losses, f"{label} training rank {r}: its "
                                                        f"losses differ from rank 0's")
    hold(all(math.isfinite(v) for e in tr[0]["log"] for v in (e["loss"], e["grad_norm"]))
         and after < losses[0], f"{label} training: losses {losses} not finite, or the "
                                f"first batch's loss did not fall ({losses[0]} -> {after})")
    hold(max(loss_rels) <= 1e-2, f"{label} training: losses {losses} are {loss_rels} from "
                                 f"the whole run's {w_losses}")
    # Two bf16 gradients of a deep stack lie ~2.4e-2 apart in relative L2
    # however they are summed, and as far from the same weights' f32
    # gradient: each leaf of the sharded run's is held to lie no farther from
    # the f32 gradient than SHARD_GRAD_RATIO times the whole run's does (with
    # ``model_axis``, times the model-axis arithmetic's own ratio where that
    # passes SHARD_GRAD_RATIO), and the planted fault must lie beyond that
    # limit on every leaf.
    soft = min(fault_ratio, key=lambda n: fault_ratio[n] / limit[n])
    top = sorted(ratio, key=ratio.get, reverse=True)[:5]
    log(f"{label} training: the five largest gradient ratios (sharded vs f32 over whole vs f32): "
        + ", ".join(f"{n} {ratio[n]:.3f}" for n in top)
        + ("" if not model_axis else "; the whole model in the mesh's order of sums and "
           "roundings (row blocks over 'data', the model axis' arithmetic), the same ratio: " + ", ".join(f"{n} {axis_ratio[n]:.3f}" for n in top)
           + f"; its largest {max(axis_ratio.values()):.3f}; leaves held past "
           f"{SHARD_GRAD_RATIO:g} by it: "
           + (", ".join(f"{n} (limit {limit[n]:.3f})" for n in limit
                        if limit[n] > SHARD_GRAD_RATIO) or "none")))
    log(f"{label} training: the planted fault (no reduction over 'data': the gradient of data "
        f"rank 0's {rows} rows) against the f32 gradient, by the same ratio: smallest "
        f"{fault_ratio[soft]:.3f} ({soft}), median {statistics.median(fault_ratio.values()):.3f}, "
        f"largest {max(fault_ratio.values()):.3f} (limit {limit[soft]:.3f} there; the sharded "
        f"run's nearest its limit {ratio[far]:.3f} ({far}, limit {limit[far]:.3f}))")
    hold(ratio[far] <= limit[far],
         f"{label} training: gradient {far} lies {g32[far]:.3e} from the f32 gradient, the "
         f"whole run's {w32[far]:.3e} (ratio {ratio[far]:.3f} > {limit[far]:.3f})")
    hold(fault_ratio[soft] > limit[soft],
         f"{label} training: the planted fault passes the gradient check on {soft} (ratio "
         f"{fault_ratio[soft]:.3f} <= {limit[soft]:.3f})")
    return dict(loss_rel=loss_rels, first_batch_after=after, grad_rel_max=g_rel[worst],
                grad_f32_ratio_max=ratio[big], grad_ratio_nearest=[far, ratio[far], limit[far]],
                fault_ratio_min=fault_ratio[soft],
                kept_diff=kept_diff)


@contextlib.contextmanager
def _scan_rows_zeroed(module, name: str, rows: int):
    """A context in which the chunk scan ``module.<name>`` returns its
    output zeroed on its first ``rows`` rows (its final state kept): a
    planted fault, one rank's scan rows lost."""
    import torch

    fn = getattr(module, name)

    def zeroed(*a):
        y, state = fn(*a)
        return torch.cat([torch.zeros_like(y[:rows]), y[rows:]]), state

    setattr(module, name, zeroed)
    try:
        yield
    finally:
        setattr(module, name, fn)


def _sharded_wholes(dev, work: str, runs=REC_SHARDED, shape=(LM_BATCH, LM_PROMPT)) -> dict:
    """The whole runs the ranks' stacks are held against, made before the
    ranks start: for each of ``runs`` (label, architecture, layers, prompt
    seed: bf16, seed-0 weights, the first ``shape`` of the serving phase's
    LM_BATCH x LM_PROMPT prompt), the serving path at ``shape`` + LM_NEW
    (its tokens to ``DIR/<label>_tokens.npy``, the first MOE_HOLD_SHAPE
    rows' to ``DIR/<label>32_tokens.npy``) and, for a recurrent stack, the
    yardstick of its bf16 hold: the same weights in f32, and the planted
    fault (the chunk scan's output zeroed on row 0, the rows one rank holds
    at SHARD_SERVE_MESH, in every layer), each prefilled and decoded
    teacher-forced on the path's tokens (``_forced_rows``)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import rwkv6, ssm
    from repro_torch.models.model import init_params

    rows = LM_BATCH // make_mesh(SHARD_SERVE_MESH).shape["model"]
    out = {}
    for label, arch, n_layers, seed in runs:
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        prompt = torch.as_tensor(np.random.default_rng(seed).integers(
            0, cfg.vocab, (LM_BATCH, LM_PROMPT))[:shape[0], :shape[1]], dtype=torch.int32,
            device=dev)
        cache_len = shape[1] + LM_NEW
        path = _serve_path(f"{label} ({n_layers} layers, the sharded run's whole twin)", model,
                           prompt, LM_NEW, cache_len, keep=True)
        yard = None
        if cfg.block_kind != "attn":
            yard = {"f32": _forced_rows(_sub_model(model, n_layers, dtype=torch.float32),
                                        prompt, path, cache_len)}
            torch.cuda.empty_cache()
            module, name = ((ssm, "_ssd_chunks") if cfg.block_kind == "mamba2"
                            else (rwkv6, "_wkv_chunks"))
            with _scan_rows_zeroed(module, name, rows):
                yard["fault"] = _forced_rows(model, prompt, path, cache_len)
        tokens = path["tokens"].cpu()
        np.save(os.path.join(work, f"{label}_tokens.npy"), tokens.numpy())
        np.save(os.path.join(work, f"{label}32_tokens.npy"), tokens[:MOE_HOLD_SHAPE[0]].numpy())
        out[label] = dict(tokens=tokens, logits=path["logits"].cpu(),
                          step_logits=[x.cpu() for x in path["step_logits"]], yardstick=yard,
                          prefill_s=path["prefill_s"], decode_ms=path["decode_ms"],
                          launches=path["launches"])
        del model, path
        torch.cuda.empty_cache()
    return out


def _whole_train_twin(dev, arch: str, n_layers: int, n_attn: int) -> dict:
    """A whole ``launch.train`` run of ``arch`` at ``n_layers`` (seed-0
    weights, TokenStream seed 17, SHARD_TRAIN_STEPS steps of TRAIN_BATCH x
    TRAIN_SEQ), as the training phase runs it: the sharded run's twin. Its
    record (losses, seconds a step), its state freed."""
    import torch

    from repro_torch.launch import train as ttrain

    argv = ["--arch", arch, "--override", f"n_layers={n_layers}", "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--device", str(dev), "--steps",
            str(SHARD_TRAIN_STEPS)]
    state, whole_tr, _ = _train_run(
        dev, f"{arch} ({n_layers} layers, the sharded run's whole twin)",
        lambda: _main_run(ttrain, argv), SHARD_TRAIN_STEPS, 1, n_attn, TRAIN_BATCH * TRAIN_SEQ)
    del state
    torch.cuda.empty_cache()
    return whole_tr


def _recurrent_sharded_holds(dev, recs: list, wholes: dict, twins: dict, work: str,
                             hold) -> dict:
    """The ranks' recurrent stacks (``_rank_recurrent``) against the whole
    runs: serving at SHARD_SERVE_MESH (``_sharded_serving_holds``, the bf16
    logits by ``_recurrent_bf16_hold``), f32 serving at MOE_HOLD_SHAPE
    (``_sharded_f32_hold``), and training at SHARD_TRAIN_MESH against the
    whole ``launch.train`` runs of the same depth (``twins``,
    ``_whole_train_twin``; ``_sharded_training_holds``). Returns the
    records and the ranks' flash launches on the hd-80 routes."""
    import dataclasses

    from repro_torch.configs import get_config

    out, hd80 = {}, {"flash_attention_hd80": 0, "flash_attention_bwd_hd80": 0}
    for label, arch, n_layers, seed in REC_SHARDED:
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        w, whole_tr = wholes[label], twins[label]
        sv = [x[f"{label}_serve"] for x in recs]
        rec = _sharded_serving_holds(
            f"{label} sharded", cfg, w, sv, work, label,
            f"whole run at {n_layers} layers: prefill {w['prefill_s']:.3f} s, decode "
            f"{w['decode_ms']:.2f} ms", hold)
        f32 = dataclasses.replace(cfg, dtype="float32", n_layers=n_layers if cfg.attn_every
                                  else SHARD_RWKV_F32_LAYERS)
        rec.update(_sharded_f32_hold(dev, f"{label} sharded", f32, w, work, hold, f"{label}32",
                                     seed, scaled=True))
        tr = [x[f"{label}_train"] for x in recs]
        rec.update(_sharded_training_holds(dev, f"{label} sharded", cfg, whole_tr["losses"],
                                           whole_tr["step_s"], tr, work, label, hold,
                                           model_axis=True))
        out[label] = dict(rec, serve=sv, train=tr, f32=[x[f"{label}_f32"] for x in recs],
                          whole_prefill_s=w["prefill_s"], whole_decode_ms=w["decode_ms"],
                          whole_step_s=whole_tr["step_s"])
        hd80["flash_attention_hd80"] += sum(
            x["prefill_launches"]["flash_attention"] + x["decode_launches"]["flash_attention"]
            for x in sv) + sum(x["launches"]["flash_attention"] for x in tr)
        hd80["flash_attention_bwd_hd80"] += sum(x["launches"]["flash_attention_bwd"] for x in tr)
    return out, hd80


def _rank_failures(label: str, results: list) -> None:
    """Log every failed rank's exit code, and the output of those that
    failed first: a rank whose peer died fails on the closed connection,
    which says nothing of the cause."""
    bad = [(r, code, text) for r, (code, text) in enumerate(results) if code != 0]
    if not bad:
        return
    log(f"{label}: ranks failed (rank, exit code): {[(r, c) for r, c, _ in bad]}")
    first = [b for b in bad if "Connection closed by peer" not in b[2]] or bad[:1]
    for r, code, text in first[:3]:
        log(f"{label} rank {r} exited with {code}; its last output:\n{text[-4000:]}")


def start_ranks16(work: str) -> dict:
    """Start the SHARD16_MESH rank processes (``lm16_rank``) in a thread,
    in the background: ``ranks16_phase`` holds what they wrote."""
    import threading

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.multihost import spawn_ranks

    job = {"t0": time.perf_counter()}

    def run():
        try:
            job["ranks"] = spawn_ranks([sys.executable, str(ROOT / "chip_smoke.py"),
                                        "--lm16-rank", work], make_mesh(SHARD16_MESH).size,
                                       SHARD_TIMEOUT)
        except Exception as e:
            job["error"] = repr(e)
        job["s"] = time.perf_counter() - job["t0"]

    job["thread"] = threading.Thread(target=run, daemon=True)
    job["thread"].start()
    return job


def ranks16_phase(dev, job: dict, wholes: dict, work: str, hold) -> dict:
    """The SHARD16_MESH ranks (``start_ranks16``), let go (``DIR/go16``)
    and waited for, against the whole runs of SHARD16
    (``_sharded_wholes``): bf16 serving as the phase holds its
    other runs (``_sharded_serving_holds``: minitron-4b as a dense stack,
    rwkv6-3b as a recurrent one) and f32 serving at MOE_HOLD_SHAPE
    (``_sharded_f32_hold``: elementwise for the attention stack, within
    1e-4 of the largest logit for the recurrent one, the phase's limits)."""
    import dataclasses

    from repro_torch.configs import get_config

    t = time.perf_counter()
    with open(os.path.join(work, "go16"), "w"):
        pass                                  # the ranks draw their shards from here on
    job["thread"].join()
    waited = time.perf_counter() - t
    check("error" not in job, f"the {SHARD16_MESH} ranks: {job.get('error')}")
    _rank_failures(f"lm sharded {SHARD16_MESH}", job["ranks"])
    check(all(code == 0 for code, _ in job["ranks"]),
          f"the {SHARD16_MESH} ranks' exit codes {[code for code, _ in job['ranks']]}")
    recs = [json.load(open(os.path.join(work, f"rank16_{r}.json")))
            for r in range(len(job["ranks"]))]
    log(f"lm sharded {SHARD16_MESH}: {len(recs)} ranks on the card in {job['s']:.1f} s from "
        f"their start (in the background; {waited:.1f} s waited for here), their serving "
        f"{min(x['seconds'] for x in recs):.1f}-{max(x['seconds'] for x in recs):.1f} s")
    out = {"ranks_s": job["s"], "waited_s": waited}
    for label, arch, n_layers, seed in SHARD16:
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        w = wholes[label]
        sv = [x[f"{label}_serve"] for x in recs]
        rec = _sharded_serving_holds(
            f"{label} sharded", cfg, w, sv, work, label,
            f"whole run at {n_layers} layers: prefill {w['prefill_s']:.3f} s, decode "
            f"{w['decode_ms']:.2f} ms", hold, SHARD16_MESH)
        rec.update(_sharded_f32_hold(dev, f"{label} sharded {SHARD16_MESH}",
                                     dataclasses.replace(cfg, dtype="float32"), w, work, hold,
                                     f"{label}32", seed, scaled=cfg.block_kind != "attn"))
        out[label] = dict(rec, serve=sv, f32=[x[f"{label}_f32"] for x in recs],
                          whole_prefill_s=w["prefill_s"], whole_decode_ms=w["decode_ms"])
    return out


def lm_sharded_phase(dev, peaks, results: dict, work: str, dry_work: str) -> dict:
    """internlm2-1.8b and qwen2-moe-a2.7b split over four rank processes on
    the card (ROADMAP item 13.6; ``lm_rank``): each served at
    SHARD_SERVE_MESH and trained at SHARD_TRAIN_MESH (internlm2 at
    SHARD_DENSE_TRAIN_LAYERS, qwen2-moe at MOE_TRAIN_LAYERS, its experts over
    'model'), held against the whole-tensor runs of the serving and training
    phases (internlm2's training against a whole run at its depth made here;
    ``_sharded_serving_holds``, ``_sharded_training_holds``); then the
    recurrent stacks of REC_SHARDED in the same ranks, against whole runs at
    their depths made here (``_sharded_wholes`` before the ranks start,
    ``_recurrent_sharded_holds`` after), and qwen2-moe at
    SHARD_STRADDLE_MESH, its groups straddling the data split (items
    13.6a), against the qwen2-moe phase's whole run of that prompt. The
    whole training twins and SHARD16's whole runs run before the holds;
    SHARD16_MESH's ranks (``start_ranks16``, items 13.6b-c) start and the
    dry run (``start_dryrun``, in ``dry_work``) runs beside the four ranks'
    holds alone; the ranks serve after them (``ranks16_phase``), and the dry
    run is read last (``dryrun_phase``);
    then the dense path's row-parallel products are timed at one rank's
    shapes. Returns the ranks' flash launches on the hd-128 paths (summed);
    those on zamba2's hd-80 routes go to
    ``results["lm_sharded"]["hd80_launches"]``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.multihost import spawn_ranks

    failed = []

    def hold(cond: bool, msg: str) -> None:
        if not cond:
            failed.append(msg)
            log(f"lm sharded: FAILED {msg}")

    t0 = time.perf_counter()
    for tag, key in (("lm", "lm_whole"), ("moe", "moe_whole")):
        np.save(os.path.join(work, f"{tag}_tokens.npy"), results[key]["tokens"].numpy())
    np.save(os.path.join(work, "moe32_tokens.npy"),
            results["moe_whole"]["tokens"][:MOE_HOLD_SHAPE[0]].numpy())
    np.save(os.path.join(work, "moe22_tokens.npy"), results["moe_straddle_whole"]["tokens"].numpy())
    with open(os.path.join(work, "args.json"), "w") as f:
        json.dump({"device": str(dev)}, f)
    t = time.perf_counter()
    rec_wholes = _sharded_wholes(dev, work)
    t_rec_wholes = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = spawn_ranks([sys.executable, str(ROOT / "chip_smoke.py"), "--lm-rank", work],
                        make_mesh(SHARD_SERVE_MESH).size, SHARD_TIMEOUT)
    t_ranks = time.perf_counter() - t
    _rank_failures("lm sharded", ranks)
    check(all(code == 0 for code, _ in ranks),
          f"lm sharded: the ranks' exit codes {[code for code, _ in ranks]}")
    recs = [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(len(ranks))]
    card = results.get("card", "not measured")
    log(f"lm sharded ({len(ranks)} ranks on the card, {card}): the ranks' dense work "
        f"{[round(x['lm_s'], 1) for x in recs]} s, MoE work {[round(x['moe_s'], 1) for x in recs]}"
        f" s, recurrent work {[round(x['rec_s'], 1) for x in recs]} s, {t_ranks:.1f} s in all "
        f"(the recurrent stacks' whole runs before them {t_rec_wholes:.1f} s)")
    lm_cfg, moe_cfg = get_config(LM_ARCH), get_config(MOE_ARCH)
    mt, qm = results["mesh_tp"]["internlm2"], results["qwen2_moe"]
    # The whole training runs the ranks' training is held against, timed
    # (seconds a step beside the ranks'): the dense one at
    # SHARD_DENSE_TRAIN_LAYERS and the recurrent stacks' at their depths, as
    # the training phase runs them.
    t = time.perf_counter()
    lm_twin = _whole_train_twin(dev, LM_ARCH, SHARD_DENSE_TRAIN_LAYERS,
                                SHARD_DENSE_TRAIN_LAYERS)
    rec_twins = {label: _whole_train_twin(dev, arch, n, attn_applications(dataclasses.replace(
        get_config(arch), n_layers=n))) for label, arch, n, _ in REC_SHARDED}
    t_twins = time.perf_counter() - t
    # The SHARD16_MESH runs' whole twins (timed), then their 16 ranks and the
    # dry run (ROADMAP item 13.6) beside the holds, which decide correctness
    # and take no time that is reported; both read after the holds, before
    # the timed GEMMs below.
    t = time.perf_counter()
    wholes16 = _sharded_wholes(dev, work, SHARD16, SHARD16_SHAPE)
    t_wholes16 = time.perf_counter() - t
    torch.cuda.empty_cache()
    job16 = start_ranks16(work)
    dry = start_dryrun(dry_work)
    t = time.perf_counter()
    serve = _sharded_serving_holds(
        "lm sharded", lm_cfg, results["lm_whole"], [x["serve"] for x in recs], work, "lm",
        f"whole run: prefill {mt['prefill_s_tp1']:.3f} s, decode {mt['decode_ms_tp1']:.2f} ms",
        hold)
    moe_serve = _sharded_serving_holds(
        "moe sharded", moe_cfg, results["moe_whole"], [x["moe_serve"] for x in recs], work,
        "moe", f"whole run: prefill {qm['prefill_s']:.3f} s, decode {qm['decode_ms']:.2f} ms",
        hold)
    moe_serve.update(_sharded_f32_hold(
        dev, "moe sharded", dataclasses.replace(moe_cfg, n_layers=MOE_F32_LAYERS,
                                                dtype="float32"), results["moe_whole"], work,
        hold))
    lm_train_cfg = dataclasses.replace(lm_cfg, n_layers=SHARD_DENSE_TRAIN_LAYERS)
    tr = [x["train"] for x in recs]
    train = _sharded_training_holds(dev, "lm sharded", lm_train_cfg, lm_twin["losses"],
                                    lm_twin["step_s"], tr, work, "lm", hold)
    moe_tr = [x["moe_train"] for x in recs]
    fam = results["families_training"][MOE_ARCH]
    moe_train = _sharded_training_holds(
        dev, "moe sharded", dataclasses.replace(moe_cfg, n_layers=MOE_TRAIN_LAYERS),
        fam["losses"], fam["step_s"], moe_tr, work, "moe", hold)
    recurrent, hd80 = _recurrent_sharded_holds(dev, recs, rec_wholes, rec_twins, work, hold)
    straddle = [x["moe_straddle"] for x in recs]
    sw = results["moe_straddle_whole"]
    moe_straddle = _sharded_serving_holds(
        "moe straddling sharded", moe_cfg, sw, straddle, work, "moe22",
        f"whole run: prefill {sw['prefill_s']:.3f} s, decode {sw['decode_ms']:.2f} ms", hold,
        SHARD_STRADDLE_MESH)
    t_holds = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    try:
        sharded16 = ranks16_phase(dev, job16, wholes16, work, hold)
    finally:
        job16["thread"].join()
    t_holds16 = time.perf_counter() - t
    dryrun_phase(results, dry)
    # The row-parallel products and their partials' bytes (one rank's shapes).
    sv = [x["serve"] for x in recs]
    gemm = _row_parallel_gemms(dev, lm_cfg, sv[0]["prefill_collectives"])
    ar = gemm.pop("prefill all_reduce")
    log(f"lm sharded row-parallel GEMMs ({card}; ms with the f32 accumulator as output, the "
        f"operands widened to f32, a bf16 output): " + "; ".join(
            f"{k} {v['shape']} {v['ms_f32_out']:.3f} / {v['ms_widened']:.3f} / "
            f"{v['ms_bf16_out']:.3f} (rel L2 against the widened {v['rel']:.2e})"
            for k, v in gemm.items())
        + f"; a prefill's 'model' all-reduces on rank 0 with f32 partials "
          f"{ar['bytes_f32'] / 1e6:.1f} MB in {ar['seconds']:.3f} s, with bf16 partials "
          f"{ar['bytes_bf16'] / 1e6:.1f} MB ({ar['seconds_bf16_at_rate']:.3f} s at the same "
          f"rate)")
    for k, v in gemm.items():
        hold(v["rel"] <= 1e-5, f"lm sharded: row-parallel GEMM {k}: the f32 accumulator lies "
                               f"{v['rel']:.2e} from the widened product (limit 1e-5)")
    check(not failed, "lm sharded: " + " | ".join(failed))
    msv = [x["moe_serve"] for x in recs]
    mini = sharded16["minitron"]["serve"]
    counts = {"flash_attention": sum(x["prefill_launches"]["flash_attention"]
                                     + x["decode_launches"]["flash_attention"]
                                     for x in sv + msv + straddle + mini)
              + sum(x["launches"]["flash_attention"] for x in tr + moe_tr),
              "flash_attention_bwd": sum(x["launches"]["flash_attention_bwd"]
                                         for x in tr + moe_tr)}
    # Each run's flash launches on one rank (every rank of a run launches alike).
    serving = (("internlm2 1x4 serve", sv), ("qwen2-moe 1x4 serve", msv),
               (f"qwen2-moe {SHARD_STRADDLE_MESH} serve", straddle),
               (f"minitron-4b {SHARD16_MESH} serve", mini))
    training = (("internlm2 2x2 train", tr), ("qwen2-moe 2x2 train", moe_tr))
    flash_per_rank = {
        "flash_attention": {
            **{k: x[0]["prefill_launches"]["flash_attention"]
               + x[0]["decode_launches"]["flash_attention"] for k, x in serving},
            **{k: x[0]["launches"]["flash_attention"] for k, x in training}},
        "flash_attention_bwd": {k: x[0]["launches"]["flash_attention_bwd"]
                                for k, x in training}}
    results["lm_sharded"] = dict(card=card, ranks_s=t_ranks, seconds=time.perf_counter() - t0,
                                 serve=sv, train=tr, moe_serve=msv, moe_train=moe_tr,
                                 row_parallel=gemm, prefill_all_reduce=ar, launches=counts,
                                 **serve, **train,
                                 moe={**{f"serve_{k}": v for k, v in moe_serve.items()},
                                      **moe_train},
                                 recurrent=recurrent, hd80_launches=hd80,
                                 recurrent_wholes_s=t_rec_wholes, twins_s=t_twins,
                                 holds_s=t_holds, moe_straddle=dict(moe_straddle,
                                                                    serve=straddle),
                                 sharded16=sharded16, wholes16_s=t_wholes16,
                                 holds16_s=t_holds16,
                                 flash_per_rank=flash_per_rank)
    log(f"lm sharded ({card}): the recurrent stacks' whole runs {t_rec_wholes:.1f} s before the "
        f"ranks, their work on the ranks {[round(x['rec_s'], 1) for x in recs]} s, the "
        f"{SHARD_STRADDLE_MESH} qwen2-moe serving {[round(x['straddle_s'], 1) for x in recs]} s; "
        f"the whole training twins {t_twins:.1f} s; the {SHARD16_MESH} whole twins "
        f"{t_wholes16:.1f} s; the holds {t_holds:.1f} s beside the {SHARD16_MESH} ranks and the "
        f"dry run, then {t_holds16:.1f} s for the {SHARD16_MESH} ranks and their holds "
        f"({sharded16['waited_s']:.1f} s of it waited for), the dry run "
        f"{results['dryrun']['waited_s']:.1f} s waited for after them; flash launches on the "
        f"hd-80 routes {hd80}; hd-128 flash launches a rank, by run: {flash_per_rank}")
    return counts


_FLEX = {}


def timed_against_baseline(label: str, kern, base) -> tuple[float, float, float, float]:
    """Milliseconds of the earlier design ``base`` and the kernel ``kern``
    in turns (baseline, kernel, kernel, baseline; median of 3 each), and a
    check that the kernel is the faster in both pairs."""
    b1, k1, k2, b2 = (cuda_ms(fn, reps=3) for fn in (base, kern, kern, base))
    check(max(k1, k2) < min(b1, b2), f"{label}: the kernel ({k1:.3f} / {k2:.3f} ms) is not faster "
                                     f"than the baseline ({b1:.3f} / {b2:.3f} ms)")
    return b1, k1, k2, b2


def flex_library(s: int, window: int, cap: float, device):
    """The library call that computes the softcapped causal (sliding-window)
    GQA attention of the hd-256 routes: ``torch.compile(flex_attention)``
    with a ``score_mod`` of ``cap * tanh(s / cap)``, the causal (and window)
    ``block_mask`` and ``enable_gqa=True``. Returns ``fn(q, k, v)``; its
    backward is autograd through it. Timed here only: the port never
    calls it."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    if "fn" not in _FLEX:
        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
    key = ("mods", window, cap)
    if key not in _FLEX:
        def mask_mod(b, h, qi, ki):
            ok = qi >= ki
            return ok & (qi - ki < window) if window > 0 else ok

        def score_mod(score, b, h, qi, ki):
            return cap * torch.tanh(score / cap)

        _FLEX[key] = (mask_mod, score_mod)
    mask_mod, score_mod = _FLEX[key]
    block_mask = create_block_mask(mask_mod, None, None, s, s, device=device)
    return lambda q, k, v: _FLEX["fn"](q, k, v, score_mod=score_mod, block_mask=block_mask,
                                       enable_gqa=True)


def _sdpa_yardstick(q, kx, vx, mask):
    """``scaled_dot_product_attention`` on the repeated KV (kx, vx) at the
    causal mask, or at ``mask`` (``window_mask``), without the softcap: a
    yardstick beside the library call (``flex_library``) that computes the
    softcapped function."""
    import torch.nn.functional as F

    if mask is None:
        return F.scaled_dot_product_attention(q, kx, vx, is_causal=True)
    return F.scaled_dot_product_attention(q, kx, vx, attn_mask=mask)


def window_mask(s: int, window: int, device):
    """The (S, S) boolean causal sliding-window mask (None for window 0)."""
    import torch

    if window <= 0:
        return None
    i = torch.arange(s, device=device)
    dist = i[:, None] - i[None, :]
    return (dist >= 0) & (dist < window)


def _route_holds(label: str, logits, logits_never, logits_32=None) -> dict:
    """A bf16 model's prefill logits on the kernel route against its
    ``use_flash="never"`` route (3e-2 in relative L2, as the internlm2
    path), and, given the same weights in f32, both against them: the
    kernel route within 3e-2 (relative L2) and elementwise no further from
    f32 than 1.25x the never route's largest error."""
    import torch

    rel = lambda x, y: float(torch.linalg.norm(x - y) / torch.linalg.norm(y))
    out = lambda x, y: float(((x - y).abs() > 3e-2 * (1 + y.abs())).float().mean())
    res = dict(rel_never=rel(logits, logits_never),
               max_abs_never=float((logits - logits_never).abs().max()))
    log(f"{label}: kernel route vs use_flash=never rel L2 {res['rel_never']:.3e}, max_abs_err "
        f"{res['max_abs_never']:.3e}, share outside rtol=atol=3e-2 "
        f"{out(logits, logits_never):.2e} (|logits| max {float(logits_never.abs().max()):.3g})")
    check(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(logits_never).all()),
          f"{label}: non-finite logits")
    check(res["rel_never"] <= 3e-2, f"{label}: kernel route vs plain route logits rel L2 "
                                     f"{res['rel_never']:.3e} > 3e-2")
    if logits_32 is not None:
        err32, err32_never = (float((x - logits_32).abs().max()) for x in (logits, logits_never))
        res.update(rel_f32=rel(logits, logits_32), max_abs_f32=err32,
                   max_abs_f32_never=err32_never)
        log(f"{label} against the f32 weights: kernel route rel L2 {res['rel_f32']:.3e}, "
            f"max_abs_err {err32:.3e}; use_flash=never route rel L2 "
            f"{rel(logits_never, logits_32):.3e}, max_abs_err {err32_never:.3e}")
        check(res["rel_f32"] <= 3e-2, f"{label}: bf16 kernel route vs f32 rel L2 "
                                      f"{res['rel_f32']:.3e} > 3e-2")
        check(err32 <= 1.25 * err32_never,
              f"{label}: bf16 kernel route's largest error against f32 {err32:.3e} > 1.25 x "
              f"the never route's {err32_never:.3e}")
    return res


def _sub_model(model, n_layers: int, dtype=None, use_flash: str | None = None):
    """A ``TransformerLM`` on the first ``n_layers`` layers of ``model``'s
    weights (shared, or copied at ``dtype``), optionally on another
    attention route."""
    import dataclasses

    import torch

    from repro_torch.models.model import TransformerLM

    over = dict(n_layers=n_layers)
    if dtype is not None:
        over["dtype"] = "float32" if dtype == torch.float32 else "bfloat16"
    if use_flash is not None:
        over["use_flash"] = use_flash
    sub = TransformerLM(dataclasses.replace(model.cfg, **over), device="meta")
    keep = lambda key: not key.startswith("layers.") or int(key.split(".")[1]) < n_layers
    state = {k: (v.to(dtype) if dtype is not None and v.dtype != torch.float32 else v)
             for k, v in model.state_dict().items() if keep(k)}
    sub.load_state_dict(state, assign=True)
    return sub


def _serve_path(label: str, model, prompt, n_new: int, cache_len: int, warm_model=None,
                hbm_ms: float | None = None, tp: int = 1, keep: bool = False) -> dict:
    """The serving path through the entry points (``make_prefill_step``,
    ``make_decode_step``, at ``tp``) after a warm-up at its shapes (cuBLAS
    picks its algorithms at the first call of each shape; through
    ``warm_model``, a model of fewer layers of the same shapes, where the
    full prefill takes seconds): prefill, then ``n_new - 1`` greedy steps,
    each counted and timed; ``hbm_ms``, the time to read the weights and the
    cache once at HBM rate, is printed beside a decode step's. With
    ``keep`` the result also holds the tokens, each step's logits and the
    final cache."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.training.serve import make_decode_step, make_prefill_step

    cfg = model.cfg
    b, s = prompt.shape
    prefill = make_prefill_step(cfg, cache_len, tp=tp)
    decode = make_decode_step(cfg, tp=tp)
    warm_model = warm_model or model
    _, warm = prefill(warm_model, prompt)
    decode(warm_model, prompt[:, :1], warm)
    del warm
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t = time.perf_counter()
    logits, cache = prefill(model, prompt)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t
    pre = ops.launch_counts()
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    toks, step_logits = [tok], []
    ops.reset_launch_counts()
    t = time.perf_counter()
    for _ in range(n_new - 1):
        tok, lg, cache = decode(model, tok, cache)
        toks.append(tok)
        step_logits.append(lg)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t
    dec = ops.launch_counts()
    toks = torch.cat(toks, dim=1)
    log(f"phase {label} prefill {b}x{s}: {t_prefill:.3f} s ({b * s / t_prefill:.0f} prompt "
        f"tokens/s); launches {pre}")
    log(f"phase {label} decode {n_new - 1} steps x {b}: {t_decode:.3f} s "
        f"({b * (n_new - 1) / t_decode:.1f} tokens/s, {1e3 * t_decode / (n_new - 1):.2f} ms per "
        f"step" + ("" if hbm_ms is None else f"; the weights and the cache read once per step "
                                              f"take {hbm_ms:.2f} ms at HBM rate")
        + f"); launches {dec}")
    log(f"{label} sample tokens: {toks[0, :16].tolist()}")
    check(pre["flash_attention"] == attn_applications(cfg),
          f"{label}: prefill launched flash_attention {pre['flash_attention']} times, expected "
          f"{attn_applications(cfg)}")
    check(dec["flash_attention"] == 0, f"{label}: decode launched flash_attention")
    check(logits.shape == (b, cfg.vocab) and bool(torch.isfinite(logits).all())
          and all(bool(torch.isfinite(x).all()) for x in step_logits),
          f"{label}: non-finite logits")
    check(toks.shape == (b, n_new) and toks.dtype == torch.int32 and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab, f"{label}: tokens out of range")
    check(cache["pos"] == cache_len - 1, f"{label}: cache position")
    out = dict(logits=logits, prefill_s=t_prefill, decode_s=t_decode,
               decode_ms=1e3 * t_decode / (n_new - 1),
               launches={k: pre[k] + dec[k] for k in pre})
    if keep:
        out.update(tokens=toks, step_logits=step_logits, cache=cache)
    del cache, step_logits
    torch.cuda.empty_cache()
    return out


def _f32_holds(label: str, m2, prompt, s2: int, decode: bool = True) -> dict:
    """A few layers in f32 (``m2``): the kernel route against the
    ``use_flash="never"`` route on a prefill of ``s2 + 1`` tokens,
    elementwise at 1e-4 (the same function in other orders), and, with
    ``decode``, decode after a prefill of ``s2`` tokens against that
    prefill (tests/test_models_smoke.py's 2e-3)."""
    import torch

    from repro_torch.models.model import prefill_step, serve_step

    never = _sub_model(m2, m2.cfg.n_layers, use_flash="never")
    p = prompt[:, :s2 + 1]
    with torch.inference_mode():
        direct, _ = prefill_step(m2, p, s2 + 8)
        direct_never, _ = prefill_step(never, p, s2 + 8)
        if decode:
            _, c2 = prefill_step(m2, p[:, :s2], s2 + 8)
            dec, _ = serve_step(m2, p[:, s2:], c2)
    res = dict(f32_routes_max_abs=float((direct - direct_never).abs().max()))
    msg = (f"{label} at {p.shape[0]}x{p.shape[1]}: kernel route vs use_flash=never max_abs_err "
           f"{res['f32_routes_max_abs']:.3e}")
    if decode:
        res["decode_vs_prefill_max_abs"] = float((dec - direct).abs().max())
        msg += (f"; decode after prefill {s2} vs prefill {s2 + 1}: max_abs_err "
                f"{res['decode_vs_prefill_max_abs']:.3e}")
    log(msg)
    check(bool(torch.allclose(direct, direct_never, rtol=1e-4, atol=1e-4)),
          f"{label}: kernel route vs plain route differ by {res['f32_routes_max_abs']:.3e} > 1e-4")
    if decode:
        check(bool(torch.allclose(dec, direct, rtol=2e-3, atol=2e-3)),
              f"{label}: decode vs longer prefill differ by "
              f"{res['decode_vs_prefill_max_abs']:.3e} > 2e-3")
    return res


def _forced_rows(model, prompt, path: dict, cache_len: int) -> dict:
    """``model`` prefilled on ``prompt`` and decoded SHARD_DECODE steps
    teacher-forced on the serving path's tokens (``path``, with ``keep``):
    each logits row's relative L2 from the path's, position by position
    (the prefill first), and the greedy tokens that differ."""
    import torch

    from repro_torch.models.model import prefill_step, serve_step

    with torch.inference_mode():
        logits, cache = prefill_step(model, prompt, cache_len)
        got = [logits]
        for i in range(SHARD_DECODE):
            logits, cache = serve_step(model, path["tokens"][:, i:i + 1], cache)
            got.append(logits)
    want = [path["logits"]] + path["step_logits"][:SHARD_DECODE]
    rels = [((x - y).float().norm(dim=-1) / y.float().norm(dim=-1)).tolist()
            for x, y in zip(got, want)]
    flips = sum(int((x.argmax(-1) != y.argmax(-1)).sum()) for x, y in zip(got, want))
    return dict(rels=rels, flips=flips)


def _card_bytes(model, cache: dict) -> tuple[int, int]:
    """Summed ``nbytes`` of a model's parameters and of a decode cache."""
    import torch

    return (sum(p.numel() * p.element_size() for p in model.parameters()),
            sum(t.numel() * t.element_size() for t in cache.values() if torch.is_tensor(t)))


def _reckoned_vs_card(label: str, mesh_spec: str, batch: int, cache_len: int, model,
                      cache: dict) -> dict:
    """The dry run's reckoning (``launch.dryrun.lm_cell_bytes``) of this
    serving shape on ``mesh_spec`` against the tensors on the card: the
    parameter and cache bytes of the mesh's layout in all (what the one
    card holds when it runs that layout) equal their summed ``nbytes``
    exactly; the per-device bytes of the mesh are printed beside them."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.dryrun import lm_cell_bytes
    from repro_torch.launch.mesh import make_mesh

    rec = lm_cell_bytes(model.cfg, ShapeSpec("smoke", cache_len, batch, "decode"),
                        make_mesh(mesh_spec))
    p_card, c_card = _card_bytes(model, cache)
    tot = rec["totals"]
    log(f"{label} --mesh {mesh_spec}: dry run reckons params {tot['params']:,} B and cache "
        f"{tot['cache']:,} B in all ({rec['param_bytes']:,} + {rec['cache_bytes']:,} B per "
        f"device of the mesh); the card holds {p_card:,} + {c_card:,} B")
    check(tot["params"] == p_card and tot["cache"] == c_card,
          f"{label} --mesh {mesh_spec}: reckoned bytes {tot['params']} / {tot['cache']} differ "
          f"from the card's {p_card} / {c_card}")
    return dict(params=p_card, cache=c_card, per_device=rec["param_bytes"] + rec["cache_bytes"])


def _tp_serving_hold(label: str, model, prompt, mesh_spec: str, cache_len: int, base: dict,
                     logits_rel: float) -> dict:
    """The serving path at ``tp`` (``--mesh mesh_spec``) on ``model``, held
    against the tp = 1 run ``base`` (``_serve_path(..., keep=True)``; its
    cache is needed only where tp expands it): the same tokens, the prefill
    and every step's logits within ``logits_rel`` in relative L2, and, where
    the cache is expanded (r > 1), every copy of each KV head of the
    prefilled slots bitwise the tp = 1 cache's. The
    dry run's bytes against the card's, and its reckoned peak beside
    ``max_memory_allocated`` over the run."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.attention import cache_expand_factor
    from repro_torch.sharding.rules import tp_size

    cfg = model.cfg
    b, s = prompt.shape
    tp = tp_size(make_mesh(mesh_spec))
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    run = _serve_path(f"{label} --mesh {mesh_spec} (tp={tp})", model, prompt, LM_NEW,
                      cache_len, tp=tp, keep=True)
    peak = torch.cuda.max_memory_allocated()
    rel = lambda x, y: float(torch.linalg.norm((x - y).float()) / torch.linalg.norm(y.float()))
    rels = [rel(run["logits"], base["logits"])] + [
        rel(x, y) for x, y in zip(run["step_logits"], base["step_logits"])]
    same_tokens = torch.equal(run["tokens"], base["tokens"])
    bitwise = [torch.equal(run["logits"], base["logits"])] + [
        torch.equal(x, y) for x, y in zip(run["step_logits"], base["step_logits"])]
    r = cache_expand_factor(cfg, tp)
    cache_ok = None if r == 1 else all(
        torch.equal(run["cache"][key][:, :, :s, j::r], base["cache"][key][:, :, :s])
        for key in ("k", "v") for j in range(r))
    log(f"{label} tp={tp} vs tp=1: tokens equal {same_tokens}; logits rel L2 prefill "
        f"{rels[0]:.3e}, decode max {max(rels[1:]):.3e} (limit {logits_rel:g}); bitwise equal "
        f"logits {sum(bitwise)} of {len(bitwise)}; cache {tuple(run['cache']['k'].shape)} "
        f"(r={r}), every copy of each KV head of the prefilled slots bitwise the tp=1 cache's: "
        f"{'no copies' if r == 1 else cache_ok}; decode {run['decode_ms']:.2f} ms per step against "
        f"{base['decode_ms']:.2f} at tp=1, prefill {run['prefill_s']:.3f} s against "
        f"{base['prefill_s']:.3f}")
    check(same_tokens, f"{label} tp={tp}: tokens differ from the tp=1 run")
    check(max(rels) <= logits_rel, f"{label} tp={tp}: logits rel L2 {max(rels):.3e} from tp=1 "
                                   f"> {logits_rel:g}")
    check(cache_ok is not False,
          f"{label} tp={tp}: the expanded cache is not each KV head repeated {r} times")
    by = _reckoned_vs_card(label, mesh_spec, b, cache_len, model, run["cache"])
    reckoned = by["params"] + by["cache"]
    log(f"{label} tp={tp}: reckoned peak (params + cache, no activations) "
        f"{reckoned / 1e9:.3f} GB, max_memory_allocated over the run {peak / 1e9:.3f} GB")
    out = dict(tp=tp, mesh=mesh_spec, r=r, tokens_equal=same_tokens, logits_rel=rels,
               bitwise_logits=sum(bitwise), cache_bitwise=cache_ok, decode_ms=run["decode_ms"],
               decode_ms_tp1=base["decode_ms"], prefill_s=run["prefill_s"],
               prefill_s_tp1=base["prefill_s"], reckoned_bytes=reckoned, max_allocated=peak,
               launches=run["launches"], seconds=time.perf_counter() - t0)
    del run
    torch.cuda.empty_cache()
    return out


def _pad_experts_in_place(model, tp: int, generator) -> None:
    """Pad every MoE layer of ``model`` (built at tp = 1) to
    ``padded_experts(cfg, tp)`` experts, layer by layer: the first E keep
    their weights, the new ones get draws at ``MoE.reset_parameters``'s
    scales (router columns 0.02, experts d ** -0.5 and f ** -0.5), so that
    at most one leaf exists twice at a time (the whole model twice would
    be ~57 GB for qwen2-moe)."""
    import torch
    from torch import nn

    from repro_torch.models.layers import dense_init_
    from repro_torch.models.transformer import padded_experts

    cfg = model.cfg
    e, e_pad = cfg.n_experts, padded_experts(cfg, tp)
    with torch.no_grad():
        for layer in model.layers:
            moe = layer.moe
            d, f = moe.w_gate.shape[1:]
            for name, dim, scale in (("router", 1, 0.02), ("w_gate", 0, d ** -0.5),
                                     ("w_up", 0, d ** -0.5), ("w_down", 0, f ** -0.5)):
                old = getattr(moe, name)
                shape = list(old.shape)
                shape[dim] = e_pad
                new = torch.empty(shape, dtype=old.dtype, device=old.device)
                new.narrow(dim, 0, e).copy_(old)
                dense_init_(new.narrow(dim, e, e_pad - e), generator, scale=scale)
                setattr(moe, name, nn.Parameter(new, requires_grad=old.requires_grad))
                del old
    torch.cuda.empty_cache()


def start_dryrun(work: str) -> dict:
    """Start ``python -m repro_torch.launch.dryrun`` over every cell on both
    production meshes and one card (``1x1``) in a subprocess, in the
    background: it runs on the host alone (``meta`` tensors), beside the
    sharded phase's holds, and ``dryrun_phase`` reads it. The process
    is killed at exit if it is still running."""
    import atexit

    out = os.path.join(work, "dryrun.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT / "src"), env.get("PYTHONPATH"))
                                        if p)
    meshes = ("pod", "multipod", "1x1")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--jobs", str(DRYRUN_JOBS),
           "--out", out] + sum((["--mesh", m] for m in meshes), [])
    proc = subprocess.Popen(cmd, env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return dict(proc=proc, cmd=cmd, out=out, meshes=meshes, t0=time.perf_counter())


def dryrun_phase(results: dict, job: dict) -> dict:
    """The dry run started by ``start_dryrun``: it must exit 0 with every
    applicable cell OK (32 LM cells and 2 SBV GP cells a mesh) and the
    reference's skips, each with ``configs.applicable``'s reason. A compact
    summary per arch: the largest per-device peak on each mesh and whether
    every cell of the arch fits one 80 GB card there."""
    from repro_torch.configs import ARCHS, SHAPES, applicable, get_config

    proc, cmd, out, meshes = job["proc"], job["cmd"], job["out"], job["meshes"]
    t = time.perf_counter()
    try:
        stdout, stderr = proc.communicate(timeout=max(1.0, DRYRUN_TIMEOUT - (t - job["t0"])))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        check(False, f"dry run did not finish within {DRYRUN_TIMEOUT} s")
    waited, wall = time.perf_counter() - t, time.perf_counter() - job["t0"]
    log(f"dry run: {' '.join(cmd[1:])}: exit {proc.returncode} {wall:.1f} s after its start "
        f"(in the background; {waited:.1f} s waited for here); "
        f"{stdout.strip().splitlines()[-1] if stdout.strip() else ''}")
    check(proc.returncode == 0, f"dry run exited {proc.returncode}: {stderr[-2000:]}")
    with open(out) as f:
        data = json.load(f)
    applicable_cells = [(a, s_) for a in ARCHS for s_ in SHAPES
                        if applicable(get_config(a), s_)[0]]
    want_skips = {f"{a}|{s_}|-": applicable(get_config(a), s_)[1] for a in ARCHS for s_ in SHAPES
                  if not applicable(get_config(a), s_)[0]}
    ok = {k: v for k, v in data.items() if "error" not in v and "skipped" not in v}
    skips = {k: v["skipped"] for k, v in data.items() if "skipped" in v}
    errors = [k for k, v in data.items() if "error" in v]
    n_want = len(meshes) * (len(applicable_cells) + 2)
    log(f"dry run: {len(ok)} cells OK (expected {n_want}: {len(applicable_cells)} LM cells and 2 "
        f"SBV GP cells on each of {len(meshes)} meshes), {len(skips)} skipped, errors {errors}")
    check(not errors and len(ok) == n_want, f"dry run: {len(ok)} cells OK of {n_want}, errors "
                                            f"{errors}")
    check(skips == want_skips, "dry run: the skips differ from configs.applicable's")
    summary = {}
    for arch in list(ARCHS) + ["sbv-gp"]:
        row = {}
        for m in meshes:
            cells = [v for v in ok.values() if v["arch"] == arch and v["mesh"] == m]
            row[m] = dict(peak_gb=max(v["peak_memory"] for v in cells) / 1e9,
                          fits=all(v["fits"] for v in cells),
                          fits_shapes=[v["shape"] for v in cells if v["fits"]])
        summary[arch] = row
        log(f"dry run {arch}: largest reckoned peak per device " + "; ".join(
            f"{m} {r_['peak_gb']:.2f} GB ({'all fit' if r_['fits'] else 'fit: ' + (','.join(r_['fits_shapes']) or 'none')})"
            for m, r_ in row.items()))
    results["dryrun"] = dict(wall_s=wall, waited_s=waited, cells=len(ok), skipped=len(skips),
                             summary=summary)
    return results["dryrun"]


def gemma2_serving_phase(dev, peaks, results: dict) -> dict:
    """gemma2-9b serving at full width and depth (ROADMAP item 13.2): the
    forward kernel at hd 256 (the 'wgmma' route) against its plain version
    at the path's global and local shapes (window 4096, softcap 50) before
    the model is loaded, and timed beside the scalar kernel it replaced, its
    plain version, flex_attention and an SDPA yardstick; the path through
    the entry points; the model against its
    ``use_flash="never"`` route, its first layers against the same weights
    in f32, and decode after a prefill against a longer prefill. Returns the
    launch counts of the path run (prefill and decode)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (ROUTES, flash_attention_cuda,
                                                     flash_attention_plain, flash_route)
    from repro_torch.kernels.flash_attention import _launch as flash_launch
    from repro_torch.models.model import init_params, prefill_step
    from repro_torch.models.transformer import layer_windows

    cfg = get_config(G2_ARCH)
    b, h, hkv, s, hd = G2_BATCH, cfg.n_heads, cfg.n_kv_heads, G2_PROMPT, cfg.head_dim
    cap, tol, row_tol = cfg.attn_softcap, 3e-2, 1e-2
    route = flash_route(torch.bfloat16, hd)
    check(route == "wgmma", f"gemma2: the forward's route at hd {hd} is {route!r}")
    windows = layer_windows(cfg)
    kinds = (("global", 0), ("local", cfg.sliding_window))

    # 53. The forward kernel against its plain version at the path's two
    # shapes (B = 2, H = 16, Hkv = 8, S = T = 8192, hd = 256, causal,
    # softcap 50; window 0 and 4096), on random and edge queries (the keys
    # at the causal and the window's edges), and times: the kernel beside
    # the scalar kernel it replaced (the 'scalar_bf16' route, uncounted,
    # first held against it: baseline, kernel, kernel, baseline), the plain
    # version, flex_attention, and SDPA on the same mask without the
    # softcap.
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    mk = lambda *sh: torch.randn(*sh, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = mk(b, h, s, hd), mk(b, hkv, s, hd), mk(b, hkv, s, hd)
    kern_res = {}
    for kind, window in kinds:
        errs = {}
        lib = flex_library(s, window, cap, dev)
        for inp in ("random", "edge"):
            qq = q if inp == "random" else flash_edge_queries(k, h, s, window)
            want = flash_attention_plain(qq, k, v, causal=True, window=window, softcap=cap)
            if inp == "random":
                # The library call computes the same function: its output
                # within the kernel's limits of the plain version's.
                lib_out = lib(q, k, v)
                lib_err = float((lib_out.float() - want.float()).abs().max())
                lib_row = row_rel_err(lib_out, want)
                log(f"flex_attention gemma2 {kind} bf16 random vs plain: max_abs_err "
                    f"{lib_err:.3e}, row rel L2 max {lib_row:.3e}")
                check(lib_row <= row_tol and bool(((lib_out.float() - want.float()).abs()
                                                   <= tol * (1 + want.float().abs())).all()),
                      f"flex_attention gemma2 {kind}: not the kernel's function ({lib_err:.3e})")
                del lib_out
            got = flash_attention_cuda(qq, k, v, causal=True, window=window, softcap=cap)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            bad = float(((got.float() - want.float()).abs()
                         - tol * (1 + want.float().abs())).max())
            row = row_rel_err(got, want)
            log(f"flash gemma2 {kind} bf16 {inp}: B={b} H={h} Hkv={hkv} S=T={s} hd={hd} causal "
                f"window={window} softcap={cap}: max_abs_err={err:.3e} (tol {tol:g}), row rel "
                f"L2 max {row:.3e} (tol {row_tol:g})")
            check(bool(torch.isfinite(got).all()), f"flash gemma2 {kind}: non-finite output")
            check(bad <= 0, f"flash gemma2 {kind} {inp}: kernel vs plain max_abs_err {err:.3e} "
                            f"beyond rtol = atol = {tol:g}")
            check(row <= row_tol, f"flash gemma2 {kind} {inp}: kernel vs plain row rel L2 "
                                  f"{row:.3e} > {row_tol:g}")
            errs[inp] = (err, row)
            del qq, want, got
            torch.cuda.empty_cache()
        kern = lambda: flash_attention_cuda(q, k, v, causal=True, window=window, softcap=cap)
        base = lambda: flash_launch(ROUTES["scalar_bf16"], q, k, v, True, window, cap)
        got, want = kern(), base()
        base_row = row_rel_err(got, want)
        check(base_row <= row_tol, f"flash gemma2 {kind}: wgmma vs the scalar baseline row rel "
                                   f"L2 {base_row:.3e}")
        del got, want
        b1_ms, k_ms, k2_ms, b2_ms = timed_against_baseline(f"flash gemma2 {kind}", kern, base)
        # The kernel without the softcap (not the path's function): what the
        # accurate tanhf on every score costs.
        nc_ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=True, window=window), reps=3)
        with torch.inference_mode():
            p_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True, window=window,
                                                         softcap=cap), reps=3)
        kx, vx = k.repeat_interleave(h // hkv, 1), v.repeat_interleave(h // hkv, 1)
        mask = window_mask(s, window, dev)
        l_ms = cuda_ms(lambda: _sdpa_yardstick(q, kx, vx, mask), reps=3)
        del kx, vx, mask
        torch.cuda.empty_cache()
        f_ms = cuda_ms(lambda: lib(q, k, v), reps=3)
        flops, nbytes = flash_work(b, h, hkv, s, hd, 2, window)
        b_ms, b_by = bound_ms(flops, nbytes, peaks, "bf16")
        log(f"flash time gemma2 {kind} (B={b} H={h} Hkv={hkv} S=T={s} hd={hd} window={window} "
            f"softcap={cap}, {route} route): kernel {k_ms:.3f} / {k2_ms:.3f} ms "
            f"({flops / k_ms / 1e9:.2f} TFLOP/s, {100 * b_ms / k_ms:.2f} % of the bound, "
            f"{100 * b_ms / f_ms:.2f} % for flex_attention); the scalar kernel it replaced "
            f"{b1_ms:.3f} / {b2_ms:.3f} ms (before / after; "
            f"{min(b1_ms, b2_ms) / max(k_ms, k2_ms):.1f}x the wgmma route's time; row rel L2 "
            f"between them {base_row:.3e}); the kernel without the softcap {nc_ms:.3f} ms; plain "
            f"{p_ms:.3f} ms; flex_attention (compiled, softcap score_mod, block mask) "
            f"{f_ms:.3f} ms ({f_ms / k_ms:.2f}x the kernel's time); scaled_dot_product_attention "
            f"on the same mask without the softcap (yardstick, not the same function) "
            f"{l_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by}; {flops:.3e} flop, {nbytes:.3e} B)")
        kern_res[kind] = dict(max_abs_err=errs["random"][0], row_rel=errs["random"][1],
                              edge_max_abs_err=errs["edge"][0], ms=k_ms, ms2=k2_ms,
                              baseline_ms=[b1_ms, b2_ms], baseline_row_rel=base_row,
                              no_softcap_ms=nc_ms, plain_ms=p_ms,
                              library_ms=f_ms, library_max_abs_err=lib_err,
                              sdpa_no_softcap_ms=l_ms, bound_ms=b_ms, bound_by=b_by, flops=flops)
    del q, k, v
    torch.cuda.empty_cache()

    # 54. The path: gemma2-9b at full width and depth, 2 x 8192 + 32.
    t = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    cache_len = G2_PROMPT + G2_NEW
    kv_bytes = 2 * cfg.n_layers * b * cache_len * hkv * hd * 2
    n_local = sum(1 for w in windows if w)
    log(f"phase gemma2 init: {time.perf_counter() - t:.2f} s; {G2_ARCH} at full width and depth "
        f"(L={cfg.n_layers}: {n_local} local at window {cfg.sliding_window}, "
        f"{cfg.n_layers - n_local} global; d={cfg.d_model}, H/Hkv={h}/{hkv}, hd={hd}, "
        f"d_ff={cfg.d_ff}, V={cfg.vocab}, tied, softcaps {cap} / {cfg.logit_softcap}): "
        f"{n_par / 1e9:.3f} B parameters, {n_bytes / 1e9:.2f} GB; KV cache {kv_bytes / 1e9:.2f} GB")
    check(not hasattr(model, "lm_head"), "gemma2: tied embeddings carry an lm_head")
    prompt = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, (b, G2_PROMPT)),
                             dtype=torch.int32, device=dev)
    path = _serve_path("gemma2", model, prompt, G2_NEW, cache_len,
                       warm_model=_sub_model(model, G2_F32_LAYERS))
    t_attn = (n_local * kern_res["local"]["ms"]
              + (cfg.n_layers - n_local) * kern_res["global"]["ms"]) / 1e3
    log(f"gemma2 prefill: flash_attention launches {path['launches']['flash_attention']} on the "
        f"{route!r} route (hd {hd}), {n_local} x {kern_res['local']['ms']:.2f} ms + "
        f"{cfg.n_layers - n_local} x {kern_res['global']['ms']:.2f} ms = {t_attn:.3f} s "
        f"of the {path['prefill_s']:.3f} s prefill; decode {path['decode_ms']:.2f} ms per step "
        f"(the weights and the cache read once take "
        f"{1e3 * (n_bytes + kv_bytes) / peaks['hbm']:.2f} ms at HBM rate)")

    # 55. The same weights through the never route at full depth, and their
    # first G2_F32_LAYERS layers on both routes against the same weights in
    # f32 (the kernel's f32 route at hd 256: 'scalar_f32').
    with torch.inference_mode():
        logits_never, _ = prefill_step(_sub_model(model, cfg.n_layers, use_flash="never"),
                                       prompt, cache_len)
    torch.cuda.empty_cache()
    holds = {"full": _route_holds(f"gemma2 prefill logits ({cfg.n_layers} layers, bf16)",
                                  path["logits"], logits_never)}
    del logits_never
    torch.cuda.empty_cache()
    n4 = G2_F32_LAYERS
    with torch.inference_mode():
        l_k, _ = prefill_step(_sub_model(model, n4), prompt, cache_len)
        l_n, _ = prefill_step(_sub_model(model, n4, use_flash="never"), prompt, cache_len)
        torch.cuda.empty_cache()
        l_32, _ = prefill_step(_sub_model(model, n4, dtype=torch.float32), prompt, cache_len)
    torch.cuda.empty_cache()
    holds["f32"] = _route_holds(f"gemma2 prefill logits ({n4} layers, bf16)", l_k, l_n, l_32)
    del l_k, l_n, l_32
    torch.cuda.empty_cache()

    # 56. f32, the first G2_DECODE_LAYERS layers (one local, one global):
    # the two routes elementwise (1e-4), and decode after a prefill of
    # G2_DECODE_PROMPT tokens (past the window, which then binds in the
    # decode mask as in the prefill) against a prefill of one more
    # (tests/test_models_smoke.py's 2e-3).
    holds.update(_f32_holds(f"gemma2 f32 {G2_DECODE_LAYERS}-layer (window "
                            f"{cfg.sliding_window} < {G2_DECODE_PROMPT} tokens)",
                            _sub_model(model, G2_DECODE_LAYERS, dtype=torch.float32), prompt,
                            G2_DECODE_PROMPT))
    del model, path["logits"]
    torch.cuda.empty_cache()
    results["gemma2"] = dict(kernel=kern_res, holds=holds, prefill_s=path["prefill_s"],
                             decode_ms=path["decode_ms"], params=n_par)
    return path["launches"]


def moe_serving_phase(dev, peaks, results: dict) -> dict:
    """qwen2-moe-a2.7b serving at full width and depth (ROADMAP item
    13.3): the path through the entry points at LM_BATCH x LM_PROMPT +
    LM_NEW, the model against its ``use_flash="never"`` route, one MoE
    layer on the card against the same layer on the CPU in f32 (outputs,
    aux, and the kept (token, expert, slot) assignments), and the MoE's
    share of one prefill layer. Returns the launch counts of the path run."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_route
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.model import embed_tokens, init_params, prefill_step
    from repro_torch.models.moe import MoE

    cfg = get_config(MOE_ARCH)
    route = flash_route(torch.bfloat16, cfg.head_dim)
    check(route == "wgmma", f"qwen2-moe: the forward's route at hd {cfg.head_dim} is {route!r}")

    # 57. The path.
    t = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    cache_len = LM_PROMPT + LM_NEW
    kv_bytes = 2 * cfg.n_layers * LM_BATCH * cache_len * cfg.n_kv_heads * cfg.head_dim * 2
    moe0 = model.layers[0].moe
    log(f"phase qwen2-moe init: {time.perf_counter() - t:.2f} s; {MOE_ARCH} at full width and "
        f"depth (L={cfg.n_layers}, d={cfg.d_model}, H={cfg.n_heads}, hd={cfg.head_dim}, "
        f"{moe0.n_experts} experts top-{cfg.n_experts_active}, moe_d_ff={cfg.moe_d_ff}, "
        f"shared_d_ff={cfg.shared_d_ff}, V={cfg.vocab}): {n_par / 1e9:.3f} B parameters, "
        f"{n_bytes / 1e9:.2f} GB; KV cache {kv_bytes / 1e9:.2f} GB")
    prompt = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab,
                                                               (LM_BATCH, LM_PROMPT)),
                             dtype=torch.int32, device=dev)
    path = _serve_path("qwen2-moe", model, prompt, LM_NEW, cache_len, keep=True)
    t = time.perf_counter()
    card1 = _reckoned_vs_card("qwen2-moe", "1x1", LM_BATCH, cache_len, model, path.pop("cache"))
    t_card1 = time.perf_counter() - t
    torch.cuda.empty_cache()

    # 58. The never route at full depth, layer by layer: each layer of both
    # routes takes the same input (the kernel route's hidden states). The
    # attention sublayer's outputs (the part the routes compute apart) are
    # held at 3e-2 in relative L2, as the dense paths' logits are. A token
    # whose router input moves by the two routes' bf16 rounding may pick
    # another expert (routing is discontinuous), so the block's update
    # (output minus input) is held at 3e-2 on the tokens both routes route
    # alike (the same experts, kept alike), and the others are counted and
    # held to MOE_REROUTED_MAX of the tokens per layer. The last token's
    # logits after all 24 layers, which carry those routing differences, are
    # held to MOE_LOGITS_REL in relative L2.
    never = _sub_model(model, cfg.n_layers, use_flash="never")
    rel = lambda x, y: float(torch.linalg.norm((x - y).float()) / torch.linalg.norm(y.float()))
    with torch.inference_mode():
        logits_never, _ = prefill_step(never, prompt, cache_len)
        e2e = rel(path["logits"], logits_never)
        del logits_never
    # The yardstick of the sharded phase's bf16 hold (lm_sharded_phase): the
    # never route (a second bf16 computation of the same weights) and a
    # planted fault (the kernel route with experts 0-14, one rank's at 1x4,
    # giving no output), each prefilled and decoded teacher-forced on this
    # run's tokens, their logits' rows against this run's.
    yard = {"never": _forced_rows(never, prompt, path, cache_len)}
    # The same for the sharded phase's run at SHARD_STRADDLE_MESH (ROADMAP
    # item 13.6a): its whole twin, the path on the first
    # SHARD_STRADDLE_SHAPE of the prompt, and that hold's yardstick.
    b2, s2 = SHARD_STRADDLE_SHAPE
    p2, cl2 = prompt[:b2, :s2], s2 + LM_NEW
    path2 = _serve_path(f"qwen2-moe {b2}x{s2} (the {SHARD_STRADDLE_MESH} sharded run's whole "
                        f"twin)", model, p2, LM_NEW, cl2, keep=True)
    path2.pop("cache")
    yard2 = {"never": _forced_rows(never, p2, path2, cl2)}
    saved = [layer.moe.w_down[:cfg.n_experts // 4].clone() for layer in model.layers]
    with torch.no_grad():
        for layer in model.layers:
            layer.moe.w_down[:cfg.n_experts // 4] = 0
    yard["fault"] = _forced_rows(model, prompt, path, cache_len)
    yard2["fault"] = _forced_rows(model, p2, path2, cl2)
    with torch.no_grad():
        for layer, w in zip(model.layers, saved):
            layer.moe.w_down[:cfg.n_experts // 4] = w
    del saved
    torch.cuda.empty_cache()
    with torch.inference_mode():
        x = embed_tokens(model, prompt)
        positions = torch.arange(LM_PROMPT, dtype=torch.int32, device=dev).expand(LM_BATCH,
                                                                                  LM_PROMPT)
        per_layer = []
        for lk, ln_ in zip(model.layers, never.layers):
            a = rms_norm(x, lk.ln1, cfg.norm_eps)
            hk, hn = lk.attn(a, positions, 0)[0], ln_.attn(a, positions, 0)[0]
            rk, rn = (lk.moe.routing(rms_norm(x + h_, lk.ln2, cfg.norm_eps)) for h_ in (hk, hn))
            alike = ((rk.expert == rn.expert) & (rk.keep == rn.keep)).all(-1).reshape(LM_BATCH,
                                                                                      LM_PROMPT)
            yk, yn = lk._ffn_residual(x, hk)[0], ln_._ffn_residual(x, hn)[0]
            per_layer.append((rel(hk, hn), rel((yk - x)[alike], (yn - x)[alike]),
                              int((~alike).sum())))
            x = yk
        del x, a, hk, hn, rk, rn, yk, yn, alike
    del never
    torch.cuda.empty_cache()
    worst_attn = max(r_[0] for r_ in per_layer)
    worst_upd = max(r_[1] for r_ in per_layer)
    rerouted = [r_[2] for r_ in per_layer]
    log(f"qwen2-moe, kernel route vs use_flash=never, layer by layer on the same inputs "
        f"({cfg.n_layers} layers, bf16, {LM_BATCH}x{LM_PROMPT}): attention output rel L2 max "
        f"{worst_attn:.3e} (limit 3e-2); block update rel L2 max {worst_upd:.3e} on the tokens "
        f"routed alike (limit 3e-2); tokens routed otherwise per layer {rerouted} of "
        f"{LM_BATCH * LM_PROMPT} (limit {MOE_REROUTED_MAX:g} of them); the last token's logits "
        f"after all layers rel L2 {e2e:.3e} (limit {MOE_LOGITS_REL:g})")
    check(worst_attn <= 3e-2, f"qwen2-moe: attention kernel route vs never route rel L2 "
                              f"{worst_attn:.3e} > 3e-2")
    check(worst_upd <= 3e-2, f"qwen2-moe: block update kernel route vs never route rel L2 "
                             f"{worst_upd:.3e} > 3e-2 on tokens routed alike")
    check(max(rerouted) <= MOE_REROUTED_MAX * LM_BATCH * LM_PROMPT,
          f"qwen2-moe: {max(rerouted)} of {LM_BATCH * LM_PROMPT} tokens routed otherwise on the "
          f"never route in one layer, more than {MOE_REROUTED_MAX:g} of them")
    check(e2e <= MOE_LOGITS_REL, f"qwen2-moe: last-token logits kernel route vs never route "
                                 f"rel L2 {e2e:.3e} > {MOE_LOGITS_REL:g}")
    holds = dict(attn_rel_max=worst_attn, update_rel_max=worst_upd, rerouted=rerouted,
                 logits_rel=e2e)

    # 58b. f32, the first 2 layers at 2 x 1024 tokens (two whole groups of
    # the MoE; a decode hold would need a prefill of 2 x 1023, which no
    # group size divides): the two routes elementwise.
    holds.update(_f32_holds("qwen2-moe f32 2-layer", _sub_model(model, 2, dtype=torch.float32),
                            prompt[:2], 1023, decode=False))
    torch.cuda.empty_cache()

    # 59. The MoE's share of one prefill layer at the path's shape (layer 0
    # on the prompt's embeddings; CUDA events, median of 5).
    with torch.inference_mode():
        layer = model.layers[0]
        x = embed_tokens(model, prompt)
        positions = torch.arange(LM_PROMPT, dtype=torch.int32, device=dev).expand(LM_BATCH,
                                                                                  LM_PROMPT)
        hn = rms_norm(x, layer.ln2, cfg.norm_eps)
        layer_ms = cuda_ms(lambda: layer(x, positions, 0))
        moe_ms = cuda_ms(lambda: layer.moe(hn))
        r = layer.moe.routing(hn)
        kept, chosen = int(r.keep.sum()), int(r.selected.sum())
        routed_tp1 = (r.keep, r.expert, r.slot)
    log(f"qwen2-moe prefill layer at {LM_BATCH}x{LM_PROMPT}: {layer_ms:.3f} ms, of which the MoE "
        f"{moe_ms:.3f} ms ({100 * moe_ms / layer_ms:.1f} %); {r.expert.shape[0]} groups, "
        f"capacity {r.capacity}, kept {kept} of {chosen} assignments")
    del x, hn, r, positions
    torch.cuda.empty_cache()

    # 60. One MoE layer (layer 0's weights in f32) on the card against the
    # same layer on the CPU, on the same f32 input (2 x 1024 tokens, two
    # groups): the output within 1e-4 of its largest entry (cuBLAS's and
    # the CPU's f32 sums in other orders), the aux at rtol 1e-5, the kept
    # (token, expert, slot) assignments equal. The smallest gap between a
    # token's k-th and (k+1)-th router probability says how near a tie
    # came.
    state = {k_: v_.float() for k_, v_ in moe0.state_dict().items()}
    on_card = MoE(cfg, moe0.n_experts, dtype=torch.float32, device=dev)
    on_cpu = MoE(cfg, moe0.n_experts, dtype=torch.float32)
    on_card.load_state_dict(state)
    on_cpu.load_state_dict({k_: v_.cpu() for k_, v_ in state.items()})
    xb, xs = MOE_HOLD_SHAPE
    x_cpu = torch.randn(xb, xs, cfg.d_model, generator=torch.Generator().manual_seed(SEED + 29))
    t = time.perf_counter()
    with torch.inference_mode():
        out_c, aux_c = on_card(x_cpu.to(dev))
        r_c = on_card.routing(x_cpu.to(dev))
        torch.cuda.synchronize()
        out_h, aux_h = on_cpu(x_cpu)
        r_h = on_cpu.routing(x_cpu)
    t_hold = time.perf_counter() - t
    top = torch.sort(r_h.probs, dim=-1, descending=True).values
    k_act = cfg.n_experts_active
    gap = float((top[..., k_act - 1] - top[..., k_act]).min())
    err = float((out_c.cpu() - out_h).abs().max()) / float(out_h.abs().max())
    same = (torch.equal(r_c.keep.cpu(), r_h.keep) and torch.equal(r_c.expert.cpu(), r_h.expert)
            and torch.equal(r_c.slot.cpu(), r_h.slot))
    kept_c, kept_h = int(r_c.keep.sum()), int(r_h.keep.sum())
    log(f"qwen2-moe MoE layer f32, card vs CPU at {xb}x{xs} tokens ({t_hold:.2f} s): output "
        f"max_abs_err {err:.3e} of the largest (limit 1e-4), aux {float(aux_c):.8f} / "
        f"{float(aux_h):.8f}, kept assignments {kept_c} / {kept_h} of "
        f"{xb * xs * k_act} (capacity {r_h.capacity}), the same (token, expert, slot) triples "
        f"{same}; smallest top-{k_act} router gap {gap:.3e}")
    check(err <= 1e-4, f"qwen2-moe MoE layer: card vs CPU {err:.3e} of the largest > 1e-4")
    check(abs(float(aux_c) - float(aux_h)) <= 1e-5 * abs(float(aux_h)),
          f"qwen2-moe MoE layer: aux {float(aux_c)} vs {float(aux_h)}")
    check(same and kept_c == kept_h, "qwen2-moe MoE layer: kept assignments differ")
    holds["moe_layer"] = dict(scaled_err=err, kept=kept_c, assignments=xb * xs * k_act,
                              min_gap=gap)
    del on_card, on_cpu, out_c, r_c
    torch.cuda.empty_cache()
    launches = path["launches"]
    results["qwen2_moe"] = dict(holds=holds, prefill_s=path["prefill_s"],
                                decode_ms=path["decode_ms"], params=n_par, layer_ms=layer_ms,
                                moe_ms=moe_ms)
    # The sharded phase holds its ranks against this run's tokens and logits.
    results["moe_whole"] = dict(tokens=path["tokens"].cpu(), logits=path["logits"].cpu(),
                                step_logits=[x.cpu() for x in path["step_logits"]],
                                cache_len=cache_len, yardstick=yard)
    results["moe_straddle_whole"] = dict(
        tokens=path2["tokens"].cpu(), logits=path2["logits"].cpu(),
        step_logits=[x.cpu() for x in path2["step_logits"]], cache_len=cl2, yardstick=yard2,
        prefill_s=path2["prefill_s"], decode_ms=path2["decode_ms"], launches=path2["launches"])
    launches = {k: v + path2["launches"].get(k, 0) for k, v in launches.items()}
    del path2

    # 60b. Meshes and tp (ROADMAP item 13.6): the same weights at --mesh 1x8
    # (tp = 8), padded in place from 60 to 64 experts, the path against this
    # phase's, and layer 0's routing at the path's shape: the kept (token,
    # expert, slot) assignments equal to tp = 1's (the capacity counts only
    # the real experts), the MoE's time with the four padded experts.
    t = time.perf_counter()
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.rules import tp_size

    _pad_experts_in_place(model, tp_size(make_mesh(MOE_TP_MESH)),
                          torch.Generator(device=dev).manual_seed(SEED + 31))
    hold = _tp_serving_hold("qwen2-moe", model, prompt, MOE_TP_MESH, cache_len, path,
                            MOE_LOGITS_REL)
    with torch.inference_mode():
        layer = model.layers[0]
        hn = rms_norm(embed_tokens(model, prompt), layer.ln2, cfg.norm_eps)
        moe_tp_ms = cuda_ms(lambda: layer.moe(hn))
        r = layer.moe.routing(hn)
        kept_tp = int(r.keep.sum())
        same = all(torch.equal(a_, b_) for a_, b_ in zip((r.keep, r.expert, r.slot), routed_tp1))
    log(f"qwen2-moe --mesh {MOE_TP_MESH}: {layer.moe.n_experts} experts; layer 0 at "
        f"{LM_BATCH}x{LM_PROMPT}: kept {kept_tp} of {chosen} assignments (tp=1: {kept}), the "
        f"same (token, expert, slot) triples {same}; the MoE {moe_tp_ms:.3f} ms against "
        f"{moe_ms:.3f} ms at tp=1 ({moe_tp_ms / moe_ms:.3f}x)")
    check(same and kept_tp == kept, f"qwen2-moe --mesh {MOE_TP_MESH}: kept assignments differ "
                                    f"from tp=1 ({kept_tp} against {kept})")
    del hn, r, routed_tp1, model, path
    torch.cuda.empty_cache()
    results.setdefault("mesh_tp", {})["qwen2-moe"] = dict(
        hold, card_1x1=card1, kept=kept_tp, kept_tp1=kept, routing_equal=same,
        moe_ms=moe_tp_ms, moe_ms_tp1=moe_ms, seconds=time.perf_counter() - t + t_card1)
    return launches


def families_training_phase(dev, peaks, results: dict) -> dict:
    """Training gemma2 and qwen2-moe at full width (ROADMAP items 13.2,
    13.3): the backward kernels at hd 256 (the 'wgmma' route) against
    autograd through the plain version at the gemma2 path's shapes (1 x
    8192, window 4096 and 0, softcap 50), timed beside the scalar kernels
    they replaced, the plain version, autograd through flex_attention and an
    SDPA yardstick, before training allocates its state; then
    ``launch.train.main`` for FAMILY_TRAIN_STEPS steps on each. Returns the
    launch counts of the two training runs, by model."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (_bwd_launch, flash_attention_bwd_cuda,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_cuda, flash_bwd_route)
    from repro_torch.launch import train as ttrain
    from repro_torch.models.model import TransformerLM

    g2 = get_config(G2_ARCH)
    b, h, hkv, s, hd, cap = (G2_TRAIN_BATCH, g2.n_heads, g2.n_kv_heads, G2_TRAIN_SEQ, g2.head_dim,
                             g2.attn_softcap)
    route = flash_bwd_route(torch.bfloat16, hd)
    check(route == "wgmma", f"gemma2 training: the backward's route at hd {hd} is {route!r}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    mk = lambda *sh: torch.randn(*sh, generator=gen, device=dev).to(torch.bfloat16)

    # 61. The backward kernels at the gemma2 training shapes: held against
    # autograd through the plain version, then timed from the forward's
    # statistics (as training calls them) beside the scalar kernels they
    # replaced (the 'scalar' route, uncounted, first held against them:
    # baseline, kernel, kernel, baseline), the plain version, the library's
    # backward and the SDPA yardstick.
    q, k, v, do = mk(b, h, s, hd), mk(b, hkv, s, hd), mk(b, hkv, s, hd), mk(b, h, s, hd)
    bwd_res = {}
    for kind, window in (("global", 0), ("local", g2.sliding_window)):
        kw = dict(causal=True, window=window, softcap=cap)
        got = flash_attention_bwd_cuda(q, k, v, do, **kw)
        want = flash_attention_bwd_plain(q, k, v, do, **kw)
        torch.cuda.synchronize()
        res = {n: grad_check(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
        log(f"flash_bwd gemma2 {kind} bf16 ({route} route): B={b} H={h} Hkv={hkv} S=T={s} "
            f"hd={hd} causal window={window} softcap={cap}: " + "; ".join(
                f"{n} max_abs_err {r['max_abs_err']:.3e} ({r['scaled_err']:.2e} of the largest, "
                f"row rel L2 {r['row_rel']:.2e})" for n, r in res.items())
            + f" (limits {BWD_TOL['bfloat16']:g} of the largest, rows {BWD_ROW_TOL:g})")
        check(all(r["ok"] for r in res.values()),
              f"flash_bwd gemma2 {kind}: kernel vs plain autograd {res}")
        del got, want
        torch.cuda.empty_cache()
        _, stats = flash_attention_cuda(q, k, v, return_stats=True, **kw)
        kern = lambda: flash_attention_bwd_cuda(q, k, v, do, stats=stats, **kw)
        base = lambda: _bwd_launch("scalar", q, k, v, do, True, window, cap)
        base_res = {n: grad_check(g, w) for n, g, w in zip(("dq", "dk", "dv"), kern(), base())}
        log(f"flash_bwd gemma2 {kind}: wgmma route vs the scalar kernels: " + "; ".join(
            f"{n} {r['scaled_err']:.2e} of the largest, rows {r['row_rel']:.2e}"
            for n, r in base_res.items()))
        check(all(r["ok"] for r in base_res.values()),
              f"flash_bwd gemma2 {kind}: wgmma vs the scalar baseline {base_res}")
        torch.cuda.empty_cache()
        b1_ms, k_ms, k2_ms, b2_ms = timed_against_baseline(f"flash_bwd gemma2 {kind}", kern,
                                                            base)
        # The kernels without the softcap (not the path's function), from
        # their own forward's statistics: what the accurate tanhf costs.
        _, stats = flash_attention_cuda(q, k, v, return_stats=True, causal=True, window=window)
        nc_ms = cuda_ms(lambda: flash_attention_bwd_cuda(q, k, v, do, stats=stats, causal=True,
                                                         window=window), reps=3)
        del stats
        p_ms = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, do, **kw), reps=3)
        torch.cuda.empty_cache()
        # The library's backward: autograd through flex_attention (the
        # same function: each gradient within the kernel's elementwise limit
        # of the plain version's; its dq rows can miss the kernel's row
        # limit, by up to 4.8e-2 relative L2 at this shape on an NVIDIA H100
        # 80GB HBM3 at 700 W, so rows are printed, not held), and SDPA's
        # without the softcap.
        qx, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))
        ox = flex_library(s, window, cap, dev)(qx, kl, vl)
        lib_g = torch.autograd.grad(ox, (qx, kl, vl), do, retain_graph=True)
        want = flash_attention_bwd_plain(q, k, v, do, **kw)
        lib_res = {n: grad_check(g, w) for n, g, w in zip(("dq", "dk", "dv"), lib_g, want)}
        log(f"flex_attention backward gemma2 {kind} vs plain: " + "; ".join(
            f"{n} {r['scaled_err']:.2e} of the largest, rows {r['row_rel']:.2e}"
            for n, r in lib_res.items()))
        check(all(r["scaled_err"] <= BWD_TOL["bfloat16"] for r in lib_res.values()),
              f"flex_attention backward gemma2 {kind}: not the kernel's function {lib_res}")
        del lib_g, want
        torch.cuda.empty_cache()
        f_ms = cuda_ms(lambda: torch.autograd.grad(ox, (qx, kl, vl), do, retain_graph=True),
                       reps=3)
        del ox
        kx = k.repeat_interleave(h // hkv, 1).requires_grad_(True)
        vx = v.repeat_interleave(h // hkv, 1).requires_grad_(True)
        mask = window_mask(s, window, dev)
        ox = _sdpa_yardstick(qx, kx, vx, mask)
        l_ms = cuda_ms(lambda: torch.autograd.grad(ox, (qx, kx, vx), do, retain_graph=True),
                       reps=3)
        del qx, kl, vl, kx, vx, ox, mask
        torch.cuda.empty_cache()
        flops, nbytes = flash_bwd_work(b, h, hkv, s, hd, 2, window)
        b_ms, b_by = bound_ms(flops, nbytes, peaks, "bf16")
        log(f"flash_bwd time gemma2 {kind} (B={b} H={h} Hkv={hkv} S=T={s} hd={hd} "
            f"window={window} softcap={cap}, {route} route, from the forward's statistics): "
            f"kernel {k_ms:.3f} / {k2_ms:.3f} ms ({flops / k_ms / 1e9:.2f} TFLOP/s, "
            f"{100 * b_ms / k_ms:.2f} % of the bound, {100 * b_ms / f_ms:.2f} % for "
            f"flex_attention); the scalar kernels they replaced {b1_ms:.3f} / {b2_ms:.3f} ms "
            f"(before / after; {min(b1_ms, b2_ms) / max(k_ms, k2_ms):.1f}x the wgmma route's "
            f"time); the kernels without the softcap {nc_ms:.3f} ms; plain (autograd through "
            f"flash_attention_plain) {p_ms:.3f} ms; the backward "
            f"of flex_attention (compiled, softcap score_mod, block mask) {f_ms:.3f} ms "
            f"({f_ms / k_ms:.2f}x the kernel's time); the backward of "
            f"scaled_dot_product_attention on the same mask without the softcap (yardstick, not "
            f"the same function) {l_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by}; {flops:.3e} flop, "
            f"{nbytes:.3e} B)")
        bwd_res[kind] = dict(max_abs_err=max(r["max_abs_err"] for r in res.values()),
                             scaled_err=max(r["scaled_err"] for r in res.values()),
                             row_rel=max(r["row_rel"] for r in res.values()), ms=k_ms, ms2=k2_ms,
                             baseline_ms=[b1_ms, b2_ms], no_softcap_ms=nc_ms,
                             plain_ms=p_ms, library_ms=f_ms, sdpa_no_softcap_ms=l_ms,
                             bound_ms=b_ms, bound_by=b_by)
    del q, k, v, do
    torch.cuda.empty_cache()

    # 62. The two training paths through launch.train.main.
    out = {"kernel_bwd": bwd_res}
    counts = {}
    for arch, n_layers, bt, st in ((G2_ARCH, G2_TRAIN_LAYERS, G2_TRAIN_BATCH, G2_TRAIN_SEQ),
                                   (MOE_ARCH, MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ)):
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        n_par = sum(p.numel() for p in TransformerLM(cfg, device="meta").parameters())
        # The state is bf16 params and f32 Adam moments (10 B a parameter)
        # and the step's bf16 grads (2 B); the functional Adam update holds
        # the old and the new params and moments at once (22 B).
        reckoned, at_update = 12 * n_par, 22 * n_par
        bwd_route = flash_bwd_route(torch.bfloat16, cfg.head_dim)
        argv = ["--arch", arch, "--override", f"n_layers={n_layers}", "--batch", str(bt),
                "--seq", str(st), "--lr", str(TRAIN_LR), "--device", str(dev), "--steps",
                str(FAMILY_TRAIN_STEPS)]
        note = (f" against {reckoned / 1e9:.2f} GB reckoned for bf16 params and grads and f32 "
                f"moments, {at_update / 1e9:.2f} GB with the old and new params and moments of "
                f"the Adam update")
        state, rec, c = _train_run(
            dev, f"{arch} ({n_layers} layers at full width, {bt}x{st} tokens, "
            f"{n_par / 1e9:.3f} B parameters; backward route {bwd_route!r})",
            lambda: _main_run(ttrain, argv), FAMILY_TRAIN_STEPS, 1, n_layers, bt * st, note)
        check(rec["losses"][-1] < rec["losses"][0],
              f"lm training {arch}: loss did not fall ({rec['losses']})")
        counts[arch] = c
        out[arch] = dict(rec, reckoned_bytes=[reckoned, at_update], params=n_par)
        del state
        torch.cuda.empty_cache()
    g = bwd_res
    log(f"gemma2 training: the attention backward {G2_TRAIN_LAYERS // 2} x "
        f"{g['local']['ms']:.2f} ms (local) + {G2_TRAIN_LAYERS // 2} x {g['global']['ms']:.2f} ms "
        f"(global) = {G2_TRAIN_LAYERS / 2 * (g['local']['ms'] + g['global']['ms']) / 1e3:.3f} s "
        f"of the {out[G2_ARCH]['step_s']:.3f} s step")
    results["families_training"] = out
    return counts


def _hd80_forward(dev, peaks, cfg) -> dict:
    """The forward kernel at zamba2's shared-attention shape (LM_BATCH x
    LM_PROMPT, H = Hkv = 32, hd 80, causal, no softcap; the 'wgmma' route)
    against its plain version on random and edge queries (3e-2 per element,
    1e-2 per row in relative L2), its row statistics against the plain
    version's (as at hd 64 and 128: m exactly -1e30 on rows with no allowed
    key, within 1e-5 elsewhere; 1 / l within 1e-5 relative), and timed
    beside the 'mma' kernel it replaced (uncounted, first held against it per
    row: baseline, kernel, kernel, baseline), the plain version and
    ``scaled_dot_product_attention(is_causal=True)``, which with Hkv = H and
    no softcap computes the same function (held per element; its rows are
    printed)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (ROUTES, flash_attention_cuda,
                                                     flash_attention_plain, flash_route)
    from repro_torch.kernels.flash_attention import _launch as flash_launch

    b, h, hkv, s, hd = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, LM_PROMPT, cfg.head_dim
    route = flash_route(torch.bfloat16, hd)
    check(route == "wgmma", f"zamba2: the forward's route at hd {hd} is {route!r}")
    tol, row_tol = 3e-2, 1e-2
    gen = torch.Generator(device=dev).manual_seed(SEED + 37)
    mk = lambda *sh: torch.randn(*sh, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = mk(b, h, s, hd), mk(b, hkv, s, hd), mk(b, hkv, s, hd)
    errs = {}
    for inp in ("random", "edge"):
        qq = q if inp == "random" else flash_edge_queries(k, h, s, 0)
        want, want_st = flash_attention_plain(qq, k, v, causal=True, return_stats=True)
        got, st = flash_attention_cuda(qq, k, v, causal=True, return_stats=True)
        outs = [("kernel", got)]
        if inp == "random":
            outs.append(("sdpa", F.scaled_dot_product_attention(q, k, v, is_causal=True)))
        for who, out in outs:
            torch.cuda.synchronize()
            err = float((out.float() - want.float()).abs().max())
            bad = float(((out.float() - want.float()).abs() - tol * (1 + want.float().abs())).max())
            row = row_rel_err(out, want)
            log(f"flash zamba2 hd{hd} bf16 {inp} ({who}; {route} route): B={b} H={h} Hkv={hkv} "
                f"S=T={s} causal: max_abs_err={err:.3e} (tol {tol:g}), row rel L2 max {row:.3e} "
                f"(tol {row_tol:g})")
            check(bool(torch.isfinite(out).all()), f"flash zamba2 hd{hd} {who}: non-finite output")
            check(bad <= 0 and (who == "sdpa" or row <= row_tol),
                  f"flash zamba2 hd{hd} {inp} {who} vs plain: max_abs_err {err:.3e}, row rel L2 "
                  f"{row:.3e}")
            if who == "kernel":
                errs[inp] = (err, row)
        empty = want_st[0] == -1e30
        m_err = float((st[0][~empty] - want_st[0][~empty]).abs().max())
        l_rel = float(((st[1] - want_st[1]) / want_st[1]).abs().max())
        log(f"flash zamba2 hd{hd} {inp}: the row statistics vs plain: m max_abs_err {m_err:.3e} "
            f"(tol 1e-5 (1 + |m|)), 1 / l max rel err {l_rel:.3e} (tol 1e-5); rows with no "
            f"allowed key {int(empty.sum())}")
        check(bool((st[0][empty] == -1e30).all()) and l_rel <= 1e-5 and bool(
            ((st[0][~empty] - want_st[0][~empty]).abs()
             <= 1e-5 * (1 + want_st[0][~empty].abs())).all()),
            f"flash zamba2 hd{hd} {inp}: statistics vs plain (m {m_err:.3e}, 1 / l {l_rel:.3e})")
        del qq, want, want_st, got, st, outs, out
        torch.cuda.empty_cache()
    kern = lambda: flash_attention_cuda(q, k, v, causal=True)
    base = lambda: flash_launch(ROUTES["mma"], q, k, v, True, 0, 0.0)
    base_row = row_rel_err(kern(), base())
    log(f"flash zamba2 hd{hd}: wgmma route vs the 'mma' kernel it replaced: row rel L2 max "
        f"{base_row:.3e} (tol {row_tol:g})")
    check(base_row <= row_tol, f"flash zamba2 hd{hd}: wgmma vs the mma baseline row rel L2 "
                               f"{base_row:.3e}")
    b1_ms, k_ms, k2_ms, b2_ms = timed_against_baseline(f"flash zamba2 hd{hd}", kern, base)
    with torch.inference_mode():
        p_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True), reps=3)
    torch.cuda.empty_cache()
    l_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    flops, nbytes = flash_work(b, h, hkv, s, hd, 2)
    b_ms, b_by = bound_ms(flops, nbytes, peaks, "bf16")
    log(f"flash time zamba2 (B={b} H={h} Hkv={hkv} S=T={s} hd={hd} causal, {route} route): kernel "
        f"{k_ms:.3f} / {k2_ms:.3f} ms ({flops / k_ms / 1e9:.2f} TFLOP/s, {100 * b_ms / k_ms:.2f} % "
        f"of the bound); the 'mma' kernel it replaced {b1_ms:.3f} / {b2_ms:.3f} ms (before / "
        f"after; {min(b1_ms, b2_ms) / max(k_ms, k2_ms):.2f}x the wgmma route's time, "
        f"{100 * b_ms / min(b1_ms, b2_ms):.2f} % of the bound); plain {p_ms:.3f} ms; "
        f"scaled_dot_product_attention (the same function) {l_ms:.3f} ms ({k_ms / l_ms:.2f}x its "
        f"time); bound {b_ms:.4f} ms ({b_by}; {flops:.3e} flop, {nbytes:.3e} B)")
    del q, k, v
    torch.cuda.empty_cache()
    return dict(max_abs_err=errs["random"][0], row_rel=errs["random"][1],
                edge_max_abs_err=errs["edge"][0], ms=k_ms, ms2=k2_ms, plain_ms=p_ms,
                library_ms=l_ms, baseline_ms=[b1_ms, b2_ms], bound_ms=b_ms, bound_by=b_by,
                flops=flops)


def _bf16_holds(label: str, model, n: int, prompt, relative: bool) -> dict:
    """The first ``n`` layers of ``model`` in bf16, each prefill over the
    whole prompt (S tokens): the kernel route's logits against the same
    weights in f32 and, where the stack has attention, against the
    ``use_flash="never"`` route (3e-2 in relative L2); decode after a
    prefill of S - 1 tokens against the prefill of S. With ``relative``
    False, the kernel route within 3e-2 of f32 and the decode within 3e-2 of
    the prefill (the smoke's bf16 LM limit). With ``relative`` (zamba2,
    whose seed-initialised stack amplifies rounding, so that both bf16
    routes lie ~8e-2 from f32 on its first group), each no further from f32
    than 1.25x its plain counterpart: the kernel route than the never route
    (relative L2 and largest error), the decode than the bf16 prefill."""
    import torch

    from repro_torch.models.model import prefill_step, serve_step

    s = prompt.shape[1]
    rel = lambda x, y: float(torch.linalg.norm(x - y) / torch.linalg.norm(y))
    sub = _sub_model(model, n)
    attn = attn_applications(sub.cfg) > 0
    with torch.inference_mode():
        l_k, _ = prefill_step(sub, prompt, s + 8)
        l_32, _ = prefill_step(_sub_model(model, n, dtype=torch.float32), prompt, s + 8)
        torch.cuda.empty_cache()
        l_n = (prefill_step(_sub_model(model, n, use_flash="never"), prompt, s + 8)[0]
               if attn else None)
        _, c = prefill_step(sub, prompt[:, :s - 1], s + 8)
        dec, _ = serve_step(sub, prompt[:, s - 1:], c)
        del c
    torch.cuda.empty_cache()
    res = dict(rel_f32=rel(l_k, l_32), max_f32=float((l_k - l_32).abs().max()),
               decode_rel=rel(dec, l_k), decode_rel_f32=rel(dec, l_32))
    msg = (f"{label} ({n} layers, bf16, {prompt.shape[0]}x{s}): kernel route vs f32 weights rel L2 "
           f"{res['rel_f32']:.3e} (max {res['max_f32']:.3e}); decode after a prefill of {s - 1} vs "
           f"the prefill of {s} rel L2 {res['decode_rel']:.3e}, the decode vs f32 "
           f"{res['decode_rel_f32']:.3e}")
    if attn:
        res.update(rel_never=rel(l_k, l_n), never_rel_f32=rel(l_n, l_32),
                   never_max_f32=float((l_n - l_32).abs().max()))
        msg += (f"; use_flash=never route vs kernel route {res['rel_never']:.3e}, vs f32 "
                f"{res['never_rel_f32']:.3e} (max {res['never_max_f32']:.3e})")
    log(msg + (" (held relative to the plain counterparts, limit 1.25x)" if relative
               else " (limit 3e-2)"))
    check(bool(torch.isfinite(l_k).all()) and bool(torch.isfinite(dec).all()),
          f"{label}: non-finite logits")
    if attn:
        check(res["rel_never"] <= 3e-2, f"{label}: kernel route vs never route rel L2 "
                                        f"{res['rel_never']:.3e} > 3e-2")
    if relative:
        check(res["rel_f32"] <= 1.25 * res["never_rel_f32"]
              and res["max_f32"] <= 1.25 * res["never_max_f32"],
              f"{label}: kernel route further from f32 than 1.25x the never route ({res})")
        check(res["decode_rel_f32"] <= 1.25 * res["rel_f32"],
              f"{label}: decode further from f32 than 1.25x the prefill ({res})")
    else:
        check(res["rel_f32"] <= 3e-2 and res["decode_rel"] <= 3e-2,
              f"{label}: bf16 vs f32 or decode vs prefill beyond 3e-2 ({res})")
    return res


def _f32_depth_holds(label: str, model, prompt, logits_bf16) -> dict:
    """The whole stack in f32 (the same weights): decode after a prefill of
    S - 1 tokens against the prefill of S within 2e-3 in relative L2
    (tests/test_models_smoke.py's tolerance), and two readings of how the
    seed-initialised stack amplifies rounding: the bf16 path's prefill
    logits (``logits_bf16``) against the f32 ones, and the last hidden
    states' response to a 1e-6 relative perturbation of the embeddings of
    the first 1,024 prompt tokens."""
    import torch

    from repro_torch.models.model import embed_tokens, prefill_step, serve_step
    from repro_torch.models.transformer import prefill as stack_prefill

    b, s = prompt.shape
    rel = lambda x, y: float(torch.linalg.norm(x - y) / torch.linalg.norm(y))
    m32 = _sub_model(model, model.cfg.n_layers, dtype=torch.float32)
    cfg = m32.cfg
    with torch.inference_mode():
        f, _ = prefill_step(m32, prompt, s + 8)
        _, c = prefill_step(m32, prompt[:, :s - 1], s + 8)
        d, _ = serve_step(m32, prompt[:, s - 1:], c)
        del c
        torch.cuda.empty_cache()
        sp = min(s, 1024)
        e = embed_tokens(m32, prompt[:, :sp])
        pos = torch.arange(sp, dtype=torch.int32, device=prompt.device).expand(b, sp)
        noise = torch.randn(e.shape, generator=torch.Generator(device=prompt.device).manual_seed(
            SEED + 53), device=prompt.device) * (1e-6 * float(e.abs().mean()))
        h0 = stack_prefill(m32.layers, e, cfg, pos, sp, m32.shared_attn)[0][:, -1]
        h1 = stack_prefill(m32.layers, e + noise, cfg, pos, sp, m32.shared_attn)[0][:, -1]
    gain = rel(h1, h0) / rel(e + noise, e)
    res = dict(f32_decode_rel=rel(d, f), f32_decode_max=float((d - f).abs().max()),
               bf16_vs_f32=rel(logits_bf16, f), perturbation_gain=gain)
    log(f"{label} f32 at full depth ({cfg.n_layers} layers, {b}x{s}): decode after a prefill of "
        f"{s - 1} vs the prefill of {s} rel L2 {res['f32_decode_rel']:.3e} (limit 2e-3), max_abs_err "
        f"{res['f32_decode_max']:.3e}; readings: the bf16 path's prefill logits vs f32 rel L2 "
        f"{res['bf16_vs_f32']:.3e}; the last hidden states' response to a 1e-6 perturbation of the "
        f"embeddings (first {sp} tokens) {gain:.3g}x")
    check(bool(torch.isfinite(d).all()) and res["f32_decode_rel"] <= 2e-3,
          f"{label}: f32 decode vs prefill rel L2 {res['f32_decode_rel']:.3e} > 2e-3")
    del m32
    torch.cuda.empty_cache()
    return res


def _layer_card_vs_cpu(label: str, layer, dev) -> float:
    """One full-width layer (``layer``'s weights in f32) on the card against
    the same layer on the CPU, on the same f32 input of SSM_HOLD_SHAPE
    tokens: every output (the hidden
    states and the decode cache's pieces) within 1e-4 of its largest entry
    (cuBLAS's and the CPU's f32 sums in other orders). Returns the worst."""
    import torch

    state = {k_: v_.float() for k_, v_ in layer.state_dict().items()}
    on_card, on_cpu = (type(layer)(layer.cfg, dtype=torch.float32, device=d) for d in (dev, None))
    on_card.load_state_dict(state)
    on_cpu.load_state_dict({k_: v_.cpu() for k_, v_ in state.items()})
    xb, xs = SSM_HOLD_SHAPE
    x_cpu = torch.randn(xb, xs, layer.cfg.d_model,
                        generator=torch.Generator().manual_seed(SEED + 41))
    t = time.perf_counter()
    with torch.inference_mode():
        out_c = on_card(x_cpu.to(dev))
        torch.cuda.synchronize()
        out_h = on_cpu(x_cpu)
    errs = [float((a.cpu() - b).abs().max()) / float(b.abs().max()) for a, b in zip(out_c, out_h)]
    log(f"{label} f32, card vs CPU at {xb}x{xs} tokens ({time.perf_counter() - t:.2f} s): "
        f"outputs {[f'{e:.2e}' for e in errs]} of their largest (limit 1e-4)")
    check(all(math.isfinite(e) and e <= 1e-4 for e in errs),
          f"{label}: card vs CPU {errs} of the largest > 1e-4")
    return max(errs)


def _scan_share(label: str, layer, x, module, name: str) -> dict:
    """The chunk scan's share of one prefill layer at the path's shape:
    ``layer(x)`` and the scan function ``module.<name>`` alone on the
    arguments that layer passes it (captured once), CUDA events, median of
    5; beside the scan's host seconds to enqueue its launches (unsynchronised),
    which, near its device time, says the scan is bound by its launches."""
    import torch

    fn, args = getattr(module, name), []
    setattr(module, name, lambda *a: args.append(a) or fn(*a))
    try:
        with torch.inference_mode():
            layer(x)
    finally:
        setattr(module, name, fn)
    with torch.inference_mode():
        layer_ms = cuda_ms(lambda: layer(x))
        scan_ms = cuda_ms(lambda: fn(*args[0]))
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(*args[0])
        host_ms = 1e3 * (time.perf_counter() - t)
        torch.cuda.synchronize()
    n_chunks = args[0][0].shape[1]
    log(f"{label} prefill layer at {tuple(x.shape[:2])}: {layer_ms:.3f} ms, of which the chunk scan "
        f"({name}, {n_chunks} chunks) {scan_ms:.3f} ms ({100 * scan_ms / layer_ms:.1f} %); the "
        f"scan's host enqueue {host_ms:.3f} ms")
    del args
    return dict(layer_ms=layer_ms, scan_ms=scan_ms, scan_host_ms=host_ms, chunks=n_chunks)


def zamba2_serving_phase(dev, peaks, results: dict) -> dict:
    """zamba2-2.7b serving at full width and depth (ROADMAP item 13.4): the
    hd-80 forward kernel ('wgmma') against its plain version at the shared
    block's shape before the model is loaded; the path through the entry
    points; the model against its ``use_flash="never"`` route, its first
    group against the same weights in f32, decode after a prefill against a
    longer prefill, one mamba2 layer on the card against the CPU, and the
    SSD scan's share of a layer. Returns the launch counts of the path run."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.model import embed_tokens, init_params

    cfg = get_config(ZAMBA_ARCH)
    a, n_groups = cfg.attn_every, attn_applications(cfg)

    # 63. The hd-80 forward kernel at the path's shape.
    kern = _hd80_forward(dev, peaks, cfg)

    # 64. The path: zamba2-2.7b at full width and depth, 4 x 4096 + 32.
    t = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    cache_len = LM_PROMPT + LM_NEW
    kv_bytes = 2 * n_groups * LM_BATCH * cache_len * cfg.n_kv_heads * cfg.head_dim * 2
    st_bytes = cfg.n_layers * LM_BATCH * (cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
                                          + (cfg.ssm_conv - 1) * cfg.d_inner * 2)
    log(f"phase zamba2 init: {time.perf_counter() - t:.2f} s; {ZAMBA_ARCH} at full width and depth "
        f"(L={cfg.n_layers} mamba2 layers, d={cfg.d_model}, d_inner={cfg.d_inner}, "
        f"{cfg.ssm_heads} SSD heads of {cfg.ssm_head_dim}, N={cfg.ssm_state}; the shared block "
        f"after every {a}: {n_groups} applications, H=Hkv={cfg.n_heads}, hd={cfg.head_dim}, "
        f"d_ff={cfg.d_ff}; V={cfg.vocab}): {n_par / 1e9:.3f} B parameters, {n_bytes / 1e9:.2f} GB; "
        f"KV cache {kv_bytes / 1e9:.2f} GB, SSD and conv states {st_bytes / 1e9:.3f} GB")
    prompt = torch.as_tensor(np.random.default_rng(7).integers(0, cfg.vocab,
                                                               (LM_BATCH, LM_PROMPT)),
                             dtype=torch.int32, device=dev)
    hbm = 1e3 * (n_bytes + kv_bytes + st_bytes) / peaks["hbm"]
    path = _serve_path("zamba2", model, prompt, LM_NEW, cache_len,
                       warm_model=_sub_model(model, a), hbm_ms=hbm)
    log(f"zamba2 prefill: flash_attention launches {path['launches']['flash_attention']} on the "
        f"'wgmma' route (hd {cfg.head_dim}), {n_groups} x {kern['ms']:.3f} ms = "
        f"{n_groups * kern['ms'] / 1e3:.4f} s of the {path['prefill_s']:.3f} s prefill")

    # 65. The first group (6 mamba2 layers and the shared block) in bf16: the
    # two attention routes, f32 weights, decode against the prefill (held
    # relative to their plain counterparts: seed-initialised, the stack
    # amplifies rounding ~2,000x at full depth, so bf16 lies ~8e-2 from f32
    # on one group and ~0.9 at 54 layers; see step 67).
    holds = {"group": _bf16_holds("zamba2 first group", model, a, prompt, relative=True)}

    # 66. f32, the first group: the two routes elementwise, decode after a
    # prefill against a longer prefill (2e-3).
    holds.update(_f32_holds(f"zamba2 f32 first group ({SSM_F32_PROMPT + 1} tokens: 8 SSD chunks, "
                            f"the last ragged)", _sub_model(model, a, dtype=torch.float32), prompt,
                            SSM_F32_PROMPT))
    torch.cuda.empty_cache()

    # 67. f32, all 54 layers: decode against the prefill, and the depth's
    # amplification of rounding.
    holds["depth"] = _f32_depth_holds("zamba2", model, prompt, path["logits"])

    # 68. One mamba2 layer (layer 0's weights in f32) on the card against the
    # CPU.
    holds["layer"] = _layer_card_vs_cpu("zamba2 mamba2 layer", model.layers[0], dev)

    # 69. The SSD scan's share of one prefill layer at the path's shape.
    with torch.inference_mode():
        x = embed_tokens(model, prompt)
    share = _scan_share("zamba2", model.layers[0], x, ssm, "_ssd_chunks")
    del x, model, path["logits"]
    torch.cuda.empty_cache()
    results["zamba2"] = dict(kernel=kern, holds=holds, prefill_s=path["prefill_s"],
                             decode_ms=path["decode_ms"], hbm_ms=hbm, params=n_par, **share)
    results["flash_attention_hd80"] = kern
    return path["launches"]


def rwkv6_serving_phase(dev, peaks, results: dict) -> dict:
    """rwkv6-3b serving at full width and depth (ROADMAP item 13.5): the
    path through the entry points; the first 2 layers in bf16 against the
    same weights in f32; decode after a prefill against a longer prefill;
    one layer on the card against the CPU; the chunked time mix against its
    token-by-token decode loop on the card; the WKV scan's share of a layer.
    Returns the launch counts of the path run (no kernel: rwkv6 has no
    attention)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import rwkv6
    from repro_torch.models.model import embed_tokens, init_params

    cfg = get_config(RWKV_ARCH)

    # 70. The path: rwkv6-3b at full width and depth, 4 x 4096 + 32.
    t = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    cache_len = LM_PROMPT + LM_NEW
    st_bytes = cfg.n_layers * LM_BATCH * (cfg.n_heads * cfg.head_dim ** 2 * 4 + 2 * cfg.d_model * 2)
    log(f"phase rwkv6 init: {time.perf_counter() - t:.2f} s; {RWKV_ARCH} at full width and depth "
        f"(L={cfg.n_layers}, d={cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, "
        f"d_ff={cfg.d_ff}, V={cfg.vocab}): {n_par / 1e9:.3f} B parameters, {n_bytes / 1e9:.2f} GB; "
        f"WKV states and last tokens {st_bytes / 1e9:.3f} GB")
    prompt = torch.as_tensor(np.random.default_rng(11).integers(0, cfg.vocab,
                                                                (LM_BATCH, LM_PROMPT)),
                             dtype=torch.int32, device=dev)
    hbm = 1e3 * (n_bytes + st_bytes) / peaks["hbm"]
    path = _serve_path("rwkv6", model, prompt, LM_NEW, cache_len, warm_model=_sub_model(model, 2),
                       hbm_ms=hbm)
    check(sum(path["launches"].values()) == 0, f"rwkv6: the path launched {path['launches']}")

    # 71. The first 2 layers in bf16 against the same weights in f32 and
    # decode against the prefill (3e-2); 72. all 32 layers in f32: decode
    # against the prefill, and the depth's amplification of rounding.
    holds = {"first": _bf16_holds("rwkv6 first layers", model, 2, prompt, relative=False),
             "depth": _f32_depth_holds("rwkv6", model, prompt, path["logits"])}

    # 73. One layer (layer 0's weights in f32) on the card against the CPU.
    holds["layer"] = _layer_card_vs_cpu("rwkv6 layer", model.layers[0], dev)

    # 74. The chunked time mix against rwkv6_time_mix_decode token by token
    # on the card, layer 0 in f32 at 1 x RWKV_LOOP_TOKENS: every output and
    # the final state within 1e-4 of their largest entry.
    m = rwkv6.RWKV6(cfg, dtype=torch.float32, device=dev)
    m.load_state_dict({k_: v_.float() for k_, v_ in model.layers[0].rwkv.state_dict().items()})
    x = torch.randn(1, RWKV_LOOP_TOKENS, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED + 43))
    t = time.perf_counter()
    with torch.inference_mode():
        y, st, last = rwkv6.rwkv6_time_mix(m, x)
        state = torch.zeros_like(st)
        tok = torch.zeros_like(last)
        ys = []
        for i in range(RWKV_LOOP_TOKENS):
            yi, state, tok = rwkv6.rwkv6_time_mix_decode(m, x[:, i:i + 1], state, tok)
            ys.append(yi)
        ys = torch.cat(ys, 1)
    torch.cuda.synchronize()
    errs = [float((a_ - b_).abs().max()) / float(b_.abs().max()) for a_, b_ in ((y, ys), (st, state))]
    log(f"rwkv6 chunked time mix vs its token loop on the card (f32, 1x{RWKV_LOOP_TOKENS}, "
        f"{time.perf_counter() - t:.2f} s): outputs {errs[0]:.2e}, final state {errs[1]:.2e} of "
        f"their largest (limit 1e-4)")
    check(all(e <= 1e-4 for e in errs) and torch.equal(last, tok),
          f"rwkv6: chunked vs token loop {errs}")
    holds["token_loop"] = max(errs)
    del m, x, y, st, ys, state

    # 75. The WKV scan's share of one prefill layer at the path's shape.
    with torch.inference_mode():
        x = embed_tokens(model, prompt)
    share = _scan_share("rwkv6", model.layers[0], x, rwkv6, "_wkv_chunks")
    del x, model, path["logits"]
    torch.cuda.empty_cache()
    results["rwkv6"] = dict(holds=holds, prefill_s=path["prefill_s"], decode_ms=path["decode_ms"],
                            hbm_ms=hbm, params=n_par, **share)
    return path["launches"]


def _first_batch_loss(cfg, params, batch: int, seq: int, dev) -> float:
    """``lm_loss`` at ``params`` on the first batch ``launch.train.main``
    draws (``TokenStream(seed=17)``, batch 0): a training run's loss on the
    same tokens before and after its steps."""
    import torch

    from repro_torch.data.tokens import TokenStream
    from repro_torch.models.model import lm_loss
    from repro_torch.training.train_step import _bind

    tok, lab = TokenStream(cfg.vocab, batch, seq, seed=17).next()
    with torch.no_grad():
        return float(lm_loss(_bind(cfg, params), torch.as_tensor(tok, device=dev),
                             torch.as_tensor(lab, device=dev)))


def recurrent_training_phase(dev, peaks, results: dict) -> dict:
    """Training zamba2 and rwkv6 at full width (ROADMAP items 13.4, 13.5):
    the hd-80 backward kernels (the 'wgmma' route, fed by the forward's
    statistics) against autograd through the plain version at zamba2's
    training shape (4 x 2048, H = Hkv = 32), timed beside the 'scalar'
    kernels they replaced, the plain version and the backward of
    ``scaled_dot_product_attention`` (the same function); then ``launch.train.main`` for FAMILY_TRAIN_STEPS
    steps on each, at ZAMBA_TRAIN_LAYERS and RWKV_TRAIN_LAYERS layers.
    Returns the launch counts of the two training runs, by model."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (_bwd_launch, flash_attention_bwd_cuda,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_cuda, flash_bwd_route)
    from repro_torch.launch import train as ttrain
    from repro_torch.models.model import TransformerLM

    zc = get_config(ZAMBA_ARCH)
    b, h, hkv, s, hd = TRAIN_BATCH, zc.n_heads, zc.n_kv_heads, TRAIN_SEQ, zc.head_dim
    route = flash_bwd_route(torch.bfloat16, hd)
    check(route == "wgmma", f"zamba2 training: the backward's route at hd {hd} is {route!r}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 47)
    mk = lambda *sh: torch.randn(*sh, generator=gen, device=dev).to(torch.bfloat16)

    # 76. The backward kernels at the training shape, fed by the forward's
    # statistics (as training calls them), against autograd through the
    # plain version, then the backward of SDPA (the same function: each
    # gradient within the kernel's elementwise limit of the plain version's;
    # its rows are printed), and times: the kernels beside the 'scalar'
    # kernels they replaced (uncounted, first held against them: baseline,
    # kernel, kernel, baseline), the plain version and the SDPA backward.
    q, k, v, do = mk(b, h, s, hd), mk(b, hkv, s, hd), mk(b, hkv, s, hd), mk(b, h, s, hd)
    _, stats = flash_attention_cuda(q, k, v, causal=True, return_stats=True)
    got = flash_attention_bwd_cuda(q, k, v, do, causal=True, stats=stats)
    want = flash_attention_bwd_plain(q, k, v, do, causal=True)
    torch.cuda.synchronize()
    res = {n: grad_check(g, w) for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    qx, kx, vx = (x.detach().requires_grad_(True) for x in (q, k, v))
    ox = F.scaled_dot_product_attention(qx, kx, vx, is_causal=True)
    lib = {n: grad_check(g, w) for n, g, w in
           zip(("dq", "dk", "dv"), torch.autograd.grad(ox, (qx, kx, vx), do, retain_graph=True),
               want)}
    log(f"flash_bwd zamba2 hd{hd} bf16 ({route} route): B={b} H={h} Hkv={hkv} S=T={s} causal: "
        + "; ".join(f"{n} max_abs_err {r['max_abs_err']:.3e} ({r['scaled_err']:.2e} of the "
                    f"largest, row rel L2 {r['row_rel']:.2e})" for n, r in res.items())
        + f" (limits {BWD_TOL['bfloat16']:g} of the largest, rows {BWD_ROW_TOL:g}); the SDPA "
        f"backward vs plain: " + "; ".join(f"{n} {r['scaled_err']:.2e}, rows {r['row_rel']:.2e}"
                                            for n, r in lib.items()))
    check(all(r["ok"] for r in res.values()), f"flash_bwd zamba2 hd{hd}: kernel vs plain {res}")
    check(all(r["scaled_err"] <= BWD_TOL["bfloat16"] for r in lib.values()),
          f"SDPA backward zamba2 hd{hd}: not the kernel's function {lib}")
    del got, want
    torch.cuda.empty_cache()
    kern = lambda: flash_attention_bwd_cuda(q, k, v, do, causal=True, stats=stats)
    base = lambda: _bwd_launch("scalar", q, k, v, do, True, 0, 0.0)
    base_res = {n: grad_check(g, w) for n, g, w in zip(("dq", "dk", "dv"), kern(), base())}
    log(f"flash_bwd zamba2 hd{hd}: wgmma route vs the 'scalar' kernels it replaced: " + "; ".join(
        f"{n} {r['scaled_err']:.2e} of the largest, rows {r['row_rel']:.2e}"
        for n, r in base_res.items()))
    check(all(r["ok"] for r in base_res.values()),
          f"flash_bwd zamba2 hd{hd}: wgmma vs the scalar baseline {base_res}")
    torch.cuda.empty_cache()
    b1_ms, k_ms, k2_ms, b2_ms = timed_against_baseline(f"flash_bwd zamba2 hd{hd}", kern, base)
    p_ms = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, do, causal=True), reps=3)
    torch.cuda.empty_cache()
    l_ms = cuda_ms(lambda: torch.autograd.grad(ox, (qx, kx, vx), do, retain_graph=True))
    flops, nbytes = flash_bwd_work(b, h, hkv, s, hd, 2)
    b_ms, b_by = bound_ms(flops, nbytes, peaks, "bf16")
    log(f"flash_bwd time zamba2 (B={b} H={h} Hkv={hkv} S=T={s} hd={hd} causal, {route} route, "
        f"from the forward's statistics): kernel {k_ms:.3f} / {k2_ms:.3f} ms "
        f"({flops / k_ms / 1e9:.2f} TFLOP/s, {100 * b_ms / k_ms:.2f} % of the bound); the "
        f"'scalar' kernels it replaced {b1_ms:.3f} / {b2_ms:.3f} ms (before / after; "
        f"{min(b1_ms, b2_ms) / max(k_ms, k2_ms):.1f}x the wgmma route's time, "
        f"{100 * b_ms / min(b1_ms, b2_ms):.2f} % of the bound); plain (autograd through "
        f"flash_attention_plain) {p_ms:.3f} ms; the backward of scaled_dot_product_attention (the "
        f"same function) {l_ms:.3f} ms ({k_ms / l_ms:.2f}x its time); bound {b_ms:.4f} ms "
        f"({b_by}; {flops:.3e} flop, {nbytes:.3e} B)")
    results["flash_attention_bwd_hd80"] = dict(
        max_abs_err=max(r["max_abs_err"] for r in res.values()),
        scaled_err=max(r["scaled_err"] for r in res.values()),
        row_rel=max(r["row_rel"] for r in res.values()), ms=k_ms, ms2=k2_ms, plain_ms=p_ms,
        library_ms=l_ms, baseline_ms=[b1_ms, b2_ms], bound_ms=b_ms, bound_by=b_by)
    del q, k, v, do, stats, qx, kx, vx, ox
    torch.cuda.empty_cache()

    # 77. The two training paths through launch.train.main.
    out, counts = {}, {}
    for arch, n_layers in ((ZAMBA_ARCH, ZAMBA_TRAIN_LAYERS), (RWKV_ARCH, RWKV_TRAIN_LAYERS)):
        cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
        n_par = sum(p.numel() for p in TransformerLM(cfg, device="meta").parameters())
        full = sum(p.numel() for p in TransformerLM(get_config(arch), device="meta").parameters())
        reckoned, at_update = 12 * n_par, 22 * n_par
        n_attn = attn_applications(cfg)
        argv = ["--arch", arch, "--override", f"n_layers={n_layers}", "--batch", str(TRAIN_BATCH),
                "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR), "--device", str(dev), "--steps",
                str(FAMILY_TRAIN_STEPS)]
        note = (f" against {reckoned / 1e9:.2f} GB reckoned for bf16 params and grads and f32 "
                f"moments, {at_update / 1e9:.2f} GB with the old and new params and moments of "
                f"the Adam update ({22 * full / 1e9:.1f} GB at full depth)")
        state, rec, c = _train_run(
            dev, f"{arch} ({n_layers} layers at full width, {n_attn} shared-attention "
            f"applications, {TRAIN_BATCH}x{TRAIN_SEQ} tokens, {n_par / 1e9:.3f} B parameters)",
            lambda: _main_run(ttrain, argv), FAMILY_TRAIN_STEPS, 1, n_attn,
            TRAIN_BATCH * TRAIN_SEQ, note)
        # Each step draws new uniform random tokens, whose loss moves by
        # ~1e-2 from batch to batch, more than a step gains at lr 3e-4
        # (zamba2's per-step losses, printed above, rise over these three
        # steps); so the fall is held on the same tokens: the first batch's
        # loss after the run against its loss at the first step.
        after = _first_batch_loss(cfg, state.params, TRAIN_BATCH, TRAIN_SEQ, dev)
        log(f"lm training {arch}: the first batch's loss {rec['losses'][0]:.5f} at the first step, "
            f"{after:.5f} after {FAMILY_TRAIN_STEPS} steps")
        check(math.isfinite(after) and after < rec["losses"][0],
              f"lm training {arch}: the first batch's loss did not fall ({rec['losses'][0]} -> "
              f"{after})")
        counts[arch] = c
        out[arch] = dict(rec, reckoned_bytes=[reckoned, at_update], params=n_par,
                         first_batch_after=after)
        del state
        torch.cuda.empty_cache()
    check(sum(counts[RWKV_ARCH].values()) == 0, f"rwkv6 training launched {counts[RWKV_ARCH]}")
    results["recurrent_training"] = out
    return counts


# Per-block limits (relative to max(1, |value|); for predictions, to the
# output scale) of the f32 and bf16 variants against their plain versions on
# the same data, each set from its own readings at the fit's initial
# parameters (nugget 1e-3 of sigma2), where the f32 Cholesky of a block
# amplifies rounding by its conditioning (chip_smoke.py, NVIDIA H100 80GB
# HBM3, 700.00 W): the f32 kernel and its plain version differ by up to
# 1.24e-3 per block; the bf16 variants by up to 4.2e-4 (likelihood),
# 6.4e-4 (multi-stats) and 5.0e-4 of the scale (predict).
LADDER_TOL_F32 = 3e-3
LADDER_TOL_BF16 = 1.5e-3
# At the initial beta = 0.5 the bf16 variants' two roundings are exact (0.5
# is a bf16 number, and a bf16 x over 0.5 is one), so a variant that left
# either out would pass the limits above. The rounding checks run at a beta
# that bf16 cannot hold, where each rounding moves the result: the kernel must
# be closer (in L2 over all blocks) to its plain version than ROUND_MARGIN
# times its distance to the plain version without the beta rounding, and to
# the one without the rounding of x / beta.
ROUND_BETA = 0.37
ROUND_MARGIN = 0.5


def _no_beta_round(x, beta):
    """bf16(x / beta): the scaled coordinates without beta's rounding."""
    return (x.float() / beta.float()).to(x.dtype).float()


def _no_z_round(x, beta):
    """x / bf16(beta) in f32: the scaled coordinates left unrounded."""
    return x.float() / beta.to(x.dtype).float()


def rounding_check(name: str, run_kernel, run_plain) -> float:
    """Hold a bf16 variant to its plain version against the plain versions
    with one of the two roundings of the scaled coordinates left out (see
    ROUND_BETA). ``run_*`` return a list of tensors (or of tuples of
    tensors). Returns the ratio of the distances."""
    import contextlib

    import torch

    from repro_torch.core import vecchia
    from repro_torch.kernels import matern_cov as mc

    @contextlib.contextmanager
    def scaled_as(fn):
        old = vecchia.narrow_scaled
        vecchia.narrow_scaled = mc.narrow_scaled = fn
        try:
            yield
        finally:
            vecchia.narrow_scaled = mc.narrow_scaled = old

    def flat(outs):
        return torch.cat([t.double().reshape(-1) for o in outs
                          for t in (o if isinstance(o, tuple) else (o,))])

    got = flat(run_kernel())
    with torch.no_grad():
        want = flat(run_plain())
        with scaled_as(_no_beta_round):
            want_nb = flat(run_plain())
        with scaled_as(_no_z_round):
            want_nz = flat(run_plain())
    e, e_nb, e_nz = (float(torch.linalg.vector_norm(got - w)) for w in (want, want_nb, want_nz))
    ratio = e / max(min(e_nb, e_nz), 1e-300)
    log(f"{name} rounding check at beta {ROUND_BETA}: L2 distance of the kernel to its plain "
        f"version {e:.3e}, to it without the beta rounding {e_nb:.3e}, without the x / beta "
        f"rounding {e_nz:.3e}: ratio {ratio:.3e} (limit {ROUND_MARGIN:g})")
    check(bool(torch.isfinite(got).all()) and ratio <= ROUND_MARGIN,
          f"{name}: the kernel is not closer to its plain version than to one without a "
          f"rounding of the scaled coordinates ({e:.3e} vs {e_nb:.3e} / {e_nz:.3e})")
    return ratio


def block_rel(got, want) -> float:
    """The largest per-block error relative to max(1, |want|)."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


def cond_bound(k, nugget: float) -> float:
    """An upper bound on cond(K + nugget I) for a covariance K >= 0 with
    nonnegative entries: lambda_max <= the largest row sum (Gershgorin),
    lambda_min >= nugget."""
    return (float(k.sum(dim=-1).max()) + nugget) / nugget


def f32_cov_check(got32, plain32, exact) -> dict:
    """An f32 covariance `got32` against the exact one, beside the plain f32
    version `plain32` on the same inputs: the largest error of each, and at
    how many entries each misses 1e-5. It holds (``ok``) when the kernel's
    largest error is within 1e-5 plus twice the plain version's, at no more
    than twice as many entries beyond 1e-5; where the plain version meets
    1e-5 everywhere, that is the flat 1e-5. The two lose alike to rounding
    the coordinates and, for nearly coincident points, the distance
    |za|^2 + |zb|^2 - 2 za . zb, but round the distance in different
    orders, so they are compared as a whole and not entry by entry."""
    e_k = (got32.double() - exact).abs()
    r = dict(err=float(e_k.max()), over=int((e_k > 1e-5).sum()))
    del e_k
    e_p = (plain32.double() - exact).abs()
    r.update(plain_err=float(e_p.max()), plain_over=int((e_p > 1e-5).sum()))
    r["ok"] = r["err"] <= 1e-5 + 2 * r["plain_err"] and r["over"] <= 2 * r["plain_over"]
    return r


def exact_kl_phase(dev, peaks, results: dict) -> dict:
    """Paper Eq. 4 at Fig. 4's paper scale (n = 20,000, d = 10, bs = 10,
    m = 30; nothing cut): ``kl_divergence`` of the SBV structure (built with
    the generator's beta) and of the isotropic BV structure, through the
    kernels. Its exact half assembles the dense 20,000^2 covariance with the
    covariance kernel at B = 1 (3.2 GB in f64) and factors it with
    ``torch.linalg.cholesky_ex``; its Vecchia half is one likelihood launch.
    Held against the plain route, and the kernel timed at this shape beside
    its earlier design and the write-rate yardstick. Returns the path's
    launch counts."""
    import torch

    from repro_torch.core import KernelParams, SBVConfig, exact_gp, kl_divergence, preprocess
    from repro_torch.data.gp_sim import paper_synthetic
    from repro_torch.kernels import ops
    from repro_torch.kernels.matern_cov import _launch as cov_launch
    from repro_torch.kernels.matern_cov import matern_cov_cuda, matern_cov_plain

    n = N_EXACT
    t0 = time.perf_counter()
    x, _, true_p = paper_synthetic(SEED, n, d=D)
    beta = true_p.beta.numpy()
    zeros = np.zeros(n)
    cfg = SBVConfig(n_blocks=n // BS_EXACT, m=M_EXACT, seed=SEED)
    t1 = time.perf_counter()
    packed = {"SBV": preprocess(x, zeros, beta, cfg)[0],
              "BV": preprocess(x, zeros, np.ones(D), cfg)[0]}
    log(f"phase exact-GP data: generate {t1 - t0:.2f} s, preprocess SBV + BV "
        f"{time.perf_counter() - t1:.2f} s (n={n}, d={D}, bc={packed['SBV'].n_blocks}, "
        f"bs_max {packed['SBV'].bs_max} / {packed['BV'].bs_max}, m={M_EXACT})")

    # 26. The path: Eq. 4 for SBV and BV through the kernels, at the
    # generator's parameters with the nugget at 1e-3 (ROADMAP fault 2).
    nugget = 1e-3
    p = KernelParams.create(sigma2=1.0, beta=beta, nugget=nugget, device=dev)
    ops.reset_launch_counts()
    t = time.perf_counter()
    kl = {v: kl_divergence(p, x, pk, device=dev) for v, pk in packed.items()}
    torch.cuda.synchronize()
    t_kl = time.perf_counter() - t
    launches = ops.launch_counts()
    log(f"launches on the exact-GP/KL path (kl_divergence x 2): {launches}")
    check(launches["matern_cov"] == 2 and launches["sbv_loglik"] == 2,
          "KL path: matern_cov and sbv_loglik must launch once per exact / Vecchia evaluation")
    t = time.perf_counter()
    kl_ref = {v: kl_divergence(p, x, pk, device=dev, backend="ref") for v, pk in packed.items()}
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t
    # The two routes round K (and each block's matrices, principal
    # submatrices of K or Schur complements of them, no worse conditioned)
    # differently; the log-determinants amplify that by at most cond(K).
    xt = torch.as_tensor(x, device=dev)[None]
    k = matern_cov_cuda(xt, xt, p.beta, p.sigma2)
    cond = cond_bound(k[0], nugget)
    l0 = float(exact_gp.exact_loglik(p, x, zeros, device=dev, backend="ref"))
    for v in packed:
        tol = 10 * 2.2e-16 * cond * (2 * abs(l0) + abs(kl_ref[v]))
        log(f"KL {v} (Eq. 4, nugget {nugget:g}): kernel route {kl[v]!r}, plain route "
            f"{kl_ref[v]!r}, |diff| {abs(kl[v] - kl_ref[v]):.3e} <= {tol:.3e} (10 eps cond(K), "
            f"cond(K) <= {cond:.3e}, l_exact(0) {l0:.6f}); KL/n {kl[v] / n:.6e}")
        check(kl[v] >= 0.0, f"KL {v}: {kl[v]} < 0")
        check(abs(kl[v] - kl_ref[v]) <= tol, f"KL {v}: kernel vs plain route beyond {tol:.3e}")
    log(f"Fig. 4a at n={n}: KL SBV {kl['SBV']:.6f} vs BV {kl['BV']:.6f} "
        f"(SBV/BV {kl['SBV'] / kl['BV']:.4f}); two KLs in {t_kl:.2f} s through the kernels, "
        f"{t_ref:.2f} s on the plain route")
    # At the generator's own parameters (nugget 1e-8, K conditioned near
    # 1e11): logged, and only held to be finite.
    kl_true = {v: kl_divergence(true_p, x, pk, device=dev) for v, pk in packed.items()}
    log(f"KL at the generator's parameters (nugget 1e-8): SBV {kl_true['SBV']!r}, "
        f"BV {kl_true['BV']!r}")
    check(all(math.isfinite(v) for v in kl_true.values()), "KL at the true params: not finite")

    # 27. The kernel at the path's shape (B = 1, na = nb = 20,000) against
    # its plain version, in f64 and f32.
    want = matern_cov_plain(xt, xt, p.beta, p.sigma2)
    dif = (k - want).abs()
    err = float(dif.max())
    rel = float((dif / want.abs().clamp_min(1e-300)).max())
    del dif
    x32 = xt.float()
    c32 = f32_cov_check(matern_cov_cuda(x32, x32, p.beta, p.sigma2),
                        matern_cov_plain(x32, x32, p.beta.float(), p.sigma2.float()), want)
    del want
    log(f"matern_cov at B=1 na=nb={n} d={D}: f64 max_abs_err {err:.3e} max_rel_err {rel:.3e}; "
        f"f32 against f64: kernel max_abs_err {c32['err']:.3e} ({c32['over']} entries beyond "
        f"1e-5), plain f32 version {c32['plain_err']:.3e} ({c32['plain_over']} entries)")
    check(rel <= 1e-12, f"matern_cov B=1: f64 kernel vs plain rel err {rel:.3e} > 1e-12")
    check(c32["ok"], f"matern_cov B=1: f32 kernel worse than the plain f32 version ({c32})")
    # The Cholesky factor of the exact half (cuSOLVER through torch).
    k[0].diagonal().add_(nugget)
    chol_ms = cuda_ms(lambda: torch.linalg.cholesky_ex(k[0]), reps=3)
    del k
    torch.cuda.empty_cache()

    # 28. Times at the path's shape: the kernel beside the earlier design
    # (parent, change, change, parent), fill_ and the plain version.
    entry = {}
    for dt, isz in ((torch.float64, 8), (torch.float32, 4)):
        xd, bd, sd = xt.to(dt), p.beta.to(dt), p.sigma2.to(dt)
        tiled = lambda: matern_cov_cuda(xd, xd, bd, sd)
        rowwise = lambda: cov_launch("matern_cov_rowwise", xd, xd, bd, sd, 3.5)
        base1, k1, k2, base2 = (cuda_ms(f, inner=10) for f in (rowwise, tiled, tiled, rowwise))
        fill = cuda_ms(lambda: torch.empty(1, n, n, dtype=dt, device=dev).fill_(1.0), inner=10)
        if dt == torch.float64:
            bnd, bby, flops, nbytes = cov_bound_f64(1, n, n, D, peaks)
        else:
            flops, nbytes = cov_work(1, n, n, D, isz)
            bnd, bby = bound_ms(flops, nbytes, peaks, "f32")
        entry[str(dt)] = dict(ms=[k1, k2], baseline_ms=[base1, base2], fill_ms=fill,
                              bound_ms=bnd, bound_by=bby)
        log(f"matern_cov time at B=1 na=nb={n} d={D} {dt} (10 calls back to back per event "
            f"pair): kernel {k1:.4f}, {k2:.4f} ms; "
            f"row-wise design {base1:.4f}, {base2:.4f} ms; fill_ {fill:.4f} ms; bound "
            f"{bnd:.4f} ms ({bby}; {flops:.3e} flop, {nbytes:.3e} B); kernel at "
            f"{100 * bnd / min(k1, k2):.1f} % of the bound")
        torch.cuda.empty_cache()
    plain_ms = cuda_ms(lambda: matern_cov_plain(xt, xt, p.beta, p.sigma2), reps=3)
    log(f"exact half at n={n}: Cholesky (cholesky_ex, f64) {chol_ms:.2f} ms; covariance kernel "
        f"{min(entry['torch.float64']['ms']):.3f} ms; plain covariance {plain_ms:.2f} ms")
    e64 = entry["torch.float64"]
    results["matern_cov"].update(
        max_abs_err=err, ms=e64["ms"][0], plain_ms=plain_ms, bound_ms=e64["bound_ms"],
        bound_by=e64["bound_by"], baseline_ms=e64["baseline_ms"], fill_ms=e64["fill_ms"],
        f32=entry["torch.float32"], chol_ms=chol_ms)
    del xt
    torch.cuda.empty_cache()
    return launches


# Host structure results by function and inputs (``_memo``): main's round-0
# ``preprocess`` and, within ``shared_host_structure``, the ladder phase's.
_HOST_MEMO: dict = {}


def _memo_key(args, kw) -> tuple:
    """Arrays by the SHA-1 of their bytes, scalars by value, other objects
    (configurations, an index's block structure) by identity."""
    import hashlib

    part = lambda a: (("nd", a.shape, str(a.dtype),
                       hashlib.sha1(np.ascontiguousarray(a).view(np.uint8)).hexdigest())
                      if isinstance(a, np.ndarray) else
                      a if isinstance(a, (int, float, str, type(None))) else ("id", id(a)))
    return tuple(part(a) for a in args) + tuple((k, part(v)) for k, v in sorted(kw.items()))


def _memo(fn, name: str, copy=lambda out: out):
    """``fn`` memoized in ``_HOST_MEMO`` (``fn`` must be pure: the same
    inputs give the same outputs); ``copy`` hands each caller its own."""
    def wrapped(*args, **kw):
        key = (name,) + _memo_key(args, kw)
        if key not in _HOST_MEMO:
            _HOST_MEMO[key] = fn(*args, **kw)
        return copy(_HOST_MEMO[key])
    return wrapped


@contextlib.contextmanager
def shared_host_structure():
    """Within the block, the host structure that the fit and the
    predictions build from the same inputs is built once:
    ``core.fit.preprocess`` (main's round-0 structure at the initial beta is
    in the memo already), ``core.predict.build_train_index`` and
    ``filtered_knn_points`` are pure functions of their inputs, so each call
    is handed what it would compute (the neighbour lists as copies). The
    buckets-and-ladder phase's bf16 fit starts from main's structure, and
    its four predictions of the same points share one index and kNN."""
    from repro_torch.core import fit as tfit
    from repro_torch.core import predict as tpredict

    orig = tfit.preprocess, tpredict.build_train_index, tpredict.filtered_knn_points
    tfit.preprocess = _memo(orig[0], "preprocess")
    tpredict.build_train_index = _memo(orig[1], "index")
    tpredict.filtered_knn_points = _memo(orig[2], "knn", lambda lists: [a.copy() for a in lists])
    try:
        yield
    finally:
        tfit.preprocess, tpredict.build_train_index, tpredict.filtered_knn_points = orig
        _HOST_MEMO.clear()


def buckets_ladder_phase(dev, peaks, results: dict, packed0, packed_m, x_tr, y_tr, x_te, y_te,
                         cfg, init, init_m) -> dict:
    """Bucketed execution and the precision ladder, at the fit's initial
    parameters (at the generator's true ones f32 and bf16 are meaningless:
    ROADMAP fault 2). The bf16 variants against their plain versions, the
    bucketed layouts against the uniform ones, and the bucketed bf16 fit,
    prediction, multi-output stats and covariance through their entry
    points. Returns the bf16 variants' launches in those path runs."""
    import torch

    from repro_torch.core import buckets as bk
    from repro_torch.core import multioutput as mo
    from repro_torch.core import predict as tpredict
    from repro_torch.core import vecchia
    from repro_torch.core.fit import fit_sbv, neg_loglik_fn
    from repro_torch.core.kernels_math import KernelParams
    from repro_torch.kernels import ops
    from repro_torch.kernels.matern_cov import _launch as cov_launch
    from repro_torch.kernels.matern_cov import matern_cov_cuda, matern_cov_plain
    from repro_torch.kernels.sbv_loglik import _launch as loglik_launch
    from repro_torch.kernels.sbv_loglik import sbv_loglik_cuda, sbv_loglik_plain
    from repro_torch.kernels.sbv_multi_stats import _launch as multi_launch
    from repro_torch.kernels.sbv_multi_stats import sbv_multi_stats_cuda, sbv_multi_stats_plain
    from repro_torch.kernels.sbv_predict import _launch_panel as predict_panel
    from repro_torch.kernels.sbv_predict import (sbv_predict_cuda, sbv_predict_cuda_many,
                                                 sbv_predict_plain)

    f64, f32 = torch.float64, torch.float32
    panel = lambda *a: loglik_launch("sbv_loglik_panel", *a, nu=3.5)
    p0 = init.to(device=dev)
    par = lambda p, dt: (p.beta.to(dt), p.sigma2.to(dt), p.nugget.to(dt))
    launches = {}

    # 18. The buckets of round 0's structure.
    bucketed = bk.bucket_blocks(packed0, n_buckets=N_BUCKETS)
    occ_u = bk.loglik_work([packed0])
    log(f"buckets (n_buckets={N_BUCKETS}) of bc={packed0.n_blocks} bs_max={packed0.bs_max} "
        f"m={packed0.m}: " + ", ".join(f"(bs={pk.bs_max}, m={pk.m}, bc={pk.n_blocks})"
                                       for pk in bucketed.buckets))
    log(f"occupancy (true / padded likelihood flops): uniform {occ_u[0] / occ_u[1]:.4f}, "
        f"bucketed {bucketed.occupancy():.4f}")

    # 19. f64: the bucketed kernel likelihood against the uniform one, and
    # what padding costs in time.
    arrs_u = vecchia.packed_arrays(packed0, dev)
    arrs_b = vecchia.packed_arrays(bucketed, dev)
    ll_u = float(sbv_loglik_cuda(*par(p0, f64), *arrs_u).sum())
    ll_b = sum(float(sbv_loglik_cuda(*par(p0, f64), *a).sum()) for a in arrs_b)
    rel = abs(ll_b - ll_u) / abs(ll_u)
    tb1 = cuda_ms(lambda: [panel(*par(p0, f64), *a) for a in arrs_b])
    t_u = cuda_ms(lambda: sbv_loglik_cuda(*par(p0, f64), *arrs_u))
    t_b = cuda_ms(lambda: [sbv_loglik_cuda(*par(p0, f64), *a) for a in arrs_b])
    t_each = [cuda_ms(lambda a=a: sbv_loglik_cuda(*par(p0, f64), *a)) for a in arrs_b]
    tb2 = cuda_ms(lambda: [panel(*par(p0, f64), *a) for a in arrs_b])
    tr_old = sum(block_traffic(pk)[0] for pk in bucketed.buckets)
    tr_new = sum(block_traffic(pk)[1] for pk in bucketed.buckets)
    log(f"f64 loglik bucketed {ll_b:.12e} uniform {ll_u:.12e}: rel {rel:.3e}; kernel time "
        f"uniform {t_u:.3f} ms, bucketed {t_b:.3f} ms (per bucket "
        f"{', '.join(f'{t:.3f}' for t in t_each)} ms); panel_cholesky baseline bucketed "
        f"{tb1:.3f} / {tb2:.3f} ms (before / after); reckoned scratch traffic over the buckets: "
        f"baseline {tr_old / 1e9:.2f} GB, tiled {tr_new / 1e9:.2f} GB")
    check(rel <= 1e-10, f"bucketed f64 loglik vs uniform rel {rel:.3e} > 1e-10")
    results["buckets"] = dict(uniform_ms=t_u, bucketed_ms=t_b, baseline_bucketed_ms=[tb1, tb2])

    # 20. Per bucket, the bf16 and f32 variants against their plain
    # versions, and each tier's total against f64 beside its budget.
    err16, k16_ms, pl16_ms, fl16, by16 = 0.0, 0.0, 0.0, 0.0, 0.0
    for i, (pk, a64) in enumerate(zip(bucketed.buckets, arrs_b)):
        a16 = vecchia.packed_arrays(bk.cast_packed(pk, "bf16"), dev)
        a32 = vecchia.packed_arrays(bk.cast_packed(pk, "f32"), dev)
        want64 = float(sbv_loglik_cuda(*par(p0, f64), *a64).sum())
        g16, g32 = (sbv_loglik_cuda(*par(p0, f32), *a) for a in (a16, a32))
        with torch.no_grad():
            w16, w32 = (sbv_loglik_plain(*par(p0, f32), *a) for a in (a16, a32))
        torch.cuda.synchronize()
        r16, r32 = block_rel(g16, w16), block_rel(g32, w32)
        t16, t32 = (abs(float(g.double().sum()) - want64) / max(1.0, abs(want64))
                    for g in (g16, g32))
        k_ms = cuda_ms(lambda: sbv_loglik_cuda(*par(p0, f32), *a16))
        with torch.no_grad():
            p_ms = cuda_ms(lambda: sbv_loglik_plain(*par(p0, f32), *a16), reps=1)
        fl, by = loglik_work(pk, xb=2, wb=4)
        log(f"bucket {i} (bs={pk.bs_max}, m={pk.m}, bc={pk.n_blocks}): kernel vs plain per-block "
            f"max rel bf16 {r16:.3e} (limit {LADDER_TOL_BF16:g}), f32 {r32:.3e} (limit "
            f"{LADDER_TOL_F32:g}); total vs f64 bf16 "
            f"{t16:.3e} (budget {bk._TIER_BUDGETS['bf16']:g}), f32 {t32:.3e} (budget "
            f"{bk._TIER_BUDGETS['f32']:g}); bf16 kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
        check(bool(torch.isfinite(g16).all() and torch.isfinite(g32).all()),
              f"bucket {i}: non-finite bf16/f32 kernel output")
        check(r16 <= LADDER_TOL_BF16 and r32 <= LADDER_TOL_F32,
              f"bucket {i}: kernel vs plain per-block rel bf16 {r16:.3e} / f32 {r32:.3e} "
              f"> {LADDER_TOL_BF16:g} / {LADDER_TOL_F32:g}")
        err16 = max(err16, float((g16.double() - w16.double()).abs().max()))
        k16_ms, pl16_ms, fl16, by16 = k16_ms + k_ms, pl16_ms + p_ms, fl16 + fl, by16 + by
        del a16, a32, g16, g32, w16, w32
    torch.cuda.empty_cache()
    b_ms, b_by = bound_ms(fl16, by16, peaks, "f32")
    a16u = vecchia.packed_arrays(bk.cast_packed(packed0, "bf16"), dev)
    k16u_ms = cuda_ms(lambda: sbv_loglik_cuda(*par(p0, f32), *a16u))
    del a16u
    a16b = [vecchia.packed_arrays(bk.cast_packed(pk, "bf16"), dev) for pk in bucketed.buckets]
    k16b_ms = cuda_ms(lambda: [sbv_loglik_cuda(*par(p0, f32), *a) for a in a16b])
    base16_ms = cuda_ms(lambda: [panel(*par(p0, f32), *a) for a in a16b])
    del a16b
    log(f"loglik bf16 variant: {k16_ms:.3f} ms over the {bucketed.n_buckets} buckets, one by one "
        f"({k16b_ms:.3f} ms back to back; panel_cholesky baseline {base16_ms:.3f} ms; uniform "
        f"shape: {k16u_ms:.3f} ms); plain {pl16_ms:.1f} ms; bound {b_ms:.4f} ms ({b_by}, f32 "
        f"peak; {fl16:.3e} flop, {by16:.3e} B)")
    results["sbv_loglik_bf16"] = dict(max_abs_err=err16, ms=k16_ms, plain_ms=pl16_ms,
                                      bound_ms=b_ms, bound_by=b_by, uniform_ms=k16u_ms,
                                      baseline_ms=[base16_ms])
    # The rounding check (see ROUND_BETA) on the same buckets.
    d = x_tr.shape[1]
    pr = par(KernelParams.create(sigma2=float(init.sigma2), beta=ROUND_BETA,
                                 nugget=float(init.nugget), d=d, device=dev), f32)
    a16s = [vecchia.packed_arrays(bk.cast_packed(pk, "bf16"), dev) for pk in bucketed.buckets]
    rounding_check("sbv_loglik_bf16", lambda: [sbv_loglik_cuda(*pr, *a) for a in a16s],
                   lambda: [sbv_loglik_plain(*pr, *a) for a in a16s])
    del a16s

    # 21. The tiers the probe gives through the kernel route.
    tiers = bk.assign_precision(p0, bucketed, bk.PrecisionPolicy("bf16"), backend="auto")
    log(f"assign_precision(PrecisionPolicy('bf16')) through the kernel route: {tiers}")

    # 22. The bucketed bf16 fit through the entry point; within the block the
    # host structure is main's round-0 one and the four predictions share one
    # index and kNN (``shared_host_structure``), so their seconds leave out
    # building it.
    with shared_host_structure():
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fit = fit_sbv(x_tr, y_tr, cfg, init=init, n_buckets=N_BUCKETS, precision="bf16",
                      outer_rounds=1, inner_steps=3, device=dev)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t
        fit_launches = ops.launch_counts()
        launches["sbv_loglik_bf16"] = fit_launches["sbv_loglik_bf16"]
        losses = [h[2] for h in fit.history]
        loss_fn = neg_loglik_fn(fit.packed, 3.5, "auto", device=dev)
        lv = [t_.clone().requires_grad_(True) for t_ in p0]
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.autograd.grad(loss_fn(KernelParams(*lv)), lv)
        torch.cuda.synchronize()
        t_step = time.perf_counter() - t
        log(f"phase bucketed bf16 fit: {t_fit:.2f} s (1 round x 3 steps, probe included; the host "
            f"structure not built here: main's round-0 one, the same inputs); tiers "
            f"{fit.precision_tiers}; one step {t_step:.3f} s; losses {losses}; launches "
            f"{fit_launches}")
        check(len(losses) == 3 and all(math.isfinite(v) for v in losses)
              and losses[-1] <= losses[0],
              f"bucketed bf16 fit: losses {losses}")
        del fit, loss_fn

        # A step at full width on every bucket cast to bf16 (the probe above
        # keeps f64 at these parameters): the bf16 forward through the kernel and
        # the gradient, which is the f64 plain version's on the bf16-stored data
        # (ROADMAP fault 3), held against that version differentiated directly.
        cast = bk.apply_precision(bucketed, "bf16")
        loss16 = neg_loglik_fn(cast, 3.5, "auto", device=dev)
        lv = [t_.clone().requires_grad_(True) for t_ in p0]
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        val16 = loss16(KernelParams(*lv))
        g16 = torch.autograd.grad(val16, lv)
        val16 = float(val16.detach())
        torch.cuda.synchronize()
        t_step16 = time.perf_counter() - t
        step_launches = ops.launch_counts()
        launches["sbv_loglik_bf16"] += step_launches["sbv_loglik_bf16"]
        del loss16
        wide = lambda a: a.double() if a.is_floating_point() else a
        lv64 = [t_.clone().requires_grad_(True) for t_ in p0]
        g_ref, val_ref = [torch.zeros_like(t_) for t_ in p0], 0.0
        # The kernel route's loss is f32, so its cotangent is -1/n rounded to f32.
        cot = float(torch.ones((), dtype=f32) / -cast.n_points)
        for pk, arrs in zip(cast.buckets, vecchia.packed_arrays(cast, dev)):
            ll = vecchia.packed_loglik(KernelParams(*lv64), pk, backend="ref",
                                       arrays=tuple(wide(a) for a in arrs)) * cot
            for acc, gi in zip(g_ref, torch.autograd.grad(ll, lv64)):
                acc += gi
            val_ref += float(ll.detach())
            del ll
        g_err = max(float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
                    for a, b in zip(g16, g_ref))
        log(f"bf16 step on the bf16-cast buckets: {t_step16:.3f} s (forward + backward); loss "
            f"{val16:.10f} (f64 plain, no pivot floor: {val_ref:.10f}); gradient vs the f64 "
            f"plain version max rel {g_err:.3e}; launches {step_launches}")
        check(math.isfinite(val16) and all(bool(torch.isfinite(g).all()) for g in g16),
              "bf16 step: non-finite loss or gradient")
        check(step_launches["sbv_loglik_bf16"] == cast.n_buckets and
              step_launches["sbv_loglik"] == 0,
              f"bf16 step launches {step_launches}, expected one bf16 launch per bucket")
        check(g_err <= 1e-10,
              f"bf16 step: gradient vs the f64 plain version rel {g_err:.3e} > 1e-10")
        del cast, g16, g_ref
        torch.cuda.empty_cache()

        # 23. Prediction: bucketed f64 against uniform, bf16 against f64, on the
        # first N_LADDER_TEST held-out points.
        kw = dict(bs_pred=BS_PRED, m_pred=M_PRED, n_sims=N_SIMS, chunk_size=CHUNK, seed=SEED,
                  device=dev)
        x_lt, y_lt = x_te[:N_LADDER_TEST], y_te[:N_LADDER_TEST]
        t = time.perf_counter()
        pred_u = tpredict.predict_sbv(init, x_tr, y_tr, x_lt, **kw)
        t_pu = time.perf_counter() - t
        t = time.perf_counter()
        pred_b = tpredict.predict_sbv(init, x_tr, y_tr, x_lt, n_buckets=N_BUCKETS, **kw)
        t_pb = time.perf_counter() - t
        ops.reset_launch_counts()
        t = time.perf_counter()
        pred_16 = tpredict.predict_sbv(init, x_tr, y_tr, x_lt, n_buckets=N_BUCKETS, precision="bf16",
                                       **kw)
        torch.cuda.synchronize()
        t_p16 = time.perf_counter() - t
        pred_launches = ops.launch_counts()
        launches["sbv_predict_bf16"] = pred_launches["sbv_predict_bf16"]
        n_chunks = math.ceil(len(x_lt) / CHUNK)
        check(pred_launches["sbv_predict_bf16"] == n_chunks and pred_launches["sbv_predict"] == 0,
              f"bucketed bf16 predict launches {pred_launches}, expected one bf16 launch per chunk "
              f"({n_chunks})")
        # The reference's bf16 prediction test (tests/test_buckets.py:452-476)
        # runs its ``ref`` route: the bf16 coordinates' rounding alone. Here too,
        # on the plain version (not a kernel path; its launches are not counted).
        t = time.perf_counter()
        pred_r = tpredict.predict_sbv(init, x_tr, y_tr, x_lt, n_buckets=N_BUCKETS, precision="bf16",
                                      backend="ref", **kw)
        t_pr = time.perf_counter() - t
    scale = max(1.0, float(np.abs(pred_u.mean).max()))
    d_mean = float(np.abs(pred_b.mean - pred_u.mean).max())
    d_var = float(np.abs(pred_b.var - pred_u.var).max())
    rms = [float(np.sqrt(np.mean((p.mean - pred_u.mean) ** 2)) / np.sqrt(np.mean(pred_u.mean ** 2)))
           for p in (pred_16, pred_r)]
    mspe = [float(np.mean((p.mean - y_lt) ** 2)) for p in (pred_u, pred_16, pred_r)]
    log(f"phase bucketed predict at the initial params ({len(x_lt)} points in {n_chunks} chunks; "
        f"the three after the first reuse its host index and kNN): uniform {t_pu:.2f} s, "
        f"bucketed f64 "
        f"{t_pb:.2f} s, bucketed bf16 {t_p16:.2f} s (ref route {t_pr:.2f} s); bucketed vs "
        f"uniform max |d mean| {d_mean:.3e}, |d var| {d_var:.3e}; bf16 vs f64 relative RMS: "
        f"kernel route {rms[0]:.4f} (printed: its pivot floor 2^-7 * sigma2 = "
        f"{float(init.sigma2) / 128:.3g} is above the nugget {float(init.nugget):.3g}, so K(NN, NN) "
        f"pivots are clamped; ROADMAP fault 4), ref route {rms[1]:.4f}; MSPE f64 {mspe[0]:.5f}, "
        f"bf16 kernel route {mspe[1]:.5f}, ref route {mspe[2]:.5f}; launches of the bf16 run "
        f"{pred_launches}")
    check(d_mean <= 1e-10 * scale and d_var <= 1e-10 * scale,
          f"bucketed predict vs uniform: {d_mean:.3e} / {d_var:.3e} > 1e-10 x {scale:.3g}")
    check(all(bool(np.isfinite(p.mean).all() and (p.var > 0).all()) for p in (pred_16, pred_r)),
          "bf16 predict: non-finite mean or non-positive variance")
    check(rms[1] < 0.1, f"bf16 predict (ref route) vs f64 relative RMS {rms[1]:.4f} >= 0.1")
    del pred_u, pred_b, pred_16, pred_r

    # The predict variant against its plain version on the first chunk's
    # buckets, at the f32 accumulation width the bf16 path packs at.
    index = tpredict.build_train_index(x_tr, y_tr, init.beta.numpy(), M_PRED, seed=SEED)
    _, chunk = next(tpredict.iter_query_chunks(index, x_te, BS_PRED, M_PRED, seed=SEED,
                                               chunk_size=CHUNK, dtype=np.float32))
    pieces = bk.bucket_prediction(chunk, n_buckets=N_BUCKETS).buckets
    ac_u = tuple(torch.as_tensor(a).to(dev).double() for a in chunk.arrays())
    ac_b = [tuple(torch.as_tensor(a).to(dev).double() for a in pc.arrays()) for pc in pieces]
    tp_u = cuda_ms(lambda: sbv_predict_cuda(*par(p0, f64), *ac_u))
    tp_b = cuda_ms(lambda: sbv_predict_cuda_many(*par(p0, f64), ac_b))
    tp_each = cuda_ms(lambda: [sbv_predict_cuda(*par(p0, f64), *a) for a in ac_b])
    occ_pu = bk.prediction_work([chunk])
    log(f"predict chunk 0 buckets: " + ", ".join(f"(bs={pc.bs_pred}, m={pc.m_pred}, "
                                                 f"bc={pc.n_blocks})" for pc in pieces)
        + f"; occupancy uniform {occ_pu[0] / occ_pu[1]:.4f}, bucketed "
        f"{bk.BucketedPrediction(pieces, []).occupancy():.4f}; f64 kernel time uniform "
        f"{tp_u:.3f} ms, bucketed in one launch {tp_b:.3f} ms (one launch per bucket "
        f"{tp_each:.3f} ms)")
    results["buckets"].update(predict_uniform_ms=tp_u, predict_bucketed_ms=tp_b,
                              predict_per_bucket_ms=tp_each)
    del ac_u, ac_b
    # The bf16 variant over the chunk's buckets in one launch, each piece
    # against its plain version at the f32 accumulation width.
    a16 = [tuple(torch.as_tensor(a).to(dev) for a in bk.cast_prediction(pc, "bf16").arrays())
           for pc in pieces]
    outs = sbv_predict_cuda_many(*par(p0, f32), a16)
    perr, pp_ms, pfl, pby = 0.0, 0.0, 0.0, 0.0
    for i, (pc, arrs, got) in enumerate(zip(pieces, a16, outs)):
        if pc.n_queries == 0:  # the chunk's padding blocks (no query), bucketed together
            continue
        want = sbv_predict_plain(*par(p0, f32), *arrs)
        torch.cuda.synchronize()
        msk = arrs[1]
        sc = max(1.0, max(float(w[msk].abs().max()) for w in want))
        err = max(float((g - w)[msk].abs().max()) for g, w in zip(got, want))
        p_ms = cuda_ms(lambda: sbv_predict_plain(*par(p0, f32), *arrs), reps=1)
        fl, by = predict_work(pc, xb=2, wb=4)
        log(f"predict bucket {i} (bs={pc.bs_pred}, m={pc.m_pred}, bc={pc.n_blocks}): bf16 kernel "
            f"vs plain max abs err {err:.3e} (|out| max {sc:.3g}); plain {p_ms:.1f} ms")
        check(all(bool(torch.isfinite(g).all()) for g in got), "predict bf16: non-finite output")
        check(err <= LADDER_TOL_BF16 * sc, f"predict bf16 bucket {i}: kernel vs plain {err:.3e} "
                                           f"> {LADDER_TOL_BF16:g} x {sc:.3g}")
        perr, pp_ms, pfl, pby = max(perr, err), pp_ms + p_ms, pfl + fl, pby + by
    base16 = lambda: [predict_panel(*par(p0, f32), *a) for a in a16]
    pbase1_ms = cuda_ms(base16)
    pk_ms = cuda_ms(lambda: sbv_predict_cuda_many(*par(p0, f32), a16))
    pbase2_ms = cuda_ms(base16)
    pb_ms, pb_by = bound_ms(pfl, pby, peaks, "f32")
    log(f"predict bf16 variant: {pk_ms:.3f} ms over one chunk's {len(a16)} buckets in one launch "
        f"(panel_cholesky baseline, one launch per bucket: {pbase1_ms:.3f} / {pbase2_ms:.3f} ms "
        f"before / after); plain {pp_ms:.1f} ms; bound {pb_ms:.4f} ms ({pb_by}; {pfl:.3e} flop, "
        f"{pby:.3e} B)")
    results["sbv_predict_bf16"] = dict(max_abs_err=perr, ms=pk_ms, plain_ms=pp_ms, bound_ms=pb_ms,
                                       bound_by=pb_by, baseline_ms=[pbase1_ms, pbase2_ms])
    p16s = [a for pc, a in zip(pieces, a16) if pc.n_queries]
    rounding_check("sbv_predict_bf16", lambda: sbv_predict_cuda_many(*pr, p16s),
                   lambda: [sbv_predict_plain(*pr, *a) for a in p16s])
    del a16, outs, p16s

    # 24. Multi-output: bucketed f64 stats against uniform; the bf16
    # variant per bucket against its plain version; the bf16 stats path.
    pm0 = init_m.to(device=dev)
    s0 = pm0.structure_params()
    bucketed_m = bk.bucket_blocks(packed_m, n_buckets=N_BUCKETS)
    with torch.no_grad():
        ld_u, q_u = mo.packed_multi_stats(pm0, packed_m)
        ld_b, q_b = mo.packed_multi_stats(pm0, bucketed_m)
    mrel = max(abs(float(ld_b - ld_u)) / abs(float(ld_u)),
               float(((q_b - q_u).abs() / q_u.abs()).max()))
    am_u = vecchia.packed_arrays(packed_m, dev)
    am_b = vecchia.packed_arrays(bucketed_m, dev)
    tm_u = cuda_ms(lambda: sbv_multi_stats_cuda(*par(s0, f64), *am_u))
    tm_b = cuda_ms(lambda: [sbv_multi_stats_cuda(*par(s0, f64), *a) for a in am_b])
    occ_mu = bk.loglik_work([packed_m])
    log(f"multi buckets: " + ", ".join(f"(bs={pk.bs_max}, m={pk.m}, bc={pk.n_blocks})"
                                       for pk in bucketed_m.buckets)
        + f"; occupancy uniform {occ_mu[0] / occ_mu[1]:.4f}, bucketed "
        f"{bucketed_m.occupancy():.4f}; f64 bucketed vs uniform max rel {mrel:.3e}; f64 kernel "
        f"time uniform {tm_u:.3f} ms, bucketed {tm_b:.3f} ms")
    results["buckets"].update(multi_uniform_ms=tm_u, multi_bucketed_ms=tm_b)
    del am_u, am_b
    check(mrel <= 1e-10, f"bucketed f64 multi stats vs uniform rel {mrel:.3e} > 1e-10")
    m16b = [vecchia.packed_arrays(bk.cast_packed(pk, "bf16"), dev) for pk in bucketed_m.buckets]
    panel16 = lambda: [multi_launch("sbv_multi_stats_panel", *par(s0, f32), *a, nu=3.5)
                       for a in m16b]
    mbase1_ms = cuda_ms(panel16)
    mk16b_ms = cuda_ms(lambda: [sbv_multi_stats_cuda(*par(s0, f32), *a) for a in m16b])
    mbase2_ms = cuda_ms(panel16)
    del m16b
    merr, mk_ms, mp_ms, mfl, mby = 0.0, 0.0, 0.0, 0.0, 0.0
    for i, pk in enumerate(bucketed_m.buckets):
        a16 = vecchia.packed_arrays(bk.cast_packed(pk, "bf16"), dev)
        got = sbv_multi_stats_cuda(*par(s0, f32), *a16)
        with torch.no_grad():
            want = sbv_multi_stats_plain(*par(s0, f32), *a16)
        torch.cuda.synchronize()
        r = block_rel(got, want)
        k_ms = cuda_ms(lambda: sbv_multi_stats_cuda(*par(s0, f32), *a16))
        with torch.no_grad():
            p_ms = cuda_ms(lambda: sbv_multi_stats_plain(*par(s0, f32), *a16), reps=1)
        fl, by = multi_work(pk, xb=2, wb=4)
        log(f"multi bucket {i}: bf16 kernel vs plain per-block max rel {r:.3e}; kernel "
            f"{k_ms:.3f} ms, plain {p_ms:.1f} ms")
        check(bool(torch.isfinite(got).all()), "multi bf16: non-finite output")
        check(r <= LADDER_TOL_BF16, f"multi bf16 bucket {i}: kernel vs plain rel {r:.3e} > "
                                    f"{LADDER_TOL_BF16:g}")
        merr = max(merr, float((got.double() - want.double()).abs().max()))
        mk_ms, mp_ms, mfl, mby = mk_ms + k_ms, mp_ms + p_ms, mfl + fl, mby + by
        del a16, got, want
    mb_ms, mb_by = bound_ms(mfl, mby, peaks, "f32")
    sr = par(KernelParams.create(sigma2=1.0, beta=ROUND_BETA, nugget=float(pm0.tau2), d=d,
                                 device=dev), f32)
    m16s = [vecchia.packed_arrays(bk.cast_packed(pk, "bf16"), dev) for pk in bucketed_m.buckets]
    rounding_check("sbv_multi_stats_bf16", lambda: [sbv_multi_stats_cuda(*sr, *a) for a in m16s],
                   lambda: [sbv_multi_stats_plain(*sr, *a) for a in m16s])
    del m16s
    cast_m = bk.apply_precision(bucketed_m, "bf16")
    ops.reset_launch_counts()
    with torch.no_grad():
        ld16, q16 = mo.packed_multi_stats(pm0, cast_m)
    torch.cuda.synchronize()
    multi_launches = ops.launch_counts()
    launches["sbv_multi_stats_bf16"] = multi_launches["sbv_multi_stats_bf16"]
    q_gap = float(((q16.double() - q_u).abs() / q_u.abs()).max())
    log(f"multi_stats bf16 variant: {mk_ms:.3f} ms over the buckets, one by one "
        f"({mk16b_ms:.3f} ms back to back; panel_cholesky baseline {mbase1_ms:.3f} / "
        f"{mbase2_ms:.3f} ms before / after); plain {mp_ms:.1f} ms; "
        f"bound {mb_ms:.4f} ms ({mb_by}); bf16 path vs f64: logdet0 rel "
        f"{abs(float(ld16) - float(ld_u)) / abs(float(ld_u)):.3e}, q max rel {q_gap:.3e} "
        f"(printed: the unit-variance pivot floor 2^-7 against tau2 "
        f"{float(pm0.tau2):.3g}, ROADMAP fault 4); launches {multi_launches}")
    results["sbv_multi_stats_bf16"] = dict(max_abs_err=merr, ms=mk_ms, plain_ms=mp_ms,
                                           bound_ms=mb_ms, bound_by=mb_by,
                                           baseline_ms=[mbase1_ms, mbase2_ms])
    del cast_m
    torch.cuda.empty_cache()

    # 25. The covariance's bf16 variant on the 256 joint blocks, through its
    # entry point.
    full_m = slice_blocks(packed_m, packed_m.bs_max, M_FIT, 256)
    xj = torch.as_tensor(np.concatenate([full_m.nn_x, full_m.blk_x], axis=1),
                         device=dev).bfloat16()
    kp = KernelParams.create(sigma2=1.0, beta=0.5, nugget=1e-3, d=xj.shape[2], device=dev)
    want = matern_cov_plain(xj, xj, kp.beta.float(), kp.sigma2.float())
    ops.reset_launch_counts()
    cov = ops.matern_cov(xj, xj, kp)
    torch.cuda.synchronize()
    launches["matern_cov_bf16"] = ops.launch_counts()["matern_cov_bf16"]
    cerr = float((cov - want).abs().max())
    # Beside the earlier (row-wise) design (parent, change, change, parent)
    # and fill_ of the same f32 output bytes.
    from repro_torch.kernels.matern_cov import _launch as cov_launch

    tiled = lambda: matern_cov_cuda(xj, xj, kp.beta, kp.sigma2)
    rowwise = lambda: cov_launch("matern_cov_rowwise", xj, xj, kp.beta.float(),
                                 kp.sigma2.float(), 3.5)
    cbase1_ms, ck_ms, ck2_ms, cbase2_ms = (cuda_ms(f, inner=10)
                                           for f in (rowwise, tiled, tiled, rowwise))
    cp_ms = cuda_ms(lambda: matern_cov_plain(xj, xj, kp.beta.float(), kp.sigma2.float()), reps=3)
    b_, na, d_ = xj.shape
    cfill_ms = cuda_ms(lambda: torch.empty(b_, na, na, dtype=torch.float32,
                                           device=dev).fill_(1.0), inner=10)
    cfl = float(b_ * na * na * (2 * d_ + 15))
    cby = float(2 * b_ * 2 * na * d_ + 4 * b_ * na * na)
    cb_ms, cb_by = bound_ms(cfl, cby, peaks, "f32")
    log(f"matern_cov bf16 variant at B={b_} na=nb={na} d={d_} (10 calls back to back per "
        f"event pair): f32 output {cov.dtype}, kernel "
        f"vs plain max_abs_err {cerr:.3e}; kernel {ck_ms:.4f}, {ck2_ms:.4f} ms, row-wise design "
        f"{cbase1_ms:.4f}, {cbase2_ms:.4f} ms, fill_ {cfill_ms:.4f} ms, plain {cp_ms:.3f} ms, "
        f"bound {cb_ms:.4f} ms ({cb_by}; kernel at {100 * cb_ms / min(ck_ms, ck2_ms):.1f} %); "
        f"launches {launches['matern_cov_bf16']}")
    check(cov.dtype == torch.float32 and bool(torch.isfinite(cov).all()) and cerr <= 1e-5,
          f"matern_cov bf16: dtype {cov.dtype}, err {cerr:.3e} > 1e-5")
    results["matern_cov_bf16"] = dict(max_abs_err=cerr, ms=ck_ms, plain_ms=cp_ms, bound_ms=cb_ms,
                                      bound_by=cb_by, baseline_ms=[cbase1_ms, cbase2_ms],
                                      fill_ms=cfill_ms)
    kr = KernelParams.create(sigma2=1.0, beta=ROUND_BETA, d=d_, device=dev)
    rounding_check("matern_cov_bf16", lambda: [matern_cov_cuda(xj, xj, kr.beta, kr.sigma2)],
                   lambda: [matern_cov_plain(xj, xj, kr.beta.float(), kr.sigma2.float())])
    del xj, cov, want
    torch.cuda.empty_cache()
    log(f"launches on the buckets-and-ladder paths: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} launched no time on its path")
    return launches


def trace_step(fn, path: str) -> dict:
    """Run ``fn`` once under ``torch.profiler`` (host and device) and read
    the chrome trace at ``path``: kernels and host launches, the kernels'
    busy time (the union of their intervals), the host-to-device copies and
    how much of them overlapped a kernel, and the span from the first to the
    last device event."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    prof.export_chrome_trace(path)
    with open(path) as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    os.remove(path)
    ker = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev if e.get("cat") == "kernel")
    h2d = [(e["ts"], e["ts"] + e["dur"]) for e in ev
           if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    busy = []
    for a, b in ker:
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    ends = [t for iv in ker + h2d for t in iv]
    overlap = sum(max(0.0, min(b, y) - max(a, x)) for a, b in h2d for x, y in busy)
    return dict(kernels=len(ker),
                launches=sum(1 for e in ev if e.get("name") == "cudaLaunchKernel"),
                kernel_busy_s=sum(b - a for a, b in busy) / 1e6,
                span_s=(max(ends) - min(ends)) / 1e6 if ends else 0.0,
                h2d=len(h2d), h2d_s=sum(b - a for a, b in h2d) / 1e6, h2d_overlap_s=overlap / 1e6)


def grad_gap(got, want) -> float:
    """Largest per-leaf gap of two gradients, relative to the leaf's scale."""
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
               for a, b in zip(got, want))


def streaming_phase(dev, results: dict, x_tr, y_tr, x_te, y_te, xm_tr, ym_tr, cfg, init,
                    true_p, t_step_incore: float, store_dir: str) -> dict:
    """The out-of-core path: the training set in an on-disk ``ArrayStore``
    at ``store_dir`` (kept for the distributed phase), the streaming
    structure, the spool's tiers held bitwise against each other, one piece
    against many, ``fit_sbv(store, None, ...)`` with its device memory and
    host RSS beside their models, the multi-output streaming fit at
    p = 32, and the store-backed prediction. Returns the launches of its
    three path runs (the fits and the prediction); ``results['streaming']``
    keeps the fit's history and device cache for the distributed phase."""
    import shutil
    import tempfile

    import torch

    from repro_torch.core import multioutput as mo
    from repro_torch.core import predict as tpredict
    from repro_torch.core import vecchia
    from repro_torch.core.fit import (_chunk_grad, _multi_stats_chunk, _multi_wgrad_chunk,
                                      _piece_backend, fit_sbv)
    from repro_torch.core.kernels_math import KernelParams
    from repro_torch.data import streaming as st
    from repro_torch.data.store import ArrayStore, MemoryStore
    from repro_torch.kernels import ops
    from repro_torch.kernels.sbv_loglik import sbv_loglik_cuda, sbv_loglik_plain
    from repro_torch.kernels.sbv_predict import sbv_predict_plain
    from repro_torch.memwatch import PeakRssSampler

    out = {}
    n, d = x_tr.shape
    tmp = tempfile.mkdtemp(prefix="smoke-stream-")
    try:
        # 29. The training set on disk (default shards of 131,072 rows).
        t = time.perf_counter()
        store = ArrayStore.from_arrays(store_dir, x_tr, y_tr)
        log(f"phase streaming store: {time.perf_counter() - t:.2f} s to write n={store.n_rows} "
            f"d={store.d} in {store.n_shards} shards")

        # 30. Structure at the fit's initial beta, taken as the fit takes it
        # (exp of the log-beta on the device).
        p0 = KernelParams(*(torch.as_tensor(a).to(dev) for a in init))
        beta = p0.beta.cpu().numpy()
        t = time.perf_counter()
        blocks, radii, vol = st.streaming_kmeans_blocks(store, beta, cfg.n_blocks,
                                                        n_workers=cfg.n_workers, seed=cfg.seed,
                                                        ordering=cfg.ordering)
        t_km = time.perf_counter() - t
        t = time.perf_counter()
        neigh, flat = st.streaming_filtered_nns(store, blocks, radii, beta, cfg.m,
                                                alpha=cfg.alpha, domain_volume=vol)
        t_nns = time.perf_counter() - t
        t = time.perf_counter()
        plan = st.plan_block_chunks(blocks, neigh, cfg.m, STREAM_CHUNK)
        t_plan = time.perf_counter() - t
        bs_max = int(max(mb.size for mb in blocks.members))
        bc_pad = max(len(r) for r in plan)
        t = time.perf_counter()
        pieces = [st.pack_block_chunk(store, blocks, neigh, r, m=cfg.m, bs_max=bs_max)
                  .pad_to_blocks(bc_pad) for r in plan]
        t_pack = time.perf_counter() - t
        spool_bytes = sum(sum(a.nbytes for a in (pk.blk_x, pk.blk_y, pk.blk_mask, pk.nn_x,
                                                  pk.nn_y, pk.nn_mask)) for pk in pieces)
        log(f"phase streaming structure: k-means {t_km:.2f} s, store-backed NNS {t_nns:.2f} s "
            f"({flat.gathered_rows} rows gathered), plan {t_plan:.3f} s, pack {t_pack:.2f} s; "
            f"bc={blocks.n_blocks} bs_max={bs_max} m={cfg.m}; {len(pieces)} pieces of "
            f"{bc_pad} blocks, spool {spool_bytes / 1e6:.1f} MB")
        out["structure_s"] = dict(kmeans=t_km, nns=t_nns, plan=t_plan, pack=t_pack)

        # 31. Value and gradient at the same params over one spool in three
        # tiers, prefetched and (disk) synchronous: all bitwise equal.
        def evaluate(spool, prefetch):
            """Loss, gradient, step seconds and the seconds the consumer
            waited for its next piece."""
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = grad = None
            waited = 0.0
            it = spool.iter_arrays(prefetch=prefetch)
            while True:
                tw = time.perf_counter()
                item = next(it, None)
                waited += time.perf_counter() - tw
                if item is None:
                    break
                v, g = _chunk_grad(p0, item[0], 3.5, item[1], n)
                loss = v if loss is None else loss + v
                grad = g if grad is None else tuple(a + b for a, b in zip(grad, g))
            torch.cuda.synchronize()
            return loss, grad, time.perf_counter() - t, waited

        # The disk tier alternates prefetch 2 and 0, three times each, so the
        # two are compared within one stretch of the run.
        runs = []
        for label, budget, order in (("device", spool_bytes, (2, 2)),
                                     ("half", spool_bytes // 2, (2, 2)),
                                     ("disk", 0, (2, 0) * 3)):
            t = time.perf_counter()
            spool = st.PackedChunkSpool(os.path.join(tmp, label), device_budget=budget,
                                        device=dev)
            for pk in pieces:
                spool.add(pk, tag=_piece_backend("auto", pk))
            t_spool = time.perf_counter() - t
            times = {}
            for pf in order:
                l_, g_, s_, w_ = evaluate(spool, pf)
                runs.append((label, pf, l_, g_))
                times.setdefault(pf, []).append((s_, w_))
            for pf, tw in times.items():
                log(f"streaming tier {label} prefetch {pf}: {spool.n_device} of {len(spool)} "
                    f"pieces on the device ({spool.device_bytes / 1e6:.1f} MB), H2D "
                    f"{spool.disk_bytes_total / 1e6:.1f} MB per step; step "
                    + ", ".join(f"{a:.3f}" for a, _ in tw) + " s (mean "
                    f"{sum(a for a, _ in tw) / len(tw):.3f}), waiting for pieces "
                    + ", ".join(f"{b:.3f}" for _, b in tw)
                    + f" s (spool built in {t_spool:.2f} s); loss {float(l_)!r}")
                out[f"step_s_{label}_prefetch{pf}"] = [a for a, _ in tw]
                out[f"wait_s_{label}_prefetch{pf}"] = [b for _, b in tw]
            out[f"h2d_bytes_{label}"] = spool.disk_bytes_total
            # One profiled step: the device's busy share of the unprofiled
            # step, and whether the copies overlap kernels.
            tr = None
            if label != "half":
                try:
                    tr = trace_step(lambda: evaluate(spool, 2), os.path.join(tmp, "trace.json"))
                except Exception as exc:  # a diagnostic: no trace is no failure
                    log(f"streaming tier {label}: torch.profiler trace not measured ({exc!r})")
            if tr is not None:
                fastest = min(a for a, _ in times[2])
                tr["idle_share"] = 1.0 - tr["kernel_busy_s"] / fastest
                log(f"streaming tier {label} prefetch 2, one step under torch.profiler: "
                    f"{tr['kernels']} kernels ({tr['launches']} cudaLaunchKernel), kernels busy "
                    f"{tr['kernel_busy_s']:.4f} s of a {tr['span_s']:.4f} s profiled span; "
                    f"device idle {100 * tr['idle_share']:.1f} % of the fastest unprofiled "
                    f"step {fastest:.3f} s; {tr['h2d']} H2D copies, {tr['h2d_s'] * 1e3:.2f} ms, "
                    f"{tr['h2d_overlap_s'] * 1e3:.2f} ms of it under a kernel")
                out[f"trace_{label}"] = tr
            spool.cleanup()
        pf2, pf0 = out["step_s_disk_prefetch2"], out["step_s_disk_prefetch0"]
        log(f"streaming disk tier, prefetch 2 vs 0 in alternation: mean {sum(pf2) / 3:.3f} vs "
            f"{sum(pf0) / 3:.3f} s per step; prefetch faster in "
            f"{sum(a < b for a, b in zip(pf2, pf0))} of 3 pairs")
        ref_loss, ref_grad = runs[0][2], runs[0][3]
        for label, pf, l_, g_ in runs[1:]:
            same = bool(torch.equal(l_, ref_loss)) and all(
                torch.equal(a, b) for a, b in zip(g_, ref_grad))
            check(same, f"streaming tier {label} prefetch {pf}: value or gradient not bitwise "
                        f"equal to the device tier's (loss {float(l_)!r} vs {float(ref_loss)!r},"
                        f" gradient gap {grad_gap(g_, ref_grad):.3e})")
        log(f"streaming tiers: {len(runs)} evaluations (device and half twice, disk with "
            f"prefetch 2 and 0 three times each) bitwise equal in loss and every gradient leaf")

        # 31b. The kernel route against the plain one on the same pieces:
        # the streaming `ref` route (the checkpointed joint form) summed
        # over the spool, and each piece's per-block values against the
        # plain version of the kernel.
        t = time.perf_counter()
        p_loss = p_grad = None
        blk_rel = 0.0
        for pk in pieces:
            arrs = tuple(torch.as_tensor(a).to(dev) for a in (pk.blk_x, pk.blk_y, pk.blk_mask,
                                                               pk.nn_x, pk.nn_y, pk.nn_mask))
            v, g = _chunk_grad(p0, arrs, 3.5, "ref", n)
            p_loss = v if p_loss is None else p_loss + v
            p_grad = g if p_grad is None else tuple(a + b for a, b in zip(p_grad, g))
            pr = (p0.beta, p0.sigma2, p0.nugget)
            got, want = sbv_loglik_cuda(*pr, *arrs), sbv_loglik_plain(*pr, *arrs)
            check(bool(torch.isfinite(got).all()), "streaming piece: non-finite kernel output")
            blk_rel = max(blk_rel, float(((got - want).abs() / want.abs().clamp_min(1e-300))
                                         .max()))
        torch.cuda.synchronize()
        rel_l = abs(float(p_loss) - float(ref_loss)) / abs(float(p_loss))
        rel_g = grad_gap(ref_grad, p_grad)
        log(f"streaming kernel route vs plain over the {len(pieces)} spooled pieces "
            f"({time.perf_counter() - t:.2f} s): loss rel {rel_l:.3e}, gradient rel {rel_g:.3e} "
            f"(the checkpointed joint form); per-block values max rel {blk_rel:.3e}")
        check(rel_l <= 1e-10 and rel_g <= 1e-10,
              f"streaming kernel route vs plain: loss {rel_l:.3e}, gradient {rel_g:.3e} > 1e-10")
        check(blk_rel <= 1e-9, f"streaming pieces: per-block kernel vs plain {blk_rel:.3e} > 1e-9")
        out["plain_check"] = dict(loss_rel=rel_l, grad_rel=rel_g, block_rel=blk_rel)
        del arrs, p_grad, got, want

        # 32. The same structure in one piece: the sum differs in order only.
        one = st.plan_block_chunks(blocks, neigh, cfg.m, 10 ** 9)
        check(len(one) == 1, f"one-piece plan has {len(one)} pieces")
        pk1 = st.pack_block_chunk(store, blocks, neigh, one[0], m=cfg.m, bs_max=bs_max)
        arrs1 = tuple(torch.as_tensor(a).to(dev) for a in (pk1.blk_x, pk1.blk_y, pk1.blk_mask,
                                                            pk1.nn_x, pk1.nn_y, pk1.nn_mask))
        l1, g1 = _chunk_grad(p0, arrs1, 3.5, "auto", n)
        rel_l = abs(float(l1) - float(ref_loss)) / abs(float(l1))
        rel_g = grad_gap(ref_grad, g1)
        log(f"streaming one piece ({pk1.n_blocks} blocks) vs {len(pieces)} pieces: loss rel "
            f"{rel_l:.3e}, gradient rel {rel_g:.3e}")
        check(rel_l <= 1e-10 and rel_g <= 1e-10,
              f"one piece vs many: loss {rel_l:.3e}, gradient {rel_g:.3e} > 1e-10")
        del arrs1, pk1, g1
        torch.cuda.empty_cache()

        # 33. The user path: fit_sbv on the store, half the spool on the card.
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base_alloc = torch.cuda.memory_allocated(dev)
        rss = PeakRssSampler().start()
        t = time.perf_counter()
        fit = fit_sbv(store, None, cfg, init=init, stream_chunk=STREAM_CHUNK,
                      device_cache=spool_bytes // 2, inner_steps=STREAM_INNER, outer_rounds=1,
                      device=dev)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t
        rss_delta = rss.stop()
        peak = torch.cuda.max_memory_allocated(dev) - base_alloc
        fit_launches = ops.launch_counts()
        s = fit.stream_stats
        losses = [h[2] for h in fit.history]
        step_s = s["inner_time_s"] / s["inner_steps_total"]
        log(f"phase streaming fit: {t_fit:.2f} s (1 round x {STREAM_INNER} steps, host "
            f"structure and packing included); {step_s:.3f} s per Adam step over "
            f"{s['n_pieces']} pieces ({s['device_cached_pieces']} on the device, H2D "
            f"{s['h2d_bytes_per_step'] / 1e6:.1f} MB per step) beside the in-core step "
            f"{t_step_incore:.3f} s; losses {losses}; launches {fit_launches}")
        check(len(losses) == STREAM_INNER and all(math.isfinite(v) for v in losses),
              "streaming fit: missing or non-finite losses")
        check(s["n_pieces"] == len(pieces) and 0 < s["device_cached_pieces"] < s["n_pieces"],
              f"streaming fit: {s['n_pieces']} pieces, {s['device_cached_pieces']} cached")
        check(losses[0] == float(ref_loss),
              f"streaming fit: first loss {losses[0]!r} not bitwise the tier check's "
              f"{float(ref_loss)!r}")
        want = s["n_pieces"] * STREAM_INNER
        check(fit_launches["sbv_loglik"] == want,
              f"streaming fit: loglik kernel launched {fit_launches['sbv_loglik']} times, "
              f"expected pieces x steps = {want}")
        room = s["device_cached_bytes"] + s["device_reserve_bytes"]
        unit = s["backward_blocks"] * (s["bs_max"] + cfg.m) ** 2 * 8
        sets = peak / unit
        live = st.backward_live_bytes(s["bs_max"], cfg.m, s["backward_blocks"], 8, 1, d)
        log(f"streaming fit device memory: peak {peak / 1e9:.3f} GB above the start "
            f"({sets:.2f} (bs+m)^2 sets of {s['backward_blocks']} blocks, everything included) "
            f"against cached {s['device_cached_bytes'] / 1e9:.3f} GB + reserve "
            f"{s['device_reserve_bytes'] / 1e9:.3f} GB (its backward term "
            f"{live / 1e9:.3f} GB = {live / unit:.2f} sets, counted)")
        check(peak <= room, f"streaming fit: device peak {peak} B above cached + reserve {room} B")
        # Host RSS against the model's host terms: on the card the backward
        # and the cached pieces are device memory (its device_terms).
        ws = st.working_set_model(s, n, d, cfg.m, STREAM_CHUNK, n_caches=1, device=dev)
        log(f"streaming fit host RSS: peak delta {rss_delta / 1e6:.1f} MB against "
            f"working_set_model {ws['total'] / 1e6:.1f} MB of host terms ("
            + ", ".join(f"{k} {v / 1e6:.1f}" for k, v in ws["terms"].items())
            + "; device terms, not in RSS: "
            + ", ".join(f"{k} {v / 1e6:.1f}" for k, v in ws["device_terms"].items())
            + f"; in-core model {ws['incore_total'] / 1e6:.1f} MB)")
        check(rss_delta is not None and rss_delta < 2 * ws["total"],
              f"streaming fit: RSS delta {rss_delta} B not below 2 x {ws['total']} B")
        out.update(history=fit.history, device_cache=spool_bytes // 2)
        out.update(fit_s=t_fit, step_s=step_s, peak_device_bytes=peak, room_bytes=room,
                   peak_sets=sets, rss_delta=rss_delta, working_set_host=ws["total"],
                   n_pieces=s["n_pieces"])
        fitted = fit.params
        del fit
        torch.cuda.empty_cache()

        # 34. Multi-output streaming at p = 32 on the first 50,000 rows.
        xm, ym = xm_tr[:N_MULTI_STREAM], ym_tr[:N_MULTI_STREAM]
        cfg_m = type(cfg)(n_blocks=N_MULTI_STREAM // 100, m=cfg.m, seed=cfg.seed)
        init_m = mo.MultiOutputParams.create(sigma2=1.0, beta=0.5, tau2=1e-3, d=xm.shape[1],
                                             p=ym.shape[1])
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base_alloc = torch.cuda.memory_allocated(dev)
        t = time.perf_counter()
        fit_m = fit_sbv(xm, ym, cfg_m, init=init_m, stream_chunk=STREAM_CHUNK,
                        inner_steps=MULTI_STREAM_INNER, outer_rounds=1, device=dev)
        torch.cuda.synchronize()
        t_fit_m = time.perf_counter() - t
        peak_m = torch.cuda.max_memory_allocated(dev) - base_alloc
        multi_launches = ops.launch_counts()
        sm = fit_m.stream_stats
        room_m = sm["device_cached_bytes"] + sm["device_reserve_bytes"]
        unit_m = sm["backward_blocks"] * (sm["bs_max"] + cfg.m) ** 2 * 8
        sets_m = peak_m / unit_m
        live_m = st.backward_live_bytes(sm["bs_max"], cfg.m, sm["backward_blocks"], 8,
                                        ym.shape[1], xm.shape[1])
        log(f"streaming multi fit device memory: peak {peak_m / 1e9:.3f} GB ({sets_m:.2f} sets) "
            f"against cached {sm['device_cached_bytes'] / 1e9:.3f} GB + reserve "
            f"{sm['device_reserve_bytes'] / 1e9:.3f} GB (its backward term "
            f"{live_m / 1e9:.3f} GB = {live_m / unit_m:.2f} sets, counted)")
        m_losses = [h[2] for h in fit_m.history]
        want = 2 * sm["n_pieces"] * MULTI_STREAM_INNER + sm["n_pieces"]
        log(f"phase streaming multi fit: {t_fit_m:.2f} s (n={N_MULTI_STREAM}, p={ym.shape[1]}, "
            f"1 round x {MULTI_STREAM_INNER} steps, {sm['n_pieces']} pieces); "
            f"{sm['inner_time_s'] / MULTI_STREAM_INNER:.3f} s per step (two passes); losses "
            f"{m_losses}; launches {multi_launches}")
        check(multi_launches["sbv_multi_stats"] == want,
              f"streaming multi fit: stats kernel launched {multi_launches['sbv_multi_stats']} "
              f"times, expected 2 x pieces x steps + pieces = {want}")
        pm = mo.MultiOutputParams(*(torch.as_tensor(a).to(dev) for a in init_m))
        struct1 = st.streaming_preprocess(MemoryStore(xm, ym), pm.beta.cpu().numpy(), cfg_m,
                                          10 ** 9)
        pk1 = st.pack_block_chunk(MemoryStore(xm, ym), struct1.blocks, struct1.neigh,
                                  struct1.plan[0], m=cfg.m, bs_max=struct1.bs_max)
        arrs1 = tuple(torch.as_tensor(a).to(dev) for a in (pk1.blk_x, pk1.blk_y, pk1.blk_mask,
                                                            pk1.nn_x, pk1.nn_y, pk1.nn_mask))
        with torch.no_grad():
            ld1, q1 = _multi_stats_chunk(pm, arrs1, 3.5, "auto")
            ld_p, q_p = _multi_stats_chunk(pm, arrs1, 3.5, "ref")
        one_m = float(mo.pooled_objective(ld1, q1, N_MULTI_STREAM))
        rel_m = abs(m_losses[0] - one_m) / abs(one_m)
        log(f"streaming multi first loss {m_losses[0]!r} vs one piece {one_m!r}: rel {rel_m:.3e}")
        check(rel_m <= 1e-10, f"streaming multi first loss vs one piece rel {rel_m:.3e} > 1e-10")
        # The stats kernel and the pass-B gradient against the plain
        # (checkpointed joint form) route on the same piece.
        st_rel = max(abs(float(ld1) - float(ld_p)) / abs(float(ld_p)),
                     float(((q1 - q_p).abs() / q_p.abs()).max()))
        w1 = 1.0 / q1
        p_m = ym.shape[1]
        g_k = _multi_wgrad_chunk(pm, w1, arrs1, 3.5, "auto", N_MULTI_STREAM, p_m)
        g_p = _multi_wgrad_chunk(pm, w1, arrs1, 3.5, "ref", N_MULTI_STREAM, p_m)
        mg_rel = grad_gap(g_k, g_p)
        log(f"streaming multi one piece ({pk1.n_blocks} blocks): stats kernel vs plain max rel "
            f"{st_rel:.3e}, pass-B gradient rel {mg_rel:.3e}")
        check(st_rel <= 1e-10 and mg_rel <= 1e-10,
              f"streaming multi: stats {st_rel:.3e} or gradient {mg_rel:.3e} vs plain > 1e-10")
        s2 = fit_m.params.sigma2.detach().cpu().numpy()
        check(all(math.isfinite(v) for v in m_losses) and bool(np.isfinite(s2).all())
              and bool((s2 > 0).all()), "streaming multi fit: non-finite loss or sigma2")
        # The backward's device peak on this piece at p and 4p outputs (the
        # observations repeated), against the counted live set plus the
        # stats kernel's scratch.
        peaks_p = {}
        for reps in (1, 4):
            a_r = arrs1[:1] + (arrs1[1].repeat(1, 1, reps),) + arrs1[2:4] + (
                arrs1[4].repeat(1, 1, reps),) + arrs1[5:]
            pm_r = mo.MultiOutputParams.create(sigma2=1.0, beta=0.5, tau2=1e-3, d=xm.shape[1],
                                               p=p_m * reps)
            pm_r = mo.MultiOutputParams(*(torch.as_tensor(a).to(dev) for a in pm_r))
            with torch.no_grad():
                w_r = 1.0 / _multi_stats_chunk(pm_r, a_r, 3.5, "auto")[1]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base_r = torch.cuda.memory_allocated(dev)
            _multi_wgrad_chunk(pm_r, w_r, a_r, 3.5, "auto", N_MULTI_STREAM, p_m * reps)
            torch.cuda.synchronize()
            pk_r = torch.cuda.max_memory_allocated(dev) - base_r
            k_r = pk1.bs_max + cfg.m
            live_r = st.backward_live_bytes(pk1.bs_max, cfg.m, ops.BACKWARD_CHUNK, 8,
                                            p_m * reps, xm.shape[1])
            scratch_r = pk1.n_blocks * (k_r + 1) * k_r * 8
            unit_r = ops.BACKWARD_CHUNK * k_r ** 2 * 8
            peaks_p[p_m * reps] = pk_r
            log(f"multi backward device peak at p={p_m * reps}: {pk_r / 1e9:.3f} GB = "
                f"{pk_r / unit_r:.2f} sets of {ops.BACKWARD_CHUNK} blocks at bs+m={k_r} against "
                f"the counted {live_r / unit_r:.2f} sets + the kernel's scratch "
                f"{scratch_r / unit_r:.2f}")
            check(pk_r <= live_r + scratch_r,
                  f"multi backward peak at p={p_m * reps}: {pk_r} B above {live_r + scratch_r} B")
            del a_r, w_r
        out["multi"] = dict(fit_s=t_fit_m, step_s=sm["inner_time_s"] / MULTI_STREAM_INNER,
                            n_pieces=sm["n_pieces"], peak_device_bytes=peak_m, room_bytes=room_m,
                            stats_rel=st_rel, grad_rel=mg_rel, backward_peaks=peaks_p)
        del fit_m, arrs1, pk1, g_k, g_p
        torch.cuda.empty_cache()

        # 35. Prediction from the store: 20,000 points in chunks of 10,000
        # at the generator's parameters (the smoke's MSPE gate), then the
        # store-backed against the in-core streaming prediction at the
        # fitted ones.
        kw = dict(bs_pred=BS_PRED, m_pred=M_PRED, n_sims=N_SIMS, chunk_size=STREAM_PRED_CHUNK,
                  stream_chunk=STREAM_CHUNK, seed=SEED, device=dev)
        xt, yt = x_te[:N_STREAM_TEST], y_te[:N_STREAM_TEST]
        # The path's first chunk, its inputs and its kernel outputs, kept for
        # the plain check below.
        first = []
        many = tpredict.batched_block_predict_many

        def keep_first(params, arrs, **k):
            res = many(params, arrs, **k)
            if not first:
                first.append((params, arrs, res))
            return res

        tpredict.batched_block_predict_many = keep_first
        try:
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            pred = tpredict.predict_sbv(true_p, store, None, xt, **kw)
            torch.cuda.synchronize()
            t_pred = time.perf_counter() - t
            pred_launches = ops.launch_counts()
        finally:
            tpredict.batched_block_predict_many = many
        n_chunks = math.ceil(N_STREAM_TEST / STREAM_PRED_CHUNK)
        mspe = float(np.mean((pred.mean - yt) ** 2))
        var_y = float(np.var(np.concatenate([y_tr, y_te])))
        log(f"phase streaming predict: {t_pred:.2f} s for {N_STREAM_TEST} points in {n_chunks} "
            f"chunks from the store; MSPE {mspe:.5f} vs var(y) {var_y:.5f}; launches "
            f"{pred_launches}")
        check(pred_launches["sbv_predict"] == n_chunks,
              f"streaming predict: kernel launched {pred_launches['sbv_predict']} times, "
              f"expected {n_chunks}")
        for f in ("mean", "var", "sim_mean", "ci_low", "ci_high"):
            a = getattr(pred, f)
            check(a.shape == (N_STREAM_TEST,) and bool(np.isfinite(a).all()),
                  f"streaming predict: bad {f}")
        check(mspe < 0.5 * var_y, f"streaming MSPE {mspe:.4f} not below 0.5 var(y)")
        # Chunk 0's kernel outputs against the plain version on its inputs:
        # 1e-10 of the output scale, or 10 eps cond(K_NN) at the generator's
        # nugget 1e-8, as the in-core predict check holds them.
        prm, arrs_c, res_c = first[0]
        pr = (prm.beta, prm.sigma2, prm.nugget)
        p_err, p_scale, p_cond = 0.0, 1.0, 1.0
        for a_c, (mu_k, var_k) in zip(arrs_c, res_c):
            msk = a_c[1].bool()
            for got, want in zip((mu_k, var_k), sbv_predict_plain(*pr, *a_c)):
                p_err = max(p_err, float((got - want).abs()[msk].max()))
                p_scale = max(p_scale, float(want.abs()[msk].max()))
            k_nn = vecchia._masked_cov(a_c[2], a_c[2], a_c[4].bool(), a_c[4].bool(), *pr, 3.5,
                                       identity=True)
            ev = torch.linalg.eigvalsh(k_nn)
            p_cond = max(p_cond, float((ev[:, -1] / ev[:, 0]).max()))
            del k_nn, ev
        p_tol = max(1e-10, 10 * 2.2e-16 * p_cond)
        log(f"streaming predict chunk 0 ({arrs_c[0][0].shape[0]} blocks): kernel vs plain max abs "
            f"err {p_err:.3e} (|out| max {p_scale:.3g}, max cond(K_NN) {p_cond:.3e}, tolerance "
            f"{p_tol:.1e} x {p_scale:.3g})")
        check(p_err <= p_tol * p_scale,
              f"streaming predict chunk 0: kernel vs plain {p_err:.3e} > {p_tol:.1e} x {p_scale:.3g}")
        out["predict_plain_err"] = p_err
        del first, arrs_c, res_c
        xb = x_te[:N_STREAM_BITWISE]
        t = time.perf_counter()
        p_store = tpredict.predict_sbv(fitted, store, None, xb, **kw)
        t_ps = time.perf_counter() - t
        p_mem = tpredict.predict_sbv(fitted, x_tr, y_tr, xb, **kw)
        same = [f for f in ("mean", "var", "sim_mean", "ci_low", "ci_high")
                if np.array_equal(getattr(p_store, f), getattr(p_mem, f))]
        log(f"streaming predict at the fitted params, {N_STREAM_BITWISE} points: store-backed "
            f"{t_ps:.2f} s; bitwise equal to the in-core streaming prediction in {same}; MSPE "
            f"{float(np.mean((p_store.mean - y_te[:N_STREAM_BITWISE]) ** 2)):.5f} (not checked: "
            f"{STREAM_INNER} Adam steps)")
        check(len(same) == 5, f"streaming predict: store vs in-core differ outside {same}")
        out["predict_s"] = t_pred
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    results["streaming"] = out
    return {"sbv_loglik": fit_launches["sbv_loglik"],
            "sbv_multi_stats": multi_launches["sbv_multi_stats"],
            "sbv_predict": pred_launches["sbv_predict"]}


def _gap(got, want) -> float:
    """Largest relative difference of a loss and its gradient leaves."""
    v = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    return max(v, grad_gap(got[1], want[1]))


def predict_rank(work: str) -> int:
    """One rank of the phase's multi-host prediction (``python3 chip_smoke.py
    --predict-rank DIR``, started by ``multihost.spawn_ranks``): the
    training set from the store in ``DIR/train``, the queries, params and
    keyword arguments (device included) from ``DIR``, then
    ``predict_sbv(multihost=)``; writes its results, launches and seconds
    to ``DIR/pred.rank<r>.npz``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.core import predict as tpredict
    from repro_torch.core.kernels_math import KernelParams
    from repro_torch.data.store import ArrayStore
    from repro_torch.kernels import ops
    from repro_torch.multihost import MultihostContext

    ctx = MultihostContext.from_env()
    store = ArrayStore(os.path.join(work, "train"))
    x, y = store.read_slice(0, store.n_rows)
    xq = np.load(os.path.join(work, "xq.npy"))
    with np.load(os.path.join(work, "params.npz")) as z:
        params = KernelParams(*(torch.as_tensor(z[k]) for k in KernelParams._fields))
    with open(os.path.join(work, "predict.json")) as f:
        kw = json.load(f)
    ops.reset_launch_counts()
    t = time.perf_counter()
    pred = tpredict.predict_sbv(params, x, y, xq, multihost=ctx, **kw)
    if torch.device(kw["device"]).type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t
    np.savez(os.path.join(work, f"pred.rank{ctx.rank}.npz"), seconds=secs,
             allreduce_s=ctx.allreduce_s, launches=ops.launch_counts()["sbv_predict"],
             **{f: getattr(pred, f) for f in ("mean", "var", "sim_mean", "ci_low", "ci_high")})
    ctx.shutdown()
    return 0


def distributed_phase(dev, results: dict, x_tr, y_tr, x_te, cfg, init, true_p, index,
                      work: str) -> dict:
    """Paper Alg. 1 steps 4-5 and Alg. 2 on the one card: the in-core fit
    over a 4-worker mesh (``fit_sbv(distributed=)``, every worker on the
    card), its loss and gradient and a bucketed evaluation against the
    serial ones, one prediction chunk over 4 shards against the serial
    chunk, the streaming fit over the mesh against the streaming phase's
    serial fit, then the multi-host fit (``fit_gp --distributed-hosts 2``)
    and the multi-host prediction on 2 rank processes sharing the card.
    ``work`` holds the streaming phase's store (``work/train``). Returns
    the launches of the parent's path runs and each rank's."""
    import torch

    from repro_torch.core import buckets
    from repro_torch.core import distributed as dist
    from repro_torch.core import predict as tpredict
    from repro_torch.core import vecchia
    from repro_torch.core.fit import _value_and_grad, fit_sbv, neg_loglik_fn
    from repro_torch.core.pipeline import SBVConfig
    from repro_torch.core.vecchia import bucketed_loglik
    from repro_torch.data.store import ArrayStore
    from repro_torch.kernels import ops
    from repro_torch.kernels.sbv_predict import sbv_predict_plain
    from repro_torch.launch.mesh import make_worker_mesh
    from repro_torch.multihost import spawn_ranks

    out = {}
    store_dir = os.path.join(work, "train")
    mesh = make_worker_mesh(N_WORKERS)
    cfg_w = SBVConfig(n_blocks=cfg.n_blocks, m=cfg.m, seed=cfg.seed, n_workers=N_WORKERS)
    log(f"worker mesh: {N_WORKERS} workers on {sorted(set(map(str, mesh.devices)))}")

    # 36. The in-core fit over the mesh, through the user entry point.
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fit = fit_sbv(x_tr, y_tr, cfg_w, init=init, distributed=(mesh, "workers"), outer_rounds=1,
                  inner_steps=DIST_INNER, device=dev)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t
    fit_launches = ops.launch_counts()
    losses = [h[2] for h in fit.history]
    log(f"phase distributed fit: {t_fit:.2f} s (1 round x {DIST_INNER} steps over {N_WORKERS} "
        f"workers, preprocess included); losses {losses}; launches {fit_launches}")
    check(len(losses) == DIST_INNER and all(math.isfinite(v) for v in losses),
          "distributed fit: missing or non-finite losses")
    check(fit_launches["sbv_loglik"] == N_WORKERS * DIST_INNER,
          f"distributed fit: loglik kernel launched {fit_launches['sbv_loglik']} times, "
          f"expected workers x steps = {N_WORKERS * DIST_INNER}")

    # 37. Loss and gradient at the initial params, 4 shards against the
    # serial closure on the same packed structure, timed in turns.
    packed = fit.packed
    p0 = init.to(device=dev)
    serial_fn = neg_loglik_fn(packed, 3.5, "auto", device=dev)
    dist_fn = dist.distributed_neg_loglik_fn(packed, 3.5, mesh, "workers")
    evals, secs = {}, {"serial": [], "mesh": []}
    for label in ("serial", "mesh", "mesh", "serial"):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        evals[label] = _value_and_grad(serial_fn if label == "serial" else dist_fn, p0)
        torch.cuda.synchronize()
        secs[label].append(time.perf_counter() - t)
        if label == "mesh":
            n_launch = ops.launch_counts()["sbv_loglik"]
            check(n_launch == N_WORKERS,
                  f"distributed evaluation: {n_launch} loglik launches, expected {N_WORKERS}")
    rel = _gap(evals["mesh"], evals["serial"])
    log(f"distributed loss and gradient at the initial params ({packed.n_blocks} blocks, "
        f"{N_WORKERS} shards of {-(-packed.n_blocks // N_WORKERS)}): max rel gap to the serial "
        f"closure {rel:.3e}; step (value + gradient) serial {secs['serial']} s, mesh "
        f"{secs['mesh']} s; the fit's first loss {losses[0]!r} vs {float(evals['mesh'][0])!r}")
    check(rel <= 1e-12, f"distributed vs serial loss/gradient rel {rel:.3e} > 1e-12")
    check(abs(losses[0] - float(evals["mesh"][0])) <= 1e-12 * abs(losses[0]),
          "distributed fit: first loss differs from the checked evaluation")
    # The 4-worker structure's loss and gradient through the plain version
    # (what neg_loglik_fn(packed, 3.5, "ref") differentiates), in 500-block
    # pieces: the whole batch at once would hold ~35 GB of intermediates.
    arrs_p = vecchia.packed_arrays(packed, dev)
    t = time.perf_counter()
    ref_loss = ref_grad = None
    for s0 in range(0, packed.n_blocks, 500):
        piece = tuple(a[s0:s0 + 500] for a in arrs_p)
        v, g = _value_and_grad(
            lambda p: -vecchia.batched_block_loglik(p, *piece) / packed.n_points, p0)
        ref_loss = v if ref_loss is None else ref_loss + v
        ref_grad = g if ref_grad is None else tuple(a + b for a, b in zip(ref_grad, g))
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t
    rel_ref = _gap(evals["mesh"], (ref_loss, ref_grad))
    log(f"distributed loss and gradient vs the plain version on the same {packed.n_blocks} "
        f"blocks (bs_max={packed.bs_max}, m={packed.m}; {t_ref:.2f} s): max rel {rel_ref:.3e}")
    check(rel_ref <= 1e-10, f"distributed vs plain loss/gradient rel {rel_ref:.3e} > 1e-10")
    out.update(fit_s=t_fit, step_serial_s=secs["serial"], step_mesh_s=secs["mesh"], rel=rel,
               rel_plain=rel_ref)
    del serial_fn, dist_fn, evals, arrs_p, ref_grad
    torch.cuda.empty_cache()

    # 38. One bucketed evaluation over the mesh against the serial one.
    bk = buckets.bucket_blocks(packed, n_buckets=N_BUCKETS)
    with torch.no_grad():
        want = bucketed_loglik(p0, bk)
        ops.reset_launch_counts()
        got = dist.distributed_bucketed_loglik(p0, bk, mesh)
        torch.cuda.synchronize()
        bk_launches = ops.launch_counts()["sbv_loglik"]
        want_ref = bucketed_loglik(p0, bk, backend="ref")
    rel_b = abs(float(got) - float(want)) / abs(float(want))
    rel_br = abs(float(got) - float(want_ref)) / abs(float(want_ref))
    log(f"distributed bucketed evaluation ({bk.n_buckets} buckets x {N_WORKERS} shards, "
        f"{bk_launches} launches): rel {rel_b:.3e} to the serial bucketed loglik, "
        f"{rel_br:.3e} to its plain version")
    check(rel_b <= 1e-12, f"distributed bucketed vs serial rel {rel_b:.3e} > 1e-12")
    check(rel_br <= 1e-10, f"distributed bucketed vs plain rel {rel_br:.3e} > 1e-10")
    out.update(bucketed_rel=rel_b, bucketed_rel_plain=rel_br)
    check(bk_launches == bk.n_buckets * N_WORKERS,
          f"distributed bucketed: {bk_launches} launches, expected {bk.n_buckets * N_WORKERS}")
    del bk, packed, fit
    torch.cuda.empty_cache()

    # 39. One 25,000-point prediction chunk over 4 shards against the
    # serial chunk (owners from a 4-worker blocking of the queries).
    _, chunk = next(tpredict.iter_query_chunks(index, x_te, BS_PRED, M_PRED, seed=SEED,
                                               n_workers=N_WORKERS, chunk_size=CHUNK))
    arrs = tuple(torch.as_tensor(a).to(dev) for a in chunk.arrays())
    n_q = chunk.n_queries

    def scattered(pk, mu, var):
        m_, v_ = np.zeros(N_TEST), np.zeros(N_TEST)
        tpredict.scatter_packed(pk, (mu, m_), (var, v_))
        return m_, v_

    m_s, v_s = scattered(chunk, *tpredict.batched_block_predict(true_p, *arrs))
    ops.reset_launch_counts()
    sharded, mu, var = dist.sharded_packed_predict(true_p, chunk, mesh)
    torch.cuda.synchronize()
    pr_launches = ops.launch_counts()["sbv_predict"]
    m_d, v_d = scattered(sharded, mu, var)
    p_err = max(float(np.abs(m_d - m_s).max()), float(np.abs(v_d - v_s).max()))
    bitwise = bool(np.array_equal(m_d, m_s) and np.array_equal(v_d, v_s))
    sh_ms = cuda_ms(lambda: dist.sharded_packed_predict(true_p, chunk, mesh))
    se_ms = cuda_ms(lambda: tpredict.batched_block_predict(true_p, *arrs))
    log(f"sharded prediction chunk ({chunk.n_blocks} blocks, {n_q} points, {N_WORKERS} shards, "
        f"{pr_launches} launches): bitwise {bitwise}, max abs err {p_err:.3e}; "
        f"{sh_ms:.3f} ms (reorder and gather included) against one launch {se_ms:.3f} ms")
    check(p_err <= 1e-12, f"sharded prediction vs serial err {p_err:.3e} > 1e-12")
    check(pr_launches == N_WORKERS, f"sharded prediction: {pr_launches} launches")
    # The sharded chunk's kernel outputs against the plain version on its
    # own (reordered, padded) arrays, within the main path's limit at the
    # true params: 10 eps cond(K_NN) of the output scale.
    s_arrs = tuple(torch.as_tensor(a).to(dev) for a in sharded.arrays())
    pr_t = (true_p.beta.double(), true_p.sigma2.double(), true_p.nugget.double())
    want_p = sbv_predict_plain(*pr_t, *s_arrs)
    msk = s_arrs[1]
    nn_m = s_arrs[4].bool()
    ev = torch.linalg.eigvalsh(vecchia._masked_cov(s_arrs[2], s_arrs[2], nn_m, nn_m, *pr_t, 3.5,
                                                   identity=True))
    cond = float((ev[:, -1] / ev[:, 0]).max())
    scale = max(1.0, max(float(w.abs()[msk].max()) for w in want_p))
    errs_pl = [float((g - w).abs()[msk].max()) for g, w in zip((mu, var), want_p)]
    tol = max(1e-10, 10 * 2.2e-16 * cond)
    log(f"sharded prediction chunk vs the plain version on its arrays: max abs err mu/var "
        f"{errs_pl[0]:.3e}/{errs_pl[1]:.3e} (|out| max {scale:.3g}, max cond(K_NN) {cond:.3e}, "
        f"limit {tol:.1e} x {scale:.3g})")
    check(max(errs_pl) <= tol * scale,
          f"sharded prediction vs plain err {max(errs_pl):.3e} > {tol:.1e} x {scale:.3g}")
    out.update(predict_bitwise=bitwise, predict_err=p_err, sharded_ms=sh_ms, serial_ms=se_ms,
               predict_err_plain=errs_pl)
    del arrs, mu, var, s_arrs, want_p, ev
    torch.cuda.empty_cache()

    # 40. The streaming fit over the mesh, against the streaming phase's
    # serial fit of the same store (every piece padded to 4 shards).
    stream = results["streaming"]
    store = ArrayStore(store_dir)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fit_s = fit_sbv(store, None, cfg_w, init=init, stream_chunk=STREAM_CHUNK,
                    device_cache=stream["device_cache"], inner_steps=STREAM_INNER,
                    outer_rounds=1, distributed=(mesh, "workers"), device=dev)
    torch.cuda.synchronize()
    t_fs = time.perf_counter() - t
    s_launches = ops.launch_counts()
    st_ = fit_s.stream_stats
    hist = [h[2] for h in fit_s.history]
    ser = [h[2] for h in stream["history"]]
    rel_s = max(abs(a - b) / abs(b) for a, b in zip(hist, ser))
    want = st_["n_pieces"] * N_WORKERS * STREAM_INNER
    log(f"phase distributed streaming fit: {t_fs:.2f} s ({st_['n_pieces']} pieces x "
        f"{N_WORKERS} shards, {st_['inner_time_s'] / STREAM_INNER:.3f} s per step beside the "
        f"serial {stream['step_s']:.3f} s); history {hist} vs serial {ser}: max rel {rel_s:.3e}; "
        f"launches {s_launches}")
    check(len(hist) == len(ser) and rel_s <= 1e-10,
          f"distributed streaming history vs serial rel {rel_s:.3e} > 1e-10")
    check(s_launches["sbv_loglik"] == want,
          f"distributed streaming fit: {s_launches['sbv_loglik']} launches, expected {want}")
    out.update(stream_fit_s=t_fs, stream_rel=rel_s,
               stream_step_s=st_["inner_time_s"] / STREAM_INNER)
    del fit_s
    torch.cuda.empty_cache()

    # 41. The multi-host fit: 2 rank processes sharing the card, through
    # the fit driver.
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT / "src"), env.get("PYTHONPATH"))
                                        if p)
    result = os.path.join(work, "mh.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.fit_gp", "--store", store_dir,
           "--distributed-hosts", str(N_RANKS), "--blocks", str(cfg.n_blocks),
           "--m", str(cfg.m), "--inner-steps", str(STREAM_INNER), "--outer-rounds", "1",
           "--stream-chunk", str(STREAM_CHUNK), "--seed", str(SEED), "--device", str(dev),
           "--timeout", str(RANK_TIMEOUT), "--result-json", result]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=str(ROOT), env=env, capture_output=True, text=True,
                          timeout=RANK_TIMEOUT + 60)
    t_mh = time.perf_counter() - t
    for line in proc.stdout.splitlines():
        if "[fit_gp]" in line:
            log(line)
    check(proc.returncode == 0, f"multi-host fit failed ({proc.returncode}):\n"
                                f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    with open(result) as f:
        merged = json.load(f)
    gap = abs(merged["nll"] - ser[-1])
    log(f"phase multi-host fit: {t_mh:.2f} s for {N_RANKS} ranks (start, structure, "
        f"{STREAM_INNER} steps); nll {merged['nll']!r}, spread {merged['max_nll_spread']!r}, "
        f"|nll - serial streaming| {gap:.3e}")
    rank_fit = []
    for rk in merged["ranks"]:
        s_ = rk["stats"]
        log(f"multi-host rank {rk['rank']}: owned {s_['owned_rows']} rows in "
            f"{s_['owned_blocks']} blocks (+{s_['halo_rows']} halo rows, "
            f"{s_['halo_blocks']} blocks, {s_['halo_rounds']} rounds), exchange "
            f"{s_['exchange_bytes'] / 1e6:.1f} MB in {s_['exchange_s']:.2f} s, "
            f"{s_['n_pieces']} pieces ({s_['lockstep_chunks']} lockstep slots), step "
            f"{rk['step_s']:.3f} s, fit {rk['t_fit_s']:.2f} s, all-reduce {rk['allreduce_s']:.2f} s; "
            f"peak RSS delta {rk['peak_rss_bytes'] / 1e6:.1f} MB against host terms "
            f"{rk['working_set_bytes'] / 1e6:.1f} MB; launches {rk['launches']}")
        check(rk["launches"]["sbv_loglik"] > 0,
              f"multi-host rank {rk['rank']}: no loglik kernel launch")
        check(rk["peak_rss_bytes"] is not None
              and rk["peak_rss_bytes"] <= 2 * rk["working_set_bytes"],
              f"multi-host rank {rk['rank']}: peak RSS {rk['peak_rss_bytes']} B above 2 x "
              f"{rk['working_set_bytes']} B")
        rank_fit.append(rk["launches"]["sbv_loglik"])
    check(merged["max_nll_spread"] == 0.0, f"multi-host spread {merged['max_nll_spread']}")
    check(gap <= 1e-8, f"multi-host nll vs serial streaming {gap:.3e} > 1e-8")
    out.update(mh_fit_s=t_mh, mh_gap=gap, mh_ranks=merged["ranks"])

    # 42. The multi-host prediction on 2 ranks against the serial one.
    xq = x_te[:N_MH_TEST]
    np.save(os.path.join(work, "xq.npy"), xq)
    np.savez(os.path.join(work, "params.npz"),
             **{k: getattr(true_p, k).cpu().numpy() for k in type(true_p)._fields})
    kw = dict(bs_pred=BS_PRED, m_pred=M_PRED, n_sims=N_SIMS, chunk_size=STREAM_PRED_CHUNK,
              seed=SEED, device=str(dev))
    with open(os.path.join(work, "predict.json"), "w") as f:
        json.dump(kw, f)
    t = time.perf_counter()
    want = tpredict.predict_sbv(true_p, x_tr, y_tr, xq, **kw)
    t_ser = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ranks = spawn_ranks([sys.executable, str(ROOT / "chip_smoke.py"), "--predict-rank", work],
                        N_RANKS, timeout_s=RANK_TIMEOUT)
    t_mhp = time.perf_counter() - t
    for r, (code, text) in enumerate(ranks):
        check(code == 0, f"multi-host predict rank {r} failed ({code}):\n{text[-4000:]}")
    rank_pred = []
    for r in range(N_RANKS):
        with np.load(os.path.join(work, f"pred.rank{r}.npz")) as z:
            same = [f for f in ("mean", "var") if np.array_equal(z[f], getattr(want, f))]
            sim = max(float(np.abs(z[f] - getattr(want, f)).max())
                      for f in ("sim_mean", "ci_low", "ci_high"))
            log(f"multi-host predict rank {r}: {float(z['seconds']):.2f} s, launches "
                f"{int(z['launches'])}, all-reduce {float(z['allreduce_s']):.3f} s; bitwise "
                f"serial in {same}; simulation columns max abs diff {sim:.3e}")
            check(len(same) == 2, f"multi-host predict rank {r}: mean/var not bitwise serial")
            check(sim <= 1e-8, f"multi-host predict rank {r}: simulation diff {sim:.3e} > 1e-8")
            check(int(z["launches"]) > 0, f"multi-host predict rank {r}: no predict launch")
            rank_pred.append(int(z["launches"]))
    log(f"phase multi-host predict: {t_mhp:.2f} s for {N_MH_TEST} points on {N_RANKS} ranks "
        f"(start included) against the serial {t_ser:.2f} s")
    out.update(mh_predict_s=t_mhp, serial_predict_s=t_ser)
    results["distributed"] = out
    return {"sbv_loglik": fit_launches["sbv_loglik"] + bk_launches + s_launches["sbv_loglik"],
            "sbv_predict": pr_launches, "rank_sbv_loglik": rank_fit,
            "rank_sbv_predict": rank_pred}


def _launch_line(step: str, counts: dict) -> dict:
    """Print one step's GP kernel launches (the f64 and bf16 variants of the
    likelihood and the predict kernel), each on its own line."""
    for k in ("sbv_predict", "sbv_predict_bf16", "sbv_loglik", "sbv_loglik_bf16"):
        log(f"serving step {step} launches {k}: {counts.get(k, 0)}")
    return counts


def _chunk_line(label: str, n_points: int, wall: float, timer) -> dict:
    s = timer.summary()
    row = dict(points_per_s=n_points / wall, wall_s=wall, n_chunks=s["n_chunks"],
               pack_s=s["pack_s"], compute_s=s["compute_s"], land_wait_s=s["land_wait_s"],
               wall_s_per_chunk=wall / max(s["n_chunks"], 1))
    log(f"serving {label}: {n_points} points in {s['n_chunks']} chunks of {SERVE_CHUNK}, "
        f"{wall:.3f} s ({row['points_per_s']:.0f} points/s); per chunk: pack "
        f"{s['pack_s']:.4f} s, compute {s['compute_s']:.5f} s (CUDA events: kernel + copies "
        f"back), land wait {s['land_wait_s']:.4f} s, wall {row['wall_s_per_chunk']:.4f} s")
    return row


def hold_served_chunk(label: str, dev, params, pk, mean, var) -> dict:
    """One served chunk (or bucket piece) held against the plain version.

    ``pk`` is the chunk packed as the server packed it (the same index,
    seed, offset, padding and bucket split), ``mean`` / ``var`` the served
    results its query indices point into. Single output: the predict
    wrapper runs on the chunk's operands and is held against
    ``sbv_predict_plain`` within 10 eps cond(K_NN) of the output scale (the
    main path's limit), and the served rows must be bitwise the wrapper's
    output (the server launched the same kernel on the same operands; the
    launch is a comparison one, after the caller read the step's counts).
    Multi-output (``MultiOutputParams``, no kernel: the conditional is
    ``torch.linalg``, as in the reference): the served rows are held against
    ``block_predict_multi`` on the chunk's operands at the same limit."""
    import torch

    from repro_torch.core import predict as tpredict
    from repro_torch.core import vecchia
    from repro_torch.core.multioutput import MultiOutputParams
    from repro_torch.kernels.sbv_predict import sbv_predict_cuda, sbv_predict_plain

    a = tpredict.upload_packed(pk, dev)
    multi = isinstance(params, MultiOutputParams)
    nn_m = a[4].bool()
    with torch.no_grad():
        if multi:
            p = MultiOutputParams(*(t.double().to(dev) for t in params))
            want = tpredict.block_predict_multi(p.beta, p.tau2, p.sigma2, *a, nu=3.5)
            one = torch.ones((), dtype=torch.float64, device=dev)
            pr = (p.beta, one, p.tau2)
            got = None
        else:
            pr = (params.beta.double(), params.sigma2.double(), params.nugget.double())
            got = sbv_predict_cuda(*pr, *a)
            want = sbv_predict_plain(*pr, *a)
        ev = torch.linalg.eigvalsh(vecchia._masked_cov(a[2], a[2], nn_m, nn_m, *pr, 3.5,
                                                       identity=True))
    msk = a[1].bool()
    h_msk = msk.cpu().numpy()
    rows = np.asarray(pk.q_idx)[np.asarray(pk.q_mask)]
    cond = float((ev[:, -1] / ev[:, 0]).max())
    scale = max(1.0, max(float(w.abs()[msk].max()) for w in want))
    tol = max(1e-10, 10 * 2.2e-16 * cond)
    if multi:
        err = max(float(np.abs(served[rows] - w.cpu().numpy()[h_msk]).max())
                  for served, w in zip((mean, var), want))
        same = True
    else:
        err = max(float((g - w).abs()[msk].max()) for g, w in zip(got, want))
        same = all(np.array_equal(served[rows], g.cpu().numpy()[h_msk])
                   for served, g in zip((mean, var), got))
        check(bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()),
              f"serving {label}: non-finite kernel output")
    what = "served rows vs the torch.linalg conditional" if multi else "predict kernel vs plain"
    log(f"serving {label}: chunk of {len(rows)} points (bc={pk.n_blocks}, bs={pk.bs_pred}, "
        f"m={pk.m_pred}{', p=' + str(want[0].shape[-1]) if multi else ''}): {what} max abs err "
        f"{err:.3e} (|out| max {scale:.3g}, max cond(K_NN) {cond:.3e}, limit {tol:.1e} x "
        f"{scale:.3g})" + ("" if multi else f"; served rows bitwise the kernel's: {same}"))
    check(err <= tol * scale, f"serving {label}: {what} {err:.3e} > {tol:.1e} x {scale:.3g}")
    check(same, f"serving {label}: served rows differ from the kernel's output on the chunk")
    return dict(max_abs_err=err, cond=cond, scale=scale)


def multi_serving_step(dev, params_m, xm_tr, ym_tr, xm_te, index_m) -> dict:
    """The p = 32 drain batch on the multi-output path's MetaRVM index (item
    12a): N_MULTI_REQ requests over N_MULTI_SERVE held-out points in one
    micro-batch through ``GPServer``, bitwise against ``predict_synchronous``
    over their concatenation, and chunk 0 held by ``hold_served_chunk``.
    The multi-output conditional runs no kernel (``torch.linalg``, as in the
    reference), so its ``sbv_predict`` count is printed as 0."""
    from repro_torch.core import predict as tpredict
    from repro_torch.kernels import ops
    from repro_torch.serving import (BatchingPolicy, GPServer, GPServerConfig, PipelineConfig,
                                     predict_synchronous)

    xq = xm_te[:N_MULTI_SERVE]
    pipe = PipelineConfig(bs_pred=BS_PRED, m_pred=M_PRED, chunk_size=SERVE_CHUNK, backend="auto")
    conf = GPServerConfig(pipeline=pipe, policy=BatchingPolicy(max_points=10 * len(xq),
                                                               max_wait_s=30.0), seed=SEED)
    bounds = np.linspace(0, len(xq), N_MULTI_REQ + 1).astype(int)
    ops.reset_launch_counts()
    server = GPServer(params_m, xm_tr, ym_tr, conf, index=index_m, device=dev)
    t = time.perf_counter()
    with server:
        futs = [server.submit(xq[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]
        server.flush()
        served = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t
    c = ops.launch_counts()
    mean = np.concatenate([r.mean for r in served])
    var = np.concatenate([r.var for r in served])
    want = predict_synchronous(params_m, index_m, xq, pipe, seed=SEED, device=dev)
    same = np.array_equal(mean, want[0]) and np.array_equal(var, want[1])
    n_out = params_m.sigma2.shape[0]
    log(f"serving multi-output drain: {len(served)} requests, {len(xq)} points x {n_out} outputs "
        f"in {server.stats.summary()['n_batches']} batch, {wall:.3f} s "
        f"({len(xq) / wall:.0f} points/s); bitwise the synchronous loop: {same}; launches "
        f"sbv_predict {c['sbv_predict']} (the torch.linalg conditional, no kernel)")
    check(server.stats.summary()["n_batches"] == 1, "multi drain: more than one batch")
    check(mean.shape == (len(xq), n_out) and bool(np.isfinite(mean).all())
          and bool((var > 0).all()), "multi drain: bad output")
    check(same, "multi drain: served results differ from the synchronous loop")
    _, chunk0 = next(tpredict.iter_query_chunks(index_m, xq, BS_PRED, M_PRED, seed=SEED,
                                                chunk_size=SERVE_CHUNK))
    held = hold_served_chunk("multi drain chunk 0", dev, params_m, chunk0, mean, var)
    return dict(seconds=wall, bitwise=same, launches=c["sbv_predict"], chunk0=held)


def serving_phase(dev, results: dict, x_tr, y_tr, x_te, fit_params, beta_true, index,
                  work: str) -> dict:
    """Checkpoints, the autotuner and GP serving (ROADMAP items 11 and 12) on
    the single-output path's data, fitted params and 50,000 held-out points:

    a. ``save_checkpoint`` of the fitted params and one bf16 tensor, then
       ``restore_train_state(..., device=cuda)``: bitwise;
    b. ``autotune_loglik`` on the 200,000-point training set (a 20,000-row
       sample, bucket levels (0, 2, 4, 8) x tiers (bf16, f32, f64), best of
       3), its record reloaded to an equal dict, then ``fit_sbv(tuning=)`` on
       the sample (1 x 2);
    c. a drain-mode ``GPServer`` (f64, ``backend="auto"``, chunks of 4,096,
       the main path's index, whose structure is the generator's beta) on the
       50,000 points as 32 requests in one micro-batch, each request against
       its slice of ``predict_synchronous`` over the concatenation; the
       pipelined and synchronous loops timed per chunk;
    d. continuous mode: 48 requests of log-uniform sizes, alternately
       interactive and bulk, 2 cancelled mid-stream; each finished request
       against ``predict_synchronous`` of it alone, 4 against a lone
       ``predict_sbv``; latency per SLO class;
    e. the same stream through 2 replicas (a CUDA stream each) behind the
       affinity router;
    f. ``python -m repro_torch.launch.serve gp --tuning-record`` (b's
       record) alone and with ``--distributed-hosts 2``.

    The kernels are held against their plain versions at the phase's own
    shapes: in b, every bucket of every layout the autotuner timed, at each
    tier it probed; in c and d, served chunks (``hold_served_chunk``).

    Returns the phase's launches of the likelihood and predict kernels,
    its own and those counted in the CLI's processes."""
    import torch

    from repro_torch.ckpt import CheckpointManager, restore_train_state, save_checkpoint
    from repro_torch.ckpt.checkpoint import _flatten
    from repro_torch.core import SBVConfig, vecchia
    from repro_torch.core import predict as tpredict
    from repro_torch.core.buckets import bucket_blocks, cast_packed
    from repro_torch.core.fit import fit_sbv
    from repro_torch.core.kernels_math import KernelParams
    from repro_torch.core.pipeline import preprocess
    from repro_torch.kernels import ops
    from repro_torch.kernels.sbv_loglik import sbv_loglik_cuda, sbv_loglik_plain
    from repro_torch.serving import (BatchingPolicy, ChunkTimer, GPServer, GPServerConfig,
                                     PipelineConfig, ReplicaRouter, SchedulerPolicy,
                                     predict_pipelined, predict_synchronous)
    from repro_torch.tuning import TuningRecord, autotune_loglik, settled_tier

    total = {"sbv_loglik": 0, "sbv_predict": 0, "sbv_loglik_bf16": 0, "sbv_predict_bf16": 0}
    out = {}

    def count(step):
        c = _launch_line(step, ops.launch_counts())
        for k in total:
            total[k] += c.get(k, 0)
        return c

    # a. Checkpoints.
    ops.reset_launch_counts()
    t = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    state = {"params": fit_params,
             "bf16": torch.randn(64, 96, generator=g, device=dev).to(torch.bfloat16)}
    path = save_checkpoint(os.path.join(work, "ckpt"), OUTER * INNER, state,
                           extras={"phase": "serving"})
    restored, manifest = restore_train_state(path, state, device=dev)
    flat_a, flat_b = _flatten(state), _flatten(restored)
    bits = lambda v: v.view(torch.int16) if v.dtype == torch.bfloat16 else v
    same = all(flat_b[k].is_cuda and flat_b[k].dtype == v.dtype
               and torch.equal(bits(flat_b[k]), bits(v)) for k, v in flat_a.items())
    mgr = CheckpointManager(os.path.join(work, "ckpt_async"), keep=1)
    mgr.save(1, state)
    mgr.save(2, state)
    mgr.close()
    kept = sorted(os.listdir(os.path.join(work, "ckpt_async")))
    log(f"serving step a (checkpoint): {len(flat_a)} leaves (bf16 {tuple(state['bf16'].shape)}) "
        f"saved and restored onto {dev} bitwise={same}; manifest step {manifest['step']}; "
        f"async keep-1 left {kept}; {time.perf_counter() - t:.2f} s")
    check(same, "checkpoint: a restored leaf differs from the saved one")
    check(kept == ["step_00000002"], f"checkpoint manager kept {kept}")
    count("a")

    # b. The autotuner on the training set, then a fit from its record.
    ops.reset_launch_counts()
    tdir = os.path.join(work, "tuning")
    cfg_t = SBVConfig(n_blocks=TUNE_SAMPLE // 100, m=M_FIT, seed=SEED)
    torch.cuda.synchronize()
    t = time.perf_counter()
    rec = autotune_loglik(x_tr, y_tr, cfg_t, sample_rows=TUNE_SAMPLE, bucket_grid=(0, 2, 4, 8),
                          tiers=("bf16", "f32", "f64"), repeats=TUNE_REPEATS, save_dir=tdir,
                          device=dev)
    t_tune = time.perf_counter() - t
    for c in rec.candidates:
        log(f"autotune candidate K={c['n_buckets'] or '-'} tier={c['precision']}: "
            f"{1e3 * c['time_s']:.3f} ms, occupancy {c['occupancy']:.4f}, tiers {c['tiers']}")
    log(f"autotune: {t_tune:.2f} s for {len(rec.candidates)} candidates on {TUNE_SAMPLE} of "
        f"{len(x_tr)} rows (bs_max {rec.meta['bs_max']}, m {rec.meta['m']}); winner "
        f"K={rec.n_buckets} precision={rec.precision} tiers={rec.bucket_tiers} occupancy "
        f"{rec.occupancy:.4f}, stream_chunk={rec.stream_chunk}, device cache budget "
        f"{rec.device_cache_budget / 2**30:.2f} GiB")
    c = count("b (autotune)")
    check(c["sbv_loglik"] + c["sbv_loglik_bf16"] > 0, "autotune: no likelihood kernel launch")
    check(len(rec.candidates) == 12 and all(math.isfinite(c_["time_s"]) and c_["time_s"] > 0
                                            for c_ in rec.candidates),
          "autotune: missing or bad candidate times")
    check(TuningRecord.load(tdir).to_dict() == rec.to_dict(), "autotune: record reload differs")
    # The likelihood kernel at the autotuner's shapes: its sample, params
    # and structure rebuilt as autotune_loglik builds them; every bucket of
    # the uniform layout and of K = 2, 4, 8, cast to each tier (what the
    # probes launch; a timed candidate runs each bucket at one of these),
    # against the plain version per block: f64 1e-9, f32 and bf16 at the
    # ladder's limits (the same nugget of 1e-3 as the fit's initial params).
    idx = np.linspace(0, len(x_tr) - 1, TUNE_SAMPLE).astype(np.int64)
    t = time.perf_counter()
    p_t = KernelParams.create(sigma2=float(np.var(y_tr[idx])), beta=0.5, nugget=1e-3,
                              d=x_tr.shape[1], device=dev)
    packed_t, _ = preprocess(x_tr[idx], y_tr[idx], p_t.beta.cpu().numpy(), cfg_t)
    check((packed_t.bs_max, packed_t.m) == (rec.meta["bs_max"], rec.meta["m"]),
          "autotune: the rebuilt sample's shapes differ from the record's")
    lim = {"f64": 1e-9, "f32": LADDER_TOL_F32, "bf16": LADDER_TOL_BF16}
    tune_err, n_held = dict.fromkeys(lim, 0.0), 0
    for k in (0, 2, 4, 8):
        for pk in (bucket_blocks(packed_t, n_buckets=k).buckets if k else [packed_t]):
            for tier in lim:
                dt = torch.float64 if tier == "f64" else torch.float32
                a = vecchia.packed_arrays(cast_packed(pk, tier), dev)
                pr = (p_t.beta.to(dt), p_t.sigma2.to(dt), p_t.nugget.to(dt))
                with torch.no_grad():
                    got, want = sbv_loglik_cuda(*pr, *a), sbv_loglik_plain(*pr, *a)
                check(bool(torch.isfinite(got).all()), f"autotune K={k} {tier}: non-finite")
                tune_err[tier] = max(tune_err[tier], block_rel(got, want))
                n_held += 1
    log(f"autotune shapes: {n_held} (bucket, tier) launches vs plain "
        f"({time.perf_counter() - t:.2f} s): per-block max rel "
        + ", ".join(f"{k_} {v:.3e} (limit {lim[k_]:g})" for k_, v in tune_err.items()))
    check(all(tune_err[k_] <= lim[k_] for k_ in lim),
          f"autotune shapes: kernel vs plain {tune_err} beyond {lim}")
    out["autotune_plain_rel"] = tune_err
    ops.reset_launch_counts()
    t = time.perf_counter()
    fit_t = fit_sbv(x_tr[idx], y_tr[idx], cfg_t, inner_steps=2, outer_rounds=1, tuning=tdir,
                    device=dev)
    losses = [h[2] for h in fit_t.history]
    log(f"fit_sbv(tuning=record) on the sample, 1 x 2: {time.perf_counter() - t:.2f} s, "
        f"losses {losses}, tiers {fit_t.precision_tiers}")
    count("b (fit from the record)")
    check(len(losses) == 2 and all(math.isfinite(v) for v in losses) and losses[1] < losses[0],
          "fit_sbv(tuning=): losses missing, non-finite or not decreasing")
    out["autotune"] = dict(seconds=t_tune, winner=[rec.n_buckets, rec.precision],
                           candidates=rec.candidates)

    # c. Drain mode: the 50,000 points as 32 requests in one micro-batch.
    pipe = PipelineConfig(bs_pred=BS_PRED, m_pred=M_PRED, chunk_size=SERVE_CHUNK,
                          backend="auto")
    bounds = np.linspace(0, len(x_te), N_DRAIN_REQ + 1).astype(int)
    reqs = [x_te[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    conf = GPServerConfig(pipeline=pipe, policy=BatchingPolicy(max_points=10 * len(x_te),
                                                               max_wait_s=30.0), seed=SEED)
    ops.reset_launch_counts()
    server = GPServer(fit_params, x_tr, y_tr, conf, index=index, device=dev)
    t = time.perf_counter()
    with server:
        futs = [server.submit(r) for r in reqs]
        server.flush()
        served = [f.result(timeout=600) for f in futs]
    wall_srv = time.perf_counter() - t
    c = count("c (drain server)")
    n_chunks = math.ceil(len(x_te) / SERVE_CHUNK)
    st_ = server.stats.summary()
    log(f"serving drain: {len(reqs)} requests in {st_['n_batches']} batch(es), {wall_srv:.3f} s "
        f"({len(x_te) / wall_srv:.0f} points/s, latency p50 {st_['latency_p50_s']:.3f} s)")
    check(st_["n_batches"] == 1, f"drain: {st_['n_batches']} batches, expected 1")
    check(c["sbv_predict"] == n_chunks, f"drain: {c['sbv_predict']} predict launches, "
          f"expected {n_chunks}")
    # The batch's chunk 0 (4,096 points, the batch's seed, SEED), as the
    # server packed it.
    _, chunk0 = next(tpredict.iter_query_chunks(index, x_te, BS_PRED, M_PRED, seed=SEED,
                                                chunk_size=SERVE_CHUNK))
    out["drain_plain"] = hold_served_chunk(
        "drain chunk 0", dev, fit_params, chunk0, np.concatenate([r.mean for r in served]),
        np.concatenate([r.var for r in served]))
    timers = {}
    ops.reset_launch_counts()
    for label, runner in (("synchronous", predict_synchronous), ("pipelined", predict_pipelined),
                          ("pipelined again", predict_pipelined),
                          ("synchronous again", predict_synchronous)):
        timers[label] = ChunkTimer()
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = runner(fit_params, index, x_te, pipe, seed=SEED, device=dev, timer=timers[label])
        torch.cuda.synchronize()
        out[label] = _chunk_line(label, len(x_te), time.perf_counter() - t, timers[label])
        if label == "synchronous":
            want = got
        else:
            check(all(np.array_equal(a_, b_) for a_, b_ in zip(got, want)),
                  f"serving: the {label} loop is not bitwise the synchronous one")
    err = max(max(float(np.abs(r.mean - want[0][a:b]).max()),
                  float(np.abs(r.var - want[1][a:b]).max()))
              for r, a, b in zip(served, bounds[:-1], bounds[1:]))
    log(f"serving drain: each request vs its slice of predict_synchronous over the "
        f"concatenation: max |delta| {err:.3e} (limit 1e-12)")
    check(err <= 1e-12, f"drain serving parity {err:.3e} > 1e-12")
    check(bool(np.isfinite(want[0]).all()) and bool((want[1] > 0).all()), "serving: bad output")
    c = count("c (pipelined and synchronous loops)")
    check(c["sbv_predict"] == 4 * n_chunks, "serving loops: predict launches")

    # d. Continuous mode: 48 requests, 2 cancelled mid-stream.
    rng = np.random.default_rng(SEED + 20)
    sizes = np.minimum(MAX_REQ, np.exp(rng.uniform(0, math.log(MAX_REQ), N_CONT_REQ))
                       .astype(int) + 1)
    starts = rng.integers(0, len(x_te) - sizes)
    stream = [(x_te[s0:s0 + n], "interactive" if i % 2 == 0 else "bulk")
              for i, (s0, n) in enumerate(zip(starts, sizes))]
    bulk = [i for i, (_, slo) in enumerate(stream) if slo == "bulk"]
    # The largest bulk requests, in submission order (FIFO within a class),
    # so each is still running when its cancel comes.
    victims = sorted(sorted(bulk, key=lambda i: -len(stream[i][0]))[:N_CANCEL])
    sconf = GPServerConfig(pipeline=pipe, policy=BatchingPolicy(max_wait_s=0.002),
                           scheduler=SchedulerPolicy(), seed=SEED)
    refs = []
    for xq, _ in stream:
        refs.append(predict_synchronous(fit_params, index, xq, pipe, seed=SEED, device=dev))
    ops.reset_launch_counts()
    server = GPServer(fit_params, x_tr, y_tr, sconf, index=index, device=dev)
    t = time.perf_counter()
    with server:
        futs = [server.submit(xq, slo=slo) for xq, slo in stream]
        for v in victims:
            # Mid-stream: cancel once the victim's first chunk is dispatched.
            deadline = time.monotonic() + 120
            while getattr(server._sched._by_future.get(futs[v]), "next_ci", 0) < 1:
                check(time.monotonic() < deadline and not futs[v].done(),
                      f"request {v} never started or finished before its cancel")
                time.sleep(0.0005)
            check(server.cancel(futs[v]), f"cancel of request {v} refused")
        server.flush()
        done = {i: f.result(timeout=600) for i, f in enumerate(futs) if i not in victims}
    wall_c = time.perf_counter() - t
    c = count("d (continuous)")
    check(c["sbv_predict"] > 0, "continuous: no predict launch")
    check(all(futs[v].cancelled() for v in victims), "continuous: a victim was not cancelled")
    err = max(max(float(np.abs(r.mean - refs[i][0]).max()),
                  float(np.abs(r.var - refs[i][1]).max())) for i, r in done.items())
    st_ = server.stats.summary()
    n_pts = int(sum(len(stream[i][0]) for i in done))
    log(f"serving continuous: {len(done)} requests ({n_pts} points, sizes {int(sizes.min())}-"
        f"{int(sizes.max())}) in {wall_c:.3f} s; cancelled {st_['n_cancelled']} "
        f"(requests {victims}, {[len(stream[v][0]) for v in victims]} points); preempted "
        f"{st_['n_preempted']}; each vs predict_synchronous alone: max |delta| {err:.3e}")
    for name, cls in st_["by_class"].items():
        log(f"serving continuous {name}: n={cls['n']} latency p50 {cls['latency_p50_s']:.4f} s "
            f"p99 {cls['latency_p99_s']:.4f} s")
    check(err <= 1e-12, f"continuous serving parity {err:.3e} > 1e-12")
    check(st_["n_cancelled"] == N_CANCEL, f"continuous: {st_['n_cancelled']} cancelled")
    # Chunk 0 of the smallest and of the largest finished request, packed as
    # the scheduler packs a (request, chunk) unit (pipeline.pack_scheduled).
    for i in (min(done, key=lambda i: len(stream[i][0])),
              max(done, key=lambda i: len(stream[i][0]))):
        xq = stream[i][0]
        unit = tpredict.pack_queries(index, xq[:min(len(xq), SERVE_CHUNK)], BS_PRED, M_PRED,
                                     seed=SEED, pad_shapes=True)
        out[f"continuous_plain_{len(xq)}"] = hold_served_chunk(
            f"continuous request {i} chunk 0", dev, fit_params, unit, done[i].mean, done[i].var)
    out["continuous"] = dict(wall_s=wall_c, points=n_pts, by_class=st_["by_class"],
                             n_preempted=st_["n_preempted"])
    lone = sorted(done, key=lambda i: len(stream[i][0]))[::max(1, len(done) // 4)][:4]
    lone_err = 0.0
    for i in lone:
        p_ = tpredict.predict_sbv(fit_params, x_tr, y_tr, stream[i][0], bs_pred=BS_PRED,
                                  m_pred=M_PRED, seed=SEED, chunk_size=SERVE_CHUNK, n_sims=2,
                                  beta_struct=beta_true, device=dev)
        lone_err = max(lone_err, float(np.abs(done[i].mean - p_.mean).max()),
                       float(np.abs(done[i].var - p_.var).max()))
    log(f"serving continuous vs lone predict_sbv on requests {lone} "
        f"({[len(stream[i][0]) for i in lone]} points): max |delta| {lone_err:.3e}")
    check(lone_err <= 1e-12, f"served vs lone predict_sbv {lone_err:.3e} > 1e-12")

    # e. The same stream through 2 replicas behind the affinity router.
    ops.reset_launch_counts()
    reps = [GPServer(fit_params, x_tr, y_tr, sconf, index=index, device=dev) for _ in range(2)]
    t = time.perf_counter()
    with ReplicaRouter(reps, routing="affinity", seed=SEED) as router:
        futs = [router.submit(xq, slo=slo) for xq, slo in stream]
        router.flush()
        routed = [f.result(timeout=600) for f in futs]
    wall_r = time.perf_counter() - t
    c = count("e (2 replicas)")
    rs = router.summary()
    err = max(max(float(np.abs(r.mean - refs[i][0]).max()),
                  float(np.abs(r.var - refs[i][1]).max())) for i, r in enumerate(routed))
    log(f"serving router: {len(stream)} requests over 2 replicas in {wall_r:.3f} s; affinity "
        f"hit rate {rs['affinity_hit_rate']:.3f}, requests per replica "
        f"{rs['replica_requests']}, shapes {[r_['n_compiled_shapes'] for r_ in rs['replicas']]};"
        f" each vs predict_synchronous alone: max |delta| {err:.3e}")
    check(c["sbv_predict"] > 0, "router: no predict launch")
    check(err <= 1e-12, f"routed serving parity {err:.3e} > 1e-12")
    out["router"] = dict(wall_s=wall_r, affinity_hit_rate=rs["affinity_hit_rate"],
                         replica_requests=rs["replica_requests"])

    # g. Bucketed continuous serving (ROADMAP fault 7's path): the same
    # stream at 4 bucket levels, each request bitwise its bucketed
    # synchronous loop; one sbv_predict launch per (request, chunk) unit over
    # the unit's bucket pieces; chunk 0 of the largest request held piece by
    # piece against the plain version.
    from repro_torch.serving.pipeline import make_chunk_split

    pipe_b = PipelineConfig(bs_pred=BS_PRED, m_pred=M_PRED, chunk_size=SERVE_CHUNK,
                            backend="auto", n_buckets=N_BUCKETS)
    bconf = GPServerConfig(pipeline=pipe_b, policy=BatchingPolicy(max_wait_s=0.002),
                           scheduler=SchedulerPolicy(), seed=SEED)
    brefs = [predict_synchronous(fit_params, index, xq, pipe_b, seed=SEED, device=dev)
             for xq, _ in stream]
    ops.reset_launch_counts()
    server = GPServer(fit_params, x_tr, y_tr, bconf, index=index, device=dev)
    t = time.perf_counter()
    with server:
        futs = [server.submit(xq, slo=slo) for xq, slo in stream]
        server.flush()
        bdone = [f.result(timeout=600) for f in futs]
    wall_b = time.perf_counter() - t
    c = count("g (bucketed continuous)")
    n_units = sum(math.ceil(len(xq) / SERVE_CHUNK) for xq, _ in stream)
    same = all(np.array_equal(r.mean, brefs[i][0]) and np.array_equal(r.var, brefs[i][1])
               for i, r in enumerate(bdone))
    log(f"serving bucketed continuous ({N_BUCKETS} levels): {len(bdone)} requests "
        f"({sum(len(xq) for xq, _ in stream)} points, {n_units} units) in {wall_b:.3f} s; "
        f"bitwise the bucketed synchronous loop: {same}; sbv_predict launches "
        f"{c['sbv_predict']} (expected {n_units}: one per unit over its buckets)")
    check(same, "bucketed continuous serving differs from its synchronous loop")
    check(c["sbv_predict"] == n_units, f"bucketed continuous: {c['sbv_predict']} predict "
          f"launches, expected {n_units}")
    big = max(range(len(stream)), key=lambda i: len(stream[i][0]))
    xq = stream[big][0]
    unit = tpredict.pack_queries(index, xq[:min(len(xq), SERVE_CHUNK)], BS_PRED, M_PRED,
                                 seed=SEED, pad_shapes=True)
    # (A piece of padding blocks alone holds no query to compare.)
    pieces = [pc for pc in make_chunk_split(pipe_b)(unit) if np.asarray(pc.q_mask).any()]
    out["bucketed_plain"] = [hold_served_chunk(
        f"bucketed request {big} chunk 0 piece {j}", dev, fit_params, pc, bdone[big].mean,
        bdone[big].var) for j, pc in enumerate(pieces)]
    out["bucketed"] = dict(wall_s=wall_b, units=n_units, launches=c["sbv_predict"],
                           pieces=len(pieces))

    # f. The serve CLI from b's record, alone and on 2 ranks. The record
    # fills the buckets, the backend and the tier: the widest its winner's
    # buckets settled at, since serving probes nothing (a narrow label the
    # probe demoted everywhere would be ROADMAP fault 4).
    env = dict(os.environ, PYTHONPATH=os.path.join(str(ROOT), "src"))
    cli = [sys.executable, "-m", "repro_torch.launch.serve", "gp", "--n-train",
           str(SERVE_CLI_TRAIN), "--n-test", str(SERVE_CLI_TEST), "--requests",
           str(N_DRAIN_REQ), "--scheduler", "continuous", "--chunk", str(SERVE_CHUNK),
           "--bs-pred", str(BS_PRED), "--m-pred", str(M_PRED), "--tuning-record", tdir,
           "--seed", str(SEED)]
    cli_launches = {}
    for label, extra in (("alone", []), ("2 ranks", ["--distributed-hosts", str(N_RANKS),
                                                     "--timeout", str(RANK_TIMEOUT)])):
        res_json = os.path.join(work, f"serve_{len(extra)}.json")
        t = time.perf_counter()
        proc = subprocess.run(cli + extra + ["--result-json", res_json], env=env,
                              capture_output=True, text=True, timeout=2 * RANK_TIMEOUT)
        secs = time.perf_counter() - t
        for line in proc.stdout.splitlines():
            if "[serve-gp]" in line and "hostname" not in line:
                log(f"  {line}")
        check(proc.returncode == 0, f"serve gp ({label}) exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        with open(res_json) as f:
            res = json.load(f)
        if extra:
            lc = {k: sum(rk["launches"].get(k, 0) for rk in res["ranks"]) for k in total}
            log(f"serve gp --distributed-hosts {N_RANKS}: {secs:.1f} s; served parity "
                f"{res['served_parity_max']:.3e}, multi-host mean/var "
                f"{res['multihost_mean_var_max']:.3e}, simulations "
                f"{res['multihost_sim_max']:.3e}; requests per rank "
                f"{[rk['n_requests'] for rk in res['ranks']]}")
            check(all(rk["served_parity_max"] <= 1e-12 for rk in res["ranks"]),
                  "serve gp ranks: served parity > 1e-12")
            check(res["multihost_mean_var_max"] == 0.0, "serve gp ranks: mean/var not bitwise")
            check(res["multihost_sim_max"] <= 1e-8, "serve gp ranks: simulations > 1e-8")
            check(all(rk["launches"]["sbv_predict"] > 0 for rk in res["ranks"]),
                  "serve gp ranks: a rank launched no predict kernel")
        else:
            lc = {k: res["launches"].get(k, 0) for k in total}
            tier = settled_tier(rec) or "f64"
            log(f"serve gp: {secs:.1f} s with the process start; {res['points_per_s']:.0f} "
                f"points/s served at {res['precision']} (the record: label {rec.precision}, "
                f"buckets settled at {rec.bucket_tiers}); by class {res['by_class']}")
            check(res["precision"] == tier, f"serve gp served {res['precision']}, the record "
                  f"settled at {tier}")
            check(lc["sbv_predict"] + lc["sbv_predict_bf16"] > 0, "serve gp: no predict launch")
        _launch_line(f"f ({label})", lc)
        for k in total:
            total[k] += lc[k]
            cli_launches[k] = cli_launches.get(k, 0) + lc[k]
    out["cli_launches"] = cli_launches
    results["serving"] = out
    return total


FLASH_ROUTE_OF = {"flash_attention": "wgmma", "flash_attention_bwd": "wgmma",
                  "flash_attention_hd256": "wgmma", "flash_attention_bwd_hd256": "wgmma",
                  "flash_attention_hd80": "wgmma", "flash_attention_bwd_hd80": "wgmma"}


def flash_counts(results: dict, lm_launches: dict, g2_launches: dict, moe_launches: dict,
                 fam_launches: dict) -> tuple[dict, dict]:
    """The flash entries' launches, each of its own route: the hd-128
    entries ('wgmma' forward and backward) count the internlm2 and
    qwen2-moe paths' (``lm_launches`` plus the qwen2-moe serving and
    training runs'), the hd-256 entries ('wgmma' forward and backward, the
    256-thread kernels) the gemma2 paths' (each phase holds its path's route, and
    every flash launch of a path is at its model's head_dim; the same
    wrappers count both, as LAUNCHES["flash_attention"] and
    ["flash_attention_bwd"]). Also fills ``results`` for the hd-256
    entries: times at the gemma2 path's global shapes, the local window's
    beside them, the scalar kernels they replaced (``baseline_ms``), the
    library call (``flex_library``) and SDPA without the softcap as a
    yardstick. Returns (hd-128 counts, hd-256 counts)."""
    lm_launches = dict(lm_launches)
    for counts in (moe_launches, fam_launches[MOE_ARCH]):
        for k, v in counts.items():
            lm_launches[k] = lm_launches.get(k, 0) + v
    g2k, g2b = results["gemma2"]["kernel"], results["families_training"]["kernel_bwd"]
    hd256 = {"flash_attention_hd256": g2_launches["flash_attention"]
             + fam_launches[G2_ARCH]["flash_attention"],
             "flash_attention_bwd_hd256": fam_launches[G2_ARCH]["flash_attention_bwd"]}
    log(f"flash launches by route: 'wgmma' forward {lm_launches['flash_attention']}, backward "
        f"{lm_launches['flash_attention_bwd']} (internlm2 and qwen2-moe, hd 128); 'wgmma' "
        f"forward {hd256['flash_attention_hd256']}, backward "
        f"{hd256['flash_attention_bwd_hd256']} (gemma2, hd 256)")
    check(hd256["flash_attention_hd256"] > 0 and hd256["flash_attention_bwd_hd256"] > 0,
          "the hd-256 routes were not launched on the gemma2 paths")
    for kname, kr in (("flash_attention_hd256", g2k), ("flash_attention_bwd_hd256", g2b)):
        results[kname] = dict(max_abs_err=max(kr[w]["max_abs_err"] for w in kr),
                              ms=kr["global"]["ms"], plain_ms=kr["global"]["plain_ms"],
                              bound_ms=kr["global"]["bound_ms"],
                              bound_by=kr["global"]["bound_by"],
                              library_ms=kr["global"]["library_ms"],
                              baseline_ms=kr["global"]["baseline_ms"],
                              local_baseline_ms=kr["local"]["baseline_ms"],
                              local_ms=kr["local"]["ms"], local_plain_ms=kr["local"]["plain_ms"],
                              local_bound_ms=kr["local"]["bound_ms"],
                              local_library_ms=kr["local"]["library_ms"],
                              sdpa_no_softcap_ms=[kr[w]["sdpa_no_softcap_ms"] for w in kr])
    return lm_launches, hd256


def kernel_entry(kname: str, src: str, replaces: str, launches: int, r: dict) -> dict:
    """One kernel's entry of the kernels line, from its ``results`` record."""
    return {"name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "baseline_ms": r.get("baseline_ms"),
            "fill_ms": r.get("fill_ms"), "rank_launches": r.get("rank_launches"),
            **({"rank_launches_by_run": r["rank_launches_by_run"]}
               if "rank_launches_by_run" in r else {}),
            **({"flash_route": FLASH_ROUTE_OF[kname]} if kname in FLASH_ROUTE_OF else {}),
            **{key: r[key] for key in ("local_ms", "local_plain_ms", "local_bound_ms",
                                       "local_library_ms", "local_baseline_ms",
                                       "sdpa_no_softcap_ms") if key in r}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.core import KernelParams, SBVConfig, preprocess
    from repro_torch.core import multioutput as mo
    from repro_torch.core import predict as tpredict
    from repro_torch.core import vecchia
    from repro_torch.core.fit import fit_sbv, neg_loglik_fn
    from repro_torch.data.gp_sim import metarvm_field_dataset, paper_synthetic_chunks
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.matern_cov import _launch as cov_launch
    from repro_torch.kernels.matern_cov import matern_cov_cuda, matern_cov_plain
    from repro_torch.kernels.sbv_loglik import _launch as loglik_launch
    from repro_torch.kernels.sbv_loglik import sbv_loglik_cuda, sbv_loglik_plain
    from repro_torch.kernels.sbv_multi_stats import _launch as multi_launch
    from repro_torch.kernels.sbv_multi_stats import sbv_multi_stats_cuda, sbv_multi_stats_plain
    from repro_torch.kernels.sbv_predict import _launch_panel as predict_panel
    from repro_torch.kernels.sbv_predict import sbv_predict_cuda, sbv_predict_plain

    t_start = time.perf_counter()
    dev = torch.device(DEVICE)
    # The plain versions' float32 matmuls must run in full float32 (not TF32,
    # ~3 decimal digits) so that an f32 comparison measures the kernel.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32 off: the plain versions' f32 matmuls run in full f32, so an f32 comparison "
        "measures the kernel and not TF32 rounding")

    # 1. Card info.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(f"peaks used for bounds: f64 {peaks['f64'] / 1e12:g} TFLOP/s (outside the tensor "
        f"cores {peaks['f64_simt'] / 1e12:g}), bf16 "
        f"{peaks['bf16'] / 1e12:g} TFLOP/s, HBM {peaks['hbm'] / 1e12:g} TB/s")

    # 2. Build, with the host's data generation (below) running meanwhile on
    # a thread: numpy's cos and matmul release the GIL while nvcc runs.
    import concurrent.futures

    gen_pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    t_gen0 = time.perf_counter()
    gen_job = gen_pool.submit(lambda: [c for c in paper_synthetic_chunks(SEED, N_TRAIN + N_TEST,
                                                                         d=D)])
    t = time.perf_counter()
    nvcc_out = io.StringIO()
    with contextlib.redirect_stdout(nvcc_out):
        paths = _build.build(verbose=True)
    sys.stdout.write(nvcc_out.getvalue())
    log(f"build: {time.perf_counter() - t:.1f} s -> {', '.join(p.name for p in paths.values())}")
    for line in ptxas_summary(nvcc_out.getvalue(), "Li80E"):
        log(f"ptxas (-Xptxas=-v), hd 80: {line}")
    log(f"matern_cov resident CTAs per SM at d={D} f32/f64/bf16: "
        f"{[_build.load('matern_cov').matern_cov_ctas_per_sm(D, v) for v in (0, 1, 2)]}")

    # Data: one realization, 200k train + 50k held out (generated during
    # the build).
    t = time.perf_counter()
    xs, ys = zip(*gen_job.result())
    gen_pool.shutdown()
    x_all, y_all = np.concatenate(xs), np.concatenate(ys)
    x_tr, y_tr = x_all[:N_TRAIN], y_all[:N_TRAIN]
    x_te, y_te = x_all[N_TRAIN:], y_all[N_TRAIN:]
    t_gen = time.perf_counter() - t_gen0
    log(f"phase generate: {t_gen:.2f} s (n={N_TRAIN + N_TEST}, d={D}; beside the build, "
        f"{time.perf_counter() - t:.2f} s of it after the build)")
    log(json.dumps({"reduced": {"n_train": [500_000, N_TRAIN], "n_test": N_TEST,
                                "ladder_n_test": [N_TEST, N_LADDER_TEST],
                                "why": "host preprocess time grows faster than linearly in n; "
                                       "d, m, bs, m_pred, bs_pred and dtype are full"}}))

    cfg = SBVConfig(n_blocks=N_TRAIN // 100, m=M_FIT, seed=SEED)
    init = KernelParams.create(sigma2=float(np.var(y_tr)), beta=0.5, nugget=1e-3, d=D)
    beta_true = np.full(D, 5.0)
    beta_true[:2] = 0.05
    true_p = KernelParams.create(sigma2=1.0, beta=beta_true, nugget=1e-8, device=dev)

    # Round-0 structure of the fit (at the init params), for the kernel checks.
    t = time.perf_counter()
    packed0, _ = _memo(preprocess, "preprocess")(x_tr, y_tr, init.beta.numpy(), cfg)
    t_pre = time.perf_counter() - t
    log(f"phase preprocess: {t_pre:.2f} s (bc={packed0.n_blocks}, bs_max={packed0.bs_max}, "
        f"m={packed0.m})")

    p0 = init.to(device=dev)
    cast = lambda ts, dt: tuple(a.to(dt) if a.is_floating_point() else a for a in ts)
    par = lambda p, dt: (p.beta.to(dt), p.sigma2.to(dt), p.nugget.to(dt))
    results = {"card": card}

    # 3. Likelihood kernel against its plain version.
    qs_x, qs_y = x_tr[:4500], y_tr[:4500]
    quick, _ = preprocess(qs_x, qs_y, init.beta.numpy(), SBVConfig(n_blocks=90, m=40, seed=SEED))
    cases = [("full", slice_blocks(packed0, packed0.bs_max, M_FIT, 256)),
             ("ragged", slice_blocks(packed0, 37, 61, 256)),
             ("quickstart", quick)]
    full_err = None
    for label, pk in cases:
        arrs = vecchia.packed_arrays(pk, dev)
        want = sbv_loglik_plain(*par(p0, torch.float64), *arrs)
        got = sbv_loglik_cuda(*par(p0, torch.float64), *arrs)
        got32 = sbv_loglik_cuda(*par(p0, torch.float32), *cast(arrs, torch.float32))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs()).max())
        rel32 = abs(float(got32.double().sum()) - float(want.sum())) / abs(float(want.sum()))
        log(f"loglik {label}: bc={pk.n_blocks} bs={pk.bs_max} m={pk.m} f64 max_abs_err={err:.3e} "
            f"max_rel_err={rel:.3e}; f32 sum rel_err={rel32:.3e}")
        check(bool(torch.isfinite(got).all()), f"loglik {label}: non-finite kernel output")
        check(rel <= 1e-9, f"loglik {label}: f64 kernel vs plain rel err {rel:.3e} > 1e-9")
        check(rel32 <= 5e-4, f"loglik {label}: f32 kernel vs f64 rel err {rel32:.3e} > 5e-4")
        if label == "full":
            full_err = err

    # The earlier design (padded blocks, panel_cholesky), kept callable for
    # this side-by-side timing: the same values to 1e-10 on the full case.
    arrs_f = vecchia.packed_arrays(cases[0][1], dev)
    base = loglik_launch("sbv_loglik_panel", *par(p0, torch.float64), *arrs_f, nu=3.5)
    tiled = sbv_loglik_cuda(*par(p0, torch.float64), *arrs_f)
    base_rel = float(((tiled - base).abs() / base.abs()).max())
    log(f"loglik tiled vs panel_cholesky baseline (full case, f64): max rel {base_rel:.3e}")
    check(base_rel <= 1e-10, f"loglik tiled vs baseline rel {base_rel:.3e} > 1e-10")
    del arrs_f, base, tiled

    # Time at the main path's shape: one likelihood evaluation of round 0,
    # beside the earlier design (parent, change, change, parent).
    arrs0 = vecchia.packed_arrays(packed0, dev)
    panel_f64 = lambda: loglik_launch("sbv_loglik_panel", *par(p0, torch.float64), *arrs0, nu=3.5)
    kb1_ms = cuda_ms(panel_f64)
    k_ms = cuda_ms(lambda: sbv_loglik_cuda(*par(p0, torch.float64), *arrs0))
    k32_ms = cuda_ms(lambda: sbv_loglik_cuda(*par(p0, torch.float32),
                                             *cast(arrs0, torch.float32)))
    kb2_ms = cuda_ms(panel_f64)
    with torch.no_grad():
        pl_ms = cuda_ms(lambda: sbv_loglik_plain(*par(p0, torch.float64), *arrs0), reps=3)
    flops, nbytes = loglik_work(packed0)
    b_ms, b_by = bound_ms(flops, nbytes, peaks)
    lib_ll = _build.load("sbv_loglik")
    per_sm = lib_ll.sbv_loglik_ctas_per_sm(packed0.bs_max, packed0.m, D, 1)
    per_sm_b = lib_ll.sbv_loglik_panel_ctas_per_sm(packed0.bs_max, packed0.m, D, 1)
    tr_old, tr_new = block_traffic(packed0)
    log(f"loglik time at bc={packed0.n_blocks} bs={packed0.bs_max} m={packed0.m}: kernel f64 "
        f"{k_ms:.3f} ms, f32 {k32_ms:.3f} ms; panel_cholesky baseline f64 {kb1_ms:.3f} / "
        f"{kb2_ms:.3f} ms (before / after); plain f64 {pl_ms:.3f} ms; bound {b_ms:.4f} ms "
        f"({b_by}; {flops:.3e} flop, {nbytes:.3e} B; {100 * b_ms / k_ms:.1f} % of the bound); "
        f"{per_sm} resident CTAs per SM (f64; baseline {per_sm_b})")
    log(f"loglik reckoned scratch traffic per evaluation (f64): panel_cholesky baseline "
        f"{tr_old / 1e9:.2f} GB, tiled {tr_new / 1e9:.2f} GB ({tr_old / tr_new:.1f}x less)")
    results["sbv_loglik"] = dict(max_abs_err=full_err, ms=k_ms, plain_ms=pl_ms, bound_ms=b_ms,
                                 bound_by=b_by, f32_ms=k32_ms, baseline_ms=[kb1_ms, kb2_ms])

    # 4. Gradient: the autograd.Function against autograd through the plain version.
    leaves = lambda: [t_.clone().requires_grad_(True) for t_ in p0]
    lk = leaves()
    g_k = torch.autograd.grad(ops.sbv_loglik(KernelParams(*lk), *arrs0), lk)
    # Autograd through the plain version in 500-block pieces (the whole
    # batch at once would hold ~35 GB of intermediates).
    g_p = [torch.zeros_like(t_) for t_ in p0]
    for s0 in range(0, packed0.n_blocks, 500):
        lp = leaves()
        part = vecchia.batched_block_loglik(KernelParams(*lp), *(a[s0:s0 + 500] for a in arrs0))
        for acc_, g_ in zip(g_p, torch.autograd.grad(part, lp)):
            acc_ += g_
    g_rel = max(float(((a - b).abs() / b.abs().clamp_min(1e-300)).max()) for a, b in zip(g_k, g_p))
    log(f"gradient at bc={packed0.n_blocks}: max rel err {g_rel:.3e} (chunk {ops.BACKWARD_CHUNK})")
    check(g_rel <= 1e-8, f"gradient rel err {g_rel:.3e} > 1e-8")
    del g_k, g_p
    torch.cuda.empty_cache()

    # 5. Predict kernel against its plain version, on the first chunk the
    # main path packs (true params structure, same seeds).
    index = tpredict.build_train_index(x_tr, y_tr, beta_true, M_PRED, seed=SEED)
    _, chunk0 = next(tpredict.iter_query_chunks(index, x_te, BS_PRED, M_PRED, seed=SEED,
                                                chunk_size=CHUNK))
    pcases = [("full", chunk0), ("ragged", None)]
    pred_err = None
    for label, pk in pcases:
        if pk is None:
            from repro_torch.core.packing import PackedPrediction

            pk = PackedPrediction(q_x=chunk0.q_x[:, :13], q_mask=chunk0.q_mask[:, :13],
                                  q_idx=chunk0.q_idx[:, :13], nn_x=chunk0.nn_x[:, :77],
                                  nn_y=chunk0.nn_y[:, :77], nn_mask=chunk0.nn_mask[:, :77],
                                  owners=chunk0.owners)
        arrs = tuple(torch.as_tensor(a).to(dev) for a in pk.arrays())
        msk = arrs[1]
        for pname, pp in (("true", true_p), ("init", p0)):
            want = sbv_predict_plain(*par(pp, torch.float64), *arrs)
            got = sbv_predict_cuda(*par(pp, torch.float64), *arrs)
            got32 = sbv_predict_cuda(*par(pp, torch.float32), *cast(arrs, torch.float32))
            torch.cuda.synchronize()
            errs, rels, errs32 = [], [], []
            for g, g32, w in zip(got, got32, want):
                dif = (g - w).abs()[msk]
                errs.append(float(dif.max()))
                rels.append(float((dif / w.abs()[msk].clamp_min(1e-300)).max()))
                errs32.append(float((g32.double() - w).abs()[msk].max()))
            scale = max(float(w.abs()[msk].max()) for w in want)
            # Rounding in the assembly moves the solve by up to eps * cond(K_NN).
            k_nn = vecchia._masked_cov(arrs[2], arrs[2], arrs[4].bool(), arrs[4].bool(),
                                       *par(pp, torch.float64), 3.5, identity=True)
            ev = torch.linalg.eigvalsh(k_nn)
            cond = float((ev[:, -1] / ev[:, 0]).max())
            del k_nn, ev
            log(f"predict {label} params={pname}: bc={pk.n_blocks} bs={pk.bs_pred} m={pk.m_pred} "
                f"f64 max_abs_err mu/var={errs[0]:.3e}/{errs[1]:.3e} max_rel={max(rels):.3e}; "
                f"f32 max_abs_err mu/var={errs32[0]:.3e}/{errs32[1]:.3e} (|out| max {scale:.3g}, "
                f"max cond(K_NN) {cond:.3e})")
            check(all(bool(torch.isfinite(g).all()) for g in got), "predict: non-finite output")
            # rtol 1e-10 (tests/test_predict_packed.py) where K_NN is well
            # conditioned (init params, nugget 1e-3); at the true params
            # (nugget 1e-8) the bound is the conditioning one, 10 eps cond.
            tol = 1e-10 if pname == "init" else max(1e-10, 10 * 2.2e-16 * cond)
            check(max(errs) <= tol * max(1.0, scale),
                  f"predict {label} {pname}: f64 kernel vs plain err {max(errs):.3e} "
                  f"> {tol:.1e} x {max(1.0, scale):.3g}")
            # f32 is held at the init params (nugget 1e-3), within 5e-4 of the
            # output scale, the reference's f32-vs-f64 rule for the likelihood
            # (tests/test_kernels_pallas.py:65). At the true params (nugget
            # 1e-8) K(NN, NN) is conditioned beyond float32: printed only.
            if pname == "init":
                check(max(errs32) <= 5e-4 * max(1.0, scale),
                      f"predict {label} {pname}: f32 kernel vs plain err {max(errs32):.3e}")
            if label == "full" and pname == "true":
                pred_err = max(errs)
    arrs_c = tuple(torch.as_tensor(a).to(dev) for a in chunk0.arrays())
    # The earlier design (padded blocks, panel_cholesky), kept callable for
    # the side-by-side timing: the same values at the init params (nugget
    # 1e-3, where the f64 check above holds at 1e-10).
    base = predict_panel(*par(p0, torch.float64), *arrs_c)
    tiled = sbv_predict_cuda(*par(p0, torch.float64), *arrs_c)
    sc = max(1.0, max(float(w.abs().max()) for w in base))
    base_err = max(float((g - w).abs().max()) for g, w in zip(tiled, base)) / sc
    log(f"predict tiled vs panel_cholesky baseline (chunk 0, init params, f64): max err "
        f"{base_err:.3e} of max(1, |out|) = {sc:.3g}")
    check(base_err <= 1e-10, f"predict tiled vs baseline {base_err:.3e} > 1e-10")
    del base, tiled
    panel_p = lambda: predict_panel(*par(true_p, torch.float64), *arrs_c)
    pb1_ms = cuda_ms(panel_p)
    pk_ms = cuda_ms(lambda: sbv_predict_cuda(*par(true_p, torch.float64), *arrs_c))
    pk32_ms = cuda_ms(lambda: sbv_predict_cuda(*par(true_p, torch.float32),
                                               *cast(arrs_c, torch.float32)))
    pb2_ms = cuda_ms(panel_p)
    pp_ms = cuda_ms(lambda: sbv_predict_plain(*par(true_p, torch.float64), *arrs_c), reps=3)
    flops, nbytes = predict_work(chunk0)
    pb_ms, pb_by = bound_ms(flops, nbytes, peaks)
    lib_p = _build.load("sbv_predict")
    per_sm = lib_p.sbv_predict_ctas_per_sm(chunk0.bs_pred, chunk0.m_pred, D, 1)
    per_sm_b = lib_p.sbv_predict_panel_ctas_per_sm(chunk0.bs_pred, chunk0.m_pred, D, 1)
    tr_old, tr_new = predict_traffic(chunk0)
    log(f"predict time at bc={chunk0.n_blocks} bs={chunk0.bs_pred} m={chunk0.m_pred}: kernel f64 "
        f"{pk_ms:.3f} ms, f32 {pk32_ms:.3f} ms; panel_cholesky baseline f64 {pb1_ms:.3f} / "
        f"{pb2_ms:.3f} ms (before / after); plain f64 {pp_ms:.3f} ms; bound {pb_ms:.4f} ms "
        f"({pb_by}; {flops:.3e} flop, {nbytes:.3e} B; {100 * pb_ms / pk_ms:.1f} % of the bound); "
        f"{per_sm} resident CTAs per SM (f64; baseline {per_sm_b}); reckoned scratch traffic "
        f"baseline {tr_old / 1e9:.3f} GB, tiled {tr_new / 1e9:.3f} GB")
    results["sbv_predict"] = dict(max_abs_err=pred_err, ms=pk_ms, plain_ms=pp_ms,
                                  bound_ms=pb_ms, bound_by=pb_by, f32_ms=pk32_ms,
                                  baseline_ms=[pb1_ms, pb2_ms])

    # One training step on round 0 through the kernel path (forward kernel +
    # chunked plain backward), timed on the host clock.
    loss_fn = neg_loglik_fn(packed0, 3.5, "auto", device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    lk = leaves()
    loss0 = loss_fn(KernelParams(*lk))
    torch.autograd.grad(loss0, lk)
    loss0 = float(loss0.detach())
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t
    plain0 = -float(vecchia.batched_block_loglik(p0, *arrs0)) / packed0.n_points
    log(f"phase step: {t_step:.3f} s; first loss kernel {loss0:.12f} plain {plain0:.12f}")
    check(abs(loss0 - plain0) <= 1e-9 * abs(plain0), "first-step loss: kernel vs plain")
    del arrs0, loss_fn
    torch.cuda.empty_cache()

    # 6.-7. The main path, through the user entry points.
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fit = fit_sbv(x_tr, y_tr, cfg, init=init, inner_steps=INNER, outer_rounds=OUTER,
                  device=dev)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t
    losses = [h[2] for h in fit.history]
    log(f"phase fit: {t_fit:.2f} s for {OUTER} rounds x {INNER} steps; losses {losses}")
    check(len(losses) == OUTER * INNER and all(math.isfinite(v) for v in losses),
          "fit: missing or non-finite losses")
    check(abs(losses[0] - loss0) <= 1e-12 * abs(losses[0]),
          "fit: first loss differs from the checked first step")
    log(f"fitted relevance 1/beta: {np.round(1 / fit.params.beta.cpu().numpy(), 3).tolist()}")

    t = time.perf_counter()
    pred = tpredict.predict_sbv(true_p, x_tr, y_tr, x_te, bs_pred=BS_PRED, m_pred=M_PRED,
                                n_sims=N_SIMS, chunk_size=CHUNK, seed=SEED, device=dev)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t
    launches = ops.launch_counts()
    n_chunks = math.ceil(N_TEST / CHUNK)
    log(f"phase predict: {t_pred:.2f} s for {N_TEST} points in {n_chunks} chunks")
    log(f"launches on the main path: {launches}")
    check(launches["sbv_loglik"] == OUTER * INNER,
          f"loglik kernel launched {launches['sbv_loglik']} times, expected {OUTER * INNER}")
    check(launches["sbv_predict"] == n_chunks,
          f"predict kernel launched {launches['sbv_predict']} times, expected {n_chunks}")
    for f in ("mean", "var", "sim_mean", "ci_low", "ci_high"):
        a = getattr(pred, f)
        check(a.shape == (N_TEST,) and bool(np.isfinite(a).all()), f"predict: bad {f}")
    check(bool((pred.var > 0).all()), "predict: non-positive variance")
    mspe = float(np.mean((pred.mean - y_te) ** 2))
    var_y = float(np.var(y_all))
    log(f"MSPE at the true params {mspe:.5f} vs var(y) {var_y:.5f}")
    check(mspe < 0.5 * var_y, f"MSPE {mspe:.4f} not below 0.5 var(y) = {0.5 * var_y:.4f}")

    pred_fit = tpredict.predict_sbv(fit.params, x_tr, y_tr, x_te, bs_pred=BS_PRED,
                                    m_pred=M_PRED, n_sims=N_SIMS, chunk_size=CHUNK, seed=SEED,
                                    device=dev)
    log(f"MSPE at the fitted params {float(np.mean((pred_fit.mean - y_te) ** 2)):.5f} "
        "(not checked: six Adam steps)")
    del pred, pred_fit
    torch.cuda.empty_cache()

    # 43.-48. Checkpoints, tuning and serving on this path's data and fit.
    import tempfile

    work = tempfile.mkdtemp(prefix="smoke-serve-")
    try:
        t = time.perf_counter()
        serve_launches = serving_phase(dev, results, x_tr, y_tr, x_te, fit.params, beta_true,
                                       index, work)
        log(f"phase checkpoints, tuning and serving: {time.perf_counter() - t:.1f} s; "
            f"launches {serve_launches}")
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    # The phase's bf16 launches (autotune probes and timings, the fit from
    # the record, a narrow served tier) join the bf16 entries, which the
    # ladder phase's counts carry.
    for kname in ("sbv_loglik", "sbv_predict"):
        launches[kname] += serve_launches[kname]
    del fit
    torch.cuda.empty_cache()

    # 8. The multi-output (VPPE) path: MetaRVM trajectories at 32 outputs.
    t = time.perf_counter()
    xm, ym = metarvm_field_dataset(SEED, N_TRAIN + N_MULTI_TEST, P_OUT)
    xm_tr, ym_tr = xm[:N_TRAIN], ym[:N_TRAIN]
    xm_te, ym_te = xm[N_TRAIN:], ym[N_TRAIN:]
    log(f"phase multi generate: {time.perf_counter() - t:.2f} s (n={len(xm)}, d={xm.shape[1]}, "
        f"p={P_OUT})")
    init_m = mo.MultiOutputParams.create(sigma2=np.maximum(np.var(ym_tr, axis=0), 1e-12),
                                         beta=0.5, tau2=1e-3, d=xm.shape[1], p=P_OUT)
    t = time.perf_counter()
    packed_m, _ = preprocess(xm_tr, ym_tr, init_m.beta.numpy(), cfg)
    log(f"phase multi preprocess: {time.perf_counter() - t:.2f} s (bc={packed_m.n_blocks}, "
        f"bs_max={packed_m.bs_max}, m={packed_m.m}, p={packed_m.n_outputs})")
    pm0 = init_m.to(device=dev)
    s0 = pm0.structure_params()

    # 9. Multi-output stats kernel against its plain version.
    full_m = slice_blocks(packed_m, packed_m.bs_max, M_FIT, 256)
    ragged_m = slice_blocks(packed_m, 37, 61, 256)
    ragged_m.blk_y, ragged_m.nn_y = ragged_m.blk_y[..., :3], ragged_m.nn_y[..., :3]
    multi_err = None
    for label, pk in (("full", full_m), ("ragged", ragged_m)):
        arrs = vecchia.packed_arrays(pk, dev)
        want = sbv_multi_stats_plain(*par(s0, torch.float64), *arrs)
        got = sbv_multi_stats_cuda(*par(s0, torch.float64), *arrs)
        got32 = sbv_multi_stats_cuda(*par(s0, torch.float32), *cast(arrs, torch.float32))
        torch.cuda.synchronize()
        dif = (got - want).abs()
        rel = float((dif / want.abs()).max())
        rel32 = float(((got32.double().sum(0) - want.sum(0)).abs() / want.sum(0).abs()).max())
        log(f"multi_stats {label}: bc={pk.n_blocks} bs={pk.bs_max} m={pk.m} p={pk.n_outputs} "
            f"f64 max_abs_err={float(dif.max()):.3e} max_rel_err={rel:.3e} (logdet0 "
            f"{float((dif[:, 0] / want[:, 0].abs()).max()):.3e}, q "
            f"{float((dif[:, 1:] / want[:, 1:].abs()).max()):.3e}); f32 vs f64 totals max "
            f"rel gap {rel32:.3e} (printed, not checked)")
        check(bool(torch.isfinite(got).all()), f"multi_stats {label}: non-finite kernel output")
        check(rel <= 1e-9, f"multi_stats {label}: f64 kernel vs plain rel err {rel:.3e} > 1e-9")
        if label == "full":
            multi_err = float(dif.max())
        del arrs, want, got, got32

    # p = 1 against the single-output kernel at sigma2 = 1, nugget = tau2.
    arrs = vecchia.packed_arrays(full_m, dev)
    st1 = sbv_multi_stats_cuda(*par(s0, torch.float64), arrs[0], arrs[1][..., :1], arrs[2],
                               arrs[3], arrs[4][..., :1], arrs[5])
    ll1 = sbv_loglik_cuda(*par(s0, torch.float64), arrs[0], arrs[1][..., 0].contiguous(),
                          arrs[2], arrs[3], arrs[4][..., 0].contiguous(), arrs[5])
    n_b = arrs[2].sum(dim=1).double()
    ll_st = -0.5 * n_b * vecchia._LOG2PI - 0.5 * st1[:, 0] - 0.5 * st1[:, 1]
    rel1 = float(((ll_st - ll1).abs() / ll1.abs()).max())
    log(f"multi_stats p1 vs the single-output kernel: max rel err {rel1:.3e}")
    check(rel1 <= 1e-12, f"multi_stats p=1 vs single-output kernel rel err {rel1:.3e} > 1e-12")

    # Gradient of the pooled objective: autograd.Function vs the plain version.
    n_full = full_m.n_points

    def pooled_grad(backend):
        lv = [t_.clone().requires_grad_(True) for t_ in pm0]
        ld, q = mo.packed_multi_stats(mo.MultiOutputParams(*lv), full_m, backend=backend,
                                      arrays=arrs)
        return torch.autograd.grad(mo.pooled_objective(ld, q, n_full), lv[1:])

    g_k, g_p = pooled_grad("auto"), pooled_grad("ref")
    g_rel = max(float(((a - b).abs() / b.abs().clamp_min(1e-300)).max()) for a, b in zip(g_k, g_p))
    log(f"multi gradient at bc={full_m.n_blocks}: max rel err {g_rel:.3e}")
    check(g_rel <= 1e-8, f"multi gradient rel err {g_rel:.3e} > 1e-8")
    del arrs, st1, ll1, g_k, g_p
    torch.cuda.empty_cache()

    # The earlier design (padded blocks, panel_cholesky), kept callable for
    # the side-by-side timing: the same values to 1e-10 on the full case.
    base = multi_launch("sbv_multi_stats_panel", *par(s0, torch.float64),
                        *vecchia.packed_arrays(full_m, dev), nu=3.5)
    tiled = sbv_multi_stats_cuda(*par(s0, torch.float64), *vecchia.packed_arrays(full_m, dev))
    base_rel = float(((tiled - base).abs() / base.abs()).max())
    log(f"multi_stats tiled vs panel_cholesky baseline (full case, f64): max rel {base_rel:.3e}")
    check(base_rel <= 1e-10, f"multi_stats tiled vs baseline rel {base_rel:.3e} > 1e-10")
    del base, tiled

    # Times at the path's shape: one evaluation of round 0's stats, beside
    # the earlier design (parent, change, change, parent).
    arrs_m = vecchia.packed_arrays(packed_m, dev)
    panel_m = lambda: multi_launch("sbv_multi_stats_panel", *par(s0, torch.float64), *arrs_m,
                                   nu=3.5)
    mb1_ms = cuda_ms(panel_m)
    mk_ms = cuda_ms(lambda: sbv_multi_stats_cuda(*par(s0, torch.float64), *arrs_m))
    mk32_ms = cuda_ms(lambda: sbv_multi_stats_cuda(*par(s0, torch.float32),
                                                   *cast(arrs_m, torch.float32)))
    mb2_ms = cuda_ms(panel_m)
    with torch.no_grad():
        mp_ms = cuda_ms(lambda: sbv_multi_stats_plain(*par(s0, torch.float64), *arrs_m), reps=3)
    flops, nbytes = multi_work(packed_m)
    mb_ms, mb_by = bound_ms(flops, nbytes, peaks)
    lib_m = _build.load("sbv_multi_stats")
    shape_m = (packed_m.bs_max, packed_m.m, xm.shape[1], P_OUT, 1)
    per_sm = lib_m.sbv_multi_stats_ctas_per_sm(*shape_m)
    per_sm_b = lib_m.sbv_multi_stats_panel_ctas_per_sm(*shape_m)
    tr_old, tr_new = block_traffic(packed_m, extra=P_OUT)
    log(f"multi_stats time at bc={packed_m.n_blocks} bs={packed_m.bs_max} m={packed_m.m} "
        f"p={P_OUT}: kernel f64 {mk_ms:.3f} ms, f32 {mk32_ms:.3f} ms; panel_cholesky baseline "
        f"f64 {mb1_ms:.3f} / {mb2_ms:.3f} ms (before / after); plain f64 {mp_ms:.3f} ms; bound "
        f"{mb_ms:.4f} ms ({mb_by}; {flops:.3e} flop, {nbytes:.3e} B; "
        f"{100 * mb_ms / mk_ms:.1f} % of the bound); {per_sm} resident CTAs per SM (f64; "
        f"baseline {per_sm_b}); reckoned scratch traffic baseline {tr_old / 1e9:.2f} GB, tiled "
        f"{tr_new / 1e9:.2f} GB")
    results["sbv_multi_stats"] = dict(max_abs_err=multi_err, ms=mk_ms, plain_ms=mp_ms,
                                      bound_ms=mb_ms, bound_by=mb_by, f32_ms=mk32_ms,
                                      baseline_ms=[mb1_ms, mb2_ms])

    # 10. One multi step: pooled-objective value and gradient at the full bc.
    loss_m = mo.multi_profile_neg_loglik_fn(packed_m, 3.5, "auto", device=dev)
    lv = [t_.clone().requires_grad_(True) for t_ in pm0]
    torch.cuda.synchronize()
    t = time.perf_counter()
    mloss0 = loss_m(mo.MultiOutputParams(*lv))
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t
    torch.autograd.grad(mloss0, lv[1:])
    torch.cuda.synchronize()
    t_bwd = time.perf_counter() - t - t_fwd
    mloss0 = float(mloss0.detach())
    with torch.no_grad():
        ld_p = q_p = 0
        for s0_ in range(0, packed_m.n_blocks, 500):
            ld_c, q_c = mo.block_multi_stats(*par(s0, torch.float64),
                                             *(a[s0_:s0_ + 500] for a in arrs_m))
            ld_p, q_p = ld_p + ld_c.sum(), q_p + q_c.sum(dim=0)
        mplain0 = float(mo.pooled_objective(ld_p, q_p, packed_m.n_points))
    log(f"phase multi step: forward {t_fwd:.3f} s (kernel {mk_ms:.1f} ms), chunked backward "
        f"{t_bwd:.3f} s (chunk {ops.BACKWARD_CHUNK}); first loss kernel {mloss0:.12f} "
        f"plain {mplain0:.12f}")
    check(abs(mloss0 - mplain0) <= 1e-9 * abs(mplain0), "multi first-step loss: kernel vs plain")
    del arrs_m, loss_m
    torch.cuda.empty_cache()

    # 11. The multi-output path through the user entry points.
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fit_m = fit_sbv(xm_tr, ym_tr, cfg, inner_steps=INNER, outer_rounds=OUTER, device=dev)
    torch.cuda.synchronize()
    t_fit_m = time.perf_counter() - t
    m_losses = [h[2] for h in fit_m.history]
    s2_fit = fit_m.params.sigma2.detach().cpu().numpy()
    log(f"phase multi fit: {t_fit_m:.2f} s for {OUTER} rounds x {INNER} steps; losses "
        f"{m_losses}; profiled sigma2 range [{s2_fit.min():.4g}, {s2_fit.max():.4g}], "
        f"tau2 {float(fit_m.params.tau2):.4g}")
    check(len(m_losses) == OUTER * INNER and all(math.isfinite(v) for v in m_losses),
          "multi fit: missing or non-finite losses")
    check(abs(m_losses[0] - mloss0) <= 1e-12 * abs(m_losses[0]),
          "multi fit: first loss differs from the checked first step")
    check(s2_fit.shape == (P_OUT,) and bool(np.isfinite(s2_fit).all()) and bool((s2_fit > 0).all()),
          "multi fit: non-finite profiled sigma2")

    t = time.perf_counter()
    pred_m = tpredict.predict_sbv(fit_m.params, xm_tr, ym_tr, xm_te, bs_pred=BS_PRED,
                                  m_pred=M_PRED, n_sims=N_SIMS, chunk_size=MULTI_CHUNK, seed=SEED,
                                  device=dev)
    torch.cuda.synchronize()
    t_pred_m = time.perf_counter() - t
    multi_launches = ops.launch_counts()
    log(f"phase multi predict: {t_pred_m:.2f} s for {N_MULTI_TEST} points x {P_OUT} outputs in "
        f"{math.ceil(N_MULTI_TEST / MULTI_CHUNK)} chunks (torch.linalg conditional, as in the "
        "reference)")
    log(f"launches on the multi-output path: {multi_launches}")
    check(multi_launches["sbv_multi_stats"] == OUTER * INNER + 1,
          f"multi_stats kernel launched {multi_launches['sbv_multi_stats']} times, expected "
          f"{OUTER * INNER + 1} (steps + final profile)")
    for f in ("mean", "var", "sim_mean", "ci_low", "ci_high"):
        a = getattr(pred_m, f)
        check(a.shape == (N_MULTI_TEST, P_OUT) and bool(np.isfinite(a).all()),
              f"multi predict: bad {f}")
    check(bool((pred_m.var > 0).all()), "multi predict: non-positive variance")
    mspe_j = np.mean((pred_m.mean - ym_te) ** 2, axis=0)
    var_j = np.var(ym, axis=0)
    ratio = mspe_j / var_j
    log(f"multi MSPE_j / var(y_j): max {ratio.max():.4g} (output {int(ratio.argmax())}), "
        f"median {float(np.median(ratio)):.4g}")
    check(bool((mspe_j < 0.5 * var_j).all()),
          f"multi MSPE not below 0.5 var(y_j) for outputs {np.flatnonzero(mspe_j >= 0.5 * var_j)}")
    # Where the predict time goes: the training index and one chunk's host
    # packing (host clock) against that chunk's device conditional and
    # simulation (CUDA events).
    t = time.perf_counter()
    index_m = tpredict.build_train_index(xm_tr, ym_tr, fit_m.params.beta.detach().cpu().numpy(),
                                         M_PRED, seed=SEED)
    t_index = time.perf_counter() - t
    t = time.perf_counter()
    _, chunk_m = next(tpredict.iter_query_chunks(index_m, xm_te, BS_PRED, M_PRED, seed=SEED,
                                                 chunk_size=MULTI_CHUNK))
    t_pack = time.perf_counter() - t
    arrs_p = tuple(torch.as_tensor(a).to(dev) for a in chunk_m.arrays())
    dev_ms = cuda_ms(lambda: tpredict._predict_and_simulate(fit_m.params, *arrs_p, nu=3.5,
                                                            backend="auto", n_sims=N_SIMS),
                     reps=3)
    log(f"multi predict split: training index {t_index:.2f} s; one chunk (bc={chunk_m.n_blocks}, "
        f"bs={chunk_m.bs_pred}, m={chunk_m.m_pred}): host packing {t_pack:.2f} s, device "
        f"conditional + {N_SIMS} simulations {dev_ms:.1f} ms")
    # The p = 32 drain batch on this index (ROADMAP item 12a).
    t = time.perf_counter()
    results["serving_multi"] = multi_serving_step(dev, fit_m.params, xm_tr, ym_tr, xm_te,
                                                  index_m)
    log(f"phase multi-output serving: {time.perf_counter() - t:.1f} s")
    del pred_m, fit_m, arrs_p
    torch.cuda.empty_cache()

    # 29.-35. The streaming (out-of-core) fit and prediction, then 36.-42.
    # the distributed (Alg. 1) and multi-host (Alg. 2) paths on its store.
    work = tempfile.mkdtemp(prefix="smoke-dist-")
    try:
        t = time.perf_counter()
        stream_launches = streaming_phase(dev, results, x_tr, y_tr, x_te, y_te, xm_tr, ym_tr,
                                          cfg, init, true_p, t_step,
                                          os.path.join(work, "train"))
        log(f"phase streaming (out-of-core) fit and prediction: {time.perf_counter() - t:.1f} s;"
            f" launches {stream_launches}")
        for kname in ("sbv_loglik", "sbv_predict"):
            launches[kname] += stream_launches[kname]
        multi_launches["sbv_multi_stats"] += stream_launches["sbv_multi_stats"]
        t = time.perf_counter()
        dist_launches = distributed_phase(dev, results, x_tr, y_tr, x_te, cfg, init, true_p,
                                          index, work)
        log(f"phase distributed (Alg. 1) and multi-host (Alg. 2): "
            f"{time.perf_counter() - t:.1f} s; launches {dist_launches}")
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    # The ranks' launches happen in their own processes, each counted there.
    for kname in ("sbv_loglik", "sbv_predict"):
        launches[kname] += dist_launches[kname] + sum(dist_launches[f"rank_{kname}"])
        results[kname]["rank_launches"] = dist_launches[f"rank_{kname}"]

    # 12. The batched covariance kernel, on the joint points of 256 real
    # blocks of the multi-output structure (na = nb = m + bs_max).
    xj = torch.as_tensor(np.concatenate([full_m.nn_x, full_m.blk_x], axis=1), device=dev)
    kp = KernelParams.create(sigma2=1.0, beta=0.5, nugget=1e-3, d=xj.shape[2], device=dev)
    cov_err = None
    # The path's shape, a ragged one, and the tiled kernel's store paths and
    # edges: odd nb (f64) and nb not a multiple of 4 (f32) take the scalar
    # stores, na = 1, nb = 1, d = 1, d = 16 and d = 100 (the coordinates
    # repeated; d = 100 is staged in four chunks, the last one ragged).
    x16 = torch.cat([xj, xj[..., :6]], dim=-1)
    x100 = xj.repeat(1, 1, 10)[:, :200]
    for label, (xa, xb) in (("full", (xj, xj)), ("ragged", (xj[:, :37], xj[:, 37:98])),
                            ("na=1", (xj[:, :1], xj)), ("nb=1", (xj, xj[:, 5:6])),
                            ("d=1", (xj[..., :1], xj[:, :131, :1])),
                            ("d=16", (x16[:, :70], x16[:, 70:])),
                            ("d=100", (x100[:, :70], x100[:, 70:]))):
        bt = torch.full((xa.shape[2],), 0.5, dtype=torch.float64, device=dev)
        want = matern_cov_plain(xa, xb, bt, kp.sigma2)
        got = matern_cov_cuda(xa, xb, bt, kp.sigma2)
        got32 = matern_cov_cuda(xa.float(), xb.float(), bt, kp.sigma2)
        torch.cuda.synchronize()
        dif = (got - want).abs()
        rel = float((dif / want.abs()).max())
        err32 = float((got32.double() - want).abs().max())
        log(f"matern_cov {label}: B={xa.shape[0]} na={xa.shape[1]} nb={xb.shape[1]} "
            f"d={xa.shape[2]} f64 max_abs_err={float(dif.max()):.3e} max_rel_err={rel:.3e}; "
            f"f32 max_abs_err={err32:.3e}")
        check(rel <= 1e-12, f"matern_cov {label}: f64 kernel vs plain rel err {rel:.3e} > 1e-12")
        if label == "d=100":
            # |z|^2 ten times the others': held beside the plain f32 version.
            c32 = f32_cov_check(got32, matern_cov_plain(xa.float(), xb.float(), bt.float(),
                                                        kp.sigma2.float()), want)
            log(f"matern_cov d=100 f32: plain f32 version max_abs_err={c32['plain_err']:.3e}; "
                f"entries beyond 1e-5: kernel {c32['over']}, plain {c32['plain_over']}")
            check(c32["ok"], f"matern_cov d=100: f32 kernel worse than the plain f32 ({c32})")
        else:
            check(err32 <= 1e-5, f"matern_cov {label}: f32 kernel vs f64 err {err32:.3e} > 1e-5")
        if label == "full":
            cov_err = float(dif.max())
        del want, got, got32
    # A point set against itself at nu = 0.5 (exp(-r), steepest at r = 0):
    # every diagonal entry is bitwise sigma2 * exp(-sqrt(1e-30)), the value
    # at a distance of exactly 0 (sigma2 itself in f32; in f64 the floor
    # moves it by 1e-15 relative); a distance left at a rounding residue
    # would move it by ~1e-8.
    for dt in (torch.float64, torch.float32):
        xd, s2 = xj.to(dt), kp.sigma2.to(dt)
        diag = torch.diagonal(matern_cov_cuda(xd, xd, kp.beta.to(dt), s2, nu=0.5),
                              dim1=-2, dim2=-1)
        at_zero = s2 * torch.exp(-torch.sqrt(torch.tensor(1e-30, dtype=dt, device=dev)))
        exact = bool((diag == at_zero).all()) and (dt == torch.float64 or bool((diag == s2).all()))
        log(f"matern_cov {dt} nu=0.5 self-distance: diagonal in [{float(diag.min())!r}, "
            f"{float(diag.max())!r}], value at distance 0 {float(at_zero)!r}")
        check(exact, f"matern_cov {dt}: a point's distance to itself is not exactly 0")
    # Times at the path's shape, beside the earlier (row-wise) design
    # (parent, change, change, parent) and the write-rate yardstick
    # (`fill_`: the same bytes written by PyTorch, not the same function).
    b_, na_, d_ = xj.shape
    cov256 = {}
    for dt, isz in ((torch.float64, 8), (torch.float32, 4)):
        xd, bd, sd = xj.to(dt), kp.beta.to(dt), kp.sigma2.to(dt)
        tiled = lambda: matern_cov_cuda(xd, xd, bd, sd)
        rowwise = lambda: cov_launch("matern_cov_rowwise", xd, xd, bd, sd, 3.5)
        base1, k1, k2, base2 = (cuda_ms(f, inner=10) for f in (rowwise, tiled, tiled, rowwise))
        fill = cuda_ms(lambda: torch.empty(b_, na_, na_, dtype=dt, device=dev).fill_(1.0),
                       inner=10)
        single = cuda_ms(tiled)
        if dt == torch.float64:
            bnd, bby, flops, nbytes = cov_bound_f64(b_, na_, na_, d_, peaks)
        else:
            flops, nbytes = cov_work(b_, na_, na_, d_, isz)
            bnd, bby = bound_ms(flops, nbytes, peaks, "f32")
        cov256[str(dt)] = dict(ms=[k1, k2], baseline_ms=[base1, base2], fill_ms=fill,
                               bound_ms=bnd, bound_by=bby, single_call_ms=single)
        log(f"matern_cov time at B={b_} na=nb={na_} d={d_} {dt} (10 calls back to back per "
            f"event pair; one call alone {single:.4f} ms): kernel {k1:.4f}, {k2:.4f} ms; "
            f"row-wise design {base1:.4f}, {base2:.4f} ms; fill_ {fill:.4f} ms; bound "
            f"{bnd:.4f} ms ({bby}; {flops:.3e} flop, {nbytes:.3e} B); kernel at "
            f"{100 * bnd / min(k1, k2):.1f} % of the bound")
    cp_ms = cuda_ms(lambda: matern_cov_plain(xj, xj, kp.beta, kp.sigma2), reps=3)
    log(f"matern_cov plain f64 at B={b_}: {cp_ms:.3f} ms")
    results["matern_cov"] = dict(max_abs_err=cov_err, cov256=cov256, plain256_ms=cp_ms)
    # Its entry point, once.
    ops.reset_launch_counts()
    cov = ops.matern_cov(xj, xj, kp)
    torch.cuda.synchronize()
    cov_launches = ops.launch_counts()
    log(f"launches on the matern_cov entry point (ops.matern_cov): {cov_launches}")
    check(cov_launches["matern_cov"] == 1 and cov.shape == (xj.shape[0],) + (xj.shape[1],) * 2
          and bool(torch.isfinite(cov).all()), "matern_cov path: no launch or bad output")
    del cov, xj, x16, x100
    torch.cuda.empty_cache()

    # 26.-28. The exact GP and paper Eq. 4's KL divergence at Fig. 4's scale.
    t = time.perf_counter()
    kl_launches = exact_kl_phase(dev, peaks, results)
    log(f"phase exact GP and KL (paper Fig. 4): {time.perf_counter() - t:.1f} s")

    # 18.-25. Buckets and the precision ladder.
    t = time.perf_counter()
    ladder_launches = buckets_ladder_phase(dev, peaks, results, packed0, packed_m, x_tr, y_tr,
                                           x_te, y_te, cfg, init, init_m)
    log(f"phase buckets and ladder: {time.perf_counter() - t:.1f} s")
    for kname in ("sbv_loglik_bf16", "sbv_predict_bf16"):
        ladder_launches[kname] += serve_launches[kname]

    # 13.-17. LM serving.
    lm_launches = lm_serving_phase(dev, peaks, results)

    # 49.-52. LM training, after the serving model is freed.
    work = tempfile.mkdtemp(prefix="smoke-train-")
    try:
        t = time.perf_counter()
        train_launches = lm_training_phase(dev, peaks, results, work)
        log(f"phase lm training: {time.perf_counter() - t:.1f} s; launches {train_launches} "
            f"(flash_attention: prefill {lm_launches['flash_attention']} + training "
            f"{train_launches['flash_attention']})")
    finally:
        import shutil

        shutil.rmtree(work, ignore_errors=True)
    lm_launches = {**lm_launches, **{k: lm_launches.get(k, 0) + v
                                      for k, v in train_launches.items()}}

    # 53.-56. gemma2 serving, 57.-60. qwen2-moe serving, 61.-62. their
    # training (ROADMAP items 13.2, 13.3), each path's launches counted.
    t = time.perf_counter()
    g2_launches = gemma2_serving_phase(dev, peaks, results)
    log(f"phase gemma2 serving: {time.perf_counter() - t:.1f} s; launches {g2_launches}")
    t = time.perf_counter()
    moe_launches = moe_serving_phase(dev, peaks, results)
    log(f"phase qwen2-moe serving: {time.perf_counter() - t:.1f} s; launches {moe_launches}")
    t = time.perf_counter()
    fam_launches = families_training_phase(dev, peaks, results)
    log(f"phase gemma2 and qwen2-moe training: {time.perf_counter() - t:.1f} s; launches "
        f"{fam_launches}")
    lm_launches, hd256 = flash_counts(results, lm_launches, g2_launches, moe_launches,
                                      fam_launches)
    # The tp runs of the meshes phase (13.6) are hd-128 prefills on 'wgmma'.
    for run in results["mesh_tp"].values():
        lm_launches["flash_attention"] += run["launches"]["flash_attention"]

    # 62b. The dense LM, the MoE and the recurrent stacks split over four
    # rank processes (ROADMAP item 13.6): internlm2, qwen2-moe, zamba2 (one
    # group) and rwkv6 (2 layers) served at 1x4 and trained at 2x2, held
    # against the serving and training phases above and whole runs made in
    # the phase (hd 128 and zamba2's hd 80, 'wgmma').
    work = tempfile.mkdtemp(prefix="smoke-sharded-")
    dry_work = tempfile.mkdtemp(prefix="smoke-dryrun-")
    try:
        t = time.perf_counter()
        sharded_launches = lm_sharded_phase(dev, peaks, results, work, dry_work)
        log(f"phase lm sharded: {time.perf_counter() - t:.1f} s (ranks "
            f"{results['lm_sharded']['ranks_s']:.1f} s); the ranks' flash launches on the paths "
            f"{sharded_launches}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(dry_work, ignore_errors=True)
    for k, v in sharded_launches.items():
        lm_launches[k] = lm_launches.get(k, 0) + v
    for kname in ("flash_attention", "flash_attention_bwd"):
        results[kname]["rank_launches"] = sharded_launches[kname]
        results[kname]["rank_launches_by_run"] = results["lm_sharded"]["flash_per_rank"][kname]

    # 63.-69. zamba2 serving, 70.-75. rwkv6 serving, 76.-77. their training
    # (ROADMAP items 13.4, 13.5); zamba2's shared block runs the hd-80 routes.
    t = time.perf_counter()
    z_launches = zamba2_serving_phase(dev, peaks, results)
    log(f"phase zamba2 serving: {time.perf_counter() - t:.1f} s; launches {z_launches}")
    t = time.perf_counter()
    r_launches = rwkv6_serving_phase(dev, peaks, results)
    log(f"phase rwkv6 serving: {time.perf_counter() - t:.1f} s; launches {r_launches}")
    t = time.perf_counter()
    rec_launches = recurrent_training_phase(dev, peaks, results)
    log(f"phase zamba2 and rwkv6 training: {time.perf_counter() - t:.1f} s; launches "
        f"{rec_launches}")
    # The sharded phase's zamba2 ranks ran the hd-80 routes at their local heads.
    rank80 = results["lm_sharded"]["hd80_launches"]
    hd80 = {"flash_attention_hd80": z_launches["flash_attention"]
            + rec_launches[ZAMBA_ARCH]["flash_attention"] + rank80["flash_attention_hd80"],
            "flash_attention_bwd_hd80": rec_launches[ZAMBA_ARCH]["flash_attention_bwd"]
            + rank80["flash_attention_bwd_hd80"]}
    for kname in hd80:
        results[kname]["rank_launches"] = rank80[kname]
    log(f"flash launches on the hd-80 routes (zamba2's shared block): 'wgmma' forward "
        f"{hd80['flash_attention_hd80']}, 'wgmma' backward {hd80['flash_attention_bwd_hd80']} "
        f"(of which the sharded ranks' {rank80['flash_attention_hd80']} / "
        f"{rank80['flash_attention_bwd_hd80']})")
    check(hd80["flash_attention_hd80"] > 0 and hd80["flash_attention_bwd_hd80"] > 0,
          "the hd-80 routes were not launched on the zamba2 paths")

    # 78.-80. Meshes, tp and the dry run (ROADMAP item 13.6): the tp runs
    # ran inside the internlm2 and qwen2-moe serving phases (14b, 60b), on
    # their weights; the dry run over every cell beside the sharded phase's
    # holds (62b).
    mt = results["mesh_tp"]
    log(f"phase meshes, tp and the dry run (13.6): internlm2 --mesh {LM_TP_MESH} "
        f"{mt['internlm2']['seconds']:.1f} s, qwen2-moe --mesh {MOE_TP_MESH} "
        f"{mt['qwen2-moe']['seconds']:.1f} s, the dry run {results['dryrun']['wall_s']:.1f} s "
        f"beside the sharded phase's holds ({results['dryrun']['waited_s']:.1f} s waited for); "
        f"flash_attention "
        f"launches {sum(r_['launches']['flash_attention'] for r_ in mt.values())}")

    kernels = []
    for kname, src, replaces, count in (
            ("sbv_loglik", "src/repro_torch/csrc/sbv_loglik.cu",
             "src/repro/kernels/sbv_loglik.py:289", launches),
            ("sbv_predict", "src/repro_torch/csrc/sbv_predict.cu",
             "src/repro/kernels/sbv_predict.py:82", launches),
            ("sbv_multi_stats", "src/repro_torch/csrc/sbv_multi_stats.cu",
             "src/repro/kernels/sbv_loglik.py:247", multi_launches),
            ("matern_cov", "src/repro_torch/csrc/matern_cov.cu",
             "src/repro/kernels/matern_cov.py:49", kl_launches),
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:92", lm_launches),
            ("flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd_wgmma.cu",
             "none: src/repro/kernels/flash_attention.py:92 has no backward kernel (jax.grad "
             "differentiates the XLA route)", lm_launches),
            ("flash_attention_hd256", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:92", hd256),
            ("flash_attention_bwd_hd256", "src/repro_torch/csrc/flash_attention_bwd_wgmma.cu",
             "none: src/repro/kernels/flash_attention.py:92 has no backward kernel (jax.grad "
             "differentiates the XLA route)", hd256),
            ("flash_attention_hd80", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:92", hd80),
            ("flash_attention_bwd_hd80", "src/repro_torch/csrc/flash_attention_bwd_wgmma.cu",
             "none: src/repro/kernels/flash_attention.py:92 has no backward kernel (jax.grad "
             "differentiates the XLA route)", hd80),
            ("sbv_loglik_bf16", "src/repro_torch/csrc/sbv_loglik.cu",
             "src/repro/kernels/sbv_loglik.py:289", ladder_launches),
            ("sbv_predict_bf16", "src/repro_torch/csrc/sbv_predict.cu",
             "src/repro/kernels/sbv_predict.py:82", ladder_launches),
            ("sbv_multi_stats_bf16", "src/repro_torch/csrc/sbv_multi_stats.cu",
             "src/repro/kernels/sbv_loglik.py:247", ladder_launches),
            ("matern_cov_bf16", "src/repro_torch/csrc/matern_cov.cu",
             "src/repro/kernels/matern_cov.py:49", ladder_launches)):
        kernels.append(kernel_entry(kname, src, replaces, count[kname], results[kname]))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--predict-rank"]:
        sys.exit(predict_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--lm-rank"]:
        sys.exit(lm_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--lm16-rank"]:
        sys.exit(lm16_rank(sys.argv[2]))
    sys.exit(main())
