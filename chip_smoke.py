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
  plain version (bf16 and f32) at the path's shape and at its variants.

Launch counts are set to 0 just before each path and read just after it.
It checks that every kernel of each path launched, that the outputs are
finite and right, and prints per-kernel numbers as one JSON line and, last,
``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when no CUDA device is visible, when
the repository's sources are not beside this file, or when any check fails.
"""
from __future__ import annotations

import json
import math
import os
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
# reference's bucketed fit and prediction default to.
N_BUCKETS = 4
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


def flash_work(b: int, h: int, hkv: int, s: int, hd: int, itemsize: int) -> tuple[float, float]:
    """(flops, bytes) of causal attention at S = T: 2 B H S^2 hd (the causal
    half of Q K^T and P V); Q, K, V read once, O written once."""
    return 2.0 * b * h * s * s * hd, float(itemsize * (2 * b * h + 2 * b * hkv) * s * hd)


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
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (ROUTES, flash_attention_cuda,
                                                     flash_attention_plain, flash_route)
    from repro_torch.kernels.flash_attention import _launch as flash_launch
    from repro_torch.models.model import TransformerLM, init_params, prefill_step, serve_step
    from repro_torch.training.serve import make_decode_step, make_prefill_step

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
    prefill = make_prefill_step(cfg, cache_len)
    decode = make_decode_step(cfg)
    # Warm-up (cuBLAS picks its algorithms at the first call of each shape),
    # then the counted, timed run.
    _, warm = prefill(model, prompt)
    decode(model, prompt[:, :1], warm)
    del warm
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, cache = prefill(model, prompt)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t
    pre_launches = ops.launch_counts()
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    toks, step_logits = [tok], []
    ops.reset_launch_counts()
    t = time.perf_counter()
    for _ in range(LM_NEW - 1):
        tok, lg, cache = decode(model, tok, cache)
        toks.append(tok)
        step_logits.append(lg)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t
    dec_launches = ops.launch_counts()
    toks = torch.cat(toks, dim=1)
    tok_s = LM_BATCH * (LM_NEW - 1) / t_decode
    log(f"phase lm prefill {LM_BATCH}x{LM_PROMPT}: {t_prefill:.3f} s "
        f"({LM_BATCH * LM_PROMPT / t_prefill:.0f} prompt tokens/s); launches {pre_launches}")
    log(f"phase lm decode {LM_NEW - 1} steps x {LM_BATCH}: {t_decode:.3f} s ({tok_s:.1f} tokens/s, "
        f"{1e3 * t_decode / (LM_NEW - 1):.2f} ms per step; the weights and the cache read once "
        f"per step take {1e3 * (n_bytes + kv_bytes) / peaks['hbm']:.2f} ms at HBM rate); "
        f"launches {dec_launches}")
    log(f"lm sample tokens: {toks[0, :16].tolist()}")
    check(pre_launches["flash_attention"] == cfg.n_layers,
          f"prefill launched flash_attention {pre_launches['flash_attention']} times, "
          f"expected {cfg.n_layers}")
    check(dec_launches["flash_attention"] == 0, "decode launched flash_attention")
    check(logits.shape == (LM_BATCH, cfg.vocab) and bool(torch.isfinite(logits).all())
          and all(bool(torch.isfinite(x).all()) for x in step_logits), "lm: non-finite logits")
    check(toks.shape == (LM_BATCH, LM_NEW) and toks.dtype == torch.int32
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab, "lm: tokens out of range")
    check(cache["pos"] == cache_len - 1, "lm: cache position")
    del cache, step_logits
    torch.cuda.empty_cache()

    # 15. The same weights through the plain attention route
    # (use_flash="never"), and both routes against the same weights in f32
    # (the kernel's f32 path). The two bf16 routes round different numbers:
    # the kernel rounds the unnormalised exp(s - m_running) to bf16 before
    # P . V and divides by the f32 sum at the end; the never route rounds
    # the normalised P. Through L layers of bf16 activations at d_model 2048
    # these differences grow, and the two routes lie about equally far from
    # the f32 model, so an elementwise 3e-2 between them (the reference's
    # reduced-size flash-vs-XLA prefill tolerance, tests/
    # test_flash_integration.py) does not hold at full width: it leaves out
    # ~4e-4 of the logits at L = 2 and ~2e-2 at L = 24. The routes are held
    # to 3e-2 in relative L2 norm, and elementwise the kernel route may be no
    # further from the f32 model than 1.25x the never route's largest error.
    never = TransformerLM(dataclasses.replace(cfg, use_flash="never"), device="meta")
    never.load_state_dict(model.state_dict(), assign=True)
    with torch.inference_mode():
        logits_never, _ = prefill_step(never, prompt, cache_len)
    torch.cuda.synchronize()
    del never
    m32 = TransformerLM(dataclasses.replace(cfg, dtype="float32"), device="meta")
    m32.load_state_dict({k: v.float() for k, v in model.state_dict().items()}, assign=True)
    with torch.inference_mode():
        logits_32, _ = prefill_step(m32, prompt, cache_len)
    del m32
    rel = lambda x, y: float(torch.linalg.norm(x - y) / torch.linalg.norm(y))
    out = lambda x, y: float(((x - y).abs() > 3e-2 * (1 + y.abs())).float().mean())
    route_err = float((logits - logits_never).abs().max())
    err32, err32_never = (float((x - logits_32).abs().max()) for x in (logits, logits_never))
    log(f"lm prefill logits, kernel route vs use_flash=never (bf16, {cfg.n_layers} layers): "
        f"rel L2 {rel(logits, logits_never):.3e}, max_abs_err {route_err:.3e}, share outside "
        f"rtol=atol=3e-2 {out(logits, logits_never):.2e} (|logits| max "
        f"{float(logits_never.abs().max()):.3g})")
    log(f"lm prefill logits against the f32 model: kernel route rel L2 "
        f"{rel(logits, logits_32):.3e}, max_abs_err {err32:.3e}, share outside 3e-2 "
        f"{out(logits, logits_32):.2e}; use_flash=never route rel L2 "
        f"{rel(logits_never, logits_32):.3e}, max_abs_err {err32_never:.3e}, share outside 3e-2 "
        f"{out(logits_never, logits_32):.2e}")
    check(rel(logits, logits_never) <= 3e-2,
          f"lm: kernel route vs plain route logits rel L2 {rel(logits, logits_never):.3e} > 3e-2")
    check(rel(logits, logits_32) <= 3e-2,
          f"lm: bf16 kernel route vs f32 rel L2 {rel(logits, logits_32):.3e} > 3e-2")
    check(err32 <= 1.25 * err32_never,
          f"lm: bf16 kernel route's largest error against f32 {err32:.3e} > 1.25 x the "
          f"never route's {err32_never:.3e}")
    del logits_never, logits_32
    torch.cuda.empty_cache()
    # A 2-layer full-width f32 model: the two routes elementwise (the same
    # function in other orders, 1e-4), and decode after a prefill of s
    # tokens against a prefill of s + 1 (tests/test_models_smoke.py's 2e-3).
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    m2 = init_params(cfg2, torch.Generator(device=dev).manual_seed(SEED + 1), device=dev)
    never2 = TransformerLM(dataclasses.replace(cfg2, use_flash="never"), device="meta")
    never2.load_state_dict(m2.state_dict(), assign=True)
    s2 = min(1000, LM_PROMPT - 1)
    with torch.inference_mode():
        direct, _ = prefill_step(m2, prompt[:, :s2 + 1], s2 + 8)
        direct_never, _ = prefill_step(never2, prompt[:, :s2 + 1], s2 + 8)
        _, c2 = prefill_step(m2, prompt[:, :s2], s2 + 8)
        dec, _ = serve_step(m2, prompt[:, s2:s2 + 1], c2)
    r32_err = float((direct - direct_never).abs().max())
    dd_err = float((dec - direct).abs().max())
    log(f"lm f32 2-layer: kernel route vs use_flash=never max_abs_err {r32_err:.3e}; decode "
        f"after prefill {s2} vs prefill {s2 + 1}: max_abs_err {dd_err:.3e}")
    check(bool(torch.allclose(direct, direct_never, rtol=1e-4, atol=1e-4)),
          f"lm f32: kernel route vs plain route differ by {r32_err:.3e} > 1e-4")
    check(bool(torch.allclose(dec, direct, rtol=2e-3, atol=2e-3)),
          f"lm: decode vs longer prefill differ by {dd_err:.3e} > 2e-3")
    del m2, never2, c2
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
        f"after; wgmma vs mma row rel L2 {base_row:.3e}); plain bf16 {p_ms:.3f} ms; "
        f"scaled_dot_product_attention bf16 {l_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by}; "
        f"{flops:.3e} flop, {nbytes:.3e} B); {cfg.n_layers} calls per prefill = "
        f"{cfg.n_layers * k_ms / 1e3:.3f} s of the {t_prefill:.3f} s prefill")
    results["flash_attention"] = dict(max_abs_err=flash_err, ms=k_ms, plain_ms=p_ms,
                                      bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
                                      f32_ms=k32_ms, baseline_ms=[m1_ms, m2_ms])
    del q, k, v, kx, vx, q32, k32, v32, model
    torch.cuda.empty_cache()
    return {name: pre_launches[name] + dec_launches[name] for name in pre_launches}


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

    # 22. The bucketed bf16 fit through the entry point (one structure pass).
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
    log(f"phase bucketed bf16 fit: {t_fit:.2f} s (1 round x 3 steps, probe included); tiers "
        f"{fit.precision_tiers}; one step {t_step:.3f} s; losses {losses}; launches "
        f"{fit_launches}")
    check(len(losses) == 3 and all(math.isfinite(v) for v in losses) and losses[-1] <= losses[0],
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
    check(g_err <= 1e-10, f"bf16 step: gradient vs the f64 plain version rel {g_err:.3e} > 1e-10")
    del cast, g16, g_ref
    torch.cuda.empty_cache()

    # 23. Prediction: bucketed f64 against uniform, bf16 against f64.
    kw = dict(bs_pred=BS_PRED, m_pred=M_PRED, n_sims=N_SIMS, chunk_size=CHUNK, seed=SEED,
              device=dev)
    t = time.perf_counter()
    pred_u = tpredict.predict_sbv(init, x_tr, y_tr, x_te, **kw)
    t_pu = time.perf_counter() - t
    t = time.perf_counter()
    pred_b = tpredict.predict_sbv(init, x_tr, y_tr, x_te, n_buckets=N_BUCKETS, **kw)
    t_pb = time.perf_counter() - t
    ops.reset_launch_counts()
    t = time.perf_counter()
    pred_16 = tpredict.predict_sbv(init, x_tr, y_tr, x_te, n_buckets=N_BUCKETS, precision="bf16",
                                   **kw)
    torch.cuda.synchronize()
    t_p16 = time.perf_counter() - t
    pred_launches = ops.launch_counts()
    launches["sbv_predict_bf16"] = pred_launches["sbv_predict_bf16"]
    n_chunks = math.ceil(len(x_te) / CHUNK)
    check(pred_launches["sbv_predict_bf16"] == n_chunks and pred_launches["sbv_predict"] == 0,
          f"bucketed bf16 predict launches {pred_launches}, expected one bf16 launch per chunk "
          f"({n_chunks})")
    # The reference's bf16 prediction test (tests/test_buckets.py:452-476)
    # runs its ``ref`` route: the bf16 coordinates' rounding alone. Here too,
    # on the plain version (not a kernel path; its launches are not counted).
    t = time.perf_counter()
    pred_r = tpredict.predict_sbv(init, x_tr, y_tr, x_te, n_buckets=N_BUCKETS, precision="bf16",
                                  backend="ref", **kw)
    t_pr = time.perf_counter() - t
    scale = max(1.0, float(np.abs(pred_u.mean).max()))
    d_mean = float(np.abs(pred_b.mean - pred_u.mean).max())
    d_var = float(np.abs(pred_b.var - pred_u.var).max())
    rms = [float(np.sqrt(np.mean((p.mean - pred_u.mean) ** 2)) / np.sqrt(np.mean(pred_u.mean ** 2)))
           for p in (pred_16, pred_r)]
    mspe = [float(np.mean((p.mean - y_te) ** 2)) for p in (pred_u, pred_16, pred_r)]
    log(f"phase bucketed predict at the initial params: uniform {t_pu:.2f} s, bucketed f64 "
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
    """One served chunk's kernel launch held against its plain version.

    ``pk`` is the chunk packed as the server packed it (the same index,
    seed, offset and padding), ``mean`` / ``var`` the served results its
    query indices point into. The predict wrapper runs on the chunk's
    operands and is held against ``sbv_predict_plain`` within 10 eps
    cond(K_NN) of the output scale (the main path's limit), and the served
    rows must be bitwise the wrapper's output: the server launched the same
    kernel on the same operands. The launch is a comparison one: the caller
    has read the step's counts already."""
    import torch

    from repro_torch.core import predict as tpredict
    from repro_torch.core import vecchia
    from repro_torch.kernels.sbv_predict import sbv_predict_cuda, sbv_predict_plain

    a = tpredict.upload_packed(pk, dev)
    with torch.no_grad():
        pr = (params.beta.double(), params.sigma2.double(), params.nugget.double())
        got = sbv_predict_cuda(*pr, *a)
        want = sbv_predict_plain(*pr, *a)
        nn_m = a[4].bool()
        ev = torch.linalg.eigvalsh(vecchia._masked_cov(a[2], a[2], nn_m, nn_m, *pr, 3.5,
                                                       identity=True))
    msk = a[1].bool()
    cond = float((ev[:, -1] / ev[:, 0]).max())
    scale = max(1.0, max(float(w.abs()[msk].max()) for w in want))
    err = max(float((g - w).abs()[msk].max()) for g, w in zip(got, want))
    tol = max(1e-10, 10 * 2.2e-16 * cond)
    rows = np.asarray(pk.q_idx)[np.asarray(pk.q_mask)]
    h_msk = msk.cpu().numpy()
    same = all(np.array_equal(served[rows], g.cpu().numpy()[h_msk])
               for served, g in zip((mean, var), got))
    log(f"serving {label}: chunk of {len(rows)} points (bc={pk.n_blocks}, bs={pk.bs_pred}, "
        f"m={pk.m_pred}): predict kernel vs plain max abs err {err:.3e} (|out| max {scale:.3g}, "
        f"max cond(K_NN) {cond:.3e}, limit {tol:.1e} x {scale:.3g}); served rows bitwise the "
        f"kernel's: {same}")
    check(bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()),
          f"serving {label}: non-finite kernel output")
    check(err <= tol * scale, f"serving {label}: kernel vs plain {err:.3e} > {tol:.1e} x {scale:.3g}")
    check(same, f"serving {label}: served rows differ from the kernel's output on the chunk")
    return dict(max_abs_err=err, cond=cond, scale=scale)


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

    # 2. Build.
    t = time.perf_counter()
    paths = _build.build(verbose=True)
    log(f"build: {time.perf_counter() - t:.1f} s -> {', '.join(p.name for p in paths.values())}")
    log(f"matern_cov resident CTAs per SM at d={D} f32/f64/bf16: "
        f"{[_build.load('matern_cov').matern_cov_ctas_per_sm(D, v) for v in (0, 1, 2)]}")

    # Data: one realization, 200k train + 50k held out.
    t = time.perf_counter()
    xs, ys = zip(*paper_synthetic_chunks(SEED, N_TRAIN + N_TEST, d=D))
    x_all, y_all = np.concatenate(xs), np.concatenate(ys)
    x_tr, y_tr = x_all[:N_TRAIN], y_all[:N_TRAIN]
    x_te, y_te = x_all[N_TRAIN:], y_all[N_TRAIN:]
    t_gen = time.perf_counter() - t
    log(f"phase generate: {t_gen:.2f} s (n={N_TRAIN + N_TEST}, d={D})")
    log(json.dumps({"reduced": {"n_train": [500_000, N_TRAIN], "n_test": N_TEST,
                                "why": "host preprocess time grows faster than linearly in n; "
                                       "d, m, bs, m_pred, bs_pred and dtype are full"}}))

    cfg = SBVConfig(n_blocks=N_TRAIN // 100, m=M_FIT, seed=SEED)
    init = KernelParams.create(sigma2=float(np.var(y_tr)), beta=0.5, nugget=1e-3, d=D)
    beta_true = np.full(D, 5.0)
    beta_true[:2] = 0.05
    true_p = KernelParams.create(sigma2=1.0, beta=beta_true, nugget=1e-8, device=dev)

    # Round-0 structure of the fit (at the init params), for the kernel checks.
    t = time.perf_counter()
    packed0, _ = preprocess(x_tr, y_tr, init.beta.numpy(), cfg)
    t_pre = time.perf_counter() - t
    log(f"phase preprocess: {t_pre:.2f} s (bc={packed0.n_blocks}, bs_max={packed0.bs_max}, "
        f"m={packed0.m})")

    p0 = init.to(device=dev)
    cast = lambda ts, dt: tuple(a.to(dt) if a.is_floating_point() else a for a in ts)
    par = lambda p, dt: (p.beta.to(dt), p.sigma2.to(dt), p.nugget.to(dt))
    results = {}

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
            ("sbv_loglik_bf16", "src/repro_torch/csrc/sbv_loglik.cu",
             "src/repro/kernels/sbv_loglik.py:289", ladder_launches),
            ("sbv_predict_bf16", "src/repro_torch/csrc/sbv_predict.cu",
             "src/repro/kernels/sbv_predict.py:82", ladder_launches),
            ("sbv_multi_stats_bf16", "src/repro_torch/csrc/sbv_multi_stats.cu",
             "src/repro/kernels/sbv_loglik.py:247", ladder_launches),
            ("matern_cov_bf16", "src/repro_torch/csrc/matern_cov.cu",
             "src/repro/kernels/matern_cov.py:49", ladder_launches)):
        r = results[kname]
        kernels.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": count[kname], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
                        "baseline_ms": r.get("baseline_ms"), "fill_ms": r.get("fill_ms"),
                        "rank_launches": r.get("rank_launches")})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--predict-rank"]:
        sys.exit(predict_rank(sys.argv[2]))
    sys.exit(main())
