#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from src/repro_torch/csrc, holds each one
against its plain PyTorch version at the main path's shapes (f64 and f32),
times both, then drives the main path once through the user entry points:
``fit_sbv`` (2 structure rounds x 3 Adam steps, f64) on 200,000 points of
the paper's 10-d synthetic GP, and ``predict_sbv`` on 50,000 held-out points
of the same realization. It checks that every kernel of the path launched,
that the outputs are finite and right, and prints per-kernel numbers as one
JSON line and, last, ``{"ok": true, "device": {...}}``.

Exits non-zero, with no result line, when no CUDA device is visible, when
the repository's sources are not beside this file, or when any check fails.
"""
from __future__ import annotations

import json
import math
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

# Published H100 SXM peaks (NVIDIA data sheet): f64 on the tensor cores, HBM3.
PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12)}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 5, warm: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def card_peaks(name: str) -> tuple[float, float]:
    return PEAKS["pcie" if "PCIe" in name else "sxm"]


def loglik_work(packed_np) -> tuple[float, float]:
    """(flops, bytes) this run's data needs: factor/solve operations from
    the real per-block counts, each input read once, one scalar out."""
    m_b = packed_np.nn_mask.sum(axis=1).astype(float)
    bs_b = packed_np.blk_mask.sum(axis=1).astype(float)
    flops = float(np.sum(m_b ** 3 / 3 + m_b ** 2 * (bs_b + 1) + m_b * bs_b ** 2 + bs_b ** 3 / 3))
    nbytes = float(sum(a.size * 8 for a in (packed_np.blk_x, packed_np.blk_y, packed_np.blk_mask,
                                            packed_np.nn_x, packed_np.nn_y, packed_np.nn_mask)))
    return flops, nbytes + 8 * packed_np.blk_x.shape[0]


def predict_work(packed_np) -> tuple[float, float]:
    m_b = packed_np.nn_mask.sum(axis=1).astype(float)
    bs_b = packed_np.q_mask.sum(axis=1).astype(float)
    flops = float(np.sum(m_b ** 3 / 3 + m_b ** 2 * (bs_b + 1) + m_b * bs_b))
    nbytes = float(sum(a.size * 8 for a in packed_np.arrays()))
    return flops, nbytes + 2 * 8 * packed_np.q_mask.size


def bound_ms(flops: float, nbytes: float, peaks) -> tuple[float, str]:
    t_ops, t_bytes = flops / peaks[0] * 1e3, nbytes / peaks[1] * 1e3
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
    from repro_torch.core import predict as tpredict
    from repro_torch.core import vecchia
    from repro_torch.core.fit import fit_sbv, neg_loglik_fn
    from repro_torch.data.gp_sim import paper_synthetic_chunks
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.sbv_loglik import sbv_loglik_cuda, sbv_loglik_plain
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
    log(f"peaks used for bounds: f64 {peaks[0] / 1e12:g} TFLOP/s, HBM {peaks[1] / 1e12:g} TB/s")

    # 2. Build.
    t = time.perf_counter()
    paths = _build.build(verbose=True)
    log(f"build: {time.perf_counter() - t:.1f} s -> {', '.join(p.name for p in paths.values())}")

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

    # Time at the main path's shape: one likelihood evaluation of round 0.
    arrs0 = vecchia.packed_arrays(packed0, dev)
    k_ms = cuda_ms(lambda: sbv_loglik_cuda(*par(p0, torch.float64), *arrs0))
    k32_ms = cuda_ms(lambda: sbv_loglik_cuda(*par(p0, torch.float32),
                                             *cast(arrs0, torch.float32)))
    with torch.no_grad():
        pl_ms = cuda_ms(lambda: sbv_loglik_plain(*par(p0, torch.float64), *arrs0), reps=3)
    flops, nbytes = loglik_work(packed0)
    b_ms, b_by = bound_ms(flops, nbytes, peaks)
    log(f"loglik time at bc={packed0.n_blocks} bs={packed0.bs_max} m={packed0.m}: kernel f64 "
        f"{k_ms:.3f} ms, f32 {k32_ms:.3f} ms; plain f64 {pl_ms:.3f} ms; bound {b_ms:.4f} ms "
        f"({b_by}; {flops:.3e} flop, {nbytes:.3e} B)")
    results["sbv_loglik"] = dict(max_abs_err=full_err, ms=k_ms, plain_ms=pl_ms, bound_ms=b_ms,
                                 bound_by=b_by, f32_ms=k32_ms)

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
    pk_ms = cuda_ms(lambda: sbv_predict_cuda(*par(true_p, torch.float64), *arrs_c))
    pk32_ms = cuda_ms(lambda: sbv_predict_cuda(*par(true_p, torch.float32),
                                               *cast(arrs_c, torch.float32)))
    pp_ms = cuda_ms(lambda: sbv_predict_plain(*par(true_p, torch.float64), *arrs_c), reps=3)
    flops, nbytes = predict_work(chunk0)
    pb_ms, pb_by = bound_ms(flops, nbytes, peaks)
    log(f"predict time at bc={chunk0.n_blocks} bs={chunk0.bs_pred} m={chunk0.m_pred}: kernel f64 "
        f"{pk_ms:.3f} ms, f32 {pk32_ms:.3f} ms; plain f64 {pp_ms:.3f} ms; bound {pb_ms:.4f} ms "
        f"({pb_by}; {flops:.3e} flop, {nbytes:.3e} B)")
    results["sbv_predict"] = dict(max_abs_err=pred_err, ms=pk_ms, plain_ms=pp_ms,
                                  bound_ms=pb_ms, bound_by=pb_by, f32_ms=pk32_ms)

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

    kernels = []
    for kname, src, replaces in (
            ("sbv_loglik", "src/repro_torch/csrc/sbv_loglik.cu",
             "src/repro/kernels/sbv_loglik.py:289"),
            ("sbv_predict", "src/repro_torch/csrc/sbv_predict.cu",
             "src/repro/kernels/sbv_predict.py:82")):
        r = results[kname]
        kernels.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": launches[kname], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
