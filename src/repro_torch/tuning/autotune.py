"""Shape autotuner: measured candidate runs -> persistent ``TuningRecord``.

Counterpart of ``repro.tuning.autotune``. The bucketed and mixed-precision
layer has a handful of shape knobs whose best setting depends on the
dataset's block-size histogram and on the device: the bucket count K, the
per-bucket (bs, m) ceilings K induces, the kernel backend and the
precision tier. The work model (``core.buckets.loglik_work``) ranks
candidates by padded FLOPs, but where launch overhead beats padding waste,
or a narrow tier's assembly beats its casts, is a fact of the device, so
the autotuner measures: each candidate layout runs the real
``packed_loglik`` (one ``sbv_loglik`` launch per bucket on a CUDA device)
a few times and the fastest wins.

On the CUDA kernels every bucket ceiling is exact (``bucket_mults`` gives
(1, 1)) and ``'auto'`` is the kernel route for every shape and tier, so
the record's tile multiples are 1 and its backend is the caller's.
Probing cost is bounded: candidates run on a row subsample
(``sample_rows``), a handful of evaluations each, paid once per
(dataset, device) pairing.
"""
from __future__ import annotations

import time

import numpy as np
import torch


def _size_stats(sizes: np.ndarray) -> dict:
    sizes = np.asarray(sizes, dtype=np.float64)
    if sizes.size == 0:
        return {"min": 0, "p50": 0, "max": 0, "mean": 0.0}
    return {
        "min": int(sizes.min()),
        "p50": int(np.median(sizes)),
        "max": int(sizes.max()),
        "mean": float(sizes.mean()),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_loglik(params, packed, nu, backend, repeats: int, arrays=None) -> float:
    """Best-of-N wall time of one likelihood evaluation (forward only, under
    ``no_grad``). The first call is left out (the kernels' first launch
    loads their library), and the card is synchronised before and after
    every repeat, so each one times its own work."""
    from repro_torch.core.vecchia import packed_loglik

    device = params.log_beta.device
    with torch.no_grad():
        packed_loglik(params, packed, nu=nu, backend=backend, arrays=arrays)
        best = float("inf")
        for _ in range(max(1, repeats)):
            _sync(device)
            t0 = time.perf_counter()
            packed_loglik(params, packed, nu=nu, backend=backend, arrays=arrays)
            _sync(device)
            best = min(best, time.perf_counter() - t0)
    return best


def _itemsize(dtype) -> int:
    """Bytes per element of a numpy or torch dtype."""
    return dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize


def recommend_stream_chunk(n_rows: int, d: int, m: int, bs_avg: float,
                           tier: str = "f64", budget: int | None = None,
                           frac: float = 0.25) -> int | None:
    """Streaming rows per pass from the device byte budget.

    Inverts the ``working_set_model`` packed-chunk term: a chunk costs ~4x
    its packed bytes resident (host load + device transfer + allocator
    slack), and a packed row carries its coordinates at the tier's storage
    width, its observation at the accumulation width, one mask byte, and an
    amortised ``m / bs_avg`` share of its block's neighbour rows. ``frac``
    of the budget goes to the chunk window (the rest stays with the device
    spool cache and the gradient's live set). Returns ``None`` when the
    whole dataset fits in one chunk: in-core execution is better then."""
    from repro_torch.core.buckets import acc_dtype, storage_dtype

    if budget is None:
        from repro_torch.data.streaming import device_cache_budget

        budget = device_cache_budget()
    st = _itemsize(storage_dtype(tier))
    ac = _itemsize(acc_dtype(tier))
    per_row = (d * st + ac + 1) * (1.0 + m / max(bs_avg, 1.0))
    chunk = int(frac * budget / (4.0 * per_row))
    chunk = max(4096, chunk)
    if chunk >= n_rows:
        return None
    return chunk


def autotune_loglik(
    x: np.ndarray,
    y: np.ndarray,
    cfg,
    params=None,
    nu: float = 3.5,
    backend: str = "auto",
    tiers=("bf16", "f32", "f64"),
    bucket_grid=(0, 2, 4, 8),
    error_budget: float | None = None,
    repeats: int = 3,
    sample_rows: int | None = 20000,
    save_dir: str | None = None,
    verbose: bool = False,
    device=None,
):
    """Measure the (K x tier) candidate grid and return the TuningRecord.

    ``bucket_grid`` entries are bucket levels K (0 = the uniform layout);
    ``tiers`` are ladder candidates, each enforced by ``assign_precision``
    probing before it is timed, so a candidate is timed (and recorded) at
    the tiers it would actually run. ``sample_rows`` caps the measurement
    subsample (None = the whole dataset). ``save_dir`` persists the record
    (``tuning_record.json``) for ``fit_sbv(tuning=)`` /
    ``predict_sbv(tuning=)`` / ``serve gp --tuning-record``. Runs on
    ``device`` (default: the current CUDA device; pass ``device='cpu'``
    without a GPU)."""
    from repro_torch.core.buckets import (PrecisionPolicy, _true_sizes, acc_dtype,
                                          apply_precision, assign_precision, bucket_blocks,
                                          bucket_mults, cast_packed, loglik_work)
    from repro_torch.core.kernels_math import KernelParams
    from repro_torch.core.pipeline import preprocess
    from repro_torch.core.vecchia import packed_arrays
    from repro_torch.data.streaming import device_cache_budget
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops as kops

    from .record import TuningRecord

    dev = resolve_device(device)
    x = np.asarray(x)
    y = np.asarray(y)
    n_full, d = x.shape
    if sample_rows is not None and n_full > sample_rows:
        # A deterministic stride subsample keeps the spatial spread (and so
        # the block-size histogram's shape).
        idx = np.linspace(0, n_full - 1, sample_rows).astype(np.int64)
        x_s, y_s = x[idx], y[idx]
    else:
        x_s, y_s = x, y
    if params is None:
        params = KernelParams.create(sigma2=float(np.var(y_s)), beta=0.5, nugget=1e-3, d=d)
    params = KernelParams(*(torch.as_tensor(a).to(dev) for a in params))

    packed, _ = preprocess(x_s, y_s, params.beta.cpu().numpy(), cfg)
    bs_true = _true_sizes(packed.blk_mask)
    m_true = _true_sizes(packed.nn_mask)
    histogram = {"bs": _size_stats(bs_true), "m": _size_stats(m_true)}

    candidates = []
    best = None
    for k in bucket_grid:
        layout = bucket_blocks(packed, n_buckets=k) if k else packed
        for tier in tiers:
            policy = PrecisionPolicy(tier=tier, error_budget=error_budget)
            assigned = assign_precision(params, layout, policy, nu=nu, backend=backend)
            if k:
                cast = apply_precision(layout, assigned)
                occ = cast.occupancy()
            else:
                cast = cast_packed(packed, assigned[0])
                true_f, padded_f = loglik_work([cast])
                occ = true_f / padded_f if padded_f else 1.0
            t = _time_loglik(params, cast, nu, backend, repeats,
                             arrays=packed_arrays(cast, dev))
            cand = {"n_buckets": k or None, "precision": tier,
                    "tiers": list(assigned), "time_s": t, "occupancy": occ}
            candidates.append(cand)
            if verbose:
                print(f"[autotune] K={k or '-'} tier={tier} -> "
                      f"{t * 1e3:.2f} ms occ={occ:.3f} tiers={assigned}")
            if best is None or t < best[0]:
                best = (t, k, tier, assigned, cast, occ)

    _, k_win, tier_win, tiers_win, cast_win, occ_win = best
    if k_win:
        bs_ceils = [int(pk.bs_max) for pk in cast_win.buckets]
        m_ceils = [int(pk.m) for pk in cast_win.buckets]
    else:
        bs_ceils = [int(packed.bs_max)]
        m_ceils = [int(packed.m)]

    # Predict-side tile multiples of the winning tier: (1, 1) on the CUDA
    # kernels, which take any bs and m.
    pred_backend = kops.select_backend(int(packed.bs_max), int(packed.m), kind="predict")
    bs_mult, m_mult = bucket_mults(pred_backend, precision=tier_win)

    acc_bytes = np.dtype(acc_dtype(tier_win)).itemsize
    reserve = 16 * 16 * (int(packed.bs_max) + int(packed.m)) ** 2 * acc_bytes
    budget = device_cache_budget(reserve_bytes=reserve, device=dev)
    stream_chunk = recommend_stream_chunk(n_full, d, int(packed.m),
                                          float(max(bs_true.mean(), 1.0)),
                                          tier=tier_win, budget=budget)

    record = TuningRecord(
        n_buckets=k_win or None,
        bs_ceilings=bs_ceils,
        m_ceilings=m_ceils,
        bs_mult=int(bs_mult),
        m_mult=int(m_mult),
        backend=backend,
        precision=tier_win,
        bucket_tiers=list(tiers_win),
        error_budget=error_budget,
        stream_chunk=stream_chunk,
        device_cache_budget=int(budget),
        occupancy=float(occ_win),
        histogram=histogram,
        candidates=candidates,
        meta={
            "n_rows": int(n_full), "sampled_rows": int(x_s.shape[0]),
            "d": int(d), "m": int(packed.m), "bs_max": int(packed.bs_max),
            "nu": float(nu), "device": dev.type, "repeats": int(repeats),
        },
    )
    if save_dir is not None:
        record.save(save_dir)
    return record
