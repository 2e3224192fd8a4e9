"""Fused SBV block prediction: the CUDA kernel and its plain version.

``sbv_predict_blocks_many`` is the counterpart of ``sbv_predict_pallas``
and ``sbv_predict_tiled`` (src/repro/kernels/sbv_predict.py): per-block
conditional means and variances, each (bc, bs), of every piece of one
chunk (its size buckets, or its one uniform piece). On CUDA tensors it
computes all of them in ONE launch: the kernel walks a list of per-bucket
descriptors (``csrc/sbv_predict.cu``). The CUDA kernel takes any bs and m,
so the tiled entry point's padding contract holds trivially: the caller's
shapes are the kernel's shapes. On CPU tensors the wrapper runs the plain
version piece by piece, ``repro_torch.core.predict.block_predict`` (or
``block_predict_narrow`` for bf16 coordinates: the bf16-assembly tier).
"""
from __future__ import annotations

import torch

from . import _build
from .sbv_loglik import (NU_CODES, VARIANT_CODES, _check_operands, _grid, as_mask,
                         kernel_scalars, kernel_variant)


def sbv_predict_plain(beta, sigma2, nugget, q_x, q_mask, nn_x, nn_y, nn_mask,
                      nu: float = 3.5):
    """The plain torch version of the kernel: ``(mu, var)``, each (bc, bs)."""
    from repro_torch.core.predict import block_predict, block_predict_narrow

    fn = block_predict_narrow if q_x.dtype == torch.bfloat16 else block_predict
    return fn(beta, sigma2, nugget, q_x, q_mask.bool(), nn_x, nn_y, nn_mask.bool(), nu=nu)


def _operands(q_x, q_mask, nn_x, nn_y, nn_mask, nu: float):
    """Shape, dtype and device checks of one piece: ``(variant, ops,
    device, (bc, bs, m, d))`` with the operands contiguous and the masks
    at the working (``nn_y``) dtype."""
    dtype = nn_y.dtype
    bc, bs, d = q_x.shape
    m = nn_x.shape[1]
    if q_mask.shape != (bc, bs) or nn_x.shape != (bc, m, d) or nn_y.shape != (bc, m) \
            or nn_mask.shape != (bc, m):
        raise ValueError("sbv_predict: inconsistent packed shapes")
    if nu not in NU_CODES:
        raise ValueError(f"sbv_predict: unsupported nu={nu}")
    variant = kernel_variant("sbv_predict", q_x.dtype, dtype)
    ops = dict(q_x=q_x.contiguous(), q_mask=as_mask(q_mask, dtype), nn_x=nn_x.contiguous(),
               nn_y=nn_y.contiguous(), nn_mask=as_mask(nn_mask, dtype))
    device = _check_operands("sbv_predict", q_x.dtype, dtype,
                             {k: ops[k] for k in ("q_x", "nn_x")},
                             {k: ops[k] for k in ("q_mask", "nn_y", "nn_mask")})
    return variant, ops, device, (bc, bs, m, d)


def sbv_predict_cuda_many(beta, sigma2, nugget, pieces, nu: float = 3.5):
    """Launch the fused predict kernel ONCE over the pieces of a chunk:
    ``pieces`` is a list of ``(q_x, q_mask, nn_x, nn_y, nn_mask)`` CUDA
    tuples (each its own bc, bs and m; one variant and one d for all).
    Returns one ``(mu, var)`` per piece, at the working (``nn_y``) dtype;
    bf16 coordinates with f32 observations run the bf16 variant."""
    checked = [_operands(*pc, nu=nu) for pc in pieces]
    if not checked:
        return []
    variant, _, device, (_, _, _, d) = checked[0]
    for v, _, dv, shape in checked:
        if v != variant or shape[3] != d:
            raise TypeError("sbv_predict: the pieces of one launch differ in variant or d")
        if dv != device:
            raise ValueError("sbv_predict: operands on several devices")
    dtype = checked[0][1]["nn_y"].dtype
    beta, scal = kernel_scalars(device, dtype, d, beta, sigma2, nugget)
    outs = [tuple(torch.empty(bc, bs, dtype=dtype, device=device) for _ in range(2))
            for _, _, _, (bc, bs, _, _) in checked]
    words, total, big = [], 0, None
    for (_, ops, _, (bc, bs, m, _)), (mu, var) in zip(checked, outs):
        if bc == 0 or bs == 0:
            continue
        words.append([ops[k].data_ptr() for k in ("q_x", "q_mask", "nn_x", "nn_y", "nn_mask")]
                     + [mu.data_ptr(), var.data_ptr(), bc, bs, m, total])
        total += bc
        if big is None or m + bs > big[0] + big[1]:
            big = (bs, m)
    if not words:
        return outs
    lib = _build.load("sbv_predict")
    with torch.cuda.device(device):
        grid = _grid(lib, "sbv_predict", total, device, *big, d, VARIANT_CODES[variant])
        per_cta = max(lib.sbv_predict_scratch_per_cta(w[8], w[9]) for w in words)
        scratch = torch.empty(grid * per_cta, dtype=dtype, device=device)
        # Pinned and non-blocking: the host does not wait for the stream's
        # earlier work (a chunk pipeline launches chunk k while k-1 runs).
        tasks = torch.tensor(words, dtype=torch.int64).pin_memory().to(device,
                                                                      non_blocking=True)
        err = getattr(lib, f"sbv_predict_{variant}")(
            beta.data_ptr(), scal.data_ptr(), tasks.data_ptr(), len(words), total, *big, d,
            NU_CODES[nu], scratch.data_ptr(), per_cta, grid,
            torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "sbv_predict")
    _build.LAUNCHES["sbv_predict_bf16" if variant == "bf16" else "sbv_predict"] += 1
    return outs


def sbv_predict_cuda(beta, sigma2, nugget, q_x, q_mask, nn_x, nn_y, nn_mask,
                     nu: float = 3.5):
    """Launch the fused predict kernel on one piece of CUDA tensors:
    ``(mu, var)`` at the working (``nn_y``) dtype."""
    return sbv_predict_cuda_many(beta, sigma2, nugget,
                                 [(q_x, q_mask, nn_x, nn_y, nn_mask)], nu=nu)[0]


def _launch_panel(beta, sigma2, nugget, q_x, q_mask, nn_x, nn_y, nn_mask, nu: float = 3.5):
    """The kernel's earlier design (padded blocks, ``panel_cholesky``, one
    piece per launch), kept for side-by-side timings; not counted as a
    launch of the path."""
    variant, ops, device, (bc, bs, m, d) = _operands(q_x, q_mask, nn_x, nn_y, nn_mask, nu)
    dtype = ops["nn_y"].dtype
    beta, scal = kernel_scalars(device, dtype, d, beta, sigma2, nugget)
    mu = torch.empty(bc, bs, dtype=dtype, device=device)
    var = torch.empty(bc, bs, dtype=dtype, device=device)
    if bc == 0 or bs == 0:
        return mu, var
    lib = _build.load("sbv_predict")
    with torch.cuda.device(device):
        grid = _grid(lib, "sbv_predict_panel", bc, device, bs, m, d, VARIANT_CODES[variant])
        scratch = torch.empty(grid * lib.sbv_predict_scratch_per_cta(bs, m), dtype=dtype,
                              device=device)
        err = getattr(lib, f"sbv_predict_panel_{variant}")(
            beta.data_ptr(), scal.data_ptr(), ops["q_x"].data_ptr(), ops["q_mask"].data_ptr(),
            ops["nn_x"].data_ptr(), ops["nn_y"].data_ptr(), ops["nn_mask"].data_ptr(),
            mu.data_ptr(), var.data_ptr(), scratch.data_ptr(), bc, bs, m, d, NU_CODES[nu], grid,
            torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "sbv_predict_panel")
    return mu, var


def sbv_predict_blocks_many(beta, sigma2, nugget, pieces, nu: float = 3.5):
    """``(mu, var)`` of each piece: one kernel launch for all of them on
    CUDA tensors, the plain version piece by piece on CPU tensors."""
    if any(pc[0].is_cuda for pc in pieces):
        return sbv_predict_cuda_many(beta, sigma2, nugget, pieces, nu=nu)
    return [sbv_predict_plain(beta, sigma2, nugget, *pc, nu=nu) for pc in pieces]
