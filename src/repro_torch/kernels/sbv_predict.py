"""Fused SBV block prediction: the CUDA kernel and its plain version.

``sbv_predict_blocks`` is the counterpart of ``sbv_predict_pallas`` and
``sbv_predict_tiled`` (src/repro/kernels/sbv_predict.py): per-block
conditional means and variances, each (bc, bs). The CUDA kernel takes any
bs and m, so the tiled entry point's padding contract holds trivially: the
caller's shapes are the kernel's shapes. On CPU tensors the wrapper runs
the plain version, ``repro_torch.core.predict.block_predict`` (or
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


def sbv_predict_cuda(beta, sigma2, nugget, q_x, q_mask, nn_x, nn_y, nn_mask,
                     nu: float = 3.5):
    """Launch the fused predict kernel on CUDA tensors: ``(mu, var)`` at the
    working (``nn_y``) dtype; bf16 coordinates with f32 observations run
    the bf16 variant."""
    dtype = nn_y.dtype
    bc, bs, d = q_x.shape
    m = nn_x.shape[1]
    if q_mask.shape != (bc, bs) or nn_x.shape != (bc, m, d) or nn_y.shape != (bc, m) \
            or nn_mask.shape != (bc, m):
        raise ValueError("sbv_predict: inconsistent packed shapes")
    if nu not in NU_CODES:
        raise ValueError(f"sbv_predict: unsupported nu={nu}")
    variant = kernel_variant("sbv_predict", q_x.dtype, dtype)
    ops = dict(q_x=q_x.contiguous(), nn_x=nn_x.contiguous(), q_mask=as_mask(q_mask, dtype),
               nn_y=nn_y.contiguous(), nn_mask=as_mask(nn_mask, dtype))
    device = _check_operands("sbv_predict", q_x.dtype, dtype,
                             {k: ops[k] for k in ("q_x", "nn_x")},
                             {k: ops[k] for k in ("q_mask", "nn_y", "nn_mask")})
    beta, scal = kernel_scalars(device, dtype, d, beta, sigma2, nugget)
    mu = torch.empty(bc, bs, dtype=dtype, device=device)
    var = torch.empty(bc, bs, dtype=dtype, device=device)
    if bc == 0 or bs == 0:
        return mu, var
    lib = _build.load("sbv_predict")
    with torch.cuda.device(device):
        grid = _grid(lib, "sbv_predict", bc, device, bs, m, d, VARIANT_CODES[variant])
        scratch = torch.empty(grid * lib.sbv_predict_scratch_per_cta(bs, m), dtype=dtype,
                              device=device)
        fn = getattr(lib, f"sbv_predict_{variant}")
        err = fn(beta.data_ptr(), scal.data_ptr(), ops["q_x"].data_ptr(),
                 ops["q_mask"].data_ptr(), ops["nn_x"].data_ptr(), ops["nn_y"].data_ptr(),
                 ops["nn_mask"].data_ptr(), mu.data_ptr(), var.data_ptr(), scratch.data_ptr(),
                 bc, bs, m, d, NU_CODES[nu], grid,
                 torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "sbv_predict")
    _build.LAUNCHES["sbv_predict_bf16" if variant == "bf16" else "sbv_predict"] += 1
    return mu, var


def sbv_predict_blocks(beta, sigma2, nugget, q_x, q_mask, nn_x, nn_y, nn_mask,
                       nu: float = 3.5):
    """``(mu, var)`` per block: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if q_x.is_cuda:
        return sbv_predict_cuda(beta, sigma2, nugget, q_x, q_mask, nn_x, nn_y, nn_mask, nu=nu)
    return sbv_predict_plain(beta, sigma2, nugget, q_x, q_mask, nn_x, nn_y, nn_mask, nu=nu)
