"""Fused multi-output SBV block stats: the CUDA kernel and its plain version.

``sbv_multi_stats_blocks`` is the counterpart of ``sbv_multi_stats_pallas``
(src/repro/kernels/sbv_loglik.py): per block the row
``[logdet0, q_1 .. q_p]``, shape (bc, 1 + p), from one Cholesky with the p
observation columns as extra right-hand sides. On CUDA tensors it launches
``csrc/sbv_multi_stats.cu``; on CPU tensors it runs the plain version,
``repro_torch.core.multioutput.block_multi_stats`` (``block_multi_stats_narrow``
for bf16 coordinates). A CUDA tensor never reaches the plain version through
this wrapper. ``_launch("sbv_multi_stats_panel", ...)`` runs the kernel's
earlier design (padded blocks, ``panel_cholesky``) for side-by-side
timings; its launches are not counted.
"""
from __future__ import annotations

import torch

from repro_torch.core.multioutput import block_multi_stats, block_multi_stats_narrow

from . import _build
from .sbv_loglik import (NU_CODES, VARIANT_CODES, _check_operands, _grid, as_mask,
                         kernel_scalars, kernel_variant)


def sbv_multi_stats_plain(beta, sigma2, nugget, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
                          nu: float = 3.5) -> torch.Tensor:
    """The plain torch version of the kernel: (bc, 1 + p)."""
    fn = block_multi_stats_narrow if blk_x.dtype == torch.bfloat16 else block_multi_stats
    ld, q = fn(beta, sigma2, nugget, blk_x, blk_y, blk_mask.bool(), nn_x, nn_y, nn_mask.bool(),
               nu=nu)
    return torch.cat([ld[:, None], q], dim=1)


def _launch(prefix: str, beta, sigma2, nugget, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
            nu: float) -> torch.Tensor:
    """Check the operands and launch the C entry points ``{prefix}_{variant}``
    (``sbv_multi_stats``: the kernel; ``sbv_multi_stats_panel``: its earlier
    design, kept for side-by-side timings). (bc, 1 + p)."""
    dtype = blk_y.dtype
    bc, bs, d = blk_x.shape
    m = nn_x.shape[1]
    if blk_y.dim() != 3:
        raise ValueError("sbv_multi_stats: observations must be (bc, bs, p)")
    p = blk_y.shape[2]
    if blk_y.shape != (bc, bs, p) or blk_mask.shape != (bc, bs) or nn_x.shape != (bc, m, d) \
            or nn_y.shape != (bc, m, p) or nn_mask.shape != (bc, m):
        raise ValueError("sbv_multi_stats: inconsistent packed shapes")
    if nu not in NU_CODES:
        raise ValueError(f"sbv_multi_stats: unsupported nu={nu}")
    variant = kernel_variant("sbv_multi_stats", blk_x.dtype, dtype)
    ops = dict(blk_x=blk_x.contiguous(), nn_x=nn_x.contiguous(), blk_y=blk_y.contiguous(),
               blk_mask=as_mask(blk_mask, dtype), nn_y=nn_y.contiguous(),
               nn_mask=as_mask(nn_mask, dtype))
    device = _check_operands("sbv_multi_stats", blk_x.dtype, dtype,
                             {k: ops[k] for k in ("blk_x", "nn_x")},
                             {k: ops[k] for k in ("blk_y", "blk_mask", "nn_y", "nn_mask")})
    beta, scal = kernel_scalars(device, dtype, d, beta, sigma2, nugget)
    out = torch.empty(bc, 1 + p, dtype=dtype, device=device)
    if bc == 0:
        return out
    lib = _build.load("sbv_multi_stats")
    with torch.cuda.device(device):
        grid = _grid(lib, prefix, bc, device, bs, m, d, p, VARIANT_CODES[variant])
        scratch = torch.empty(grid * lib.sbv_multi_stats_scratch_per_cta(bs, m, p), dtype=dtype,
                              device=device)
        fn = getattr(lib, f"{prefix}_{variant}")
        err = fn(beta.data_ptr(), scal.data_ptr(), ops["blk_x"].data_ptr(),
                 ops["blk_y"].data_ptr(), ops["blk_mask"].data_ptr(), ops["nn_x"].data_ptr(),
                 ops["nn_y"].data_ptr(), ops["nn_mask"].data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), bc, bs, m, d, p, NU_CODES[nu], grid,
                 torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, prefix)
    return out


def sbv_multi_stats_cuda(beta, sigma2, nugget, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
                         nu: float = 3.5) -> torch.Tensor:
    """Launch the fused multi-output stats kernel on CUDA tensors: (bc, 1 + p).

    The observation dtype (f64 or f32) is the kernel's working dtype;
    coordinates are at that dtype, or bf16 with f32 observations (the bf16
    variant). Boolean masks and the parameters are converted to it."""
    out = _launch("sbv_multi_stats", beta, sigma2, nugget, blk_x, blk_y, blk_mask, nn_x, nn_y,
                  nn_mask, nu)
    if out.shape[0]:
        _build.LAUNCHES["sbv_multi_stats_bf16" if blk_x.dtype == torch.bfloat16
                        else "sbv_multi_stats"] += 1
    return out


def sbv_multi_stats_blocks(beta, sigma2, nugget, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
                           nu: float = 3.5) -> torch.Tensor:
    """Per-block ``[logdet0, q_1 .. q_p]``, (bc, 1 + p): the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if blk_x.is_cuda:
        return sbv_multi_stats_cuda(beta, sigma2, nugget, blk_x, blk_y, blk_mask,
                                    nn_x, nn_y, nn_mask, nu=nu)
    return sbv_multi_stats_plain(beta, sigma2, nugget, blk_x, blk_y, blk_mask,
                                 nn_x, nn_y, nn_mask, nu=nu)
