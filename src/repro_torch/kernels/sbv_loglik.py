"""Fused SBV block log-likelihood: the CUDA kernel and its plain version.

``sbv_loglik_blocks`` is the counterpart of ``sbv_loglik_pallas``
(src/repro/kernels/sbv_loglik.py): per-block log-densities, shape (bc,).
On CUDA tensors it launches ``csrc/sbv_loglik.cu``; on CPU tensors it runs
the plain version, ``repro_torch.core.vecchia.block_loglik``. A CUDA
tensor never reaches the plain version through this wrapper.
"""
from __future__ import annotations

import torch

from repro_torch.core.vecchia import block_loglik

from . import _build

NU_CODES = {0.5: 0, 1.5: 1, 2.5: 2, 3.5: 3}


def sbv_loglik_plain(beta, sigma2, nugget, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
                     nu: float = 3.5) -> torch.Tensor:
    """The plain torch version of the kernel (per-block, (bc,))."""
    return block_loglik(beta, sigma2, nugget, blk_x, blk_y, blk_mask.bool(),
                        nn_x, nn_y, nn_mask.bool(), nu=nu)


def _grid(lib, prefix: str, bc: int, device: torch.device, *shape: int) -> int:
    """CTAs to launch: as many as fit on the card at once, at most ``bc``.
    ``shape`` is the kernel's ``(bs, m, d, [p,] f64)``."""
    per_sm = getattr(lib, f"{prefix}_ctas_per_sm")(*shape)
    if per_sm <= 0:
        smem = getattr(lib, f"{prefix}_smem_bytes")(*shape)
        raise RuntimeError(f"{prefix}: no CTA fits on an SM at (bs, m, d, ..., f64)={shape} "
                           f"({smem} bytes of shared memory; code {per_sm})")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(bc, per_sm * sms))


def _check_operands(name: str, dtype, tensors: dict) -> torch.device:
    if dtype not in (torch.float64, torch.float32):
        raise TypeError(f"{name}: kernel runs in float64 or float32, got {dtype}")
    device = None
    for key, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is not a CUDA tensor")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, expected {dtype}")
        if device is not None and t.device != device:
            raise ValueError(f"{name}: operands on several devices")
        device = t.device
    return device


def sbv_loglik_cuda(beta, sigma2, nugget, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
                    nu: float = 3.5) -> torch.Tensor:
    """Launch the fused likelihood kernel on CUDA tensors. Per-block (bc,).

    The observation dtype (f64 or f32) is the kernel's working dtype;
    coordinates, masks and parameters are converted to it."""
    dtype = blk_y.dtype
    bc, bs, d = blk_x.shape
    m = nn_x.shape[1]
    if blk_y.shape != (bc, bs) or blk_mask.shape != (bc, bs) or nn_x.shape != (bc, m, d) \
            or nn_y.shape != (bc, m) or nn_mask.shape != (bc, m):
        raise ValueError("sbv_loglik: inconsistent packed shapes")
    if nu not in NU_CODES:
        raise ValueError(f"sbv_loglik: unsupported nu={nu}")
    cv = lambda t: t.to(dtype).contiguous()
    ops = dict(blk_x=cv(blk_x), blk_y=cv(blk_y), blk_mask=cv(blk_mask), nn_x=cv(nn_x),
               nn_y=cv(nn_y), nn_mask=cv(nn_mask))
    device = _check_operands("sbv_loglik", dtype, ops)
    beta = torch.as_tensor(beta).to(device=device, dtype=dtype).reshape(d).contiguous()
    scal = torch.stack([torch.as_tensor(sigma2).to(device=device, dtype=dtype).reshape(()),
                        torch.as_tensor(nugget).to(device=device, dtype=dtype).reshape(())])
    out = torch.empty(bc, dtype=dtype, device=device)
    if bc == 0:
        return out
    lib = _build.load("sbv_loglik")
    f64 = dtype == torch.float64
    with torch.cuda.device(device):
        grid = _grid(lib, "sbv_loglik", bc, device, bs, m, d, int(f64))
        scratch = torch.empty(grid * lib.sbv_loglik_scratch_per_cta(bs, m), dtype=dtype,
                              device=device)
        fn = lib.sbv_loglik_f64 if f64 else lib.sbv_loglik_f32
        err = fn(beta.data_ptr(), scal.data_ptr(), ops["blk_x"].data_ptr(),
                 ops["blk_y"].data_ptr(), ops["blk_mask"].data_ptr(), ops["nn_x"].data_ptr(),
                 ops["nn_y"].data_ptr(), ops["nn_mask"].data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), bc, bs, m, d, NU_CODES[nu], grid,
                 torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "sbv_loglik")
    _build.LAUNCHES["sbv_loglik"] += 1
    return out


def sbv_loglik_blocks(beta, sigma2, nugget, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
                      nu: float = 3.5) -> torch.Tensor:
    """Per-block log-likelihoods, shape (bc,): the kernel on CUDA tensors,
    the plain version on CPU tensors."""
    if blk_x.is_cuda:
        return sbv_loglik_cuda(beta, sigma2, nugget, blk_x, blk_y, blk_mask,
                               nn_x, nn_y, nn_mask, nu=nu)
    return sbv_loglik_plain(beta, sigma2, nugget, blk_x, blk_y, blk_mask,
                            nn_x, nn_y, nn_mask, nu=nu)
