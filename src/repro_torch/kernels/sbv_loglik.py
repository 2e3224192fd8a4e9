"""Fused SBV block log-likelihood: the CUDA kernel and its plain version.

``sbv_loglik_blocks`` is the counterpart of ``sbv_loglik_pallas``
(src/repro/kernels/sbv_loglik.py): per-block log-densities, shape (bc,).
On CUDA tensors it launches ``csrc/sbv_loglik.cu``; on CPU tensors it runs
the plain version, ``repro_torch.core.vecchia.block_loglik`` (or, for bf16
coordinates, ``block_loglik_narrow``, the Pallas body's bf16-assembly
form). A CUDA tensor never reaches the plain version through this wrapper.

The observation dtype is the kernel's working dtype (f64 or f32). The
coordinates are stored at that dtype, or as bf16 with f32 observations:
the precision ladder's bf16-assembly tier, a variant of its own.
"""
from __future__ import annotations

import torch

from repro_torch.core.vecchia import block_loglik, block_loglik_narrow

from . import _build

NU_CODES = {0.5: 0, 1.5: 1, 2.5: 2, 3.5: 3}
# The kernels' variant codes (their C entry points' `variant` argument).
VARIANT_CODES = {"f32": 0, "f64": 1, "bf16": 2}


def sbv_loglik_plain(beta, sigma2, nugget, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
                     nu: float = 3.5) -> torch.Tensor:
    """The plain torch version of the kernel (per-block, (bc,))."""
    fn = block_loglik_narrow if blk_x.dtype == torch.bfloat16 else block_loglik
    return fn(beta, sigma2, nugget, blk_x, blk_y, blk_mask.bool(), nn_x, nn_y, nn_mask.bool(),
              nu=nu)


def ladder_dtypes(dtype):
    """(assembly, accumulation) dtypes for a coordinate storage dtype on the
    precision ladder: bf16 coordinates assemble at bf16 and accumulate in
    f32; f32 and f64 storage accumulate at their own width."""
    if dtype == torch.bfloat16:
        return torch.bfloat16, torch.float32
    return dtype, dtype


def kernel_variant(name: str, coord_dtype, work_dtype) -> str:
    """The kernel variant for coordinates of ``coord_dtype`` with the
    working (observation) dtype ``work_dtype``: 'f64', 'f32', or 'bf16'
    (bf16 coordinates, f32 working type). Any other mix raises
    ``TypeError``: the kernels convert no operand to another width."""
    if work_dtype not in (torch.float64, torch.float32):
        raise TypeError(f"{name}: kernel works in float64 or float32, got {work_dtype}")
    if coord_dtype == work_dtype:
        return "f64" if work_dtype == torch.float64 else "f32"
    if coord_dtype == torch.bfloat16 and work_dtype == torch.float32:
        return "bf16"
    raise TypeError(f"{name}: coordinates in {coord_dtype} with a {work_dtype} working dtype; "
                    "coordinates must be at the working dtype, or bfloat16 with float32")


def _grid(lib, prefix: str, bc: int, device: torch.device, *shape: int) -> int:
    """CTAs to launch: as many as fit on the card at once, at most ``bc``.
    ``shape`` is the kernel's ``(bs, m, d, [p,] variant)``."""
    per_sm = getattr(lib, f"{prefix}_ctas_per_sm")(*shape)
    if per_sm <= 0:
        smem = getattr(lib, f"{prefix}_smem_bytes")(*shape)
        raise RuntimeError(f"{prefix}: no CTA fits on an SM at (bs, m, d, ..., variant)={shape} "
                           f"({smem} bytes of shared memory; code {per_sm})")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(bc, per_sm * sms))


def _check_operands(name: str, coord_dtype, work_dtype, coords: dict,
                    work: dict) -> torch.device:
    """Dtype and device checks: the coordinates at ``coord_dtype``, the rest
    at ``work_dtype``, every operand on one CUDA device."""
    for group, dtype in ((coords, coord_dtype), (work, work_dtype)):
        for key, t in group.items():
            if t.dtype != dtype:
                raise TypeError(f"{name}: {key} has dtype {t.dtype}, expected {dtype}")
    device = None
    for key, t in {**coords, **work}.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: {key} is not a CUDA tensor")
        if device is not None and t.device != device:
            raise ValueError(f"{name}: operands on several devices")
        device = t.device
    return device


def as_mask(mask: torch.Tensor, dtype) -> torch.Tensor:
    """A boolean mask as the kernel's float mask; a float mask passes as it
    is (``_check_operands`` then holds it to the working dtype)."""
    return (mask.to(dtype) if mask.dtype == torch.bool else mask).contiguous()


def kernel_scalars(device, dtype, d: int, beta, *scalars):
    """``beta`` (d,) and the stacked scalars at the working dtype."""
    beta = torch.as_tensor(beta).to(device=device, dtype=dtype).reshape(d).contiguous()
    scal = torch.stack([torch.as_tensor(v).to(device=device, dtype=dtype).reshape(())
                        for v in scalars])
    return beta, scal


def _launch(prefix: str, beta, sigma2, nugget, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
            nu: float) -> torch.Tensor:
    """Check the operands and launch the C entry points ``{prefix}_{variant}``
    (``sbv_loglik``: the kernel; ``sbv_loglik_panel``: its earlier design,
    kept for side-by-side timings). Per-block (bc,)."""
    dtype = blk_y.dtype
    bc, bs, d = blk_x.shape
    m = nn_x.shape[1]
    if blk_y.shape != (bc, bs) or blk_mask.shape != (bc, bs) or nn_x.shape != (bc, m, d) \
            or nn_y.shape != (bc, m) or nn_mask.shape != (bc, m):
        raise ValueError("sbv_loglik: inconsistent packed shapes")
    if nu not in NU_CODES:
        raise ValueError(f"sbv_loglik: unsupported nu={nu}")
    variant = kernel_variant("sbv_loglik", blk_x.dtype, dtype)
    ops = dict(blk_x=blk_x.contiguous(), nn_x=nn_x.contiguous(), blk_y=blk_y.contiguous(),
               blk_mask=as_mask(blk_mask, dtype), nn_y=nn_y.contiguous(),
               nn_mask=as_mask(nn_mask, dtype))
    device = _check_operands("sbv_loglik", blk_x.dtype, dtype,
                             {k: ops[k] for k in ("blk_x", "nn_x")},
                             {k: ops[k] for k in ("blk_y", "blk_mask", "nn_y", "nn_mask")})
    beta, scal = kernel_scalars(device, dtype, d, beta, sigma2, nugget)
    out = torch.empty(bc, dtype=dtype, device=device)
    if bc == 0:
        return out
    lib = _build.load("sbv_loglik")
    with torch.cuda.device(device):
        grid = _grid(lib, prefix, bc, device, bs, m, d, VARIANT_CODES[variant])
        scratch = torch.empty(grid * lib.sbv_loglik_scratch_per_cta(bs, m), dtype=dtype,
                              device=device)
        fn = getattr(lib, f"{prefix}_{variant}")
        err = fn(beta.data_ptr(), scal.data_ptr(), ops["blk_x"].data_ptr(),
                 ops["blk_y"].data_ptr(), ops["blk_mask"].data_ptr(), ops["nn_x"].data_ptr(),
                 ops["nn_y"].data_ptr(), ops["nn_mask"].data_ptr(), out.data_ptr(),
                 scratch.data_ptr(), bc, bs, m, d, NU_CODES[nu], grid,
                 torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, prefix)
    return out


def sbv_loglik_cuda(beta, sigma2, nugget, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
                    nu: float = 3.5) -> torch.Tensor:
    """Launch the fused likelihood kernel on CUDA tensors. Per-block (bc,).

    The observation dtype (f64 or f32) is the kernel's working dtype;
    coordinates are at that dtype, or bf16 with f32 observations (the
    bf16 variant). Boolean masks and the parameters are converted to the
    working dtype."""
    out = _launch("sbv_loglik", beta, sigma2, nugget, blk_x, blk_y, blk_mask, nn_x, nn_y,
                  nn_mask, nu)
    if out.numel():
        _build.LAUNCHES["sbv_loglik_bf16" if blk_x.dtype == torch.bfloat16
                        else "sbv_loglik"] += 1
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
