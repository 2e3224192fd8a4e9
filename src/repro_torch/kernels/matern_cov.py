"""Batched scaled-Matérn covariance: the CUDA kernel and its plain version.

``matern_cov_blocks`` is the counterpart of ``matern_cov_pallas``
(src/repro/kernels/matern_cov.py): xa (B, na, d), xb (B, nb, d) ->
(B, na, nb), ``sigma2 * matern_nu(r)`` with the floor
``r = sqrt(max(d2, 0) + 1e-30)`` of that kernel. On CUDA tensors it
launches ``csrc/matern_cov.cu``; on CPU tensors it runs the plain version,
the counterpart of ``repro.kernels.ref.matern_cov_ref``. bf16 coordinates
(the precision ladder's bf16-assembly tier) give an f32 output, as in the
reference: z = bf16(x / bf16(beta)) widened to f32, everything after in f32.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels_math import matern, scaled_sqdist
from repro_torch.core.vecchia import narrow_scaled

from . import _build
from .sbv_loglik import NU_CODES, _check_operands, kernel_variant, ladder_dtypes


def matern_cov_plain(xa, xb, beta, sigma2, nu: float = 3.5) -> torch.Tensor:
    """The plain torch version of the kernel: (B, na, nb)."""
    _, dtype = ladder_dtypes(xa.dtype)
    beta = torch.as_tensor(beta).to(dtype)
    if xa.dtype == torch.bfloat16:
        za, zb = narrow_scaled(xa, beta), narrow_scaled(xb, beta)
        d2 = torch.clamp(torch.sum(za * za, dim=-1)[..., :, None]
                         + torch.sum(zb * zb, dim=-1)[..., None, :]
                         - 2.0 * za @ zb.transpose(-1, -2), min=0.0)
    else:
        d2 = scaled_sqdist(xa, xb, beta)
    return torch.as_tensor(sigma2).to(dtype) * matern(torch.sqrt(d2 + 1e-30), nu)


def _launch(prefix: str, xa, xb, beta, sigma2, nu: float) -> torch.Tensor:
    """Check the operands and launch the C entry points ``{prefix}_{variant}``
    (``matern_cov``: the kernel; ``matern_cov_rowwise``: its earlier design,
    kept for side-by-side timings). (B, na, nb)."""
    if xa.dim() != 3 or xb.dim() != 3 or xa.shape[0] != xb.shape[0] \
            or xa.shape[2] != xb.shape[2]:
        raise ValueError("matern_cov: expected xa (B, na, d) and xb (B, nb, d)")
    if nu not in NU_CODES:
        raise ValueError(f"matern_cov: unsupported nu={nu}")
    _, dtype = ladder_dtypes(xa.dtype)
    variant = kernel_variant("matern_cov", xa.dtype, dtype)
    b, na, d = xa.shape
    nb = xb.shape[1]
    # The kernel stages whole 4-byte words, so each coordinate tensor starts
    # on one (a bf16 view may not).
    ops = {}
    for key, t in (("xa", xa), ("xb", xb)):
        t = t.contiguous()
        ops[key] = t if t.data_ptr() % 4 == 0 else t.clone()
    device = _check_operands("matern_cov", xa.dtype, dtype, ops, {})
    beta = torch.as_tensor(beta).to(device=device, dtype=dtype).reshape(d).contiguous()
    scal = torch.as_tensor(sigma2).to(device=device, dtype=dtype).reshape(1).contiguous()
    out = torch.empty(b, na, nb, dtype=dtype, device=device)
    if out.numel() == 0:
        return out
    lib = _build.load("matern_cov")
    fn = getattr(lib, f"{prefix}_{variant}")
    with torch.cuda.device(device):
        err = fn(ops["xa"].data_ptr(), ops["xb"].data_ptr(), beta.data_ptr(), scal.data_ptr(),
                 out.data_ptr(), b, na, nb, d, NU_CODES[nu],
                 torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, prefix)
    return out


def matern_cov_cuda(xa, xb, beta, sigma2, nu: float = 3.5) -> torch.Tensor:
    """Launch the covariance kernel on CUDA tensors: (B, na, nb) at the
    coordinates' dtype, or f32 for bf16 coordinates (the bf16 variant)."""
    out = _launch("matern_cov", xa, xb, beta, sigma2, nu)
    if out.numel():
        _build.LAUNCHES["matern_cov_bf16" if xa.dtype == torch.bfloat16 else "matern_cov"] += 1
    return out


def matern_cov_blocks(xa, xb, beta, sigma2, nu: float = 3.5) -> torch.Tensor:
    """(B, na, nb) covariance: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if xa.is_cuda:
        return matern_cov_cuda(xa, xb, beta, sigma2, nu=nu)
    return matern_cov_plain(xa, xb, beta, sigma2, nu=nu)
