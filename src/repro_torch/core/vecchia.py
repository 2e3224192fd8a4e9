"""Block-Vecchia log-likelihood (paper Eq. 2 + Alg. 5) — plain torch version.

Each block contributes the conditional Gaussian log-density
    log p(y_B | y_NN(B))
computed exactly as Alg. 5:
    Sigma_con   = K(NN, NN) + nugget I        (m x m)
    Sigma_cross = K(NN, B)                    (m x bs)
    Sigma_lk    = K(B, B)   + nugget I        (bs x bs)
    L  = chol(Sigma_con);  A = L^-1 Sigma_cross;  z = L^-1 y_NN
    Sigma_new = Sigma_lk - A^T A;  mu = A^T z
    L' = chol(Sigma_new);  v = L'^-1 (y_B - mu)
    ll = -0.5*bs*log(2pi) - sum(log diag L') - 0.5 v^T v

Counterpart of ``repro.core.vecchia``. The reference vmaps a one-block
function; here the block axis is the leading batch dimension of every
tensor. Identity padding (packing.py) makes the fixed-size batch exact for
irregular block/neighbor counts.

This module is the CPU path, the plain version that the fused CUDA kernel
(``repro_torch/kernels/sbv_loglik.py``) is held against, and the backward
pass of that kernel (``kernels/ops.py``).
"""
from __future__ import annotations

import math

import torch

from .kernels_math import KernelParams, cast_params, matern

_LOG2PI = math.log(2.0 * math.pi)


def _masked_cov(xa, xb, mask_a, mask_b, beta, sigma2, nugget, nu, *, identity: bool):
    """Batched covariance (..., na, nb) with masked rows/cols zeroed;
    optionally unit diagonal on padded entries (only valid when xa is xb
    and the masks coincide).

    With ``identity`` a point's distance to itself is exactly 0, as in the
    CUDA kernels; the matmul form below rounds it to ~1e-16, which the
    nu = 0.5 kernel exp(-r) does not forgive (sqrt lifts it to r ~ 1e-8).
    The diagonal is replaced by ``torch.where``, so its gradient is 0 and
    never 0 * inf."""
    za = xa / beta
    zb = xb / beta
    d2 = (
        torch.sum(za * za, dim=-1)[..., :, None]
        + torch.sum(zb * zb, dim=-1)[..., None, :]
        - 2.0 * za @ zb.transpose(-1, -2)
    )
    d2 = torch.clamp(d2, min=0.0)
    if identity:
        diag = torch.eye(xa.shape[-2], dtype=torch.bool, device=d2.device)
        d2 = torch.where(diag, torch.zeros((), dtype=d2.dtype, device=d2.device), d2)
    # The sqrt-at-zero gradient guard must not underflow to 0.0 in the
    # dtype computing (1e-300 does in f32, giving 0 * inf = NaN).
    eps = 1e-300 if d2.dtype == torch.float64 else 1e-30
    r = torch.sqrt(d2 + eps)
    k = sigma2 * matern(r, nu)
    mm = mask_a[..., :, None] & mask_b[..., None, :]
    k = torch.where(mm, k, torch.zeros((), dtype=k.dtype, device=k.device))
    if identity:
        n = xa.shape[-2]
        eye = torch.eye(n, dtype=k.dtype, device=k.device)
        real = mask_a.to(k.dtype)[..., :, None]
        k = k + nugget * real * eye
        k = k + (1.0 - real) * eye  # unit diagonal on pads
    return k


def _cholesky(a: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky that returns NaN for a matrix that is not PD.

    ``jnp.linalg.cholesky`` fills a failed factor with NaN while
    ``torch.linalg.cholesky`` raises; ``cholesky_ex`` plus this mask keeps
    the reference's behaviour (a non-PD block gives a NaN likelihood)."""
    chol, info = torch.linalg.cholesky_ex(a)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full((), float("nan"), dtype=a.dtype, device=a.device), chol)


def _solve_lower(l: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(l, b, upper=False)


def block_loglik(beta, sigma2, nugget, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
                 nu: float = 3.5) -> torch.Tensor:
    """Per-block conditional log-densities, shape (bc,).

    ``beta`` (d,), ``sigma2`` and ``nugget`` are the constrained parameters;
    coordinates (bc, bs, d) / (bc, m, d), observations (bc, bs) / (bc, m),
    masks bool. Everything runs at the dtype of the inputs."""
    blk_mask = blk_mask.bool()
    nn_mask = nn_mask.bool()
    sigma_con = _masked_cov(nn_x, nn_x, nn_mask, nn_mask, beta, sigma2, nugget, nu,
                            identity=True)
    sigma_cross = _masked_cov(nn_x, blk_x, nn_mask, blk_mask, beta, sigma2, nugget, nu,
                              identity=False)
    sigma_lk = _masked_cov(blk_x, blk_x, blk_mask, blk_mask, beta, sigma2, nugget, nu,
                           identity=True)
    zero = torch.zeros((), dtype=blk_y.dtype, device=blk_y.device)
    ynn = torch.where(nn_mask, nn_y, zero)
    yb = torch.where(blk_mask, blk_y, zero)

    chol_con = _cholesky(sigma_con)
    a = _solve_lower(chol_con, sigma_cross)                  # (bc, m, bs)
    z = _solve_lower(chol_con, ynn[..., None])                # (bc, m, 1)

    at = a.transpose(-1, -2)
    sigma_new = sigma_lk - at @ a
    mu = (at @ z)[..., 0]

    chol_new = _cholesky(sigma_new)
    v = _solve_lower(chol_new, (yb - mu)[..., None])[..., 0]

    n_real = blk_mask.sum(dim=-1).to(blk_y.dtype)
    diag = torch.diagonal(chol_new, dim1=-2, dim2=-1)
    logdet = 2.0 * torch.sum(torch.where(blk_mask, torch.log(diag), zero), dim=-1)
    return -0.5 * n_real * _LOG2PI - 0.5 * logdet - 0.5 * torch.sum(v * v, dim=-1)


def batched_block_loglik(params: KernelParams, blk_x, blk_y, blk_mask, nn_x, nn_y,
                         nn_mask, nu: float = 3.5) -> torch.Tensor:
    """Sum of per-block conditional log-densities."""
    return block_loglik(params.beta, params.sigma2, params.nugget,
                        blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask, nu=nu).sum()


def packed_arrays(packed, device) -> tuple:
    """The six likelihood operands of a ``PackedBlocks`` as tensors on
    ``device`` (numpy arrays are copied; tensors are moved if needed)."""
    arrs = (packed.blk_x, packed.blk_y, packed.blk_mask,
            packed.nn_x, packed.nn_y, packed.nn_mask)
    return tuple(torch.as_tensor(a).to(device) for a in arrs)


def packed_loglik(params: KernelParams, packed, nu: float = 3.5,
                  backend: str = "auto", arrays: tuple | None = None) -> torch.Tensor:
    """Log-likelihood of a ``PackedBlocks`` dataset on the params' device.

    ``backend='auto'`` goes through ``kernels.ops.sbv_loglik``, which runs
    the fused CUDA kernel on a CUDA device and this module's plain version
    on the CPU (its backward is the plain version either way).
    ``backend='ref'`` differentiates the plain version directly.
    ``arrays`` passes operands already on the device (``packed_arrays``),
    so a fit moves them once per structure refresh, not once per step.
    """
    device = params.log_beta.device
    if arrays is None:
        arrays = packed_arrays(packed, device)
    if backend == "ref":
        acc = arrays[1].dtype
        return batched_block_loglik(cast_params(params, acc), *arrays, nu=nu)
    if backend == "auto":
        from repro_torch.kernels import ops

        return ops.sbv_loglik(params, *arrays, nu=nu)
    raise ValueError(f"unknown backend {backend!r}")
