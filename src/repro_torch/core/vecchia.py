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
from torch.utils.checkpoint import checkpoint

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


def block_multi_stats(beta, sigma2, nugget, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
                      nu: float = 3.5):
    """Per-block ``(logdet0 (bc,), q0 (bc, p))`` from one Cholesky each.

    The joint-assembly form (the reference's ``_block_multi_stats_one``,
    and with p = 1 its ``_block_loglik_joint_one``): the (m + bs)
    covariance of [NN; B] is factored once and the masked (m + bs, p)
    observations go through one triangular solve; with L = [[L11, 0],
    [L21, L22]], Sigma_new = L22 L22^T and L22^-1 (y_B - mu) is the tail of
    L^-1 [y_NN; y_B]. With ``sigma2 = 1, nugget = tau2`` these are the
    multi-output unit-variance stats. A block that is not positive
    definite gives NaN, as in the reference."""
    blk_mask = blk_mask.bool()
    nn_mask = nn_mask.bool()
    m = nn_x.shape[-2]
    x = torch.cat([nn_x, blk_x], dim=-2)
    mask = torch.cat([nn_mask, blk_mask], dim=-1)
    zero = torch.zeros((), dtype=blk_y.dtype, device=blk_y.device)
    yv = torch.cat([torch.where(nn_mask[..., None], nn_y, zero),
                    torch.where(blk_mask[..., None], blk_y, zero)], dim=-2)
    sigma = _masked_cov(x, x, mask, mask, beta, sigma2, nugget, nu, identity=True)
    chol = _cholesky(sigma)
    vb = _solve_lower(chol, yv)[..., m:, :]
    diag = torch.diagonal(chol, dim1=-2, dim2=-1)[..., m:]
    logdet0 = 2.0 * torch.sum(torch.where(blk_mask, torch.log(diag), zero), dim=-1)
    return logdet0, torch.sum(vb * vb, dim=-2)


def block_loglik_joint(beta, sigma2, nugget, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
                       nu: float = 3.5) -> torch.Tensor:
    """Per-block log-densities (bc,) in the joint-assembly form: the same
    value as ``block_loglik`` from one factorization instead of the chain
    chol -> solve -> Schur -> chol."""
    logdet, q = block_multi_stats(beta, sigma2, nugget, blk_x, blk_y[..., None], blk_mask, nn_x,
                                  nn_y[..., None], nn_mask, nu=nu)
    n_real = blk_mask.bool().sum(dim=-1).to(blk_y.dtype)
    return -0.5 * n_real * _LOG2PI - 0.5 * logdet - 0.5 * q[..., 0]


def batched_block_loglik_joint(params: KernelParams, blk_x, blk_y, blk_mask, nn_x, nn_y,
                               nn_mask, nu: float = 3.5) -> torch.Tensor:
    """Joint-assembly batched likelihood (same value as
    ``batched_block_loglik``)."""
    return block_loglik_joint(params.beta, params.sigma2, params.nugget, blk_x, blk_y,
                              blk_mask, nn_x, nn_y, nn_mask, nu=nu).sum()


# Blocks per checkpointed slice of the remat forms (the reference's
# ``lax.map`` batch, ``_MAP_BATCH`` in repro.core.fit).
MAP_BATCH = 16


def checkpointed_blocks(per_block_fn, arrays, batch: int = MAP_BATCH):
    """``per_block_fn(*arrays)`` over slices of ``batch`` blocks, each under
    ``torch.utils.checkpoint``: the backward recomputes one slice at a time
    from its inputs, so the live set is a few ``batch x (bs+m)^2`` buffers
    however many blocks there are. Returns the per-block outputs
    concatenated (a tuple of them when ``per_block_fn`` returns a tuple)."""
    bc = arrays[0].shape[0]
    parts = [checkpoint(per_block_fn, *(a[s:s + batch] for a in arrays), use_reentrant=False)
             for s in range(0, bc, batch)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(cols) for cols in zip(*parts))
    return torch.cat(parts)


def batched_block_loglik_joint_remat(params: KernelParams, blk_x, blk_y, blk_mask, nn_x, nn_y,
                                     nn_mask, nu: float = 3.5,
                                     batch: int = MAP_BATCH) -> torch.Tensor:
    """Joint assembly with a checkpointed body (the reference's
    ``batched_block_loglik_joint_remat`` under ``lax.map(batch_size=16)``):
    the streaming ``ref`` route's likelihood of one spooled piece."""
    beta, sigma2, nugget = params.beta, params.sigma2, params.nugget
    per_block = checkpointed_blocks(
        lambda *a: block_loglik_joint(beta, sigma2, nugget, *a, nu=nu),
        (blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask), batch)
    return per_block.sum()


# -- the bf16-assembly tier (the Pallas kernels' narrow form) ---------------
#
# With bf16 coordinates the reference's kernels scale the coordinates at
# storage width, z = bf16(x / bf16(beta)), widen z to f32 and assemble,
# factor and solve in f32, clamping every Cholesky pivot at
# eps(bf16) * sigma2 (src/repro/kernels/sbv_loglik.py: _sbv_kernel,
# _masked_cov_tile, _cholesky_inplace). The functions below are that body in
# plain torch: the CPU path of the kernel route and the yardstick of the
# CUDA kernels' bf16 variants. Like the kernels they factor the joint
# covariance of [neighbours; block] once, with the observations as extra
# rows; its pivots are those of the Pallas chain chol -> solve -> Schur ->
# chol. Forward only: the gradient of every tier is the f64 plain version
# (kernels/ops.py).

BF16_EPS = 2.0 ** -7  # finfo(bfloat16).eps


def narrow_scaled(x: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """bf16 coordinates scaled at storage width and widened: f32
    ``bf16(x / bf16(beta))`` (the division is done in f32 and rounded once
    to bf16, which is the correctly rounded bf16 quotient)."""
    return (x / beta.to(x.dtype)).float()


def narrow_joint(beta, sigma2, nugget, x0, m0, x1, m1, nu: float) -> torch.Tensor:
    """The f32 joint covariance (..., P, P) of the bf16 point sets
    [x0; x1] (P = n0 + n1), masked, with the nugget and unit padding on the
    diagonal. A point's distance to itself is exactly 0, as in the kernels."""
    z = narrow_scaled(torch.cat([x0, x1], dim=-2), beta)
    mask = torch.cat([m0, m1], dim=-1).float()
    nrm = torch.sum(z * z, dim=-1)
    d2 = nrm[..., :, None] + nrm[..., None, :] - 2.0 * z @ z.transpose(-1, -2)
    eye = torch.eye(z.shape[-2], dtype=torch.bool, device=z.device)
    d2 = torch.where(eye, torch.zeros((), dtype=d2.dtype, device=d2.device),
                     torch.clamp(d2, min=0.0))
    k = sigma2 * matern(torch.sqrt(d2 + 1e-30), nu) * (mask[..., :, None] * mask[..., None, :])
    return k + torch.diag_embed(nugget * mask + (1.0 - mask))


# The GP kernels' panel width (csrc/sbv_common.cuh: kTileNB).
TILE_PANEL = 32


def tiled_cholesky_(at: torch.Tensor, ncols: int, floor, panel: int = TILE_PANEL) -> torch.Tensor:
    """In-place left-looking blocked Cholesky of the first ``ncols``
    columns of A, stored transposed: ``at`` is (..., C, N) with
    ``at[..., j, i] = A[i, j]`` (column j contiguous), in the order of the
    GP kernels' ``tiled_cholesky`` (csrc/sbv_common.cuh): each panel of
    ``panel`` columns is formed once from the original columns minus the
    finished factor's product, its diagonal tile is factored column by
    column (every pivot clamped at ``floor`` before its square root), and
    every row below the tile is solved against it with the tile's inverse
    diagonal. Rows of A below ``ncols`` ride along as extra right-hand
    sides (the forward solve). Returns ``at``, whose lower part (i >= j)
    holds the factor."""
    for j0 in range(0, ncols, panel):
        j1 = min(ncols, j0 + panel)
        if j0:
            at[..., j0:j1, j0:] -= at[..., :j0, j0:j1].transpose(-1, -2) @ at[..., :j0, j0:]
        for c in range(j0, j1):
            piv = torch.sqrt(torch.maximum(at[..., c, c], floor))
            at[..., c, c] = piv
            at[..., c, c + 1:j1] /= piv[..., None]
            if c + 1 < j1:
                at[..., c + 1:j1, c + 1:j1] -= (at[..., c, c + 1:j1, None]
                                                * at[..., c, None, c + 1:j1])
        for c in range(j0, j1):
            if c > j0:
                at[..., c, j1:] -= (at[..., j0:c, j1:] * at[..., j0:c, c, None]).sum(dim=-2)
            at[..., c, j1:] *= (1.0 / at[..., c, c])[..., None]
    return at


def narrow_factor(beta, sigma2, nugget, x0, m0, y0, x1, m1, y1, nu: float,
                  ncols: int | None = None) -> torch.Tensor:
    """The factored joint panel of one bf16 tier call: the joint
    covariance of [x0; x1] with the masked observation columns y0, y1
    (..., n, r) appended as r extra rows of A, factored over its first
    ``ncols`` columns (all P by default) with the bf16 pivot floor, in the
    GP kernels' order (``tiled_cholesky_``). Returns ``at``
    (..., ncols, P + r), transposed as in ``tiled_cholesky_``."""
    k = narrow_joint(beta, sigma2, nugget, x0, m0, x1, m1, nu)
    ncols = k.shape[-1] if ncols is None else ncols
    y = torch.cat([y0 * m0.float()[..., None], y1 * m1.float()[..., None]], dim=-2)
    # k is symmetric, so its row j is column j of A; y's row j holds A's
    # observation rows at column j.
    at = torch.cat([k, y], dim=-1)[..., :ncols, :]
    return tiled_cholesky_(at, ncols, sigma2 * BF16_EPS)


def block_loglik_narrow(beta, sigma2, nugget, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
                        nu: float = 3.5) -> torch.Tensor:
    """Per-block log-densities (bc,) on the bf16-assembly tier: bf16
    coordinates, f32 observations, masks and parameters."""
    m = nn_x.shape[-2]
    at = narrow_factor(beta, sigma2, nugget, nn_x, nn_mask.bool(), nn_y[..., None],
                       blk_x, blk_mask.bool(), blk_y[..., None], nu)
    p = at.shape[-2]
    mb = blk_mask.float()
    diag = torch.diagonal(at, dim1=-2, dim2=-1)[..., m:]
    logdet = 2.0 * torch.sum(torch.log(torch.clamp(diag, min=1e-30)) * mb, dim=-1)
    v = at[..., m:, p]
    return -0.5 * mb.sum(dim=-1) * _LOG2PI - 0.5 * logdet - 0.5 * torch.sum(v * v, dim=-1)


def batched_block_loglik(params: KernelParams, blk_x, blk_y, blk_mask, nn_x, nn_y,
                         nn_mask, nu: float = 3.5) -> torch.Tensor:
    """Sum of per-block conditional log-densities."""
    return block_loglik(params.beta, params.sigma2, params.nugget,
                        blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask, nu=nu).sum()


def packed_arrays(packed, device):
    """The six likelihood operands of a ``PackedBlocks`` as tensors on
    ``device`` (numpy arrays are copied; tensors are moved if needed); for
    a ``BucketedBlocks``, a list with one such tuple per bucket."""
    if hasattr(packed, "buckets"):
        return [packed_arrays(pk, device) for pk in packed.buckets]
    arrs = (packed.blk_x, packed.blk_y, packed.blk_mask,
            packed.nn_x, packed.nn_y, packed.nn_mask)
    return tuple(torch.as_tensor(a).to(device) for a in arrs)


def packed_loglik(params: KernelParams, packed, nu: float = 3.5,
                  backend: str = "auto", arrays=None) -> torch.Tensor:
    """Log-likelihood of a ``PackedBlocks`` or ``BucketedBlocks`` dataset on
    the params' device.

    ``backend='auto'`` goes through ``kernels.ops.sbv_loglik``, which runs
    the fused CUDA kernel on a CUDA device and its plain version on the CPU
    (its backward is the plain version either way), for every bucket shape
    and tier. ``backend='ref'`` differentiates the plain
    version directly, at the packed observations' dtype. The coordinate
    dtype selects the precision tier (bf16 coordinates: the bf16-assembly
    tier). ``arrays`` passes operands already on the device
    (``packed_arrays``), so a fit moves them once per structure refresh,
    not once per step.
    """
    if hasattr(packed, "buckets"):
        return bucketed_loglik(params, packed, nu=nu, backend=backend, arrays=arrays)
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


def bucketed_loglik(params: KernelParams, bucketed, nu: float = 3.5, backend: str = "auto",
                    arrays=None) -> torch.Tensor:
    """Sum of the per-bucket packed log-likelihoods (one kernel launch per
    bucket). Identity padding makes it equal to the uniform layout's.
    Differentiable: gradients flow through each bucket independently."""
    if arrays is None:
        arrays = packed_arrays(bucketed, params.log_beta.device)
    total = None
    for pk, arrs in zip(bucketed.buckets, arrays):
        ll = packed_loglik(params, pk, nu=nu, backend=backend, arrays=arrs)
        total = ll if total is None else total + ll
    return total
