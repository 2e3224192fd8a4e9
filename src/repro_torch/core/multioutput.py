"""Multi-output SBV: one structure, batched per-output likelihoods (VPPE).

Counterpart of ``repro.core.multioutput``. All p outputs share ONE input
scaling beta and ONE block/neighbour structure and differ only in their
marginal variance:

    K_j = sigma2_j * ( R(beta) + tau2 * I )        for output j,

a shared unit-variance correlation R with a shared RELATIVE nugget tau2.
Every per-block conditional then factors through the SAME Cholesky of the
unit-variance joint covariance:

    logdet_j = bs * log(sigma2_j) + logdet0,     q_j = q0_j / sigma2_j,

with q0_j from one (m + bs, p)-right-hand-side solve. The per-output scales
are profiled in closed form (sigma2_j = Q_j / n), leaving a pooled profile
likelihood over (log_beta, log_tau2):

    2 * nll(beta, tau2) = p*n*log(2 pi) + p*logdet0 + n * sum_j log(Q_j / n) + n*p.

``block_multi_stats`` is the CPU path, the plain version the fused CUDA
kernel (``kernels/sbv_multi_stats.py``) is held against, and that kernel's
backward pass (``kernels/ops.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device

from .kernels_math import KernelParams, cast_params
from .vecchia import _LOG2PI, _cholesky, _masked_cov, _solve_lower, narrow_factor, packed_arrays


class MultiOutputParams(NamedTuple):
    """Shared-structure multi-output kernel parameters (log scale).

    ``log_sigma2`` is (p,), one marginal variance per output; ``log_beta``
    the shared (d,) input scaling; ``log_tau2`` the shared relative nugget
    (nugget_j = tau2 * sigma2_j)."""

    log_sigma2: torch.Tensor  # (p,)
    log_beta: torch.Tensor    # (d,)
    log_tau2: torch.Tensor    # scalar

    @property
    def sigma2(self) -> torch.Tensor:
        return torch.exp(self.log_sigma2)

    @property
    def beta(self) -> torch.Tensor:
        return torch.exp(self.log_beta)

    @property
    def tau2(self) -> torch.Tensor:
        return torch.exp(self.log_tau2)

    @property
    def nugget(self) -> torch.Tensor:
        return torch.exp(self.log_tau2 + self.log_sigma2)  # (p,) absolute

    @property
    def n_outputs(self) -> int:
        return int(self.log_sigma2.shape[0])

    @staticmethod
    def create(sigma2, beta, tau2, d: int, p: int, device="cpu",
               dtype=torch.float64) -> "MultiOutputParams":
        t = lambda a, shape: torch.log(torch.as_tensor(
            np.broadcast_to(np.asarray(a, dtype=np.float64), shape).copy())).to(
                device=device, dtype=dtype)
        return MultiOutputParams(log_sigma2=t(sigma2, (p,)), log_beta=t(beta, (d,)),
                                 log_tau2=t(tau2, ()))

    def to(self, device=None, dtype=None) -> "MultiOutputParams":
        return MultiOutputParams(*(a.to(device=device, dtype=dtype) for a in self))

    def output_params(self, j: int) -> KernelParams:
        """The equivalent single-output ``KernelParams`` for output j."""
        return KernelParams(log_sigma2=self.log_sigma2[j], log_beta=self.log_beta,
                            log_nugget=self.log_tau2 + self.log_sigma2[j])

    def structure_params(self) -> KernelParams:
        """Unit-variance correlation params: sigma2 = 1, nugget = tau2. All
        shared-Cholesky math runs on these; the per-output sigma2 re-enter
        as closed-form scalings."""
        return KernelParams(
            log_sigma2=torch.zeros((), dtype=self.log_beta.dtype, device=self.log_beta.device),
            log_beta=self.log_beta, log_nugget=self.log_tau2)


def as_multi_params(params, p: int, d: int) -> MultiOutputParams:
    """Coerce a KernelParams (broadcast over outputs) or pass through."""
    if isinstance(params, MultiOutputParams):
        return params
    if isinstance(params, KernelParams):
        return MultiOutputParams(log_sigma2=torch.log(params.sigma2.expand(p)),
                                 log_beta=torch.log(params.beta.expand(d)),
                                 log_tau2=torch.log(params.nugget / params.sigma2))
    raise TypeError(f"cannot coerce {type(params).__name__} to MultiOutputParams")


def block_multi_stats(beta, sigma2, nugget, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
                      nu: float = 3.5):
    """Per-block ``(logdet0 (bc,), q0 (bc, p))`` from one Cholesky each.

    The counterpart of the reference's vmapped ``_block_multi_stats_one``:
    the joint (m + bs) covariance of [NN; B] is factored once and the
    masked (m + bs, p) observations go through one triangular solve. With
    ``sigma2 = 1, nugget = tau2`` these are the unit-variance stats. A
    block that is not positive definite gives NaN, as in the reference."""
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


def block_multi_stats_narrow(beta, sigma2, nugget, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
                             nu: float = 3.5):
    """Per-block ``(logdet0 (bc,), q0 (bc, p))`` on the bf16-assembly tier:
    bf16 coordinates, f32 observations (bc, ., p), masks and parameters;
    the Pallas multi-stats body with its pivot floor (see
    ``vecchia.narrow_factor``)."""
    m = nn_x.shape[-2]
    at = narrow_factor(beta, sigma2, nugget, nn_x, nn_mask.bool(), nn_y, blk_x, blk_mask.bool(),
                       blk_y, nu)
    n = at.shape[-2]
    diag = torch.diagonal(at, dim1=-2, dim2=-1)[..., m:]
    logdet0 = 2.0 * torch.sum(torch.log(torch.clamp(diag, min=1e-30)) * blk_mask.float(), dim=-1)
    vb = at[..., m:, n:]
    return logdet0, torch.sum(vb * vb, dim=-2)


def _cast_multi(params: MultiOutputParams, dtype) -> MultiOutputParams:
    """Differentiable down-cast (precision ladder), like ``cast_params``."""
    return MultiOutputParams(*(a.to(dtype) for a in params))


def packed_multi_stats(params: MultiOutputParams, packed, nu: float = 3.5,
                       backend: str = "auto", arrays=None):
    """Dataset totals ``(logdet0, q0 (p,))`` of a ``PackedBlocks`` or
    ``BucketedBlocks`` with (., ., p) observations, on the params' device.

    Dispatch as ``vecchia.packed_loglik``: ``'auto'`` goes through
    ``kernels.ops.sbv_multi_stats`` (the fused CUDA kernel on a CUDA
    device, the plain version on the CPU); ``'ref'`` differentiates the
    plain version directly. A bucketed layout sums its per-bucket stats.
    ``arrays`` passes operands already on the device (``packed_arrays``)."""
    if hasattr(packed, "buckets"):
        if arrays is None:
            arrays = packed_arrays(packed, params.log_beta.device)
        ld = q = None
        for pk, arrs in zip(packed.buckets, arrays):
            ld_b, q_b = packed_multi_stats(params, pk, nu=nu, backend=backend, arrays=arrs)
            ld = ld_b if ld is None else ld + ld_b
            q = q_b if q is None else q + q_b
        return ld, q
    if arrays is None:
        arrays = packed_arrays(packed, params.log_beta.device)
    p0 = params.structure_params()
    if backend == "ref":
        p0 = cast_params(p0, arrays[1].dtype)
        ld, q = block_multi_stats(p0.beta, p0.sigma2, p0.nugget, *arrays, nu=nu)
        return ld.sum(), q.sum(dim=0)
    if backend == "auto":
        from repro_torch.kernels import ops

        return ops.sbv_multi_stats(p0, *arrays, nu=nu)
    raise ValueError(f"unknown backend {backend!r}")


def multi_loglik(params: MultiOutputParams, packed, nu: float = 3.5,
                 backend: str = "auto") -> torch.Tensor:
    """Per-output log-likelihood vector (p,) from the shared stats."""
    logdet0, q0 = packed_multi_stats(params, packed, nu=nu, backend=backend)
    n = packed.n_points
    s2 = params.sigma2.to(q0.dtype)
    return -0.5 * n * _LOG2PI - 0.5 * logdet0 - 0.5 * n * torch.log(s2) - 0.5 * q0 / s2


def profile_sigma2(q0: torch.Tensor, n: int) -> torch.Tensor:
    """Closed-form per-output MLE scale given unit-variance quadratics."""
    return q0 / n


def pooled_objective(logdet0, q0, n: int):
    """Pooled profile nll per data point: what the multi fit minimizes over
    (log_beta, log_tau2); sigma2 is profiled out."""
    p = q0.shape[0]
    nll2 = p * n * _LOG2PI + p * logdet0 + n * torch.sum(torch.log(q0 / n)) + n * p
    return 0.5 * nll2 / (n * p)


def multi_profile_neg_loglik_fn(packed, nu: float, backend: str, device=None):
    """``loss(params)`` for the monolithic multi fit, with the packed
    operands moved to the device once."""
    n = packed.n_points
    arrays = packed_arrays(packed, resolve_device(device))

    def f(params: MultiOutputParams):
        logdet0, q0 = packed_multi_stats(params, packed, nu=nu, backend=backend, arrays=arrays)
        return pooled_objective(logdet0, q0, n)

    return f


def with_profiled_sigma2(params: MultiOutputParams, packed, nu: float = 3.5,
                         backend: str = "auto") -> MultiOutputParams:
    """Params with sigma2_j set to the closed-form profile MLE."""
    with torch.no_grad():
        _, q0 = packed_multi_stats(params, packed, nu=nu, backend=backend)
        s2 = torch.clamp(profile_sigma2(q0.to(torch.float64), packed.n_points), min=1e-300)
    return params._replace(log_sigma2=torch.log(s2).to(params.log_sigma2.dtype))
