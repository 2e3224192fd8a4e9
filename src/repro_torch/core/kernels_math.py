"""Scaled anisotropic Matérn kernels (paper Eq. 5/6), differentiable in torch.

The covariance is

    K_theta(x, x') = sigma^2 * matern_nu(r) + nugget * 1{x == x'},
    r^2 = sum_i ((x_i - x'_i) / beta_i)^2,

with half-integer smoothness nu (all paper experiments use nu = 3.5).
Half-integer Matérn has a closed form exp(-r) * poly(r); scipy's
general-nu Bessel form is kept as a host-only test oracle.

Counterpart of ``repro.core.kernels_math``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SUPPORTED_NU = (0.5, 1.5, 2.5, 3.5)


class KernelParams(NamedTuple):
    """Unconstrained (log-space) kernel parameters: theta of the paper.

    Leaves are torch tensors: ``log_sigma2`` and ``log_nugget`` scalars,
    ``log_beta`` of shape (d,)."""

    log_sigma2: torch.Tensor
    log_beta: torch.Tensor
    log_nugget: torch.Tensor

    @property
    def sigma2(self) -> torch.Tensor:
        return torch.exp(self.log_sigma2)

    @property
    def beta(self) -> torch.Tensor:
        return torch.exp(self.log_beta)

    @property
    def nugget(self) -> torch.Tensor:
        return torch.exp(self.log_nugget)

    @staticmethod
    def create(sigma2=1.0, beta=1.0, nugget=1e-8, d=None, device="cpu",
               dtype=torch.float64) -> "KernelParams":
        beta = np.atleast_1d(np.asarray(beta, dtype=np.float64))
        if d is not None and beta.shape[0] == 1:
            beta = np.full((d,), beta[0])
        t = lambda a: torch.log(torch.as_tensor(a, dtype=torch.float64)).to(
            device=device, dtype=dtype)
        return KernelParams(log_sigma2=t(sigma2), log_beta=t(beta), log_nugget=t(nugget))

    def to(self, device=None, dtype=None) -> "KernelParams":
        return KernelParams(*(a.to(device=device, dtype=dtype) for a in self))


def cast_params(params: KernelParams, dtype) -> KernelParams:
    """Cast the log-space parameters to an accumulation dtype.

    Differentiable (``Tensor.to`` has a gradient), so a reduced-precision
    likelihood still yields full-precision gradients w.r.t. the caller's
    f64 master parameters."""
    return KernelParams(*(a.to(dtype) for a in params))


def matern(r: torch.Tensor, nu: float) -> torch.Tensor:
    """Normalized half-integer Matérn correlation: 2^{1-nu}/Gamma(nu) r^nu K_nu(r).

    Closed forms (nu = p + 1/2):
        nu=0.5: exp(-r)
        nu=1.5: (1 + r) exp(-r)
        nu=2.5: (1 + r + r^2/3) exp(-r)
        nu=3.5: (1 + r + 2 r^2 / 5 + r^3 / 15) exp(-r)
    """
    if nu == 0.5:
        poly = 1.0
    elif nu == 1.5:
        poly = 1.0 + r
    elif nu == 2.5:
        poly = 1.0 + r + r * r / 3.0
    elif nu == 3.5:
        poly = 1.0 + r + 0.4 * (r * r) + (r * r * r) / 15.0
    else:
        raise ValueError(f"nu={nu} not in supported half-integer set {SUPPORTED_NU}")
    return poly * torch.exp(-r)


def scaled_sqdist(x1: torch.Tensor, x2: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Pairwise squared scaled distance. x1 (..., n1, d), x2 (..., n2, d) -> (..., n1, n2)."""
    z1 = x1 / beta
    z2 = x2 / beta
    d2 = (
        torch.sum(z1 * z1, dim=-1)[..., :, None]
        + torch.sum(z2 * z2, dim=-1)[..., None, :]
        - 2.0 * z1 @ z2.transpose(-1, -2)
    )
    return torch.clamp(d2, min=0.0)


def cov_matrix(
    x1: torch.Tensor,
    x2: torch.Tensor,
    params: KernelParams,
    nu: float = 3.5,
    add_nugget: bool = False,
) -> torch.Tensor:
    """Scaled Matérn covariance between two point sets (paper Eq. 5/6).

    ``add_nugget`` adds nugget * I and must only be used when x1 is x2.
    """
    d2 = scaled_sqdist(x1, x2, params.beta)
    # sqrt is non-differentiable at 0; the tiny floor keeps intermediate
    # gradients finite (d d2 / d params == 0 on the diagonal).
    r = torch.sqrt(d2 + 1e-300)
    k = params.sigma2 * matern(r, nu)
    if add_nugget:
        n = x1.shape[-2]
        k = k + params.nugget * torch.eye(n, dtype=k.dtype, device=k.device)
    return k


def matern_scipy_oracle(r, nu):
    """General-nu Matérn via scipy Bessel K (host-only test oracle)."""
    from scipy.special import gamma, kv

    r = np.asarray(r, dtype=np.float64)
    with np.errstate(invalid="ignore"):
        out = np.where(
            r == 0.0,
            1.0,
            2.0 ** (1.0 - nu) / gamma(nu) * np.power(r, nu) * kv(nu, r),
        )
    return out
