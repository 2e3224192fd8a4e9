"""Exact dense GP (paper Eq. 1 and §4.1), the oracle for the SBV path.

Counterpart of ``repro.core.exact_gp``. O(n^3); for tests and small checks.
"""
from __future__ import annotations

import math

import torch

from .kernels_math import KernelParams, cov_matrix
from .vecchia import _solve_lower

_LOG2PI = math.log(2.0 * math.pi)


def exact_loglik(params: KernelParams, x: torch.Tensor, y: torch.Tensor,
                 nu: float = 3.5) -> torch.Tensor:
    """Dense GP log-likelihood (paper Eq. 1)."""
    n = x.shape[0]
    k = cov_matrix(x, x, params, nu=nu, add_nugget=True)
    chol = torch.linalg.cholesky(k)
    alpha = _solve_lower(chol, y[:, None])[:, 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    return -0.5 * n * _LOG2PI - 0.5 * logdet - 0.5 * torch.dot(alpha, alpha)


def exact_predict(params: KernelParams, x_train: torch.Tensor, y_train: torch.Tensor,
                  x_test: torch.Tensor, nu: float = 3.5):
    """Conditional mean and marginal variance at test points."""
    k_tt = cov_matrix(x_train, x_train, params, nu=nu, add_nugget=True)
    k_ts = cov_matrix(x_train, x_test, params, nu=nu)
    chol = torch.linalg.cholesky(k_tt)
    a = _solve_lower(chol, k_ts)
    z = _solve_lower(chol, y_train[:, None])[:, 0]
    mean = a.T @ z
    var = (params.sigma2 + params.nugget) - torch.sum(a * a, dim=0)
    return mean, torch.clamp(var, min=1e-12)
