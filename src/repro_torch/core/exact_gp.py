"""Exact dense GP (paper Eq. 1 and §4.1), the oracle for the SBV path and the
exact half of the KL divergence (paper Eq. 4, ``core/kl.py``).

Counterpart of ``repro.core.exact_gp``. O(n^3). Each function runs on
``device`` (the current CUDA device when not given; without one it raises
unless ``device="cpu"``).

``backend="auto"`` assembles the covariance on a CUDA device with the
batched covariance kernel (``kernels.ops.matern_cov`` at B = 1; the
reference assembles it with plain jnp), and on the CPU with
``kernels_math.cov_matrix``; ``backend="ref"`` takes ``cov_matrix`` on
either. The kernel is not differentiable, so the kernel route refuses
parameters that require grad. The Cholesky factor and the triangular
solves are library calls, as the reference leaves them to XLA.

The two routes differ in the floor under the square root: 1e-30 in the
kernel, 1e-300 in ``cov_matrix`` (the reference's). At a zero distance that
moves the nu = 0.5 diagonal by 1e-15 relative (exp(-1e-15)) and, at
nu >= 1.5, by nothing a double can hold (the change is O(r^2) = 1e-30).
At nu = 0.5 the larger difference is ROADMAP fault 1: ``cov_matrix``'s
matmul form leaves a point's distance to itself at ~1e-16, not 0, which
moves its diagonal by up to ~3e-8.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device

from .kernels_math import KernelParams, cov_matrix
from .vecchia import _solve_lower

_LOG2PI = math.log(2.0 * math.pi)


def _prepare(params: KernelParams, device, backend: str, *arrays):
    """Whether the kernel route is taken, the params on the resolved device,
    and each array as a tensor there (numpy arrays are copied). The kernel
    route refuses parameters that require grad before anything moves."""
    if backend not in ("auto", "ref"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device)
    kernel = backend == "auto" and dev.type == "cuda"
    if kernel and any(t.requires_grad for t in params):
        raise RuntimeError("exact GP: the covariance kernel is not differentiable; detach the "
                           "parameters, or pass backend='ref' to differentiate")
    return (kernel, params.to(device=dev)) + tuple(torch.as_tensor(a).to(dev) for a in arrays)


def _cov(x1, x2, params: KernelParams, nu: float, kernel: bool, nugget: bool = False):
    """K(x1, x2), plus the nugget on the diagonal when ``nugget`` (x1 is x2)."""
    if not kernel:
        return cov_matrix(x1, x2, params, nu=nu, add_nugget=nugget)
    from repro_torch.kernels import ops

    k = ops.matern_cov(x1[None], x2[None], params, nu=nu)[0]
    if nugget:
        k.diagonal().add_(params.nugget.to(k.dtype))
    return k


def _factor(k: torch.Tensor):
    """Lower Cholesky factor and whether it succeeded. A failed factor
    makes the results NaN, as ``jnp.linalg.cholesky`` does in the
    reference (``torch.linalg.cholesky`` would raise)."""
    chol, info = torch.linalg.cholesky_ex(k)
    return chol, info == 0


def _nan_unless(ok: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, value, torch.full((), float("nan"), dtype=value.dtype,
                                             device=value.device))


def exact_loglik(params: KernelParams, x, y, nu: float = 3.5, device=None,
                 backend: str = "auto") -> torch.Tensor:
    """Dense GP log-likelihood (paper Eq. 1)."""
    kernel, params, x, y = _prepare(params, device, backend, x, y)
    n = x.shape[0]
    chol, ok = _factor(_cov(x, x, params, nu, kernel, nugget=True))
    alpha = _solve_lower(chol, y[:, None])[:, 0]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    return _nan_unless(ok, -0.5 * n * _LOG2PI - 0.5 * logdet - 0.5 * torch.dot(alpha, alpha))


def exact_logdet(params: KernelParams, x, nu: float = 3.5, device=None,
                 backend: str = "auto") -> torch.Tensor:
    """log det(K + nugget I)."""
    kernel, params, x = _prepare(params, device, backend, x)
    chol, ok = _factor(_cov(x, x, params, nu, kernel, nugget=True))
    return _nan_unless(ok, 2.0 * torch.sum(torch.log(torch.diagonal(chol))))


def exact_predict(params: KernelParams, x_train, y_train, x_test, nu: float = 3.5, device=None,
                  backend: str = "auto"):
    """Conditional mean and marginal variance at test points (paper §4.1)."""
    kernel, params, x_train, y_train, x_test = _prepare(params, device, backend, x_train,
                                                        y_train, x_test)
    k_tt = _cov(x_train, x_train, params, nu, kernel, nugget=True)
    k_ts = _cov(x_train, x_test, params, nu, kernel)
    chol, ok = _factor(k_tt)
    a = _solve_lower(chol, k_ts)
    z = _solve_lower(chol, y_train[:, None])[:, 0]
    mean = a.T @ z
    var = (params.sigma2 + params.nugget) - torch.sum(a * a, dim=0)
    return _nan_unless(ok, mean), _nan_unless(ok, torch.clamp(var, min=1e-12))
