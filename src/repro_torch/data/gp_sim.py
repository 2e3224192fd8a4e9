"""Synthetic anisotropic GP draws of the paper's §6.1 experiments.

Counterpart of the synthetic part of ``repro.data.gp_sim``, numpy-seeded
the same way: exact Cholesky draws for small n, random-Fourier-feature
(RFF) draws for large n. The Matérn spectral density is a multivariate
Student-t with 2*nu dof, so RFF frequencies are z / sqrt(g),
z ~ N(0, I_d), g ~ Gamma(nu, 1/nu), scaled dimension-wise by 1/beta.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kernels_math import KernelParams, cov_matrix


def sample_gp_exact(seed: int, x: np.ndarray, params: KernelParams, nu: float = 3.5) -> np.ndarray:
    """Exact zero-mean GP draw via dense Cholesky (on the host, f64). O(n^3); n <= ~5000."""
    n = x.shape[0]
    xt = torch.as_tensor(np.asarray(x, dtype=np.float64))
    p = params.to(device="cpu", dtype=torch.float64)
    k = cov_matrix(xt, xt, p, nu=nu, add_nugget=True).numpy()
    chol = np.linalg.cholesky(k + 1e-10 * np.eye(n))
    rng = np.random.default_rng(seed)
    return chol @ rng.standard_normal(n)


def sample_gp_rff(
    seed: int, x: np.ndarray, params: KernelParams, nu: float = 3.5, n_features: int = 4096
) -> np.ndarray:
    """Approximate GP draw via random Fourier features; O(n * n_features)."""
    rng = np.random.default_rng(seed)
    n, d = x.shape
    beta = params.beta.detach().cpu().numpy()
    sigma2 = float(params.sigma2)
    nugget = float(params.nugget)
    z = rng.standard_normal((n_features, d))
    g = rng.gamma(shape=nu, scale=1.0 / nu, size=(n_features, 1))
    omega = z / np.sqrt(g) / beta[None, :]
    phase = rng.uniform(0.0, 2.0 * np.pi, size=n_features)
    w = rng.standard_normal(n_features)
    proj = x @ omega.T + phase[None, :]
    y = np.sqrt(2.0 * sigma2 / n_features) * (np.cos(proj) @ w)
    if nugget > 0:
        y = y + np.sqrt(nugget) * rng.standard_normal(n)
    return y


def paper_synthetic(seed: int, n: int, d: int = 10, exact_threshold: int = 3000):
    """Paper §6.1 setup: x ~ U[0,1]^10, Matern nu=3.5, beta = (.05,.05,5...5)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    beta = np.full(d, 5.0)
    beta[:2] = 0.05
    params = KernelParams.create(sigma2=1.0, beta=beta, nugget=0.0 + 1e-8, d=d)
    sampler = sample_gp_exact if n <= exact_threshold else sample_gp_rff
    y = sampler(seed + 1, x, params)
    return x, y, params


def paper_synthetic_chunks(seed: int, n: int, d: int = 10, gen_rows: int = 65536,
                           n_features: int = 4096):
    """Chunked generator of ONE ``paper_synthetic``-family GP realization.

    The RFF weights are drawn once and shared across every yielded
    ``(x, y)`` chunk, so the concatenation is a single function draw. RAM
    stays at ``gen_rows x n_features`` however large ``n`` is."""
    rng = np.random.default_rng(seed)
    nu = 3.5
    beta = np.full(d, 5.0)
    beta[:2] = 0.05
    sigma2, nugget = 1.0, 1e-8
    z = rng.standard_normal((n_features, d))
    g = rng.gamma(shape=nu, scale=1.0 / nu, size=(n_features, 1))
    omega = z / np.sqrt(g) / beta[None, :]
    phase = rng.uniform(0.0, 2.0 * np.pi, size=n_features)
    w = rng.standard_normal(n_features)
    done = 0
    while done < n:
        k = min(n - done, gen_rows)
        x = rng.uniform(size=(k, d))
        y = np.sqrt(2.0 * sigma2 / n_features) * (
            np.cos(x @ omega.T + phase[None, :]) @ w
        )
        y = y + np.sqrt(nugget) * rng.standard_normal(k)
        yield x, y
        done += k
