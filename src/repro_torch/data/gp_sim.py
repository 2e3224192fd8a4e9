"""Dataset generators of the paper's three experiment families.

Counterpart of ``repro.data.gp_sim``, numpy-seeded the same way:

* synthetic anisotropic GP draws (§6.1): exact Cholesky draws for small n,
  random-Fourier-feature (RFF) draws for large n. The Matérn spectral
  density is a multivariate Student-t with 2*nu dof, so RFF frequencies are
  z / sqrt(g), z ~ N(0, I_d), g ~ Gamma(nu, 1/nu), scaled dimension-wise
  by 1/beta;
* the satellite-drag-like surrogate (§6.2);
* the MetaRVM-like compartmental simulator (§6.3) and its multi-output
  trajectory form, bitwise the reference's arrays.
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


def satellite_drag_like(seed: int, n: int):
    """8-d drag-coefficient surrogate: smooth, anisotropic, 3 dominant dims
    (the paper's Fig. 6 finding that the last 3 dims dominate)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, 8))
    vel, t_srf, t_atm, yaw, pitch, acc1, acc2, extra = [x[:, i] for i in range(8)]
    y = (
        2.2
        + 1.5 * np.cos(np.pi * pitch) ** 2
        + 1.2 * acc1 * (1.0 - 0.5 * acc2)
        + 0.8 * np.exp(-2.0 * (acc2 - 0.5) ** 2)
        + 0.08 * np.sin(2 * np.pi * yaw)
        + 0.05 * vel * t_atm
        + 0.02 * t_srf
        + 0.0 * extra
    )
    y = y + 0.01 * rng.standard_normal(n)
    return x, y


# The MetaRVM-like simulator of paper §6.3: Table-4 parameter bounds.
METARVM_BOUNDS = {
    "ts": (0.1, 0.9), "tv": (0.1, 0.9), "dv": (30.0, 90.0), "de": (1.0, 5.0),
    "dp": (1.0, 3.0), "da": (1.0, 9.0), "ds": (1.0, 9.0), "dh": (1.0, 5.0),
    "dr": (30.0, 90.0), "ve": (0.3, 0.8),
}


def metarvm_sample_inputs(seed: int, n: int) -> np.ndarray:
    """Uniform draws inside the Table-4 bounds, columns in Table-4 order."""
    rng = np.random.default_rng(seed)
    lo = np.array([b[0] for b in METARVM_BOUNDS.values()])
    hi = np.array([b[1] for b in METARVM_BOUNDS.values()])
    return lo + (hi - lo) * rng.uniform(size=(n, 10))


def _metarvm_run(th: np.ndarray, snap_days: np.ndarray) -> np.ndarray:
    """Accumulated hospital admissions (n, len(snap_days)) after each
    snapshot day, from ONE daily sweep of the compartmental model.

    A run stopped at day k has taken exactly the first k steps of a longer
    run, so every column is bitwise what a separate run of k days gives."""
    ts, tv, dv, de, dp, da, ds, dh, dr, ve = [th[:, i] for i in range(10)]
    nb = th.shape[0]

    contact = 0.55      # fixed daily contact rate
    p_asym = 0.4        # P -> A split
    p_hosp = 0.12       # I -> H split
    vax_rate = 0.01     # S -> V per day

    s = np.full(nb, 0.989)
    v = np.zeros(nb)
    e = np.full(nb, 0.001)
    p = np.zeros(nb)
    a = np.zeros(nb)
    i_ = np.full(nb, 0.01)
    h = np.zeros(nb)
    r = np.zeros(nb)
    cum_h = np.zeros(nb)
    out = np.zeros((nb, len(snap_days)))

    for day in range(1, int(np.max(snap_days, initial=0)) + 1):
        infectious = p + a + i_
        foi_s = 1.0 - np.exp(-contact * ts * infectious)
        foi_v = 1.0 - np.exp(-contact * tv * (1.0 - ve) * infectious)
        new_e = s * foi_s + v * foi_v
        e_out = e / de
        p_out = p / dp
        a_out = a / da
        i_out = i_ / ds
        h_out = h / dh
        r_out = r / dr
        v_wane = v / dv
        new_v = vax_rate * s
        new_h = p_hosp * i_out

        s = s - s * foi_s - new_v + r_out + v_wane
        v = v + new_v - v * foi_v - v_wane
        e = e + new_e - e_out
        p = p + e_out - p_out
        a = a + p_asym * p_out - a_out
        i_ = i_ + (1.0 - p_asym) * p_out - i_out
        h = h + new_h - h_out
        r = r + a_out + (1.0 - p_hosp) * i_out + h_out - r_out
        cum_h = cum_h + new_h
        hit = snap_days == day
        if hit.any():
            out[:, hit] = cum_h[:, None]
    return out


def metarvm_simulate(theta: np.ndarray, days: int = 100) -> np.ndarray:
    """Deterministic compartmental respiratory-virus model (vectorized).

    Compartments (fractions of one population): S susceptible, V vaccinated,
    E exposed, P infectious presymptomatic, A infectious asymptomatic,
    I infectious symptomatic, H hospitalized, R recovered.
    Output: accumulated hospital admissions over ``days``.
    """
    th = np.atleast_2d(np.asarray(theta, dtype=np.float64))
    cum_h = _metarvm_run(th, np.array([days]))[:, 0]
    return cum_h if theta.ndim > 1 else cum_h[0]


def metarvm_dataset(seed: int, n: int, normalize: bool = True):
    """(X in [0,1]^10, y) pairs per paper §6.3 (inputs scaled to the unit
    cube, output normalized to mean 1)."""
    theta = metarvm_sample_inputs(seed, n)
    y = metarvm_simulate(theta)
    lo = np.array([b[0] for b in METARVM_BOUNDS.values()])
    hi = np.array([b[1] for b in METARVM_BOUNDS.values()])
    x01 = (theta - lo) / (hi - lo)
    if normalize:
        y = y / max(y.mean(), 1e-12)
    return x01, y


def metarvm_field_simulate(theta: np.ndarray, p: int, days: int = 100) -> np.ndarray:
    """The epidemic trajectory: accumulated hospital admissions at ``p``
    evenly spaced days, (n, p). Column j is the total through day
    ``round((j+1) * days / p)``; the last column is exactly
    ``metarvm_simulate(theta, days)``."""
    if p < 1:
        raise ValueError(f"need p >= 1 output snapshots, got {p}")
    th = np.atleast_2d(np.asarray(theta, dtype=np.float64))
    snap_days = np.rint(np.arange(1, p + 1) * days / p).astype(int)
    snap_days[-1] = days
    return _metarvm_run(th, snap_days)


def metarvm_field_dataset(seed: int, n: int, p: int, days: int = 100,
                          normalize: bool = True):
    """Multi-output MetaRVM: (X in [0,1]^10, Y (n, p)), each column
    normalized to mean 1 (the per-output scale is what the multi-output
    per-output sigma2 absorbs)."""
    theta = metarvm_sample_inputs(seed, n)
    y = metarvm_field_simulate(theta, p, days=days)
    lo = np.array([b[0] for b in METARVM_BOUNDS.values()])
    hi = np.array([b[1] for b in METARVM_BOUNDS.values()])
    x01 = (theta - lo) / (hi - lo)
    if normalize:
        y = y / np.maximum(y.mean(axis=0), 1e-12)
    return x01, y
