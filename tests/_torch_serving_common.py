"""Shared fixtures of the port's serving tests (tests/test_torch_serving.py,
test_torch_scheduler.py, test_torch_router.py).

The reference's serving fixtures draw ``paper_synthetic`` data, whose
nugget (1e-8) leaves K(NN, NN) conditioned at up to ~4e5 here. Two f64
block conditionals computed by different LAPACK paths (the port's
``torch.linalg`` and an elementwise mean, the reference's XLA programs)
then agree to eps * cond, not to the last bit: 2.3e-11 at the 400-point
fixture. So each served result is held twice:

* against the port's own ``predict_sbv`` on the same inputs at atol 1e-12
  (the reference's serving contract: serving only rearranges the packed
  prediction pipeline, so scheduling and routing never change a result);
* against the reference's ``predict_sbv`` at ``conditioning_tol``:
  10 * eps * the largest cond(K(NN, NN)) of the request's packed blocks,
  times max(1, |mean|), the rule ``chip_smoke.py`` holds the predict
  kernel to at ill-conditioned parameters (ROADMAP fault 2).

Each file also serves ``conditioned_problem``, the same draw with the
nugget raised to 1e-2. There the two packages agree to within 1e-12 (2.7e-13
measured on the mean at the 400-point fixture; 1.3e-12 at nugget 1e-3), so
its served results are held against the reference's ``predict_sbv`` at
atol 1e-12.
"""
from __future__ import annotations

import numpy as np
import torch

from repro.core import KernelParams as RefKernelParams
from repro.core import predict_sbv as ref_predict_sbv
from repro.data.gp_sim import paper_synthetic as ref_paper_synthetic
from repro_torch.convert import params_from_reference
from repro_torch.core import vecchia
from repro_torch.core.predict import build_train_index, iter_query_chunks, predict_sbv

EPS = float(np.finfo(np.float64).eps)
PARITY = 1e-12  # served vs the port's own predict_sbv, and vs the reference when conditioned
CONDITIONED_NUGGET = 1e-2


def synthetic_problem(seed: int, n: int, d: int):
    """The reference's ``paper_synthetic`` draw: ``(x, y, ref_params, params)``."""
    x, y, ref_params = ref_paper_synthetic(seed=seed, n=n, d=d)
    return x, y, ref_params, params_from_reference(*(np.asarray(a) for a in ref_params))


def conditioned_problem(seed: int, n: int, d: int):
    """``synthetic_problem`` with the kernel's nugget raised to 1e-2."""
    x, y, ref_params = ref_paper_synthetic(seed=seed, n=n, d=d)
    ref_params = RefKernelParams.create(sigma2=float(ref_params.sigma2),
                                        beta=np.asarray(ref_params.beta),
                                        nugget=CONDITIONED_NUGGET)
    return x, y, ref_params, params_from_reference(*(np.asarray(a) for a in ref_params))


def conditioning_tol(params, x, y, xq, bs_pred: int, m_pred: int, seed: int,
                     chunk_size) -> float:
    """10 eps cond(K(NN, NN)) max(1, |mean|) over the request's packed chunks."""
    index = build_train_index(x, y, params.beta.numpy(), m_pred, seed=seed)
    cond, scale = 1.0, 1.0
    for _, pk in iter_query_chunks(index, xq, bs_pred, m_pred, seed=seed,
                                   chunk_size=chunk_size):
        nx, nm = torch.as_tensor(pk.nn_x), torch.as_tensor(pk.nn_mask)
        k = vecchia._masked_cov(nx, nx, nm, nm, params.beta, params.sigma2, params.nugget, 3.5,
                                identity=True)
        ev = torch.linalg.eigvalsh(k)
        cond = max(cond, float((ev[:, -1] / ev[:, 0]).max()))
        scale = max(scale, float(np.abs(pk.nn_y).max()))
    return 10 * EPS * cond * scale


def port_predict(params, x, y, xq, bs_pred, m_pred, seed, chunk_size, **kw):
    """The port's lone ``predict_sbv`` on the CPU: ``(mean, var)``."""
    p = predict_sbv(params, x, y, xq, bs_pred=bs_pred, m_pred=m_pred, seed=seed,
                    chunk_size=chunk_size, n_sims=2, device="cpu", **kw)
    return p.mean, p.var


def ref_predict(ref_params, x, y, xq, bs_pred, m_pred, seed, chunk_size, **kw):
    """The reference's lone ``predict_sbv``: ``(mean, var)``."""
    p = ref_predict_sbv(ref_params, x, y, xq, bs_pred=bs_pred, m_pred=m_pred, seed=seed,
                        chunk_size=chunk_size, n_sims=2, **kw)
    return np.asarray(p.mean), np.asarray(p.var)


def assert_parity(mean, var, want, atol: float) -> None:
    np.testing.assert_allclose(mean, want[0], rtol=0, atol=atol)
    np.testing.assert_allclose(var, want[1], rtol=0, atol=atol)
