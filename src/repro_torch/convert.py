"""Carry kernel parameters between this package and the JAX package.

The JAX package's ``KernelParams`` leaves (``log_sigma2``, ``log_beta``,
``log_nugget``) and ``MultiOutputParams`` leaves (``log_sigma2`` (p,),
``log_beta``, ``log_tau2``) travel as numpy arrays, so neither package
imports the other. Packed structures are numpy on both sides and need no
conversion.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kernels_math import KernelParams
from repro_torch.core.multioutput import MultiOutputParams


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float64)).to(device=device, dtype=dtype)


def params_from_reference(log_sigma2, log_beta, log_nugget, device="cpu",
                          dtype=torch.float64) -> KernelParams:
    """This package's ``KernelParams`` from the reference's log-space leaves."""
    t = lambda a: _tensor(a, device, dtype)
    return KernelParams(log_sigma2=t(log_sigma2), log_beta=t(log_beta),
                        log_nugget=t(log_nugget))


def params_to_reference(params: KernelParams) -> tuple:
    """``(log_sigma2, log_beta, log_nugget)`` as float64 numpy arrays, the
    leaves of the reference's ``KernelParams``."""
    return tuple(np.asarray(a.detach().cpu().numpy(), dtype=np.float64) for a in params)


def multi_params_from_reference(log_sigma2, log_beta, log_tau2, device="cpu",
                                dtype=torch.float64) -> MultiOutputParams:
    """This package's ``MultiOutputParams`` from the reference's leaves."""
    t = lambda a: _tensor(a, device, dtype)
    return MultiOutputParams(log_sigma2=t(log_sigma2), log_beta=t(log_beta),
                             log_tau2=t(log_tau2))


def multi_params_to_reference(params: MultiOutputParams) -> tuple:
    """``(log_sigma2, log_beta, log_tau2)`` as float64 numpy arrays, the
    leaves of the reference's ``MultiOutputParams``."""
    return params_to_reference(params)
