"""KL divergence between the exact GP and a Vecchia approximation (paper Eq. 4).

Counterpart of ``repro.core.kl``. For zero-mean Gaussians, D_KL(exact ||
vecchia) reduces to the difference of the log-likelihoods at y = 0:

    D_KL = l_exact(theta; 0) - l_vecchia(theta; 0) >= 0.
"""
from __future__ import annotations

import numpy as np

from repro_torch.device import resolve_device

from .exact_gp import exact_loglik
from .kernels_math import KernelParams
from .packing import PackedBlocks
from .vecchia import packed_loglik


def kl_divergence(params: KernelParams, x: np.ndarray, packed: PackedBlocks, nu: float = 3.5,
                  device=None, backend: str = "auto") -> float:
    """Eq. 4 on ``device`` (the current CUDA device when not given; without
    one it raises unless ``device="cpu"``). ``packed`` must have been built
    from the same x (its observations are ignored). ``backend='auto'`` is
    the kernel route (the covariance kernel for the exact half, the
    likelihood kernel for the Vecchia half, on a CUDA device); ``'ref'`` the
    plain one."""
    dev = resolve_device(device)
    params = KernelParams(*(t.detach() for t in params)).to(device=dev)
    zero_packed = PackedBlocks(
        blk_x=packed.blk_x,
        blk_y=np.zeros_like(packed.blk_y),
        blk_mask=packed.blk_mask,
        nn_x=packed.nn_x,
        nn_y=np.zeros_like(packed.nn_y),
        nn_mask=packed.nn_mask,
        owners=packed.owners,
    )
    l0 = exact_loglik(params, x, np.zeros(x.shape[0]), nu=nu, device=dev, backend=backend)
    la = packed_loglik(params, zero_packed, nu=nu, backend=backend)
    return float(l0 - la)
