"""MLE parameter estimation for SBV (paper Alg. 1 outer loop).

Counterpart of the monolithic in-core branch of ``repro.core.fit.fit_sbv``:
Adam on ``-loglik/n`` with an analytic gradient, alternating with the
Scaled-Vecchia structure refresh (the block/neighbor structure is rebuilt
with the current beta estimate every outer round). The packed arrays go to
the device once per round; every step runs the fused likelihood kernel on
the GPU (the plain version on the CPU) and its chunked backward pass.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim import adam_init, adam_update

from .kernels_math import KernelParams
from .pipeline import SBVConfig, preprocess
from .vecchia import packed_arrays, packed_loglik


@dataclass
class FitResult:
    params: KernelParams
    history: list = field(default_factory=list)  # (outer, inner, -loglik/n)
    packed: object = None


def neg_loglik_fn(packed, nu: float, backend: str, device=None):
    """``f(params) -> -loglik/n`` on one packed dataset, with its operands
    moved to the device once."""
    n = packed.n_points
    arrays = packed_arrays(packed, resolve_device(device))

    def f(params):
        return -packed_loglik(params, packed, nu=nu, backend=backend, arrays=arrays) / n

    return f


def _value_and_grad(loss_fn, params: KernelParams):
    leaves = KernelParams(*(p.detach().requires_grad_(True) for p in params))
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, tuple(leaves))
    return loss.detach(), grads


def fit_sbv(
    x: np.ndarray,
    y: np.ndarray = None,
    cfg: SBVConfig = None,
    init: KernelParams | None = None,
    nu: float = 3.5,
    lr: float = 0.05,
    inner_steps: int = 60,
    outer_rounds: int = 3,
    backend: str = "auto",
    verbose: bool = False,
    device=None,
    distributed=None,
    n_buckets: int | None = None,
    stream_chunk: int | None = None,
    spool_dir: str | None = None,
    device_cache: int | None = None,
    multihost=None,
    precision=None,
    tuning=None,
) -> FitResult:
    """Maximum-likelihood fit of (sigma^2, beta, nugget) with fixed nu.

    Runs on ``device`` (default: the current CUDA device; with no GPU pass
    ``device='cpu'``). ``backend='auto'`` takes the fused kernel on CUDA
    and the plain version on the CPU; ``'ref'`` differentiates the plain
    version directly.

    Only the in-core single-output path is ported: distributed, bucketed,
    streaming, multi-host, precision-ladder, tuning and multi-output
    arguments raise ``NotImplementedError``."""
    if cfg is None:
        raise TypeError("fit_sbv requires an SBVConfig")
    for name, val in (("distributed", distributed), ("n_buckets", n_buckets),
                      ("stream_chunk", stream_chunk), ("spool_dir", spool_dir),
                      ("device_cache", device_cache), ("multihost", multihost),
                      ("precision", precision), ("tuning", tuning)):
        if val is not None:
            raise NotImplementedError(f"fit_sbv({name}=) is not ported yet")
    if y is None or np.asarray(y).ndim != 1:
        raise NotImplementedError("only in-core single-output fits are ported")
    dev = resolve_device(device)
    d = x.shape[1]
    if init is None:
        init = KernelParams.create(sigma2=float(np.var(y)), beta=0.5, nugget=1e-3, d=d)
    params = KernelParams(*(torch.as_tensor(a).to(dev).detach() for a in init))
    history = []
    packed = None

    for outer in range(outer_rounds):
        beta_np = params.beta.detach().cpu().numpy()
        packed, _ = preprocess(x, y, beta_np, cfg)
        loss_fn = neg_loglik_fn(packed, nu, backend, device=dev)

        state = adam_init(params)
        for it in range(inner_steps):
            loss, g = _value_and_grad(loss_fn, params)
            params, state = adam_update(g, state, params, lr)
            history.append((outer, it, float(loss)))
            if verbose and it % 10 == 0:
                print(f"[fit] outer={outer} it={it} nll/n={float(loss):.6f}")
    return FitResult(params=params, history=history, packed=packed)
