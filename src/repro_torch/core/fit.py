"""MLE parameter estimation for SBV (paper Alg. 1 outer loop).

Counterpart of the monolithic in-core branches of ``repro.core.fit.fit_sbv``:
Adam on ``-loglik/n`` with an analytic gradient, alternating with the
Scaled-Vecchia structure refresh (the block/neighbor structure is rebuilt
with the current beta estimate every outer round). The packed arrays go to
the device once per round; every step runs the fused likelihood kernel on
the GPU (the plain version on the CPU) and its chunked backward pass.

A 2-D ``y`` with p >= 2 outputs takes the shared-structure multi-output
(VPPE) fit: Adam on the pooled profile likelihood through the fused
multi-output stats kernel. An (n, 1) ``y`` squeezes to the single-output
fit, so p = 1 is bitwise the 1-D path.

``n_buckets`` runs every step on the bucketed layout (``core.buckets``),
re-bucketed at every structure refresh; ``precision`` selects the ladder
tier, re-probed per bucket (``assign_precision`` at the current params)
every outer round for single-output fits and cast-only for multi-output
ones, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim import adam_init, adam_update

from .buckets import (BucketedBlocks, apply_precision, as_policy, assign_precision,
                      bucket_blocks, cast_packed)
from .kernels_math import KernelParams
from .multioutput import (MultiOutputParams, as_multi_params, multi_profile_neg_loglik_fn,
                          with_profiled_sigma2)
from .pipeline import SBVConfig, preprocess
from .vecchia import packed_arrays, packed_loglik


@dataclass
class FitResult:
    params: KernelParams  # or MultiOutputParams (multi-output fits)
    history: list = field(default_factory=list)  # (outer, inner, -loglik/n)
    packed: object = None
    precision_tiers: list | None = None  # per-bucket ladder tiers (last round)


def neg_loglik_fn(packed, nu: float, backend: str, device=None):
    """``f(params) -> -loglik/n`` on one packed (or bucketed) dataset,
    with its operands moved to the device once."""
    n = packed.n_points
    arrays = packed_arrays(packed, resolve_device(device))

    def f(params):
        return -packed_loglik(params, packed, nu=nu, backend=backend, arrays=arrays) / n

    return f


def _value_and_grad(loss_fn, params):
    """``(loss, grads)`` of ``loss_fn`` at a NamedTuple of leaf tensors; a
    leaf the loss does not depend on gets a zero gradient."""
    leaves = type(params)(*(p.detach().requires_grad_(True) for p in params))
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, tuple(leaves), allow_unused=True)
    return loss.detach(), tuple(torch.zeros_like(p) if g is None else g
                                for p, g in zip(leaves, grads))


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
    version directly. A 2-D ``y`` (n, p) fits the multi-output model and
    returns ``MultiOutputParams`` (p = 1 squeezes to the 1-D fit).

    ``n_buckets`` fits on the bucketed layout, re-bucketed every outer
    round. ``precision`` (a ladder tier or a ``PrecisionPolicy``) probes
    each bucket at the current params every outer round and demotes it
    until its nll is within the tier's budget (multi-output fits cast
    without probing); the last round's tiers are
    ``FitResult.precision_tiers``.

    Only the in-core paths are ported: distributed, streaming, multi-host
    and tuning arguments raise ``NotImplementedError``."""
    if cfg is None:
        raise TypeError("fit_sbv requires an SBVConfig")
    for name, val in (("distributed", distributed), ("stream_chunk", stream_chunk),
                      ("spool_dir", spool_dir), ("device_cache", device_cache),
                      ("multihost", multihost), ("tuning", tuning)):
        if val is not None:
            raise NotImplementedError(f"fit_sbv({name}=) is not ported yet")
    if y is None or np.asarray(y).ndim not in (1, 2):
        raise NotImplementedError("only in-core fits of 1-D or 2-D observations are ported")
    if np.asarray(y).ndim == 2:
        y2 = np.asarray(y)
        if y2.shape[1] == 1:
            init1 = init.output_params(0) if isinstance(init, MultiOutputParams) else init
            return fit_sbv(x, y2[:, 0], cfg, init=init1, nu=nu, lr=lr, inner_steps=inner_steps,
                           outer_rounds=outer_rounds, backend=backend, verbose=verbose,
                           device=device, n_buckets=n_buckets, precision=precision)
        return _fit_sbv_multi(x, y2, cfg, init, nu, lr, inner_steps, outer_rounds, backend,
                              verbose, device, n_buckets, precision)
    policy = None
    if precision is not None:
        policy = as_policy(precision)
        if policy.tier == "f64" and not policy.probe:
            policy = None
    dev = resolve_device(device)
    d = x.shape[1]
    if init is None:
        init = KernelParams.create(sigma2=float(np.var(y)), beta=0.5, nugget=1e-3, d=d)
    params = KernelParams(*(torch.as_tensor(a).to(dev).detach() for a in init))
    history = []
    packed = None
    tiers = None

    for outer in range(outer_rounds):
        beta_np = params.beta.detach().cpu().numpy()
        packed, _ = preprocess(x, y, beta_np, cfg)
        if n_buckets:
            packed = bucket_blocks(packed, n_buckets=n_buckets)
        if policy is not None:
            # Probe and demote at the current params, every structure
            # refresh (re-clustering reshapes the buckets).
            tiers = assign_precision(params, packed, policy, nu=nu, backend=backend)
            packed = (apply_precision(packed, tiers) if isinstance(packed, BucketedBlocks)
                      else cast_packed(packed, tiers[0]))
        loss_fn = neg_loglik_fn(packed, nu, backend, device=dev)

        state = adam_init(params)
        for it in range(inner_steps):
            loss, g = _value_and_grad(loss_fn, params)
            params, state = adam_update(g, state, params, lr)
            history.append((outer, it, float(loss)))
            if verbose and it % 10 == 0:
                print(f"[fit] outer={outer} it={it} nll/n={float(loss):.6f}")
    return FitResult(params=params, history=history, packed=packed, precision_tiers=tiers)


def _fit_sbv_multi(x, y, cfg, init, nu, lr, inner_steps, outer_rounds, backend, verbose,
                   device, n_buckets=None, precision=None) -> FitResult:
    """Monolithic multi-output fit (counterpart of the reference's
    ``_fit_sbv_multi``).

    One structure pass per outer round shared by all p outputs; Adam
    minimizes the pooled profile likelihood over (log_beta, log_tau2)
    through the shared-Cholesky stats; the per-output sigma2 are profiled
    in closed form at the end (their gradient in the pooled objective is
    identically zero, so they ride along). ``n_buckets`` re-buckets every
    round; ``precision`` casts every bucket to the policy's tier without a
    probe (the per-bucket probe is single-output only, as in the
    reference)."""
    dev = resolve_device(device)
    d, p = x.shape[1], y.shape[1]
    if init is None:
        init = MultiOutputParams.create(sigma2=np.maximum(np.var(y, axis=0), 1e-12), beta=0.5,
                                        tau2=1e-3, d=d, p=p)
    params = as_multi_params(init, p, d)
    params = MultiOutputParams(*(torch.as_tensor(a).to(dev).detach() for a in params))
    history = []
    packed = None
    tier = None
    if precision is not None and as_policy(precision).tier != "f64":
        tier = as_policy(precision).tier

    for outer in range(outer_rounds):
        beta_np = params.beta.detach().cpu().numpy()
        packed, _ = preprocess(x, y, beta_np, cfg)
        if n_buckets:
            packed = bucket_blocks(packed, n_buckets=n_buckets)
        if tier:
            packed = (apply_precision(packed, tier) if isinstance(packed, BucketedBlocks)
                      else cast_packed(packed, tier))
        loss_fn = multi_profile_neg_loglik_fn(packed, nu, backend, device=dev)

        state = adam_init(params)
        for it in range(inner_steps):
            loss, g = _value_and_grad(loss_fn, params)
            params, state = adam_update(g, state, params, lr)
            history.append((outer, it, float(loss)))
            if verbose and it % 10 == 0:
                print(f"[fit-multi] outer={outer} it={it} nll/np={float(loss):.6f} p={p}")
    params = with_profiled_sigma2(params, packed, nu=nu, backend=backend)
    return FitResult(params=params, history=history, packed=packed)
