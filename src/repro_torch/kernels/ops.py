"""Public wrappers around the fused kernels.

``sbv_loglik`` and ``sbv_multi_stats`` are differentiable: the forward pass
runs the fused kernel (the plain version on CPU tensors); the backward pass
recomputes the plain version under autograd and contracts it with the
incoming cotangents, as the reference's ``custom_vjp``s do
(src/repro/kernels/ops.py). As there, the backward pass is the ``ref`` form
(``block_loglik``, ``block_multi_stats``: no bf16 rounding of the scaled
coordinates and no pivot floor), computed at the promotion of the master
parameters' dtype and the data's: f64 master parameters differentiate the
f32 and bf16 tiers' narrow-stored data in f64. Unlike the reference, the
backward pass runs in chunks of blocks: autograd through the plain version
keeps about a dozen (bc, ., .) tensors alive, which at the paper's per-GPU
sizes outgrows device memory. Both outputs are sums over independent
blocks, so the chunked gradient equals the unchunked one.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels_math import KernelParams
from repro_torch.core.multioutput import block_multi_stats
from repro_torch.core.vecchia import block_loglik

from . import _build
from .matern_cov import matern_cov_blocks
from .sbv_loglik import ladder_dtypes, sbv_loglik_blocks
from .sbv_multi_stats import sbv_multi_stats_blocks
from .sbv_predict import sbv_predict_blocks_many

# Blocks recomputed per backward chunk: at m = 200, bs ~ 290 in f64 a block
# keeps ~17 MB of autograd intermediates, so a chunk holds ~2 GB.
BACKWARD_CHUNK = 128


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return dict(_build.LAUNCHES)


def reset_launch_counts() -> None:
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0


def select_backend(bs: int, m: int, kind: str = "predict", dtype=None) -> str:
    """Resolve ``backend='auto'`` for one batch (bucket) shape and dtype.

    On Hopper the answer is ``'auto'`` itself, the kernel route, for every
    shape and ladder dtype: the CUDA kernels take any bs and m and have
    f64, f32 and bf16-assembly variants, so there is no tile to align to
    and no size below which a plain program would be sent to the card
    instead (the reference's TPU policy, src/repro/kernels/ops.py, is not
    copied). The dispatchers therefore take ``'auto'`` as the kernel route
    without calling this; ``'ref'`` stays the explicit plain backend."""
    if kind not in ("predict", "loglik"):
        raise ValueError(f"unknown kind {kind!r}")
    return "auto"


def _chunked_vjp(per_block_fn, cotangent, params, blk_x, blk_y, blk_mask, nn_x, nn_y,
                 nn_mask, need, chunk: int):
    """Gradients of ``sum(cotangent * per_block_fn(...))`` in chunks of
    ``chunk`` blocks: ``(g_log_sigma2, g_log_beta, g_log_nugget, g_blk_y,
    g_nn_y)``, the observation gradients only where ``need`` asks. Each
    chunk recomputes the plain version under autograd and frees it.

    The plain version runs at the promotion of the parameters' dtype and
    the observations' (the reference's jnp promotion of f64 master
    parameters against narrow data): coordinates and observations are
    widened to it, exactly, and the observation gradients are returned at
    the observations' own dtype."""
    wide = torch.promote_types(params[0].dtype, blk_y.dtype)
    up = lambda t: t.to(wide) if t.is_floating_point() else t
    leaves = [t.detach().requires_grad_(True) for t in params]
    gp = [torch.zeros_like(t) for t in leaves]
    g_by = torch.zeros_like(blk_y) if need[0] else None
    g_ny = torch.zeros_like(nn_y) if need[1] else None
    bc = blk_x.shape[0]
    cotangent = cotangent.to(wide)
    for s in range(0, bc, chunk):
        sl = slice(s, min(bc, s + chunk))
        by = up(blk_y[sl].detach()).requires_grad_(need[0])
        ny = up(nn_y[sl].detach()).requires_grad_(need[1])
        with torch.enable_grad():
            out = per_block_fn(torch.exp(leaves[1]).to(wide), torch.exp(leaves[0]).to(wide),
                               torch.exp(leaves[2]).to(wide), up(blk_x[sl]), by, blk_mask[sl],
                               up(nn_x[sl]), ny, nn_mask[sl])
            total = torch.sum(out * cotangent)
            wrt = leaves + [t for t in (by, ny) if t.requires_grad]
            grads = torch.autograd.grad(total, wrt)
        for acc_g, gi in zip(gp, grads[:3]):
            acc_g += gi
        rest = list(grads[3:])
        if need[0]:
            g_by[sl] = rest.pop(0)
        if need[1]:
            g_ny[sl] = rest.pop(0)
    return gp[0], gp[1], gp[2], g_by, g_ny


class _SbvLoglik(torch.autograd.Function):
    @staticmethod
    def forward(ctx, log_sigma2, log_beta, log_nugget, blk_x, blk_y, blk_mask, nn_x, nn_y,
                nn_mask, nu, chunk):
        acc = blk_y.dtype
        per_block = sbv_loglik_blocks(
            torch.exp(log_beta).to(acc), torch.exp(log_sigma2).to(acc),
            torch.exp(log_nugget).to(acc), blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask, nu=nu)
        ctx.save_for_backward(log_sigma2, log_beta, log_nugget, blk_x, blk_y, blk_mask,
                              nn_x, nn_y, nn_mask)
        ctx.nu, ctx.chunk = nu, chunk
        return per_block.sum()

    @staticmethod
    def backward(ctx, g):
        ls2, lb, ln, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask = ctx.saved_tensors
        need = ctx.needs_input_grad
        plain = lambda *a: block_loglik(*a, nu=ctx.nu)
        g_s2, g_b, g_n, g_by, g_ny = _chunked_vjp(
            plain, g, (ls2, lb, ln), blk_x, blk_y, blk_mask, nn_x, nn_y,
            nn_mask, (need[4], need[7]), ctx.chunk)
        return (g_s2, g_b, g_n, None, g_by, None, None, g_ny, None, None, None)


class _SbvMultiStats(torch.autograd.Function):
    """(logdet0, q0 (p,)) of the unit-variance multi-output stats."""

    @staticmethod
    def forward(ctx, log_sigma2, log_beta, log_nugget, blk_x, blk_y, blk_mask, nn_x, nn_y,
                nn_mask, nu, chunk):
        acc = blk_y.dtype
        per_block = sbv_multi_stats_blocks(
            torch.exp(log_beta).to(acc), torch.exp(log_sigma2).to(acc),
            torch.exp(log_nugget).to(acc), blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask, nu=nu)
        ctx.save_for_backward(log_sigma2, log_beta, log_nugget, blk_x, blk_y, blk_mask,
                              nn_x, nn_y, nn_mask)
        ctx.nu, ctx.chunk = nu, chunk
        return per_block[:, 0].sum(), per_block[:, 1:].sum(dim=0)

    @staticmethod
    def backward(ctx, g_ld, g_q):
        ls2, lb, ln, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask = ctx.saved_tensors
        need = ctx.needs_input_grad
        # Per block [logdet0, q_1 .. q_p] against the cotangent row [g_ld, g_q].
        cot = torch.cat([g_ld.reshape(1), g_q.reshape(-1).to(g_ld.dtype)])

        def plain(*a):
            ld, q = block_multi_stats(*a, nu=ctx.nu)
            return torch.cat([ld[:, None], q], dim=1)

        g_s2, g_b, g_n, g_by, g_ny = _chunked_vjp(
            plain, cot, (ls2, lb, ln), blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
            (need[4], need[7]), ctx.chunk)
        return (g_s2, g_b, g_n, None, g_by, None, None, g_ny, None, None, None)


def sbv_loglik(params: KernelParams, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
               nu: float = 3.5, chunk: int = BACKWARD_CHUNK) -> torch.Tensor:
    """Total SBV log-likelihood through the fused kernel (differentiable in
    the params and the observations; coordinates and masks get no
    gradient). ``chunk`` is the number of blocks per backward chunk."""
    return _SbvLoglik.apply(params.log_sigma2, params.log_beta, params.log_nugget,
                            blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask, nu, int(chunk))


def sbv_multi_stats(params0: KernelParams, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
                    nu: float = 3.5, chunk: int = BACKWARD_CHUNK):
    """Multi-output dataset stats ``(logdet0, q0 (p,))`` through the fused
    kernel: one Cholesky per block, the p outputs as extra right-hand sides.

    ``params0`` is the UNIT-VARIANCE correlation (sigma2 = 1, nugget = tau2;
    ``MultiOutputParams.structure_params``). Differentiable in the params
    and the observations; coordinates and masks get no gradient. ``chunk``
    is the number of blocks per backward chunk."""
    return _SbvMultiStats.apply(params0.log_sigma2, params0.log_beta, params0.log_nugget,
                                blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask, nu, int(chunk))


def sbv_predict_many(params: KernelParams, pieces, nu: float = 3.5):
    """Batched block conditional mean/variance of each piece of a chunk
    (``pieces``: ``(q_x, q_mask, nn_x, nn_y, nn_mask)`` tuples, its size
    buckets or its one uniform piece) through ONE launch of the fused
    kernel: a list of ``(mu, var)``, each (bc, bs_pred) of its piece.
    Padded query slots carry mu=0 / var=prior and are dropped by the
    caller's mask. Not differentiable."""
    acc = pieces[0][3].dtype
    with torch.no_grad():
        return sbv_predict_blocks_many(params.beta.to(acc), params.sigma2.to(acc),
                                       params.nugget.to(acc), pieces, nu=nu)


def matern_cov(xa, xb, params: KernelParams, nu: float = 3.5) -> torch.Tensor:
    """Batched scaled-Matérn covariance (B, na, nb) through the kernel (the
    plain version on CPU tensors). bf16 coordinates give an f32 output (the
    bf16-assembly variant). Not differentiable."""
    _, acc = ladder_dtypes(xa.dtype)
    with torch.no_grad():
        return matern_cov_blocks(xa, xb, params.beta.to(acc), params.sigma2.to(acc), nu=nu)
