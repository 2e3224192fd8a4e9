"""Public wrappers around the fused kernels.

``sbv_loglik`` is differentiable: the forward pass runs the fused kernel
(the plain version on CPU tensors); the backward pass recomputes the plain
version under autograd and scales by the incoming cotangent, as the
reference's ``custom_vjp`` does (src/repro/kernels/ops.py). Unlike the
reference, the backward pass runs in chunks of blocks: autograd through
the plain version keeps about a dozen (bc, ., .) tensors alive, which at
the paper's per-GPU sizes outgrows device memory. The loss is a sum over
independent blocks, so the chunked gradient equals the unchunked one.
"""
from __future__ import annotations

import torch

from repro_torch.core.kernels_math import KernelParams

from . import _build
from .sbv_loglik import sbv_loglik_blocks, sbv_loglik_plain
from .sbv_predict import sbv_predict_blocks

# Blocks recomputed per backward chunk: at m = 200, bs ~ 290 in f64 a block
# keeps ~17 MB of autograd intermediates, so a chunk holds ~2 GB.
BACKWARD_CHUNK = 128


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name."""
    return dict(_build.LAUNCHES)


def reset_launch_counts() -> None:
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0


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
        acc = blk_y.dtype
        leaves = [t.detach().requires_grad_(True) for t in (ls2, lb, ln)]
        gp = [torch.zeros_like(t) for t in leaves]
        g_by = torch.zeros_like(blk_y) if need[4] else None
        g_ny = torch.zeros_like(nn_y) if need[7] else None
        bc = blk_x.shape[0]
        for s in range(0, bc, ctx.chunk):
            sl = slice(s, min(bc, s + ctx.chunk))
            by = blk_y[sl].detach().requires_grad_(need[4])
            ny = nn_y[sl].detach().requires_grad_(need[7])
            with torch.enable_grad():
                ll = sbv_loglik_plain(
                    torch.exp(leaves[1]).to(acc), torch.exp(leaves[0]).to(acc),
                    torch.exp(leaves[2]).to(acc), blk_x[sl], by, blk_mask[sl], nn_x[sl], ny,
                    nn_mask[sl], nu=ctx.nu).sum()
                wrt = leaves + [t for t in (by, ny) if t.requires_grad]
                grads = torch.autograd.grad(ll, wrt)
            for acc_g, gi in zip(gp, grads[:3]):
                acc_g += gi
            rest = list(grads[3:])
            if need[4]:
                g_by[sl] = rest.pop(0)
            if need[7]:
                g_ny[sl] = rest.pop(0)
        scale = lambda t: None if t is None else t * g
        return (scale(gp[0]), scale(gp[1]), scale(gp[2]), None, scale(g_by), None, None,
                scale(g_ny), None, None, None)


def sbv_loglik(params: KernelParams, blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask,
               nu: float = 3.5, chunk: int = BACKWARD_CHUNK) -> torch.Tensor:
    """Total SBV log-likelihood through the fused kernel (differentiable in
    the params and the observations; coordinates and masks get no
    gradient). ``chunk`` is the number of blocks per backward chunk."""
    return _SbvLoglik.apply(params.log_sigma2, params.log_beta, params.log_nugget,
                            blk_x, blk_y, blk_mask, nn_x, nn_y, nn_mask, nu, int(chunk))


def sbv_predict(params: KernelParams, q_x, q_mask, nn_x, nn_y, nn_mask, nu: float = 3.5):
    """Batched block conditional mean/variance through the fused kernel:
    ``(mu, var)`` each (bc, bs_pred). Padded query slots carry mu=0 /
    var=prior and are dropped by the caller's mask. Not differentiable."""
    acc = nn_y.dtype
    with torch.no_grad():
        return sbv_predict_blocks(params.beta.to(acc), params.sigma2.to(acc),
                                  params.nugget.to(acc), q_x, q_mask, nn_x, nn_y, nn_mask,
                                  nu=nu)
