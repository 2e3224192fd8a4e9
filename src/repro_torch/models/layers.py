"""Shared neural-net layers: RMSNorm, RoPE, the MLPs, softcap, cross-entropy.

The counterpart of ``repro.models.layers``. Weight matrices keep the JAX
package's orientation, ``x @ w`` with ``w`` of shape (d_in, d_out), so that
parameters carry across unchanged (``repro_torch.convert``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in f32 with the scale applied as ``1 + scale``; the output
    has the input's dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: ``cap * tanh(x / cap)``."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Half-split (not interleaved) rotary embedding, in f32.

    x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)                 # (hd/2,)
    ang = positions[..., :, None].to(torch.float32) * freqs        # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]                          # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def dense_init_(w: torch.Tensor, generator: torch.Generator, scale: float | None = None) -> None:
    """Fill a (d_in, d_out) weight in place with normal draws times
    ``d_in ** -0.5`` (or ``scale``), drawn in f32 and cast to its dtype: the
    reference's ``dense_init``."""
    scale = scale if scale is not None else w.shape[0] ** -0.5
    draw = torch.randn(w.shape, generator=generator, dtype=torch.float32, device=w.device)
    with torch.no_grad():
        w.copy_(draw * scale)


def linear_weight(d_in: int, d_out: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(d_in, d_out, dtype=dtype, device=device))


class MLP(nn.Module):
    """``swiglu``: ``down(silu(x @ gate) * (x @ up))``; ``relu2``
    (nemotron/minitron): ``down(relu(x @ up) ** 2)``."""

    def __init__(self, d_model: int, d_ff: int, kind: str = "swiglu", *, dtype=torch.float32,
                 device=None):
        super().__init__()
        if kind not in ("swiglu", "relu2"):
            raise ValueError(kind)
        self.kind = kind
        if kind == "swiglu":
            self.w_gate = linear_weight(d_model, d_ff, dtype, device)
        self.w_up = linear_weight(d_model, d_ff, dtype, device)
        self.w_down = linear_weight(d_ff, d_model, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.kind == "swiglu":
            dense_init_(self.w_gate, generator)
        dense_init_(self.w_up, generator)
        dense_init_(self.w_down, generator, scale=self.w_down.shape[0] ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "swiglu":
            return (F.silu(x @ self.w_gate) * (x @ self.w_up)) @ self.w_down
        return torch.square(F.relu(x @ self.w_up)) @ self.w_down


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over tokens; f32 logsumexp."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)
