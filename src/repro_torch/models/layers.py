"""Shared neural-net layers: RMSNorm, RoPE, the MLPs, softcap, cross-entropy.

The counterpart of ``repro.models.layers``. Weight matrices keep the JAX
package's orientation, ``x @ w`` with ``w`` of shape (d_in, d_out), so that
parameters carry across unchanged (``repro_torch.convert``).

A module bound to a ``sharding.placement.ShardContext`` (``module.shard``;
None on a whole model) holds its rank's shards and runs the Megatron layout
that the reference's ``constrain`` calls ask XLA for:

* an in-projection (``w_gate``, ``w_up``; ``wq``, ``wk``, ``wv`` and the
  head elsewhere) gathers its FSDP-split input dimension over the data axes
  and multiplies its own output columns; its input enters through
  ``copy_to`` over 'model', so the input's gradient is summed over 'model';
* an out-projection (``w_down``, ``wo``: ``row_parallel``) gathers over the
  data axes, multiplies its own input rows and all-reduces the partial
  product over 'model'. Each partial product is the GEMM's f32 accumulator
  (bf16 operands, f32 output), summed over 'model' in f32 and rounded once
  to the activation dtype, as one whole GEMM rounds its accumulator once;
  summing bf16 partials would add one more bf16 rounding per rank;
* the weight gradients go back to the shards' layout by the gathers'
  backward, a reduce-scatter over the data axes;
* where the model axis does not divide d_ff, ``_fit`` replicates all three
  MLP leaves over 'model' and the MLP runs whole on every model rank
  (``MLP.split`` False): no ``copy_to``, no sum.
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


def rms_norm_split(x: torch.Tensor, scale: torch.Tensor, eps: float, shard,
                   width: int) -> torch.Tensor:
    """``rms_norm`` over a last dimension of ``width`` of which ``x`` and
    ``scale`` hold this rank's block over 'model': the f32 sum of squares
    summed over 'model' (forward and backward) before the ``rsqrt``."""
    x32 = x.float()
    ss = shard.sum_model(shard.to_model(torch.sum(x32 * x32, dim=-1, keepdim=True)), tag="norm")
    out = x32 * torch.rsqrt(ss / width + eps)
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


def leaf(m: nn.Module, name: str) -> torch.Tensor:
    """``m``'s parameter ``name``, gathered over the data axes (FSDP) when
    ``m`` is bound to a shard context."""
    w = getattr(m, name)
    return w if m.shard is None else m.shard.fsdp(w, m.specs[name])


def linear_weight(d_in: int, d_out: int, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(d_in, d_out, dtype=dtype, device=device))


class _MatmulF32(torch.autograd.Function):
    """``x @ w`` of 16-bit operands on the card with the GEMM's f32
    accumulator as its output (``torch.mm(out_dtype=)``, which has no
    derivative of its own); the backward multiplies in the operands' dtype,
    as the backward of ``x @ w`` does."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        gx = g @ w.T if ctx.needs_input_grad[0] else None
        gw = (x.reshape(-1, x.shape[-1]).T @ g.reshape(-1, g.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return gx, gw


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in f32: the f32 accumulator of the operands' GEMM. On the
    CPU, whose GEMM has no f32 output for 16-bit operands, the operands
    are widened (their products are exact in f32: the same sum)."""
    if x.dtype == torch.float32:
        return x @ w
    if x.device.type == "cpu":
        return x.float() @ w.float()
    return _MatmulF32.apply(x, w)


def row_parallel(x: torch.Tensor, w: torch.Tensor, shard) -> torch.Tensor:
    """``x @ w`` for this rank's input rows ``w``: the partial product in
    f32 (``matmul_f32``), summed over 'model' in rank order, in ``x``'s
    dtype."""
    return shard.sum_model(matmul_f32(x, w), out_dtype=x.dtype)


class MLP(nn.Module):
    """``swiglu``: ``down(silu(x @ gate) * (x @ up))``; ``relu2``
    (nemotron/minitron): ``down(relu(x @ up) ** 2)``. Bound to a shard
    context, the hidden features are this rank's (``d_ff / tp``), or all of
    them where the model axis does not divide d_ff (``split`` False)."""

    shard = None

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

    @property
    def split(self) -> bool:
        """Sharded, whether the hidden features are split over 'model'."""
        return self.shard.split(self.specs["w_up"], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sh = self.shard
        if sh is None or not self.split:
            w = lambda name: leaf(self, name)
            if self.kind == "swiglu":
                return (F.silu(x @ w("w_gate")) * (x @ w("w_up"))) @ w("w_down")
            return torch.square(F.relu(x @ w("w_up"))) @ w("w_down")
        return sh.sum_model(self.partial(sh.to_model(x)), out_dtype=x.dtype)

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """Sharded: this rank's f32 partial of the output (its hidden
        features through its ``w_down`` rows, ``matmul_f32``), before the
        sum over 'model'; ``x`` has passed ``to_model``."""
        w = lambda name: leaf(self, name)
        if self.kind == "swiglu":
            h = F.silu(x @ w("w_gate")) * (x @ w("w_up"))
        else:
            h = torch.square(F.relu(x @ w("w_up")))
        return matmul_f32(h, w("w_down"))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over tokens; f32 logsumexp."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)
