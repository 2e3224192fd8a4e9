"""Flash attention: the forward and backward CUDA kernels, their plain
versions, and the autograd.Function that joins them.

``flash_attention`` is the counterpart of ``flash_attention``
(src/repro/kernels/flash_attention.py): q (B, H, S, hd), k and v
(B, Hkv, T, hd) with Hkv | H -> (B, H, S, hd) in q's dtype, causal and
sliding-window masks with both positions counted from 0 (top-left aligned),
a score softcap applied before the mask, and the -1e30 mask value of the
reference, so a row with no allowed key averages V. On CUDA tensors it
launches ``csrc/flash_attention.cu``; on CPU tensors it runs
``flash_attention_plain``, the counterpart of
``repro.kernels.flash_ref.flash_attention_ref``. Query head h uses KV head
``h // (H // Hkv)``, as ``repro.models.attention._expand_kv`` repeats them.
f32 and bf16; hd in {32, 64, 80, 128, 256}; any S and T. ``flash_route``
picks the kernel by dtype and head_dim (the table in the CUDA source).

``FlashAttention`` is the differentiable form, for training: its forward is
``flash_attention``; its backward launches ``csrc/flash_attention_bwd.cu``
(``flash_attention_bwd_cuda``) on CUDA tensors and runs autograd through
``flash_attention_plain`` on CPU tensors (``flash_attention_bwd_plain``).
The reference has no backward kernel (its docstring names a
``jax.custom_vjp``, but the code has none; ``jax.grad`` differentiates its
XLA route), so the backward kernel replaces no Pallas kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = (32, 64, 80, 128, 256)
_NEG = -1e30


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: expected q (B, H, S, hd) and k, v (B, Hkv, T, hd)")
    b, h, _, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} do not match")
    if k.shape[1] == 0 or h % k.shape[1]:
        raise ValueError(f"flash_attention: {k.shape[1]} KV heads do not divide {h} heads")


def flash_attention_plain(q, k, v, causal: bool = True, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """The plain torch version: dense f32 scores, (B, H, S, hd) in q's dtype."""
    _check_shapes(q, k, v)
    s, hd = q.shape[2], q.shape[3]
    t = k.shape[2]
    n_rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(n_rep, dim=1) if n_rep > 1 else k.float()
    vf = v.float().repeat_interleave(n_rep, dim=1) if n_rep > 1 else v.float()
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), kf) * (hd ** -0.5)
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    dist = (torch.arange(s, device=q.device)[:, None]
            - torch.arange(t, device=q.device)[None, :])
    allow = torch.ones(s, t, dtype=torch.bool, device=q.device)
    if causal:
        allow &= dist >= 0
    if window > 0:
        allow &= dist < window
    scores = scores.masked_fill(~allow, _NEG)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, vf).to(q.dtype)


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernel can read it as is (hd contiguous, the
    (B, H, S) strides and the base address in whole 16-byte vectors), else
    a contiguous copy."""
    item = t.element_size()
    if (t.stride(3) == 1 and all(st * item % 16 == 0 for st in t.stride()[:3])
            and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous()


# The CUDA entry point of each route (csrc/flash_attention.cu).
ROUTES = {"wgmma": "flash_attention_wgmma_bf16", "mma": "flash_attention_mma_bf16",
          "scalar_bf16": "flash_attention_scalar_bf16", "scalar_f32": "flash_attention_f32"}


def flash_route(dtype, hd: int) -> str:
    """The kernel that serves ``dtype`` at head_dim ``hd``: ``'wgmma'``
    (bf16 at 64 and 128), ``'mma'`` (bf16 at 32 and 80), ``'scalar_bf16'``
    (bf16 at 256) or ``'scalar_f32'`` (f32 at every head_dim)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if dtype == torch.float32:
        return "scalar_f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: kernel runs in float32 or bfloat16, got {dtype}")
    if hd in (64, 128):
        return "wgmma"
    return "mma" if hd in (32, 80) else "scalar_bf16"


def _launch(entry: str, q, k, v, causal: bool, window: int, softcap: float) -> torch.Tensor:
    """Check the operands and launch the C entry point ``entry`` on them."""
    _check_shapes(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} is not a CUDA tensor")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} has dtype {t.dtype}, expected {q.dtype}")
        if t.device != q.device:
            raise ValueError("flash_attention: operands on several devices")
    b, h, s, hd = q.shape
    hkv, t_len = k.shape[1], k.shape[2]
    q, k, v = _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if t_len == 0:
        raise ValueError("flash_attention: no keys (T = 0)")
    out = _kernel_ready(out)
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
    fn = getattr(_build.load("flash_attention"), entry)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, hkv, s, t_len,
                 hd, strides, int(causal), int(window), float(softcap), float(hd ** -0.5),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, entry)
    return out


def flash_attention_cuda(q, k, v, causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """Launch the flash-attention kernel on CUDA tensors: (B, H, S, hd),
    through the route ``flash_route`` gives for q's dtype and head_dim.

    The output has q's strides where q is dense (for the model's
    (B, S, H, hd) projections seen as (B, H, S, hd), a (B, S, H, hd)
    buffer), so no transpose is copied on either side."""
    _check_shapes(q, k, v)
    route = flash_route(q.dtype, q.shape[3])
    out = _launch(ROUTES[route], q, k, v, causal, window, softcap)
    if out.numel():
        _build.LAUNCHES["flash_attention"] += 1
    return out


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """(B, H, S, hd) attention: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap)
    return flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap)


def flash_attention_bwd_plain(q, k, v, do, causal: bool = True, window: int = 0,
                              softcap: float = 0.0):
    """``(dq, dk, dv)``: autograd through ``flash_attention_plain`` with
    cotangent ``do``, each in its input's dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = flash_attention_plain(*leaves, causal=causal, window=window, softcap=softcap)
        return torch.autograd.grad(out, leaves, do)


def flash_attention_bwd_cuda(q, k, v, do, causal: bool = True, window: int = 0,
                             softcap: float = 0.0):
    """Launch the backward kernels on CUDA tensors: ``(dq, dk, dv)`` of
    ``flash_attention(q, k, v)`` under the cotangent ``do``, each in the
    inputs' dtype (f32 or bf16, every hd in ``HEAD_DIMS``). Any strides with
    hd contiguous; gradients come back with their input's strides where it
    is dense. The kernels recompute the softmax statistics themselves, so
    the forward's output is not an input."""
    _check_shapes(q, k, v)
    b, h, s, hd = q.shape
    hkv, t_len = k.shape[1], k.shape[2]
    flash_route(q.dtype, hd)  # raises for a dtype or head_dim the kernels do not take
    if do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: do {tuple(do.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        if not x.is_cuda or x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: {name} ({x.dtype} on {x.device}) is not a "
                             f"{q.dtype} tensor on q's CUDA device")
    if t_len == 0 and q.numel():
        raise ValueError("flash_attention_bwd: no keys (T = 0)")
    q, k, v, do = (_kernel_ready(x) for x in (q, k, v, do))
    dq, dk, dv = (_kernel_ready(torch.empty_like(x)) for x in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    stats = torch.empty(3 * b * h * s, dtype=torch.float32, device=q.device)
    tensors = (q, k, v, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 21)(*(st for x in tensors for st in x.stride()[:3]))
    entry = "flash_attention_bwd_f32" if q.dtype == torch.float32 else "flash_attention_bwd_bf16"
    fn = getattr(_build.load("flash_attention_bwd"), entry)
    with torch.cuda.device(q.device):
        err = fn(*(x.data_ptr() for x in tensors), stats.data_ptr(), b, h, hkv, s, t_len, hd,
                 strides, int(causal), int(window), float(softcap), float(hd ** -0.5),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, entry)
    _build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: ``FlashAttention.apply(q, k, v,
    causal, window, softcap)``. The forward is ``flash_attention`` (the
    kernel on CUDA, the plain version on CPU); the backward launches the
    backward kernel on CUDA and differentiates the plain version on CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=0, softcap=0.0):
        ctx.save_for_backward(q, k, v)
        ctx.mask = (causal, window, softcap)
        return flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        if q.is_cuda:
            grads = flash_attention_bwd_cuda(q, k, v, do, *ctx.mask)
        else:
            grads = flash_attention_bwd_plain(q, k, v, do, *ctx.mask)
        return (*grads, None, None, None)
