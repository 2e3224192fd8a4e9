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
``flash_attention`` (on the wgmma route it also keeps each query row's
softmax statistics, ``return_stats``); its backward launches
``flash_attention_bwd_cuda`` on CUDA tensors, through the route
``flash_bwd_route`` gives (``csrc/flash_attention_bwd_wgmma.cu``, fed by
those statistics, or ``csrc/flash_attention_bwd.cu``), and runs autograd
through ``flash_attention_plain`` on CPU tensors
(``flash_attention_bwd_plain``). The reference has no backward kernel (its
docstring names a ``jax.custom_vjp``, but the code has none; ``jax.grad``
differentiates its XLA route), so the backward kernels replace no Pallas
kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

HEAD_DIMS = (32, 64, 80, 128, 256)
_NEG = -1e30
LOG2E = 1.4426950408889634


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
                          softcap: float = 0.0, return_stats: bool = False):
    """The plain torch version: dense f32 scores, (B, H, S, hd) in q's dtype.

    With ``return_stats``, ``(out, stats)``: stats (2, B, H, S) f32 holds
    each query row's softmax statistics as the wgmma forward writes them,
    the max m of its masked scores in log2 units (score * log2(e); exactly
    -1e30 for a row with no allowed key) and 1 / l, l = sum_j exp(x_j - max):
    the row's logsumexp is m ln 2 - log(1 / l)."""
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
    out = torch.einsum("bhst,bhtd->bhsd", probs, vf).to(q.dtype)
    if not return_stats:
        return out
    m = scores.amax(dim=-1)
    inv_l = 1.0 / torch.exp(scores - m[..., None]).sum(dim=-1)
    return out, torch.stack((torch.where(m == _NEG, m, m * LOG2E), inv_l))


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernel can read it as is (hd contiguous, the
    (B, H, S) strides and the base address in whole 16-byte vectors), else
    a contiguous copy."""
    item = t.element_size()
    if (t.stride(3) == 1 and all(st * item % 16 == 0 for st in t.stride()[:3])
            and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous()


# The CUDA entry point of each route (csrc/flash_attention.cu). 'scalar_bf16'
# serves no dtype and head_dim of ``flash_route`` any more: it stays callable
# through ``_launch`` at every head_dim, for a side-by-side timing against
# the wgmma route at hd 256; 'mma' likewise at hd 64, 80 and 128.
ROUTES = {"wgmma": "flash_attention_wgmma_bf16", "mma": "flash_attention_mma_bf16",
          "scalar_bf16": "flash_attention_scalar_bf16", "scalar_f32": "flash_attention_f32"}


def flash_route(dtype, hd: int) -> str:
    """The kernel that serves ``dtype`` at head_dim ``hd``: ``'wgmma'``
    (bf16 at 64, 80, 128 and 256), ``'mma'`` (bf16 at 32; callable at 64,
    80 and 128 through ``_launch(ROUTES["mma"], ...)``, for a side-by-side
    timing) or ``'scalar_f32'`` (f32 at every head_dim)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if dtype == torch.float32:
        return "scalar_f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: kernel runs in float32 or bfloat16, got {dtype}")
    return "mma" if hd == 32 else "wgmma"


def stats_rows(s: int) -> int:
    """Rows of each (b, h) in the statistics buffer: S padded to whole
    128-row tiles (``stats_rows`` in csrc/flash_hopper.cuh)."""
    return -(-s // 128) * 128


def _launch(entry: str, q, k, v, causal: bool, window: int, softcap: float,
            stats=None) -> torch.Tensor:
    """Check the operands and launch the C entry point ``entry`` on them;
    ``stats`` (wgmma route only) is a (2, B, H, stats_rows(S)) f32 buffer
    that receives the row statistics."""
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
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if stats is None else stats.data_ptr(), b, h, hkv, s, t_len, hd, strides,
                 int(causal), int(window), float(softcap), float(hd ** -0.5),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, entry)
    return out


def flash_attention_cuda(q, k, v, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, return_stats: bool = False):
    """Launch the flash-attention kernel on CUDA tensors: (B, H, S, hd),
    through the route ``flash_route`` gives for q's dtype and head_dim.

    The output has q's strides where q is dense (for the model's
    (B, S, H, hd) projections seen as (B, H, S, hd), a (B, S, H, hd)
    buffer), so no transpose is copied on either side. With
    ``return_stats`` (the wgmma route only), ``(out, stats)`` with the row
    statistics of ``flash_attention_plain(..., return_stats=True)``: a
    (2, B, H, S) view of the kernel's padded buffer, which the backward's
    wgmma route reads as it is."""
    _check_shapes(q, k, v)
    route = flash_route(q.dtype, q.shape[3])
    stats = None
    if return_stats:
        if route != "wgmma":
            raise ValueError(f"flash_attention: the row statistics come from the wgmma route "
                             f"(bf16 at head_dim 64, 80, 128 or 256), not {route}")
        b, h, s = q.shape[:3]
        stats = torch.empty(2, b, h, stats_rows(s), dtype=torch.float32, device=q.device)
    out = _launch(ROUTES[route], q, k, v, causal, window, softcap, stats)
    if out.numel():
        _build.LAUNCHES["flash_attention"] += 1
    return out if stats is None else (out, stats[..., :q.shape[2]])


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


def flash_bwd_route(dtype, hd: int) -> str:
    """The backward kernels that serve ``dtype`` at head_dim ``hd``:
    ``'wgmma'`` (bf16 at 64, 80, 128 and 256:
    csrc/flash_attention_bwd_wgmma.cu, fed by the forward's row statistics)
    or ``'scalar'`` (f32 at every head_dim, bf16 at 32:
    csrc/flash_attention_bwd.cu; callable at every head_dim through
    ``_bwd_launch("scalar", ...)``, for a side-by-side timing). Raises for
    any other dtype or head_dim."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {hd} not in {HEAD_DIMS}")
    if dtype == torch.float32:
        return "scalar"
    if dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_bwd: kernels run in float32 or bfloat16, got {dtype}")
    return "scalar" if hd == 32 else "wgmma"


def _kernel_stats(stats, b: int, h: int, s: int, device) -> torch.Tensor:
    """The row statistics in the kernel's padded (2, B, H, stats_rows(S))
    layout: the forward's own buffer as it is, anything else copied."""
    if tuple(stats.shape) != (2, b, h, s) or stats.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: stats {tuple(stats.shape)} {stats.dtype} must "
                         f"be float32 of shape {(2, b, h, s)}")
    if stats.device != device:
        raise ValueError(f"flash_attention_bwd: stats on {stats.device}, q on {device}")
    r = stats_rows(s)
    full = (stats.stride() == (b * h * r, h * r, r, 1) and stats.data_ptr() % 16 == 0
            and stats.untyped_storage().nbytes() >= (stats.storage_offset() + 2 * b * h * r) * 4)
    if full:
        return stats
    buf = torch.empty(2, b, h, r, dtype=torch.float32, device=device)
    buf[..., :s] = stats
    return buf


def _bwd_launch(route: str, q, k, v, do, causal: bool, window: int, softcap: float,
                stats=None):
    """Launch the backward kernels of ``route`` (uncounted); the wgmma route
    reads ``stats``. Returns ``(dq, dk, dv)``."""
    b, h, s, hd = q.shape
    hkv, t_len = k.shape[1], k.shape[2]
    q, k, v, do = (_kernel_ready(x) for x in (q, k, v, do))
    dq, dk, dv = (_kernel_ready(torch.empty_like(x)) for x in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    tensors = (q, k, v, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 21)(*(st for x in tensors for st in x.stride()[:3]))
    if route == "wgmma":
        stats = _kernel_stats(stats, b, h, s, q.device)
        scratch = (stats, torch.empty(b * h * stats_rows(s), dtype=torch.float32,
                                      device=q.device))
        entry, lib = "flash_attention_bwd_wgmma_bf16", "flash_attention_bwd_wgmma"
    else:
        scratch = (torch.empty(3 * b * h * s, dtype=torch.float32, device=q.device),)
        entry = f"flash_attention_bwd_{'f32' if q.dtype == torch.float32 else 'bf16'}"
        lib = "flash_attention_bwd"
    fn = getattr(_build.load(lib), entry)
    with torch.cuda.device(q.device):
        err = fn(*(x.data_ptr() for x in tensors + scratch), b, h, hkv, s, t_len, hd, strides,
                 int(causal), int(window), float(softcap), float(hd ** -0.5),
                 torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, entry)
    return dq, dk, dv


def flash_attention_bwd_cuda(q, k, v, do, causal: bool = True, window: int = 0,
                             softcap: float = 0.0, stats=None):
    """Launch the backward kernels on CUDA tensors: ``(dq, dk, dv)`` of
    ``flash_attention(q, k, v)`` under the cotangent ``do``, each in the
    inputs' dtype (f32 or bf16, every hd in ``HEAD_DIMS``), through the
    route ``flash_bwd_route`` gives. Any strides with hd contiguous;
    gradients come back with their input's strides where it is dense.

    The wgmma route reads the forward's row statistics ``stats``
    (``flash_attention_cuda(..., return_stats=True)``, or the plain
    version's); without them it runs that forward first (one more forward
    launch). The scalar route recomputes them itself and ignores ``stats``.
    The forward's output is not an input."""
    _check_shapes(q, k, v)
    route = flash_bwd_route(q.dtype, q.shape[3])
    if do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: do {tuple(do.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("do", do)):
        if not x.is_cuda or x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd: {name} ({x.dtype} on {x.device}) is not a "
                             f"{q.dtype} tensor on q's CUDA device")
    if k.shape[2] == 0 and q.numel():
        raise ValueError("flash_attention_bwd: no keys (T = 0)")
    if route == "wgmma" and stats is None and q.numel():
        stats = flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap,
                                     return_stats=True)[1]
    grads = _bwd_launch(route, q, k, v, do, causal, window, softcap, stats)
    if q.numel():
        _build.LAUNCHES["flash_attention_bwd"] += 1
    return grads


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: ``FlashAttention.apply(q, k, v,
    causal, window, softcap)``. The forward is ``flash_attention`` (the
    kernel on CUDA, the plain version on CPU), and keeps the row statistics
    where the backward's route reads them; the backward launches the
    backward kernels on CUDA and differentiates the plain version on CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=0, softcap=0.0):
        ctx.mask = (causal, window, softcap)
        stats = None
        if q.is_cuda and flash_bwd_route(q.dtype, q.shape[3]) == "wgmma":
            out, stats = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                              softcap=softcap, return_stats=True)
        else:
            out = flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, stats)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, stats = ctx.saved_tensors
        if q.is_cuda:
            grads = flash_attention_bwd_cuda(q, k, v, do, *ctx.mask, stats=stats)
        else:
            grads = flash_attention_bwd_plain(q, k, v, do, *ctx.mask)
        return (*grads, None, None, None)
