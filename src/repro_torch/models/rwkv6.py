"""RWKV-6 "Finch" block: a linear recurrence with a data-dependent decay per
channel. The counterpart of ``repro.models.rwkv6``.

Per head (key dim K, value dim V):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(wlog_t)) from a LoRA of the token-shifted input.

The time mix runs in chunks of ``_CHUNK`` = 16 steps (the reference's
default), exactly: inside a chunk the decay enters only as exp(c_{t-1} -
c_s) for s < t, which is at most 1. The (Q, Q, K) decay tensor is formed
once per chunk, with the strict causal mask applied before the ``exp``,
and reduced over K (with r and k) before the product with v; the factored
r exp(c), k exp(-c) form, which overflows for strong decay, is not used.
As in ``ssm.py``, every chunk's state-free terms are evaluated at once and
only the carry ``S = contrib + exp(c_last) S`` loops over chunks. The
reference's ``REPRO_RWKV_CHUNK`` switch is not carried over.

Bound to a shard context (``sharding.placement``), a layer runs the
reference's layout over a mesh's 'model' axis:

* the time mix's ``wr``, ``wk``, ``wv``, ``wg`` and ``w_lora_b`` give this
  rank's channels (the channel order is head-major, (H, K); where the model
  axis does not divide the heads a rank's block holds part of a head);
  for ``s > 1`` r, k, v, the log-decay and g pass an all-to-all over
  'model' from channels to rows (``all_to_all:wkv``), the reference's
  ``FULL_BATCH`` constraint (``rwkv6.py:113-123``): the rank then holds
  rows / tp rows at every channel, so every head whole, runs the chunk
  scan, the norm over all of H K and the gate on them as on a whole model,
  and the product returns by the inverse all-to-all to the row-parallel
  ``wo``; the final state passes it too (heads over 'model', the cache's
  layout) where the axis divides the heads, and is all-gathered over the
  rows where it does not (``cache_specs`` keeps it whole). Where the rows
  do not divide over 'model' the scan is replicated over it (r, k, v and
  the log-decay all-gathered over the channels; the rank keeps its own
  channels, and its heads of the state where they are whole). Decode runs
  on the rank's heads, the norm's sum of squares summed over 'model'; where
  its channels are not whole heads it all-gathers r, k, v and the decay
  over the channels and steps every head (the state is whole there);
* the channel mix's ``w_cm_r`` and ``w_cm_1`` are column-parallel and
  ``w_cm_2`` row-parallel: its f32 partial products are reduce-scattered
  over 'model' along D (summed in f32, rounded once, as
  ``layers.row_parallel`` keeps a GEMM's accumulator), multiplied by this
  rank's D-block of the receptance, and the product all-gathered;
* the decode cache's ``last1`` / ``last2`` hold this rank's block of D,
  all-gathered where a step reads the whole token;
* every column-parallel product (``wr``, ``wk``, ``wv``, ``wg``,
  ``w_lora_b``, ``w_cm_r``, ``w_cm_1``) reads its input through
  ``to_model``, as ``ssm.py`` and the attention do, so that the input's
  gradient is summed over 'model' there: each mix then has its whole
  gradient on every rank, and ``mu``, ``mu_cm`` and ``w_lora_a`` theirs;
* the leaves a rank reads whole but computes only part of the gradient of
  (``w_base`` at this rank's channels, ``u_bonus`` and ``ln_out`` in the
  region) enter through ``ShardContext.partial_leaves``, whose backward
  sums their gradients over 'model' once;
* a leaf the rules replicate over 'model' (H K, D or d_ff that the axis
  does not divide) is used whole: the time mix runs whole on every rank
  where H K does not divide, the channel mix's hidden features where d_ff
  does not (its product then not summed over 'model'), its receptance and
  the last tokens where D does not; a whole leaf's input does not pass
  ``to_model``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (dense_init_, leaf, linear_weight, matmul_f32, rms_norm, rms_norm_split,
                     row_parallel)
from .ssm import _carry, _pad_seq

_CHUNK = 16
_LORA = 64


class RWKV6(nn.Module):
    """The reference's leaves: time mix ``mu`` (5, d) (the r, k, v, g, w
    shifts), ``wr``, ``wk``, ``wv``, ``wg`` (d, H K), ``w_base`` (H K,) f32,
    ``w_lora_a`` (d, 64), ``w_lora_b`` (64, H K), ``u_bonus`` (H, K) f32,
    ``ln_out`` (H K,) f32, ``wo`` (H K, d); channel mix ``mu_cm`` (2, d),
    ``w_cm_r`` (d, d), ``w_cm_1`` (d, d_ff), ``w_cm_2`` (d_ff, d). The
    matrices and the shifts take ``dtype``."""

    shard = None

    def __init__(self, cfg, *, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d, hk = cfg.d_model, cfg.n_heads * cfg.head_dim
        f32 = lambda *shape: nn.Parameter(torch.empty(*shape, dtype=torch.float32,
                                                      device=device))
        self.mu = nn.Parameter(torch.empty(5, d, dtype=dtype, device=device))
        self.wr = linear_weight(d, hk, dtype, device)
        self.wk = linear_weight(d, hk, dtype, device)
        self.wv = linear_weight(d, hk, dtype, device)
        self.wg = linear_weight(d, hk, dtype, device)
        self.w_base = f32(hk)
        self.w_lora_a = linear_weight(d, _LORA, dtype, device)
        self.w_lora_b = linear_weight(_LORA, hk, dtype, device)
        self.u_bonus = f32(cfg.n_heads, cfg.head_dim)
        self.ln_out = f32(hk)
        self.wo = linear_weight(hk, d, dtype, device)
        self.mu_cm = nn.Parameter(torch.empty(2, d, dtype=dtype, device=device))
        self.w_cm_r = linear_weight(d, d, dtype, device)
        self.w_cm_1 = linear_weight(d, cfg.d_ff, dtype, device)
        self.w_cm_2 = linear_weight(cfg.d_ff, d, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's ``rwkv6_init``: shifts 0.5, ``w_base`` -0.6,
        dense draws (``w_lora_b`` at 0.01, ``wo`` at ``(H K) ** -0.5``,
        ``w_cm_2`` at ``d_ff ** -0.5``), ``u_bonus`` and ``ln_out`` zero."""
        for w in (self.wr, self.wk, self.wv, self.wg, self.w_lora_a):
            dense_init_(w, generator)
        dense_init_(self.w_lora_b, generator, scale=0.01)
        dense_init_(self.wo, generator, scale=self.wo.shape[0] ** -0.5)
        dense_init_(self.w_cm_r, generator)
        dense_init_(self.w_cm_1, generator)
        dense_init_(self.w_cm_2, generator, scale=self.w_cm_2.shape[0] ** -0.5)
        with torch.no_grad():
            self.mu.fill_(0.5)
            self.mu_cm.fill_(0.5)
            self.w_base.fill_(-0.6)
            self.u_bonus.zero_()
            self.ln_out.zero_()


def _token_shift(x: torch.Tensor, last: torch.Tensor | None = None) -> torch.Tensor:
    """Previous-token features; ``last`` (B, 1, D) carries across calls."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _wkv_chunks(r, k, v, logw, u, state):
    """Every WKV chunk: the reference's ``_wkv_chunk`` scanned over chunks.

    r, k, v (B, C, Q, H, K) in the model dtype, logw (B, C, Q, H, K) f32,
    u (H, K) f32, state (B, H, K, V) f32. Returns (y (B, C, Q, H, V) f32,
    the final state)."""
    q = r.shape[2]
    rf, kf, vf = (t.float().transpose(2, 3) for t in (r, k, v))    # (B, C, H, Q, K)
    clog = torch.cumsum(logw, dim=2).transpose(2, 3)                # (B, C, H, Q, K)
    cshift = F.pad(clog, (0, 0, 1, 0))[..., :q, :]                  # clog_{t-1}
    # intra: A[t, s] = sum_K r_t exp(c_{t-1} - c_s) k_s   (strictly s < t)
    below = torch.ones(q, q, dtype=torch.bool, device=r.device).tril(-1)
    dten = torch.exp((cshift[..., :, None, :] - clog[..., None, :, :])
                     .masked_fill(~below[..., None], float("-inf")))  # (B, C, H, Q, Q, K) t, s
    amat = torch.einsum("bchtsk,bchsk->bchts", dten * rf[..., :, None, :], kf)
    y = amat @ vf
    # diagonal u-bonus: y_t += (r_t . (u * k_t)) v_t
    y = y + (rf * u[:, None, :] * kf).sum(-1, keepdim=True) * vf
    # each chunk's own contribution to the state it passes on
    contrib = (kf * torch.exp(clog[..., -1:, :] - clog)).transpose(-1, -2) @ vf
    s_prev, state = _carry(contrib, torch.exp(clog[..., -1, :])[..., None], state)
    # inter: y_t += (r_t * exp(c_{t-1})) S_prev
    y = y + (rf * torch.exp(cshift)) @ s_prev
    return y.transpose(2, 3), state


def _heads(x: torch.Tensor, h: int, hk: int) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1], h, hk)


def _col(m: RWKV6):
    """``col(t, name)``: ``t @ w`` for the column-parallel leaf ``name`` of
    ``m``: the module's own (whole), this rank's columns with ``t`` read
    through ``to_model`` (sharded: its gradient summed over 'model'), or,
    where the rules replicate the leaf over 'model', the whole leaf on
    ``t`` as it is."""
    return lambda t, name: (m.shard.to_model(t) if _split(m, name) else t) @ leaf(m, name)


def _split(m: RWKV6, name: str = "wr") -> bool:
    """Whether the leaf ``name`` is split over 'model' (sharded): ``wr``
    for the time mix's H K, ``w_cm_r`` for D, ``w_cm_1`` for d_ff."""
    return m.shard is not None and m.shard.split(m.specs[name], 1)


def _last(m: RWKV6, x: torch.Tensor) -> torch.Tensor:
    """The last token of ``x`` as the decode cache holds it: this rank's
    block of D where D is split over 'model'."""
    return m.shard.channels(x[:, -1:]) if _split(m, "w_cm_r") else x[:, -1:]


def _wkv_region(cfg, r, k, v, logw, u, ln_out, state=None):
    """The chunk scan and the gated norm's norm: r, k, v, logw (R, S, H, K)
    at every head -> (rms_norm(y) (R, S, H K) in r's dtype, the final WKV
    state (R, H, K, K) f32)."""
    b, s, h, hk = r.shape
    if state is None:
        state = torch.zeros(b, h, hk, hk, dtype=torch.float32, device=r.device)
    q = min(_CHUNK, s)
    pad = (-s) % q
    if pad:
        # zero k (no state additions) + zero logw (no decay): padded steps
        # are exact no-ops on the recurrence.
        r, k, v, logw = (_pad_seq(a, pad) for a in (r, k, v, logw))
    nc = (s + pad) // q
    chunked = lambda a: a.reshape((b, nc, q) + a.shape[2:])
    y, state = _wkv_chunks(chunked(r), chunked(k), chunked(v), chunked(logw), u, state)
    y = y.reshape(b, s + pad, h * hk)[:, :s].to(r.dtype)
    return rms_norm(y, ln_out, cfg.norm_eps), state


def rwkv6_time_mix(m: RWKV6, x: torch.Tensor, state: torch.Tensor | None = None,
                   last_tok: torch.Tensor | None = None):
    """x (B, S, D) -> (y (B, S, D), final WKV state (B, H, K, K) f32, the
    last input token (B, 1, D)); sharded, the state's heads and the last
    token's D are this rank's blocks where the model axis divides them."""
    if _split(m):
        if state is not None or last_tok is not None:
            raise ValueError("a sharded rwkv6 prefill starts from the zero state")
        return _time_mix_sharded(m, x)
    cfg, col = m.cfg, _col(m)
    h, hk = cfg.n_heads, cfg.head_dim
    xs = _token_shift(x, last_tok)
    mix = lambda i: x + m.mu[i] * (xs - x)
    r = _heads(col(mix(0), "wr"), h, hk)
    k = _heads(col(mix(1), "wk"), h, hk)
    v = _heads(col(mix(2), "wv"), h, hk)
    g = F.silu(col(mix(3), "wg"))
    wlog = m.w_base + col(torch.tanh(mix(4) @ leaf(m, "w_lora_a")), "w_lora_b").float()
    logw = _heads(-torch.exp(wlog), h, hk)                          # (B, S, H, K) < 0
    y, state = _wkv_region(cfg, r, k, v, logw, m.u_bonus, m.ln_out, state)
    out = (y * g) @ leaf(m, "wo")
    return out, state, (x[:, -1:] if m.shard is None else _last(m, x))


def _time_mix_sharded(m: RWKV6, x: torch.Tensor):
    """The time mix on this rank's shards (the module docstring)."""
    cfg, sh = m.cfg, m.shard
    b, s, _ = x.shape
    h, hk = cfg.n_heads, cfg.head_dim
    heads = h % sh.tp == 0
    col = _col(m)
    w_base, u, ln_out = sh.partial_leaves(m.w_base, m.u_bonus, m.ln_out, tag="wkv")
    xs = _token_shift(x)
    mix = lambda i: x + m.mu[i] * (xs - x)
    r = col(mix(0), "wr")                                           # (B, S, H K / tp)
    k = col(mix(1), "wk")
    v = col(mix(2), "wv")
    g = F.silu(col(mix(3), "wg"))
    lora = torch.tanh(mix(4) @ sh.fsdp(m.w_lora_a, m.specs["w_lora_a"]))
    logw = -torch.exp(sh.channels(w_base) + col(lora, "w_lora_b").float())
    if sh.full_batch(b):
        r, k, v, logw, g = (sh.exchange(t, 0, 2, "wkv") for t in (r, k, v, logw, g))
        y, state = _wkv_region(cfg, *(_heads(t, h, hk) for t in (r, k, v, logw)), u, ln_out)
        y = sh.exchange(y * g, 2, 0, "wkv")                         # (B, S, H K / tp)
        state = sh.exchange(state, 1, 0, "wkv") if heads else sh.gather_model(state, 0)
    else:
        r, k, v, logw = (_heads(sh.gather_model(t, 2), h, hk) for t in (r, k, v, logw))
        y, state = _wkv_region(cfg, r, k, v, logw, u, ln_out)
        y, state = sh.channels(y) * g, (sh.channels(state, 1) if heads else state)
    return row_parallel(y, sh.fsdp(m.wo, m.specs["wo"]), sh), state, _last(m, x)


def rwkv6_time_mix_decode(m: RWKV6, x: torch.Tensor, state: torch.Tensor,
                          last_tok: torch.Tensor):
    """One-token step: x (B, 1, D). Returns (y, new state, new last token);
    sharded, the state's heads and the last token's D are this rank's
    where the model axis divides them."""
    cfg, sh = m.cfg, m.shard
    b = x.shape[0]
    hk = cfg.head_dim
    col = _col(m)
    split = _split(m)
    heads = split and cfg.n_heads % sh.tp == 0
    w_base, u, ln_out, new_last = m.w_base, m.u_bonus, m.ln_out, x
    if sh is not None and _split(m, "w_cm_r"):
        last_tok = sh.gather_replicated(last_tok, -1)
        new_last = sh.channels(x)
    if split:
        w_base, u, ln_out = sh.partial_leaves(w_base, u, ln_out, tag="wkv")
        w_base = sh.channels(w_base)
    if heads:
        u, ln_out = sh.channels(u, 0), sh.channels(ln_out)
    mix = lambda i: x + m.mu[i] * (last_tok - x)
    r, k, v = (col(mix(i), name) for i, name in enumerate(("wr", "wk", "wv")))
    g = F.silu(col(mix(3), "wg"))
    wlog = w_base + col(torch.tanh(mix(4) @ leaf(m, "w_lora_a")), "w_lora_b").float()
    if split and not heads:
        r, k, v, wlog = (sh.gather_model(t, -1) for t in (r, k, v, wlog))
    r, k, v = (t.reshape(b, -1, hk) for t in (r, k, v))            # (B, H, K)
    w_ = torch.exp(-torch.exp(wlog)).reshape(b, -1, hk)

    kv = torch.einsum("bhk,bhv->bhkv", k.float(), v.float())
    y = torch.einsum("bhk,bhkv->bhv", r.float(), state + u[None, :, :, None] * kv)
    state = w_[..., None] * state + kv
    y = y.reshape(b, 1, -1).to(x.dtype)
    if not split:
        return (rms_norm(y, ln_out, cfg.norm_eps) * g) @ leaf(m, "wo"), state, new_last
    if heads:
        y = rms_norm_split(y, ln_out, cfg.norm_eps, sh, cfg.n_heads * hk)
    else:
        y = sh.channels(rms_norm(y, ln_out, cfg.norm_eps))
    return row_parallel(y * g, leaf(m, "wo"), sh), state, new_last


def rwkv6_channel_mix(m: RWKV6, x: torch.Tensor, last_tok: torch.Tensor | None = None):
    """x (B, S, D) -> (y (B, S, D), the last input token (B, 1, D));
    sharded, ``last_tok`` and the returned token are this rank's block of
    D where the model axis divides D."""
    sh = m.shard
    col = _col(m)
    dsplit = _split(m, "w_cm_r")
    if dsplit and last_tok is not None:
        last_tok = sh.gather_replicated(last_tok, -1)
    xs = _token_shift(x, last_tok)
    xk = x + m.mu_cm[0] * (xs - x)
    xr = x + m.mu_cm[1] * (xs - x)
    r = torch.sigmoid(col(xr, "w_cm_r"))
    kk = torch.square(F.relu(col(xk, "w_cm_1")))
    if sh is None:
        return r * (kk @ m.w_cm_2), x[:, -1:]
    w2 = sh.fsdp(m.w_cm_2, m.specs["w_cm_2"])
    if not _split(m, "w_cm_1"):             # d_ff whole on every rank: no sum
        out = (sh.gather_replicated(r, -1) if dsplit else r) * (kk @ w2)
    elif dsplit:
        out = sh.gather_replicated(
            r * sh.scatter_model(matmul_f32(kk, w2), -1, out_dtype=x.dtype), -1)
    else:
        out = r * sh.sum_model(matmul_f32(kk, w2), out_dtype=x.dtype)
    return out, _last(m, x)
