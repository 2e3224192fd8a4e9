"""GQA attention: the full-sequence forward (prefill) and one-token decode
against a KV cache. The counterpart of ``repro.models.attention``.

The full-sequence forward takes one of two routes, as the reference's
``_flash_enabled`` chooses (``cfg.use_flash``):

* ``"auto"`` / ``"always"``: the flash kernel (``kernels.flash_attention``),
  which launches on CUDA tensors and runs its plain version on CPU tensors.
  The (B, S, H, hd) projections go in as strided (B, H, S, hd) views, and
  the kernel reads KV head ``h // n_rep`` itself, so neither K nor V is
  repeated or transposed. Where gradients are needed (training) the call
  goes through ``FlashAttention``, whose backward is the backward kernel;
  under ``inference_mode`` (serving) it is the forward alone;
* ``"never"``: the port of ``_attend_block``: f32 scores and softmax over
  query chunks of 1024, the probabilities cast to the model dtype before
  P . V. This is the reference's second route, not a fallback.

Decode computes the grouped score and output einsums of the reference
(no repeated cache) with the ``kpos <= pos`` mask. It writes the new K/V
into the cache in place (the reference returns an updated copy). Without a
mesh the reference's sharding constraints are no-ops, so they are left out.
No step builds a device tensor from a Python number (masks take the
sentinel as a scalar), so nothing waits for the device between launches.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention import FlashAttention, flash_attention

from .layers import apply_rope, dense_init_, linear_weight, softcap

_Q_CHUNK = 1024
_NEG = -1e30


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n_heads, head_dim))


def _expand_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, T, Hkv, hd) -> (B, T, Hq, hd); query head h uses kv group h // n_rep."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def _gqa_scores_grouped(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B, S, Hq, hd), k (B, T, G, hd), G | Hq -> scores (B, Hq, S, T),
    without repeating the cache."""
    b, s, hq, hd = q.shape
    g = k.shape[2]
    qg = q.reshape(b, s, g, hq // g, hd)
    sc = torch.einsum("bsgrh,btgh->bgrst", qg, k)
    return sc.reshape(b, hq, s, k.shape[1])


def _gqa_out_grouped(probs: torch.Tensor, v: torch.Tensor, hq: int) -> torch.Tensor:
    """probs (B, Hq, S, T), v (B, T, G, hd) -> (B, S, Hq, hd); G | Hq."""
    b, _, s, t = probs.shape
    g = v.shape[2]
    pg = probs.reshape(b, g, hq // g, s, t)
    out = torch.einsum("bgrst,btgh->bsgrh", pg, v)
    return out.reshape(b, s, hq, v.shape[-1])


def _attend_block(q, k, v, qpos, kpos, window: int, attn_softcap: float, n_rep: int, dtype):
    """One (query chunk x all keys) tile with the causal and window mask:
    the reference's XLA route. q (B, Sc, Hq, hd), k/v (B, T, Hkv, hd),
    qpos (B, Sc), kpos (B, T) -> (B, Sc, Hq, hd)."""
    hd = q.shape[-1]
    kx, vx = _expand_kv(k, n_rep), _expand_kv(v, n_rep)
    scores = torch.einsum("bsqh,btqh->bqst", q, kx).float() * (hd ** -0.5)
    scores = softcap(scores, attn_softcap)
    dist = qpos[:, :, None] - kpos[:, None, :]
    allow = dist >= 0
    if window > 0:
        allow &= dist < window
    scores = scores.masked_fill(~allow[:, None], _NEG)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.einsum("bqst,btqh->bsqh", probs, vx)


def cache_expand_factor(cfg, tp: int) -> int:
    """Duplication factor r of the decode KV cache (1 = no expansion): the
    smallest r dividing n_rep with (Hkv * r) % tp == 0 when Hkv does not
    divide the model axis of size ``tp``, so that the cache's heads shard
    over that axis (r = 2 for every 8-KV-head architecture at tp = 16; 1
    where no such r exists). The grouped decode einsums read the repetition
    from the cache's head count."""
    if tp <= 1 or cfg.n_kv_heads % tp == 0:
        return 1
    n_rep = cfg.n_heads // cfg.n_kv_heads
    for r in range(2, n_rep + 1):
        if n_rep % r == 0 and (cfg.n_kv_heads * r) % tp == 0:
            return r
    return 1


def _flash_enabled(cfg) -> bool:
    if cfg.use_flash not in ("auto", "always", "never"):
        raise ValueError(f"use_flash must be auto, always or never, got {cfg.use_flash!r}")
    return cfg.use_flash != "never"


class Attention(nn.Module):
    """``wq`` (d, H hd), ``wk``/``wv`` (d, Hkv hd), ``wo`` (H hd, d)."""

    def __init__(self, cfg, *, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.head_dim
        self.wq = linear_weight(d, cfg.n_heads * hd, dtype, device)
        self.wk = linear_weight(d, cfg.n_kv_heads * hd, dtype, device)
        self.wv = linear_weight(d, cfg.n_kv_heads * hd, dtype, device)
        self.wo = linear_weight(cfg.n_heads * hd, d, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv):
            dense_init_(w, generator)
        dense_init_(self.wo, generator, scale=self.wo.shape[0] ** -0.5)

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        hd = cfg.head_dim
        q = apply_rope(_split_heads(x @ self.wq, cfg.n_heads, hd), positions, cfg.rope_theta)
        k = apply_rope(_split_heads(x @ self.wk, cfg.n_kv_heads, hd), positions, cfg.rope_theta)
        v = _split_heads(x @ self.wv, cfg.n_kv_heads, hd)
        return q, k, v

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int = 0):
        """Full-sequence attention (prefill and training).

        x (B, S, D), positions (B, S) int. Returns ``(out (B, S, D), k, v)``
        with k, v (B, S, Hkv, hd), rotary applied to k: what prefill writes
        into the cache."""
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = self._qkv(x, positions)
        if _flash_enabled(cfg):
            qkv = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
            if torch.is_grad_enabled() and any(t.requires_grad for t in qkv):
                o = FlashAttention.apply(*qkv, True, window, cfg.attn_softcap)
            else:
                o = flash_attention(*qkv, causal=True, window=window, softcap=cfg.attn_softcap)
            out = o.transpose(1, 2)
        else:
            n_rep = cfg.n_heads // cfg.n_kv_heads
            out = torch.cat([
                _attend_block(q[:, c:c + _Q_CHUNK], k, v, positions[:, c:c + _Q_CHUNK],
                              positions, window, cfg.attn_softcap, n_rep, x.dtype)
                for c in range(0, s, _Q_CHUNK)], dim=1)
        return out.reshape(b, s, -1) @ self.wo, k, v

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
               window: int = 0) -> torch.Tensor:
        """One-token decode: x (B, 1, D) at position ``pos``; cache
        (B, S_max, Hc, hd), Hc = Hkv or Hkv r (the expanded cache of
        ``cache_expand_factor``, each KV head repeated r times in a row).
        Writes this token's K/V at ``pos`` in place; returns (B, 1, D)."""
        cfg = self.cfg
        b = x.shape[0]
        hd = cfg.head_dim
        posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q, k, v = self._qkv(x, posb)
        if cache_k.shape[2] != cfg.n_kv_heads:  # (partially) expanded cache
            r = cache_k.shape[2] // cfg.n_kv_heads
            k, v = _expand_kv(k, r), _expand_kv(v, r)
        cache_k[:, pos:pos + 1] = k.to(cache_k.dtype)
        cache_v[:, pos:pos + 1] = v.to(cache_v.dtype)

        scores = _gqa_scores_grouped(q, cache_k).float() * (hd ** -0.5)
        scores = softcap(scores, cfg.attn_softcap)                 # (B, Hq, 1, S_max)
        kpos = torch.arange(cache_k.shape[1], device=x.device)
        allow = kpos <= pos
        if window > 0:
            allow &= kpos > pos - window
        scores = scores.masked_fill(~allow, _NEG)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = _gqa_out_grouped(probs, cache_v, cfg.n_heads)
        return out.reshape(b, 1, -1) @ self.wo
