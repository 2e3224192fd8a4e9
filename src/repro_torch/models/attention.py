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

Bound to a shard context (``Attention.shard``, ``layers`` explains the
layout), a rank computes its own query heads, ``n_heads / tp`` of them in a
row, and the KV heads those read (``_local``): where ``n_kv_heads`` divides
the model axis these are its own ``wk`` / ``wv`` columns; where it does not
(the expanded cache of ``cache_expand_factor``) it gathers the K and V
weights over 'model' and takes the columns of its KV heads, whose
gradients the gather's backward sums back over the ranks that share them.
Prefill and training call the same flash route on those heads; decode
reads the rank's cache heads (``cache_heads``), and ``wo`` is row-parallel.
``cache_specs`` splits the cache's sequence instead of its heads where the
expanded cache's heads do not divide the model axis; no dense configuration
of the repo reaches that at the meshes run (2 x 2, 1 x 4: every
``n_kv_heads * r`` divides them), so a sharded cache of that layout raises.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention import FlashAttention, flash_attention

from .layers import apply_rope, dense_init_, linear_weight, row_parallel, softcap

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


def cache_heads_local(cfg, r: int, tp: int) -> int:
    """The cache heads (of ``n_kv_heads * r``) one rank of a model axis of
    ``tp`` holds. Raises where they do not divide it: ``cache_specs`` then
    splits the sequence over 'model', which no configuration of the repo
    reaches at the meshes its sharded runs use (2 x 2 and 1 x 4)."""
    hc = cfg.n_kv_heads * r
    if hc % tp:
        raise NotImplementedError(
            f"{cfg.name}: {hc} cache heads do not divide the model axis of {tp}, so "
            f"cache_specs splits the sequence; sequence-split decode (an all-reduce of each "
            f"row's max and sum over 'model') is not written")
    return hc // tp


def _flash_enabled(cfg) -> bool:
    if cfg.use_flash not in ("auto", "always", "never"):
        raise ValueError(f"use_flash must be auto, always or never, got {cfg.use_flash!r}")
    return cfg.use_flash != "never"


class Attention(nn.Module):
    """``wq`` (d, H hd), ``wk``/``wv`` (d, Hkv hd), ``wo`` (H hd, d)."""

    shard = None

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

    def _local(self) -> tuple[int, int, int, int]:
        """``(q0, hq, kv0, nkv)``: this rank's query heads [q0, q0 + hq)
        and the KV heads [kv0, kv0 + nkv) they read (all of them whole)."""
        cfg, sh = self.cfg, self.shard
        if sh is None:
            return 0, cfg.n_heads, 0, cfg.n_kv_heads
        hq = cfg.n_heads // sh.tp
        q0 = sh.tp_index * hq
        n_rep = cfg.n_heads // cfg.n_kv_heads
        kv0 = q0 // n_rep
        return q0, hq, kv0, (q0 + hq - 1) // n_rep + 1 - kv0

    def _kv_weight(self, name: str) -> torch.Tensor:
        """The ``wk`` / ``wv`` columns of this rank's KV heads."""
        sh, spec, cfg = self.shard, self.specs[name], self.cfg
        w = sh.fsdp(getattr(self, name), spec)
        if spec[1] is not None:
            if cfg.n_kv_heads % sh.tp == 0:
                return w                    # its own columns are its KV heads
            w = sh.gather_model(w, 1)
        _, _, kv0, nkv = self._local()
        return w[:, kv0 * cfg.head_dim:(kv0 + nkv) * cfg.head_dim]

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor):
        cfg = self.cfg
        hd = cfg.head_dim
        sh = self.shard
        if sh is None:
            wq, wk, wv = self.wq, self.wk, self.wv
        else:
            x = sh.to_model(x)
            wq = sh.fsdp(self.wq, self.specs["wq"])
            wk, wv = self._kv_weight("wk"), self._kv_weight("wv")
        _, hq, _, nkv = self._local()
        q = apply_rope(_split_heads(x @ wq, hq, hd), positions, cfg.rope_theta)
        k = apply_rope(_split_heads(x @ wk, nkv, hd), positions, cfg.rope_theta)
        v = _split_heads(x @ wv, nkv, hd)
        return q, k, v

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        """(B, S, hq hd) -> (B, S, D) through ``wo`` (row-parallel when sharded)."""
        if self.shard is None:
            return o @ self.wo
        return row_parallel(o, self.shard.fsdp(self.wo, self.specs["wo"]), self.shard)

    def cache_heads(self, k: torch.Tensor, r: int) -> torch.Tensor:
        """This rank's KV heads (B, S, nkv, hd) -> the decode cache's heads it
        holds: each KV head repeated r times in a row (``_expand_kv``), and
        of those the rank's block under ``cache_specs``."""
        if self.shard is None:
            return _expand_kv(k, r)
        hc = cache_heads_local(self.cfg, r, self.shard.tp)
        c0 = self.shard.tp_index * hc
        lo = c0 - self._local()[2] * r
        return _expand_kv(k, r)[:, :, lo:lo + hc]

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int = 0):
        """Full-sequence attention (prefill and training).

        x (B, S, D), positions (B, S) int. Returns ``(out (B, S, D), k, v)``
        with k, v (B, S, Hkv, hd), rotary applied to k: what prefill writes
        into the cache."""
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = self._qkv(x, positions)
        n_rep = q.shape[2] // k.shape[2]
        if _flash_enabled(cfg):
            qkv = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
            if torch.is_grad_enabled() and any(t.requires_grad for t in qkv):
                o = FlashAttention.apply(*qkv, True, window, cfg.attn_softcap)
            else:
                o = flash_attention(*qkv, causal=True, window=window, softcap=cfg.attn_softcap)
            out = o.transpose(1, 2)
        else:
            out = torch.cat([
                _attend_block(q[:, c:c + _Q_CHUNK], k, v, positions[:, c:c + _Q_CHUNK],
                              positions, window, cfg.attn_softcap, n_rep, x.dtype)
                for c in range(0, s, _Q_CHUNK)], dim=1)
        return self._out(out.reshape(b, s, -1)), k, v

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
               window: int = 0) -> torch.Tensor:
        """One-token decode: x (B, 1, D) at position ``pos``; cache
        (B, S_max, Hc, hd), Hc = Hkv or Hkv r (the expanded cache of
        ``cache_expand_factor``, each KV head repeated r times in a row).
        Writes this token's K/V at ``pos`` in place; returns (B, 1, D).
        Sharded, the cache holds this rank's ``Hc / tp`` heads."""
        cfg = self.cfg
        b = x.shape[0]
        hd = cfg.head_dim
        posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q, k, v = self._qkv(x, posb)
        tp = 1 if self.shard is None else self.shard.tp
        if cache_k.shape[2] * tp != cfg.n_kv_heads:  # (partially) expanded cache, or a shard
            r = cache_k.shape[2] * tp // cfg.n_kv_heads
            k, v = self.cache_heads(k, r), self.cache_heads(v, r)
        cache_k[:, pos:pos + 1] = k.to(cache_k.dtype)
        cache_v[:, pos:pos + 1] = v.to(cache_v.dtype)
        if self.shard is None and cache_k.shape[2] != cfg.n_kv_heads:
            # A whole model's expanded cache holds each KV head r times in a
            # row: read the first copy of each, so that the grouped products
            # are (Hkv, n_rep) whatever r is, the same sums (and the same
            # rounding) as on the cache of tp = 1.
            r = cache_k.shape[2] // cfg.n_kv_heads
            cache_k, cache_v = cache_k[:, :, ::r], cache_v[:, :, ::r]

        scores = _gqa_scores_grouped(q, cache_k).float() * (hd ** -0.5)
        scores = softcap(scores, cfg.attn_softcap)                 # (B, Hq, 1, S_max)
        kpos = torch.arange(cache_k.shape[1], device=x.device)
        allow = kpos <= pos
        if window > 0:
            allow &= kpos > pos - window
        scores = scores.masked_fill(~allow, _NEG)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        out = _gqa_out_grouped(probs, cache_v, q.shape[2])
        return self._out(out.reshape(b, 1, -1))
