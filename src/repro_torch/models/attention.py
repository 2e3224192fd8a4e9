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
layout), a rank takes the placement ``sharding.rules`` gives its leaves and
computes the whole layer's function on it (``_local``):

* where the model axis divides the query heads, the rank computes its own
  query heads, ``n_heads / tp`` of them in a row, and the KV heads those
  read: where ``n_kv_heads`` divides the axis these are its own ``wk`` /
  ``wv`` columns; where it does not (the expanded cache of
  ``cache_expand_factor``) it gathers the K and V columns over 'model' and
  takes those of its KV heads;
* where the axis divides the H hd columns of ``wq`` but not the heads, its
  columns hold part of a head: the rank gathers the Q, K and V columns over
  'model', runs rotary and attention on the whole heads its columns fall in
  (each query head with its own KV head, so no grouping is assumed), and
  keeps its own columns of the output for the row-parallel ``wo``. The
  gathers' backward sums each column's gradient over the ranks that used
  it; ``wk`` / ``wv`` replicated over 'model' (columns it does not divide)
  enter through ``partial_leaves``, whose backward sums theirs;
* where the axis does not divide H hd, ``_fit`` replicates all four leaves
  and the attention runs whole on every model rank (``whole``).

Prefill and training call the same flash route on the rank's heads. The
decode cache follows ``cache_specs`` (``cache_block``): its heads over
'model' where they divide it (the rank's cache heads, ``cache_heads``);
else its sequence, each rank holding its block of positions for every
cache head, where the length divides it; else the whole cache on every
rank. Decode on a sequence-split cache forms each rank's partial scores
over its positions (masked past ``pos`` and outside the window), takes the
rows' max over 'model' (``max_over``) and their sums of exponents in f32 in
rank order, and sums the partial P . V products over 'model'; the rank that
owns ``pos`` writes the new token's K/V. With a whole cache every rank
attends over all of it. Both read every head and keep the rank's ``wo``
rows of the output.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention import FlashAttention, flash_attention

from .layers import apply_rope, dense_init_, leaf, linear_weight, row_parallel, softcap

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
    ``tp`` holds: its block where they divide the axis, else all of them
    (``cache_specs`` then splits the sequence, or keeps the cache whole)."""
    hc = cfg.n_kv_heads * r
    return hc // tp if hc % tp == 0 else hc


def cache_block(cfg, r: int, tp: int, tp_index: int, cache_len: int) -> tuple:
    """``(p0, n_pos, c0, n_heads)``: the positions [p0, p0 + n_pos) and the
    cache heads [c0, c0 + n_heads) that the rank at ``tp_index`` of a model
    axis of ``tp`` holds of a cache of ``cache_len`` slots and ``n_kv_heads
    * r`` heads, as ``cache_specs`` lays it out: heads over 'model'; where
    they do not divide it, the sequence; where neither does, all of it."""
    hc, nh = cfg.n_kv_heads * r, cache_heads_local(cfg, r, tp)
    if nh != hc:
        return 0, cache_len, tp_index * nh, nh
    if tp > 1 and cache_len % tp == 0:
        return tp_index * (cache_len // tp), cache_len // tp, 0, hc
    return 0, cache_len, 0, hc


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

    @property
    def whole(self) -> bool:
        """Whether this rank runs the attention whole: unsharded, or a model
        axis that does not divide ``wq``'s H hd columns (``_fit`` then
        replicates ``wq``, ``wk``, ``wv`` and ``wo`` over 'model')."""
        return self.shard is None or not self.shard.split(self.specs["wq"], 1)

    @property
    def aligned(self) -> bool:
        """Whether a rank's ``wq`` columns are whole query heads (sharded)."""
        return not self.whole and self.cfg.n_heads % self.shard.tp == 0

    def _local(self) -> tuple[int, int, int, int, int, int]:
        """``(q0, hq, kv0, nkv, lo, hi)``: the query heads [q0, q0 + hq) this
        rank computes (those its ``wq`` columns fall in; all of them where
        the attention runs whole), the KV heads [kv0, kv0 + nkv) they read,
        and the columns [lo, hi) of their (hq hd) output that are this
        rank's ``wo`` rows."""
        cfg = self.cfg
        h, hd = cfg.n_heads, cfg.head_dim
        if self.whole:
            return 0, h, 0, cfg.n_kv_heads, 0, h * hd
        w = h * hd // self.shard.tp
        c0 = self.shard.tp_index * w
        q0, q1 = c0 // hd, -(-(c0 + w) // hd)
        n_rep = h // cfg.n_kv_heads
        kv0 = q0 // n_rep
        return q0, q1 - q0, kv0, (q1 - 1) // n_rep + 1 - kv0, c0 - q0 * hd, c0 - q0 * hd + w

    def _cols(self, x: torch.Tensor, name: str, c0: int, n: int) -> torch.Tensor:
        """Columns [c0, c0 + n) of ``x @ w`` for the column-parallel leaf
        ``name`` (sharded; ``x`` has passed ``to_model``): the rank's own
        product where they are its columns, else its product gathered over
        'model' (the gather's backward sums each piece's gradient over the
        ranks), or, where the leaf is replicated over 'model', the leaf's
        columns through ``partial_leaves`` (each rank's gradient of it is
        partial)."""
        sh, spec = self.shard, self.specs[name]
        w = sh.fsdp(getattr(self, name), spec)
        if not sh.split(spec, 1):
            return x @ sh.partial_leaves(w)[0][:, c0:c0 + n]
        own = w.shape[1]
        if c0 == sh.tp_index * own and n == own:
            return x @ w
        return sh.gather_model(x @ w, -1)[..., c0:c0 + n]

    def _qkv(self, x: torch.Tensor, positions: torch.Tensor, all_heads: bool = False):
        """``(q, k, v, k0)``: q (B, S, hq, hd) for the query heads of
        ``_local`` (all of them with ``all_heads``), k and v for KV heads
        [k0, k0 + nk): the rank's own where its query heads are whole heads,
        else all of them (what a sequence-split or whole cache holds).
        Rotary applied to q and k."""
        cfg, sh = self.cfg, self.shard
        hd = cfg.head_dim
        q0, hq, kv0, nkv, _, _ = self._local()
        if self.whole:
            q, k, v = x @ leaf(self, "wq"), x @ leaf(self, "wk"), x @ leaf(self, "wv")
            kv0 = 0
        else:
            x = sh.to_model(x)
            if all_heads:
                q0, hq = 0, cfg.n_heads
            if all_heads or not self.aligned:
                kv0, nkv = 0, cfg.n_kv_heads
            q = self._cols(x, "wq", q0 * hd, hq * hd)
            k = self._cols(x, "wk", kv0 * hd, nkv * hd)
            v = self._cols(x, "wv", kv0 * hd, nkv * hd)
        q = apply_rope(_split_heads(q, q.shape[-1] // hd, hd), positions, cfg.rope_theta)
        k = apply_rope(_split_heads(k, k.shape[-1] // hd, hd), positions, cfg.rope_theta)
        return q, k, _split_heads(v, v.shape[-1] // hd, hd), kv0

    def _out(self, o: torch.Tensor) -> torch.Tensor:
        """(B, S, width) -> (B, S, D) through ``wo``: row-parallel on this
        rank's rows when sharded, whole where the attention runs whole."""
        if self.whole:
            return o @ leaf(self, "wo")
        return row_parallel(o, leaf(self, "wo"), self.shard)

    def cache_heads(self, k: torch.Tensor, r: int) -> torch.Tensor:
        """The KV heads ``forward`` returned (B, S, nk, hd) -> the decode
        cache's heads this rank holds: each KV head repeated r times in a row
        (``_expand_kv``), and of those the rank's block under ``cache_specs``
        (all of them where they do not divide the model axis)."""
        if self.shard is None:
            return _expand_kv(k, r)
        hc = cache_heads_local(self.cfg, r, self.shard.tp)
        if hc == self.cfg.n_kv_heads * r:
            return _expand_kv(k, r)
        lo = self.shard.tp_index * hc - self._local()[2] * r
        return _expand_kv(k, r)[:, :, lo:lo + hc]

    def cache_block(self, r: int, cache_len: int) -> tuple:
        """``cache_block`` of this rank (the whole cache unsharded)."""
        sh = self.shard
        return cache_block(self.cfg, r, 1 if sh is None else sh.tp,
                           0 if sh is None else sh.tp_index, cache_len)

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int = 0):
        """Full-sequence attention (prefill and training).

        x (B, S, D), positions (B, S) int. Returns ``(out (B, S, D), k, v)``
        with k, v (B, S, Hkv, hd) (sharded: the KV heads of ``_qkv``), rotary
        applied to k: what prefill writes into the cache."""
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v, k0 = self._qkv(x, positions)
        q0, hq, _, _, lo, hi = self._local()
        ka, va = k, v
        if not self.whole and not self.aligned:
            # Each query head with its own KV head: a rank's heads need not
            # fall in whole groups.
            idx = torch.arange(q0, q0 + hq, device=x.device) // (cfg.n_heads // cfg.n_kv_heads)
            ka, va = k[:, :, idx - k0], v[:, :, idx - k0]
        n_rep = q.shape[2] // ka.shape[2]
        if _flash_enabled(cfg):
            qkv = (q.transpose(1, 2), ka.transpose(1, 2), va.transpose(1, 2))
            if torch.is_grad_enabled() and any(t.requires_grad for t in qkv):
                o = FlashAttention.apply(*qkv, True, window, cfg.attn_softcap)
            else:
                o = flash_attention(*qkv, causal=True, window=window, softcap=cfg.attn_softcap)
            out = o.transpose(1, 2)
        else:
            out = torch.cat([
                _attend_block(q[:, c:c + _Q_CHUNK], ka, va, positions[:, c:c + _Q_CHUNK],
                              positions, window, cfg.attn_softcap, n_rep, x.dtype)
                for c in range(0, s, _Q_CHUNK)], dim=1)
        out = out.reshape(b, s, -1)
        if hi - lo != out.shape[-1]:
            out = out[..., lo:hi]
        return self._out(out), k, v

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
               window: int = 0, cache_len: int | None = None) -> torch.Tensor:
        """One-token decode: x (B, 1, D) at position ``pos``; cache
        (B, S_max, Hc, hd), Hc = Hkv or Hkv r (the expanded cache of
        ``cache_expand_factor``, each KV head repeated r times in a row).
        Writes this token's K/V at ``pos`` in place; returns (B, 1, D).
        Sharded, the cache holds this rank's block (``cache_block`` of a
        cache of ``cache_len`` slots): its ``Hc / tp`` heads, its block of
        positions at every head, or all of it."""
        cfg = self.cfg
        sh = self.shard
        if sh is not None and not self.aligned:
            return self._decode_every_head(x, cache_k, cache_v, pos, window, cache_len)
        b = x.shape[0]
        hd = cfg.head_dim
        posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q, k, v, _ = self._qkv(x, posb)
        tp = 1 if sh is None else sh.tp
        if cache_k.shape[2] * tp != cfg.n_kv_heads:  # (partially) expanded cache, or a shard
            r = cache_k.shape[2] * tp // cfg.n_kv_heads
            k, v = self.cache_heads(k, r), self.cache_heads(v, r)
        cache_k[:, pos:pos + 1] = k.to(cache_k.dtype)
        cache_v[:, pos:pos + 1] = v.to(cache_v.dtype)
        if sh is None and cache_k.shape[2] != cfg.n_kv_heads:
            # A whole model's expanded cache holds each KV head r times in a
            # row: read the first copy of each, so that the grouped products
            # are (Hkv, n_rep) whatever r is, the same sums (and the same
            # rounding) as on the cache of tp = 1.
            r = cache_k.shape[2] // cfg.n_kv_heads
            cache_k, cache_v = cache_k[:, :, ::r], cache_v[:, :, ::r]
        probs = torch.softmax(self._scores(q, cache_k, pos, 0, window), dim=-1).to(x.dtype)
        out = _gqa_out_grouped(probs, cache_v, q.shape[2])
        return self._out(out.reshape(b, 1, -1))

    def _scores(self, q, cache_k, pos: int, p0: int, window: int) -> torch.Tensor:
        """f32 scores (B, Hq, 1, n) of q against cache positions [p0, p0 +
        n), soft-capped, masked past ``pos`` and outside the window."""
        scores = _gqa_scores_grouped(q, cache_k).float() * (self.cfg.head_dim ** -0.5)
        scores = softcap(scores, self.cfg.attn_softcap)
        kpos = p0 + torch.arange(cache_k.shape[1], device=q.device)
        allow = kpos <= pos
        if window > 0:
            allow &= kpos > pos - window
        return scores.masked_fill(~allow, _NEG)

    def _decode_every_head(self, x, cache_k, cache_v, pos: int, window: int,
                           cache_len: int | None) -> torch.Tensor:
        """Decode where the rank holds every cache head (the heads do not
        divide the model axis): its block of positions (a sequence split,
        whose softmax statistics and P . V partials are summed over
        'model') or all of them; every query head is computed, and the
        rank keeps its ``wo`` rows of the output."""
        cfg, sh = self.cfg, self.shard
        b, dtype = x.shape[0], x.dtype
        posb = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
        q, k, v, _ = self._qkv(x, posb, all_heads=True)
        r = cache_k.shape[2] // cfg.n_kv_heads
        cache_len = cache_k.shape[1] if cache_len is None else cache_len
        p0, n_pos, _, _ = self.cache_block(r, cache_len)
        if n_pos != cache_k.shape[1]:
            raise ValueError(f"decode: a cache block of {cache_k.shape[1]} positions, the "
                             f"layout of {cache_len} slots gives {n_pos}")
        if p0 <= pos < p0 + n_pos:
            cache_k[:, pos - p0:pos - p0 + 1] = _expand_kv(k, r).to(cache_k.dtype)
            cache_v[:, pos - p0:pos - p0 + 1] = _expand_kv(v, r).to(cache_v.dtype)
        ck, cv = (cache_k[:, :, ::r], cache_v[:, :, ::r]) if r > 1 else (cache_k, cache_v)
        scores = self._scores(q, ck, pos, p0, window)
        if n_pos == cache_len:
            probs = torch.softmax(scores, dim=-1).to(dtype)
            out = _gqa_out_grouped(probs, cv, cfg.n_heads)
        else:
            m = sh.max_model(scores.amax(-1, keepdim=True))
            e = torch.exp(scores - m)
            probs = (e / sh.sum_model(e.sum(-1, keepdim=True), tag="decode")).to(dtype)
            out = sh.sum_model(_gqa_out_grouped(probs.float(), cv.float(), cfg.n_heads),
                               out_dtype=dtype, tag="decode")
        out = out.reshape(b, 1, -1)
        if not self.whole:
            w = out.shape[-1] // sh.tp
            out = out[..., sh.tp_index * w:(sh.tp_index + 1) * w]
        return self._out(out)
