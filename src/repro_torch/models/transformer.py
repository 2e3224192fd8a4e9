"""Decoder blocks and their training forward, prefill and decode loops: the
counterpart of ``repro.models.transformer``, for all five stack patterns:

* the global-attention stacks (musicgen, internlm2, minitron, mistral,
  chameleon), gemma2 (local and global layers alternating, the attention
  softcap, sandwich norms) and the MoE stacks (dbrx, qwen2-moe: attention
  and a grouped-dispatch MoE, ``models/moe.py``): ``block_kind == "attn"``;
* rwkv6: time mix and channel mix, attention-free (``models/rwkv6.py``);
* mamba2, and the zamba2 hybrid: groups of ``attn_every`` mamba2 layers
  (``models/ssm.py``), each group followed by ONE shared attention block
  (the same weights every time, window 0; its KV cache is per group).

The layers are an ``nn.ModuleList`` walked by a Python loop (the reference
stacks them for ``lax.scan``), so each layer's window reaches the flash
kernel as a Python int. The decode caches keep the reference's stacked
layouts and dtypes (``init_cache``); ``pos`` is a Python int. Decode writes
new K/V into the attention caches in place and returns new recurrent
states.

``tp`` (the size of a mesh's 'model' axis) changes two things, as in the
reference: the MoE's experts are padded to a multiple of it
(``padded_experts``; the padded ones are never routed to), and the decode
KV cache holds each KV head ``cache_expand_factor(cfg, tp)`` times, so that
its heads divide it. A whole model computes on one device whatever ``tp``
is; a model bound to a shard context (``sharding.placement.shard_model``)
runs its blocks on this rank's heads and hidden features, keeps the norms
and the residual stream replicated over 'model' and its rows split over the
data axes, and holds this rank's block of the decode cache (``cache_specs``:
batch over the data axes, cache heads over 'model', or where they do not
divide it the cache's sequence, or neither). A sharded cache with K/V
carries ``len``, its whole length, beside ``pos``: a rank's block of a
sequence split does not show it. Every block shards:
attention, dense or MoE (its experts over 'model', ``models/moe.py``), and
the recurrent blocks, whose scans run in the reference's ``FULL_BATCH``
layout (``models/ssm.py``, ``models/rwkv6.py``: rows over every axis, every
head; their decode caches hold this rank's heads, conv channels and block of
the last tokens' D); zamba2's shared block shards as an attention block
does, its KV cache per group.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.rules import cache_specs, local_shape

from .attention import Attention, cache_expand_factor
from .layers import MLP, rms_norm
from .moe import MoE
from .rwkv6 import RWKV6, rwkv6_channel_mix, rwkv6_time_mix, rwkv6_time_mix_decode
from .ssm import Mamba2, mamba2_decode, mamba2_forward


def _norm(d: int, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device))


class AttnBlock(nn.Module):
    """Pre-norm attention + MLP or MoE block (``_attn_block_fwd``):
    ``ln1``, ``attn``, ``ln2``, then ``moe`` (``cfg.n_experts``) or
    ``mlp``, and ``ln1_post`` / ``ln2_post`` on the two branch outputs
    (``cfg.sandwich_norm``, gemma2)."""

    def __init__(self, cfg, *, tp: int = 1, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _norm(cfg.d_model, device)
        self.attn = Attention(cfg, dtype=dtype, device=device)
        self.ln2 = _norm(cfg.d_model, device)
        if cfg.n_experts:
            self.moe = MoE(cfg, padded_experts(cfg, tp), dtype=dtype, device=device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype=dtype, device=device)
        if cfg.sandwich_norm:
            self.ln1_post = _norm(cfg.d_model, device)
            self.ln2_post = _norm(cfg.d_model, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for p in self.parameters(recurse=False):
            nn.init.zeros_(p)
        self.attn.reset_parameters(generator)
        (self.moe if self.cfg.n_experts else self.mlp).reset_parameters(generator)

    def _ffn_residual(self, x: torch.Tensor, h: torch.Tensor):
        """x and the attention output h -> ``(x', aux)``: the rest of the
        block; aux is the MoE's load-balancing loss (0.0 for an MLP)."""
        cfg = self.cfg
        if cfg.sandwich_norm:
            h = rms_norm(h, self.ln1_post, cfg.norm_eps)
        x = x + h
        h = rms_norm(x, self.ln2, cfg.norm_eps)
        h, aux = self.moe(h) if cfg.n_experts else (self.mlp(h), 0.0)
        if cfg.sandwich_norm:
            h = rms_norm(h, self.ln2_post, cfg.norm_eps)
        return x + h, aux

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int = 0):
        """(B, S, D) -> ``(x, k, v, aux)``, k/v the rotated keys and values
        the prefill writes into the cache."""
        h, k, v = self.attn(rms_norm(x, self.ln1, self.cfg.norm_eps), positions, window)
        x, aux = self._ffn_residual(x, h)
        return x, k, v, aux

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
               window: int = 0, cache_len: int | None = None) -> torch.Tensor:
        h = self.attn.decode(rms_norm(x, self.ln1, self.cfg.norm_eps), cache_k, cache_v, pos,
                             window, cache_len)
        return self._ffn_residual(x, h)[0]


class MambaBlock(nn.Module):
    """``ln1`` and ``mamba``: x + mamba2(rms_norm(x))."""

    def __init__(self, cfg, *, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _norm(cfg.d_model, device)
        self.mamba = Mamba2(cfg, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.ln1)
        self.mamba.reset_parameters(generator)

    def forward(self, x: torch.Tensor):
        """(B, S, D) -> ``(x, ssd state, conv tail)``: the layer's decode
        cache after a prefill."""
        h, ssd, conv = mamba2_forward(self.mamba, rms_norm(x, self.ln1, self.cfg.norm_eps))
        return x + h, ssd, conv

    def decode(self, x: torch.Tensor, ssd: torch.Tensor, conv: torch.Tensor):
        h, new = mamba2_decode(self.mamba, rms_norm(x, self.ln1, self.cfg.norm_eps),
                               {"ssd": ssd, "conv": conv})
        return x + h, new["ssd"], new["conv"]


class RwkvBlock(nn.Module):
    """``ln1``, ``ln2`` and ``rwkv``: x + time_mix(rms_norm(x)), then
    + channel_mix(rms_norm(x))."""

    def __init__(self, cfg, *, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _norm(cfg.d_model, device)
        self.ln2 = _norm(cfg.d_model, device)
        self.rwkv = RWKV6(cfg, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.ln1)
        nn.init.zeros_(self.ln2)
        self.rwkv.reset_parameters(generator)

    def forward(self, x: torch.Tensor):
        """(B, S, D) -> ``(x, wkv state, last1, last2)``: the layer's decode
        cache after a prefill (the last token of each mix's input)."""
        eps = self.cfg.norm_eps
        h, wkv, last1 = rwkv6_time_mix(self.rwkv, rms_norm(x, self.ln1, eps))
        x = x + h
        h, last2 = rwkv6_channel_mix(self.rwkv, rms_norm(x, self.ln2, eps))
        return x + h, wkv, last1, last2

    def decode(self, x: torch.Tensor, wkv: torch.Tensor, last1: torch.Tensor,
               last2: torch.Tensor):
        eps = self.cfg.norm_eps
        h, wkv, last1 = rwkv6_time_mix_decode(self.rwkv, rms_norm(x, self.ln1, eps), wkv, last1)
        x = x + h
        h, last2 = rwkv6_channel_mix(self.rwkv, rms_norm(x, self.ln2, eps), last_tok=last2)
        return x + h, wkv, last1, last2


def make_layers(cfg, *, tp: int = 1, dtype=torch.float32, device=None) -> nn.ModuleList:
    """The ``n_layers`` blocks of ``cfg.block_kind`` (an MoE block's experts
    padded for ``tp``). Raises ``ValueError`` for a stack the reference does
    not build: another ``block_kind``, or a hybrid whose layers do not split
    into whole groups of ``attn_every``."""
    blocks = {"attn": AttnBlock, "mamba2": MambaBlock, "rwkv6": RwkvBlock}
    if cfg.block_kind not in blocks:
        raise ValueError(f"{cfg.name}: block_kind {cfg.block_kind!r} not in {tuple(blocks)}")
    if cfg.attn_every and cfg.n_layers % cfg.attn_every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole groups of "
                         f"attn_every = {cfg.attn_every}")
    kw = dict(dtype=dtype, device=device, **({"tp": tp} if cfg.block_kind == "attn" else {}))
    return nn.ModuleList(blocks[cfg.block_kind](cfg, **kw) for _ in range(cfg.n_layers))


def padded_experts(cfg, tp: int = 1) -> int:
    """The expert count padded up to a multiple of the model axis ``tp``."""
    if not cfg.n_experts:
        return 0
    return ((cfg.n_experts + tp - 1) // tp) * tp


def _check_tp(layers: nn.ModuleList, cfg, tp: int) -> None:
    """``tp`` must be a positive int, and an MoE stack's layers must carry
    ``padded_experts(cfg, tp)`` experts."""
    if not (isinstance(tp, int) and tp >= 1):
        raise ValueError(f"tp must be a positive int, got {tp!r}")
    if cfg.n_experts and cfg.block_kind == "attn":
        e = layers[0].moe.n_experts
        if e != padded_experts(cfg, tp):
            raise ValueError(f"{cfg.name}: the layers carry {e} experts, tp={tp} pads "
                             f"{cfg.n_experts} to {padded_experts(cfg, tp)}")


def layer_windows(cfg) -> list[int]:
    """Per-layer sliding-window sizes (0 = global attention)."""
    if cfg.local_global and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else 0 for i in range(cfg.n_layers)]
    if cfg.sliding_window:
        return [cfg.sliding_window] * cfg.n_layers
    return [0] * cfg.n_layers


def _train_layer(layer: AttnBlock, x: torch.Tensor, positions: torch.Tensor, window: int):
    x, _, _, aux = layer(x, positions, window)
    return x, aux


def _train_group(group: nn.ModuleList, shared: AttnBlock, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """One hybrid group: its mamba2 layers, then the shared block at window 0."""
    for layer in group:
        x = layer(x)[0]
    return shared(x, positions, 0)[0]


def forward_train(layers: nn.ModuleList, x: torch.Tensor, cfg, positions: torch.Tensor,
                  tp: int = 1, shared_attn: AttnBlock | None = None):
    """x (B, S, D) embeddings -> ``(hidden (B, S, D), aux_loss)``: aux is
    the MoE layers' load-balancing losses summed over layers (0.0 for
    every other stack). ``shared_attn`` is the hybrid's shared block.

    With ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``
    (non-reentrant), as the reference wraps its scan body in
    ``jax.checkpoint``: the backward pass recomputes each layer's
    activations instead of keeping L layers of them, so the attention
    forward runs twice per layer and step. The hybrid checkpoints each
    group (its mamba2 layers and the shared block) as one, as the reference
    checkpoints ``group_body``. ``tp`` must match the MoE's padded
    experts; the padded ones are never routed to."""
    _check_tp(layers, cfg, tp)
    ckpt = ((lambda f, *a: checkpoint(f, *a, use_reentrant=False, preserve_rng_state=False))
            if cfg.remat else (lambda f, *a: f(*a)))
    if cfg.block_kind == "attn":
        aux = 0.0
        for layer, w in zip(layers, layer_windows(cfg)):
            x, a = ckpt(_train_layer, layer, x, positions, w)
            aux = aux + a
        return x, aux
    if cfg.attn_every:
        for i in range(0, cfg.n_layers, cfg.attn_every):
            x = ckpt(_train_group, layers[i:i + cfg.attn_every], shared_attn, x, positions)
        return x, 0.0
    for layer in layers:
        x = ckpt(lambda lyr, x: lyr(x)[0], layer, x)
    return x, 0.0


def prefill(layers: nn.ModuleList, x: torch.Tensor, cfg, positions: torch.Tensor,
            cache_len: int, shared_attn: AttnBlock | None = None, tp: int = 1):
    """Forward over the prompt, building the decode cache.

    Returns ``(hidden (B, S, D), cache)`` with ``pos`` = S; attention K/V
    are written into length-``cache_len`` buffers of ``Hkv * r`` heads, r =
    ``cache_expand_factor(cfg, tp)``, each KV head repeated r times in a row
    (the reference's ``_expand_kv``)."""
    _check_tp(layers, cfg, tp)
    b, s, _ = x.shape
    r = cache_expand_factor(cfg, tp)
    kv_layers = (cfg.n_layers if cfg.block_kind == "attn"
                 else cfg.n_layers // cfg.attn_every if cfg.attn_every else 0)
    if kv_layers and cache_len < s:
        raise ValueError(f"prefill: cache_len {cache_len} < prompt length {s}")
    if cfg.block_kind == "rwkv6":
        states = []
        for layer in layers:
            x, *st = layer(x)
            states.append(st)
        wkv, last1, last2 = (torch.stack(t) for t in zip(*states))
        return x, {"wkv": wkv, "last1": last1, "last2": last2, "pos": s}
    if kv_layers:
        attn = (layers[0] if cfg.block_kind == "attn" else shared_attn).attn
        p0, n_pos, _, hc = attn.cache_block(r, cache_len)
        shape = (kv_layers, b, n_pos, hc, cfg.head_dim)
        ck = torch.zeros(shape, dtype=x.dtype, device=x.device)
        cv = torch.zeros(shape, dtype=x.dtype, device=x.device)
        lo, hi = p0, min(s, p0 + n_pos)     # the prompt's positions this rank holds

        def write(i, k, v):
            if lo < hi:
                ck[i, :, :hi - lo] = attn.cache_heads(k[:, lo:hi], r)
                cv[i, :, :hi - lo] = attn.cache_heads(v[:, lo:hi], r)

        kv = {"k": ck, "v": cv, "pos": s}
        if attn.shard is not None:
            kv["len"] = cache_len
    if cfg.block_kind == "attn":
        for i, (layer, w) in enumerate(zip(layers, layer_windows(cfg))):
            x, k, v, _ = layer(x, positions, w)
            write(i, k, v)
        return x, kv
    states = []
    for i, layer in enumerate(layers):
        x, ssd, conv = layer(x)
        states.append((ssd, conv))
        if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
            x, k, v, _ = shared_attn(x, positions, 0)
            write(i // cfg.attn_every, k, v)
    ssd, conv = (torch.stack(t) for t in zip(*states))
    if not cfg.attn_every:
        return x, {"ssd": ssd, "conv": conv, "pos": s}
    grouped = lambda t: t.reshape((kv_layers, cfg.attn_every) + t.shape[1:])
    return x, {"ssd": grouped(ssd), "conv": grouped(conv), **kv}


def decode_step(layers: nn.ModuleList, x: torch.Tensor, cfg, cache: dict,
                shared_attn: AttnBlock | None = None, tp: int = 1):
    """One-token decode, x (B, 1, D). Returns ``(hidden (B, 1, D), cache)``;
    the attention K/V buffers are updated in place, the recurrent states
    come back as new tensors, and ``pos`` advances. The attention reads its
    KV repetition from the cache's head count (``Attention.decode``)."""
    _check_tp(layers, cfg, tp)
    pos = int(cache["pos"])
    kv = {k: cache[k] for k in ("k", "v", "len") if k in cache}
    cache_len = cache.get("len", cache["k"].shape[2]) if "k" in cache else None
    if "k" in cache and not 0 <= pos < cache_len:
        raise ValueError(f"decode: position {pos} outside the cache of length {cache_len}")
    if cfg.block_kind == "attn":
        for i, (layer, w) in enumerate(zip(layers, layer_windows(cfg))):
            x = layer.decode(x, cache["k"][i], cache["v"][i], pos, w, cache_len)
        return x, {**kv, "pos": pos + 1}
    if cfg.block_kind == "rwkv6":
        states = []
        for i, layer in enumerate(layers):
            x, *st = layer.decode(x, cache["wkv"][i], cache["last1"][i], cache["last2"][i])
            states.append(st)
        wkv, last1, last2 = (torch.stack(t) for t in zip(*states))
        return x, {"wkv": wkv, "last1": last1, "last2": last2, "pos": pos + 1}
    flat = lambda t: t.reshape((cfg.n_layers,) + t.shape[2:]) if cfg.attn_every else t
    ssd_in, conv_in = flat(cache["ssd"]), flat(cache["conv"])
    states = []
    for i, layer in enumerate(layers):
        x, *st = layer.decode(x, ssd_in[i], conv_in[i])
        states.append(st)
        if cfg.attn_every and (i + 1) % cfg.attn_every == 0:
            g = i // cfg.attn_every
            x = shared_attn.decode(x, cache["k"][g], cache["v"][g], pos, 0, cache_len)
    ssd, conv = (torch.stack(t) for t in zip(*states))
    if not cfg.attn_every:
        return x, {"ssd": ssd, "conv": conv, "pos": pos + 1}
    grouped = lambda t: t.reshape(cache["ssd"].shape[:2] + t.shape[1:])
    return x, {"ssd": grouped(ssd), "conv": grouped(conv), **kv, "pos": pos + 1}


def init_cache(cfg, batch: int, cache_len: int, dtype, device, tp: int = 1,
               shard=None) -> dict:
    """Empty decode cache (for decode without a prefill), ``pos`` at the
    last slot as in the reference: attention K/V (L, B, cache_len, Hkv r,
    hd), r = ``cache_expand_factor(cfg, tp)``;
    rwkv6 ``wkv`` (L, B, H, hd, hd) f32, ``last1`` / ``last2`` (L, B, 1,
    D); mamba2 ``ssd`` (L, B, H, P, N) f32 and ``conv`` (L, B, K - 1,
    d_inner), grouped as (G, attn_every, ...) in the hybrid, whose shared
    block's K/V are (G, B, cache_len, Hkv r, hd). With a ``shard``
    context: this rank's block of each leaf under ``cache_specs`` (``batch``
    is the global batch) and, with K/V, ``len``."""
    if shard is not None:
        whole = init_cache(cfg, batch, cache_len, dtype, "meta", tp)
        specs = cache_specs(whole, shard.mesh)
        out = {k: (torch.zeros(local_shape(v.shape, specs[k], shard.mesh), dtype=v.dtype,
                               device=device) if torch.is_tensor(v) else v)
               for k, v in whole.items()}
        return dict(out, len=cache_len) if "k" in out else out
    zeros = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    kv = lambda n: (n, batch, cache_len, cfg.n_kv_heads * cache_expand_factor(cfg, tp),
                    cfg.head_dim)
    pos = cache_len - 1
    n = cfg.n_layers
    if cfg.block_kind == "attn":
        return {"k": zeros(kv(n)), "v": zeros(kv(n)), "pos": pos}
    if cfg.block_kind == "rwkv6":
        return {"wkv": zeros((n, batch, cfg.n_heads, cfg.head_dim, cfg.head_dim), torch.float32),
                "last1": zeros((n, batch, 1, cfg.d_model)),
                "last2": zeros((n, batch, 1, cfg.d_model)), "pos": pos}
    lead = (n // cfg.attn_every, cfg.attn_every) if cfg.attn_every else (n,)
    out = {"ssd": zeros(lead + (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                        torch.float32),
           "conv": zeros(lead + (batch, cfg.ssm_conv - 1, cfg.d_inner)), "pos": pos}
    if cfg.attn_every:
        out["k"], out["v"] = zeros(kv(lead[0])), zeros(kv(lead[0]))
    return out
