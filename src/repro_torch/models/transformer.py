"""Decoder blocks and their training forward, prefill and decode loops: the
``block_kind == "attn"`` branch of ``repro.models.transformer``. It runs
the global-attention stacks (musicgen, internlm2, minitron, mistral,
chameleon), gemma2 (local and global layers alternating, the attention
softcap, sandwich norms) and the MoE stacks (dbrx, qwen2-moe: attention and
a grouped-dispatch MoE, ``models/moe.py``).

The layers are an ``nn.ModuleList`` walked by a Python loop (the reference
stacks them for ``lax.scan``), so each layer's window reaches the flash
kernel as a Python int. The decode cache stays stacked as in the
reference: ``{"k": (L, B, S_max, Hkv, hd), "v": ..., "pos": int}``. The
attention-free and hybrid stacks (mamba2 / zamba2, rwkv6) raise
``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import Attention
from .layers import MLP, rms_norm
from .moe import MoE


def check_supported(cfg) -> None:
    """Raise for the configurations the port does not run yet."""
    if cfg.block_kind != "attn":
        raise NotImplementedError(
            f"{cfg.name}: block_kind {cfg.block_kind!r} (mamba2 / rwkv6) is not ported yet "
            "(ROADMAP queue 1 items 13.4, 13.5)")


def _norm(d: int, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device))


class AttnBlock(nn.Module):
    """Pre-norm attention + MLP or MoE block (``_attn_block_fwd``):
    ``ln1``, ``attn``, ``ln2``, then ``moe`` (``cfg.n_experts``) or
    ``mlp``, and ``ln1_post`` / ``ln2_post`` on the two branch outputs
    (``cfg.sandwich_norm``, gemma2)."""

    def __init__(self, cfg, *, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _norm(cfg.d_model, device)
        self.attn = Attention(cfg, dtype=dtype, device=device)
        self.ln2 = _norm(cfg.d_model, device)
        if cfg.n_experts:
            self.moe = MoE(cfg, dtype=dtype, device=device)
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
               window: int = 0) -> torch.Tensor:
        h = self.attn.decode(rms_norm(x, self.ln1, self.cfg.norm_eps), cache_k, cache_v, pos,
                             window)
        return self._ffn_residual(x, h)[0]


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


def forward_train(layers: nn.ModuleList, x: torch.Tensor, cfg, positions: torch.Tensor,
                  tp: int = 1):
    """x (B, S, D) embeddings -> ``(hidden (B, S, D), aux_loss)``: aux is
    the MoE layers' load-balancing losses summed over layers (0.0 for
    dense stacks).

    With ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``
    (non-reentrant), as the reference wraps its scan body in
    ``jax.checkpoint``: the backward pass recomputes each layer's
    activations instead of keeping L layers of them, so the attention
    forward runs twice per layer and step."""
    if tp != 1:
        raise NotImplementedError(f"tp={tp}: tensor parallelism is not ported yet "
                                  "(ROADMAP queue 1 item 13.6)")
    aux = 0.0
    for layer, w in zip(layers, layer_windows(cfg)):
        if cfg.remat:
            x, a = checkpoint(_train_layer, layer, x, positions, w, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = _train_layer(layer, x, positions, w)
        aux = aux + a
    return x, aux


def prefill(layers: nn.ModuleList, x: torch.Tensor, cfg, positions: torch.Tensor,
            cache_len: int):
    """Forward over the prompt, building the decode cache.

    Returns ``(hidden (B, S, D), cache)``; K/V are written into
    length-``cache_len`` buffers and ``pos`` is S."""
    b, s, _ = x.shape
    if cache_len < s:
        raise ValueError(f"prefill: cache_len {cache_len} < prompt length {s}")
    shape = (cfg.n_layers, b, cache_len, cfg.n_kv_heads, cfg.head_dim)
    ck = torch.zeros(shape, dtype=x.dtype, device=x.device)
    cv = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i, (layer, w) in enumerate(zip(layers, layer_windows(cfg))):
        x, k, v, _ = layer(x, positions, w)
        ck[i, :, :s] = k
        cv[i, :, :s] = v
    return x, {"k": ck, "v": cv, "pos": s}


def decode_step(layers: nn.ModuleList, x: torch.Tensor, cfg, cache: dict):
    """One-token decode, x (B, 1, D). Returns ``(hidden (B, 1, D), cache)``;
    the cache's K/V buffers are updated in place and ``pos`` advances."""
    pos = int(cache["pos"])
    if not 0 <= pos < cache["k"].shape[2]:
        raise ValueError(f"decode: position {pos} outside the cache of length "
                         f"{cache['k'].shape[2]}")
    for i, (layer, w) in enumerate(zip(layers, layer_windows(cfg))):
        x = layer.decode(x, cache["k"][i], cache["v"][i], pos, w)
    return x, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def init_cache(cfg, batch: int, cache_len: int, dtype, device) -> dict:
    """Empty decode cache (for decode without a prefill), ``pos`` at the
    last slot as in the reference."""
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device), "pos": cache_len - 1}
