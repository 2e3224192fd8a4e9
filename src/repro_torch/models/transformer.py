"""Decoder blocks and their training forward, prefill and decode loops: the
``block_kind == "attn"`` branch of ``repro.models.transformer``, for dense
global-attention stacks (musicgen, internlm2, minitron, mistral, chameleon).

The layers are an ``nn.ModuleList`` walked by a Python loop (the reference
stacks them for ``lax.scan``). The decode cache stays stacked as in the
reference: ``{"k": (L, B, S_max, Hkv, hd), "v": ..., "pos": int}``.
Configurations outside the slice raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .attention import Attention
from .layers import MLP, rms_norm


def check_supported(cfg) -> None:
    """Raise for the configurations the port does not run yet."""
    if cfg.block_kind != "attn":
        raise NotImplementedError(
            f"{cfg.name}: block_kind {cfg.block_kind!r} (mamba2 / rwkv6) is not ported yet "
            "(ROADMAP queue 1 item 13)")
    if cfg.n_experts:
        raise NotImplementedError(f"{cfg.name}: MoE blocks are not ported yet "
                                  "(ROADMAP queue 1 item 13)")
    if cfg.local_global or cfg.sliding_window:
        raise NotImplementedError(f"{cfg.name}: sliding-window / local-global attention "
                                  "(gemma2) is not ported yet (ROADMAP queue 1 item 13)")


def _norm(d: int, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(d, dtype=torch.float32, device=device))


class AttnBlock(nn.Module):
    """Pre-norm attention + MLP block (``_attn_block_fwd``). gemma2's
    sandwich norms come with the gemma2 slice."""

    def __init__(self, cfg, *, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _norm(cfg.d_model, device)
        self.attn = Attention(cfg, dtype=dtype, device=device)
        self.ln2 = _norm(cfg.d_model, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for p in (self.ln1, self.ln2):
            nn.init.zeros_(p)
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)

    def _mlp_residual(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        x = x + h
        return x + self.mlp(rms_norm(x, self.ln2, self.cfg.norm_eps))

    def forward(self, x: torch.Tensor, positions: torch.Tensor, window: int = 0):
        """(B, S, D) -> ``(x, k, v)``, k/v the rotated keys and values the
        prefill writes into the cache."""
        h, k, v = self.attn(rms_norm(x, self.ln1, self.cfg.norm_eps), positions, window)
        return self._mlp_residual(x, h), k, v

    def decode(self, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, pos: int,
               window: int = 0) -> torch.Tensor:
        h = self.attn.decode(rms_norm(x, self.ln1, self.cfg.norm_eps), cache_k, cache_v, pos,
                             window)
        return self._mlp_residual(x, h)


def layer_windows(cfg) -> list[int]:
    """Per-layer sliding-window sizes (0 = global attention)."""
    if cfg.local_global and cfg.sliding_window:
        return [cfg.sliding_window if i % 2 == 0 else 0 for i in range(cfg.n_layers)]
    if cfg.sliding_window:
        return [cfg.sliding_window] * cfg.n_layers
    return [0] * cfg.n_layers


def _train_layer(layer: AttnBlock, x: torch.Tensor, positions: torch.Tensor,
                 window: int) -> torch.Tensor:
    return layer(x, positions, window)[0]


def forward_train(layers: nn.ModuleList, x: torch.Tensor, cfg, positions: torch.Tensor,
                  tp: int = 1):
    """x (B, S, D) embeddings -> ``(hidden (B, S, D), aux_loss)``; aux is
    0.0 (no MoE block in this slice).

    With ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``
    (non-reentrant), as the reference wraps its scan body in
    ``jax.checkpoint``: the backward pass recomputes each layer's
    activations instead of keeping L layers of them, so the attention
    forward runs twice per layer and step."""
    if tp != 1:
        raise NotImplementedError(f"tp={tp}: tensor parallelism is not ported yet "
                                  "(ROADMAP queue 1 item 13.6)")
    for layer, w in zip(layers, layer_windows(cfg)):
        if cfg.remat:
            x = checkpoint(_train_layer, layer, x, positions, w, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _train_layer(layer, x, positions, w)
    return x, 0.0


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
        x, k, v = layer(x, positions, w)
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
