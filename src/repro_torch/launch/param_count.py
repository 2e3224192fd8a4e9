"""Analytic parameter counts per architecture (for 6*N*D roofline terms): a
copy of the reference's arithmetic (``repro.launch.param_count``)."""
from __future__ import annotations


def _attn_params(cfg) -> int:
    d, hd = cfg.d_model, cfg.head_dim
    q = d * cfg.n_heads * hd
    kv = 2 * d * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * d
    return q + kv + o


def _mlp_params(cfg) -> int:
    if cfg.mlp_kind == "swiglu":
        return 3 * cfg.d_model * cfg.d_ff
    return 2 * cfg.d_model * cfg.d_ff  # relu2: up + down


def _moe_params_per_layer(cfg, active: bool) -> int:
    e = cfg.n_experts_active if active else cfg.n_experts
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    shared = 3 * cfg.d_model * cfg.shared_d_ff if cfg.shared_d_ff else 0
    router = cfg.d_model * cfg.n_experts
    return e * per_expert + shared + router


def _mamba2_params(cfg) -> int:
    d, di, ns = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h = cfg.ssm_heads
    in_proj = d * (2 * di + 2 * ns + h)     # x, z, B, C, dt
    conv = cfg.ssm_conv * di
    out = di * d
    return in_proj + conv + out + h + di    # + A, D, skip


def _rwkv6_params(cfg) -> int:
    d = cfg.d_model
    tm = 4 * d * d + d * cfg.d_ff * 0       # r,k,v,g projections + output
    tm = 5 * d * d                           # r,k,v,g,o
    lora = 6 * (d * 32 + 32 * d)            # data-dependent decay LoRAs (approx)
    cm = 2 * d * cfg.d_ff                    # channel mix k,v (+ r: d*d)
    return tm + lora + cm + d * d


def layer_params(cfg, active: bool = False) -> int:
    if cfg.block_kind == "rwkv6":
        return _rwkv6_params(cfg)
    if cfg.block_kind == "mamba2":
        base = _mamba2_params(cfg)
        return base
    # attn stack
    attn = _attn_params(cfg)
    if cfg.n_experts:
        return attn + _moe_params_per_layer(cfg, active)
    return attn + _mlp_params(cfg)


def param_count(cfg, active: bool = False) -> int:
    """Non-embedding parameter count (total or active-per-token for MoE)."""
    n = cfg.n_layers * layer_params(cfg, active)
    if cfg.attn_every:  # zamba2 shared attention block
        n += _attn_params(cfg) + _mlp_params(cfg)
    return n


def active_param_count(cfg) -> int:
    return param_count(cfg, active=True)


def total_param_count(cfg) -> int:
    """Including embeddings (and untied lm_head)."""
    n = param_count(cfg, active=False) + cfg.vocab * cfg.d_model
    if not cfg.tie_embeddings:
        n += cfg.vocab * cfg.d_model
    return n
