"""Model configuration dataclass shared by all 10 assigned architectures."""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # attention variants
    sliding_window: int = 0          # >0: local attention window
    local_global: bool = False       # gemma2: alternate local/global layers
    attn_softcap: float = 0.0        # gemma2 attention-logit softcap
    logit_softcap: float = 0.0       # gemma2 final-logit softcap
    sandwich_norm: bool = False      # gemma2 pre+post block norms
    rope_theta: float = 10_000.0

    # MoE
    n_experts: int = 0
    n_experts_active: int = 0        # top-k
    moe_d_ff: int = 0                # per-expert hidden dim
    shared_d_ff: int = 0             # qwen2-moe shared-expert hidden dim
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64

    # hybrid (zamba2): one SHARED attention block applied every k core layers
    attn_every: int = 0

    # block kind of the core stack: attn | mamba2 | rwkv6
    block_kind: str = "attn"

    norm_eps: float = 1e-5
    remat: bool = True               # rematerialize each layer's activations
    use_flash: str = "auto"          # flash-attn kernel: auto|always|never
    emb_scale: bool = False          # gemma-style sqrt(d_model) embed multiplier
    mlp_kind: str = "swiglu"         # swiglu | relu2 (nemotron/minitron)
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # frontend stub for [audio]/[vlm]: backbone consumes precomputed tokens
    frontend: str = "none"

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self, **over) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 4 if self.attn_every == 0 else 2 * max(self.attn_every, 1)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab=256,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
        )
        if self.n_experts:
            # capacity_factor >= E/k guarantees no capacity drops, making
            # prefill-vs-decode smoke checks exact (drops are a large-scale
            # load-balancing artifact, not a correctness property).
            kw.update(n_experts=4, n_experts_active=min(self.n_experts_active, 2),
                      moe_d_ff=64, shared_d_ff=64 if self.shared_d_ff else 0,
                      capacity_factor=4.0)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=16)
        if self.attn_every:
            kw.update(attn_every=2, n_layers=4)
        kw.update(over)
        return replace(self, **kw)
