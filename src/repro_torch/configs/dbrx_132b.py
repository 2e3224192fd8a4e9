"""dbrx-132b [moe]: 16 experts top-4 fine-grained MoE
(hf:databricks/dbrx-base; unverified)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab=100_352,
    n_experts=16, n_experts_active=4, moe_d_ff=10752,
)
