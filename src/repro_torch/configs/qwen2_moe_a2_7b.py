"""qwen2-moe-a2.7b [moe]: 60 routed top-4 + shared expert
(hf:Qwen/Qwen1.5-MoE-A2.7B). 60 experts pad to 64 on a 16-way model axis."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=151_936,
    n_experts=60, n_experts_active=4, moe_d_ff=1408, shared_d_ff=5632,
)
