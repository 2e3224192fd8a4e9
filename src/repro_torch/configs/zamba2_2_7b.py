"""zamba2-2.7b [hybrid]: Mamba2 core + ONE shared attention block applied
every 6 layers (arXiv:2411.15242)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32_000,
    block_kind="mamba2", ssm_state=64, ssm_conv=4, ssm_expand=2,
    ssm_head_dim=64, attn_every=6,
)
