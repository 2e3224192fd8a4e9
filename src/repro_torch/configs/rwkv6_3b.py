"""rwkv6-3b [ssm]: Finch — attention-free, data-dependent per-channel decay
(arXiv:2404.05892)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab=65_536, block_kind="rwkv6",
)
