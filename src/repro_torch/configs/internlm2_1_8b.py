"""internlm2-1.8b [dense]: GQA kv=8 (arXiv:2403.17297)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=92_544, rope_theta=1_000_000.0,
)
