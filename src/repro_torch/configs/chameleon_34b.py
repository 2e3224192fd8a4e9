"""chameleon-34b [vlm]: early-fusion over VQ image tokens (arXiv:2405.09818;
unverified). VQ tokenizer frontend is a stub: input_specs() feeds token ids."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=65_536, frontend="vq-stub",
)
