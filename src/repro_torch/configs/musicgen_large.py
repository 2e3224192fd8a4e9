"""musicgen-large [audio]: decoder-only over EnCodec tokens (arXiv:2306.05284).

Backbone only — the EnCodec frontend is a stub: input_specs() feeds
precomputed codebook token ids (vocab 2048)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048, frontend="encodec-stub",
)
