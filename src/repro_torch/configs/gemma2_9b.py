"""gemma2-9b [dense]: local+global alternating attention, softcaps, sandwich
norms, tied 256k embeddings (arXiv:2408.00118)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256_000,
    sliding_window=4096, local_global=True,
    attn_softcap=50.0, logit_softcap=30.0, sandwich_norm=True,
    emb_scale=True, tie_embeddings=True,
)
