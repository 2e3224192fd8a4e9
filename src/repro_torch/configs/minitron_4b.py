"""minitron-4b [dense]: pruned nemotron — squared-ReLU MLP, tied 256k
embeddings (arXiv:2407.14679)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab=256_000, mlp_kind="relu2", tie_embeddings=True,
)
