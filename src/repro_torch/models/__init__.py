"""The LM substrate: attention decoders (dense, gemma2's local/global, MoE), for
training and serving."""
from .model import (
    TransformerLM, embed_tokens, init_params, lm_loss, logits_fn, make_empty_cache, model_dtype,
    prefill_step, serve_step,
)

__all__ = [
    "TransformerLM", "embed_tokens", "init_params", "lm_loss", "logits_fn", "make_empty_cache",
    "model_dtype", "prefill_step", "serve_step",
]
