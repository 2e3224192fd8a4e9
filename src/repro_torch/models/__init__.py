"""The LM substrate for serving: dense global-attention decoders."""
from .model import (
    TransformerLM, embed_tokens, init_params, logits_fn, make_empty_cache, model_dtype,
    prefill_step, serve_step,
)

__all__ = [
    "TransformerLM", "embed_tokens", "init_params", "logits_fn", "make_empty_cache",
    "model_dtype", "prefill_step", "serve_step",
]
