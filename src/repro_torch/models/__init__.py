"""The LM substrate: attention decoders (dense, gemma2's local/global, MoE), the
attention-free rwkv6 and the mamba2 / zamba2 hybrid stacks, for training and
serving."""
from .model import (
    TransformerLM, embed_tokens, init_params, lm_loss, logits_fn, make_empty_cache, model_dtype,
    prefill_step, serve_step,
)

__all__ = [
    "TransformerLM", "embed_tokens", "init_params", "lm_loss", "logits_fn", "make_empty_cache",
    "model_dtype", "prefill_step", "serve_step",
]
