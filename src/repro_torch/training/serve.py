"""Serving steps: prefill (prompt -> cache) and greedy decode, one token at a
time. The counterpart of ``repro.training.serve``; every step runs under
``torch.inference_mode``. ``tp`` is the model axis the reference's steps
take: the model's padded experts and the decode cache's head expansion."""
from __future__ import annotations

import torch

from repro_torch.models.model import prefill_step, serve_step


def make_prefill_step(cfg, cache_len: int, tp: int = 1):
    @torch.inference_mode()
    def step(model, tokens):
        return prefill_step(model, tokens, cache_len, tp=tp)

    return step


def make_decode_step(cfg, tp: int = 1):
    @torch.inference_mode()
    def step(model, tokens, cache):
        logits, cache = serve_step(model, tokens, cache, tp=tp)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_tok, logits, cache

    return step


@torch.inference_mode()
def greedy_generate(model, prompt: torch.Tensor, cfg, max_new: int,
                    cache_len: int, tp: int = 1) -> torch.Tensor:
    """Prefill ``prompt`` (B, S), then ``max_new - 1`` greedy decode steps:
    (B, max_new) int32 tokens, the first from the prefill's logits."""
    logits, cache = prefill_step(model, prompt, cache_len, tp=tp)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    out = [tok]
    decode = make_decode_step(cfg, tp)
    for _ in range(max_new - 1):
        tok, _, cache = decode(model, tok, cache)
        out.append(tok)
    return torch.cat(out, dim=1)
