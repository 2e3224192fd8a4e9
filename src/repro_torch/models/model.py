"""LM wrapper: embeddings, the chunked training loss, the output head,
prefill and decode steps. The counterpart of ``repro.models.model``.

``lm_loss`` streams the output projection and cross-entropy over sequence
chunks of ``_LOSS_CHUNK`` tokens, each under ``torch.utils.checkpoint``, so
the (B, S, V) logits never exist at once (at internlm2's 92,544-token vocab
and 4 x 2048 tokens they would take 3 GB in f32).

A model bound to a shard context (``sharding.placement.shard_model``) holds
the vocabulary split over 'model' (``embed`` is ``P(model, fsdp)``, the
head ``P(fsdp, model)``; tied embeddings read the embed's shard):
``embed_tokens`` looks up the rows of its vocabulary block, zeros the
others and all-reduces over 'model'; the loss is the vocab-parallel cross
entropy (each row's max and sum of exponents all-reduced over 'model', the
label's logit picked by the rank that holds it); ``logits_fn`` all-gathers
the logits over 'model'. ``lm_loss`` then takes this rank's rows and
returns the mean over the global batch (summed over the data axes), so its
gradient is the whole step's.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .layers import cross_entropy, rms_norm, softcap
from .transformer import AttnBlock, decode_step, forward_train, init_cache, make_layers, prefill

_LOSS_CHUNK = 512


def model_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class TransformerLM(nn.Module):
    """``embed`` (V, D), ``layers`` (an ``nn.ModuleList`` of the blocks of
    ``cfg.block_kind``: ``AttnBlock``, ``MambaBlock`` or ``RwkvBlock``), the
    hybrid's ``shared_attn`` (an ``AttnBlock`` when ``cfg.attn_every``, else
    None),
    ``ln_f`` (D,) in f32, and ``lm_head`` (D, V) unless the config ties the
    embeddings (then the head is ``embed.T``). Parameters are allocated
    uninitialised; ``init_params`` draws them. The matrices take ``dtype``,
    by default the config's. ``tp`` pads an MoE's experts to a multiple of
    it (``transformer.padded_experts``), as the reference's ``init_params(
    key, cfg, tp)`` does; no other parameter depends on it."""

    shard = None

    def __init__(self, cfg, *, device=None, dtype=None, tp: int = 1):
        super().__init__()
        self.cfg = cfg
        dtype = dtype or model_dtype(cfg)
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model, dtype=dtype, device=device))
        self.layers = make_layers(cfg, tp=tp, dtype=dtype, device=device)
        self.shared_attn = (AttnBlock(cfg, tp=tp, dtype=dtype, device=device)
                            if cfg.attn_every else None)
        self.ln_f = nn.Parameter(torch.zeros(cfg.d_model, dtype=torch.float32, device=device))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab, dtype=dtype,
                                                    device=device))

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def head_matrix(self) -> torch.Tensor:
        """(D, V): the head, or ``embed.T`` with tied embeddings; sharded,
        gathered over the data axes: (D, V / tp), this rank's vocabulary."""
        sh = self.shard
        if sh is None:
            return self.embed.T if self.cfg.tie_embeddings else self.lm_head
        if self.cfg.tie_embeddings:
            return sh.fsdp(self.embed, sh.specs["embed"]).T
        return sh.fsdp(self.lm_head, sh.specs["lm_head"])

    def vocab_block(self) -> tuple[int, int]:
        """(first token, count) of this rank's vocabulary block."""
        if self.shard is None:
            return 0, self.cfg.vocab
        n = self.cfg.vocab // self.shard.tp
        return self.shard.tp_index * n, n

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's distributions: ``normal * 0.02`` for the embedding
        and the head, ``d_in ** -0.5`` for the dense layers (``d_ff ** -0.5``
        and ``(H hd) ** -0.5`` for the down and output projections), the
        MoE's, mamba2's and rwkv6's as ``models.moe.MoE``, ``models.ssm.
        Mamba2`` and ``models.rwkv6.RWKV6`` draw them, zero norms."""
        with torch.no_grad():
            draw = lambda w: torch.randn(w.shape, generator=generator, dtype=torch.float32,
                                         device=w.device)
            self.embed.copy_(draw(self.embed) * 0.02)
            for layer in self.layers:
                layer.reset_parameters(generator)
            if self.shared_attn is not None:
                self.shared_attn.reset_parameters(generator)
            self.ln_f.zero_()
            if not self.cfg.tie_embeddings:
                self.lm_head.copy_(draw(self.lm_head) * 0.02)


def init_params(cfg, generator: torch.Generator, device=None, tp: int = 1) -> TransformerLM:
    """A ``TransformerLM`` (experts padded for ``tp``) with weights drawn
    from ``generator`` (which must live on ``device``) at the reference's
    distributions. The draws are the port's own: the same seed does not
    give the reference's weights (carry those across with
    ``repro_torch.convert.lm_params_from_reference``)."""
    model = TransformerLM(cfg, device=device, tp=tp)
    model.reset_parameters(generator)
    return model


def embed_tokens(model: TransformerLM, tokens: torch.Tensor) -> torch.Tensor:
    sh = model.shard
    if sh is None:
        x = model.embed[tokens.long()]
    else:
        v0, n = model.vocab_block()
        local = tokens.long() - v0
        inside = ((local >= 0) & (local < n))[..., None]
        rows = sh.fsdp(model.embed, sh.specs["embed"])[local.clamp(0, n - 1)]
        x = sh.sum_model(torch.where(inside, rows, 0))  # one rank adds its row: exact
    if model.cfg.emb_scale:
        # The reference casts sqrt(d_model) to the activation dtype first.
        x = x * float(torch.tensor(model.cfg.d_model ** 0.5, dtype=x.dtype))
    return x


def logits_fn(model: TransformerLM, hidden: torch.Tensor) -> torch.Tensor:
    """``hidden @ head`` in the model dtype, then f32 and the final softcap
    (sharded: each rank's vocabulary block, all-gathered over 'model')."""
    sh = model.shard
    if sh is None:
        return softcap((hidden @ model.head_matrix()).float(), model.cfg.logit_softcap)
    local = softcap((sh.to_model(hidden) @ model.head_matrix()).float(), model.cfg.logit_softcap)
    return sh.gather_model(local, -1)


def _chunk_loss(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                cap: float) -> torch.Tensor:
    return cross_entropy(softcap((h @ head).float(), cap), labels)


def _chunk_loss_sharded(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor, cap: float,
                        shard, v0: int) -> torch.Tensor:
    """Vocab-parallel cross entropy of this rank's rows: the mean over them
    of logsumexp - the label's logit, with ``head`` this rank's (D, n)
    vocabulary block from token ``v0``."""
    logits = softcap((shard.to_model(h) @ head).float(), cap)
    n = logits.shape[-1]
    m = shard.max_model(logits.amax(-1))
    lse = m + torch.log(shard.sum_model(torch.exp(logits - m[..., None]).sum(-1)))
    local = labels.long() - v0
    inside = (local >= 0) & (local < n)
    pick = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = shard.sum_model(torch.where(inside, pick, 0.0))
    return torch.mean(lse - gold)


def lm_loss(model: TransformerLM, tokens: torch.Tensor, labels: torch.Tensor, tp: int = 1,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Mean next-token cross-entropy (f32 scalar) of tokens (B, S) against
    labels (B, S); the loss head runs chunk by chunk over the sequence and
    the chunk means are summed in f32 in order and divided by their count,
    as the reference's scan does. MoE stacks add ``aux_weight`` times the
    router's load-balancing loss summed over layers, divided by the layer
    count. ``tp`` must match the model's padded experts. Sharded, tokens
    and labels are this rank's rows (``placement.shard_batch``; the global
    batch divides over the data axes) and the loss is the global batch's
    mean on every rank."""
    cfg = model.cfg
    sh = model.shard
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    x = embed_tokens(model, tokens)
    hidden, aux = forward_train(model.layers, x, cfg, positions, tp, model.shared_attn)
    hidden = rms_norm(hidden, model.ln_f, cfg.norm_eps)
    head = model.head_matrix()
    chunk = min(_LOSS_CHUNK, s)
    if s % chunk:
        raise ValueError(f"lm_loss: sequence length {s} is not a multiple of {chunk}")
    fn, extra = ((_chunk_loss, ()) if sh is None
                 else (_chunk_loss_sharded, (sh, model.vocab_block()[0])))
    total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for c in range(0, s, chunk):
        total = total + checkpoint(fn, hidden[:, c:c + chunk], head, labels[:, c:c + chunk],
                                   cfg.logit_softcap, *extra,
                                   use_reentrant=False, preserve_rng_state=False)
    loss = total / (s // chunk)
    if sh is not None:
        n_data = 1
        for axis in sh.dp:
            n_data *= sh.mesh.shape[axis]
        loss = sh.sum_data(loss / n_data)
    if cfg.n_experts:
        loss = loss + aux_weight * aux / cfg.n_layers
    return loss


def prefill_step(model: TransformerLM, tokens: torch.Tensor, cache_len: int, tp: int = 1):
    """Prompt forward: tokens (B, S) -> (last-token logits (B, V) f32, cache);
    the cache's KV heads expanded for ``tp`` (``transformer.prefill``)."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    x = embed_tokens(model, tokens)
    hidden, cache = prefill(model.layers, x, model.cfg, positions, cache_len, model.shared_attn,
                            tp)
    hidden = rms_norm(hidden[:, -1:], model.ln_f, model.cfg.norm_eps)
    return logits_fn(model, hidden)[:, 0], cache


def serve_step(model: TransformerLM, tokens: torch.Tensor, cache: dict, tp: int = 1):
    """One decode step: tokens (B, 1) -> (logits (B, V) f32, cache)."""
    x = embed_tokens(model, tokens)
    hidden, cache = decode_step(model.layers, x, model.cfg, cache, model.shared_attn, tp)
    hidden = rms_norm(hidden, model.ln_f, model.cfg.norm_eps)
    return logits_fn(model, hidden)[:, 0], cache


def make_empty_cache(model: TransformerLM, batch: int, cache_len: int, tp: int = 1) -> dict:
    """An empty cache for a ``batch`` (global) of ``cache_len`` slots; a
    sharded model's holds its rank's block."""
    return init_cache(model.cfg, batch, cache_len, model.dtype, model.device, tp, model.shard)
