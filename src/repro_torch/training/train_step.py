"""LM train step: cross-entropy loss + Adam, grad-accumulation microbatching,
mixed precision, optional int8 gradient compression with error feedback.
The counterpart of ``repro.training.train_step``.

* Params live in the model dtype (bf16 for the assigned archs) with float32
  Adam moments: the float32 "master" information is (mu, nu, step).
* The global batch is split into ``grad_accum`` microbatches run one after
  another; their gradients are averaged in float32 (``g.float() /
  grad_accum`` added in microbatch order, as the reference's scan adds them).
* ``compress=True`` replaces the gradients by their per-tensor int8
  quantization Q(g + err) (scale absmax / 127, ``torch.round`` rounding half
  to even as ``jnp.round`` does) and carries the residual as the next
  step's error.

A ``TrainState``'s params are the model's parameters as an ordered tuple
(``TransformerLM`` parameter order); the step is functional, as the
reference's: it binds them into a parameter-less ``TransformerLM`` skeleton
(``load_state_dict(assign=True)``, no copy), takes the gradients with
``torch.autograd.grad`` and returns new tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.models.model import TransformerLM, lm_loss
from repro_torch.optim import AdamState, adam_init, adam_update


class TrainState(NamedTuple):
    params: tuple
    opt: AdamState
    step: int


def train_state_init(params) -> TrainState:
    """A fresh state over ``params``: a ``TransformerLM`` or its parameters
    as an ordered tuple (detached; the state shares their storage)."""
    if isinstance(params, torch.nn.Module):
        params = params.parameters()
    params = tuple(p.detach() for p in params)
    return TrainState(params=params, opt=adam_init(params), step=0)


def _compress_int8(grads, err):
    """Deterministic int8 quantization with error feedback: g is replaced by
    Q(g + err), and the residual (g + err) - Q(...) becomes the new error
    (float32). Scales are per-tensor absmax / 127."""
    out, new_err = [], []
    for g, e in zip(grads, err):
        t = g.float() + e
        scale = torch.clamp_min(t.abs().max(), 1e-12) / 127.0
        deq = torch.clamp(torch.round(t / scale), -127, 127) * scale
        out.append(deq.to(g.dtype))
        new_err.append(t - deq)
    return tuple(out), tuple(new_err)


def _bind(cfg, params, tp: int = 1) -> TransformerLM:
    """A ``TransformerLM`` (experts padded for ``tp``) whose parameters are
    ``params`` (no copy)."""
    model = TransformerLM(cfg, device="meta", tp=tp)
    names = []
    for (name, skel), p in zip(model.named_parameters(), params):
        if skel.shape != p.shape:
            raise ValueError(f"{name}: shape {tuple(p.shape)}, the model at tp={tp} has "
                             f"{tuple(skel.shape)} (an MoE's experts are padded for tp)")
        names.append(name)
    model.load_state_dict(dict(zip(names, params)), assign=True)
    return model


def _batch(x, device) -> torch.Tensor:
    return x.to(device) if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x),
                                                                             device=device)


def make_train_step(cfg, tp: int = 1, lr: float = 3e-4, grad_accum: int = 1,
                    weight_decay: float = 0.0, compress: bool = False):
    """Build ``step(state, tokens, labels, compress_err=None) -> (state,
    metrics)`` (``(state, metrics, compress_err)`` with ``compress``).

    tokens / labels: (global_batch, seq) int (numpy or tensors), moved to
    the params' device. With ``grad_accum > 1`` microbatch i is rows
    [i * micro, (i + 1) * micro). ``metrics``: ``loss`` and ``grad_norm``
    (the float32 norm of the applied gradients), float32 scalar tensors.
    ``tp`` is the model axis: the params carry ``padded_experts(cfg, tp)``
    experts in an MoE stack (the reference's ``init_params(key, cfg, tp)``);
    nothing else of the step depends on it."""

    def step(state: TrainState, tokens, labels, compress_err=None):
        device = state.params[0].device
        tokens, labels = _batch(tokens, device), _batch(labels, device)
        b = tokens.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} is not a multiple of grad_accum {grad_accum}")
        micro = b // grad_accum
        model = _bind(cfg, state.params, tp)
        leaves = tuple(model.parameters())

        if grad_accum == 1:
            loss = lm_loss(model, tokens, labels, tp=tp)
            grads = torch.autograd.grad(loss, leaves)
            loss = loss.detach()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=device)
            grads = tuple(torch.zeros(p.shape, dtype=torch.float32, device=device)
                          for p in state.params)
            for i in range(grad_accum):
                rows = slice(i * micro, (i + 1) * micro)
                lo = lm_loss(model, tokens[rows], labels[rows], tp=tp)
                for acc, g in zip(grads, torch.autograd.grad(lo, leaves)):
                    acc.add_(g.float() / grad_accum)
                loss = loss + lo.detach() / grad_accum
        del model, leaves

        if compress:
            if compress_err is None:
                compress_err = tuple(torch.zeros(p.shape, dtype=torch.float32, device=device)
                                     for p in state.params)
            grads, compress_err = _compress_int8(grads, compress_err)

        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        params, opt = adam_update(grads, state.opt, state.params, lr,
                                  weight_decay=weight_decay)
        new_state = TrainState(params=tuple(params), opt=opt, step=state.step + 1)
        metrics = {"loss": loss, "grad_norm": gnorm}
        if compress:
            return new_state, metrics, compress_err
        return new_state, metrics

    return step
