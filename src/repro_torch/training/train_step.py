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

Sharded (``make_train_step(..., comm=)``, a ``sharding.collectives.
MeshComm``), the state holds this rank's shards of the params and of the
Adam moments (the params' specs) and the step:

* takes the global batch and keeps this rank's rows (``batch_spec``; the
  batch must divide over the data axes); grad accumulation splits those
  rows into microbatches. The loss is the global batch's mean on every rank,
  so the gradient is the whole step's: the FSDP gathers' backward sums the
  split leaves' gradients over the data axes, and the leaves a data axis
  does not split (the norms) are all-reduced over it here;
* takes the int8 compression's per-tensor absmax as the max over every
  axis that splits the leaf, so the scale is the whole tensor's;
* forms ``grad_norm`` from each leaf's shards once: the sums of squares
  are summed over the axes that split the leaf, and a replicated leaf
  counts once;
* runs ``adam_update`` on the shards unchanged (it is elementwise).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.models.model import TransformerLM, lm_loss
from repro_torch.optim import AdamState, adam_init, adam_update
from repro_torch.sharding.collectives import entry_axes


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


def _compress_int8(grads, err, absmax=None):
    """Deterministic int8 quantization with error feedback: g is replaced by
    Q(g + err), and the residual (g + err) - Q(...) becomes the new error
    (float32). Scales are per-tensor absmax / 127; ``absmax(i, m)`` turns
    leaf i's local absmax m into the whole tensor's (sharded leaves)."""
    out, new_err = [], []
    for i, (g, e) in enumerate(zip(grads, err)):
        t = g.float() + e
        m = t.abs().max()
        scale = torch.clamp_min(m if absmax is None else absmax(i, m), 1e-12) / 127.0
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


def _split_axes(spec) -> tuple:
    """The mesh axes a spec splits its leaf over, in mesh order."""
    return tuple(a for entry in spec for a in entry_axes(entry))


def _sharded_grads(comm, specs, grads) -> tuple:
    """Sum each gradient over the data axes its leaf is not split over."""
    out = []
    for spec, g in zip(specs, grads):
        split = _split_axes(spec)
        for axis in comm.mesh.axis_names:
            if axis != "model" and axis not in split:
                g = comm.all_reduce(g, axis)
        out.append(g)
    return tuple(out)


def _sharded_norm(comm, specs, grads) -> torch.Tensor:
    """The whole gradients' f32 norm from their shards: each leaf's sum of
    squares summed over the axes that split it (leaves grouped by those
    axes, one all-reduce per group and axis), the same on every rank."""
    groups: dict = {}
    for spec, g in zip(specs, grads):
        groups.setdefault(_split_axes(spec), []).append(torch.sum(torch.square(g.float())))
    total = None
    for axes, sq in groups.items():
        part = comm.all_reduce_axes(torch.stack(sq), axes).sum()
        total = part if total is None else total + part
    return torch.sqrt(total)


def _batch(x, device) -> torch.Tensor:
    return x.to(device) if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x),
                                                                             device=device)


def make_train_step(cfg, tp: int = 1, lr: float = 3e-4, grad_accum: int = 1,
                    weight_decay: float = 0.0, compress: bool = False, comm=None):
    """Build ``step(state, tokens, labels, compress_err=None) -> (state,
    metrics)`` (``(state, metrics, compress_err)`` with ``compress``).

    tokens / labels: (global_batch, seq) int (numpy or tensors), moved to
    the params' device. With ``grad_accum > 1`` microbatch i is rows
    [i * micro, (i + 1) * micro). ``metrics``: ``loss`` and ``grad_norm``
    (the float32 norm of the applied gradients), float32 scalar tensors.
    ``tp`` is the model axis: the params carry ``padded_experts(cfg, tp)``
    experts in an MoE stack (the reference's ``init_params(key, cfg, tp)``);
    nothing else of the step depends on it. With ``comm`` the state holds
    this rank's shards (the module docstring); ``tp`` is then the mesh's."""
    if comm is not None:
        from repro_torch.sharding.placement import bind_shards, shard_batch
        from repro_torch.sharding.rules import batch_spec

        tp = comm.mesh.shape.get("model", 1)

    def step(state: TrainState, tokens, labels, compress_err=None):
        device = state.params[0].device
        tokens, labels = _batch(tokens, device), _batch(labels, device)
        if comm is not None:
            if batch_spec(comm.mesh, tokens.shape[0])[0] is None:
                raise ValueError(f"batch {tokens.shape[0]} does not divide over the data axes "
                                 f"of the {comm.mesh} mesh")
            tokens, labels = (shard_batch(t, comm.mesh, comm.rank) for t in (tokens, labels))
            model = bind_shards(cfg, state.params, comm.mesh, comm.rank, comm)
            specs = [model.shard.specs[name] for name, _ in model.named_parameters()]
        else:
            model = _bind(cfg, state.params, tp)
        b = tokens.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} is not a multiple of grad_accum {grad_accum}")
        micro = b // grad_accum
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
        if comm is not None:
            grads = _sharded_grads(comm, specs, grads)

        if compress:
            if compress_err is None:
                compress_err = tuple(torch.zeros(p.shape, dtype=torch.float32, device=device)
                                     for p in state.params)
            absmax = (None if comm is None else
                      lambda i, m: comm.all_reduce_axes(m, _split_axes(specs[i]), "max"))
            grads, compress_err = _compress_int8(grads, compress_err, absmax)

        if comm is None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))
        else:
            gnorm = _sharded_norm(comm, specs, grads)
        params, opt = adam_update(grads, state.opt, state.params, lr,
                                  weight_decay=weight_decay)
        new_state = TrainState(params=tuple(params), opt=opt, step=state.step + 1)
        metrics = {"loss": loss, "grad_norm": gnorm}
        if compress:
            return new_state, metrics, compress_err
        return new_state, metrics

    return step
