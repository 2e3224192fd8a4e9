"""Top-k mixture of experts with per-group capacity (+ a shared expert).
The counterpart of ``repro.models.moe``.

Tokens are flattened in (b, s) order into groups of ``_GROUP``; each group
routes its tokens by k rounds of argmax over the router's softmax, keeps
each expert's first ``capacity`` assignments in token order and drops the
rest, as the reference's one-hot dispatch does. The port keeps exactly the
reference's kept (token, expert, slot) triples but dispatches by index: the
kept tokens are copied into an (E, G * C, D) buffer at row ``g * C +
slot`` of their expert (the reference's ``einsum("gtec,gtd->egcd")``
layout, empty slots zero), the experts run as three batched matmuls, and
each token gathers its experts' rows back, weighted by its gates and
summed over its k choices in f32 in a fixed order (the same rounding on the
card on every run), instead of two one-hot einsums. Every shape is
fixed by (B, S), so nothing waits for the device. Padded experts
(``n_experts_padded`` > ``n_experts``, a mesh's model axis) get router
logits of -1e30 and are never chosen; they still run in the batched expert
products, on empty slots, as the reference's einsums run them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import MLP, dense_init_

_GROUP = 1024  # tokens per dispatch group


class Routing(NamedTuple):
    """One call's routing, per group: ``expert``, ``slot`` and ``keep``
    (G, gs, k) for each token's k chosen experts in the order chosen,
    ``gate`` (G, gs, k) f32 (renormalised, 0 where dropped), ``probs``
    (G, gs, E) f32 and ``selected`` (G, gs, E) bool (before the capacity
    drop), and the capacity."""
    expert: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    probs: torch.Tensor
    selected: torch.Tensor
    capacity: int


def group_size(t: int) -> int:
    gs = min(_GROUP, t)
    if t % gs:
        raise ValueError(f"moe: {t} tokens are not a multiple of the group size {gs}")
    return gs


def route(logits: torch.Tensor, e_real: int, k: int, capacity_factor: float) -> Routing:
    """The reference's routing of router logits (G, gs, E) f32: softmax,
    top-k by k rounds of argmax (the first maximum wins, as ``jnp.argmax``),
    gates renormalised with a 1e-9 floor, per-group capacity ``max(int(cf
    * gs * k / e_real), 1)``, slots by a cumsum over the group's tokens,
    assignments at or past capacity dropped."""
    _, gs, e = logits.shape
    if e > e_real:
        pad = torch.arange(e, device=logits.device) >= e_real
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    gates = torch.zeros_like(probs)
    remaining = probs
    chosen = []
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1, keepdim=True)
        onehot = torch.zeros_like(probs).scatter_(-1, idx, 1.0)
        gates = gates + onehot * probs
        remaining = remaining * (1.0 - onehot)
        chosen.append(idx)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    capacity = max(int(capacity_factor * gs * k / e_real), 1)
    selected = gates > 0.0
    pos_in_e = torch.cumsum(selected.to(torch.int32), dim=1) - 1           # (G, gs, E)
    expert = torch.cat(chosen, dim=-1)                                      # (G, gs, k)
    slot = torch.gather(pos_in_e, -1, expert)
    keep = torch.gather(selected, -1, expert) & (slot < capacity)
    gate = torch.where(keep, torch.gather(gates, -1, expert), 0.0)
    return Routing(expert, slot, keep, gate, probs, selected, capacity)


def switch_aux(r: Routing, e_real: int, k: int) -> torch.Tensor:
    """The Switch load-balancing loss from the pre-drop selection."""
    frac_tokens = torch.mean(r.selected.float(), dim=(0, 1))
    frac_probs = torch.mean(r.probs, dim=(0, 1))
    return e_real * torch.sum(frac_tokens * frac_probs) / k


class MoE(nn.Module):
    """``router`` (d, E) in f32, ``w_gate`` / ``w_up`` (E, d, f) and
    ``w_down`` (E, f, d) in the model dtype, and a SwiGLU ``shared`` MLP
    when ``cfg.shared_d_ff``. E is ``n_experts_padded`` (default
    ``cfg.n_experts``), as the reference pads the experts to its model
    axis; tokens route only to the first ``cfg.n_experts``."""

    def __init__(self, cfg, n_experts_padded: int | None = None, *, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.cfg = cfg
        e = n_experts_padded or cfg.n_experts
        d, f = cfg.d_model, cfg.moe_d_ff
        self.router = nn.Parameter(torch.empty(d, e, dtype=torch.float32, device=device))
        self.w_gate = nn.Parameter(torch.empty(e, d, f, dtype=dtype, device=device))
        self.w_up = nn.Parameter(torch.empty(e, d, f, dtype=dtype, device=device))
        self.w_down = nn.Parameter(torch.empty(e, f, d, dtype=dtype, device=device))
        if cfg.shared_d_ff:
            self.shared = MLP(d, cfg.shared_d_ff, "swiglu", dtype=dtype, device=device)

    @property
    def n_experts(self) -> int:
        return self.router.shape[1]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's ``moe_init`` distributions: router ``0.02``,
        experts ``d ** -0.5`` (``f ** -0.5`` down)."""
        d, f = self.w_gate.shape[1:]
        dense_init_(self.router, generator, scale=0.02)
        dense_init_(self.w_gate, generator, scale=d ** -0.5)
        dense_init_(self.w_up, generator, scale=d ** -0.5)
        dense_init_(self.w_down, generator, scale=f ** -0.5)
        if self.cfg.shared_d_ff:
            self.shared.reset_parameters(generator)

    def routing(self, x: torch.Tensor) -> Routing:
        """x (B, S, D) -> the routing of its token groups; router logits in
        x's dtype, then f32. Only the real experts' logits are computed: the
        padded ones are -1e30 whatever their column holds (``route``), so a
        padded router gives the real experts the logits of the unpadded one
        bit for bit (the product's kernel may differ with the column count)."""
        b, s, d = x.shape
        gs = group_size(b * s)
        xt = x.reshape(-1, gs, d)
        e_real = self.cfg.n_experts
        logits = (xt @ self.router[:, :e_real].to(x.dtype)).float()
        if self.n_experts > e_real:
            logits = F.pad(logits, (0, self.n_experts - e_real), value=-1e30)
        return route(logits, e_real, self.cfg.n_experts_active, self.cfg.capacity_factor)

    def forward(self, x: torch.Tensor):
        """x (B, S, D) -> ``(out (B, S, D), aux)`` (``moe_forward``)."""
        b, s, d = x.shape
        r = self.routing(x)
        n_groups, gs, k = r.expert.shape
        e, c = self.n_experts, r.capacity
        # Row of each (token, choice) in the (E * G * C) expert buffer; a
        # dropped one points at the spare row E * G * C, cut off before the
        # experts run.
        group = torch.arange(n_groups, device=x.device)[:, None, None]
        spare = e * n_groups * c
        rows = torch.where(r.keep, (r.expert * n_groups + group) * c + r.slot, spare).reshape(-1)
        token = torch.arange(b * s, device=x.device).repeat_interleave(k)
        xf = x.reshape(b * s, d)
        xe = x.new_zeros(spare + 1, d).index_copy(0, rows, xf[token])[:spare]
        xe = xe.view(e, n_groups * c, d)
        h = F.silu(torch.bmm(xe, self.w_gate)) * torch.bmm(xe, self.w_up)
        ye = torch.bmm(h, self.w_down).reshape(spare, d)                  # (E G C, D)
        ye = torch.cat([ye, ye.new_zeros(1, d)])
        # (token, choice) rows are token-major, so each token's k weighted
        # rows sum in a fixed order (index_add's CUDA atomics would not).
        contrib = ye[rows].float() * r.gate.reshape(-1, 1).to(x.dtype).float()
        out = contrib.view(b * s, k, d).sum(1).to(x.dtype).reshape(b, s, d)
        aux = switch_aux(r, self.cfg.n_experts, k)
        if self.cfg.shared_d_ff:
            out = out + self.shared(x)
        return out, aux
