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

Bound to a shard context (``sharding.placement``), the experts are split
over 'model' (EP: rank i of a model group owns experts [i E_p / tp, (i +
1) E_p / tp), their D dimension split over the data axes) and the tokens
are whole over 'model' (the Megatron layout of the residual stream), so the
dispatch stays local: every rank of a model group routes the same tokens
with the same f32 router (gathered over the data axes, whole over
'model'), copies only the kept (token, choice) rows of its own experts
into its (E_p / tp, G * C, D) buffer, runs its experts, and forms its
partial combine, a fixed-order f32 sum over its own choices. That partial
and the shared expert's row-parallel partial are summed over 'model' in one
f32 rank-order all-reduce: the reference's g -> e einsum, an all-to-all
only where tokens are split over 'model', is that sum here. Three things
keep the gradient whole:

* the router reads x as it is, and only the dispatch and the shared expert
  read ``to_model(x)``, whose backward sums their partial dx over 'model':
  the router's dx, alike on every rank of a group, is counted once;
* the gates enter the combine through ``to_model``: a rank's combine reads
  the gates of its own experts' choices only, so their gradient is summed
  over 'model' before it reaches the router;
* the load-balancing loss sums its token and probability fractions over
  the data axes before their product (the product of means is not the
  mean of the products).

The group size comes from the global token count (``group_size`` of the
local count times the data axes' size), so capacity and drops are the
whole run's. Groups follow the reference's (b, s) order over the global
batch, in which a rank's tokens are one contiguous run. Where a group is
larger than a rank's run (a short prompt, or a decode step: 2 tokens a rank
against a group of 4 at 2 x 2), it straddles the data split: the rank
gathers the f32 router logits over the data axes, routes every group its
tokens fall in exactly as ``route`` does (capacity, slots and the cumsum
over the group's tokens), and keeps its own tokens' dispatch and combine
(``_straddling_routing``). The other ranks' logits enter as constants, so
the gradient reaches this rank's own. The load-balancing loss reads only a
token's own selection and probabilities, so it stays the sum over the data
axes of each rank's tokens' terms: the reference's value. Where the model
axis does not divide ``shared_d_ff`` the shared expert is replicated over
'model' and runs whole on every rank, added after the sum.
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


def switch_aux(r: Routing, e_real: int, k: int, shard=None) -> torch.Tensor:
    """The Switch load-balancing loss from the pre-drop selection. With a
    shard context the fractions are the global batch's: the per-expert
    counts and probability sums are summed over the data axes first."""
    if shard is None or shard.n_data == 1:
        frac_tokens = torch.mean(r.selected.float(), dim=(0, 1))
        frac_probs = torch.mean(r.probs, dim=(0, 1))
    else:
        sums = shard.sum_data(torch.stack([r.selected.float().sum(dim=(0, 1)),
                                           r.probs.sum(dim=(0, 1))]), tag="moe_aux")
        frac_tokens, frac_probs = sums / (r.probs.shape[0] * r.probs.shape[1] * shard.n_data)
    return e_real * torch.sum(frac_tokens * frac_probs) / k


class MoE(nn.Module):
    """``router`` (d, E) in f32, ``w_gate`` / ``w_up`` (E, d, f) and
    ``w_down`` (E, f, d) in the model dtype, and a SwiGLU ``shared`` MLP
    when ``cfg.shared_d_ff``. E is ``n_experts_padded`` (default
    ``cfg.n_experts``), as the reference pads the experts to its model
    axis; tokens route only to the first ``cfg.n_experts``. Bound to a
    shard context the expert leaves hold this rank's E / tp experts."""

    shard = None

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

    def logits(self, x: torch.Tensor, router: torch.Tensor | None = None) -> torch.Tensor:
        """x (..., D) -> the f32 router logits (..., E) (``routing``)."""
        e_real = self.cfg.n_experts
        router = self.router if router is None else router
        logits = (x @ router[:, :e_real].to(x.dtype)).float()
        if self.n_experts > e_real:
            logits = F.pad(logits, (0, self.n_experts - e_real), value=-1e30)
        return logits

    def routing(self, x: torch.Tensor, gs: int | None = None,
                router: torch.Tensor | None = None) -> Routing:
        """x (B, S, D) -> the routing of its token groups of ``gs`` tokens
        (default ``group_size(B S)``); router logits in x's dtype, then
        f32. Only the real experts' logits are computed: the padded ones are
        -1e30 whatever their column holds (``route``), so a padded router
        gives the real experts the logits of the unpadded one bit for bit
        (the product's kernel may differ with the column count). ``router``
        is the whole (d, E) router where ``self.router`` is a shard."""
        b, s, d = x.shape
        gs = gs or group_size(b * s)
        return route(self.logits(x.reshape(-1, gs, d), router), self.cfg.n_experts,
                     self.cfg.n_experts_active, self.cfg.capacity_factor)

    def _straddling_routing(self, x: torch.Tensor, gs: int, router: torch.Tensor):
        """This rank's tokens' routing where their groups of ``gs`` tokens
        straddle the data split (the module docstring): a ``Routing`` of
        shape (1, B S, ...) and, for ``_combine``, each token's group (B S,)
        and the group count."""
        sh = self.shard
        t = x.shape[0] * x.shape[1]
        logits = self.logits(x.reshape(t, -1), router)
        whole = sh.gather_data(logits.detach())                         # (T, E), (b, s) order
        o = sh.data_index * t
        g0, g1 = o // gs, -(-(o + t) // gs)
        span = torch.cat([whole[g0 * gs:o], logits, whole[o + t:g1 * gs]])
        r = route(span.view(g1 - g0, gs, -1), self.cfg.n_experts, self.cfg.n_experts_active,
                  self.cfg.capacity_factor)
        mine = lambda f: f.reshape(-1, f.shape[-1])[o - g0 * gs:o - g0 * gs + t][None]
        group = torch.arange(o, o + t, device=x.device) // gs - g0
        return Routing(*map(mine, r[:6]), r.capacity), (group, g1 - g0)

    def _combine(self, x: torch.Tensor, r: Routing, e0: int, gate: torch.Tensor,
                 weights, groups=None) -> torch.Tensor:
        """Experts [e0, e0 + E_w) (``weights``: their w_gate, w_up, w_down)
        on x (B, S, D) under routing ``r``: each token's rows weighted by
        ``gate`` and summed over its k choices in f32, a choice of another
        expert adding nothing. ``groups``: (each token's group, the group
        count) where ``r`` is not laid out by group (a straddling group's).
        Returns (B S, D) f32."""
        w_gate, w_up, w_down = weights
        b, s, d = x.shape
        n_groups, gs, k = r.expert.shape
        e, c = w_gate.shape[0], r.capacity
        # Row of each (token, choice) in the (E_w * G * C) expert buffer; a
        # dropped choice, or one of another rank's expert, points at the
        # spare row E_w * G * C, cut off before the experts run.
        if groups is None:
            group = torch.arange(n_groups, device=x.device)[:, None, None]
        else:
            group, n_groups = groups[0].view(1, -1, 1), groups[1]
        spare = e * n_groups * c
        local = r.expert - e0
        mine = r.keep & (local >= 0) & (local < e)
        rows = torch.where(mine, (local * n_groups + group) * c + r.slot, spare).reshape(-1)
        token = torch.arange(b * s, device=x.device).repeat_interleave(k)
        xf = x.reshape(b * s, d)
        xe = x.new_zeros(spare + 1, d).index_copy(0, rows, xf[token])[:spare]
        xe = xe.view(e, n_groups * c, d)
        h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
        ye = torch.bmm(h, w_down).reshape(spare, d)                       # (E_w G C, D)
        ye = torch.cat([ye, ye.new_zeros(1, d)])
        # (token, choice) rows are token-major, so each token's k weighted
        # rows sum in a fixed order (index_add's CUDA atomics would not).
        contrib = ye[rows].float() * gate.reshape(-1, 1).to(x.dtype).float()
        return contrib.view(b * s, k, d).sum(1)

    def forward(self, x: torch.Tensor):
        """x (B, S, D) -> ``(out (B, S, D), aux)`` (``moe_forward``)."""
        if self.shard is not None:
            return self._forward_sharded(x)
        b, s, d = x.shape
        r = self.routing(x)
        out = self._combine(x, r, 0, r.gate, (self.w_gate, self.w_up, self.w_down))
        out = out.to(x.dtype).reshape(b, s, d)
        aux = switch_aux(r, self.cfg.n_experts, r.expert.shape[-1])
        if self.cfg.shared_d_ff:
            out = out + self.shared(x)
        return out, aux

    def _forward_sharded(self, x: torch.Tensor):
        """This rank's rows x (B, S, D), whole over 'model' -> ``(out, aux)``
        (the module docstring)."""
        sh = self.shard
        b, s, d = x.shape
        gs = group_size(b * s * sh.n_data)
        router = sh.fsdp(self.router, self.specs["router"])
        if (b * s) % gs:
            r, groups = self._straddling_routing(x, gs, router)
        else:
            r, groups = self.routing(x, gs, router), None
        xm = sh.to_model(x)
        weights = [sh.fsdp(getattr(self, n), self.specs[n]) for n in ("w_gate", "w_up", "w_down")]
        e0 = sh.tp_index * weights[0].shape[0]
        part = self._combine(xm, r, e0, sh.to_model(r.gate, tag="moe_gate"), weights, groups)
        shared_split = self.cfg.shared_d_ff and self.shared.split
        if shared_split:
            part = part + self.shared.partial(xm).reshape(b * s, d)
        out = sh.sum_model(part, out_dtype=x.dtype, tag="moe").reshape(b, s, d)
        if self.cfg.shared_d_ff and not shared_split:
            out = out + self.shared(x)
        return out, switch_aux(r, self.cfg.n_experts, r.expert.shape[-1], sh)
