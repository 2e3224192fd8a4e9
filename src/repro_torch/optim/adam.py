"""Adam and AdamW over a tuple of tensors, as written in ``repro.optim.adam``.

Moments are kept in float32 regardless of the parameter dtype, and the
update itself is taken in float32 and cast back to the parameter dtype,
exactly as the reference does. ``torch.optim.Adam`` keeps its moments at
the parameter dtype and would drift off the reference trajectory.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdamState(NamedTuple):
    step: int
    mu: tuple   # like params, float32
    nu: tuple   # like params, float32


def adam_init(params) -> AdamState:
    z = tuple(torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in params)
    return AdamState(step=0, mu=z, nu=tuple(t.clone() for t in z))


def adam_update(grads, state: AdamState, params, lr, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-8, weight_decay: float = 0.0):
    """Returns ``(new_params, new_state)``; ``params`` is a tuple of tensors
    (or a NamedTuple such as ``KernelParams``, whose type is kept)."""
    step = state.step + 1
    device = params[0].device
    t = torch.tensor(float(step), dtype=torch.float32, device=device)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    new_p, new_m, new_v = [], [], []
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            g32 = g.to(torch.float32)
            m = b1 * m + (1.0 - b1) * g32
            v = b2 * v + (1.0 - b2) * (g32 * g32)
            update = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                update = update + weight_decay * p.to(torch.float32)
            new_p.append((p.to(torch.float32) - lr * update).to(p.dtype))
            new_m.append(m)
            new_v.append(v)
    out = type(params)(*new_p) if hasattr(params, "_fields") else tuple(new_p)
    return out, AdamState(step=step, mu=tuple(new_m), nu=tuple(new_v))


def adamw_update(grads, state: AdamState, params, lr, weight_decay: float = 0.1, **kw):
    """Adam with decoupled weight decay (default 0.1), the reference's
    ``adamw_update``."""
    return adam_update(grads, state, params, lr, weight_decay=weight_decay, **kw)
