"""Carry parameters between this package and the JAX package.

The JAX package's ``KernelParams`` leaves (``log_sigma2``, ``log_beta``,
``log_nugget``) and ``MultiOutputParams`` leaves (``log_sigma2`` (p,),
``log_beta``, ``log_tau2``) travel as numpy arrays, so neither package
imports the other. Packed structures are numpy on both sides and need no
conversion. So does the LM's parameter pytree (``lm_params_from_reference``,
``lm_params_to_reference``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kernels_math import KernelParams
from repro_torch.core.multioutput import MultiOutputParams
from repro_torch.models.model import TransformerLM


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float64)).to(device=device, dtype=dtype)


def params_from_reference(log_sigma2, log_beta, log_nugget, device="cpu",
                          dtype=torch.float64) -> KernelParams:
    """This package's ``KernelParams`` from the reference's log-space leaves."""
    t = lambda a: _tensor(a, device, dtype)
    return KernelParams(log_sigma2=t(log_sigma2), log_beta=t(log_beta),
                        log_nugget=t(log_nugget))


def params_to_reference(params: KernelParams) -> tuple:
    """``(log_sigma2, log_beta, log_nugget)`` as float64 numpy arrays, the
    leaves of the reference's ``KernelParams``."""
    return tuple(np.asarray(a.detach().cpu().numpy(), dtype=np.float64) for a in params)


def multi_params_from_reference(log_sigma2, log_beta, log_tau2, device="cpu",
                                dtype=torch.float64) -> MultiOutputParams:
    """This package's ``MultiOutputParams`` from the reference's leaves."""
    t = lambda a: _tensor(a, device, dtype)
    return MultiOutputParams(log_sigma2=t(log_sigma2), log_beta=t(log_beta),
                             log_tau2=t(log_tau2))


def multi_params_to_reference(params: MultiOutputParams) -> tuple:
    """``(log_sigma2, log_beta, log_tau2)`` as float64 numpy arrays, the
    leaves of the reference's ``MultiOutputParams``."""
    return params_to_reference(params)


def _flatten(tree, prefix=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _reference_path(name: str) -> tuple[tuple, int | None]:
    """The reference leaf of parameter ``name``, and its layer index: the
    per-layer leaves are stacked on a leading L axis under
    ``["stack"]["layers"]``."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ("stack", "layers") + tuple(parts[2:]), int(parts[1])
    return tuple(parts), None


def lm_params_from_reference(tree, cfg, device="cpu", dtype=None) -> TransformerLM:
    """A ``TransformerLM`` holding the reference's parameter pytree.

    ``tree`` is the reference's ``init_params`` output with numpy leaves.
    numpy has no bf16, so the caller passes bf16 leaves as
    ``np.asarray(leaf, np.float32)``: that widening is exact, and so is the
    cast back to ``torch.bfloat16`` here. The matrices land at ``dtype``
    (default: the config's), the norms in f32, as in the reference. Every
    leaf of ``tree`` must have a parameter and the same shape."""
    model = TransformerLM(cfg, device=device, dtype=dtype)
    leaves = _flatten(tree)
    used = set()
    with torch.no_grad():
        for name, param in model.named_parameters():
            path, layer = _reference_path(name)
            if path not in leaves:
                raise KeyError(f"reference tree has no leaf {'/'.join(path)} for {name}")
            a = np.asarray(leaves[path])
            if layer is not None:
                a = a[layer]
            if tuple(a.shape) != tuple(param.shape):
                raise ValueError(f"{name}: reference shape {a.shape}, port {tuple(param.shape)}")
            param.copy_(torch.tensor(a).to(param.dtype))
            used.add(path)
    extra = sorted("/".join(p) for p in set(leaves) - used)
    if extra:
        raise ValueError(f"reference leaves without a port parameter: {extra}")
    return model


def lm_params_to_reference(model: TransformerLM) -> dict:
    """The reference's parameter pytree, as float32 numpy leaves (bf16
    values widen exactly), per-layer leaves stacked on a leading L axis."""
    layered: dict = {}
    tree: dict = {}
    for name, param in model.named_parameters():
        path, layer = _reference_path(name)
        a = param.detach().float().cpu().numpy()
        if layer is None:
            tree[path[0]] = a
        else:
            layered.setdefault(path, []).append(a)
    for path, per_layer in layered.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(per_layer)
    return tree
