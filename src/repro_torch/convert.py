"""Carry parameters between this package and the JAX package.

The JAX package's ``KernelParams`` leaves (``log_sigma2``, ``log_beta``,
``log_nugget``) and ``MultiOutputParams`` leaves (``log_sigma2`` (p,),
``log_beta``, ``log_tau2``) travel as numpy arrays, so neither package
imports the other. Packed structures are numpy on both sides and need no
conversion. So does the LM's parameter pytree (``lm_params_from_reference``,
``lm_params_to_reference``) and its training state (``train_state_from_reference``,
``train_state_to_reference``: params, Adam moments and step counts).

The reference stacks each per-layer leaf on a leading L axis under
``["stack"]["layers"]``; ``reference_tree`` and ``tensors_from_reference_tree``
map a ``TransformerLM``'s parameter order to that layout and back with
torch tensors (dtype and device kept), which is also the key layout of the
training checkpoints (``launch/train.py``), so either package resumes the
other's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.kernels_math import KernelParams
from repro_torch.core.multioutput import MultiOutputParams
from repro_torch.models.model import TransformerLM
from repro_torch.optim import AdamState


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
    ``["stack"]["layers"]``; the hybrid's shared block lies unstacked under
    ``["stack"]["shared_attn"]``."""
    parts = name.split(".")
    if parts[0] == "layers":
        return ("stack", "layers") + tuple(parts[2:]), int(parts[1])
    if parts[0] == "shared_attn":
        return ("stack",) + tuple(parts), None
    return tuple(parts), None


def reference_leaves(model: TransformerLM) -> dict:
    """``{"a/b/name": (stacked shape, dtype)}``: the reference's leaf of
    each of ``model``'s parameters, at the shape of the stacked leaf (per-
    layer parameters gain a leading L axis), in parameter order."""
    out: dict = {}
    for name, p in model.named_parameters():
        path, layer = _reference_path(name)
        key = "/".join(path)
        if layer is None:
            out[key] = (tuple(p.shape), p.dtype)
        else:
            n = out[key][0][0] if key in out else 0
            out[key] = ((n + 1,) + tuple(p.shape), p.dtype)
    return out


def lm_params_from_reference(tree, cfg, device="cpu", dtype=None, tp: int = 1) -> TransformerLM:
    """A ``TransformerLM`` holding the reference's parameter pytree.

    ``tree`` is the reference's ``init_params`` output with numpy leaves.
    numpy has no bf16, so the caller passes bf16 leaves as
    ``np.asarray(leaf, np.float32)``: that widening is exact, and so is the
    cast back to ``torch.bfloat16`` here. The matrices land at ``dtype``
    (default: the config's), the norms in f32, as in the reference. ``tp``
    is the reference's ``init_params(key, cfg, tp)``: its MoE trees carry
    ``padded_experts(cfg, tp)`` experts (an (L, D, E) router, (L, E, ...)
    expert leaves). Every leaf of ``tree`` must have a parameter and the
    same shape."""
    model = TransformerLM(cfg, device=device, dtype=dtype, tp=tp)
    names, params = zip(*model.named_parameters())
    with torch.no_grad():
        for name, param, a in zip(names, params, tensors_from_reference_tree(names, tree)):
            a = np.asarray(a)
            if tuple(a.shape) != tuple(param.shape):
                raise ValueError(f"{name}: reference shape {a.shape}, port {tuple(param.shape)}")
            param.copy_(torch.tensor(a).to(param.dtype))
    return model


def param_names(cfg, tp: int = 1) -> list[str]:
    """A ``TransformerLM``'s parameter names, in its parameter order."""
    return [name for name, _ in TransformerLM(cfg, device="meta", tp=tp).named_parameters()]


def reference_tree(names, tensors) -> dict:
    """The reference's nested tree of ``tensors`` (one per parameter name of
    ``names``): per-layer tensors stacked on a leading L axis."""
    layered: dict = {}
    tree: dict = {}

    def put(path, t):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t

    for name, t in zip(names, tensors):
        path, layer = _reference_path(name)
        if layer is None:
            put(path, t)
        else:
            layered.setdefault(path, []).append(t)
    for path, per_layer in layered.items():
        put(path, torch.stack(per_layer))
    return tree


def tensors_from_reference_tree(names, tree) -> list:
    """The inverse of ``reference_tree``: one leaf (or layer slice of a
    stacked leaf) per name of ``names``. Every leaf of ``tree`` must be used."""
    leaves = _flatten(tree)
    out, used = [], set()
    for name in names:
        path, layer = _reference_path(name)
        if path not in leaves:
            raise KeyError(f"reference tree has no leaf {'/'.join(path)} for {name}")
        out.append(leaves[path] if layer is None else leaves[path][layer])
        used.add(path)
    extra = sorted("/".join(p) for p in set(leaves) - used)
    if extra:
        raise ValueError(f"reference leaves without a port parameter: {extra}")
    return out


def _numpy32(tree):
    if isinstance(tree, dict):
        return {k: _numpy32(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy()


def lm_params_to_reference(model: TransformerLM) -> dict:
    """The reference's parameter pytree, as float32 numpy leaves (bf16
    values widen exactly), per-layer leaves stacked on a leading L axis."""
    names, params = zip(*model.named_parameters())
    return _numpy32(reference_tree(names, params))


def train_state_to_reference(state, cfg) -> dict:
    """A ``training.train_step.TrainState`` as the reference's state in
    numpy: ``{"params": tree, "opt": {"step", "mu": tree, "nu": tree},
    "step"}``, trees as ``lm_params_to_reference`` gives them (float32
    leaves; bf16 params widen exactly), step counts as int32."""
    names = param_names(cfg)
    return {"params": _numpy32(reference_tree(names, state.params)),
            "opt": {"step": np.int32(state.opt.step),
                    "mu": _numpy32(reference_tree(names, state.opt.mu)),
                    "nu": _numpy32(reference_tree(names, state.opt.nu))},
            "step": np.int32(state.step)}


def train_state_from_reference(tree, cfg, device="cpu", tp: int = 1):
    """A ``TrainState`` from the reference's state in numpy (the layout of
    ``train_state_to_reference``): params at the config's dtype (norms f32),
    Adam moments in float32, through ``lm_params_from_reference``."""
    from repro_torch.training.train_step import TrainState

    leaves = lambda t, dtype=None: tuple(
        p.detach() for p in lm_params_from_reference(t, cfg, device=device, dtype=dtype,
                                                     tp=tp).parameters())
    return TrainState(params=leaves(tree["params"]),
                      opt=AdamState(step=int(tree["opt"]["step"]),
                                    mu=leaves(tree["opt"]["mu"], torch.float32),
                                    nu=leaves(tree["opt"]["nu"], torch.float32)),
                      step=int(tree["step"]))
