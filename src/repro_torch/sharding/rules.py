"""Sharding rules: parameter, batch and cache specs for any mesh. The
counterpart of ``repro.sharding.rules``, with its table and fallbacks:

* batch (DP) over ('pod', 'data');
* FSDP / ZeRO-3: a weight's input-feature dim over ('pod', 'data');
* TP (Megatron column / row) over 'model': output features of the
  in-projections, input features of the out-projections;
* EP: the MoE expert dim over 'model' (experts padded to divide it);
* every rule checks divisibility and falls back to replication.

A spec is a plain tuple with one entry per dimension: None (replicated), an
axis name, or a tuple of names, entry for entry the reference's
``PartitionSpec``. Rules match a parameter by its reference leaf name and
the rank of its stacked leaf (per-layer leaves carry a leading L axis, MoE
experts L and E): ``param_specs`` keys a ``TransformerLM``'s parameters by
their reference paths (``convert.reference_leaves``), so each one meets the
rule the reference's would. ``device_bytes`` reckons what one device of the
mesh holds of a leaf under its spec.
"""
from __future__ import annotations

import math

from torch import nn


def dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def fsdp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def tp_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def _axsize(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def _fit(mesh, dim: int, axes):
    """axes if they divide dim, else None (replicate)."""
    if axes is None or dim % _axsize(mesh, axes) != 0:
        return None
    return axes if not (isinstance(axes, tuple) and len(axes) == 1) else axes[0]


# name -> role table
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "wr", "wg", "wz", "wx",
        "w_cm_1", "w_cm_r", "lm_head"}
_ROW = {"wo", "w_down", "w_cm_2"}
_SMALL_COL = {"wB", "wC", "wdt", "w_lora_a", "router"}


def _spec_for(name: str, shape: tuple, mesh) -> tuple:
    f = fsdp_axes(mesh) or None
    rank = len(shape)

    if name == "embed":  # (V, D)
        return (_fit(mesh, shape[0], "model"), _fit(mesh, shape[1], f))

    if name in _COL:
        if rank == 2:    # (Din, Dout) e.g. lm_head
            return (_fit(mesh, shape[0], f), _fit(mesh, shape[1], "model"))
        if rank == 3:    # (L, Din, Dout)
            return (None, _fit(mesh, shape[1], f), _fit(mesh, shape[2], "model"))
        if rank == 4:    # (L, E, Din, Dout) MoE experts
            return (None, _fit(mesh, shape[1], "model"), _fit(mesh, shape[2], f), None)

    if name in _ROW:
        if rank == 2:
            return (_fit(mesh, shape[0], "model"), _fit(mesh, shape[1], f))
        if rank == 3:
            return (None, _fit(mesh, shape[1], "model"), _fit(mesh, shape[2], f))
        if rank == 4:
            return (None, _fit(mesh, shape[1], "model"), None, _fit(mesh, shape[3], f))

    if name in _SMALL_COL and rank >= 2:
        # (L, Din, small): shard the big input dim only
        return (None,) * (rank - 2) + (_fit(mesh, shape[-2], f), None)

    if name == "w_lora_b" and rank == 3:   # (L, lora, Dout)
        return (None, None, _fit(mesh, shape[2], "model"))

    if name == "conv_w" and rank == 3:     # (L, K, d_inner)
        return (None, None, _fit(mesh, shape[2], "model"))

    return (None,) * rank                   # norms, scalars, mu, biases...


def param_specs(params, mesh) -> dict:
    """``{reference leaf path: spec}``. ``params`` is a ``TransformerLM``
    (its parameters keyed by ``convert.reference_leaves``, at their stacked
    shapes) or a mapping from a path ("a/b/name") to a shape or a tensor;
    the rule reads the path's last name."""
    if isinstance(params, nn.Module):
        from repro_torch.convert import reference_leaves

        params = {path: shape for path, (shape, _) in reference_leaves(params).items()}
    return {path: _spec_for(path.split("/")[-1], tuple(getattr(leaf, "shape", leaf)), mesh)
            for path, leaf in params.items()}


def batch_spec(mesh, global_batch: int) -> tuple:
    dp = dp_axes(mesh)
    if not dp or global_batch % _axsize(mesh, dp) != 0:
        return (None, None)
    return (dp if len(dp) > 1 else dp[0], None)


def cache_specs(cache: dict, mesh) -> dict:
    """Decode-cache specs for the port's cache dict (``models.transformer.
    init_cache``; its leaves carry the reference's names ``k``, ``v``,
    ``ssd``, ``conv``, ``wkv``, ``last1``, ``last2`` and ``pos``): batch
    over DP when divisible; heads (or failing that, sequence) over 'model'."""
    dp = dp_axes(mesh)

    def one(name, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        rank = len(shape)
        if rank == 0:
            return ()
        if name in ("k", "v"):
            # (L_or_G, B, S, Hkv, hd)
            b = _fit(mesh, shape[1], dp or None)
            h = _fit(mesh, shape[3], "model")
            s = None if h is not None else _fit(mesh, shape[2], "model")
            return (None, b, s, h, None)
        if name == "ssd":
            # (..., B, H, P, N): batch over dp, heads over model
            b = _fit(mesh, shape[-4], dp or None)
            h = _fit(mesh, shape[-3], "model")
            return (None,) * (rank - 4) + (b, h, None, None)
        if name == "conv":
            b = _fit(mesh, shape[-3], dp or None)
            c = _fit(mesh, shape[-1], "model")
            return (None,) * (rank - 3) + (b, None, c)
        if name == "wkv":
            # (L, B, H, K, V)
            b = _fit(mesh, shape[1], dp or None)
            h = _fit(mesh, shape[2], "model")
            return (None, b, h, None, None)
        if name in ("last1", "last2"):
            b = _fit(mesh, shape[1], dp or None)
            d = _fit(mesh, shape[3], "model")
            return (None, b, None, d)
        return (None,) * rank

    return {name: one(name, leaf) for name, leaf in cache.items()}


def shard_count(spec: tuple, mesh) -> int:
    """How many pieces ``spec`` cuts a leaf into: the product of the sizes
    of the mesh axes it names."""
    n = 1
    for entry in spec:
        n *= _axsize(mesh, entry)
    return n


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """The shape of one device's piece of a leaf of ``shape`` under ``spec``."""
    return tuple(int(n) // _axsize(mesh, entry) for n, entry in zip(shape, spec))


def device_bytes(shape, itemsize: int, spec: tuple, mesh) -> int:
    """Bytes one device holds of a leaf of ``shape`` under ``spec`` (every
    axis a spec names divides its dimension, so the pieces are equal)."""
    return math.prod(shape) * itemsize // shard_count(spec, mesh)
