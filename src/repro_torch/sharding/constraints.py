"""Axis-spec resolution for activations: the counterpart of
``repro.sharding.constraints``.

``_resolve(mesh, dim, entry)`` maps one logical axis spec onto the longest
prefix of the named mesh axes that exist and divide ``dim`` (None, one
axis name, or a tuple of them), as the reference's does. ``BATCH`` names the
data-parallel axes, ``FULL_BATCH`` every axis (the recurrent blocks' batch).

The reference's ``constrain(x, *axes)`` has no counterpart. It applies
``with_sharding_constraint`` under an ambient mesh (``jax.set_mesh``) and is
the identity without one; the port runs a model on one device and has no
ambient mesh, so its model code has nothing to annotate. For the same reason
``model_divides`` takes the mesh as an argument.
"""
from __future__ import annotations

BATCH = ("pod", "data")
FULL_BATCH = ("pod", "data", "model")  # batch over EVERY axis (recurrent blocks)


def _resolve(mesh, dim: int, entry):
    """Longest prefix of the requested axes that exists and divides dim."""
    if entry is None:
        return None
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    names = tuple(n for n in names if n in mesh.axis_names)
    best: tuple = ()
    size = 1
    for n in names:
        size *= mesh.shape[n]
        if dim % size == 0:
            best = best + (n,)
        else:
            break
    if not best or all(mesh.shape[n] == 1 for n in best):
        return None
    return best if len(best) > 1 else best[0]


def model_divides(dim: int, mesh) -> bool:
    """True if ``dim`` is shardable over the full 'model' axis of ``mesh``
    (always, without a mesh or a 'model' axis)."""
    if mesh is None or "model" not in mesh.axis_names:
        return True
    size = mesh.shape["model"]
    return size == 1 or dim % size == 0
