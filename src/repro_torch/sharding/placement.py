"""Cut LM leaves into per-rank shards by their specs, and back.

A spec (``sharding.rules``) names, per dimension, the mesh axes that split
it. ``local_shard`` gives a rank the contiguous block of each split
dimension at its coordinates (for an entry of several axes, the first is
the major one): entry for entry what ``NamedSharding`` gives the device at
those mesh coordinates. ``assemble`` (on the host, from every rank's shard)
and ``gather_whole`` (a collective) reverse it.

``shard_model`` cuts a ``TransformerLM``'s parameters by ``param_specs``
(keyed by ``convert.reference_leaves``; a per-layer parameter takes its
stacked leaf's spec without the leading layer axis) into a model of shards
bound to a ``ShardContext``; ``bind_shards`` binds shards that exist
already (a train step's state). The Adam moments take their parameter's
spec, the batch ``batch_spec`` (``shard_batch``) and the decode cache
``cache_specs`` (``shard_cache``). Only dense attention stacks shard: an
MoE or a recurrent stack raises ``NotImplementedError``; a tensor-parallel
dimension that the model axis does not divide raises ``ValueError``, as
does a leaf whose spec leaves it whole where the sharded layers need it
split. Nothing falls back to whole tensors.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.sharding.collectives import copy_to, entry_axes, gather, max_over, sum_over
from repro_torch.sharding.rules import batch_spec, cache_specs, dp_axes, local_shape, param_specs

# Where the sharded layers need the model axis (Megatron): the column-
# parallel leaves' output dimension, the row-parallel leaves' input
# dimension, the embedding's vocabulary. K and V may stay whole or split
# inside a head (``models.attention`` gathers them then).
_NEEDS_MODEL = {"wq": 1, "w_gate": 1, "w_up": 1, "lm_head": 1, "wo": 0, "w_down": 0, "embed": 0}


def _block(entry, mesh, coords) -> tuple[int, int]:
    """(pieces, this rank's piece index) of a spec entry at ``coords``."""
    n, idx = 1, 0
    for a in entry_axes(entry):
        size = mesh.shape[a]
        n *= size
        idx = idx * size + coords[mesh.axis_names.index(a)]
    return n, idx


def local_shard(whole: torch.Tensor, spec: tuple, mesh, coords) -> torch.Tensor:
    """The block of ``whole`` (a view) that the rank at ``coords`` holds."""
    if len(spec) != whole.dim():
        raise ValueError(f"spec {spec} for a tensor of shape {tuple(whole.shape)}")
    for dim, entry in enumerate(spec):
        n, idx = _block(entry, mesh, coords)
        if whole.shape[dim] % n:
            raise ValueError(f"spec {spec}: dimension {dim} of {tuple(whole.shape)} does not "
                             f"divide into {n}")
        size = whole.shape[dim] // n
        whole = whole.narrow(dim, idx * size, size)
    return whole


def assemble(shards, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from every rank's shard (``shards[r]`` for rank r),
    on the host; the ranks that hold the same block must hold the same
    bytes (else ``ValueError``)."""
    first = shards[0]
    shape = tuple(n * _block(entry, mesh, mesh.coords(0))[0]
                  for n, entry in zip(first.shape, spec))
    whole = torch.empty(shape, dtype=first.dtype)
    seen = {}
    for r, piece in enumerate(shards):
        coords = mesh.coords(r)
        key = tuple(_block(entry, mesh, coords)[1] for entry in spec)
        piece = piece.detach().cpu()
        if key in seen:
            if not torch.equal(seen[key], piece):
                raise ValueError(f"ranks holding block {key} of a {spec} leaf differ")
            continue
        seen[key] = piece
        local_shard(whole, spec, mesh, coords).copy_(piece)
    return whole


def gather_whole(shard: torch.Tensor, spec: tuple, comm) -> torch.Tensor:
    """The whole leaf on every rank (collective: every rank calls it)."""
    for dim, entry in enumerate(spec):
        for axis in reversed(entry_axes(entry)):
            shard = comm.all_gather(shard, axis, dim)
    return shard


def check_shardable(cfg, mesh) -> None:
    """Raise unless ``cfg`` is a dense attention stack whose heads divide
    the model axis."""
    if cfg.block_kind != "attn":
        raise NotImplementedError(
            f"{cfg.name}: a sharded {cfg.block_kind} stack is not written (ROADMAP 13.6, next: "
            f"the recurrent stacks' FULL_BATCH layout, batch over every axis)")
    if cfg.n_experts:
        raise NotImplementedError(
            f"{cfg.name}: a sharded MoE is not written (ROADMAP 13.6, next: the experts' "
            f"all-to-all over 'model')")
    tp = mesh.shape.get("model", 1)
    if cfg.n_heads % tp:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} query heads do not divide the model axis "
                         f"of {tp}")


def parameter_specs(model, mesh) -> dict:
    """``{parameter name: spec}`` of a ``TransformerLM`` (whole or on
    ``meta``) under ``param_specs``, per-layer parameters without the
    stacked leaf's layer axis."""
    from repro_torch.convert import _reference_path

    ref = param_specs(model, mesh)
    out = {}
    for name, _ in model.named_parameters():
        path, layer = _reference_path(name)
        spec = ref["/".join(path)]
        out[name] = spec[1:] if layer is not None else spec
    return out


class ShardContext:
    """What a sharded module reads: the ``MeshComm`` (None for a model that
    is only cut, not run) and the mesh."""

    def __init__(self, mesh, rank: int, comm=None):
        self.mesh, self.rank, self.comm = mesh, int(rank), comm
        self.coords = mesh.coords(self.rank)
        self.tp = mesh.shape.get("model", 1)
        self.tp_index = self.coords[mesh.axis_names.index("model")] if "model" in mesh.shape else 0
        self.dp = dp_axes(mesh)
        self.specs: dict = {}

    def fsdp(self, w: torch.Tensor, spec: tuple) -> torch.Tensor:
        """``w`` gathered over every axis but 'model' that its spec splits
        (FSDP; the backward reduce-scatters the gradient)."""
        for dim, entry in enumerate(spec):
            axes = tuple(a for a in entry_axes(entry) if a != "model")
            if axes:
                w = gather(w, self.comm, axes, dim)
        return w

    def gather_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return gather(x, self.comm, "model", dim)

    def to_model(self, x: torch.Tensor) -> torch.Tensor:
        return copy_to(x, self.comm, "model")

    def sum_model(self, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
        return sum_over(x, self.comm, "model", out_dtype)

    def max_model(self, x: torch.Tensor) -> torch.Tensor:
        return max_over(x, self.comm, "model")

    def sum_data(self, x: torch.Tensor) -> torch.Tensor:
        for axis in self.dp:
            x = sum_over(x, self.comm, axis)
        return x


def attach(model: nn.Module, shard: ShardContext, specs: dict) -> nn.Module:
    """Bind ``shard`` to every module of ``model`` and give each module the
    specs of its own parameters (``module.specs[name]``; ``shard.specs``
    keeps them all by parameter name)."""
    shard.specs = specs
    for mname, mod in model.named_modules():
        mod.shard = shard
        mod.specs = {pn: specs[f"{mname}.{pn}" if mname else pn]
                     for pn, _ in mod.named_parameters(recurse=False)}
    return model


def _check_specs(specs: dict, tp: int) -> None:
    if tp == 1:
        return
    for name, spec in specs.items():
        dim = _NEEDS_MODEL.get(name.rsplit(".", 1)[-1])
        if dim is not None and "model" not in entry_axes(spec[dim]):
            raise ValueError(f"{name}: spec {spec} leaves dimension {dim} whole; the sharded "
                             f"layers need it split over 'model'")


def bind_shards(cfg, tensors, mesh, rank: int, comm=None):
    """A ``TransformerLM`` skeleton whose parameters are ``tensors`` (this
    rank's shards, in parameter order; no copy), bound to a
    ``ShardContext``."""
    from repro_torch.models.model import TransformerLM

    check_shardable(cfg, mesh)
    model = TransformerLM(cfg, device="meta")
    specs = parameter_specs(model, mesh)
    _check_specs(specs, mesh.shape.get("model", 1))
    names = [n for n, _ in model.named_parameters()]
    if len(names) != len(tensors):
        raise ValueError(f"{len(tensors)} tensors for {len(names)} parameters")
    for (name, skel), t in zip(list(model.named_parameters()), tensors):
        want = local_shape(skel.shape, specs[name], mesh)
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: shard shape {tuple(t.shape)}, the {mesh} mesh gives {want}")
        mod_name, _, pn = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[pn] = nn.Parameter(t, requires_grad=skel.requires_grad)
    return attach(model, ShardContext(mesh, rank, comm), specs)


def shard_tensors(model, tensors, mesh, rank: int) -> list:
    """Each of ``tensors`` (one per parameter of ``model``, whole: the
    parameters themselves or their Adam moments) cut to this rank's block,
    as contiguous copies."""
    specs = parameter_specs(model, mesh)
    coords = mesh.coords(rank)
    return [local_shard(t.detach(), specs[name], mesh, coords).clone()
            for (name, _), t in zip(model.named_parameters(), tensors)]


def shard_model(model, mesh, rank: int, comm=None):
    """``model`` (whole) cut to this rank's shards and bound to a
    ``ShardContext``."""
    check_shardable(model.cfg, mesh)
    return bind_shards(model.cfg, shard_tensors(model, list(model.parameters()), mesh, rank),
                       mesh, rank, comm)


def shard_batch(x: torch.Tensor, mesh, rank: int) -> torch.Tensor:
    """This rank's rows of a global (batch, seq) array under ``batch_spec``."""
    return local_shard(x, batch_spec(mesh, x.shape[0]), mesh, mesh.coords(rank))


def shard_cache(cache: dict, mesh, rank: int) -> dict:
    """This rank's blocks of a whole decode cache under ``cache_specs``
    (``pos`` kept)."""
    specs = cache_specs(cache, mesh)
    coords = mesh.coords(rank)
    return {k: (local_shard(v, specs[k], mesh, coords).clone() if torch.is_tensor(v) else v)
            for k, v in cache.items()}
