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
already (a train step's state), and ``init_shards`` draws a rank's shards
of the seeded weights without the whole model. The Adam moments take their
parameter's spec, the batch ``batch_spec`` (``shard_batch``) and the
decode cache ``cache_specs`` (``shard_cache``). Every stack of the repo
shards: attention stacks, dense or MoE (the experts over 'model', their D
over the data axes; the router and the shared expert as the rules give),
and the recurrent stacks, mamba2 (with zamba2's shared attention block) and
rwkv6 (their in-projections column-parallel over 'model', the scans in the
reference's ``FULL_BATCH`` layout: ``models/ssm.py``, ``models/rwkv6.py``).

A leaf takes exactly the placement its spec gives, the reference's
fallbacks included, and the layers compute the same function on it:

* a column-parallel leaf whose columns the model axis divides but not in
  whole heads (query heads, SSD heads or rwkv6's heads that it does not
  divide) is split by features; the layer gathers its output columns over
  'model' (or exchanges them for rows) before the head reshape, runs the
  per-head work on whole heads and takes this rank's columns for the
  row-parallel product (``ShardContext.split`` tells a layer which);
* a leaf that ``_fit`` replicates over 'model' (a dimension the axis does
  not divide: heads times head_dim, d_inner, d_ff, the vocabulary) is used
  whole on every model rank, and the block it belongs to runs whole there:
  its input is not summed over 'model' and its product is not either;
* the decode cache follows ``cache_specs``: heads over 'model', or its
  sequence where the heads do not divide, or whole (``models/attention``);
* an MoE dispatch group larger than a rank's tokens spans the data split:
  its router logits are gathered over the data axes (``models/moe``).

Only a ``block_kind`` without sharded layers raises (``check_shardable``).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.sharding.collectives import (copy_to, copy_to_many, entry_axes, exchange, gather,
                                              gather_replicated, max_over, scatter_sum, sum_over)
from repro_torch.sharding.rules import batch_spec, cache_specs, dp_axes, local_shape, param_specs

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
    """Raise unless ``cfg`` is a stack whose layers have sharded forms: an
    attention stack (dense or MoE), mamba2 (with zamba2's shared block) or
    rwkv6. Any dimension may leave the model axis undivided: its leaves
    then take the reference's fallback placement (the module docstring)."""
    if cfg.block_kind not in ("attn", "mamba2", "rwkv6"):
        raise NotImplementedError(f"{cfg.name}: a sharded {cfg.block_kind} stack is not written")


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
    is only cut, not run) and the mesh. ``tag`` names a collective's own
    counter (``MeshComm.stats[axis]["all_reduce:<tag>"]``)."""

    def __init__(self, mesh, rank: int, comm=None):
        self.mesh, self.rank, self.comm = mesh, int(rank), comm
        self.coords = mesh.coords(self.rank)
        self.tp = mesh.shape.get("model", 1)
        self.tp_index = self.coords[mesh.axis_names.index("model")] if "model" in mesh.shape else 0
        self.dp = dp_axes(mesh)
        self.n_data, self.data_index = _block(self.dp, mesh, self.coords)
        self.specs: dict = {}

    @staticmethod
    def split(spec: tuple, dim: int) -> bool:
        """Whether ``spec`` splits dimension ``dim`` over 'model' (else
        ``_fit`` replicated it there)."""
        return "model" in entry_axes(spec[dim])

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

    def to_model(self, x: torch.Tensor, tag: str | None = None) -> torch.Tensor:
        return copy_to(x, self.comm, "model", tag)

    def sum_model(self, x: torch.Tensor, out_dtype=None, tag: str | None = None) -> torch.Tensor:
        return sum_over(x, self.comm, "model", out_dtype, tag)

    def max_model(self, x: torch.Tensor) -> torch.Tensor:
        return max_over(x, self.comm, "model")

    def gather_data(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """All-gather along ``dim`` over the data axes, in the global
        batch's order (``data_index``)."""
        return gather(x, self.comm, self.dp, dim) if self.dp else x

    def sum_data(self, x: torch.Tensor, tag: str | None = None) -> torch.Tensor:
        for axis in self.dp:
            x = sum_over(x, self.comm, axis, tag=tag)
        return x

    # -- the recurrent layers' FULL_BATCH region --------------------------

    def full_batch(self, rows: int) -> bool:
        """Whether a scan over this rank's ``rows`` (its block over the data
        axes) splits them over 'model' too: the reference's ``FULL_BATCH``
        = ('pod', 'data', 'model') where the global batch divides over every
        axis; where it does not, ``constraints._resolve`` keeps the longest
        dividing prefix, which leaves 'model' out, and the scan is
        replicated over 'model'."""
        return self.tp > 1 and rows % self.tp == 0

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block over 'model' of the rows (dim 0) of ``x``."""
        n = x.shape[0] // self.tp
        return x.narrow(0, self.tp_index * n, n)

    def channels(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's block over 'model' of dimension ``dim`` of ``x``."""
        n = x.shape[dim] // self.tp
        return x.narrow(dim, self.tp_index * n, n)

    def exchange(self, x: torch.Tensor, split_dim: int, cat_dim: int,
                 tag: str | None = None) -> torch.Tensor:
        """All-to-all over 'model' (``collectives.exchange``)."""
        return exchange(x, self.comm, "model", split_dim, cat_dim, tag)

    def partial_leaves(self, *leaves: torch.Tensor, tag: str | None = None) -> tuple:
        """Leaves whole on every 'model' rank of which each rank computes
        only part of the gradient (they enter the FULL_BATCH region, where a
        rank holds its rows, or are read at this rank's channels): the
        identity forward; backward, their gradients summed over 'model' in
        one all-reduce, so that each is summed exactly once."""
        return copy_to_many(leaves, self.comm, "model", tag)

    def scatter_model(self, x: torch.Tensor, dim: int, out_dtype=None) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum over 'model' (f32,
        rank order, then ``out_dtype``); the backward all-gathers."""
        return scatter_sum(x, self.comm, "model", dim, out_dtype)

    def gather_replicated(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """All-gather over 'model' of a piece whose whole every rank then
        uses alike; the backward keeps this rank's piece."""
        return gather_replicated(x, self.comm, "model", dim)


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


def bind_shards(cfg, tensors, mesh, rank: int, comm=None):
    """A ``TransformerLM`` skeleton whose parameters are ``tensors`` (this
    rank's shards, in parameter order; no copy), bound to a
    ``ShardContext``."""
    from repro_torch.models.model import TransformerLM

    check_shardable(cfg, mesh)
    tp = mesh.shape.get("model", 1)
    model = TransformerLM(cfg, device="meta", tp=tp)
    specs = parameter_specs(model, mesh)
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


def init_shards(cfg, generator: torch.Generator, mesh, rank: int, device=None) -> list:
    """This rank's shards of ``models.model.init_params(cfg, generator,
    device, tp)`` (tp the mesh's model axis), bitwise, in parameter order,
    without the whole model: each of ``TransformerLM.init_units`` (the
    embedding, a layer, the shared block, the final norm, the head) is made
    whole on ``device`` in ``init_params``' order of draws, copied into
    this rank's blocks, and freed before the next. The largest unit is one
    layer (qwen2-moe: 1.04 GB of bf16 experts) or the embedding
    (minitron-4b: 1.57 GB, drawn in f32). The blocks are made before the
    first draw, so none lies in the segments the units' draws held: on a
    card, those are released at the end, and a rank keeps only its shards.
    A configuration that does not shard raises as ``check_shardable``."""
    from repro_torch.models.model import TransformerLM

    check_shardable(cfg, mesh)
    model = TransformerLM(cfg, device="meta", tp=mesh.shape.get("model", 1))
    specs = parameter_specs(model, mesh)
    coords = mesh.coords(rank)
    out = {name: torch.empty(local_shape(skel.shape, specs[name], mesh), dtype=skel.dtype,
                             device=device)
           for name, skel in model.named_parameters()}
    for names, fill in model.init_units():
        held = []
        for name in names:
            mod_name, _, pn = name.rpartition(".")
            mod = model.get_submodule(mod_name) if mod_name else model
            skel = mod._parameters[pn]
            mod._parameters[pn] = nn.Parameter(torch.empty_like(skel, device=device),
                                               requires_grad=skel.requires_grad)
            held.append((name, mod, pn, skel))
        with torch.no_grad():
            fill(generator)
        for name, mod, pn, skel in held:
            out[name].copy_(local_shard(mod._parameters[pn].detach(), specs[name], mesh, coords))
            mod._parameters[pn] = skel
    if torch.device(device if device is not None else "cpu").type == "cuda":
        torch.cuda.empty_cache()
    return list(out.values())


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
    (``pos`` kept; with K/V, ``len`` the whole cache's length)."""
    specs = cache_specs(cache, mesh)
    coords = mesh.coords(rank)
    out = {k: (local_shard(v, specs[k], mesh, coords).clone() if torch.is_tensor(v) else v)
           for k, v in cache.items()}
    return dict(out, len=cache["k"].shape[2]) if "k" in cache else out
