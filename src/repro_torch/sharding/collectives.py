"""The process group of an LM mesh's rank processes and its collectives.

Each rank of a ``launch.mesh.LMMesh`` is one process. ``MeshComm`` joins the
ranks' gloo process group through ``multihost.MultihostContext`` (its
``TCPStore`` rendezvous and ``REPRO_TORCH_DIST_*`` environment, so a failed
rendezvous raises within its timeout) and creates one subgroup per axis
group (``LMMesh.axis_groups``). On a tensor it provides

* ``all_gather(t, axis, dim)``: the group's pieces concatenated along
  ``dim`` in coordinate order;
* ``reduce_scatter(t, axis, dim)``: ``t`` cut into the group's pieces along
  ``dim``; each rank receives its piece from every member and adds them in
  rank order;
* ``all_reduce(t, axis, op)``: ``"sum"`` is a reduce-scatter of the flat
  tensor followed by an all-gather of the summed pieces, ``"max"`` an
  all-gather and a max.

Rules:

* **Rank-order sums.** gloo only moves bytes (an all-gather, an
  all-to-all); every sum is formed here, in f32, piece by piece in rank
  order, as ``MultihostContext.allreduce`` does, so every rank gets the same
  bytes from run to run whatever algorithm gloo picks. A sum comes back in
  the input's dtype unless ``out_dtype`` says otherwise.
* **gloo, staged through the host.** The ranks may share one card, which
  NCCL refuses (two ranks on one device), so the backend is gloo and device
  tensors go through pinned host buffers explicitly: a copy to the host,
  the collective on CPU tensors, one copy back. Every dtype travels as its
  bytes (uint8). An NCCL group for ranks on distinct cards is not written.
* **Counters.** ``stats[axis][op]`` counts calls, the bytes this rank
  received from its peers, and the seconds spent (staging included).

The differentiable forms used by the sharded model are ``gather`` (an
all-gather whose backward is the reduce-scatter: FSDP), ``sum_over`` (an
all-reduce whose backward is the identity: Megatron's row-parallel output)
and ``copy_to`` (the identity whose backward is an all-reduce: Megatron's
column-parallel input). A one-rank mesh needs no process group: every
collective is then the identity.
"""
from __future__ import annotations

import os
import time

import torch

from repro_torch.multihost import (DEFAULT_TIMEOUT_S, ENV_COORD, ENV_NPROCS, ENV_RANK,
                                   ENV_STORE_HOSTED, ENV_TIMEOUT, MultihostContext)

OPS = ("all_gather", "reduce_scatter", "all_reduce")


def entry_axes(entry) -> tuple:
    """A spec entry (None, an axis name or a tuple of them) as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class MeshComm:
    """Collectives over the axes of ``mesh`` for rank ``rank``. ``world`` is
    the joined ``MultihostContext`` (None for a one-rank mesh). Several
    meshes may share one world: each ``MeshComm`` makes its own subgroups,
    and every rank must create them in the same order."""

    def __init__(self, mesh, rank: int, world: MultihostContext | None = None):
        import torch.distributed as dist

        if world is None and mesh.size != 1:
            raise ValueError(f"a {mesh} mesh needs a process group of {mesh.size} ranks")
        if world is not None and world.size != mesh.size:
            raise ValueError(f"the process group has {world.size} ranks, the mesh {mesh.size}")
        self.mesh, self.rank, self.world = mesh, int(rank), world
        self.coords = mesh.coords(self.rank)
        self._groups = {}
        for axis in mesh.axis_names:
            for ranks in mesh.axis_groups(axis):
                if len(ranks) == 1:
                    continue
                group = dist.new_group(list(ranks), backend="gloo")
                if self.rank in ranks:
                    self._groups[axis] = group
        self.stats = {a: {op: [0, 0, 0.0] for op in OPS} for a in mesh.axis_names}

    # -- construction --------------------------------------------------

    @classmethod
    def connect(cls, mesh, coordinator: str, rank: int, timeout_s: float = DEFAULT_TIMEOUT_S,
                host_store: bool | None = None) -> "MeshComm":
        """Join the gloo group of ``mesh.size`` ranks whose ``TCPStore`` is
        at ``coordinator`` (``host:port``); raises when the rendezvous does
        not complete within ``timeout_s``."""
        world = MultihostContext.connect(coordinator, mesh.size, rank, timeout_s=timeout_s,
                                         host_store=host_store)
        return cls(mesh, rank, world)

    @classmethod
    def from_env(cls, mesh) -> "MeshComm | None":
        """Join from the ``REPRO_TORCH_DIST_*`` environment (as
        ``multihost.spawn_ranks`` sets it), or None outside it."""
        if ENV_RANK not in os.environ:
            return None
        if int(os.environ[ENV_NPROCS]) != mesh.size:
            raise ValueError(f"{os.environ[ENV_NPROCS]} rank processes for a {mesh} mesh")
        rank = int(os.environ[ENV_RANK])
        return cls.connect(mesh, os.environ[ENV_COORD], rank,
                           timeout_s=float(os.environ.get(ENV_TIMEOUT, DEFAULT_TIMEOUT_S)),
                           host_store=rank == 0 and os.environ.get(ENV_STORE_HOSTED) != "1")

    # -- geometry -------------------------------------------------------

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[self.mesh.axis_names.index(axis)]

    def size(self, axis: str) -> int:
        return self.mesh.shape[axis]

    # -- staging --------------------------------------------------------

    @staticmethod
    def _wire(t: torch.Tensor, rows: int = 1) -> torch.Tensor:
        """``t`` as a contiguous CPU (rows, bytes) uint8 tensor, the bytes
        gloo moves whatever the dtype, through a pinned buffer when ``t``
        lies on a device."""
        if t.device.type != "cpu":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
        else:
            host = t.contiguous()
        return host.reshape(-1).view(torch.uint8).reshape(rows, -1)

    @staticmethod
    def _unwire(buf: torch.Tensor, dtype, shape, device) -> torch.Tensor:
        """The inverse of ``_wire`` for ``buf`` holding tensors of ``shape``."""
        out = buf.reshape(-1).view(dtype).reshape(shape)
        return out.to(device) if device.type != "cpu" else out

    def _count(self, axis: str, op: str, nbytes: int, t0: float) -> None:
        rec = self.stats[axis][op]
        rec[0] += 1
        rec[1] += int(nbytes)
        rec[2] += time.perf_counter() - t0

    # -- collectives ----------------------------------------------------

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The ``axis`` group's tensors concatenated along ``dim`` in
        coordinate order (identical bytes on every member)."""
        import torch.distributed as dist

        n = self.size(axis)
        if n == 1:
            return t
        t0 = time.perf_counter()
        wire = self._wire(t)
        buf = torch.empty((n, wire.shape[1]), dtype=torch.uint8,
                          pin_memory=t.device.type != "cpu")
        dist.all_gather(list(buf.split(1)), wire, group=self._groups[axis])
        out = self._unwire(buf, t.dtype, (n,) + tuple(t.shape), t.device)
        dim = dim % t.dim()
        out = out.movedim(0, dim).reshape(t.shape[:dim] + (n * t.shape[dim],) + t.shape[dim + 1:])
        self._count(axis, "all_gather", (n - 1) * wire.numel(), t0)
        return out

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int,
                       out_dtype=None) -> torch.Tensor:
        """This rank's piece (by its coordinate) of the sum over the
        ``axis`` group of ``t``, cut along ``dim``; added in f32 in rank
        order, returned in ``out_dtype`` (default ``t``'s)."""
        import torch.distributed as dist

        n = self.size(axis)
        out_dtype = out_dtype or t.dtype
        if n == 1:
            return t.to(out_dtype)
        dim = dim % t.dim()
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dimension {dim} of {tuple(t.shape)} does not "
                             f"divide into {n}")
        t0 = time.perf_counter()
        pieces = t.unflatten(dim, (n, t.shape[dim] // n)).movedim(dim, 0)
        wire = self._wire(pieces, rows=n)
        recv = torch.empty(wire.shape, dtype=torch.uint8, pin_memory=t.device.type != "cpu")
        dist.all_to_all_single(recv, wire, group=self._groups[axis])
        parts = self._unwire(recv, t.dtype, tuple(pieces.shape), t.device)
        acc = parts[0].float()
        for p in parts[1:]:
            acc = acc + p.float()
        self._count(axis, "reduce_scatter", (n - 1) * recv.shape[1], t0)
        return acc.to(out_dtype)

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum",
                   out_dtype=None) -> torch.Tensor:
        """The ``axis`` group's element-wise sum (f32, rank order, then
        ``out_dtype``, default ``t``'s) or max, the same bytes on every
        member."""
        if op not in ("sum", "max"):
            raise ValueError(f"unknown reduction {op!r}")
        n = self.size(axis)
        out_dtype = out_dtype or t.dtype
        if n == 1:
            return t.to(out_dtype)
        t0 = time.perf_counter()
        stats = {k: list(v) for k, v in self.stats[axis].items()}
        if op == "max":
            out = self.all_gather(t.unsqueeze(0), axis, 0).amax(0).to(out_dtype)
        else:
            flat = t.reshape(-1)
            pad = -flat.numel() % n
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            piece = self.reduce_scatter(flat, axis, 0, out_dtype=out_dtype)
            out = self.all_gather(piece, axis, 0)[:t.numel()].reshape(t.shape)
        moved = sum(self.stats[axis][k][1] - stats[k][1] for k in stats)
        self.stats[axis] = stats
        self._count(axis, "all_reduce", moved, t0)
        return out

    def all_reduce_axes(self, t: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
        """``all_reduce`` over each axis of ``axes`` in turn (the same bytes
        on every rank of the product group)."""
        for a in axes:
            t = self.all_reduce(t, a, op)
        return t

    def barrier(self) -> None:
        import torch.distributed as dist

        if self.world is not None:
            dist.barrier()

    def summary(self) -> dict:
        """``{axis: {op: {"calls", "bytes", "seconds"}}}`` of the counters."""
        return {a: {op: dict(zip(("calls", "bytes", "seconds"), rec)) for op, rec in ops.items()}
                for a, ops in self.stats.items()}

    def reset_stats(self) -> None:
        for ops in self.stats.values():
            for rec in ops.values():
                rec[:] = [0, 0, 0.0]

    def shutdown(self) -> None:
        if self.world is not None:
            self.world.shutdown()
            self.world = None


# -- differentiable forms ---------------------------------------------------

class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, axis, dim):
        ctx.args = (comm, axis, dim, t.dtype)
        return comm.all_gather(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        comm, axis, dim, dtype = ctx.args
        return comm.reduce_scatter(g, axis, dim, out_dtype=dtype), None, None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, axis, out_dtype):
        ctx.dtype = t.dtype
        return comm.all_reduce(t, axis, "sum", out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, axis):
        ctx.args = (comm, axis)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        comm, axis = ctx.args
        return comm.all_reduce(g, axis, "sum"), None, None


def gather(t: torch.Tensor, comm: MeshComm, entry, dim: int) -> torch.Tensor:
    """All-gather ``t`` along ``dim`` over the axes of a spec entry (the
    minor axis first, so that the pieces land in the spec's order); the
    backward reduce-scatters the gradient back to the piece."""
    for axis in reversed(entry_axes(entry)):
        if comm.size(axis) > 1:
            t = _Gather.apply(t, comm, axis, dim)
    return t


def sum_over(t: torch.Tensor, comm: MeshComm, axis: str, out_dtype=None) -> torch.Tensor:
    """All-reduce (sum) over ``axis``; the gradient passes through."""
    if comm.size(axis) == 1:
        return t.to(out_dtype or t.dtype)
    return _SumOver.apply(t, comm, axis, out_dtype)


def copy_to(t: torch.Tensor, comm: MeshComm, axis: str) -> torch.Tensor:
    """The identity; the gradient is all-reduced (summed) over ``axis``."""
    if comm.size(axis) == 1:
        return t
    return _CopyTo.apply(t, comm, axis)


def max_over(t: torch.Tensor, comm: MeshComm, axis: str) -> torch.Tensor:
    """All-reduce (max) over ``axis`` of a tensor that carries no gradient."""
    return comm.all_reduce(t.detach(), axis, "max")
