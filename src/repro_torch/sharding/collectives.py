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
  all-gather and a max;
* ``all_to_all(t, axis, split_dim, cat_dim)``: ``t`` cut into the group's
  pieces along ``split_dim``, piece j sent to member j, and the pieces
  received concatenated along ``cat_dim`` in coordinate order (the
  recurrent layers' exchange between channels and rows over 'model').

Rules:

* **Rank-order sums.** gloo only moves bytes (an all-gather, an
  all-to-all); every sum is formed here, in f32, piece by piece in rank
  order, as ``MultihostContext.allreduce`` does, so every rank gets the same
  bytes from run to run whatever algorithm gloo picks. A sum comes back in
  the input's dtype unless ``out_dtype`` says otherwise.
* **gloo for CPU tensors; the card's memory for CUDA tensors.** The ranks
  share one card, which NCCL refuses (two ranks on one device), so the
  backend is gloo. CPU tensors travel through gloo as their bytes (uint8).
  CUDA tensors move on the card (``DeviceExchange``): each rank's exchange
  buffer is opened by the others through CUDA IPC, and a round is a copy
  into this rank's buffer, a barrier (each rank's count of barriers in a
  file every rank maps, waited on by spinning, which also checks that the
  ranks are in step), copies out of the peers' buffers and a second
  barrier. Either way the same bytes arrive and every
  sum is formed here, so the result does not depend on the tensors'
  device. Ranks on distinct cards (an NCCL group) are not written.
* **Counters.** ``stats[axis][op]`` counts calls, the bytes this rank
  received from its peers, and the seconds spent (barriers included). An
  all-reduce given a ``tag`` counts under ``"all_reduce:<tag>"`` instead
  (the MoE's combine ``moe``, its gates' gradient ``moe_gate``, its
  load-balancing sums ``moe_aux``), and an all-to-all given one under
  ``"all_to_all:<tag>"`` (mamba2's ``ssd``, rwkv6's ``wkv``), so a layer's
  collectives read apart.

The differentiable forms used by the sharded model are ``gather`` (an
all-gather whose backward is the reduce-scatter: FSDP), ``sum_over`` (an
all-reduce whose backward is the identity: Megatron's row-parallel output),
``copy_to`` (the identity whose backward is an all-reduce: Megatron's
column-parallel input), ``exchange`` (an all-to-all whose backward is the
inverse all-to-all: it moves bytes and never sums, so a round trip is
bitwise, forward and backward), ``scatter_sum`` (a reduce-scatter whose
backward is the all-gather) and ``gather_replicated`` (an all-gather of a
result every member then uses alike, whose backward keeps the member's own
piece of the gradient). A one-rank mesh needs no process group: every
collective is then the identity.
"""
from __future__ import annotations

import math
import os
import time

import numpy as np
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
        ex = getattr(world, "_device_exchange", None)
        if ex is not None:
            ex.align()

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

    # -- transport ------------------------------------------------------

    @staticmethod
    def _wire(t: torch.Tensor, rows: int = 1) -> torch.Tensor:
        """``t`` as a contiguous (rows, bytes) uint8 tensor: the bytes that
        move, whatever the dtype."""
        return t.contiguous().reshape(-1).view(torch.uint8).reshape(rows, -1)

    def _gather_bytes(self, wire: torch.Tensor, axis: str) -> torch.Tensor:
        """(1, bytes) -> (n, bytes): every member's, in coordinate order."""
        import torch.distributed as dist

        if wire.is_cuda:
            return DeviceExchange.of(self.world, wire.device).all_gather(wire[0], self, axis)
        buf = torch.empty((self.size(axis), wire.shape[1]), dtype=torch.uint8)
        dist.all_gather(list(buf.split(1)), wire, group=self._groups[axis])
        return buf

    def _exchange(self, pieces: torch.Tensor, axis: str) -> tuple:
        """Piece j of ``pieces`` (n, ...) to the member at coordinate j, and
        the n pieces received: ``(their (n, bytes) uint8 wire, the pieces
        as tensors)``."""
        import torch.distributed as dist

        wire = self._wire(pieces, rows=pieces.shape[0])
        if wire.is_cuda:
            recv = DeviceExchange.of(self.world, wire.device).all_to_all(wire, self, axis)
        else:
            recv = torch.empty_like(wire)
            dist.all_to_all_single(recv, wire, group=self._groups[axis])
        return recv, recv.view(pieces.dtype).reshape(pieces.shape)

    def _count(self, axis: str, op: str, nbytes: int, t0: float) -> None:
        rec = self.stats[axis].setdefault(op, [0, 0, 0.0])
        rec[0] += 1
        rec[1] += int(nbytes)
        rec[2] += time.perf_counter() - t0

    # -- collectives ----------------------------------------------------

    def all_gather(self, t: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The ``axis`` group's tensors concatenated along ``dim`` in
        coordinate order (identical bytes on every member)."""
        n = self.size(axis)
        if n == 1:
            return t
        t0 = time.perf_counter()
        wire = self._wire(t)
        out = self._gather_bytes(wire, axis).view(t.dtype).reshape((n,) + tuple(t.shape))
        dim = dim % t.dim()
        out = out.movedim(0, dim).reshape(t.shape[:dim] + (n * t.shape[dim],) + t.shape[dim + 1:])
        self._count(axis, "all_gather", (n - 1) * wire.numel(), t0)
        return out

    def reduce_scatter(self, t: torch.Tensor, axis: str, dim: int,
                       out_dtype=None) -> torch.Tensor:
        """This rank's piece (by its coordinate) of the sum over the
        ``axis`` group of ``t``, cut along ``dim``; added in f32 in rank
        order, returned in ``out_dtype`` (default ``t``'s)."""
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
        recv, parts = self._exchange(pieces, axis)
        acc = parts[0].float()
        for p in parts[1:]:
            acc = acc + p.float()
        self._count(axis, "reduce_scatter", (n - 1) * recv.shape[1], t0)
        return acc.to(out_dtype)

    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int, cat_dim: int,
                   tag: str | None = None) -> torch.Tensor:
        """``t`` cut along ``split_dim`` into the ``axis`` group's pieces,
        piece j sent to the member at coordinate j; the pieces this rank
        receives concatenated along ``cat_dim`` in coordinate order. Counted
        as ``all_to_all`` or ``all_to_all:<tag>``."""
        n = self.size(axis)
        if n == 1:
            return t
        split_dim, cat_dim = split_dim % t.dim(), cat_dim % t.dim()
        if t.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dimension {split_dim} of {tuple(t.shape)} does not "
                             f"divide into {n}")
        t0 = time.perf_counter()
        pieces = t.unflatten(split_dim, (n, t.shape[split_dim] // n)).movedim(split_dim, 0)
        recv, parts = self._exchange(pieces, axis)
        shape = parts.shape[1:]
        out = parts.movedim(0, cat_dim).reshape(shape[:cat_dim] + (n * shape[cat_dim],)
                                                + shape[cat_dim + 1:])
        self._count(axis, "all_to_all" if tag is None else f"all_to_all:{tag}",
                    (n - 1) * recv.shape[1], t0)
        return out

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum",
                   out_dtype=None, tag: str | None = None) -> torch.Tensor:
        """The ``axis`` group's element-wise sum (f32, rank order, then
        ``out_dtype``, default ``t``'s) or max, the same bytes on every
        member; counted as ``all_reduce`` or ``all_reduce:<tag>``."""
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
        elif t.is_cuda and n * t.numel() * t.element_size() <= DeviceExchange.BYTES:
            # On the card, where the gathered tensors fit one buffer: one
            # round, every member's whole tensor summed here in the same f32
            # rank order (the reduce-scatter's sums).
            parts = self.all_gather(t.unsqueeze(0), axis, 0)
            acc = parts[0].float()
            for p in parts[1:]:
                acc = acc + p.float()
            out = acc.to(out_dtype)
        else:
            flat = t.reshape(-1)
            pad = -flat.numel() % n
            if pad:
                flat = torch.cat([flat, flat.new_zeros(pad)])
            piece = self.reduce_scatter(flat, axis, 0, out_dtype=out_dtype)
            out = self.all_gather(piece, axis, 0)[:t.numel()].reshape(t.shape)
        moved = sum(self.stats[axis][k][1] - stats.get(k, [0, 0])[1] for k in self.stats[axis])
        self.stats[axis] = stats
        self._count(axis, "all_reduce" if tag is None else f"all_reduce:{tag}", moved, t0)
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


class DeviceExchange:
    """One rank's exchange buffer on the card that every rank of the world
    shares, opened by the other ranks through CUDA IPC (made once per
    world, ``of``). A round of a collective over an axis: this rank writes
    its bytes into its buffer, waits for the write, passes the axis group's
    barrier, copies what it needs out of its peers' buffers, waits for the
    copies and passes a second barrier, after which no peer reads its
    buffer (so it may write the next round, or exit). Tensors larger than
    the buffer go in several rounds.

    The barrier is a file in the temporary directory mapped by every rank
    (the ranks share a host, as they share the card): each rank writes its
    count of the axis's barriers into its slot and waits until every member
    of its group has reached that count (a gloo collective costs
    milliseconds). The counts of a group's members must start equal: an
    earlier mesh may have grouped the axis's ranks otherwise (two pairs of
    a 2 x 2 mesh before a 1 x 4 one), and its groups may have passed
    different numbers of barriers. So every ``MeshComm`` made after the
    exchange aligns them (``align``). From there every member passes the
    same barriers in the same order, so none can be more than one ahead of
    a rank waiting (it would have passed a barrier without it); one that is
    has run other collectives, and it raises, as it does when a member does
    not come within the world's timeout."""

    BYTES = 64 << 20
    AXES = ("pod", "data", "model")

    def __init__(self, world, device):
        import atexit
        import tempfile
        import uuid

        import torch.distributed as dist

        self.device, self.timeout_s, self.rank = device, world.timeout_s, world.rank
        path = None
        if world.rank == 0:
            path = os.path.join(tempfile.gettempdir(), f"repro_torch_exchange_{uuid.uuid4().hex}")
            np.zeros((world.size, len(self.AXES)), dtype=np.int64).tofile(path)
            atexit.register(lambda: os.path.exists(path) and os.remove(path))
        self.buf, handle = self._allocate()
        every = [None] * world.size
        dist.all_gather_object(every, (world.rank, self._place(), path, handle))
        if len({p for _, p, _, _ in every}) != 1:
            raise RuntimeError("a device exchange needs every rank on one card")
        self.peers = {r: self.buf if r == world.rank else self._open(h) for r, _, _, h in every}
        self.flags = np.memmap(every[0][2], dtype=np.int64, mode="r+",
                               shape=(world.size, len(self.AXES)))

    # The card's side (a test may stand in for it with shared files):
    def _allocate(self) -> tuple:
        """This rank's buffer and the handle its peers open it by."""
        from torch.multiprocessing.reductions import reduce_tensor

        buf = torch.empty(self.BYTES, dtype=torch.uint8, device=self.device)
        return buf, reduce_tensor(buf)

    @staticmethod
    def _open(handle) -> torch.Tensor:
        fn, args = handle
        return fn(*args)

    def _place(self) -> str:
        """Where the buffers live: the card's UUID."""
        return str(torch.cuda.get_device_properties(self.device).uuid)

    def _sync(self) -> None:
        torch.cuda.current_stream(self.device).synchronize()

    @classmethod
    def of(cls, world, device) -> "DeviceExchange":
        """The world's exchange, made on its first call (collectively), as
        normal tensors even when that call runs under ``inference_mode``
        (a later call outside it writes into the buffer)."""
        ex = getattr(world, "_device_exchange", None)
        if ex is None:
            with torch.inference_mode(False):
                ex = world._device_exchange = cls(world, device)
        return ex

    def align(self) -> None:
        """Set this rank's count on each axis to the largest of the world's
        (a gloo all-reduce, so every rank has left its last barrier before
        any count moves), as every rank does when it makes a mesh's
        ``MeshComm``: every group of the new mesh starts in step."""
        import torch.distributed as dist

        row = torch.from_numpy(np.array(self.flags[self.rank]))
        dist.all_reduce(row, op=dist.ReduceOp.MAX)
        self.flags[self.rank] = row.numpy()

    def _barrier(self, comm, axis: str) -> None:
        """Wait for this rank's copies, then for the ``axis`` group."""
        self._sync()
        a = self.AXES.index(axis)
        k = int(self.flags[self.rank, a]) + 1
        self.flags[self.rank, a] = k
        members = list(self._members(comm, axis))
        deadline, spins = time.monotonic() + self.timeout_s, 0
        while True:
            counts = self.flags[members, a]
            if counts.min() >= k:
                return
            if counts.max() > k + 1:
                raise RuntimeError(f"device exchange on {axis!r}: the ranks are at barriers "
                                   f"{counts.tolist()}, this one at {k}")
            spins += 1
            if spins % 64 == 0:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"device exchange on {axis!r}: members {members} at "
                                       f"barriers {counts.tolist()}, this one waited for {k}")
                time.sleep(20e-6)
            else:
                os.sched_yield()

    @staticmethod
    def _members(comm, axis: str) -> tuple:
        return next(g for g in comm.mesh.axis_groups(axis) if comm.rank in g)

    def _round(self, comm, axis: str, rows: torch.Tensor, read) -> None:
        """One round: ``rows`` (k, m) written into this rank's buffer,
        ``read(member index, its buffer)`` for each member of the group."""
        self.buf[:rows.numel()].view(rows.shape).copy_(rows)
        self._barrier(comm, axis)
        for j, r in enumerate(self._members(comm, axis)):
            read(j, self.peers[r])
        self._barrier(comm, axis)

    def all_gather(self, wire: torch.Tensor, comm, axis: str) -> torch.Tensor:
        """(bytes,) uint8 on the card -> (n, bytes): every member's, in
        coordinate order."""
        n, nb = comm.size(axis), wire.numel()
        out = torch.empty((n, nb), dtype=torch.uint8, device=wire.device)
        for a in range(0, nb, self.BYTES):
            m = min(self.BYTES, nb - a)
            self._round(comm, axis, wire[None, a:a + m],
                        lambda j, peer: out[j, a:a + m].copy_(peer[:m]))
        return out

    def all_to_all(self, wire: torch.Tensor, comm, axis: str) -> torch.Tensor:
        """(n, bytes) uint8 on the card, row j for the member at coordinate
        j -> (n, bytes): row j from the member at coordinate j."""
        n, nb = wire.shape
        me = comm.index(axis)
        out = torch.empty_like(wire)
        step = max(1, self.BYTES // n)
        for a in range(0, nb, step):
            m = min(step, nb - a)
            self._round(comm, axis, wire[:, a:a + m],
                        lambda j, peer: out[j, a:a + m].copy_(peer[me * m:(me + 1) * m]))
        return out


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
    def forward(ctx, t, comm, axis, out_dtype, tag):
        ctx.dtype = t.dtype
        return comm.all_reduce(t, axis, "sum", out_dtype=out_dtype, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, axis, tag):
        ctx.args = (comm, axis, tag)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        comm, axis, tag = ctx.args
        return comm.all_reduce(g, axis, "sum", tag=tag), None, None, None


class _CopyToMany(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, axis, tag, *ts):
        ctx.args = (comm, axis, tag, [(t.shape, t.dtype) for t in ts])
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        comm, axis, tag, meta = ctx.args
        flat = comm.all_reduce(torch.cat([g.float().reshape(-1) for g in gs]), axis, "sum",
                               tag=tag)
        out, at = [], 0
        for shape, dtype in meta:
            n = math.prod(shape)
            out.append(flat[at:at + n].reshape(shape).to(dtype))
            at += n
        return (None, None, None, *out)


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, axis, split_dim, cat_dim, tag):
        ctx.args = (comm, axis, split_dim, cat_dim, tag)
        return comm.all_to_all(t, axis, split_dim, cat_dim, tag)

    @staticmethod
    def backward(ctx, g):
        comm, axis, split_dim, cat_dim, tag = ctx.args
        return comm.all_to_all(g, axis, cat_dim, split_dim, tag), None, None, None, None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, axis, dim, out_dtype):
        ctx.args = (comm, axis, dim, t.dtype)
        return comm.reduce_scatter(t, axis, dim, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, g):
        comm, axis, dim, dtype = ctx.args
        return comm.all_gather(g, axis, dim).to(dtype), None, None, None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, axis, dim):
        ctx.args = (comm, axis, dim % t.dim(), t.shape[dim])
        return comm.all_gather(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        comm, axis, dim, n = ctx.args
        return g.narrow(dim, comm.index(axis) * n, n), None, None, None


def exchange(t: torch.Tensor, comm: MeshComm, axis: str, split_dim: int, cat_dim: int,
             tag: str | None = None) -> torch.Tensor:
    """All-to-all over ``axis`` (``MeshComm.all_to_all``); the backward is
    the inverse all-to-all (``split_dim`` and ``cat_dim`` swapped)."""
    if comm.size(axis) == 1:
        return t
    return _Exchange.apply(t, comm, axis, split_dim, cat_dim, tag)


def scatter_sum(t: torch.Tensor, comm: MeshComm, axis: str, dim: int,
                out_dtype=None) -> torch.Tensor:
    """This rank's piece along ``dim`` of the sum over ``axis`` (f32, rank
    order, then ``out_dtype``); the backward all-gathers the gradient."""
    if comm.size(axis) == 1:
        return t.to(out_dtype or t.dtype)
    return _ScatterSum.apply(t, comm, axis, dim, out_dtype)


def gather_replicated(t: torch.Tensor, comm: MeshComm, axis: str, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` over ``axis`` of a piece whose gathered
    whole every member then uses alike (so its gradient is the same on
    every member): the backward keeps this rank's piece of the gradient."""
    if comm.size(axis) == 1:
        return t
    return _GatherReplicated.apply(t, comm, axis, dim)


def gather(t: torch.Tensor, comm: MeshComm, entry, dim: int) -> torch.Tensor:
    """All-gather ``t`` along ``dim`` over the axes of a spec entry (the
    minor axis first, so that the pieces land in the spec's order); the
    backward reduce-scatters the gradient back to the piece."""
    for axis in reversed(entry_axes(entry)):
        if comm.size(axis) > 1:
            t = _Gather.apply(t, comm, axis, dim)
    return t


def sum_over(t: torch.Tensor, comm: MeshComm, axis: str, out_dtype=None,
             tag: str | None = None) -> torch.Tensor:
    """All-reduce (sum) over ``axis``; the gradient passes through."""
    if comm.size(axis) == 1:
        return t.to(out_dtype or t.dtype)
    return _SumOver.apply(t, comm, axis, out_dtype, tag)


def copy_to(t: torch.Tensor, comm: MeshComm, axis: str, tag: str | None = None) -> torch.Tensor:
    """The identity; the gradient is all-reduced (summed) over ``axis``."""
    if comm.size(axis) == 1:
        return t
    return _CopyTo.apply(t, comm, axis, tag)


def copy_to_many(ts, comm: MeshComm, axis: str, tag: str | None = None) -> tuple:
    """``copy_to`` of several tensors at once: the identity on each; their
    gradients are summed over ``axis`` in one all-reduce (in f32, each then
    rounded once to its tensor's dtype)."""
    if comm.size(axis) == 1:
        return tuple(ts)
    return _CopyToMany.apply(comm, axis, tag, *ts)


def max_over(t: torch.Tensor, comm: MeshComm, axis: str) -> torch.Tensor:
    """All-reduce (max) over ``axis`` of a tensor that carries no gradient."""
    return comm.all_reduce(t.detach(), axis, "max")
