"""The worker mesh of the in-process distributed SBV runtime.

Counterpart of ``repro.launch.mesh.make_worker_mesh``: a 1-D mesh whose one
axis, ``"workers"``, stands for the paper's P MPI ranks. In the reference
it is a JAX device mesh that ``shard_map`` splits the block axis over; here
it is one process over a tuple of ``torch.device``s, and
``core.distributed`` sends worker k's slice of the blocks to
``mesh.devices[k]``. Devices may repeat, so k workers can share one card
(or the CPU). The multi-process case is ``repro_torch.multihost``.

The LM meshes (``make_production_mesh``, ``make_test_mesh``, ``make_mesh``)
are device-free: an ``LMMesh`` carries the axis names and sizes that the
sharding rules (``repro_torch.sharding``) read, and maps ranks to mesh
coordinates. Without ``--sharded`` the port runs an LM on the one device it
is given: a mesh's ``model`` axis sets the ``tp`` the model is built and run
at (the padded experts and the expanded decode cache), and the rules reckon
what each device of that mesh would hold. With ``--sharded`` each of the
mesh's ``size`` rank processes holds its own shards
(``repro_torch.sharding.placement``) and the ranks talk through
``repro_torch.sharding.collectives``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

AXIS = "workers"


@dataclass(frozen=True)
class LMMesh:
    """A device-free LM mesh: ``axis_names`` and their ``sizes``, in order."""

    axis_names: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) or any(int(n) < 1 for n in self.sizes):
            raise ValueError(f"mesh axes {self.axis_names} and sizes {self.sizes} do not match")

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def __str__(self) -> str:
        return "x".join(str(n) for n in self.sizes)

    def coords(self, rank: int) -> tuple:
        """Rank -> its index along each axis, row-major over ``axis_names``
        (the last axis varies fastest): the order in which ``jax.make_mesh``
        lays out the devices of the reference's ``make_test_mesh``."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        out = []
        for n in reversed(self.sizes):
            rank, i = divmod(rank, n)
            out.append(i)
        return tuple(reversed(out))

    def rank(self, coords) -> int:
        """The inverse of ``coords``."""
        r = 0
        for i, n in zip(coords, self.sizes):
            if not 0 <= i < n:
                raise ValueError(f"coordinates {tuple(coords)} outside the mesh {self}")
            r = r * n + i
        return r

    def axis_groups(self, axis: str) -> list:
        """The rank groups of ``axis``: for every setting of the other
        coordinates, the ranks along ``axis`` in coordinate order (every rank
        lies in exactly one group)."""
        a = self.axis_names.index(axis)
        groups = {}
        for r in range(self.size):
            c = self.coords(r)
            groups.setdefault(c[:a] + c[a + 1:], []).append(r)
        return [tuple(g) for g in groups.values()]


def make_production_mesh(*, multi_pod: bool = False) -> LMMesh:
    """(16, 16) over ``("data", "model")``, or (2, 16, 16) over ``("pod",
    "data", "model")``: the reference's single- and two-pod meshes."""
    if multi_pod:
        return LMMesh(("pod", "data", "model"), (2, 16, 16))
    return LMMesh(("data", "model"), (16, 16))


def make_test_mesh(shape=(2, 2), axes=("data", "model")) -> LMMesh:
    return LMMesh(tuple(axes), tuple(int(n) for n in shape))


def make_mesh(spec: str) -> LMMesh:
    """``"DxM"`` -> ``("data", "model")``, ``"PxDxM"`` -> ``("pod", "data",
    "model")``, as the reference's ``launch.train.make_mesh`` parses it."""
    try:
        dims = tuple(int(t) for t in spec.split("x"))
    except ValueError:
        dims = ()
    if len(dims) not in (2, 3):
        raise ValueError(f"mesh {spec!r}: expected DxM or PxDxM")
    names = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return LMMesh(names, dims)


@dataclass(frozen=True)
class WorkerMesh:
    """A 1-D mesh: ``devices[k]`` is worker k's device."""

    devices: tuple
    axis: str = AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as a JAX mesh's ``shape``."""
        return {self.axis: self.size}


def make_worker_mesh(n_workers: int | None = None, devices=None) -> WorkerMesh:
    """1-D mesh for the SBV GP runtime (axis name ``'workers'``).

    ``devices`` (a device, a device string or a sequence of them) defaults
    to the visible CUDA devices; the list is repeated cyclically to
    ``n_workers`` entries (default: one worker per listed device). With no
    CUDA device and no ``devices``, raise: the mesh never falls back to the
    CPU on its own."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices='cpu' to build a "
                               "worker mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = [torch.device(dv) for dv in devices]
    if not devices:
        raise ValueError("make_worker_mesh: empty device list")
    n = len(devices) if n_workers is None else int(n_workers)
    if n < 1:
        raise ValueError(f"make_worker_mesh: n_workers={n_workers} must be at least 1")
    return WorkerMesh(devices=tuple(devices[k % len(devices)] for k in range(n)))
