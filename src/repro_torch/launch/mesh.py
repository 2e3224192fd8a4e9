"""The worker mesh of the in-process distributed SBV runtime.

Counterpart of ``repro.launch.mesh.make_worker_mesh``: a 1-D mesh whose one
axis, ``"workers"``, stands for the paper's P MPI ranks. In the reference
it is a JAX device mesh that ``shard_map`` splits the block axis over; here
it is one process over a tuple of ``torch.device``s, and
``core.distributed`` sends worker k's slice of the blocks to
``mesh.devices[k]``. Devices may repeat, so k workers can share one card
(or the CPU). The multi-process case is ``repro_torch.multihost``.

The LM meshes of the reference (``make_production_mesh`` and the others)
are not ported here.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

AXIS = "workers"


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
