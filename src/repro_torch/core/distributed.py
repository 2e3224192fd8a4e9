"""Distributed SBV likelihood and prediction over a worker mesh (paper Alg. 1
steps 4-5).

Counterpart of ``repro.core.distributed``. Worker k's blocks live on
``mesh.devices[k]`` (``launch.mesh.WorkerMesh``): each worker computes the
batched likelihood of its own slice of the block axis, through the
likelihood kernel on a CUDA device (one launch per shard per evaluation),
and the per-shard sums are added in worker order on the parameters' device.
That sum is the reference's scalar ``psum`` (the paper's MPI_Allreduce):
communication per optimizer iteration is O(1) scalars. The loss is
differentiable through each shard's ``ops.sbv_loglik`` autograd function
and the cross-device sum.

Host preprocessing already grouped blocks by owner (Alg. 2's
MPI_Alltoall locality), so slicing the packed arrays on the leading block
axis IS the paper's data distribution; ``shard_blocks_by_owner`` and
``shard_prediction_by_owner`` are numpy, bitwise the reference's.
Prediction needs no collective: every shard computes its blocks'
conditionals in one predict launch and the results are gathered in block
order.
"""
from __future__ import annotations

import numpy as np
import torch

from .buckets import BucketedBlocks
from .kernels_math import KernelParams, cast_params
from .packing import PackedBlocks, PackedPrediction
from .predict import batched_block_predict_many
from .vecchia import batched_block_loglik

_LOGLIK_KEYS = ("blk_x", "blk_y", "blk_mask", "nn_x", "nn_y", "nn_mask")


def shard_blocks_by_owner(packed: PackedBlocks, n_workers: int) -> PackedBlocks:
    """Reorder blocks so each worker's blocks are contiguous, then pad the
    block count to a multiple of n_workers with fully-masked dummy blocks
    (identity padding => zero likelihood contribution)."""
    order = np.argsort(packed.owners, kind="stable")
    def g(a):
        return a[order]
    packed = PackedBlocks(
        blk_x=g(packed.blk_x), blk_y=g(packed.blk_y), blk_mask=g(packed.blk_mask),
        nn_x=g(packed.nn_x), nn_y=g(packed.nn_y), nn_mask=g(packed.nn_mask),
        owners=g(packed.owners),
    )
    bc = packed.n_blocks
    target = ((bc + n_workers - 1) // n_workers) * n_workers
    if target != bc:
        packed = packed.pad_to_blocks(target)
    # Contiguous-by-owner matches the paper's locality; with quantile
    # partitioning worker loads are near-equal, so tail padding suffices.
    return packed


def shard_prediction_by_owner(packed: PackedPrediction, n_workers: int) -> PackedPrediction:
    """Prediction-side twin of ``shard_blocks_by_owner``: contiguous-by-owner
    block order + fully-masked padding to a multiple of n_workers. Padded
    blocks produce mu=0/var=prior and are dropped at scatter time, so the
    reorder is free of correctness constraints: it only preserves the
    paper's locality (a worker serves the query blocks whose neighbors it
    already owns)."""
    order = np.argsort(packed.owners, kind="stable")
    g = lambda a: a[order]
    packed = PackedPrediction(
        q_x=g(packed.q_x), q_mask=g(packed.q_mask), q_idx=g(packed.q_idx),
        nn_x=g(packed.nn_x), nn_y=g(packed.nn_y), nn_mask=g(packed.nn_mask),
        owners=g(packed.owners),
    )
    bc = packed.n_blocks
    target = ((bc + n_workers - 1) // n_workers) * n_workers
    if target != bc:
        packed = packed.pad_to_blocks(target)
    return packed


def mesh_devices(mesh, axis: str = "workers") -> tuple:
    """The shard devices of ``axis`` of a ``WorkerMesh``, in worker order."""
    if axis != mesh.axis:
        raise ValueError(f"mesh has axis {mesh.axis!r}, not {axis!r}")
    return mesh.devices


def place_shards(arrays, devices) -> list:
    """Worker k's equal contiguous slice of every array's block axis, as
    tensors on ``devices[k]`` (the block count must divide the shard
    count: ``shard_blocks_by_owner`` pads it so)."""
    bc, k = arrays[0].shape[0], len(devices)
    if bc % k:
        raise ValueError(f"{bc} blocks do not split evenly over {k} shards")
    per = bc // k
    return [tuple(torch.as_tensor(a[i * per:(i + 1) * per]).to(dev) for a in arrays)
            for i, dev in enumerate(devices)]


def _on(params, device):
    return type(params)(*(torch.as_tensor(t).to(device) for t in params))


def _shard_loglik(params: KernelParams, arrays, nu: float, backend: str) -> torch.Tensor:
    """One shard's total log-likelihood, dispatched as ``packed_loglik``
    does: ``'auto'`` is the kernel on CUDA (the plain version on the CPU),
    ``'ref'`` the plain version at the observations' dtype."""
    if backend == "ref":
        return batched_block_loglik(cast_params(params, arrays[1].dtype), *arrays, nu=nu)
    if backend == "auto":
        from repro_torch.kernels import ops

        return ops.sbv_loglik(params, *arrays, nu=nu)
    raise ValueError(f"unknown backend {backend!r}")


def sum_over_shards(params, shards, loglik) -> torch.Tensor:
    """``sum_k loglik(params on shard k's device, shard k)`` added in worker
    order on the parameters' device: the reference's ``psum``."""
    out = params.log_beta.device
    total = None
    for arrs in shards:
        ll = loglik(_on(params, arrs[0].device), arrs).to(out)
        total = ll if total is None else total + ll
    return total


def distributed_loglik(params: KernelParams, packed: PackedBlocks, mesh, axis: str = "workers",
                       nu: float = 3.5, backend: str = "auto") -> torch.Tensor:
    """Total log-likelihood with blocks sharded over ``axis`` of ``mesh``
    (call ``shard_blocks_by_owner`` first so the block count divides)."""
    shards = place_shards([getattr(packed, k) for k in _LOGLIK_KEYS], mesh_devices(mesh, axis))
    return sum_over_shards(params, shards,
                           lambda p, a: _shard_loglik(p, a, nu, backend))


def distributed_predict(params, packed: PackedPrediction, mesh, axis: str = "workers",
                        nu: float = 3.5, backend: str = "auto"):
    """Batched block prediction with blocks sharded over ``axis``.

    Each shard computes the conditionals of its own blocks (one predict
    launch per shard on CUDA); unlike the likelihood there is NO
    collective: the per-shard ``(mu, var)`` are gathered on the first
    worker's device in block order. Returns ``(mu, var)`` as (bc, bs_pred)
    tensors in the order of ``packed`` (call ``shard_prediction_by_owner``
    first so bc divides)."""
    devices = mesh_devices(mesh, axis)
    mus, variances = [], []
    for arrs in place_shards(packed.arrays(), devices):
        (mu, var), = batched_block_predict_many(_on(params, arrs[0].device), [arrs], nu=nu,
                                                backend=backend)
        mus.append(mu.to(devices[0]))
        variances.append(var.to(devices[0]))
    return torch.cat(mus), torch.cat(variances)


def sharded_packed_predict(params, packed: PackedPrediction, mesh, axis: str = "workers",
                           nu: float = 3.5, backend: str = "auto"):
    """One sharded micro-batch: owner-contiguous reorder + padded sharding +
    distributed block conditionals. Returns ``(packed, mu, var)``: the
    REORDERED packed (its ``q_idx`` matches the output block order), so the
    caller scatters with the right indices."""
    packed = shard_prediction_by_owner(packed, len(mesh_devices(mesh, axis)))
    mu, var = distributed_predict(params, packed, mesh, axis=axis, nu=nu, backend=backend)
    return packed, mu, var


def distributed_bucketed_loglik(params: KernelParams, bucketed: BucketedBlocks, mesh,
                                axis: str = "workers", nu: float = 3.5,
                                backend: str = "auto") -> torch.Tensor:
    """Total loglik of a ``BucketedBlocks`` with each bucket sharded over
    ``axis``: per-bucket owner-contiguous reorder + masked padding to the
    worker count, one shard sum per bucket, added in bucket order.

    Sharding bucket by bucket balances *work*, not block counts: every
    shard receives an equal slice of EVERY bucket, and within a bucket
    block sizes agree to the geometric-ceiling width. One-shot: optimizer
    loops use ``distributed_neg_loglik_fn``, which places every bucket
    once."""
    n_workers = len(mesh_devices(mesh, axis))
    total = None
    for pk in bucketed.buckets:
        ll = distributed_loglik(params, shard_blocks_by_owner(pk, n_workers), mesh, axis=axis,
                                nu=nu, backend=backend)
        total = ll if total is None else total + ll
    return total


def distributed_neg_loglik_fn(packed, nu: float, mesh, axis: str = "workers",
                              backend: str = "auto"):
    """Loss closure for ``fit_sbv(distributed=(mesh, axis))``:
    ``f(params) -> -loglik/n`` with every shard placed on its worker's
    device once.

    Accepts a uniform ``PackedBlocks`` or a ``BucketedBlocks``; bucketed
    inputs are sharded bucket by bucket (see
    ``distributed_bucketed_loglik``)."""
    devices = mesh_devices(mesh, axis)
    buckets = packed.buckets if isinstance(packed, BucketedBlocks) else [packed]
    placed = []
    for pk in buckets:
        pk = shard_blocks_by_owner(pk, len(devices))
        placed.append(place_shards([getattr(pk, k) for k in _LOGLIK_KEYS], devices))
    n = packed.n_points
    ll = lambda p, a: _shard_loglik(p, a, nu, backend)

    def loss(params):
        total = None
        for shards in placed:
            s = sum_over_shards(params, shards, ll)
            total = s if total is None else total + s
        return -total / n

    return loss
