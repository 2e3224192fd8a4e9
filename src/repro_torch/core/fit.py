"""MLE parameter estimation for SBV (paper Alg. 1 outer loop).

Counterpart of the monolithic in-core branches of ``repro.core.fit.fit_sbv``:
Adam on ``-loglik/n`` with an analytic gradient, alternating with the
Scaled-Vecchia structure refresh (the block/neighbor structure is rebuilt
with the current beta estimate every outer round). The packed arrays go to
the device once per round; every step runs the fused likelihood kernel on
the GPU (the plain version on the CPU) and its chunked backward pass.

A 2-D ``y`` with p >= 2 outputs takes the shared-structure multi-output
(VPPE) fit: Adam on the pooled profile likelihood through the fused
multi-output stats kernel. An (n, 1) ``y`` squeezes to the single-output
fit, so p = 1 is bitwise the 1-D path.

``n_buckets`` runs every step on the bucketed layout (``core.buckets``),
re-bucketed at every structure refresh; ``precision`` selects the ladder
tier, re-probed per bucket (``assign_precision`` at the current params)
every outer round for single-output fits and cast-only for multi-output
ones, as in the reference.

Out of core (a row store for ``x``, and/or ``stream_chunk``): the
structure comes from streaming passes over the store
(``data.streaming``), the blocks are packed into pieces of about
``stream_chunk`` rows, and the pieces wait in a ``PackedChunkSpool`` (on
the device, or on disk behind a prefetching copy thread). Every step sums
each piece's value and gradient in spool order: one likelihood kernel
launch per piece on CUDA (two multi-output stats launches per piece, for
the pooled objective's two passes).

In-process distributed (``distributed=(mesh, axis)``, a
``launch.mesh.WorkerMesh``): every likelihood evaluation, in core or per
streaming piece, slices the block axis over the mesh's workers, owner by
owner, and adds the per-shard sums in worker order (``core.distributed``):
one kernel launch per shard. Multi-host (``multihost=``, a
``repro_torch.multihost`` comm): each rank process builds, packs and
spools only its own partition of a row store, and the ranks all-reduce
``[loss, grad]`` once per lockstep chunk slot per step.

``fit_neldermead`` is the reference's derivative-free path (scipy
Nelder-Mead at one structure pass), its loss through the same kernel.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.data.store import PartitionedStore, as_store, is_store
from repro_torch.data.streaming import (DEFAULT_STRUCT_BATCH, PackedChunkSpool,
                                        device_cache_budget, multihost_preprocess,
                                        pack_block_chunk, stream_reserve_bytes,
                                        streaming_moments, streaming_preprocess)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.optim import adam_init, adam_update

from .buckets import (BucketedBlocks, _group, apply_precision, as_policy, assign_precision,
                      bucket_blocks, bucket_ceilings, cast_packed)
from .distributed import (distributed_neg_loglik_fn, mesh_devices, place_shards,
                          shard_blocks_by_owner, sum_over_shards)
from .kernels_math import KernelParams, cast_params
from .multioutput import (MultiOutputParams, as_multi_params, batched_multi_stats_remat,
                          multi_profile_neg_loglik_fn, pooled_objective, profile_sigma2,
                          with_profiled_sigma2)
from .packing import round_up
from .pipeline import SBVConfig, preprocess
from .vecchia import MAP_BATCH, batched_block_loglik_joint_remat, packed_arrays, packed_loglik

@dataclass
class FitResult:
    params: KernelParams  # or MultiOutputParams (multi-output fits)
    history: list = field(default_factory=list)  # (outer, inner, -loglik/n)
    packed: object = None
    stream_stats: dict | None = None  # set by the streaming (out-of-core) path
    precision_tiers: list | None = None  # per-bucket ladder tiers (last round)


def neg_loglik_fn(packed, nu: float, backend: str, device=None):
    """``f(params) -> -loglik/n`` on one packed (or bucketed) dataset,
    with its operands moved to the device once."""
    n = packed.n_points
    arrays = packed_arrays(packed, resolve_device(device))

    def f(params):
        return -packed_loglik(params, packed, nu=nu, backend=backend, arrays=arrays) / n

    return f


def _value_and_grad(loss_fn, params):
    """``(loss, grads)`` of ``loss_fn`` at a NamedTuple of leaf tensors; a
    leaf the loss does not depend on gets a zero gradient."""
    leaves = type(params)(*(p.detach().requires_grad_(True) for p in params))
    loss = loss_fn(leaves)
    grads = torch.autograd.grad(loss, tuple(leaves), allow_unused=True)
    return loss.detach(), tuple(torch.zeros_like(p) if g is None else g
                                for p, g in zip(leaves, grads))


def fit_sbv(
    x: np.ndarray,
    y: np.ndarray = None,
    cfg: SBVConfig = None,
    init: KernelParams | None = None,
    nu: float = 3.5,
    lr: float = 0.05,
    inner_steps: int = 60,
    outer_rounds: int = 3,
    backend: str = "auto",
    verbose: bool = False,
    device=None,
    distributed=None,
    n_buckets: int | None = None,
    stream_chunk: int | None = None,
    spool_dir: str | None = None,
    device_cache: int | None = None,
    prefetch: int = 2,
    multihost=None,
    precision=None,
    tuning=None,
) -> FitResult:
    """Maximum-likelihood fit of (sigma^2, beta, nugget) with fixed nu.

    Runs on ``device`` (default: the current CUDA device; with no GPU pass
    ``device='cpu'``). ``backend='auto'`` takes the fused kernel on CUDA
    and the plain version on the CPU; ``'ref'`` differentiates the plain
    version directly. A 2-D ``y`` (n, p) fits the multi-output model and
    returns ``MultiOutputParams`` (p = 1 squeezes to the 1-D fit).

    ``n_buckets`` fits on the bucketed layout, re-bucketed every outer
    round. ``precision`` (a ladder tier or a ``PrecisionPolicy``) probes
    each bucket at the current params every outer round and demotes it
    until its nll is within the tier's budget (multi-output fits cast
    without probing); the last round's tiers are
    ``FitResult.precision_tiers``.

    Out of core: pass ``x`` as a row store (``repro_torch.data.ArrayStore``
    / ``MemoryStore``, with ``y=None``) and/or set ``stream_chunk`` to fit
    through the streaming path — structure, packing and likelihood all run
    in bounded ~``stream_chunk``-row passes. In-core arrays with
    ``stream_chunk`` take the identical code over a ``MemoryStore``, so
    store-backed and in-core streaming fits agree bitwise. ``device_cache``
    (bytes; None = auto, 0 = off) is the spool's device tier, ``prefetch``
    the disk pieces staged ahead on a copy thread (0 = synchronous),
    ``spool_dir`` where the disk tier lives (a temporary directory by
    default). Streaming precision casts every piece to the policy's tier
    without a probe. ``FitResult.stream_stats`` reports pieces, bytes and
    tiers.

    ``distributed=(mesh, axis)`` (a ``launch.mesh.WorkerMesh``; workers
    may share a device) works with both paths: in core it shards the
    monolithic packed likelihood (``core.distributed``), streaming it
    shards every spooled piece, whose block count is rounded up to the
    worker count. The parameters live on ``device``, by default the mesh's
    first device. ``multihost=`` (a ``repro_torch.multihost`` comm) runs
    the MULTI-PROCESS streaming fit: each rank process builds, packs and
    spools only its own row partition and the ranks all-reduce
    ``[loss, grad]`` once per chunk per step; with a ``LoopbackComm`` it is
    bitwise the single-process streaming fit. Multi-output fits take
    neither, as in the reference.

    ``tuning`` starts pre-tuned from an autotuner record (a
    ``repro_torch.tuning.TuningRecord``, its dict, or the checkpoint
    directory or json path holding one, from either package): it fills
    ``n_buckets``, ``stream_chunk`` and ``precision`` where the caller left
    them unset, and ``backend`` when it is ``'auto'`` (a reference record's
    ``'pallas'`` / ``'pallas_tiled'`` read as ``'auto'``). Explicit
    arguments win over the record."""
    if cfg is None:
        raise TypeError("fit_sbv requires an SBVConfig")
    if tuning is not None:
        from repro_torch.tuning import apply_record

        n_buckets, stream_chunk, precision, backend = apply_record(
            tuning, n_buckets=n_buckets, stream_chunk=stream_chunk, precision=precision,
            backend=backend, probe=True)
    if multihost is not None and not (is_store(x) or stream_chunk is not None):
        raise ValueError("multihost= requires the streaming path: pass a "
                         "row store and/or set stream_chunk")
    if device is None and distributed is not None:
        device = mesh_devices(*distributed)[0]
    stream = dict(spool_dir=spool_dir, device_cache=device_cache, prefetch=prefetch,
                  precision=precision)
    if is_store(x):
        store = as_store(x, y)
        multi = np.asarray(store.read_slice(0, 1)[1]).ndim == 2
        stream_chunk = stream_chunk or DEFAULT_STRUCT_BATCH
    else:
        if y is None or np.asarray(y).ndim not in (1, 2):
            raise ValueError("fit_sbv needs 1-D or 2-D observations y (or a row store as x)")
        if np.asarray(y).ndim == 2 and np.asarray(y).shape[1] == 1:
            init1 = init.output_params(0) if isinstance(init, MultiOutputParams) else init
            return fit_sbv(x, np.asarray(y)[:, 0], cfg, init=init1, nu=nu, lr=lr,
                           inner_steps=inner_steps, outer_rounds=outer_rounds, backend=backend,
                           verbose=verbose, device=device, distributed=distributed,
                           n_buckets=n_buckets, stream_chunk=stream_chunk, multihost=multihost,
                           **stream)
        store = None if stream_chunk is None else as_store(x, y)
        multi = np.asarray(y).ndim == 2
    if multi and (multihost is not None or distributed is not None):
        raise NotImplementedError("multi-output fits do not support "
                                  "multihost=/distributed= yet")
    if store is not None:
        if not multi:
            if multihost is not None:
                if distributed is not None:
                    raise ValueError("multihost and in-process distributed= are "
                                     "mutually exclusive (one device per host)")
                if n_buckets:
                    raise NotImplementedError("bucketed piece shapes are not wired "
                                              "into the multihost mode yet")
            return _fit_sbv_streaming(store, cfg, init, nu, lr, inner_steps, outer_rounds,
                                      backend, verbose, device, stream_chunk, n_buckets,
                                      distributed=distributed, comm=multihost, **stream)
        if n_buckets:
            raise NotImplementedError("bucketed pieces are not wired into the "
                                      "multi-output streaming fit (as in the reference)")
        return _fit_sbv_multi_streaming(store, cfg, init, nu, lr, inner_steps, outer_rounds,
                                        backend, verbose, device, stream_chunk, **stream)
    if multi:
        return _fit_sbv_multi(x, np.asarray(y), cfg, init, nu, lr, inner_steps, outer_rounds,
                              backend, verbose, device, n_buckets, precision)
    policy = None
    if precision is not None:
        policy = as_policy(precision)
        if policy.tier == "f64" and not policy.probe:
            policy = None
    dev = resolve_device(device)
    d = x.shape[1]
    if init is None:
        init = KernelParams.create(sigma2=float(np.var(y)), beta=0.5, nugget=1e-3, d=d)
    params = KernelParams(*(torch.as_tensor(a).to(dev).detach() for a in init))
    history = []
    packed = None
    tiers = None

    for outer in range(outer_rounds):
        beta_np = params.beta.detach().cpu().numpy()
        packed, _ = preprocess(x, y, beta_np, cfg)
        if n_buckets:
            packed = bucket_blocks(packed, n_buckets=n_buckets)
        if policy is not None:
            # Probe and demote at the current params, every structure
            # refresh (re-clustering reshapes the buckets).
            tiers = assign_precision(params, packed, policy, nu=nu, backend=backend)
            packed = (apply_precision(packed, tiers) if isinstance(packed, BucketedBlocks)
                      else cast_packed(packed, tiers[0]))
        if distributed is not None:
            loss_fn = distributed_neg_loglik_fn(packed, nu, *distributed, backend=backend)
        else:
            loss_fn = neg_loglik_fn(packed, nu, backend, device=dev)

        state = adam_init(params)
        for it in range(inner_steps):
            loss, g = _value_and_grad(loss_fn, params)
            params, state = adam_update(g, state, params, lr)
            history.append((outer, it, float(loss)))
            if verbose and it % 10 == 0:
                print(f"[fit] outer={outer} it={it} nll/n={float(loss):.6f}")
    return FitResult(params=params, history=history, packed=packed, precision_tiers=tiers)


def _fit_sbv_multi(x, y, cfg, init, nu, lr, inner_steps, outer_rounds, backend, verbose,
                   device, n_buckets=None, precision=None) -> FitResult:
    """Monolithic multi-output fit (counterpart of the reference's
    ``_fit_sbv_multi``).

    One structure pass per outer round shared by all p outputs; Adam
    minimizes the pooled profile likelihood over (log_beta, log_tau2)
    through the shared-Cholesky stats; the per-output sigma2 are profiled
    in closed form at the end (their gradient in the pooled objective is
    identically zero, so they ride along). ``n_buckets`` re-buckets every
    round; ``precision`` casts every bucket to the policy's tier without a
    probe (the per-bucket probe is single-output only, as in the
    reference)."""
    dev = resolve_device(device)
    d, p = x.shape[1], y.shape[1]
    if init is None:
        init = MultiOutputParams.create(sigma2=np.maximum(np.var(y, axis=0), 1e-12), beta=0.5,
                                        tau2=1e-3, d=d, p=p)
    params = as_multi_params(init, p, d)
    params = MultiOutputParams(*(torch.as_tensor(a).to(dev).detach() for a in params))
    history = []
    packed = None
    tier = None
    if precision is not None and as_policy(precision).tier != "f64":
        tier = as_policy(precision).tier

    for outer in range(outer_rounds):
        beta_np = params.beta.detach().cpu().numpy()
        packed, _ = preprocess(x, y, beta_np, cfg)
        if n_buckets:
            packed = bucket_blocks(packed, n_buckets=n_buckets)
        if tier:
            packed = (apply_precision(packed, tier) if isinstance(packed, BucketedBlocks)
                      else cast_packed(packed, tier))
        loss_fn = multi_profile_neg_loglik_fn(packed, nu, backend, device=dev)

        state = adam_init(params)
        for it in range(inner_steps):
            loss, g = _value_and_grad(loss_fn, params)
            params, state = adam_update(g, state, params, lr)
            history.append((outer, it, float(loss)))
            if verbose and it % 10 == 0:
                print(f"[fit-multi] outer={outer} it={it} nll/np={float(loss):.6f} p={p}")
    params = with_profiled_sigma2(params, packed, nu=nu, backend=backend)
    return FitResult(params=params, history=history, packed=packed)


# -- the streaming (out-of-core) fits ---------------------------------------


def _chunk_loglik(params: KernelParams, arrays, nu: float, backend: str) -> torch.Tensor:
    """Total log-likelihood of one spooled piece.

    ``'ref'`` runs the checkpointed joint-assembly form in ``MAP_BATCH``-
    block slices, at the piece's observation dtype (the precision ladder's
    accumulation dtype; a no-op for f64 pieces): autograd through the whole
    piece at once would keep O(10) (bc, bs+m, bs+m) buffers alive.
    ``'auto'`` launches the likelihood kernel on CUDA (its backward
    recomputes the plain version in ``ops.BACKWARD_CHUNK``-block chunks)
    and runs the plain version on the CPU."""
    if backend == "ref":
        return batched_block_loglik_joint_remat(cast_params(params, arrays[1].dtype), *arrays,
                                                nu=nu)
    if backend == "auto":
        return ops.sbv_loglik(params, *arrays, nu=nu)
    raise ValueError(f"unknown backend {backend!r}")


def _chunk_grad(params: KernelParams, arrays, nu: float, backend: str, n_points: int,
                shard_devices=None):
    """``(value, grads)`` of one piece's ``-loglik / n`` contribution; with
    ``shard_devices``, the piece's block axis is sliced over them and the
    per-shard logliks are added in worker order (``core.distributed``)."""
    if shard_devices is None:
        return _value_and_grad(lambda p: -_chunk_loglik(p, arrays, nu, backend) / n_points,
                               params)
    shards = place_shards(arrays, shard_devices)
    ll = lambda p, a: _chunk_loglik(p, a, nu, backend)
    return _value_and_grad(lambda p: -sum_over_shards(p, shards, ll) / n_points, params)


def _multi_stats_chunk(params: MultiOutputParams, arrays, nu: float, backend: str):
    """``(logdet0, q0 (p,))`` of one spooled multi-output piece, as
    ``multioutput.packed_multi_stats`` dispatches them: ``'ref'`` casts the
    unit-variance params to the piece's accumulation dtype and checkpoints
    the joint-form stats in ``MAP_BATCH``-block slices; ``'auto'`` is the
    stats kernel on CUDA (the plain version on the CPU)."""
    p0 = params.structure_params()
    if backend == "ref":
        return batched_multi_stats_remat(cast_params(p0, arrays[1].dtype), *arrays, nu=nu)
    if backend == "auto":
        return ops.sbv_multi_stats(p0, *arrays, nu=nu)
    raise ValueError(f"unknown backend {backend!r}")


def _multi_wgrad_chunk(params: MultiOutputParams, w, arrays, nu: float, backend: str,
                       n_points: int, p: int):
    """Gradient of one piece's weighted-stats scalar.

    The pooled profile objective takes logs of GLOBAL sums, so chunked
    accumulation is two passes per step: pass A sums (logdet0, q0) over
    the pieces; pass B accumulates the gradient of
    ``(p*ld_c/2 + n/2 * sum_j q_cj / Q_j) / (n*p)`` with the weights
    ``w = 1/Q_j`` frozen at pass A's totals — by the chain rule the sum
    over pieces is the exact gradient of the pooled objective."""
    def f(prm):
        ld_c, q_c = _multi_stats_chunk(prm, arrays, nu, backend)
        return (0.5 * p * ld_c + 0.5 * n_points * torch.sum(w * q_c)) / (n_points * p)

    return _value_and_grad(f, params)[1]


def _piece_backend(backend: str, piece) -> str:
    """Resolve ``backend='auto'`` per spooled piece shape through
    ``kernels.ops.select_backend``, as the reference does (on Hopper it is
    the kernel route for every shape and tier)."""
    if backend != "auto":
        return backend
    return ops.select_backend(piece.bs_max, piece.m, kind="loglik", dtype=piece.blk_x.dtype)


def _streaming_tier(precision) -> str | None:
    """The ladder tier every streamed piece is cast to (no probe), or None
    for f64."""
    if precision is None or as_policy(precision).tier == "f64":
        return None
    return as_policy(precision).tier


def _spool_budget(device_cache, struct, cfg, d: int, n_out: int, tier, backend: str,
                  prefetch: int, dev) -> tuple[int, dict]:
    """The spool's device-tier budget, and the reserve beside it with what
    the backward is sized by (for ``stream_stats``).

    ``device_cache=None`` takes half the free device memory minus
    ``stream_reserve_bytes``: the port's backward live set for ``n_out``
    outputs and ``d`` coordinates, the kernel's scratch and the staged
    pieces in flight. A uniform piece holds bc_pad x (bs_max + m) points of
    d coordinates, ``n_out`` observations and a mask byte each; bucketed
    pieces are smaller."""
    bc_pad = max((len(r) for r in struct.plan), default=1)
    coord = 2 if tier == "bf16" else (4 if tier else int(np.dtype(cfg.dtype).itemsize))
    acc = 4 if tier else int(np.dtype(cfg.dtype).itemsize)
    piece_bytes = bc_pad * (struct.bs_max + cfg.m) * (d * coord + n_out * acc + 1)
    reserve = stream_reserve_bytes(struct.bs_max, cfg.m, bc_pad, piece_bytes, backend,
                                   prefetch, acc, n_out, d)
    sizing = {"backward_blocks": MAP_BATCH if backend == "ref" else ops.BACKWARD_CHUNK,
              "backward_itemsize": acc if backend == "ref" else 8,
              "device_reserve_bytes": reserve}
    if device_cache is not None:
        return int(device_cache), sizing
    return device_cache_budget(reserve_bytes=reserve, device=dev), sizing


def _new_stream_stats(tier, **extra) -> dict:
    return {"n_chunks": 0, "n_pieces": 0, "packed_chunk_bytes_max": 0, "spool_bytes": 0,
            "bs_max": 0, "bc": 0, "n_shards": 1, **extra, "device_cached_pieces": 0,
            "device_cached_bytes": 0, "h2d_bytes_per_step": 0, "inner_steps_total": 0,
            "inner_time_s": 0.0, "precision": tier or "f64", "device_cache_budget": 0}


@contextmanager
def _stream_round(store, beta, cfg, stream_chunk: int, outer: int, n_out: int, tier,
                  backend: str, stats: dict, dev, spool_dir=None, device_cache=None,
                  prefetch: int = 2, precision=None, comm=None):
    """One outer round's streaming structure and an empty spool sized for
    it: yields ``(struct, spool)`` for the caller to fill and iterate, then
    records the spool in ``stats`` and removes it. (``precision`` is the
    caller's: it casts the pieces.) With a host ``comm``, the structure is
    this rank's share (``multihost_preprocess`` over a ``PartitionedStore``)
    and the spool directory is the rank's own."""
    if comm is None:
        struct, name = streaming_preprocess(store, beta, cfg, stream_chunk), f"round{outer}"
    else:
        struct = multihost_preprocess(store, beta, cfg, stream_chunk, comm)
        name = f"rank{comm.rank}-round{outer}"
    budget, sizing = _spool_budget(device_cache, struct, cfg, store.d, n_out, tier, backend,
                                   prefetch, dev)
    stats.update(sizing)
    stats["device_cache_budget"] = max(stats["device_cache_budget"], budget)
    work_dir = spool_dir or tempfile.mkdtemp(prefix="sbv-spool-")
    spool = PackedChunkSpool(os.path.join(work_dir, name), device_budget=budget, device=dev)
    try:
        yield struct, spool
        _record_spool(stats, struct, spool)
    finally:
        spool.cleanup()
        if spool_dir is None:
            shutil.rmtree(work_dir, ignore_errors=True)


def _record_spool(stats: dict, struct, spool) -> None:
    """Last-round piece counts and tiers in ``stats``; bytes as maxima over
    rounds (the cached-bytes peak is what ``working_set_model`` covers)."""
    stats.update(
        n_chunks=len(struct.plan), n_pieces=len(spool),
        packed_chunk_bytes_max=max(stats["packed_chunk_bytes_max"], spool.packed_bytes_max),
        spool_bytes=max(stats["spool_bytes"], spool.packed_bytes_total),
        bs_max=struct.bs_max, bc=struct.blocks.n_blocks,
        device_cached_pieces=spool.n_device, h2d_bytes_per_step=spool.disk_bytes_total,
        device_cached_bytes=max(stats["device_cached_bytes"], spool.device_bytes),
    )


def _serial_step(params, spool, nu, n: int, prefetch: int, shard_devices):
    """One step's ``(loss, grad)``: every piece's value and gradient summed
    on the device in spool order."""
    loss = grad = None
    for arrays, piece_backend in spool.iter_arrays(prefetch=prefetch):
        v, g = _chunk_grad(params, arrays, nu, piece_backend, n, shard_devices)
        loss = v if loss is None else loss + v
        grad = g if grad is None else tuple(a + b for a, b in zip(grad, g))
    return float(loss), grad


def _lockstep_step(params, spool, nu, n: int, prefetch: int, comm, n_lock: int):
    """One step's ``(loss, grad)`` across ranks: one ``[loss, grad]``
    all-reduce per lockstep slot, ``n_lock`` slots (a rank out of pieces
    sends zeros), summed on the host in slot order."""
    sizes = [p.numel() for p in params]
    loss, gsum = 0.0, np.zeros(sum(sizes))
    pieces = spool.iter_arrays(prefetch=prefetch)
    for _ in range(n_lock):
        entry = next(pieces, None)
        vec = np.zeros(1 + gsum.size)
        if entry is not None:
            arrays, piece_backend = entry
            v, g = _chunk_grad(params, arrays, nu, piece_backend, n)
            vec = np.concatenate([[float(v)], torch.cat(
                [t.reshape(-1) for t in g]).detach().cpu().numpy()])
        red = comm.allreduce(vec)
        loss += float(red[0])
        gsum = gsum + red[1:]
    pieces.close()
    grad = tuple(torch.as_tensor(a).reshape(p.shape).to(p)
                 for a, p in zip(np.split(gsum, np.cumsum(sizes)[:-1]), params))
    return loss, grad


def _fit_sbv_streaming(store, cfg, init, nu, lr, inner_steps, outer_rounds, backend, verbose,
                       device, stream_chunk, n_buckets=None, distributed=None, comm=None,
                       **spooling) -> FitResult:
    """Out-of-core fit: every pass holds ~``stream_chunk`` data rows.

    Per outer round: streaming structure (mini-batch k-means + store-backed
    filtered NNS), then the rank-ordered blocks are packed into
    ``stream_chunk``-row chunks (gather-and-remap from the store), padded
    to ONE shared shape (or, with ``n_buckets``, to global bucket ceilings
    with per-cell block counts, so every piece lands on one of a bounded
    set of shapes), cast to the precision tier, and handed to the two-tier
    ``PackedChunkSpool``. Each inner step accumulates value and gradient
    over the pieces IN SPOOL ORDER: the likelihood is a sum over blocks, so
    chunked accumulation differs from the monolithic fit only in float
    summation order, and the tier a piece waits in changes nothing.

    ``distributed=(mesh, axis)`` shards every piece's block axis over the
    mesh's workers (owner-contiguous, masked padding to the shard count,
    which every piece's block count is rounded up to), one kernel launch
    per shard; the block reorder changes only the summation order.

    ``comm`` (a ``repro_torch.multihost`` comm) makes it the multi-process
    fit: one rank process per partition of the row store, construction and
    packing per rank (``multihost_preprocess``), one ``[loss, grad]``
    all-reduce per lockstep chunk slot per step (``_lockstep_step``). The
    reduced vector, 1 + n_param float64 scalars, is identical bytes on
    every rank, so the replicated Adam state stays in lockstep and every
    rank finishes with identical parameters. With a ``LoopbackComm`` the
    fit is bitwise the serial one; across ranks it differs only in
    summation order. ``spooling``: ``spool_dir``, ``device_cache``,
    ``prefetch``, ``precision``."""
    dev = resolve_device(device)
    tier = _streaming_tier(spooling.get("precision"))
    prefetch = spooling.get("prefetch", 2)
    shard_devices = None if distributed is None else mesh_devices(*distributed)
    n_shards = 1 if shard_devices is None else len(shard_devices)
    if comm is not None and not isinstance(store, PartitionedStore):
        store = PartitionedStore(store, comm.size, comm.rank)
    n, d = store.n_rows, store.d
    if init is None:
        _, var_y = streaming_moments(store, comm=comm)
        init = KernelParams.create(sigma2=var_y, beta=0.5, nugget=1e-3, d=d)
    params = KernelParams(*(torch.as_tensor(a).to(dev).detach() for a in init))
    history = []
    if comm is None:
        stats = _new_stream_stats(tier, n_shards=n_shards)
    else:
        stats = _new_stream_stats(tier, n_hosts=comm.size, rank=comm.rank, lockstep_chunks=0,
                                  allreduce_scalars_per_chunk=1 + sum(p.numel() for p in params))

    for outer in range(outer_rounds):
        with _stream_round(store, params.beta.detach().cpu().numpy(), cfg, stream_chunk, outer,
                           1, tier, backend, stats, dev, comm=comm,
                           **spooling) as (struct, spool):
            # A rank packs from its row table (owned and halo rows).
            rows = store if comm is None else struct.table
            # One shared shape (per rank: only [loss, grad] crosses ranks),
            # its block count a multiple of the shard count.
            bc_pad = round_up(max((len(r) for r in struct.plan), default=1), n_shards)
            if n_buckets:
                # GLOBAL bucket ceilings + per-cell bc padding: every chunk's
                # pieces land on one of <= occupied-cells shapes.
                bs_true = np.asarray([struct.blocks.members[b].size
                                      for b in struct.blocks.order])
                m_true = np.asarray([min(len(struct.neigh[b]), cfg.m)
                                     for b in struct.blocks.order])
                bs_ceils = bucket_ceilings(bs_true, n_buckets, 8)
                m_ceils = bucket_ceilings(m_true, n_buckets, 8)
                cell_bc: dict = {}
                for ranks in struct.plan:
                    for bs_c, m_c, idx in _group(bs_true[ranks], m_true[ranks], bs_ceils,
                                                 m_ceils):
                        # Same clamp bucket_blocks applies to piece shapes.
                        key = (min(bs_c, struct.bs_max), min(m_c, cfg.m))
                        cell_bc[key] = max(cell_bc.get(key, 0),
                                           round_up(round_up(idx.size, 8), n_shards))
            for ranks in struct.plan:
                packed = pack_block_chunk(rows, struct.blocks, struct.neigh, ranks, m=cfg.m,
                                          bs_max=struct.bs_max, dtype=cfg.dtype)
                if n_buckets:
                    bucketed = bucket_blocks(packed, ceilings=(bs_ceils, m_ceils))
                    groups = _group(bs_true[ranks], m_true[ranks], bs_ceils, m_ceils)
                    pieces = [pk.pad_to_blocks(cell_bc[(min(bs_c, packed.bs_max),
                                                        min(m_c, packed.m))])
                              for (bs_c, m_c, _), pk in zip(groups, bucketed.buckets)]
                else:
                    pieces = [packed.pad_to_blocks(bc_pad)]
                for pk in pieces:
                    if tier:
                        pk = cast_packed(pk, tier)
                    if shard_devices is not None:
                        # Owner-contiguous reorder; the shape is unchanged.
                        pk = shard_blocks_by_owner(pk, n_shards)
                    spool.add(pk, tag=_piece_backend(backend, pk))
            n_lock = len(spool)
            if comm is not None:
                n_lock = int(comm.allreduce_scalar(float(len(spool)), op="max"))
                stats.update(lockstep_chunks=n_lock, **struct.stats)

            state = adam_init(params)
            t_inner = time.perf_counter()
            for it in range(inner_steps):
                if comm is None:
                    loss, grad = _serial_step(params, spool, nu, n, prefetch, shard_devices)
                else:
                    loss, grad = _lockstep_step(params, spool, nu, n, prefetch, comm, n_lock)
                params, state = adam_update(grad, state, params, lr)
                history.append((outer, it, loss))
                if verbose and it % 10 == 0:
                    print(f"[fit-stream] outer={outer} it={it} nll/n={loss:.6f} "
                          f"pieces={len(spool)}/{n_lock} (device-cached {spool.n_device})")
            stats["inner_time_s"] += time.perf_counter() - t_inner
            stats["inner_steps_total"] += inner_steps
    return FitResult(params=params, history=history, packed=None, stream_stats=stats)


def _fit_sbv_multi_streaming(store, cfg, init, nu, lr, inner_steps, outer_rounds, backend,
                             verbose, device, stream_chunk, **spooling) -> FitResult:
    """Out-of-core multi-output fit: ``_fit_sbv_streaming``'s spool plan
    with the two-pass piece accumulation of ``_multi_wgrad_chunk``. Every
    pass holds ~stream_chunk data rows; blk_y / nn_y spool with their
    (..., p) output axis through the same tiers. ``precision`` casts every
    piece to the tier before spooling (no probe). The per-output sigma2 are
    profiled at the last round's final params (one more values pass)."""
    dev = resolve_device(device)
    tier = _streaming_tier(spooling.get("precision"))
    prefetch = spooling.get("prefetch", 2)
    n, d = store.n_rows, store.d
    y0 = np.asarray(store.read_slice(0, 1)[1])
    if y0.ndim != 2:
        raise ValueError("multi-output streaming fit needs (n, p) store rows")
    p = int(y0.shape[1])
    if init is None:
        init = MultiOutputParams.create(sigma2=1.0, beta=0.5, tau2=1e-3, d=d, p=p)
    params = as_multi_params(init, p, d)
    params = MultiOutputParams(*(torch.as_tensor(a).to(dev).detach() for a in params))
    history = []
    stats = _new_stream_stats(tier, n_outputs=p)
    final_q = None

    for outer in range(outer_rounds):
        with _stream_round(store, params.beta.detach().cpu().numpy(), cfg, stream_chunk, outer,
                           p, tier, backend, stats, dev, **spooling) as (struct, spool):
            bc_pad = max(len(r) for r in struct.plan)
            for ranks in struct.plan:
                packed = pack_block_chunk(store, struct.blocks, struct.neigh, ranks, m=cfg.m,
                                          bs_max=struct.bs_max, dtype=cfg.dtype)
                if tier:
                    packed = cast_packed(packed, tier)
                spool.add(packed.pad_to_blocks(bc_pad), tag=_piece_backend(backend, packed))

            def totals(prm):
                ld = q = None
                with torch.no_grad():
                    for arrays, tag in spool.iter_arrays(prefetch=prefetch):
                        ld_c, q_c = _multi_stats_chunk(prm, arrays, nu, tag)
                        ld = ld_c if ld is None else ld + ld_c
                        q = q_c if q is None else q + q_c
                return ld, q

            state = adam_init(params)
            t_inner = time.perf_counter()
            for it in range(inner_steps):
                ld, q = totals(params)
                loss = pooled_objective(ld, q, n)
                w = 1.0 / torch.clamp(q, min=1e-300)
                grad = None
                for arrays, tag in spool.iter_arrays(prefetch=prefetch):
                    g = _multi_wgrad_chunk(params, w, arrays, nu, tag, n, p)
                    grad = g if grad is None else tuple(a + b for a, b in zip(grad, g))
                params, state = adam_update(grad, state, params, lr)
                history.append((outer, it, float(loss)))
                if verbose and it % 10 == 0:
                    print(f"[fit-multi-stream] outer={outer} it={it} nll/np={float(loss):.6f} "
                          f"pieces={len(spool)}")
            # Profile the per-output scales at the round-final params.
            _, final_q = totals(params)
            stats["inner_time_s"] += time.perf_counter() - t_inner
            stats["inner_steps_total"] += inner_steps
    s2 = torch.clamp(profile_sigma2(final_q.to(torch.float64), n), min=1e-300)
    params = params._replace(log_sigma2=torch.log(s2).to(params.log_sigma2.dtype))
    return FitResult(params=params, history=history, packed=None, stream_stats=stats)


def fit_neldermead(x, y, cfg: SBVConfig, init: KernelParams | None = None, nu: float = 3.5,
                   maxiter: int = 400, backend: str = "auto", device=None) -> FitResult:
    """Derivative-free MLE (the paper's optimizer path, via scipy).

    Nelder-Mead over the log-space params at ONE structure pass (the init
    params' beta), as the reference's ``fit_neldermead``; the loss moves
    the packed arrays to ``device`` once and runs without a gradient, so on
    CUDA every evaluation is one likelihood kernel launch
    (``backend='auto'``). ``history`` holds one entry,
    ``(0, iterations, final loss)``."""
    from scipy.optimize import minimize

    dev = resolve_device(device)
    d = x.shape[1]
    if init is None:
        init = KernelParams.create(sigma2=float(np.var(y)), beta=0.5, nugget=1e-3, d=d)
    init = KernelParams(*(torch.as_tensor(a).to(dev).detach() for a in init))
    packed, _ = preprocess(x, y, init.beta.cpu().numpy(), cfg)
    loss = neg_loglik_fn(packed, nu, backend, device=dev)

    def unpack(v):
        t = torch.as_tensor(np.asarray(v, dtype=np.float64), device=dev)
        return KernelParams(log_sigma2=t[0], log_beta=t[1:1 + d], log_nugget=t[1 + d])

    def f(v):
        with torch.no_grad():
            return float(loss(unpack(v)))

    v0 = np.concatenate([[float(init.log_sigma2)], init.log_beta.cpu().numpy(),
                         [float(init.log_nugget)]])
    res = minimize(f, v0, method="Nelder-Mead",
                   options={"maxiter": maxiter, "xatol": 1e-4, "fatol": 1e-7})
    return FitResult(params=unpack(res.x), history=[(0, res.nit, float(res.fun))],
                     packed=packed)
