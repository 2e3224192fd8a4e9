"""Double-buffered chunk pipeline: host packing overlaps device compute.

Counterpart of ``repro.serving.pipeline``. The one-shot serving loop is
serial per chunk:

    pack k -> upload k -> compute k -> wait for k -> scatter k -> pack k+1

The reference overlaps these phases through JAX's asynchronous dispatch.
PyTorch's calls return before the card finishes as well, but only as long
as nothing on the host waits for the stream (a ``.to(device)`` from
pageable memory, a ``.cpu()``). The engine therefore runs the phases on
CUDA streams and events, over ``repro_torch.prefetch.Prefetcher``:

* the producer thread packs chunk k+1 (numpy: blocks, filtered kNN,
  gather), splits it into its pieces, and uploads them through pinned
  memory on a side stream, then records an event;
* the consumer makes its compute stream wait on that event, marks the
  staged tensors as used there (``record_stream``), launches the chunk's
  conditionals (``ops.sbv_predict_many``: one kernel launch for all of a
  chunk's pieces), and queues the copies of the results into pinned host
  buffers behind them, with an event;
* only then does it land chunk k-1: it waits on chunk k-1's event (not on
  the stream, so chunk k keeps running) and scatters.

Every thread names its device explicitly: the current CUDA device is per
thread. Results are bitwise the synchronous loop's (the same packing, the
same kernel on the same inputs, the same scatter). On the CPU the engine
keeps the producer thread and computes in the consumer.
"""
from __future__ import annotations

import time
from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.predict import (TrainIndex, batched_block_predict_many, iter_query_chunks,
                                      pack_queries, place_params, query_chunk_jobs,
                                      scatter_packed, upload_packed)
from repro_torch.device import resolve_device
from repro_torch.prefetch import Prefetcher

from .telemetry import ServerStats


@dataclass
class PipelineConfig:
    """Knobs of the chunked prediction read path (shared by the synchronous
    and double-buffered loops so the two cannot drift)."""

    bs_pred: int = 25
    m_pred: int = 120
    nu: float = 3.5
    alpha: float = 100.0
    backend: str = "auto"     # 'auto' (the kernel route on CUDA) | 'ref'
    dtype: type = np.float64
    chunk_size: int | None = 4096
    n_workers: int = 1
    prefetch: int = 2         # packed chunks in flight (2 = double buffer)
    n_buckets: int | None = None  # size-bucketed micro-batches
    stream_chunk: int | None = None  # out-of-core train index
    precision: str | None = None  # ladder tier; None = f64

    def __post_init__(self):
        # A PrecisionPolicy or tier string collapses to the tier name, f64
        # to None, and a narrow tier pins dtype to its accumulation width
        # (queries pack at acc; coordinates drop to storage in the split).
        if self.precision is not None:
            from repro_torch.core.buckets import acc_dtype, as_policy

            tier = as_policy(self.precision).tier
            if tier == "f64":
                self.precision = None
            else:
                self.precision = tier
                self.dtype = acc_dtype(tier)


def tuned_config(tuning, **overrides) -> PipelineConfig:
    """A ``PipelineConfig`` from a persisted autotuner record (TuningRecord /
    dict / checkpoint path, from either package), with explicit
    ``overrides`` winning over the record (``tuning.apply_record``; the
    precision is the tier the record's buckets settled at). This is how
    ``serve gp --tuning-record`` starts pre-tuned."""
    from repro_torch.tuning.record import Knobs, apply_record

    knobs = apply_record(tuning, **{k: overrides.pop(k) for k in Knobs._fields if k in overrides})
    return PipelineConfig(**{k: v for k, v in knobs._asdict().items() if v is not None},
                          **overrides)


def _n_rows(x_test) -> int:
    """Row count of an in-core array or of a row store."""
    from repro_torch.data.store import is_store

    if is_store(x_test):
        return x_test.n_rows
    return int(np.asarray(x_test).shape[0])


def n_outputs_of(params) -> int:
    """Output count of a parameter set: 1 for ``KernelParams``, ``p`` for
    ``MultiOutputParams``. The serving layer sizes its result buffers off
    this, so multi-output models flow through the same engine with (n, p)
    mean and variance."""
    from repro_torch.core.multioutput import MultiOutputParams

    if isinstance(params, MultiOutputParams):
        return params.n_outputs
    return 1


def _result_zeros(n: int, n_outputs: int) -> tuple[np.ndarray, np.ndarray]:
    shape = (n,) if n_outputs == 1 else (n, n_outputs)
    return np.zeros(shape), np.zeros(shape)


def make_chunk_split(cfg: PipelineConfig):
    """``split(packed) -> [piece, ...]``: the host-side bucketing of one
    chunk (the uniform layout is the one-piece case) and the tier's storage
    cast. Pure host work, so the pipelined loop runs it on the producer
    thread."""
    tier = cfg.precision
    if not cfg.n_buckets:
        if tier is None:
            return lambda packed: [packed]
        from repro_torch.core.buckets import cast_prediction

        return lambda packed: [cast_prediction(packed, tier)]

    from repro_torch.core.buckets import bucket_mults, bucket_prediction, cast_prediction
    from repro_torch.core.packing import round_up

    # Serving quantizes bucket shapes harder than the one-shot path, as the
    # reference does: ceilings to multiples of 8 and block counts padded to
    # multiples of 8 (masked, inert), so steady traffic converges to a
    # bounded set of piece shapes.
    bs_mult, m_mult = (max(v, 8) for v in bucket_mults(cfg.backend, precision=tier))

    def split(packed):
        pieces = bucket_prediction(packed, n_buckets=cfg.n_buckets, bs_mult=bs_mult,
                                   m_mult=m_mult).buckets
        pieces = [p.pad_to_blocks(round_up(p.n_blocks, 8)) for p in pieces]
        if tier is not None:
            pieces = [cast_prediction(p, tier) for p in pieces]
        return pieces

    return split


def _engine_device(mesh, device) -> torch.device:
    """The device the engine computes on: the mesh's first device, else
    ``device`` (default: the current CUDA device)."""
    if mesh is not None:
        from repro_torch.core.distributed import mesh_devices

        return torch.device(mesh_devices(mesh, "workers")[0])
    return resolve_device(device)


def make_chunk_compute(params, cfg: PipelineConfig, mesh=None, axis: str = "workers",
                       device=None):
    """``compute(pieces, arrays=None) -> [(piece, mu, var), ...]`` over the
    (already split) pieces of one chunk, with ``mu`` and ``var`` left on
    the device and nothing waited for. Without a mesh every chunk is one
    ``batched_block_predict_many`` call (one kernel launch for all its
    pieces on CUDA); ``arrays`` are the pieces' operands already on the
    device (the pipelined loop's staged upload), else they go up here,
    through pinned memory on the current stream. With a mesh, each piece's
    blocks are sharded by owner first, which reorders them: every piece is
    returned beside its outputs, so the scatter uses matching indices."""
    if mesh is None:
        dev = resolve_device(device)
        params = place_params(params, dev)

        def compute(pieces, arrays=None):
            if arrays is None:
                arrays = [upload_packed(pc, dev) for pc in pieces]
            conds = batched_block_predict_many(params, arrays, nu=cfg.nu, backend=cfg.backend)
            return [(pc, mu, var) for pc, (mu, var) in zip(pieces, conds)]

        return compute

    from repro_torch.core.distributed import sharded_packed_predict

    def compute(pieces, arrays=None):
        return [sharded_packed_predict(params, piece, mesh, axis=axis, nu=cfg.nu,
                                       backend=cfg.backend)
                for piece in pieces]

    return compute


def _record_pieces(stats: ServerStats | None, pieces) -> None:
    """Per-piece shape and padding-occupancy telemetry for ONE chunk (the
    chunk counter advances once however many bucket pieces it split into).
    One key per piece, tagged with the piece's tier: the affinity router
    reads this set as its warm-replica signal."""
    if stats is None:
        return
    from repro_torch.core.buckets import dtype_tier, prediction_work

    for i, (piece, _, _) in enumerate(pieces):
        stats.record_chunk_shape(piece.n_blocks, piece.bs_pred, piece.m_pred,
                                 count_chunk=i == 0, tier=dtype_tier(piece.q_x.dtype))
    stats.record_occupancy(*prediction_work([p for p, _, _ in pieces]))


def _chunks(index: TrainIndex, x_test, cfg: PipelineConfig, seed: int):
    return iter_query_chunks(index, x_test, cfg.bs_pred, cfg.m_pred, alpha=cfg.alpha, seed=seed,
                             n_workers=cfg.n_workers, chunk_size=cfg.chunk_size, dtype=cfg.dtype)


def request_chunk_bounds(n: int, chunk_size: int | None, bs_pred: int) -> list[tuple[int, int]]:
    """Per-request chunk bounds: the exact stepping of ``iter_query_chunks``,
    so the continuous scheduler can enumerate a request's chunks up front.
    Chunk ``ci`` covering rows ``[start, stop)`` is packed by
    ``pack_scheduled``; together they make the scheduler's per-request
    results those of a per-request ``predict_sbv`` call, however admission
    interleaves requests."""
    step = n if chunk_size is None else max(int(chunk_size), bs_pred)
    return [(start, min(n, start + step)) for start in range(0, n, step)]


def pack_scheduled(index: TrainIndex, cfg: PipelineConfig, item, seed: int = 0):
    """Pack one scheduled (request, chunk) unit with the per-request
    ``iter_query_chunks`` protocol: the request's own array is the test set,
    ``offset`` and ``seed`` advance within the request. The scheduler only
    reorders which unit runs when; what each unit computes is pinned here
    (the 1e-12 parity contract)."""
    return pack_queries(index, item.entry.req.x[item.start:item.stop], cfg.bs_pred, cfg.m_pred,
                        alpha=cfg.alpha, seed=seed + item.ci, n_workers=cfg.n_workers,
                        offset=item.start, pad_shapes=cfg.chunk_size is not None,
                        dtype=cfg.dtype)


def _to_host(pieces, device: torch.device):
    """Queue the copy of each piece's ``(mu, var)`` to the host: ``(slots,
    event)``, where the slots hold pinned host tensors that are valid once
    ``event`` has completed (on the CPU: the outputs themselves, no event)."""
    if device.type != "cuda":
        return [(pc, mu.detach(), var.detach()) for pc, mu, var in pieces], None
    slots = []
    for pc, mu, var in pieces:
        hm, hv = (torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in (mu, var))
        hm.copy_(mu, non_blocking=True)
        hv.copy_(var, non_blocking=True)
        slots.append((pc, hm, hv))
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return slots, done


def _stage(split, device: torch.device, stream):
    """The producer's per-job work: pack (the job's thunk), split, and on a
    CUDA device upload every piece through pinned memory on ``stream``,
    recording an event the consumer waits on. A ``None`` thunk is a barrier
    and passes through."""

    def stage(job):
        tag, pack_fn = job
        if pack_fn is None:
            return tag, None, None, None, 0.0
        t0 = time.perf_counter()
        pieces = split(pack_fn())
        arrays = event = None
        if stream is not None:
            with torch.cuda.device(device), torch.cuda.stream(stream):
                arrays = [upload_packed(pc, device) for pc in pieces]
                event = torch.cuda.Event()
                event.record(stream)
        return tag, pieces, arrays, event, time.perf_counter() - t0

    return stage


class ChunkTimer:
    """Per-chunk timings of a chunk loop, for callers that pass one:
    ``pack_s`` (host seconds to pack, split and queue the upload),
    ``compute_s`` (device seconds from the chunk's upload being ready to
    its results being on the host, from CUDA events; host seconds of the
    compute call on the CPU) and ``land_wait_s`` (host seconds spent
    waiting for the results)."""

    def __init__(self):
        self.pack_s: list[float] = []
        self.land_wait_s: list[float] = []
        self._events: list = []
        self._compute_host: list[float] = []

    def summary(self) -> dict:
        """Totals and per-chunk means (synchronises the card once)."""
        compute = list(self._compute_host)
        for a, b in self._events:
            b.synchronize()
            compute.append(a.elapsed_time(b) / 1e3)
        n = max(len(self.pack_s), 1)
        return {"n_chunks": len(self.pack_s), "pack_s": sum(self.pack_s) / n,
                "compute_s": sum(compute) / n, "land_wait_s": sum(self.land_wait_s) / n,
                "pack_s_total": sum(self.pack_s), "compute_s_total": sum(compute)}


def _timed_compute(compute, pieces, arrays, device, timer):
    """``(compute(pieces, arrays), end)``: with a timer, the call is
    bracketed by a start event and an ``end`` event the caller records once
    the results' copies are queued (on the CPU, by the host clock, and
    ``end`` is None)."""
    if timer is None:
        return compute(pieces, arrays), None
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = compute(pieces, arrays)
        timer._events.append((start, end))
        return out, end
    t0 = time.perf_counter()
    out = compute(pieces, arrays)
    timer._compute_host.append(time.perf_counter() - t0)
    return out, None


def _land(slot, emit, timer) -> None:
    tag, slots, done = slot
    t0 = time.perf_counter()
    if done is not None:
        done.synchronize()
    if timer is not None:
        timer.land_wait_s.append(time.perf_counter() - t0)
    for piece, mu, var in slots:
        emit(tag, piece, mu.numpy(), var.numpy())


def run_chunk_stream(params, cfg: PipelineConfig, jobs, emit, mesh=None,
                     stats: ServerStats | None = None, device=None,
                     timer: ChunkTimer | None = None) -> None:
    """The double-buffered chunk engine, decoupled from any one request.

    ``jobs`` yields ``(tag, pack_fn)`` pairs; ``pack_fn()`` runs on the
    producer thread, the consumer launches each chunk and calls ``emit(tag,
    piece, mean, var)`` (host arrays) one chunk later, while the card runs
    the next chunk. ``jobs`` is pulled lazily (a bounded queue of depth
    ``cfg.prefetch``), so every pull is a chunk boundary: a scheduler-backed
    ``jobs`` admits new requests and honours cancellations between any two
    chunks.

    A job with ``pack_fn=None`` is a BARRIER: it lands whatever is in
    flight without computing anything. An endless source (the continuous
    scheduler) must emit barriers when it idles, or the one-chunk-delayed
    emit strands a burst's last chunk until the next arrival.

    The compute runs on the caller's current stream of ``device`` (default:
    the current CUDA device): a server gives each replica its own stream
    this way. The upload stream starts behind the work already queued
    there (say, the kernel parameters' upload)."""
    dev = _engine_device(mesh, device)
    cuda = dev.type == "cuda"
    with torch.cuda.device(dev) if cuda else nullcontext():
        compute_stream = torch.cuda.current_stream(dev) if cuda else None
        split = make_chunk_split(cfg)
        compute = make_chunk_compute(params, cfg, mesh, device=dev)
        side = torch.cuda.Stream(dev) if cuda and mesh is None else None
        if side is not None:
            side.wait_stream(compute_stream)
        inflight = None  # (tag, host slots, event): launched, not yet landed
        with Prefetcher(jobs, depth=cfg.prefetch, stage=_stage(split, dev, side),
                        name="sbv-packer") as staged:
            for tag, pieces, arrays, ready, pack_s in staged:
                if pieces is None:               # barrier: flush the delayed emit
                    if inflight is not None:
                        _land(inflight, emit, timer)
                        inflight = None
                    continue
                if ready is not None:
                    compute_stream.wait_event(ready)
                    for tup in arrays:
                        for t in tup:
                            t.record_stream(compute_stream)
                if timer is not None:
                    timer.pack_s.append(pack_s)
                out, end = _timed_compute(compute, pieces, arrays, dev, timer)
                _record_pieces(stats, out)
                slots, done = _to_host(out, dev)
                if end is not None:
                    end.record()
                if inflight is not None:
                    _land(inflight, emit, timer)
                inflight = (tag, slots, done)
            if inflight is not None:
                _land(inflight, emit, timer)


def predict_synchronous(params, index: TrainIndex, x_test, cfg: PipelineConfig, seed: int = 0,
                        mesh=None, stats: ServerStats | None = None, device=None,
                        timer: ChunkTimer | None = None) -> tuple[np.ndarray, np.ndarray]:
    """The strictly serial chunk loop (pack -> upload -> compute -> wait ->
    scatter), on ``device`` (default: the current CUDA device).

    Kept as the pipeline's correctness twin and benchmark baseline.
    ``x_test`` may be a row store; windows are then read on demand inside
    ``iter_query_chunks``."""
    n_test = _n_rows(x_test)
    mean, var = _result_zeros(n_test, n_outputs_of(params))
    dev = _engine_device(mesh, device)
    split = make_chunk_split(cfg)
    compute = make_chunk_compute(params, cfg, mesh, device=dev)
    chunks = _chunks(index, x_test, cfg, seed)
    while True:
        t0 = time.perf_counter()
        packed = next(chunks, None)
        if packed is None:
            break
        pieces = split(packed[1])
        if timer is not None:
            timer.pack_s.append(time.perf_counter() - t0)
        pieces, end = _timed_compute(compute, pieces, None, dev, timer)
        _record_pieces(stats, pieces)
        slots, done = _to_host(pieces, dev)
        if end is not None:
            end.record()
        _land((None, slots, done),
              lambda _tag, pc, mu, vr: scatter_packed(pc, (mu, mean), (vr, var)), timer)
    return mean, var


def predict_pipelined(params, index: TrainIndex, x_test, cfg: PipelineConfig, seed: int = 0,
                      mesh=None, stats: ServerStats | None = None, device=None,
                      timer: ChunkTimer | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Double-buffered chunk loop: the synchronous loop's results, with its
    phases overlapped (see the module docstring). With a store-backed
    ``x_test`` the producer also does the window reads off the critical
    path."""
    n_test = _n_rows(x_test)
    mean, var = _result_zeros(n_test, n_outputs_of(params))
    if n_test == 0:
        return mean, var

    # Each chunk is read and packed on the PRODUCER thread, by its job's
    # thunk (the iter_query_chunks protocol, so the results stay bitwise
    # the synchronous loop's).
    jobs = query_chunk_jobs(index, x_test, cfg.bs_pred, cfg.m_pred, alpha=cfg.alpha, seed=seed,
                            n_workers=cfg.n_workers, chunk_size=cfg.chunk_size, dtype=cfg.dtype)

    def emit(_tag, piece, mu, vr):
        scatter_packed(piece, (mu, mean), (vr, var))

    run_chunk_stream(params, cfg, jobs, emit, mesh=mesh, stats=stats, device=device, timer=timer)
    return mean, var


class SpoolResultSink:
    """Disk-backed per-request result sink (the backpressure story's
    out-of-core leg): each completed piece's (index, mean, var) triple is
    spooled through ``PackedChunkSpool`` (``data/streaming.py``) with a zero
    device budget, so a bulk sweep's full result never lives in server RAM.
    ``float64`` ``.npz`` round-trips are bit-exact, so ``materialize()``
    reproduces the in-RAM result identically."""

    def __init__(self, path: str, n_points: int, n_outputs: int = 1):
        from repro_torch.data.streaming import PackedChunkSpool

        self.n_points = int(n_points)
        self.n_outputs = int(n_outputs)
        self._spool = PackedChunkSpool(path, device_budget=0, device_stage=False)
        self._n_added = 0

    def add(self, piece, mu, var) -> None:
        """Spool one computed chunk piece (masked rows only)."""
        msk = np.asarray(piece.q_mask)
        self._spool.add_arrays({"idx": np.asarray(piece.q_idx)[msk],
                                "mean": np.asarray(mu)[msk],
                                "var": np.asarray(var)[msk]}, tag=self._n_added)
        self._n_added += 1

    @property
    def n_chunks(self) -> int:
        return self._n_added

    @property
    def spooled_bytes(self) -> int:
        return self._spool.disk_bytes_total

    def iter_chunks(self):
        """Yield ``(idx, mean, var)`` per spooled piece, in spool order: the
        bounded-memory read path (one piece resident at a time)."""
        for arrays, _tag in self._spool.iter_arrays(prefetch=0):
            yield arrays["idx"], arrays["mean"], arrays["var"]

    def materialize(self) -> tuple[np.ndarray, np.ndarray]:
        """Assemble the full (mean, var) in RAM."""
        mean, var = _result_zeros(self.n_points, self.n_outputs)
        for idx, mu, vr in self.iter_chunks():
            mean[idx] = mu
            var[idx] = vr
        return mean, var

    def cleanup(self) -> None:
        self._spool.cleanup()
