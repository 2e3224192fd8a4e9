"""Persistent batched GP serving process (the paper's throughput story,
made a long-running service instead of a one-shot CLI loop).

Counterpart of ``repro.serving.server``. ``GPServer`` owns the train-side
state exactly once:

* the ``TrainIndex`` (scaled inputs, coarse blocks, cached flat block
  index for the filtered kNN), and
* the kernel parameters on its device, and a CUDA stream of its own for
  the conditionals (replicas on one card do not queue behind each other
  on one stream),

then serves asynchronous predict requests of arbitrary size:
requests are coalesced into fixed-shape padded micro-batches by the
max-size/max-wait policy (``batching.py``) and each micro-batch streams
through the double-buffered chunk pipeline (``pipeline.py``), so host
packing of chunk k+1 overlaps device compute of chunk k.

Shape stability: chunked packing rounds (bc, bs) to multiples of 8, so
steady-state traffic touches a handful of piece shapes however request
sizes vary (``stats()['n_compiled_shapes']``; the CUDA kernels take any
shape, so nothing recompiles, but the router reads these keys).

Bucketed micro-batches: with ``PipelineConfig(n_buckets=K)`` each chunk
executes as size-buckets padded only to their own ceilings
(docs/packing.md) instead of one uniformly-padded batch; the padding
waste saved is reported as ``stats()['padding_occupancy']`` (true FLOPs
over padded FLOPs — 1.0 means no waste).
"""
from __future__ import annotations

import threading
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.predict import TrainIndex, build_train_index

from .batching import (
    BatchingPolicy, MicroBatcher, PredictRequest, SchedulerPolicy,
    ServeRequest, concat_requests,
)
from .pipeline import (
    PipelineConfig, _engine_device, n_outputs_of, pack_scheduled,
    predict_pipelined, run_chunk_stream,
)
from .scheduler import ContinuousScheduler
from .telemetry import ServerStats, now


def _mask_outputs(arr, outputs, copy: bool = True):
    """Gather a request's output columns from a full-output result array.

    ``outputs=None`` (or a 1-D single-output array) passes through; a
    fancy-index gather copies by construction, so ``copy`` only governs
    the pass-through path (the drain loop hands out slices of a shared
    batch buffer and must copy; scheduler entries own their buffers)."""
    if arr is None:
        return None
    if outputs is not None and arr.ndim == 2:
        return arr[:, outputs]
    return arr.copy() if copy else arr


@dataclass
class ServeResult:
    """Per-request result. In-RAM requests carry ``mean``/``var``; bulk
    requests routed through the out-of-core sink carry ``sink`` instead
    (a ``SpoolResultSink`` — ``iter_chunks()`` for bounded-memory reads,
    ``materialize()`` to assemble in RAM after all)."""

    mean: np.ndarray | None
    var: np.ndarray | None
    latency_s: float
    queue_wait_s: float
    sink: object = None


@dataclass
class GPServerConfig:
    """Everything the server needs beyond the fitted kernel parameters.

    ``scheduler=None`` keeps the original drain-and-rebatch loop
    (micro-batches coalesced by concatenation — the benchmark baseline);
    a ``SchedulerPolicy`` switches dispatch to the continuous-batching
    scheduler (``scheduler.py``): per-request chunking, SLO-aware
    admission at every chunk boundary, cancellation, backpressure."""

    pipeline: PipelineConfig = field(default_factory=PipelineConfig)
    policy: BatchingPolicy = field(default_factory=BatchingPolicy)
    scheduler: SchedulerPolicy | None = None
    seed: int = 0


class GPServer:
    """Persistent micro-batching SBV prediction server.

    Usage::

        server = GPServer(params, x_train, y_train, config, device="cuda")
        with server:                       # starts the dispatch thread
            fut = server.submit(x_query)   # returns concurrent.futures.Future
            res = fut.result()             # ServeResult(mean, var, latency)

    Requests submitted within one batching window are coalesced; because
    coalescing just concatenates query arrays before the shared packed
    pipeline, per-request results equal the matching slices of a single
    ``predict_sbv`` call on the concatenation.

    Runs on ``device`` (default: the current CUDA device; without a GPU pass
    ``device='cpu'``), or on the first device of ``mesh``. The parameters
    go to the device once; every dispatch runs on the server's own stream.
    """

    def __init__(
        self,
        params,
        x_train: np.ndarray,
        y_train: np.ndarray,
        config: GPServerConfig | None = None,
        beta_struct: np.ndarray | None = None,
        mesh=None,
        index: TrainIndex | None = None,
        device=None,
    ):
        self.device = _engine_device(mesh, device)
        self.params = type(params)(*(torch.as_tensor(a).to(self.device) for a in params))
        self.config = config or GPServerConfig()
        self.mesh = mesh
        self.stats = ServerStats()
        self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                        else None)
        beta = (self.params.beta.detach().cpu().numpy() if beta_struct is None
                else np.asarray(beta_struct))
        cfg = self.config.pipeline
        if index is not None:
            # Prebuilt index (must match m_pred/seed): lets several server
            # configurations share one construction pass.
            self.index = index
        else:
            self.index = build_train_index(
                x_train, y_train, beta, cfg.m_pred,
                n_workers=cfg.n_workers, seed=self.config.seed,
                stream_chunk=cfg.stream_chunk,
            )
        self.d = self.index.x.shape[1]
        self.n_outputs = n_outputs_of(params)
        self._batcher = MicroBatcher(self.config.policy)
        self._sched: ContinuousScheduler | None = None
        self._thread: threading.Thread | None = None
        self._n_batches = 0

    def _make_scheduler(self) -> ContinuousScheduler:
        cfg = self.config.pipeline
        return ContinuousScheduler(
            policy=self.config.scheduler,
            window=self.config.policy,
            chunk_size=cfg.chunk_size,
            bs_pred=cfg.bs_pred,
            stats=self.stats,
            result_factory=self._make_result,
            n_outputs=self.n_outputs,
        )

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "GPServer":
        if self._thread is not None:
            return self
        if self.config.scheduler is not None:
            if self._sched is None or self._sched.closed:  # fresh after stop()
                self._sched = self._make_scheduler()
            target = self._continuous_loop
        else:
            if self._batcher.closed:  # restart after stop(): fresh batcher
                self._batcher = MicroBatcher(self.config.policy)
            target = self._dispatch_loop
        if self._stream is not None:
            # The server's stream starts behind the caller's queued work
            # (the parameters' upload).
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._thread = threading.Thread(
            target=self._on_stream, args=(target,), name="gp-server", daemon=True
        )
        self._thread.start()
        return self

    def _on_stream(self, target) -> None:
        """Run a dispatch loop with this server's device and stream current
        (both are per thread in torch)."""
        if self._stream is None:
            return target()
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            return target()

    def _fail_pending(self, message: str) -> None:
        source = self._sched if self._sched is not None else self._batcher
        for req in source.drain_pending():
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(RuntimeError(message))

    def stop(self, timeout_s: float = 120.0) -> None:
        """Drain pending requests, then stop the dispatch thread.

        Raises ``TimeoutError`` if the dispatch thread is still processing
        after ``timeout_s`` (the server is NOT stopped in that case) — but
        only AFTER failing still-queued futures, so no client blocks
        forever on a request the wedged dispatcher will never pick up."""
        if self._thread is None:
            return
        source = self._sched if self._sched is not None else self._batcher
        source.close()
        self._thread.join(timeout=timeout_s)
        if self._thread.is_alive():
            self._fail_pending(
                f"server stop timed out after {timeout_s}s; request abandoned"
            )
            raise TimeoutError(
                f"gp-server dispatch thread still busy after {timeout_s}s"
            )
        self._thread = None
        self._fail_pending("server stopped")

    def __enter__(self) -> "GPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request path --------------------------------------------------

    def _norm_outputs(self, outputs) -> np.ndarray | None:
        """Validate an output-index mask against the model's output count.

        ``None`` means all outputs. A mask that selects every output in
        order collapses back to ``None`` (no column gather on the result
        path — keeps single-output requests bitwise untouched)."""
        if outputs is None:
            return None
        out = np.atleast_1d(np.asarray(outputs, dtype=np.intp))
        if out.ndim != 1 or out.size == 0:
            raise ValueError("outputs must be a non-empty 1-D index list")
        if out.min() < 0 or out.max() >= self.n_outputs:
            raise ValueError(
                f"output indices must lie in [0, {self.n_outputs}); "
                f"got {outputs!r}"
            )
        if out.size == self.n_outputs and np.array_equal(
                out, np.arange(self.n_outputs)):
            return None
        return out

    def submit(self, x: np.ndarray, slo: str = "interactive",
               outputs=None) -> Future:
        """Enqueue a predict request; resolves to a ``ServeResult``.

        ``slo`` picks the request's service class in continuous-scheduler
        mode (``SchedulerPolicy.classes``; default classes are
        ``interactive`` and ``bulk``) and is ignored in drain mode. May
        raise ``AdmissionQueueFull`` under backpressure.

        ``outputs`` (multi-output models only) is an output-index mask:
        the result's mean/var carry just those columns, in the order
        given. Compute is unaffected — the shared Cholesky already pays
        for all p outputs (docs/multioutput.md), so the server computes
        everything and slices per request. Spool-backed bulk results
        (``ServeResult.sink``) always carry all outputs."""
        if self._thread is None:
            raise RuntimeError("GPServer.submit before start()")
        x = np.array(x, dtype=np.float64, copy=True)
        if x.ndim == 1:
            x = x[None, :]
        if x.ndim != 2 or x.shape[1] != self.d:
            raise ValueError(f"expected (n, {self.d}) queries, got {x.shape}")
        out = self._norm_outputs(outputs)
        if self._sched is not None:
            req = ServeRequest(x=x, future=Future(), outputs=out, slo=slo)
            self._sched.submit(req)
        else:
            req = PredictRequest(x=x, future=Future(), outputs=out)
            self._batcher.put(req)
        return req.future

    @property
    def outstanding_points(self) -> int:
        """Queued + admitted-but-unfinished query points on this server —
        the router's least-outstanding-work signal. Drain mode has no
        per-chunk accounting; it reports 0 (the router refuses drain-mode
        replicas anyway — see ``serving/router.py``)."""
        if self._sched is not None:
            return self._sched.outstanding_points
        return 0

    def cancel(self, future: Future) -> bool:
        """Cancel an in-flight request; effective at the next chunk
        boundary in scheduler mode (queued-or-running both work), queued
        requests only in drain mode. Returns True if the cancellation
        was accepted."""
        if self._sched is not None:
            return self._sched.cancel(future)
        return future.cancel()

    def predict(self, x: np.ndarray, timeout_s: float | None = None) -> ServeResult:
        """Synchronous convenience: submit + wait."""
        return self.submit(x).result(timeout=timeout_s)

    def flush(self) -> None:
        """Dispatch whatever is queued without waiting out the batch window."""
        if self._sched is not None:
            self._sched.flush()
        else:
            self._batcher.flush()

    def warmup(self, n_points: int | None = None) -> ServeResult:
        """Push one synthetic batch through before real traffic arrives (the
        kernels' first launch loads their library, off the critical path)."""
        n = n_points or max(self.config.pipeline.bs_pred * 8, 64)
        rng = np.random.default_rng(self.config.seed + 17)
        if self.index.store is not None:
            # Store-backed index: bounding box from a bounded row probe
            # instead of a full scan (warmup only needs plausible inputs).
            probe, _ = self.index.store.read_slice(
                0, min(4096, self.index.store.n_rows))
            lo, hi = probe.min(axis=0), probe.max(axis=0)
        else:
            lo = self.index.x.min(axis=0)
            hi = self.index.x.max(axis=0)
        x = lo + (hi - lo) * rng.uniform(size=(n, self.d))
        fut = self.submit(x)
        self.flush()
        return fut.result()

    # -- dispatch ------------------------------------------------------

    def _dispatch_loop(self) -> None:
        while True:
            batch = self._batcher.next_batch()
            if batch:
                try:
                    self._process(batch)
                except BaseException as exc:
                    # _process resolves per-request failures itself; anything
                    # escaping here must not kill the sole dispatch thread.
                    for req in batch:
                        if not req.future.done():
                            req.future.set_exception(exc)
            elif self._batcher.closed:
                return

    def _process(self, batch: list[PredictRequest]) -> None:
        t_dispatch = now()
        # Claim each future; drop requests whose client cancelled while
        # queued (set_result on a cancelled future raises InvalidStateError).
        batch = [req for req in batch
                 if req.future.set_running_or_notify_cancel()]
        if not batch:
            return
        for req in batch:
            req.trace.t_dispatch = t_dispatch
        x, slices = concat_requests(batch)
        self.stats.record_batch(len(batch), x.shape[0])
        # Deterministic per-batch seed, equal to the base seed for the first
        # batch so a fresh server reproduces predict_sbv exactly.
        seed = self.config.seed + 100003 * self._n_batches
        self._n_batches += 1
        try:
            mean, var = predict_pipelined(
                self.params, self.index, x, self.config.pipeline,
                seed=seed, mesh=self.mesh, stats=self.stats, device=self.device,
            )
        except BaseException as exc:
            for req in batch:
                req.future.set_exception(exc)
            return
        t_done = now()
        for req, sl in zip(batch, slices):
            req.trace.t_done = t_done
            self.stats.record_request(req.trace)
            req.future.set_result(ServeResult(
                mean=_mask_outputs(mean[sl], req.outputs),
                var=_mask_outputs(var[sl], req.outputs),
                latency_s=req.trace.latency_s,
                queue_wait_s=req.trace.queue_wait_s,
            ))

    # -- continuous-batching dispatch (config.scheduler set) -----------

    def _make_result(self, entry) -> ServeResult:
        trace = entry.req.trace
        out = entry.req.outputs
        mean, var = ((None, None) if entry.sink is not None
                     else (_mask_outputs(entry.mean, out, copy=False),
                           _mask_outputs(entry.var, out, copy=False)))
        return ServeResult(
            mean=mean, var=var,
            latency_s=trace.latency_s, queue_wait_s=trace.queue_wait_s,
            sink=entry.sink,
        )

    def _continuous_loop(self) -> None:
        """Drive the double-buffered engine from the scheduler: each pull
        of the jobs generator is a chunk boundary (admission + reap +
        weighted-fair pick); each emit lands one chunk back into its
        request. All requests pack with the SAME base seed, so every
        request reproduces ``predict_sbv(..., seed=config.seed)`` exactly
        regardless of when it was admitted."""
        sched = self._sched
        cfg = self.config.pipeline
        seed = self.config.seed

        def jobs():
            while True:
                item = sched.next_chunk(idle_timeout_s=0.05)
                if item is not None:
                    yield item, (lambda it=item: pack_scheduled(
                        self.index, cfg, it, seed=seed))
                elif sched.closed:
                    return
                else:
                    # Idle barrier: land the delayed in-flight chunk so a
                    # burst's LAST chunk resolves now, not at the next
                    # arrival (run_chunk_stream emits one chunk late).
                    yield None, None

        try:
            run_chunk_stream(self.params, cfg, jobs(),
                             sched.complete_chunk, mesh=self.mesh,
                             stats=self.stats, device=self.device)
        except BaseException as exc:
            # The engine died (producer pack error surfaces here too):
            # no future may be left hanging on a loop that exited.
            sched.fail_all(exc)
