"""Request micro-batching for the persistent GP server.

A copy of ``repro.serving.batching`` (pure Python and numpy).

The workload shape (VPPE-style emulation: many concurrent small queries)
wants the opposite of the one-shot CLI loop: requests of arbitrary size
arrive asynchronously and must be coalesced into device-efficient
micro-batches without letting any single request wait unboundedly.

Policy (the classic max-size/max-wait pair):

* a batch DISPATCHES as soon as it holds >= ``max_points`` query points
  (enough to fill the packed device program), and
* a non-empty batch never waits longer than ``max_wait_s`` after its
  first request arrived (latency bound under light load).

Coalesced requests are concatenated into one query array; the packed
prediction pipeline then sees a single test set, so micro-batched results
are IDENTICAL to a single ``predict_sbv`` call on the concatenation (the
equivalence the serving tests pin down).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

from .telemetry import RequestTrace, now


@dataclass
class BatchingPolicy:
    """Dispatch thresholds for the micro-batcher.

    With ``adaptive=True`` the wait window scales with observed traffic:
    the batcher tracks an EMA of request inter-arrival times and waits
    ``window_factor * ema`` (clamped to ``[0, max_wait_s]``) — under
    heavy traffic the window stays wide enough to coalesce the next few
    arrivals, while sparse traffic (expected gap beyond the cap) stops
    paying the full ``max_wait_s`` latency tax for a coalescing partner
    that is not coming."""

    max_points: int = 4096     # dispatch once this many points are queued
    max_wait_s: float = 0.010  # ... or this long after the first request
    max_requests: int = 1024   # hard cap on requests per batch
    adaptive: bool = False     # scale the wait window from arrival rate
    window_factor: float = 4.0 # target ~this many further arrivals/window
    ema_alpha: float = 0.2     # EMA weight of the newest inter-arrival gap


class ArrivalWindow:
    """Inter-arrival EMA -> the batching window currently in force.

    The adaptive-window machinery shared by the drain-mode ``MicroBatcher``
    and the continuous scheduler's idle-admission gate (scheduler.py): both
    observe arrivals on an injectable clock and derive the same
    ``clamp(window_factor * ema, [0, max_wait_s])`` window, so the two
    admission paths cannot drift and both stay deterministic under a fake
    clock."""

    def __init__(self, policy: BatchingPolicy, clock=now):
        self.policy = policy
        self._clock = clock
        self._lock = threading.Lock()
        self._last_arrival: float | None = None
        self._ema_gap_s: float | None = None

    def observe(self) -> float:
        """Stamp one arrival; returns the clock reading used."""
        t = self._clock()
        with self._lock:
            if self._last_arrival is not None:
                gap = max(t - self._last_arrival, 0.0)
                a = self.policy.ema_alpha
                self._ema_gap_s = (
                    gap if self._ema_gap_s is None
                    else (1.0 - a) * self._ema_gap_s + a * gap
                )
            self._last_arrival = t
        return t

    def effective_wait_s(self) -> float:
        """The batching window currently in force (see BatchingPolicy)."""
        pol = self.policy
        with self._lock:
            ema = self._ema_gap_s
        if not pol.adaptive or ema is None:
            return pol.max_wait_s
        return min(pol.max_wait_s, max(0.0, pol.window_factor * ema))


# -- SLO-aware scheduling policy (consumed by scheduler.py) ----------------


@dataclass(frozen=True)
class SLOClass:
    """One service class of the continuous scheduler.

    ``priority`` breaks virtual-time ties (lower wins — an interactive
    arrival lands at the running batch's virtual time and therefore
    preempts queued bulk work at the next chunk boundary); ``weight`` is
    the weighted-fair share of chunk boundaries when several classes are
    backlogged, which is what keeps bulk work starvation-free."""

    name: str
    priority: int
    weight: float


INTERACTIVE = SLOClass("interactive", priority=0, weight=3.0)
BULK = SLOClass("bulk", priority=1, weight=1.0)


def default_slo_classes() -> dict[str, SLOClass]:
    return {c.name: c for c in (INTERACTIVE, BULK)}


class AdmissionQueueFull(RuntimeError):
    """Backpressure: the bounded admission queue cannot take this request."""


@dataclass
class SchedulerPolicy:
    """Continuous-batching scheduler knobs (docs/serving.md).

    ``queue_bound`` bounds the admission queue in query POINTS — a submit
    that would exceed it raises ``AdmissionQueueFull`` so producers feel
    backpressure instead of growing host RAM. ``spool_threshold`` routes
    the results of any request at least that large to a disk-backed
    ``SpoolResultSink`` (pipeline.py), so a bulk sweep never holds its
    full mean/var in RAM server-side."""

    classes: dict[str, SLOClass] = field(default_factory=default_slo_classes)
    queue_bound: int | None = None       # max queued points (None = unbounded)
    max_active_requests: int = 64        # running-batch cap
    spool_threshold: int | None = None   # spool results of requests >= this
    spool_dir: str | None = None         # default: a fresh tempdir


@dataclass
class PredictRequest:
    """One in-flight request: a query array + the future holding its slice
    of the micro-batch result."""

    x: np.ndarray
    future: Future
    outputs: np.ndarray | None = None  # output-index mask (None = all outputs)
    trace: RequestTrace = field(init=False)
    t_arrival: float = field(init=False, default=0.0)  # batcher-clock stamp

    def __post_init__(self):
        self.trace = RequestTrace(n_points=self.x.shape[0])


@dataclass
class ServeRequest(PredictRequest):
    """A scheduler-mode request: carries its SLO class and cancel flag."""

    slo: str = "interactive"
    cancelled: bool = field(init=False, default=False)


class MicroBatcher:
    """Blocking queue + coalescing loop shared by the server's worker.

    ``put`` is called from request threads; ``next_batch`` is called by
    the single dispatch thread and returns a list of requests forming one
    micro-batch (or an empty list on timeout so the caller can check for
    shutdown). A ``flush`` wakes the dispatcher immediately.
    """

    _FLUSH = object()

    def __init__(self, policy: BatchingPolicy, clock=now):
        self.policy = policy
        self._q: queue.Queue = queue.Queue()
        self._closed = threading.Event()
        self._clock = clock            # injectable for deterministic tests
        self._window = ArrivalWindow(policy, clock=clock)

    def put(self, req: PredictRequest) -> None:
        if self._closed.is_set():
            raise RuntimeError("server is stopped")
        req.t_arrival = self._window.observe()
        self._q.put(req)

    @property
    def _ema_gap_s(self) -> float | None:
        return self._window._ema_gap_s

    def effective_wait_s(self) -> float:
        """The batching window currently in force (see BatchingPolicy)."""
        return self._window.effective_wait_s()

    def flush(self) -> None:
        """Force the dispatcher to emit whatever is queued right now."""
        self._q.put(self._FLUSH)

    def close(self) -> None:
        self._closed.set()
        self._q.put(self._FLUSH)  # wake the dispatcher

    def drain_pending(self) -> list[PredictRequest]:
        """Remove and return whatever is still queued (post-close cleanup:
        a ``put`` can race ``close`` and land after the dispatcher's final
        drain — the server fails these futures instead of stranding them)."""
        pending: list[PredictRequest] = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return pending
            if item is not self._FLUSH:
                pending.append(item)

    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    def next_batch(self, idle_timeout_s: float = 0.05) -> list[PredictRequest]:
        """Coalesce queued requests into one micro-batch.

        Blocks up to ``idle_timeout_s`` for the first request; once one
        arrives, keeps accumulating until the policy's max_points /
        max_requests trip or max_wait_s elapses (or a flush arrives).

        Requests already sitting in the queue are ALWAYS drained (up to
        the size caps) regardless of the deadline: a backlog that built
        up while the previous batch was computing costs zero extra
        latency to coalesce, and waiting only applies when the queue has
        gone empty before the window closed.
        """
        pol = self.policy
        batch: list[PredictRequest] = []
        points = 0
        try:
            first = self._q.get(timeout=idle_timeout_s)
        except queue.Empty:
            return batch
        if first is self._FLUSH:
            return batch
        batch.append(first)
        points += first.x.shape[0]
        # Deadline math runs entirely on the batcher's clock (t_arrival is
        # stamped by put() with the same clock), so the adaptive window is
        # deterministically testable with a fake clock.
        deadline = first.t_arrival + self.effective_wait_s()

        while (points < pol.max_points and len(batch) < pol.max_requests
               and not self._closed.is_set()):
            try:
                nxt = self._q.get_nowait()   # drain backlog unconditionally
            except queue.Empty:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
            if nxt is self._FLUSH:
                break
            batch.append(nxt)
            points += nxt.x.shape[0]
        return batch


def concat_requests(batch: list[PredictRequest]) -> tuple[np.ndarray, list[slice]]:
    """Stack request arrays into one query set + per-request result slices."""
    sizes = [req.x.shape[0] for req in batch]
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    x = np.concatenate([req.x for req in batch], axis=0)
    slices = [slice(int(offsets[i]), int(offsets[i + 1])) for i in range(len(batch))]
    return x, slices
