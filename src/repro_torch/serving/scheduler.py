"""Continuous-batching scheduler: a persistent running batch admitting
requests at every chunk boundary (docs/serving.md, "Continuous batching").

Counterpart of ``repro.serving.scheduler``, the same state machine; only
``complete_chunk`` differs, in that it also lands device tensors (one
copy to the host per piece) besides host arrays.

The drain-mode server (``MicroBatcher`` + ``_process``) computes a whole
micro-batch to completion before looking at the queue again; a bulk
sweep therefore holds the device hostage for its full duration and an
interactive point query arriving one chunk too late waits out the whole
sweep. This scheduler replaces that loop with SGLang-style continuous
batching:

* **unit of work** — one *(request, chunk)* pair. A request's chunks are
  enumerated up front by ``request_chunk_bounds`` and packed by
  ``pack_scheduled`` (``pipeline.py``) with the request's OWN
  ``iter_query_chunks`` protocol, so per-request results are exactly
  those of a per-request ``predict_sbv`` call — the scheduler reorders
  which unit runs when, never what a unit computes. That is the whole
  1e-12 parity contract, and why admission order is a pure policy knob.
* **chunk boundary = decision point** — ``next_chunk`` is pulled by the
  double-buffered pipeline (``run_chunk_stream``) once per chunk; each
  pull reaps cancellations, admits newly queued requests into the
  running batch, and picks the next unit.
* **SLO classes** — start-time fair queuing over classes: pick the
  backlogged class with the smallest virtual time (priority breaks
  ties), then advance its clock by ``1/weight``. A newly backlogged
  class enters at the current virtual time, so an interactive arrival
  preempts queued bulk work at the very next boundary, while bulk's
  weight guarantees it a bounded share of boundaries (starvation-free:
  with weights 3:1, every 4 consecutive picks contain a bulk chunk
  whenever bulk is backlogged).
* **cancellation** — ``cancel(future)`` (or a plain ``future.cancel()``)
  marks the request; the next boundary drops its remaining chunks from
  the running batch. Chunks already dispatched to the device complete
  but their results are discarded. Futures are never marked running
  until resolution, so client-side ``cancel()`` always "wins" the race.
* **backpressure** — the admission queue is bounded in query points
  (``SchedulerPolicy.queue_bound``; overflow raises
  ``AdmissionQueueFull``), and requests of ``spool_threshold`` points or
  more stream their results into a disk-backed ``SpoolResultSink``
  instead of RAM.

Determinism: every decision runs on an injectable ``clock`` and
``next_chunk(idle_timeout_s=0)`` is one strictly non-blocking pass, so a
fake clock plus scripted arrivals replays any schedule exactly —
``tests/test_torch_scheduler.py`` holds the port to the reference that way.
"""
from __future__ import annotations

import os
import tempfile
import threading
from collections import deque

import numpy as np
import torch

from .batching import (
    AdmissionQueueFull, ArrivalWindow, BatchingPolicy, SchedulerPolicy,
    ServeRequest,
)
from .pipeline import request_chunk_bounds
from .telemetry import now

from repro_torch.core.predict import scatter_packed


def _host(a) -> np.ndarray:
    """A result piece as a host array (a device tensor is copied back)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class _Entry:
    """One admitted request inside the running batch."""

    __slots__ = ("req", "cls", "bounds", "next_ci", "done", "cancelled",
                 "mean", "var", "sink", "t_admit", "finalized")

    def __init__(self, req: ServeRequest, cls, bounds, t_admit: float):
        self.req = req
        self.cls = cls
        self.bounds = bounds      # [(start, stop), ...] — all chunks
        self.next_ci = 0          # chunks handed to the pipeline so far
        self.done = 0             # chunks completed so far
        self.cancelled = False
        self.mean = None          # result buffers (RAM mode) ...
        self.var = None
        self.sink = None          # ... or the spool sink (out-of-core mode)
        self.t_admit = t_admit
        self.finalized = False    # terminal bookkeeping done exactly once

    @property
    def n_chunks(self) -> int:
        return len(self.bounds)


class ScheduledChunk:
    """One schedulable unit: chunk ``ci`` (request rows [start, stop)) of
    one admitted request — the ``tag`` flowing through
    ``run_chunk_stream`` and back into ``complete_chunk``."""

    __slots__ = ("entry", "ci", "start", "stop", "landed")

    def __init__(self, entry: _Entry, ci: int, start: int, stop: int):
        self.entry = entry
        self.ci = ci
        self.start = start
        self.stop = stop
        self.landed = 0           # query rows of this chunk landed so far

    @property
    def request(self) -> ServeRequest:
        return self.entry.req

    @property
    def n_points(self) -> int:
        return self.stop - self.start


def _default_result(entry: _Entry):
    return entry.sink if entry.sink is not None else (entry.mean, entry.var)


class ContinuousScheduler:
    """The running batch + admission queue + SLO policy state machine.

    Thread contract: ``submit``/``cancel``/``flush``/``close`` are called
    from request threads; ``next_chunk`` from the pipeline's producer
    thread; ``complete_chunk`` from the consumer (dispatch) thread. One
    condition variable serializes all of it.
    """

    def __init__(
        self,
        policy: SchedulerPolicy | None = None,
        window: BatchingPolicy | None = None,
        chunk_size: int | None = 4096,
        bs_pred: int = 25,
        clock=now,
        stats=None,
        result_factory=None,
        sink_factory=None,
        n_outputs: int = 1,
    ):
        self.policy = policy or SchedulerPolicy()
        self.window_policy = window or BatchingPolicy()
        self.chunk_size = chunk_size
        self.bs_pred = bs_pred
        self.n_outputs = int(n_outputs)
        self._clock = clock
        self.stats = stats
        self._result_factory = result_factory or _default_result
        self._sink_factory = sink_factory
        self._window = ArrivalWindow(self.window_policy, clock=clock)
        self._cond = threading.Condition(threading.Lock())
        self._queue: deque[ServeRequest] = deque()
        self._queued_points = 0
        self._last_arrival = 0.0
        self._active: dict[str, list[_Entry]] = {
            name: [] for name in self.policy.classes
        }
        self._inflight: set[_Entry] = set()   # fully scheduled, not complete
        self._vtime: dict[str, float] = {name: 0.0 for name in self.policy.classes}
        self._vnow = 0.0                      # virtual time of the last pick
        self._by_future: dict = {}            # future -> ServeRequest | _Entry
        self._closed = False
        self._force = False                   # flush(): skip the idle window
        self._spool_root: str | None = None
        self._sink_seq = 0

    # -- request side --------------------------------------------------

    def submit(self, req: ServeRequest) -> None:
        """Enqueue one request for admission at the next chunk boundary.

        Raises ``AdmissionQueueFull`` when ``queue_bound`` (total queued
        points) would be exceeded — the backpressure signal; callers
        retry, shed, or block on their side."""
        n = int(req.x.shape[0])
        with self._cond:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if req.slo not in self.policy.classes:
                raise ValueError(
                    f"unknown SLO class {req.slo!r}; "
                    f"have {sorted(self.policy.classes)}"
                )
            bound = self.policy.queue_bound
            if bound is not None and self._queued_points + n > bound:
                if self.stats is not None:
                    self.stats.record_rejected()
                raise AdmissionQueueFull(
                    f"admission queue holds {self._queued_points} points; "
                    f"{n} more would exceed queue_bound={bound}"
                )
            req.t_arrival = self._window.observe()
            self._last_arrival = req.t_arrival
            self._queue.append(req)
            self._queued_points += n
            self._by_future[req.future] = req
            if self.stats is not None:
                self.stats.record_queue_depth(self._queued_points)
            self._cond.notify_all()

    def cancel(self, future) -> bool:
        """Request cancellation; takes effect at the next chunk boundary.

        Returns False when the future is unknown here (never submitted,
        or already resolved)."""
        with self._cond:
            target = self._by_future.get(future)
            if target is None:
                return False
            target.cancelled = True
            self._cond.notify_all()
            return True

    def flush(self) -> None:
        """Admit whatever is queued at the next boundary, window or not."""
        with self._cond:
            self._force = True
            self._cond.notify_all()

    def close(self) -> None:
        """Stop accepting submits; the running batch and queue drain."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def queue_depth_points(self) -> int:
        with self._cond:
            return self._queued_points

    @property
    def outstanding_points(self) -> int:
        """Queued + admitted-but-unlanded query points — the router's
        least-outstanding-work spill signal. ``_active`` (partially
        scheduled) and ``_inflight`` (fully scheduled, not complete)
        entries are disjoint by construction, so each is summed once."""
        with self._cond:
            total = self._queued_points
            entries = [e for lst in self._active.values() for e in lst]
            entries.extend(self._inflight)
            for e in entries:
                total += sum(stop - start for start, stop in e.bounds[e.done:])
            return total

    def drain_pending(self) -> list[ServeRequest]:
        """Remove and return still-queued requests (post-close cleanup:
        the server fails their futures instead of stranding them)."""
        with self._cond:
            pending = list(self._queue)
            self._queue.clear()
            self._queued_points = 0
            for req in pending:
                self._by_future.pop(req.future, None)
            if self.stats is not None:
                self.stats.record_queue_depth(0)
            return pending

    def fail_all(self, exc: BaseException) -> None:
        """Terminal failure (the pipeline engine died): fail every
        outstanding future so no client blocks forever."""
        with self._cond:
            entries = set(self._inflight)
            for lst in self._active.values():
                entries.update(lst)
                lst.clear()
            self._inflight.clear()
            reqs = [e.req for e in entries if not e.finalized] + list(self._queue)
            for e in entries:
                e.finalized = True
            self._queue.clear()
            self._queued_points = 0
            self._by_future.clear()
            self._cond.notify_all()
        for req in reqs:
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(exc)

    # -- scheduling side (pipeline threads) ----------------------------

    def next_chunk(self, idle_timeout_s: float = 0.0) -> ScheduledChunk | None:
        """THE chunk boundary: reap cancellations, admit queued requests,
        pick the next unit by weighted-fair virtual time.

        With ``idle_timeout_s <= 0`` this is one strictly non-blocking
        pass (returns None when nothing is runnable) — deterministic
        under a fake clock, which is how the scheduler tests drive it. A
        positive timeout polls the condition variable up to that long
        (real-clock server use). Returns None on timeout, and None
        permanently once closed and fully drained."""
        deadline = None
        with self._cond:
            while True:
                self._reap()
                self._admit()
                item = self._pick()
                if item is not None:
                    return item
                if (self._closed and not self._queue
                        and not any(self._active.values())):
                    return None
                if idle_timeout_s <= 0:
                    return None
                t = self._clock()
                if deadline is None:
                    deadline = t + idle_timeout_s
                remaining = deadline - t
                if remaining <= 0:
                    return None
                # Poll-capped wait: a deferred idle-window admission has
                # a clock deadline no notify will fire for.
                self._cond.wait(timeout=min(remaining, 0.05))

    def complete_chunk(self, item: ScheduledChunk, piece, mu, var) -> None:
        """Land one computed piece of a chunk: scatter into the request's
        buffers (or spool sink) and resolve the future once the request is
        whole. ``mu`` and ``var`` are host arrays or device tensors (copied
        back here). Cancelled entries' results are discarded. A chunk counts
        as complete once all its query rows have landed, so a bucketed
        chunk's pieces may land in any number of calls (the reference counts
        calls, and resolves a bucketed request early: ROADMAP fault 7)."""
        e = item.entry
        _PENDING = object()
        result = _PENDING
        with self._cond:
            # A bucketed chunk lands as several pieces; the chunk is done
            # when all of its query rows have landed (each real row is in
            # exactly one piece). Counting calls instead would resolve a
            # request before its later pieces land.
            item.landed += int(np.count_nonzero(np.asarray(piece.q_mask)))
            chunk_done = item.landed >= item.n_points
            if chunk_done:
                e.done += 1
            live = not (e.finalized or e.cancelled or e.req.future.cancelled())
            if live:
                mu = _host(mu)
                var = _host(var)
                if e.sink is not None:
                    e.sink.add(piece, mu, var)
                else:
                    scatter_packed(piece, (mu, e.mean), (var, e.var))
            if chunk_done and (e.cancelled or e.req.future.cancelled()):
                if not e.finalized:
                    self._finalize_cancel(e)
                if e.done >= e.next_ci:   # last in-flight chunk landed
                    self._inflight.discard(e)
                    if e.sink is not None:
                        e.sink.cleanup()
            elif chunk_done and e.done == e.n_chunks:
                e.finalized = True
                self._inflight.discard(e)
                self._by_future.pop(e.req.future, None)
                e.req.trace.t_done = self._clock()
                if self.stats is not None:
                    self.stats.record_request(e.req.trace, slo=e.cls.name)
                result = self._result_factory(e)
            self._cond.notify_all()
        if result is not _PENDING:
            # Resolve OUTSIDE the lock: done-callbacks run inline and may
            # re-enter the scheduler (e.g. submit a follow-up request).
            if e.req.future.set_running_or_notify_cancel():
                e.req.future.set_result(result)

    # -- internals (all called with the lock held) ---------------------

    def _n_active(self) -> int:
        return sum(len(lst) for lst in self._active.values()) + len(self._inflight)

    def _reap(self) -> None:
        """Make cancellations effective: drop cancelled requests from the
        queue and cancelled entries' remaining chunks from the running
        batch. This runs at every boundary — the 'within one chunk'
        cancellation guarantee."""
        if self._queue:
            kept: deque[ServeRequest] = deque()
            for req in self._queue:
                if req.cancelled or req.future.cancelled():
                    self._queued_points -= int(req.x.shape[0])
                    self._by_future.pop(req.future, None)
                    req.future.cancel()
                    if self.stats is not None:
                        self.stats.record_cancelled()
                else:
                    kept.append(req)
            self._queue = kept
        for lst in self._active.values():
            for e in list(lst):
                if e.cancelled or e.req.future.cancelled():
                    lst.remove(e)
                    self._finalize_cancel(e)
        for e in list(self._inflight):
            if (e.cancelled or e.req.future.cancelled()) and not e.finalized:
                self._finalize_cancel(e)

    def _finalize_cancel(self, e: _Entry) -> None:
        if not e.finalized:   # idempotent: reap + complete can both land here
            e.cancelled = True
            e.finalized = True
            self._by_future.pop(e.req.future, None)
            e.req.future.cancel()
            if self.stats is not None:
                self.stats.record_cancelled()
        if e.done >= e.next_ci:   # nothing in flight — drop it now
            self._inflight.discard(e)
            if e.sink is not None:
                e.sink.cleanup()

    def _admit(self) -> None:
        if not self._queue:
            self._force = False
            return
        busy = bool(self._inflight) or any(self._active.values())
        if not busy and not self._force and not self._closed:
            # Idle device: the adaptive batching window applies exactly
            # as in drain mode — wait briefly for coalescing partners
            # unless the queue already trips max_points. When the device
            # is BUSY the window is moot: admission at a boundary is
            # free, so arrivals join the running batch immediately.
            # Anchor on the MOST RECENT arrival: each new request re-arms
            # the coalescing window (adaptive EMA shrinks it under load).
            if (self._queued_points < self.window_policy.max_points
                    and self._clock() < self._last_arrival
                    + self._window.effective_wait_s()):
                return
        self._force = False
        cap = self.policy.max_active_requests
        while self._queue:
            # On close, the cap is waived: everything queued must drain.
            if not self._closed and self._n_active() >= cap:
                break
            req = self._queue.popleft()
            self._queued_points -= int(req.x.shape[0])
            self._admit_one(req)
        if self.stats is not None:
            self.stats.record_queue_depth(self._queued_points)

    def _admit_one(self, req: ServeRequest) -> None:
        cls = self.policy.classes[req.slo]
        n = int(req.x.shape[0])
        t = self._clock()
        e = _Entry(req, cls, request_chunk_bounds(n, self.chunk_size,
                                                  self.bs_pred), t)
        req.trace.t_dispatch = t
        thr = self.policy.spool_threshold
        if thr is not None and n >= thr:
            e.sink = self._make_sink(req)
        else:
            shape = (n,) if self.n_outputs == 1 else (n, self.n_outputs)
            e.mean = np.zeros(shape)
            e.var = np.zeros(shape)
        if not self._active[cls.name]:
            # Newly backlogged class enters at the running batch's
            # virtual time — this is what lets interactive arrivals
            # preempt queued bulk chunks at the next pick.
            self._vtime[cls.name] = max(self._vtime[cls.name], self._vnow)
        self._active[cls.name].append(e)
        self._by_future[req.future] = e

    def _pick(self) -> ScheduledChunk | None:
        backlogged = [name for name, lst in self._active.items() if lst]
        if not backlogged:
            return None
        name = min(backlogged, key=lambda c: (
            self._vtime[c], self.policy.classes[c].priority, c))
        cls = self.policy.classes[name]
        lst = self._active[name]
        e = lst[0]
        if self.stats is not None:
            for other in backlogged:
                # A preemption: this pick jumps ahead of OLDER admitted
                # work in a lower-priority class.
                if (other != name
                        and self.policy.classes[other].priority > cls.priority
                        and self._active[other][0].t_admit < e.t_admit):
                    self.stats.record_preemption()
                    break
        ci = e.next_ci
        start, stop = e.bounds[ci]
        e.next_ci += 1
        if e.next_ci >= e.n_chunks:
            lst.pop(0)
            self._inflight.add(e)
        self._vnow = self._vtime[name]
        self._vtime[name] += 1.0 / max(cls.weight, 1e-9)
        return ScheduledChunk(e, ci, start, stop)

    def _make_sink(self, req: ServeRequest):
        if self._sink_factory is not None:
            return self._sink_factory(req)
        from .pipeline import SpoolResultSink

        if self._spool_root is None:
            self._spool_root = (self.policy.spool_dir
                                or tempfile.mkdtemp(prefix="sbv-serve-sink-"))
        self._sink_seq += 1
        path = os.path.join(self._spool_root, f"req_{self._sink_seq:06d}")
        return SpoolResultSink(path, int(req.x.shape[0]),
                               n_outputs=self.n_outputs)
