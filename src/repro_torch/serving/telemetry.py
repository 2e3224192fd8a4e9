"""Per-request latency + batching telemetry for the persistent GP server.

A copy of ``repro.serving.telemetry`` (pure Python). Every request carries
a trace (submit -> dispatch -> done); the server aggregates them under a
lock so ``GPServer.stats`` can report queue wait, end-to-end latency
percentiles, micro-batch occupancy, and the set of piece shape keys
``(bc, bs, m, tier)`` it ran. The reference compiles one program per key;
the port's CUDA kernels take any shape, so here the set is the shape
profile a replica's traffic touched, which the affinity router reads.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field


def now() -> float:
    return time.perf_counter()


@dataclass
class RequestTrace:
    """Timeline of one predict request through the server."""

    n_points: int
    t_submit: float = field(default_factory=now)
    t_dispatch: float = 0.0   # when its micro-batch left the queue
    t_done: float = 0.0       # when its future resolved

    @property
    def queue_wait_s(self) -> float:
        return max(0.0, self.t_dispatch - self.t_submit)

    @property
    def latency_s(self) -> float:
        return max(0.0, self.t_done - self.t_submit)


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    k = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[k]


class ServerStats:
    """Thread-safe aggregate counters for one ``GPServer`` lifetime.

    Counters are exact over the lifetime; the per-request/per-batch
    samples behind the percentiles are a sliding window (``window``
    most recent) so a server that runs forever holds bounded memory."""

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._window = window
        self.n_requests = 0
        self.n_points = 0
        self.n_batches = 0
        self.n_chunks = 0
        self.batch_sizes: deque[int] = deque(maxlen=window)    # reqs/batch
        self.batch_points: deque[int] = deque(maxlen=window)   # pts/batch
        self.latencies_s: deque[float] = deque(maxlen=window)
        self.queue_waits_s: deque[float] = deque(maxlen=window)
        self.compiled_shapes: set[tuple] = set()  # (bc, bs, m, tier) pieces run
        self.true_flops = 0.0    # padding-occupancy accounting: useful work
        self.padded_flops = 0.0  # ... vs what the padded shapes execute
        # Continuous-scheduler signals (scheduler.py): per-SLO-class
        # latency windows plus admission-queue / policy-event counters.
        self.class_latencies: dict[str, deque] = {}
        self.class_counts: dict[str, int] = {}
        self.n_cancelled = 0
        self.n_preempted = 0
        self.n_rejected = 0            # AdmissionQueueFull submits
        self.queue_depth_points = 0    # current gauge
        self.queue_depth_peak = 0      # lifetime high-water mark
        self.t_start = now()

    def record_batch(self, n_requests: int, n_points: int) -> None:
        with self._lock:
            self.n_batches += 1
            self.batch_sizes.append(n_requests)
            self.batch_points.append(n_points)

    def record_chunk_shape(self, bc: int, bs: int, m: int,
                           count_chunk: bool = True,
                           tier: str = "f64") -> None:
        """Track one piece shape; ``count_chunk=False`` records a further
        bucket piece of an already-counted chunk, so ``n_chunks`` keeps
        meaning chunks processed, not pieces dispatched. The key carries
        the precision ``tier``, as the reference's compile key does (the
        same ``(bc, bs, m)`` at two dtypes is another kernel variant), so
        the affinity router's signal does not collapse them."""
        with self._lock:
            self.n_chunks += 1 if count_chunk else 0
            self.compiled_shapes.add((bc, bs, m, tier))

    def compiled_shape_keys(self) -> set[tuple]:
        """Snapshot of the ``(bc, bs, m, tier)`` keys seen so far (a copy;
        safe to iterate while the server keeps recording)."""
        with self._lock:
            return set(self.compiled_shapes)

    def reset(self, preserve_shapes: bool = True) -> None:
        """Zero every counter and window and restart the qps clock.

        ``compiled_shapes`` is kept by default, as in the reference (whose
        process-level compile cache survives a stats reset). Pass
        ``preserve_shapes=False`` to clear it too (fresh-server
        accounting in benchmarks)."""
        with self._lock:
            self.n_requests = 0
            self.n_points = 0
            self.n_batches = 0
            self.n_chunks = 0
            self.batch_sizes.clear()
            self.batch_points.clear()
            self.latencies_s.clear()
            self.queue_waits_s.clear()
            if not preserve_shapes:
                self.compiled_shapes.clear()
            self.true_flops = 0.0
            self.padded_flops = 0.0
            self.class_latencies = {}
            self.class_counts = {}
            self.n_cancelled = 0
            self.n_preempted = 0
            self.n_rejected = 0
            self.queue_depth_points = 0
            self.queue_depth_peak = 0
            self.t_start = now()

    def record_occupancy(self, true_flops: float, padded_flops: float) -> None:
        """Accumulate the padding-occupancy ratio's numerator/denominator
        (occupancy = Sigma true FLOPs / Sigma padded FLOPs; 1.0 = zero
        padding waste — the bucketed layout's whole point)."""
        with self._lock:
            self.true_flops += float(true_flops)
            self.padded_flops += float(padded_flops)

    def record_request(self, trace: RequestTrace, slo: str | None = None) -> None:
        with self._lock:
            self.n_requests += 1
            self.n_points += trace.n_points
            self.latencies_s.append(trace.latency_s)
            self.queue_waits_s.append(trace.queue_wait_s)
            if slo is not None:
                if slo not in self.class_latencies:
                    self.class_latencies[slo] = deque(maxlen=self._window)
                    self.class_counts[slo] = 0
                self.class_latencies[slo].append(trace.latency_s)
                self.class_counts[slo] += 1

    def record_queue_depth(self, points: int) -> None:
        """Admission-queue gauge (points), with a lifetime high-water mark."""
        with self._lock:
            self.queue_depth_points = int(points)
            self.queue_depth_peak = max(self.queue_depth_peak, int(points))

    def record_cancelled(self) -> None:
        with self._lock:
            self.n_cancelled += 1

    def record_preemption(self) -> None:
        """One pick that jumped ahead of older lower-priority work."""
        with self._lock:
            self.n_preempted += 1

    def record_rejected(self) -> None:
        """One submit refused by the bounded admission queue."""
        with self._lock:
            self.n_rejected += 1

    def summary(self) -> dict:
        with self._lock:
            lat = sorted(self.latencies_s)
            waits = sorted(self.queue_waits_s)
            elapsed = max(now() - self.t_start, 1e-9)
            return {
                "n_requests": self.n_requests,
                "n_points": self.n_points,
                "n_batches": self.n_batches,
                "n_chunks": self.n_chunks,
                "points_per_s": self.n_points / elapsed,
                "mean_batch_requests": (
                    sum(self.batch_sizes) / len(self.batch_sizes)
                    if self.batch_sizes else 0.0
                ),
                "mean_batch_points": (
                    sum(self.batch_points) / len(self.batch_points)
                    if self.batch_points else 0.0
                ),
                "latency_p50_s": _percentile(lat, 0.50),
                "latency_p95_s": _percentile(lat, 0.95),
                "latency_p99_s": _percentile(lat, 0.99),
                "queue_wait_p50_s": _percentile(waits, 0.50),
                "n_compiled_shapes": len(self.compiled_shapes),
                "padding_occupancy": (
                    self.true_flops / self.padded_flops
                    if self.padded_flops else 1.0
                ),
                "n_cancelled": self.n_cancelled,
                "n_preempted": self.n_preempted,
                "n_rejected": self.n_rejected,
                "queue_depth_points": self.queue_depth_points,
                "queue_depth_peak": self.queue_depth_peak,
                "by_class": {
                    name: {
                        "n": self.class_counts[name],
                        "latency_p50_s": _percentile(sorted(d), 0.50),
                        "latency_p99_s": _percentile(sorted(d), 0.99),
                    }
                    for name, d in self.class_latencies.items()
                },
            }
