"""Multi-replica prediction routing with shape affinity.

Counterpart of ``repro.serving.router``; ``rendezvous_rank`` and
``request_shape_signature`` give the reference's values (the hash is
``hashlib``'s keyed blake2b), so both packages partition a request stream
identically. In the reference each replica owns a compile cache, and
spraying requests makes every replica compile every shape. The port's
CUDA kernels are built once for all shapes, so here affinity only keeps
each shape class on one replica; the replicas are threads on one card,
each with its own CUDA stream (``GPServer``), so their kernels can run
side by side.
``ServerStats.compiled_shapes`` records the piece shapes each replica
ran, and the router closes the loop on it:

* **shape signature** — ``request_shape_signature`` maps a request's row
  count through the SAME stepping the serving stack uses
  (``request_chunk_bounds`` + the ``pad_shapes`` block rounding +
  ``bucket_mults`` quantization) into the ``(bc, bs, m, tier)`` key
  space ``ServerStats.compiled_shapes`` records. Equal-size requests
  under one config share a signature by construction, so they share all
  realized piece shapes.
* **rendezvous hashing** — each signature scores every replica with a
  keyed blake2b digest and prefers the max (highest-random-weight
  hashing): deterministic, coordination-free, and stable — removing a
  replica only remaps the signatures it owned. Python's salted
  ``hash()`` is deliberately NOT used (routing must agree across
  processes and runs).
* **least-outstanding-work spill** — affinity is a preference, not a
  pin: when the preferred replica's outstanding work (queued + admitted
  unfinished points, ``GPServer.outstanding_points``) exceeds
  ``spill_points``, or its bounded admission queue rejects the submit
  (``AdmissionQueueFull``), the request spills to the least-loaded
  replica. Steady-state traffic hits warm caches; bursts still balance.

Parity contract: replicas must run the continuous scheduler
(``GPServerConfig.scheduler`` set) with identical pipeline configs and
seeds — scheduler mode packs every request with the base seed, so ANY
replica returns exactly the lone ``predict_sbv(..., seed=config.seed)``
answer and routing can never change a result (<= 1e-12, gated). Drain
mode's per-batch seeds break that, so drain-mode replicas are refused.
"""
from __future__ import annotations

import hashlib
import threading

import numpy as np

from .batching import AdmissionQueueFull
from .pipeline import PipelineConfig, request_chunk_bounds


def _signature_tier(cfg: PipelineConfig) -> str:
    from repro_torch.core.buckets import dtype_tier

    return cfg.precision or dtype_tier(cfg.dtype)


def request_shape_signature(n: int, cfg: PipelineConfig) -> tuple:
    """The compile-key profile of an ``n``-row request under ``cfg``.

    Chunk stepping follows ``request_chunk_bounds`` exactly; each chunk
    contributes the ``(bc, bs, m, tier)`` key of its uniform padded
    layout (block count rounded to 8 under the chunked ``pad_shapes``
    protocol, mirroring ``pack_queries``). Bucketed configs append the
    ``bucket_mults`` quantization the chunk split applies, since it
    reshapes the realized per-bucket keys. Two requests with equal
    signatures realize identical compile-cache keys — the affinity
    invariant the router routes on. (Bucketed realized keys also depend
    on the data's block-size skew, but that skew is a function of the
    chunk profile + config, both of which the signature pins.)
    """
    from repro_torch.core.packing import round_up

    tier = _signature_tier(cfg)
    keys = set()
    for start, stop in request_chunk_bounds(n, cfg.chunk_size, cfg.bs_pred):
        bc = max(1, (stop - start) // cfg.bs_pred)
        if cfg.chunk_size is not None:
            bc = round_up(bc, 8)
        keys.add((bc, cfg.bs_pred, cfg.m_pred, tier))
    sig = tuple(sorted(keys))
    if cfg.n_buckets:
        from repro_torch.core.buckets import bucket_mults

        bs_mult, m_mult = (max(v, 8)
                           for v in bucket_mults(cfg.backend,
                                                 precision=cfg.precision))
        sig = sig + (("buckets", cfg.n_buckets, bs_mult, m_mult),)
    return sig


def rendezvous_rank(signature, n_replicas: int, salt: int = 0) -> int:
    """Highest-random-weight owner of ``signature`` among ``n_replicas``.

    Deterministic across processes and runs (keyed blake2b, never the
    salted builtin ``hash``); removing a replica only remaps signatures
    it owned. Also used by the multi-host serve plane to partition a
    request stream across ranks with zero coordination."""
    if n_replicas <= 0:
        raise ValueError("need at least one replica")
    sig = repr(signature).encode()
    best, best_score = 0, b""
    for r in range(n_replicas):
        score = hashlib.blake2b(
            sig, digest_size=8, key=f"{salt}|{r}".encode()
        ).digest()
        if score > best_score:
            best, best_score = r, score
    return best


class RouterStats:
    """Thread-safe routing counters (the tentpole's telemetry surface):
    per-replica request/point totals, affinity hit-rate (requests landing
    on their rendezvous-preferred replica) and spill rate."""

    def __init__(self, n_replicas: int):
        self._lock = threading.Lock()
        self.n_replicas = int(n_replicas)
        self.n_requests = 0
        self.n_points = 0
        self.affinity_hits = 0
        self.n_spilled = 0
        self.replica_requests = [0] * self.n_replicas
        self.replica_points = [0] * self.n_replicas
        self.replica_spills = [0] * self.n_replicas  # spilled ONTO replica

    def record(self, replica: int, preferred: int, n_points: int,
               spilled: bool) -> None:
        with self._lock:
            self.n_requests += 1
            self.n_points += int(n_points)
            self.replica_requests[replica] += 1
            self.replica_points[replica] += int(n_points)
            if replica == preferred:
                self.affinity_hits += 1
            if spilled:
                self.n_spilled += 1
                self.replica_spills[replica] += 1

    def summary(self) -> dict:
        with self._lock:
            n = max(self.n_requests, 1)
            return {
                "n_replicas": self.n_replicas,
                "n_requests": self.n_requests,
                "n_points": self.n_points,
                "affinity_hits": self.affinity_hits,
                "affinity_hit_rate": self.affinity_hits / n,
                "n_spilled": self.n_spilled,
                "spill_rate": self.n_spilled / n,
                "replica_requests": list(self.replica_requests),
                "replica_points": list(self.replica_points),
                "replica_spills": list(self.replica_spills),
            }


class ReplicaRouter:
    """Front N ``GPServer`` replicas behind the one-server API.

    ``submit()/flush()/stop()`` mirror ``GPServer``; routing policy:

    * ``"affinity"`` (default) — rendezvous-preferred replica, with
      least-outstanding-work spill past ``spill_points`` or on
      ``AdmissionQueueFull``;
    * ``"random"`` — seeded uniform choice (the baseline affinity is
      compared against);
    * ``"round_robin"`` — strict rotation.

    Replicas must be scheduler-mode servers sharing one pipeline config
    and seed (checked at construction — the per-request parity
    contract). Local replicas are threads on one card, each with its own
    stream; ``compiled_shapes`` per replica is the set of piece shapes its
    traffic touched.
    """

    def __init__(self, replicas, routing: str = "affinity",
                 spill_points: int | None = None, seed: int = 0):
        if not replicas:
            raise ValueError("need at least one replica")
        if routing not in ("affinity", "random", "round_robin"):
            raise ValueError(f"unknown routing policy {routing!r}")
        for i, rep in enumerate(replicas):
            rcfg = getattr(rep, "config", None)
            if rcfg is not None and rcfg.scheduler is None:
                raise ValueError(
                    f"replica {i} runs the drain-mode loop; routing "
                    "requires scheduler-mode replicas (drain mode's "
                    "per-batch seeds break the per-request parity "
                    "contract — set GPServerConfig.scheduler)"
                )
        self._check_uniform(replicas)
        self.replicas = list(replicas)
        self.routing = routing
        self.spill_points = spill_points
        self.seed = int(seed)
        self.stats = RouterStats(len(replicas))
        self._cfg = self._pipeline_cfg(replicas[0])
        self._lock = threading.Lock()
        self._rr = 0
        self._rng = np.random.default_rng(seed)

    @staticmethod
    def _pipeline_cfg(replica) -> PipelineConfig:
        rcfg = getattr(replica, "config", None)
        return rcfg.pipeline if rcfg is not None else PipelineConfig()

    @staticmethod
    def _check_uniform(replicas) -> None:
        def key(rep):
            rcfg = getattr(rep, "config", None)
            if rcfg is None:
                return None
            p = rcfg.pipeline
            return (rcfg.seed, p.chunk_size, p.bs_pred, p.m_pred, p.nu,
                    p.alpha, p.backend, np.dtype(p.dtype).name, p.n_buckets,
                    p.precision)

        keys = {key(rep) for rep in replicas} - {None}
        if len(keys) > 1:
            raise ValueError(
                "replicas disagree on pipeline config/seed "
                f"({sorted(map(str, keys))}); identical configs are the "
                "routing-independence (parity) contract"
            )

    # -- lifecycle (fan out to every replica) --------------------------

    def start(self) -> "ReplicaRouter":
        for rep in self.replicas:
            rep.start()
        return self

    def stop(self, timeout_s: float = 120.0) -> None:
        errs = []
        for rep in self.replicas:
            try:
                rep.stop(timeout_s=timeout_s)
            except Exception as exc:  # keep stopping the rest
                errs.append(exc)
        if errs:
            raise errs[0]

    def __enter__(self) -> "ReplicaRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def flush(self) -> None:
        for rep in self.replicas:
            rep.flush()

    def warmup(self, n_points: int | None = None):
        """Warm every replica's cache (one synthetic batch each)."""
        return [rep.warmup(n_points) for rep in self.replicas]

    # -- routing -------------------------------------------------------

    def preferred_replica(self, n: int) -> int:
        """The rendezvous owner of an ``n``-row request (affinity target
        before any spill) — exposed for tests and telemetry."""
        return rendezvous_rank(request_shape_signature(n, self._cfg),
                               len(self.replicas), salt=self.seed)

    def _outstanding(self, i: int) -> int:
        return int(getattr(self.replicas[i], "outstanding_points", 0))

    def _least_outstanding(self, exclude=()) -> int:
        candidates = [i for i in range(len(self.replicas))
                      if i not in exclude]
        return min(candidates, key=lambda i: (self._outstanding(i), i))

    def submit(self, x, slo: str = "interactive", outputs=None):
        """Route one predict request; returns the replica's Future.

        Raises ``AdmissionQueueFull`` only when EVERY replica rejects."""
        n = int(np.asarray(x).shape[0]) if np.asarray(x).ndim > 1 else 1
        pref = self.preferred_replica(n)
        if self.routing == "random":
            target = int(self._rng.integers(len(self.replicas)))
        elif self.routing == "round_robin":
            with self._lock:
                target = self._rr % len(self.replicas)
                self._rr += 1
        else:
            target = pref
            if (self.spill_points is not None
                    and self._outstanding(pref) > self.spill_points):
                spill_to = self._least_outstanding()
                if self._outstanding(spill_to) < self._outstanding(pref):
                    target = spill_to
        tried = []
        while True:
            try:
                fut = self.replicas[target].submit(x, slo=slo,
                                                   outputs=outputs)
                break
            except AdmissionQueueFull:
                tried.append(target)
                if len(tried) == len(self.replicas):
                    raise
                target = self._least_outstanding(exclude=tried)
        self.stats.record(target, pref, n,
                          spilled=(self.routing == "affinity"
                                   and target != pref))
        return fut

    # -- telemetry -----------------------------------------------------

    def summary(self) -> dict:
        """Routing counters + per-replica server telemetry: qps, compile
        keys seen (the recompile count under process replicas), queue
        gauges — the ``serve gp --replicas`` report."""
        out = self.stats.summary()
        per = []
        for i, rep in enumerate(self.replicas):
            stats = getattr(rep, "stats", None)
            s = stats.summary() if stats is not None else {}
            per.append({
                "replica": i,
                "n_requests": s.get("n_requests", 0),
                "n_points": s.get("n_points", 0),
                "points_per_s": s.get("points_per_s", 0.0),
                "n_compiled_shapes": s.get("n_compiled_shapes", 0),
                "queue_depth_peak": s.get("queue_depth_peak", 0),
            })
        out["replicas"] = per
        out["total_compiled_shapes"] = sum(r["n_compiled_shapes"]
                                           for r in per)
        return out
