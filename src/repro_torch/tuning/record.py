"""Persistent autotuner output: one JSON-plain ``TuningRecord``.

Counterpart of ``repro.tuning.record``, field for field: ``to_dict()``
gives the same JSON, so a record written by either package loads in the
other. The autotuner (``repro_torch.tuning.autotune``) measures short
candidate runs and distils the winner into the execution-shape knobs that
``fit_sbv``, ``predict_sbv`` and ``GPServer`` otherwise take from their
callers: bucket count and ceilings, tile multiples, kernel backend,
precision tier, streaming chunk, device cache budget. Saved next to the
checkpoint (``ckpt.save_tuning_record`` -> ``tuning_record.json``), it lets
a later process start pre-tuned without measuring again. The record keeps
its evidence: the observed block-size histogram and the whole measured
candidate table.

Backend names: the port has two backends, ``'auto'`` (the kernel route on
a CUDA device) and ``'ref'`` (the plain version). A record written by the
reference may name ``'pallas'`` or ``'pallas_tiled'``, its TPU kernels;
``port_backend`` reads those as ``'auto'`` when the port applies the
record. The record itself keeps the name it was given, so a reference
record saved again by the port is unchanged.

``apply_record`` is the one place that maps a record onto the knobs of
``fit_sbv``, ``predict_sbv``, ``serving.tuned_config`` and ``serve gp
--tuning-record``.
"""
from __future__ import annotations

import os
from dataclasses import asdict, dataclass, field
from typing import NamedTuple

RECORD_VERSION = 1

# The reference's kernel backends, each of which the port runs as its
# kernel route.
_KERNEL_BACKENDS = ("pallas", "pallas_tiled")
# The ladder, narrowest first.
_TIERS = ("bf16", "f32", "f64")


def port_backend(name: str | None) -> str | None:
    """The port's backend for a record's backend name (``None`` passes)."""
    return "auto" if name in _KERNEL_BACKENDS else name


@dataclass
class TuningRecord:
    """Autotuned execution shape for one (dataset, device) pairing.

    All fields are JSON-plain, so the record round-trips through
    ``ckpt.save_tuning_record`` byte-stably. ``None`` means "knob not tuned:
    keep the caller's default"."""

    version: int = RECORD_VERSION
    n_buckets: int | None = None          # K (bucket levels per dim); None = unbucketed
    bs_ceilings: list | None = None       # realized block-size bucket ceilings
    m_ceilings: list | None = None        # realized neighbor-count ceilings
    bs_mult: int = 1                      # tile multiple for bs ceilings
    m_mult: int = 1                       # tile multiple for m ceilings
    backend: str | None = None            # kernel backend, as given ('auto', 'ref', ...)
    precision: str | None = None          # requested ladder tier
    bucket_tiers: list | None = None      # probe-enforced per-bucket tiers at tune time
    error_budget: float | None = None     # PrecisionPolicy override, if any
    stream_chunk: int | None = None       # streaming rows per pass; None = in-core
    device_cache_budget: int | None = None  # spool device-tier bytes at tune time
    occupancy: float | None = None        # true/padded FLOP ratio of the winner
    histogram: dict | None = None         # observed {bs: {...}, m: {...}} size stats
    candidates: list = field(default_factory=list)  # measured candidate table
    meta: dict = field(default_factory=dict)        # n, d, device, timings...

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TuningRecord":
        known = {f for f in cls.__dataclass_fields__}
        rec = cls(**{k: v for k, v in d.items() if k in known})
        if rec.version > RECORD_VERSION:
            raise ValueError(f"tuning record version {rec.version} is newer than this "
                             f"build understands ({RECORD_VERSION})")
        return rec

    def precision_policy(self):
        """The record's precision choice as a ``core.buckets.PrecisionPolicy``
        (probing stays on, so a drifted dataset still demotes safely)."""
        from repro_torch.core.buckets import PrecisionPolicy

        return PrecisionPolicy(tier=self.precision or "f64", error_budget=self.error_budget)

    # -- persistence ---------------------------------------------------
    def save(self, directory: str) -> str:
        """Write ``tuning_record.json`` into ``directory`` (atomic)."""
        from repro_torch.ckpt import save_tuning_record

        return save_tuning_record(directory, self.to_dict())

    @classmethod
    def load(cls, directory: str) -> "TuningRecord | None":
        """Load from a checkpoint directory or a direct json path."""
        from repro_torch.ckpt import load_tuning_record

        d = load_tuning_record(directory)
        return None if d is None else cls.from_dict(d)


def as_record(obj) -> TuningRecord:
    """Coerce a TuningRecord / dict / path into a ``TuningRecord``.

    A string is a checkpoint directory or json path; a missing record there
    is an error (the caller asked to start pre-tuned)."""
    if isinstance(obj, TuningRecord):
        return obj
    if isinstance(obj, dict):
        return TuningRecord.from_dict(obj)
    if isinstance(obj, (str, os.PathLike)):
        rec = TuningRecord.load(os.fspath(obj))
        if rec is None:
            raise FileNotFoundError(f"no tuning record at {obj!r}")
        return rec
    raise TypeError(f"cannot interpret {type(obj).__name__} as a TuningRecord")


def settled_tier(rec: TuningRecord) -> str | None:
    """The tier a path that probes nothing (prediction, serving) takes from
    a record: the widest of the tiers its winner's buckets were assigned at
    tune time (``bucket_tiers``), or the requested ``precision`` when the
    record carries no assignment. The requested tier alone can name a
    narrow tier that the probe demoted in every bucket: the candidates then
    tie and one wins on timing noise."""
    if rec.bucket_tiers:
        return max(rec.bucket_tiers, key=_TIERS.index)
    return rec.precision


class Knobs(NamedTuple):
    """The execution knobs a tuning record sets."""

    n_buckets: int | None
    stream_chunk: int | None
    precision: object
    backend: str | None


def apply_record(tuning, n_buckets=None, stream_chunk=None, precision=None, backend=None,
                 probe: bool = False) -> Knobs:
    """The execution knobs from a tuning record (a ``TuningRecord``, its
    dict, or a checkpoint path, from either package), explicit arguments
    winning.

    ``None`` leaves a knob to the record (``n_buckets=0`` asks for the
    uniform layout), and so does ``backend='auto'``; the record's backend
    goes through ``port_backend``. The precision is the record's requested
    tier as a probing ``PrecisionPolicy`` when the caller probes
    (``probe=True``: a fit probes every bucket every outer round), else
    its ``settled_tier``."""
    rec = as_record(tuning)
    if n_buckets is None:
        n_buckets = rec.n_buckets
    if stream_chunk is None:
        stream_chunk = rec.stream_chunk
    if precision is None and rec.precision:
        precision = rec.precision_policy() if probe else settled_tier(rec)
    if backend in (None, "auto") and rec.backend:
        backend = port_backend(rec.backend)
    return Knobs(n_buckets, stream_chunk, precision, backend)
