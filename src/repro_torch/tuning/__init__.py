"""Persistent shape autotuner.

Measures short candidate runs over the observed block-size histogram and
the device memory budget, picks the execution shape (bucket count and
ceilings, backend, precision tier, streaming chunk), and persists the
winner as a ``TuningRecord`` next to the checkpoint so later fits,
predictions and servers start pre-tuned. Counterpart of ``repro.tuning``.
"""
from .autotune import autotune_loglik, recommend_stream_chunk
from .record import (RECORD_VERSION, TuningRecord, apply_record, as_record, port_backend,
                     settled_tier)

__all__ = [
    "RECORD_VERSION",
    "TuningRecord",
    "apply_record",
    "as_record",
    "autotune_loglik",
    "port_backend",
    "recommend_stream_chunk",
    "settled_tier",
]
