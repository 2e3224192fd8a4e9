# Persistent batched GP serving, the counterpart of ``repro.serving``:
#   batching.py  — request micro-batching + SLO / scheduler policy types
#   scheduler.py — continuous-batching scheduler (running batch, SLO-aware
#                  admission at chunk boundaries, cancellation, backpressure)
#   pipeline.py  — double-buffered chunk engine on CUDA streams (pack k+1 ||
#                  compute k || land k-1), per-request pack protocol,
#                  spool-backed result sink
#   server.py    — GPServer: owns the train index, the device parameters and
#                  a CUDA stream
#   router.py    — ReplicaRouter: N replicas behind one submit(), routed by
#                  shape affinity (rendezvous hashing + spill)
#   telemetry.py — per-request / per-SLO-class latency + occupancy stats
from .batching import (
    AdmissionQueueFull, ArrivalWindow, BatchingPolicy, MicroBatcher,
    PredictRequest, SchedulerPolicy, ServeRequest, SLOClass,
)
from .pipeline import (
    ChunkTimer, PipelineConfig, SpoolResultSink, pack_scheduled,
    predict_pipelined, predict_synchronous, request_chunk_bounds,
    run_chunk_stream, tuned_config,
)
from .router import (
    ReplicaRouter, RouterStats, rendezvous_rank, request_shape_signature,
)
from .scheduler import ContinuousScheduler, ScheduledChunk
from .server import GPServer, GPServerConfig, ServeResult
from .telemetry import RequestTrace, ServerStats

__all__ = [
    "AdmissionQueueFull", "ArrivalWindow", "BatchingPolicy", "MicroBatcher",
    "PredictRequest", "SchedulerPolicy", "ServeRequest", "SLOClass",
    "ChunkTimer", "PipelineConfig", "SpoolResultSink", "pack_scheduled",
    "predict_pipelined", "predict_synchronous", "request_chunk_bounds",
    "run_chunk_stream", "tuned_config",
    "ReplicaRouter", "RouterStats", "rendezvous_rank",
    "request_shape_signature",
    "ContinuousScheduler", "ScheduledChunk",
    "GPServer", "GPServerConfig", "ServeResult",
    "RequestTrace", "ServerStats",
]
