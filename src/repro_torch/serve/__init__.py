"""Production serving layer over the X-TIME CAM engine (DESIGN.md §6, §12).

The port of ``repro.serve``, on one device (``device=``; ``None`` is the
card) or one device mesh (``mesh=``):

    TableRegistry  — hold/hot-swap many named models, one device or
                     mesh; accepts a trained Ensemble, a CAMTable, or a
                     CompiledModel artifact (disk cold-start, zero
                     recompilation); thread-safe for concurrent swap/lookup
    MicroBatcher   — shape-bucketed request coalescing per engine
                     (thread-safe enqueue/flush)
    ServeLoop      — synchronous single-threaded driver with p50/p99
                     latency accounting; the deterministic oracle the
                     async tier is bit-equality-tested against
    ClusterServer  — the async production tier: concurrent intake over
                     per-model queues, adaptive flush deadlines,
                     admission control with explicit shedding, and
                     replicated fault tolerance (heartbeat failover,
                     straggler exclusion, elastic restore) wired to
                     repro_torch.ft.runtime; replicas run on streams
                     of their own
    TrafficTrace   — seeded heavy-tailed replay load generation
                     (make_trace / replay_trace) for SLO gating
"""

from repro_torch.serve.batching import BucketSpec, MicroBatcher
from repro_torch.serve.cluster import (
    AdaptiveWindow,
    ClusterClosed,
    ClusterHandle,
    ClusterServer,
    FailedRequest,
    ShedError,
)
from repro_torch.serve.loop import LatencyStats, RequestRecord, ServeLoop
from repro_torch.serve.registry import ServedModel, TableRegistry
from repro_torch.serve.traffic import (
    ReplayResult,
    TrafficMark,
    TrafficRequest,
    TrafficTrace,
    make_trace,
    replay_trace,
)

__all__ = [
    "AdaptiveWindow",
    "BucketSpec",
    "ClusterClosed",
    "ClusterHandle",
    "ClusterServer",
    "FailedRequest",
    "LatencyStats",
    "MicroBatcher",
    "ReplayResult",
    "RequestRecord",
    "ServeLoop",
    "ServedModel",
    "ShedError",
    "TableRegistry",
    "TrafficMark",
    "TrafficRequest",
    "TrafficTrace",
    "make_trace",
    "replay_trace",
]
