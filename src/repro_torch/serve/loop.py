"""Synchronous serving loop: request intake -> micro-batch flush -> stats.

The port of ``repro.serve.loop``.  ``ServeLoop`` is the production-style
driver over a ``TableRegistry``: it keeps one ``MicroBatcher`` per
registered model, admits requests one at a time, and flushes a model's
queue when either

  * the queue holds ``flush_rows`` rows (a full coalescing bucket), or
  * the oldest request has waited ``window_s`` seconds (latency bound).

Every request gets wall-clock latency accounting from enqueue to its
results on the host: a flush ends with the copy of the outputs from the
device, which waits for the kernel, and only then is the completion time
stamped (a CUDA launch returns before the kernel ends).  ``stats()``
reports p50/p99 latency + requests/s + samples/s, and ``report()`` puts
them beside the ``perfmodel`` analytic numbers for the same model
mapping (DESIGN.md §6) and the flushes per bucket size.

The loop is deliberately synchronous — single-threaded, deterministic,
testable — and is the ORACLE the async tier
(``repro_torch.serve.cluster``) is bit-equality-tested against on
identical request streams (DESIGN.md §12).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

import numpy as np

from repro_torch.serve.batching import MicroBatcher
from repro_torch.serve.registry import TableRegistry


@dataclass
class RequestRecord:
    """Completed-request accounting."""

    model: str
    request_id: int
    n_rows: int
    t_enqueue: float
    t_done: float

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_enqueue


@dataclass
class LatencyStats:
    """Aggregate serving statistics for one model (or the whole loop)."""

    n_requests: int
    n_rows: int
    p50_ms: float
    p99_ms: float
    mean_ms: float
    requests_per_s: float
    samples_per_s: float
    n_flushes: int

    @classmethod
    def from_records(
        cls, records: "list[RequestRecord] | deque", n_flushes: int
    ) -> "LatencyStats":
        records = list(records)
        if not records:
            return cls(0, 0, 0.0, 0.0, 0.0, 0.0, 0.0, n_flushes)
        lat_ms = np.array([r.latency_s for r in records]) * 1e3
        span = max(r.t_done for r in records) - min(r.t_enqueue for r in records)
        span = max(span, 1e-9)
        return cls(
            n_requests=len(records),
            n_rows=sum(r.n_rows for r in records),
            p50_ms=float(np.percentile(lat_ms, 50)),
            p99_ms=float(np.percentile(lat_ms, 99)),
            mean_ms=float(lat_ms.mean()),
            requests_per_s=len(records) / span,
            samples_per_s=sum(r.n_rows for r in records) / span,
            n_flushes=n_flushes,
        )


class ServeLoop:
    """Micro-batching request driver over a ``TableRegistry``."""

    def __init__(
        self,
        registry: TableRegistry,
        *,
        window_s: float = 0.002,
        flush_rows: int = 256,
        max_batch: int = 1024,
        kind: str = "predict",
        clock: Callable[[], float] = time.perf_counter,
        history: int = 100_000,
    ) -> None:
        self.registry = registry
        self.window_s = window_s
        self.flush_rows = flush_rows
        self.max_batch = max_batch
        self.kind = kind
        self.clock = clock
        self._batchers: dict[str, MicroBatcher] = {}
        self._versions: dict[str, int] = {}
        self._results: dict[tuple[str, int], np.ndarray] = {}
        # latency accounting is a rolling window so a long-lived loop stays
        # bounded; completed OUTPUTS are popped by result() — callers that
        # never fetch a handle leak it, by design (there is no TTL yet)
        self._records: deque[RequestRecord] = deque(maxlen=history)
        self._inflight: dict[str, list[tuple[int, int, float]]] = {}
        self._n_flushes: dict[str, int] = {}
        self._buckets: dict[str, dict[int, int]] = {}  # model -> {bucket: flushes}
        # loop-global id allocation: handles stay unique even when a hot
        # swap replaces a model's batcher (whose local counter restarts)
        self._next_rid: int = 0

    # -- internals -----------------------------------------------------------

    def _batcher(self, model: str) -> MicroBatcher:
        entry = self.registry.get(model)
        # hot swap: a version bump invalidates the cached batcher (it holds
        # the old engine); pending requests of the old version still flush
        # through the old batcher before it is dropped.
        if (
            model not in self._batchers
            or self._versions.get(model) != entry.version
        ):
            old = self._batchers.get(model)
            if old is not None and old.pending_requests:
                self._flush(model, old)
            self._batchers[model] = MicroBatcher.for_engine(
                entry.engine, max_batch=self.max_batch, kind=self.kind
            )
            self._versions[model] = entry.version
        return self._batchers[model]

    def _flush(self, model: str, batcher: MicroBatcher | None = None) -> int:
        batcher = batcher if batcher is not None else self._batchers.get(model)
        if batcher is None or not batcher.pending_requests:
            return 0
        results = batcher.flush()  # ends with the D2H copy: the kernel is done
        t_done = self.clock()
        self._n_flushes[model] = self._n_flushes.get(model, 0) + 1
        size = batcher.bucket.select(sum(out.shape[0] for out in results.values()))
        counts = self._buckets.setdefault(model, {})
        counts[size] = counts.get(size, 0) + 1
        inflight = self._inflight.get(model, [])
        done = [x for x in inflight if x[0] in results]
        self._inflight[model] = [x for x in inflight if x[0] not in results]
        for rid, n_rows, t_enq in done:
            self._results[(model, rid)] = results[rid]
            self._records.append(
                RequestRecord(model, rid, n_rows, t_enq, t_done)
            )
        return len(done)

    # -- request API ---------------------------------------------------------

    def submit(self, model: str, q_bins: np.ndarray) -> tuple[str, int]:
        """Enqueue one request; returns its (model, request_id) handle.

        May trigger a flush of the model's queue (full bucket or expired
        window) — admission and service share the single thread.
        """
        now = self.clock()
        batcher = self._batcher(model)
        q = np.asarray(q_bins)
        if q.ndim == 1:
            q = q[None, :]
        rid = batcher.submit(q, t_enqueue=now, request_id=self._next_rid)
        self._next_rid += 1
        self._inflight.setdefault(model, []).append((rid, q.shape[0], now))
        oldest = batcher.oldest_enqueue_time()
        if batcher.pending_rows >= self.flush_rows or (
            oldest is not None and now - oldest >= self.window_s
        ):
            self._flush(model)
        return model, rid

    def poll(self) -> int:
        """Flush every queue whose coalescing window has expired."""
        now = self.clock()
        done = 0
        for model, batcher in list(self._batchers.items()):
            oldest = batcher.oldest_enqueue_time()
            if oldest is not None and now - oldest >= self.window_s:
                done += self._flush(model, batcher)
        return done

    def drain(self) -> int:
        """Flush everything pending regardless of window; returns #done."""
        done = 0
        for model in list(self._batchers):
            done += self._flush(model)
        return done

    def result(self, handle: tuple[str, int]) -> np.ndarray:
        """Fetch (and forget) a completed request's outputs."""
        if handle not in self._results:
            self._flush(handle[0])
        try:
            return self._results.pop(handle)
        except KeyError:
            raise KeyError(f"request {handle} not completed") from None

    # -- accounting ----------------------------------------------------------

    def stats(self, model: str | None = None) -> LatencyStats:
        records = [
            r for r in self._records if model is None or r.model == model
        ]
        n_flushes = (
            sum(self._n_flushes.values())
            if model is None
            else self._n_flushes.get(model, 0)
        )
        return LatencyStats.from_records(records, n_flushes)

    def report(self, model: str) -> dict:
        """Measured serving stats side-by-side with the chip model."""
        s = self.stats(model)
        entry = self.registry.get(model)
        perf = entry.perf
        deploy = entry.deploy
        return {
            "model": model,
            "version": entry.version,
            "deploy": {
                "backend": deploy.backend,
                "mode": deploy.mode,
                "noc_config": entry.engine.noc_config,
                "spmd": entry.engine.spmd,
                "batching": entry.batching,
                "device": str(entry.engine.device),
            },
            "measured": {
                "requests": s.n_requests,
                "rows": s.n_rows,
                "p50_ms": round(s.p50_ms, 3),
                "p99_ms": round(s.p99_ms, 3),
                "mean_ms": round(s.mean_ms, 3),
                "requests_per_s": round(s.requests_per_s, 1),
                "samples_per_s": round(s.samples_per_s, 1),
                "flushes": s.n_flushes,
                "buckets": dict(sorted(self._buckets.get(model, {}).items())),
            },
            "xtime_chip_model": {
                "latency_ns": round(perf.latency_ns, 1),
                "throughput_msps": round(perf.throughput_msps, 2),
                "energy_nj_per_dec": round(perf.energy_nj_per_dec, 3),
                "bottleneck": perf.bottleneck,
            },
        }
