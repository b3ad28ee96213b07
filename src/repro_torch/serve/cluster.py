"""Async serving tier: replicated, fault-tolerant cluster over the CAM
engine (DESIGN.md §12).

The port of ``repro.serve.cluster``.  Its replicas are worker threads on
one device (or one mesh, ``mesh=``): each runs its flushes on a CUDA
stream of its own on that device, the mesh's first one (the kernels
launch on the current stream, and the copy of a flush's outputs to the
host waits for that stream only), and all of them share the one engine
that the artifact binds once.

``ClusterServer`` is the production layer the synchronous ``ServeLoop``
deliberately deferred: the same flush discipline (full coalescing bucket
OR expired latency window), but with

  * concurrent intake — ``submit`` is called from any number of client
    threads and returns a ``ClusterHandle`` future; per-model queues are
    drained by a dispatcher thread and executed on replica worker
    threads (thread-based producer/consumer);
  * per-model ADAPTIVE flush deadlines — an EWMA of request
    inter-arrival time sizes the window to "the expected time to fill a
    coalescing bucket", clamped between bounds (``AdaptiveWindow``), so
    hot models flush on full buckets and cold models stop holding single
    requests for the maximum window;
  * admission control — each model's queue is bounded
    (``max_queue_rows``); an overloaded queue sheds the request with an
    explicit ``ShedError`` (the HTTP-503 of this tier) instead of
    queueing unbounded latency, and sheds are counted per model;
  * replicated fault tolerance — every replica holds a full
    ``TableRegistry`` copy of each registered artifact (degrading
    THROUGHPUT, not correctness).  Replicas beat
    ``repro_torch.ft.runtime.Heartbeat`` liveness files; a monitor marks
    a silent replica dead after the timeout and re-routes its queued and
    in-flight work to survivors.  Per-ROW flush wall times (batch sizes
    vary wildly between paced and burst regimes) feed one shared
    EWMA ``StragglerMonitor``; a replica flagged ``straggler_strikes``
    times is excluded from routing (the serving analogue of re-slicing).
    ``restore_replica`` is the elastic boundary: a fresh replica
    re-registers the current catalog and rejoins the rotation.

Correctness contract: predictions are BIT-EQUAL to the synchronous
``ServeLoop`` on the same request stream, before/during/after any
failover — every replica binds an engine over the same compiled
artifact, a request is completed exactly once (first writer wins), and a
re-routed request re-executes the same deterministic computation on a
survivor (tests/test_torch_cluster.py).

Fault-injection hooks (``inject_crash`` / ``inject_hang`` /
``inject_delay`` / ``restore_replica``) make every degradation mode
testable on the CPU — no real hardware needs to die to exercise the
failover state machine.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import queue
import shutil
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.launch.mesh import check_mesh
from repro_torch.ft.runtime import Heartbeat, StragglerMonitor
from repro_torch.serve.batching import MicroBatcher
from repro_torch.serve.loop import LatencyStats, RequestRecord
from repro_torch.serve.registry import ServedModel, TableRegistry

log = logging.getLogger(__name__)

# replica lifecycle: ALIVE -> (EXCLUDED <-> ALIVE) -> DEAD -> (restore)
ALIVE, EXCLUDED, DEAD = "alive", "excluded", "dead"


class ShedError(RuntimeError):
    """Admission control rejected the request (bounded queue overflowed).

    The explicit backpressure signal of the cluster tier: callers retry
    with backoff or divert, exactly like an HTTP 503 — the queue never
    absorbs unbounded latency.
    """


class ClusterClosed(RuntimeError):
    """Submitted to a server after ``close()``."""


class FailedRequest(RuntimeError):
    """The request exhausted its retry budget (every replica failed it)."""


@dataclass
class AdaptiveWindow:
    """Per-model flush deadline from an EWMA of inter-arrival times.

    The window targets "expected time for ``target_rows`` more rows to
    arrive": at high arrival rate it shrinks toward ``min_s`` (the
    bucket fills anyway; don't add latency), at low rate it grows toward
    ``max_s`` (wait for coalescing partners, but bounded).  Before any
    interval is observed the window is ``max_s``.
    """

    min_s: float = 5e-4
    max_s: float = 0.02
    target_rows: int = 256
    alpha: float = 0.2
    _ewma_dt: float | None = None
    _last_arrival: float | None = None

    def observe(self, now: float, n_rows: int = 1) -> None:
        if self._last_arrival is not None:
            dt = max(now - self._last_arrival, 0.0) / max(1, n_rows)
            self._ewma_dt = (
                dt if self._ewma_dt is None
                else self.alpha * dt + (1.0 - self.alpha) * self._ewma_dt
            )
        self._last_arrival = now

    @property
    def window_s(self) -> float:
        if self._ewma_dt is None:
            return self.max_s
        return float(
            min(self.max_s, max(self.min_s, self.target_rows * self._ewma_dt))
        )


class ClusterHandle:
    """Future for one submitted request; completed exactly once."""

    __slots__ = ("model", "request_id", "n_rows", "_event", "_lock",
                 "_value", "_error")

    def __init__(self, model: str, request_id: int, n_rows: int) -> None:
        self.model = model
        self.request_id = request_id
        self.n_rows = n_rows
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._value: np.ndarray | None = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> np.ndarray:
        """Block until the request completes; raises its failure if any."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.model}:{self.request_id} not completed "
                f"within {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._value

    # first writer wins: a re-routed request may race its original
    # replica (kill mid-flush); both compute identical bits, but counters
    # and records must tally it once.
    def _complete(self, value: np.ndarray) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._value = value
            self._event.set()
            return True

    def _fail(self, error: BaseException) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._error = error
            self._event.set()
            return True


@dataclass
class _Pending:
    """One admitted request waiting in a model queue (or in a job)."""

    handle: ClusterHandle
    q_bins: np.ndarray
    t_enqueue: float


@dataclass
class _Job:
    """A coalesced batch of requests routed to one replica."""

    model: str
    requests: list[_Pending]
    attempt: int = 0

    @property
    def n_rows(self) -> int:
        return sum(p.handle.n_rows for p in self.requests)


class _InjectedCrash(RuntimeError):
    pass


class Replica:
    """One serving replica: replicated registry + worker thread + liveness.

    The worker drains ``inbox`` jobs, flushes them through a per-model
    ``MicroBatcher`` (rebuilt on hot-swap version bumps, same discipline
    as ``ServeLoop``), and beats its heartbeat file between jobs and on
    idle wakeups.  Injection flags simulate the failure envelope:
    ``crash`` raises on the next job (fail-stop with a live supervisor),
    ``hang`` stops both processing and beating (silent death — only the
    heartbeat timeout discovers it), ``delay_s`` slows every flush
    (straggler).  On a CUDA device the replica's flushes run on its own
    stream.
    """

    def __init__(
        self,
        server: "ClusterServer",
        replica_id: int,
        run_dir: str,
        *,
        heartbeat_timeout_s: float,
        beat_interval_s: float,
    ) -> None:
        self.id = replica_id
        self.registry = TableRegistry(
            chip_spec=server.chip_spec, deploy=server.deploy,
            **({"mesh": server.mesh} if server.mesh is not None else {"device": server.device}),
        )
        self.stream = (
            torch.cuda.Stream(device=server.device)
            if server.device.type == "cuda" else None
        )
        self.state = ALIVE
        self.inbox: queue.Queue = queue.Queue()
        self.heartbeat = Heartbeat(
            run_dir, replica_id, timeout_s=heartbeat_timeout_s
        )
        self.served_requests = 0
        self.served_rows = 0
        self.n_flushes = 0
        self.delay_s = 0.0
        self._beat_interval_s = beat_interval_s
        self._server = server
        self._crash = threading.Event()
        self._hang = threading.Event()
        self._inflight: _Job | None = None
        self._batchers: dict[str, MicroBatcher] = {}
        self._versions: dict[str, int] = {}
        self._thread = threading.Thread(
            target=self._run, name=f"xtime-replica-{replica_id}", daemon=True
        )

    def start(self) -> None:
        self.heartbeat.beat()
        self._thread.start()

    # -- worker loop ---------------------------------------------------------

    def _run(self) -> None:
        while True:
            if self._hang.is_set():
                # silent death: stop beating AND stop draining the inbox;
                # the monitor's heartbeat timeout is the only way out
                time.sleep(self._beat_interval_s)
                continue
            try:
                job = self.inbox.get(timeout=self._beat_interval_s)
            except queue.Empty:
                # a replica killed (hung) while it waited stays silent: the
                # server may already have removed its run dir
                if not self._hang.is_set():
                    self.heartbeat.beat()
                continue
            if job is None:  # shutdown sentinel
                return
            if self._hang.is_set():
                # hung between get() and processing: hand the job back
                self._server._requeue_job(job)
                continue
            if self._crash.is_set():
                self._server._replica_failed(
                    self, job, _InjectedCrash(f"replica {self.id} crashed")
                )
                return  # fail-stop: the thread dies with the "process"
            self._inflight = job
            try:
                self._process(job)
            except Exception as exc:  # noqa: BLE001 - any failure fails over
                self._inflight = None
                self._server._replica_failed(self, job, exc)
                return
            self._inflight = None
            self.heartbeat.beat()

    def _batcher(self, model: str) -> tuple[MicroBatcher, ServedModel]:
        entry = self.registry.get(model)
        # hot swap: a version bump invalidates the cached batcher (it
        # holds the old engine).  Jobs are flushed whole, so there is
        # never pending state to migrate.
        if (
            model not in self._batchers
            or self._versions.get(model) != entry.version
        ):
            self._batchers[model] = MicroBatcher.for_engine(
                entry.engine,
                max_batch=self._server.max_batch,
                kind=self._server.kind,
            )
            self._versions[model] = entry.version
        return self._batchers[model], entry

    def _process(self, job: _Job) -> None:
        t0 = time.perf_counter()
        if self.delay_s > 0.0:
            time.sleep(self.delay_s)  # injected straggler: counts as flush time
        batcher, _ = self._batcher(job.model)
        for p in job.requests:
            batcher.submit(
                p.q_bins, t_enqueue=p.t_enqueue,
                request_id=p.handle.request_id,
            )
        with (torch.cuda.stream(self.stream) if self.stream is not None
              else contextlib.nullcontext()):
            results = batcher.flush()  # ends with the D2H copy on this stream
        dt = time.perf_counter() - t0
        self.n_flushes += 1
        self._server._job_done(self, job, results, dt)


class ClusterServer:
    """Replicated async serving cluster (see module docstring).

    Args:
      n_replicas: serving replicas, each with a full registry copy.
      device / mesh / chip_spec / deploy: forwarded to every replica's
        ``TableRegistry``; ``device`` (``None``: the card) or ``mesh``
        (exclusive with it) is shared by all replicas, each on its own
        stream of that device (of the mesh's first device).
      kind: 'predict' (bit-equal contract) or 'margin'.
      flush_rows: coalescing bucket target — a model's queue flushes when
        it holds this many rows (same meaning as ``ServeLoop``).
      max_batch: per-flush row cap and the batcher's bucket ceiling.
      window: ``AdaptiveWindow`` template; each model gets its own copy
        (``target_rows`` defaults to ``flush_rows``).
      max_queue_rows: per-model admission bound; beyond it ``submit``
        raises ``ShedError``.
      heartbeat_timeout_s: silence threshold after which a replica is
        declared dead.  Workers beat every ``heartbeat_timeout_s / 4``.
      straggler: shared EWMA ``StragglerMonitor`` settings (per-row
        flush times); a replica collecting ``straggler_strikes``
        CONSECUTIVE flags is excluded from routing.
      max_attempts: retry budget per job across replica failures.
    """

    def __init__(
        self,
        *,
        n_replicas: int = 2,
        device=None,
        mesh=None,
        chip_spec=None,
        deploy=None,
        kind: str = "predict",
        flush_rows: int = 256,
        max_batch: int = 1024,
        window: AdaptiveWindow | None = None,
        max_queue_rows: int = 8192,
        heartbeat_timeout_s: float = 2.0,
        straggler_threshold: float = 5.0,
        straggler_alpha: float = 0.2,
        straggler_strikes: int = 3,
        monitor_interval_s: float = 0.05,
        max_attempts: int = 3,
        run_dir: str | None = None,
        clock: Callable[[], float] = time.perf_counter,
        history: int = 100_000,
    ) -> None:
        if n_replicas < 1:
            raise ValueError("need at least one replica")
        self.mesh = None if mesh is None else check_mesh(mesh)
        if mesh is not None and device is not None:
            raise ValueError("pass device= or mesh=, not both")
        self.device = mesh.devices.flat[0] if mesh is not None else resolve_device(device)
        self.chip_spec = chip_spec
        self.deploy = deploy
        self.kind = kind
        self.flush_rows = flush_rows
        self.max_batch = max_batch
        self.max_queue_rows = max_queue_rows
        self.max_attempts = max_attempts
        self.clock = clock
        self._window_template = window or AdaptiveWindow(target_rows=flush_rows)
        self._owns_run_dir = run_dir is None
        self.run_dir = run_dir or tempfile.mkdtemp(prefix="xtime-cluster-")
        self._hb_timeout_s = heartbeat_timeout_s
        self._beat_interval_s = heartbeat_timeout_s / 4.0
        self._monitor_interval_s = monitor_interval_s
        # shared across replicas: a straggler is slow vs the CLUSTER's
        # recent flush times, not vs its own (self-referenced baselines
        # let a uniformly slow replica hide)
        self.straggler = StragglerMonitor(
            threshold=straggler_threshold, ewma_alpha=straggler_alpha
        )
        self.straggler_strikes = straggler_strikes
        self._strikes: dict[int, int] = {}
        self._flush_seq = itertools.count()

        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._queues: dict[str, deque[_Pending]] = {}
        self._queue_rows: dict[str, int] = {}
        self._windows: dict[str, AdaptiveWindow] = {}
        self._shed: dict[str, int] = {}
        self._records: deque[RequestRecord] = deque(maxlen=history)
        self._n_flushes: dict[str, int] = {}
        self._outstanding = 0
        self._failovers = 0
        self._next_rid = itertools.count()
        self._closed = False
        # catalog of live registrations, for elastic restore: name ->
        # (artifact, deploy, batching) as registered on the primary
        self._catalog: dict[str, tuple] = {}

        # liveness observer (reads every worker file in run_dir)
        self._observer = Heartbeat(self.run_dir, -1, timeout_s=heartbeat_timeout_s)
        self.replicas: dict[int, Replica] = {}
        for rid in range(n_replicas):
            self.replicas[rid] = self._new_replica(rid)
        self._rr = itertools.cycle(sorted(self.replicas))
        for r in self.replicas.values():
            r.start()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="xtime-dispatch", daemon=True
        )
        self._dispatcher.start()

    def _new_replica(self, rid: int) -> Replica:
        return Replica(
            self, rid, self.run_dir,
            heartbeat_timeout_s=self._hb_timeout_s,
            beat_interval_s=self._beat_interval_s,
        )

    # -- lifecycle -----------------------------------------------------------

    def __enter__(self) -> "ClusterServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop dispatcher and workers; outstanding handles are failed."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pending = [
                p for qd in self._queues.values() for p in qd
            ]
            self._queues.clear()
            self._queue_rows.clear()
            self._cond.notify_all()
        for p in pending:
            if p.handle._fail(ClusterClosed("server closed")):
                with self._lock:
                    self._outstanding -= 1
        for r in self.replicas.values():
            r.inbox.put(None)
        self._dispatcher.join(timeout=5.0)
        for r in self.replicas.values():
            r._thread.join(timeout=1.0)  # hung replicas are daemon threads
        if self._owns_run_dir:
            shutil.rmtree(self.run_dir, ignore_errors=True)

    # -- registration (replicated) -------------------------------------------

    def register(self, name: str, model, **kw) -> ServedModel:
        """Install ``model`` on EVERY replica (compile once, install N).

        The first live replica is the primary: it runs the full
        ``TableRegistry.register`` path (compiling if needed); the
        resulting artifact is installed as-is on the other replicas —
        same table bits, so any replica serves bit-equal predictions.
        """
        with self._lock:
            if self._closed:
                raise ClusterClosed("server closed")
            order = [
                r for r in self.replicas.values() if r.state != DEAD
            ]
            if not order:
                raise RuntimeError("no live replicas to register on")
            primary, rest = order[0], order[1:]
        entry = primary.registry.register(name, model, **kw)
        for r in rest:
            r.registry.register(
                name, entry.artifact, batching=entry.batching,
                deploy=entry.deploy,
            )
        with self._lock:
            self._catalog[name] = (entry.artifact, entry.deploy, entry.batching)
            self._windows.setdefault(
                name,
                AdaptiveWindow(
                    min_s=self._window_template.min_s,
                    max_s=self._window_template.max_s,
                    target_rows=self._window_template.target_rows,
                    alpha=self._window_template.alpha,
                ),
            )
        return entry

    def models(self) -> list[str]:
        with self._lock:
            return sorted(self._catalog)

    # -- fault injection / elasticity ---------------------------------------

    def inject_crash(self, replica_id: int) -> None:
        """Fail-stop the replica on its next job (supervised crash)."""
        self.replicas[replica_id]._crash.set()

    def inject_hang(self, replica_id: int) -> None:
        """Silence the replica: no processing, no heartbeats.  Only the
        heartbeat timeout discovers it (the unsupervised death mode)."""
        self.replicas[replica_id]._hang.set()

    def inject_delay(self, replica_id: int, delay_s: float) -> None:
        """Slow every flush on the replica by ``delay_s`` (straggler)."""
        self.replicas[replica_id].delay_s = float(delay_s)

    def kill_replica(self, replica_id: int) -> None:
        """Immediately declare the replica dead and re-route its work."""
        with self._lock:
            replica = self.replicas[replica_id]
            replica._hang.set()  # stop it touching anything further
            self._mark_dead_locked(replica)
            self._cond.notify_all()

    def restore_replica(self, replica_id: int) -> Replica:
        """Elastic restart boundary: bring a dead/excluded replica back.

        A FRESH replica object re-registers the current catalog (the
        artifacts live registrations point at — not whatever the dead
        registry last held) and rejoins the routing rotation.
        """
        with self._lock:
            if self._closed:
                raise ClusterClosed("server closed")
            old = self.replicas.get(replica_id)
            if old is not None and old.state == ALIVE:
                raise ValueError(f"replica {replica_id} is already alive")
            catalog = dict(self._catalog)
        replica = self._new_replica(replica_id)
        for name, (artifact, deploy, batching) in catalog.items():
            replica.registry.register(
                name, artifact, deploy=deploy, batching=batching
            )
        replica.start()
        with self._lock:
            self.replicas[replica_id] = replica
            self._strikes[replica_id] = 0
            self._cond.notify_all()
        return replica

    # -- intake --------------------------------------------------------------

    def submit(self, model: str, q_bins: np.ndarray) -> ClusterHandle:
        """Admit one request; returns a ``ClusterHandle`` future.

        Raises ``ShedError`` when the model's queue is at capacity
        (explicit backpressure), ``KeyError`` for an unregistered model,
        ``ClusterClosed`` after shutdown.  Never blocks on the engine.
        """
        q = np.array(q_bins)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[0] == 0:
            raise ValueError(f"expected (b, F) query rows, got shape {q.shape}")
        now = self.clock()
        with self._lock:
            if self._closed:
                raise ClusterClosed("server closed")
            if model not in self._catalog:
                raise KeyError(
                    f"unknown model {model!r}; registered: {self.models()}"
                )
            rows = self._queue_rows.get(model, 0)
            if rows + q.shape[0] > self.max_queue_rows:
                self._shed[model] = self._shed.get(model, 0) + 1
                raise ShedError(
                    f"model {model!r} queue at {rows}/{self.max_queue_rows} "
                    f"rows; request of {q.shape[0]} rows shed"
                )
            handle = ClusterHandle(model, next(self._next_rid), q.shape[0])
            self._queues.setdefault(model, deque()).append(
                _Pending(handle, q, now)
            )
            self._queue_rows[model] = rows + q.shape[0]
            self._windows[model].observe(now, q.shape[0])
            self._outstanding += 1
            self._cond.notify_all()
        return handle

    def drain(self, timeout: float = 30.0) -> None:
        """Force-flush every queue and block until nothing is outstanding."""
        deadline = time.monotonic() + timeout
        with self._lock:
            self._force_flush = True
            self._cond.notify_all()
            while self._outstanding > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"{self._outstanding} requests still outstanding "
                        f"after {timeout}s"
                    )
                self._cond.wait(timeout=min(remaining, 0.05))
            self._force_flush = False

    _force_flush = False

    # -- dispatcher ----------------------------------------------------------

    def _live_replicas(self) -> list[Replica]:
        return [r for r in self.replicas.values() if r.state == ALIVE]

    def _route_locked(self, job: _Job) -> bool:
        """Round-robin the job to the next live replica; False if none."""
        live = self._live_replicas()
        if not live:
            return False
        for _ in range(len(self.replicas)):
            rid = next(self._rr)
            replica = self.replicas.get(rid)
            if replica is not None and replica.state == ALIVE:
                replica.inbox.put(job)
                return True
        live[0].inbox.put(job)  # rotation missed (membership changed)
        return True

    def _pop_jobs_locked(self, now: float) -> list[_Job]:
        if not self._live_replicas():
            return []  # park everything until a restore/monitor pass
        jobs: list[_Job] = []
        for model, qd in self._queues.items():
            if any(p.handle.done() for p in qd):
                # requeued copies that lost the completion race to their
                # original replica: drop them instead of re-serving
                qd = self._queues[model] = deque(
                    p for p in qd if not p.handle.done()
                )
                self._queue_rows[model] = sum(p.handle.n_rows for p in qd)
            if not qd:
                continue
            window = self._windows[model].window_s
            rows = self._queue_rows.get(model, 0)
            expired = now - qd[0].t_enqueue >= window
            if not (rows >= self.flush_rows or expired or self._force_flush):
                continue
            while qd:
                batch: list[_Pending] = [qd.popleft()]
                n = batch[0].handle.n_rows
                while qd and n + qd[0].handle.n_rows <= self.max_batch:
                    p = qd.popleft()
                    batch.append(p)
                    n += p.handle.n_rows
                jobs.append(_Job(model, batch))
                # below the flush target and not forced: leave the rest
                # to coalesce further (only the expired/full head goes)
                remaining = sum(p.handle.n_rows for p in qd)
                if remaining < self.flush_rows and not self._force_flush:
                    break
            self._queue_rows[model] = sum(p.handle.n_rows for p in qd)
        return jobs

    def _next_deadline_locked(self, now: float) -> float:
        timeout = self._monitor_interval_s
        if not self._live_replicas():
            return timeout  # nothing to dispatch to; just keep monitoring
        for model, qd in self._queues.items():
            if qd:
                due = qd[0].t_enqueue + self._windows[model].window_s - now
                timeout = min(timeout, max(due, 0.0))
        return timeout

    def _dispatch_loop(self) -> None:
        last_monitor = 0.0
        while True:
            try:
                with self._cond:
                    if self._closed:
                        return
                    timeout = self._next_deadline_locked(self.clock())
                    if timeout > 0:
                        self._cond.wait(timeout=timeout)
                    if self._closed:
                        return
                    for job in self._pop_jobs_locked(self.clock()):
                        if not self._route_locked(job):
                            # no live replica: park the job at the front
                            qd = self._queues.setdefault(job.model, deque())
                            qd.extendleft(reversed(job.requests))
                            self._queue_rows[job.model] = sum(
                                p.handle.n_rows for p in qd
                            )
                now = time.monotonic()
                if now - last_monitor >= self._monitor_interval_s:
                    last_monitor = now
                    self._monitor_liveness()
            except Exception:  # noqa: BLE001 - dispatcher must survive
                log.exception("dispatcher iteration failed; continuing")
                time.sleep(self._monitor_interval_s)

    # -- failure handling ----------------------------------------------------

    def _monitor_liveness(self) -> None:
        """Heartbeat sweep: declare silent replicas dead, re-route work."""
        dead = set(self._observer.dead_workers())
        if not dead:
            return
        with self._lock:
            for rid in dead:
                replica = self.replicas.get(rid)
                if replica is not None and replica.state == ALIVE:
                    log.warning(
                        "replica %d heartbeat stale > %.2fs: failover",
                        rid, self._hb_timeout_s,
                    )
                    self._mark_dead_locked(replica)
            self._cond.notify_all()

    def _mark_dead_locked(self, replica: Replica) -> None:
        replica.state = DEAD
        self._failovers += 1
        # reclaim everything the replica was holding: queued inbox jobs
        # and the in-flight job (incomplete requests only — completed
        # handles are first-writer-guarded)
        reclaimed: list[_Job] = []
        inflight = replica._inflight
        if inflight is not None:
            reclaimed.append(inflight)
        while True:
            try:
                job = replica.inbox.get_nowait()
            except queue.Empty:
                break
            if job is not None:
                reclaimed.append(job)
        for job in reclaimed:
            self._requeue_job_locked(job)

    def _replica_failed(
        self, replica: Replica, job: _Job, exc: BaseException
    ) -> None:
        """Worker-thread callback: fail-stop crash during/with a job."""
        log.warning("replica %d failed (%s): failover", replica.id, exc)
        with self._lock:
            if replica.state == ALIVE:
                self._mark_dead_locked(replica)
            self._requeue_job_locked(job)
            self._cond.notify_all()

    def _requeue_job(self, job: _Job) -> None:
        with self._lock:
            self._requeue_job_locked(job)
            self._cond.notify_all()

    def _requeue_job_locked(self, job: _Job) -> None:
        """Return a job's incomplete requests to the FRONT of the queue.

        Requeued work bypasses admission control — the request was
        already accepted; shedding it now would turn a replica failure
        into a correctness-visible loss.  ``max_attempts`` bounds the
        retries instead.
        """
        job.attempt += 1
        alive = [p for p in job.requests if not p.handle.done()]
        if not alive:
            return
        if job.attempt >= self.max_attempts:
            for p in alive:
                if p.handle._fail(
                    FailedRequest(
                        f"request {p.handle.request_id} failed on "
                        f"{job.attempt} replicas"
                    )
                ):
                    self._outstanding -= 1
            self._cond.notify_all()
            return
        qd = self._queues.setdefault(job.model, deque())
        qd.extendleft(reversed(alive))
        self._queue_rows[job.model] = sum(p.handle.n_rows for p in qd)

    # -- completion ----------------------------------------------------------

    def _job_done(
        self,
        replica: Replica,
        job: _Job,
        results: dict[int, np.ndarray],
        flush_dt: float,
    ) -> None:
        t_done = self.clock()
        completed = 0
        records = []
        for p in job.requests:
            out = results.get(p.handle.request_id)
            if out is None:  # pragma: no cover - batcher contract violation
                continue
            if p.handle._complete(out):
                completed += 1
                records.append(
                    RequestRecord(
                        job.model, p.handle.request_id, p.handle.n_rows,
                        p.t_enqueue, t_done,
                    )
                )
        with self._lock:
            replica.served_requests += completed
            replica.served_rows += sum(r.n_rows for r in records)
            self._records.extend(records)
            self._n_flushes[job.model] = self._n_flushes.get(job.model, 0) + 1
            self._outstanding -= completed
            # shared straggler accounting, normalized PER ROW: flush wall
            # time scales with batch size, so a raw-dt baseline set by
            # small paced flushes would false-flag every big burst flush
            if self.straggler.record(
                next(self._flush_seq), flush_dt / max(1, job.n_rows)
            ):
                # strikes must be CONSECUTIVE: sporadic blips (a first
                # flush, a host hiccup) reset below; a genuinely
                # slow replica flags on every flush and keeps the streak
                strikes = self._strikes.get(replica.id, 0) + 1
                self._strikes[replica.id] = strikes
                if (
                    strikes >= self.straggler_strikes
                    and replica.state == ALIVE
                    and len(self._live_replicas()) > 1
                ):
                    log.warning(
                        "replica %d excluded after %d straggler flags "
                        "(last flush %.4fs/row vs EWMA %.4fs/row)",
                        replica.id, strikes,
                        flush_dt / max(1, job.n_rows),
                        self.straggler.baseline or 0.0,
                    )
                    replica.state = EXCLUDED
            else:
                self._strikes[replica.id] = 0
            self._cond.notify_all()

    # -- accounting ----------------------------------------------------------

    def reset_stats(self) -> None:
        """Zero the SLO accounting window (e.g. after a warmup pass, so
        compile-time latencies don't pollute the gated percentiles)."""
        with self._lock:
            self._records.clear()
            self._n_flushes.clear()

    def stats(self, model: str | None = None) -> LatencyStats:
        """p50/p99 accounting, same type the synchronous loop reports."""
        with self._lock:
            records = [
                r for r in self._records if model is None or r.model == model
            ]
            n_flushes = (
                sum(self._n_flushes.values())
                if model is None
                else self._n_flushes.get(model, 0)
            )
        return LatencyStats.from_records(records, n_flushes)

    def report(self, model: str | None = None) -> dict:
        """Cluster health + SLO accounting in one dict."""
        s = self.stats(model)
        with self._lock:
            return {
                "model": model,
                "measured": {
                    "requests": s.n_requests,
                    "rows": s.n_rows,
                    "p50_ms": round(s.p50_ms, 3),
                    "p99_ms": round(s.p99_ms, 3),
                    "mean_ms": round(s.mean_ms, 3),
                    "requests_per_s": round(s.requests_per_s, 1),
                    "samples_per_s": round(s.samples_per_s, 1),
                    "flushes": s.n_flushes,
                },
                "shed": dict(self._shed),
                "failovers": self._failovers,
                "straggler_events": len(self.straggler.events),
                "windows_ms": {
                    m: round(w.window_s * 1e3, 3)
                    for m, w in self._windows.items()
                },
                "queue_rows": {
                    m: n for m, n in self._queue_rows.items() if n
                },
                "replicas": {
                    r.id: {
                        "state": r.state,
                        "served_requests": r.served_requests,
                        "served_rows": r.served_rows,
                        "flushes": r.n_flushes,
                    }
                    for r in self.replicas.values()
                },
            }
