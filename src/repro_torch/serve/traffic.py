"""Deterministic traffic-replay load generation for the serving tier.

A copy of ``repro.serve.traffic`` (numpy only): the same seed gives the
same trace in both packages, so one request stream drives the JAX
package's loop and the port's tiers alike.

A ``TrafficTrace`` is a seeded, fully pre-computed request schedule —
heavy-tailed inter-arrival times (Lomax/Pareto-II: bursty with a long
quiet tail, the "millions of users" shape rather than a uniform drip),
Zipf-ian popularity across many models, geometric request sizes (mostly
single rows), plus named MARKS at chosen points (hot-swap a model, kill
a replica, restore one).  The same seed always yields the same trace, so
a load test is a replayable experiment: the async tier and the
synchronous ``ServeLoop`` oracle can be driven with IDENTICAL request
streams and compared bit-for-bit (tests/test_torch_cluster.py).

``replay_trace`` drives any ``submit(model, q_bins)``-shaped target —
``ClusterServer.submit``, ``ServeLoop.submit``, or a lambda — pacing
arrivals to the trace offsets time-warped by ``speed`` (``speed=0``
replays as fast as possible, for throughput measurement), and fires
``callbacks[name]()`` when a mark's offset passes.  SLO accounting stays
in ``LatencyStats`` (``repro_torch.serve.loop``): the replay returns handles;
the server's ``stats()``/``report()`` own the percentiles.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

import numpy as np


@dataclass(frozen=True)
class TrafficRequest:
    """One scheduled request: ``n_rows`` rows of ``model``'s replay
    stream starting at ``row_start``, submitted at offset ``t``."""

    t: float
    model: str
    row_start: int
    n_rows: int


@dataclass(frozen=True)
class TrafficMark:
    """A named point in the schedule (swap/kill/restore hooks)."""

    t: float
    name: str


@dataclass(frozen=True)
class TrafficTrace:
    """A reproducible request schedule (see module docstring)."""

    requests: tuple[TrafficRequest, ...]
    marks: tuple[TrafficMark, ...] = ()
    seed: int = 0

    @property
    def horizon_s(self) -> float:
        """Offset of the last scheduled event."""
        last_req = self.requests[-1].t if self.requests else 0.0
        last_mark = max((m.t for m in self.marks), default=0.0)
        return max(last_req, last_mark)

    @property
    def n_rows(self) -> int:
        return sum(r.n_rows for r in self.requests)

    def merged(self) -> list["TrafficRequest | TrafficMark"]:
        """All events in time order; marks sort before requests at a tie
        (a kill scheduled 'at' a request happens first, determinism)."""
        return sorted(
            [*self.marks, *self.requests],
            key=lambda e: (e.t, isinstance(e, TrafficRequest)),
        )


def make_trace(
    models: Sequence[str] | Mapping[str, int],
    n_requests: int,
    *,
    seed: int,
    mean_interval_s: float = 1e-3,
    tail_alpha: float = 1.8,
    zipf_exponent: float = 1.1,
    mean_rows: float = 1.3,
    max_rows: int = 8,
    stream_len: int = 1 << 30,
    marks: Sequence[tuple[float, str]] = (),
) -> TrafficTrace:
    """Build a seeded heavy-tailed trace over ``models``.

    Args:
      models: model names; a mapping gives each model its own replay
        stream length (``row_start`` wraps inside it), a sequence uses
        ``stream_len`` for all.
      n_requests: number of requests to schedule.
      seed: RNG seed — same seed, same trace, bit-for-bit.
      mean_interval_s: mean inter-arrival time.  Arrivals are Lomax
        (Pareto-II) with shape ``tail_alpha``: scale-free bursts and a
        heavy quiet tail, normalized so the MEAN stays as requested
        (requires ``tail_alpha > 1``).
      zipf_exponent: popularity skew across models (first model listed
        is the hottest); 0 = uniform.
      mean_rows / max_rows: request sizes are 1 + Geometric, capped —
        mostly single rows, occasional small batches.
      marks: ``(fraction_of_schedule, name)`` pairs; each becomes a
        ``TrafficMark`` at that fraction of the request schedule's span.
    """
    if n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    if tail_alpha <= 1.0:
        raise ValueError("tail_alpha must be > 1 (finite mean)")
    if mean_rows < 1.0:
        raise ValueError("mean_rows must be >= 1")
    names = list(models)
    lengths = (
        {m: int(models[m]) for m in names}
        if isinstance(models, Mapping)
        else {m: int(stream_len) for m in names}
    )
    rng = np.random.default_rng(seed)

    # Lomax(alpha) has mean 1/(alpha-1); rescale to the requested mean.
    gaps = rng.pareto(tail_alpha, size=n_requests)
    gaps *= mean_interval_s * (tail_alpha - 1.0)
    t = np.cumsum(gaps)

    ranks = np.arange(1, len(names) + 1, dtype=np.float64)
    probs = ranks ** -float(zipf_exponent)
    probs /= probs.sum()
    which = rng.choice(len(names), size=n_requests, p=probs)

    # Geometric(1/mean_rows) has mean mean_rows and support {1, 2, ...}:
    # mostly single rows with an occasional small batch, capped
    p = min(1.0, 1.0 / max(mean_rows, 1.0 + 1e-9))
    sizes = np.clip(rng.geometric(p, size=n_requests), 1, max_rows)

    cursor = dict.fromkeys(names, 0)
    requests = []
    for i in range(n_requests):
        model = names[which[i]]
        n = int(sizes[i])
        start = cursor[model] % lengths[model]
        cursor[model] += n
        requests.append(TrafficRequest(float(t[i]), model, start, n))

    span = float(t[-1])
    mark_events = tuple(
        TrafficMark(float(frac) * span, name) for frac, name in marks
    )
    return TrafficTrace(tuple(requests), mark_events, seed)


@dataclass
class ReplayResult:
    """Outcome of one replay: per-request handles aligned with
    ``trace.requests`` (None where the submit target shed/raised) and
    wall-clock accounting for throughput math."""

    handles: list
    shed: int
    errors: list[tuple[int, BaseException]]
    wall_s: float
    submitted: int = field(init=False)

    def __post_init__(self) -> None:
        self.submitted = sum(1 for h in self.handles if h is not None)


def replay_trace(
    submit: Callable[[str, np.ndarray], object],
    trace: TrafficTrace,
    streams: Mapping[str, np.ndarray],
    *,
    speed: float = 1.0,
    callbacks: Mapping[str, Callable[[], object]] | None = None,
    shed_exceptions: tuple[type[BaseException], ...] = (),
    clock: Callable[[], float] = time.perf_counter,
    sleep: Callable[[float], None] = time.sleep,
) -> ReplayResult:
    """Drive ``submit`` with the trace's schedule.

    Args:
      submit: ``(model, q_bins) -> handle`` — ``ClusterServer.submit``
        and ``ServeLoop.submit`` both fit.
      streams: per-model ``(N, F)`` replay data; request rows are taken
        at ``row_start`` (wrapping) so the same trace always replays the
        same bits.
      speed: time-warp factor — 2.0 replays twice as fast as recorded,
        0 disables pacing entirely (as-fast-as-possible throughput mode).
      callbacks: ``{mark_name: fn}`` fired as the schedule passes each
        mark; unknown marks are ignored (a trace with a 'kill' mark can
        also drive the oracle, which simply has nothing to kill).
      shed_exceptions: exception types counted as sheds (admission
        control) rather than re-raised — pass ``(ShedError,)`` when
        driving an overloaded cluster.
    """
    callbacks = callbacks or {}
    handles: list = []
    errors: list[tuple[int, BaseException]] = []
    shed = 0
    t0 = clock()
    for ev in trace.merged():
        if speed > 0:
            delay = (t0 + ev.t / speed) - clock()
            if delay > 0:
                sleep(delay)
        if isinstance(ev, TrafficMark):
            cb = callbacks.get(ev.name)
            if cb is not None:
                cb()
            continue
        xs = streams[ev.model]
        rows = np.take(
            xs, np.arange(ev.row_start, ev.row_start + ev.n_rows),
            axis=0, mode="wrap",
        )
        try:
            handles.append(submit(ev.model, rows))
        except shed_exceptions as exc:  # noqa: PERF203 - explicit 503 path
            shed += 1
            errors.append((len(handles), exc))
            handles.append(None)
    return ReplayResult(handles, shed, errors, clock() - t0)
