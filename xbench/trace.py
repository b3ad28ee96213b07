"""The device trace of a ``--trace 1`` run, and its reduction.

``Tracer`` runs ``torch.profiler`` (host and CUDA activity) over the
measured window, with the window itself marked as a host span. ``reduce``
turns the raw events into what the per-layer readers need: the device's
busy time (the union of every kernel, copy and fill on the card), each
kernel's time and launch count by name, and the longest idle gaps, each
named by the innermost host span that covered it.
"""

from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field

import numpy as np

WINDOW = "xbench.window"


@dataclass(frozen=True)
class Event:
    name: str
    on_device: bool
    start_ns: int
    end_ns: int


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)  # device op name -> seconds
    kernel_n: dict = field(default_factory=dict)  # device op name -> launches
    idle_gaps: list = field(default_factory=list)  # [[host span, seconds], ...]

    def seconds_of(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(s for n, s in self.kernel_s.items() if rx.search(n))

    def launches_of(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(c for n, c in self.kernel_n.items() if rx.search(n))

    def device_ops(self, top: int = 10) -> list:
        return [[n, s] for n, s in sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]]


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:  # drop the parenthesised arguments, keep template args
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip()[:120]


def reduce(events: list[Event], *, top: int = 10) -> TraceSummary:
    """Busy time, per-kernel sums and idle gaps inside the ``WINDOW`` span."""
    marks = [e for e in events if not e.on_device and e.name == WINDOW]
    if not marks:
        raise ValueError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = marks[0].start_ns, marks[0].end_ns
    dev = sorted(
        (max(e.start_ns, w0), min(e.end_ns, w1), e.name)
        for e in events if e.on_device and e.end_ns > w0 and e.start_ns < w1
    )
    busy, gaps, cursor = 0, [], w0
    kernel_s: dict[str, float] = {}
    kernel_n: dict[str, int] = {}
    for s, e, name in dev:
        key = short_name(name)
        kernel_s[key] = kernel_s.get(key, 0.0) + (e - s) * 1e-9
        kernel_n[key] = kernel_n.get(key, 0) + 1
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if cursor < w1:
        gaps.append((cursor, w1))
    host = [e for e in events if not e.on_device and e.name != WINDOW]
    h0 = np.array([h.start_ns for h in host], dtype=np.int64)
    h1 = np.array([h.end_ns for h in host], dtype=np.int64)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for g0, g1 in longest:
        mid = (g0 + g1) // 2
        cover = np.flatnonzero((h0 <= mid) & (h1 > mid))
        label = (host[cover[np.argmin(h1[cover] - h0[cover])]].name if cover.size
                 else "host: no span")
        named.append([label, (g1 - g0) * 1e-9])
    return TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                        kernel_s=kernel_s, kernel_n=kernel_n, idle_gaps=named)


class Tracer:
    """``with Tracer(on): ...`` around a window; ``summary()`` after it.
    Off, it marks nothing and costs nothing."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled
        self._prof = None
        self._mark = None

    def __enter__(self) -> "Tracer":
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile, record_function

            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._mark = record_function(WINDOW)
            self._mark.__enter__()
            self._torch = torch
        return self

    def __exit__(self, *exc) -> None:
        if self.enabled:
            self._torch.cuda.synchronize()
            self._mark.__exit__(None, None, None)
            self._prof.__exit__(None, None, None)

    def span(self, name: str):
        """A host span around a call into one of the program's layers, in a
        traced run (it names the idle gaps); nothing otherwise."""
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def events(self) -> list[Event]:
        out = []
        for e in self._prof.profiler.kineto_results.events():
            on_device = not str(e.device_type()).endswith("CPU")
            if on_device and e.is_user_annotation():
                continue  # the device-side copy of a host span, not work on the card
            start = int(e.start_ns())
            out.append(Event(e.name(), on_device, start, start + int(e.duration_ns())))
        return out

    def summary(self) -> TraceSummary | None:
        return reduce(self.events()) if self.enabled else None
