"""The port's spans: named ranges at the stage boundaries of its hot paths.

``with span("score.chunk"): ...`` marks one stage of the program.  A span
does its work only while a ``torch.profiler`` records:

  * **profiler off** — one read of the profiler's flag (and a note that
    it was off), and the shared null context comes back: no aggregate
    changes and no profiler op is made;
  * **profiler on** — a profiler range named ``repro_torch.<name>`` opens
    (``torch._C._profiler._RecordFunctionFast``, or ``record_function``
    where a build lacks it).  It lands in the same kineto event stream as
    the CUDA activity, so a span lies on the device trace's own clock: on
    the timeline, an idle gap of the card during a hot path falls inside
    a named stage.  The span also adds to an aggregate per name (count,
    total ns, self ns — the total less the time its child spans on the
    same thread cover — and how often each parent opened it).  Each
    thread keeps its own stack of open spans.

``totals()`` returns the aggregates of the latest profiled window: they
start afresh with the first span to close under the profiler after the
program last found it off, and stay readable after the profiler stops.
There is no switch of its own: run the program under ``torch.profiler``
and read ``totals()`` or the exported chrome trace.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
import torch.autograd.profiler as _profiler

PREFIX = "repro_torch."

_NULL = contextlib.nullcontext()
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None) or _profiler.record_function
_lock = threading.Lock()
_local = threading.local()
_totals: dict[str, list] = {}  # name -> [count, total ns, self ns, {parent: count}]
_stale = True  # the program last found the profiler off: the next window starts afresh


def span(name: str):
    """A context manager around one stage named ``name``; the null
    context unless a profiler records."""
    global _stale
    if not _profiler._is_profiler_enabled:
        _stale = True
        return _NULL
    return _Span(name)


def totals() -> dict[str, dict]:
    """``{name: {"count", "total_ns", "self_ns", "parents"}}`` of the
    latest profiled window; ``parents`` maps each enclosing span's name
    (``None`` at the top of a thread's stack) to how often it held this one."""
    with _lock:
        return {k: {"count": n, "total_ns": tot, "self_ns": own, "parents": dict(parents)}
                for k, (n, tot, own, parents) in _totals.items()}


class _Span:
    __slots__ = ("name", "range", "stack", "parent", "child_ns", "t0")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "_Span":
        self.range = _Range(PREFIX + self.name)
        self.range.__enter__()
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self.stack = stack
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.child_ns = 0
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        global _stale
        dt = time.perf_counter_ns() - self.t0
        self.stack.pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += dt
            parent = parent.name
        self.range.__exit__(*exc)
        with _lock:
            if _stale:
                _totals.clear()
                _stale = False
            t = _totals.get(self.name)
            if t is None:
                t = _totals[self.name] = [0, 0, 0, {}]
            t[0] += 1
            t[1] += dt
            t[2] += dt - self.child_ns
            t[3][parent] = t[3].get(parent, 0) + 1
