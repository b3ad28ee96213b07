"""The port's spans (``repro_torch.spans``) on the CPU: nothing recorded
and no profiler op made while no profiler records; under
``torch.profiler`` the stages of ``score_file`` and ``raw_margin`` counted
a chunk and a call, nested as the code nests them, on the profiler's own
clock; each profiled window starting afresh; one stack a thread."""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import repro_torch
from repro_torch import spans
from repro_torch.core.trees import random_deep_ensemble
from repro_torch.score import score_file

N_ROWS = 301


def off_path():
    with spans.span("score.chunk"):
        pass


@pytest.fixture(scope="module")
def model():
    cm = repro_torch.build(random_deep_ensemble(n_trees=10, depth=4, n_features=9, n_bins=32,
                                                seed=5))
    q = np.random.default_rng(0).integers(0, 32, size=(N_ROWS, 9)).astype(np.int32)
    cm.raw_margin(q[:4], device="cpu")  # binds the engine
    return cm, q


def profiled(fn):
    """``fn()`` under a CPU profiler inside an outer range, as a window of
    its own (a span finds the profiler off just before); returns its
    result, ``spans.totals()`` and the window's kineto events."""
    off_path()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            out = fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()]
    return out, spans.totals(), events


def test_profiler_off_records_nothing_and_makes_no_range(model, monkeypatch):
    cm, q = model
    profiled(off_path)
    before = spans.totals()

    def no_range(name):
        raise AssertionError(f"a profiler range {name!r} was made with no profiler on")

    monkeypatch.setattr(spans, "_Range", no_range)
    assert spans.span("score.chunk") is spans.span("api.raw_margin")  # the shared null context
    score_file(cm, q, chunk_rows=64, device="cpu")
    cm.raw_margin(q, device="cpu")
    assert spans.totals() == before


@pytest.mark.parametrize("chunk_rows", [1, 64, 100, N_ROWS, 1000])
def test_score_file_spans_a_chunk(model, chunk_rows):
    cm, q = model
    r, t, _ = profiled(lambda: score_file(cm, q, chunk_rows=chunk_rows, device="cpu"))
    n = r.n_chunks
    assert n == -(-N_ROWS // chunk_rows)
    assert t["score.chunk"]["count"] == n and t["score.chunk"]["parents"] == {None: n}
    for stage in ("score.prep", "score.stage", "score.wait"):
        assert t[stage]["count"] == n and t[stage]["parents"] == {"score.chunk": n}
    assert t["engine.launch"]["parents"] == {"score.wait": n}
    for v in t.values():
        assert 0 <= v["self_ns"] <= v["total_ns"]
    chunk = t["score.chunk"]
    assert chunk["total_ns"] - chunk["self_ns"] == sum(
        t[s]["total_ns"] for s in ("score.prep", "score.stage", "score.wait"))
    assert "api.raw_margin" not in t


@pytest.mark.parametrize("calls", [1, 3])
def test_raw_margin_spans_a_call(model, calls):
    cm, q = model
    outs, t, _ = profiled(lambda: [cm.raw_margin(q, device="cpu") for _ in range(calls)])
    assert all(o.shape == (N_ROWS, cm.table.n_outputs) for o in outs)
    assert t["api.raw_margin"]["count"] == calls
    assert t["api.raw_margin"]["parents"] == {None: calls}
    for child in ("engine.prep", "engine.launch", "api.fetch"):
        assert t[child]["count"] == calls and t[child]["parents"] == {"api.raw_margin": calls}
    call = t["api.raw_margin"]
    assert call["total_ns"] - call["self_ns"] == sum(
        t[s]["total_ns"] for s in ("engine.prep", "engine.launch", "api.fetch"))
    assert set(t) == {"api.raw_margin", "engine.prep", "engine.launch", "api.fetch"}


@pytest.mark.parametrize("path", ["score_file", "raw_margin"])
def test_ranges_share_the_profilers_clock(model, path):
    """Every ``repro_torch.*`` range is a kineto event inside the outer
    range, one for each span counted, and children lie inside parents."""
    cm, q = model
    fn = ((lambda: score_file(cm, q, chunk_rows=100, device="cpu")) if path == "score_file"
          else (lambda: cm.raw_margin(q, device="cpu")))
    _, t, events = profiled(fn)
    (o0, o1), = [(s, e) for n, s, e in events if n == "outer"]
    ours = [(n[len(spans.PREFIX):], s, e) for n, s, e in events if n.startswith(spans.PREFIX)]
    assert {n: sum(1 for m, _, _ in ours if m == n) for n in t} == {
        n: v["count"] for n, v in t.items()}
    assert all(o0 <= s <= e <= o1 for _, s, e in ours)
    for child, s, e in ours:
        parents = [p for p, c in t[child]["parents"].items() if p is not None]
        for parent in parents:
            assert any(ps <= s and e <= pe for n, ps, pe in ours if n == parent)


def test_each_window_starts_afresh(model):
    cm, q = model
    _, first, _ = profiled(lambda: cm.raw_margin(q, device="cpu"))
    cm.raw_margin(q, device="cpu")  # unprofiled: found the profiler off
    _, second, _ = profiled(lambda: score_file(cm, q, chunk_rows=200, device="cpu"))
    assert first["api.raw_margin"]["count"] == 1
    assert "api.raw_margin" not in second and second["score.chunk"]["count"] == 2
    assert spans.totals() == second  # readable after the profiler stopped


def test_two_threads_keep_separate_stacks():
    """Thread A holds ``a.outer`` open while thread B opens ``b.inner``:
    B's span has no parent, and A's self time is not cut by B's span."""
    a_open, b_done = threading.Event(), threading.Event()

    def a():
        with spans.span("a.outer"):
            a_open.set()
            assert b_done.wait(10)

    def b():
        assert a_open.wait(10)
        with spans.span("b.inner"):
            with spans.span("b.leaf"):
                pass
        b_done.set()

    def run():
        threads = [threading.Thread(target=f) for f in (a, b)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(10)
        assert not any(th.is_alive() for th in threads)

    _, t, _ = profiled(run)
    assert t["a.outer"]["parents"] == {None: 1}
    assert t["a.outer"]["self_ns"] == t["a.outer"]["total_ns"]
    assert t["b.inner"]["parents"] == {None: 1}
    assert t["b.leaf"]["parents"] == {"b.inner": 1}


def test_many_threads_lose_no_update():
    n_threads, per_thread = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per_thread):
                with spans.span("stress.outer"):
                    with spans.span("stress.inner"):
                        pass

        def run():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
            assert not any(th.is_alive() for th in threads)

        _, t, _ = profiled(run)
    finally:
        sys.setswitchinterval(old)
    n = n_threads * per_thread
    assert t["stress.outer"]["count"] == n and t["stress.outer"]["parents"] == {None: n}
    assert t["stress.inner"]["count"] == n and t["stress.inner"]["parents"] == {"stress.outer": n}
    outer = t["stress.outer"]
    assert outer["total_ns"] - outer["self_ns"] == t["stress.inner"]["total_ns"]


def test_fallback_range_when_the_fast_one_is_absent(model, monkeypatch):
    """``record_function`` stands in where a build has no
    ``_RecordFunctionFast``: the same names reach the trace."""
    monkeypatch.setattr(spans, "_Range", torch.autograd.profiler.record_function)
    cm, q = model
    _, t, events = profiled(lambda: cm.raw_margin(q, device="cpu"))
    names = {n for n, _, _ in events if n.startswith(spans.PREFIX)}
    assert names == {spans.PREFIX + n for n in t} and t["api.raw_margin"]["count"] == 1


def test_span_probe_finds_each_calls_kernel_by_correlation():
    """``tools/span_probe.calls_in`` on a hand-made chrome trace: the
    kernel launched inside a call is found through its correlation id, its
    offset taken from the call's start; a call whose kernel the trace
    missed has none."""
    from repro_torch.tools.span_probe import calls_in

    def x(name, ts, dur, cat="cpu_op", **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}

    events = [x("repro_torch.api.raw_margin", 100.0, 50.0), x("repro_torch.engine.prep", 101.0, 9.0),
              x("repro_torch.engine.launch", 112.0, 8.0), x("repro_torch.api.fetch", 121.0, 28.0),
              x("cudaLaunchKernel", 115.0, 3.0, cat="cuda_runtime", correlation=7),
              x("void cam_match_u8_kernel<true, false>", 117.5, 20.0, cat="kernel", correlation=7),
              x("repro_torch.api.raw_margin", 200.0, 40.0), x("repro_torch.engine.prep", 201.0, 9.0),
              x("repro_torch.engine.launch", 211.0, 8.0), x("repro_torch.api.fetch", 220.0, 19.0),
              {"ph": "i", "name": "marker", "ts": 0.0}]
    first, second = calls_in(events)
    assert first == {"call": 50.0, "engine.prep": 1.0, "engine.launch": 12.0, "api.fetch": 21.0,
                     "kernel": 17.5, "kernel_us": 20.0, "after_launch": True}
    assert "kernel" not in second and second["engine.launch"] == 11.0
