"""Host ms a ``raw_margin`` call spends in the kernel's wrapper (its
checks, workspaces and launch): the program's ``engine.launch`` span, its
total / calls.  Span durations are host-clock readings that
``repro_torch.spans`` keeps for the traced window; None where the program
has no spans or their count is not the driver's count of calls."""


def read(rec):
    try:
        from repro_torch.spans import totals
    except ImportError:  # a program without spans
        return None
    t, n = totals().get("engine.launch", {}), rec.counters.get("calls")
    if rec.trace is None or not n or t.get("count") != n:
        return None
    return 1e-6 * t["total_ns"] / n
