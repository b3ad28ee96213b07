"""The share of ``raw_margin`` calls whose queries found the engine's
staging slot ready, in %: 100 x (the ``engine.stage`` spans - the
``engine.stage_alloc`` spans, which open where a slot is made or grown) /
calls.  Span counts are kept by ``repro_torch.spans`` for the traced
window; None where the program has no spans or its ``engine.stage``
count is not the run's ``calls`` counter (a program that stages no
queries)."""


def read(rec):
    try:
        from repro_torch.spans import totals
    except ImportError:  # a program without spans
        return None
    t, n = totals(), rec.counters.get("calls")
    if rec.trace is None or not n or t.get("engine.stage", {}).get("count") != n:
        return None
    return 100.0 * (n - t.get("engine.stage_alloc", {}).get("count", 0)) / n
