"""Host ms a ``raw_margin`` call, from the program's own spans: (the
``api.raw_margin`` spans' total - the ``api.fetch`` spans', where the
host copies the margins back and waits for the card) / calls.  The inside
counterpart of ``host_ms_per_call.loop``.  Span durations are host-clock
readings that ``repro_torch.spans`` keeps for the traced window; None
where the program has no spans or their count is not the driver's count
of calls."""


def read(rec):
    try:
        from repro_torch.spans import totals
    except ImportError:  # a program without spans
        return None
    t, n = totals(), rec.counters.get("calls")
    if rec.trace is None or not n:
        return None
    if any(t.get(k, {}).get("count") != n for k in ("api.raw_margin", "api.fetch")):
        return None
    return 1e-6 * (t["api.raw_margin"]["total_ns"] - t["api.fetch"]["total_ns"]) / n
