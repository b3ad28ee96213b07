"""Host ms a ``score_file`` chunk spends staging its queries: the wait for
the pinned slot, the copy into it and the enqueue of the copy to the card.
The program's ``score.stage`` span, its total / chunks.  Span durations
are host-clock readings that ``repro_torch.spans`` keeps for the traced
window; None where the program has no spans or their count is not the
driver's count of chunks."""


def read(rec):
    try:
        from repro_torch.spans import totals
    except ImportError:  # a program without spans
        return None
    t, n = totals().get("score.stage", {}), rec.counters.get("chunks")
    if rec.trace is None or not n or t.get("count") != n:
        return None
    return 1e-6 * t["total_ns"] / n
