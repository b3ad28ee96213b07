"""Host ms a ``score_file`` chunk, from the program's own spans: (the
``score.chunk`` spans' total - the ``score.wait`` spans', where the host
waits for the card) / chunks.  The inside counterpart of
``host_ms_per_chunk.bulk``.  Span durations are host-clock readings that
``repro_torch.spans`` keeps for the traced window; None where the program
has no spans or their count is not the driver's count of chunks."""


def read(rec):
    try:
        from repro_torch.spans import totals
    except ImportError:  # a program without spans
        return None
    t, n = totals(), rec.counters.get("chunks")
    if rec.trace is None or not n:
        return None
    if any(t.get(k, {}).get("count") != n for k in ("score.chunk", "score.wait")):
        return None
    return 1e-6 * (t["score.chunk"]["total_ns"] - t["score.wait"]["total_ns"]) / n
