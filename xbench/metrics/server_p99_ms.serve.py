"""The server's own p99 from enqueue to done (``ClusterServer.stats()``,
unrounded); beside ``p99_ms``, which runs from the due time, it splits the
time before intake from the time inside the server."""


def read(rec):
    return rec.counters.get("server_p99_ms")
