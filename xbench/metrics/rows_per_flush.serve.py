"""Rows the server scored a flush in the window, from its own counters
(``ClusterServer.stats()``: rows over flushes)."""


def read(rec):
    c = rec.counters
    return c["server_rows"] / c["server_flushes"] if c.get("server_flushes") else None
