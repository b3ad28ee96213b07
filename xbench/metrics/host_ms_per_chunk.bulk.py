"""Host ms a ``score_file`` chunk beyond the card's busy time (``readers.host_ms_per``)."""

from xbench.readers import host_ms_per


def read(rec):
    return host_ms_per(rec, "chunks")
