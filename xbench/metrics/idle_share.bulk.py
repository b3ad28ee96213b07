"""The card's idle share of the traced window in the bulk cells (``readers.idle_share``)."""

from xbench.readers import idle_share


def read(rec):
    return idle_share(rec)
