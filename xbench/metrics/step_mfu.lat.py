"""The whole window's share of the card's peak in the latency cells (``readers.step_mfu``)."""

from xbench.readers import step_mfu


def read(rec):
    return step_mfu(rec)
