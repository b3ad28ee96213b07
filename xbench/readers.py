"""Arithmetic the per-layer readers share (each metric's own file in
``xbench/metrics/`` names which of these it reads and on what)."""

from __future__ import annotations

from xbench.workcount import least_seconds

# the program's CAM kernels (cam_match.cu, cam_match_soft.cu,
# cam_match_common.cuh): every launch of a call, and the main one alone
CAM_KERNELS = r"cam_match|reduce_splits|live_tiles"
MAIN_CAM = r"cam_match\w*_kernel"


def cam_roofline(rec) -> float | None:
    """The least time for the launches' work over the CAM kernels' device
    time, in %."""
    if rec.trace is None or rec.peak is None:
        return None
    seconds, launches = rec.trace.seconds_of(CAM_KERNELS), rec.trace.launches_of(MAIN_CAM)
    if seconds <= 0 or launches == 0:
        return None
    return 100.0 * least_seconds(rec.cfg, rec.counters["rows"], launches, rec.peak) / seconds


def step_mfu(rec) -> float | None:
    """The least time for the window's work over the window's wall time, in %."""
    if rec.peak is None or rec.counters["launches"] == 0:
        return None
    c = rec.counters
    return 100.0 * least_seconds(rec.cfg, c["rows"], c["launches"], rec.peak) / c["wall_s"]


def idle_share(rec) -> float | None:
    """The share of the traced window in which nothing ran on the card, in %."""
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)


def host_ms_per(rec, counter: str) -> float | None:
    """(traced window - device busy time) / ``counter``, in ms: the host's
    time a chunk or a call beyond what the card was busy."""
    if rec.trace is None or not rec.counters.get(counter):
        return None
    return 1e3 * (rec.trace.window_s - rec.trace.busy_s) / rec.counters[counter]
