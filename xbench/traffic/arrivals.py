"""Seeded request schedules for the open-loop cells.

A copy of the program's ``repro_torch.serve.traffic.make_trace`` arithmetic
(Lomax inter-arrival gaps normalised to the requested mean, request sizes
1 + geometric, capped), cut to one model and no marks, with Poisson
arrivals added. The benchmark owns its copy, so a change to the program's
generator does not move the yardstick.

Every seed gets the same set of gaps and sizes, drawn once from a fixed
seed, in its own order: the run's seed permutes them. So the work of a
window (requests, rows, its mean rate) is the same from seed to seed, and
only the order of arrivals and sizes moves.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BASE_SEED = 20230403  # draws the one set of gaps and sizes every seed reorders


@dataclass(frozen=True)
class Schedule:
    """Requests due at ``t`` (seconds from the window's start), each of
    ``sizes`` rows taken from the row pool at ``starts`` (wrapping)."""

    t: np.ndarray  # (n,) float64, ascending
    sizes: np.ndarray  # (n,) int64
    starts: np.ndarray  # (n,) int64


def schedule(seed: int, *, rate_per_s: float, seconds: float, arrivals: str = "poisson",
             tail_alpha: float = 1.8, mean_rows: float = 1.3, max_rows: int = 8,
             pool_rows: int = 1 << 30) -> Schedule:
    """The requests due in ``[0, seconds)`` at mean rate ``rate_per_s``.

    ``arrivals``: 'poisson' (exponential gaps) or 'lomax' (Pareto-II gaps of
    shape ``tail_alpha``, scaled so the mean gap is ``1 / rate_per_s``)."""
    if rate_per_s <= 0 or seconds <= 0:
        raise ValueError("rate_per_s and seconds must be > 0")
    if mean_rows < 1.0:
        raise ValueError("mean_rows must be >= 1")
    base = np.random.default_rng(BASE_SEED)
    mean_gap = 1.0 / float(rate_per_s)
    n = int(rate_per_s * seconds * 1.5) + 64
    if arrivals == "poisson":
        gaps = base.exponential(mean_gap, size=n)
    elif arrivals == "lomax":
        if tail_alpha <= 1.0:
            raise ValueError("tail_alpha must be > 1 (finite mean)")
        gaps = base.pareto(tail_alpha, size=n) * mean_gap * (tail_alpha - 1.0)
    else:
        raise ValueError(f"unknown arrivals {arrivals!r}")
    # the gaps whose sum stays inside the window, in any order
    gaps = gaps[: int(np.searchsorted(np.cumsum(gaps), seconds))]
    p = min(1.0, 1.0 / max(mean_rows, 1.0 + 1e-9))
    sizes = np.clip(base.geometric(p, size=gaps.size), 1, max_rows).astype(np.int64)
    rng = np.random.default_rng(int(seed) % 2**63)
    t = np.cumsum(rng.permutation(gaps))
    sizes = rng.permutation(sizes)
    starts = (np.cumsum(sizes) - sizes) % int(pool_rows)
    return Schedule(t, sizes, starts)
