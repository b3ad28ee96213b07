"""Analog-hardware defect injection (§V-A Fig. 9b), a NumPy copy of
``repro.core.defects``.

The paper defines a defect as a 1-level random flip of a memristor
conductance or of a DAC output voltage, with half the affected devices
flipped up and half down.  On the 8-bit threshold grid a 1-level flip of a
4-bit sub-cell moves the stored bound by ±1 (LSB sub-cell) or ±16 (MSB
sub-cell); a DAC flip moves one query element the same way.

The same ``np.random.Generator`` state draws the same perturbations as the
JAX package's module.  Perturbed tables reach bounds such as ``high <=
low`` (never-match, ``(+inf, -inf)`` in the soft layout) and values at 0
or ``n_bins``.  ``relative_accuracy`` reproduces the Fig. 9(b) protocol:
ideal accuracy / defect-compromised accuracy averaged over repeated draws.
"""

from __future__ import annotations

from dataclasses import replace as dc_replace

import numpy as np

from repro_torch.core.compile import CAMTable


def _flip_levels(
    values: np.ndarray, frac: float, n_bins: int, rng: np.random.Generator
) -> np.ndarray:
    """Flip a fraction of entries by ±1 sub-cell level (±1 or ±16 codes)."""
    flat = values.reshape(-1).copy()
    n = flat.size
    k = int(round(frac * n))
    if k == 0:
        return values.copy()
    idx = rng.choice(n, size=k, replace=False)
    # half up, half down; 50/50 LSB (±1) vs MSB (±16) sub-cell
    magnitude = np.where(rng.random(k) < 0.5, 1, 16)
    sign = np.where(np.arange(k) % 2 == 0, 1, -1)
    rng.shuffle(sign)
    flat[idx] = np.clip(flat[idx] + sign * magnitude, 0, n_bins)
    return flat.reshape(values.shape)


def inject_table_defects(
    table: CAMTable, frac: float, rng: np.random.Generator
) -> CAMTable:
    """Memristor defects: each stored bound (2 devices per macro-cell per
    side) independently eligible for a 1-level flip."""
    low = _flip_levels(table.low, frac, table.n_bins, rng)
    high = _flip_levels(table.high, frac, table.n_bins, rng)
    # flipped levels can leave the packed encoding's range (low pushed to
    # n_bins, high below low): the perturbed table drops to the universal
    # int32 layout, which the engine resolves 'auto' from
    return dc_replace(
        table,
        low=low.astype(np.int32),
        high=high.astype(np.int32),
        table_dtype="int32",
    )


def inject_query_defects(
    q_bins: np.ndarray, frac: float, n_bins: int, rng: np.random.Generator
) -> np.ndarray:
    """DAC defects: 1-level flips on the applied query voltages."""
    out = _flip_levels(q_bins.astype(np.int64), frac, n_bins - 1, rng)
    return out.astype(q_bins.dtype if q_bins.dtype != np.uint8 else np.int32)


def relative_accuracy(
    ideal_acc: float, defect_accs: list[float]
) -> tuple[float, float]:
    """Fig. 9(b) metric: mean and std of defect_acc / ideal_acc."""
    rel = np.asarray(defect_accs, dtype=np.float64) / max(ideal_acc, 1e-12)
    return float(rel.mean()), float(rel.std())
