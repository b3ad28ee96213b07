"""Per-feature quantile binning — the paper's N_bit feature grid (§III-B).

X-TIME represents thresholds and queries on an N_bit grid (256 bins for the
8-bit configuration that matches FP accuracy, 16 bins for the 4-bit
iso-area ablation).  ``FeatureQuantizer`` computes per-feature quantile cut
points on training data; trees are trained *directly on bins* so the CAM
table, the traversal baseline, and the float model agree bit-exactly.

Convention (shared with trees.py and compile.py):
    bin(x) = searchsorted(edges, x, side='right')  in [0, n_bins-1]
    split "bin < t" == "x < edges[t-1]"

A copy of ``repro.core.quantize``: the port imports nothing of ``repro``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FeatureQuantizer:
    edges: list[np.ndarray]  # per feature, ascending unique cut points (<= n_bins-1)
    n_bins: int

    @property
    def n_features(self) -> int:
        return len(self.edges)

    @staticmethod
    def from_thresholds(
        thresholds: list[np.ndarray],
        n_bins: int = 256,
        on_overflow: str = "merge",
    ) -> tuple["FeatureQuantizer", list[int]]:
        """Build the grid directly from a model's own split points (§III-B).

        Ingestion path: instead of fitting quantiles on training data, the
        per-feature edge set IS the sorted unique thresholds of the
        imported ensemble, so every split lands exactly on a grid edge and
        binned inference is bit-identical to float inference.

        A feature may carry at most ``n_bins - 1`` distinct thresholds.
        Beyond that, ``on_overflow='merge'`` keeps an evenly-spaced
        subsample (nearest-edge remapping then loses exactness — the
        ingest report records every merged threshold), while ``'raise'``
        rejects the model.  Returns ``(quantizer, merged_per_feature)``.
        """
        if not 2 <= n_bins <= 65536:
            raise ValueError(f"n_bins must be in [2, 65536], got {n_bins}")
        if on_overflow not in ("merge", "raise"):
            raise ValueError(f"on_overflow {on_overflow!r} not in (merge, raise)")
        edges: list[np.ndarray] = []
        merged: list[int] = []
        cap = n_bins - 1
        for f, th in enumerate(thresholds):
            e = np.unique(np.asarray(th, dtype=np.float64))
            if not np.all(np.isfinite(e)):
                raise ValueError(f"feature {f}: non-finite threshold")
            if e.shape[0] > cap:
                if on_overflow == "raise":
                    raise ValueError(
                        f"feature {f}: {e.shape[0]} distinct thresholds exceed "
                        f"the {cap}-edge grid (n_bins={n_bins}); raise n_bins "
                        "or allow on_overflow='merge'"
                    )
                keep = np.round(np.linspace(0, e.shape[0] - 1, cap)).astype(int)
                merged.append(e.shape[0] - cap)
                e = e[np.unique(keep)]
            else:
                merged.append(0)
            edges.append(e)
        return FeatureQuantizer(edges=edges, n_bins=n_bins), merged

    @staticmethod
    def fit(x: np.ndarray, n_bins: int = 256) -> "FeatureQuantizer":
        """Quantile cuts per feature; duplicate quantiles are collapsed."""
        if not 2 <= n_bins <= 65536:
            raise ValueError(f"n_bins must be in [2, 65536], got {n_bins}")
        edges = []
        qs = np.linspace(0, 1, n_bins + 1)[1:-1]
        for f in range(x.shape[1]):
            col = x[:, f]
            col = col[np.isfinite(col)]
            if col.size == 0:
                edges.append(np.zeros((0,), dtype=np.float64))
                continue
            e = np.unique(np.quantile(col, qs))
            # drop degenerate cuts at the extremes (everything on one side)
            e = e[(e > col.min()) & (e <= col.max())]
            edges.append(np.asarray(e, dtype=np.float64))
        return FeatureQuantizer(edges=edges, n_bins=n_bins)

    def transform(self, x: np.ndarray) -> np.ndarray:
        """Float features -> integer bins (n, F).

        dtype is uint8 when n_bins <= 256 (the paper's DAC input width),
        else int32.  NaN (missing) maps to bin 0 — the trainer can still
        route it; the CAM don't-care covers the missing-feature case.
        """
        out = np.zeros(x.shape, dtype=np.int64)
        for f in range(x.shape[1]):
            col = np.nan_to_num(x[:, f], nan=-np.inf)
            out[:, f] = np.searchsorted(self.edges[f], col, side="right")
        dtype = np.uint8 if self.n_bins <= 256 else np.int32
        return out.astype(dtype)

    def effective_bins(self, f: int) -> int:
        """Number of distinct bins actually realizable for feature f."""
        return int(self.edges[f].shape[0]) + 1

    def effective_bins_array(self) -> np.ndarray:
        """(n_features,) realizable bin counts — ``transform`` can only
        ever emit bins in ``[0, effective_bins(f) - 1]`` per feature, so
        anything a CAM row constrains at or above that count is dead
        weight the compression pass prunes/widens against this vector."""
        return np.asarray(
            [e.shape[0] + 1 for e in self.edges], dtype=np.int64
        )

    def threshold_value(self, f: int, t: int) -> float:
        """Float-space threshold for split 'bin < t' (x < edges[t-1])."""
        return float(self.edges[f][t - 1])

    def bin_of_threshold(self, f: int, v: float) -> tuple[int, bool]:
        """Bin split point ``t`` realizing float split ``x < v`` as
        ``bin < t``, plus whether the mapping is exact.

        Exact iff ``v`` is a grid edge (always true on an unmerged
        ``from_thresholds`` grid); otherwise the nearest edge is used —
        the ingest report counts these remapped splits.
        """
        e = self.edges[f]
        if e.shape[0] == 0:
            raise ValueError(f"feature {f} has no grid edges to split on")
        i = int(np.searchsorted(e, v, side="left"))
        if i < e.shape[0] and e[i] == v:
            return i + 1, True
        lo = max(i - 1, 0)
        hi = min(i, e.shape[0] - 1)
        j = lo if abs(e[lo] - v) <= abs(e[hi] - v) else hi
        return j + 1, False
