"""RETENTION-style CAM table compression (arXiv:2312.03088, PAPERS.md).

The naive one-row-per-leaf mapping explodes CAM rows on paper-scale
models (4096 trees x depth 8 -> 1M rows); RETENTION shows large
ensembles fit bounded CAM capacity with resource-efficient row mapping,
and MonoSparse-CAM's sparsity observations say many lowered rows/cells
are dead weight.  ``compress_table`` runs between ``compile_ensemble``
and packing (``repro_torch.build(compress=...)``) and applies three
strictly bit-equivalence-preserving rewrites:

  prune  — drop rows that can never match: structurally empty intervals
           (``low >= high``, produced by contradictory duplicate splits
           on one path) and, when the artifact's own ``FeatureQuantizer``
           grid is attached, rows whose interval starts at or above the
           feature's realizable bin count.  Grid-vacuous upper bounds
           (``high >= effective_bins``) are widened to full wildcards —
           they exclude nothing a real query can present, and widening
           feeds both the column collapse and the kernel's wildcard tile
           skipping.
  merge  — RETENTION's common-prefix factoring: two rows of the SAME
           tree and class channel whose interval boxes are identical in
           every feature but one, adjacent in that one (``high_a ==
           low_b``), and whose leaf payloads are bit-identical, are one
           leaf split needlessly in two — they fuse into the union row.
           Iterated to fixpoint, a constant subtree collapses level by
           level into its root's single row.
  collapse — feature columns that are all-wildcard across every row
           (``CAMTable.feature_occupancy() == 0``) are physically
           dropped; ``CAMTable.feature_ids`` records the surviving
           original indices so the engine selects query columns before
           matching.  Dropped columns cost zero CAM cells, zero queued-
           array segments and zero kernel feature tiles.

Bit-equivalence contract (tests/test_compress.py): for every query the
engine can be handed — any bin vector when no grid is given, any
grid-realizable bin vector when one is — the per-query multiset of leaf
values accumulated into each output channel is IDENTICAL before and
after compression.  Pruned rows contribute only a +0.0 that float
addition absorbs; merged rows replace {v, v-matched-once} with the same
v matched once (a query inside the union interval matched exactly one of
the two adjacent source rows); collapsed columns never constrained any
match.  What can therefore NOT merge: rows with bit-different leaf
values (the sum would change), rows of different trees or class channels
(both could match one query — the multiset would lose a term), and
duplicate rows with IDENTICAL boxes (each contributes its value; fusing
them would halve the contribution) — see DESIGN.md §11.

Grid-aware stages (unreachable-row pruning, vacuous-bound widening) run
only when a grid is passed: they are exact for every query produced by
``FeatureQuantizer.transform`` but would change results for bin vectors
outside the grid's realizable range, which is why ``build`` passes the
artifact's own attached quantizer and nothing else.

A copy of ``repro.core.compress``: the port imports nothing of ``repro``,
and both packages must compress a table to the same bytes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace

import numpy as np

from repro_torch.core.compile import CAMTable, order_rows_by_wildcards
from repro_torch.core.quantize import FeatureQuantizer

# 'off' is the identity; 'prune' = dead rows + grid widening; 'merge' adds
# sibling-interval factoring; 'full' adds wildcard-column collapse.
# 'auto' is the serving alias for the strongest level.
COMPRESS_LEVELS = ("off", "prune", "merge", "full", "auto")


@dataclass
class CompressionReport:
    """Per-stage accounting of one ``compress_table`` run (artifact
    sidecar payload — ``CompiledModel.compression``)."""

    level: str
    rows_before: int
    rows_after: int
    cols_before: int
    cols_after: int
    pruned_empty: int = 0  # structurally empty [low, high) boxes
    pruned_unreachable: int = 0  # empty under the quantizer grid only
    merged_rows: int = 0  # rows removed by sibling-interval factoring
    widened_cells: int = 0  # grid-vacuous bounds widened to wildcard
    collapsed_columns: int = 0  # all-wildcard feature columns dropped
    sentinel_rows: int = 0  # wildcard zero-leaf rows kept (empty-table guard)

    @property
    def rows_saved(self) -> int:
        return self.rows_before - self.rows_after

    @property
    def row_savings_fraction(self) -> float:
        return self.rows_saved / self.rows_before if self.rows_before else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        # derived numbers ride along: the sidecar is read by dashboards
        # and the bench gate, neither of which should re-derive them
        d["rows_saved"] = self.rows_saved
        d["row_savings_fraction"] = self.row_savings_fraction
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CompressionReport":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


def resolve_level(level: str) -> str:
    """Validate and normalize a compression level ('auto' -> 'full')."""
    if level not in COMPRESS_LEVELS:
        raise ValueError(f"compress level {level!r} not in {COMPRESS_LEVELS}")
    return "full" if level == "auto" else level


def _effective_bins(table: CAMTable, grid: FeatureQuantizer | None) -> np.ndarray:
    """(n_cols,) realizable bin count per PHYSICAL column, capped at the
    table grid (no grid -> every bin below n_bins is presumed reachable)."""
    if grid is None:
        return np.full(table.n_cols, table.n_bins, dtype=np.int64)
    if grid.n_features != table.n_features:
        raise ValueError(
            f"grid covers {grid.n_features} features but the table queries "
            f"{table.n_features}; compress with the artifact's own quantizer"
        )
    eff = np.minimum(grid.effective_bins_array(), table.n_bins)
    if table.feature_ids is not None:
        eff = eff[np.asarray(table.feature_ids, dtype=np.int64)]
    return eff


def _merge_rows(
    low: np.ndarray,
    high: np.ndarray,
    leaf: np.ndarray,
    tree_id: np.ndarray,
    class_id: np.ndarray,
    n_bins: int,
) -> tuple[np.ndarray, int]:
    """Fixpoint sibling-interval factoring; mutates ``high`` in place.

    Returns ``(alive_mask, n_merged)``.  Rows group by (class channel,
    leaf BITS, box-minus-one-feature); within a group, intervals along
    the remaining feature are sorted and strictly-adjacent neighbours
    (``high_a == low_b``) fuse.  Bit-level leaf keys keep +0.0 and -0.0
    apart, and identical (duplicate) intervals are never adjacent, so
    duplicate leaves survive untouched — both deliberate (see module
    docstring).  Per-tree work is tiny (<= N_words rows), so the python
    group loop only ever sees a few hundred rows.
    """
    alive = np.ones(low.shape[0], dtype=bool)
    leaf_key = leaf.astype(np.float32).view(np.uint32).astype(np.int64)
    n_merged = 0
    for t in np.unique(tree_id):
        rows = np.flatnonzero(tree_id == t)
        changed = True
        while changed:
            changed = False
            live = rows[alive[rows]]
            if live.shape[0] < 2:
                break
            constrained = np.flatnonzero(
                ((low[live] > 0) | (high[live] < n_bins)).any(axis=0)
            )
            for f in constrained:
                live = rows[alive[rows]]
                if live.shape[0] < 2:
                    break
                # group key: everything but feature f's interval, as one
                # int64 row hashed through a void view (vectorized)
                box = np.column_stack(
                    [
                        class_id[live].astype(np.int64),
                        leaf_key[live],
                        np.delete(low[live], f, axis=1).astype(np.int64),
                        np.delete(high[live], f, axis=1).astype(np.int64),
                    ]
                )
                keys = np.ascontiguousarray(box).view(
                    [("", np.int64)] * box.shape[1]
                ).ravel()
                _, inv, counts = np.unique(
                    keys, return_inverse=True, return_counts=True
                )
                for g in np.flatnonzero(counts > 1):
                    members = live[inv == g]
                    members = members[np.argsort(low[members, f], kind="stable")]
                    cur = members[0]
                    for r in members[1:]:
                        if high[cur, f] == low[r, f]:
                            high[cur, f] = high[r, f]
                            alive[r] = False
                            n_merged += 1
                            changed = True
                        else:
                            cur = r
    return alive, n_merged


def compress_table(
    table: CAMTable,
    grid: FeatureQuantizer | None = None,
    *,
    level: str = "auto",
) -> tuple[CAMTable, CompressionReport]:
    """Compress a compiled CAM table; returns ``(table, report)``.

    ``grid`` enables the grid-aware stages and must be the quantizer the
    table's queries flow through (``build`` passes the artifact's own);
    without it only query-universal rewrites run.  The result is
    re-ordered by wildcard tile activity (a permutation — row order never
    affects results) so the savings also reach the v2 kernel's tile
    skipping.  ``level='off'`` is the identity.
    """
    level = resolve_level(level)
    n_rows, n_cols = table.n_rows, table.n_cols
    report = CompressionReport(
        level=level,
        rows_before=n_rows,
        rows_after=n_rows,
        cols_before=n_cols,
        cols_after=n_cols,
    )
    if level == "off":
        return table, report

    low = np.asarray(table.low, dtype=np.int32).copy()
    high = np.asarray(table.high, dtype=np.int32).copy()
    B = table.n_bins
    eff = _effective_bins(table, grid)

    # -- prune: never-matching rows, then grid-vacuous bound widening ------
    empty = (low >= high).any(axis=1)
    unreachable = (low >= eff[None, :]).any(axis=1) & ~empty
    keep = ~(empty | unreachable)
    report.pruned_empty = int(empty.sum())
    report.pruned_unreachable = int(unreachable.sum())
    low, high = low[keep], high[keep]
    leaf = np.asarray(table.leaf, dtype=np.float32)[keep]
    tree_id = np.asarray(table.tree_id, dtype=np.int32)[keep]
    class_id = np.asarray(table.class_id, dtype=np.int32)[keep]
    # realizable bins stop at eff-1, so high >= eff excludes nothing a
    # grid query can present: widen to the full range (more wildcards ->
    # more merges, collapses and skippable tiles)
    vacuous = (high >= eff[None, :]) & (high < B)
    report.widened_cells = int(vacuous.sum())
    high[vacuous] = B

    # -- merge: sibling-interval common-prefix factoring -------------------
    if level in ("merge", "full") and low.shape[0] > 1:
        alive, n_merged = _merge_rows(low, high, leaf, tree_id, class_id, B)
        report.merged_rows = n_merged
        low, high = low[alive], high[alive]
        leaf, tree_id, class_id = leaf[alive], tree_id[alive], class_id[alive]

    # an entirely-pruned table (every row dead) still has to pack, pad and
    # place: keep one all-wildcard zero-leaf sentinel row — it adds +0.0
    # to channel 0 of every query, exactly what the dead rows added
    if low.shape[0] == 0:
        low = np.zeros((1, n_cols), dtype=np.int32)
        high = np.full((1, n_cols), B, dtype=np.int32)
        leaf = np.zeros(1, dtype=np.float32)
        tree_id = np.zeros(1, dtype=np.int32)
        class_id = np.zeros(1, dtype=np.int32)
        report.sentinel_rows = 1

    # -- collapse: drop all-wildcard feature columns -----------------------
    feature_ids = table.feature_ids
    if level == "full":
        keep_cols = ~((low == 0) & (high == B)).all(axis=0)
        if not keep_cols.any():
            keep_cols[0] = True  # zero-width queries are degenerate
        dropped = n_cols - int(keep_cols.sum())
        if dropped:
            cols = (
                np.asarray(table.feature_ids, dtype=np.int32)
                if table.feature_ids is not None
                else np.arange(table.n_features, dtype=np.int32)
            )
            feature_ids = cols[keep_cols]
            low, high = low[:, keep_cols], high[:, keep_cols]
            report.collapsed_columns = dropped

    report.rows_after = int(low.shape[0])
    report.cols_after = int(low.shape[1])
    out = replace(
        table,
        low=low,
        high=high,
        leaf=leaf,
        tree_id=tree_id,
        class_id=class_id,
        feature_ids=feature_ids,
    )
    return order_rows_by_wildcards(out), report
