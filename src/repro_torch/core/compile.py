"""X-TIME compiler: tree ensembles -> CAM tables -> core placement (§II-D, §III-A).

Every root-to-leaf path of every tree becomes one CAM row storing per
feature an integer range ``[low, high)`` over the quantizer's bin grid
(don't-care = the full range ``[0, n_bins)``), plus the leaf value, tree id
and class id — the ``L x (2*N_feat + 3)`` table of §III-A.

``pack_cores`` then performs the paper's placement: trees are assigned to
cores (first-fit decreasing over the N_words = N_stacked * H row budget),
features are segmented over queued arrays, and models smaller than the chip
are replicated for input batching (§III-D).  The placement feeds the cycle
model in ``perfmodel.py`` and defines the row-shard boundaries of the
distributed engine.

A copy of ``repro.core.compile`` (without ``padded_table``): the port imports
nothing of ``repro``, and both packages must compile identical tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch.core.trees import Ensemble

# Kernel table dtypes, narrowest first.  The packed (unsigned) dtypes store
# INCLUSIVE upper bounds so the full bin range [0, n_bins) fits the dtype
# (n_bins=256 needs values up to 255, not 256) — see DESIGN.md §10.
TABLE_DTYPES = ("uint8", "uint16", "int32")


def select_table_dtype(n_bins: int) -> str:
    """Narrowest kernel dtype the grid cardinality permits (§III-B: the
    paper's native precision is 8-bit; uint8 covers its whole design
    space).  Packed dtypes hold inclusive bounds, so ``n_bins - 1`` is
    the largest stored value."""
    if n_bins <= 1 << 8:
        return "uint8"
    if n_bins <= 1 << 16:
        return "uint16"
    return "int32"


@dataclass
class CAMTable:
    """The compiled ensemble: one row per leaf (root-to-leaf path).

    ``low``/``high`` are always held here in canonical int32
    exclusive-high form — the semantic layer every compiler/analysis
    consumer reads.  ``table_dtype`` records the packed dtype the KERNEL
    path may stream instead (selected at compile time from ``n_bins``);
    the engine performs the actual packing (inclusive-high, narrow
    dtype) at bind time and the artifact stores the packed form at rest.

    ``feature_ids`` is set by the compression pass when it physically
    drops all-wildcard feature columns (``repro.core.compress``): it maps
    each stored column back to the original query feature index, so the
    engine selects ``q[:, feature_ids]`` before matching.  ``None`` means
    the identity layout (every query feature has a column).
    ``n_features`` always stays the LOGICAL query width; ``n_cols`` is
    the physical table width.

    ``col_perm`` records the compile-time column clustering
    (``order_columns_by_activity``): stored column ``j`` holds what the
    pre-clustering layout held at column ``col_perm[j]``, so the engine
    permutes selected queries with ``q[:, col_perm]`` before matching.
    It is a PURE permutation (width-preserving), which is exactly why it
    cannot ride ``feature_ids``: the engine's pass-through shortcut for
    pre-narrowed queries keys off the width change, and a permutation
    has none.  ``None`` means original column order.
    """

    low: np.ndarray  # (R, n_cols) int32, inclusive lower bin bound
    high: np.ndarray  # (R, n_cols) int32, exclusive upper bin bound
    leaf: np.ndarray  # (R,) float32 leaf value (logit / vote / mean)
    tree_id: np.ndarray  # (R,) int32
    class_id: np.ndarray  # (R,) int32, output channel of the leaf
    n_trees: int
    n_features: int
    n_bins: int
    n_outputs: int
    task: str
    kind: str
    base_score: float
    n_classes: int
    table_dtype: str = "int32"  # packed kernel dtype (schema v1-additive)
    feature_ids: np.ndarray | None = None  # (n_cols,) int32 (schema v3-additive)
    col_perm: np.ndarray | None = None  # (n_cols,) int32 (schema v3-additive)

    @property
    def n_rows(self) -> int:
        return int(self.low.shape[0])

    @property
    def n_cols(self) -> int:
        """Physical feature-column count of the stored table (equals
        ``n_features`` unless compression collapsed wildcard columns)."""
        return int(self.low.shape[1])

    def dont_care_fraction(self) -> float:
        """Fraction of cells programmed to the full range (wildcards)."""
        dc = (self.low == 0) & (self.high == self.n_bins)
        return float(dc.mean())

    def feature_occupancy(self) -> np.ndarray:
        """(n_cols,) fraction of rows with a real (non-wildcard) range per
        stored feature column — how hard each queued-array column works
        (``scripts/ingest.py`` prints the mean for ingested tables; the
        compression pass collapses columns where this is exactly 0)."""
        dc = (self.low == 0) & (self.high == self.n_bins)
        return 1.0 - dc.mean(axis=0)

    def row_tile_activity(self, f_blk: int) -> np.ndarray:
        """(R, ceil(F/f_blk)) bool — which feature tiles each row actually
        constrains (non-wildcard).  The shared primitive behind
        ``tile_activity`` and the wildcard row ordering;
        ``kops.wildcard_tile_mask`` is the padded/packed kernel-side twin.
        """
        act = ~((self.low == 0) & (self.high == self.n_bins))
        R, F = act.shape
        nf = max(1, -(-F // f_blk))
        padded = np.zeros((R, nf * f_blk), dtype=bool)
        padded[:, :F] = act
        return padded.reshape(R, nf, f_blk).any(axis=-1)

    def packed_row_activity(self, f_blk: int) -> np.ndarray:
        """(R, ceil(T/8)) uint8 — each row's feature-tile activity bitmask,
        bit-packed big-endian (tile 0 is the MSB of byte 0).  One byte per
        8 feature tiles instead of one bool per tile; byte-lexicographic
        order equals the numeric order of the unpacked bitmask, so this is
        the sort key behind the wildcard row clustering at any tile count.
        """
        return np.packbits(self.row_tile_activity(f_blk), axis=1)

    def tile_activity(self, r_blk: int, f_blk: int) -> np.ndarray:
        """(ceil(R/r_blk), ceil(F/f_blk)) bool — does any cell of the tile
        hold a real (non-wildcard) range?  An all-wildcard tile matches
        every query, so the v2 kernel skips its compare entirely."""
        rows = self.row_tile_activity(f_blk)
        R, nf = rows.shape
        nr = max(1, -(-R // r_blk))
        padded = np.zeros((nr * r_blk, nf), dtype=bool)
        padded[:R] = rows
        return padded.reshape(nr, r_blk, nf).any(axis=1)

    def tile_skip_fraction(self, r_blk: int, f_blk: int) -> float:
        """Fraction of (r_blk, f_blk) compare tiles the v2 kernel skips —
        what wildcard-aware row ordering maximizes."""
        act = self.tile_activity(r_blk, f_blk)
        return float(1.0 - act.mean()) if act.size else 0.0

    def permuted(self, perm: np.ndarray) -> "CAMTable":
        """The same table with rows reordered by ``perm`` — semantically
        identical (the match+accumulate is row-order invariant)."""
        return replace(
            self,
            low=self.low[perm],
            high=self.high[perm],
            leaf=self.leaf[perm],
            tree_id=self.tree_id[perm],
            class_id=self.class_id[perm],
        )

    def leaf_matrix(self) -> np.ndarray:
        """(R, n_outputs) leaf values scattered to their class channel.

        ``match @ leaf_matrix`` is the in-core accumulation + class routing:
        the MXU replacement for the paper's MMR + SRAM + ACC path.
        """
        m = np.zeros((self.n_rows, self.n_outputs), dtype=np.float32)
        m[np.arange(self.n_rows), self.class_id] = self.leaf
        return m


def validate_ensemble(ens: Ensemble) -> None:
    """Structural preconditions of the compiler, checked up front so a
    malformed model (hand-built or ingested) fails with a diagnosis
    instead of an index error mid-traversal."""
    F, B = ens.n_features, ens.n_bins
    for i, tree in enumerate(ens.trees):
        n = tree.n_nodes
        internal = tree.feature >= 0
        if np.any(tree.feature >= F):
            raise ValueError(f"tree {i}: split feature >= n_features={F}")
        t = tree.threshold[internal]
        if t.size and (t.min() < 1 or t.max() > B - 1):
            raise ValueError(
                f"tree {i}: bin threshold outside [1, {B - 1}] "
                f"(n_bins={B}) — was the model lowered onto this grid?"
            )
        kids = np.concatenate([tree.left[internal], tree.right[internal]])
        if kids.size and (kids.min() < 0 or kids.max() >= n):
            raise ValueError(f"tree {i}: child index outside [0, {n})")
    if ens.leaf_class_mode == "leaf" and len(ens.leaf_class) != ens.n_trees:
        raise ValueError("leaf_class_mode='leaf' needs leaf_class per tree")


def order_rows_by_wildcards(table: CAMTable, f_blk: int = 128) -> CAMTable:
    """Cluster rows by which feature tiles they actually constrain.

    Tree rows are overwhelmingly wildcards (MonoSparse-CAM,
    arXiv:2407.11071): a depth-d path constrains ≤ d of F features.
    Sorting rows by their per-feature-tile activity bitmask groups rows
    that are all-wildcard in the same ``f_blk``-wide tile into the same
    row blocks, turning those (r_blk, f_blk) tiles into skippable
    no-ops for the v2 kernel.  Stable sort: rows with identical
    activity keep their tree-traversal order.
    """
    # bit-packed per-row activity masks: byte-lexicographic order equals
    # the numeric order of the full bitmask (tile 0 = MSB), at any tile
    # count — no <63-tile integer-key special case.  lexsort's last key
    # is primary, so feed the bytes most-significant-last; it is stable,
    # so rows with identical activity keep their tree-traversal order.
    packed = table.packed_row_activity(f_blk)  # (R, ceil(T/8)) uint8
    perm = np.lexsort(packed.T[::-1])
    return table.permuted(perm)


def order_columns_by_activity(table: CAMTable, f_blk: int = 128) -> CAMTable:
    """Cluster feature COLUMNS so all-wildcard features cost zero matches.

    Compression may leave (and uncompressed tables always have) columns
    that no row constrains — every cell is the full range, so they match
    any query.  Scattered among active columns they poison their
    ``f_blk``-wide tiles; moved together at the tail they join the
    always-match column padding and their tiles drop out of the kernel's
    wildcard tile mask entirely.  Stable partition: active columns keep
    their original relative order, so partially-active tiles stay as
    clustered as the original layout had them.

    The permutation is recorded on ``CAMTable.col_perm`` (composed with
    any existing one) and the row clustering re-runs on the new layout —
    both are semantics-free given the engine permutes queries to match
    (``XTimeEngine.select_features``).  Identity permutations return the
    table unchanged (no ``col_perm``, artifact schema stays put).
    """
    active = table.feature_occupancy() > 0.0
    perm = np.argsort(~active, kind="stable").astype(np.int32)
    if np.array_equal(perm, np.arange(table.n_cols, dtype=np.int32)):
        return table  # nothing to move; don't stamp a trivial col_perm
    prev = table.col_perm
    combined = perm if prev is None else np.asarray(prev, np.int32)[perm]
    out = replace(
        table,
        low=table.low[:, perm],
        high=table.high[:, perm],
        col_perm=combined,
    )
    return order_rows_by_wildcards(out, f_blk)


def compile_ensemble(
    ens: Ensemble,
    *,
    table_dtype: str = "auto",
    order_rows: bool = True,
    cluster_columns: bool = False,
) -> CAMTable:
    """Traverse every tree, emit one CAM row per leaf.

    ``table_dtype='auto'`` selects the narrowest kernel dtype the bin
    grid permits (``select_table_dtype``); pass ``'int32'`` to pin the
    v1 wide layout.  ``order_rows`` applies the wildcard-aware row
    clustering (row order never affects results — see ``permuted``).
    ``cluster_columns`` additionally runs ``order_columns_by_activity``,
    recording the column permutation on the table (``col_perm``) so the
    engine permutes queries to match; off by default because it bumps
    the artifact schema to v3 and only pays off when all-wildcard
    feature columns exist.
    """
    if table_dtype == "auto":
        table_dtype = select_table_dtype(ens.n_bins)
    if table_dtype not in TABLE_DTYPES:
        raise ValueError(f"table_dtype {table_dtype!r} not in {TABLE_DTYPES}")
    if table_dtype != "int32" and ens.n_bins - 1 > np.iinfo(table_dtype).max:
        raise ValueError(
            f"table_dtype {table_dtype!r} cannot hold n_bins={ens.n_bins} "
            "(inclusive bounds store values up to n_bins-1)"
        )
    validate_ensemble(ens)
    F, B = ens.n_features, ens.n_bins
    lows: list[np.ndarray] = []
    highs: list[np.ndarray] = []
    leaves: list[float] = []
    tree_ids: list[int] = []
    class_ids: list[int] = []

    for i, tree in enumerate(ens.trees):
        # iterative DFS carrying the [low, high) box of the current path
        stack = [(0, np.zeros(F, dtype=np.int32), np.full(F, B, dtype=np.int32))]
        while stack:
            node, lo, hi = stack.pop()
            f = int(tree.feature[node])
            if f < 0:  # leaf
                lows.append(lo)
                highs.append(hi)
                leaves.append(float(tree.value[node]))
                tree_ids.append(i)
                if ens.leaf_class_mode == "leaf":
                    class_ids.append(int(ens.leaf_class[i][node]))
                else:
                    c = 0 if ens.tree_class is None else int(ens.tree_class[i])
                    class_ids.append(c)
                continue
            t = int(tree.threshold[node])
            llo, lhi = lo.copy(), hi.copy()
            lhi[f] = min(lhi[f], t)  # left: bin < t
            rlo, rhi = lo.copy(), hi.copy()
            rlo[f] = max(rlo[f], t)  # right: bin >= t
            stack.append((int(tree.right[node]), rlo, rhi))
            stack.append((int(tree.left[node]), llo, lhi))

    table = CAMTable(
        low=np.stack(lows).astype(np.int32),
        high=np.stack(highs).astype(np.int32),
        leaf=np.asarray(leaves, dtype=np.float32),
        tree_id=np.asarray(tree_ids, dtype=np.int32),
        class_id=np.asarray(class_ids, dtype=np.int32),
        n_trees=ens.n_trees,
        n_features=F,
        n_bins=B,
        n_outputs=ens.n_outputs,
        task=ens.task,
        kind=ens.kind,
        base_score=ens.base_score,
        n_classes=ens.n_classes,
        table_dtype=table_dtype,
    )
    if order_rows:
        table = order_rows_by_wildcards(table)
    if cluster_columns:
        table = order_columns_by_activity(table)
    return table


# ---------------------------------------------------------------------------
# Core placement (§III-A, §III-C)
# ---------------------------------------------------------------------------


@dataclass
class ChipSpec:
    """X-TIME single-chip architecture constants (§III-C, §IV-B)."""

    n_cores: int = 4096
    array_rows: int = 128  # H
    array_cols: int = 65
    n_stacked: int = 2  # row-wise extension: N_words = n_stacked * array_rows
    n_queued: int = 2  # column-wise extension: width = n_queued * array_cols
    clock_ghz: float = 1.0
    lambda_cam: int = 4  # cycles per aCAM search (precharge, MSB, LSB, latch)
    lambda_core: int = 12  # end-to-end core latency in cycles
    peak_power_w: float = 19.0
    n_routers: int = 1365  # H-tree over 4096 cores (4096/4 + ... + 1)
    flit_bytes: int = 8  # 64-bit leaf flits
    noc_radix: int = 4

    @property
    def n_words(self) -> int:
        return self.n_stacked * self.array_rows

    @property
    def core_width(self) -> int:
        return self.n_queued * self.array_cols


@dataclass
class CorePlacement:
    """Result of packing one model onto the chip."""

    spec: ChipSpec
    # per used core: list of tree indices mapped to it
    core_trees: list[list[int]] = field(default_factory=list)
    core_rows_used: list[int] = field(default_factory=list)
    n_feature_segments: int = 1  # queued-array groups of <=65 features
    replication: int = 1  # input-batching copies of the whole model (§III-D)

    @property
    def n_cores_used(self) -> int:
        return len(self.core_trees)

    @property
    def max_trees_per_core(self) -> int:
        return max((len(t) for t in self.core_trees), default=0)

    @property
    def word_utilization(self) -> float:
        cap = self.n_cores_used * self.spec.n_words
        return (sum(self.core_rows_used) / cap) if cap else 0.0


def pack_cores(table: CAMTable, spec: ChipSpec | None = None) -> CorePlacement:
    """First-fit-decreasing placement of trees onto cores.

    A tree's leaves must live in one core (the MMR iterates matches locally,
    §III-A); the paper's hyperparameter search bounds N_leaves,max = 256 =
    N_words so this always holds for compliant models.
    """
    spec = spec or ChipSpec()
    leaves_per_tree = np.bincount(table.tree_id, minlength=table.n_trees)
    if leaves_per_tree.max(initial=0) > spec.n_words:
        raise ValueError(
            f"tree with {int(leaves_per_tree.max())} leaves exceeds core capacity "
            f"N_words={spec.n_words}; retrain with max_leaves<={spec.n_words}"
        )

    order = np.argsort(-leaves_per_tree)  # decreasing
    core_trees: list[list[int]] = []
    core_free: list[int] = []
    for t in order:
        need = int(leaves_per_tree[t])
        placed = False
        for c in range(len(core_trees)):
            if core_free[c] >= need:
                core_trees[c].append(int(t))
                core_free[c] -= need
                placed = True
                break
        if not placed:
            core_trees.append([int(t)])
            core_free.append(spec.n_words - need)
    n_used = len(core_trees)
    if n_used > spec.n_cores:
        raise ValueError(
            f"model needs {n_used} cores > chip capacity {spec.n_cores}; "
            "shard across chips (PCIe card scenario, §III-D)"
        )

    # segmentation counts the PHYSICAL columns streamed into the queued
    # arrays — collapsed wildcard columns cost no segment
    n_seg = int(np.ceil(table.n_cols / spec.array_cols))
    replication = max(1, spec.n_cores // max(1, n_used))
    return CorePlacement(
        spec=spec,
        core_trees=core_trees,
        core_rows_used=[spec.n_words - f for f in core_free],
        n_feature_segments=n_seg,
        replication=replication,
    )
