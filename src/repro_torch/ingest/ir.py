"""Common ingestion IR: float-threshold trees from any source library.

Every importer (XGBoost JSON, LightGBM text, sklearn dict) parses its
dump into one ``ImportedEnsemble`` — trees over *float* feature space
with a single normalized split convention:

    x[feature] < threshold  ->  left child

Library conventions are normalized at parse time: XGBoost already splits
on strict ``<``; LightGBM and sklearn split on ``<=``, which parsers
rewrite as ``x < nextafter(t, +inf)`` (exact — no float value lies
between ``t`` and its successor).  Categorical splits are expanded into
threshold chains by the LightGBM parser (see ``lightgbm_text``), so the
IR itself is purely numerical.

Aggregation is always a SUM over trees plus per-channel ``base_score``:
averaging sources (random forests) pre-scale their leaf values by
``1/n_trees`` at parse time, so ``raw_margin`` has identical semantics
for every source.  ``raw_margin``/``predict`` here are the float-space
*reference* traversal; the bit-exact serving path is the lowering in
``ingest.lower`` onto the binned ``Ensemble`` + CAM engine.

A copy of ``repro.ingest.ir``: the port imports nothing of ``repro``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class IngestError(ValueError):
    """A model dump that cannot be parsed or lowered."""


@dataclass
class ImportedTree:
    """One tree in normalized float space (strict-< splits)."""

    feature: np.ndarray  # (n_nodes,) int32, -1 => leaf
    threshold: np.ndarray  # (n_nodes,) float64, split: x < threshold
    left: np.ndarray  # (n_nodes,) int32
    right: np.ndarray  # (n_nodes,) int32
    value: np.ndarray  # (n_nodes,) float64 leaf contribution

    @property
    def n_nodes(self) -> int:
        return int(self.feature.shape[0])

    @property
    def n_leaves(self) -> int:
        return int((self.feature < 0).sum())

    def validate(self, n_features: int, where: str = "tree") -> None:
        """Structural checks shared by every parser (clear errors beat
        downstream index crashes on malformed dumps)."""
        n = self.n_nodes
        arrays = (self.feature, self.threshold, self.left, self.right, self.value)
        if n == 0 or any(a.shape != (n,) for a in arrays):
            raise IngestError(f"{where}: node arrays empty or length-mismatched")
        internal = self.feature >= 0
        if np.any(self.feature[internal] >= n_features):
            raise IngestError(
                f"{where}: split feature index >= n_features={n_features}"
            )
        kids = np.concatenate([self.left[internal], self.right[internal]])
        if kids.size and (kids.min(initial=0) < 0 or kids.max(initial=0) >= n):
            raise IngestError(f"{where}: child index out of range [0, {n})")
        if not np.all(np.isfinite(self.threshold[internal])):
            raise IngestError(f"{where}: non-finite split threshold")
        # every node reachable exactly once from the root => it is a tree
        seen = np.zeros(n, dtype=bool)
        stack = [0]
        while stack:
            j = stack.pop()
            if seen[j]:
                raise IngestError(f"{where}: node {j} reached twice (cycle/DAG)")
            seen[j] = True
            if self.feature[j] >= 0:
                stack.append(int(self.left[j]))
                stack.append(int(self.right[j]))
        if not seen.all():
            raise IngestError(f"{where}: {int((~seen).sum())} unreachable nodes")

    def leaf_ids(self, x: np.ndarray) -> np.ndarray:
        """Float-space traversal: leaf node index per row of ``x``."""
        node = np.zeros(x.shape[0], dtype=np.int32)
        active = self.feature[node] >= 0
        while active.any():
            f = self.feature[node]
            t = self.threshold[node]
            go_left = x[np.arange(x.shape[0]), np.maximum(f, 0)] < t
            nxt = np.where(go_left, self.left[node], self.right[node])
            node = np.where(active, nxt, node)
            active = self.feature[node] >= 0
        return node


def single_leaf_tree(value: float) -> ImportedTree:
    """A constant tree (one all-wildcard CAM row after lowering) — used to
    realize per-class base scores exactly."""
    return ImportedTree(
        feature=np.asarray([-1], dtype=np.int32),
        threshold=np.zeros(1, dtype=np.float64),
        left=np.asarray([-1], dtype=np.int32),
        right=np.asarray([-1], dtype=np.int32),
        value=np.asarray([value], dtype=np.float64),
    )


@dataclass
class ImportedEnsemble:
    """A parsed model dump, normalized and ready for grid lowering.

    ``tree_class[i]`` is the margin channel tree ``i`` sums into.
    ``base_score`` is per-channel (scalar bases broadcast); sources with
    per-class intercepts (sklearn GBDT ``init``) keep them exact here and
    the lowering emits one wildcard CAM row per distinct extra channel.
    """

    trees: list[ImportedTree]
    n_features: int
    task: str  # 'regression' | 'binary' | 'multiclass'
    n_outputs: int  # margin channels (1 logit, or C probability/vote lanes)
    tree_class: np.ndarray  # (n_trees,) int32
    base_score: np.ndarray  # (n_outputs,) float64
    source: str  # 'xgboost-json' | 'lightgbm-text' | 'sklearn-dict'
    source_kind: str = "gbdt"  # provenance: 'gbdt' | 'rf' | 'dart'
    n_classes: int = 1
    notes: list[str] = field(default_factory=list)

    def __post_init__(self) -> None:
        if self.task not in ("regression", "binary", "multiclass"):
            raise IngestError(f"unsupported task {self.task!r}")
        if len(self.trees) == 0:
            raise IngestError(f"{self.source}: model has no trees")
        self.tree_class = np.asarray(self.tree_class, dtype=np.int32)
        if self.tree_class.shape != (len(self.trees),):
            raise IngestError("tree_class must have one entry per tree")
        if self.tree_class.size and (
            self.tree_class.min() < 0 or self.tree_class.max() >= self.n_outputs
        ):
            raise IngestError("tree_class entry outside [0, n_outputs)")
        self.base_score = np.broadcast_to(
            np.asarray(self.base_score, dtype=np.float64), (self.n_outputs,)
        ).copy()
        for i, t in enumerate(self.trees):
            t.validate(self.n_features, where=f"{self.source} tree {i}")

    @property
    def n_trees(self) -> int:
        return len(self.trees)

    def thresholds_per_feature(self) -> list[np.ndarray]:
        """Sorted unique split thresholds per feature — the input to
        ``FeatureQuantizer.from_thresholds`` (§III-B grid mapping)."""
        per: list[list[float]] = [[] for _ in range(self.n_features)]
        for t in self.trees:
            for f, v in zip(t.feature, t.threshold):
                if f >= 0:
                    per[int(f)].append(float(v))
        return [np.unique(np.asarray(v, dtype=np.float64)) for v in per]

    @property
    def uniform_base(self) -> bool:
        """True when every channel shares one base score — lowered as the
        scalar ``Ensemble.base_score``; otherwise each nonzero channel
        becomes a float32 wildcard bias row (``single_leaf_tree``)."""
        return bool(np.all(self.base_score == self.base_score[0]))

    def effective_base(self) -> np.ndarray:
        """Per-channel base as the lowered path realizes it (float64
        scalar broadcast, or float32-rounded bias rows)."""
        if self.uniform_base:
            return self.base_score
        return self.base_score.astype(np.float32).astype(np.float64)

    # -- float-space reference (validation only; serving goes via lowering) --

    def raw_margin(self, x: np.ndarray) -> np.ndarray:
        """(n, n_outputs) float32 margins, float64 accumulation — the same
        accumulation order/width as ``Ensemble.raw_margin`` so the lowered
        binned path is bit-identical."""
        x = np.asarray(x, dtype=np.float64)
        out = np.zeros((x.shape[0], self.n_outputs), dtype=np.float64)
        for i, tree in enumerate(self.trees):
            vals = tree.value.astype(np.float32)[tree.leaf_ids(x)]
            out[:, int(self.tree_class[i])] += vals
        out += self.effective_base()
        return out.astype(np.float32)

    def predict(self, x: np.ndarray) -> np.ndarray:
        margin = self.raw_margin(x)
        if self.task == "regression":
            return margin[:, 0]
        if margin.shape[1] == 1:  # single-logit binary
            return (margin[:, 0] > 0.0).astype(np.int32)
        return np.argmax(margin, axis=1).astype(np.int32)
