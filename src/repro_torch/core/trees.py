"""Decision-tree ensembles over pre-binned features (the host-side model).

A copy of the containers and the synthetic generator of
``repro.core.trees`` (the port imports nothing of ``repro``): ``Tree`` and
``Ensemble`` with the explicit traversal ``raw_margin``/``predict`` that
every CAM result is held to, and ``random_deep_ensemble``, the seeded
complete-depth model behind the full-width runs.  The trainers
(``train_gbdt``/``train_rf``) are not ported yet.

Split convention: ``bin < t`` goes left.  Trees are stored as flat arrays
(struct-of-arrays), the tabular node format the X-TIME compiler ingests
(§II-D).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal

import numpy as np

Task = Literal["regression", "binary", "multiclass"]


# ---------------------------------------------------------------------------
# Tree container
# ---------------------------------------------------------------------------


@dataclass
class Tree:
    """Array-based binary tree over binned features.

    Internal node j: if ``x_bins[feature[j]] < threshold[j]`` descend to
    ``left[j]`` else ``right[j]``.  Leaf j has ``feature[j] == -1`` and
    prediction ``value[j]`` (scalar logit / target).
    """

    feature: np.ndarray  # (n_nodes,) int32, -1 => leaf
    threshold: np.ndarray  # (n_nodes,) int32 bin split point, in [1, n_bins-1]
    left: np.ndarray  # (n_nodes,) int32
    right: np.ndarray  # (n_nodes,) int32
    value: np.ndarray  # (n_nodes,) float32

    @property
    def n_nodes(self) -> int:
        return int(self.feature.shape[0])

    @property
    def n_leaves(self) -> int:
        return int((self.feature < 0).sum())

    @property
    def max_depth(self) -> int:
        depth = np.zeros(self.n_nodes, dtype=np.int32)
        best = 0
        for j in range(self.n_nodes):  # parents precede children by construction
            if self.feature[j] >= 0:
                depth[self.left[j]] = depth[j] + 1
                depth[self.right[j]] = depth[j] + 1
            else:
                best = max(best, int(depth[j]))
        return best

    def leaf_ids(self, xb: np.ndarray) -> np.ndarray:
        """Vectorized traversal: node index of the leaf each row lands in."""
        node = np.zeros(xb.shape[0], dtype=np.int32)
        active = self.feature[node] >= 0
        while active.any():
            f = self.feature[node]
            t = self.threshold[node]
            go_left = xb[np.arange(xb.shape[0]), np.maximum(f, 0)] < t
            nxt = np.where(go_left, self.left[node], self.right[node])
            node = np.where(active, nxt, node)
            active = self.feature[node] >= 0
        return node

    def predict_bins(self, xb: np.ndarray) -> np.ndarray:
        """(n, F) binned features -> (n,) leaf values."""
        return self.value[self.leaf_ids(xb)]


@dataclass
class Ensemble:
    """A trained forest in the paper's tabular exchange format (§III-A).

    ``tree_class[i]`` is the class whose logit tree i contributes to
    (0 for regression/binary).  GBDT multiclass emits one tree per class per
    round; RF classification stores a vote of 1.0 and the per-leaf majority
    class (``leaf_class_mode == 'leaf'``), matching the paper's class-ID
    column in the CAM table.
    """

    trees: list[Tree]
    n_features: int
    n_bins: int
    task: Task
    kind: Literal["gbdt", "rf"]
    n_classes: int = 1  # logical classes (1 for regression; 2 for binary)
    tree_class: np.ndarray | None = None  # (n_trees,)
    base_score: float = 0.0
    # 'tree': all leaves of tree i belong to tree_class[i] (GBDT).
    # 'leaf': class id varies per leaf (RF classification majority vote).
    leaf_class_mode: Literal["tree", "leaf"] = "tree"
    leaf_class: list[np.ndarray] = field(default_factory=list)  # per tree (n_nodes,)
    # imported models (repro.ingest) may carry margin layouts the native
    # trainers never produce, e.g. a summing binary forest with one
    # probability lane per class; None keeps the native derivation
    n_outputs_override: int | None = None

    @property
    def n_trees(self) -> int:
        return len(self.trees)

    @property
    def n_outputs(self) -> int:
        """Width of the raw margin vector (number of accumulator channels)."""
        if self.n_outputs_override is not None:
            return self.n_outputs_override
        if self.task == "multiclass":
            return self.n_classes
        if self.kind == "rf" and self.task == "binary":
            return 2  # vote counts per class
        return 1

    @property
    def max_leaves(self) -> int:
        return max(t.n_leaves for t in self.trees)

    @property
    def total_leaves(self) -> int:
        return sum(t.n_leaves for t in self.trees)

    # -- reference prediction by explicit traversal (the "GPU-style" path) --

    def raw_margin(self, xb: np.ndarray) -> np.ndarray:
        """(n, n_outputs) summed leaf values before the final reduction op."""
        n = xb.shape[0]
        out = np.zeros((n, self.n_outputs), dtype=np.float64)
        for i, tree in enumerate(self.trees):
            if self.leaf_class_mode == "leaf":
                leaves = tree.leaf_ids(xb)
                vals = tree.value[leaves]
                cls = self.leaf_class[i][leaves]
                np.add.at(out, (np.arange(n), cls), vals)
            else:
                c = 0 if self.tree_class is None else int(self.tree_class[i])
                out[:, c] += tree.predict_bins(xb)
        out += self.base_score
        if self.kind == "rf":
            out /= max(1, self.n_trees)
        return out.astype(np.float32)

    def predict(self, xb: np.ndarray) -> np.ndarray:
        """Final model prediction (class id / regression value) — the CP op.

        Classification decides by margin layout: a single channel is a
        logit (sign test), several channels are per-class scores (argmax)
        — covering native GBDT/RF and every imported-ensemble layout.
        """
        margin = self.raw_margin(xb)
        if self.task == "regression":
            return margin[:, 0]
        if margin.shape[1] == 1:
            return (margin[:, 0] > 0.0).astype(np.int32)
        return np.argmax(margin, axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# Synthetic deep ensembles (compression workloads)
# ---------------------------------------------------------------------------


def random_deep_ensemble(
    *,
    n_trees: int = 8,
    depth: int = 6,
    n_features: int = 16,
    n_bins: int = 256,
    task: Task = "regression",
    n_classes: int = 1,
    p_dup: float = 0.5,
    leaf_levels: int = 16,
    base_score: float = 0.5,
    seed: int = 0,
) -> Ensemble:
    """Random complete-depth ensemble shaped to exercise CAM compression.

    The trainers (`train_gbdt`/`train_rf`) never emit the structures the
    compression pass targets: their splits always partition live data, so
    no path carries a contradictory duplicate split, and their leaf
    values are distinct floats, so sibling leaves never compare equal.
    This generator produces both, deliberately:

      * with probability ``p_dup`` an internal node re-splits a feature
        already split on its path, with a threshold drawn over the FULL
        grid — thresholds outside the path's surviving ``[low, high)``
        interval make one child's CAM row structurally empty (prunable),
      * leaf values are drawn from the ``k/16`` grid (the paper-adjacent
        quantized leaf payload), so sibling leaves frequently hold
        bit-identical values and merge into their parent's interval.

    ``k/16`` payloads also make every margin exact in float32 (dyadic
    rationals, bounded magnitude), so any accumulation order yields the
    same bits — the property the differential tests and benchmarks rely
    on when comparing compressed against uncompressed tables at paper
    scale.  Trees are complete (``2**depth`` leaves each): depth 8 gives
    the paper's 256-leaf N_words bound exactly.
    """
    if depth < 1:
        raise ValueError("depth must be >= 1")
    if not 0.0 <= p_dup <= 1.0:
        raise ValueError("p_dup must be in [0, 1]")
    rng = np.random.default_rng(seed)
    k_cls = n_classes if task == "multiclass" else (2 if task == "binary" else 1)
    trees: list[Tree] = []
    tree_class: list[int] = []
    n_nodes = 2 ** (depth + 1) - 1
    for i in range(n_trees):
        feature = np.full(n_nodes, -1, dtype=np.int32)
        threshold = np.zeros(n_nodes, dtype=np.int32)
        left = np.full(n_nodes, -1, dtype=np.int32)
        right = np.full(n_nodes, -1, dtype=np.int32)
        value = np.zeros(n_nodes, dtype=np.float32)
        next_free = 1
        stack: list[tuple[int, int, tuple[int, ...]]] = [(0, 0, ())]
        while stack:
            j, d, path = stack.pop()
            if d == depth:
                value[j] = np.float32(
                    int(rng.integers(-leaf_levels, leaf_levels + 1)) / 16.0
                )
                continue
            if path and rng.random() < p_dup:
                f = int(path[int(rng.integers(0, len(path)))])
            else:
                f = int(rng.integers(0, n_features))
            threshold[j] = int(rng.integers(1, n_bins))
            feature[j] = f
            left[j] = next_free
            right[j] = next_free + 1
            stack.append((next_free, d + 1, path + (f,)))
            stack.append((next_free + 1, d + 1, path + (f,)))
            next_free += 2
        trees.append(
            Tree(feature=feature, threshold=threshold, left=left,
                 right=right, value=value)
        )
        tree_class.append(i % k_cls if task == "multiclass" else 0)
    return Ensemble(
        trees=trees,
        n_features=n_features,
        n_bins=n_bins,
        task=task,
        kind="gbdt",
        n_classes=k_cls,
        tree_class=np.asarray(tree_class, dtype=np.int32),
        base_score=float(base_score),
        leaf_class_mode="tree",
    )
