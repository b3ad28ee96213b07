"""Decision-tree ensembles trained on pre-binned features.

A copy of ``repro.core.trees`` (the port imports nothing of ``repro``):
``Tree`` and ``Ensemble`` with the explicit traversal
``raw_margin``/``predict`` that every CAM result is held to; the trainers,
which grow the same trees node for node from the same seed:

  * ``train_gbdt`` — histogram-based second-order gradient boosting
    (XGBoost-style gain, leaf-wise best-first growth, lr shrinkage,
    row/column subsampling), for regression / binary / multiclass.
  * ``train_rf``   — bagged CART forests (multi-output variance reduction),
    leaves store the majority class or the mean.

and ``random_deep_ensemble``, the seeded complete-depth model behind the
full-width runs.  Both trainers run on the host in numpy over **binned**
features (bin indices from ``quantize.FeatureQuantizer``).

Split convention: ``bin < t`` goes left, so in float space ``x < edges[t-1]``
goes left.  Trees are stored as flat arrays (struct-of-arrays), the tabular
node format the X-TIME compiler ingests (§II-D).
"""

from __future__ import annotations

import heapq
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
# Histogram machinery (shared by GBDT and RF)
# ---------------------------------------------------------------------------


def _hist(
    xb: np.ndarray, g: np.ndarray, h: np.ndarray, idx: np.ndarray, n_bins: int
) -> tuple[np.ndarray, np.ndarray]:
    """Per-(output, feature, bin) gradient and (feature, bin) hessian hists.

    g: (n, K) multi-output gradients, h: (n,) shared hessians.
    Returns (G, H) with shapes (K, F, n_bins) and (F, n_bins).  Built with
    bincounts over a flattened (row, feature) index — the numpy analog of
    the fused histogram kernels in LightGBM/XGBoost.
    """
    n, F = idx.shape[0], xb.shape[1]
    K = g.shape[1]
    flat = xb[idx].astype(np.int64) + np.arange(F, dtype=np.int64)[None, :] * n_bins
    flat = flat.ravel()
    G = np.empty((K, F, n_bins), dtype=np.float64)
    for k in range(K):
        gw = np.broadcast_to(g[idx, k][:, None], (n, F)).ravel()
        G[k] = np.bincount(flat, weights=gw, minlength=F * n_bins).reshape(F, n_bins)
    hw = np.broadcast_to(h[idx, None], (n, F)).ravel()
    H = np.bincount(flat, weights=hw, minlength=F * n_bins).reshape(F, n_bins)
    return G, H


def _best_split(
    G: np.ndarray,
    H: np.ndarray,
    reg_lambda: float,
    min_child_weight: float,
    feat_mask: np.ndarray | None = None,
) -> tuple[float, int, int]:
    """XGBoost gain (summed over outputs) over all (feature, bin) candidates.

    G: (K, F, n_bins), H: (F, n_bins).  Returns (gain, feature, t) where
    rows with bin < t go left.  gain <= 0 means no useful split.
    """
    Gtot = G.sum(axis=2, keepdims=True)  # (K, F, 1)
    Htot = H.sum(axis=1, keepdims=True)  # (F, 1)
    GL = np.cumsum(G, axis=2)[:, :, :-1]  # (K, F, n_bins-1)
    HL = np.cumsum(H, axis=1)[:, :-1]  # (F, n_bins-1)
    GR = Gtot - GL
    HR = Htot - HL
    parent = ((Gtot**2) / (Htot + reg_lambda)[None]).sum(axis=0)  # (F, 1)
    gain = (GL**2 / (HL + reg_lambda)[None] + GR**2 / (HR + reg_lambda)[None]).sum(
        axis=0
    ) - parent  # (F, n_bins-1)
    ok = (HL >= min_child_weight) & (HR >= min_child_weight)
    if feat_mask is not None:
        ok &= feat_mask[:, None]
    gain = np.where(ok, gain, -np.inf)
    j = int(np.argmax(gain))
    f, t = divmod(j, gain.shape[1])
    return float(gain[f, t]), int(f), int(t) + 1


@dataclass
class _Node:
    idx: np.ndarray  # row indices reaching this node
    G: np.ndarray  # (K, F, n_bins) grad hist
    H: np.ndarray  # (F, n_bins) hess hist
    tree_pos: int  # index in the output arrays


def _grow_tree(
    xb: np.ndarray,
    g: np.ndarray,
    h: np.ndarray,
    idx: np.ndarray,
    *,
    n_bins: int,
    max_leaves: int,
    max_depth: int,
    reg_lambda: float,
    min_child_weight: float,
    learning_rate: float,
    colsample: float,
    rng: np.random.Generator,
) -> Tree:
    """Leaf-wise (best-first) growth with histogram subtraction.

    For K == 1 the leaf value is the Newton step -G/(H+λ)·lr; for K > 1 the
    tree structure is grown on the summed gain and leaf payloads are
    recomputed by the caller.
    """
    F = xb.shape[1]
    if g.ndim == 1:
        g = g[:, None]
    feature = [np.int32(-1)]
    threshold = [np.int32(0)]
    left = [np.int32(-1)]
    right = [np.int32(-1)]
    value = [np.float32(0)]
    depth = {0: 0}

    def leaf_value(node: _Node) -> float:
        Gt = node.G[0].sum()
        Ht = node.H.sum()
        return float(-Gt / (Ht + reg_lambda) * learning_rate)

    feat_mask = None
    if colsample < 1.0:
        k = max(1, int(round(colsample * F)))
        chosen = rng.choice(F, size=k, replace=False)
        feat_mask = np.zeros(F, dtype=bool)
        feat_mask[chosen] = True

    G0, H0 = _hist(xb, g, h, idx, n_bins)
    root = _Node(idx=idx, G=G0, H=H0, tree_pos=0)
    value[0] = np.float32(leaf_value(root))

    heap: list = []  # (-gain, counter, node, f, t)
    counter = 0

    def push(node: _Node) -> None:
        nonlocal counter
        if depth[node.tree_pos] >= max_depth or node.idx.shape[0] < 2:
            return
        gain, f, t = _best_split(node.G, node.H, reg_lambda, min_child_weight, feat_mask)
        if np.isfinite(gain) and gain > 1e-12:
            heapq.heappush(heap, (-gain, counter, node, f, t))
            counter += 1

    push(root)
    n_leaves = 1
    while heap and n_leaves < max_leaves:
        _, _, node, f, t = heapq.heappop(heap)
        rows = node.idx
        go_left = xb[rows, f] < t
        li, ri = rows[go_left], rows[~go_left]
        if li.size == 0 or ri.size == 0:
            continue
        # histogram subtraction: build the smaller child, derive the other
        if li.size <= ri.size:
            GL_, HL_ = _hist(xb, g, h, li, n_bins)
            GR_, HR_ = node.G - GL_, node.H - HL_
        else:
            GR_, HR_ = _hist(xb, g, h, ri, n_bins)
            GL_, HL_ = node.G - GR_, node.H - HR_

        pos = node.tree_pos
        feature[pos] = np.int32(f)
        threshold[pos] = np.int32(t)
        left[pos] = np.int32(len(feature))
        right[pos] = np.int32(len(feature) + 1)
        for child_idx, Gc, Hc in ((li, GL_, HL_), (ri, GR_, HR_)):
            child = _Node(idx=child_idx, G=Gc, H=Hc, tree_pos=len(feature))
            feature.append(np.int32(-1))
            threshold.append(np.int32(0))
            left.append(np.int32(-1))
            right.append(np.int32(-1))
            value.append(np.float32(leaf_value(child)))
            depth[child.tree_pos] = depth[pos] + 1
            push(child)
        n_leaves += 1

    return Tree(
        feature=np.asarray(feature, dtype=np.int32),
        threshold=np.asarray(threshold, dtype=np.int32),
        left=np.asarray(left, dtype=np.int32),
        right=np.asarray(right, dtype=np.int32),
        value=np.asarray(value, dtype=np.float32),
    )


# ---------------------------------------------------------------------------
# Gradient boosting (XGBoost-style, §II-A "GB")
# ---------------------------------------------------------------------------


@dataclass
class GBDTParams:
    n_rounds: int = 50
    learning_rate: float = 0.1
    max_leaves: int = 256  # the paper's N_leaves,max constraint
    max_depth: int = 8
    reg_lambda: float = 1.0
    min_child_weight: float = 1.0
    subsample: float = 1.0
    colsample: float = 1.0
    seed: int = 0


def _sigmoid(z: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-np.clip(z, -30, 30)))


def _softmax(z: np.ndarray) -> np.ndarray:
    z = z - z.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


def train_gbdt(
    xb: np.ndarray,
    y: np.ndarray,
    *,
    task: Task,
    n_bins: int,
    n_classes: int = 1,
    params: GBDTParams | None = None,
) -> Ensemble:
    """Second-order gradient boosting on binned features."""
    p = params or GBDTParams()
    rng = np.random.default_rng(p.seed)
    n = xb.shape[0]
    y = np.asarray(y)

    if task == "regression":
        base = float(np.mean(y))
        margin = np.zeros((n, 1))
    elif task == "binary":
        pos = float(np.clip(np.mean(y), 1e-6, 1 - 1e-6))
        base = float(np.log(pos / (1 - pos)))
        margin = np.zeros((n, 1))
    else:
        base = 0.0
        margin = np.zeros((n, n_classes))

    trees: list[Tree] = []
    tree_class: list[int] = []
    for _ in range(p.n_rounds):
        if task == "regression":
            pred = margin[:, 0] + base
            grads = [(0, (pred - y).astype(np.float64), np.ones(n))]
        elif task == "binary":
            prob = _sigmoid(margin[:, 0] + base)
            grads = [(0, (prob - y).astype(np.float64), np.maximum(prob * (1 - prob), 1e-16))]
        else:
            prob = _softmax(margin + base)
            grads = [
                (
                    c,
                    (prob[:, c] - (y == c)).astype(np.float64),
                    np.maximum(prob[:, c] * (1 - prob[:, c]), 1e-16),
                )
                for c in range(n_classes)
            ]

        for c, g, h in grads:
            if p.subsample < 1.0:
                m = max(1, int(round(p.subsample * n)))
                idx = rng.choice(n, size=m, replace=False)
            else:
                idx = np.arange(n)
            tree = _grow_tree(
                xb, g, h, idx,
                n_bins=n_bins,
                max_leaves=p.max_leaves,
                max_depth=p.max_depth,
                reg_lambda=p.reg_lambda,
                min_child_weight=p.min_child_weight,
                learning_rate=p.learning_rate,
                colsample=p.colsample,
                rng=rng,
            )
            trees.append(tree)
            tree_class.append(c)
            margin[:, c] += tree.predict_bins(xb)

    return Ensemble(
        trees=trees,
        n_features=xb.shape[1],
        n_bins=n_bins,
        task=task,
        kind="gbdt",
        n_classes=(n_classes if task == "multiclass" else (2 if task == "binary" else 1)),
        tree_class=np.asarray(tree_class, dtype=np.int32),
        base_score=base,
        leaf_class_mode="tree",
    )


# ---------------------------------------------------------------------------
# Random forests (§II-A "RF")
# ---------------------------------------------------------------------------


@dataclass
class RFParams:
    n_trees: int = 100
    max_leaves: int = 256
    max_depth: int = 12
    min_child_weight: float = 1.0
    colsample: float = 1.0  # per-tree feature subsample ("max_features")
    bootstrap: bool = True
    seed: int = 0


def train_rf(
    xb: np.ndarray,
    y: np.ndarray,
    *,
    task: Task,
    n_bins: int,
    n_classes: int = 1,
    params: RFParams | None = None,
) -> Ensemble:
    """Bagged CART forest.

    Classification trees are grown on multi-output squared loss over one-hot
    targets (variance-reduction gain, equal to gini gain up to a factor of 2
    for one-hot y); leaves are relabelled with the exact in-bag majority
    class.  Regression trees minimize variance; leaves store the in-bag
    mean.  The ensemble averages (regression) or votes (classification).
    """
    p = params or RFParams()
    rng = np.random.default_rng(p.seed)
    n = xb.shape[0]
    y = np.asarray(y)
    k_cls = max(2, n_classes)

    trees: list[Tree] = []
    leaf_class: list[np.ndarray] = []
    tree_class: list[int] = []

    for _ in range(p.n_trees):
        idx = rng.choice(n, size=n, replace=True) if p.bootstrap else np.arange(n)
        if task == "regression":
            g = (-y).astype(np.float64)[:, None]  # leaf value = mean(y) with lr=1
        else:
            g = -(y[:, None] == np.arange(k_cls)[None, :]).astype(np.float64)
        h = np.ones(n, dtype=np.float64)
        tree = _grow_tree(
            xb, g, h, idx,
            n_bins=n_bins,
            max_leaves=p.max_leaves,
            max_depth=p.max_depth,
            reg_lambda=1e-9,
            min_child_weight=p.min_child_weight,
            learning_rate=1.0,
            colsample=p.colsample,
            rng=rng,
        )
        if task == "regression":
            # leaf value = -mean(g) = mean(y) over in-bag rows: already set
            trees.append(tree)
            tree_class.append(0)
        else:
            # exact per-leaf majority vote over in-bag rows
            leaves = tree.leaf_ids(xb[idx])
            votes = np.zeros((tree.n_nodes, k_cls), dtype=np.int64)
            np.add.at(votes, (leaves, y[idx].astype(np.int64)), 1)
            maj = votes.argmax(axis=1).astype(np.int32)
            tree.value = np.ones(tree.n_nodes, dtype=np.float32)  # one vote
            trees.append(tree)
            tree_class.append(0)
            leaf_class.append(maj)

    return Ensemble(
        trees=trees,
        n_features=xb.shape[1],
        n_bins=n_bins,
        task=task,
        kind="rf",
        n_classes=(n_classes if task == "multiclass" else (2 if task == "binary" else 1)),
        tree_class=np.asarray(tree_class, dtype=np.int32),
        base_score=0.0,
        leaf_class_mode=("leaf" if task != "regression" else "tree"),
        leaf_class=leaf_class,
    )


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
