"""LightGBM model-text importer (``Booster.save_model('model.txt')``).

Zero-dependency parser for the key=value text format: a header block
(``num_class``, ``num_tree_per_iteration``, ``max_feature_idx``,
``objective``), one ``Tree=i`` block per tree, terminated by
``end of trees``.

Node encoding (LightGBM internal): internal nodes are indexed
``0..num_leaves-2``; a negative child ``c`` means leaf ``~c``.  Numerical
splits descend LEFT when ``x <= threshold`` — normalized to the IR's
strict ``<`` via ``nextafter(threshold, +inf)`` (exact: no double lies
between them).

Categorical splits (``decision_type & 1``) are LOWERED TO THRESHOLD
SETS: the bitset of member categories (``cat_threshold`` words sliced by
``cat_boundaries``) is decomposed into maximal runs of consecutive
integer codes ``[a, b]``, and the split node is rewritten as a chain of
interval tests ``(x < a-0.5 ? nonmember : x < b+0.5 ? member : next
run)``.  Subtrees referenced by several chain nodes are duplicated when
the nested structure is flattened back to arrays — each duplicated leaf
is one extra CAM row, the exact §III-A cost of a union-of-intervals
match, and the ingest report records the expansion.

Shrinkage is already folded into ``leaf_value`` by LightGBM; multiclass
models interleave classes (``tree_class[i] = i % num_tree_per_iteration``).
Missing-value default directions are ignored (finite-feature serving),
recorded as a note.

A copy of ``repro.ingest.lightgbm_text``: the port imports nothing of
``repro``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from repro_torch.ingest.ir import ImportedEnsemble, ImportedTree, IngestError


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise IngestError(f"lightgbm-text: {msg}")


def _kv_block(lines: list[str], where: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for ln in lines:
        if "=" in ln:
            k, _, v = ln.partition("=")
            out[k.strip()] = v.strip()
        elif ln.strip() and where == "header":
            out.setdefault("_magic", ln.strip())
    return out


def _ints(s: str) -> np.ndarray:
    return np.asarray(s.split(), dtype=np.int64) if s else np.zeros(0, np.int64)


def _floats(s: str) -> np.ndarray:
    return np.asarray(s.split(), dtype=np.float64) if s else np.zeros(0, np.float64)


def _member_categories(bitset: np.ndarray) -> np.ndarray:
    """Decode a LightGBM uint32-word bitset into sorted category codes."""
    cats = []
    for w, word in enumerate(bitset):
        word = int(word) & 0xFFFFFFFF
        while word:
            b = (word & -word).bit_length() - 1
            cats.append(w * 32 + b)
            word &= word - 1
    return np.asarray(cats, dtype=np.int64)


def _runs(cats: np.ndarray) -> list[tuple[int, int]]:
    """Maximal runs [a, b] of consecutive integers."""
    runs: list[tuple[int, int]] = []
    for c in cats:
        if runs and c == runs[-1][1] + 1:
            runs[-1] = (runs[-1][0], int(c))
        else:
            runs.append((int(c), int(c)))
    return runs


def _categorical_chain(runs: list[tuple[int, int]], member, nonmember) -> dict:
    """Nested threshold nodes testing membership in a union of integer
    runs.  ``member``/``nonmember`` subtrees are shared by reference here;
    flattening duplicates them."""
    node: dict = nonmember  # falls through every run => not a member
    for a, b in reversed(runs):
        inside = {"f": None, "t": b + 0.5, "l": member, "r": node}
        node = {"f": None, "t": a - 0.5, "l": nonmember, "r": inside}
    return node


class _TreeBuilder:
    """Parses one Tree= block into nested dict nodes, then flattens
    (duplicating shared categorical subtrees) into an ImportedTree."""

    def __init__(self, block: dict[str, str], idx: int) -> None:
        self.idx = idx
        self.n_expanded = 0
        for key in ("num_leaves", "leaf_value"):
            _require(key in block, f"Tree={idx} missing {key!r}")
        self.num_leaves = int(block["num_leaves"])
        self.leaf_value = _floats(block["leaf_value"])
        _require(self.leaf_value.shape[0] == self.num_leaves,
                 f"Tree={idx}: leaf_value length != num_leaves")
        n_int = self.num_leaves - 1
        self.split_feature = _ints(block.get("split_feature", ""))
        self.threshold = _floats(block.get("threshold", ""))
        self.decision_type = _ints(block.get("decision_type", "")) \
            if block.get("decision_type") else np.zeros(n_int, np.int64)
        self.left = _ints(block.get("left_child", ""))
        self.right = _ints(block.get("right_child", ""))
        for name, arr in (("split_feature", self.split_feature),
                          ("threshold", self.threshold),
                          ("decision_type", self.decision_type),
                          ("left_child", self.left),
                          ("right_child", self.right)):
            _require(arr.shape[0] == n_int,
                     f"Tree={idx}: {name} length {arr.shape[0]} != {n_int}")
        self.cat_boundaries = _ints(block.get("cat_boundaries", ""))
        self.cat_threshold = _ints(block.get("cat_threshold", ""))

    def _child(self, c: int) -> dict:
        if c < 0:
            return {"leaf": float(self.leaf_value[~c])}
        return self._node(int(c))

    def _node(self, j: int) -> dict:
        _require(0 <= j < self.num_leaves - 1,
                 f"Tree={self.idx}: internal node index {j} out of range")
        f = int(self.split_feature[j])
        left, right = self._child(int(self.left[j])), self._child(int(self.right[j]))
        if int(self.decision_type[j]) & 1:  # categorical
            cat_idx = int(self.threshold[j])
            _require(0 <= cat_idx and cat_idx + 2 <= len(self.cat_boundaries),
                     f"Tree={self.idx}: cat_boundaries missing slot {cat_idx}")
            lo, hi = int(self.cat_boundaries[cat_idx]), int(self.cat_boundaries[cat_idx + 1])
            cats = _member_categories(self.cat_threshold[lo:hi])
            _require(cats.size > 0,
                     f"Tree={self.idx}: empty categorical bitset at node {j}")
            runs = _runs(cats)
            self.n_expanded += 1
            chain = _categorical_chain(runs, member=left, nonmember=right)
            return {"f": f, "t": chain["t"], "l": chain["l"], "r": chain["r"]}
        # numerical: x <= t goes left  ->  x < nextafter(t, +inf)
        return {"f": f, "t": float(np.nextafter(self.threshold[j], np.inf)),
                "l": left, "r": right}

    def build(self) -> ImportedTree:
        if self.num_leaves == 1:  # constant tree
            root: dict = {"leaf": float(self.leaf_value[0])}
        else:
            root = self._node(0)
        feature, threshold, left, right, value = [], [], [], [], []

        def emit(node: dict, cat_f: int | None = None) -> int:
            pos = len(feature)
            feature.append(-1); threshold.append(0.0)
            left.append(-1); right.append(-1); value.append(0.0)
            if "leaf" in node:
                value[pos] = node["leaf"]
                return pos
            f = node["f"] if node["f"] is not None else cat_f
            feature[pos] = int(f)
            threshold[pos] = float(node["t"])
            # chain nodes created by the categorical expansion carry f=None
            # and inherit the categorical split's feature index
            left[pos] = emit(node["l"], cat_f=f)
            right[pos] = emit(node["r"], cat_f=f)
            return pos

        emit(root)
        return ImportedTree(
            feature=np.asarray(feature, dtype=np.int32),
            threshold=np.asarray(threshold, dtype=np.float64),
            left=np.asarray(left, dtype=np.int32),
            right=np.asarray(right, dtype=np.int32),
            value=np.asarray(value, dtype=np.float64),
        )


def import_lightgbm_text(doc: str | Path) -> ImportedEnsemble:
    """Parse a LightGBM ``save_model`` text dump (text or path)."""
    if isinstance(doc, Path) or (isinstance(doc, str) and "\n" not in doc
                                 and Path(doc).exists()):
        doc = Path(doc).read_text()
    lines = doc.splitlines()
    _require(any(ln.strip() == "tree" for ln in lines[:5]),
             "missing 'tree' magic in header (is this Booster.save_model text?)")

    # split into blank-line-separated blocks; Tree=i blocks carry trees
    blocks: list[list[str]] = [[]]
    for ln in lines:
        if ln.strip():
            blocks[-1].append(ln)
        elif blocks[-1]:
            blocks.append([])
    header = _kv_block(blocks[0], "header")
    tree_blocks = [b for b in blocks if b and b[0].startswith("Tree=")]
    _require(bool(tree_blocks), "no Tree= blocks found")
    _require(any(ln.strip() == "end of trees" for b in blocks for ln in b),
             "missing 'end of trees' terminator (truncated dump?)")

    n_features = int(header.get("max_feature_idx", -1)) + 1
    _require(n_features > 0, "missing max_feature_idx")
    num_class = int(header.get("num_class", 1))
    per_iter = int(header.get("num_tree_per_iteration", 1))
    objective = header.get("objective", "regression")

    if objective.startswith(("binary",)):
        task, n_outputs = "binary", 1
    elif objective.startswith(("multiclass", "multiclassova")):
        _require(num_class >= 2, "multiclass objective with num_class < 2")
        task, n_outputs = "multiclass", num_class
    elif objective.startswith(("regression", "mape", "huber", "fair",
                               "poisson", "quantile", "gamma", "tweedie")):
        task, n_outputs = "regression", 1
    else:
        raise IngestError(
            f"lightgbm-text: objective {objective!r} unsupported "
            "(binary / multiclass / regression families only)"
        )

    trees, n_expanded = [], 0
    for i, b in enumerate(tree_blocks):
        builder = _TreeBuilder(_kv_block(b, f"Tree={i}"), i)
        trees.append(builder.build())
        n_expanded += builder.n_expanded
    tree_class = (np.arange(len(trees)) % per_iter if n_outputs > 1
                  else np.zeros(len(trees))).astype(np.int32)
    _require(n_outputs == 1 or per_iter == n_outputs,
             f"num_tree_per_iteration={per_iter} != num_class={num_class}")

    notes = []
    if n_expanded:
        notes.append(f"{n_expanded} categorical splits lowered to "
                     "threshold-interval chains")
    if any(int(d) & ~1 for b in tree_blocks
           for d in _kv_block(b, "t").get("decision_type", "").split()):
        notes.append("missing-value default directions ignored "
                     "(serve finite features)")
    return ImportedEnsemble(
        trees=trees,
        n_features=n_features,
        task=task,
        n_outputs=n_outputs,
        tree_class=tree_class,
        base_score=np.zeros(n_outputs, dtype=np.float64),
        source="lightgbm-text",
        source_kind="gbdt",
        n_classes=(num_class if task == "multiclass"
                   else (2 if task == "binary" else 1)),
        notes=notes,
    )
