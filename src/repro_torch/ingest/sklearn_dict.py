"""Generic sklearn-forest dict importer.

scikit-learn has no portable dump format, so this repo defines one — a
JSON document mirroring the public ``tree_`` arrays, producible with a
five-line export loop and no sklearn on the serving side:

    {"format": "sklearn-forest",
     "kind": "rf" | "gbdt",
     "task": "regression" | "binary" | "multiclass",
     "n_features": F, "n_classes": C,
     "learning_rate": 0.1,          # gbdt only (default 1.0)
     "init": 0.0 | [b_0, ..., b_C],  # gbdt intercept(s) (default 0)
     "trees": [
       {"feature": tree_.feature,            # < 0 (sklearn: -2) => leaf
        "threshold": tree_.threshold,        # x <= threshold -> left
        "children_left": tree_.children_left,
        "children_right": tree_.children_right,
        "value": tree_.value,   # (n_nodes,) scalar, or (n_nodes, C)
                                # class counts/probabilities for rf
        "class": 0}]}           # gbdt multiclass: channel of this tree

Lowering semantics (all exact):

  * ``gbdt``: leaf = value * learning_rate, summed; per-class ``init``
    intercepts become base scores (wildcard bias rows when they differ).
  * ``rf`` regression: leaf = value / n_trees, summed == forest mean.
  * ``rf`` classification: each tree's per-leaf class-count rows are
    normalized to probabilities and the tree is REPLICATED per class —
    class c's copy carries leaf = p(c) / n_trees on channel c.  The
    summed margins equal sklearn's averaged ``predict_proba`` exactly,
    so ``argmax`` matches ``predict``; CAM rows grow by the factor C
    (recorded in the ingest report).

``<=`` splits are normalized to strict ``<`` with nextafter, like the
LightGBM importer.

A copy of ``repro.ingest.sklearn_dict``: the port imports nothing of
``repro``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from repro_torch.ingest.ir import ImportedEnsemble, ImportedTree, IngestError

FORMAT = "sklearn-forest"


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise IngestError(f"sklearn-dict: {msg}")


def _tree_arrays(t: dict, idx: int) -> tuple[np.ndarray, ...]:
    for key in ("feature", "threshold", "children_left", "children_right",
                "value"):
        _require(key in t, f"tree {idx} missing {key!r}")
    feature = np.asarray(t["feature"], dtype=np.int32)
    feature = np.where(feature < 0, -1, feature)  # sklearn leaf marker is -2
    threshold = np.asarray(t["threshold"], dtype=np.float64)
    left = np.asarray(t["children_left"], dtype=np.int32)
    right = np.asarray(t["children_right"], dtype=np.int32)
    value = np.asarray(t["value"], dtype=np.float64)
    # x <= t -> left  ==>  x < nextafter(t, +inf) -> left
    threshold = np.where(feature >= 0, np.nextafter(threshold, np.inf), 0.0)
    return feature, threshold, left, right, value


def import_sklearn_dict(doc: dict | str | Path) -> ImportedEnsemble:
    """Parse a sklearn-forest dict dump (dict, JSON text, or path)."""
    if isinstance(doc, (str, Path)):
        p = Path(doc)
        text = p.read_text() if p.exists() else str(doc)
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise IngestError(f"sklearn-dict: not valid JSON ({e})") from None
    _require(isinstance(doc, dict), "dump is not a JSON object")
    _require(doc.get("format") == FORMAT,
             f"format {doc.get('format')!r} != {FORMAT!r}")
    kind = doc.get("kind")
    task = doc.get("task")
    _require(kind in ("rf", "gbdt"), f"kind {kind!r} not in ('rf', 'gbdt')")
    _require(task in ("regression", "binary", "multiclass"),
             f"task {task!r} unsupported")
    n_features = int(doc.get("n_features", 0))
    _require(n_features > 0, "missing/zero n_features")
    n_classes = int(doc.get("n_classes", 1))
    _require(task != "multiclass" or n_classes >= 2,
             "task 'multiclass' needs n_classes >= 2")
    trees_json = doc.get("trees")
    _require(isinstance(trees_json, list) and trees_json, "no trees")
    lr = float(doc.get("learning_rate", 1.0))
    n_trees = len(trees_json)
    notes: list[str] = []

    trees: list[ImportedTree] = []
    tree_class: list[int] = []

    if kind == "rf" and task != "regression":
        C = max(2, n_classes)
        n_outputs = C
        for i, t in enumerate(trees_json):
            feature, threshold, left, right, value = _tree_arrays(t, i)
            _require(value.ndim == 2 and value.shape[1] == C,
                     f"tree {i}: rf classifier value must be (n_nodes, "
                     f"{C}) class counts")
            row_sum = value.sum(axis=1, keepdims=True)
            _require(bool(np.all(row_sum[feature < 0] > 0)),
                     f"tree {i}: leaf with empty class-count row")
            proba = value / np.where(row_sum > 0, row_sum, 1.0)
            for c in range(C):  # one channel-c copy per class
                trees.append(ImportedTree(
                    feature=feature, threshold=threshold, left=left,
                    right=right,
                    value=np.where(feature < 0, proba[:, c] / n_trees, 0.0),
                ))
                tree_class.append(c)
        base = np.zeros(n_outputs)
        notes.append(
            f"rf classifier: {n_trees} trees replicated x{C} classes "
            "(margins == averaged predict_proba)"
        )
        source_kind = "rf"
    else:
        n_outputs = n_classes if task == "multiclass" else 1
        scale = lr if kind == "gbdt" else 1.0 / n_trees
        for i, t in enumerate(trees_json):
            feature, threshold, left, right, value = _tree_arrays(t, i)
            if value.ndim == 2:
                _require(value.shape[1] == 1,
                         f"tree {i}: expected scalar leaf values")
                value = value[:, 0]
            trees.append(ImportedTree(
                feature=feature, threshold=threshold, left=left, right=right,
                value=np.where(feature < 0, value * scale, 0.0),
            ))
            c = int(t.get("class", 0))
            _require(0 <= c < n_outputs,
                     f"tree {i}: class {c} outside [0, {n_outputs})")
            tree_class.append(c)
        init = doc.get("init", 0.0) if kind == "gbdt" else 0.0
        base = np.broadcast_to(
            np.asarray(init, dtype=np.float64), (n_outputs,)
        ).copy()
        if kind == "rf":
            notes.append(f"rf regression: leaves pre-scaled by 1/{n_trees} "
                         "(margins == forest mean)")
        source_kind = kind

    return ImportedEnsemble(
        trees=trees,
        n_features=n_features,
        task=task,
        n_outputs=n_outputs,
        tree_class=np.asarray(tree_class, dtype=np.int32),
        base_score=base,
        source="sklearn-dict",
        source_kind=source_kind,
        n_classes=(n_classes if task == "multiclass"
                   else (2 if task == "binary" else 1)),
        notes=notes,
    )
