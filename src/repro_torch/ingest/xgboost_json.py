"""XGBoost JSON importer/exporter (``Booster.save_model('model.json')``).

Zero-dependency: parses the documented JSON schema directly — the
container never needs xgboost installed.  Supported:

  * boosters: ``gbtree`` and ``dart`` (per-tree ``weight_drop`` folded
    into the leaf values at import, so DART inference is exact).
  * objectives: ``reg:squarederror``/``reg:linear`` (regression),
    ``reg:logistic``/``binary:logistic`` (single-logit binary; the saved
    probability-space ``base_score`` is mapped to margin space with
    logit, mirroring ``ObjFunction::ProbToMargin``), ``binary:logitraw``,
    ``multi:softmax``/``multi:softprob`` (one tree per class per round,
    classes from ``tree_info``).

Rejected with a clear ``IngestError``: categorical splits
(``split_type != 0`` / non-empty ``categories_nodes`` — XGBoost's
partition sets are not representable on the threshold grid without the
library's category codes), ``gblinear``, ranking objectives, and
multi-target leaf vectors (``size_leaf_vector > 1``).

Split convention: XGBoost descends LEFT when ``x < split_condition``
(strict), which is already the IR convention — thresholds pass through
untouched.  Missing-value ``default_left`` routing is NOT modeled: the
engine serves finite features (the quantizer bins NaN to the lowest
bin), so importers record a note instead of silently diverging.

``to_xgboost_json`` is the inverse: it exports a native binned
``Ensemble`` (optionally through a ``FeatureQuantizer`` for float-space
thresholds) into this same schema — the round-trip property test and
the golden-fixture generator both use it.

A copy of ``repro.ingest.xgboost_json``: the port imports nothing of
``repro``.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from repro_torch.ingest.ir import ImportedEnsemble, ImportedTree, IngestError

_REGRESSION = ("reg:squarederror", "reg:linear", "reg:squaredlogerror",
               "reg:pseudohubererror", "reg:absoluteerror")
_LOGISTIC = ("binary:logistic", "reg:logistic")
_BINARY_RAW = ("binary:logitraw",)
_MULTI = ("multi:softmax", "multi:softprob")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise IngestError(f"xgboost-json: {msg}")


def _parse_tree(t: dict, idx: int, weight: float) -> ImportedTree:
    _require(isinstance(t, dict), f"tree {idx} is not an object")
    for key in ("left_children", "right_children", "split_indices",
                "split_conditions"):
        _require(key in t, f"tree {idx} missing {key!r}")
    left = np.asarray(t["left_children"], dtype=np.int32)
    right = np.asarray(t["right_children"], dtype=np.int32)
    split_idx = np.asarray(t["split_indices"], dtype=np.int64)
    cond = np.asarray(t["split_conditions"], dtype=np.float64)
    if t.get("categories_nodes") or any(st != 0 for st in t.get("split_type", ())):
        raise IngestError(
            "xgboost-json: categorical splits (split_type=1) are not "
            "supported — export the model with numeric-encoded features"
        )
    size_leaf = int(t.get("tree_param", {}).get("size_leaf_vector", "1") or 1)
    _require(size_leaf <= 1, f"tree {idx}: multi-target leaf vectors unsupported")
    is_leaf = left < 0
    # split_conditions doubles as the leaf value at leaf nodes
    feature = np.where(is_leaf, -1, split_idx).astype(np.int32)
    threshold = np.where(is_leaf, 0.0, cond)
    value = np.where(is_leaf, cond * weight, 0.0)
    return ImportedTree(
        feature=feature,
        threshold=threshold,
        left=left,
        right=np.where(is_leaf, -1, right).astype(np.int32),
        value=value,
    )


def import_xgboost_json(doc: dict | str | Path) -> ImportedEnsemble:
    """Parse an XGBoost ``save_model`` JSON document (dict, text, or path)."""
    if isinstance(doc, (str, Path)):
        p = Path(doc)
        text = p.read_text() if p.exists() else str(doc)
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise IngestError(f"xgboost-json: not valid JSON ({e})") from None
    _require(isinstance(doc, dict) and "learner" in doc,
             "missing top-level 'learner' (is this a Booster.save_model dump?)")
    learner = doc["learner"]
    booster = learner.get("gradient_booster", {})
    name = booster.get("name", "gbtree")

    weights: np.ndarray | None = None
    if name == "dart":
        weights = np.asarray(booster.get("weight_drop", ()), dtype=np.float64)
        booster = booster.get("gbtree", booster)
        name = "dart"
    elif name != "gbtree":
        raise IngestError(
            f"xgboost-json: booster {name!r} unsupported (gbtree/dart only)"
        )
    model = booster.get("model", booster)
    trees_json = model.get("trees")
    _require(isinstance(trees_json, list) and trees_json,
             "no trees under gradient_booster.model.trees")
    if weights is not None:
        _require(len(weights) == len(trees_json),
                 "dart weight_drop length != number of trees")

    mp = learner.get("learner_model_param", {})
    n_features = int(mp.get("num_feature", 0) or 0)
    num_class = int(mp.get("num_class", 0) or 0)
    base_raw = float(mp.get("base_score", 0.0) or 0.0)
    objective = learner.get("objective", {}).get("name", "reg:squarederror")

    if objective in _REGRESSION:
        task, n_outputs, base = "regression", 1, base_raw
    elif objective in _LOGISTIC:
        _require(0.0 < base_raw < 1.0,
                 f"base_score {base_raw} outside (0,1) for {objective}")
        task, n_outputs = "binary", 1
        base = math.log(base_raw / (1.0 - base_raw))  # ProbToMargin
    elif objective in _BINARY_RAW:
        task, n_outputs, base = "binary", 1, base_raw
    elif objective in _MULTI:
        _require(num_class >= 2, f"{objective} needs num_class >= 2")
        task, n_outputs, base = "multiclass", num_class, base_raw
    else:
        raise IngestError(
            f"xgboost-json: objective {objective!r} unsupported "
            f"(supported: {_REGRESSION + _LOGISTIC + _BINARY_RAW + _MULTI})"
        )

    tree_info = model.get("tree_info") or [0] * len(trees_json)
    _require(len(tree_info) == len(trees_json),
             "tree_info length != number of trees")
    trees = [
        _parse_tree(t, i, float(weights[i]) if weights is not None else 1.0)
        for i, t in enumerate(trees_json)
    ]
    if not n_features:  # older dumps leave num_feature=0; infer from splits
        n_features = 1 + max(
            (int(t.feature.max(initial=-1)) for t in trees), default=-1
        )
        _require(n_features > 0, "cannot infer num_feature (no splits)")

    notes = []
    if any(t.get("default_left") and any(t["default_left"]) for t in trees_json):
        notes.append("default_left missing-value routing ignored "
                     "(serve finite features)")
    if weights is not None:
        notes.append(f"dart: {len(weights)} weight_drop factors folded into leaves")
    return ImportedEnsemble(
        trees=trees,
        n_features=n_features,
        task=task,
        n_outputs=n_outputs,
        tree_class=np.asarray(tree_info, dtype=np.int32),
        base_score=np.full(n_outputs, base, dtype=np.float64),
        source="xgboost-json",
        source_kind="dart" if weights is not None else "gbdt",
        n_classes=(num_class if task == "multiclass"
                   else (2 if task == "binary" else 1)),
        notes=notes,
    )


# ---------------------------------------------------------------------------
# Export: native binned Ensemble -> the same JSON schema
# ---------------------------------------------------------------------------


def to_xgboost_json(ens, quantizer=None) -> dict:
    """Serialize a native GBDT ``Ensemble`` as an XGBoost-JSON dump.

    Bin-split ``bin < t`` becomes float split ``x < thr`` with
    ``thr = quantizer.threshold_value(f, t)`` when a quantizer is given
    (float-space export), else ``thr = float(t)`` (bin indices are the
    feature space).  Re-importing yields bit-identical margins — the
    hypothesis round-trip in tests/test_ingest.py.
    """
    if ens.kind != "gbdt" or ens.leaf_class_mode != "tree":
        raise IngestError("to_xgboost_json: only GBDT tree-class ensembles")
    if ens.task == "regression":
        objective, base, num_class = "reg:squarederror", ens.base_score, 0
    elif ens.task == "binary":
        objective, num_class = "binary:logitraw", 0
        base = ens.base_score  # logitraw keeps margin space: exact round trip
    else:
        objective, base, num_class = "multi:softprob", ens.base_score, ens.n_classes

    trees_json = []
    for tree in ens.trees:
        is_leaf = tree.feature < 0
        cond = np.where(
            is_leaf,
            tree.value.astype(np.float64),
            [0.0 if lf else (
                float(quantizer.threshold_value(int(f), int(t))) if quantizer
                else float(t))
             for lf, f, t in zip(is_leaf, tree.feature, tree.threshold)],
        )
        n = tree.n_nodes
        trees_json.append({
            "base_weights": [0.0] * n,
            "categories": [], "categories_nodes": [],
            "categories_segments": [], "categories_sizes": [],
            "default_left": [0] * n,
            "id": len(trees_json),
            "left_children": tree.left.tolist(),
            "loss_changes": [0.0] * n,
            "parents": [2147483647] * n,
            "right_children": tree.right.tolist(),
            "split_conditions": [float(c) for c in cond],
            "split_indices": np.maximum(tree.feature, 0).tolist(),
            "split_type": [0] * n,
            "sum_hessian": [0.0] * n,
            "tree_param": {
                "num_deleted": "0", "num_feature": str(ens.n_features),
                "num_nodes": str(n), "size_leaf_vector": "1",
            },
        })
    tree_class = (ens.tree_class if ens.tree_class is not None
                  else np.zeros(ens.n_trees, dtype=np.int32))
    return {
        "learner": {
            "attributes": {},
            "feature_names": [], "feature_types": [],
            "gradient_booster": {
                "model": {
                    "gbtree_model_param": {
                        "num_parallel_tree": "1",
                        "num_trees": str(len(trees_json)),
                    },
                    "tree_info": [int(c) for c in tree_class],
                    "trees": trees_json,
                },
                "name": "gbtree",
            },
            "learner_model_param": {
                "base_score": repr(float(base)),
                "boost_from_average": "1",
                "num_class": str(num_class),
                "num_feature": str(ens.n_features),
                "num_target": "1",
            },
            "objective": {"name": objective},
        },
        "version": [2, 0, 0],
    }
