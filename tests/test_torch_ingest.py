"""The port's ingestion frontend held to the JAX package's.

Each importer gives the JAX package's IR array for array on every golden
dump; ``lower_to_ensemble`` gives equal trees, an equal grid and an equal
report; ``load_model``/``detect_format`` route the same way; the
``IngestError`` cases of ``tests/test_ingest.py`` raise the same errors in
the port; and ``to_xgboost_json`` exports the same document and round
trips bit-exactly.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import repro.ingest as jin
import repro_torch.ingest as tin
from repro.core.quantize import FeatureQuantizer as JQuantizer
from repro.core.trees import GBDTParams as JGBDTParams
from repro.core.trees import train_gbdt as j_train_gbdt
from repro_torch.core.quantize import FeatureQuantizer as TQuantizer
from repro_torch.core.trees import GBDTParams as TGBDTParams
from repro_torch.core.trees import Ensemble as TEnsemble
from repro_torch.core.trees import train_gbdt as t_train_gbdt

FIXTURES = Path(__file__).parent / "fixtures" / "ingest"
DUMPS = sorted(
    p for p in FIXTURES.iterdir()
    if p.suffix in (".json", ".txt") and ".expected" not in p.name
)
FORMAT_OF = {"xgb": "xgboost-json", "lgbm": "lightgbm-text", "sk": "sklearn-dict"}
IMPORTER = {"xgboost-json": "import_xgboost_json", "lightgbm-text": "import_lightgbm_text",
            "sklearn-dict": "import_sklearn_dict"}
TREE_ARRAYS = ("feature", "threshold", "left", "right", "value")


def _fmt(dump: Path) -> str:
    return FORMAT_OF[dump.name.split("_")[0]]


def _payload(dump: Path):
    text = dump.read_text()
    return text if _fmt(dump) == "lightgbm-text" else json.loads(text)


def _assert_same_array(a, b, what) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _assert_same_ir(j, t) -> None:
    assert type(t).__name__ == "ImportedEnsemble"
    for name in ("n_features", "task", "n_outputs", "source", "source_kind",
                 "n_classes", "notes", "n_trees", "uniform_base"):
        assert getattr(t, name) == getattr(j, name), name
    _assert_same_array(j.tree_class, t.tree_class, "tree_class")
    _assert_same_array(j.base_score, t.base_score, "base_score")
    for i, (jt, tt) in enumerate(zip(j.trees, t.trees, strict=True)):
        for name in TREE_ARRAYS:
            _assert_same_array(getattr(jt, name), getattr(tt, name), f"tree {i} {name}")
    for jt, tt in zip(j.thresholds_per_feature(), t.thresholds_per_feature(), strict=True):
        _assert_same_array(jt, tt, "thresholds_per_feature")


def _assert_same_ensemble(j, t) -> None:
    for name in ("n_bins", "task", "n_classes", "kind", "base_score", "leaf_class_mode"):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("tree_class", "leaf_class"):
        jv, tv = getattr(j, name), getattr(t, name)
        assert (jv is None) == (tv is None), name
        if jv is not None:
            for a, b in zip(jv, tv, strict=True):
                _assert_same_array(a, b, name)
    for i, (jt, tt) in enumerate(zip(j.trees, t.trees, strict=True)):
        for name in TREE_ARRAYS:
            _assert_same_array(getattr(jt, name), getattr(tt, name), f"tree {i} {name}")


def _assert_same_quantizer(j, t) -> None:
    assert t.n_bins == j.n_bins
    for a, b in zip(j.edges, t.edges, strict=True):
        _assert_same_array(a, b, "edges")


@pytest.mark.parametrize("dump", DUMPS, ids=lambda p: p.name)
def test_importer_gives_the_jax_ir(dump):
    """Each format's importer, from the parsed payload and from the path."""
    name = IMPORTER[_fmt(dump)]
    j = getattr(jin, name)(_payload(dump))
    t = getattr(tin, name)(_payload(dump))
    _assert_same_ir(j, t)
    _assert_same_ir(j, getattr(tin, name)(dump))
    x = np.random.default_rng(5).normal(size=(40, t.n_features)) * 3.0
    _assert_same_array(j.raw_margin(x), t.raw_margin(x), "raw_margin")
    _assert_same_array(j.predict(x), t.predict(x), "predict")


@pytest.mark.parametrize("n_bins", [256, 8])
@pytest.mark.parametrize("dump", DUMPS, ids=lambda p: p.name)
def test_lowering_gives_equal_trees_grid_and_report(dump, n_bins):
    """``lower_to_ensemble`` at the default grid and at one too small for
    the model (thresholds merged, splits remapped: an inexact report)."""
    jens, jq, jrep = jin.lower_to_ensemble(jin.load_model(dump), n_bins=n_bins)
    tens, tq, trep = tin.lower_to_ensemble(tin.load_model(dump), n_bins=n_bins)
    assert isinstance(tens, TEnsemble) and isinstance(tq, TQuantizer)
    _assert_same_ensemble(jens, tens)
    _assert_same_quantizer(jq, tq)
    assert trep.to_dict() == jrep.to_dict()
    assert trep.occupancy_summary() == jrep.occupancy_summary()
    x = np.random.default_rng(6).normal(size=(50, tq.n_features)) * 3.0
    _assert_same_array(jq.transform(x), tq.transform(x), "transform")
    _assert_same_array(jens.raw_margin(jq.transform(x)), tens.raw_margin(tq.transform(x)),
                       "lowered raw_margin")


@pytest.mark.parametrize("dump", DUMPS, ids=lambda p: p.name)
@pytest.mark.parametrize("format", ["auto", "explicit"])
def test_load_model_and_detect_format(dump, format):
    fmt = _fmt(dump) if format == "explicit" else "auto"
    assert tin.detect_format(dump) == jin.detect_format(dump) == _fmt(dump)
    _assert_same_ir(jin.load_model(dump, format=fmt), tin.load_model(dump, format=fmt))


def test_formats_and_exports_match():
    assert tin.FORMATS == jin.FORMATS
    assert sorted(tin.__all__) == sorted(jin.__all__)


def _raises_alike(fn_name: str, arg, match: str | None = None):
    """The same call raises ``IngestError`` with the same message in both
    packages."""
    msgs = []
    for pkg in (jin, tin):
        with pytest.raises(pkg.IngestError, match=match) as info:
            getattr(pkg, fn_name)(arg)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


def test_malformed_xgboost_paths():
    _raises_alike("import_xgboost_json", {"not": "a model"}, "learner")
    _raises_alike("import_xgboost_json", "{broken", "valid JSON")
    doc = json.loads((FIXTURES / "xgb_binary.json").read_text())
    doc["learner"]["objective"]["name"] = "rank:pairwise"
    _raises_alike("import_xgboost_json", doc, "rank:pairwise")
    doc = json.loads((FIXTURES / "xgb_binary.json").read_text())
    trees = doc["learner"]["gradient_booster"]["model"]["trees"]
    trees[0]["split_type"] = [1] * len(trees[0]["split_type"])
    _raises_alike("import_xgboost_json", doc, "categorical")
    doc = json.loads((FIXTURES / "xgb_binary.json").read_text())
    doc["learner"]["gradient_booster"]["model"]["trees"][0]["left_children"] = [999]
    _raises_alike("import_xgboost_json", doc)


def test_malformed_lightgbm_paths():
    good = (FIXTURES / "lgbm_binary.txt").read_text()
    _raises_alike("import_lightgbm_text", "not a model\n", "magic")
    _raises_alike("import_lightgbm_text", good.split("end of trees")[0], "truncated")
    _raises_alike("import_lightgbm_text",
                  good.replace("objective=binary sigmoid:1", "objective=lambdarank"),
                  "objective")
    _raises_alike("import_lightgbm_text", good.replace("split_feature=0 1", "split_feature=0"),
                  "length")


def test_malformed_sklearn_paths():
    good = json.loads((FIXTURES / "sk_rf_cls.json").read_text())
    _raises_alike("import_sklearn_dict", {"format": "pickle"}, "format")
    _raises_alike("import_sklearn_dict", dict(good, kind="extra-trees"), "kind")
    bad = json.loads(json.dumps(good))
    bad["trees"][0].pop("children_left")
    _raises_alike("import_sklearn_dict", bad, "children_left")
    bad = json.loads(json.dumps(good))
    bad["trees"][0]["value"] = [[1.0]] * len(bad["trees"][0]["feature"])
    _raises_alike("import_sklearn_dict", bad, "class counts")


def test_load_model_errors_and_content_sniffing(tmp_path):
    mislabeled = tmp_path / "model.txt"
    mislabeled.write_text((FIXTURES / "xgb_binary.json").read_text())
    assert tin.detect_format(mislabeled) == "xgboost-json"
    assert tin.load_model(mislabeled).source == "xgboost-json"
    stray = tmp_path / "model.json"
    stray.write_text('{"weights": [1, 2]}')
    _raises_alike("load_model", stray, "neither")
    _raises_alike("load_model", tmp_path / "nope.json", "not found")
    for pkg in (jin, tin):
        with pytest.raises(pkg.IngestError, match="unknown format"):
            pkg.load_model(stray, format="onnx")


def test_overflow_raise_is_an_ingest_error():
    imported = [pkg.load_model(FIXTURES / "xgb_deep.json") for pkg in (jin, tin)]
    msgs = []
    for pkg, imp in zip((jin, tin), imported):
        with pytest.raises(pkg.IngestError, match="exceed") as info:
            pkg.lower_to_ensemble(imp, n_bins=4, on_overflow="raise")
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("task,n_classes", [("regression", 1), ("binary", 2), ("multiclass", 3)])
@pytest.mark.parametrize("with_grid", [False, True])
def test_to_xgboost_json_round_trip(task, n_classes, with_grid):
    """A native GBDT (trained the same in both packages) exports to the
    same XGBoost document, with bin or float thresholds, and re-ingests
    to bit-equal margins and predictions on binned inputs."""
    rng = np.random.default_rng(7)
    n, F, B = 240, 5, 32
    x = rng.normal(size=(n, F))
    if task == "regression":
        y = x[:, 0] - 0.5 * x[:, 2] + 0.1 * rng.normal(size=n)
    else:
        y = (np.digitize(x[:, 0] + 0.5 * x[:, 1], [-0.5, 0.5]) % n_classes).astype(np.int64)
    jq, tq = JQuantizer.fit(x, B), TQuantizer.fit(x, B)
    xb = tq.transform(x)
    _assert_same_array(jq.transform(x), xb, "binned")
    kw = dict(task=task, n_bins=B, n_classes=n_classes)
    jens = j_train_gbdt(xb, y, params=JGBDTParams(n_rounds=3, max_leaves=8, seed=1), **kw)
    tens = t_train_gbdt(xb, y, params=TGBDTParams(n_rounds=3, max_leaves=8, seed=1), **kw)
    jdoc = jin.to_xgboost_json(jens, jq if with_grid else None)
    tdoc = tin.to_xgboost_json(tens, tq if with_grid else None)
    assert json.dumps(tdoc) == json.dumps(jdoc)
    low, q2, report = tin.lower_to_ensemble(tin.import_xgboost_json(tdoc), n_bins=B)
    assert report.exact
    xq = q2.transform(x if with_grid else xb.astype(np.float64))
    np.testing.assert_array_equal(low.raw_margin(xq), tens.raw_margin(xb))
    np.testing.assert_array_equal(low.predict(xq), tens.predict(xb))
