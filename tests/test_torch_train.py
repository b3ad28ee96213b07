"""The port's trainers, datasets and hardware-aware search held to the JAX
package's.

``train_gbdt`` and ``train_rf`` grow the same trees node for node from the
same binned data and seed, for every task; ``make_dataset`` makes the same
arrays byte for byte; ``random_search`` with a few trials on a small split
samples the same trials and returns the same winner.
"""

import dataclasses

import numpy as np
import pytest

import repro.core.trees as jtrees
import repro.core.tune as jtune
import repro.data.tabular as jdata
import repro_torch
import repro_torch.core.trees as ttrees
import repro_torch.core.tune as ttune
import repro_torch.data.tabular as tdata
from repro.core.quantize import FeatureQuantizer as JQuantizer
from repro_torch.core.quantize import FeatureQuantizer as TQuantizer

TASKS = [("regression", 1), ("binary", 2), ("multiclass", 3)]
TREE_ARRAYS = ("feature", "threshold", "left", "right", "value")


def _same(a, b, what) -> None:
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _assert_same_ensemble(j, t) -> None:
    assert type(t) is ttrees.Ensemble
    for name in ("n_features", "n_bins", "task", "kind", "n_classes", "base_score",
                 "leaf_class_mode", "n_outputs_override", "n_trees", "max_leaves"):
        assert getattr(t, name) == getattr(j, name), name
    assert (j.tree_class is None) == (t.tree_class is None)
    if j.tree_class is not None:
        _same(j.tree_class, t.tree_class, "tree_class")
    assert len(j.leaf_class) == len(t.leaf_class)
    for a, b in zip(j.leaf_class, t.leaf_class):
        _same(a, b, "leaf_class")
    for i, (jt, tt) in enumerate(zip(j.trees, t.trees, strict=True)):
        for name in TREE_ARRAYS:
            _same(getattr(jt, name), getattr(tt, name), f"tree {i} {name}")


def _problem(task: str, n_classes: int, n: int = 300, f: int = 6, n_bins: int = 32):
    rng = np.random.default_rng(21)
    x = rng.normal(size=(n, f))
    if task == "regression":
        y = x[:, 0] * 2.0 - x[:, 1] ** 2 + 0.1 * rng.normal(size=n)
    else:
        score = x[:, 0] + 0.7 * x[:, 2] * x[:, 3] + 0.2 * rng.normal(size=n)
        y = np.digitize(score, np.quantile(score, np.linspace(0, 1, n_classes + 1)[1:-1]))
        y = y.astype(np.int64)
    xb = TQuantizer.fit(x, n_bins).transform(x)
    _same(JQuantizer.fit(x, n_bins).transform(x), xb, "binned")
    return xb, y, n_bins


@pytest.mark.parametrize("sub", [False, True], ids=["full", "subsampled"])
@pytest.mark.parametrize("task,n_classes", TASKS, ids=[t for t, _ in TASKS])
def test_train_gbdt_node_for_node(task, n_classes, sub):
    xb, y, n_bins = _problem(task, n_classes)
    kw = dict(n_rounds=4, max_leaves=16, max_depth=5, seed=9)
    if sub:
        kw.update(subsample=0.7, colsample=0.6, learning_rate=0.3, reg_lambda=2.0)
    common = dict(task=task, n_bins=n_bins, n_classes=n_classes)
    j = jtrees.train_gbdt(xb, y, params=jtrees.GBDTParams(**kw), **common)
    t = ttrees.train_gbdt(xb, y, params=ttrees.GBDTParams(**kw), **common)
    _assert_same_ensemble(j, t)
    _same(j.raw_margin(xb), t.raw_margin(xb), "raw_margin")
    _same(j.predict(xb), t.predict(xb), "predict")


@pytest.mark.parametrize("bootstrap", [True, False])
@pytest.mark.parametrize("task,n_classes", TASKS, ids=[t for t, _ in TASKS])
def test_train_rf_node_for_node(task, n_classes, bootstrap):
    xb, y, n_bins = _problem(task, n_classes)
    kw = dict(n_trees=5, max_leaves=32, max_depth=9, colsample=0.7, bootstrap=bootstrap,
              seed=4)
    common = dict(task=task, n_bins=n_bins, n_classes=n_classes)
    j = jtrees.train_rf(xb, y, params=jtrees.RFParams(**kw), **common)
    t = ttrees.train_rf(xb, y, params=ttrees.RFParams(**kw), **common)
    _assert_same_ensemble(j, t)
    _same(j.raw_margin(xb), t.raw_margin(xb), "raw_margin")
    _same(j.predict(xb), t.predict(xb), "predict")


def test_params_defaults_match():
    for name in ("GBDTParams", "RFParams"):
        assert (dataclasses.asdict(getattr(ttrees, name)())
                == dataclasses.asdict(getattr(jtrees, name)()))
    assert dataclasses.asdict(ttune.HWConstraints()) == dataclasses.asdict(jtune.HWConstraints())


@pytest.mark.parametrize("name", sorted(jdata.PAPER_DATASETS))
def test_make_dataset_is_byte_equal(name):
    assert tdata.PAPER_DATASETS == jdata.PAPER_DATASETS
    j, t = jdata.make_dataset(name, seed=3), tdata.make_dataset(name, seed=3)
    for f in dataclasses.fields(jdata.TabularDataset):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(a, np.ndarray):
            _same(a, b, f.name)
        else:
            assert a == b, f.name
    assert t.n_features == j.n_features


def test_accuracy_metric_matches():
    rng = np.random.default_rng(0)
    y, p = rng.integers(0, 3, 50), rng.integers(0, 3, 50)
    assert tdata.accuracy_metric("multiclass", y, p) == jdata.accuracy_metric("multiclass", y, p)
    yr, pr = rng.normal(size=50), rng.normal(size=50)
    assert tdata.accuracy_metric("regression", yr, pr) == jdata.accuracy_metric(
        "regression", yr, pr)


def _small(pkg, n_train: int = 240, n_valid: int = 120):
    """The first rows of each split of ``churn``, in ``pkg``'s dataset type."""
    ds = pkg.make_dataset("churn")
    return pkg.TabularDataset(
        name=ds.name, task=ds.task, n_classes=ds.n_classes,
        x_train=ds.x_train[:n_train], y_train=ds.y_train[:n_train],
        x_valid=ds.x_valid[:n_valid], y_valid=ds.y_valid[:n_valid],
        x_test=ds.x_test[:n_valid], y_test=ds.y_test[:n_valid],
    )


@pytest.mark.parametrize("kind", ["gbdt", "rf"])
def test_random_search_same_trials_and_winner(kind):
    hw_kw = dict(n_bins=64)
    j = jtune.random_search(_small(jdata), kind=kind, n_trials=3, seed=5,
                            hw=jtune.HWConstraints(**hw_kw))
    t = ttune.random_search(_small(tdata), kind=kind, n_trials=3, seed=5,
                            hw=ttune.HWConstraints(**hw_kw))
    assert [dataclasses.asdict(x) for x in t.trials] == [dataclasses.asdict(x) for x in j.trials]
    assert dataclasses.asdict(t.best) == dataclasses.asdict(j.best)
    assert t.test_ready and isinstance(t.quantizer, TQuantizer)
    for a, b in zip(j.quantizer.edges, t.quantizer.edges, strict=True):
        _same(a, b, "edges")
    _assert_same_ensemble(j.ensemble, t.ensemble)


def test_searched_model_builds_and_predicts_like_the_numpy_ensemble():
    """The slice end to end at a small size: search, build with the
    search's grid and compression, predict float rows on the CPU."""
    ds = _small(tdata)
    res = ttune.random_search(ds, kind="rf", n_trials=2, seed=1,
                              hw=ttune.HWConstraints(n_bins=64))
    cm = repro_torch.build(res.ensemble, quantizer=res.quantizer, compress="auto")
    want = res.ensemble.predict(res.quantizer.transform(ds.x_test))
    np.testing.assert_array_equal(cm.predict(ds.x_test, device="cpu"), want)
