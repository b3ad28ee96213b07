"""The port's compression pass and its ``build`` held to the JAX package's.

``compress_table`` gives the same bytes at every level, with and without
the grid, for every task — the all-pruned sentinel and the collapse to
one column included; ``repro_torch.build(dump_or_ensemble, compress=...)``
saves the same ``.npz`` arrays and the same ``.json`` sidecar as
``repro.api.build`` for every golden dump and every level; and the
compressed artifacts predict the same on the CPU.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import repro.api as japi
import repro_torch
from repro.core.compile import CAMTable as JCAMTable
from repro.core.compile import compile_ensemble as j_compile
from repro.core.compress import COMPRESS_LEVELS as J_LEVELS
from repro.core.compress import compress_table as j_compress
from repro.core.compress import resolve_level as j_resolve
from repro.core.quantize import FeatureQuantizer as JQuantizer
from repro.core.trees import random_deep_ensemble as j_random_deep_ensemble
from repro_torch.core.compile import CAMTable as TCAMTable
from repro_torch.core.compile import compile_ensemble as t_compile
from repro_torch.core.compress import COMPRESS_LEVELS as T_LEVELS
from repro_torch.core.compress import CompressionReport
from repro_torch.core.compress import compress_table as t_compress
from repro_torch.core.compress import resolve_level as t_resolve
from repro_torch.core.quantize import FeatureQuantizer as TQuantizer
from repro_torch.core.trees import random_deep_ensemble as t_random_deep_ensemble

FIXTURES = Path(__file__).parent / "fixtures" / "ingest"
DUMPS = sorted(
    p for p in FIXTURES.iterdir()
    if p.suffix in (".json", ".txt") and ".expected" not in p.name
)
LEVELS = ("off", "prune", "merge", "full")
TASKS = [("regression", 1), ("binary", 2), ("multiclass", 3)]


def _assert_same_table(j, t) -> None:
    for f in dataclasses.fields(JCAMTable):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            assert a is not None and b is not None, f.name
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name


def _assert_same_arrays(a: Path, b: Path) -> None:
    with np.load(a) as na, np.load(b) as nb:
        assert na.files == nb.files
        for k in na.files:
            assert na[k].dtype == nb[k].dtype and na[k].shape == nb[k].shape, k
            assert na[k].tobytes() == nb[k].tobytes(), k


def _assert_same_answers(tcm, jcm, x) -> None:
    """Class ids exactly; margins (and regression values) within the
    oracles' cross-backend 1 ULP (``tests/oracles.py``): the plain
    PyTorch version and the JAX engine add a float leaf sum in another
    order."""
    pred, jpred = tcm.predict(x, device="cpu"), np.asarray(jcm.predict(x))
    if tcm.table.task == "regression":
        np.testing.assert_allclose(pred, jpred, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(pred, jpred)
    np.testing.assert_allclose(tcm.raw_margin(x, device="cpu"), np.asarray(jcm.raw_margin(x)),
                               rtol=1e-6, atol=1e-7)


def _grids(n_features: int):
    """The same small grid in both packages: 4 distinct values a feature,
    so unreachable-row pruning and vacuous-bound widening both fire."""
    x = np.random.default_rng(4).choice([0.1, 0.7, 1.3, 2.9], size=(64, n_features))
    return JQuantizer.fit(x, n_bins=256), TQuantizer.fit(x, n_bins=256), x


def test_levels_and_resolve_match():
    assert T_LEVELS == J_LEVELS
    for level in T_LEVELS:
        assert t_resolve(level) == j_resolve(level)
    with pytest.raises(ValueError, match="not in"):
        t_resolve("zip")


@pytest.mark.parametrize("with_grid", [False, True], ids=["no_grid", "grid"])
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("task,n_classes", TASKS, ids=[t for t, _ in TASKS])
def test_compress_table_is_byte_equal(task, n_classes, level, with_grid):
    kw = dict(n_trees=7, depth=5, n_features=6, n_bins=256, task=task,
              n_classes=n_classes, p_dup=0.5, seed=13)
    jt, tt = j_compile(j_random_deep_ensemble(**kw)), t_compile(t_random_deep_ensemble(**kw))
    jg, tg, _ = _grids(6) if with_grid else (None, None, None)
    jc, jrep = j_compress(jt, jg, level=level)
    tc, trep = t_compress(tt, tg, level=level)
    _assert_same_table(jc, tc)
    assert trep.to_dict() == jrep.to_dict()
    assert CompressionReport.from_dict(trep.to_dict()) == trep
    if level != "off":
        assert trep.rows_saved > 0


def _manual_tables(low, high, leaf, tree_id=None):
    """The same hand-made regression table in both packages."""
    low, high = np.asarray(low, np.int32), np.asarray(high, np.int32)
    r, f = low.shape
    tid = np.asarray(tree_id if tree_id is not None else np.zeros(r), np.int32)
    kw = dict(low=low, high=high, leaf=np.asarray(leaf, np.float32), tree_id=tid,
              class_id=np.zeros(r, np.int32), n_trees=int(tid.max()) + 1,
              n_features=f, n_bins=256, n_outputs=1, task="regression", kind="gbdt",
              base_score=0.0, n_classes=1, table_dtype="int32")
    return JCAMTable(**kw), TCAMTable(**kw)


@pytest.mark.parametrize("case", ["all_pruned_sentinel", "all_wildcard_columns"])
def test_degenerate_tables_are_byte_equal(case):
    """Every row pruned (one wildcard zero-leaf sentinel row kept) and
    every column a wildcard (collapsed to the one-column floor)."""
    if case == "all_pruned_sentinel":
        jt, tt = _manual_tables([[5, 5], [9, 0]], [[5, 256], [3, 256]], [42.0, 7.0],
                                tree_id=[0, 1])
    else:
        jt, tt = _manual_tables(np.zeros((4, 6)), np.full((4, 6), 256),
                                [0.25, 0.5, 0.75, 1.0], tree_id=np.arange(4))
    jc, jrep = j_compress(jt, level="full")
    tc, trep = t_compress(tt, level="full")
    _assert_same_table(jc, tc)
    assert trep.to_dict() == jrep.to_dict()
    if case == "all_pruned_sentinel":
        assert trep.sentinel_rows == 1 and tc.n_rows == 1 and float(tc.leaf[0]) == 0.0
    else:
        assert tc.n_cols == 1 and trep.collapsed_columns == 5 and tc.n_rows == 4
    q = np.random.default_rng(0).integers(0, 256, size=(17, tc.n_features)).astype(np.int32)
    cm = repro_torch.build(tc)
    jcm = japi.build(jc)
    np.testing.assert_array_equal(cm.raw_margin(q, device="cpu"), np.asarray(jcm.raw_margin(q)))


@pytest.mark.parametrize("level", [*LEVELS, "auto"])
@pytest.mark.parametrize("dump", DUMPS, ids=lambda p: p.name)
def test_build_from_dump_saves_the_jax_artifact(dump, level, tmp_path):
    """A dump path through ingest, compile, compress, placement and the
    plans: byte-equal artifacts, equal predictions and margins."""
    jcm = japi.build(str(dump), compress=level)
    tcm = repro_torch.build(str(dump), compress=level)
    jcm.save(tmp_path / "j")
    tcm.save(tmp_path / "t")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    _assert_same_arrays(tmp_path / "t.npz", tmp_path / "j.npz")
    assert tcm.ingest == jcm.ingest and tcm.compression == jcm.compression
    assert tcm.deploy.compress == jcm.deploy.compress == j_resolve(level)
    exp = json.loads(dump.with_name(dump.name.rsplit(".", 1)[0] + ".expected.json").read_text())
    _assert_same_answers(tcm, jcm, np.asarray(exp["x"], dtype=np.float64))


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("source", ["imported", "ensemble"])
def test_build_from_imported_or_native_model(source, level, tmp_path):
    """An ``ImportedEnsemble`` (as the JAX package's ``load_model`` gives
    it to ``repro.api.build``) and a native ensemble with an attached grid."""
    if source == "imported":
        import repro.ingest as jin
        import repro_torch.ingest as tin

        dump = FIXTURES / "lgbm_multi.txt"
        jm, tm, jkw, tkw = jin.load_model(dump), tin.load_model(dump), {}, {}
        x = np.random.default_rng(1).normal(size=(40, tm.n_features)) * 2.0
    else:
        kw = dict(n_trees=9, depth=5, n_features=6, n_bins=256, task="multiclass",
                  n_classes=3, p_dup=0.5, seed=5)
        jm, tm = j_random_deep_ensemble(**kw), t_random_deep_ensemble(**kw)
        jg, tg, x = _grids(6)
        jkw, tkw = {"quantizer": jg}, {"quantizer": tg}
    jcm = japi.build(jm, compress=level, **jkw)
    tcm = repro_torch.build(tm, compress=level, **tkw)
    jcm.save(tmp_path / "j")
    tcm.save(tmp_path / "t")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    _assert_same_arrays(tmp_path / "t.npz", tmp_path / "j.npz")
    _assert_same_answers(tcm, jcm, x)


def test_build_rejects_what_it_cannot_ingest():
    with pytest.raises(TypeError, match="dump path"):
        repro_torch.build(np.zeros(3))
    with pytest.raises(ValueError, match="not in"):
        repro_torch.build(t_random_deep_ensemble(n_trees=2, depth=2, n_features=3),
                          compress="zip")
