"""(f) artifacts between the packages and (g) the whole slice at smoke size.

(f) JAX save -> port load and port save -> JAX load give equal
predictions, arrays and a byte-identical sidecar; the port's ``build``
compiles the same artifact as ``repro.api.build``; every ingest golden,
ingested and saved by JAX, reproduces its recorded margins and
predictions through the port.  (g) ``xtime_tabular.smoke()`` widths run
end to end in both packages on the same seeded ensemble.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest

import repro.api as japi
import repro_torch
from repro.configs.xtime_tabular import smoke
from repro.core.trees import random_deep_ensemble as j_random_deep_ensemble
from repro_torch import convert
from repro_torch.core.trees import random_deep_ensemble as t_random_deep_ensemble

FIXTURES = Path(__file__).parent / "fixtures" / "ingest"
DUMPS = sorted(
    p for p in FIXTURES.iterdir()
    if p.suffix in (".json", ".txt") and ".expected" not in p.name
)


def _expected(dump: Path) -> dict:
    exp = json.loads(dump.with_name(dump.name.rsplit(".", 1)[0] + ".expected.json").read_text())
    return {"x": np.asarray(exp["x"], dtype=np.float64),
            "raw_margin": np.asarray(exp["raw_margin"], dtype=np.float32),
            "predict": np.asarray(exp["predict"])}


def _assert_same_arrays(a: Path, b: Path) -> None:
    with np.load(a) as na, np.load(b) as nb:
        assert na.files == nb.files
        for k in na.files:
            assert na[k].dtype == nb[k].dtype
            np.testing.assert_array_equal(na[k], nb[k])


def test_golden_set_is_complete():
    assert len(DUMPS) == 8


@pytest.mark.parametrize("dump", DUMPS, ids=lambda p: p.name)
def test_ingest_golden_through_the_port(dump, tmp_path):
    """Ingested and saved by JAX, loaded and served by the port (float
    rows binned by the artifact's own grid) — the recorded answers."""
    exp = _expected(dump)
    japi.build(str(dump)).save(tmp_path / "art")
    cm = repro_torch.CompiledModel.load(tmp_path / "art")
    assert cm.quantizer is not None and cm.ingest["exact"] is True
    pred = cm.predict(exp["x"], device="cpu")
    margin = cm.raw_margin(exp["x"], device="cpu")
    if cm.table.task == "regression":
        np.testing.assert_allclose(pred, exp["predict"], rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(pred.astype(exp["predict"].dtype), exp["predict"])
    np.testing.assert_allclose(margin, exp["raw_margin"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("compress", ["off", "prune", "merge", "full"])
def test_artifacts_cross_both_ways(compress, tmp_path):
    """JAX save -> port load -> port save, and back through JAX: the same
    arrays, the same sidecar bytes, the same predictions."""
    dump = FIXTURES / "xgb_deep.json"
    x = _expected(dump)["x"]
    jcm = japi.build(str(dump), compress=compress)
    jcm.save(tmp_path / "j")
    tcm = repro_torch.CompiledModel.load(tmp_path / "j")
    tcm.save(tmp_path / "t")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    _assert_same_arrays(tmp_path / "t.npz", tmp_path / "j.npz")
    back = japi.CompiledModel.load(tmp_path / "t")
    back.save(tmp_path / "b")
    assert (tmp_path / "b.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    want = np.asarray(jcm.predict(x))
    np.testing.assert_array_equal(tcm.predict(x, device="cpu"), want)
    np.testing.assert_array_equal(np.asarray(back.predict(x)), want)
    # in memory, the JAX object's state converts to the same artifact
    mem = convert.from_state(*convert.to_state(jcm))
    np.testing.assert_array_equal(mem.table.low, tcm.table.low)
    np.testing.assert_array_equal(mem.predict(x, device="cpu"), want)


def test_port_save_loads_in_jax(tmp_path):
    ens = t_random_deep_ensemble(n_trees=10, depth=4, n_features=9, n_bins=256,
                                 task="multiclass", n_classes=4, seed=2)
    tcm = repro_torch.build(ens, cluster_columns=True)
    tcm.save(tmp_path / "t")
    jcm = japi.CompiledModel.load(tmp_path / "t")
    jcm.save(tmp_path / "j")
    assert (tmp_path / "j.json").read_bytes() == (tmp_path / "t.json").read_bytes()
    _assert_same_arrays(tmp_path / "j.npz", tmp_path / "t.npz")
    q = np.random.default_rng(0).integers(0, 256, size=(33, 9)).astype(np.uint8)
    np.testing.assert_array_equal(np.asarray(jcm.predict(q)), tcm.predict(q, device="cpu"))
    np.testing.assert_array_equal(np.asarray(jcm.raw_margin(q)), tcm.raw_margin(q, device="cpu"))


@pytest.mark.parametrize("task,n_classes", [("regression", 1), ("binary", 2), ("multiclass", 5)])
def test_port_build_equals_jax_build(task, n_classes, tmp_path):
    """The same Ensemble compiles to the same tables, placement, NoC plan
    and perf report in both packages (compared as saved artifacts)."""
    kw = dict(n_trees=7, depth=5, n_features=12, n_bins=256, task=task,
              n_classes=n_classes, seed=3)
    japi.build(j_random_deep_ensemble(**kw)).save(tmp_path / "j")
    repro_torch.build(t_random_deep_ensemble(**kw)).save(tmp_path / "t")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    _assert_same_arrays(tmp_path / "t.npz", tmp_path / "j.npz")


def test_port_build_takes_compression_and_dumps(tmp_path):
    """The inputs the port's ``build`` once refused — an ensemble at
    ``compress='full'`` and the ``xgb_deep.json`` dump path — build the
    JAX package's artifacts byte for byte."""
    kw = dict(n_trees=2, depth=2, n_features=3, seed=0)
    repro_torch.build(t_random_deep_ensemble(**kw), compress="full").save(tmp_path / "t")
    japi.build(j_random_deep_ensemble(**kw), compress="full").save(tmp_path / "j")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    _assert_same_arrays(tmp_path / "t.npz", tmp_path / "j.npz")
    dump = FIXTURES / "xgb_deep.json"
    tcm, jcm = repro_torch.build(str(dump)), japi.build(str(dump))
    tcm.save(tmp_path / "td")
    jcm.save(tmp_path / "jd")
    assert (tmp_path / "td.json").read_bytes() == (tmp_path / "jd.json").read_bytes()
    _assert_same_arrays(tmp_path / "td.npz", tmp_path / "jd.npz")
    assert tcm.ingest["exact"] is True and tcm.quantizer is not None
    x = _expected(dump)["x"]
    np.testing.assert_array_equal(tcm.predict(x, device="cpu"), np.asarray(jcm.predict(x)))


def test_whole_slice_at_smoke_widths():
    """xtime-tabular smoke(): 64 trees x 32 leaves, 16 features, 256 bins,
    3 classes — seeded ensemble -> build -> predict in both packages."""
    cfg = smoke()
    kw = dict(n_trees=cfg.n_trees, depth=int(math.log2(cfg.max_leaves)),
              n_features=cfg.n_features, n_bins=cfg.n_bins, task=cfg.task,
              n_classes=cfg.n_classes, seed=11)
    jens, tens = j_random_deep_ensemble(**kw), t_random_deep_ensemble(**kw)
    for jt, tt in zip(jens.trees, tens.trees):
        for name in ("feature", "threshold", "left", "right", "value"):
            np.testing.assert_array_equal(getattr(jt, name), getattr(tt, name))
    jcm, tcm = japi.build(jens), repro_torch.build(tens)
    assert tcm.table.n_rows == cfg.n_trees * cfg.max_leaves
    for name in ("low", "high", "leaf", "tree_id", "class_id"):
        np.testing.assert_array_equal(getattr(tcm.table, name), getattr(jcm.table, name))
    q = np.random.default_rng(12).integers(0, cfg.n_bins, size=(70, cfg.n_features))
    q = q.astype(np.uint8)
    want = np.asarray(jcm.raw_margin(q))
    np.testing.assert_array_equal(tens.raw_margin(q), jens.raw_margin(q))
    np.testing.assert_array_equal(tcm.raw_margin(q, device="cpu"), want)
    np.testing.assert_array_equal(tcm.raw_margin(q, device="cpu"), tens.raw_margin(q))
    np.testing.assert_array_equal(tcm.predict(q, device="cpu"), np.asarray(jcm.predict(q)))
    np.testing.assert_array_equal(tcm.predict(q, device="cpu"), tens.predict(q))


def test_summary_with_deploy_bin_and_engine_match_jax(tmp_path):
    """``summary``, ``with_deploy`` and the deprecated ``bin`` behave as
    the JAX package's; the engine reports the JAX engine's attributes;
    ``batch_hint`` binds no second engine and ``mesh`` is refused."""
    dump = FIXTURES / "xgb_deep.json"
    x = _expected(dump)["x"]
    jcm = japi.build(str(dump))
    jcm.save(tmp_path / "j")
    tcm = repro_torch.CompiledModel.load(tmp_path / "j")
    assert tcm.summary() == jcm.summary()
    for change in ({"batching": True}, {"b_blk": 64}, {}):
        jd, td = jcm.with_deploy(jcm.deploy.replace(**change)), tcm.with_deploy(
            tcm.deploy.replace(**change))
        assert td.summary() == jd.summary() and td.deploy.to_dict() == jd.deploy.to_dict()
    assert tcm.with_deploy(tcm.deploy) is tcm
    with pytest.warns(DeprecationWarning, match="CompiledModel.bin"):
        got = tcm.bin(x)
    with pytest.warns(DeprecationWarning, match="CompiledModel.bin"):
        np.testing.assert_array_equal(got, jcm.bin(x))
    eng, jeng = tcm.engine("cpu"), jcm.engine()
    for name in ("b_blk", "backend", "spmd", "noc_config", "batch_multiple", "table_dtype"):
        assert getattr(eng, name) == getattr(jeng, name), name
    assert tcm.engine("cpu", batch_hint=4096) is eng
    with pytest.raises(TypeError, match="Mesh"):
        tcm.engine(mesh=object())
