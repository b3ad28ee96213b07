"""The port's kernel autotuner and its per-bucket dispatch, on the CPU,
against the JAX package's.

(a) ``tests/test_autotune.py`` on ``repro_torch`` with ``device="cpu"``:
sweep -> TunePlan -> sidecar -> cold start; (b) with one deterministic
timing function in place of both packages' ``_time_margin``, the port's
``autotune_kernel`` gives the JAX package's trials, dispatch and winner
(everything but ``env``) for the default, a faithful and a soft sweep;
(c) tuned artifacts cross between the packages with byte-equal sidecars;
(d) the dispatch applies through ``predict``/``predict_proba``/
``raw_margin``/``engine(batch_hint=)``/``score_file``/
``TableRegistry.engine_for_batch`` only for a plan the port timed itself,
and binds the same bits as the untuned artifact; (e) the parity gaps:
``predict_padded``/``raw_margin_padded`` and the loose-kwarg registry forms.
"""

import json

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core.tune as jtune
import repro_torch
import repro_torch.core.tune as ttune
from repro.core.deploy import DeployConfig as JDeploy
from repro.core.engine import XTimeEngine as JEngine
from repro.core.trees import random_deep_ensemble as j_random_deep_ensemble
from repro.serve.registry import TableRegistry as JRegistry
from repro_torch import CompiledModel, DeployConfig, TunePlan, autotune_kernel, build
from repro_torch.core.engine import XTimeEngine
from repro_torch.core.trees import GBDTParams, random_deep_ensemble, train_gbdt
from repro_torch.kernels import ops as kops
from repro_torch.serve import TableRegistry


def assert_margins_close(got, want):
    """The oracles' tolerance against the JAX reference (1 float32 ULP)."""
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def artifact():
    rng = np.random.default_rng(0)
    xb = rng.integers(0, 256, size=(256, 8))
    y = (xb[:, 0].astype(np.int64) + xb[:, 3] > 250).astype(np.int64)
    ens = train_gbdt(xb, y, task="binary", n_bins=256,
                     params=GBDTParams(n_rounds=4, max_leaves=16))
    return build(ens), xb


def _quick_plan(cm):
    return autotune_kernel(
        cm, device="cpu", batch=64, b_blks=(32, 64), r_blks=(64, 128), warmup=1, iters=1,
    )


# -- (a) tests/test_autotune.py on the port ------------------------------------


def test_autotune_sweeps_and_picks_winner(artifact):
    cm, _ = artifact
    plan = _quick_plan(cm)
    assert plan.b_blk in (32, 64) and plan.r_blk in (64, 128)
    assert plan.table_dtype in ("uint8", "uint16", "int32")  # resolved, not 'auto'
    assert plan.us_per_call > 0
    # full sweep recorded: every (b, r, dtype/kernel-mode) candidate timed
    assert len(plan.trials) >= 8
    assert {t["us_per_call"] >= 0 for t in plan.trials} == {True}
    assert plan.env["platform"] == "cpu" and plan.env["torch"] == torch.__version__
    winner_us = min(t["us_per_call"] for t in plan.trials)
    assert plan.us_per_call == winner_us


def test_plan_round_trips_and_applies(artifact):
    cm, _ = artifact
    plan = _quick_plan(cm)
    assert TunePlan.from_dict(plan.to_dict()) == plan
    cfg = plan.apply(DeployConfig())
    assert (cfg.b_blk, cfg.r_blk, cfg.table_dtype, cfg.mode) == (
        plan.b_blk, plan.r_blk, plan.table_dtype, plan.mode,
    )


def test_faithful_mode_sweep_stays_int32(artifact):
    cm, _ = artifact
    plan = autotune_kernel(
        cm, device="cpu", deploy=DeployConfig(mode="msb_lsb"), batch=32,
        b_blks=(32,), r_blks=(64,), iters=1,
    )
    assert plan.mode == "msb_lsb"
    assert plan.table_dtype == "int32"


def test_tuned_artifact_save_load_round_trip(artifact, tmp_path):
    cm, xb = artifact
    plan = _quick_plan(cm)
    tuned = cm.with_tuning(plan)
    assert tuned.tuning == plan.to_dict()
    assert tuned.deploy.b_blk == plan.b_blk
    assert tuned.summary()["tuned"] is True

    tuned.save(tmp_path / "m")
    loaded = CompiledModel.load(tmp_path / "m")
    # the autotune plan survives the round trip, knobs already folded in
    assert loaded.tuning == plan.to_dict()
    assert loaded.tune_plan() == plan
    assert loaded.deploy.b_blk == plan.b_blk
    assert loaded.deploy.r_blk == plan.r_blk
    assert loaded.deploy.table_dtype == plan.table_dtype
    # and the tuned engine computes the same bits as the untuned one
    m0 = cm.engine("cpu").raw_margin(xb).numpy()
    m1 = loaded.engine("cpu").raw_margin(xb).numpy()
    np.testing.assert_array_equal(m0, m1)


def test_registry_cold_start_uses_tuned_plan(artifact, tmp_path):
    cm, xb = artifact
    plan = _quick_plan(cm)
    cm.with_tuning(plan).save(tmp_path / "m")

    reg = TableRegistry(device="cpu")
    entry = reg.register("churn", CompiledModel.load(tmp_path / "m"))
    assert entry.tuning == plan.to_dict()
    assert entry.engine.b_blk == plan.b_blk
    assert entry.engine.r_blk == plan.r_blk
    assert entry.engine.table_dtype == plan.table_dtype
    np.testing.assert_array_equal(
        entry.engine.raw_margin(xb).numpy(), cm.engine("cpu").raw_margin(xb).numpy(),
    )


def test_untuned_artifact_has_no_plan(artifact, tmp_path):
    cm, _ = artifact
    assert cm.tuning is None and cm.tune_plan() is None
    cm.save(tmp_path / "m")
    assert CompiledModel.load(tmp_path / "m").tuning is None


def test_v1_artifact_still_loads(artifact, tmp_path):
    """Pre-kernel-v2 artifacts (schema_version 1: int32 exclusive-high
    arrays, no table_dtype) must keep loading unchanged."""
    cm, xb = artifact
    cm.save(tmp_path / "m")
    sidecar = json.loads((tmp_path / "m.json").read_text())
    assert sidecar["schema_version"] == 2
    sidecar["schema_version"] = 1
    del sidecar["table"]["table_dtype"]
    (tmp_path / "m.json").write_text(json.dumps(sidecar))
    with np.load(tmp_path / "m.npz") as npz:
        arrays = dict(npz)
    arrays["low"] = cm.table.low.astype(np.int32)
    arrays["high"] = cm.table.high.astype(np.int32)
    np.savez_compressed(tmp_path / "m.npz", **arrays)

    old = CompiledModel.load(tmp_path / "m")
    assert old.table.table_dtype == "int32"  # pre-v2 layout, as saved
    np.testing.assert_array_equal(old.table.low, cm.table.low)
    np.testing.assert_array_equal(old.table.high, cm.table.high)
    np.testing.assert_array_equal(
        old.engine("cpu").raw_margin(xb).numpy(), cm.engine("cpu").raw_margin(xb).numpy(),
    )


# -- (b) the same sweep from the same timings ----------------------------------


def _fake_time(engine, q, *, warmup, iters):
    """Deterministic microseconds from (table dtype, mode, b_blk, r_blk,
    batch): int32 wins small batches, uint8 large ones; r_blk 256 and 512
    tie, so the first of equal times must win in both packages."""
    fixed = {"uint8": 50.0, "uint16": 55.0, "int32": 10.0, "float32": 80.0}[engine.table_dtype]
    per_row = {"uint8": 1.0, "uint16": 1.05, "int32": 1.2, "float32": 2.0}[engine.table_dtype]
    return (q.shape[0] * per_row + fixed + (engine.b_blk % 97) * 0.01
            + (engine.r_blk >= 256) * 0.25 + (engine.mode == "inclusive") * 0.5)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """One JAX-built artifact (8 trees x depth 6 = 512 rows, so r_blk 128,
    256 and 512 pad alike) and the port's load of it."""
    ens = j_random_deep_ensemble(n_trees=8, depth=6, n_features=10, n_bins=256,
                                 task="multiclass", n_classes=3, seed=4)
    jcm = japi.build(ens)
    base = tmp_path_factory.mktemp("shared") / "art"
    jcm.save(base)
    q = np.random.default_rng(5).integers(0, 256, size=(300, 10)).astype(np.uint8)
    return jcm, CompiledModel.load(base), q


@pytest.mark.parametrize("sweep", ["default", "msb_lsb", "soft"])
def test_same_timings_give_the_jax_package_plan(shared, monkeypatch, sweep):
    jcm, tcm, _ = shared
    monkeypatch.setattr(jtune, "_time_margin", _fake_time)
    monkeypatch.setattr(ttune, "_time_margin", _fake_time)
    kw = {"default": {}, "msb_lsb": {"mode": "msb_lsb"}, "soft": {"mode": "soft"}}[sweep]
    jplan = jtune.autotune_kernel(jcm, deploy=jcm.deploy.replace(**kw), batches=(1, 16))
    tplan = autotune_kernel(tcm, device="cpu", deploy=tcm.deploy.replace(**kw),
                            batches=(1, 16))
    jd, td = jplan.to_dict(), tplan.to_dict()
    assert jd.pop("env")["platform"] == td.pop("env")["platform"] == "cpu"
    assert td == jd
    assert len(td["trials"]) == {"default": 27, "msb_lsb": 9, "soft": 9}[sweep] * 3
    if sweep == "default":  # the buckets' winners differ: a real dispatch table
        assert [e["table_dtype"] for e in td["dispatch"]] == ["int32", "int32", "uint8"]


def test_sweep_binds_once_per_padded_layout(shared, monkeypatch):
    """The 9 (b_blk, r_blk) twins of a layout run one bound engine: the
    default sweep binds 3 (uint8 inclusive, int32 direct, int32
    inclusive); r_blk 64 pads 512 rows alike too, r_blk 384 does not."""
    _, tcm, _ = shared
    monkeypatch.setattr(ttune, "_time_margin", _fake_time)
    binds = []
    init = XTimeEngine.__init__

    def counting(self, table, **kw):
        binds.append((kw["config"].table_dtype, kw["config"].mode, kw["config"].r_blk))
        init(self, table, **kw)

    monkeypatch.setattr(XTimeEngine, "__init__", counting)
    autotune_kernel(tcm, device="cpu", batches=(1,))
    assert len(binds) == 3
    binds.clear()
    autotune_kernel(tcm, device="cpu", r_blks=(64, 128, 384), b_blks=(64,))
    assert sorted(r for _, _, r in binds) == [64, 64, 64, 384, 384, 384]


# -- (c) tuned artifacts cross between the packages ----------------------------


def _jax_plan(jcm, monkeypatch):
    monkeypatch.setattr(jtune, "_time_margin", _fake_time)
    return jtune.autotune_kernel(jcm, batches=(1, 16))


def _port_plan(tcm, monkeypatch):
    monkeypatch.setattr(ttune, "_time_margin", _fake_time)
    return autotune_kernel(tcm, device="cpu", batches=(1, 16))


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_tuned_sidecars_cross_byte_equal(shared, monkeypatch, tmp_path, maker):
    """A tuned artifact saved by one package loads in the other with its
    plan, and the other's save writes the same bytes."""
    jcm, tcm, q = shared
    if maker == "jax":
        tuned = jcm.with_tuning(_jax_plan(jcm, monkeypatch))
        tuned.save(tmp_path / "a")
        other = CompiledModel.load(tmp_path / "a")
        assert other.tune_plan().to_dict() == tuned.tune_plan().to_dict()
    else:
        tuned = tcm.with_tuning(_port_plan(tcm, monkeypatch))
        tuned.save(tmp_path / "a")
        other = japi.CompiledModel.load(tmp_path / "a")
        assert other.tune_plan().to_dict() == tuned.tune_plan().to_dict()
        np.testing.assert_array_equal(np.asarray(other.predict(q)),
                                      tcm.predict(q, device="cpu"))
    assert other.deploy.to_dict() == tuned.deploy.to_dict()
    other.save(tmp_path / "b")
    for suffix in (".json", ".npz"):
        assert (tmp_path / f"a{suffix}").read_bytes() == (tmp_path / f"b{suffix}").read_bytes()


def test_dispatch_for_and_apply_equal_the_jax_package(shared, monkeypatch):
    jcm, tcm, _ = shared
    jplan = _jax_plan(jcm, monkeypatch)
    tplan = TunePlan.from_dict(jplan.to_dict())
    v1 = TunePlan.from_dict({**jplan.to_dict(), "dispatch": []})  # schema v1: no table
    jv1 = jtune.TunePlan.from_dict(v1.to_dict())
    for batch in (1, 2, 15, 16, 17, 100, 256, 257, 4096):
        assert tplan.dispatch_for(batch) == jplan.dispatch_for(batch)
        assert v1.dispatch_for(batch) == jv1.dispatch_for(batch)
        got = tplan.apply(tcm.deploy, batch=batch).to_dict()
        assert got == jplan.apply(jcm.deploy, batch=batch).to_dict()
    assert tplan.apply(tcm.deploy).to_dict() == jplan.apply(jcm.deploy).to_dict()
    assert tplan.kernel == jplan.kernel


# -- (d) where the dispatch applies ---------------------------------------------


def _handmade(platform_env: dict, table_dtypes=("int32", "uint8"), mode="direct"):
    """A deterministic two-bucket plan: bucket 16 -> the first dtype,
    bucket 256 -> the second."""
    d16, d256 = table_dtypes
    return TunePlan(
        b_blk=64, r_blk=128, table_dtype=d256, mode=mode, backend="jnp",
        us_per_call=2.0, batch=256, env=platform_env,
        dispatch=[
            {"batch": 16, "b_blk": 32, "r_blk": 64, "table_dtype": d16, "mode": mode,
             "kernel": ttune.kernel_version(d16), "us_per_call": 1.0},
            {"batch": 256, "b_blk": 64, "r_blk": 128, "table_dtype": d256, "mode": mode,
             "kernel": ttune.kernel_version(d256), "us_per_call": 2.0},
        ],
    )


PORT_CPU = {"platform": "cpu", "n_devices": 1, "torch": torch.__version__, "device_name": "cpu"}
FOREIGN = {
    "jax": {"platform": "tpu", "n_devices": 4, "jax": "0.4.37"},
    "jax-cpu": {"platform": "cpu", "n_devices": 1, "jax": "0.4.37"},
    "port-cuda": {**PORT_CPU, "platform": "cuda"},
}


def test_port_plan_dispatches_per_bucket_with_untuned_bits(shared):
    """A plan the port timed on the CPU: ``predict``/``raw_margin`` bind
    each bucket's winner, every bucket gives the untuned artifact's bits
    and the JAX package's margins within the oracle tolerance."""
    jcm, tcm, q = shared
    tuned = tcm.with_tuning(_handmade(PORT_CPU))
    assert tuned.engine("cpu", batch_hint=8).table_dtype == "int32"
    assert tuned.engine("cpu", batch_hint=200).table_dtype == "uint8"
    assert tuned.engine("cpu", batch_hint=10_000) is tuned.engine("cpu", batch_hint=200)
    for b in (1, 16, 17, 256, 300):
        x = q[:b]
        np.testing.assert_array_equal(tuned.predict(x, device="cpu"), tcm.predict(x, device="cpu"))
        m = tuned.raw_margin(x, device="cpu")
        np.testing.assert_array_equal(m, tcm.raw_margin(x, device="cpu"))
        assert_margins_close(m, np.asarray(jcm.raw_margin(x)))
    engines = {id(e) for e in tuned._engines.values()}
    assert len(engines) == 2  # bucket 16's and bucket 256's winners


def test_soft_port_plan_predict_proba_bit_equal(shared):
    """``predict_proba`` of a soft artifact tuned by the port: each bucket
    binds its winner's blocks, the probabilities are the untuned bits."""
    jcm, tcm, q = shared
    jsoft = jcm.with_deploy(jcm.deploy.replace(mode="soft", tau=0.1))
    soft = tcm.with_deploy(tcm.deploy.replace(mode="soft", tau=0.1))
    tuned = soft.with_tuning(_handmade(PORT_CPU, ("float32", "float32"), mode="soft"))
    for b in (1, 16, 256, 300):
        x = q[:b]
        p = tuned.predict_proba(x, device="cpu")
        np.testing.assert_array_equal(p, soft.predict_proba(x, device="cpu"))
        np.testing.assert_allclose(p, np.asarray(jsoft.predict_proba(x)), rtol=1e-6, atol=1e-7)
    assert {e.b_blk for e in tuned._engines.values()} == {32, 64}


@pytest.mark.parametrize("origin", sorted(FOREIGN))
def test_foreign_plan_applies_no_dispatch_and_warns_once(shared, origin):
    """The JAX package's plan, or the port's timed on the other device
    type, measured other kernels: every bucket binds the primary winner
    folded into deploy, with one UserWarning naming the platform."""
    _, tcm, q = shared
    tuned = tcm.with_tuning(_handmade(FOREIGN[origin]))
    platform = FOREIGN[origin]["platform"]
    with pytest.warns(UserWarning, match=f"platform '{platform}'") as record:
        small = tuned.engine("cpu", batch_hint=8)
        pred = tuned.predict(q[:8], device="cpu")
        score = repro_torch.score_file(tuned, q, kind="margin", chunk_rows=16, device="cpu")
    assert sum(issubclass(w.category, UserWarning) for w in record) == 1
    assert small is tuned.engine("cpu") and small.table_dtype == "uint8"
    assert len(tuned._engines) == 1
    np.testing.assert_array_equal(pred, tcm.predict(q[:8], device="cpu"))
    np.testing.assert_array_equal(score.values, tcm.raw_margin(q, device="cpu"))
    reg = TableRegistry(device="cpu")
    reg.register("m", tuned)
    assert reg.engine_for_batch("m", 8) is reg.engine("m")


def test_buckets_with_one_winner_share_one_engine(shared, monkeypatch):
    """Buckets whose winners are the same configuration bind once: the
    cache is keyed on (device, resolved DeployConfig), not on the bucket."""
    _, tcm, q = shared
    plan = _handmade(PORT_CPU, ("uint8", "uint8"))
    plan = TunePlan.from_dict({**plan.to_dict(), "dispatch": [
        {**e, "b_blk": 64, "r_blk": 128} for e in plan.dispatch] + [
        {**plan.dispatch[0], "batch": 1024, "table_dtype": "int32", "kernel": "v1"}]})
    tuned = tcm.with_tuning(plan)
    binds = []
    init = XTimeEngine.__init__
    monkeypatch.setattr(XTimeEngine, "__init__",
                        lambda self, t, **kw: (binds.append(1), init(self, t, **kw))[1])
    for b in (1, 16, 17, 256, 300, 1000):
        tuned.raw_margin(q[:min(b, 300)], device="cpu")
        tuned.engine("cpu", batch_hint=b)
    assert tuned.engine("cpu", batch_hint=1) is tuned.engine("cpu")  # primary winner too
    assert len(binds) == 2  # uint8 for buckets 16 and 256, int32 for 1024


def test_engine_for_batch_and_score_file_apply_port_plans(shared):
    _, tcm, q = shared
    tuned = tcm.with_tuning(_handmade(PORT_CPU))
    reg = TableRegistry(device="cpu")
    entry = reg.register("m", tuned)
    assert entry.engine.table_dtype == "uint8"  # the primary winner
    assert reg.engine_for_batch("m", 8).table_dtype == "int32"
    assert reg.engine_for_batch("m", 200) is entry.engine
    assert reg.engine_for_batch("m", 8) is tuned.engine("cpu", batch_hint=16)
    reg.register("plain", tcm)
    assert reg.engine_for_batch("plain", 8) is reg.engine("plain")
    for chunk, dtype in ((10, "int32"), (100, "uint8")):
        res = repro_torch.score_file(tuned, q, kind="margin", chunk_rows=chunk, device="cpu")
        assert res.engine["table_dtype"] == dtype
        np.testing.assert_array_equal(res.values, tcm.raw_margin(q, device="cpu"))


# -- (e) parity gaps ---------------------------------------------------------------


def test_padded_entries_equal_padded_fn_and_the_jax_engine(shared):
    jcm, tcm, q = shared
    eng, jeng = tcm.engine("cpu"), jcm.engine()
    qp = np.zeros((320, eng.arrays.f_pad), dtype=np.int32)
    qp[:300, :10] = q
    want_m = np.asarray(jeng.raw_margin_padded(qp))
    want_p = np.asarray(jeng.predict_padded(qp))
    got_m, got_p = eng.raw_margin_padded(qp).numpy(), eng.predict_padded(qp).numpy()
    np.testing.assert_array_equal(got_m, eng.padded_fn("margin")(qp).numpy())
    np.testing.assert_array_equal(got_p, eng.padded_fn("predict")(qp).numpy())
    assert got_m.shape == want_m.shape and got_p.shape == want_p.shape
    assert_margins_close(got_m, want_m)
    np.testing.assert_array_equal(got_p, want_p)


def test_loose_registry_kwargs_warn_and_match_the_jax_package(shared):
    jcm, tcm, _ = shared
    with pytest.warns(DeprecationWarning, match="loose TableRegistry"):
        reg = TableRegistry(device="cpu", b_blk=64, table_dtype="int32")
    with pytest.warns(DeprecationWarning, match="loose TableRegistry"):
        jreg = JRegistry(b_blk=64, table_dtype="int32")
    assert reg.deploy.to_dict() == jreg.deploy.to_dict()
    ens = random_deep_ensemble(n_trees=4, depth=3, n_features=10, n_bins=256, seed=1)
    jens = j_random_deep_ensemble(n_trees=4, depth=3, n_features=10, n_bins=256, seed=1)
    a, ja = reg.register("e", ens), jreg.register("e", jens)
    assert a.deploy.to_dict() == ja.deploy.to_dict() and a.engine.table_dtype == "int32"
    with pytest.warns(DeprecationWarning, match="loose register"):
        b = reg.register("m", tcm, r_blk=64)
    with pytest.warns(DeprecationWarning, match="loose register"):
        jb = jreg.register("m", jcm, r_blk=64)
    assert b.deploy.to_dict() == jb.deploy.to_dict() and b.engine.r_blk == 64
    # hot swaps carry the loose overrides; an explicit deploy= resets them
    c, jc = reg.swap("m", tcm), jreg.swap("m", jcm)
    assert c.deploy.to_dict() == jc.deploy.to_dict() and c.deploy.r_blk == 64
    d = reg.swap("m", tcm, deploy=DeployConfig())
    jd = jreg.swap("m", jcm, deploy=JDeploy())
    assert d.deploy.to_dict() == jd.deploy.to_dict() and d.deploy.r_blk == 256
    assert isinstance(jd.engine, JEngine)


def test_padded_bucket_matches_kops_pad_to_bucket(shared):
    """The engine's padded entries take what ``kops.pad_to_bucket`` makes."""
    _, tcm, q = shared
    eng = tcm.engine("cpu")
    qp = kops.pad_to_bucket(q[:37], 64, eng.arrays.f_pad, dtype=eng.table_dtype)
    np.testing.assert_array_equal(eng.raw_margin_padded(qp).numpy()[:37],
                                  tcm.raw_margin(q[:37], device="cpu"))
