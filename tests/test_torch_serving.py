"""The port's serving layer against the JAX package's, on the CPU.

Artifacts are trained and built by ``repro``, saved, and loaded by the
port.  Held to the JAX package: ``BucketSpec`` sizes and selections over
a grid (equal), ``MicroBatcher`` and ``ServeLoop`` outputs on one seeded
trace (predictions exact; margins within ``rtol=1e-6, atol=1e-7`` of the
JAX jnp engine), and the chip-model columns of ``report()`` (equal).
Inside the port: a micro-batched request's predictions equal a direct
``engine.predict`` on it (exact), hot swap, the copy on ``submit``, the
window flush.
"""

import logging

import numpy as np
import pytest

import repro.api as japi
import repro_torch
from repro.core.quantize import FeatureQuantizer
from repro.core.trees import GBDTParams, train_gbdt
from repro.serve import BucketSpec as JBucketSpec
from repro.serve import ServeLoop as JServeLoop
from repro.serve import TableRegistry as JTableRegistry
from repro_torch.serve import (
    BucketSpec,
    MicroBatcher,
    ServeLoop,
    TableRegistry,
    make_trace,
    replay_trace,
)

RTOL, ATOL = 1e-6, 1e-7  # the port's margins against the JAX jnp engine


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{name: (JAX artifact, port artifact)} and the binned queries."""
    d = tmp_path_factory.mktemp("serving")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, 8))
    s = x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.normal(size=400)
    xb = FeatureQuantizer.fit(x, 256).transform(x).astype(np.int32)
    y2, y3 = (s > 0).astype(np.int32), np.digitize(s, [-0.5, 0.5]).astype(np.int32)
    models = {
        "a": train_gbdt(xb, y2, task="binary", n_bins=256,
                        params=GBDTParams(n_rounds=6, max_depth=4)),
        "b": train_gbdt(xb, y2, task="binary", n_bins=256,
                        params=GBDTParams(n_rounds=2, max_depth=2)),
        "m": train_gbdt(xb, y3, task="multiclass", n_classes=3, n_bins=256,
                        params=GBDTParams(n_rounds=4, max_depth=4)),
    }
    out = {}
    for name, ens in models.items():
        jcm = japi.build(ens)
        jcm.save(d / name)
        out[name] = (jcm, repro_torch.CompiledModel.load(d / name))
    return out, xb


def _rows(xb, req):
    return np.take(xb, np.arange(req.row_start, req.row_start + req.n_rows), axis=0, mode="wrap")


# -- buckets -------------------------------------------------------------------

BUCKETS = [  # (b_blk, max_batch, multiple)
    (128, 512, 1), (128, 384, 128), (128, 1024, 256), (8, 64, 1), (16, 100, 3),
    (1, 7, 1), (32, 96, 8), (128, 1024, 1),
]


@pytest.mark.parametrize("b_blk,max_batch,multiple", BUCKETS)
def test_bucket_spec_equals_jax(b_blk, max_batch, multiple, caplog):
    ours = BucketSpec(b_blk=b_blk, max_batch=max_batch, multiple=multiple)
    ref = JBucketSpec(b_blk=b_blk, max_batch=max_batch, multiple=multiple)
    assert ours.sizes() == ref.sizes()
    with caplog.at_level(logging.WARNING):
        for n in range(1, max_batch + 2 * int(np.lcm(b_blk, multiple)) + 2):
            assert ours.select(n) == ref.select(n), n
    with pytest.raises(ValueError):
        ours.select(0)


@pytest.mark.parametrize("b_blk,max_batch,multiple", [(128, 128, 256), (0, 8, 1), (8, 8, 0)])
def test_bucket_spec_rejects_what_jax_rejects(b_blk, max_batch, multiple):
    with pytest.raises(ValueError):
        JBucketSpec(b_blk=b_blk, max_batch=max_batch, multiple=multiple)
    with pytest.raises(ValueError):
        BucketSpec(b_blk=b_blk, max_batch=max_batch, multiple=multiple)


def test_over_max_fallback_is_logged(caplog):
    spec = BucketSpec(b_blk=128, max_batch=256, multiple=1)
    with caplog.at_level(logging.WARNING, logger="repro_torch.serve.batching"):
        assert spec.select(300) == 384
    assert any("uncached bucket" in r.message for r in caplog.records)


# -- micro-batching ------------------------------------------------------------


@pytest.mark.parametrize("name", ["a", "m"])
def test_microbatch_equals_direct_predict_and_jax(served, name):
    models, xb = served
    jcm, cm = models[name]
    eng, jeng = cm.engine("cpu"), jcm.engine()
    assert eng.batch_multiple == jeng.batch_multiple == 1 and eng.b_blk == jeng.b_blk
    mb = MicroBatcher.for_engine(eng, max_batch=256)
    mbm = MicroBatcher.for_engine(eng, max_batch=256, kind="margin")
    sizes, ids, row = [1, 3, 1, 7, 2, 1, 17, 1], [], 0
    for s in sizes:
        chunk = xb[row : row + s]
        ids.append((mb.submit(chunk), mbm.submit(chunk), chunk))
        row += s
    out, outm = mb.flush(), mbm.flush()
    assert mb.pending_requests == 0 and mb.flush() == {}
    for rid, ridm, chunk in ids:
        np.testing.assert_array_equal(out[rid], eng.predict(chunk).numpy())
        np.testing.assert_array_equal(out[rid], np.asarray(jeng.predict(chunk)))
        np.testing.assert_allclose(outm[ridm], np.asarray(jeng.raw_margin(chunk)),
                                   rtol=RTOL, atol=ATOL)


def test_submit_copies_caller_buffer(served):
    models, xb = served
    eng = models["a"][1].engine("cpu")
    mb = MicroBatcher.for_engine(eng, max_batch=256)
    buf = xb[0].copy()
    rid = mb.submit(buf)
    expected = eng.predict(xb[:1]).numpy()
    buf[:] = 0  # the caller reuses its buffer before the flush
    np.testing.assert_array_equal(mb.flush()[rid], expected)
    with pytest.raises(ValueError):
        mb.submit(np.zeros((0, xb.shape[1]), np.int32))


# -- serve loop ----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["predict", "margin"])
def test_serve_loop_trace_equals_jax_serve_loop(served, kind):
    models, xb = served
    trace = make_trace(["a", "m"], 160, seed=21, mean_interval_s=1e-4, mean_rows=1.4)
    jreg, reg = JTableRegistry(), TableRegistry(device="cpu")
    for name in ("a", "m"):
        jreg.register(name, models[name][0])
        reg.register(name, models[name][1])
    jloop = JServeLoop(jreg, window_s=100.0, flush_rows=16, max_batch=128, kind=kind)
    loop = ServeLoop(reg, window_s=100.0, flush_rows=16, max_batch=128, kind=kind)
    jres = replay_trace(jloop.submit, trace, {"a": xb, "m": xb}, speed=0)
    res = replay_trace(loop.submit, trace, {"a": xb, "m": xb}, speed=0)
    jloop.drain()
    loop.drain()
    for req, h, jh in zip(trace.requests, res.handles, jres.handles):
        got, want = loop.result(h), jloop.result(jh)
        assert got.shape == want.shape
        if kind == "predict":
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                got, models[req.model][1].predict(_rows(xb, req), device="cpu"))
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for name in ("a", "m"):
        s, js = loop.stats(name), jloop.stats(name)
        assert (s.n_requests, s.n_rows, s.n_flushes) == (js.n_requests, js.n_rows, js.n_flushes)
        assert s.p99_ms >= s.p50_ms >= 0.0 and s.requests_per_s > 0


def test_report_keys_and_chip_model_equal_jax(served):
    models, xb = served
    jreg, reg = JTableRegistry(), TableRegistry(device="cpu")
    jreg.register("a", models["a"][0])
    reg.register("a", models["a"][1])
    jloop = JServeLoop(jreg, window_s=100.0, flush_rows=16)
    loop = ServeLoop(reg, window_s=100.0, flush_rows=16)
    for i in range(20):
        jloop.submit("a", xb[i])
        loop.submit("a", xb[i])
    jloop.drain()
    loop.drain()
    rep, jrep = loop.report("a"), jloop.report("a")
    assert set(rep) == set(jrep)
    for part in ("deploy", "measured", "xtime_chip_model"):
        assert set(rep[part]) >= set(jrep[part])
    assert rep["xtime_chip_model"] == jrep["xtime_chip_model"]
    assert {k: rep["deploy"][k] for k in jrep["deploy"]} == jrep["deploy"]
    assert rep["deploy"]["device"] == "cpu"
    assert rep["measured"]["requests"] == 20 and rep["measured"]["flushes"] == 2
    assert rep["measured"]["buckets"] == {4: 1, 16: 1}  # a full 16-row bucket + the 4 left


def test_window_expiry_flushes(served):
    models, xb = served
    t = [0.0]
    reg = TableRegistry(device="cpu")
    reg.register("a", models["a"][1])
    loop = ServeLoop(reg, window_s=1.0, flush_rows=1000, clock=lambda: t[0])
    h = loop.submit("a", xb[0])
    assert loop.poll() == 0  # the window has not expired
    t[0] = 2.0
    assert loop.poll() == 1
    assert loop.result(h).shape == (1,)
    assert loop.stats("a").p50_ms == pytest.approx(2000.0)


def test_registry_hot_swap(served):
    models, xb = served
    cm_a, cm_b = models["a"][1], models["b"][1]
    pred_a, pred_b = cm_a.predict(xb[:8], device="cpu"), cm_b.predict(xb[:8], device="cpu")
    assert (pred_a != pred_b).any()  # the swap is observable
    reg = TableRegistry(device="cpu")
    assert reg.version("m") == 0
    reg.register("m", cm_a)
    assert reg.version("m") == 1 and "m" in reg and reg.names() == ["m"] and len(reg) == 1
    assert reg.engine("m") is cm_a.engine("cpu")  # the artifact's own engine, bound once
    loop = ServeLoop(reg, window_s=100.0, flush_rows=64)
    h_old = loop.submit("m", xb[:8])
    reg.swap("m", cm_b)
    assert reg.version("m") == 2
    h_new = loop.submit("m", xb[:8])  # the old pending flushed through the old engine
    loop.drain()
    np.testing.assert_array_equal(loop.result(h_old), pred_a)
    np.testing.assert_array_equal(loop.result(h_new), pred_b)
    with pytest.raises(KeyError):
        reg.swap("ghost", cm_b)
    reg.unregister("m")
    assert "m" not in reg and reg.version("m") == 0
    with pytest.raises(KeyError):
        reg.get("m")
    with pytest.raises(KeyError, match="unknown model"):
        reg.unregister("m")


def test_swap_retains_serving_configuration(served):
    models, _ = served
    cm = models["a"][1]
    reg = TableRegistry(device="cpu")
    a = reg.register("m", cm, batching=True)
    assert a.batching and a.noc.config == "batch"
    b = reg.swap("m", cm)  # no batching argument: inherited, not reset
    assert b.batching and b.noc.config == "batch" and b.version == 2
    c = reg.register("m", cm, batching=False)  # an explicit override wins
    assert not c.batching and c.noc.config != "batch"
    assert reg.engine_for_batch("m", 37) is c.engine
