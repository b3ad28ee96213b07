"""The port's async serving tier, on the CPU: the cases of
``tests/test_cluster.py`` on ``repro_torch.serve``, plus the JAX package
as the reference.

Held to the JAX package: ``AdaptiveWindow`` and ``StragglerMonitor``
outputs on one sequence (equal), ``make_trace`` for one seed (equal), and
the cluster's predictions on a seeded trace against the JAX
``ServeLoop``'s (exact).  Inside the port: the cluster's outputs against
the port's ``ServeLoop`` (exact) before, during and after crash,
heartbeat-timeout and straggler failover; elastic restore, shedding,
hot swap under traffic, and the thread safety of the shared batcher and
registry.  Margins are held to ``rtol=1e-6, atol=1e-7``.  Threaded tests
join with a timeout and drain with one, and assert no ordering in wall
time tighter than the JAX package's own cluster tests.
"""

import threading
import time

import numpy as np
import pytest

import repro.api as japi
import repro_torch
from repro.core.quantize import FeatureQuantizer
from repro.core.trees import GBDTParams, train_gbdt
from repro.ft.runtime import StragglerMonitor as JStragglerMonitor
from repro.serve import AdaptiveWindow as JAdaptiveWindow
from repro.serve import ServeLoop as JServeLoop
from repro.serve import TableRegistry as JTableRegistry
from repro.serve import make_trace as j_make_trace
from repro_torch.ft.runtime import StragglerMonitor
from repro_torch.serve import (
    AdaptiveWindow,
    ClusterClosed,
    ClusterServer,
    MicroBatcher,
    ServeLoop,
    ShedError,
    TableRegistry,
    make_trace,
    replay_trace,
)

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(JAX artifact v1, port artifact v1, port artifact v2, queries):
    v1 and v2 differ somewhere."""
    d = tmp_path_factory.mktemp("cluster")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(400, 8))
    y = (x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.normal(size=400) > 0).astype(np.int32)
    xb = FeatureQuantizer.fit(x, 256).transform(x).astype(np.int32)[:256]
    a = train_gbdt(xb, y[:256], task="binary", n_bins=256, params=GBDTParams(n_rounds=4, max_depth=4))
    b = train_gbdt(xb, y[:256], task="binary", n_bins=256, params=GBDTParams(n_rounds=2, max_depth=3))
    ja, jb = japi.build(a), japi.build(b)
    ja.save(d / "a")
    jb.save(d / "b")
    load = repro_torch.CompiledModel.load
    return ja, load(d / "a"), load(d / "b"), xb


def _server(**kw):
    defaults = dict(
        n_replicas=2, device="cpu", flush_rows=16, max_batch=128,
        heartbeat_timeout_s=0.6, monitor_interval_s=0.02,
    )
    defaults.update(kw)
    return ClusterServer(**defaults)


def _oracle(cm, trace, xb):
    """The port's synchronous ServeLoop on the identical trace."""
    reg = TableRegistry(device="cpu")
    reg.register("m", cm)
    loop = ServeLoop(reg, window_s=100.0, flush_rows=16, max_batch=128)
    res = replay_trace(loop.submit, trace, {"m": xb}, speed=0)
    loop.drain()
    return [loop.result(h) for h in res.handles]


def _direct(cm, rows):
    return cm.predict(rows, device="cpu")


# -- the pieces against the JAX package ----------------------------------------


def test_adaptive_window_equals_jax():
    rng = np.random.default_rng(4)
    ours = AdaptiveWindow(min_s=1e-3, max_s=0.1, target_rows=10, alpha=0.3)
    ref = JAdaptiveWindow(min_s=1e-3, max_s=0.1, target_rows=10, alpha=0.3)
    assert ours.window_s == ref.window_s == 0.1
    t = 0.0
    for gap, rows in zip(rng.pareto(1.5, 300) * 1e-3, rng.integers(1, 5, 300)):
        t += float(gap)
        ours.observe(t, int(rows))
        ref.observe(t, int(rows))
        assert ours.window_s == ref.window_s
    for dt in (10.0, 1e-7):  # quiet, then flood: the caps
        for _ in range(40):
            t += dt
            ours.observe(t)
            ref.observe(t)
        assert ours.window_s == ref.window_s


@pytest.mark.parametrize("alpha", [None, 0.5])
def test_straggler_monitor_equals_jax(alpha):
    rng = np.random.default_rng(5)
    ours = StragglerMonitor(threshold=3.0, ewma_alpha=alpha, min_samples=4)
    ref = JStragglerMonitor(threshold=3.0, ewma_alpha=alpha, min_samples=4)
    dts = np.concatenate([rng.uniform(0.009, 0.011, 20), [1.0] * 4, rng.uniform(0.009, 0.011, 8)])
    flags = [ours.record(i, float(dt)) for i, dt in enumerate(dts)]
    assert flags == [ref.record(i, float(dt)) for i, dt in enumerate(dts)]
    assert sum(flags) >= 4
    assert ours.events == ref.events and ours.baseline == ref.baseline


def test_trace_equals_jax_for_one_seed():
    for models, kw in ((["x", "y"], dict(mean_interval_s=1e-3)),
                       ({"m": 10, "n": 7}, dict(marks=[(0.5, "kill"), (0.0, "start")]))):
        ours = make_trace(models, 300, seed=11, **kw)
        ref = j_make_trace(models, 300, seed=11, **kw)
        assert [tuple(vars(r).values()) for r in ours.requests] == \
            [tuple(vars(r).values()) for r in ref.requests]
        assert [tuple(vars(m).values()) for m in ours.marks] == \
            [tuple(vars(m).values()) for m in ref.marks]
    a = make_trace(["x", "y"], 500, seed=11)
    assert a == make_trace(["x", "y"], 500, seed=11) and a != make_trace(["x", "y"], 500, seed=12)


def test_replay_paces_and_fires_marks():
    t = [0.0]
    trace = make_trace(["m"], 20, seed=3, mean_interval_s=1e-2, marks=[(0.5, "mid")])
    seen, fired = [], []
    res = replay_trace(
        lambda model, q: seen.append((t[0], q.shape[0])) or len(seen),
        trace, {"m": np.zeros((8, 4), np.int32)},
        speed=2.0,
        callbacks={"mid": lambda: fired.append(t[0])},
        clock=lambda: t[0],
        sleep=lambda d: t.__setitem__(0, t[0] + d),
    )
    assert res.submitted == 20 and res.shed == 0
    for (at, _), req in zip(seen, trace.requests):
        assert at == pytest.approx(req.t / 2.0)
    assert fired == [pytest.approx(trace.marks[0].t / 2.0)]


# -- bit-equality ----------------------------------------------------------------


def test_cluster_bit_equal_to_port_and_jax_serve_loops(served):
    jcm, cm, _, xb = served
    trace = make_trace(["m"], 120, seed=5, mean_interval_s=2e-4, mean_rows=1.5)
    oracle = _oracle(cm, trace, xb)
    jreg = JTableRegistry()
    jreg.register("m", jcm)
    jloop = JServeLoop(jreg, window_s=100.0, flush_rows=16, max_batch=128)
    jres = replay_trace(jloop.submit, trace, {"m": xb}, speed=0)
    jloop.drain()
    with _server() as srv:
        srv.register("m", cm)
        res = replay_trace(srv.submit, trace, {"m": xb}, speed=0)
        srv.drain(timeout=60)
        stats = srv.stats("m")
        assert stats.n_requests == 120 and stats.n_rows == trace.n_rows
        assert stats.p99_ms >= stats.p50_ms >= 0.0
        for h, want, jh in zip(res.handles, oracle, jres.handles):
            got = h.result(5)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, jloop.result(jh))
        # every replica serves the artifact's one engine
        engines = {id(r.registry.engine("m")) for r in srv.replicas.values()}
        assert engines == {id(cm.engine("cpu"))}


def test_cluster_margin_kind_close_to_jax(served):
    jcm, cm, _, xb = served
    trace = make_trace(["m"], 40, seed=6, mean_interval_s=2e-4)
    with _server(kind="margin") as srv:
        srv.register("m", cm)
        res = replay_trace(srv.submit, trace, {"m": xb}, speed=0)
        srv.drain(timeout=60)
        jeng = jcm.engine()
        for h, req in zip(res.handles, trace.requests):
            rows = np.take(xb, np.arange(req.row_start, req.row_start + req.n_rows),
                           axis=0, mode="wrap")
            np.testing.assert_allclose(h.result(5), np.asarray(jeng.raw_margin(rows)),
                                       rtol=RTOL, atol=ATOL)


# -- failure modes -----------------------------------------------------------------


def test_heartbeat_timeout_failover_preserves_bits(served):
    _, cm, _, xb = served
    trace = make_trace(["m"], 100, seed=8, mean_interval_s=2e-4)
    oracle = _oracle(cm, trace, xb)
    with _server() as srv:
        srv.register("m", cm)
        warm = replay_trace(srv.submit, trace, {"m": xb}, speed=0)
        srv.drain(timeout=60)
        srv.inject_hang(0)  # silent: only the heartbeat timeout finds it
        res = replay_trace(srv.submit, trace, {"m": xb}, speed=0)
        srv.drain(timeout=60)
        rep = srv.report()
        assert rep["failovers"] >= 1 and rep["replicas"][0]["state"] == "dead"
        for h, want in zip([*warm.handles, *res.handles], oracle + oracle):
            np.testing.assert_array_equal(h.result(5), want)


def test_crash_failover_mid_traffic(served):
    _, cm, _, xb = served
    trace = make_trace(["m"], 100, seed=9, mean_interval_s=2e-4, marks=[(0.5, "crash")])
    oracle = _oracle(cm, trace, xb)
    with _server() as srv:
        srv.register("m", cm)
        res = replay_trace(srv.submit, trace, {"m": xb}, speed=0,
                           callbacks={"crash": lambda: srv.inject_crash(1)})
        srv.drain(timeout=60)
        # replica 1 fails on the first job it takes after the mark, if any;
        # replica 0 serves on
        assert srv.report()["replicas"][0]["state"] != "dead"
        for h, want in zip(res.handles, oracle):
            np.testing.assert_array_equal(h.result(5), want)


def test_work_parks_while_no_replica_lives(served):
    _, cm, _, xb = served
    with _server() as srv:
        srv.register("m", cm)
        srv.kill_replica(0)
        srv.kill_replica(1)
        hs = [srv.submit("m", xb[i]) for i in range(8)]  # parked until a restore
        time.sleep(0.1)
        assert not any(h.done() for h in hs)
        srv.restore_replica(0)
        srv.drain(timeout=60)
        assert srv.report()["failovers"] == 2
        np.testing.assert_array_equal(np.concatenate([h.result(5) for h in hs]),
                                      _direct(cm, xb[:8]))


def test_crash_on_first_job_fails_over(served):
    _, cm, _, xb = served
    trace = make_trace(["m"], 100, seed=9, mean_interval_s=2e-4)
    oracle = _oracle(cm, trace, xb)
    with _server() as srv:
        srv.register("m", cm)
        srv.inject_crash(0)  # fail-stop on its first routed job
        res = replay_trace(srv.submit, trace, {"m": xb}, speed=0)
        srv.drain(timeout=60)
        rep = srv.report()
        assert rep["replicas"][0]["state"] == "dead" and rep["failovers"] >= 1
        assert rep["replicas"][1]["served_requests"] == 100
        for h, want in zip(res.handles, oracle):
            np.testing.assert_array_equal(h.result(5), want)


def test_straggler_excluded_from_routing(served):
    _, cm, _, xb = served
    # the heartbeat timeout exceeds the injected delay: a slow replica,
    # not a dead one (workers beat between jobs)
    with _server(straggler_threshold=3.0, straggler_strikes=2, heartbeat_timeout_s=10.0) as srv:
        srv.register("m", cm)
        for _ in range(12):  # pull the shared EWMA down to steady flushes
            hs = [srv.submit("m", xb[i]) for i in range(16)]
            srv.drain(timeout=60)
            for h in hs:
                h.result(5)
        srv.inject_delay(0, 0.5)
        handles = []
        for _ in range(6):  # alternating routing feeds the slow replica
            hs = [srv.submit("m", xb[i]) for i in range(16)]
            srv.drain(timeout=60)
            handles.extend(hs)
        rep = srv.report()
        assert rep["replicas"][0]["state"] == "excluded"
        assert rep["straggler_events"] >= 2
        direct = _direct(cm, xb[:16])
        for i, h in enumerate(handles):  # slow, not wrong
            np.testing.assert_array_equal(h.result(5), direct[i % 16 : i % 16 + 1])
        before = srv.report()["replicas"][0]["flushes"]
        for i in range(16):
            srv.submit("m", xb[i])
        srv.drain(timeout=60)
        assert srv.report()["replicas"][0]["flushes"] == before


def test_elastic_restore_rejoins_rotation(served):
    _, cm, _, xb = served
    with _server() as srv:
        srv.register("m", cm)
        srv.kill_replica(0)
        assert srv.report()["replicas"][0]["state"] == "dead"
        hs = [srv.submit("m", xb[i]) for i in range(32)]
        srv.drain(timeout=60)
        with pytest.raises(ValueError):
            srv.restore_replica(1)  # still alive
        srv.restore_replica(0)
        hs2 = [srv.submit("m", xb[i]) for i in range(32)]
        srv.drain(timeout=60)
        assert srv.report()["replicas"][0]["state"] == "alive"
        direct = _direct(cm, xb[:32])
        for i, h in enumerate([*hs, *hs2]):
            np.testing.assert_array_equal(h.result(5), direct[i % 32 : i % 32 + 1])


def test_hot_swap_under_live_traffic(served):
    _, cm_a, cm_b, xb = served
    pred_a, pred_b = _direct(cm_a, xb), _direct(cm_b, xb)
    assert (pred_a != pred_b).any()  # the swap is observable
    with _server() as srv:
        srv.register("m", cm_a)
        pre = [srv.submit("m", xb[i]) for i in range(48)]
        srv.register("m", cm_b)  # on every replica, mid-traffic
        post = [srv.submit("m", xb[i]) for i in range(48)]
        srv.drain(timeout=60)
        for i, h in enumerate(pre):  # one version or the other, never torn
            got = h.result(5)
            assert np.array_equal(got, pred_a[i : i + 1]) or np.array_equal(got, pred_b[i : i + 1])
        for i, h in enumerate(post):
            np.testing.assert_array_equal(h.result(5), pred_b[i : i + 1])


# -- admission control ---------------------------------------------------------------


def test_overload_sheds_with_explicit_backpressure(served):
    _, cm, _, xb = served
    with _server(flush_rows=1000, max_queue_rows=8,
                 window=AdaptiveWindow(min_s=5.0, max_s=5.0)) as srv:
        srv.register("m", cm)
        handles, sheds = [], 0
        for i in range(12):  # the queue holds 8 rows: 4 sheds
            try:
                handles.append(srv.submit("m", xb[i]))
            except ShedError:
                sheds += 1
        assert sheds == 4 and len(handles) == 8
        assert srv.report()["shed"] == {"m": 4}
        srv.drain(timeout=60)
        direct = _direct(cm, xb[:8])
        for i, h in enumerate(handles):
            np.testing.assert_array_equal(h.result(5), direct[i : i + 1])


def test_submit_errors(served):
    _, cm, _, xb = served
    srv = _server(n_replicas=1)
    srv.register("m", cm)
    with pytest.raises(KeyError):
        srv.submit("ghost", xb[0])
    with pytest.raises(ValueError):
        srv.submit("m", np.zeros((0, xb.shape[1]), np.int32))
    srv.close()
    with pytest.raises(ClusterClosed):
        srv.submit("m", xb[0])
    srv.close()  # idempotent
    with pytest.raises(ValueError):
        ClusterServer(n_replicas=0, device="cpu")


# -- thread safety of the shared pieces ----------------------------------------------


def test_microbatcher_concurrent_submit_flush(served):
    _, cm, _, xb = served
    eng = cm.engine("cpu")
    mb = MicroBatcher.for_engine(eng, max_batch=128)
    direct = eng.predict(xb).numpy()
    results, rid_row, lock, stop = {}, {}, threading.Lock(), threading.Event()

    def submitter(rows):
        for i in rows:
            rid = mb.submit(xb[i])
            with lock:
                rid_row[rid] = i
            time.sleep(0)

    def flusher():
        while not stop.is_set() or mb.pending_requests:
            out = mb.flush()
            with lock:
                results.update(out)

    threads = [threading.Thread(target=submitter, args=(range(k, 96, 4),)) for k in range(4)]
    fl = threading.Thread(target=flusher)
    fl.start()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    stop.set()
    fl.join(timeout=60)
    assert not fl.is_alive() and not any(th.is_alive() for th in threads)
    assert len(results) == 96  # nothing lost, nothing flushed twice
    for rid, row in rid_row.items():
        np.testing.assert_array_equal(results[rid], direct[row : row + 1])


def test_registry_concurrent_swap_and_lookup(served):
    _, cm_a, cm_b, _ = served
    reg = TableRegistry(device="cpu")
    reg.register("m", cm_a)
    errors = []

    def swapper(artifact):
        try:
            for _ in range(10):
                reg.register("m", artifact)
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    def reader():
        try:
            for _ in range(50):
                entry = reg.get("m")  # a whole entry, never a torn one
                assert entry.engine is not None and entry.version >= 1
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=swapper, args=(cm_a,)),
               threading.Thread(target=swapper, args=(cm_b,)),
               threading.Thread(target=reader), threading.Thread(target=reader)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert not errors
    assert reg.version("m") == 21  # 1 + 2 swappers x 10, no lost update
