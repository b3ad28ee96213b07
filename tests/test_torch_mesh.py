"""The port's mesh engine (``XTimeEngine(mesh=)``) against the JAX package.

On ``devices=["cpu"] * 8`` — logical shards that share the CPU, no XLA
flag — at a small size.  The mesh engine runs the NoC programs
(accumulate, batch, hybrid) as one shard program; held to the JAX
package's SINGLE-DEVICE jnp engine (the DESIGN.md §8 guarantee): margins
within the ``tests/oracles.py`` contract (``rtol=1e-6, atol=1e-7``),
predictions exactly equal, bit-equal on k/16 leaves and from run to run.
Then the axis-order and ``pod`` meshes, the resolution rules, the tiers
on a mesh, and — in one subprocess with 8 fake XLA devices — the JAX mesh
engine's own attributes and per-shard rows.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from oracles import random_cam_table
from test_torch_soft import _assert_uncertainty_close

import repro.api as japi
from repro.core.deploy import DeployConfig as JDeploy
from repro.core.engine import XTimeEngine as JEngine
from repro.core.trees import random_deep_ensemble as j_random_deep_ensemble
from repro_torch import convert
from repro_torch.api import CompiledModel, build
from repro_torch.core.compile import CAMTable
from repro_torch.core.deploy import DeployConfig
from repro_torch.core.engine import XTimeEngine
from repro_torch.core.trees import random_deep_ensemble
from repro_torch.kernels import ops
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.score import score_file
from repro_torch.serve import ClusterServer, ServeLoop, TableRegistry

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = dict(rtol=1e-6, atol=1e-7)
MODES = ("direct", "inclusive", "msb_lsb", "two_cycle")
PROGRAMS = [("accumulate", "gspmd"), ("accumulate", "shard_map"), ("batch", "gspmd"),
            ("batch", "shard_map"), ("hybrid", "shard_map")]
CPU8 = ["cpu"] * 8


def _port_table(jt) -> CAMTable:
    return CAMTable(**{f.name: getattr(jt, f.name) for f in dataclasses.fields(jt)})


def _mesh(shape=(2, 4), axes=("data", "model")) -> Mesh:
    return Mesh(np.array(CPU8, dtype=object).reshape(shape), axes)


@pytest.fixture(scope="module")
def normal():
    """The oracle gate's table (normal leaves, wildcard sentinel rows) in
    both packages, and 45 seeded queries."""
    rng = np.random.default_rng(11)
    jt = random_cam_table(rng, r=200, f=12, n_bins=256, n_outputs=3)
    q = rng.integers(0, 256, size=(45, 12)).astype(np.int32)
    return jt, _port_table(jt), q


@pytest.fixture(scope="module")
def dyadic():
    """A k/16-leaf ensemble: every float32 sum is exact."""
    jcm = japi.build(j_random_deep_ensemble(n_trees=24, depth=4, n_features=16, n_bins=256,
                                            task="multiclass", n_classes=3, seed=3))
    cm = convert.from_state(*convert.to_state(jcm))
    q = np.random.default_rng(12).integers(0, 256, size=(37, 16)).astype(np.int32)
    return jcm, cm, q


# -- the NoC programs against the JAX single-device engine ------------------------


@pytest.mark.parametrize("noc,spmd", PROGRAMS)
@pytest.mark.parametrize("mode", MODES)
def test_mesh_matches_jax_single_device(normal, mode, noc, spmd):
    jt, tt, q = normal
    jeng = JEngine.from_config(jt, JDeploy(backend="jnp", mode=mode))
    eng = XTimeEngine(tt, config=DeployConfig(mode=mode, noc_config=noc, spmd=spmd),
                      mesh=_mesh())
    assert (eng.spmd, eng.noc_config, eng.device) == (spmd, noc, torch.device("cpu"))
    m = eng.raw_margin(q)
    np.testing.assert_allclose(m.numpy(), np.asarray(jeng.raw_margin(q)), **TOL)
    np.testing.assert_array_equal(eng.predict(q).numpy(), np.asarray(jeng.predict(q)))
    assert torch.equal(eng.raw_margin(q), m)  # run to run


@pytest.mark.parametrize("noc,spmd", PROGRAMS)
def test_mesh_bit_equal_on_dyadic_leaves(dyadic, noc, spmd):
    jcm, cm, q = dyadic
    want = np.asarray(jcm.engine().raw_margin(q))
    got = cm.raw_margin(q, mesh=_mesh(), noc_config=noc, spmd=spmd)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, cm.raw_margin(q, device="cpu"))
    np.testing.assert_array_equal(cm.predict(q, mesh=_mesh(), noc_config=noc, spmd=spmd),
                                  np.asarray(jcm.engine().predict(q)))


@pytest.mark.parametrize("tau", [0.0, 0.1])
def test_soft_mesh_matches_jax_single_device(normal, tau):
    jt, tt, q = normal
    jeng = JEngine.from_config(jt, JDeploy(backend="jnp", mode="soft", tau=tau))
    for noc in ("accumulate", "batch", "hybrid"):
        eng = XTimeEngine(tt, config=DeployConfig(mode="soft", tau=tau, noc_config=noc),
                          mesh=_mesh())
        np.testing.assert_allclose(eng.raw_margin(q).numpy(), np.asarray(jeng.raw_margin(q)),
                                   **TOL)
        jmom = np.asarray(jeng.raw_moments(q))
        np.testing.assert_allclose(eng.raw_moments(q).numpy(), jmom, **TOL)
        _assert_uncertainty_close(eng.uncertainty(q).numpy(), np.asarray(jeng.uncertainty(q)),
                                  jmom, tt.n_outputs)
        if tau == 0.0:  # the exact limit: bit-equal to 'direct' on the same mesh
            direct = XTimeEngine(tt, config=DeployConfig(mode="direct", noc_config=noc),
                                 mesh=_mesh())
            assert torch.equal(eng.raw_margin(q), direct.raw_margin(q))


# -- other meshes ------------------------------------------------------------------


def _launches(monkeypatch) -> list[tuple[int, int]]:
    """Record (queries, table rows) of every kernel call."""
    calls = []
    real = ops.cam_match

    def spy(q, low, *args, **kwargs):
        calls.append((q.shape[0], low.shape[0]))
        return real(q, low, *args, **kwargs)

    monkeypatch.setattr(ops, "cam_match", spy)
    return calls


@pytest.mark.parametrize("noc", ["accumulate", "batch", "hybrid"])
def test_axis_order_mesh(normal, monkeypatch, noc):
    """A (4, 2) mesh whose axes are ("model", "data"): the batch splits
    over 'data' (then 'model'), the rows over 'model', whatever the mesh's
    own axis order."""
    jt, tt, q = normal
    mesh = _mesh((4, 2), ("model", "data"))
    eng = XTimeEngine(tt, config=DeployConfig(noc_config=noc), mesh=mesh)
    assert eng._group_coords() == [{"data": 0}, {"data": 1}]
    assert len(eng.shards) == 2 and all(len(row) == 4 for row in eng.shards)
    calls = _launches(monkeypatch)
    m = eng.raw_margin(q)
    b_pad = -(-45 // eng.batch_multiple) * eng.batch_multiple
    rows = eng.arrays.r_pad // (1 if noc == "batch" else 4)
    per = b_pad // 2 if noc != "batch" else b_pad // 8
    assert calls == [(per, rows)] * 8
    jeng = JEngine.from_config(jt, JDeploy(backend="jnp"))
    np.testing.assert_allclose(m.numpy(), np.asarray(jeng.raw_margin(q)), **TOL)
    np.testing.assert_array_equal(eng.predict(q).numpy(), np.asarray(jeng.predict(q)))


@pytest.mark.parametrize("noc", ["accumulate", "batch", "hybrid"])
def test_pod_mesh(dyadic, noc):
    """A (2, 2, 2) mesh with a 'pod' axis: pod × data batch groups."""
    jcm, cm, q = dyadic
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    eng = cm.engine(mesh=mesh, noc_config=noc)
    assert eng.batch_multiple == (4 if noc == "accumulate" else 8)
    assert eng._group_coords() == [
        {"pod": 0, "data": 0}, {"pod": 0, "data": 1}, {"pod": 1, "data": 0},
        {"pod": 1, "data": 1}]
    np.testing.assert_array_equal(eng.raw_margin(q).numpy(),
                                  np.asarray(jcm.engine().raw_margin(q)))


# -- the mesh itself and the resolution rules -----------------------------------------


def test_mesh_value_equality_and_defaults(monkeypatch):
    a, b = make_host_mesh(2, 4, devices=CPU8), _mesh()
    assert a == b and hash(a) == hash(b) and a.size == 8
    assert a.shape == {"data": 2, "model": 4} and a.axis_names == ("data", "model")
    assert a != _mesh((4, 2), ("model", "data"))
    assert make_host_mesh(devices=["cpu"] * 6).shape == {"data": 3, "model": 2}
    assert make_host_mesh(devices=["cpu"] * 3).shape == {"data": 3, "model": 1}
    assert make_production_mesh(devices=["cpu"] * 256).shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True, devices=["cpu"] * 512).axis_names == (
        "pod", "data", "model")
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_host_mesh(2, 4, devices=["cpu"] * 4)
    # no card: a mesh over the cards, or naming one, raises — never the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: make_host_mesh(), lambda: make_host_mesh(2, 4),
                 lambda: make_production_mesh(), lambda: make_host_mesh(devices=["cuda"] * 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_resolution_rules(dyadic, normal):
    _, cm, q = dyadic
    _, tt, _ = normal
    mesh = _mesh()
    assert cm.resolved_deploy(device="cpu").spmd == "gspmd"
    assert cm.resolved_deploy(mesh=mesh).spmd == "shard_map"
    assert cm.resolved_deploy(mesh=mesh, spmd="gspmd").spmd == "gspmd"
    # the compiled plan's 'batch' stays on a mesh and degrades without one
    batched = build(random_deep_ensemble(n_trees=4, depth=3, n_features=5, n_bins=32,
                                         task="binary", seed=0),
                    deploy=DeployConfig(batching=True))
    assert batched.noc.engine_noc_config == "batch"
    assert batched.resolved_deploy(mesh=mesh).noc_config == "batch"
    assert batched.resolved_deploy(device="cpu").noc_config == "accumulate"
    # the bias is never fused on a mesh
    assert not cm.engine(mesh=mesh).fuse_epilogue
    with pytest.raises(ValueError, match="multiply the base score"):
        XTimeEngine(tt, config=DeployConfig(fuse_epilogue=True), mesh=mesh)
    with pytest.raises(ValueError, match="only expressible with spmd='shard_map'"):
        XTimeEngine(tt, config=DeployConfig(noc_config="hybrid", spmd="gspmd"), mesh=mesh)
    with pytest.raises(ValueError, match="lacks configured axes"):
        XTimeEngine(tt, config=DeployConfig(row_axis="cores"), mesh=mesh)
    assert [XTimeEngine(tt, config=DeployConfig(noc_config=n), mesh=mesh).batch_multiple
            for n in ("accumulate", "batch", "hybrid")] == [2, 8, 8]
    # the row padding divides over the row shards, and shards are views
    eng = XTimeEngine(tt, config=DeployConfig(r_blk=64), mesh=mesh)
    assert eng.arrays.r_pad % (64 * 4) == 0 and eng.n_row_shards == 4
    s = eng.shards[1][2]
    assert s.low.data_ptr() == eng.arrays.low[2 * eng.arrays.r_pad // 4].data_ptr()
    assert s.cells.k == eng.arrays.cells.k
    with pytest.raises(ValueError, match="not a multiple"):
        eng.padded_fn("margin")(np.zeros((3, eng.arrays.f_pad), np.int32))
    # device and mesh are exclusive; only a Mesh is a mesh
    with pytest.raises(ValueError, match="not both"):
        cm.engine("cpu", mesh=mesh)
    with pytest.raises(TypeError, match="Mesh"):
        XTimeEngine(tt, mesh=object())
    # the engine cache keys on the mesh's value
    assert cm.engine(mesh=mesh) is cm.engine(mesh=_mesh())
    assert cm.engine(mesh=mesh) is not cm.engine(mesh=mesh, spmd="gspmd")


def test_cell_list_rows():
    rng = np.random.default_rng(1)
    jt = random_cam_table(rng, r=40, f=6)
    eng = XTimeEngine(_port_table(jt), config=DeployConfig(r_blk=8), device="cpu")
    cells = eng.arrays.cells
    part = cells.rows(8, 24)
    assert (part.k, part.width, tuple(part.count.shape)) == (cells.k, cells.width, (16,))
    for name in ("count", "feat", "lo", "hi"):
        assert torch.equal(getattr(part, name), getattr(cells, name)[8:24])


# -- the tiers on a mesh --------------------------------------------------------------


def test_registry_serves_shard_map_for_free(dyadic):
    """A mesh registry binds the shard program with no caller changes, and
    the micro-batched serving outputs match the JAX single-device engine."""
    jcm, cm, q = dyadic
    reg = TableRegistry(mesh=_mesh())
    entry = reg.register("m", cm)
    assert entry.engine.spmd == "shard_map" and entry.engine.batch_multiple == 2
    assert reg.device == torch.device("cpu")
    loop = ServeLoop(reg, window_s=10.0, flush_rows=16)
    handles = [loop.submit("m", row) for row in q]
    loop.drain()
    served = np.concatenate([loop.result(h) for h in handles])
    np.testing.assert_array_equal(served, np.asarray(jcm.engine().predict(q)))
    with ClusterServer(n_replicas=2, mesh=_mesh(), flush_rows=16) as srv:
        srv.register("m", cm)
        assert all(r.registry.engine("m") is entry.engine for r in srv.replicas.values())
        handles = [srv.submit("m", row) for row in q]
        srv.drain(timeout=30)
        np.testing.assert_array_equal(np.concatenate([h.result(10) for h in handles]), served)


def test_score_file_and_saved_artifact_on_a_mesh(dyadic, tmp_path):
    jcm, cm, q = dyadic
    want = np.asarray(jcm.engine().predict(q))
    r = score_file(cm, q, kind="predict", chunk_rows=10, mesh=_mesh())
    np.testing.assert_array_equal(r.values, want)
    assert r.engine["devices"] == 8 and r.engine["noc_config"] == "batch"
    assert r.engine["spmd"] == "shard_map" and r.bucket % 8 == 0
    m = score_file(cm, q, kind="margin", chunk_rows=16, mesh=_mesh(), noc_config="hybrid")
    np.testing.assert_array_equal(m.values, np.asarray(jcm.engine().raw_margin(q)))
    jcm.save(tmp_path / "jax")  # the JAX package's save -> the port's load
    loaded = CompiledModel.load(tmp_path / "jax")
    eng = loaded.engine(mesh=_mesh())
    np.testing.assert_array_equal(eng.predict(q).numpy(), want)


# -- the JAX mesh engine, on 8 fake XLA devices ------------------------------------

_JAX_MESH = r"""
import json, numpy as np
import jax
from repro.api import build
from repro.core.trees import random_deep_ensemble
from repro.launch.mesh import make_host_mesh

cm = build(random_deep_ensemble(n_trees=24, depth=4, n_features=16, n_bins=256,
                                task="multiclass", n_classes=3, seed=3))
q = np.random.default_rng(12).integers(0, 256, size=(37, 16)).astype(np.int32)
mesh = make_host_mesh(2, 4)
out = {"n_dev": len(jax.devices()), "programs": {}}
for noc in ("accumulate", "batch", "hybrid"):
    eng = cm.engine(mesh=mesh, noc_config=noc)
    out["programs"][noc] = {
        "spmd": eng.spmd, "noc_config": eng.noc_config,
        "batch_multiple": eng.batch_multiple, "r_pad": eng.arrays.r_pad,
        "shard_rows": eng.arrays.low.addressable_shards[0].data.shape[0],
        "margin": np.asarray(eng.raw_margin(q)).tolist(),
    }
print(json.dumps(out))
"""


def test_port_mesh_matches_jax_mesh_engine(dyadic):
    env = dict(os.environ)
    # one host thread: the suite's other workers run timing-sensitive tests
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_cpu_multi_thread_eigen=false")
    env["PYTHONPATH"] = str(SRC)
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", _JAX_MESH], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n_dev"] == 8
    _, cm, q = dyadic
    mesh = make_host_mesh(2, 4, devices=CPU8)
    for noc, want in res["programs"].items():
        eng = cm.engine(mesh=mesh, noc_config=noc)
        got = {"spmd": eng.spmd, "noc_config": eng.noc_config,
               "batch_multiple": eng.batch_multiple, "r_pad": eng.arrays.r_pad,
               "shard_rows": eng.shards[0][0].low.shape[0]}
        assert got == {k: want[k] for k in got}, noc
        np.testing.assert_array_equal(eng.raw_margin(q).numpy(),
                                      np.asarray(want["margin"], np.float32))


# -- the entry points that need a mesh, on CPU shards -----------------------------------


def test_paper_scale_smoke_on_cpu_shards(capsys):
    from repro_torch.tools import paper_scale_smoke

    assert paper_scale_smoke.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "9728 rows/shard across 4 'model' shards (budget 16384" in out
    assert "margins bit-equal to the float reference" in out


def test_multichip_example_on_the_cpu():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(SRC)
    env["OMP_NUM_THREADS"] = "1"  # one host thread, as above
    r = subprocess.run([sys.executable, str(SRC.parent / "examples" / "torch_xtime_multichip.py"),
                        "--device", "cpu"], capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("pred equal: True") == 3
    assert "gspmd vs shard_map margins bit-identical: True" in r.stdout
