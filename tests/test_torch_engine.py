"""(e) The port's ``XTimeEngine(device="cpu")`` against the JAX engine.

The same table through both engines (the JAX one on its jnp backend) in
the four hard modes and every table dtype they admit: plain compiled
tables, compressed tables that dropped feature columns (``feature_ids``,
from ``repro.api.build(compress='full')`` carried across by
``repro_torch.convert``), column-clustered tables (``col_perm``) and the
normal-leaf ``tests/oracles.py`` table, through ``raw_margin``/``predict``
and the ``padded_fn`` buckets.  Predictions are exact; margins within the
oracle contract (``rtol=1e-6, atol=1e-7``), exact on k/16 leaves.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracles import random_cam_table

import repro.api as japi
from repro.core.deploy import DeployConfig as JDeploy
from repro.core.engine import XTimeEngine as JEngine
from repro.core.trees import random_deep_ensemble as j_random_deep_ensemble
from repro.kernels import ops as jops
from repro_torch import convert
from repro_torch.core.compile import CAMTable
from repro_torch.core.deploy import DeployConfig
from repro_torch.core.engine import XTimeEngine

FIXTURES = Path(__file__).parent / "fixtures" / "ingest"
BINDINGS = [  # (mode, table_dtype)
    ("direct", "auto"), ("direct", "int32"), ("direct", "uint16"),
    ("inclusive", "auto"), ("inclusive", "int32"),
    ("msb_lsb", "auto"), ("two_cycle", "auto"),
]


def _jax_models():
    ens = j_random_deep_ensemble(n_trees=12, depth=4, n_features=24, n_bins=256,
                                 task="multiclass", n_classes=3, seed=4)
    # 6 trees of depth 3 split on at most 42 of 64 features: the unused
    # columns move to the tail
    sparse = j_random_deep_ensemble(n_trees=6, depth=3, n_features=64, n_bins=256,
                                    task="binary", seed=5)
    return {
        "plain": japi.build(ens),
        "col_perm": japi.build(sparse, cluster_columns=True),
        "feature_ids": japi.build(str(FIXTURES / "xgb_deep.json"), compress="full"),
    }


@pytest.fixture(scope="module")
def jax_models():
    return _jax_models()


def _port(jcm):
    """In memory: the JAX artifact's state through ``convert``."""
    return convert.from_state(*convert.to_state(jcm))


def _queries(table, rng, b=45):
    return rng.integers(0, table.n_bins, size=(b, table.n_features)).astype(np.int32)


def _check(table_j, table_t, mode, table_dtype, q):
    jeng = JEngine.from_config(table_j, JDeploy(backend="jnp", mode=mode, table_dtype=table_dtype))
    teng = XTimeEngine.from_config(table_t, DeployConfig(mode=mode, table_dtype=table_dtype),
                                   device="cpu")
    assert (teng.table_dtype, teng.kernel_mode) == (jeng.table_dtype, jeng.kernel_mode)
    assert teng.arrays.tile_mask.numpy().tobytes() == np.asarray(jeng.arrays.tile_mask).tobytes()
    jm = np.asarray(jeng.raw_margin(q))
    np.testing.assert_allclose(teng.raw_margin(q).numpy(), jm, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(teng.predict(q).numpy(), np.asarray(jeng.predict(q)))
    # serving buckets: one pre-padded int32 block, full padded output back
    qsel = np.asarray(jeng.select_features(q))
    bucket = np.asarray(jops.pad_to_bucket(jnp.asarray(qsel), 64, jeng.arrays.f_pad))
    for kind in ("margin", "predict"):
        got = teng.padded_fn(kind)(bucket).numpy()
        ref = np.asarray(jeng.padded_fn(kind)(jnp.asarray(bucket)))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    return jm


@pytest.mark.parametrize("mode,table_dtype", BINDINGS)
@pytest.mark.parametrize("kind", ["plain", "col_perm", "feature_ids"])
def test_engine_matches_jax_engine(jax_models, kind, mode, table_dtype):
    jcm = jax_models[kind]
    tcm = _port(jcm)
    if kind == "feature_ids":
        assert tcm.table.feature_ids is not None
        assert tcm.table.n_cols < tcm.table.n_features
    if kind == "col_perm":
        assert tcm.table.col_perm is not None
    q = _queries(jcm.table, np.random.default_rng(len(kind)))
    m = _check(jcm.table, tcm.table, mode, table_dtype, q)
    if kind != "feature_ids":  # k/16 leaves: exact against the JAX engine too
        np.testing.assert_array_equal(tcm.raw_margin(q, device="cpu", mode=mode,
                                                     table_dtype=table_dtype), m)


@pytest.mark.parametrize("mode,table_dtype", BINDINGS)
def test_engine_matches_jax_engine_normal_leaves(mode, table_dtype):
    """The oracle gate's table: wildcard sentinel rows, normal leaves."""
    rng = np.random.default_rng(9)
    jt = random_cam_table(rng, r=80, f=20, n_outputs=3)
    tt = CAMTable(**{f.name: getattr(jt, f.name) for f in dataclasses.fields(jt)})
    _check(jt, tt, mode, table_dtype, _queries(jt, rng))


def test_engine_bind_errors():
    rng = np.random.default_rng(0)
    jt = random_cam_table(rng, r=16, f=4)
    tt = CAMTable(**{f.name: getattr(jt, f.name) for f in dataclasses.fields(jt)})
    with pytest.raises(ValueError, match="CUDA kernel"):
        XTimeEngine(tt, config=DeployConfig(fuse_epilogue=True), device="cpu")
    eng = XTimeEngine(tt, device="cpu")
    assert eng.batch_multiple == 1 and not eng.fuse_epilogue
    soft = XTimeEngine(tt, config=DeployConfig(mode="soft", tau=0.25), device="cpu")
    assert (soft.kernel_mode, soft.table_dtype, soft.tau) == ("soft", "float32", 0.25)
    assert soft.arrays.low.dtype == soft.arrays.high.dtype == torch.float32
    assert tuple(soft._moments.shape) == (soft.arrays.r_pad, 8)  # 3 * 1 channels -> 8
    assert eng.tau == 0.0 and eng._moments is None
    with pytest.raises(ValueError, match="expected"):
        eng.padded_fn("margin")(np.zeros((4, 3), np.int32))
    with pytest.raises(ValueError, match="do not fit"):
        eng.raw_margin(np.full((2, 4), 300, np.int32))
