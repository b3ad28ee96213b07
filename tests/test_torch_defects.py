"""(g) Defect injection: ``repro_torch.core.defects`` against
``repro.core.defects``, and both engines on the perturbed tables.

The same generator state draws the same perturbations in both packages.
Perturbed tables hold bounds at 0 and ``n_bins``, ``high <= low`` cells
(never-match, ``(+inf, -inf)`` in the soft layout) and drop to the int32
layout; the port's hard and soft engines on them match the JAX engines
(margins within ``rtol=1e-6, atol=1e-7``, exact at tau = 0 on k/16
leaves), and the soft tables stay byte-equal.
"""

import numpy as np
import pytest
from test_torch_engine import _check
from test_torch_soft import TOL, _check_engine, _engines

import repro.api as japi
from repro.core import defects as jdef
from repro.core.trees import random_deep_ensemble as j_random_deep_ensemble
from repro_torch import convert
from repro_torch.core import defects as tdef

FRACS = [0.0, 0.05, 0.3]


@pytest.fixture(scope="module")
def tables():
    ens = j_random_deep_ensemble(n_trees=10, depth=4, n_features=12, n_bins=256,
                                 task="multiclass", n_classes=3, seed=6)
    jcm = japi.build(ens)
    return jcm.table, convert.from_state(*convert.to_state(jcm)).table


def _perturbed(tables, frac, seed=0):
    jt, tt = tables
    jp = jdef.inject_table_defects(jt, frac, np.random.default_rng(seed))
    tp = tdef.inject_table_defects(tt, frac, np.random.default_rng(seed))
    return jp, tp


@pytest.mark.parametrize("frac", FRACS)
def test_same_draws_as_jax(tables, frac):
    jp, tp = _perturbed(tables, frac)
    for name in ("low", "high"):
        a, b = getattr(jp, name), getattr(tp, name)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert jp.table_dtype == tp.table_dtype == "int32"
    if frac > 0:
        assert (tp.high <= tp.low).any()  # never-match cells appear
        assert (tp.low == tp.n_bins).any() or (tp.high == 0).any()
    q = np.random.default_rng(1).integers(0, 256, size=(40, 12)).astype(np.uint8)
    jq = jdef.inject_query_defects(q, frac, 256, np.random.default_rng(2))
    tq = tdef.inject_query_defects(q, frac, 256, np.random.default_rng(2))
    assert jq.dtype == tq.dtype
    np.testing.assert_array_equal(jq, tq)
    accs = [0.8, 0.75, 0.9]
    assert tdef.relative_accuracy(0.9, accs) == jdef.relative_accuracy(0.9, accs)


@pytest.mark.parametrize("mode", ["direct", "msb_lsb", "two_cycle"])
def test_hard_engines_on_perturbed_tables(tables, mode):
    jp, tp = _perturbed(tables, 0.3)
    q = np.random.default_rng(3).integers(0, 256, size=(45, 12)).astype(np.int32)
    _check(jp, tp, mode, "auto", q)


@pytest.mark.parametrize("tau", [0.0, 0.1, 0.5])
def test_soft_engines_on_perturbed_tables(tables, tau):
    jp, tp = _perturbed(tables, 0.3)
    q = np.random.default_rng(3).integers(0, 256, size=(45, 12)).astype(np.int32)
    jeng, teng = _engines(jp, tp, tau)
    lo = teng.arrays.low.numpy()
    assert np.isposinf(lo[: tp.n_rows]).any()  # perturbed never-match cells
    _check_engine(jeng, teng, q)
    scores = teng.raw_moments(q).numpy()
    assert np.isfinite(scores).all()
    if tau == 0.0:
        np.testing.assert_array_equal(teng.raw_margin(q).numpy(),
                                      np.asarray(jeng.raw_margin(q)))
    else:
        np.testing.assert_allclose(teng.raw_margin(q).numpy(),
                                   np.asarray(jeng.raw_margin(q)), **TOL)
