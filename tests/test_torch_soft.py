"""The soft cell mode of the port against the JAX package (DESIGN.md §15).

The same seeded inputs through both packages, at the shapes of
``tests/test_soft_mode.py`` (about 96 rows x 12 features):

(a) the torch ``soft_cell_logscore``/``soft_match_scores`` against
    ``repro.core.precision`` on every 8-bit edge, ±inf and 0 bounds;
(b) the float32 soft tables and their tile mask, byte-equal;
(c) the plain ``cam_match_ref(mode='soft')``/``soft_scores_ref`` against the
    JAX reference and its Pallas kernel (interpret mode, as the JAX
    package's own CPU tests run it);
(d) the port's ``XTimeEngine(device="cpu", mode="soft")`` against the JAX
    soft engine: margins, predictions, raw moments, uncertainty and the
    ``padded_fn`` buckets, on plain, ``col_perm`` and ``feature_ids`` tables;
(e) ``predict_proba`` and ``predict(return_uncertainty=True)`` on models
    trained by the JAX package, across save/load in both directions;
(f) the error messages of hard bindings and regression models.

Tolerance: the ``tests/oracles.py`` contract, ``rtol=1e-6, atol=1e-7``.
Both packages evaluate ``min(x, 0) - log1p(exp(-|x|))`` in float32 with
their own ``exp``/``log1p``; their log-scores differ by at most 2 ULP, and
sums of them by float32 reassociation.  At tau = 0 every score is 0 or 1
and the results are exact.  The uncertainty, a cancelling difference of
the moments, is held per element to the limit that the contract on the
moments implies (derived in ``_assert_uncertainty_close``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracles import env_interpret_kernel, random_cam_table, random_tables
from test_torch_engine import _jax_models, _port

import repro.api as japi
from repro.core import precision as jprec
from repro.core.deploy import DeployConfig as JDeploy
from repro.core.engine import XTimeEngine as JEngine
from repro.core.quantize import FeatureQuantizer
from repro.core.trees import GBDTParams, train_gbdt
from repro.core.trees import random_deep_ensemble as j_random_deep_ensemble
from repro.kernels import ops as jops
from repro.kernels.cam_match import cam_match_pallas
from repro.kernels.ref import cam_match_ref as j_ref
from repro_torch import CompiledModel
from repro_torch.core import precision as tprec
from repro_torch.core.compile import CAMTable
from repro_torch.core.deploy import DeployConfig
from repro_torch.core.engine import XTimeEngine
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import cam_match_ref, soft_scores_ref

TOL = dict(rtol=1e-6, atol=1e-7)
TAUS = [0.0, 0.1, 0.5, 1.0]
EDGES = np.array([0, 1, 15, 16, 17, 127, 128, 129, 239, 240, 254, 255, 256])


def _port_table(jt) -> CAMTable:
    return CAMTable(**{f.name: getattr(jt, f.name) for f in dataclasses.fields(jt)})


# -- (a) log-scores -----------------------------------------------------------


def _edge_cells():
    """Every pair of 8-bit edge bounds through the soft encoding (real,
    wildcard and never-match cells), plus raw ±inf, ±0.5 and 0 bounds."""
    lo, hi = np.meshgrid(EDGES, EDGES, indexing="ij")
    lo_f, hi_f = jprec.encode_soft_bounds(lo.ravel(), hi.ravel(), 256)
    raw = np.array([-np.inf, -0.5, 0.0, 0.5, 127.5, 255.5, np.inf], np.float32)
    rl, rh = np.meshgrid(raw, raw, indexing="ij")
    return (np.concatenate([lo_f, rl.ravel()]).astype(np.float32),
            np.concatenate([hi_f, rh.ravel()]).astype(np.float32))


@pytest.mark.parametrize("tau", TAUS)
def test_logscore_matches_jax_on_every_edge(tau):
    low, high = _edge_cells()
    q = np.arange(0, 257, dtype=np.float32)[:, None]  # every 8-bit bin and n_bins
    want = np.asarray(jprec.soft_cell_logscore(jnp.asarray(q), jnp.asarray(low)[None],
                                               jnp.asarray(high)[None], tau))
    got = tprec.soft_cell_logscore(torch.from_numpy(q), torch.from_numpy(low)[None],
                                   torch.from_numpy(high)[None], tau).numpy()
    assert not np.isnan(got).any() and (got <= 0.0).all()
    np.testing.assert_allclose(got, want, **TOL)  # -inf == -inf, 0.0 == -0.0
    wild = np.isneginf(low) & np.isposinf(high)
    never = np.isposinf(low) & np.isneginf(high)
    assert wild.any() and never.any()
    assert (got[:, wild] == 0.0).all() and np.isneginf(got[:, never]).all()
    if tau == 0.0:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tau", TAUS)
def test_match_scores_match_jax(tau):
    rng = np.random.default_rng(2)
    table = random_cam_table(rng, r=64, f=10, n_bins=256)
    low, high = jprec.encode_soft_bounds(table.low, table.high, table.n_bins)
    q = rng.integers(0, 256, size=(16, 10)).astype(np.float32)
    want = np.asarray(jprec.soft_match_scores(jnp.asarray(q), jnp.asarray(low),
                                              jnp.asarray(high), tau))
    got = tprec.soft_match_scores(torch.from_numpy(q), torch.from_numpy(low),
                                  torch.from_numpy(high), tau).numpy()
    assert ((got >= 0.0) & (got <= 1.0)).all()
    np.testing.assert_allclose(got, want, **TOL)


# -- (b) soft tables ----------------------------------------------------------


def _same_bytes(a: np.ndarray, b: np.ndarray) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _perturbed(rng, r, f, n_bins):
    """Bounds off the grid: negative, past n_bins, high <= low."""
    low = rng.integers(-20, n_bins + 20, size=(r, f)).astype(np.int32)
    high = rng.integers(-20, n_bins + 20, size=(r, f)).astype(np.int32)
    wild = rng.random((r, f)) < 0.3
    low[wild], high[wild] = 0, n_bins
    return low, high


@pytest.mark.parametrize("kind", ["compiled", "perturbed"])
@pytest.mark.parametrize("encode_rows", [7, 1 << 14])
def test_soft_tables_byte_equal(kind, encode_rows, monkeypatch):
    """Padding rows and columns included; the row-chunked encoding (7 rows
    a block here) gives the bytes of the one-shot one."""
    monkeypatch.setattr(tops, "SOFT_ENCODE_ROWS", encode_rows)
    rng = np.random.default_rng(5)
    if kind == "compiled":
        low, high = random_tables(rng, 90, 11, 256)
    else:
        low, high = _perturbed(rng, 90, 11, 256)
    low[:32, :8], high[:32, :8] = 0, 256  # one all-wildcard tile
    leaf = rng.normal(size=(90, 3)).astype(np.float32)
    for n_bins in (256, None):
        kw = dict(r_blk=32, f_blk=8, n_bins=n_bins, c_mult=8, dtype="float32")
        a = jops.pack_tables(low, high, leaf, **kw)
        b = tops.pack_tables(low, high, leaf, **kw)
        for x, y in zip(a[:3], b[:3]):
            _same_bytes(x, y)
        assert a[3] is b[3] is False
        lo = b[0]
        assert np.isneginf(lo[:90, 11:]).all() and np.isposinf(lo[90:]).all()
        ma = jops.wildcard_tile_mask(a[0], a[1], r_blk=32, f_blk=8, n_bins=256, inclusive=False)
        mb = tops.wildcard_tile_mask(b[0], b[1], r_blk=32, f_blk=8, n_bins=256, inclusive=False)
        _same_bytes(ma, mb)
        assert mb.sum() > 0 and (mb[0, 0] == 0) == (n_bins == 256)


def test_float_query_padding():
    q = np.random.default_rng(3).integers(0, 256, size=(9, 6))
    want = np.asarray(jops.pad_to_bucket(jnp.asarray(q), 16, 32, dtype="float32"))
    for src in (q, q.astype(np.uint8), torch.from_numpy(q), torch.from_numpy(q).float()):
        got = tops.pad_to_bucket(src, 16, 32, dtype="float32")
        assert got.dtype == torch.float32
        _same_bytes(got.numpy(), want)


# -- (c) the plain version, kernel level ---------------------------------------


def _soft_problem(seed, n_bins=256, r=96, f=12, b=32, c=3, dyadic=False):
    rng = np.random.default_rng(seed)
    low, high = random_tables(rng, r, f, n_bins)
    if dyadic:  # k/16 leaves: sums of them are exact in any order
        leaf = (rng.integers(-16, 17, size=(r, c)) / 16.0).astype(np.float32)
    else:
        leaf = rng.normal(size=(r, c)).astype(np.float32)
    q = rng.integers(0, n_bins, size=(b, f)).astype(np.int32)
    q[:4], q[4:8] = 0, n_bins - 1
    lo, hi, lm, _ = jops.pack_tables(low, high, leaf, r_blk=32, f_blk=128,
                                     n_bins=n_bins, dtype="float32")
    mask = jops.wildcard_tile_mask(lo, hi, r_blk=32, f_blk=128, n_bins=n_bins,
                                   inclusive=False)
    qp = np.zeros((b, lo.shape[1]), np.float32)
    qp[:, :f] = q
    return dict(q=qp, low=lo, high=hi, leaf=lm, mask=mask, raw=(low, high, leaf, q))


@pytest.mark.parametrize("tau", TAUS)
def test_plain_version_matches_jax(tau):
    p = _soft_problem(7, dyadic=tau == 0.0)
    tq, tlo, thi, tlm = (torch.from_numpy(p[k]) for k in ("q", "low", "high", "leaf"))
    jq, jlo, jhi, jlm = (jnp.asarray(p[k]) for k in ("q", "low", "high", "leaf"))
    got = cam_match_ref(tq, tlo, thi, tlm, mode="soft", tau=tau).numpy()
    want = np.asarray(j_ref(jq, jlo, jhi, jlm, mode="soft", tau=tau))
    pallas = np.asarray(cam_match_pallas(jq, jlo, jhi, jlm, jnp.asarray(p["mask"]),
                                         b_blk=32, r_blk=32, f_blk=128, mode="soft",
                                         tau=tau, interpret=env_interpret_kernel()))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)
    scores = soft_scores_ref(tq, tlo, thi, tau=tau).numpy()
    np.testing.assert_allclose(
        scores, np.asarray(jprec.soft_match_scores(jq, jlo, jhi, tau)), **TOL)
    if tau == 0.0:  # the exact limit: equal to the JAX results and to 'direct'
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, pallas)
        assert set(np.unique(scores)) <= {0.0, 1.0}
        low, high, leaf, q = p["raw"]
        ilo, ihi, ilm = tops.pad_tables(low, high, leaf, r_blk=32, f_blk=128, n_bins=256)
        qi = torch.from_numpy(p["q"].astype(np.int32))
        direct = cam_match_ref(qi, *(torch.from_numpy(a) for a in (ilo, ihi, ilm)),
                               mode="direct")
        np.testing.assert_array_equal(got, direct.numpy())


def test_plain_version_row_chunks(monkeypatch):
    """Walking the rows in chunks changes nothing but the float order."""
    from repro_torch.kernels import ref

    p = _soft_problem(8)
    args = [torch.from_numpy(p[k]) for k in ("q", "low", "high", "leaf")]
    one = cam_match_ref(*args, mode="soft", tau=0.25)
    s_one = soft_scores_ref(*args[:3], tau=0.25)
    monkeypatch.setattr(ref, "CHUNK_ELEMS", 32 * 256 * 5)  # 5 rows per chunk
    np.testing.assert_allclose(cam_match_ref(*args, mode="soft", tau=0.25), one, **TOL)
    assert torch.equal(soft_scores_ref(*args[:3], tau=0.25), s_one)


# -- (d) the engine ------------------------------------------------------------


def _assert_uncertainty_close(got, want, moments, C, pred=None):
    """The port's uncertainty against the JAX package's, per element,
    within the limit that the moments' contract implies.

    Both packages form ``var = m2/mass - (m1/mass)^2`` in float64 from
    float32 moments that agree within ``d(m) = atol + rtol*|m|`` (TOL,
    checked on ``raw_moments`` above).  With ``mean = m1/mass``, to first
    order ``|d var| <= (d m2 + (m2/mass) d mass + 2|mean| (d m1 + |mean|
    d mass)) / mass``: the cancellation in ``m2/mass - mean^2`` turns the
    moments' relative error into ``m2 / (mass var)`` times as much on var.
    A factor 2 covers the second-order terms.  Then ``std = sqrt(max(var,
    0))`` moves by at most ``min(sqrt|d var|, |d var| / std)`` (as
    ``|sqrt a - sqrt b| = |a - b| / (sqrt a + sqrt b)``), and each side's
    float32 cast adds ``u |std|``.  ``pred`` picks the predicted channel,
    as ``predict(return_uncertainty=True)`` does."""
    m = np.asarray(moments, dtype=np.float64)
    m1, m2, mass = m[:, :C], m[:, C:2 * C], np.maximum(m[:, 2 * C:3 * C], 1e-12)
    d = TOL["atol"] + TOL["rtol"] * np.abs(m)
    d1, d2, dmass = d[:, :C], d[:, C:2 * C], d[:, 2 * C:3 * C]
    mean = np.abs(m1 / mass)
    dvar = 2.0 * (d2 + (m2 / mass) * dmass + 2.0 * mean * (d1 + mean * dmass)) / mass
    std = np.sqrt(np.maximum(m2 / mass - mean * mean, 0.0))
    lim = np.minimum(np.sqrt(dvar), dvar / np.maximum(std, 1e-300)) + 2.0 * 2.0 ** -24 * std
    if pred is not None:
        lim = lim[:, 0] if C == 1 else lim[np.arange(len(pred)), np.asarray(pred, np.int64)]
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= lim).all(), (
        f"uncertainty off by {err.max()}, worst err/limit {(err / lim).max()}")


@pytest.fixture(scope="module")
def jax_models():
    return _jax_models()


def _engines(table_j, table_t, tau):
    jeng = JEngine.from_config(table_j, JDeploy(backend="jnp", mode="soft", tau=tau))
    teng = XTimeEngine.from_config(table_t, DeployConfig(mode="soft", tau=tau), device="cpu")
    return jeng, teng


def _check_engine(jeng, teng, q):
    assert (teng.table_dtype, teng.kernel_mode, teng.tau) == (
        jeng.table_dtype, jeng.kernel_mode, jeng.tau)
    a, ja = teng.arrays, jeng.arrays
    for name in ("low", "high", "leaf", "tile_mask"):
        _same_bytes(getattr(a, name).numpy(), np.asarray(getattr(ja, name)))
    _same_bytes(teng._moments.numpy(), np.asarray(jeng._moments))
    jm = np.asarray(jeng.raw_margin(q))
    np.testing.assert_allclose(teng.raw_margin(q).numpy(), jm, **TOL)
    np.testing.assert_allclose(teng.raw_moments(q).numpy(),
                               np.asarray(jeng.raw_moments(q)), **TOL)
    _assert_uncertainty_close(teng.uncertainty(q).numpy(), np.asarray(jeng.uncertainty(q)),
                              np.asarray(jeng.raw_moments(q)), teng.table.n_outputs)
    jp, tp = np.asarray(jeng.predict(q)), teng.predict(q).numpy()
    if teng.table.task == "regression":
        np.testing.assert_allclose(tp, jp, **TOL)
    else:
        # class ids are equal wherever the JAX top-two gap exceeds the
        # margin tolerance; the rest (ties of k/16 leaves, mostly) must
        # have bit-equal margins, and at these seeds no other row is left
        tm = teng.raw_margin(q).numpy()
        if jm.shape[1] > 1:
            top2 = np.sort(jm, axis=1)[:, -2:]
            close = (top2[:, 1] - top2[:, 0]) <= TOL["atol"] + TOL["rtol"] * np.abs(top2[:, 1])
        else:
            close = np.abs(jm[:, 0]) <= TOL["atol"]
        assert not (close & (tm != jm).any(axis=1)).any()
        np.testing.assert_array_equal(tp, jp)
    qsel = np.asarray(jeng.select_features(q))
    bucket = np.asarray(jops.pad_to_bucket(jnp.asarray(qsel), 64, ja.f_pad))
    for kind in ("margin", "predict"):
        got = teng.padded_fn(kind)(bucket).numpy()
        ref = np.asarray(jeng.padded_fn(kind)(jnp.asarray(bucket)))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("tau", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("kind", ["plain", "col_perm", "feature_ids"])
def test_engine_matches_jax_soft_engine(jax_models, kind, tau):
    jcm = jax_models[kind]
    tcm = _port(jcm)
    q = np.random.default_rng(len(kind)).integers(
        0, jcm.table.n_bins, size=(45, jcm.table.n_features)).astype(np.int32)
    jeng, teng = _engines(jcm.table, tcm.table, tau)
    _check_engine(jeng, teng, q)
    if tau == 0.0:  # the exact limit: bit-equal to 'direct' in the port
        direct = tcm.engine("cpu", mode="direct", table_dtype="int32")
        assert torch.equal(teng.raw_margin(q), direct.raw_margin(q))
        moments = teng.raw_moments(q).numpy()
        C = tcm.table.n_outputs
        np.testing.assert_array_equal(moments[:, 2 * C:].sum(axis=1), tcm.table.n_trees)


def test_engine_matches_jax_soft_engine_normal_leaves():
    rng = np.random.default_rng(9)
    jt = random_cam_table(rng, r=96, f=12, n_bins=256, n_outputs=3)
    q = rng.integers(0, 256, size=(64, 12)).astype(np.int32)
    for tau in (0.1, 0.25):
        _check_engine(*_engines(jt, _port_table(jt), tau), q)


# -- (e) the API ---------------------------------------------------------------


def _trained(task, tau=0.25, n=300, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    if task == "binary":
        y = (x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.normal(size=n) > 0).astype(np.int32)
        n_classes = 1
    else:
        y = ((x[:, 0] > 0).astype(np.int32) + (x[:, 1] > 0.5)).astype(np.int32)
        n_classes = 3
    quant = FeatureQuantizer.fit(x, 256)
    ens = train_gbdt(quant.transform(x), y, task=task, n_bins=256, n_classes=n_classes,
                     params=GBDTParams(n_rounds=6, max_depth=3))
    return japi.build(ens, quantizer=quant, deploy=JDeploy(mode="soft", tau=tau)), x


@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_predict_proba_and_uncertainty_across_packages(task, tmp_path):
    jcm, x = _trained(task)
    jcm.save(tmp_path / "j")
    tcm = CompiledModel.load(tmp_path / "j")
    assert (tcm.deploy.mode, tcm.deploy.tau) == ("soft", 0.25)
    p = tcm.predict_proba(x, device="cpu")
    np.testing.assert_allclose(p, jcm.predict_proba(x), **TOL)
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-5)
    assert p.shape == (x.shape[0], 2 if task == "binary" else 3)
    pred, unc = tcm.predict(x, device="cpu", return_uncertainty=True)
    jpred, junc = jcm.predict(x, return_uncertainty=True)
    np.testing.assert_array_equal(pred, jpred)
    _assert_uncertainty_close(unc, junc, jcm.engine().raw_moments(jcm.quantizer.transform(x)),
                              jcm.table.n_outputs, jpred)
    assert np.isfinite(unc).all() and (unc >= 0).all()
    # the port's save -> the JAX package's load: mode and tau round-trip
    tcm.save(tmp_path / "t")
    back = japi.CompiledModel.load(tmp_path / "t")
    assert (back.deploy.mode, back.deploy.tau) == ("soft", 0.25)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    np.testing.assert_array_equal(back.predict_proba(x), jcm.predict_proba(x))
    again = CompiledModel.load(tmp_path / "t")
    np.testing.assert_array_equal(again.predict_proba(x, device="cpu"), p)


def test_port_build_of_a_soft_model():
    ens = j_random_deep_ensemble(n_trees=6, depth=3, n_features=8, n_bins=64,
                                 task="multiclass", n_classes=4, seed=2)
    from repro_torch import build
    from repro_torch.core.trees import random_deep_ensemble as t_random_deep_ensemble

    tens = t_random_deep_ensemble(n_trees=6, depth=3, n_features=8, n_bins=64,
                                  task="multiclass", n_classes=4, seed=2)
    jcm = japi.build(ens, deploy=JDeploy(mode="soft", tau=0.1))
    tcm = build(tens, deploy=DeployConfig(mode="soft", tau=0.1))
    q = np.random.default_rng(3).integers(0, 64, size=(20, 8)).astype(np.int32)
    np.testing.assert_allclose(tcm.predict_proba(q, device="cpu"), jcm.predict_proba(q), **TOL)
    np.testing.assert_allclose(tcm.raw_margin(q, device="cpu"), np.asarray(jcm.raw_margin(q)),
                               **TOL)


# -- (f) error messages ---------------------------------------------------------


def _message(fn) -> str:
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


def test_hard_bindings_and_regression_raise_as_jax(tmp_path):
    jcm, x = _trained("binary")
    jcm.save(tmp_path / "m")
    tcm = CompiledModel.load(tmp_path / "m")
    for mode in ("direct", "inclusive", "msb_lsb"):
        for call in ("predict_proba", "uncertainty"):
            if call == "predict_proba":
                t = _message(lambda: tcm.predict_proba(x, device="cpu", mode=mode))
                j = _message(lambda: jcm.predict_proba(x, mode=mode))
            else:
                t = _message(lambda: tcm.predict(x, device="cpu", mode=mode,
                                                 return_uncertainty=True))
                j = _message(lambda: jcm.predict(x, mode=mode, return_uncertainty=True))
            assert t == j and "cell_mode='soft'" in t
        q = tcm.quantizer.transform(x)
        for method in ("raw_moments", "uncertainty"):
            t = _message(lambda: getattr(tcm.engine("cpu", mode=mode), method)(q))
            j = _message(lambda: getattr(jcm.engine(mode=mode), method)(q))
            assert t == j
    ens = j_random_deep_ensemble(n_trees=3, depth=2, n_features=4, n_bins=32,
                                 task="regression", seed=1)
    japi.build(ens, deploy=JDeploy(mode="soft")).save(tmp_path / "reg")
    jreg = japi.CompiledModel.load(tmp_path / "reg")
    treg = CompiledModel.load(tmp_path / "reg")
    q = np.zeros((2, 4), np.int32)
    assert _message(lambda: treg.predict_proba(q, device="cpu")) == _message(
        lambda: jreg.predict_proba(q))
    pred, unc = treg.predict(q, device="cpu", return_uncertainty=True)
    jpred, junc = jreg.predict(q, return_uncertainty=True)
    np.testing.assert_allclose(pred, jpred, **TOL)
    _assert_uncertainty_close(unc, junc, jreg.engine().raw_moments(q), 1, jpred)
