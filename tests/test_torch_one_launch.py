"""``predict(return_uncertainty=True)`` from one soft kernel launch
(``XTimeEngine.margin_and_moments``), on the CPU.

On one card the engine runs the moments launch once and takes the margins
from its m1 columns, adding the bias as the reduce kernel adds it (one
float32 add after the split sum); the kernel's per-output float sequence
does not depend on the matrix width, so that equals the margin launch bit
for bit (held on the card by tests/test_torch_gpu.py and chip_smoke.py).
The plain version's CPU product sums in a width-dependent order, so a CPU
engine runs both passes.  Here:

(a) ``CompiledModel.predict(return_uncertainty=True)`` equals ``predict``
    and ``uncertainty`` called apart, bit for bit, on a CPU engine, for
    multiclass, binary and regression models, gbdt and rf;
(b) the one-launch arithmetic itself — the m1 columns + bias, the
    epilogue — with the engine made to take it and a column-independent
    stand-in for the kernel: equal to ``raw_margin`` / ``raw_moments`` /
    ``predict`` through the same stand-in, bit for bit, with the bias fused
    into the kernel (as a card engine binds it) and added after it;
(c) on models trained by the JAX package: the port's
    ``predict(return_uncertainty=True)`` against the JAX package's as
    ``tests/test_torch_soft.py`` holds it (predictions equal, uncertainty
    within the limit the moments' contract implies).
"""

import numpy as np
import pytest
import torch
from test_torch_soft import _assert_uncertainty_close, _trained

import repro_torch
from repro_torch import CompiledModel
from repro_torch.core.engine import XTimeEngine
from repro_torch.core.trees import RFParams, random_deep_ensemble, train_rf
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import soft_scores_ref


def _models():
    """name -> (soft CompiledModel, uint8 query bins)."""
    rng = np.random.default_rng(5)
    out = {}
    for name, task, n_classes in (("multiclass", "multiclass", 4),
                                  ("binary", "binary", 1), ("regression", "regression", 1)):
        ens = random_deep_ensemble(n_trees=12, depth=5, n_features=10, n_bins=256, task=task,
                                   n_classes=n_classes, seed=len(out))
        deploy = repro_torch.DeployConfig(mode="soft", tau=0.2)
        out[name] = (repro_torch.build(ens, deploy=deploy),
                     rng.integers(0, 256, size=(45, 10)).astype(np.uint8))
    xb = rng.integers(0, 256, size=(200, 6)).astype(np.uint8)
    y = (xb[:, 0] > 128).astype(np.int32) + (xb[:, 1] > 64)
    rf = train_rf(xb, y, task="multiclass", n_bins=256, n_classes=3,
                  params=RFParams(n_trees=5, max_depth=4))
    out["rf"] = (repro_torch.build(rf, deploy=repro_torch.DeployConfig(mode="soft", tau=0.3)),
                 xb[:37])
    return out


MODELS = _models()


def _picked(u: np.ndarray, pred: np.ndarray, n_outputs: int) -> np.ndarray:
    return u[:, 0] if n_outputs == 1 else u[np.arange(pred.shape[0]), pred.astype(np.int64)]


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("b", [1, 7, 45])
def test_one_call_equals_predict_and_uncertainty_apart(name, b):
    cm, x = MODELS[name]
    x = x[:b]
    pred, unc = cm.predict(x, device="cpu", return_uncertainty=True)
    eng = cm.engine("cpu")
    np.testing.assert_array_equal(pred, cm.predict(x, device="cpu"))
    np.testing.assert_array_equal(unc, _picked(eng.uncertainty(x).numpy(), pred,
                                               cm.table.n_outputs))
    margin, moments = eng.margin_and_moments(x)
    assert torch.equal(margin, eng.raw_margin(x)) and torch.equal(moments, eng.raw_moments(x))


def _per_column(q, low, high, leaf, cells=None, bias=None, *, out_b, out_c, mode, tau):
    """A stand-in for the kernel whose every output column is summed on
    its own (as the card's kernel sums it): one matrix-vector product a
    column, then the bias."""
    assert mode == "soft"
    s = soft_scores_ref(q, low, high, tau=tau)
    out = torch.stack([s @ leaf[:, c].contiguous() for c in range(leaf.shape[1])], dim=1)
    if bias is not None:
        out = out + bias
    return out[:out_b, :out_c]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name", list(MODELS))
def test_the_one_launch_arithmetic(name, fused, monkeypatch):
    cm, x = MODELS[name]
    eng = cm.engine("cpu")
    if fused:  # as a card engine binds it: the base score as the kernel's bias row
        monkeypatch.setattr(eng, "fuse_epilogue", True)
        monkeypatch.setattr(eng, "_bias", torch.full(
            (1, eng.arrays.c_pad), float(np.float32(cm.table.base_score))))
    monkeypatch.setattr(tops, "cam_match", _per_column)
    want_margin, want_moments = eng.raw_margin(x), eng.raw_moments(x)
    monkeypatch.setattr(XTimeEngine, "_one_launch_moments", property(lambda self: True))
    calls = []
    monkeypatch.setattr(tops, "cam_match", lambda *a, **k: calls.append(1) or
                        _per_column(*a, **k))
    margin, moments = eng.margin_and_moments(x)
    assert len(calls) == 1  # one pass, over the moments matrix
    assert torch.equal(margin, want_margin) and torch.equal(moments, want_moments)
    assert eng.fuse_epilogue == (eng._bias is not None)
    pred, unc = cm.predict(x, device="cpu", return_uncertainty=True)
    assert len(calls) == 2
    np.testing.assert_array_equal(pred, eng._predict_from_margin(want_margin).numpy())
    np.testing.assert_array_equal(
        unc, _picked(eng.uncertainty_from_moments(want_moments).numpy(), pred,
                     cm.table.n_outputs))


@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_against_the_jax_package(task, tmp_path):
    jcm, x = _trained(task, seed=3)
    jcm.save(tmp_path / "j")
    tcm = CompiledModel.load(tmp_path / "j")
    pred, unc = tcm.predict(x, device="cpu", return_uncertainty=True)
    jpred, junc = jcm.predict(x, return_uncertainty=True)
    np.testing.assert_array_equal(pred, jpred)
    _assert_uncertainty_close(unc, junc, jcm.engine().raw_moments(jcm.quantizer.transform(x)),
                              jcm.table.n_outputs, jpred)
