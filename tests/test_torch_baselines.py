"""The traversal baseline against the JAX package's, on the CPU.

``repro_torch.core.baselines.TraversalBaseline`` and
``repro.core.baselines.TraversalBaseline`` walk the same ensembles on the
same seeded queries: binary, multiclass and regression GBDTs, binary,
multiclass and regression random forests.  Tolerances: class predictions
exact; margins (and regression predictions) exact on dyadic (k/16)
leaves, otherwise within float32
reassociation of the per-class tree sum, 2·T·u·Σ_t|leaf_t| (u = 2^-24),
against the JAX baseline and against ``Ensemble.raw_margin``.
"""

import numpy as np
import pytest

from repro.core.baselines import TraversalBaseline as JTraversal
from repro.core.trees import GBDTParams, RFParams, train_gbdt, train_rf
from repro.core.trees import random_deep_ensemble as j_random_deep_ensemble
from repro_torch.core.baselines import TraversalBaseline
from repro_torch.core.trees import Ensemble, Tree

F32_EPS = 2.0 ** -24
N_BINS = 64


def port_ensemble(j) -> Ensemble:
    """The JAX package's ensemble as the port's (same arrays)."""
    trees = [Tree(t.feature, t.threshold, t.left, t.right, t.value) for t in j.trees]
    return Ensemble(
        trees=trees, n_features=j.n_features, n_bins=j.n_bins, task=j.task, kind=j.kind,
        n_classes=j.n_classes, tree_class=j.tree_class, base_score=j.base_score,
        leaf_class_mode=j.leaf_class_mode, leaf_class=list(j.leaf_class),
        n_outputs_override=j.n_outputs_override,
    )


def _data(seed, n=240, f=6):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, N_BINS, size=(n, f)).astype(np.int32)
    s = (x[:, 0] - 32) / 16.0 + (x[:, 1] - 32) / 32.0 + 0.3 * rng.normal(size=n)
    return x, s


def _ensemble(case):
    x, s = _data(1)
    if case.startswith("dyadic"):
        task = case.split("-")[1]
        return j_random_deep_ensemble(n_trees=10, depth=5, n_features=6, n_bins=N_BINS,
                                      task=task, n_classes=3 if task == "multiclass" else 1,
                                      seed=7), True
    kind, task = case.split("-")
    y = {"binary": (s > 0).astype(np.int32),
         "multiclass": np.digitize(s, [-0.5, 0.5]).astype(np.int32),
         "regression": s.astype(np.float64)}[task]
    n_classes = {"binary": 1, "multiclass": 3, "regression": 1}[task]
    if kind == "gbdt":
        ens = train_gbdt(x, y, task=task, n_bins=N_BINS, n_classes=n_classes,
                         params=GBDTParams(n_rounds=6, max_depth=4))
    else:
        ens = train_rf(x, y, task=task, n_bins=N_BINS, n_classes=max(2, n_classes)
                       if task != "regression" else 1,
                       params=RFParams(n_trees=7, max_depth=5))
    return ens, False


CASES = ["dyadic-binary", "dyadic-multiclass", "dyadic-regression",
         "gbdt-binary", "gbdt-multiclass", "gbdt-regression",
         "rf-binary", "rf-multiclass", "rf-regression"]


def _abs_sum(ens: Ensemble, q: np.ndarray) -> np.ndarray:
    """(B, C) Σ_t |leaf value| routed to each channel (the scale of the
    float32 sum's rounding)."""
    out = np.zeros((q.shape[0], ens.n_outputs))
    rows = np.arange(q.shape[0])
    for i, t in enumerate(ens.trees):
        leaves = t.leaf_ids(q)
        if ens.leaf_class_mode == "leaf":
            cls = ens.leaf_class[i][leaves]
        else:
            cls = np.full(q.shape[0], 0 if ens.tree_class is None else int(ens.tree_class[i]))
        np.add.at(out, (rows, cls), np.abs(t.value[leaves].astype(np.float64)))
    return out + abs(ens.base_score)


@pytest.mark.parametrize("case", CASES)
def test_traversal_matches_jax_baseline(case):
    jens, dyadic = _ensemble(case)
    ens = port_ensemble(jens)
    q, _ = _data(2, n=97)
    got = TraversalBaseline(ens, device="cpu").raw_margin(q).numpy()
    want = np.asarray(JTraversal(jens).raw_margin(q))
    truth = ens.raw_margin(q)
    assert got.dtype == np.float32 and got.shape == (97, ens.n_outputs)
    if dyadic:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, truth)
    else:
        lim = 2.0 * ens.n_trees * F32_EPS * _abs_sum(ens, q)
        if ens.kind == "rf":
            lim = lim / ens.n_trees + 2 * F32_EPS * np.abs(truth)  # + the divides
        assert (np.abs(got.astype(np.float64) - want) <= lim).all()
        assert (np.abs(got.astype(np.float64) - truth) <= lim).all()
    pred = TraversalBaseline(ens, device="cpu").predict(q)
    if ens.task == "regression" and not dyadic:  # the prediction is the margin
        assert (np.abs(pred - want[:, 0]) <= lim[:, 0]).all()
        assert (np.abs(pred - ens.predict(q)) <= lim[:, 0]).all()
    else:  # class ids: exact
        np.testing.assert_array_equal(pred, JTraversal(jens).predict(q))
        np.testing.assert_array_equal(pred, ens.predict(q))


def test_traversal_takes_tensors_and_checks_width():
    import torch

    jens, _ = _ensemble("dyadic-multiclass")
    ens = port_ensemble(jens)
    tb = TraversalBaseline(ens, device="cpu")
    q, _ = _data(3, n=5)
    np.testing.assert_array_equal(tb.raw_margin(torch.from_numpy(q)).numpy(),
                                  ens.raw_margin(q))
    np.testing.assert_array_equal(tb.raw_margin(q.astype(np.uint8)).numpy(), ens.raw_margin(q))
    with pytest.raises(ValueError, match="query bins"):
        tb.raw_margin(q[:, :4])
