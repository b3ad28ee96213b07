"""Hyperparameter search under X-TIME hardware constraints (§IV-A), and
the kernel-version naming of the autotuner.

A copy of the search half of ``repro.core.tune`` (the port imports nothing
of ``repro``): the paper optimizes every model/dataset pair subject to the
chip constraints (N_trees <= 4096, N_leaves,max <= 256, 8-bit thresholds)
and picks the best configuration on held-out data; ``random_search`` does
that with seeded random search over the same space, on the host in numpy,
and gives the same trials and winner as the JAX package from the same seed.

Of the execution autotuner only ``kernel_version`` is ported: serving and
scoring reports name the kernel a binding runs.  ``autotune_kernel`` and
``TunePlan`` are a later slice (ROADMAP.md); until then an artifact's
``tuning`` is carried through save/load and applied nowhere.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.quantize import FeatureQuantizer
from repro_torch.core.trees import Ensemble, GBDTParams, RFParams, train_gbdt, train_rf
from repro_torch.data.tabular import TabularDataset, accuracy_metric


def kernel_version(table_dtype: str) -> str:
    """Kernel generation a resolved table dtype binds: the v1 int32
    exclusive-high layout, the v2 packed inclusive-high layout
    (uint8/uint16), or the float32 soft-encoded layout ('soft')."""
    if table_dtype == "int32":
        return "v1"
    return "soft" if np.dtype(table_dtype).kind == "f" else "v2"


@dataclass
class HWConstraints:
    """§V-A 'X-TIME 8bit' envelope."""

    max_trees: int = 4096
    max_leaves: int = 256
    n_bins: int = 256


@dataclass
class Trial:
    params: dict
    valid_score: float
    n_trees: int
    max_leaves: int


@dataclass
class SearchResult:
    best: Trial
    trials: list[Trial] = field(default_factory=list)
    ensemble: Ensemble | None = None
    quantizer: FeatureQuantizer | None = None

    @property
    def test_ready(self) -> bool:
        return self.ensemble is not None


def _sample_gbdt(rng: np.random.Generator, hw: HWConstraints, n_classes: int) -> dict:
    leaves = int(rng.choice([16, 32, 64, 128, hw.max_leaves]))
    # rounds bounded so total trees respect the chip (multiclass: x classes)
    max_rounds = max(8, hw.max_trees // max(1, n_classes))
    return {
        "n_rounds": int(rng.integers(10, min(120, max_rounds))),
        "learning_rate": float(10 ** rng.uniform(-1.5, -0.4)),
        "max_leaves": leaves,
        "max_depth": int(rng.integers(4, 11)),
        "subsample": float(rng.uniform(0.6, 1.0)),
        "colsample": float(rng.uniform(0.5, 1.0)),
        "reg_lambda": float(10 ** rng.uniform(-1, 1)),
    }


def _sample_rf(rng: np.random.Generator, hw: HWConstraints) -> dict:
    return {
        "n_trees": int(rng.integers(20, min(200, hw.max_trees))),
        "max_leaves": int(rng.choice([32, 64, 128, hw.max_leaves])),
        "max_depth": int(rng.integers(6, 14)),
        "colsample": float(rng.uniform(0.3, 0.9)),
    }


def random_search(
    ds: TabularDataset,
    *,
    kind: str = "gbdt",
    n_trials: int = 20,
    hw: HWConstraints | None = None,
    seed: int = 0,
) -> SearchResult:
    """Seeded random search; scores on the VALIDATION split; refits the
    winner and returns it ready for CAM compilation."""
    hw = hw or HWConstraints()
    rng = np.random.default_rng(seed)
    quant = FeatureQuantizer.fit(ds.x_train, hw.n_bins)
    xb_tr = quant.transform(ds.x_train)
    xb_va = quant.transform(ds.x_valid)

    trials: list[Trial] = []
    best: Trial | None = None
    best_ens: Ensemble | None = None
    for t in range(n_trials):
        if kind == "gbdt":
            p = _sample_gbdt(rng, hw, ds.n_classes)
            ens = train_gbdt(
                xb_tr, ds.y_train, task=ds.task, n_bins=hw.n_bins,
                n_classes=ds.n_classes, params=GBDTParams(seed=seed + t, **p),
            )
        else:
            p = _sample_rf(rng, hw)
            ens = train_rf(
                xb_tr, ds.y_train, task=ds.task, n_bins=hw.n_bins,
                n_classes=ds.n_classes, params=RFParams(seed=seed + t, **p),
            )
        assert ens.n_trees <= hw.max_trees and ens.max_leaves <= hw.max_leaves
        score = accuracy_metric(ds.task, ds.y_valid, ens.predict(xb_va))
        trial = Trial(params=p, valid_score=score, n_trees=ens.n_trees,
                      max_leaves=ens.max_leaves)
        trials.append(trial)
        if best is None or score > best.valid_score:
            best, best_ens = trial, ens
    return SearchResult(best=best, trials=trials, ensemble=best_ens,
                        quantizer=quant)

