"""The port's analytic models (``core/perfmodel.py``) held to the JAX
package's: the chip model on built artifacts, and the kernel traffic,
Booster and GPU models on the same inputs give equal results.  The GPU
model describes the paper's baseline GPU from its published constants,
not a card the port runs on."""

import dataclasses

import pytest

import repro.api as japi
import repro.core.perfmodel as jpm
import repro_torch
import repro_torch.core.perfmodel as tpm
from repro.core.trees import random_deep_ensemble as j_random_deep_ensemble
from repro_torch.core.trees import random_deep_ensemble as t_random_deep_ensemble


def _artifacts(level: str):
    kw = dict(n_trees=12, depth=6, n_features=10, n_bins=256, task="multiclass",
              n_classes=3, p_dup=0.5, seed=7)
    return (japi.build(j_random_deep_ensemble(**kw), compress=level),
            repro_torch.build(t_random_deep_ensemble(**kw), compress=level))


@pytest.mark.parametrize("level", ["off", "full"])
def test_chip_and_booster_models_match(level):
    jcm, tcm = _artifacts(level)
    assert dataclasses.asdict(tcm.perf) == dataclasses.asdict(jcm.perf)
    for kw in ({}, {"node_cycles": 2}):
        j = jpm.booster_perf(jcm.table, jcm.placement, jcm.noc, depth=6, **kw)
        t = tpm.booster_perf(tcm.table, tcm.placement, tcm.noc, depth=6, **kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("dtype", ["int32", "uint16", "uint8"])
def test_kernel_traffic_model_matches(dtype):
    kw = dict(batch=256, rows=16384, features=130, channels=8, table_dtype=dtype,
              tile_skip_fraction=0.4, rows_saved=1000, cols_saved=3)
    assert tpm.kernel_traffic_model(**kw) == jpm.kernel_traffic_model(**kw)


@pytest.mark.parametrize("batch", [None, 1, 1024, 100000])
def test_gpu_model_matches(batch):
    assert dataclasses.asdict(tpm.GPUSpec()) == dataclasses.asdict(jpm.GPUSpec())
    kw = dict(n_trees=4096, depth=8, batch=batch)
    t, j = tpm.gpu_perf_model(**kw), jpm.gpu_perf_model(**kw)
    assert type(t) is tpm.PerfReport and dataclasses.asdict(t) == dataclasses.asdict(j)
