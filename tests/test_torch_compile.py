"""The port's ``compile_ensemble`` against the JAX package's, on the CPU.

The port writes each leaf's box by bounding the row range of every split
a depth at a time; the reference copies a box at every node.  Both must
give the same table bit for bit — bounds, leaves, tree and class ids, in
the same row order (rows clustered by wildcards, and without) — on
seeded random ensembles of every task and on the golden dumps (gradient
boosted and random forests, unbalanced trees, per-leaf classes), lowered
by each package's own ingest.
"""

from pathlib import Path

import numpy as np
import pytest

import repro.ingest as jin
import repro_torch.ingest as tin
from repro.core.compile import compile_ensemble as j_compile
from repro.core.trees import random_deep_ensemble as j_random
from repro_torch.core.compile import compile_ensemble as t_compile
from repro_torch.core.trees import random_deep_ensemble as t_random

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "ingest"
FIELDS = ("low", "high", "leaf", "tree_id", "class_id")


def _assert_same_table(j, t) -> None:
    for name in FIELDS:
        a, b = np.asarray(getattr(j, name)), getattr(t, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (j.n_trees, j.n_features, j.n_bins, j.n_outputs, j.table_dtype) == (
        t.n_trees, t.n_features, t.n_bins, t.n_outputs, t.table_dtype)


RANDOM = {  # name: random_deep_ensemble's arguments
    "multiclass": dict(n_trees=12, depth=5, n_features=40, n_bins=256, task="multiclass",
                       n_classes=4, seed=3),
    "binary-wide": dict(n_trees=6, depth=7, n_features=300, n_bins=256, task="binary", seed=4),
    "regression-64-bins": dict(n_trees=9, depth=3, n_features=5, n_bins=64,
                               task="regression", seed=5),
}


@pytest.mark.parametrize("order_rows", [True, False], ids=["clustered", "traversal-order"])
@pytest.mark.parametrize("case", list(RANDOM))
def test_random_ensembles_compile_alike(case, order_rows):
    kw = RANDOM[case]
    _assert_same_table(j_compile(j_random(**kw), order_rows=order_rows),
                       t_compile(t_random(**kw), order_rows=order_rows))


@pytest.mark.parametrize("dump", sorted(p.name for p in FIXTURES.iterdir()
                                        if p.suffix in (".json", ".txt")
                                        and not p.name.endswith(".expected.json")))
def test_golden_dumps_compile_alike(dump):
    jens, _, _ = jin.lower_to_ensemble(jin.load_model(FIXTURES / dump))
    tens, _, _ = tin.lower_to_ensemble(tin.load_model(FIXTURES / dump))
    _assert_same_table(j_compile(jens), t_compile(tens))
