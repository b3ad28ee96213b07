"""The reference traversal against margins worked out by hand, and the
seeded inputs' determinism."""

import numpy as np
import torch

from xbench import correct, ensemble
from xbench.ensemble import Trees
from xbench.reference.traverse import margins

# two depth-2 trees in heap order (node j -> 2j+1 if x[f] < t else 2j+2),
# tree 0 adding to channel 0, tree 1 to channel 1, base score 0.5
HAND = Trees(
    feature=torch.tensor([[0, 1, 2], [2, 0, 1]]),
    threshold=torch.tensor([[5, 3, 7], [4, 2, 9]]),
    leaf=torch.tensor([[1.0, 2.0, 3.0, 4.0], [0.5, -0.5, 0.25, -0.25]]),
    tree_class=torch.tensor([0, 1]),
    base_score=0.5, depth=2, n_outputs=2,
)


def test_hand_margins():
    rows = torch.tensor([[4, 3, 8], [6, 0, 1], [0, 0, 0]], dtype=torch.uint8)
    m, mag = margins(HAND, rows, block_rows=2)
    # [4,3,8]: tree 0 left (4 < 5), right (3 >= 3) -> leaf 1 = 2.0;
    #          tree 1 right (8 >= 4), left (3 < 9) -> leaf 2 = 0.25
    # [6,0,1]: tree 0 right, left (1 < 7) -> leaf 2 = 3.0;
    #          tree 1 left (1 < 4), right (6 >= 2) -> leaf 1 = -0.5
    # [0,0,0]: tree 0 left, left -> 1.0; tree 1 left, left -> 0.5
    assert m.dtype == torch.float64
    np.testing.assert_array_equal(m.numpy(), [[2.5, 0.75], [3.5, 0.0], [1.5, 1.0]])
    np.testing.assert_array_equal(mag.numpy(), [[2.5, 0.75], [3.5, 1.0], [1.5, 1.0]])


def test_control_precision_rounds_the_leaves():
    trees = Trees(HAND.feature, HAND.threshold, HAND.leaf + 1e-3, HAND.tree_class, 0.0, 2, 2)
    rows = torch.tensor([[4, 3, 8]], dtype=torch.uint8)
    exact, mag = margins(trees, rows)
    low, _ = margins(trees, rows, leaf_dtype=torch.bfloat16, acc_dtype=torch.float32)
    g = correct.gap(low.numpy(), exact.numpy(), mag.numpy())
    assert 1e-4 < g < 2**-8  # bfloat16 keeps 8 bits of the leaf


def test_gap_reads_shape_and_nan_as_failure():
    ref, mag = np.ones((2, 1)), np.ones((2, 1))
    assert correct.gap(np.ones((2, 1)), ref, mag) == 0.0
    assert correct.gap(np.ones((2, 2)), ref, mag) == correct.NOT_FINITE
    assert correct.gap(np.array([[np.nan], [1.0]]), ref, mag) == correct.NOT_FINITE


def test_seeded_inputs_repeat():
    cfg = {"n_trees": 5, "depth": 3, "n_features": 7, "n_bins": 256, "task": "multiclass",
           "n_classes": 3, "leaf_scale": 0.1, "base_score": 0.0}
    a, b = ensemble.make_trees(cfg, 2**31 + 5, "cpu"), ensemble.make_trees(cfg, 2**31 + 5, "cpu")
    c = ensemble.make_trees(cfg, 2**31 + 6, "cpu")
    assert torch.equal(a.leaf, b.leaf) and torch.equal(a.feature, b.feature)
    assert not torch.equal(a.leaf, c.leaf)
    assert int(a.threshold.min()) >= 1 and int(a.threshold.max()) <= 255
    assert a.tree_class.tolist() == [0, 1, 2, 0, 1]
    r = ensemble.make_rows(cfg, 2**31 + 5, 16, "cpu")
    assert r.dtype == torch.uint8 and r.shape == (16, 7)
    assert torch.equal(r, ensemble.make_rows(cfg, 2**31 + 5, 16, "cpu"))


def test_schedule_same_work_every_seed():
    from xbench.traffic.arrivals import schedule

    a = schedule(1, rate_per_s=500, seconds=2, mean_rows=32, max_rows=1024, pool_rows=1000)
    b = schedule(2, rate_per_s=500, seconds=2, mean_rows=32, max_rows=1024, pool_rows=1000)
    assert a.t.size == b.t.size and a.sizes.sum() == b.sizes.sum()
    assert not np.array_equal(a.sizes, b.sizes)
    assert a.t[-1] < 2 and np.all(np.diff(a.t) >= 0) and np.all(a.starts < 1000)
    assert 800 < a.t.size < 1200 and 20 < a.sizes.mean() < 45
    lomax = schedule(1, rate_per_s=500, seconds=2, arrivals="lomax", mean_rows=1.3, max_rows=8)
    assert lomax.sizes.max() <= 8 and lomax.t[-1] < 2
