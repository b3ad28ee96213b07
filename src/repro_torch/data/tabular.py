"""Synthetic tabular datasets shaped like the paper's benchmark (Table II).

The Kaggle/UCI datasets used by the paper are not downloadable in this
offline container, so we generate synthetic analogs with matched
(n_samples, N_feat, N_classes, task).  The generator builds a ground truth
that is *piecewise axis-aligned* (a random shallow tree ensemble plus
feature interactions and label noise), i.e. exactly the function class
tree models excel at — so accuracy deltas between FP / 8-bit / 4-bit /
RF-only reproduce the paper's qualitative Fig. 9 claims.

A copy of ``repro.data.tabular``: the port imports nothing of ``repro``,
and both packages must make the same arrays from a name and a seed.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np


@dataclass
class TabularDataset:
    name: str
    task: str  # regression | binary | multiclass
    x_train: np.ndarray
    y_train: np.ndarray
    x_valid: np.ndarray
    y_valid: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    n_classes: int

    @property
    def n_features(self) -> int:
        return int(self.x_train.shape[1])


# name -> (task, n_samples, n_feat, n_classes)  [Table II]
PAPER_DATASETS: dict[str, tuple[str, int, int, int]] = {
    "churn": ("binary", 10000, 10, 2),
    "eye": ("multiclass", 10936, 26, 3),
    "forest": ("multiclass", 20000, 54, 7),  # subsampled from 581k for CPU budget
    "gas": ("multiclass", 13910, 129, 6),
    "gesture": ("multiclass", 9873, 32, 5),
    "telco": ("binary", 7032, 19, 2),
    "rossmann": ("regression", 20000, 29, 1),  # subsampled from 610k
}


def _random_tree_logits(
    x: np.ndarray, n_trees: int, depth: int, n_out: int, rng: np.random.Generator
) -> np.ndarray:
    """Ground-truth generator: sum of random axis-aligned decision trees."""
    n, F = x.shape
    out = np.zeros((n, n_out))
    for _ in range(n_trees):
        # a random balanced tree of the given depth: route by thresholds
        leaf = np.zeros(n, dtype=np.int64)
        for d in range(depth):
            f = int(rng.integers(0, F))
            thr = rng.uniform(np.quantile(x[:, f], 0.2), np.quantile(x[:, f], 0.8))
            leaf = leaf * 2 + (x[:, f] >= thr)
        leaf_vals = rng.normal(size=(2**depth, n_out))
        out += leaf_vals[leaf]
    return out / np.sqrt(n_trees)


def make_dataset(name: str, seed: int = 0) -> TabularDataset:
    if name not in PAPER_DATASETS:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(PAPER_DATASETS)}")
    task, n, n_feat, n_classes = PAPER_DATASETS[name]
    # zlib.crc32, NOT hash(): python string hashing is per-process salted,
    # which silently made every dataset (and borderline accuracy tests)
    # differ between runs.
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 2**31)

    # features: mixture of continuous (correlated gaussians), heavy-tailed,
    # and low-cardinality integer-coded categoricals — typical tabular mix.
    n_cat = max(1, n_feat // 5)
    n_cont = n_feat - n_cat
    A = rng.normal(size=(n_cont, n_cont)) / np.sqrt(n_cont)
    x_cont = rng.normal(size=(n, n_cont)) @ (np.eye(n_cont) + 0.3 * A)
    heavy = rng.integers(0, n_cont, size=max(1, n_cont // 4))
    x_cont[:, heavy] = np.sign(x_cont[:, heavy]) * np.abs(x_cont[:, heavy]) ** 1.7
    x_cat = rng.integers(0, 8, size=(n, n_cat)).astype(np.float64)
    x = np.concatenate([x_cont, x_cat], axis=1)

    n_out = n_classes if task == "multiclass" else 1
    logits = _random_tree_logits(x, n_trees=24, depth=5, n_out=n_out, rng=rng)
    # mild smooth interaction term so the problem is not *exactly* a tree
    w = rng.normal(size=(n_feat, n_out)) / np.sqrt(n_feat)
    logits = logits + 0.25 * np.tanh(x @ w)

    if task == "regression":
        y = logits[:, 0] + 0.1 * rng.normal(size=n)
        y = (y - y.mean()) / (y.std() + 1e-9)
    elif task == "binary":
        p = 1 / (1 + np.exp(-2.0 * logits[:, 0]))
        y = (rng.uniform(size=n) < p).astype(np.int64)
    else:
        g = 2.0 * logits + rng.gumbel(size=(n, n_out)) * 0.25
        y = np.argmax(g, axis=1).astype(np.int64)

    # 70/15/15 split, same protocol as the paper's pipeline (§IV-A)
    perm = rng.permutation(n)
    i1, i2 = int(0.7 * n), int(0.85 * n)
    tr, va, te = perm[:i1], perm[i1:i2], perm[i2:]
    return TabularDataset(
        name=name,
        task=task,
        x_train=x[tr].astype(np.float32),
        y_train=y[tr],
        x_valid=x[va].astype(np.float32),
        y_valid=y[va],
        x_test=x[te].astype(np.float32),
        y_test=y[te],
        n_classes=n_classes,
    )


def accuracy_metric(task: str, y_true: np.ndarray, pred: np.ndarray) -> float:
    """The paper's per-task metric: accuracy, or R^2-style score for regression."""
    if task == "regression":
        ss_res = float(np.sum((y_true - pred) ** 2))
        ss_tot = float(np.sum((y_true - y_true.mean()) ** 2)) + 1e-12
        return 1.0 - ss_res / ss_tot
    return float(np.mean(y_true == pred))
