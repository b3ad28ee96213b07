"""The benchmark's own tree ensembles and query rows, made from ``--seed``.

A configuration states the model's sizes (trees, depth, features, bins,
task, classes, base score). The trees are complete binary trees in heap
order: internal node ``j`` of a tree tests ``x[feature[j]] < threshold[j]``
and goes to ``2j + 1`` when it holds, else to ``2j + 2``; the ``2**depth``
leaves follow the ``2**depth - 1`` internal nodes. Features are uniform
over the configuration's columns, thresholds uniform over ``[1, n_bins)``
(so both children of every node are reachable) and leaves uniform float32
in ``[-leaf_scale, leaf_scale)``. Tree ``t`` adds to output channel
``t % n_outputs``.

Everything is drawn on ``device`` by ``torch.Generator``s seeded from the
run's seed, in a few large calls, so one seed gives the same trees and
rows on every run on one kind of device. This module imports nothing of
the program: the reference traverses these arrays, and the harness hands
them to the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_SEED_MOD = 2**63
# separate generator streams, so the rows do not depend on the tree draws
STREAMS = {"trees": 1, "rows": 2, "requests": 3, "sample": 4}


def stream_seed(seed: int, stream: str) -> int:
    """The run's seed turned into the seed of one of its streams."""
    return (int(seed) * 1_000_003 + STREAMS[stream]) % _SEED_MOD


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def n_outputs(cfg: dict) -> int:
    return int(cfg["n_classes"]) if cfg["task"] == "multiclass" else 1


@dataclass(frozen=True)
class Trees:
    """One ensemble as device tensors (module docstring)."""

    feature: torch.Tensor  # (T, 2**depth - 1) int64
    threshold: torch.Tensor  # (T, 2**depth - 1) int64, in [1, n_bins)
    leaf: torch.Tensor  # (T, 2**depth) float32
    tree_class: torch.Tensor  # (T,) int64
    base_score: float
    depth: int
    n_outputs: int


def make_trees(cfg: dict, seed: int, device) -> Trees:
    if cfg.get("kind", "gbdt") != "gbdt":
        raise ValueError("only gradient-boosted (summing) ensembles are made here")
    t, depth = int(cfg["n_trees"]), int(cfg["depth"])
    inner, leaves = 2**depth - 1, 2**depth
    g = generator(seed, "trees", device)
    feature = torch.randint(0, int(cfg["n_features"]), (t, inner), generator=g, device=device)
    threshold = torch.randint(1, int(cfg["n_bins"]), (t, inner), generator=g, device=device)
    scale = float(cfg["leaf_scale"])
    leaf = (torch.rand((t, leaves), generator=g, device=device, dtype=torch.float32) * 2 - 1) * scale
    c = n_outputs(cfg)
    tree_class = torch.arange(t, device=device) % c
    return Trees(feature, threshold, leaf, tree_class, float(cfg["base_score"]), depth, c)


def make_rows(cfg: dict, seed: int, n: int, device, stream: str = "rows") -> torch.Tensor:
    """``(n, n_features)`` query bins, uniform over ``[0, n_bins)``, as uint8
    where the bins fit in a byte and int32 otherwise."""
    dtype = torch.uint8 if int(cfg["n_bins"]) <= 256 else torch.int32
    g = generator(seed, stream, device)
    return torch.randint(0, int(cfg["n_bins"]), (n, int(cfg["n_features"])), generator=g,
                         device=device, dtype=dtype)
