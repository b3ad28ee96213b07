"""The traversal baseline the paper compares against (§II-B, §V-B).

``TraversalBaseline`` is the GPU-style implementation of
``repro.core.baselines``: one logical thread per (sample, tree) walking D
dependent node fetches over a padded array-of-trees forest.  Here the
walk is torch ops on the device: a depth-long loop of ``gather``s over
every (tree, query) pair at once, then a float32 sum per class (no
tensor cores, so no TF32) — the JAX package's algorithm, not a tuned
GPU library.  It equals ``Ensemble.raw_margin`` exactly on dyadic
(k/16) leaves and within float32 reassociation otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.trees import Ensemble


class TraversalBaseline:
    """Padded array-of-trees traversal on ``device`` (``None``: the card)."""

    def __init__(self, ens: Ensemble, *, device=None) -> None:
        self.ens = ens
        self.device = resolve_device(device)
        T = ens.n_trees
        N = max(t.n_nodes for t in ens.trees)
        feat = np.full((T, N), -1, dtype=np.int32)
        thr = np.zeros((T, N), dtype=np.int32)
        left = np.zeros((T, N), dtype=np.int64)
        right = np.zeros((T, N), dtype=np.int64)
        val = np.zeros((T, N), dtype=np.float32)
        cls = np.zeros((T, N), dtype=np.int32)
        for i, t in enumerate(ens.trees):
            n = t.n_nodes
            feat[i, :n] = t.feature
            thr[i, :n] = t.threshold
            left[i, :n] = t.left
            right[i, :n] = t.right
            val[i, :n] = t.value
            if ens.leaf_class_mode == "leaf":
                cls[i, :n] = ens.leaf_class[i]
            else:
                cls[i, :n] = 0 if ens.tree_class is None else int(ens.tree_class[i])

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(self.device)

        self.feature = put(feat)
        self.threshold = put(thr)
        self.left = put(left)  # int64: gather indices
        self.right = put(right)
        self.value = put(val)
        self.leaf_cls = put(cls)
        self.depth = int(max(t.max_depth for t in ens.trees))
        self.n_outputs = ens.n_outputs
        self.n_features = int(ens.n_features)

    def raw_margin(self, q_bins) -> torch.Tensor:
        """(B, n_outputs) float32 margins on the device for ``(B, F)``
        binned queries (a numpy array, or a tensor on the device)."""
        q = (q_bins if isinstance(q_bins, torch.Tensor)
             else torch.from_numpy(np.asarray(q_bins)))
        if q.ndim != 2 or q.shape[1] != self.n_features:
            raise ValueError(f"expected (_, {self.n_features}) query bins, got {tuple(q.shape)}")
        q = q.to(device=self.device, dtype=torch.int32)
        T, B = self.feature.shape[0], q.shape[0]
        cols = torch.arange(B, device=self.device)[None, :]
        node = torch.zeros((T, B), dtype=torch.int64, device=self.device)
        for _ in range(self.depth):  # a leaf keeps its node: every walk ends by then
            f = self.feature.gather(1, node)
            go_left = q[cols, f.clamp(min=0).long()] < self.threshold.gather(1, node)
            nxt = torch.where(go_left, self.left.gather(1, node), self.right.gather(1, node))
            node = torch.where(f < 0, node, nxt)
        vals = self.value.gather(1, node)  # (T, B)
        cls = self.leaf_cls.gather(1, node)
        # one float32 sum over the trees per class: no matmul, so no TF32
        out = torch.stack(
            [torch.where(cls == c, vals, 0.0).sum(dim=0) for c in range(self.n_outputs)],
            dim=1,
        )
        out = out + torch.tensor(np.float32(self.ens.base_score), device=self.device)
        if self.ens.kind == "rf":
            out = out / torch.tensor(np.float32(max(1, self.ens.n_trees)), device=self.device)
        return out

    def predict(self, q_bins) -> np.ndarray:
        """Final predictions on the host — as ``Ensemble.predict``."""
        m = self.raw_margin(q_bins).cpu().numpy()
        if self.ens.task == "regression":
            return m[:, 0]
        if self.n_outputs == 1:  # single-logit binary: sign test
            return (m[:, 0] > 0.0).astype(np.int32)
        return np.argmax(m, axis=1).astype(np.int32)
