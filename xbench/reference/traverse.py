"""The plain reference: a root-to-leaf traversal of the benchmark's trees.

Plain PyTorch, over the arrays of ``xbench.ensemble.Trees`` and the query
rows the benchmark made itself. It imports nothing of the program and
takes nothing the program built (no CAM table, no cell list, no engine),
so it also stands as the check on the program's compiler.

``margins`` sums each row's leaves per output channel in float64 and adds
the base score; it also returns the sum of the magnitudes of the terms,
the scale against which a float32 sum's rounding is judged.
``leaf_dtype``/``acc_dtype`` let the control run the same traversal with
its leaves and sums held in a lower precision.
"""

from __future__ import annotations

import torch


def margins(trees, rows: torch.Tensor, *, leaf_dtype=torch.float64,
            acc_dtype=torch.float64, block_rows: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """``(N, n_outputs)`` margins and ``(N, n_outputs)`` magnitude sums, both
    float64 on ``rows``' device, in blocks of ``block_rows`` rows."""
    dev = rows.device
    feature = trees.feature.to(dev)
    threshold = trees.threshold.to(dev)
    leaf = trees.leaf.to(dev).to(leaf_dtype).to(acc_dtype)
    cls = trees.tree_class.to(dev)
    inner = feature.shape[1]
    out, mag = [], []
    for start in range(0, rows.shape[0], block_rows):
        xt = rows[start:start + block_rows].to(torch.int64).T  # (F, n)
        n = xt.shape[1]
        node = torch.zeros((feature.shape[0], n), dtype=torch.int64, device=dev)
        col = torch.arange(n, device=dev).expand_as(node)
        for _ in range(trees.depth):
            f = torch.gather(feature, 1, node)
            thr = torch.gather(threshold, 1, node)
            node = 2 * node + 1 + (xt[f, col] >= thr).to(torch.int64)
        val = torch.gather(leaf, 1, node - inner)  # (T, n)
        m = torch.zeros((trees.n_outputs, n), dtype=acc_dtype, device=dev)
        m.index_add_(0, cls, val)
        a = torch.zeros((trees.n_outputs, n), dtype=torch.float64, device=dev)
        a.index_add_(0, cls, val.abs().to(torch.float64))
        out.append(m.to(torch.float64).T + trees.base_score)
        mag.append(a.T + abs(trees.base_score))
    return torch.cat(out), torch.cat(mag)
