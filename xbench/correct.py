"""The comparison that decides ``correct``.

The program's margins for the rows kept from the window are held to the
plain reference (``xbench.reference.traverse``), run on the same device
after the program's state is freed. The number compared is ``margin_gap``:
the widest gap, over the kept rows and the output channels, between the
program's margin and the reference's float64 margin, as a share of the
sum of the magnitudes of that margin's terms (its leaves and the base
score). That is the scale on which a float32 sum's rounding lives, so
sound runs read near float32's unit round-off whatever the model's size,
while a wrong leaf, a dropped tree or leaves held in a lower precision
read well above it. Each cell's file states its limit, and ``PERF.md``
gives the readings it was set from.
"""

from __future__ import annotations

import numpy as np
import torch

from xbench.reference.traverse import margins

# a gap that is not finite (NaN or infinite margins) reads as this
NOT_FINITE = 1e30


def gap(prog: np.ndarray, ref: np.ndarray, mag: np.ndarray) -> float:
    if prog.shape != ref.shape:
        return NOT_FINITE
    g = np.abs(prog.astype(np.float64) - ref) / mag
    return float(g.max()) if np.isfinite(g).all() else NOT_FINITE


def judge(trees, answers, device, limits: dict) -> tuple[dict, int]:
    """``({"margin_gap": {"value", "limit"}}, rows checked)``."""
    if not answers:
        return {"margin_gap": {"value": NOT_FINITE, "limit": limits["margin_gap"]}}, 0
    rows = np.concatenate([np.asarray(r) for r, _ in answers])
    outs = [np.asarray(o, dtype=np.float64) for _, o in answers]
    if any(o.ndim != 2 or o.shape[0] != len(r) for (r, _), o in zip(answers, outs)):
        return {"margin_gap": {"value": NOT_FINITE, "limit": limits["margin_gap"]}}, 0
    prog = np.concatenate(outs)
    ref, mag = margins(trees, torch.from_numpy(np.ascontiguousarray(rows)).to(device))
    value = gap(prog, ref.cpu().numpy(), mag.cpu().numpy())
    return {"margin_gap": {"value": value, "limit": limits["margin_gap"]}}, int(rows.shape[0])
