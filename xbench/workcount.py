"""The work a tree ensemble's inference needs, from the ensemble's sizes.

The yardstick behind every ``*_roofline`` and ``*mfu*`` metric. It reads
the configuration (trees, depth, features, bins, outputs) and the batch,
and never the program's CAM table, cell list or kernel design, so a change
to the compiler, the table or the kernel leaves it where it was.

- Operations a row: each tree's root-to-leaf compares (``depth`` for the
  complete trees of these configurations) plus one leaf add.
- Bytes a launch: every internal node once (its feature id and its
  threshold, each in the fewest whole bytes that hold its range), every
  leaf value once (float32), the launch's query rows (a bin each) and its
  outputs (float32 a channel), each counted once.
- Peaks (``peaks.json``): operations against the card's highest published
  integer rate, so no formulation can read above 100%; bytes against its
  HBM bandwidth.
"""

from __future__ import annotations

import json
from pathlib import Path

from xbench.ensemble import n_outputs

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def whole_bytes(n_values: int) -> int:
    """Fewest of 1, 2, 4 or 8 bytes that hold ``n_values`` distinct values."""
    for b in (1, 2, 4, 8):
        if n_values <= 256**b:
            return b
    raise ValueError(f"{n_values} values do not fit in 8 bytes")


def ops_per_row(cfg: dict) -> int:
    return int(cfg["n_trees"]) * (int(cfg["depth"]) + 1)


def model_bytes(cfg: dict) -> int:
    t, depth = int(cfg["n_trees"]), int(cfg["depth"])
    node = whole_bytes(int(cfg["n_features"])) + whole_bytes(int(cfg["n_bins"]))
    return t * ((2**depth - 1) * node + 2**depth * 4)


def row_bytes(cfg: dict) -> int:
    return int(cfg["n_features"]) * whole_bytes(int(cfg["n_bins"])) + n_outputs(cfg) * 4


def peaks(kind: str) -> dict | None:
    """The card's published peaks by ``torch.cuda.get_device_name()``, or
    None for a card the table does not hold."""
    return json.loads(PEAKS.read_text())["cards"].get(kind)


def least_seconds(cfg: dict, rows: int, launches: int, peak: dict) -> float:
    """The least time the card could take for ``rows`` rows scored in
    ``launches`` launches: the larger of the operations over the peak rate
    and the bytes over the bandwidth."""
    ops = rows * ops_per_row(cfg)
    nbytes = launches * model_bytes(cfg) + rows * row_bytes(cfg)
    return max(ops / peak["ops_per_s"], nbytes / peak["bytes_per_s"])
