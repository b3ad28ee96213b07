"""Readings behind the ``margin_gap`` limits: the control, on the card.

    python3 xbench/control.py --cell f130.bulk --seeds 11 12 13 --rows 8192

The control is the plain reference put in the program's place with its
leaves held in bfloat16 (the precision below the configuration's float32;
its sums stay float32), on the cell's own model and rows of the cell's own
kind, drawn from each seed. It prints one JSON line a seed with the
control's ``margin_gap``. The program's own readings are the
``margin_gap`` that each run of ``xbench/run.py`` prints; ``PERF.md`` sets
each limit between the two.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from xbench import correct, harness  # noqa: E402
from xbench.ensemble import make_rows, make_trees  # noqa: E402
from xbench.reference.traverse import margins  # noqa: E402


def control_gap(cfg: dict, seed: int, n_rows: int, device) -> float:
    trees = make_trees(cfg, seed, device)
    rows = make_rows(cfg, seed, n_rows, device)
    ref, mag = margins(trees, rows)
    ctl, _ = margins(trees, rows, leaf_dtype=torch.bfloat16, acc_dtype=torch.float32)
    return correct.gap(ctl.cpu().numpy(), ref.cpu().numpy(), mag.cpu().numpy())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the control's margin_gap on a cell's model")
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rows", type=int, default=8192)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.cell)
    cfg = harness.load_config(cell["config"])
    for seed in args.seeds:
        g = control_gap(cfg, seed, args.rows, torch.device(args.device))
        print(json.dumps({"cell": args.cell, "seed": seed, "rows": args.rows,
                          "control_margin_gap": g, "limit": cell["limits"]["margin_gap"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
