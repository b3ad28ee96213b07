"""The open-loop cells' knee: one sweep of fixed rates on the card.

    python3 xbench/sweep.py --cell f968.serve --seed 5 --seconds 8 --rates 4000 6000 8000

Sets the cell up once, then runs its window at each rate in turn and prints
one JSON line a rate: requests and rows a second offered, the requests
shed, the requests still open when the last one was sent, the seconds
until the last one was answered, the p50/p99 from the due time, and how
late the sender ran. The knee is the highest rate at which nothing is
shed and the backlog at the window's end stays as small as at the low
rates; the cell's rate is fixed at four fifths of it (``PERF.md``).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from xbench import harness  # noqa: E402
from xbench.trace import Tracer  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the knee of an open-loop cell")
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    import repro_torch
    from repro_torch.core.deploy import DeployConfig

    cell = harness.load_cell(args.cell)
    cfg = harness.load_config(cell["config"])
    dev = torch.device("cuda:0")
    ctx = harness.Context(cell=cell, cfg=cfg, seed=args.seed, device=dev)
    trees = harness.make_trees(cfg, args.seed, dev)
    ctx.cm = repro_torch.build(harness.port_ensemble(trees, cfg),
                               deploy=DeployConfig(mode=cfg["mode"]))
    driver = harness.driver_class(cell["traffic"]["kind"])(ctx)
    driver.bind()
    driver.prepare()
    print(json.dumps({"setup_s": time.perf_counter() - T_START}), flush=True)
    try:
        for rate in args.rates:
            driver.server.reset_stats()
            gc.collect()
            w = driver.window(args.seconds, Tracer(False), rate=rate)
            c = w["counters"]
            print(json.dumps({"rate_per_s": rate, "rows_per_s": c["rows"] / args.seconds,
                              "failed": w["failed"], "shed": c["shed"], **driver.last,
                              **w["e2e"], "server_p99_ms": c["server_p99_ms"],
                              "rows_per_flush": c["server_rows"] / max(1, c["server_flushes"]),
                              "late_p50_ms": c["late_p50_ms"], "late_p99_ms": c["late_p99_ms"]}),
                  flush=True)
            driver.kept.clear()
            if w["failed"] or driver.last["drain_s"] > 1.0:
                break  # past the knee: what follows would only queue behind it
    finally:
        driver.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
