"""Measure a cell's spread on the card: two sets of runs on the same seeds.

    python3 xbench/sets.py --cell f130.bulk --seeds 11 12 13 14 15 16 \
        --traced 21 22 23 --extra 31 32 33 --out chiprun_out/f130.bulk.jsonl

Runs ``xbench/run.py`` once a seed for set 1, then again for set 2 on the
same seeds, then the traced runs and the extra seeds, one process after
another, at the benchmark's ``run_seconds``; appends every result line to
``--out`` and prints, a metric at a time, each set's median and spread
(the distance between the first and third quartiles by
``statistics.quantiles(values, n=4)``, as a share of the median) and the
widest spread, which is what a bound is set from.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def one(cell: str, seed: int, seconds: int, trace: int) -> dict:
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(ROOT / "xbench" / "run.py"), "--workload", cell,
                          "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                         capture_output=True, text=True, cwd=ROOT)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        return {"seed": seed, "trace": trace, "rc": out.returncode, "wall_s": wall,
                "stderr": out.stderr[-3000:]}
    return {"seed": seed, "trace": trace, "rc": 0, "wall_s": wall,
            **json.loads(out.stdout.strip().splitlines()[-1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="two sets of runs of one cell, and their spread")
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--traced", type=int, nargs="*", default=[])
    ap.add_argument("--extra", type=int, nargs="*", default=[])
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    seconds = json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    sets: list[list[dict]] = []
    plan = [(k, s, 0) for k in range(args.sets) for s in args.seeds]
    plan += [(None, s, 1) for s in args.traced] + [(None, s, 0) for s in args.extra]
    for k, seed, trace in plan:
        r = one(args.cell, seed, seconds, trace)
        r["set"] = k
        with out.open("a") as f:
            f.write(json.dumps(r) + "\n")
        brief = {m: v["value"] for m, v in r.get("metrics", {}).items()}
        print(json.dumps({"set": k, "seed": seed, "trace": trace, "rc": r["rc"],
                          "correct": r.get("correct"), "wall_s": round(r["wall_s"], 1),
                          "gap": r.get("checked", {}).get("margin_gap", {}).get("value"),
                          **brief}), flush=True)
        if k is not None:
            while len(sets) <= k:
                sets.append([])
            sets[k].append(r)
    names = sorted({m for s in sets for r in s for m in r.get("metrics", {})})
    for m in names:
        rows = []
        for s in sets:
            vals = [r["metrics"][m]["value"] for r in s if m in r.get("metrics", {})]
            if len(vals) >= 2:
                rows.append({"median": statistics.median(vals), "spread": spread(vals),
                             "values": vals})
        if rows:
            print(json.dumps({"metric": m, "sets": rows,
                              "widest": max(r["spread"] for r in rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
