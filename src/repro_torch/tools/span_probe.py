"""What the port's spans cost, and where they fall on the device trace.

    python3 src/repro_torch/tools/span_probe.py [--calls 8] [--out DIR] [--cost-only]

Prints the host's CPU, then the cost of one span (``repro_torch.spans``)
in ns with no profiler and under ``torch.profiler`` (host and, with a
card, CUDA activity), each beside a ``with`` of the null context and an
empty call (the loop's own cost, included in every figure).
With a card (unless ``--cost-only``), builds a random model of
xtime-tabular's size (4,096 trees of depth 8, 130 features, 256 bins, 8
classes), binds it to the card, and runs ``--calls`` ``raw_margin`` calls
of 1,024 rows under the profiler: it writes the chrome trace under
``--out`` and prints, for each call, the offsets in µs from the start of
its ``repro_torch.api.raw_margin`` range to its child ranges and to the
start of its CAM kernel on the card, and whether each kernel starts after
its ``repro_torch.engine.launch`` range opens.  Nothing runs at import.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

CAM = "cam_match"
PREFIX = "repro_torch."  # repro_torch.spans.PREFIX


def ns_per(fn, n: int) -> float:
    t0 = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t0) / n


def span_cost(n: int = 200_000) -> dict:
    """ns a span with the profiler off and on, beside a null ``with`` and an empty call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import spans

    def empty():
        pass

    def null():
        with spans._NULL:
            pass

    def one():
        with spans.span("probe"):
            pass

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    out = {"off_ns": ns_per(one, n), "null_ns": ns_per(null, n), "empty_ns": ns_per(empty, n)}
    with profile(activities=acts):
        out["on_ns"] = ns_per(one, n // 4)
        out["on_null_ns"] = ns_per(null, n // 4)
        out["on_empty_ns"] = ns_per(empty, n // 4)
    return out


def timeline(calls: int, out_dir: Path) -> list[dict]:
    """One profiled window of ``calls`` raw_margin calls on the card; per
    call the child ranges' and the CAM kernel's offsets from the call's start."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from repro_torch import spans
    from repro_torch.core.trees import random_deep_ensemble

    ens = random_deep_ensemble(n_trees=4096, depth=8, n_features=130, n_bins=256,
                               task="multiclass", n_classes=8, p_dup=0.0, seed=0)
    cm = repro_torch.build(ens)
    q = np.random.default_rng(0).integers(0, 256, size=(1024, 130)).astype(np.int32)
    for _ in range(3):
        cm.raw_margin(q)
    torch.cuda.synchronize()
    with spans.span("probe"):  # found off: the window below starts afresh
        pass
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            cm.raw_margin(q)
        torch.cuda.synchronize()
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "span_probe.trace.json"
    prof.export_chrome_trace(str(path))
    return calls_in(json.loads(path.read_text())["traceEvents"])


def calls_in(events: list[dict]) -> list[dict]:
    """Per ``api.raw_margin`` range of a chrome trace: its duration, its
    children's and its CAM kernel's offsets from its start (µs), the kernel
    found through the correlation id of the launch inside the call."""
    ev = [e for e in events if e.get("ph") == "X"]
    launches = {e["args"].get("correlation"): e for e in ev
                if e.get("cat") == "cuda_runtime" and e["name"] == "cudaLaunchKernel"}
    kernels = [e for e in ev if e.get("cat") == "kernel" and CAM in e["name"]]

    def inside(e, c):
        return c["ts"] <= e["ts"] <= c["ts"] + c["dur"]

    rows = []
    for c in sorted((e for e in ev if e["name"] == PREFIX + "api.raw_margin"),
                    key=lambda e: e["ts"]):
        kids = {k: next(e for e in ev if e["name"] == PREFIX + k and inside(e, c))
                for k in ("engine.prep", "engine.launch", "api.fetch")}
        row = {"call": c["dur"], **{k: e["ts"] - c["ts"] for k, e in kids.items()}}
        ks = [k for k in kernels if k["args"].get("correlation") in launches
              and inside(launches[k["args"]["correlation"]], c)]
        if ks:  # the profiler may miss the first call's kernel
            row["kernel"] = ks[0]["ts"] - c["ts"]
            row["kernel_us"] = ks[0]["dur"]
            row["after_launch"] = ks[0]["ts"] > kids["engine.launch"]["ts"]
        rows.append(row)
    return rows


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=8)
    ap.add_argument("--out", type=Path, default=Path("chiprun_out"))
    ap.add_argument("--cost-only", action="store_true")
    args = ap.parse_args(argv)
    sys.path[0] = str(Path(__file__).resolve().parents[2])  # the checkout's src
    import torch

    from repro_torch.tools.compress_time import cpu_model

    print("host:", cpu_model())
    print("torch:", torch.__version__, "card:",
          torch.cuda.get_device_name(0) if torch.cuda.is_available() else "none")
    print("span cost:", json.dumps({k: round(v, 1) for k, v in span_cost().items()}))
    if args.cost_only or not torch.cuda.is_available():
        return 0
    rows = timeline(args.calls, args.out)
    for i, r in enumerate(rows):
        print(f"call {i}: " + ", ".join(f"{k} {v:.1f} us" if isinstance(v, float) else f"{k} {v}"
                                         for k, v in r.items()))
    found = [r["after_launch"] for r in rows if "after_launch" in r]
    print(f"kernels found for {len(found)} of {len(rows)} calls; each after its launch "
          f"range opens: {all(found)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
