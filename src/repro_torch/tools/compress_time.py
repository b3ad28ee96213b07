"""Host seconds of the compression pass at the full width of xtime-tabular.

    python3 src/repro_torch/tools/compress_time.py [LEVEL ...]

Compiles the seeded xtime-tabular ensemble (4096 trees of depth 8, 130
features, 256 bins, 8 classes, seed 0: 1,048,576 CAM rows) and times
``compress_table`` at each level given (default ``prune merge full``),
without a grid, on the host.  Prints the host's CPU model, then per level
the rows and columns before and after and the seconds, and a JSON object
of them.  Needs a few GB of host memory; no card.
"""

from __future__ import annotations

import json
import os
import platform
import sys
import time
from pathlib import Path


def cpu_model() -> str:
    """The host's CPU model where /proc/cpuinfo names it, its architecture
    and its core count."""
    model = platform.processor() or "CPU model not named"
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                model = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    return f"{model}, {platform.machine()}, {os.cpu_count()} cores"


def main(argv: list[str]) -> int:
    # run as a file, sys.path[0] is this directory: put the checkout's src there
    sys.path[0] = str(Path(__file__).resolve().parents[2])
    from repro_torch.core.compile import compile_ensemble
    from repro_torch.core.compress import compress_table
    from repro_torch.core.trees import random_deep_ensemble

    levels = argv[1:] or ["prune", "merge", "full"]
    print(f"host: {cpu_model()}", flush=True)
    t0 = time.perf_counter()
    ens = random_deep_ensemble(n_trees=4096, depth=8, n_features=130, n_bins=256,
                               task="multiclass", n_classes=8, seed=0)
    table = compile_ensemble(ens)
    print(f"xtime-tabular compiled: {table.n_rows} rows x {table.n_cols} columns in "
          f"{time.perf_counter() - t0} s", flush=True)
    out = {}
    for level in levels:
        t0 = time.perf_counter()
        small, rep = compress_table(table, None, level=level)
        secs = time.perf_counter() - t0
        out[level] = {"seconds": secs, **rep.to_dict()}
        print(f"compress_table level={level}: {rep.rows_before} -> {rep.rows_after} rows, "
              f"{rep.cols_before} -> {rep.cols_after} columns, {rep.merged_rows} merged, "
              f"{secs} s on the host", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
