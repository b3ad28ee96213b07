"""The benchmark's command: one run of one cell.

    python3 xbench/run.py --workload f130.bulk --seed 7 --seconds 20 --trace 0

Prints the result as one JSON object, the last line of standard output,
and the numbers compared, each beside its limit, as the last lines of
standard error. Exits with another code than 0, and prints no result,
where there is no CUDA card (or fewer than the cell asks for), where the
program is not in the checkout, or where JAX or the JAX package was
loaded by the time the window closed.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here, before any import

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the program or torch may write stays inside the checkout, at
# fixed paths (the kernels' nvcc build is under build/repro_torch already)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(ROOT / "build" / "xbench" / sub)
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from xbench import harness

    cell = harness.load_cell(args.workload)
    chips = next((int(w["chips"]) for w in harness.load_benchmark()["workloads"]
                  if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"xbench: {args.workload} needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         device="cuda:0", t_start=T_START, cell=cell)
    found = harness.forbidden_modules()
    if found:
        print(f"xbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, v in result["checked"].items():
        print(f"checked {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
