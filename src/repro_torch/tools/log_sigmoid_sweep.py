"""Every float32 x with |x| <= 104 through the soft kernel's log-sigmoid
mirror (``kernels.ref.log_sigmoid_f32``), against float64.

    python3 src/repro_torch/tools/log_sigmoid_sweep.py [--ex2-ulps N]

Prints the largest relative error in units of u = 2^-24 of |log_sigmoid(x)|
where that is at least 2^-126 (with the x that gives it), the largest
absolute error below, and whether any result is NaN.  ``--ex2-ulps`` moves
every ex2 result by that many ulps, both signs, as far as the card's
ex2.approx may be from the correctly rounded one.  CPU only: about
2.1e9 inputs, a few minutes, a few hundred MB a chunk.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from repro_torch.kernels.ref import log_sigmoid_f32  # noqa: E402

U = 2.0 ** -24
TINY = 2.0 ** -126
LIMIT = np.float32(104.0)
CHUNK = 1 << 22  # inputs a pass


def sweep(ex2_ulps: float) -> tuple[float, float, float, bool]:
    """(worst relative error in u, its x, worst absolute error where
    |log_sigmoid| < 2^-126, any NaN) over every float32 in [-104, 104]."""
    top = int(LIMIT.view(np.uint32))  # bit patterns 0 .. top are +0 .. 104
    worst, worst_x, worst_abs, nan = 0.0, 0.0, 0.0, False
    for lo in range(0, top + 1, CHUNK):
        pos = np.arange(lo, min(top + 1, lo + CHUNK), dtype=np.uint32).view(np.float32)
        for x in (pos, -pos):
            x64 = x.astype(np.float64)
            want = np.minimum(x64, 0.0) - np.log1p(np.exp(-np.abs(x64)))
            for ulps in {ex2_ulps, -ex2_ulps}:
                got = log_sigmoid_f32(x, ulps).astype(np.float64)
                nan |= bool(np.isnan(got).any())
                err = np.abs(got - want)
                big = np.abs(want) >= TINY
                rel = np.where(big, err / np.where(big, np.abs(want), 1.0), 0.0) / U
                i = int(np.argmax(rel))
                if rel[i] > worst:
                    worst, worst_x = float(rel[i]), float(x[i])
                if (~big).any():
                    worst_abs = max(worst_abs, float(err[~big].max()))
    return worst, worst_x, worst_abs, nan


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ex2-ulps", type=float, default=0.0)
    args = ap.parse_args(argv)
    worst, x, worst_abs, nan = sweep(args.ex2_ulps)
    print(f"log_sigmoid_f32, ex2 moved by +-{args.ex2_ulps} ulp: max relative error "
          f"{worst:.4f}u at x = {x!r} (|ls| >= 2^-126); max absolute error below "
          f"{worst_abs:.3g}; NaN {nan}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
