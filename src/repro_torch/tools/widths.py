"""The widest table each CUDA kernel variant launches, found on the card.

    python3 src/repro_torch/tools/widths.py [SRC]

Launches every kernel variant — the hard kernel for each (table dtype,
cell mode) the engine binds, the soft kernel at tau = 0 and tau > 0 and
its moments pass — on a small table (B = 32, R = 128, three listed cells
a row, one at the last feature) at padded widths that are multiples of
128, and bisects for the widest that launches up to ``LIMIT`` (a launch
refused for its shared memory raises ``RuntimeError``).  Prints one line
per variant and a JSON object of them.  ``SRC`` imports ``repro_torch``
from another checkout's ``src`` directory (an older commit's kernels);
the default is this one.  Needs a card; nothing runs at import.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

STEP, LIMIT = 128, 16384
# (label, table dtype, kernel mode, inclusive encoding, tau, moments pass)
VARIANTS = [
    ("uint8/inclusive", "uint8", "inclusive", True, None, False),
    ("uint16/inclusive", "uint16", "inclusive", True, None, False),
    ("int32/direct", "int32", "direct", False, None, False),
    ("int32/msb_lsb", "int32", "msb_lsb", False, None, False),
    ("int32/two_cycle", "int32", "two_cycle", False, None, False),
    ("soft tau=0", "float32", "soft", False, 0.0, False),
    ("soft tau=0.1", "float32", "soft", False, 0.1, False),
    ("soft tau=0.1 moments", "float32", "soft", False, 0.1, True),
]


def _launcher(f_pad: int, variant: tuple):
    """A closure that launches ``variant`` once at width ``f_pad``."""
    import numpy as np
    import torch

    from repro_torch.kernels import cam_match as K
    from repro_torch.kernels import ops

    _, dtype, mode, inclusive, tau, moments = variant
    rng = np.random.default_rng(f_pad)
    r, n_bins = 128, 200
    low = np.zeros((r, f_pad), np.int32)
    high = np.full((r, f_pad), n_bins, np.int32)
    for i in range(r):
        f = rng.choice(f_pad - 1, size=2, replace=False).tolist() + [f_pad - 1]
        low[i, f], high[i, f] = 20, 180
    leaf = np.ones((r, 3 if not moments else 9), np.float32)
    if dtype == "float32" or inclusive:
        lo, hi, lm, _ = ops.pack_tables(low, high, leaf, r_blk=128, f_blk=STEP, n_bins=n_bins,
                                        dtype=dtype, inclusive=True if inclusive else None)
    else:
        lo, hi, lm = ops.pad_tables(low, high, leaf, r_blk=128, f_blk=STEP, n_bins=n_bins)
        lo, hi = lo.astype(dtype), hi.astype(dtype)
    cells = ops.binding_cells(lo, hi, n_bins=n_bins, inclusive=inclusive,
                              n_real_rows=r).to("cuda")
    q = ops.pad_queries(rng.integers(0, n_bins, size=(32, f_pad)), lo.shape[1], dtype=dtype,
                        device="cuda")
    lm = torch.from_numpy(lm).cuda()
    if mode == "soft":
        return lambda: K.cam_match_soft_cuda(q, cells, lm, tau=tau)
    return lambda: K.cam_match_cuda(q, cells, lm, mode=mode)


def launches(f_pad: int, variant: tuple) -> bool:
    """Whether ``variant`` launches at width ``f_pad`` (and runs to its end)."""
    import torch

    fn = _launcher(f_pad, variant)
    try:
        fn()
    except RuntimeError as e:
        if "launch failed" not in str(e):
            raise
        return False
    torch.cuda.synchronize()
    return True


def widest(variant: tuple) -> int:
    """The widest multiple of ``STEP`` up to ``LIMIT`` that launches (a
    bisection: a width that launches is taken to mean every narrower one
    does), or 0 when not even ``STEP`` does."""
    if launches(LIMIT, variant):
        return LIMIT
    lo, hi = 0, LIMIT // STEP  # lo launches (0: none known), hi does not
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if launches(mid * STEP, variant):
            lo = mid
        else:
            hi = mid
    return lo * STEP


def main(argv: list[str]) -> int:
    # run as a file, sys.path[0] is this directory: put a checkout's src there
    src = Path(argv[1]) if len(argv) > 1 else Path(__file__).resolve().parents[2]
    sys.path[0] = str(src.resolve())
    import torch

    if not torch.cuda.is_available():
        print("widths: torch sees no CUDA device", file=sys.stderr)
        return 1
    import repro_torch

    print(f"kernels of {Path(repro_torch.__file__).resolve().parent}", flush=True)
    out = {}
    for v in VARIANTS:
        out[v[0]] = widest(v)
        print(f"widest F_pad that launches: {v[0]} {out[v[0]]}"
              + (f" (or more: the probe stops at {LIMIT})" if out[v[0]] == LIMIT else ""),
              flush=True)
    print(json.dumps({"widest_f_pad": out, "limit": LIMIT}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
