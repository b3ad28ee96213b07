"""Paper-scale compression smoke: 512 trees x depth 8 on an 8-shard mesh.

    python -m repro_torch.tools.paper_scale_smoke [--device cpu]

The port of ``scripts/paper_scale_smoke.py``.  The paper's scaling
argument (Fig. 11) assumes large ensembles fit the chip's bounded CAM row
capacity; RETENTION-style compression (``repro_torch.core.compress``) is
what makes that true for deep models whose naive one-row-per-leaf
lowering would not.  Three checks:

  1. a 512-tree depth-8 duplicate-split ensemble (131072 naive rows) is
     built with ``compress='auto'`` and must shed >= 30% of its rows,
  2. bound to a mesh of 8 logical shards on the device
     (``make_host_mesh(devices=[device] * 8)``), the compressed per-shard
     row count must fit a budget (half the naive per-shard load) that the
     UNCOMPRESSED table provably exceeds,
  3. one served batch must return margins bit-equal to the float
     reference (k/16 leaves: exact float32 sums, no tolerance).

The mesh runs on the card unless ``--device cpu`` is given.  Exits
non-zero when a check fails.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

N_TREES, DEPTH, N_FEATURES, N_BINS = 512, 8, 32, 256
MIN_SAVINGS = 0.30
N_SHARDS = 8


def main(argv: list[str] | None = None) -> int:
    from repro_torch.api import build
    from repro_torch.core.engine import resolve_device
    from repro_torch.core.trees import random_deep_ensemble
    from repro_torch.launch.mesh import make_host_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the device the 8 logical shards share (default: the card)")
    device = resolve_device(ap.parse_args(argv).device)

    ens = random_deep_ensemble(
        n_trees=N_TREES, depth=DEPTH, n_features=N_FEATURES,
        n_bins=N_BINS, p_dup=0.5, seed=20260808,
    )
    cm = build(ens, compress="auto")
    rep = cm.compression
    naive_rows = rep["rows_before"]
    print(f"[build]   {N_TREES} trees x depth {DEPTH}: {naive_rows} naive "
          f"rows -> {rep['rows_after']} "
          f"({rep['row_savings_fraction']:.0%} saved, "
          f"{rep['cols_before'] - rep['cols_after']} columns collapsed)")
    if rep["row_savings_fraction"] < MIN_SAVINGS:
        print(f"[build]   FAIL: savings {rep['row_savings_fraction']:.3f} below the "
              f"{MIN_SAVINGS:.0%} acceptance floor", file=sys.stderr)
        return 1

    mesh = make_host_mesh(devices=[device] * N_SHARDS)
    eng = cm.engine(mesh=mesh)
    n_row_shards = mesh.shape[eng.row_axis]
    shard_rows = eng.arrays.r_pad // n_row_shards
    naive_shard_rows = -(-naive_rows // n_row_shards)  # ceil
    budget = naive_shard_rows // 2
    print(f"[place]   mesh {mesh.shape} on {device}: {shard_rows} rows/shard "
          f"across {n_row_shards} '{eng.row_axis}' shards "
          f"(budget {budget}, naive would need {naive_shard_rows}); spmd {eng.spmd}")
    if eng.spmd != "shard_map":
        print(f"[place]   FAIL: spmd {eng.spmd!r}, want 'shard_map'", file=sys.stderr)
        return 1
    if naive_shard_rows <= budget:
        print("[place]   FAIL: smoke is vacuous: the naive table fits the per-shard "
              "budget", file=sys.stderr)
        return 1
    if shard_rows > budget:
        print(f"[place]   FAIL: compressed table does not fit: {shard_rows} rows/shard "
              f"> budget {budget}", file=sys.stderr)
        return 1

    rng = np.random.default_rng(0)
    q = rng.integers(0, N_BINS, size=(64, N_FEATURES)).astype(np.int32)
    got = eng.raw_margin(q).cpu().numpy()
    ref = ens.raw_margin(q)
    if not np.array_equal(got, ref):
        print(f"[serve]   FAIL: served margins diverge from the float "
              f"reference (max err {np.abs(got - ref).max():.3e})",
              file=sys.stderr)
        return 1
    print(f"[serve]   OK — {q.shape[0]} queries served under {eng.spmd} "
          f"({eng.noc_config}), margins bit-equal to the float reference")
    return 0


if __name__ == "__main__":
    sys.exit(main())
