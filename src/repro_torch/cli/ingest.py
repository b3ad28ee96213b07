"""Convert a serialized model dump into a saved X-TIME CompiledModel.

    python -m repro_torch.cli.ingest model.json --out artifacts/churn
    python -m repro_torch.cli.ingest model.txt  --out artifacts/lgbm --n-bins 256
    python -m repro_torch.cli.ingest model.json --out a/m --expected golden.json
    python -m repro_torch.cli.ingest model.json --out a/m --autotune 1,16,256,1024

The port's ``scripts/ingest.py``: ingests an XGBoost-JSON / LightGBM-text /
sklearn-forest dump with the zero-dependency parsers in
``repro_torch.ingest`` (the source libraries are never imported), lowers
it onto the threshold grid, compiles + places it (``repro_torch.build``),
prints the lowering report, and writes the ``<out>.npz`` + ``<out>.json``
artifact a serve process cold-starts from — byte-equal to the JAX
command's for the same arguments.

``--expected`` verifies the saved artifact end-to-end on ``--device`` (the
card unless ``cpu``): the recorded float queries are binned with the
artifact's grid and served through the engine; predictions must match the
record bit-exactly and margins within engine tolerance (exit 1 otherwise).

``--autotune BATCHES`` (comma-separated, the first the primary batch) runs
``autotune_kernel`` on ``--device`` before saving and writes the artifact
``with_tuning(plan)``: ``autotune_kernel`` -> ``with_tuning`` -> ``save``
from the command line.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.cli._common import verify_expected
from repro_torch.ingest import FORMATS, IngestError, load_model


def _batches(text: str) -> tuple[int, ...]:
    try:
        out = tuple(int(b) for b in text.split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(f"not a comma-separated list of batches: {text!r}")
    if not out or min(out) < 1:
        raise argparse.ArgumentTypeError(f"batches must be >= 1: {text!r}")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dump", help="model dump (XGBoost .json / LightGBM .txt / "
                                 "sklearn-forest .json)")
    ap.add_argument("--out", required=True, metavar="BASE",
                    help="artifact base path (writes BASE.npz + BASE.json)")
    ap.add_argument("--format", default="auto",
                    choices=("auto",) + FORMATS)
    ap.add_argument("--n-bins", type=int, default=256,
                    help="threshold grid size (default: %(default)s — the "
                         "paper's 8-bit grid)")
    ap.add_argument("--strict", action="store_true",
                    help="reject models whose thresholds do not fit the grid "
                         "instead of merging (merging loses bit-exactness)")
    ap.add_argument("--batching", action="store_true",
                    help="build the §III-D input-batching router program")
    ap.add_argument("--compress", default="off", metavar="LEVEL",
                    help="CAM table compression level (off/prune/merge/full/"
                         "auto, default: %(default)s) — bit-equivalent row "
                         "merging + pruning, see repro_torch.core.compress")
    ap.add_argument("--expected", metavar="JSON",
                    help="golden reference {x, raw_margin, predict}; verify "
                         "the saved artifact serves it bit-exactly")
    ap.add_argument("--device", default=None,
                    help="where --expected and --autotune run (default: the "
                         "card; 'cpu' runs the plain version)")
    ap.add_argument("--autotune", type=_batches, metavar="BATCHES",
                    help="time the kernel candidates at these batch sizes "
                         "(e.g. 1,16,256,1024; the first is the primary) and "
                         "save the artifact with the plan")
    args = ap.parse_args(argv)

    from repro_torch.api import CompiledModel, build  # lazy: --help stays instant
    from repro_torch.core.deploy import DeployConfig

    try:
        imported = load_model(args.dump, format=args.format)
        artifact = build(
            imported,
            deploy=DeployConfig(batching=args.batching),
            n_bins=args.n_bins,
            on_overflow="raise" if args.strict else "merge",
            compress=args.compress,
        )
    except (IngestError, ValueError) as e:
        print(f"[ingest]  ERROR: {e}", file=sys.stderr)
        return 1

    rep = artifact.ingest or {}
    print(f"[ingest]  {imported.source} ({imported.source_kind}, "
          f"{imported.task}): {rep.get('n_source_trees')} trees -> "
          f"{rep.get('n_trees')} lowered, {artifact.table.n_rows} CAM rows")
    grid = [g for g in rep.get("grid", ()) if g["thresholds"]]
    peak = max((g["thresholds"] for g in grid), default=0)
    print(f"[grid]    {len(grid)}/{rep.get('n_features')} features split, "
          f"peak {peak}/{args.n_bins - 1} edges, "
          f"exact={rep.get('exact')} "
          f"(merged={rep.get('merged_thresholds')}, "
          f"remapped={rep.get('remapped_splits')})")
    for note in rep.get("notes", ()):
        print(f"[note]    {note}")
    if artifact.compression is not None:
        c = artifact.compression
        print(f"[compress] level '{c['level']}': {c['rows_before']} -> "
              f"{c['rows_after']} rows ({c['row_savings_fraction']:.0%} saved; "
              f"pruned {c['pruned_empty'] + c['pruned_unreachable']}, "
              f"merged {c['merged_rows']}, "
              f"{c['cols_before'] - c['cols_after']} columns collapsed)")
    print(f"[place]   {artifact.placement.n_cores_used} cores, "
          f"replication x{artifact.placement.replication}, "
          f"NoC '{artifact.noc.config}', "
          f"{artifact.table.feature_occupancy().mean():.0%} of CAM cells "
          "non-wildcard")

    if args.autotune:
        from repro_torch.core.tune import autotune_kernel

        plan = autotune_kernel(artifact, device=args.device, batch=args.autotune[0],
                               batches=args.autotune[1:])
        artifact = artifact.with_tuning(plan)
        buckets = ", ".join(f"{e['batch']}: {e['table_dtype']}/{e['mode']} "
                            f"{e['us_per_call']} us" for e in plan.dispatch)
        print(f"[tune]    {len(plan.trials)} trials on {plan.env['device_name']} "
              f"({plan.env['platform']}): primary B={plan.batch} -> "
              f"{plan.table_dtype}/{plan.mode} b_blk={plan.b_blk} "
              f"r_blk={plan.r_blk}; dispatch {{{buckets}}}")

    sidecar = artifact.save(args.out)
    print(f"[save]    {sidecar} (+ .npz)")

    if args.expected:
        reloaded = CompiledModel.load(args.out)  # verify the DISK artifact
        return verify_expected(reloaded, Path(args.expected), device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
