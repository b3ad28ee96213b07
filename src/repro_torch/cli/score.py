"""Bulk-score a columnar file through a saved X-TIME artifact.

    python -m repro_torch.cli.score artifacts/churn rows.npy --out preds.npy
    python -m repro_torch.cli.score artifacts/churn rows.parquet --kind margin
    python -m repro_torch.cli.score artifacts/churn rows.npy --expected golden.json

The port's ``scripts/score.py`` (DESIGN.md §14): loads the ``<artifact>.npz
+ .json`` pair, streams the input file chunk by chunk through
``repro_torch.score.score_file`` on ``--device`` (the card unless ``cpu``)
— binning float rows with the artifact's own grid, a copy stream and two
pinned buffers on the card — and writes predictions to ``--out`` (a
``.npy`` memmap, bounded memory at any file size) while reporting rows/s.

``--expected`` verifies the streamed outputs against a golden record
``{x, raw_margin, predict}``: the record's queries are written to a temp
``.npy``, streamed through the scoring pipeline in BOTH kinds, and judged
with the shared ``check_against_record`` contract — predictions
bit-identical, margins within engine tolerance (exit 1 otherwise).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

from repro_torch.cli._common import check_against_record, load_artifact, load_expected


def _report(res) -> None:
    eng = res.engine
    print(f"[score]   {res.n_rows} rows x {res.n_features} features -> "
          f"{res.kind}: {res.n_chunks} chunks of {res.chunk_rows} "
          f"(bucket {res.bucket}), "
          f"{'grid-binned' if res.binned else 'pre-binned'}, "
          f"{'double-buffered' if res.double_buffered else 'synchronous'}")
    if eng:
        print(f"[engine]  {eng['backend']}/{eng['table_dtype']} "
              f"kernel {eng['kernel']}, noc '{eng['noc_config']}', "
              f"{eng['devices']} device(s)")
    if res.elapsed_s > 0:
        print(f"[perf]    {res.elapsed_s:.3f} s, "
              f"{res.rows_per_s:,.0f} rows/s")
    if res.path is not None:
        print(f"[out]     {res.path}")


def _verify(artifact, expected_path: str, chunk_rows: int, device) -> int:
    """Stream the golden record's queries through the scoring pipeline
    (not the in-memory engine — the point is to certify the file path)
    and judge both kinds against the record."""
    from repro_torch.score import score_file

    exp = load_expected(expected_path)
    with tempfile.TemporaryDirectory() as td:
        qpath = Path(td) / "golden_x.npy"
        np.save(qpath, exp["x"])
        got_m = score_file(artifact, qpath, kind="margin",
                           chunk_rows=chunk_rows, device=device)
        got_p = score_file(artifact, qpath, kind="predict",
                           chunk_rows=chunk_rows, device=device)
    return check_against_record(
        got_m.values, got_p.values, exp, artifact.table.task,
        f"{Path(expected_path).name}, streamed",
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("artifact", help="saved artifact base path "
                                     "(the BASE of BASE.npz + BASE.json)")
    ap.add_argument("input", help="columnar rows: .npy (memory-mapped, "
                                  "zero-dependency) or .parquet (pyarrow)")
    ap.add_argument("--kind", default="predict",
                    choices=("predict", "margin"),
                    help="final predictions or raw per-channel margins "
                         "(default: %(default)s)")
    ap.add_argument("--out", metavar="NPY",
                    help="stream outputs to this .npy (memmap; omit to "
                         "score without writing)")
    ap.add_argument("--chunk-rows", type=int, default=8192, metavar="N",
                    help="rows per streamed chunk (default: %(default)s)")
    ap.add_argument("--columns", metavar="A,B,...",
                    help="parquet feature columns, in artifact feature "
                         "order (default: schema order)")
    ap.add_argument("--no-double-buffer", action="store_true",
                    help="drain each chunk synchronously (debug/measure; "
                         "same bits, no overlap)")
    ap.add_argument("--expected", metavar="JSON",
                    help="golden record {x, raw_margin, predict}: stream "
                         "its queries and verify both kinds bit-exactly")
    ap.add_argument("--device", default=None,
                    help="where the engine runs (default: the card; 'cpu' "
                         "runs the plain version)")
    args = ap.parse_args(argv)

    artifact = load_artifact(args.artifact)
    if args.expected:
        return _verify(artifact, args.expected, args.chunk_rows, args.device)

    from repro_torch.score import score_file  # lazy: --help stays instant

    try:
        res = score_file(
            artifact,
            args.input,
            kind=args.kind,
            chunk_rows=args.chunk_rows,
            out=args.out,
            columns=args.columns.split(",") if args.columns else None,
            double_buffer=not args.no_double_buffer,
            device=args.device,
        )
    except (ValueError, FileNotFoundError, ImportError) as e:
        print(f"[score]   ERROR: {e}", file=sys.stderr)
        return 1
    _report(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
