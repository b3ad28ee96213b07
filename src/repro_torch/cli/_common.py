"""Shared plumbing for the artifact command lines (``ingest``, ``score``).

A copy of ``scripts/_cli.py`` without its ``sys.path`` bootstrap (run the
commands with ``python -m repro_torch.cli.<name>`` and ``src`` on the
path): artifact loading with a friendly error, and the ``--expected``
golden-record verification, so the two frontends cannot drift apart on how
a record is judged — nor from the JAX package's.

The golden record is a JSON file ``{x, raw_margin, predict}``: float
queries plus the frozen reference outputs.  Verification contract
(DESIGN.md §9): predictions must be BIT-IDENTICAL to the record
(regression excepted — its predictions ARE margins); raw margins must
sit within the engine's float32 accumulation tolerance (~1 ULP vs the
reference traversal).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np


def load_artifact(base: str | Path):
    """``CompiledModel.load`` with a CLI-grade error message."""
    from repro_torch.api import CompiledModel  # lazy: --help stays instant

    base = Path(base)
    try:
        return CompiledModel.load(base)
    except FileNotFoundError:
        raise SystemExit(
            f"[load]    ERROR: no artifact at {base!s} "
            f"(expected {base}.npz + {base}.json — the pair "
            "scripts/ingest.py --out writes)"
        )


def load_expected(path: str | Path) -> dict:
    """Parse a golden record into arrays: x, raw_margin, predict."""
    exp = json.loads(Path(path).read_text())
    return {
        "x": np.asarray(exp["x"], dtype=np.float64),
        "raw_margin": np.asarray(exp["raw_margin"], dtype=np.float32),
        "predict": np.asarray(exp["predict"]),
    }


def check_against_record(
    got_margin: np.ndarray,
    got_pred: np.ndarray,
    exp: dict,
    task: str,
    source: str,
) -> int:
    """Judge served outputs against a loaded golden record.

    Returns a process exit code (0 ok / 1 fail) and prints the
    ``[verify]`` verdict lines of the JAX package's commands.
    """
    want_margin, want_pred = exp["raw_margin"], exp["predict"]
    ok = True
    got_margin = np.asarray(got_margin, dtype=np.float32)
    if not np.allclose(got_margin, want_margin, rtol=1e-5, atol=1e-6):
        bad = int((~np.isclose(got_margin, want_margin,
                               rtol=1e-5, atol=1e-6)).sum())
        print(f"[verify]  FAIL raw_margin: {bad}/{want_margin.size} cells "
              "outside engine tolerance", file=sys.stderr)
        ok = False
    if task == "regression":
        # regression "predictions" ARE the margins: engine tolerance
        pred_ok = np.allclose(got_pred, want_pred, rtol=1e-5, atol=1e-6)
    else:
        pred_ok = np.array_equal(
            np.asarray(got_pred, dtype=want_pred.dtype), want_pred
        )
    if not pred_ok:
        print("[verify]  FAIL predict: outputs differ from the record",
              file=sys.stderr)
        ok = False
    if ok:
        print(f"[verify]  OK — {exp['x'].shape[0]} queries: predictions "
              f"bit-identical, margins within engine tolerance ({source})")
    return 0 if ok else 1


def verify_expected(artifact, expected_path: str | Path, device=None) -> int:
    """Serve a golden record's float queries through the artifact's
    engine on ``device`` (the one-call ``raw_margin``/``predict`` API; the
    card unless ``"cpu"``) and judge."""
    exp = load_expected(expected_path)
    return check_against_record(
        artifact.raw_margin(exp["x"], device=device),
        artifact.predict(exp["x"], device=device),
        exp,
        artifact.table.task,
        Path(expected_path).name,
    )
