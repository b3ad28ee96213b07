"""Streaming offline batch scoring: saved artifact × columnar file.

The port of ``repro.score``: the throughput tier (DESIGN.md §14), on the
card unless ``device="cpu"`` (or a device mesh, ``mesh=``) is given.  ``score_file`` is the entry
point; the reader/writer pieces are exported for callers that compose
their own pipelines::

    from repro_torch.score import score_file

    res = score_file("model_artifact", "rows.npy", kind="predict",
                     chunk_rows=8192, out="preds.npy", device="cuda")
    print(f"{res.n_rows} rows at {res.rows_per_s:,.0f} rows/s")

Importing this package touches no device — sources open, inputs are
inspected, and errors surface numpy-only; device work starts inside
``score_file`` once there are rows to score.
"""

from repro_torch.score.pipeline import KINDS, ScoreResult, score_file
from repro_torch.score.reader import (
    ArraySource,
    NpySource,
    ParquetSource,
    open_columnar,
)
from repro_torch.score.writer import PredictionWriter

__all__ = [
    # pipeline
    "score_file",
    "ScoreResult",
    "KINDS",
    # columnar input sources
    "open_columnar",
    "ArraySource",
    "NpySource",
    "ParquetSource",
    # streaming output
    "PredictionWriter",
]
