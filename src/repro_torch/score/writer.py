"""Streaming prediction writer for the offline-scoring pipeline.

A copy of ``repro.score.writer``.

The pipeline drains device outputs one chunk at a time; this writer puts
them where they belong without ever holding more than one chunk of
freshly produced output:

  * with a ``path`` — a preallocated ``.npy`` memmap
    (``np.lib.format.open_memmap``), so a billion-row scoring run
    streams straight to disk with a bounded resident set;
  * without — a preallocated in-memory array (the convenience path for
    callers that want the result as an ndarray).

Allocation is deferred to the first chunk: output dtype and trailing
shape fall out of what the engine actually produced (``(B, n_outputs)``
float32 margins vs ``(B,)`` integer predictions), so the writer never
second-guesses the engine's contract.  Numpy-only, like the reader.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class PredictionWriter:
    """Collects per-chunk outputs into one ``(n_rows, ...)`` array/file."""

    def __init__(self, n_rows: int, path: str | Path | None = None) -> None:
        self.n_rows = int(n_rows)
        self.path = None if path is None else Path(path)
        if self.path is not None and self.path.suffix != ".npy":
            # writing raw npy bytes under a surprising suffix would make
            # the output unreadable by the obvious np.load call
            self.path = self.path.with_suffix(self.path.suffix + ".npy")
        self._out: np.ndarray | None = None
        self._written = 0

    def _allocate(self, first_chunk: np.ndarray) -> None:
        shape = (self.n_rows,) + first_chunk.shape[1:]
        if self.path is None:
            self._out = np.empty(shape, dtype=first_chunk.dtype)
        else:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._out = np.lib.format.open_memmap(
                self.path, mode="w+", dtype=first_chunk.dtype, shape=shape
            )

    def write(self, start: int, chunk: np.ndarray) -> None:
        """Place ``chunk`` at row ``start``; chunks must arrive in order
        (the pipeline drains its double buffer sequentially)."""
        if self._out is None:
            self._allocate(chunk)
        if start != self._written:
            raise ValueError(
                f"out-of-order chunk: expected row {self._written}, "
                f"got {start}"
            )
        stop = start + chunk.shape[0]
        if stop > self.n_rows:
            raise ValueError(
                f"chunk [{start}:{stop}) overruns the {self.n_rows}-row "
                "output"
            )
        self._out[start:stop] = chunk
        self._written = stop

    def finalize(self, empty_like: tuple | None = None) -> np.ndarray:
        """Flush and return the full output array.

        ``empty_like = (shape_tail, dtype)`` shapes a zero-row output
        when no chunk was ever written (an empty input file is a valid
        scoring run, not an error).
        """
        if self._out is None:
            tail, dtype = empty_like if empty_like is not None else ((), np.float32)
            self._allocate(np.empty((0,) + tuple(tail), dtype=dtype))
        if self._written != self.n_rows:
            raise ValueError(
                f"finalize after {self._written}/{self.n_rows} rows written"
            )
        if isinstance(self._out, np.memmap):
            self._out.flush()
        return self._out
