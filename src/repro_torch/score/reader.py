"""Columnar input sources for the offline-scoring pipeline (DESIGN.md §14).

A copy of ``repro.score.reader``.

A *source* is anything that can hand the pipeline its rows in order, one
bounded chunk at a time, without materializing the whole file:

    ``ArraySource``    an in-memory (or already memory-mapped) 2-D array
    ``NpySource``      an ``.npy`` file opened with ``mmap_mode='r'`` —
                       the zero-dependency path: chunks are copied out of
                       the OS page cache, the full file is never resident
    ``ParquetSource``  a ``.parquet`` file streamed batch-by-batch via
                       pyarrow (optional dependency; a clean error names
                       the ``.npy`` fallback when it is absent)

``open_columnar`` picks the source from the input's type/suffix.  All
sources expose ``n_rows`` / ``n_features`` up front (the writer
preallocates its output from them) and ``iter_chunks(chunk_rows)``
yielding ``(start_row, chunk)`` with float or integer dtype preserved —
the pipeline decides whether the artifact's grid must bin them.

This module is deliberately numpy-only: opening and inspecting inputs
never touches the device (the same contract as artifact loading).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator

import numpy as np

#: file suffixes ``open_columnar`` understands (lowercased)
NPY_SUFFIXES = (".npy",)
PARQUET_SUFFIXES = (".parquet", ".pq")


def _check_chunk_rows(chunk_rows: int) -> int:
    if int(chunk_rows) < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    return int(chunk_rows)


@dataclass
class ArraySource:
    """Rows from a 2-D array already in (possibly mapped) memory.

    Chunks are *copies* of the slice (``np.ascontiguousarray``), so a
    memory-mapped backing array is only ever touched one chunk at a time
    and the pipeline may donate/overwrite what it is handed.
    """

    array: np.ndarray

    def __post_init__(self) -> None:
        if self.array.ndim != 2:
            raise ValueError(
                f"columnar input must be 2-D (rows, features), "
                f"got shape {self.array.shape}"
            )

    @property
    def n_rows(self) -> int:
        return int(self.array.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.array.shape[1])

    @property
    def dtype(self) -> np.dtype:
        return self.array.dtype

    def iter_chunks(
        self, chunk_rows: int
    ) -> Iterator[tuple[int, np.ndarray]]:
        chunk_rows = _check_chunk_rows(chunk_rows)
        for start in range(0, self.n_rows, chunk_rows):
            stop = min(start + chunk_rows, self.n_rows)
            yield start, np.ascontiguousarray(self.array[start:stop])

    def close(self) -> None:  # uniform interface; nothing to release
        pass


class NpySource(ArraySource):
    """A ``.npy`` file memory-mapped read-only — the zero-dependency
    billion-row path: the resident set is one chunk plus whatever the OS
    keeps cached, regardless of file size."""

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        super().__init__(np.load(self.path, mmap_mode="r"))

    def close(self) -> None:
        # drop the mmap reference; the OS unmaps when the array dies
        mm = getattr(self.array, "_mmap", None)
        self.array = np.zeros((0, self.n_features or 0))
        if mm is not None:  # pragma: no cover - platform-dependent attr
            mm.close()


@dataclass
class ParquetSource:
    """A ``.parquet`` file streamed via pyarrow's batch iterator.

    Optional-dependency path: importing this class is free, constructing
    it without pyarrow raises a clean error pointing at the ``.npy``
    route.  ``columns`` selects/orders feature columns; by default every
    column is used in schema order.
    """

    path: str | Path
    columns: list[str] | None = None
    _pf: object = field(init=False, repr=False, default=None)

    def __post_init__(self) -> None:
        try:
            import pyarrow.parquet as pq
        except ImportError as e:  # pragma: no cover - env-dependent
            raise ImportError(
                "reading .parquet needs the optional 'pyarrow' dependency "
                "(pip install pyarrow); .npy inputs stream with no extra "
                "dependencies"
            ) from e
        self.path = Path(self.path)
        self._pf = pq.ParquetFile(self.path)
        names = [f.name for f in self._pf.schema_arrow]
        if self.columns is None:
            self.columns = names
        else:
            missing = [c for c in self.columns if c not in names]
            if missing:
                raise ValueError(
                    f"{self.path}: columns {missing} not in parquet schema "
                    f"{names}"
                )

    @property
    def n_rows(self) -> int:
        return int(self._pf.metadata.num_rows)

    @property
    def n_features(self) -> int:
        return len(self.columns)

    @property
    def dtype(self) -> np.dtype:
        # the widest selected column type decides whether the pipeline
        # treats rows as pre-binned (all-integer) or grid-binned (float)
        schema = self._pf.schema_arrow
        kinds = [
            np.dtype(schema.field(c).type.to_pandas_dtype())
            for c in self.columns
        ]
        return np.result_type(*kinds) if kinds else np.dtype(np.float64)

    def iter_chunks(
        self, chunk_rows: int
    ) -> Iterator[tuple[int, np.ndarray]]:
        chunk_rows = _check_chunk_rows(chunk_rows)
        start = 0
        for batch in self._pf.iter_batches(
            batch_size=chunk_rows, columns=self.columns
        ):
            chunk = np.stack(
                [batch.column(i).to_numpy(zero_copy_only=False)
                 for i in range(batch.num_columns)],
                axis=1,
            )
            yield start, chunk
            start += chunk.shape[0]

    def close(self) -> None:
        self._pf.close()


def open_columnar(
    source,
    *,
    columns: list[str] | None = None,
) -> ArraySource | ParquetSource:
    """Open ``source`` as a chunk-iterable columnar input.

    ``source`` may be a 2-D ``np.ndarray`` (used as-is, zero copy until
    chunked), a ``.npy`` path (memory-mapped), or a ``.parquet`` path
    (streamed via optional pyarrow).  Already-open sources pass through.
    ``columns`` selects parquet feature columns; it is rejected for
    array inputs, whose column order is positional.
    """
    if hasattr(source, "iter_chunks"):  # already a source
        return source
    if isinstance(source, np.ndarray):
        if columns is not None:
            raise ValueError(
                "columns= applies to parquet inputs; slice array inputs "
                "before passing them"
            )
        return ArraySource(source)
    if isinstance(source, (str, Path)):
        path = Path(source)
        if not path.exists():
            raise FileNotFoundError(f"no such input file: {path}")
        suffix = path.suffix.lower()
        if suffix in NPY_SUFFIXES:
            if columns is not None:
                raise ValueError(
                    "columns= applies to parquet inputs; .npy columns are "
                    "positional"
                )
            return NpySource(path)
        if suffix in PARQUET_SUFFIXES:
            return ParquetSource(path, columns=columns)
        raise ValueError(
            f"unsupported columnar input {path.name!r}: expected one of "
            f"{NPY_SUFFIXES + PARQUET_SUFFIXES}"
        )
    raise TypeError(
        "open_columnar takes a 2-D ndarray, a .npy/.parquet path, or an "
        f"existing source, got {type(source).__name__}"
    )
