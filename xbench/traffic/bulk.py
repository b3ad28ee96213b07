"""Bulk scoring: ``score_file`` over a ``.npy`` of binned rows, in whole
passes, until the window ends.

The cell's ``traffic`` gives ``rows`` (the file's length), ``chunk_rows``
and ``sample_rows`` (rows of each pass's output kept for the reference,
drawn from the seed). The file is written under ``TMPDIR`` at set-up and
removed at the end. ``rows_per_s`` is every row scored over the wall time
of the whole passes, each of which ends when its last chunk's outputs are
on the host.
"""

from __future__ import annotations

import tempfile
import time
from pathlib import Path

import numpy as np

from xbench.ensemble import make_rows


class Driver:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        p = ctx.cell["traffic"]
        self.n_rows, self.chunk = int(p["rows"]), int(p["chunk_rows"])
        self.sample = int(p["sample_rows"])
        self.kept: list[tuple[np.ndarray, np.ndarray]] = []
        self._dir = None

    def bind(self) -> None:
        self.ctx.cm.engine(self.ctx.device, batch_hint=self.chunk)

    def _pass(self):
        from repro_torch import score_file

        return score_file(self.ctx.cm, self.path, kind="margin", chunk_rows=self.chunk,
                          device=self.ctx.device)

    def prepare(self) -> None:
        rows = make_rows(self.ctx.cfg, self.ctx.seed, self.n_rows, self.ctx.device)
        self.rows = rows.cpu().numpy()
        del rows
        self._dir = tempfile.TemporaryDirectory(prefix="xbench-")
        self.path = Path(self._dir.name) / "rows.npy"
        np.save(self.path, self.rows)
        self._pass()  # binds the pipeline's buffers and reads the file once

    def window(self, seconds: float, tracer) -> dict:
        rng = np.random.default_rng(self.ctx.sample_seed)
        rows = chunks = 0
        t0 = time.perf_counter()
        while True:
            with tracer.span("xbench.score_file"):
                res = self._pass()
            idx = rng.choice(self.n_rows, self.sample, replace=False)
            self.kept.append((idx, np.array(res.values[idx])))
            rows += res.n_rows
            chunks += res.n_chunks
            wall = time.perf_counter() - t0
            if wall >= seconds:
                break
        return {
            "e2e": {"rows_per_s": rows / wall},
            "attempted": rows, "failed": 0,
            "counters": {"rows": rows, "launches": chunks, "chunks": chunks, "wall_s": wall,
                         "passes": len(self.kept)},
        }

    def answers(self):
        for idx, out in self.kept:
            yield self.rows[idx], out

    def close(self) -> None:
        if self._dir is not None:
            self._dir.cleanup()
            self._dir = None
