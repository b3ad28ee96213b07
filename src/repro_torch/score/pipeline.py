"""Streaming batch scoring: saved artifact × columnar file → predictions.

The port of ``repro.score.pipeline``: the throughput counterpart to the
latency-focused serve tiers — bulk offline scoring of columnar rows at
maximum rows/s (DESIGN.md §14).  On the card the pipeline is

    read + bin chunk i+1  host: slice → grid binning → bucket pad → pinned buffer
    copy chunk i+1        copy stream: pinned buffer → device, then an event
    score chunk i         compute stream: waits for its copy's event → kernel
                          → outputs into a pinned host buffer, then an event
    drain chunk i-1       host: waits for that event → writer (in order)

with two pinned host buffers and two device buffers, so at most two
chunks are in flight and host→device transfer and host binning overlap
the kernel.  The engine is bound with ``batch_hint=chunk_rows``, so a
tuned artifact scores with the measured winner of that bucket (where the
port timed the plan on the device's type).  Every chunk (tail included)
pads to one bucket, sized to ``chunk_rows`` rounded up to
``lcm(b_blk, batch_multiple)`` of that engine.  On the CPU
(``device="cpu"``) the chunks run one after another through the plain
version.  On a mesh (``mesh=``) each chunk fans out under the ``batch``
NoC program unless ``noc_config`` says otherwise, and the pipeline runs on
the mesh's first device, where the engine's outputs land.

Bit-equivalence contract: every CAM row match and leaf accumulation is
per-query-row independent, so the concatenated streamed outputs are
BIT-IDENTICAL to one call over the whole file on the same engine —
across chunk sizes, tails, and double-buffering on/off
(tests/test_torch_score.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.tune import kernel_version
from repro_torch.kernels import ops as kops
from repro_torch.score.reader import open_columnar
from repro_torch.score.writer import PredictionWriter
from repro_torch.spans import span

#: what ``kind`` selects — engine margins (the BDT analysis score) or
#: final predictions (argmax/sign/regression value)
KINDS = ("margin", "predict")


@dataclass(frozen=True)
class ScoreResult:
    """One streaming scoring run: the outputs plus its throughput record."""

    values: np.ndarray  # (n_rows, n_outputs) margins or (n_rows,) predictions
    path: Path | None  # where values were streamed (None: in-memory)
    kind: str
    n_rows: int
    n_features: int
    n_chunks: int
    chunk_rows: int
    bucket: int  # padded per-chunk batch (one shape for the whole file)
    binned: bool  # True when the artifact's grid binned float input
    double_buffered: bool
    elapsed_s: float
    engine: dict = field(default_factory=dict)  # bound-engine provenance

    @property
    def rows_per_s(self) -> float:
        if self.elapsed_s <= 0:
            return 0.0
        return self.n_rows / self.elapsed_s


def _load_model(model):
    from repro_torch.api import CompiledModel

    if isinstance(model, (str, Path)):
        return CompiledModel.load(model)
    if not isinstance(model, CompiledModel):
        raise TypeError(
            "score_file takes a CompiledModel or a saved-artifact path, "
            f"got {type(model).__name__}"
        )
    return model


def _empty_tail(model, kind: str) -> tuple[tuple, np.dtype]:
    """Output (trailing shape, dtype) for a zero-row input, mirroring the
    engine's own output contract without binding an engine."""
    if kind == "margin":
        return (int(model.table.n_outputs),), np.dtype(np.float32)
    if model.table.task == "regression":
        return (), np.dtype(np.float32)
    return (), np.dtype(np.int32)


def score_file(
    model,
    source,
    *,
    kind: str = "margin",
    chunk_rows: int = 8192,
    out: str | Path | None = None,
    device=None,
    mesh=None,
    columns: list[str] | None = None,
    double_buffer: bool = True,
    **overrides,
) -> ScoreResult:
    """Stream ``source`` through ``model``'s engine chunk by chunk.

    Args:
      model: a ``CompiledModel`` or a saved-artifact base path.
      source: 2-D ndarray, ``.npy`` path (memory-mapped), ``.parquet``
        path (optional pyarrow), or an open reader source.  Float rows
        are binned chunk by chunk with the artifact's attached grid
        (``CompiledModel.quantizer``); integer rows are treated as
        already-binned queries and pass the grid by.
      kind: 'margin' (raw per-channel scores) or 'predict' (final
        predictions) — the outputs of ``XTimeEngine.raw_margin`` /
        ``predict`` over the whole file, bit for bit.
      chunk_rows: rows per chunk; the device batch is the ``bucket`` this
        pads to.
      out: optional ``.npy`` path to stream predictions into
        (preallocated memmap — bounded memory at any file size).
      device: where the engine runs; ``None`` is the card (raises where
        there is none), ``"cpu"`` the plain version.
      mesh: a ``repro_torch.launch.mesh.Mesh`` instead of ``device``;
        chunks then fan out under the ``batch`` NoC program (replicated
        tables, each device a piece of the chunk) unless ``noc_config``
        is given.
      double_buffer: keep one chunk in flight while the host prepares
        the next.  ``False`` drains every chunk before reading the next
        — same bits, no overlap.
      overrides: ``DeployConfig`` field updates for the engine binding.

    Returns a :class:`ScoreResult`; ``.values`` is the full output array
    (memmap-backed when ``out`` was given).
    """
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} not in {KINDS}")
    if chunk_rows < 1:
        raise ValueError(f"chunk_rows must be >= 1, got {chunk_rows}")
    model = _load_model(model)
    src = open_columnar(source, columns=columns)
    try:
        n_rows, n_feat = src.n_rows, src.n_features
        expect = int(model.table.n_features)
        if n_feat != expect:
            raise ValueError(
                f"input has {n_feat} feature columns, the artifact expects "
                f"{expect}"
            )
        needs_grid = np.dtype(src.dtype).kind not in "iu"
        if needs_grid and model.quantizer is None:
            raise ValueError(
                "float columnar input needs the artifact's feature grid to "
                "bin queries, but this artifact has none attached; build "
                "with quantizer=..., or provide already-binned integer rows"
            )
        writer = PredictionWriter(n_rows, path=out)
        if n_rows == 0:
            # a valid (empty) scoring run; binds no engine
            values = writer.finalize(empty_like=_empty_tail(model, kind))
            return ScoreResult(
                values=values, path=writer.path, kind=kind, n_rows=0,
                n_features=n_feat, n_chunks=0, chunk_rows=chunk_rows,
                bucket=0, binned=needs_grid, double_buffered=double_buffer,
                elapsed_s=0.0, engine={},
            )

        if mesh is not None and "noc_config" not in overrides:
            overrides = {"noc_config": "batch", **overrides}
        engine = model.engine(device, mesh=mesh, batch_hint=chunk_rows, **overrides)
        # one bucket for every chunk (tail included)
        mult = int(np.lcm(engine.b_blk, engine.batch_multiple))
        bucket = int(np.ceil(min(chunk_rows, n_rows) / mult)) * mult
        quantizer = model.quantizer

        def padded(chunk: np.ndarray) -> torch.Tensor:
            """Host: bin (float input), select the stored columns, pad."""
            bins = quantizer.transform(chunk) if needs_grid else chunk
            return kops.pad_to_bucket(
                engine.select_features(np.asarray(bins)), bucket,
                engine.arrays.f_pad, dtype=engine.table_dtype, device="cpu",
            )

        stream = _stream_cuda if engine.device.type == "cuda" else _stream_host
        t0 = time.perf_counter()
        n_chunks = stream(engine.padded_fn(kind), iter(src.iter_chunks(chunk_rows)), padded,
                          writer, engine.device, double_buffer)
        values = writer.finalize()
        elapsed = time.perf_counter() - t0

        return ScoreResult(
            values=values, path=writer.path, kind=kind, n_rows=n_rows,
            n_features=n_feat, n_chunks=n_chunks, chunk_rows=chunk_rows,
            bucket=bucket, binned=needs_grid, double_buffered=double_buffer,
            elapsed_s=elapsed,
            engine={
                "backend": engine.backend,
                "table_dtype": engine.table_dtype,
                "kernel": kernel_version(engine.table_dtype),
                "spmd": engine.spmd,
                "noc_config": engine.noc_config,
                "devices": 1 if mesh is None else int(mesh.size),
                "device": str(engine.device),
            },
        )
    finally:
        src.close()


def _take(chunks, padded):
    """The next chunk off the reader and its padded queries: ``score.prep``."""
    with span("score.prep"):
        start, chunk = next(chunks)
        return start, chunk.shape[0], padded(chunk)


def _stream_host(run, chunks, padded, writer, device, double_buffer) -> int:
    """The CPU: each chunk is scored before the next is read (the plain
    version is synchronous, so there is nothing to overlap).  Its spans
    mirror the card's: ``score.stage`` hands the queries to the device (no
    copy here) and ``score.wait`` is the synchronous call itself."""
    n_chunks = taken = 0
    while taken < writer.n_rows:
        with span("score.chunk"):
            start, n, q = _take(chunks, padded)
            with span("score.stage"):
                q = q.to(device)
            with span("score.wait"):
                out = run(q).numpy()[:n]
            writer.write(start, out)
        taken = start + n
        n_chunks += 1
    return n_chunks


def _stream_cuda(run, chunks, padded, writer, device, double_buffer) -> int:
    """The card: a copy stream and pinned host buffers, two slots.

    Chunk i uses slot i % 2.  Events order the work: ``copied[s]`` ends
    the copy of slot s to the device (the host may refill its pinned
    buffer after it), ``done[s]`` ends the kernel and the copy of its
    outputs to the host (the copy stream may overwrite the device buffer,
    and the host drains the outputs, after it).  An event never recorded
    waits for nothing.  Both device buffers are allocated before the first
    launch: one allocated later could reuse memory that a running kernel
    of the compute stream was given and has released to the allocator,
    and the copy stream would overwrite it while that kernel reads it.

    A mesh engine whose shards sit on other cards stays in this order: its
    copies between cards (the query pieces out, the partials and outputs
    back to ``device``) are PyTorch peer copies, which wait for the current
    streams of both cards and make them wait for the copy — so the kernels
    on the other cards run after ``main`` has the chunk, and ``done[s]``,
    recorded on ``main`` after the gather, follows every shard's work."""
    main = torch.cuda.current_stream(device)
    copy = torch.cuda.Stream(device=device)
    host_q: list[torch.Tensor] = []
    dev_q: list[torch.Tensor] = []
    host_out: list[torch.Tensor | None] = [None, None]
    copied = [torch.cuda.Event(), torch.cuda.Event()]
    done = [torch.cuda.Event(), torch.cuda.Event()]

    def drain(slot: int, start: int, n: int) -> None:
        with span("score.wait"):
            done[slot].synchronize()
        writer.write(start, host_out[slot].numpy()[:n])

    pending = None
    n_chunks = taken = 0
    while taken < writer.n_rows:
        with span("score.chunk"):
            slot = n_chunks % 2
            start, n, q = _take(chunks, padded)  # the host bins while the card runs chunk i-1
            with span("score.stage"):
                copied[slot].synchronize()  # the copy that last read this pinned buffer
                if not dev_q:
                    host_q = [torch.empty(q.shape, dtype=q.dtype, pin_memory=True)
                              for _ in range(2)]
                    dev_q = [torch.empty(q.shape, dtype=q.dtype, device=device) for _ in range(2)]
                host_q[slot].copy_(q)
                with torch.cuda.stream(copy):
                    copy.wait_event(done[slot])  # the kernel that last read dev_q[slot]
                    dev_q[slot].copy_(host_q[slot], non_blocking=True)
                    copied[slot].record(copy)
            main.wait_event(copied[slot])
            with torch.cuda.stream(main):
                out = run(dev_q[slot])
                if host_out[slot] is None:
                    host_out[slot] = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                host_out[slot].copy_(out, non_blocking=True)
                done[slot].record(main)
            taken = start + n
            n_chunks += 1
            if pending is not None:
                drain(*pending)
                pending = None
            if double_buffer and taken < writer.n_rows:
                pending = (slot, start, n)
            else:  # the last chunk drains inside its own span
                drain(slot, start, n)
    return n_chunks
