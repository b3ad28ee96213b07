"""Shape-bucketed micro-batching for the CAM serving path.

The port of ``repro.serve.batching``.  Production tabular traffic arrives
as many small, ragged query batches (typically a single row per request).
Instead of one engine call per request the batcher:

  1. coalesces pending requests (arrival order) into one query block,
  2. pads the block to the smallest admissible BUCKET — powers of two up
     to ``b_blk``, then ``b_blk`` multiples up to ``max_batch`` — the
     JAX package's buckets (the port's engines have ``batch_multiple``
     1, like its jnp engine), so both packages pad alike,
  3. runs the engine's ``padded_fn`` once per flush on the engine's
     device, and copies the outputs to the host (``.cpu()``: the one
     sync point of a flush),
  4. un-pads and splits the outputs back to the individual requests in
     their original order.

Batches larger than ``max_batch`` still get served: the fallback bucket is
the next ``b_blk`` multiple (logged, not fatal).
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field

import numpy as np

from repro_torch.kernels import ops as kops

log = logging.getLogger(__name__)


def _ceil_to(x: int, m: int) -> int:
    return int(np.ceil(x / m)) * m


@dataclass(frozen=True)
class BucketSpec:
    """The admissible padded batch sizes for one served model.

    ``multiple`` comes from ``XTimeEngine.batch_multiple``: 1 for the
    port's single-device engines (the CUDA kernel masks a ragged batch
    edge), the batch-shard count for a mesh engine; the JAX package's
    Pallas engines need ``b_blk`` multiples.  Large buckets step by ``lcm(b_blk, multiple)`` so every
    constraint holds simultaneously.
    """

    b_blk: int = 128
    max_batch: int = 1024
    multiple: int = 1

    def __post_init__(self) -> None:
        if self.multiple < 1 or self.b_blk < 1:
            raise ValueError("b_blk and multiple must be >= 1")
        if self.max_batch < self._step():
            raise ValueError(
                f"max_batch={self.max_batch} must be >= the smallest large "
                f"bucket lcm(b_blk={self.b_blk}, multiple={self.multiple})"
                f"={self._step()}"
            )

    def _step(self) -> int:
        return int(np.lcm(self.b_blk, self.multiple))

    def sizes(self) -> list[int]:
        """All cached bucket sizes, ascending: power-of-two multiples of
        ``multiple`` below the large-bucket step, then step multiples."""
        step = self._step()
        out = []
        p = self.multiple
        while p < step:
            out.append(p)
            p *= 2
        out.extend(range(step, self.max_batch + 1, step))
        return out

    def select(self, n: int) -> int:
        """Smallest bucket holding ``n`` rows (over-max falls back to the
        next step multiple — admissible but uncached)."""
        if n <= 0:
            raise ValueError("empty batch")
        for s in self.sizes():
            if n <= s:
                return s
        fallback = _ceil_to(n, self._step())
        log.warning(
            "batch of %d rows exceeds max_batch=%d; using uncached bucket %d",
            n, self.max_batch, fallback,
        )
        return fallback


@dataclass
class PendingRequest:
    """One enqueued query batch awaiting a flush."""

    request_id: int
    q_bins: np.ndarray  # (b, F) int
    t_enqueue: float = 0.0

    @property
    def n_rows(self) -> int:
        return int(self.q_bins.shape[0])


@dataclass
class MicroBatcher:
    """Coalesces requests for ONE engine into bucket-padded flushes.

    The batcher owns ordering: requests are concatenated in arrival order
    and results are handed back keyed by request id, so interleaving or
    re-submitting out of order cannot mis-route rows.

    Thread safety: ``submit``/``flush``/queue inspection may be called
    from concurrent threads (the async cluster tier drives one batcher
    from intake and worker threads at once).  The queue is mutated only
    under ``_lock``; a flush atomically takes the whole pending list and
    runs the engine OUTSIDE the lock, so submits keep landing while a
    flush computes and two racing flushes serve disjoint batches.
    """

    # XTimeEngine (duck-typed: padded_fn/arrays/batch_multiple/select_features)
    engine: "object"
    bucket: BucketSpec = field(default_factory=BucketSpec)
    kind: str = "predict"
    _pending: list[PendingRequest] = field(default_factory=list)
    _next_id: int = 0
    _lock: threading.RLock = field(
        default_factory=threading.RLock, repr=False, compare=False
    )

    @classmethod
    def for_engine(cls, engine, *, max_batch: int = 1024, kind: str = "predict"):
        return cls(
            engine=engine,
            bucket=BucketSpec(
                b_blk=engine.b_blk,
                max_batch=max_batch,
                multiple=engine.batch_multiple,
            ),
            kind=kind,
        )

    # -- queue ---------------------------------------------------------------

    def submit(
        self,
        q_bins: np.ndarray,
        *,
        t_enqueue: float = 0.0,
        request_id: int | None = None,
    ) -> int:
        """Enqueue one request batch; returns its request id.

        ``request_id`` lets an owner (ServeLoop) allocate ids globally so
        handles stay unique across batcher replacements (hot swap).
        """
        # copy: the queue may hold this until a much later flush, and the
        # caller is free to reuse/overwrite its buffer after submit()
        q = np.array(q_bins)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[0] == 0:
            raise ValueError(f"expected (b, F) query rows, got shape {q.shape}")
        with self._lock:
            if request_id is None:
                request_id = self._next_id
                self._next_id += 1
            else:
                self._next_id = max(self._next_id, request_id + 1)
            self._pending.append(PendingRequest(request_id, q, t_enqueue))
        return request_id

    @property
    def pending_rows(self) -> int:
        with self._lock:
            return sum(p.n_rows for p in self._pending)

    @property
    def pending_requests(self) -> int:
        with self._lock:
            return len(self._pending)

    def oldest_enqueue_time(self) -> float | None:
        with self._lock:
            return self._pending[0].t_enqueue if self._pending else None

    # -- flush ---------------------------------------------------------------

    def flush(self) -> dict[int, np.ndarray]:
        """Run one coalesced engine call; returns {request_id: outputs}.

        Output rows per request exactly match what a direct
        ``engine.predict``/``raw_margin`` call on that request would give
        (the correctness contract tested in tests/test_torch_serving.py).
        """
        with self._lock:
            if not self._pending:
                return {}
            batch, self._pending = self._pending, []
        n = sum(p.n_rows for p in batch)
        size = self.bucket.select(n)
        q = np.concatenate([p.q_bins for p in batch], axis=0)
        # compressed tables dropped wildcard columns: narrow the full-width
        # request rows to the stored columns BEFORE padding to f_pad —
        # padding first would bake misaligned columns into the bucket
        q_sel = self.engine.select_features(q)
        q_padded = kops.pad_to_bucket(
            q_sel, size, self.engine.arrays.f_pad,
            dtype=self.engine.table_dtype, device=self.engine.device,
        )
        # the D2H copy waits for the kernel on the current stream
        out = self.engine.padded_fn(self.kind)(q_padded).cpu().numpy()
        results: dict[int, np.ndarray] = {}
        row = 0
        for p in batch:
            results[p.request_id] = out[row : row + p.n_rows]
            row += p.n_rows
        return results
