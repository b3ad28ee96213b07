"""An open loop through ``ClusterServer``: requests sent on a seeded
schedule whatever the server does, each timed from the moment it was due.

The cell's ``traffic`` gives the server's settings (``replicas``,
``flush_rows``, ``max_batch``; the rest are the server's defaults), the
schedule (``rate_per_s``, ``arrivals``, ``mean_rows``, ``max_rows``; see
``arrivals.schedule``), ``pool_rows`` (the rows the requests take, drawn
from the seed), ``warm_s`` (seconds of the same traffic before the window,
so that the server's adaptive windows start settled) and
``sample_requests`` (requests kept for the reference, drawn from the seed,
with the longest among them).

The server's handles record no completion time, so a waiter thread of the
benchmark's own stamps it: it waits on the oldest open request and, at
least every millisecond, stamps the answered ones among the oldest 64, so a
request answered out of order among them is stamped at most a millisecond
late (the server's two replicas run at most two flushes at once). A request that is shed,
fails, or is still open a minute after the window counts as failed and
enters the percentiles as answered a minute after the window closed.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
import time

import numpy as np

from xbench.ensemble import make_rows
from xbench.trace import Tracer
from xbench.traffic.arrivals import schedule

SWEEP_S = 1e-3
LOOKAHEAD = 64
PERCENTILES = (50, 90, 95, 99)
LATE_S = 60.0


class Driver:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        self.p = ctx.cell["traffic"]
        self.server = None
        self.kept: list[tuple[np.ndarray, np.ndarray]] = []

    def bind(self) -> None:
        from repro_torch import ClusterServer

        p = self.p
        self.server = ClusterServer(n_replicas=int(p["replicas"]), device=self.ctx.device,
                                    kind="margin", flush_rows=int(p["flush_rows"]),
                                    max_batch=int(p["max_batch"]))
        self.server.register("m", self.ctx.cm)

    def _schedule(self, seed: int, seconds: float, rate=None):
        p = self.p
        return schedule(seed, rate_per_s=float(rate or p["rate_per_s"]), seconds=seconds,
                        arrivals=p["arrivals"], tail_alpha=float(p.get("tail_alpha", 1.8)),
                        mean_rows=float(p["mean_rows"]), max_rows=int(p["max_rows"]),
                        pool_rows=self.pool.shape[0])

    def prepare(self) -> None:
        from repro_torch.serve.batching import BucketSpec

        rows = make_rows(self.ctx.cfg, self.ctx.seed, int(self.p["pool_rows"]), self.ctx.device,
                         stream="requests")
        self.pool = rows.cpu().numpy()
        del rows
        eng = self.ctx.cm.engine(self.ctx.device)
        sizes = BucketSpec(b_blk=eng.b_blk, max_batch=int(self.p["max_batch"]),
                           multiple=eng.batch_multiple).sizes()
        for _ in range(int(self.p["replicas"])):  # every bucket on every replica's stream
            for b in sizes:
                self.server.submit("m", self.pool[:b]).result(timeout=LATE_S)
        warm = float(self.p["warm_s"])
        if warm > 0:
            self._drive(self._schedule(self.ctx.seed + 1, warm), Tracer(False).span)
        self.server.reset_stats()

    def _rows(self, start: int, n: int) -> np.ndarray:
        if start + n <= self.pool.shape[0]:
            return self.pool[start:start + n]
        return np.take(self.pool, np.arange(start, start + n), axis=0, mode="wrap")

    def _drive(self, sched, span) -> dict:
        """Send ``sched`` on time; returns due and done times (perf_counter
        seconds), which failed, the kept answers and the submit lateness."""
        from repro_torch.serve.cluster import ShedError

        n = sched.t.size
        keep = self._sample(sched)
        handles: list = [None] * n
        done = np.full(n, np.nan)
        sent = np.empty(n)
        failed = np.zeros(n, dtype=bool)
        opened: queue.SimpleQueue = queue.SimpleQueue()
        kept: dict[int, np.ndarray] = {}

        def stamp(i: int, now: float) -> None:
            done[i] = now
            try:
                out = handles[i].result(timeout=0)
            except Exception:  # noqa: BLE001 - a failed request is counted
                failed[i] = True
            else:
                if i in keep:
                    kept[i] = out

        def waiter() -> None:
            pending: collections.deque[int] = collections.deque()
            seen = 0
            while seen < n or pending:
                while seen < n:
                    try:
                        pending.append(opened.get(block=not pending, timeout=LATE_S))
                        seen += 1
                    except queue.Empty:
                        break
                if not pending:
                    continue
                h = handles[pending[0]]
                if h is not None:
                    try:
                        h.result(timeout=SWEEP_S)
                    except Exception:  # noqa: BLE001 - not done yet, or failed: stamp tells
                        pass
                now = time.perf_counter()
                while pending:  # the oldest first, as long as they are answered
                    i = pending[0]
                    if handles[i] is not None and np.isnan(done[i]):
                        if not handles[i].done():
                            break
                        stamp(i, now)
                    handles[i] = None  # the client lets an answered request go
                    pending.popleft()
                for i in itertools.islice(pending, 1, LOOKAHEAD):  # answered out of order
                    if handles[i] is not None and np.isnan(done[i]) and handles[i].done():
                        stamp(i, now)
                if now > t0 + sched.t[-1] + LATE_S:
                    break  # what is still open has failed

        t0 = time.perf_counter() + 1e-3
        th = threading.Thread(target=waiter, name="xbench-waiter", daemon=True)
        th.start()
        submit = self.server.submit
        for i in range(n):
            d = t0 + sched.t[i] - time.perf_counter()
            if d > 0:
                time.sleep(d)
            sent[i] = time.perf_counter()
            try:
                with span("xbench.submit"):
                    handles[i] = submit("m", self._rows(int(sched.starts[i]), int(sched.sizes[i])))
            except ShedError:
                failed[i] = True
            opened.put(i)
        t_sent = time.perf_counter()
        th.join(timeout=2 * LATE_S + 5)
        if th.is_alive():
            raise RuntimeError("the waiter did not end")
        due = t0 + sched.t
        failed |= np.isnan(done)
        return {"due": due, "done": done, "failed": failed, "kept": kept,
                "late": sent - due, "t0": t0, "t_sent": t_sent}

    def window(self, seconds: float, tracer, rate=None) -> dict:
        sched = self._schedule(self.ctx.seed, seconds, rate)
        r = self._drive(sched, tracer.span)
        due, done, failed = r["due"], r["done"], r["failed"]
        t_close = np.nanmax(done) if np.isfinite(done).any() else r["t_sent"]
        lat = np.where(failed, t_close + LATE_S - due, done - due) * 1e3
        st = self.server.stats()
        rep = self.server.report()
        self.last = {"open_at_last_send": int(np.sum(done > r["t_sent"])),
                     "drain_s": float(t_close - r["t_sent"])}
        self._keep(sched, r)
        return {
            "e2e": {f"p{q}_ms": float(np.percentile(lat, q)) for q in PERCENTILES},
            "attempted": int(sched.t.size), "failed": int(failed.sum()),
            "counters": {
                "requests": int(sched.t.size), "rows": int(st.n_rows), "wall_s": float(t_close - r["t0"]),
                "launches": int(st.n_flushes), "server_rows": int(st.n_rows),
                "server_flushes": int(st.n_flushes), "server_p99_ms": float(st.p99_ms),
                "late_p50_ms": float(np.percentile(r["late"], 50) * 1e3),
                "late_p99_ms": float(np.percentile(r["late"], 99) * 1e3),
                "shed": int(sum(rep["shed"].values())),
                "replicas_alive": sum(x["state"] == "alive" for x in rep["replicas"].values()),
                "straggler_events": int(rep["straggler_events"]),
            },
        }

    def _sample(self, sched) -> set[int]:
        """The requests kept for the reference: drawn from the seed, with
        the longest among them."""
        rng = np.random.default_rng(self.ctx.sample_seed)
        k = min(int(self.p["sample_requests"]), sched.t.size)
        return {*rng.choice(sched.t.size, k, replace=False).tolist(),
                int(np.argmax(sched.sizes))}

    def _keep(self, sched, r) -> None:
        for i in sorted(r["kept"]):
            if not r["failed"][i]:
                rows = self._rows(int(sched.starts[i]), int(sched.sizes[i]))
                self.kept.append((rows, np.asarray(r["kept"][i])))

    def answers(self):
        yield from self.kept

    def close(self) -> None:
        if self.server is not None:
            self.server.close()
            self.server = None
