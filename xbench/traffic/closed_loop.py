"""A closed loop: one client calling ``CompiledModel.raw_margin`` on
``batch``-row batches back to back, each call timed from its start to its
margins on the host.

The cell's ``traffic`` gives ``batch``, ``pool_batches`` (the distinct
batches, drawn from the seed, that the calls take in a seeded order) and
``sample_share`` (the share of calls whose outputs are kept for the
reference, drawn from the seed; at most ``sample_max``).
"""

from __future__ import annotations

import time

import numpy as np

from xbench.ensemble import make_rows

MAX_CALLS = 1 << 21
PERCENTILES = (50, 90, 95, 99)


class Driver:
    def __init__(self, ctx) -> None:
        self.ctx = ctx
        p = ctx.cell["traffic"]
        self.batch, self.n_pool = int(p["batch"]), int(p["pool_batches"])
        self.share, self.sample_max = float(p["sample_share"]), int(p["sample_max"])
        self.kept: list[tuple[int, np.ndarray]] = []

    def bind(self) -> None:
        self.ctx.cm.engine(self.ctx.device, batch_hint=self.batch)

    def prepare(self) -> None:
        cfg = self.ctx.cfg
        rows = make_rows(cfg, self.ctx.seed, self.n_pool * self.batch, self.ctx.device)
        self.pool = rows.cpu().numpy().reshape(self.n_pool, self.batch, int(cfg["n_features"]))
        del rows
        for x in self.pool[:3]:
            self.ctx.cm.raw_margin(x, device=self.ctx.device)

    def window(self, seconds: float, tracer) -> dict:
        rng = np.random.default_rng(self.ctx.sample_seed)
        order = rng.integers(0, self.n_pool, size=MAX_CALLS)
        keep = rng.random(MAX_CALLS) < self.share
        lat = np.empty(MAX_CALLS)
        cm, dev, span = self.ctx.cm, self.ctx.device, tracer.span
        i = 0
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while True:
            a = time.perf_counter()
            with span("xbench.raw_margin"):
                out = cm.raw_margin(self.pool[order[i]], device=dev)
            b = time.perf_counter()
            lat[i] = b - a
            if keep[i] and len(self.kept) < self.sample_max:
                self.kept.append((int(order[i]), out))
            i += 1
            if b >= t_end or i == MAX_CALLS:
                break
        ms = lat[:i] * 1e3
        return {
            "e2e": {f"p{q}_ms": float(np.percentile(ms, q)) for q in PERCENTILES},
            "attempted": i, "failed": 0,
            "counters": {"calls": i, "rows": i * self.batch, "launches": i, "wall_s": b - t0},
        }

    def answers(self):
        for k, out in self.kept:
            yield self.pool[k], out

    def close(self) -> None:
        pass
