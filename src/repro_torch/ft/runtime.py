"""Fault-tolerance runtime: checkpoint/restart runner, heartbeats,
straggler detection.

The port of ``repro.ft.runtime`` (numpy, torch and the standard library):

  * ``Heartbeat`` — per-worker liveness file with a monotonic counter;
    ``dead_workers`` flags anything past the timeout (the file protocol is
    what a real multi-host deployment would put on shared storage).
  * ``StragglerMonitor`` — per-step wall-time outlier detector: a
    rolling-window median baseline, or with ``ewma_alpha`` an O(1) EWMA
    baseline that excludes flagged samples, so a persistently slow
    replica cannot drag its own baseline up and hide.
  * ``FaultTolerantRunner`` — wraps a step function with periodic async
    checkpoints (``repro_torch.checkpoint``) and replays from the latest
    checkpoint after a (simulated or real) crash; data is a pure function
    of step, so the resumed loss trajectory is bit-identical (tested).

``repro_torch.serve.cluster`` replicas beat the liveness files and feed
per-row flush times into one shared EWMA monitor (DESIGN.md §12).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from repro_torch.checkpoint.ckpt import CheckpointManager, latest_step, restore_checkpoint


class Heartbeat:
    def __init__(self, run_dir: str, worker_id: int, timeout_s: float = 60.0):
        self.dir = os.path.join(run_dir, "heartbeats")
        os.makedirs(self.dir, exist_ok=True)
        self.worker_id = worker_id
        self.timeout_s = timeout_s
        self._count = 0

    def beat(self) -> None:
        self._count += 1
        path = os.path.join(self.dir, f"worker_{self.worker_id}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"count": self._count, "time": time.time()}, f)
        os.replace(tmp, path)

    def last_seen(self) -> dict[int, float]:
        """worker_id -> seconds since its last recorded beat.

        Reads every worker file in the run dir (not just this worker's),
        so any participant can observe the whole cluster; a file caught
        mid-``os.replace`` or half-written by a dying process is skipped
        rather than crashing the monitor.
        """
        now = time.time()
        ages: dict[int, float] = {}
        for fn in os.listdir(self.dir):
            if not fn.startswith("worker_") or not fn.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.dir, fn)) as f:
                    info = json.load(f)
            except (OSError, ValueError):  # pragma: no cover - torn write
                continue
            ages[int(fn.split("_")[1].split(".")[0])] = now - info["time"]
        return ages

    def dead_workers(self) -> list[int]:
        return sorted(
            wid for wid, age in self.last_seen().items()
            if age > self.timeout_s
        )


@dataclass
class StragglerMonitor:
    """Wall-time outlier detector with two baseline flavours.

    ``ewma_alpha=None`` (default, training path): baseline is the median
    of the last ``window`` samples.  ``ewma_alpha=a`` (serving path):
    baseline is an exponentially-weighted moving average updated only
    with UN-flagged samples, so a replica that turns slow keeps being
    flagged instead of normalizing its own baseline.  Either way the
    first ``min_samples`` observations are warmup and never flag.
    """

    threshold: float = 3.0
    window: int = 32
    ewma_alpha: float | None = None
    min_samples: int = 8
    times: list[float] = field(default_factory=list)
    events: list[dict] = field(default_factory=list)
    _ewma: float | None = None

    @property
    def baseline(self) -> float | None:
        """Current comparison baseline (None during warmup)."""
        if self.ewma_alpha is not None:
            return self._ewma
        hist = self.times[-self.window:]
        return float(np.median(hist)) if hist else None

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        if self.ewma_alpha is None:
            hist = self.times[-self.window:]
            self.times.append(dt)
            if len(hist) < self.min_samples:
                return False
            med = float(np.median(hist))
            if dt > self.threshold * med:
                self.events.append({"step": step, "dt": dt, "median": med})
                return True
            return False
        base = self._ewma
        self.times.append(dt)
        if base is None:
            self._ewma = float(dt)
            return False
        flagged = (
            len(self.times) >= self.min_samples and dt > self.threshold * base
        )
        if flagged:
            self.events.append({"step": step, "dt": dt, "baseline": base})
        else:
            a = self.ewma_alpha
            self._ewma = a * float(dt) + (1.0 - a) * base
        return flagged


class InjectedFailure(RuntimeError):
    pass


class FaultTolerantRunner:
    """Checkpoint/restart training loop.

    step_fn: (state, step) -> (state, metrics); state is a tree of
    tensors (``repro_torch.checkpoint``).  The runner checkpoints every
    ``ckpt_every`` steps (async), restores from the latest checkpoint on
    (re)start, and records straggler events.  ``failure_at`` injects a
    crash after that step completes (tests).
    """

    def __init__(
        self,
        run_dir: str,
        step_fn: Callable[[Any, int], tuple[Any, dict]],
        init_state: Callable[[], Any],
        *,
        ckpt_every: int = 10,
        keep: int = 3,
        worker_id: int = 0,
    ):
        self.run_dir = run_dir
        self.step_fn = step_fn
        self.init_state = init_state
        self.ckpt_every = ckpt_every
        self.mgr = CheckpointManager(os.path.join(run_dir, "ckpt"), keep=keep)
        self.heartbeat = Heartbeat(run_dir, worker_id)
        self.straggler = StragglerMonitor()

    def resume_or_init(self, placer: Callable | None = None) -> tuple[int, Any]:
        """(first step, state): the latest checkpoint restored into the
        structure (and devices) of ``init_state()``, then ``placer``; or
        step 0 and ``init_state()`` when there is none."""
        ckpt_dir = os.path.join(self.run_dir, "ckpt")
        step = latest_step(ckpt_dir)
        template = self.init_state()
        if step is None:
            return 0, template
        step, state = restore_checkpoint(ckpt_dir, template, step, placer)
        return step, state

    def run(
        self,
        n_steps: int,
        *,
        failure_at: int | None = None,
        placer: Callable | None = None,
        on_metrics: Callable[[int, dict], None] | None = None,
    ) -> tuple[Any, list[dict]]:
        start, state = self.resume_or_init(placer)
        history: list[dict] = []
        for step in range(start, n_steps):
            t0 = time.time()
            state, metrics = self.step_fn(state, step)
            dt = time.time() - t0
            flagged = self.straggler.record(step, dt)
            metrics = {**metrics, "step": step, "dt": dt, "straggler": flagged}
            history.append(metrics)
            if on_metrics:
                on_metrics(step, metrics)
            self.heartbeat.beat()
            done = step + 1
            if done % self.ckpt_every == 0 or done == n_steps:
                self.mgr.save(done, state, extra={"metrics": {
                    k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))
                }})
            if failure_at is not None and done == failure_at:
                self.mgr.wait()
                raise InjectedFailure(f"injected crash after step {failure_at}")
        self.mgr.wait()
        return state, history
