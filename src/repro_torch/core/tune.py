"""Hyperparameter search under X-TIME hardware constraints (§IV-A), and
the kernel execution autotuner (DESIGN.md §10).

A copy of ``repro.core.tune`` (the port imports nothing of ``repro``): the
paper optimizes every model/dataset pair subject to the chip constraints
(N_trees <= 4096, N_leaves,max <= 256, 8-bit thresholds) and picks the best
configuration on held-out data; ``random_search`` does that with seeded
random search over the same space, on the host in numpy, and gives the same
trials and winner as the JAX package from the same seed.

``autotune_kernel`` is the execution-side twin: it times the kernel's
``(b_blk, r_blk, table_dtype, cell mode)`` candidates end to end on one
device (the card unless the caller asks for the CPU) and returns a
``TunePlan`` with the same candidates, trials, per-bucket dispatch and
winner as the JAX package's under the same timings.  In the port ``b_blk``
only sizes serving and scoring buckets and ``r_blk`` only pads rows, so
candidates whose padded table is the same share one bound engine: a sweep
binds once per (table dtype, kernel mode, padded rows), not once per
candidate.  ``CompiledModel.with_tuning`` persists the plan in the artifact
sidecar; the port applies a plan's dispatch only where it timed the plan
itself (``TunePlan.timed_on``).
"""

from __future__ import annotations

import copy
import time
from dataclasses import asdict, dataclass, field

import numpy as np
import torch

from repro_torch.core.compile import CAMTable
from repro_torch.core.deploy import DeployConfig
from repro_torch.core.precision import get_cell_mode
from repro_torch.core.quantize import FeatureQuantizer
from repro_torch.core.trees import Ensemble, GBDTParams, RFParams, train_gbdt, train_rf
from repro_torch.data.tabular import TabularDataset, accuracy_metric


# v2: the plan carries a measured-cost DISPATCH table — one winning
# (kernel version, block sizes) entry per swept batch bucket — on top of
# the v1 top-level winner fields (which stay the primary-batch winner, so
# v1 plans keep loading: ``from_dict`` defaults an absent dispatch to empty
# and ``dispatch_for`` falls back to the top-level winner).
TUNE_SCHEMA_VERSION = 2


def kernel_version(table_dtype: str) -> str:
    """Kernel generation a resolved table dtype binds: the v1 int32
    exclusive-high layout, the v2 packed inclusive-high layout
    (uint8/uint16), or the float32 soft-encoded layout ('soft')."""
    if table_dtype == "int32":
        return "v1"
    return "soft" if np.dtype(table_dtype).kind == "f" else "v2"


@dataclass
class HWConstraints:
    """§V-A 'X-TIME 8bit' envelope."""

    max_trees: int = 4096
    max_leaves: int = 256
    n_bins: int = 256


@dataclass
class Trial:
    params: dict
    valid_score: float
    n_trees: int
    max_leaves: int


@dataclass
class SearchResult:
    best: Trial
    trials: list[Trial] = field(default_factory=list)
    ensemble: Ensemble | None = None
    quantizer: FeatureQuantizer | None = None

    @property
    def test_ready(self) -> bool:
        return self.ensemble is not None


def _sample_gbdt(rng: np.random.Generator, hw: HWConstraints, n_classes: int) -> dict:
    leaves = int(rng.choice([16, 32, 64, 128, hw.max_leaves]))
    # rounds bounded so total trees respect the chip (multiclass: x classes)
    max_rounds = max(8, hw.max_trees // max(1, n_classes))
    return {
        "n_rounds": int(rng.integers(10, min(120, max_rounds))),
        "learning_rate": float(10 ** rng.uniform(-1.5, -0.4)),
        "max_leaves": leaves,
        "max_depth": int(rng.integers(4, 11)),
        "subsample": float(rng.uniform(0.6, 1.0)),
        "colsample": float(rng.uniform(0.5, 1.0)),
        "reg_lambda": float(10 ** rng.uniform(-1, 1)),
    }


def _sample_rf(rng: np.random.Generator, hw: HWConstraints) -> dict:
    return {
        "n_trees": int(rng.integers(20, min(200, hw.max_trees))),
        "max_leaves": int(rng.choice([32, 64, 128, hw.max_leaves])),
        "max_depth": int(rng.integers(6, 14)),
        "colsample": float(rng.uniform(0.3, 0.9)),
    }


def random_search(
    ds: TabularDataset,
    *,
    kind: str = "gbdt",
    n_trials: int = 20,
    hw: HWConstraints | None = None,
    seed: int = 0,
) -> SearchResult:
    """Seeded random search; scores on the VALIDATION split; refits the
    winner and returns it ready for CAM compilation."""
    hw = hw or HWConstraints()
    rng = np.random.default_rng(seed)
    quant = FeatureQuantizer.fit(ds.x_train, hw.n_bins)
    xb_tr = quant.transform(ds.x_train)
    xb_va = quant.transform(ds.x_valid)

    trials: list[Trial] = []
    best: Trial | None = None
    best_ens: Ensemble | None = None
    for t in range(n_trials):
        if kind == "gbdt":
            p = _sample_gbdt(rng, hw, ds.n_classes)
            ens = train_gbdt(
                xb_tr, ds.y_train, task=ds.task, n_bins=hw.n_bins,
                n_classes=ds.n_classes, params=GBDTParams(seed=seed + t, **p),
            )
        else:
            p = _sample_rf(rng, hw)
            ens = train_rf(
                xb_tr, ds.y_train, task=ds.task, n_bins=hw.n_bins,
                n_classes=ds.n_classes, params=RFParams(seed=seed + t, **p),
            )
        assert ens.n_trees <= hw.max_trees and ens.max_leaves <= hw.max_leaves
        score = accuracy_metric(ds.task, ds.y_valid, ens.predict(xb_va))
        trial = Trial(params=p, valid_score=score, n_trees=ens.n_trees,
                      max_leaves=ens.max_leaves)
        trials.append(trial)
        if best is None or score > best.valid_score:
            best, best_ens = trial, ens
    return SearchResult(best=best, trials=trials, ensemble=best_ens,
                        quantizer=quant)



# ---------------------------------------------------------------------------
# Kernel execution autotuner (DESIGN.md §10)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TunePlan:
    """The winning kernel configuration(s) of one ``autotune_kernel`` sweep.

    Serializes into the compiled-artifact sidecar (``CompiledModel.save``
    under the ``"tuning"`` key) in the JAX package's schema, so either
    package loads the other's plans.  ``dispatch`` holds one measured-cost
    entry per swept batch bucket — ``{"batch", "b_blk", "r_blk",
    "table_dtype", "mode", "kernel", "us_per_call"}``; ``dispatch_for(batch)``
    resolves a serving batch to its bucket's winner and ``apply(config,
    batch=...)`` folds it in.  The top-level fields are the PRIMARY-batch
    winner, so v1 plans load (empty dispatch).  ``env`` names where the
    sweep ran (``_tune_env``).
    """

    b_blk: int
    r_blk: int
    table_dtype: str  # resolved dtype ('uint8'/'uint16'/'int32'/'float32'), not 'auto'
    mode: str
    backend: str
    us_per_call: float
    batch: int
    trials: list[dict] = field(default_factory=list)  # full sweep record
    env: dict = field(default_factory=dict)  # platform the sweep ran on
    dispatch: list[dict] = field(default_factory=list)  # per-batch winners (v2)
    schema_version: int = TUNE_SCHEMA_VERSION

    @property
    def kernel(self) -> str:
        """Kernel version the primary winner binds ('v1' | 'v2' | 'soft')."""
        return kernel_version(self.table_dtype)

    def timed_on(self, device_type: str) -> bool:
        """Whether the port timed this plan on a device of ``device_type``
        ('cuda' | 'cpu'): its ``env`` names torch and that platform.  A
        plan timed by the JAX package, or on the other device type,
        measured other kernels."""
        return "torch" in self.env and self.env.get("platform") == device_type

    def dispatch_for(self, batch: int) -> dict:
        """The measured winner for a serving ``batch``: the SMALLEST swept
        bucket that covers it (a larger batch than every bucket takes the
        largest — its measurement is the closest regime).  Plans without
        a dispatch table (schema v1) fall back to the top-level winner as
        a synthesized single-bucket entry."""
        entries = sorted(self.dispatch, key=lambda e: int(e["batch"]))
        for e in entries:
            if batch <= int(e["batch"]):
                return e
        if entries:
            return entries[-1]
        return {
            "batch": self.batch, "b_blk": self.b_blk, "r_blk": self.r_blk,
            "table_dtype": self.table_dtype, "mode": self.mode,
            "kernel": self.kernel, "us_per_call": self.us_per_call,
        }

    def apply(self, config: DeployConfig, batch: int | None = None) -> DeployConfig:
        """Fold the winner into ``config`` (the tuned execution knobs).

        With ``batch`` the dispatch table picks the bucket winner; without
        it the primary top-level winner applies (v1 behavior)."""
        if batch is None:
            return config.replace(
                b_blk=self.b_blk,
                r_blk=self.r_blk,
                table_dtype=self.table_dtype,
                mode=self.mode,
                backend=self.backend,
            )
        e = self.dispatch_for(batch)
        return config.replace(
            b_blk=int(e["b_blk"]),
            r_blk=int(e["r_blk"]),
            table_dtype=str(e["table_dtype"]),
            mode=str(e["mode"]),
            backend=self.backend,
        )

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TunePlan":
        known = {f.name for f in cls.__dataclass_fields__.values()}  # type: ignore[attr-defined]
        return cls(**{k: v for k, v in d.items() if k in known})


def _tune_env(device: torch.device) -> dict:
    """Where a sweep ran: the device type ('cuda' | 'cpu'), the number of
    such devices, the torch version and the device's name."""
    if device.type == "cuda":
        n, name = torch.cuda.device_count(), torch.cuda.get_device_name(device)
    else:
        n, name = 1, "cpu"
    return {"platform": device.type, "n_devices": n, "torch": torch.__version__,
            "device_name": name}


def _time_margin(engine, q: np.ndarray, *, warmup: int, iters: int) -> float:
    """Median microseconds of one whole ``engine.raw_margin(q)`` call, the
    copy of ``q`` to the device and of the margins back to the host
    included.  On the card each call is timed with CUDA events on the
    current stream, the end event recorded after the copy back; on the CPU
    with ``time.perf_counter``."""
    for _ in range(warmup):
        engine.raw_margin(q).cpu()
    times = []
    if engine.device.type == "cuda":
        stream = torch.cuda.current_stream(engine.device)
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            engine.raw_margin(q).cpu()
            end.record(stream)
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            engine.raw_margin(q).cpu()
            times.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(times))


def autotune_kernel(
    model,
    *,
    device=None,
    deploy: DeployConfig | None = None,
    batch: int = 256,
    batches: tuple[int, ...] = (),
    b_blks: tuple[int, ...] = (64, 128, 256),
    r_blks: tuple[int, ...] = (128, 256, 512),
    table_dtypes: tuple[str, ...] | None = None,
    modes: tuple[str, ...] | None = None,
    warmup: int = 1,
    iters: int = 3,
    seed: int = 0,
) -> TunePlan:
    """Sweep the kernel execution space on ``device``; return the plan.

    ``model`` is a ``CAMTable`` or a ``repro_torch.api.CompiledModel``
    (whose own deploy config seeds the sweep unless ``deploy`` overrides
    it).  ``device`` is where the candidates run: ``None`` is the card
    (raises where there is none), ``"cpu"`` the plain version.  Candidates
    are the cross product of ``b_blks`` × ``r_blks`` × the admissible
    (table_dtype, mode) pairs, deduplicated by their RESOLVED kernel layout
    — 'direct' and 'inclusive' collapse onto the packed-inclusive kernel,
    and the faithful modes only ever run int32 — exactly as the JAX
    package enumerates them.  Every candidate computes the same bits, so
    the sweep is purely a performance search.

    ``batches`` adds batch buckets beyond the primary ``batch``: every
    candidate is timed at every bucket (``_time_margin``) and the
    per-bucket winners (first of equal times) become the plan's DISPATCH
    table; the top-level winner is the primary-``batch`` one.  Candidates
    whose padded table is the same share one engine, bound at its first
    candidate and freed when the sweep ends; each candidate is timed
    through a view of it that carries the candidate's own config.
    """
    from repro_torch.core.engine import XTimeEngine, resolve_device, resolve_table_dtype

    if isinstance(model, CAMTable):
        table = model
    else:  # CompiledModel — avoid importing repro_torch.api here (cycle)
        table = model.table
        if deploy is None:
            deploy = getattr(model, "deploy", None)
    deploy = deploy or DeployConfig()
    dev = resolve_device(device)

    if modes is None:
        # dtype-pinned modes (the faithful macro-cell modes, 'soft') are a
        # deliberate semantic choice — keep them; the packable fast modes
        # sweep both int-compare flavours
        modes = ("direct", "inclusive") if get_cell_mode(deploy.mode).packable \
            else (deploy.mode,)
    if table_dtypes is None:
        table_dtypes = ("auto", "int32")

    seen: set[tuple] = set()
    candidates: list[tuple[DeployConfig, tuple]] = []
    for mode in modes:
        policy = get_cell_mode(mode).table_dtype_policy
        for dt in table_dtypes:
            if policy is not None and dt not in ("auto", policy):
                continue
            cfg = deploy.replace(mode=mode, table_dtype=dt)
            resolved = resolve_table_dtype(table, cfg)
            kernel_mode = (
                "inclusive" if np.dtype(resolved).kind == "u" else mode
            )
            for b_blk in b_blks:
                for r_blk in r_blks:
                    key = (b_blk, r_blk, resolved, kernel_mode)
                    if key in seen:
                        continue
                    seen.add(key)
                    r_pad = -(-table.n_rows // r_blk) * r_blk
                    candidates.append((
                        cfg.replace(b_blk=b_blk, r_blk=r_blk, table_dtype=resolved),
                        (resolved, kernel_mode, r_pad),
                    ))

    buckets = sorted({int(batch), *(int(b) for b in batches)})
    rng = np.random.default_rng(seed)
    # one query pool sized for the largest bucket; each bucket slices a
    # prefix so every candidate sees identical inputs per bucket
    q_pool = rng.integers(0, table.n_bins, size=(max(buckets), table.n_features))
    trials: list[dict] = []
    best: dict[int, tuple[float, DeployConfig]] = {}
    engines: dict[tuple, XTimeEngine] = {}
    engine = None
    try:
        for cfg, layout in candidates:
            if layout not in engines:
                engines[layout] = XTimeEngine.from_config(table, cfg, device=dev)
            engine = copy.copy(engines[layout])
            engine.config, engine.mode = cfg, cfg.mode
            engine.b_blk, engine.r_blk = cfg.b_blk, cfg.r_blk
            for b in buckets:
                us = _time_margin(engine, q_pool[:b], warmup=warmup, iters=iters)
                trials.append({
                    "batch": b, "b_blk": cfg.b_blk, "r_blk": cfg.r_blk,
                    "table_dtype": cfg.table_dtype, "mode": cfg.mode,
                    "kernel": kernel_version(cfg.table_dtype),
                    "us_per_call": round(us, 2),
                })
                if b not in best or us < best[b][0]:
                    best[b] = (us, cfg)
    finally:
        engines.clear()
        engine = None  # the last view holds the tables too
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    if not best:
        raise ValueError("empty autotune candidate set")
    dispatch = [
        {
            "batch": b, "b_blk": c.b_blk, "r_blk": c.r_blk,
            "table_dtype": c.table_dtype, "mode": c.mode,
            "kernel": kernel_version(c.table_dtype),
            "us_per_call": round(u, 2),
        }
        for b, (u, c) in sorted(best.items())
    ]
    us, cfg = best[int(batch)]
    return TunePlan(
        b_blk=cfg.b_blk,
        r_blk=cfg.r_blk,
        table_dtype=cfg.table_dtype,
        mode=cfg.mode,
        backend=cfg.backend,
        us_per_call=round(us, 2),
        batch=batch,
        trials=trials,
        env=_tune_env(dev),
        dispatch=dispatch,
    )
