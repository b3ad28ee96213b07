"""Compiled-artifact API: ``build()`` -> portable ``CompiledModel``.

The port's counterpart of ``repro.api``:

    cm = repro_torch.build(ensemble)            # or a pre-compiled CAMTable
    cm.save("artifacts/churn")                  # churn.npz + churn.json
    cm = CompiledModel.load("artifacts/churn")  # also loads repro's artifacts
    pred = cm.predict(x)                        # on the card
    pred = cm.predict(x, device="cpu")          # the plain PyTorch version

    soft = repro_torch.build(ensemble, deploy=DeployConfig(mode="soft", tau=0.1))
    p = soft.predict_proba(x)                   # (B, n_classes) probabilities
    pred, unc = soft.predict(x, return_uncertainty=True)

Artifacts are the JAX package's format byte for byte (the same ``.npz``
arrays and the same JSON sidecar), so either package loads what the other
saved; ``repro_torch.convert`` assembles the port's objects from them.
``engine()`` binds an artifact once per (device or mesh, resolved
``DeployConfig``), under a lock, so serving replicas that bind at once
share one engine.
Models come in as a native or trained ``Ensemble``, a pre-compiled
``CAMTable``, an ``ImportedEnsemble`` or a path to a model dump (XGBoost
JSON, LightGBM text, sklearn-forest dict), and ``compress=`` runs the
table compression pass ('prune', 'merge', 'full' or 'auto'):

    cm = repro_torch.build("model.json", compress="auto")
    pred = cm.predict(x_float)                  # binned by the ingested grid

A kernel autotune (``repro_torch.core.tune.autotune_kernel``) folds into
the artifact with ``with_tuning`` and rides the sidecar; ``predict``,
``predict_proba``, ``raw_margin`` and ``engine(batch_hint=)`` then bind the
measured winner of the batch's bucket — for plans the port timed itself on
the engine's device type, and for no other plan:

    plan = autotune_kernel(cm, batch=256, batches=(1, 16, 1024))
    tuned = cm.with_tuning(plan)                # knobs folded into deploy

On a mesh of devices (``repro_torch.launch.mesh``) the same calls run the
compiled NoC program as a shard program (DESIGN.md §8):

    mesh = make_host_mesh(2, 4, devices=["cuda:0"] * 8)  # logical shards
    pred = cm.predict(x, mesh=mesh)             # == cm.predict(x), bit for bit
"""

from __future__ import annotations

import dataclasses
import json
import threading
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from repro_torch.core.compile import (
    CAMTable,
    ChipSpec,
    CorePlacement,
    compile_ensemble,
    order_columns_by_activity,
    pack_cores,
)
from repro_torch.core.compress import compress_table, resolve_level
from repro_torch.core.deploy import DeployConfig
from repro_torch.core.noc import NoCPlan, plan_noc
from repro_torch.core.perfmodel import PerfReport, xtime_perf
from repro_torch.core.quantize import FeatureQuantizer
from repro_torch.core.trees import Ensemble

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.engine import XTimeEngine

# the artifact schema of repro.api (see there for what each version adds)
SCHEMA_VERSION = 3
SUPPORTED_SCHEMAS = (1, 2, 3)
FORMAT = "xtime-compiled-model"

# the CAMTable arrays stored in the .npz payload
TABLE_ARRAYS = ("low", "high", "leaf", "tree_id", "class_id")
TABLE_META = (
    "n_trees", "n_features", "n_bins", "n_outputs",
    "task", "kind", "base_score", "n_classes", "table_dtype",
)


@dataclass(frozen=True, eq=False)
class CompiledModel:
    """Immutable compiled artifact: everything between training and serving.

    Attributes:
      table: the compiled CAM rows (one per root-to-leaf path).
      placement: tree -> core packing on the chip (``pack_cores``).
      noc: H-tree router program + collective plan (``plan_noc``).
      perf: analytic chip numbers for this exact mapping (``xtime_perf``).
      deploy: execution knobs; ``engine()`` binds them to a device.
      quantizer: the float -> bin grid, when the artifact carries one.
      ingest / compression: the lowering report of an ingested dump and
        the compression pass's report (``build`` fills both).
      tuning: the serialized ``TunePlan`` whose primary winner is
        folded into ``deploy`` (``with_tuning``), carried through
        save/load unchanged; its dispatch applies where the port timed it
        (``resolved_deploy``).
    """

    table: CAMTable
    placement: CorePlacement
    noc: NoCPlan
    perf: PerfReport
    deploy: DeployConfig
    quantizer: "FeatureQuantizer | None" = None
    ingest: dict | None = None
    tuning: dict | None = None
    compression: dict | None = None

    def __post_init__(self) -> None:
        # per-instance engine cache and the lock its binds run under
        # (frozen dataclass => set via object)
        object.__setattr__(self, "_engines", {})
        object.__setattr__(self, "_engine_lock", threading.Lock())
        object.__setattr__(self, "_warned_foreign_plan", False)

    @property
    def chip(self) -> ChipSpec:
        return self.placement.spec

    # -- execution binding ---------------------------------------------------

    def resolved_deploy(self, batch_hint=None, *, device=None, mesh=None,
                        **overrides) -> DeployConfig:
        """The effective config an engine on ``device`` (or ``mesh``) binds:
        the tuned dispatch entry for ``batch_hint`` folded in first, then
        ``overrides`` (explicit knobs outrank the dispatch), then 'auto'
        noc_config resolved from the compiled NoC plan ('batch' degrades
        to 'accumulate' without a mesh to replicate over) and 'auto' spmd
        from the mesh ('shard_map' on a mesh, 'gspmd' without one).

        The dispatch applies only for a plan the port timed itself on the
        device's type (``TunePlan.timed_on``).  A foreign plan — the JAX
        package's, or one timed on the other device type — measured other
        kernels: its primary winner is already in ``deploy``
        (``with_tuning``), and a hint then binds that, with one
        ``UserWarning`` per artifact naming the plan's platform."""
        for knob in ("batching", "compress"):
            if knob in overrides:
                raise ValueError(
                    f"{knob!r} is fixed at build time; rebuild the artifact "
                    "to change it"
                )
        cfg = self.deploy
        if batch_hint is not None and self.tuning is not None:
            from repro_torch.core.engine import resolve_device

            dev = mesh.devices.flat[0] if mesh is not None else resolve_device(device)
            plan, dev_type = self.tune_plan(), dev.type
            if plan.timed_on(dev_type):
                cfg = plan.apply(cfg, batch=int(batch_hint))
            elif not self._warned_foreign_plan:
                object.__setattr__(self, "_warned_foreign_plan", True)
                by = "torch" if "torch" in plan.env else "jax" if "jax" in plan.env else "?"
                warnings.warn(
                    f"the artifact's tuning plan was timed on platform "
                    f"{plan.env.get('platform')!r} ({by}), not by this package on "
                    f"{dev_type!r}: its per-batch dispatch is not applied and the "
                    "primary winner in deploy binds; re-run autotune_kernel to "
                    "tune for this device",
                    UserWarning,
                    stacklevel=3,
                )
        if overrides:
            cfg = cfg.replace(**overrides)
        if cfg.noc_config == "auto":
            noc_cfg = self.noc.engine_noc_config
            if noc_cfg == "batch" and mesh is None:
                noc_cfg = "accumulate"
            cfg = cfg.replace(noc_config=noc_cfg)
        if cfg.spmd == "auto":
            cfg = cfg.replace(spmd="gspmd" if mesh is None else "shard_map")
        return cfg

    def engine(self, device=None, *, mesh=None, batch_hint=None, **overrides) -> "XTimeEngine":
        """Lazily bind this artifact to an ``XTimeEngine`` on ``device``
        (``None``: the card) or on ``mesh`` (a
        ``repro_torch.launch.mesh.Mesh``; the two are exclusive).  Engines
        are cached per (mesh or device, resolved ``DeployConfig``) — a mesh
        by its value, so equal meshes share one engine: calls that resolve
        to the same configuration return the same engine, and concurrent
        first calls bind it once (the others wait for it).

        ``batch_hint`` engages a tuned artifact's DISPATCH table: the
        engine binds the measured winner of that batch's bucket
        (``TunePlan.dispatch_for``) when the port timed the plan on this
        device type (see ``resolved_deploy``).  Buckets whose winners are
        the same configuration share one engine, and so one copy of the
        table on the device — the JAX package keys its cache on the bucket
        instead; both bind the same bits."""
        from repro_torch.core.engine import XTimeEngine, resolve_device
        from repro_torch.launch.mesh import check_mesh

        if mesh is not None:
            dev, where = None, check_mesh(mesh)
            if device is not None:
                raise ValueError("pass device= or mesh=, not both")
        else:
            dev = resolve_device(device)
            where = str(dev)
        cfg = self.resolved_deploy(batch_hint, device=dev, mesh=mesh, **overrides)
        key = (where, cfg)
        with self._engine_lock:
            cached = self._engines.get(key)
            if cached is None:
                cached = XTimeEngine.from_config(self.table, cfg, device=dev, mesh=mesh)
                self._engines[key] = cached
        return cached

    def with_deploy(self, deploy: DeployConfig) -> "CompiledModel":
        """Same compiled tables, different execution config.

        Only the cheap chip-side plans are recomputed, and only when
        ``batching`` changed (it alters the router program) — the CAM
        table and core placement are reused as-is, never recompiled.
        ``deploy.compress`` is pinned to this artifact's actual level.
        An unchanged config returns this very artifact, engines and all.
        """
        if deploy.compress != self.deploy.compress:
            deploy = deploy.replace(compress=self.deploy.compress)
        if deploy == self.deploy:
            return self
        if deploy.batching == self.deploy.batching:
            return dataclasses.replace(self, deploy=deploy)
        noc = plan_noc(self.table, self.placement, batching=deploy.batching)
        perf = xtime_perf(self.table, self.placement, noc)
        return dataclasses.replace(self, noc=noc, perf=perf, deploy=deploy)

    def with_tuning(self, plan) -> "CompiledModel":
        """Fold an ``autotune_kernel`` winner into the artifact.

        The plan's knobs (b_blk/r_blk/table_dtype/mode/backend) replace
        the deploy config's, and the full plan rides the sidecar so
        reloaded artifacts — and ``TableRegistry`` cold starts — bind
        engines in the tuned configuration without re-searching.
        """
        tuned = self.with_deploy(plan.apply(self.deploy))
        return dataclasses.replace(tuned, tuning=plan.to_dict())

    def tune_plan(self):
        """The persisted ``TunePlan`` (None when never autotuned)."""
        if self.tuning is None:
            return None
        from repro_torch.core.tune import TunePlan  # lazy: keeps load light

        return TunePlan.from_dict(self.tuning)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str | Path) -> Path:
        """Write ``<base>.npz`` (tables) + ``<base>.json`` (sidecar) in the
        JAX package's format.  Returns the sidecar path."""
        from repro_torch.convert import to_state

        base = _base_path(path)
        base.parent.mkdir(parents=True, exist_ok=True)
        arrays, sidecar = to_state(self)
        np.savez_compressed(_sibling(base, ".npz"), **arrays)
        out = _sibling(base, ".json")
        out.write_text(json.dumps(sidecar, indent=1))
        return out

    @classmethod
    def load(cls, path: str | Path) -> "CompiledModel":
        """Reconstruct an artifact saved by either package."""
        from repro_torch.convert import from_state

        base = _base_path(path)
        sidecar = json.loads(_sibling(base, ".json").read_text())
        with np.load(_sibling(base, ".npz")) as npz:
            arrays = {name: npz[name] for name in npz.files}
        return from_state(arrays, sidecar, source=str(base))

    # -- float-in serving ----------------------------------------------------

    def _binned(self, x: np.ndarray, caller: str) -> np.ndarray:
        """Float queries -> the integer bins this artifact's tables index;
        already-binned integer queries pass through untouched."""
        x = np.asarray(x)
        if x.dtype.kind in "iu":
            return x
        if self.quantizer is None:
            raise ValueError(
                f"{caller} got float queries but this artifact has no "
                "feature grid attached; build with quantizer=..., or pass "
                "already-binned integer queries"
            )
        return self.quantizer.transform(x)

    def predict(
        self,
        x: np.ndarray,
        *,
        device=None,
        mesh=None,
        return_uncertainty: bool = False,
        **overrides,
    ) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
        """Final predictions for a batch of float (or pre-binned) rows:
        ``(B,)`` int32 class ids, or float32 values for regression, on
        ``device`` or on ``mesh``.

        With ``return_uncertainty=True`` (soft cell mode only — DESIGN.md
        §15) returns ``(pred, unc)``, ``unc`` the ``(B,)`` leaf-spread
        uncertainty at each row's predicted channel: on one card both come
        from one kernel launch over the moments matrix
        (``XTimeEngine.margin_and_moments``), bit-equal to ``predict`` and
        ``uncertainty`` called apart."""
        q = self._binned(x, "predict")
        eng = self.engine(device, mesh=mesh, batch_hint=q.shape[0], **overrides)
        if return_uncertainty and eng.kernel_mode != "soft":
            raise ValueError(
                "predict(return_uncertainty=True) requires cell_mode="
                f"'soft' (this binding runs mode={eng.mode!r}); build or "
                "bind with DeployConfig(mode='soft')"
            )
        if not return_uncertainty:
            return eng.predict(q).cpu().numpy()
        margin, moments = eng.margin_and_moments(q)
        pred = eng._predict_from_margin(margin).cpu().numpy()
        u = eng.uncertainty_from_moments(moments).numpy()
        if self.table.task == "regression" or self.table.n_outputs == 1:
            unc = u[:, 0]
        else:  # the spread behind the channel that won the argmax
            unc = u[np.arange(pred.shape[0]), pred.astype(np.int64)]
        return pred, unc

    def predict_proba(self, x: np.ndarray, *, device=None, mesh=None,
                      **overrides) -> np.ndarray:
        """Class probabilities for a batch of float (or pre-binned) rows.

        Soft cell mode only: binary single-logit models return ``(B, 2)``
        ``[1-p, p]`` via the sigmoid, multiclass models ``(B, n_classes)``
        via the softmax, both in float64 on the host.  Hard modes and
        regression raise."""
        q = self._binned(x, "predict_proba")
        eng = self.engine(device, mesh=mesh, batch_hint=q.shape[0], **overrides)
        if eng.kernel_mode != "soft":
            raise ValueError(
                "predict_proba requires cell_mode='soft' (this binding "
                f"runs mode={eng.mode!r}); build or bind with "
                "DeployConfig(mode='soft')"
            )
        if self.table.task == "regression":
            raise ValueError(
                "predict_proba is undefined for regression models; use "
                "predict(x, return_uncertainty=True) for a value with an "
                "uncertainty channel"
            )
        m = eng.raw_margin(q).cpu().numpy().astype(np.float64)
        if self.table.n_outputs == 1:  # single-logit binary
            p = 1.0 / (1.0 + np.exp(-m[:, 0]))
            return np.stack([1.0 - p, p], axis=1).astype(np.float32)
        z = m - m.max(axis=1, keepdims=True)
        e = np.exp(z)
        return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)

    def raw_margin(self, x: np.ndarray, *, device=None, mesh=None,
                   **overrides) -> np.ndarray:
        """Raw ``(B, n_outputs)`` float32 margins for float (or pre-binned)
        rows."""
        q = self._binned(x, "raw_margin")
        eng = self.engine(device, mesh=mesh, batch_hint=q.shape[0], **overrides)
        return eng.raw_margin(q).cpu().numpy()

    def bin(self, x: np.ndarray) -> np.ndarray:
        """Deprecated: float queries -> integer bins.  Call :meth:`predict`
        / :meth:`raw_margin` directly (they bin internally), or
        ``model.quantizer.transform(x)`` when only the bins are wanted."""
        warnings.warn(
            "CompiledModel.bin() is deprecated: call model.predict(x) / "
            "model.raw_margin(x) directly (they bin float queries "
            "internally), or model.quantizer.transform(x) for bare bins",
            DeprecationWarning,
            stacklevel=2,
        )
        if self.quantizer is None:
            raise ValueError(
                "this artifact has no feature grid attached; bin queries "
                "with the FeatureQuantizer the model was trained on"
            )
        return self.quantizer.transform(np.asarray(x))

    # -- introspection -------------------------------------------------------

    def summary(self) -> dict:
        """Human-facing one-stop description (examples / logs)."""
        return {
            "rows": self.table.n_rows,
            "features": self.table.n_features,
            "columns": self.table.n_cols,
            "compress": self.deploy.compress,
            "rows_saved": (
                0 if self.compression is None
                else int(self.compression.get("rows_saved", 0))
            ),
            "trees": self.table.n_trees,
            "outputs": self.table.n_outputs,
            "task": self.table.task,
            "cores_used": self.placement.n_cores_used,
            "replication": self.placement.replication,
            "noc": self.noc.config,
            "latency_ns": round(self.perf.latency_ns, 1),
            "throughput_msps": round(self.perf.throughput_msps, 2),
            "backend": self.deploy.backend,
            "mode": self.deploy.mode,
            "table_dtype": self.table.table_dtype,
            "tuned": self.tuning is not None,
        }


def _base_path(path: str | Path) -> Path:
    p = Path(path)
    if p.suffix in (".npz", ".json"):
        return p.parent / p.name[: -len(p.suffix)]
    return p


def _sibling(base: Path, suffix: str) -> Path:
    # not ``with_suffix``: a dotted base like 'churn.8bit' must keep its dot
    return base.parent / (base.name + suffix)


def build(
    model,
    *,
    deploy: DeployConfig | None = None,
    chip: ChipSpec | None = None,
    n_bins: int = 256,
    on_overflow: str = "merge",
    quantizer: FeatureQuantizer | None = None,
    compress: str | None = None,
    cluster_columns: bool = False,
) -> CompiledModel:
    """Compile ``model`` into a ``CompiledModel`` — the same tables,
    placement, NoC plan, perf report and sidecar as ``repro.api.build`` on
    the same model.

    ``model`` may be a native ``Ensemble``, a pre-compiled ``CAMTable``,
    an ``ImportedEnsemble`` or a path to a model dump (XGBoost JSON /
    LightGBM text / sklearn-forest dict).  The last two run the ingestion
    frontend: the model is lowered onto an ``n_bins`` threshold grid built
    from its own split points (``on_overflow`` governs grids that don't
    fit), and the artifact carries the grid and the lowering report.
    ``quantizer`` attaches a float->bin grid to a natively trained model.

    ``compress`` (or ``deploy.compress``; the explicit argument wins) runs
    the compression pass between compile and packing: 'prune', 'merge',
    'full' or 'auto' (= 'full'), keyed on the artifact's own grid; the
    ``CompressionReport`` rides the sidecar, and placement, the NoC plan
    and the perf report are computed on the compressed shapes.

    ``cluster_columns`` moves all-wildcard feature columns into trailing
    tiles after compression (``order_columns_by_activity``, recorded on
    ``col_perm``).
    """
    deploy = deploy or DeployConfig()
    level = resolve_level(deploy.compress if compress is None else compress)
    deploy = deploy.replace(compress=level)
    ingest_report = None
    if not isinstance(model, (Ensemble, CAMTable)):
        # the parsers load only when a dump or an imported model comes in
        from repro_torch.ingest import ImportedEnsemble, load_model, lower_to_ensemble

        if isinstance(model, (str, Path)):
            model = load_model(model)
        if not isinstance(model, ImportedEnsemble):
            raise TypeError(
                "build() takes an Ensemble, CAMTable, ImportedEnsemble or "
                f"dump path, got {type(model).__name__}"
            )
        model, quantizer, report = lower_to_ensemble(
            model, n_bins=n_bins, on_overflow=on_overflow
        )
        ingest_report = report.to_dict()
    table = model if isinstance(model, CAMTable) else compile_ensemble(model)
    compression = None
    if level != "off":
        table, creport = compress_table(table, quantizer, level=level)
        compression = creport.to_dict()
    if cluster_columns:
        table = order_columns_by_activity(table, f_blk=deploy.f_blk)
    placement = pack_cores(table, chip)
    noc = plan_noc(table, placement, batching=deploy.batching)
    perf = xtime_perf(table, placement, noc)
    return CompiledModel(
        table=table, placement=placement, noc=noc, perf=perf, deploy=deploy,
        quantizer=quantizer, ingest=ingest_report, compression=compression,
    )
