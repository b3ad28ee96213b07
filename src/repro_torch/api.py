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
Not ported yet (ROADMAP.md): compression levels other than 'off', the
ingestion frontend, tuning plans (carried through save/load, not
applied), meshes.
"""

from __future__ import annotations

import dataclasses
import json
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
      ingest / tuning / compression: sidecar provenance of the JAX
        package's ingestion, autotune and compression passes, carried
        through save/load unchanged.
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
        # per-instance engine cache (frozen dataclass => set via object)
        object.__setattr__(self, "_engines", {})

    @property
    def chip(self) -> ChipSpec:
        return self.placement.spec

    # -- execution binding ---------------------------------------------------

    def resolved_deploy(self, **overrides) -> DeployConfig:
        """The effective config an engine binds: ``overrides`` applied,
        then 'auto' noc_config resolved from the compiled NoC plan
        ('batch' degrades to 'accumulate' on one device) and 'auto' spmd
        to 'gspmd' (no mesh)."""
        for knob in ("batching", "compress"):
            if knob in overrides:
                raise ValueError(
                    f"{knob!r} is fixed at build time; rebuild the artifact "
                    "to change it"
                )
        cfg = self.deploy.replace(**overrides) if overrides else self.deploy
        if cfg.noc_config == "auto":
            noc_cfg = self.noc.engine_noc_config
            cfg = cfg.replace(noc_config="accumulate" if noc_cfg == "batch" else noc_cfg)
        if cfg.spmd == "auto":
            cfg = cfg.replace(spmd="gspmd")
        return cfg

    def engine(self, device=None, **overrides) -> "XTimeEngine":
        """Lazily bind this artifact to an ``XTimeEngine`` on ``device``
        (``None``: the card).  Repeated calls with the same device and
        overrides return the same engine."""
        from repro_torch.core.engine import XTimeEngine, resolve_device

        dev = resolve_device(device)
        key = (str(dev), tuple(sorted(overrides.items())))
        cached = self._engines.get(key)
        if cached is None:
            cached = XTimeEngine.from_config(
                self.table, self.resolved_deploy(**overrides), device=dev
            )
            self._engines[key] = cached
        return cached

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
        return_uncertainty: bool = False,
        **overrides,
    ) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
        """Final predictions for a batch of float (or pre-binned) rows:
        ``(B,)`` int32 class ids, or float32 values for regression.

        With ``return_uncertainty=True`` (soft cell mode only — DESIGN.md
        §15) returns ``(pred, unc)``, ``unc`` the ``(B,)`` leaf-spread
        uncertainty at each row's predicted channel (one more kernel
        launch, over the moments matrix)."""
        q = self._binned(x, "predict")
        eng = self.engine(device, **overrides)
        if return_uncertainty and eng.kernel_mode != "soft":
            raise ValueError(
                "predict(return_uncertainty=True) requires cell_mode="
                f"'soft' (this binding runs mode={eng.mode!r}); build or "
                "bind with DeployConfig(mode='soft')"
            )
        pred = eng.predict(q).cpu().numpy()
        if not return_uncertainty:
            return pred
        u = eng.uncertainty(q).cpu().numpy()
        if self.table.task == "regression" or self.table.n_outputs == 1:
            unc = u[:, 0]
        else:  # the spread behind the channel that won the argmax
            unc = u[np.arange(pred.shape[0]), pred.astype(np.int64)]
        return pred, unc

    def predict_proba(self, x: np.ndarray, *, device=None, **overrides) -> np.ndarray:
        """Class probabilities for a batch of float (or pre-binned) rows.

        Soft cell mode only: binary single-logit models return ``(B, 2)``
        ``[1-p, p]`` via the sigmoid, multiclass models ``(B, n_classes)``
        via the softmax, both in float64 on the host.  Hard modes and
        regression raise."""
        q = self._binned(x, "predict_proba")
        eng = self.engine(device, **overrides)
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

    def raw_margin(self, x: np.ndarray, *, device=None, **overrides) -> np.ndarray:
        """Raw ``(B, n_outputs)`` float32 margins for float (or pre-binned)
        rows."""
        q = self._binned(x, "raw_margin")
        return self.engine(device, **overrides).raw_margin(q).cpu().numpy()


def _base_path(path: str | Path) -> Path:
    p = Path(path)
    if p.suffix in (".npz", ".json"):
        return p.parent / p.name[: -len(p.suffix)]
    return p


def _sibling(base: Path, suffix: str) -> Path:
    # not ``with_suffix``: a dotted base like 'churn.8bit' must keep its dot
    return base.parent / (base.name + suffix)


def build(
    model: Ensemble | CAMTable,
    *,
    deploy: DeployConfig | None = None,
    chip: ChipSpec | None = None,
    quantizer: FeatureQuantizer | None = None,
    compress: str | None = None,
    cluster_columns: bool = False,
) -> CompiledModel:
    """Compile ``model`` (an ``Ensemble`` or a pre-compiled ``CAMTable``)
    into a ``CompiledModel`` — the same tables, placement, NoC plan and
    perf report as ``repro.api.build`` on the same model.

    ``cluster_columns`` moves all-wildcard feature columns into trailing
    tiles (``order_columns_by_activity``, recorded on ``col_perm``).
    Only ``compress='off'`` is ported; the compression pass and the
    ingestion frontend (dump paths, imported ensembles) are later slices
    (ROADMAP.md).
    """
    deploy = deploy or DeployConfig()
    level = deploy.compress if compress is None else compress
    if level != "off":
        raise NotImplementedError(
            f"compress={level!r}: table compression is not ported yet "
            "(ROADMAP.md, 'compression and ingest copies'); build with "
            "compress='off', or load an artifact the JAX package compressed"
        )
    if not isinstance(model, (Ensemble, CAMTable)):
        raise TypeError(
            "build() takes an Ensemble or CAMTable; the ingestion frontend "
            "is not ported yet (ROADMAP.md, 'compression and ingest "
            f"copies'), got {type(model).__name__}"
        )
    table = model if isinstance(model, CAMTable) else compile_ensemble(model)
    if cluster_columns:
        table = order_columns_by_activity(table, f_blk=deploy.f_blk)
    placement = pack_cores(table, chip)
    noc = plan_noc(table, placement, batching=deploy.batching)
    perf = xtime_perf(table, placement, noc)
    return CompiledModel(
        table=table, placement=placement, noc=noc, perf=perf, deploy=deploy,
        quantizer=quantizer,
    )
