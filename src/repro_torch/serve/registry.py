"""Multi-model table registry for the serving engine.

The port of ``repro.serve.registry``.  One serving process holds MANY
compiled models (one per customer table / model version) on one device or
one device mesh.
Each entry is a ``ServedModel`` wrapped around a
``repro_torch.api.CompiledModel`` artifact — the registry accepts a
trained ``Ensemble`` (compiles it), a raw ``CAMTable`` (places it), or a
``CompiledModel`` loaded from disk (the cold-start path: installed as-is,
zero recompilation, no training imports), and binds the artifact's
``DeployConfig`` to the registry's ``device`` (``None``: the card, which
raises where there is none) or its ``mesh``.  On a mesh that binding
resolves ``spmd='auto'`` to the shard program, so a mesh registry serves
it with no caller changes.  The artifact binds each engine once, so
registries that install the same artifact (the cluster's replicas) share
one engine.

Hot swap: re-registering a name atomically replaces its engine and bumps
the version; in-flight flushes keep the old engine object (Python
reference semantics) and the next flush picks up the new table.  Serving
settings (``batching``, the deploy config) carry over across swaps unless
explicitly overridden, so a swap changes the TABLE, not the
configuration.

Thread safety: every registry operation (register/swap/unregister and
all lookups) runs under one re-entrant lock, so the async cluster tier
(``repro_torch.serve.cluster``) can hot-swap from a control thread while
worker threads resolve entries — a reader sees either the old or the
new ``ServedModel``, never a torn one.  ``register`` holds the lock
across its read-modify-write (version bump + settings carry-over), which
serializes concurrent swaps of the same name.
"""

from __future__ import annotations

import threading
import warnings
from dataclasses import dataclass

from repro_torch.api import CompiledModel, build
from repro_torch.core.compile import CAMTable, ChipSpec, CorePlacement
from repro_torch.core.deploy import DeployConfig
from repro_torch.core.engine import XTimeEngine, resolve_device
from repro_torch.core.noc import NoCPlan
from repro_torch.core.perfmodel import PerfReport
from repro_torch.core.trees import Ensemble
from repro_torch.launch.mesh import Mesh, check_mesh


@dataclass
class ServedModel:
    """One registry entry: the live engine around its compiled artifact."""

    name: str
    version: int
    artifact: CompiledModel
    engine: XTimeEngine
    batching: bool = False  # retained across hot swaps
    engine_overrides: dict | None = None  # loose register() kwargs, retained across hot swaps

    # artifact views (kept as properties so the artifact stays the single
    # source of truth; ``entry.table`` etc. remain stable public names)

    @property
    def table(self) -> CAMTable:
        return self.artifact.table

    @property
    def placement(self) -> CorePlacement:
        return self.artifact.placement

    @property
    def noc(self) -> NoCPlan:
        return self.artifact.noc

    @property
    def perf(self) -> PerfReport:
        """Analytic chip numbers for this exact mapping."""
        return self.artifact.perf

    @property
    def deploy(self) -> DeployConfig:
        return self.artifact.deploy

    @property
    def tuning(self) -> dict | None:
        """Persisted autotune plan the engine was cold-started with
        (``repro_torch.core.tune.autotune_kernel`` →
        ``CompiledModel.with_tuning``, or the JAX package's); its primary
        winner is in ``deploy``, and ``TableRegistry.engine_for_batch``
        binds its per-bucket winners where the port timed it.  None when
        the artifact was never autotuned."""
        return self.artifact.tuning

    @property
    def compression(self) -> dict | None:
        """``CompressionReport`` dict of the JAX package's pass that
        produced this table; None for compress='off'.  Hot swaps keep
        each artifact's own report (``with_deploy`` pins ``compress``)."""
        return self.artifact.compression


class TableRegistry:
    """Compile/load, hold and hot-swap named models sharing one device (or
    one mesh: ``mesh=``, exclusive with ``device``; ``device`` is then the
    mesh's first device, where outputs land)."""

    def __init__(
        self,
        *,
        device=None,
        mesh: Mesh | None = None,
        chip_spec: ChipSpec | None = None,
        deploy: DeployConfig | None = None,
        **engine_kwargs,
    ) -> None:
        if engine_kwargs:
            warnings.warn(
                "loose TableRegistry engine kwargs are deprecated; pass "
                "deploy=DeployConfig(...)",
                DeprecationWarning,
                stacklevel=2,
            )
            deploy = (deploy or DeployConfig()).replace(**engine_kwargs)
        self.mesh = None if mesh is None else check_mesh(mesh)
        if mesh is not None and device is not None:
            raise ValueError("pass device= or mesh=, not both")
        self.device = mesh.devices.flat[0] if mesh is not None else resolve_device(device)
        self.chip_spec = chip_spec
        self.deploy = deploy  # None => per-model defaults / artifact config
        self._models: dict[str, ServedModel] = {}
        self._lock = threading.RLock()

    # -- registration --------------------------------------------------------

    def register(
        self,
        name: str,
        model: Ensemble | CAMTable | CompiledModel,
        *,
        batching: bool | None = None,
        deploy: DeployConfig | None = None,
        **engine_overrides,
    ) -> ServedModel:
        """Install ``model`` under ``name`` (compiling only if needed).

        ``Ensemble`` / ``CAMTable`` inputs run the compiler pipeline via
        ``repro_torch.api.build``; a ``CompiledModel`` is installed as-is
        — the serve cold-start path recompiles nothing.  Registering an
        existing name is the hot-swap path: the entry is replaced
        atomically and its version incremented, with the previous
        registration's ``batching``/deploy settings carried over unless
        overridden.

        ``engine_overrides`` (loose ``b_blk=...`` kwargs) are deprecated
        in favor of ``deploy=DeployConfig(...)`` but still honored.
        """
        if engine_overrides:
            warnings.warn(
                "loose register() engine kwargs are deprecated; pass "
                "deploy=DeployConfig(...)",
                DeprecationWarning,
                stacklevel=2,
            )
        with self._lock:
            return self._register_locked(name, model, batching=batching, deploy=deploy,
                                         **engine_overrides)

    def _register_locked(
        self,
        name: str,
        model: Ensemble | CAMTable | CompiledModel,
        *,
        batching: bool | None = None,
        deploy: DeployConfig | None = None,
        **engine_overrides,
    ) -> ServedModel:
        prev = self._models.get(name)
        if prev is not None and deploy is None:
            # carry the previous loose overrides forward — but an explicit
            # deploy= is a full reset, so stale kwargs must not outrank it
            engine_overrides = {**(prev.engine_overrides or {}), **engine_overrides}
        # base config precedence: explicit deploy > carried-over previous
        # registration > the artifact's own config > registry default
        if deploy is not None:
            base = deploy
        elif prev is not None:
            base = prev.deploy
        elif isinstance(model, CompiledModel):
            base = model.deploy
        else:
            base = self.deploy or DeployConfig()
        if batching is None:
            batching = base.batching
        cfg = base.replace(batching=batching, **engine_overrides)

        if isinstance(model, CompiledModel):
            artifact = model.with_deploy(cfg)  # never recompiles the table
        else:
            artifact = build(model, deploy=cfg, chip=self.chip_spec)

        entry = ServedModel(
            name=name,
            version=self.version(name) + 1,
            artifact=artifact,
            engine=self._bind(artifact),
            batching=batching,
            engine_overrides=dict(engine_overrides),
        )
        self._models[name] = entry
        return entry

    def swap(
        self, name: str, model: Ensemble | CAMTable | CompiledModel, **kw
    ) -> ServedModel:
        """Hot-swap: like ``register`` but the name must already exist."""
        with self._lock:
            if name not in self._models:
                raise KeyError(f"cannot swap unknown model {name!r}")
            return self._register_locked(name, model, **kw)

    def unregister(self, name: str) -> None:
        with self._lock:
            try:
                del self._models[name]
            except KeyError:
                raise KeyError(
                    f"unknown model {name!r}; registered: {sorted(self._models)}"
                ) from None

    # -- lookup --------------------------------------------------------------

    def get(self, name: str) -> ServedModel:
        with self._lock:
            try:
                return self._models[name]
            except KeyError:
                raise KeyError(
                    f"unknown model {name!r}; registered: {sorted(self._models)}"
                ) from None

    def engine(self, name: str) -> XTimeEngine:
        return self.get(name).engine

    def engine_for_batch(self, name: str, batch: int) -> XTimeEngine:
        """The engine serving ``batch``-sized requests of ``name``.

        A tuned artifact carries a measured per-batch-bucket dispatch
        table in its ``TunePlan``; this binds (and memoizes, via the
        artifact's engine cache) the winning kernel configuration for the
        bucket covering ``batch`` — where the port timed the plan on this
        registry's device type (``CompiledModel.resolved_deploy``).
        Untuned artifacts fall back to the entry's default engine.
        """
        entry = self.get(name)
        if entry.artifact.tuning is None:
            return entry.engine
        return self._bind(entry.artifact, batch_hint=int(batch))

    def _bind(self, artifact: CompiledModel, **kw) -> XTimeEngine:
        if self.mesh is not None:
            return artifact.engine(mesh=self.mesh, **kw)
        return artifact.engine(self.device, **kw)

    def artifact(self, name: str) -> CompiledModel:
        return self.get(name).artifact

    def version(self, name: str) -> int:
        """Current version of ``name`` (0 if never registered)."""
        with self._lock:
            entry = self._models.get(name)
            return entry.version if entry is not None else 0

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._models)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._models

    def __len__(self) -> int:
        with self._lock:
            return len(self._models)
