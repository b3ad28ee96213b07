"""Unified deployment configuration: the ONE place execution knobs live.

A copy of ``repro.core.deploy`` (the port imports nothing of ``repro``),
kept field for field so artifact sidecars round-trip byte for byte
between the two packages.  The port reads every field but dispatches on
none of ``backend``, ``interpret``, ``spmd``, the mesh axes or ``b_blk``:
the DEVICE picks the implementation (the CUDA kernel for a tensor on the
card, the plain PyTorch version on the CPU).

Every consumer of the engine used to re-thread the same loose kwargs
(``backend``, ``mode``, ``b_blk``, ``r_blk``, ``noc_config``, mesh axes)
through ``XTimeEngine``, the registry's engine kwargs, benchmarks and
examples.  ``DeployConfig`` collects them into one frozen, serializable
dataclass that travels INSIDE the compiled artifact (``repro.api.build``
-> ``CompiledModel``), so a model saved on one host binds to an engine on
another with identical execution semantics.

``noc_config='auto'`` defers the collective choice to the compiled NoC
plan (``NoCPlan.engine_noc_config``) at engine-bind time — the paper's
router program decides, not the caller.  A bare engine with no plan
resolves 'auto' to 'accumulate' (Fig. 7a), the universal-correctness
config.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from repro_torch.core.precision import CELL_MODES, get_cell_mode, mode_names

BACKENDS = ("jnp", "pallas")
NOC_CONFIGS = ("auto", "accumulate", "batch", "hybrid")
SPMD_MODES = ("auto", "gspmd", "shard_map")
TABLE_DTYPES = ("auto", "uint8", "uint16", "int32", "float32")
# every user-facing mode list derives from the CellMode registry
# (repro.core.precision) — the tuples below are kept as the back-compat
# names downstream code imports, never hand-enumerated again
MODES = mode_names()
FAITHFUL_MODES = tuple(m.name for m in CELL_MODES.values() if m.faithful)
PACKABLE_MODES = tuple(m.name for m in CELL_MODES.values() if m.packable)
# table-compression levels (repro.core.compress): 'auto' == 'full'
COMPRESS_LEVELS = ("off", "prune", "merge", "full", "auto")


@dataclass(frozen=True)
class DeployConfig:
    """Execution knobs for a compiled model, independent of any device.

    Attributes:
      backend: 'jnp' or 'pallas' — the JAX package's implementation
        switch, carried for round trips; the port ignores it.
      mode: aCAM cell comparison mode ('direct' | 'inclusive' |
        'msb_lsb' | 'two_cycle').
      noc_config: 'auto' resolves from the compiled ``NoCPlan``;
        'accumulate' / 'batch' / 'hybrid' force the engine collective
        ('hybrid' is the 2-D batch × core program for large meshes —
        shard_map only, DESIGN.md §8).
      spmd: how a mesh engine is partitioned.  'shard_map' runs the
        kernel per device shard and issues the NoC plan's collectives
        explicitly; 'gspmd' keeps the implicit ``NamedSharding`` +
        compiler-placed collectives; 'auto' resolves at engine-bind
        time (mesh present -> 'shard_map', no mesh -> 'gspmd').
      row_axis / batch_axis: mesh axis names for CAM-row sharding and
        batch sharding (plus a leading 'pod' axis when present).
      b_blk / r_blk: kernel batch/row tile sizes — also the padding
        granularity of queries and CAM rows.
      f_blk: feature tile width of the v2 kernel's third grid dimension
        (lane multiple; features pad to it, DESIGN.md §10).
      table_dtype: kernel table dtype.  'auto' takes the compile-time
        selection carried on the ``CAMTable`` (uint8 for ≤256 bins,
        uint16 to 65536, int32 beyond); an explicit packed dtype
        overrides it; modes with a pinned dtype policy
        (``CellMode.table_dtype_policy`` — the faithful modes pin the
        int32 exclusive-high layout, 'soft' pins float32 soft-encoded
        bounds) always run that layout.
      tau: boundary temperature of the 'soft' cell mode, in BIN units —
        the sigmoid width of each cell's match score.  ``0.0`` is the
        exact hard limit (bit-equal predictions to 'direct'); the
        default gives gentle sub-bin smoothing.  Ignored by hard modes.
      c_mult: leaf-channel padding multiple (kernel lane packing).
      interpret: run the Pallas kernel in interpret mode.  'auto'
        (default) resolves at engine-bind time: compiled on TPU,
        interpreted elsewhere — callers no longer hard-code it.
      fuse_epilogue: fuse the epilogue's base-score add into the Pallas
        kernel's last feature tile (kernel v3) — bit-identical, saves
        the separate epilogue pass's HBM round-trip.  'auto' (default)
        fuses exactly when eligible: backend='pallas' with no mesh (a
        row-sharded psum would count the base once per shard).  True
        demands fusion (engine bind fails if ineligible); False keeps
        the separate epilogue (the differential-test pivot).
      batching: chip-side input batching (§III-D Fig. 7c) — replicate a
        small model across core groups; feeds ``plan_noc`` at build time.
      compress: RETENTION-style table compression level applied between
        compile and packing ('off' | 'prune' | 'merge' | 'full', with
        'auto' = 'full' — see ``repro.core.compress``).  Like
        ``batching`` this is a BUILD-time knob: it rewrites the CAM
        table itself, so it cannot be overridden at engine-bind time and
        ``with_deploy`` pins it to what the artifact's table actually is.
    """

    backend: str = "jnp"
    mode: str = "direct"
    noc_config: str = "auto"
    spmd: str = "auto"
    row_axis: str = "model"
    batch_axis: str = "data"
    b_blk: int = 128
    r_blk: int = 256
    f_blk: int = 128
    table_dtype: str = "auto"
    tau: float = 0.1
    c_mult: int = 8
    interpret: bool | str = "auto"
    fuse_epilogue: bool | str = "auto"
    batching: bool = False
    compress: str = "off"

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} not in {BACKENDS}")
        cell = get_cell_mode(self.mode)  # unknown modes list the registry
        if self.noc_config not in NOC_CONFIGS:
            raise ValueError(
                f"noc_config {self.noc_config!r} not in {NOC_CONFIGS}"
            )
        if self.spmd not in SPMD_MODES:
            raise ValueError(f"spmd {self.spmd!r} not in {SPMD_MODES}")
        if self.table_dtype not in TABLE_DTYPES:
            raise ValueError(
                f"table_dtype {self.table_dtype!r} not in {TABLE_DTYPES}"
            )
        policy = cell.table_dtype_policy
        if policy is not None and self.table_dtype not in ("auto", policy):
            raise ValueError(
                f"mode {self.mode!r} pins the {policy!r} table layout; "
                f"table_dtype={self.table_dtype!r} is only available for "
                f"modes {PACKABLE_MODES}"
            )
        if self.table_dtype == "float32" and not cell.soft:
            raise ValueError(
                "table_dtype 'float32' is the soft-encoded layout; it "
                f"requires mode='soft' (got mode={self.mode!r})"
            )
        if not (
            isinstance(self.tau, (int, float))
            and math.isfinite(self.tau)
            and self.tau >= 0.0
        ):
            raise ValueError(
                f"tau must be a finite temperature >= 0, got {self.tau!r}"
            )
        if self.b_blk < 1 or self.r_blk < 1 or self.c_mult < 1:
            raise ValueError("b_blk, r_blk and c_mult must be >= 1")
        if self.f_blk < 1:
            raise ValueError("f_blk must be >= 1")
        if self.interpret not in (True, False, "auto"):
            raise ValueError("interpret must be True, False or 'auto'")
        if self.fuse_epilogue not in (True, False, "auto"):
            raise ValueError("fuse_epilogue must be True, False or 'auto'")
        if self.compress not in COMPRESS_LEVELS:
            raise ValueError(
                f"compress {self.compress!r} not in {COMPRESS_LEVELS}"
            )

    # -- derivation ----------------------------------------------------------

    def replace(self, **changes) -> "DeployConfig":
        """A copy with ``changes`` applied (frozen-dataclass update)."""
        return dataclasses.replace(self, **changes)

    # -- (de)serialization ---------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DeployConfig":
        """Rebuild from a JSON dict; unknown keys are ignored so minor
        additive schema revisions stay loadable."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
