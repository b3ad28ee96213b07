"""X-TIME inference engine: compiled CAM table -> predictions, on one
device or on a mesh of devices.

The port of ``repro.core.engine``.  At bind time the engine
packs the canonical int32 exclusive-high table into the narrowest dtype
the grid permits (``resolve_table_dtype`` — uint8 for ≤256 bins, inclusive
upper bounds, compared natively; float32 half-integer bounds for the soft
cell mode), precomputes the wildcard tile-activity mask and the per-row
list of non-wildcard cells (``kops.binding_cells``, what the kernels
read) and moves everything to ``device``.  The device picks the implementation: on a CUDA
device every call launches a Hopper kernel (``kernels/csrc/cam_match.cu``
for the hard modes, ``kernels/csrc/cam_match_soft.cu`` for soft) and the
base score rides its epilogue; on the CPU the plain PyTorch version runs.
``DeployConfig.backend`` is not consulted.  Entry points run on the card
unless ``device="cpu"`` is given; there is no fallback from a missing card
to the CPU.

Scale-out (``mesh=``, a ``repro_torch.launch.mesh.Mesh``; DESIGN.md §8):
the CAM rows (cores) shard over ``config.row_axis`` and the query batch
over ``config.batch_axis`` (× ``pod``), and the §III-D H-tree router
program runs as one explicit shard program, driven from this process:

  * ``accumulate`` — batch group i runs the kernel on its queries against
    every row shard j; the partials move to the device of (i, 0) and are
    added in ascending j (the JAX package's ``psum``);
  * ``batch`` — the table is replicated, every device runs its piece of
    the query stream against all of it, the outputs are concatenated;
  * ``hybrid`` — within group i the row-axis query pieces are gathered in
    j order, the kernel runs on each row shard, and piece p of the sum is
    added in ascending j on the device of (i, p) (``all_gather`` +
    ``psum_scatter``).

The queries split in the batch spec's axis order (``pod``, ``batch_axis``,
then ``row_axis`` for batch and hybrid), and the outputs land on the
mesh's first device (``engine.device``), where the epilogue runs once.
Partials are summed as plain tensor adds in that fixed order — no float
atomics, no library collective — so results are the same from run to
run.  ``spmd='gspmd'`` runs the same program (PyTorch has no implicit
partitioner), so the two modes are bit-identical by construction.

The engine reproduces ``Ensemble.raw_margin`` / ``Ensemble.predict`` on
binned inputs — bit-for-bit on dyadic (k/16) leaves, within float32
reassociation otherwise, on one device and on a mesh; soft engines also
give the raw moments and the leaf-spread uncertainty of DESIGN.md §15.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core.compile import CAMTable
from repro_torch.core.deploy import DeployConfig
from repro_torch.core.precision import get_cell_mode
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import Mesh, check_mesh

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  A CUDA device with no card raises: the
    port never continues on the CPU unless asked to.  A bare ``'cuda'``
    resolves to the current card's index, so ``'cuda'`` and ``'cuda:0'``
    name one device (and share one engine per artifact)."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch sees no CUDA device; "
                "pass device='cpu' to run the plain PyTorch version"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_table_dtype(table: CAMTable, config: DeployConfig) -> str:
    """Effective kernel table dtype for this (table, config) binding.

    Modes with a pinned ``CellMode.table_dtype_policy`` always run that
    layout (int32 exclusive-high for the bit-faithful macro-cell modes);
    otherwise 'auto' takes the compile-time selection carried on the
    table, and an explicit packed dtype must actually hold the grid
    (inclusive bounds -> n_bins-1).
    """
    policy = get_cell_mode(config.mode).table_dtype_policy
    if policy is not None:
        return policy
    dt = table.table_dtype if config.table_dtype == "auto" else config.table_dtype
    if dt != "int32" and table.n_bins - 1 > np.iinfo(dt).max:
        raise ValueError(
            f"table_dtype {dt!r} cannot hold n_bins={table.n_bins} "
            "(inclusive bounds store values up to n_bins-1)"
        )
    return dt


@dataclass
class EngineArrays:
    """The whole bound table: on ``engine.device``, or on a mesh the
    logical (unsharded) table on the host, from which the shards were
    placed (``XTimeEngine.shards``)."""

    low: torch.Tensor  # (R_pad, F_pad) table dtype
    high: torch.Tensor  # (inclusive upper bounds when packed)
    leaf: torch.Tensor  # (R_pad, C_pad) float32
    tile_mask: torch.Tensor  # (R_pad/r_blk, F_pad/f_blk) int32, as the JAX package binds it
    cells: kops.CellList  # each row's non-wildcard cells: what the kernels read
    r_pad: int
    f_pad: int
    c_pad: int
    table_dtype: str = "int32"
    inclusive: bool = False  # high bounds stored inclusive?


@dataclass
class Shard:
    """One mesh position of a bound engine: its device and the rows of the
    tables it matches (views of one copy per device)."""

    device: torch.device
    low: torch.Tensor
    high: torch.Tensor
    leaf: torch.Tensor
    cells: kops.CellList
    moments: torch.Tensor | None  # soft engines' moments matrix rows


def _ordered_sum(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """``parts`` moved to ``device`` and added in list order."""
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc


class XTimeEngine:
    """Batched tree-ensemble inference on a compiled CAM table.

    Args:
      table: compiled ensemble.
      config: the ``DeployConfig`` (``mode``, ``r_blk``, ``f_blk``,
        ``c_mult``, ``table_dtype``, ``fuse_epilogue``, ``noc_config``,
        ``spmd``, ``row_axis``, ``batch_axis`` are read).  'auto'
        noc_config resolves to 'accumulate' here; the artifact layer
        resolves it from the compiled NoC plan before binding.
      device: where the tables live and the kernel runs; ``None`` is the
        card.
      mesh: a ``repro_torch.launch.mesh.Mesh`` instead of ``device``: the
        rows shard over ``config.row_axis`` and the batch over
        ``config.batch_axis`` (+ a leading ``pod`` axis), and
        ``config.noc_config`` picks the shard program (module docstring).
        Outputs land on the mesh's first device, ``engine.device``.
    """

    def __init__(
        self,
        table: CAMTable,
        *,
        config: DeployConfig | None = None,
        device=None,
        mesh: Mesh | None = None,
    ) -> None:
        config = config or DeployConfig()
        if mesh is not None:
            self.device = check_mesh(mesh).devices.flat[0]
            if device is not None:
                raise ValueError("pass device= or mesh=, not both")
        else:
            self.device = resolve_device(device)
        self.mesh = mesh
        self.table = table
        self.config = config
        # compressed tables may have dropped all-wildcard feature columns:
        # queries arrive at the LOGICAL width and are narrowed to the stored
        # columns (then permuted by col_perm) before any padding/matching
        self.feature_ids = (
            None if table.feature_ids is None
            else np.asarray(table.feature_ids, dtype=np.int64)
        )
        self.col_perm = (
            None if table.col_perm is None
            else np.asarray(table.col_perm, dtype=np.int64)
        )
        self.mode = config.mode
        # b_blk only sizes the serving and scoring buckets; the kernel
        # tiles the batch itself (see ``batch_multiple``)
        self.b_blk = config.b_blk
        self.r_blk = config.r_blk
        self.f_blk = config.f_blk
        # carried for reports: the port dispatches on the device
        self.backend = config.backend
        self.row_axis = config.row_axis
        self.batch_axis = config.batch_axis
        self.noc_config = "accumulate" if config.noc_config == "auto" else config.noc_config
        # 'auto' partitioning resolves at bind time, as in the JAX package:
        # explicit shard collectives on a mesh, the plain program without
        # one; on a mesh 'gspmd' runs the same shard program
        if mesh is None:
            self.spmd = "gspmd"
        elif config.spmd == "auto":
            self.spmd = "shard_map"
        else:
            self.spmd = config.spmd
        if mesh is not None:
            missing = [ax for ax in (self.row_axis, self.batch_axis)
                       if ax not in mesh.axis_names]
            if missing:
                raise ValueError(f"mesh {mesh.axis_names} lacks configured axes {missing}")
            if self.noc_config == "hybrid" and self.spmd != "shard_map":
                raise ValueError(
                    "noc_config='hybrid' (all-gather + psum_scatter) is only "
                    "expressible with spmd='shard_map'"
                )
        self.table_dtype = resolve_table_dtype(table, config)
        if get_cell_mode(config.mode).soft:
            self.kernel_mode = "soft"
        elif np.dtype(self.table_dtype).kind == "u":
            self.kernel_mode = "inclusive"
        else:
            self.kernel_mode = config.mode
        # soft boundary temperature in bin units; pinned to 0.0 for the
        # hard modes, which ignore it
        self.tau = float(config.tau) if self.kernel_mode == "soft" else 0.0
        # the base-score add rides the kernel's split reduction whenever
        # the kernel runs on one device (bit-identical to the separate add);
        # under a mesh each row shard's partial would carry it once
        eligible = self.device.type == "cuda" and mesh is None
        if config.fuse_epilogue == "auto":
            self.fuse_epilogue = eligible
        else:
            self.fuse_epilogue = bool(config.fuse_epilogue)
            if self.fuse_epilogue and not eligible:
                raise ValueError(
                    "fuse_epilogue=True needs the CUDA kernel on one device "
                    "(a row-sharded reduction would multiply the base score); "
                    "use 'auto' to fuse only when eligible"
                )

        # row padding must also be divisible by the row-shard count
        row_mult = self.r_blk
        if mesh is not None and self.noc_config in ("accumulate", "hybrid"):
            row_mult = self.r_blk * mesh.shape[self.row_axis]
        low, high, leaf, inclusive = kops.pack_tables(
            table.low, table.high, table.leaf_matrix(),
            r_blk=row_mult, c_mult=config.c_mult, n_bins=table.n_bins,
            f_blk=self.f_blk, dtype=self.table_dtype,
            inclusive=(True if self.kernel_mode == "inclusive" else None),
        )
        tile_mask = kops.wildcard_tile_mask(
            low, high, r_blk=self.r_blk, f_blk=self.f_blk,
            n_bins=table.n_bins, inclusive=inclusive,
        )
        cells = kops.binding_cells(
            low, high, n_bins=table.n_bins, inclusive=inclusive,
            n_real_rows=table.n_rows,
        )

        # on a mesh the whole table stays on the host and the shards are
        # placed from it (``_place_on_mesh``)
        home = torch.device("cpu") if mesh is not None else self.device

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(home)

        self.arrays = EngineArrays(
            low=put(low), high=put(high), leaf=put(leaf),
            tile_mask=put(tile_mask), cells=cells.to(home),
            r_pad=low.shape[0], f_pad=low.shape[1], c_pad=leaf.shape[1],
            table_dtype=self.table_dtype, inclusive=inclusive,
        )
        # fused-epilogue bias row: base score broadcast over C_pad (padding
        # channels are sliced off by the epilogue)
        self._bias = (
            torch.full((1, self.arrays.c_pad), float(np.float32(table.base_score)),
                       dtype=torch.float32, device=self.device)
            if self.fuse_epilogue else None
        )
        # soft mode's uncertainty channel (DESIGN.md §15): a separate
        # moments matrix [leaf, leaf^2, onehot(class)] per output channel,
        # run through the same kernel with no bias — the margin path keeps
        # the plain leaf matrix (and with it tau=0 == 'direct', bit for bit)
        self._moments = None
        if self.kernel_mode == "soft":
            lm = np.asarray(table.leaf_matrix(), dtype=np.float32)  # (R, C)
            R, C = lm.shape
            onehot = np.zeros_like(lm)
            cls = np.asarray(table.class_id, dtype=np.int64) % max(1, C)
            onehot[np.arange(R), cls] = 1.0  # row mass per output channel
            c3_pad = -(-3 * C // config.c_mult) * config.c_mult
            m_pad = np.zeros((self.arrays.r_pad, c3_pad), dtype=np.float32)
            m_pad[:R, : 3 * C] = np.concatenate([lm, lm * lm, onehot], axis=1)
            self._moments = put(m_pad)
        self.shards: list[list[Shard]] = []
        if mesh is not None:
            self._place_on_mesh()
        for dev in {self.device} if mesh is None else set(mesh.devices.flat):
            if dev.type == "cuda":
                # the tables are complete before any stream reads them
                # (serving replicas launch on streams of their own)
                torch.cuda.synchronize(dev)

    @classmethod
    def from_config(
        cls, table: CAMTable, config: DeployConfig, *, device=None, mesh: Mesh | None = None
    ) -> "XTimeEngine":
        """Canonical constructor: bind a compiled table + deploy config to a
        device or a mesh."""
        return cls(table, config=config, device=device, mesh=mesh)

    # -- placement on a mesh ---------------------------------------------------

    @property
    def n_row_shards(self) -> int:
        """Row shards of the table: the row axis's size, 1 for the
        replicated 'batch' program and without a mesh."""
        if self.mesh is None or self.noc_config == "batch":
            return 1
        return self.mesh.shape[self.row_axis]

    def _group_axes(self) -> list[str]:
        """The axes the batch groups split over: ``pod``, then ``batch_axis``."""
        return (["pod"] if "pod" in self.mesh.axis_names else []) + [self.batch_axis]

    def _group_coords(self) -> list[dict[str, int]]:
        """The batch groups in the batch spec's order (``_group_axes``,
        row-major), each as mesh coordinates."""
        shape = self.mesh.shape
        axes = self._group_axes()
        return [dict(zip(axes, idx))
                for idx in itertools.product(*(range(shape[ax]) for ax in axes))]

    def _place_on_mesh(self) -> None:
        """Fill ``shards[g][j]`` (batch group g, row-axis index j): each
        device gets the rows of every shard it holds in one copy, and each
        shard is a view of it — ``.to`` on the same device returns the same
        tensor, so logical shards on one card share one copy of the table."""
        mesh, a = self.mesh, self.arrays
        per = a.r_pad // self.n_row_shards
        # (g, j) -> the device and first row of the shard it holds
        where = {(g, j): (mesh.device_at({**coords, self.row_axis: j}),
                          0 if self.noc_config == "batch" else j * per)
                 for g, coords in enumerate(self._group_coords())
                 for j in range(mesh.shape[self.row_axis])}
        need: dict[torch.device, tuple[int, int]] = {}  # device -> the rows it holds
        for dev, r0 in where.values():
            lo, hi = need.get(dev, (r0, r0 + per))
            need[dev] = (min(lo, r0), max(hi, r0 + per))
        held = {}
        for dev, (r0, r1) in need.items():
            held[dev] = (r0, a.low[r0:r1].to(dev), a.high[r0:r1].to(dev),
                         a.leaf[r0:r1].to(dev), a.cells.rows(r0, r1).to(dev),
                         None if self._moments is None else self._moments[r0:r1].to(dev))
        for (g, j), (dev, r0) in where.items():
            base, low, high, leaf, cells, mom = held[dev]
            s0, s1 = r0 - base, r0 - base + per
            if j == 0:
                self.shards.append([])
            self.shards[g].append(Shard(dev, low[s0:s1], high[s0:s1], leaf[s0:s1],
                                        cells.rows(s0, s1),
                                        None if mom is None else mom[s0:s1]))

    # -- compute -----------------------------------------------------------

    def _epilogue(self, out: torch.Tensor) -> torch.Tensor:
        """Channel slice + base score + RF averaging, applied once.  With
        the fused epilogue the base score already landed in the kernel —
        in the same float order — and only the slice (+ RF divide) remains."""
        table = self.table
        out = out[:, : table.n_outputs]
        if not self.fuse_epilogue:
            out = out + torch.tensor(np.float32(table.base_score), device=out.device)
        if table.kind == "rf":
            out = out / torch.tensor(np.float32(max(1, table.n_trees)), device=out.device)
        return out

    def _kernel(self, q: torch.Tensor, s, leaf: torch.Tensor, bias) -> torch.Tensor:
        """(B, C) raw leaf sums of the rows of ``s`` (the engine's arrays or
        a shard) on ``q`` — no epilogue, no reduction across shards."""
        return kops.cam_match(
            q, s.low, s.high, leaf, s.cells, bias,
            out_b=q.shape[0], out_c=leaf.shape[1], mode=self.kernel_mode, tau=self.tau,
        )

    def _reduced(self, q: torch.Tensor, moments: bool = False) -> torch.Tensor:
        """(B_pad, C) raw sums over every table row, on ``self.device``: the
        kernel on one device, or the NoC program on a mesh (module
        docstring).  ``moments`` runs the soft moments matrix with no bias
        (a base score has no place in raw moment sums).  Shared by margin,
        predict and moments, as the JAX package's ``_reduced_fn`` is."""
        if self.mesh is None:
            a = self.arrays
            if moments:
                return self._kernel(q, a, self._moments, None)
            return self._kernel(q, a, a.leaf, self._bias)

        def run(qs: torch.Tensor, s: Shard) -> torch.Tensor:
            return self._kernel(qs.to(s.device), s, s.moments if moments else s.leaf, None)

        n_rows = len(self.shards[0])
        per_group = q.shape[0] // len(self.shards)
        piece = per_group // n_rows  # batch, hybrid: a device's share of a group
        outs = []
        for g, row in enumerate(self.shards):
            qg = q[g * per_group:(g + 1) * per_group]
            if self.noc_config == "batch":
                outs += [run(qg[j * piece:(j + 1) * piece], s) for j, s in enumerate(row)]
                continue
            # accumulate, hybrid: the group's queries (its row-axis pieces
            # gathered in j order) against every row shard
            parts = [run(qg, s) for s in row]
            if self.noc_config == "accumulate":
                outs.append(_ordered_sum(parts, row[0].device))
            else:  # hybrid: piece p of the sum reduces onto the device of (g, p)
                outs += [_ordered_sum([part[p * piece:(p + 1) * piece] for part in parts],
                                      s.device) for p, s in enumerate(row)]
        return torch.cat([o.to(self.device) for o in outs])

    def _margin_padded(self, q: torch.Tensor) -> torch.Tensor:
        return self._epilogue(self._reduced(q))

    def _predict_from_margin(self, m: torch.Tensor) -> torch.Tensor:
        table = self.table
        if table.task == "regression":
            return m[:, 0]
        if table.n_outputs == 1:  # single-logit binary: sign test
            return (m[:, 0] > 0.0).to(torch.int32)
        return torch.argmax(m, dim=1).to(torch.int32)

    def select_features(self, q) -> torch.Tensor | np.ndarray:
        """Narrow ``(B, n_features)`` query bins to the stored table
        columns, then apply the compile-time column permutation — identity
        for plain tables.  Queries already at the (narrower) physical
        width pass through; a pure permutation preserves the width, so
        callers pass logical-order queries and call this exactly once."""
        fids, perm = self.feature_ids, self.col_perm
        if fids is None and perm is None:
            return q
        if (
            fids is not None
            and q.ndim == 2
            and q.shape[1] == fids.shape[0]
            and fids.shape[0] != self.table.n_features
        ):
            return q  # already narrowed (and permuted) by an earlier call
        if q.ndim != 2 or q.shape[1] != self.table.n_features:
            expect = f"expected (_, {self.table.n_features}) query bins"
            if fids is not None:
                expect += f" (or pre-selected (_, {fids.shape[0]}))"
            raise ValueError(f"{expect}, got {tuple(q.shape)}")
        if fids is not None:  # numpy arrays and tensors index alike
            q = q[:, fids]
        if perm is not None:
            q = q[:, perm]
        return q

    def _prep_queries(self, q_bins) -> torch.Tensor:
        # pad the batch to what the mesh's batch split accepts
        return kops.pad_queries(
            self.select_features(q_bins), self.arrays.f_pad, b_blk=self.batch_multiple,
            dtype=self.table_dtype, device=self.device,
        )

    def raw_margin(self, q_bins) -> torch.Tensor:
        """(B, n_outputs) — matches ``Ensemble.raw_margin`` on binned input."""
        return self._margin_padded(self._prep_queries(q_bins))[: q_bins.shape[0]]

    def predict(self, q_bins) -> torch.Tensor:
        """Final predictions — matches ``Ensemble.predict``."""
        return self._predict_from_margin(self.raw_margin(q_bins))

    # -- soft-mode uncertainty channel (DESIGN.md §15) -----------------------

    def _need_moments(self) -> None:
        if self._moments is None:
            raise ValueError(
                "raw_moments/uncertainty require the soft cell mode "
                f"(this engine runs mode={self.mode!r}); rebind with "
                "DeployConfig(mode='soft')"
            )

    def raw_moments(self, q_bins) -> torch.Tensor:
        """(B, 3*n_outputs) raw soft moments ``[m1 | m2 | mass]``.

        Per output channel c: ``m1 = sum_r s_r * leaf[r, c]``,
        ``m2 = sum_r s_r * leaf[r, c]^2`` and ``mass = sum_r s_r`` over
        the rows routed to c, with s_r the row's soft match score — one
        more kernel launch, over the moments matrix, with no bias.  Soft
        engines only."""
        self._need_moments()
        q = self._prep_queries(q_bins)
        return self._reduced(q, moments=True)[: q_bins.shape[0], : 3 * self.table.n_outputs]

    def margin_and_moments(self, q_bins) -> tuple[torch.Tensor, torch.Tensor]:
        """``(raw_margin(q_bins), raw_moments(q_bins))``, bit for bit, from
        one soft kernel launch on the card: the kernel's m1 columns are the
        margin's leaf sums (each output's float sequence does not depend on
        the matrix width), and the bias goes on as the reduce kernel adds
        it, one float32 add after the split sum.  The plain version's CPU
        product sums in an order that depends on the width, and a mesh
        reduces its shards in its own program: those run both passes."""
        self._need_moments()
        if not self._one_launch_moments:
            return self.raw_margin(q_bins), self.raw_moments(q_bins)
        B, C = q_bins.shape[0], self.table.n_outputs
        m = self._reduced(self._prep_queries(q_bins), moments=True)[:B]
        m1 = m[:, :C] if self._bias is None else m[:, :C] + self._bias[:, :C]
        return self._epilogue(m1), m[:, : 3 * C]

    @property
    def _one_launch_moments(self) -> bool:
        """Whether ``margin_and_moments`` takes the margins from the moments
        launch: on one card."""
        return self.mesh is None and self.device.type == "cuda"

    def uncertainty(self, q_bins) -> torch.Tensor:
        """(B, n_outputs) calibrated uncertainty: the score-weighted
        population spread (std) of the leaf values behind each output
        channel, derived on the host in float64 from ``raw_moments``.  At
        tau=0 exactly one row per tree matches and the spread is the
        across-tree disagreement; finite tau adds boundary ambiguity."""
        return self.uncertainty_from_moments(self.raw_moments(q_bins))

    def uncertainty_from_moments(self, moments: torch.Tensor) -> torch.Tensor:
        """``uncertainty`` from ``raw_moments``' output."""
        m = moments.cpu().numpy().astype(np.float64)
        C = self.table.n_outputs
        m1, m2, mass = m[:, :C], m[:, C : 2 * C], m[:, 2 * C : 3 * C]
        mass = np.maximum(mass, 1e-12)  # empty channels -> 0 spread, not NaN
        mean = m1 / mass
        var = np.maximum(m2 / mass - mean * mean, 0.0)
        return torch.from_numpy(np.sqrt(var, dtype=np.float64).astype(np.float32))

    # -- bucketed serving path ----------------------------------------------

    @property
    def batch_multiple(self) -> int:
        """Smallest batch granularity a serving bucket must respect.

        On one device 1: the CUDA kernel tiles the batch in 32-query words
        and masks the ragged edge, and the plain version takes any batch.
        On a mesh the batch splits evenly over its batch shards — ``pod`` ×
        ``batch_axis``, times ``row_axis`` for the batch and hybrid
        programs — the JAX package's rule for an engine that tiles no
        batch itself."""
        if self.mesh is None:
            return 1
        shards = len(self.shards)
        if self.noc_config in ("batch", "hybrid"):
            shards *= self.mesh.shape[self.row_axis]
        return shards

    def padded_fn(self, kind: str = "predict") -> Callable:
        """Bucket-aware entry for the serving layer: a callable of one
        pre-padded ``(bucket_b, f_pad)`` query block (``kops.pad_to_bucket``)
        that yields the FULL padded output — the caller owns un-padding.
        Soft engines take the bins as float32 (exact below 2**24)."""
        if kind not in ("predict", "margin"):
            raise ValueError(f"unknown kind {kind!r}")
        a = self.arrays

        def run(q_padded) -> torch.Tensor:
            if q_padded.ndim != 2 or q_padded.shape[1] != a.f_pad:
                raise ValueError(
                    f"expected (_, {a.f_pad}) padded queries, got {tuple(q_padded.shape)}"
                )
            # packed engines compare queries in the table dtype (soft ones
            # as float32 bins); a narrowing cast is wrap-checked (a wrapped
            # out-of-range bin would match rows it must not)
            if q_padded.shape[0] % self.batch_multiple:
                raise ValueError(
                    f"bucket {q_padded.shape[0]} not a multiple of "
                    f"batch_multiple={self.batch_multiple}"
                )
            q = kops.pad_to_bucket(
                q_padded, q_padded.shape[0], a.f_pad,
                dtype=self.table_dtype, device=self.device,
            )
            m = self._margin_padded(q)
            return m if kind == "margin" else self._predict_from_margin(m)

        return run

    def predict_padded(self, q_padded) -> torch.Tensor:
        """``predict`` on a pre-padded bucket; returns padded outputs."""
        return self.padded_fn("predict")(q_padded)

    def raw_margin_padded(self, q_padded) -> torch.Tensor:
        """``raw_margin`` on a pre-padded bucket; returns padded outputs."""
        return self.padded_fn("margin")(q_padded)

    # -- dry-run hooks -------------------------------------------------------

    def _batch_spec(self):
        """The queries' spec on the mesh, as ``_reduced`` splits them: over
        the batch groups (``_group_axes``), and over ``row_axis`` too where
        each device takes a piece of its group's queries (batch, hybrid)."""
        from repro_torch.sharding.partition import P  # its package imports the models

        axes = self._group_axes()
        if self.noc_config in ("batch", "hybrid"):
            axes.append(self.row_axis)
        return P(axes[0] if len(axes) == 1 else tuple(axes))  # as jax normalises ("data",)

    def _row_spec(self):
        """A table array's spec, as ``_place_on_mesh`` places it: rows over
        ``row_axis``, or whole on every device for the batch program."""
        from repro_torch.sharding.partition import P

        return P() if self.noc_config == "batch" else P(self.row_axis)

    def serve_step_for_dryrun(self):
        """(fn, in_specs, out_spec) for the dry run.  ``fn(q, low, high,
        leaf, cells)`` is the margin program on a padded query block ``q``
        (``input_specs``) over the table as ``_place_on_mesh`` placed it:
        the table arrays must be this engine's (``engine.arrays``' low,
        high, leaf and cells, the cell list in place of the reference's
        tile mask).  ``in_specs``: the batch spec, then the row spec of each
        table array; ``out_spec``: the batch spec."""
        if self.mesh is None:
            raise ValueError("the dry-run hooks need an engine bound to a mesh")
        a = self.arrays

        def fn(q, low, high, leaf, cells):
            if any(x is not y for x, y in zip((low, high, leaf, cells),
                                              (a.low, a.high, a.leaf, a.cells))):
                raise ValueError("fn runs the table this engine placed: pass "
                                 "engine.arrays' low, high, leaf and cells")
            return self._margin_padded(q)

        bs, rs = self._batch_spec(), self._row_spec()
        return fn, (bs, rs, rs, rs, rs), bs

    def input_specs(self, batch: int) -> torch.Tensor:
        """A meta stand-in of a padded query block: (batch, f_pad) in the
        table dtype."""
        return torch.empty((batch, self.arrays.f_pad), dtype=kops.TORCH_DTYPES[self.table_dtype],
                           device="meta")
