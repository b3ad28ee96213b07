"""X-TIME inference engine on one device: compiled CAM table -> predictions.

The single-device half of ``repro.core.engine``.  At bind time the engine
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

The engine reproduces ``Ensemble.raw_margin`` / ``Ensemble.predict`` on
binned inputs — bit-for-bit on dyadic (k/16) leaves, within float32
reassociation otherwise; soft engines also give the raw moments and the
leaf-spread uncertainty of DESIGN.md §15.  The mesh paths are not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core.compile import CAMTable
from repro_torch.core.deploy import DeployConfig
from repro_torch.core.precision import get_cell_mode
from repro_torch.kernels import ops as kops

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


class XTimeEngine:
    """Batched tree-ensemble inference on a compiled CAM table.

    Args:
      table: compiled ensemble.
      config: the ``DeployConfig`` (``mode``, ``r_blk``, ``f_blk``,
        ``c_mult``, ``table_dtype``, ``fuse_epilogue`` are read).
      device: where the tables live and the kernel runs; ``None`` is the
        card.
    """

    def __init__(
        self,
        table: CAMTable,
        *,
        config: DeployConfig | None = None,
        device=None,
    ) -> None:
        config = config or DeployConfig()
        self.device = resolve_device(device)
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
        # carried for reports: the port dispatches on the device, runs one
        # device, and so always the single-device collective plan
        self.backend = config.backend
        self.spmd = "gspmd"
        self.noc_config = "accumulate" if config.noc_config == "auto" else config.noc_config
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
        # the kernel runs (bit-identical to the separate add)
        eligible = self.device.type == "cuda"
        if config.fuse_epilogue == "auto":
            self.fuse_epilogue = eligible
        else:
            self.fuse_epilogue = bool(config.fuse_epilogue)
            if self.fuse_epilogue and not eligible:
                raise ValueError(
                    "fuse_epilogue=True needs the CUDA kernel (a CUDA "
                    "device); use 'auto' to fuse only when eligible"
                )

        low, high, leaf, inclusive = kops.pack_tables(
            table.low, table.high, table.leaf_matrix(),
            r_blk=self.r_blk, c_mult=config.c_mult, n_bins=table.n_bins,
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

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(self.device)

        self.arrays = EngineArrays(
            low=put(low), high=put(high), leaf=put(leaf),
            tile_mask=put(tile_mask), cells=cells.to(self.device),
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
        if self.device.type == "cuda":
            # the tables are complete before any stream reads them (serving
            # replicas launch on streams of their own)
            torch.cuda.synchronize(self.device)

    @classmethod
    def from_config(
        cls, table: CAMTable, config: DeployConfig, *, device=None
    ) -> "XTimeEngine":
        """Canonical constructor: bind a compiled table + deploy config."""
        return cls(table, config=config, device=device)

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

    def _kernel(self, q: torch.Tensor, leaf: torch.Tensor, bias, out_c: int) -> torch.Tensor:
        a = self.arrays
        return kops.cam_match(
            q, a.low, a.high, leaf, a.cells, bias,
            out_b=q.shape[0], out_c=out_c, mode=self.kernel_mode, tau=self.tau,
        )

    def _margin_padded(self, q: torch.Tensor) -> torch.Tensor:
        return self._epilogue(self._kernel(q, self.arrays.leaf, self._bias, self.arrays.c_pad))

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
        return kops.pad_queries(
            self.select_features(q_bins), self.arrays.f_pad,
            dtype=self.table_dtype, device=self.device,
        )

    def raw_margin(self, q_bins) -> torch.Tensor:
        """(B, n_outputs) — matches ``Ensemble.raw_margin`` on binned input."""
        return self._margin_padded(self._prep_queries(q_bins))

    def predict(self, q_bins) -> torch.Tensor:
        """Final predictions — matches ``Ensemble.predict``."""
        return self._predict_from_margin(self.raw_margin(q_bins))

    # -- soft-mode uncertainty channel (DESIGN.md §15) -----------------------

    def raw_moments(self, q_bins) -> torch.Tensor:
        """(B, 3*n_outputs) raw soft moments ``[m1 | m2 | mass]``.

        Per output channel c: ``m1 = sum_r s_r * leaf[r, c]``,
        ``m2 = sum_r s_r * leaf[r, c]^2`` and ``mass = sum_r s_r`` over
        the rows routed to c, with s_r the row's soft match score — one
        more kernel launch, over the moments matrix, with no bias.  Soft
        engines only."""
        if self._moments is None:
            raise ValueError(
                "raw_moments/uncertainty require the soft cell mode "
                f"(this engine runs mode={self.mode!r}); rebind with "
                "DeployConfig(mode='soft')"
            )
        return self._kernel(self._prep_queries(q_bins), self._moments, None,
                            3 * self.table.n_outputs)

    def uncertainty(self, q_bins) -> torch.Tensor:
        """(B, n_outputs) calibrated uncertainty: the score-weighted
        population spread (std) of the leaf values behind each output
        channel, derived on the host in float64 from ``raw_moments``.  At
        tau=0 exactly one row per tree matches and the spread is the
        across-tree disagreement; finite tau adds boundary ambiguity."""
        m = self.raw_moments(q_bins).cpu().numpy().astype(np.float64)
        C = self.table.n_outputs
        m1, m2, mass = m[:, :C], m[:, C : 2 * C], m[:, 2 * C : 3 * C]
        mass = np.maximum(mass, 1e-12)  # empty channels -> 0 spread, not NaN
        mean = m1 / mass
        var = np.maximum(m2 / mass - mean * mean, 0.0)
        return torch.from_numpy(np.sqrt(var, dtype=np.float64).astype(np.float32))

    # -- bucketed serving path ----------------------------------------------

    @property
    def batch_multiple(self) -> int:
        """Smallest batch granularity a serving bucket must respect: 1 —
        the CUDA kernel tiles the batch in 32-query words and masks the
        ragged edge, and the plain version takes any batch."""
        return 1

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
