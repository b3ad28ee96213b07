"""Host-side table prep and the device-dispatching ``cam_match`` entry.

Handles the padding contract so callers can pass ragged real-world shapes:
  * rows   -> multiple of r_blk          (pad with never-match ranges)
  * feats  -> multiple of f_blk          (pad with always-match ranges)
  * chans  -> multiple of c_mult         (pad leaf channels with zeros)
The batch needs no padding: the CUDA kernel tiles it in 32-query words and
masks the ragged edge itself.

``pad_tables``, ``pack_tables``, ``wildcard_tile_mask`` and
``check_query_range`` are NumPy copies of ``repro.kernels.ops`` and give
byte-identical arrays; ``pack_tables`` writes straight into the narrow
dtype instead of through padded int64 intermediates (4 GB per table pair
at xtime-tabular's 1M x 256 cells), and encodes the float32 soft layout
in row chunks (its int64/float64 intermediates would take ~10 GB at full
width).  ``pad_queries``/``pad_to_bucket`` build torch tensors on the
engine's device, ``write_queries`` writes host bins into a buffer of the
same layout (the engine's pinned staging rows), and ``cam_match`` picks
the implementation by device:
the Hopper kernels for CUDA tensors, the plain version for CPU tensors.
``binding_cells`` (the port's own) lists each row's non-wildcard cells,
the only cells the Hopper kernels read.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.precision import encode_soft_bounds
from repro_torch.kernels.ref import cam_match_ref

# default feature-axis tile (the engine's f_blk)
F_CHUNK = 128

TORCH_DTYPES = {
    "uint8": torch.uint8, "uint16": torch.uint16, "int32": torch.int32,
    "float32": torch.float32,
}

# rows of the soft layout encoded at a time: bounds the int64/float64
# temporaries of ``encode_soft_bounds`` to a few hundred MB
SOFT_ENCODE_ROWS = 1 << 14


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _np_dtype(x) -> np.dtype:
    """numpy dtype of a numpy array or torch tensor (``torch.uint8`` ->
    ``uint8``)."""
    return np.dtype(str(x.dtype).removeprefix("torch."))


def pad_tables(
    low: np.ndarray,
    high: np.ndarray,
    leaf_matrix: np.ndarray,
    *,
    r_blk: int = 256,
    c_mult: int = 8,
    n_bins: int | None = None,
    f_blk: int = F_CHUNK,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad the compiled CAM table to kernel-friendly shapes (host-side),
    in the canonical exclusive-high int32 layout."""
    R, F = low.shape
    C = leaf_matrix.shape[1]
    R_pad, F_pad, C_pad = _ceil_to(R, r_blk), _ceil_to(F, f_blk), _ceil_to(C, c_mult)
    big = np.int32(n_bins if n_bins is not None else (int(high.max()) + 1))

    lo = np.zeros((R_pad, F_pad), dtype=np.int32)
    hi = np.full((R_pad, F_pad), big, dtype=np.int32)  # always-match columns
    lo[:R, :F] = low
    hi[:R, :F] = high
    lo[R:, :] = 1  # never-match rows: low=1 > high=0
    hi[R:, :] = 0

    lm = np.zeros((R_pad, C_pad), dtype=np.float32)
    lm[:R, :C] = leaf_matrix
    return lo, hi, lm


def pack_tables(
    low: np.ndarray,
    high: np.ndarray,
    leaf_matrix: np.ndarray,
    *,
    r_blk: int = 256,
    c_mult: int = 8,
    n_bins: int | None = None,
    f_blk: int = F_CHUNK,
    dtype: str = "int32",
    inclusive: bool | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """Pad + pack the CAM table for the kernel; returns (lo, hi, leaf, incl).

    ``dtype`` is the kernel table dtype.  The packed (unsigned) dtypes
    always store INCLUSIVE upper bounds so the full grid [0, n_bins)
    fits; ``inclusive=True`` forces the inclusive encoding for int32 too
    (the engine's mode='inclusive').  Encoding map:

      real cells        low,  high-1       (int32 keeps high-1 exactly,
                                            so degenerate high=0 cells
                                            stay unmatchable at -1)
      always-match pad  0,    n_bins-1
      never-match rows  1,    0            (low > high, unmatchable)

    An unsigned dtype additionally requires every table value to fit its
    range; perturbed tables must use the int32 layout.  ``'float32'`` is
    the soft layout (``_pack_tables_soft``).
    """
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return _pack_tables_soft(
            low, high, leaf_matrix,
            r_blk=r_blk, c_mult=c_mult, n_bins=n_bins, f_blk=f_blk,
        )
    if inclusive is None:
        inclusive = dt.kind == "u"
    if dt.kind == "u" and not inclusive:
        raise ValueError("packed unsigned tables require the inclusive encoding")

    shift = 1 if inclusive else 0
    if dt.kind == "u":
        lo_b = int(low.min(initial=0)), int(low.max(initial=0))
        hi_b = (
            int(high.min(initial=shift)) - shift,
            int(high.max(initial=shift)) - shift,
        )
        top = np.iinfo(dt).max
        if lo_b[0] < 0 or hi_b[0] < 0 or lo_b[1] > top or hi_b[1] > top:
            raise ValueError(
                f"table values (low in {lo_b}, inclusive high in {hi_b}) "
                f"do not fit table dtype {dtype!r}; use 'int32' for "
                "perturbed/out-of-grid tables"
            )

    R, F = low.shape
    C = leaf_matrix.shape[1]
    R_pad, F_pad, C_pad = _ceil_to(R, r_blk), _ceil_to(F, f_blk), _ceil_to(C, c_mult)
    big = n_bins if n_bins is not None else (int(high.max(initial=0)) + 1)
    out_dt = dt if dt.kind == "u" else np.dtype(np.int32)

    lo = np.zeros((R_pad, F_pad), dtype=out_dt)
    # always-match columns in the chosen encoding
    hi = np.full((R_pad, F_pad), big - shift, dtype=out_dt)
    lo[:R, :F] = low
    # int32 wraps exactly like the reference's int64 -> int32 cast
    np.subtract(high, shift, out=hi[:R, :F], casting="unsafe")
    lo[R:, :] = 1  # never-match rows: low=1 > high=0 in both encodings
    hi[R:, :] = 0

    lm = np.zeros((R_pad, C_pad), dtype=np.float32)
    lm[:R, :C] = leaf_matrix
    return lo, hi, lm, inclusive


def _pack_tables_soft(
    low: np.ndarray,
    high: np.ndarray,
    leaf_matrix: np.ndarray,
    *,
    r_blk: int,
    c_mult: int,
    n_bins: int | None,
    f_blk: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """The float32 soft-mode layout: pad in the canonical int32 form, then
    ``encode_soft_bounds``, so padding columns become exact wildcards
    (log-score 0) and padding rows exact never-matches (score 0).  Done
    one block of ``SOFT_ENCODE_ROWS`` rows at a time: the encoding is
    cell-wise, so the bytes are those of encoding the whole table."""
    bins = int(n_bins) if n_bins is not None else (int(high.max(initial=0)) + 1)
    R, F = low.shape
    C = leaf_matrix.shape[1]
    R_pad, F_pad, C_pad = _ceil_to(R, r_blk), _ceil_to(F, f_blk), _ceil_to(C, c_mult)
    lo_f = np.empty((R_pad, F_pad), dtype=np.float32)
    hi_f = np.empty((R_pad, F_pad), dtype=np.float32)
    for r0 in range(0, R_pad, SOFT_ENCODE_ROWS):
        r1 = min(R_pad, r0 + SOFT_ENCODE_ROWS)
        real = max(0, min(R, r1) - r0)  # rows of the table in this block
        lo = np.zeros((r1 - r0, F_pad), dtype=np.int32)
        hi = np.full((r1 - r0, F_pad), bins, dtype=np.int32)  # always-match columns
        lo[:real, :F] = low[r0 : r0 + real]
        hi[:real, :F] = high[r0 : r0 + real]
        lo[real:, :] = 1  # never-match rows: low=1 > high=0
        hi[real:, :] = 0
        lo_f[r0:r1], hi_f[r0:r1] = encode_soft_bounds(lo, hi, bins)
    lm = np.zeros((R_pad, C_pad), dtype=np.float32)
    lm[:R, :C] = leaf_matrix
    return lo_f, hi_f, lm, False


def wildcard_cells(low, high, *, n_bins: int, inclusive: bool) -> np.ndarray:
    """Boolean array of ``low``'s shape: True where a cell is the wildcard.

    On PADDED (and possibly packed) tables: the full range [0, n_bins) in
    whichever encoding ``inclusive`` names; on float32 soft-encoded tables
    the exact (-inf, +inf) cell, whose log-score is exactly 0.  Every query
    bin in [0, n_bins) matches such a cell in every hard cell mode, so
    leaving it out of a compare changes nothing.  Never-match padding
    cells are not wildcards.
    """
    if np.dtype(low.dtype).kind == "f":
        return np.isneginf(low) & np.isposinf(high)
    top = n_bins - 1 if inclusive else n_bins
    return (low == 0) & (high >= top)


def wildcard_tile_mask(
    low: np.ndarray,
    high: np.ndarray,
    *,
    r_blk: int,
    f_blk: int,
    n_bins: int,
    inclusive: bool,
) -> np.ndarray:
    """(R/r_blk, F/f_blk) int32 — 0 marks an all-wildcard compare tile
    (``wildcard_cells``).  Never-match padding rows are not wildcards, so
    their tiles stay active."""
    R, F = low.shape
    if R % r_blk or F % f_blk:
        raise ValueError(f"padded shape ({R}, {F}) must tile by ({r_blk}, {f_blk})")
    act = ~wildcard_cells(low, high, n_bins=n_bins, inclusive=inclusive)
    tiles = act.reshape(R // r_blk, r_blk, F // f_blk, f_blk).any(axis=(1, 3))
    return tiles.astype(np.int32)


@dataclass(frozen=True)
class CellList:
    """Each table row's non-wildcard cells, in ascending feature order
    (an ELL layout: K slots a row, the first ``count[r]`` of them used).

      count  (R_pad,)    int32, at most K
      feat   (R_pad, K)  uint16 feature index, below ``width``
      lo, hi (R_pad, K)  the cells' bounds exactly as the table stores them

    Slots past a row's count are zero and never read.  ``width`` is the
    padded feature count F_pad of the table (and of the queries).  Holds
    numpy arrays or tensors; the construction checks the shapes, dtypes
    and ``count <= K``, ``feat < width`` once, so a kernel launch need not,
    and records ``span``, the largest feature index it holds + 1.
    ``words`` (made here unless given) packs each cell into the one 32-bit
    word the bit-parallel kernels' value route reads (``packing``): a
    uint8 list's ``cell_words``; a uint16, int32 or float32 list's
    ``value_words`` where its span fits one block's value tables
    (``BITMAP_FEATURES``), its ``window_words`` where it fits a cluster's
    (``MAX_MEMBERS`` windows of them), provided no listed bound is NaN;
    else None (the kernel then searches ranks).  A
    float32 (soft) list carries ``lattice`` (made here unless given):
    whether every finite bound it lists is a half-integer of magnitude at
    most ``LATTICE_MAX``, so the soft kernel may read its log-sigmoids
    from a table (``on_lattice``); other lists False.
    """

    count: np.ndarray | torch.Tensor
    feat: np.ndarray | torch.Tensor
    lo: np.ndarray | torch.Tensor
    hi: np.ndarray | torch.Tensor
    width: int
    words: np.ndarray | torch.Tensor | None = field(default=None, repr=False, compare=False)
    lattice: bool | None = field(default=None, repr=False, compare=False)
    span: int = field(default=0, init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        R, K = tuple(self.feat.shape)
        if (tuple(self.count.shape) != (R,) or tuple(self.lo.shape) != (R, K)
                or tuple(self.hi.shape) != (R, K) or K == 0):
            raise ValueError(
                f"cell list shapes: count {tuple(self.count.shape)}, feat "
                f"{tuple(self.feat.shape)}, lo {tuple(self.lo.shape)}, hi "
                f"{tuple(self.hi.shape)}; want (R,) and (R, K >= 1)"
            )
        if _np_dtype(self.count) != np.int32 or _np_dtype(self.feat) != np.uint16:
            raise ValueError("cell list count must be int32 and feat uint16")
        if _np_dtype(self.lo) != _np_dtype(self.hi):
            raise ValueError("cell list lo and hi must share the table dtype")
        if R:
            cmin, cmax = int(self.count.min()), int(self.count.max())
            fmax = int(self.feat.max()) if isinstance(self.feat, np.ndarray) else int(
                self.feat.to(torch.int32).max())
            if cmin < 0 or cmax > K or fmax >= self.width:
                raise ValueError(
                    f"cell list counts in [{cmin}, {cmax}] (K = {K}) or features up to "
                    f"{fmax} (width {self.width}) out of range"
                )
            object.__setattr__(self, "span", fmax + 1)
        if self.words is None:
            kind = packing(self)
            if kind is not None and not _nan_bounds(self):
                object.__setattr__(self, "words", _PACKERS[kind](self.feat, self.lo, self.hi))
        elif _np_dtype(self.words) != np.int32 or tuple(self.words.shape) != (R, K):
            raise ValueError(f"words must be the ({R}, K = {K}) int32 packing of the list")
        if self.lattice is None:
            object.__setattr__(self, "lattice", _np_dtype(self.lo) == np.float32
                               and on_lattice(self))

    @property
    def k(self) -> int:
        return int(self.feat.shape[1])

    def rows(self, start: int, stop: int) -> "CellList":
        """Rows ``[start, stop)`` of the list, as views (packed words
        too, where the rows' own span takes the same packing); K and the
        width stay the table's (a row shard of the mesh engine)."""
        view = (self.count[start:stop], self.feat[start:stop], self.lo[start:stop],
                self.hi[start:stop], self.width)
        sub = CellList(*view, None if self.words is None else self.words[start:stop])
        if sub.words is not None and packing(sub) != packing(self):
            sub = CellList(*view)  # packs the words of its own span
        return sub

    def to(self, device) -> "CellList":
        """The same list as tensors on ``device`` (its words and lattice
        as they are)."""
        def put(a):
            t = torch.from_numpy(a) if isinstance(a, np.ndarray) else a
            return t.to(device).contiguous()
        return CellList(put(self.count), put(self.feat), put(self.lo), put(self.hi),
                        self.width, None if self.words is None else put(self.words),
                        self.lattice)


def cell_words(feat, lo, hi):
    """(R, K) int32: each cell of a uint8 list as ``feat | lo << 16 | hi <<
    24`` (bits as uint32), numpy or torch as given."""
    if isinstance(feat, np.ndarray):
        w = (feat.astype(np.uint32) | (lo.astype(np.uint32) << 16)
             | (hi.astype(np.uint32) << 24))
        return w.view(np.int32)
    return (feat.to(torch.int32) | (lo.to(torch.int32) << 16)
            | (hi.to(torch.int32) << 24)).contiguous()


# the bit-parallel kernels' value tables (cam_match.cu `kGeStride`,
# `kMaxWindow`): GE[f][v] for v in [0, 256], GE_STRIDE words a feature, at
# most BITMAP_FEATURES features in one block's shared memory.  A list of
# span up to BITMAP_FEATURES packs ``value_words`` (one block a tile holds
# every feature); up to MAX_MEMBERS windows of BITMAP_FEATURES, the
# ``window_words`` of a thread-block cluster (`kMaxMembers`, the portable
# cluster size), member m holding features [m * 223, (m + 1) * 223)
GE_STRIDE = 260
BITMAP_FEATURES = 223
MAX_MEMBERS = 8


def _value_lookups(lo, hi):
    """(L, H) int64, numpy or torch as given: the clamped value-table
    indices of each cell's lower and (inclusive) upper half."""
    if isinstance(lo, np.ndarray):
        if lo.dtype == np.float32:
            lo_v = np.floor(np.nan_to_num(lo.astype(np.float64), nan=0.0)) + 1
            hi_v = np.ceil(np.nan_to_num(hi.astype(np.float64), nan=0.0)) + 1
        else:
            lo_v, hi_v = lo.astype(np.int64), hi.astype(np.int64) + 1
        return np.clip(lo_v, 0, 256).astype(np.int64), np.clip(hi_v, 0, 257).astype(np.int64)
    if lo.dtype == torch.float32:
        lo_v = torch.floor(torch.nan_to_num(lo.double(), nan=0.0)) + 1
        hi_v = torch.ceil(torch.nan_to_num(hi.double(), nan=0.0)) + 1
    else:
        lo_v, hi_v = lo.to(torch.int64), hi.to(torch.int64) + 1
    return lo_v.clamp(0, 256).to(torch.int64), hi_v.clamp(0, 257).to(torch.int64)


def _as_int32(w):
    """int64 words below 2**32 as their int32 bits, numpy or torch."""
    if isinstance(w, np.ndarray):
        return w.astype(np.uint32).view(np.int32)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32).contiguous()


def value_words(feat, lo, hi):
    """(R, K) int32: each cell of a uint16, int32 or float32 list as the
    offsets of its two lookups in the value tables, ``lo_at | hi_at << 16``
    (bits as uint32), ``lo_at = f * GE_STRIDE + L``, ``hi_at = f *
    GE_STRIDE + H``.  For a query bin q in [0, 255] the cell's lower half
    is GE[f][L] and an inclusive upper half ~GE[f][H], an exclusive one
    ~GE[f][H - 1] (GE[f][-1] all ones, GE[f][256] and GE[f][257] 0).
    Integer bounds: L = clip(lo, 0, 256), H = clip(hi + 1, 0, 257); float32
    (the tau = 0 indicator lo < q < hi): L = clip(floor(lo) + 1, 0, 256), H
    = clip(ceil(hi) + 1, 0, 257).  Features below ``BITMAP_FEATURES``;
    numpy or torch as given."""
    L, H = _value_lookups(lo, hi)
    base = (feat.astype(np.int64) if isinstance(feat, np.ndarray)
            else feat.to(torch.int64)) * GE_STRIDE
    return _as_int32((base + L) | ((base + H) << 16))


def window_words(feat, lo, hi):
    """(R, K) int32: each cell of a uint16, int32 or float32 list as its
    cluster member and the offsets of its lookups in that member's value
    tables, ``lo_at | (H - L + 256) << 16 | m << 26`` (bits as uint32): m =
    f // BITMAP_FEATURES, the member that holds feature f, ``lo_at = (f -
    m * BITMAP_FEATURES) * GE_STRIDE + L`` (below 2**16) and the upper
    lookup ``lo_at + H - L`` (L and H as ``value_words``' clamps).
    Features below ``MAX_MEMBERS * BITMAP_FEATURES``; numpy or torch as
    given."""
    L, H = _value_lookups(lo, hi)
    f = feat.astype(np.int64) if isinstance(feat, np.ndarray) else feat.to(torch.int64)
    m = f // BITMAP_FEATURES
    lo_at = (f - m * BITMAP_FEATURES) * GE_STRIDE + L
    return _as_int32(lo_at | ((H - L + 256) << 16) | (m << 26))


def packing(cells: "CellList") -> str | None:
    """The packed words a list of its dtype and span carries: "cell"
    (uint8, any span), "value" (span up to ``BITMAP_FEATURES``), "window"
    (up to ``MAX_MEMBERS`` windows of it), else None (the kernels search
    ranks).  A float32 list with a NaN bound carries none either."""
    if _np_dtype(cells.lo) == np.uint8:
        return "cell"
    if cells.span <= BITMAP_FEATURES:
        return "value"
    return "window" if cells.span <= MAX_MEMBERS * BITMAP_FEATURES else None


_PACKERS = {"cell": cell_words, "value": value_words, "window": window_words}


def _used_bounds(cells: "CellList"):
    """The bounds in the used slots of a list, lo then hi, as float64
    (numpy or torch as the list holds them)."""
    K = int(cells.feat.shape[1])
    if isinstance(cells.lo, np.ndarray):
        used = np.arange(K)[None, :] < cells.count[:, None]
        return np.concatenate([cells.lo[used], cells.hi[used]]).astype(np.float64)
    used = torch.arange(K, device=cells.count.device)[None, :] < cells.count[:, None]
    return torch.cat([cells.lo[used], cells.hi[used]]).double()


def _nan_bounds(cells: "CellList") -> bool:
    """Whether a used slot of a float32 list holds a NaN bound."""
    if _np_dtype(cells.lo) != np.float32:
        return False
    v = _used_bounds(cells)
    return bool(np.isnan(v).any() if isinstance(v, np.ndarray) else torch.isnan(v).any())


# the soft kernel's lattice: bounds that are half-integers within this
# magnitude (and integer queries within it) index its log-sigmoid table
LATTICE_MAX = 256.0


def on_lattice(cells: "CellList") -> bool:
    """Whether every finite bound in the used slots of a float32 list is a
    half-integer of magnitude at most ``LATTICE_MAX`` (the soft encoding
    of a table of at most 256 bins is)."""
    v = _used_bounds(cells)
    if isinstance(v, np.ndarray):
        v = v[np.isfinite(v)]
        return bool(((v - 0.5 == np.floor(v)) & (np.abs(v) <= LATTICE_MAX)).all())
    v = v[torch.isfinite(v)]
    return bool(((v - 0.5 == torch.floor(v)) & (v.abs() <= LATTICE_MAX)).all())


# rows of the table scanned at a time by ``binding_cells``: bounds its
# boolean and index temporaries to a few tens of MB at F_pad = 256
CELL_SCAN_ROWS = 1 << 14


def binding_cells(
    low: np.ndarray,
    high: np.ndarray,
    *,
    n_bins: int,
    inclusive: bool,
    n_real_rows: int,
) -> CellList:
    """The ``CellList`` of a padded, packed table (any layout of
    ``pack_tables``/``pad_tables``): every cell of a row that is not the
    wildcard (``wildcard_cells``), in ascending feature order.  Rows from
    ``n_real_rows`` on are the never-match padding rows, whose cells are
    all alike: each is listed as one cell, its first, since the AND (or
    sum) of one equals that of all.  K is the largest count, at least 1.
    Scanned once in ``CELL_SCAN_ROWS``-row blocks, so host memory stays
    bounded at full width (each block's mask; the listed cells' indices,
    6 bytes a cell, are kept for the fill)."""
    R, F = low.shape
    if high.shape != low.shape:
        raise ValueError(f"low {low.shape} and high {high.shape} differ")
    if F > np.iinfo(np.uint16).max + 1:
        raise ValueError(f"{F} features do not fit the cell list's uint16 index")
    n_real = int(n_real_rows)
    if not 0 <= n_real <= R:
        raise ValueError(f"n_real_rows={n_real_rows} outside [0, {R}]")
    pad_lo, pad_hi = low[n_real:], high[n_real:]
    if not ((pad_lo == pad_lo[:, :1]) & (pad_hi == pad_hi[:, :1])).all():
        raise ValueError(f"rows from {n_real} on are not uniform padding rows")

    def listed(r0: int, r1: int) -> np.ndarray:
        act = ~wildcard_cells(low[r0:r1], high[r0:r1], n_bins=n_bins, inclusive=inclusive)
        pad = max(0, r1 - max(r0, n_real))  # padding rows in this block
        if pad:
            act[-pad:] = False
            act[-pad:, 0] = True
        return act

    # one scan: each block's listed (row, column) pairs, row-major (ascending
    # features), kept until K, the largest count, is known
    count = np.empty(R, dtype=np.int32)
    blocks = []
    for r0 in range(0, R, CELL_SCAN_ROWS):
        r1 = min(R, r0 + CELL_SCAN_ROWS)
        rows, cols = np.nonzero(listed(r0, r1))
        count[r0:r1] = np.bincount(rows, minlength=r1 - r0)
        blocks.append((r0, r1, rows.astype(np.int32), cols.astype(np.uint16)))
    K = max(1, int(count.max(initial=0)))
    feat = np.zeros((R, K), dtype=np.uint16)
    lo = np.zeros((R, K), dtype=low.dtype)
    hi = np.zeros((R, K), dtype=high.dtype)
    for r0, r1, rows, cols in blocks:
        start = np.cumsum(count[r0:r1]) - count[r0:r1]
        slot = np.arange(rows.size) - np.repeat(start, count[r0:r1])
        feat[r0 + rows, slot] = cols
        lo[r0 + rows, slot] = low[r0 + rows, cols]
        hi[r0 + rows, slot] = high[r0 + rows, cols]
    return CellList(count, feat, lo, hi, F)


def check_query_range(q, dtype: str) -> None:
    """Reject bins a narrowing cast would WRAP (host-side or on the device).

    A packed engine casting bin 300 to uint8 would wrap it to 44 and match
    rows it must not.  Callers binning with the model's own quantizer
    never trip this.  ``q`` is a numpy array or a torch tensor.
    """
    dt, qdt = np.dtype(dtype), _np_dtype(q)
    is_tensor = isinstance(q, torch.Tensor)
    if dt.kind != "u" or (q.numel() if is_tensor else q.size) == 0:
        return
    if qdt.kind == "u" and qdt.itemsize <= dt.itemsize:
        return  # widening or same-width unsigned: no wrap possible
    if is_tensor:
        lim = torch.aminmax(q.to(torch.int64))
        mn, mx = int(lim.min), int(lim.max)
    else:
        mn, mx = int(q.min()), int(q.max())
    if mn < 0 or mx > np.iinfo(dt).max:
        raise ValueError(
            f"query bins in [{mn}, {mx}] do not fit table dtype {dtype!r} "
            f"(max {np.iinfo(dt).max}); were these binned with the model's "
            "quantizer?"
        )


def pad_queries(q, f_pad: int, b_blk: int = 1, dtype: str = "int32",
                device=None) -> torch.Tensor:
    B, _ = q.shape
    return pad_to_bucket(q, _ceil_to(B, b_blk), f_pad, dtype=dtype, device=device)


def pad_to_bucket(
    q, bucket_b: int, f_pad: int, dtype: str = "int32", device=None
) -> torch.Tensor:
    """Pad a query batch (numpy array or tensor) to an explicit bucket shape.

    Batch rows beyond ``B`` are zero vectors — they produce margins that
    the caller discards; feature columns beyond ``F`` are zero, which the
    always-match column padding of ``pad_tables`` ignores.  ``dtype`` is
    the engine's table dtype — queries compare natively against packed
    tables, and as float32 bins against soft tables (exact below 2**24).
    The result lives on ``device`` (default: ``q``'s own device).
    """
    B, F = q.shape
    if B > bucket_b:
        raise ValueError(f"batch {B} exceeds bucket {bucket_b}")
    if F > f_pad:
        raise ValueError(f"features {F} exceed padded width {f_pad}")
    check_query_range(q, dtype)
    q = torch.tensor(q) if isinstance(q, np.ndarray) else q  # copies read-only views too
    device = q.device if device is None else torch.device(device)
    tdt = TORCH_DTYPES[dtype]
    out = torch.zeros((bucket_b, f_pad), dtype=tdt, device=device)
    if tdt.is_floating_point:
        out[:B, :F] = q.to(device=device, dtype=tdt)
    else:  # int64 -> narrow casts wrap like numpy's; check_query_range ran first
        out[:B, :F] = q.to(device=device, dtype=torch.int64).to(tdt)
    return out


def write_queries(q: np.ndarray, out: np.ndarray, dtype: str,
                  columns: np.ndarray | None = None) -> int:
    """Write integer query bins into ``out[:B, :F]`` as ``pad_to_bucket``'s
    rows hold them, in one numpy pass; returns F.

    ``columns`` (the engine's selection and permutation in one index, or
    None for every column) are taken as the bins are written; ``out`` is
    a numpy buffer of the table dtype (pinned memory, for the engine's
    staging slot) whose columns past F the caller keeps zero.  The range
    check reads the selected bins, so a dropped column out of range raises
    nothing, as in ``pad_to_bucket``; in-range bins narrow to the same
    values as its int64 route, and float32 holds them exactly below 2**24.
    """
    B, F = q.shape[0], (q.shape[1] if columns is None else len(columns))
    if F > out.shape[1]:
        raise ValueError(f"features {F} exceed padded width {out.shape[1]}")
    try:
        check_query_range(q, dtype)
    except ValueError:
        if columns is None:
            raise
        q, columns = q[:, columns], None  # only the selected bins count
        check_query_range(q, dtype)
    if columns is not None and q.dtype == out.dtype:
        # 'clip' writes straight into out (the default mode buffers); take
        # casts only some dtype pairs, so others gather first
        np.take(q, columns, axis=1, out=out[:B, :F], mode="clip")
    else:
        np.copyto(out[:B, :F], q if columns is None else q[:, columns], casting="unsafe")
    return F


def cam_match(
    q_padded: torch.Tensor,
    low: torch.Tensor,
    high: torch.Tensor,
    leaf: torch.Tensor,
    cells: CellList | None = None,
    bias: torch.Tensor | None = None,
    *,
    out_b: int,
    out_c: int,
    mode: str = "direct",
    tau: float = 0.0,
) -> torch.Tensor:
    """Kernel entry on pre-padded operands; returns unpadded (out_b, out_c).

    CUDA tensors launch the Hopper kernels (``kernels.cam_match``: the
    soft wrappers for ``mode='soft'``, which run the bit-parallel hard
    kernel at tau = 0 and the soft kernel at tau > 0; the hard wrappers
    otherwise) on the
    table's ``cells`` (``binding_cells``, on the card) — they either run
    or raise; CPU tensors take the plain version on the dense ``low`` /
    ``high``.  ``bias`` is the optional (1, C_pad) fused-epilogue row,
    added once after the row sum (bit-identical to adding it after an
    unfused call); callers fusing it must NOT add the base score again
    downstream.  ``tau`` is the soft temperature in bin units; hard modes
    ignore it.
    """
    if q_padded.is_cuda:
        from repro_torch.kernels import cam_match as K

        if mode == "soft":
            out = K.cam_match_soft_cuda(q_padded, cells, leaf, bias, tau=tau)
        else:
            out = K.cam_match_cuda(q_padded, cells, leaf, bias, mode=mode)
    elif q_padded.device.type == "cpu":
        out = cam_match_ref(q_padded, low, high, leaf, mode=mode, tau=tau)
        if bias is not None:
            out = out + bias
    else:
        raise ValueError(f"no cam_match implementation for device {q_padded.device}")
    return out[:out_b, :out_c]
