"""The per-row cell list (``kernels/ops.py`` ``binding_cells``) against the
JAX package: the list leaves out only exact no-ops.

The Hopper kernels read a table as each row's non-wildcard cells, in
ascending feature order, with every never-match padding row listed as its
one first cell.  Here, on the CPU:

(a) the list holds exactly those cells of the padded table, for uint8,
    uint16 and int32 in both encodings, the float32 soft layout, a ragged
    row count and perturbed tables with never-match cells; the tiles it
    touches are the JAX package's wildcard tile mask;
(b) a plain evaluator over the list, written here in the kernels' order
    (AND, or log-score sum, over the listed cells in ascending feature
    order), against ``repro.kernels.ref.cam_match_bits_ref`` /
    ``cam_match_ref`` on the same seeded numpy inputs: match bits exact in
    all four hard modes, margins equal on k/16 leaves, soft tau = 0 exact,
    soft tau > 0 within ``soft_score_bound`` / ``soft_margin_bound``;
(c) the list is the same built in any row blocks, checks its own shape,
    and the engine binds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracles import random_cam_table, random_tables

from repro.core import precision as jprec
from repro.kernels import ops as jops
from repro.kernels.ref import cam_match_bits_ref as j_bits_ref
from repro.kernels.ref import cam_match_ref as j_ref
from repro_torch.core.compile import CAMTable
from repro_torch.core.deploy import DeployConfig
from repro_torch.core.engine import XTimeEngine
from repro_torch.core.precision import get_cell_mode, soft_cell_logscore
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import soft_margin_bound, soft_score_bound

B, R, F, C = 37, 90, 13, 3  # R = 90 does not tile by R_BLK: 6 padding rows
R_BLK, F_BLK = 32, 8

LAYOUTS = [  # (table dtype, inclusive encoding, n_bins)
    ("uint8", True, 256), ("uint16", True, 1000), ("int32", False, 256),
    ("int32", True, 256), ("uint8", False, 200), ("uint16", False, 1000),
    ("float32", False, 256),
]
HARD = [  # (table dtype, kernel mode, n_bins): every hard kernel variant
    ("int32", "direct", 256), ("int32", "inclusive", 256),
    ("int32", "msb_lsb", 256), ("int32", "two_cycle", 256),
    ("uint8", "inclusive", 256), ("uint16", "inclusive", 1000),
    ("uint8", "direct", 200), ("uint16", "direct", 1000),
]


def _tables(rng, n_bins, *, perturbed=False):
    """Seeded exclusive-high int32 tables (``tests/oracles.py``); perturbed
    ones get 2% never-match cells (high <= low) and, for a wide enough
    grid, bounds shifted by ±3 bins, negative and past the grid."""
    low, high = random_tables(rng, R, F, n_bins)
    if perturbed:
        low = low + rng.integers(-3, 4, size=low.shape).astype(np.int32)
        high = high + rng.integers(-3, 4, size=high.shape).astype(np.int32)
        bad = rng.random((R, F)) < 0.02
        high[bad] = low[bad]
    return low, high


def _packed(low, high, leaf, dtype, inclusive, n_bins):
    """The padded table in the kernel layout: ``pack_tables`` for the
    inclusive and soft layouts, ``pad_tables`` + a cast for exclusive."""
    if inclusive or dtype == "float32":
        lo, hi, lm, _ = tops.pack_tables(low, high, leaf, r_blk=R_BLK, f_blk=F_BLK,
                                         n_bins=n_bins, dtype=dtype,
                                         inclusive=True if inclusive else None)
    else:
        lo, hi, lm = tops.pad_tables(low, high, leaf, r_blk=R_BLK, f_blk=F_BLK, n_bins=n_bins)
        lo, hi = lo.astype(dtype), hi.astype(dtype)
    return lo, hi, lm


def _problem(seed, dtype, inclusive, n_bins, *, perturbed=False, normal=False):
    rng = np.random.default_rng(seed)
    low, high = _tables(rng, n_bins, perturbed=perturbed)
    if normal:
        leaf = rng.normal(size=(R, C)).astype(np.float32)
    else:
        leaf = (rng.integers(-16, 17, size=(R, C)) / 16.0).astype(np.float32)
    q = rng.integers(0, n_bins, size=(B, F))
    q[:3], q[3:6] = 0, n_bins - 1  # grid-edge queries
    # rows widened to hold a query, so every problem has matches
    rows = np.arange(0, R, 5)
    low[rows] = np.minimum(low[rows], q[rows % B])
    high[rows] = np.maximum(high[rows], q[rows % B] + 1)
    lo, hi, lm = _packed(low, high, leaf, dtype, inclusive, n_bins)
    qp = np.zeros((B, lo.shape[1]), dtype=lo.dtype)
    qp[:, :F] = q
    cells = tops.binding_cells(lo, hi, n_bins=n_bins, inclusive=inclusive, n_real_rows=R)
    return qp, lo, hi, lm, cells


# -- (a) what the list holds ---------------------------------------------------


# perturbed tables take the int32 or float32 layout (pack_tables refuses packed ones)
@pytest.mark.parametrize("dtype,inclusive,n_bins,perturbed", [
    *((*lay, False) for lay in LAYOUTS),
    *((*lay, True) for lay in LAYOUTS if lay[0] in ("int32", "float32")),
])
def test_list_holds_exactly_the_non_wildcard_cells(dtype, inclusive, n_bins, perturbed):
    _, lo, hi, _, cells = _problem(1, dtype, inclusive, n_bins, perturbed=perturbed)
    R_pad = lo.shape[0]
    assert R_pad > R and cells.width == lo.shape[1]
    assert cells.lo.dtype == lo.dtype and cells.hi.dtype == hi.dtype
    if dtype == "float32":
        wild = np.isneginf(lo) & np.isposinf(hi)
    else:
        top = n_bins - 1 if inclusive else n_bins
        wild = (lo == 0) & (hi >= top)
    assert cells.k == max(1, int(cells.count.max()))
    for r in range(R_pad):
        n = int(cells.count[r])
        want = np.nonzero(~wild[r])[0] if r < R else np.array([0])
        np.testing.assert_array_equal(cells.feat[r, :n], want)  # ascending
        assert cells.lo[r, :n].tobytes() == lo[r, want].tobytes()
        assert cells.hi[r, :n].tobytes() == hi[r, want].tobytes()
        assert not cells.feat[r, n:].any() and not cells.lo[r, n:].any()
    # padding rows: never-match, all cells alike, one listed
    assert (cells.count[R:] == 1).all()
    if dtype == "float32":
        assert np.isposinf(cells.lo[R:, 0]).all() and np.isneginf(cells.hi[R:, 0]).all()
    else:
        assert (cells.lo[R:, 0] == 1).all() and (cells.hi[R:, 0] == 0).all()
    if perturbed:  # never-match cells of real rows are listed, not dropped
        never = (hi[:R] < lo[:R]) if dtype != "float32" else np.isposinf(lo[:R])
        assert never.any() and (cells.count[:R] >= never.sum(axis=1)).all()


@pytest.mark.parametrize("dtype,inclusive,n_bins", LAYOUTS)
def test_listed_cells_touch_the_jax_tile_mask(dtype, inclusive, n_bins):
    """A tile holds a listed cell exactly where the JAX package's wildcard
    tile mask marks it active: both use one wildcard test."""
    _, lo, hi, _, cells = _problem(2, dtype, inclusive, n_bins)
    listed = np.zeros(lo.shape, dtype=bool)
    for r in range(lo.shape[0]):
        listed[r, cells.feat[r, : cells.count[r]]] = True
    # padding rows list one cell; the mask marks their whole row active
    listed[R:] = True
    tiles = listed.reshape(lo.shape[0] // R_BLK, R_BLK, -1, F_BLK).any(axis=(1, 3))
    jmask = jops.wildcard_tile_mask(lo, hi, r_blk=R_BLK, f_blk=F_BLK, n_bins=n_bins,
                                    inclusive=inclusive)
    np.testing.assert_array_equal(tiles.astype(np.int32), np.asarray(jmask))
    np.testing.assert_array_equal(
        tops.wildcard_tile_mask(lo, hi, r_blk=R_BLK, f_blk=F_BLK, n_bins=n_bins,
                                inclusive=inclusive), jmask)


# -- (b) a plain evaluator over the list, against the JAX package ------------


def _gather(cells, k, q):
    f = torch.from_numpy(cells.feat[:, k].astype(np.int64))
    used = torch.from_numpy(k < cells.count)[None, :]  # (1, R)
    return q[:, f], torch.from_numpy(cells.lo[:, k])[None, :], \
        torch.from_numpy(cells.hi[:, k])[None, :], used


def list_bits(q: torch.Tensor, cells, mode: str) -> torch.Tensor:
    """(B, R) match lines: the AND of each row's listed cells, in order."""
    match = get_cell_mode(mode).match
    ok = torch.ones((q.shape[0], cells.count.shape[0]), dtype=torch.bool)
    for k in range(cells.k):
        qv, lo, hi, used = _gather(cells, k, q)
        ok &= match(qv, lo, hi) | ~used
    return ok


def list_scores(q: torch.Tensor, cells, tau: float) -> torch.Tensor:
    """(B, R) soft scores: exp of each row's listed log-scores, added in
    ascending feature order in float32."""
    acc = torch.zeros((q.shape[0], cells.count.shape[0]), dtype=torch.float32)
    for k in range(cells.k):
        qv, lo, hi, used = _gather(cells, k, q)
        acc = acc + torch.where(used, soft_cell_logscore(qv, lo, hi, tau), 0.0)
    return torch.exp(acc)


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("dtype,mode,n_bins,perturbed", [
    *((*v, False) for v in HARD), *((*v, True) for v in HARD if v[0] == "int32"),
])
def test_list_evaluator_matches_jax_bits_and_margins(dtype, mode, n_bins, perturbed):
    qp, lo, hi, lm, cells = _problem(3, dtype, mode == "inclusive", n_bins,
                                     perturbed=perturbed)
    bits = list_bits(torch.from_numpy(qp), cells, mode)
    want = np.asarray(j_bits_ref(*_jax(qp, lo, hi), mode=mode))
    np.testing.assert_array_equal(bits.numpy(), want)
    assert want.any() and not want.all()
    margins = bits.float() @ torch.from_numpy(lm)  # k/16 leaves: order-free
    np.testing.assert_array_equal(margins.numpy(),
                                  np.asarray(j_ref(*_jax(qp, lo, hi, lm), mode=mode)))


@pytest.mark.parametrize("perturbed", [False, True], ids=["compiled", "perturbed"])
@pytest.mark.parametrize("tau", [0.0, 0.1, 0.5])
def test_list_evaluator_matches_jax_soft(tau, perturbed):
    qp, lo, hi, lm, cells = _problem(4, "float32", False, 256, perturbed=perturbed,
                                     normal=tau > 0)
    scores = list_scores(torch.from_numpy(qp), cells, tau)
    j_scores = np.array(jprec.soft_match_scores(*_jax(qp, lo, hi), tau))
    margins = (scores @ torch.from_numpy(lm)).numpy()
    j_margins = np.asarray(j_ref(*_jax(qp, lo, hi, lm), mode="soft", tau=tau))
    assert (scores.numpy()[:, R:] == 0).all()  # padding rows never match
    if tau == 0.0:
        np.testing.assert_array_equal(scores.numpy(), j_scores)
        np.testing.assert_array_equal(margins, j_margins)
        assert j_scores.any() and not j_scores.all()
        return
    s_ref = torch.from_numpy(j_scores)
    err_s = (scores - s_ref).abs().double()
    assert (err_s <= soft_score_bound(s_ref, lo.shape[1])).all()
    lim = soft_margin_bound(s_ref, torch.from_numpy(lm), lo.shape[1], extra=2)
    assert (torch.from_numpy(margins - j_margins).abs().double() <= lim).all()


# -- (c) blocks, checks, the engine --------------------------------------------


@pytest.mark.parametrize("dtype,inclusive,n_bins", [LAYOUTS[0], LAYOUTS[2], LAYOUTS[-1]])
def test_list_is_the_same_built_in_row_blocks(monkeypatch, dtype, inclusive, n_bins):
    _, lo, hi, _, whole = _problem(5, dtype, inclusive, n_bins)
    monkeypatch.setattr(tops, "CELL_SCAN_ROWS", 7)  # blocks that straddle the padding
    blocks = tops.binding_cells(lo, hi, n_bins=n_bins, inclusive=inclusive, n_real_rows=R)
    for a, b in ((whole.count, blocks.count), (whole.feat, blocks.feat),
                 (whole.lo, blocks.lo), (whole.hi, blocks.hi)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_list_checks_its_shape_and_padding():
    _, lo, hi, _, cells = _problem(6, "uint8", True, 256)
    with pytest.raises(ValueError, match="out of range"):
        tops.CellList(cells.count + 200, cells.feat, cells.lo, cells.hi, cells.width)
    with pytest.raises(ValueError, match="out of range"):
        tops.CellList(cells.count, cells.feat, cells.lo, cells.hi, int(cells.feat.max()))
    with pytest.raises(ValueError, match="int32"):
        tops.CellList(cells.count.astype(np.int64), cells.feat, cells.lo, cells.hi, cells.width)
    with pytest.raises(ValueError, match="shapes"):
        tops.CellList(cells.count[:-1], cells.feat, cells.lo, cells.hi, cells.width)
    with pytest.raises(ValueError, match="padding rows"):  # rows 0.. are not padding
        tops.binding_cells(lo, hi, n_bins=256, inclusive=True, n_real_rows=0)
    on = cells.to("cpu")
    assert isinstance(on.count, torch.Tensor) and on.k == cells.k
    assert torch.equal(on.feat, torch.from_numpy(cells.feat))


@pytest.mark.parametrize("mode", ["direct", "inclusive", "msb_lsb", "soft"])
def test_engine_binds_the_list_of_its_tables(mode):
    rng = np.random.default_rng(7)
    t = random_cam_table(rng, r=75, f=11)
    table = CAMTable(**{k: getattr(t, k) for k in t.__dataclass_fields__})
    eng = XTimeEngine(table, config=DeployConfig(mode=mode, r_blk=32), device="cpu")
    a = eng.arrays
    want = tops.binding_cells(a.low.numpy(), a.high.numpy(), n_bins=table.n_bins,
                              inclusive=a.inclusive, n_real_rows=table.n_rows)
    assert a.r_pad > table.n_rows and a.cells.width == a.f_pad
    for got, ref in ((a.cells.count, want.count), (a.cells.feat, want.feat),
                     (a.cells.lo, want.lo), (a.cells.hi, want.hi)):
        assert got.device == a.low.device and torch.equal(got, torch.from_numpy(ref))
    assert (a.cells.count[table.n_rows:] == 1).all()
