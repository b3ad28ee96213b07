"""The bit-parallel kernel of the uint16, int32 and float32 (soft tau = 0)
lists (``kernels/csrc/cam_match.cu``, ``cam_match_bp_kernel``) as a
plain-torch model, against both packages' references, on the CPU.

The kernel builds, once per 32-query tile, a table per feature below the
list's span and forms each row's 32-query word as the AND over its listed
cells of GE[lo side] & ~GE[hi side], by one of two routes a tile:

  * value route — the list has packed words (``CellList.words``: the two
    lookups' offsets, ``ops.value_words``) and every query of the tile is
    an integer bin in [0, 255] at the features below the span: GE[f][v]
    for v in [0, 256] (GE[f][-1] all ones, GE[f][256..258] 0), a cell's
    word GE[lo_at] & ~GE[hi_at] (an exclusive upper half one word below);
  * rank route — any other tile: per feature the tile's distinct query
    values ascending, padded to 32 with the type's largest value, GE over
    their ranks, and each bound a rank by six steps of a binary search
    with the mode's own half as the predicate.

A float32 query with a NaN or infinite feature matches no row.  The model
here does the same in torch and must equal ``repro.kernels.ref
.cam_match_bits_ref`` and ``repro_torch.kernels.ref.cam_match_bits_ref``
(soft: ``repro.core.precision.soft_match_scores`` and the port's
``soft_scores_ref`` at tau = 0) bit for bit on seeded numpy inputs: the four
modes on int32 and uint16, tables of more than 256 bins, queries past 255,
perturbed bounds (negative, past the grid, never-match), never-match
padding rows, rows of more than 8 cells, ragged tiles, a span past the
value tables' window, and soft queries with NaN, +-inf and non-integers.
Each mode's two halves are held to the precision functions of both
packages on every (q, bound) in [-300, 300]^2 and on random int32s, each
monotone in q; the value route's clamped lookups equal them on the bins.
The window constants against the kernel source close the file.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jprec
from repro.kernels.ref import cam_match_bits_ref as j_bits_ref
from repro_torch.core import precision as tprec
from repro_torch.kernels import cam_match as K
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import cam_match_bits_ref, soft_scores_ref

WORD = 32  # queries a tile
FULL = (1 << 32) - 1
GE_HEAD = 4  # words before feature 0's value table; GE[0][-1] is the last
RANK_STRIDE = 65  # 32 values, then GE[0..32]


def halves(mode: str):
    """The kernel's two halves of a cell mode (cam_match.cu's functors), on
    int64 tensors holding int32 values (arithmetic shifts as int32's) or
    float32 tensors (the soft tau = 0 indicator)."""
    if mode == "direct":
        return (lambda q, lo: lo <= q), (lambda q, hi: q < hi)
    if mode == "inclusive":
        return (lambda q, lo: lo <= q), (lambda q, hi: q <= hi)
    if mode == "msb_lsb":
        return ((lambda q, lo: (((q >> 4) >= (lo >> 4) + 1) | ((q & 15) >= (lo & 15)))
                 & ((q >> 4) >= (lo >> 4))),
                (lambda q, hi: (((q >> 4) < (hi >> 4)) | ((q & 15) < (hi & 15)))
                 & ((q >> 4) < (hi >> 4) + 1)))
    if mode == "two_cycle":
        return ((lambda q, lo: ((((q >> 4) - 1) >= (lo >> 4)) | ((q & 15) >= (lo & 15)))
                 & ((q >> 4) >= (lo >> 4))),
                (lambda q, hi: (((q >> 4) < (hi >> 4)) | ((q & 15) < (hi & 15)))
                 & (((q >> 4) - 1) < (hi >> 4))))
    if mode == "soft":
        return (lambda q, lo: q > lo), (lambda q, hi: q < hi)
    raise ValueError(mode)


def _values(t: torch.Tensor) -> torch.Tensor:
    """What the kernel compares: uint16/int32 widened exactly, float32 as is."""
    return t if t.dtype == torch.float32 else t.to(torch.int64)


def _pad_value(dtype) -> float | int:
    return {torch.float32: float("inf"), torch.int32: 2**31 - 1, torch.uint16: 2**32 - 1}[dtype]


def live_queries(qt: torch.Tensor) -> int:
    """The tile's queries that can match: all, or the float32 ones whose
    every feature is finite."""
    ok = torch.isfinite(qt).all(dim=1) if qt.dtype == torch.float32 else torch.ones(
        qt.shape[0], dtype=torch.bool)
    return sum(1 << b for b in range(qt.shape[0]) if ok[b])


def on_bins(qt: torch.Tensor, span: int) -> bool:
    """The value route's test: every query an integer bin in [0, 255] at the
    features below the span."""
    x = qt[:, :span]
    if x.dtype == torch.float32:
        return bool(((x >= 0) & (x <= 255) & (x == torch.round(x))).all())
    x = x.to(torch.int64)
    return bool(((x >= 0) & (x <= 255)).all())


def value_tables(qt: torch.Tensor, span: int) -> torch.Tensor:
    """The value route's shared memory as int64 words: GE_HEAD head words
    (the last all ones), then per feature GE[v] (bit b: query b >= v) for
    v in [0, 256], 0 at 256..258 and all ones at 259."""
    v = torch.arange(256)
    ge = (qt[:, :span].to(torch.int64).T[:, :, None] >= v[None, None, :]).to(torch.int64)
    words = (ge << torch.arange(qt.shape[0])[None, :, None]).sum(dim=1)  # (span, 256)
    tab = torch.zeros((span, tops.GE_STRIDE), dtype=torch.int64)
    tab[:, :256] = words
    tab[:, tops.GE_STRIDE - 1] = FULL
    return torch.cat([torch.tensor([0, 0, 0, FULL]), tab.reshape(-1)])


def rank_tables(qt: torch.Tensor, span: int, live: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The rank route's tables: (span, 32) values ascending, padded with the
    type's largest, and (span, 33) GE over their ranks (0 past the count)."""
    vals = torch.full((span, 32), _pad_value(qt.dtype),
                      dtype=torch.float32 if qt.dtype == torch.float32 else torch.int64)
    ge = torch.zeros((span, 33), dtype=torch.int64)
    lanes = [b for b in range(qt.shape[0]) if live >> b & 1]
    x = _values(qt[lanes, :span]) + 0  # -0 -> +0, one value
    for f in range(span):
        uniq = torch.unique(x[:, f])  # ascending
        vals[f, : uniq.numel()] = uniq
        eq = [sum(1 << lanes[i] for i in range(len(lanes)) if x[i, f] == u) for u in uniq]
        for j in range(len(eq)):
            ge[f, j] = sum(eq[j:]) if eq else 0
    return vals, ge


def rank_word(vals, ge, f, lo, hi, lower, upper) -> torch.Tensor:
    """Each cell's word by the kernel's six-step search: the count of
    values whose lower half fails, and of values whose upper half holds."""
    v = vals[f]  # (R, 32)
    jl = torch.zeros_like(f)
    ju = torch.zeros_like(f)
    for s in (16, 8, 4, 2, 1):
        jl = jl + torch.where(lower(v.gather(1, (jl + s - 1)[:, None])[:, 0], lo), 0, s)
        ju = ju + torch.where(upper(v.gather(1, (ju + s - 1)[:, None])[:, 0], hi), s, 0)
    jl = jl + torch.where(lower(v.gather(1, jl[:, None])[:, 0], lo), 0, 1)
    ju = ju + torch.where(upper(v.gather(1, ju[:, None])[:, 0], hi), 1, 0)
    g = ge[f]
    return g.gather(1, jl[:, None])[:, 0] & (~g.gather(1, ju[:, None])[:, 0] & FULL)


def model_bits(q: torch.Tensor, cells: tops.CellList, *, mode: str,
               force_rank: bool = False) -> tuple[torch.Tensor, list[str]]:
    """(B, R) match bits by the kernel's algorithm, and the route each tile
    took."""
    lower, upper = halves(mode)
    incl = mode == "inclusive"
    count = torch.as_tensor(np.asarray(cells.count)).to(torch.int64)
    feat = torch.as_tensor(np.asarray(cells.feat).astype(np.int64))
    lo, hi = (_values(torch.as_tensor(np.asarray(a))) for a in (cells.lo, cells.hi))
    R, Kslots = feat.shape
    span = max(1, cells.span)
    out, routes = [], []
    for q0 in range(0, q.shape[0], WORD):
        qt = q[q0:q0 + WORD]
        nq = qt.shape[0]
        live = live_queries(qt)
        value = (not force_rank and cells.words is not None and span <= tops.BITMAP_FEATURES
                 and on_bins(qt, span))
        routes.append("value" if value else "rank")
        word = torch.full((R,), live, dtype=torch.int64)
        if value:
            tab = value_tables(qt, span)
            w = torch.as_tensor(np.asarray(cells.words).view(np.uint32).astype(np.int64))
            lo_at, hi_at = GE_HEAD + (w & 0xFFFF), GE_HEAD + (w >> 16) - (0 if incl else 1)
            cell = tab[lo_at] & (~tab[hi_at] & FULL)
        else:
            vals, ge = rank_tables(qt, span, live)
            cell = torch.stack([rank_word(vals, ge, feat[:, k], lo[:, k], hi[:, k], lower, upper)
                                for k in range(Kslots)], dim=1)
        for k in range(Kslots):
            word = torch.where(k < count, word & cell[:, k], word)
        bits = (word[None, :] >> torch.arange(nq, dtype=torch.int64)[:, None]) & 1
        out.append(bits.to(torch.bool))
    return torch.cat(out), routes


# -- seeded problems ----------------------------------------------------------------


def _tables(rng, r, f, n_bins, q, *, wild, noisy, listed12=0):
    """Exclusive-high int32 tables with ``wild`` wildcard cells; ``noisy``
    shifts bounds by up to +-3 bins (negative and past the grid) and makes
    3% of the cells never-match (high <= low); the first ``listed12`` rows
    list 12 cells; every fourth row is widened to hold one of ``q``."""
    low = rng.integers(0, n_bins, size=(r, f)).astype(np.int32)
    high = np.minimum(low + rng.integers(1, n_bins, size=(r, f)), n_bins).astype(np.int32)
    w = rng.random((r, f)) < wild
    w[:listed12] = True
    w[:listed12, :12] = False
    low[w], high[w] = 0, n_bins
    if noisy:
        low = low + rng.integers(-3, 4, size=low.shape).astype(np.int32)
        high = high + rng.integers(-3, 4, size=high.shape).astype(np.int32)
        bad = rng.random((r, f)) < 0.03
        high[bad] = low[bad]
    rows = np.arange(0, r, 4)
    hold = q[rows % q.shape[0]]
    low[rows] = np.minimum(low[rows], hold)
    high[rows] = np.maximum(high[rows], hold + 1)
    return low, high


def _queries(rng, b, f, n_bins, small_tiles):
    """Bins in [0, n_bins); the tiles listed in ``small_tiles`` in [0, 256)."""
    q = rng.integers(0, n_bins, size=(b, f))
    for t in small_tiles:
        q[t * WORD:(t + 1) * WORD] = rng.integers(0, min(n_bins, 256),
                                                  size=q[t * WORD:(t + 1) * WORD].shape)
    return q


def _hard_operands(seed, *, dtype, mode, n_bins, b, r, f, small_tiles=(0,), wild=0.6,
                   noisy=False, listed12=0):
    rng = np.random.default_rng(seed)
    q = _queries(rng, b, f, n_bins, small_tiles)
    low, high = _tables(rng, r, f, n_bins, q, wild=wild, noisy=noisy, listed12=listed12)
    leaf = np.zeros((r, 1), np.float32)
    incl = mode == "inclusive"
    if incl:
        lo, hi, _, _ = tops.pack_tables(low, high, leaf, r_blk=32, f_blk=8, n_bins=n_bins,
                                        dtype=dtype, inclusive=True)
    else:
        lo, hi, _ = tops.pad_tables(low, high, leaf, r_blk=32, f_blk=8, n_bins=n_bins)
        lo, hi = lo.astype(dtype), hi.astype(dtype)
    cells = tops.binding_cells(lo, hi, n_bins=n_bins, inclusive=incl, n_real_rows=r)
    qp = tops.pad_queries(q, lo.shape[1], dtype=dtype, device="cpu")
    return qp, lo, hi, cells


HARD_CASES = {  # name: (dtype, n_bins, B, R, F, tiles on the bins, wild, noisy, rows of 12)
    "int32-bins": ("int32", 256, 45, 200, 19, (0, 1), 0.6, False, 0),
    "int32-1000-bins-both-routes": ("int32", 1000, 45, 200, 19, (0,), 0.6, False, 0),
    "int32-noisy-both-routes": ("int32", 1000, 64, 203, 24, (1,), 0.1, True, 10),
    "int32-noisy-on-bins": ("int32", 256, 37, 203, 24, (0, 1), 0.1, True, 10),
    "uint16-1000-bins-both-routes": ("uint16", 1000, 45, 200, 19, (1,), 0.6, False, 0),
    "uint16-bins-B1": ("uint16", 256, 1, 90, 16, (0,), 0.5, False, 0),
    "uint16-4096-bins-ragged": ("uint16", 4096, 37, 203, 16, (), 0.5, False, 12),
    "int32-span-past-window": ("int32", 256, 40, 96, 300, (0, 1), 0.97, False, 0),
}
MODES = {"int32": ("direct", "inclusive", "msb_lsb", "two_cycle"),
         "uint16": ("direct", "inclusive")}


@pytest.mark.parametrize("case,mode", [(c, m) for c, v in HARD_CASES.items()
                                       for m in MODES[v[0]]])
def test_both_routes_equal_both_references(case, mode):
    dtype, n_bins, b, r, f, small, wild, noisy, listed12 = HARD_CASES[case]
    q, lo, hi, cells = _hard_operands(list(HARD_CASES).index(case), dtype=dtype, mode=mode,
                                      n_bins=n_bins, b=b, r=r, f=f, small_tiles=small,
                                      wild=wild, noisy=noisy, listed12=listed12)
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    want = cam_match_bits_ref(q, lo_t, hi_t, mode=mode)
    jwant = np.asarray(j_bits_ref(jnp.asarray(q.numpy()), jnp.asarray(lo), jnp.asarray(hi),
                                  mode=mode))
    assert np.array_equal(want.numpy(), jwant)
    assert want.any() and not want.all()
    got, routes = model_bits(q, cells, mode=mode)
    assert torch.equal(got, want)
    ranked, _ = model_bits(q, cells, mode=mode, force_rank=True)
    assert torch.equal(ranked, want)  # the rank route on the value route's tiles too
    # the routes and edges the case covers
    tiles = -(-b // WORD)
    span_fits = cells.span <= tops.BITMAP_FEATURES
    assert (cells.words is not None) == span_fits
    expect = ["value" if t in small and span_fits else "rank" for t in range(tiles)]
    if n_bins <= 256 and span_fits:
        expect = ["value"] * tiles  # every bin is on the value tables
    assert routes == expect
    if case == "int32-span-past-window":
        assert not span_fits and routes == ["rank"] * tiles
    cnt = np.asarray(cells.count)
    assert (cnt[r:] == 1).all() and not want[:, r:].any()  # never-match padding rows
    if listed12:
        assert cells.k > 8
    if noisy:
        used = np.arange(cells.k)[None, :] < cnt[:, None]
        assert (np.asarray(cells.lo)[used] < 0).any() and (np.asarray(cells.hi)[used] > n_bins).any()


def _soft_operands(seed, *, b=45, r=200, f=19, perturbed=False, odd=0.0):
    """Soft-encoded float32 tables of a 256-bin grid with their cell list,
    and float32 queries: bins, the second tile's with a fraction ``odd`` of
    its entries NaN, +-inf, half bins, -1 or 300."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 256, size=(b, f))
    low, high = _tables(rng, r, f, 256, q, wild=0.6, noisy=False)
    if perturbed:
        bad = rng.random((r, f)) < 0.02
        high[bad] = low[bad]
    leaf = np.zeros((r, 1), np.float32)
    lo, hi, _, _ = tops.pack_tables(low, high, leaf, r_blk=32, f_blk=8, n_bins=256,
                                    dtype="float32")
    cells = tops.binding_cells(lo, hi, n_bins=256, inclusive=False, n_real_rows=r)
    qp = tops.pad_queries(q, lo.shape[1], dtype="float32", device="cpu")
    if odd:
        tile = qp[WORD:2 * WORD]
        pick = torch.from_numpy(rng.random(tile.shape) < odd)
        odd_values = torch.tensor([float("nan"), float("inf"), -float("inf"), 2.5, -1.0, 300.0,
                                   -0.0])
        tile[pick] = odd_values[torch.from_numpy(rng.integers(0, 7, size=int(pick.sum())))]
    return qp, lo, hi, cells


SOFT_CASES = {  # name: (B, perturbed, fraction of odd entries in tile 1)
    "bins": (45, False, 0.0),
    "perturbed": (45, True, 0.0),
    "odd-queries": (45, False, 0.02),
    "odd-queries-perturbed": (64, True, 0.1),
    "B1": (1, False, 0.0),
}


@pytest.mark.parametrize("case", list(SOFT_CASES))
def test_tau_zero_scores_equal_both_soft_references(case):
    b, perturbed, odd = SOFT_CASES[case]
    q, lo, hi, cells = _soft_operands(list(SOFT_CASES).index(case) + 20, b=b,
                                      perturbed=perturbed, odd=odd)
    want = soft_scores_ref(q, torch.from_numpy(lo), torch.from_numpy(hi), tau=0.0)
    jwant = np.asarray(jprec.soft_match_scores(jnp.asarray(q.numpy()), jnp.asarray(lo),
                                               jnp.asarray(hi), 0.0))
    assert np.array_equal(want.numpy(), jwant)
    assert (want == 1).any() and ((want == 0) | (want == 1)).all()
    got, routes = model_bits(q, cells, mode="soft")
    assert torch.equal(got.to(torch.float32), want)
    ranked, _ = model_bits(q, cells, mode="soft", force_rank=True)
    assert torch.equal(ranked.to(torch.float32), want)
    assert cells.words is not None
    assert routes == ["value"] + (["rank"] if odd else ["value"] * (len(routes) - 1))
    if odd:  # a query with a NaN or infinite feature matches nothing
        dead = ~torch.isfinite(q).all(dim=1)
        assert dead.any() and not want[dead].any()
        assert (want[WORD:2 * WORD][~dead[WORD:2 * WORD]] == 1).any()
    if perturbed:
        assert not want[:, torch.isposinf(torch.from_numpy(lo)).any(dim=1)].any()


def test_a_nan_bound_takes_the_rank_route():
    """A listed NaN bound compares false: no lookup holds it, so the list
    packs no words and every tile searches ranks."""
    q, lo, hi, _ = _soft_operands(40)
    lo = lo.copy()
    lo[3, 2] = np.nan  # a cell of row 3, now never matching
    cells = tops.binding_cells(lo, hi, n_bins=256, inclusive=False, n_real_rows=200)
    assert cells.words is None
    want = soft_scores_ref(q, torch.from_numpy(lo), torch.from_numpy(hi), tau=0.0)
    got, routes = model_bits(q, cells, mode="soft")
    assert routes == ["rank", "rank"] and torch.equal(got.to(torch.float32), want)
    assert not want[:, 3].any()


# -- each mode's halves -------------------------------------------------------------

BIG = 1 << 20
HARD_MODES = ("direct", "inclusive", "msb_lsb", "two_cycle")


def _both_matches(mode, q, lo, hi):
    """The cell function of both packages on int32 values: (JAX, torch)."""
    j = np.asarray(jprec.CELL_MODES[mode].match(jnp.asarray(q, jnp.int32), jnp.asarray(lo, jnp.int32),
                                                jnp.asarray(hi, jnp.int32)))
    t = tprec.get_cell_mode(mode).match(*(torch.as_tensor(np.asarray(a, np.int32))
                                          for a in (q, lo, hi))).numpy()
    return j, t


@pytest.mark.parametrize("mode", HARD_MODES)
def test_each_half_equals_the_match_function_exhaustively(mode):
    """Every (q, bound) in [-300, 300]^2: each half is the mode's function
    with the other bound out of reach, and monotone in q."""
    lower, upper = halves(mode)
    g = np.arange(-300, 301)
    qq, bb = np.meshgrid(g, g, indexing="ij")  # q along axis 0
    qt, bt = torch.from_numpy(qq).to(torch.int64), torch.from_numpy(bb).to(torch.int64)
    lw, up = lower(qt, bt), upper(qt, bt)
    assert upper(qt, torch.full_like(qt, BIG)).all() and lower(qt, torch.full_like(qt, -BIG)).all()
    for got, (lo, hi) in ((lw, (bb, np.full_like(bb, BIG))), (up, (np.full_like(bb, -BIG), bb))):
        j, t = _both_matches(mode, qq, lo, hi)
        assert np.array_equal(j, got.numpy()) and np.array_equal(t, got.numpy())
    # monotone in q: lower never falls, upper never rises
    assert (lw[1:].to(torch.int8) >= lw[:-1].to(torch.int8)).all()
    assert (up[1:].to(torch.int8) <= up[:-1].to(torch.int8)).all()


@pytest.mark.parametrize("mode", HARD_MODES)
def test_halves_on_random_int32(mode):
    """Random int32 triples (extremes included): the mode's function is the
    AND of its halves; each half is monotone along sorted queries."""
    rng = np.random.default_rng(HARD_MODES.index(mode))
    edge = np.array([-2**31, -2**31 + 1, -17, -16, -1, 0, 15, 16, 255, 256, 2**31 - 2,
                     2**31 - 1])
    n = 200_000
    q, lo, hi = (np.concatenate([rng.integers(-2**31, 2**31, size=n - 1000, dtype=np.int64),
                                 rng.choice(edge, size=1000)]) for _ in range(3))
    lower, upper = halves(mode)
    want = (lower(torch.from_numpy(q), torch.from_numpy(lo))
            & upper(torch.from_numpy(q), torch.from_numpy(hi))).numpy()
    j, t = _both_matches(mode, q, lo, hi)
    assert np.array_equal(j, want) and np.array_equal(t, want)
    qs = torch.from_numpy(np.sort(q))
    for b in np.concatenate([rng.choice(q, 20), edge]):
        lw = lower(qs, torch.full_like(qs, int(b))).to(torch.int8)
        up = upper(qs, torch.full_like(qs, int(b))).to(torch.int8)
        assert (lw[1:] >= lw[:-1]).all() and (up[1:] <= up[:-1]).all()


@pytest.mark.parametrize("mode", [*HARD_MODES, "soft"])
def test_value_lookups_equal_the_halves_on_the_bins(mode):
    """On the bins q in [0, 255], each half equals its clamped lookup in
    GE (``ops.value_words``'s offsets), bounds from -300 to 300 (integers,
    or for the soft indicator half-integers, integers, +-inf)."""
    lower, upper = halves(mode)
    q = torch.arange(256)
    if mode == "soft":
        b = torch.cat([torch.arange(-300, 301).float(), torch.arange(-300, 301).float() + 0.5,
                       torch.tensor([float("inf"), -float("inf")])])
        qv, feat = q.float(), torch.zeros((b.numel(), 1), dtype=torch.int32)
        w = tops.value_words(feat, b[:, None], b[:, None])
    else:
        b = torch.arange(-300, 301)
        qv = q
        w = tops.value_words(np.zeros((b.numel(), 1), np.uint16),
                             b.numpy().astype(np.int32)[:, None], b.numpy().astype(np.int32)[:, None])
        w = torch.from_numpy(np.asarray(w))
    w = w[:, 0].to(torch.int64) & FULL
    lo_at, hi_at = w & 0xFFFF, (w >> 16) - (0 if mode == "inclusive" else 1)
    def ge(at):  # GE[at] over the bins; GE[-1] all ones
        return (q[None, :] >= at[:, None]) | (at[:, None] < 0)

    assert torch.equal(ge(lo_at), lower(qv[None, :], b[:, None]))
    assert torch.equal(~ge(hi_at), upper(qv[None, :], b[:, None]))


def test_window_constants_match_the_kernel_source():
    """The value and rank tables' strides and windows, and the head, as the
    kernel source defines them, equal the Python side's."""
    src = {p.name: p.read_text() for p in (*K.SOURCES, *K.HEADERS)}
    cu = src["cam_match.cu"]
    smem = int(re.search(r"constexpr int kMaxSmem = (\d+);", src["cam_match_common.cuh"])[1])
    ge_stride = int(re.search(r"constexpr int kGeStride = (\d+);", cu)[1])
    head = int(re.search(r"constexpr int kHead = (\d+);", cu)[1])
    assert re.search(r"constexpr int kRankStride = 32 \+ 33;", cu)
    assert "kRankWindow = (kMaxSmem - kHead * 4) / (kRankStride * 4)" in cu
    assert "kMaxWindow = kMaxSmem / (kGeStride * 4)" in cu
    assert re.search(r"if \(l\.span > kRankWindow\) return launch_lanes", cu)
    assert head == GE_HEAD and ge_stride == tops.GE_STRIDE
    assert tops.BITMAP_FEATURES == smem // (ge_stride * 4) == K.BITMAP_FEATURES
    assert tops.BITMAP_FEATURES * ge_stride * 4 + head * 4 <= smem
    assert K.RANK_FEATURES == (smem - head * 4) // (RANK_STRIDE * 4) == 893
    # the offsets of a value word fit its 16-bit halves at the window's edge
    assert (tops.BITMAP_FEATURES - 1) * ge_stride + 257 < 1 << 16
