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

import copy
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
    x = qt[:, :span].to(torch.int64)  # (queries, span) bins
    eq = torch.zeros((span, 256), dtype=torch.int64)  # EQ[f][v]: the queries at v
    eq.index_put_((torch.arange(span)[None, :].expand_as(x), x),
                  (1 << torch.arange(qt.shape[0]))[:, None].expand_as(x), accumulate=True)
    tab = torch.zeros((span, tops.GE_STRIDE), dtype=torch.int64)
    tab[:, :256] = eq.flip(1).cumsum(1).flip(1)  # GE[f][v]: the sum (OR) of EQ at v and up
    tab[:, tops.GE_STRIDE - 1] = FULL
    return torch.cat([torch.tensor([0, 0, 0, FULL]), tab.reshape(-1)])


def rank_tables(qt: torch.Tensor, span: int, live: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The rank route's tables: (span, 32) values ascending, padded with the
    type's largest, and (span, 33) GE over their ranks (0 past the count)."""
    vals = torch.full((span, 32), _pad_value(qt.dtype),
                      dtype=torch.float32 if qt.dtype == torch.float32 else torch.int64)
    ge = torch.zeros((span, 33), dtype=torch.int64)
    lanes = torch.tensor([b for b in range(qt.shape[0]) if live >> b & 1], dtype=torch.int64)
    if lanes.numel() == 0:
        return vals, ge
    x = _values(qt[lanes, :span]) + 0  # (lanes, span); -0 -> +0, one value
    order = torch.arange(lanes.numel())
    # a lane leads its value where no earlier lane holds the same one
    earlier = (x[None, :, :] == x[:, None, :]) & (order[None, :, None] < order[:, None, None])
    lead = ~earlier.any(dim=1)
    # its rank: the distinct values below it
    rank = ((x[None, :, :] < x[:, None, :]) & lead[None, :, :]).sum(dim=1)
    feats = torch.arange(span)[None, :].expand_as(x)
    vals[feats[lead], rank[lead]] = x[lead]
    ge[:] = ((rank[:, :, None] >= torch.arange(33)[None, None, :]).to(torch.int64)
             << lanes[:, None, None]).sum(dim=0)
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


def members(span: int, window: int) -> int:
    """Blocks a tile: one window of ``window`` features each."""
    return -(-max(1, span) // window)


def member_value_tables(qt: torch.Tensor, span: int) -> torch.Tensor:
    """(members, GE_HEAD + BITMAP_FEATURES * GE_STRIDE) int64: member m's
    shared memory, the value tables of its window of features [m * 223,
    (m + 1) * 223) below the span (one member where the span fits one)."""
    W = tops.BITMAP_FEATURES
    out = torch.zeros((members(span, W), GE_HEAD + W * tops.GE_STRIDE), dtype=torch.int64)
    for m in range(out.shape[0]):
        tab = value_tables(qt[:, m * W:], min(W, span - m * W))
        out[m, : tab.numel()] = tab
    return out


def decode_words(cells: tops.CellList, incl: bool):
    """(member, lower offset, upper offset) of each packed cell in its
    member's value tables, read from the words as the kernel decodes them:
    uint8 ``cell_words`` (the member from the feature), one block's
    ``value_words`` (member 0) or a cluster's ``window_words``."""
    w = torch.as_tensor(np.asarray(cells.words).view(np.uint32).astype(np.int64))
    kind, up = tops.packing(cells), 0 if incl else 1
    if kind == "cell":
        f, lo, hi = w & 0xFFFF, (w >> 16) & 0xFF, w >> 24
        m = f // tops.BITMAP_FEATURES
        base = (f - m * tops.BITMAP_FEATURES) * tops.GE_STRIDE
        return m, base + lo, base + hi + (1 - up)
    if kind == "value":
        return torch.zeros_like(w), w & 0xFFFF, (w >> 16) - up
    assert kind == "window"
    lo_at = w & 0xFFFF
    return w >> 26, lo_at, lo_at + ((w >> 16) & 0x3FF) - 256 - up


def model_bits(q: torch.Tensor, cells: tops.CellList, *, mode: str,
               force_rank: bool = False) -> tuple[torch.Tensor, list[str]]:
    """(B, R) match bits by the kernel's algorithm, and the route each tile
    took.  Where the span passes one block's window, a cluster of blocks
    serves a tile, member m holding the tables of its window of features
    (223 of value tables, 893 of rank tables) and each cell's lookups read
    from the member of its feature."""
    lower, upper = halves(mode)
    incl = mode == "inclusive"
    count = torch.as_tensor(np.asarray(cells.count)).to(torch.int64)
    feat = torch.as_tensor(np.asarray(cells.feat).astype(np.int64))
    lo, hi = (_values(torch.as_tensor(np.asarray(a))) for a in (cells.lo, cells.hi))
    R, Kslots = feat.shape
    span = max(1, cells.span)
    words = cells.words is not None and tops.packing(cells) is not None
    out, routes = [], []
    for q0 in range(0, q.shape[0], WORD):
        qt = q[q0:q0 + WORD]
        nq = qt.shape[0]
        live = live_queries(qt)
        value = not force_rank and words and on_bins(qt, span)
        routes.append("value" if value else "rank")
        word = torch.full((R,), live, dtype=torch.int64)
        if value:
            tabs = member_value_tables(qt, span)
            m, lo_at, hi_at = decode_words(cells, incl)
            cell = tabs[m, GE_HEAD + lo_at] & (~tabs[m, GE_HEAD + hi_at] & FULL)
        else:
            W = K.RANK_FEATURES
            tables = [rank_tables(qt[:, m * W:], min(W, span - m * W), live)
                      for m in range(members(span, W))]
            # member m's W feature slots at rows [m * W, (m + 1) * W)
            vals = torch.cat([torch.cat([v, v.new_zeros((W - v.shape[0], 32))])
                              for v, _ in tables])
            ge = torch.cat([torch.cat([g, g.new_zeros((W - g.shape[0], 33))])
                            for _, g in tables])
            m, f = feat // W, feat % W  # the feature's member, its place there
            cell = torch.stack([rank_word(vals, ge, m[:, k] * W + f[:, k], lo[:, k], hi[:, k],
                                          lower, upper)
                                for k in range(Kslots)], dim=1)
        for k in range(Kslots):
            word = torch.where(k < count, word & cell[:, k], word)
        bits = (word[None, :] >> torch.arange(nq, dtype=torch.int64)[:, None]) & 1
        out.append(bits.to(torch.bool))
    return torch.cat(out), routes


def _ranked(cells: tops.CellList) -> tops.CellList:
    """The list without its packed words: every tile searches ranks."""
    out = copy.copy(cells)
    object.__setattr__(out, "words", None)
    return out


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
    assert tops.packing(cells) == ("value" if span_fits else "window")
    assert cells.words is not None
    expect = ["value" if t in small else "rank" for t in range(tiles)]
    if n_bins <= 256:
        expect = ["value"] * tiles  # every bin is on the value tables
    assert routes == expect
    if case == "int32-span-past-window":  # a cluster of two blocks a tile, one ranked
        assert not span_fits and routes == ["value"] * tiles
        assert K.kernel_route(cells) == ("bit-parallel", 2)
        assert K.kernel_route(_ranked(cells)) == ("bit-parallel", 1)
    else:
        assert K.kernel_route(cells) == ("bit-parallel", 1)
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


# -- past one block's window: a cluster of blocks a tile ------------------------------

WIDE_SPANS = (223, 224, 446, 447, 893, 894, 968)  # each side of 1, 2 and 4 value windows, 1 rank
WIDE_WIDTH = 968  # every case's table width: the references' shapes stay the same
WIDE_VARIANTS = [("uint8", "inclusive"), ("uint8", "direct"), ("uint16", "direct"),
                 ("uint16", "inclusive"), ("int32", "direct"), ("int32", "inclusive"),
                 ("int32", "msb_lsb"), ("int32", "two_cycle"), ("float32", "soft")]
ODD = torch.tensor([float("nan"), float("inf"), -float("inf"), 2.5, -1.0, 300.0])


def _wide_operands(seed, span, dtype, mode, *, b=40, r=512):
    """Tables ``WIDE_WIDTH`` features wide whose rows list 6 cells (every
    eighth 12) at random features below ``span``, every fourth row the last
    of them and widened to hold a query; the first tile's queries bins
    below 256, the second's (8 queries) up to 999 for uint16/int32 and with
    NaN, +-inf, half bins, -1 and 300 for float32 (the rank route within
    the cluster).  Returns the padded queries, tables and cell list."""
    rng = np.random.default_rng(seed)
    n_bins = {"uint8": 256 if mode == "inclusive" else 200, "float32": 256}.get(dtype, 1000)
    q = rng.integers(0, n_bins, size=(b, WIDE_WIDTH))
    q[:WORD] = rng.integers(0, min(256, n_bins), size=(WORD, WIDE_WIDTH))
    # 12 distinct features a row below the span, the last first in every fourth
    cols = np.argsort(rng.random((r, span)), axis=1)[:, :12]
    last = np.arange(r) % 4 == 0
    cols[last] = np.where(cols[last] == span - 1, cols[last, :1], cols[last])
    cols[last, 0] = span - 1
    lo = rng.integers(0, n_bins - 1, size=(r, 12))
    hi = np.minimum(n_bins, lo + rng.integers(1, n_bins // 2, size=(r, 12)))
    hold = q[np.arange(r) % b][np.arange(r)[:, None], cols]  # each row's query's bins there
    lo[last], hi[last] = np.minimum(lo, hold)[last], np.maximum(hi, hold + 1)[last]
    n = np.where(np.arange(r) % 8 == 1, 12, 6)
    rows, slots = np.nonzero(np.arange(12)[None, :] < n[:, None])
    low = np.zeros((r, WIDE_WIDTH), np.int32)
    high = np.full((r, WIDE_WIDTH), n_bins, np.int32)
    low[rows, cols[rows, slots]] = lo[rows, slots]
    high[rows, cols[rows, slots]] = hi[rows, slots]
    leaf = np.zeros((r, 1), np.float32)
    incl = mode == "inclusive"
    if incl or dtype == "float32":
        lo, hi, _, _ = tops.pack_tables(low, high, leaf, r_blk=32, f_blk=8, n_bins=n_bins,
                                        dtype=dtype, inclusive=True if incl else None)
    else:
        lo, hi, _ = tops.pad_tables(low, high, leaf, r_blk=32, f_blk=8, n_bins=n_bins)
        lo, hi = lo.astype(dtype), hi.astype(dtype)
    cells = tops.binding_cells(lo, hi, n_bins=n_bins, inclusive=incl, n_real_rows=r)
    qp = tops.pad_queries(q, WIDE_WIDTH, dtype=dtype, device="cpu")
    if dtype == "float32":
        tile = qp[WORD:]
        pick = torch.from_numpy(rng.random(tuple(tile.shape)) < 0.01)
        tile[pick] = ODD[torch.from_numpy(rng.integers(0, ODD.numel(), size=int(pick.sum())))]
    return qp, lo, hi, cells


@pytest.mark.parametrize("span", WIDE_SPANS)
@pytest.mark.parametrize("dtype,mode", WIDE_VARIANTS)
def test_cluster_route_equals_both_references(span, dtype, mode):
    """Spans on each side of one, two and four value windows and of one
    rank window, and 968: a tile's tables split over ceil(span / 223)
    members (value route; a list without words over ceil(span / 893), rank
    route), each cell read from its feature's member, equal both packages'
    match bits (soft: tau = 0 scores) in every mode."""
    q, lo, hi, cells = _wide_operands(WIDE_SPANS.index(span), span, dtype, mode)
    lo_t, hi_t, jq, jlo, jhi = (torch.from_numpy(lo), torch.from_numpy(hi),
                                *(jnp.asarray(a) for a in (q.numpy(), lo, hi)))
    if dtype == "float32":
        want = soft_scores_ref(q, lo_t, hi_t, tau=0.0).to(torch.bool)
        jwant = np.asarray(jprec.soft_match_scores(jq, jlo, jhi, 0.0)) == 1
    else:
        want = cam_match_bits_ref(q, lo_t, hi_t, mode=mode)
        jwant = np.asarray(j_bits_ref(jq, jlo, jhi, mode=mode))
    assert np.array_equal(want.numpy(), jwant)
    assert want[:, :512].any() and not want.all()
    got, routes = model_bits(q, cells, mode=mode)
    assert torch.equal(got, want)
    # the case's edges: the span, rows past 8 cells, every member's window listed
    assert cells.span == span and cells.k == 12
    n_value = -(-span // tops.BITMAP_FEATURES)
    used = np.arange(cells.k)[None, :] < np.asarray(cells.count)[:, None]
    listed = np.asarray(cells.feat)[used]
    assert set((listed // tops.BITMAP_FEATURES).tolist()) == set(range(n_value))
    assert K.kernel_route(cells) == ("bit-parallel", n_value)
    assert tops.packing(cells) == ("cell" if dtype == "uint8" else
                                   "value" if n_value == 1 else "window")
    assert routes == ["value", "value" if dtype == "uint8" else "rank"]
    if dtype != "uint8" and span >= K.RANK_FEATURES:  # every tile ranked: ceil(span / 893)
        ranked = _ranked(cells)
        assert K.kernel_route(ranked) == ("bit-parallel", -(-span // K.RANK_FEATURES))
        got, routes = model_bits(q, ranked, mode=mode)
        assert torch.equal(got, want) and routes == ["rank", "rank"]


def test_window_words_pack_the_list():
    """A list of span past one value window packs ``window_words``: each
    cell's member f // 223, its lower offset in that member's tables and the
    biased distance to its upper, equal to the list's feature and clamped
    bounds; numpy and torch pack alike; a row view whose span fits one
    window repacks as ``value_words``, one past a cluster's carries none."""
    for dtype, mode in (("int32", "direct"), ("uint16", "inclusive"), ("float32", "soft")):
        _, lo, hi, cells = _wide_operands(5, 968, dtype, mode, r=90)
        assert tops.packing(cells) == "window"
        w = np.asarray(cells.words).view(np.uint32).astype(np.int64)
        feat, clo, chi = (np.asarray(a) for a in (cells.feat, cells.lo, cells.hi))
        used = np.arange(cells.k)[None, :] < np.asarray(cells.count)[:, None]
        if dtype == "float32":
            L = np.clip(np.floor(clo.astype(np.float64)) + 1, 0, 256)
            H = np.clip(np.ceil(chi.astype(np.float64)) + 1, 0, 257)
        else:
            L, H = np.clip(clo.astype(np.int64), 0, 256), np.clip(chi.astype(np.int64) + 1, 0, 257)
        m, local = feat // 223, feat % 223
        assert np.array_equal((w >> 26)[used], m[used])
        assert np.array_equal((w & 0xFFFF)[used], (local * tops.GE_STRIDE + L)[used])
        assert np.array_equal(((w >> 16) & 0x3FF)[used], (H - L + 256)[used])
        assert (w >> 29 == 0).all()  # bits 29-31 unused
        t = tops.CellList(*(torch.from_numpy(np.asarray(a)) for a in
                            (cells.count, cells.feat, cells.lo, cells.hi)), cells.width)
        assert np.array_equal(t.words.numpy(), np.asarray(cells.words))
        # the mesh engine's row shards: a view repacks for its own span (the
        # never-match padding rows list feature 0)
        rows = cells.rows(90, 96)
        assert rows.span == 1 and tops.packing(rows) == "value"
        assert np.array_equal(np.asarray(rows.words),
                              tops.value_words(np.asarray(rows.feat), np.asarray(rows.lo),
                                               np.asarray(rows.hi)))
        assert np.array_equal(np.asarray(cells.rows(0, 40).words), np.asarray(cells.words)[:40])
    # past MAX_MEMBERS value windows: no words (ranks), past as many rank windows: the lanes
    f = np.array([[tops.MAX_MEMBERS * tops.BITMAP_FEATURES]], np.uint16)
    one = np.ones((1, 1), np.int32)
    wide = tops.CellList(np.ones(1, np.int32), f, one, one + 1, 8000)
    assert wide.words is None and K.kernel_route(wide) == ("bit-parallel", 2)
    far = tops.CellList(np.ones(1, np.int32), f * 0 + 7999, one, one + 1, 8000)
    assert far.words is None and K.kernel_route(far) == ("lanes", 0)
    u8 = tops.CellList(np.ones(1, np.int32), f, one.astype(np.uint8), one.astype(np.uint8), 8000)
    assert tops.packing(u8) == "cell" and K.kernel_route(u8) == ("lanes", 0)


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
    """The value and rank tables' strides and windows, the head, the
    cluster's size and the window words' fields, as the kernel source
    defines them, equal the Python side's; the launchers choose one block,
    a cluster or the lane-per-query kernel by the span alone, as
    ``kernel_route`` mirrors it."""
    src = {p.name: p.read_text() for p in (*K.SOURCES, *K.HEADERS)}
    cu = src["cam_match.cu"]
    smem = int(re.search(r"constexpr int kMaxSmem = (\d+);", src["cam_match_common.cuh"])[1])
    ge_stride = int(re.search(r"constexpr int kGeStride = (\d+);", cu)[1])
    head = int(re.search(r"constexpr int kHead = (\d+);", cu)[1])
    most = int(re.search(r"constexpr int kMaxMembers = (\d+);", cu)[1])
    bias = int(re.search(r"constexpr int kDeltaBias = (\d+);", cu)[1])
    assert re.search(r"constexpr int kRankStride = 32 \+ 33;", cu)
    assert "kRankWindow = (kMaxSmem - kHead * 4) / (kRankStride * 4)" in cu
    assert "kMaxWindow = kMaxSmem / (kGeStride * 4)" in cu
    # the dispatch: uint8 lists by value windows; the others by value windows
    # where they carry words (window words up to kMaxMembers windows), else by
    # rank windows; the lanes past kMaxMembers blocks a tile
    launch_u8 = cu[cu.index("cudaError_t launch_u8("):cu.index("cudaError_t launch_bp(")]
    launch_bp = cu[cu.index("cudaError_t launch_bp("):cu.index("}  // namespace")]
    assert "const int n = members(a.span, kMaxWindow);" in launch_u8
    assert "if (a.span > kMaxMembers * kMaxWindow) a.words = nullptr;" in launch_bp
    assert "const int n = members(a.span, a.words ? kMaxWindow : kRankWindow);" in launch_bp
    for body in (launch_u8, launch_bp):
        assert re.search(r"if \(l\.walk \|\| n > kMaxMembers\) \{?\s*return launch_lanes", body)
        assert re.search(r"cam_match_\w+_kernel<[^>]*, true>, a, n,", body)  # the cluster
    assert "inline int members(int span, int W) { return (span + W - 1) / W; }" in cu
    assert head == GE_HEAD and ge_stride == tops.GE_STRIDE
    assert tops.BITMAP_FEATURES == smem // (ge_stride * 4) == K.BITMAP_FEATURES
    assert tops.BITMAP_FEATURES * ge_stride * 4 + head * 4 <= smem
    assert K.RANK_FEATURES == (smem - head * 4) // (RANK_STRIDE * 4) == 893
    assert most == tops.MAX_MEMBERS == K.MAX_MEMBERS == 8
    # the offsets of a value or window word fit its 16-bit halves at the
    # window's edge; a window word's upper offset less its lower, biased,
    # fits 10 bits (`(cw >> 16) & 0x3FFu`) and the member 3 (`cw >> 26`)
    assert (tops.BITMAP_FEATURES - 1) * ge_stride + 257 < 1 << 16
    assert "(cw >> 16) & 0x3FFu" in cu and "int(cw >> 26)" in cu
    assert bias == 256 and 257 + bias < 1 << 10 and most - 1 < 1 << 3
    # a cluster's tables: the rank window fits one block beside the head
    assert K.RANK_FEATURES * RANK_STRIDE * 4 + head * 4 <= smem
