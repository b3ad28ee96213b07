"""The uint8 kernel's bit-parallel match (``kernels/csrc/cam_match.cu``,
``cam_match_u8_kernel``) as a plain-torch model, against both packages'
reference match bits, on the CPU.

The kernel takes the uint8 lists whose span (largest listed feature + 1)
is at most ``BITMAP_FEATURES``; it builds, once per 32-query tile, GE[f][v]
= the tile's queries with q[f] >= v for v in [0, 256] (GE[f][256] = 0) for
the features below the span, and forms each row's 32-query word as the AND
over the row's listed cells (f, lo, hi) of GE[f][lo] & ~GE[f][hi + 1]
('inclusive') or GE[f][lo] & ~GE[f][hi] ('direct').  A list of a larger
span runs the lane-per-query kernel instead.  The model here does the same
in torch, reading the cells from the packed words the kernel reads
(``CellList.words``), and must equal ``repro_torch.kernels.ref
.cam_match_bits_ref`` and ``repro.kernels.ref.cam_match_bits_ref`` bit for
bit on the same seeded numpy inputs: cells with lo = 0 and hi = 255,
never-match padding rows, rows of more than 8 cells, ragged tiles and a
table wider than the bitmaps' shared-memory window whose list fits it.
The window's size against the kernel source, the packed word's layout and
its round trip against the list close the file.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import cam_match_bits_ref as j_bits_ref
from repro_torch.kernels.cam_match import BITMAP_FEATURES, HEADERS, SOURCES
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import cam_match_bits_ref

WORD = 32  # queries a tile


def unpack_cell_words(words: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(feat uint16, lo uint8, hi uint8) of ``ops.cell_words``' packing."""
    w = np.asarray(words).view(np.uint32)
    return ((w & 0xFFFF).astype(np.uint16), ((w >> 16) & 0xFF).astype(np.uint8),
            (w >> 24).astype(np.uint8))


def _bitmaps(q_tile: torch.Tensor, window: int) -> torch.Tensor:
    """(window, 257) int64 words: bit b of GE[f][v] set iff q_tile[b, f] >= v."""
    v = torch.arange(257, dtype=torch.int64)
    ge = q_tile[:, :window].to(torch.int64).T[:, :, None] >= v[None, None, :]  # (W, nq, 257)
    shifts = torch.arange(q_tile.shape[0], dtype=torch.int64)[None, :, None]
    return (ge.to(torch.int64) << shifts).sum(dim=1)


def model_bits(q: torch.Tensor, cells: tops.CellList, *, mode: str,
               window: int | None = None) -> torch.Tensor:
    """(B, R) match bits by the kernel's algorithm: per 32-query tile the
    bitmaps of features [0, window) (the list's span unless given; never
    less), each row's word the AND of its listed cells' words."""
    window = cells.span if window is None else window
    assert cells.span <= window and cells.span <= BITMAP_FEATURES
    feat, lo, hi = (torch.from_numpy(a).to(torch.int64)
                    for a in unpack_cell_words(np.asarray(cells.words)))
    count = torch.as_tensor(np.asarray(cells.count)).to(torch.int64)
    R, K = feat.shape
    out = []
    for q0 in range(0, q.shape[0], WORD):
        qt = q[q0:q0 + WORD].to(torch.int64)
        nq = qt.shape[0]
        ge = _bitmaps(qt, window)
        word = torch.full((R,), (1 << nq) - 1, dtype=torch.int64)  # a row of no cells
        for k in range(K):
            used = k < count
            top = hi[:, k] + 1 if mode == "inclusive" else hi[:, k]
            cell = ge[feat[:, k], lo[:, k]] & ~ge[feat[:, k], top]
            word = torch.where(used, word & cell, word)
        bits = (word[None, :] >> torch.arange(nq, dtype=torch.int64)[:, None]) & 1
        out.append(bits.to(torch.bool))
    return torch.cat(out)


def _table(rng, r, f, n_bins, *, listed, wide_rows=0, span=None):
    """Exclusive-high int32 tables, ``listed`` non-wildcard cells a row at
    random features below ``span`` (default ``f``; every row lists feature
    span - 1; the first ``wide_rows`` rows list 12), each side at
    the grid's edge in a fifth of the cells: lo = 0 (not a wildcard, its
    hi is below n_bins) and hi = n_bins (inclusive 255 at 256 bins)."""
    low = np.zeros((r, f), np.int32)
    high = np.full((r, f), n_bins, np.int32)
    for i in range(r):
        n = 12 if i < wide_rows else listed
        cols = rng.choice(f, size=n, replace=False) if span is None else np.array(
            [span - 1, *rng.choice(span - 1, size=n - 1, replace=False)])
        lo = rng.integers(0, n_bins - 1, size=n)
        hi = np.minimum(n_bins, lo + rng.integers(1, n_bins // 2, size=n))
        edge = rng.random(n)
        lo[edge < 0.2] = 0
        hi[edge < 0.2] = rng.integers(1, n_bins - 1, size=int((edge < 0.2).sum()))
        lo[edge > 0.8] = rng.integers(1, n_bins - 1, size=int((edge > 0.8).sum()))
        hi[edge > 0.8] = n_bins
        low[i, cols], high[i, cols] = lo, hi
    return low, high


def _operands(seed, *, b, r, f, n_bins, mode, listed=6, wide_rows=0, span=None):
    """Seeded queries and uint8 tables in the kernel layout of ``mode``
    (padded rows: never-match padding), with the cell list."""
    rng = np.random.default_rng(seed)
    low, high = _table(rng, r, f, n_bins, listed=listed, wide_rows=wide_rows, span=span)
    q = rng.integers(0, n_bins, size=(b, f))
    hold = np.arange(0, r, 3)  # every third row holds a query: matches at any B
    low[hold] = np.minimum(low[hold], q[hold % b])
    high[hold] = np.maximum(high[hold], q[hold % b] + 1)
    leaf = np.zeros((r, 1), np.float32)
    if mode == "inclusive":
        lo, hi, _, _ = tops.pack_tables(low, high, leaf, r_blk=32, f_blk=8, n_bins=n_bins,
                                        dtype="uint8", inclusive=True)
    else:
        lo, hi, _ = tops.pad_tables(low, high, leaf, r_blk=32, f_blk=8, n_bins=n_bins)
        lo, hi = lo.astype(np.uint8), hi.astype(np.uint8)
    cells = tops.binding_cells(lo, hi, n_bins=n_bins, inclusive=mode == "inclusive",
                               n_real_rows=r)
    qp = tops.pad_queries(q, lo.shape[1], dtype="uint8", device="cpu")
    return qp, lo, hi, cells


CASES = {  # name: (B, R, F, listed cells a row, rows of 12 cells, span or None)
    "tile": (32, 90, 16, 6, 0, None),
    "ragged-B37": (37, 90, 16, 6, 0, None),
    "B1": (1, 70, 16, 5, 0, None),
    "B33": (33, 64, 24, 4, 0, None),
    "over-8-cells": (40, 96, 24, 6, 20, None),
    # a table wider than the bitmaps' window, its list at the window's edge
    "past-window": (45, 90, 300, 8, 10, BITMAP_FEATURES),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode,n_bins", [("inclusive", 256), ("direct", 200)])
def test_bit_parallel_model_equals_both_references(case, mode, n_bins):
    b, r, f, listed, wide_rows, span = CASES[case]
    q, lo, hi, cells = _operands(list(CASES).index(case), b=b, r=r, f=f, n_bins=n_bins,
                                 mode=mode, listed=listed, wide_rows=wide_rows, span=span)
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    want = cam_match_bits_ref(q, lo_t, hi_t, mode=mode)
    jwant = np.asarray(j_bits_ref(jnp.asarray(q.numpy()), jnp.asarray(lo), jnp.asarray(hi),
                                  mode=mode))
    assert np.array_equal(want.numpy(), jwant)
    assert want.any() and not want.all()
    got = model_bits(q, cells, mode=mode)
    assert torch.equal(got, want)
    # the edges the case covers
    cnt = np.asarray(cells.count)
    assert (cnt[r:] == 1).all() and not want[:, r:].any()  # never-match padding rows
    if wide_rows:
        assert cells.k > 8
    if case == "past-window":
        assert q.shape[1] > BITMAP_FEATURES and cells.span == BITMAP_FEATURES
    used = np.arange(cells.k)[None, :] < cnt[:, None]
    assert (np.asarray(cells.lo)[used] == 0).any()
    top = 255 if mode == "inclusive" else n_bins
    assert (np.asarray(cells.hi)[used] == min(top, 255)).any()


def test_the_window_does_not_change_the_words():
    """Bitmaps over any window from the span up give the same words: the
    kernel's window is the span, the table's width does not enter."""
    q, lo, hi, cells = _operands(7, b=64, r=128, f=32, n_bins=256, mode="inclusive",
                                 listed=9, wide_rows=8)
    words = [model_bits(q, cells, mode="inclusive", window=w)
             for w in (cells.span, cells.span + 5, 32, BITMAP_FEATURES)]
    assert all(torch.equal(w, words[0]) for w in words[1:])


def test_bitmap_window_matches_the_kernel_source():
    """``BITMAP_FEATURES``, the span up to which a uint8 list runs the
    bit-parallel kernel, is the kernel's own window: the features whose
    bitmaps (kGeStride words each) fit in kMaxSmem bytes."""
    src = {p.name: p.read_text() for p in (*SOURCES, *HEADERS)}
    smem = int(re.search(r"constexpr int kMaxSmem = (\d+);", src["cam_match_common.cuh"])[1])
    stride = int(re.search(r"constexpr int kGeStride = (\d+);", src["cam_match.cu"])[1])
    assert "kMaxWindow = kMaxSmem / (kGeStride * 4)" in src["cam_match.cu"]
    assert re.search(r"span <= kMaxWindow", src["cam_match.cu"])
    assert BITMAP_FEATURES == smem // (stride * 4) == 223


def test_packed_words_layout_and_round_trip():
    _, lo, hi, cells = _operands(3, b=8, r=64, f=24, n_bins=256, mode="inclusive",
                                 listed=7, wide_rows=4)
    w = np.asarray(cells.words)
    assert w.dtype == np.int32 and w.shape == cells.feat.shape
    u = w.view(np.uint32)
    feat, lo_c, hi_c = (np.asarray(a) for a in (cells.feat, cells.lo, cells.hi))
    assert np.array_equal(u & 0xFFFF, feat) and np.array_equal((u >> 16) & 0xFF, lo_c)
    assert np.array_equal(u >> 24, hi_c)
    back = unpack_cell_words(w)
    assert all(np.array_equal(x, y) and x.dtype == y.dtype
               for x, y in zip(back, (feat, lo_c, hi_c)))
    # the tensor list packs the same words; a view of rows packs its rows
    t = cells.to("cpu")
    assert torch.equal(t.words, torch.from_numpy(w))
    assert np.array_equal(np.asarray(cells.rows(10, 30).words), w[10:30])
    # an int32 list of the same table carries the value route's offset words
    # instead (tests/test_torch_rankmatch.py), and span is the largest feature + 1
    assert cells.span == int(feat.max()) + 1
    wide = tops.binding_cells(lo.astype(np.int32), hi.astype(np.int32), n_bins=256,
                              inclusive=True, n_real_rows=64)
    assert wide.span == cells.span
    assert np.array_equal(np.asarray(wide.words), tops.value_words(
        np.asarray(wide.feat), np.asarray(wide.lo), np.asarray(wide.hi)))
