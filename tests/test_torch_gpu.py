"""The CUDA kernels on a card, held to the plain PyTorch version.

Marked ``gpu``: each test skips with a reason where torch sees no CUDA
device.  This file imports no JAX (the machine with the card has none), so
it runs there on its own:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.trees import random_deep_ensemble
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (
    cam_match_bits_ref,
    cam_match_ref,
    soft_margin_bound,
    soft_score_bound,
    soft_scores_ref,
)

VARIANTS = [  # (table dtype, kernel mode, n_bins)
    ("int32", "direct", 256), ("int32", "inclusive", 256),
    ("int32", "msb_lsb", 256), ("int32", "two_cycle", 256),
    ("uint8", "inclusive", 256), ("uint16", "inclusive", 1000),
    ("uint8", "direct", 200), ("uint16", "direct", 1000),
]
B, R, F, C = 45, 200, 19, 3
R_BLK, F_BLK = 40, 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    return torch.device("cuda")


def _widened(cells: ops.CellList, k: int) -> ops.CellList:
    """The same list with its rows padded to ``k`` slots: the kernels must
    stop at each row's count, and read slots past their staged ones from
    device memory."""
    def pad(a):
        out = torch.zeros((a.shape[0], k), dtype=a.dtype, device=a.device)
        out[:, : a.shape[1]] = a
        return out
    return ops.CellList(cells.count, pad(cells.feat), pad(cells.lo), pad(cells.hi), cells.width)


def _tables(rng, n_bins, q, *, r=R, wild=0.6, noisy=False):
    """Seeded exclusive-high int32 tables with ``wild`` wildcard cells;
    ``noisy`` shifts the bounds by up to ±3 bins (negative and past the
    grid) and makes 2% of the cells never-match, as the defect injector
    leaves an int32 table.  Every fourth row is widened to hold one of the
    queries ``q``, so each problem has matches at any batch size."""
    low = rng.integers(0, n_bins, size=(r, F)).astype(np.int32)
    high = np.minimum(low + rng.integers(1, n_bins, size=(r, F)), n_bins).astype(np.int32)
    w = rng.random((r, F)) < wild
    low[w], high[w] = 0, n_bins
    if noisy:
        low = low + rng.integers(-3, 4, size=low.shape).astype(np.int32)
        high = high + rng.integers(-3, 4, size=high.shape).astype(np.int32)
        bad = rng.random((r, F)) < 0.02
        high[bad] = low[bad]
    rows = np.arange(0, r, 4)
    hold = q[rows % q.shape[0]]
    low[rows] = np.minimum(low[rows], hold)
    high[rows] = np.maximum(high[rows], hold + 1)
    return low, high


def _operands(dtype, mode, n_bins, dev, *, b=B, r=R, noisy=False):
    """Seeded tables, 60% wildcard cells (10% when ``noisy``), k/16 leaves,
    in the kernel layout of ``dtype`` (inclusive-high for mode='inclusive'),
    with their cell list."""
    rng = np.random.default_rng(11)
    q = rng.integers(0, n_bins, size=(b, F))
    low, high = _tables(rng, n_bins, q, r=r, wild=0.1 if noisy else 0.6, noisy=noisy)
    leaf = (rng.integers(-16, 17, size=(r, C)) / 16.0).astype(np.float32)
    incl = mode == "inclusive"
    if incl:
        lo, hi, lm, _ = ops.pack_tables(low, high, leaf, r_blk=R_BLK, f_blk=F_BLK,
                                        n_bins=n_bins, dtype=dtype, inclusive=True)
    else:
        lo, hi, lm = ops.pad_tables(low, high, leaf, r_blk=R_BLK, f_blk=F_BLK, n_bins=n_bins)
        lo, hi = lo.astype(dtype), hi.astype(dtype)
    cells = ops.binding_cells(lo, hi, n_bins=n_bins, inclusive=incl, n_real_rows=r)
    qp = ops.pad_queries(q, lo.shape[1], dtype=dtype, device=dev)
    return (qp, *(torch.from_numpy(a).to(dev) for a in (lo, hi, lm)), cells.to(dev))


def _check_hard(K, q, lo, hi, lm, cells, mode, dev):
    """Bits and k/16 margins equal the plain version, with the list as
    built and widened past the staged slots; fused bias equals unfused +
    bias; two runs equal.  Returns the margins."""
    bits = cam_match_bits_ref(q, lo, hi, mode=mode)
    assert bits.any() and not bits.all()  # both outcomes
    want = cam_match_ref(q, lo, hi, lm, mode=mode)
    bias = torch.full((1, lm.shape[1]), 0.75, device=dev)
    for cl in (cells, _widened(cells, 40)):
        assert torch.equal(K.cam_match_bits_cuda(q, cl, mode=mode), bits)
        out = K.cam_match_cuda(q, cl, lm, mode=mode)
        assert torch.equal(out, want)
        assert torch.equal(K.cam_match_cuda(q, cl, lm, mode=mode), out)
        assert torch.equal(K.cam_match_cuda(q, cl, lm, bias, mode=mode), out + bias)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,mode,n_bins", VARIANTS)
def test_cuda_kernel_matches_plain_version(card, dtype, mode, n_bins):
    """Bits and k/16 margins equal the plain version with the cell list as
    built and widened; fused bias equals unfused + bias; packed equals
    int32."""
    from repro_torch.kernels import cam_match as K

    q, lo, hi, lm, cells = _operands(dtype, mode, n_bins, card)
    out = _check_hard(K, q, lo, hi, lm, cells, mode, card)
    if dtype != "int32":
        q32, _, _, lm32, cells32 = _operands("int32", mode, n_bins, card)
        assert torch.equal(out, K.cam_match_cuda(q32, cells32, lm32, mode=mode))


@pytest.mark.gpu
@pytest.mark.parametrize("b,r", [(1, 200), (37, 203)], ids=["B1", "B37-ragged"])
@pytest.mark.parametrize("dtype,mode,n_bins", VARIANTS[:5])
def test_cuda_kernel_ragged_batch_and_rows(card, dtype, mode, n_bins, b, r):
    """A batch that is not a multiple of 32 and a table whose rows do not
    tile (never-match padding rows, listed as one cell each)."""
    from repro_torch.kernels import cam_match as K

    q, lo, hi, lm, cells = _operands(dtype, mode, n_bins, card, b=b, r=r)
    assert cells.feat.shape[0] > r or r == R
    _check_hard(K, q, lo, hi, lm, cells, mode, card)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["direct", "inclusive", "msb_lsb", "two_cycle"])
def test_cuda_kernel_noisy_int32_large_k(card, mode):
    """Noisy int32 bounds with never-match cells and few wildcards: rows
    list more cells than are staged, and every one of them counts."""
    from repro_torch.kernels import cam_match as K

    q, lo, hi, lm, cells = _operands("int32", mode, 256, card, b=37, r=203, noisy=True)
    assert cells.k > 8  # more than the kernels stage a row
    _check_hard(K, q, lo, hi, lm, cells, mode, card)


@pytest.mark.gpu
def test_predict_on_the_card_matches_traversal(card):
    """The main path on the card: build -> predict/raw_margin through the
    kernel, equal to the host traversal and to the CPU engine."""
    from repro_torch.kernels import cam_match as K

    ens = random_deep_ensemble(n_trees=40, depth=6, n_features=30, n_bins=256,
                               task="multiclass", n_classes=5, seed=3)
    cm = repro_torch.build(ens)
    q = np.random.default_rng(4).integers(0, 256, size=(77, 30)).astype(np.uint8)
    before = K.cam_match_cuda.launches
    np.testing.assert_array_equal(cm.raw_margin(q), ens.raw_margin(q))
    np.testing.assert_array_equal(cm.predict(q), ens.predict(q))
    assert K.cam_match_cuda.launches == before + 2
    np.testing.assert_array_equal(cm.raw_margin(q), cm.raw_margin(q, device="cpu"))


def _soft_operands(dev, *, perturbed=False, normal=False, b=B, r=R, wild=0.6):
    """The tables of ``_operands`` in the float32 soft layout, with their
    cell list; ``perturbed`` adds never-match cells (high <= low) to the
    real rows."""
    rng = np.random.default_rng(11)
    n_bins = 256
    q = rng.integers(0, n_bins, size=(b, F))
    low, high = _tables(rng, n_bins, q, r=r, wild=wild)
    if perturbed:
        bad = rng.random((r, F)) < 0.01
        high[bad] = low[bad]
    if normal:
        leaf = rng.normal(size=(r, C)).astype(np.float32)
    else:
        leaf = (rng.integers(-16, 17, size=(r, C)) / 16.0).astype(np.float32)
    lo, hi, lm, _ = ops.pack_tables(low, high, leaf, r_blk=R_BLK, f_blk=F_BLK,
                                    n_bins=n_bins, dtype="float32")
    cells = ops.binding_cells(lo, hi, n_bins=n_bins, inclusive=False, n_real_rows=r)
    qp = ops.pad_queries(q, lo.shape[1], dtype="float32", device=dev)
    ops_ = (qp, *(torch.from_numpy(a).to(dev) for a in (lo, hi, lm)), cells.to(dev))
    return ops_, (low, high, leaf, q)


def _check_soft(K, q, lo, hi, lm, cells, tau, dev):
    """Scores and margins against the plain version (exact at tau = 0,
    within ``soft_score_bound``/``soft_margin_bound`` otherwise), with the
    list as built and widened past the staged slots; fused bias == unfused
    + bias, two runs identical, no NaN, never-match rows score exactly 0.
    Returns whether the table has never-match rows."""
    s_ref = soft_scores_ref(q, lo, hi, tau=tau)
    m_ref = cam_match_ref(q, lo, hi, lm, mode="soft", tau=tau)
    bias = torch.full((1, lm.shape[1]), 0.75, device=dev)
    never = torch.isposinf(lo).any(dim=1)  # rows holding a (+inf, -inf) cell
    for cl in (cells, _widened(cells, 40)):
        scores = K.soft_scores_cuda(q, cl, tau=tau)
        out = K.cam_match_soft_cuda(q, cl, lm, tau=tau)
        torch.cuda.synchronize()
        assert not torch.isnan(scores).any() and not torch.isnan(out).any()
        assert (scores[:, never] == 0).all()
        if tau == 0.0:
            assert torch.equal(scores, s_ref) and torch.equal(out, m_ref)
        else:
            assert ((scores - s_ref).abs().double() <= soft_score_bound(s_ref, lo.shape[1])).all()
            lim = soft_margin_bound(s_ref, lm, lo.shape[1], extra=K.n_splits(lo.shape[0]) + 2)
            assert ((out - m_ref).abs().double() <= lim).all()
        assert torch.equal(K.cam_match_soft_cuda(q, cl, lm, tau=tau), out)
        assert torch.equal(K.cam_match_soft_cuda(q, cl, lm, bias, tau=tau), out + bias)
    return bool(never.any())


@pytest.mark.gpu
@pytest.mark.parametrize("tau", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("perturbed", [False, True], ids=["compiled", "perturbed"])
def test_cuda_soft_kernel_matches_plain_version(card, tau, perturbed):
    """The soft kernel against the plain version (``_check_soft``); only the
    perturbed table has never-match real rows."""
    from repro_torch.kernels import cam_match as K

    torch.backends.cuda.matmul.allow_tf32 = False
    (q, lo, hi, lm, cells), _ = _soft_operands(card, perturbed=perturbed, normal=tau > 0)
    assert _check_soft(K, q, lo, hi, lm, cells, tau, card) == perturbed


@pytest.mark.gpu
@pytest.mark.parametrize("tau", [0.0, 0.1])
@pytest.mark.parametrize("case", ["B1", "B37-ragged", "perturbed-large-K"])
def test_cuda_soft_kernel_ragged_and_large_k(card, case, tau):
    """B = 1, B = 37 on a table whose rows do not tile (never-match
    padding rows, one listed cell each), and a perturbed table with few
    wildcards whose rows list more cells than are staged."""
    from repro_torch.kernels import cam_match as K

    torch.backends.cuda.matmul.allow_tf32 = False
    kw = {"B1": dict(b=1), "B37-ragged": dict(b=37, r=203),
          "perturbed-large-K": dict(b=37, r=203, wild=0.05, perturbed=True)}[case]
    (q, lo, hi, lm, cells), _ = _soft_operands(card, normal=tau > 0, **kw)
    if case == "perturbed-large-K":
        assert cells.k > 8  # more than the kernels stage a row
    if "r" in kw:
        assert lo.shape[0] > kw["r"] and (cells.count[kw["r"]:] == 1).all()
    _check_soft(K, q, lo, hi, lm, cells, tau, card)


@pytest.mark.gpu
@pytest.mark.parametrize("normal", [False, True], ids=["k16", "normal"])
def test_cuda_soft_tau_zero_equals_direct_kernel(card, normal):
    """tau = 0 scores are exactly 0 or 1, so the margins are the int32
    `direct` kernel's, bit for bit, on normal leaves too."""
    from repro_torch.kernels import cam_match as K

    (q, lo, hi, lm, cells), (low, high, leaf, qi) = _soft_operands(card, normal=normal)
    ilo, ihi, ilm = ops.pad_tables(low, high, leaf, r_blk=R_BLK, f_blk=F_BLK, n_bins=256)
    icells = ops.binding_cells(ilo, ihi, n_bins=256, inclusive=False, n_real_rows=R).to(card)
    iq = ops.pad_queries(qi, ilo.shape[1], dtype="int32", device=card)
    ilo, ihi, ilm = (torch.from_numpy(a).to(card) for a in (ilo, ihi, ilm))
    direct = K.cam_match_cuda(iq, icells, ilm, mode="direct")
    soft = K.cam_match_soft_cuda(q, cells, lm, tau=0.0)
    assert torch.equal(soft, direct)
    bits = cam_match_bits_ref(iq, ilo, ihi, mode="direct")
    assert torch.equal(K.soft_scores_cuda(q, cells, tau=0.0), bits.float())


@pytest.mark.gpu
@pytest.mark.parametrize("tau", [0.0, 0.25])
def test_soft_engine_and_moments_pass_on_the_card(card, tau):
    """predict_proba / uncertainty through the soft kernel: one launch for
    the probabilities, one for predict(return_uncertainty=True) (margins
    and moments from the moments launch, equal to predict and uncertainty
    called apart); held to the CPU engine."""
    from repro_torch.kernels import cam_match as K

    torch.backends.cuda.matmul.allow_tf32 = False
    ens = random_deep_ensemble(n_trees=40, depth=6, n_features=30, n_bins=256,
                               task="multiclass", n_classes=5, seed=3)
    cm = repro_torch.build(ens, deploy=repro_torch.DeployConfig(mode="soft", tau=tau))
    q = np.random.default_rng(4).integers(0, 256, size=(77, 30)).astype(np.uint8)
    before = K.cam_match_soft_cuda.launches
    p = cm.predict_proba(q)
    pred, unc = cm.predict(q, return_uncertainty=True)
    assert K.cam_match_soft_cuda.launches == before + 2  # proba; margins + moments
    apart = cm.engine().uncertainty(q).numpy()[np.arange(77), pred.astype(np.int64)]
    np.testing.assert_array_equal(pred, cm.predict(q))
    np.testing.assert_array_equal(unc, apart)
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-5)
    assert np.isfinite(unc).all() and (unc >= 0).all()
    gpu, cpu = cm.engine(), cm.engine("cpu")
    mom, mom_cpu = gpu.raw_moments(q).cpu(), cpu.raw_moments(q)
    if tau == 0.0:
        np.testing.assert_array_equal(cm.raw_margin(q), ens.raw_margin(q))
        np.testing.assert_array_equal(pred, ens.predict(q))
        assert torch.equal(mom, mom_cpu)
        assert (mom[:, 10:15].sum(dim=1) == 40).all()  # mass: one row per tree
    else:
        qp = gpu._prep_queries(q)
        a = gpu.arrays
        s_ref = soft_scores_ref(qp, a.low, a.high, tau=tau)
        lim = soft_margin_bound(s_ref, gpu._moments, a.f_pad, extra=K.n_splits(a.r_pad) + 2)
        err = (mom.to(card) - cam_match_ref(qp, a.low, a.high, gpu._moments, mode="soft",
                                            tau=tau)[:, :15]).abs().double()
        assert (err <= lim[:, :15]).all()



# -- tables wider than the kernels stage ---------------------------------------------

WIDE_WIDTHS = (2048, 8192)  # past the staged query window: int32 and soft; all variants


def _wide_tables(f: int, n_bins: int, *, b: int = 40, r: int = 512, normal: bool = False):
    """A table ``f`` features wide: every cell a wildcard but 12 a row at
    random features, one of them among the last 512 (past every variant's
    staged window at 8,192); every 4th row widened to hold a query.  B = 40
    gives a tile of 32 queries (a warp a row) and one of 8 (a thread a
    (row, query) pair)."""
    rng = np.random.default_rng(f)
    low = np.zeros((r, f), np.int32)
    high = np.full((r, f), n_bins, np.int32)
    q = rng.integers(0, n_bins, size=(b, f))
    for i in range(r):
        cols = [*rng.choice(f - 512, size=11, replace=False).tolist(),
                int(rng.integers(f - 512, f))]
        lo = rng.integers(0, n_bins - 1, size=12)
        hi = np.minimum(n_bins, lo + rng.integers(1, n_bins // 2, size=12))
        if i % 4 == 0:
            lo, hi = np.minimum(lo, q[i % b, cols]), np.maximum(hi, q[i % b, cols] + 1)
        low[i, cols], high[i, cols] = lo, hi
    if normal:
        leaf = rng.normal(size=(r, C)).astype(np.float32)
    else:
        leaf = (rng.integers(-16, 17, size=(r, C)) / 16.0).astype(np.float32)
    return low, high, leaf, q


def _wide_operands(dtype, mode, n_bins, f, dev, *, normal=False):
    """``_wide_tables`` in the kernel layout of ``dtype`` (float32: the soft
    layout), with the cell list, on ``dev``."""
    low, high, leaf, q = _wide_tables(f, n_bins, normal=normal)
    incl = mode == "inclusive"
    if incl or dtype == "float32":
        lo, hi, lm, _ = ops.pack_tables(low, high, leaf, r_blk=128, f_blk=128, n_bins=n_bins,
                                        dtype=dtype, inclusive=True if incl else None)
    else:
        lo, hi, lm = ops.pad_tables(low, high, leaf, r_blk=128, f_blk=128, n_bins=n_bins)
        lo, hi = lo.astype(dtype), hi.astype(dtype)
    assert lo.shape[1] == f
    cells = ops.binding_cells(lo, hi, n_bins=n_bins, inclusive=incl, n_real_rows=low.shape[0])
    assert cells.k == 12 and (cells.feat[: low.shape[0]] >= f - 512).any(axis=1).all()
    qp = ops.pad_queries(q, f, dtype=dtype, device=dev)
    return (qp, *(torch.from_numpy(a).to(dev) for a in (lo, hi, lm)), cells.to(dev))


# lists of these spans: each side of one, two and four value windows (223
# features) and of one rank window (893), the 968-feature model's, and
# 1,784, a cluster of eight blocks a tile (the most a cluster holds)
CLUSTER_SPANS = (223, 224, 446, 447, 893, 894, 968, 1784)


def _span_operands(dtype, mode, n_bins, span, dev):
    """``_span_tables`` at ``span`` (B = 40, R = 512, 8 cells a row, one the
    last feature) in the kernel layout of ``dtype`` (float32: the soft
    layout), with the cell list, on ``dev``."""
    low, high, leaf, q = _span_tables(span, n_bins, b=40)
    incl = mode == "inclusive"
    if incl or dtype == "float32":
        lo, hi, lm, _ = ops.pack_tables(low, high, leaf, r_blk=128, f_blk=128, n_bins=n_bins,
                                        dtype=dtype, inclusive=True if incl else None)
    else:
        lo, hi, lm = ops.pad_tables(low, high, leaf, r_blk=128, f_blk=128, n_bins=n_bins)
        lo, hi = lo.astype(dtype), hi.astype(dtype)
    cells = ops.binding_cells(lo, hi, n_bins=n_bins, inclusive=incl, n_real_rows=low.shape[0])
    assert cells.span == span
    qp = ops.pad_queries(q, lo.shape[1], dtype=dtype, device=dev)
    return (qp, *(torch.from_numpy(a).to(dev) for a in (lo, hi, lm)), cells.to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("f", [*WIDE_WIDTHS, *(f"span{s}" for s in CLUSTER_SPANS)])
@pytest.mark.parametrize("dtype,mode,n_bins", [*VARIANTS, ("float32", "soft", 256)])
def test_cuda_kernel_wide_table(card, dtype, mode, n_bins, f):
    """Every hard variant and soft tau = 0 at F_pad = 2,048 and 8,192 and on
    lists of the spans around one block's windows (one block a tile, a
    cluster of up to eight, or the lane-per-query kernel, by the span):
    bits (tau = 0: scores) and k/16 margins equal the plain version
    (``_check_hard``/``_check_soft``) and, bit for bit, the lane-per-query
    kernel on the same list (``walk=True``) and the one-block kernel where
    it runs too (the list without its words, rank tables, up to 893
    features); packed equals int32."""
    from repro_torch.kernels import cam_match as K

    soft = dtype == "float32"
    if isinstance(f, str):
        span = int(f[4:])
        q, lo, hi, lm, cells = _span_operands(dtype, mode, n_bins, span, card)
        windows = -(-span // (ops.BITMAP_FEATURES if cells.words is not None else K.RANK_FEATURES))
        assert K.kernel_route(cells) == ("bit-parallel", windows)
        assert span != 1784 or windows == ops.MAX_MEMBERS  # the cluster of eight
    else:
        q, lo, hi, lm, cells = _wide_operands(dtype, mode, n_bins, f, card)
    if soft:
        _check_soft(K, q, lo, hi, lm, cells, 0.0, card)
        out = K.cam_match_soft_cuda(q, cells, lm, tau=0.0)
        lines = K.soft_scores_cuda(q, cells, tau=0.0)
        kw, run, match = {"tau": 0.0}, K.cam_match_soft_cuda, K.soft_scores_cuda
    else:
        out = _check_hard(K, q, lo, hi, lm, cells, mode, card)
        lines = K.cam_match_bits_cuda(q, cells, mode=mode)
        kw, run, match = {"mode": mode}, K.cam_match_cuda, K.cam_match_bits_cuda
    assert torch.equal(run(q, cells, lm, walk=True, **kw), out)
    assert torch.equal(match(q, cells, walk=True, **kw), lines)
    one_block = _ranked(cells)
    if dtype != "uint8" and K.kernel_route(one_block) == ("bit-parallel", 1):
        assert torch.equal(run(q, one_block, lm, **kw), out)
        assert torch.equal(match(q, one_block, **kw), lines)
    if dtype in ("uint8", "uint16"):
        operands = _span_operands if isinstance(f, str) else _wide_operands
        q32, _, _, lm32, cells32 = operands("int32", mode, n_bins, span if isinstance(f, str)
                                            else f, card)
        assert torch.equal(out, K.cam_match_cuda(q32, cells32, lm32, mode=mode))


@pytest.mark.gpu
@pytest.mark.parametrize("f", WIDE_WIDTHS)
@pytest.mark.parametrize("tau,leaf", [(0.0, "margins"), (0.1, "margins"), (0.1, "moments")])
def test_cuda_soft_kernel_wide_table(card, tau, leaf, f):
    """The soft kernel and its moments pass at F_pad = 2,048 and 8,192
    against the plain version (``_check_soft``); at tau = 0 equal to the
    int32 ``direct`` kernel bit for bit."""
    from repro_torch.kernels import cam_match as K

    torch.backends.cuda.matmul.allow_tf32 = False
    q, lo, hi, lm, cells = _wide_operands("float32", "soft", 256, f, card, normal=tau > 0)
    if leaf == "moments":
        lm = torch.cat([lm, lm * lm, (lm != 0).float()], dim=1).contiguous()
    _check_soft(K, q, lo, hi, lm, cells, tau, card)
    if tau == 0.0:
        iq, _, _, ilm, icells = _wide_operands("int32", "direct", 256, f, card)
        assert torch.equal(K.cam_match_soft_cuda(q, cells, lm, tau=0.0),
                           K.cam_match_cuda(iq, icells, ilm, mode="direct"))


# -- models in: dumps and trained ensembles on the card ------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("level", ["off", "full"])
def test_ingested_goldens_on_the_card(card, level):
    """Every golden dump through ``build(path, compress=level)`` predicts
    its recorded answers on the card."""
    import json
    from pathlib import Path

    fixtures = Path(__file__).parent / "fixtures" / "ingest"
    dumps = sorted(p for p in fixtures.iterdir()
                   if p.suffix in (".json", ".txt") and ".expected" not in p.name)
    assert len(dumps) == 8
    for dump in dumps:
        exp = json.loads(dump.with_name(dump.name.rsplit(".", 1)[0] + ".expected.json")
                         .read_text())
        x = np.asarray(exp["x"], dtype=np.float64)
        cm = repro_torch.build(str(dump), compress=level)
        pred, margin = cm.predict(x), cm.raw_margin(x)
        if cm.table.task == "regression":
            np.testing.assert_allclose(pred, exp["predict"], rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(pred, np.asarray(exp["predict"]).astype(pred.dtype))
        np.testing.assert_allclose(margin, exp["raw_margin"], rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_trained_forest_with_long_rows_on_the_card(card):
    """A random forest deeper than the 8 staged cells a row, trained,
    compressed and served on the card, equals the numpy ensemble."""
    from repro_torch.core.quantize import FeatureQuantizer
    from repro_torch.core.trees import RFParams, train_rf

    rng = np.random.default_rng(2)
    x = rng.normal(size=(600, 12))
    y = (x[:, 0] * x[:, 1] + x[:, 2] > 0).astype(np.int64)
    quant = FeatureQuantizer.fit(x, 256)
    xb = quant.transform(x)
    ens = train_rf(xb, y, task="binary", n_bins=256, n_classes=2,
                   params=RFParams(n_trees=12, max_depth=13, seed=1))
    cm = repro_torch.build(ens, quantizer=quant, compress="auto")
    assert int(cm.engine().arrays.cells.count.max()) > 8
    np.testing.assert_array_equal(cm.predict(x), ens.predict(xb))


# -- the serving, scoring and baseline tiers on the card ----------------------------


def _tier_model():
    """40 trees of depth 6 (k/16 leaves: every sum is exact in any order)."""
    ens = random_deep_ensemble(n_trees=40, depth=6, n_features=30, n_bins=256,
                               task="multiclass", n_classes=5, seed=3)
    q = np.random.default_rng(5).integers(0, 256, size=(300, 30)).astype(np.uint8)
    return ens, repro_torch.build(ens), q


@pytest.mark.gpu
def test_microbatcher_on_the_card_equals_engine_predict(card):
    from repro_torch.kernels import cam_match as K
    from repro_torch.serve import MicroBatcher

    ens, cm, q = _tier_model()
    eng = cm.engine()
    assert eng.device.type == "cuda"
    mb = MicroBatcher.for_engine(eng, max_batch=256)
    mbm = MicroBatcher.for_engine(eng, max_batch=256, kind="margin")
    sizes, ids, row = [1, 3, 1, 7, 2, 1, 17, 1, 40], [], 0
    for s in sizes:
        ids.append((mb.submit(q[row:row + s]), mbm.submit(q[row:row + s]), q[row:row + s]))
        row += s
    before = K.cam_match_cuda.launches
    out, outm = mb.flush(), mbm.flush()
    assert K.cam_match_cuda.launches == before + 2  # one launch a flush
    for rid, ridm, chunk in ids:
        np.testing.assert_array_equal(out[rid], eng.predict(chunk).cpu().numpy())
        np.testing.assert_array_equal(outm[ridm], ens.raw_margin(chunk))


@pytest.mark.gpu
def test_cluster_on_the_card_equals_serve_loop_through_a_crash(card):
    from repro_torch.serve import ClusterServer, ServeLoop, TableRegistry, make_trace, replay_trace

    _, cm, q = _tier_model()
    trace = make_trace(["m"], 200, seed=7, mean_interval_s=1e-4, marks=[(0.5, "crash")])
    reg = TableRegistry()
    reg.register("m", cm)
    loop = ServeLoop(reg, window_s=100.0, flush_rows=16, max_batch=128)
    oracle = replay_trace(loop.submit, trace, {"m": q}, speed=0)
    loop.drain()
    want = [loop.result(h) for h in oracle.handles]
    with ClusterServer(n_replicas=2, flush_rows=16, max_batch=128) as srv:
        srv.register("m", cm)
        assert all(r.stream is not None for r in srv.replicas.values())
        res = replay_trace(srv.submit, trace, {"m": q}, speed=0,
                           callbacks={"crash": lambda: srv.inject_crash(1)})
        srv.drain(timeout=60)
        for h, w in zip(res.handles, want):
            np.testing.assert_array_equal(h.result(5), w)


@pytest.mark.gpu
@pytest.mark.parametrize("chunk_rows", [1000, 64, 37])
def test_score_file_on_the_card_chunked_equals_one_shot(card, chunk_rows):
    from repro_torch.kernels import cam_match as K

    ens, cm, q = _tier_model()
    one_shot = cm.raw_margin(q)
    np.testing.assert_array_equal(one_shot, ens.raw_margin(q))
    before = K.cam_match_cuda.launches
    on = repro_torch.score_file(cm, q, kind="margin", chunk_rows=chunk_rows)
    assert K.cam_match_cuda.launches == before + on.n_chunks
    off = repro_torch.score_file(cm, q, kind="margin", chunk_rows=chunk_rows,
                                 double_buffer=False)
    pred = repro_torch.score_file(cm, q, kind="predict", chunk_rows=chunk_rows)
    np.testing.assert_array_equal(on.values, one_shot)
    np.testing.assert_array_equal(off.values, one_shot)
    np.testing.assert_array_equal(pred.values, ens.predict(q))
    assert on.engine["device"].startswith("cuda")


@pytest.mark.gpu
def test_score_file_on_the_card_while_kernels_run(card):
    """Chunks whose kernels take milliseconds: the copy of chunk i+1 runs
    while chunk i's kernel still reads its queries, so a device buffer the
    copy stream writes must never be memory that kernel was given."""
    ens = random_deep_ensemble(n_trees=2048, depth=8, n_features=130, n_bins=256,
                               task="multiclass", n_classes=8, seed=4)
    cm = repro_torch.build(ens)
    q = np.random.default_rng(8).integers(0, 256, size=(8192, 130)).astype(np.uint8)
    want = np.concatenate([cm.raw_margin(q[i:i + 512]) for i in range(0, q.shape[0], 512)])
    np.testing.assert_array_equal(want[:64], ens.raw_margin(q[:64]))
    for chunk in (1024, 4096):
        for db in (True, False):
            r = repro_torch.score_file(cm, q, kind="margin", chunk_rows=chunk, double_buffer=db)
            np.testing.assert_array_equal(r.values, want)


@pytest.mark.gpu
@pytest.mark.parametrize("task", ["multiclass", "binary", "regression"])
def test_traversal_baseline_on_the_card(card, task):
    ens = random_deep_ensemble(n_trees=40, depth=6, n_features=30, n_bins=256, task=task,
                               n_classes=5 if task == "multiclass" else 1, seed=3)
    q = np.random.default_rng(6).integers(0, 256, size=(257, 30)).astype(np.uint8)
    tb = repro_torch.TraversalBaseline(ens)
    got = tb.raw_margin(q)
    assert got.is_cuda
    np.testing.assert_array_equal(got.cpu().numpy(), ens.raw_margin(q))
    np.testing.assert_array_equal(tb.predict(q), ens.predict(q))


@pytest.mark.gpu
def test_eight_threads_bind_one_engine_on_the_card(card):
    import threading

    _, cm, q = _tier_model()
    barrier, engines = threading.Barrier(8), []

    def bind():
        barrier.wait(timeout=60)
        engines.append(cm.engine())

    threads = [threading.Thread(target=bind) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert len(engines) == 8 and all(e is engines[0] for e in engines)
    assert len(cm._engines) == 1
    np.testing.assert_array_equal(engines[0].predict(q).cpu().numpy(), cm.predict(q))


@pytest.mark.gpu
def test_autotune_on_the_card_and_tuned_bits(card):
    """A sweep on the card records platform 'cuda'; its plan applies per
    bucket and every bucket gives the untuned artifact's bits."""
    from repro_torch.kernels import cam_match as K

    ens = random_deep_ensemble(n_trees=32, depth=6, n_features=30, n_bins=256,
                               task="multiclass", n_classes=4, seed=8)
    cm = repro_torch.build(ens)
    plan = repro_torch.autotune_kernel(cm, batch=256, batches=(1, 16), b_blks=(64,),
                                       r_blks=(128, 256))
    assert plan.env["platform"] == "cuda" and plan.env["device_name"] == \
        torch.cuda.get_device_name(0)
    assert plan.timed_on("cuda") and len(plan.trials) == 3 * 2 * 3
    tuned = cm.with_tuning(plan)
    q = np.random.default_rng(9).integers(0, 256, size=(256, 30)).astype(np.uint8)
    before = K.cam_match_cuda.launches
    for b in (1, 16, 256):
        np.testing.assert_array_equal(tuned.raw_margin(q[:b]), cm.raw_margin(q[:b]))
        np.testing.assert_array_equal(tuned.predict(q[:b]), ens.predict(q[:b]))
        assert tuned.engine(batch_hint=b).table_dtype == plan.dispatch_for(b)["table_dtype"]
    assert K.cam_match_cuda.launches == before + 9


@pytest.mark.gpu
def test_ingest_score_commands_on_the_card(card, tmp_path):
    """``python -m repro_torch.cli.ingest`` -> ``...score --expected`` with
    ``--device cuda`` in subprocesses."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    fixtures = root / "tests" / "fixtures"
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    for argv in (
        ["repro_torch.cli.ingest", str(fixtures / "ingest" / "xgb_deep.json"),
         "--out", str(tmp_path / "art"), "--device", "cuda",
         "--expected", str(fixtures / "ingest" / "xgb_deep.expected.json")],
        ["repro_torch.cli.score", str(tmp_path / "art"), str(fixtures / "score" / "xgb_deep_x.npy"),
         "--expected", str(fixtures / "ingest" / "xgb_deep.expected.json"),
         "--chunk-rows", "10", "--device", "cuda"],
    ):
        r = subprocess.run([sys.executable, "-m", *argv], capture_output=True, text=True,
                           env=env, timeout=600)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "[verify]  OK" in r.stdout


@pytest.mark.gpu
@pytest.mark.parametrize("noc,spmd", [("accumulate", "shard_map"), ("accumulate", "gspmd"),
                                      ("batch", "shard_map"), ("batch", "gspmd"),
                                      ("hybrid", "shard_map")])
def test_mesh_of_logical_card_shards(card, noc, spmd):
    """8 logical shards of the card ((2, 4) mesh): one kernel launch a
    shard a call, k/16 margins and predictions equal to the single-device
    engine's, the shards views of one copy of the table on the card."""
    from repro_torch.kernels import cam_match as K
    from repro_torch.launch.mesh import make_host_mesh

    ens = random_deep_ensemble(n_trees=40, depth=6, n_features=30, n_bins=256,
                               task="multiclass", n_classes=5, seed=3)
    cm = repro_torch.build(ens)
    q = np.random.default_rng(4).integers(0, 256, size=(45, 30)).astype(np.uint8)
    mesh = make_host_mesh(2, 4, devices=[card] * 8)
    eng = cm.engine(mesh=mesh, noc_config=noc, spmd=spmd)
    assert eng.device.type == "cuda" and not eng.fuse_epilogue
    assert all(s.device.type == "cuda" and s.cells.count.is_cuda
               for row in eng.shards for s in row)
    base = eng.shards[0][0].low.data_ptr()
    per = eng.arrays.r_pad // eng.n_row_shards * eng.arrays.f_pad * eng.arrays.low.element_size()
    assert eng.shards[1][-1].low.data_ptr() == base + (eng.n_row_shards - 1) * per
    before = K.cam_match_cuda.launches
    m = eng.raw_margin(q)
    assert K.cam_match_cuda.launches == before + 8 and m.is_cuda
    np.testing.assert_array_equal(m.cpu().numpy(), cm.raw_margin(q))
    np.testing.assert_array_equal(eng.predict(q).cpu().numpy(), ens.predict(q))
    assert torch.equal(eng.raw_margin(q), m)


@pytest.mark.gpu
def test_soft_mesh_on_the_card(card):
    """Soft tau = 0.1 on 8 logical card shards, within the summation bound
    of the single-device kernel; tau = 0 bit-equal to 'direct'."""
    from repro_torch.kernels import cam_match as K
    from repro_torch.kernels.ref import summation_bound
    from repro_torch.launch.mesh import make_host_mesh

    ens = random_deep_ensemble(n_trees=40, depth=6, n_features=30, n_bins=256,
                               task="multiclass", n_classes=5, seed=3)
    soft = repro_torch.build(ens, deploy=repro_torch.DeployConfig(mode="soft", tau=0.1))
    q = np.random.default_rng(5).integers(0, 256, size=(37, 30)).astype(np.uint8)
    mesh = make_host_mesh(2, 4, devices=[card] * 8)
    one, eng = soft.engine(), soft.engine(mesh=mesh)
    a = one.arrays
    scores = soft_scores_ref(one._prep_queries(q), a.low, a.high, tau=0.1)
    lim = summation_bound(scores, a.leaf, K.n_splits(a.r_pad) + 8)[:, :5].cpu()
    err = (eng.raw_margin(q).cpu() - one.raw_margin(q).cpu()).abs().double()
    assert bool((err <= lim).all())
    direct = soft.engine(mesh=mesh, mode="direct", table_dtype="int32")
    assert torch.equal(soft.engine(mesh=mesh, tau=0.0).raw_margin(q), direct.raw_margin(q))


@pytest.mark.gpu
def test_checkpoint_on_the_card(card, tmp_path):
    """A nested dict of CUDA tensors restores bit-exact onto the card and,
    through a placer, onto a mesh's devices; a runner on the card resumes
    to an uninterrupted run's history."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.ft.runtime import FaultTolerantRunner, InjectedFailure
    from repro_torch.launch.mesh import make_host_mesh

    g = torch.Generator(device=card).manual_seed(0)
    tree = {"w": torch.randn(64, 32, device=card, generator=g),
            "emb": torch.randn(16, 8, device=card, generator=g).to(torch.bfloat16),
            "opt": {"step": torch.arange(5, device=card, dtype=torch.int64)}}
    save_checkpoint(str(tmp_path / "a"), 1, tree)
    _, back = restore_checkpoint(str(tmp_path / "a"), tree)
    for k in ("w", "emb"):
        assert back[k].is_cuda and back[k].dtype == tree[k].dtype and torch.equal(back[k], tree[k])
    assert torch.equal(back["opt"]["step"], tree["opt"]["step"])
    mesh = make_host_mesh(2, 4, devices=[card] * 8)
    _, placed = restore_checkpoint(
        str(tmp_path / "a"), tree,
        placer=lambda t: {d: {k: v.to(d) for k, v in t.items() if k != "opt"}
                          for d in set(mesh.devices.flat)})
    assert all(torch.equal(v, tree[k]) for d in placed.values() for k, v in d.items())

    def step(state, i):
        new = {"x": state["x"] * 1.01 + i, "n": state["n"] + 1}
        return new, {"loss": float(new["x"].sum())}

    def init():
        return {"x": torch.ones(4, device=card), "n": torch.zeros((), dtype=torch.int32,
                                                                 device=card)}

    with pytest.raises(InjectedFailure):
        FaultTolerantRunner(str(tmp_path / "r"), step, init, ckpt_every=5).run(20, failure_at=12)
    s2, h2 = FaultTolerantRunner(str(tmp_path / "r"), step, init, ckpt_every=5).run(20)
    s3, h3 = FaultTolerantRunner(str(tmp_path / "ref"), step, init, ckpt_every=5).run(20)
    assert s2["x"].is_cuda and torch.equal(s2["x"], s3["x"])
    ref = {h["step"]: h["loss"] for h in h3}
    assert h2[0]["step"] == 10 and all(h["loss"] == ref[h["step"]] for h in h2)


@pytest.mark.gpu
def test_mesh_across_cards(card):
    """A mesh over distinct cards (run on a machine with 2 or more): every
    NoC program equal to one card bit for bit, each card holding only the
    rows of its shards, and the streamed scoring and the replicated
    cluster — whose copies between cards must follow every shard's
    kernel — equal to ``cm.predict``."""
    from repro_torch.launch.mesh import Mesh, make_host_mesh
    from repro_torch.score import score_file
    from repro_torch.serve import ClusterServer

    n = min(4, torch.cuda.device_count())
    if n < 2:
        pytest.skip("needs 2 or more CUDA cards")
    cards = [torch.device("cuda", i) for i in range(n)]
    ens = random_deep_ensemble(n_trees=64, depth=6, n_features=30, n_bins=256,
                               task="multiclass", n_classes=5, seed=6)
    cm = repro_torch.build(ens)
    q = np.random.default_rng(7).integers(0, 256, size=(16384, 30)).astype(np.uint8)
    want_m, want_p = cm.raw_margin(q[:1000]), cm.predict(q)
    grid = np.empty(n, dtype=object)
    grid[:] = cards
    meshes = [make_host_mesh(devices=cards)]
    if n % 2 == 0:
        meshes.append(Mesh(grid.reshape(2, n // 2), ("data", "model")))
    for mesh in meshes:
        for noc in ("accumulate", "batch", "hybrid"):
            eng = cm.engine(mesh=mesh, noc_config=noc)
            assert {s.device for row in eng.shards for s in row} == set(cards)
            if noc != "batch":  # a card holds its row shard, not the table
                for row in eng.shards:
                    for s in row:
                        assert s.low.shape[0] == eng.arrays.r_pad // eng.n_row_shards
            np.testing.assert_array_equal(eng.raw_margin(q[:1000]).cpu().numpy(), want_m)
            r = score_file(cm, q, kind="predict", chunk_rows=1024, mesh=mesh, noc_config=noc)
            np.testing.assert_array_equal(r.values, want_p)
    with ClusterServer(n_replicas=2, mesh=meshes[-1], flush_rows=64) as srv:
        srv.register("m", cm)
        handles = [srv.submit("m", row) for row in q[:300]]
        srv.drain(timeout=60)
        np.testing.assert_array_equal(np.concatenate([h.result(10) for h in handles]),
                                      want_p[:300])


# -- the LM half (no kernel of its own: the same torch ops on the card) --------

LM_FIXTURE = Path(__file__).resolve().parent / "fixtures" / "torch_lm"


def _lm_smoke(module: str, **replace):
    import importlib

    return importlib.import_module(f"repro_torch.configs.{module}").smoke().replace(**replace)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["llama3.2-3b", "gemma3-1b", "deepseek-v3-671b",
                                  "llava-next-mistral-7b", "zamba2-2.7b", "rwkv6-1.6b",
                                  "whisper-tiny"])
def test_lm_fixture_replay_on_the_card(card, name):
    """The JAX package's recorded answers (tests/fixtures/torch_lm) on the
    card: the same seeded weights, each teacher-forced step's logits within
    1e-4, equal greedy tokens."""
    import json

    from repro_torch.convert import leaf_checksums, lm_params_from_numpy, seeded_numpy_params
    from repro_torch.launch.serve import generate, teacher_forced
    from repro_torch.models import build_model

    entry = json.loads((LM_FIXTURE / "manifest.json").read_text())["configs"][name]
    with np.load(LM_FIXTURE / entry["file"]) as z:
        fx = {k: z[k] for k in z.files}
    module = entry["file"].removesuffix(".npz")
    cfg = _lm_smoke(module, dtype="float32")
    tree = seeded_numpy_params(cfg, entry["seed"])
    assert leaf_checksums(tree) == entry["checksums"]
    torch.backends.cuda.matmul.allow_tf32 = False
    bundle = build_model(cfg, device=card)
    params = lm_params_from_numpy(cfg, tree, device=card)
    batch = {k: fx[k] for k in ("tokens", "embeds", "frames") if k in fx}
    logits = teacher_forced(bundle, params, batch, fx["greedy"]).cpu().numpy()
    err = np.abs(logits - fx["logits"]).max() / np.abs(fx["logits"]).max()
    assert err < 1e-4, err
    np.testing.assert_array_equal(logits.argmax(-1).T, fx["greedy"])
    if set(batch) == {"tokens"}:
        np.testing.assert_array_equal(
            generate(bundle, params, fx["tokens"], max_new=fx["greedy"].shape[1]), fx["greedy"])


@pytest.mark.gpu
@pytest.mark.parametrize("module", ["llama32_3b", "gemma3_1b", "deepseek_v3", "arctic_480b"])
def test_lm_card_equals_cpu(card, module):
    """One set of weights, made on the card: prefill and 4 teacher-forced
    decode steps on the card within 1e-4 of the port on the CPU (float32,
    TF32 off); two greedy runs on the card bit-equal."""
    from repro_torch.launch.serve import generate, teacher_forced
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_smoke(module, dtype="float32")
    on_card = build_model(cfg, flash_blk=16, device=card)
    params = on_card.init_params(3)
    on_cpu = build_model(cfg, flash_blk=16, device="cpu")
    params_cpu = copy.deepcopy(params).to("cpu")  # Module.to moves in place
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (2, 32))
    nxt = rng.integers(0, cfg.vocab_size, (2, 5))
    got = teacher_forced(on_card, params, {"tokens": prompt}, nxt).cpu().numpy()
    ref = teacher_forced(on_cpu, params_cpu, {"tokens": prompt}, nxt).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4
    a = generate(on_card, params, prompt, max_new=6)
    np.testing.assert_array_equal(a, generate(on_card, params, prompt, max_new=6))


@pytest.mark.gpu
@pytest.mark.parametrize("module,prompt_len", [("zamba2_2p7b", 32), ("zamba2_2p7b", 20),
                                               ("rwkv6_1p6b", 32), ("rwkv6_1p6b", 20),
                                               ("whisper_tiny", 24)])
def test_lm_recurrent_and_encdec_card_equals_cpu(card, module, prompt_len):
    """zamba2, rwkv6 and whisper at the smoke size, one set of seeded
    weights: prefill and 4 teacher-forced decode steps on the card within
    1e-4 of the port on the CPU (float32, TF32 off; S = 32 takes RWKV's
    chunked form and two SSD chunks, S = 20 the scan and chunks of 10;
    whisper on 40 frames); two greedy runs on the card bit-equal."""
    from repro_torch.convert import lm_params_from_numpy, seeded_numpy_params
    from repro_torch.launch.serve import generate, teacher_forced
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_smoke(module, dtype="float32")
    tree = seeded_numpy_params(cfg, 3)
    on_card = build_model(cfg, flash_blk=16, device=card)
    on_cpu = build_model(cfg, flash_blk=16, device="cpu")
    params = lm_params_from_numpy(cfg, tree, device=card)
    params_cpu = lm_params_from_numpy(cfg, tree, device="cpu")
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, prompt_len))}
    if cfg.is_encoder_decoder:
        batch["frames"] = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    nxt = rng.integers(0, cfg.vocab_size, (2, 5))
    got = teacher_forced(on_card, params, batch, nxt).cpu().numpy()
    ref = teacher_forced(on_cpu, params_cpu, batch, nxt).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4
    if not cfg.is_encoder_decoder:
        a = generate(on_card, params, batch["tokens"], max_new=6)
        np.testing.assert_array_equal(a, generate(on_card, params, batch["tokens"], max_new=6))


@pytest.mark.gpu
def test_lm_serve_command_on_the_card():
    import os
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--max-new", "8"],
        capture_output=True, text=True, cwd=str(root), timeout=600,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith("generated (4, 8) tokens in ")


# -- the LM half's training path (eager torch ops on the card) ------------------

LM_TRAIN = {"llama3.2-3b": "llama32_3b", "deepseek-v3-671b": "deepseek_v3",
            "zamba2-2.7b": "zamba2_2p7b", "rwkv6-1.6b": "rwkv6_1p6b",
            "whisper-tiny": "whisper_tiny"}


def _loss_grads(bundle, params, batch):
    """(loss, metrics, per-leaf gradient tensors, global norm) of one
    loss_fn + backward."""
    from repro_torch.launch.train import loss_and_grads, on_device
    from repro_torch.models.common import leaf_tensors, tree_leaves
    from repro_torch.optim.adamw import global_norm

    loss, metrics, grads = loss_and_grads(bundle, params,
                                          on_device(batch, bundle.device, torch.float32))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            [leaf_tensors(leaf) for _, leaf in tree_leaves(grads)], float(global_norm(grads)))


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(LM_TRAIN))
def test_lm_train_fixture_replay_on_the_card(card, name):
    """The JAX package's recorded training answers (tests/fixtures/torch_lm/
    train.json) on the card in float32, TF32 off: loss, metrics and the
    gradient norm within 1e-5 relative."""
    import json

    from _torch_lm_batch import lm_batch
    from repro_torch.convert import lm_params_from_numpy, seeded_numpy_params
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    fx = json.loads((LM_FIXTURE / "train.json").read_text())
    fb, ans = fx["batch"], fx["configs"][name]
    cfg = _lm_smoke(LM_TRAIN[name], dtype="float32")
    bundle = build_model(cfg, flash_blk=fb["flash_blk"], device=card)
    params = lm_params_from_numpy(cfg, seeded_numpy_params(cfg, fb["seed"]), device=card)
    loss, metrics, _, gnorm = _loss_grads(bundle, params, lm_batch(cfg, fb["seed"], fb["b"],
                                                                    fb["s"]))
    assert abs(loss / ans["loss"] - 1) < 1e-5 and abs(gnorm / ans["grad_norm"] - 1) < 1e-5
    assert metrics.keys() == ans["metrics"].keys()
    for k, v in metrics.items():
        assert abs(v - ans["metrics"][k]) <= 1e-5 * max(abs(ans["metrics"][k]), 1e-3), k


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(LM_TRAIN))
def test_lm_train_card_equals_cpu(card, name):
    """One set of seeded weights, float32, TF32 off: loss_fn + backward on the
    card within 1e-5 (loss) and 1e-4 (each gradient leaf, max|d|/max|ref|)
    of the port on the CPU; remat on the card gives the same gradients."""
    from _torch_lm_batch import lm_batch
    from repro_torch.convert import lm_params_from_numpy, seeded_numpy_params
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_smoke(LM_TRAIN[name], dtype="float32")
    tree = seeded_numpy_params(cfg, 7)
    batch = lm_batch(cfg, 7)
    got = _loss_grads(build_model(cfg, flash_blk=16, device=card),
                      lm_params_from_numpy(cfg, tree, device=card), batch)
    ref = _loss_grads(build_model(cfg, flash_blk=16, device="cpu"),
                      lm_params_from_numpy(cfg, tree, device="cpu"), batch)
    assert abs(got[0] / ref[0] - 1) < 1e-5
    for g, r in zip(got[2], ref[2]):
        scale = max(float(t.abs().max()) for t in r)
        err = max(float((a.cpu() - b).abs().max()) for a, b in zip(g, r))
        assert err <= 1e-4 * scale
    cfg_r = cfg.replace(remat=True)
    again = _loss_grads(build_model(cfg_r, flash_blk=16, device=card),
                        lm_params_from_numpy(cfg_r, tree, device=card), batch)
    assert again[0] == got[0]
    assert all(torch.equal(a, b) for g, h in zip(got[2], again[2]) for a, b in zip(g, h))


@pytest.mark.gpu
def test_lm_train_steps_on_the_card(card, tmp_path):
    """bfloat16 llama smoke with remat: 3 train steps twice from one seed give
    equal losses and bit-equal parameters; the recorded 3 steps (microbatch
    2, int8 compression) within 1e-5 in float32; ``train()`` crashed after
    step 6 resumes to an uninterrupted run's losses (rtol 1e-6)."""
    import json

    from repro_torch.convert import lm_params_from_numpy, seeded_numpy_params
    from repro_torch.data import TokenPipeline
    from repro_torch.ft.runtime import InjectedFailure
    from repro_torch.launch import train as ttrain
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_tensors
    from repro_torch.optim.adamw import AdamW, AdamWConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_smoke("llama32_3b", remat=True)
    pipe = TokenPipeline(cfg.vocab_size, 4, 64, seed=1)
    runs = []
    for _ in range(2):
        bundle = build_model(cfg, device=card)
        params = bundle.init_params(1)
        opt = AdamW(AdamWConfig(warmup_steps=2, decay_steps=10))
        step = ttrain.make_train_step(bundle, opt)
        state = opt.init(params)
        losses = []
        for i in range(3):
            params, state, _, m = step(params, state, None,
                                       ttrain.on_device(pipe.batch(i), card, torch.bfloat16))
            losses.append(float(m["loss"]))
        runs.append((losses, [t.detach().clone() for t in tree_tensors(params.jax_layout())]))
    assert runs[0][0] == runs[1][0] and all(np.isfinite(runs[0][0]))
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))

    st = json.loads((LM_FIXTURE / "train.json").read_text())["train_steps"]
    cfg32 = _lm_smoke("llama32_3b", dtype="float32")
    bundle = build_model(cfg32, device=card)
    params = lm_params_from_numpy(cfg32, seeded_numpy_params(cfg32, st["seed"]), device=card)
    opt = AdamW(AdamWConfig(**st["opt"]))
    step = ttrain.make_train_step(bundle, opt, microbatch=st["microbatch"],
                                  compress=st["compress"])
    state, residual = opt.init(params), None
    pipe = TokenPipeline(cfg32.vocab_size, st["global_batch"], st["seq_len"], seed=st["seed"])
    losses = []
    for i in range(st["n_steps"]):
        params, state, residual, m = step(params, state, residual,
                                          ttrain.on_device(pipe.batch(i), card, torch.float32))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, st["losses"], rtol=1e-5)

    kw = dict(global_batch=2, seq_len=32, ckpt_every=4, seed=3, log_every=100, device=card)
    with pytest.raises(InjectedFailure):
        ttrain.train(cfg, steps=10, run_dir=str(tmp_path / "a"), failure_at=6, **kw)
    resumed = ttrain.train(cfg, steps=10, run_dir=str(tmp_path / "a"), **kw)
    whole = {h["step"]: h["loss"] for h in ttrain.train(cfg, steps=10,
                                                         run_dir=str(tmp_path / "b"), **kw)}
    assert [h["step"] for h in resumed] == list(range(4, 10))
    for h in resumed:
        np.testing.assert_allclose(h["loss"], whole[h["step"]], rtol=1e-6)


@pytest.mark.gpu
def test_lm_train_command_on_the_card(tmp_path):
    import os
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-3b",
         "--scale", "0.05", "--steps", "3", "--run-dir", str(tmp_path)],
        capture_output=True, text=True, cwd=str(root), timeout=600,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith("done: 3 steps in ")


# -- the LM mesh: logical shards of the card --------------------------------------------------


def _mesh_losses(cfg, tree, batches, devices, shape):
    """Two train steps on a ``shape`` mesh over ``devices`` (None: one
    device, the CPU) from the numpy weights ``tree``: (losses, the whole
    parameters on the CPU)."""
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_tensors
    from repro_torch.optim.adamw import AdamW, AdamWConfig
    from repro_torch.sharding.placement import gather_tree

    dev = torch.device(devices[0])
    mesh = make_host_mesh(*shape, devices=devices)
    bundle = build_model(cfg, flash_blk=16, device=dev)
    opt = AdamW(AdamWConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=10))
    params = ttrain.place_params(mesh, cfg, lm_params_from_numpy(cfg, tree, device=dev))
    step = ttrain.make_train_step(bundle, opt, mesh)
    state, losses = opt.init(params), []
    for b in batches:
        batch = ttrain.place_batch(mesh, ttrain.on_device(b, dev, torch.float32))
        params, state, _, m = step(params, state, None, batch)
        losses.append(float(m["loss"]))
    return losses, [t.cpu() for t in tree_tensors(gather_tree(params, "cpu"))]


@pytest.mark.gpu
@pytest.mark.parametrize("module,replace", [("llama32_3b", {}),
                                            ("deepseek_v3", {"capacity_factor": 0.5})])
def test_lm_mesh_step_card_equals_cpu(card, module, replace):
    """Two mesh steps on 8 logical shards of the card ((4, 2)) against the
    same program on 8 CPU shards, float32, TF32 off: losses within 1e-5,
    every parameter within 1e-4 of its scale; two card runs bit-equal."""
    from repro_torch.convert import seeded_numpy_params
    from repro_torch.launch.train import batch_source

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _lm_smoke(module, dtype="float32", **replace)
    tree = seeded_numpy_params(cfg, 9)
    get = batch_source(cfg, 8, 32, seed=9)
    batches = [get(i) for i in range(2)]
    got = _mesh_losses(cfg, tree, batches, [card] * 8, (4, 2))
    again = _mesh_losses(cfg, tree, batches, [card] * 8, (4, 2))
    ref = _mesh_losses(cfg, tree, batches, ["cpu"] * 8, (4, 2))
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
    for a, b in zip(got[1], ref[1]):
        assert float((a - b).abs().max()) <= 1e-4 * max(1.0, float(b.abs().max()))
    assert got[0] == again[0] and all(torch.equal(a, b) for a, b in zip(got[1], again[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("kv", [1, 2])
def test_flash_decode_on_the_card(card, kv):
    """The flash-decode merge on a (2, 4) mesh of card shards within 1e-5 x
    scale of ``decode_attention`` on the card and of the same merge on CPU
    shards (float32)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.attention import decode_attention
    from repro_torch.models.decode_opt import flash_decode_shardmap

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(kv)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((2, 1, 8, 64), (2, 512, kv, 64), (2, 512, kv, 64)))
    got = flash_decode_shardmap(make_host_mesh(2, 4, devices=[card] * 8),
                                q.to(card), k.to(card), v.to(card), 300).cpu()
    ref = decode_attention(q.to(card), k.to(card), v.to(card), 300).cpu()
    cpu = flash_decode_shardmap(make_host_mesh(2, 4, devices=["cpu"] * 8), q, k, v, 300)
    scale = max(1.0, float(ref.abs().max()))
    assert float((got - ref).abs().max()) < 1e-5 * scale
    assert float((got - cpu).abs().max()) < 1e-5 * scale


@pytest.mark.gpu
def test_shardmap_moe_on_the_card(card):
    """The all-to-all MoE on a (2, 4) mesh of card shards: without drops
    within 1e-4 x scale of ``moe_forward`` (output and gradients); with
    drops the same keep masks as on CPU shards and the output within 1e-5
    x scale; two runs bit-equal."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.moe import MoEParams, moe_forward
    from repro_torch.models.moe_shardmap import make_shardmap_moe

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    p_cpu = MoEParams(64, 128, 16, 1, torch.float32, device="cpu", generator=g)
    p = copy.deepcopy(p_cpu).to(card)
    x_cpu = torch.randn(4, 32, 64, generator=g)
    x = x_cpu.to(card).requires_grad_(True)
    sm = make_shardmap_moe(make_host_mesh(2, 4, devices=[card] * 8))
    out, aux = sm(p, x, top_k=2, capacity_factor=16.0)
    ref, raux = moe_forward(p, x, top_k=2, capacity_factor=16.0)
    scale = max(1.0, float(ref.detach().abs().max()))
    assert float((out - ref).abs().max()) < 1e-4 * scale and abs(float(aux - raux)) < 1e-5
    gs = torch.autograd.grad((out * out).sum() + 0.01 * aux, [x, *p.parameters()])
    gr = torch.autograd.grad((ref * ref).sum() + 0.01 * raux, [x, *p.parameters()])
    for a, b in zip(gs, gr):
        assert float((a - b).abs().max()) < 1e-4 * max(1.0, float(b.abs().max()))
    on_cpu = make_shardmap_moe(make_host_mesh(2, 4, devices=["cpu"] * 8))
    with torch.no_grad():
        dropped, _ = sm(p, x, top_k=2, capacity_factor=1.0)
        again, _ = sm(p, x, top_k=2, capacity_factor=1.0)
        keep = [k.cpu() for k in sm.keep]
        cpu_out, _ = on_cpu(p_cpu, x_cpu, top_k=2, capacity_factor=1.0)
    assert int(sm.dropped) > 0 and torch.equal(dropped, again)
    assert all(torch.equal(a, b) for a, b in zip(keep, on_cpu.keep))
    assert float((dropped.cpu() - cpu_out).abs().max()) < 1e-5 * scale


@pytest.mark.gpu
def test_lm_train_use_mesh_command_on_the_card(tmp_path):
    """``--use-mesh --device cuda``: 8 logical shards of the card."""
    import os
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-3b",
         "--scale", "0.05", "--steps", "3", "--use-mesh", "--device", "cuda",
         "--run-dir", str(tmp_path)],
        capture_output=True, text=True, cwd=str(root), timeout=600,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith("done: 3 steps in ")


# -- the redesigned uint8 and soft tau > 0 kernels ----------------------------------


def _normal_leaves(lm: torch.Tensor, c: int) -> torch.Tensor:
    """Seeded normal leaves, ``c`` channels, on the rows of ``lm``."""
    rng = np.random.default_rng(c)
    return torch.from_numpy(rng.normal(size=(lm.shape[0], c)).astype(np.float32)).to(lm.device)


def _span_tables(span: int, n_bins: int, *, b: int, r: int = 512):
    """A table ``span`` features wide whose every row lists 8 cells, one of
    them the last feature: its cell list's span is ``span``."""
    rng = np.random.default_rng(span)
    low = np.zeros((r, span), np.int32)
    high = np.full((r, span), n_bins, np.int32)
    q = rng.integers(0, n_bins, size=(b, span))
    for i in range(r):
        cols = [span - 1, *rng.choice(span - 1, size=7, replace=False).tolist()]
        lo = rng.integers(0, n_bins - 1, size=8)
        hi = np.minimum(n_bins, lo + rng.integers(1, n_bins // 2, size=8))
        if i % 4 == 0:
            lo, hi = np.minimum(lo, q[i % b, cols]), np.maximum(hi, q[i % b, cols] + 1)
        low[i, cols], high[i, cols] = lo, hi
    leaf = (rng.integers(-16, 17, size=(r, C)) / 16.0).astype(np.float32)
    return low, high, leaf, q


@pytest.mark.gpu
@pytest.mark.parametrize("width", ["narrow", "span223", "span224", 2048, 8192])
def test_uint8_bit_parallel_equals_int32_inclusive(card, width):
    """The uint8 kernels against the int32 `inclusive` kernel, bit for bit
    — match words and normal-leaf margins — at B = 1, 7, 37, 256 and 1024:
    the bit-parallel kernel on a narrow table and on a list of span 223
    (one block's widest window, F_pad 256), on a cluster of two blocks a
    tile at span 224, and on tables whose rows list features past every
    staged window (a cluster or the lane-per-query kernel, by the span);
    B = 1 equals each row of a batch."""
    from repro_torch.kernels import cam_match as K

    for b in (1, 7, 37, 256, 1024):
        if width == "narrow":
            q8, _, _, lm, c8 = _operands("uint8", "inclusive", 256, card, b=b, r=300)
            q32, _, _, _, c32 = _operands("int32", "inclusive", 256, card, b=b, r=300)
        else:
            if isinstance(width, str):
                span = int(width[4:])
                low, high, leaf, q = _span_tables(span, 256, b=b)
            else:
                low, high, leaf, q = _wide_tables(width, 256, b=b)
            lo, hi, lm, _ = ops.pack_tables(low, high, leaf, r_blk=128, f_blk=128, n_bins=256,
                                            dtype="uint8", inclusive=True)
            c8 = ops.binding_cells(lo, hi, n_bins=256, inclusive=True,
                                   n_real_rows=low.shape[0]).to(card)
            c32 = ops.binding_cells(lo.astype(np.int32), hi.astype(np.int32), n_bins=256,
                                    inclusive=True, n_real_rows=low.shape[0]).to(card)
            q8 = ops.pad_queries(q, lo.shape[1], dtype="uint8", device=card)
            q32 = ops.pad_queries(q, lo.shape[1], dtype="int32", device=card)
            lm = torch.from_numpy(lm).to(card)
            if isinstance(width, str):
                assert c8.span == span and lo.shape[1] == 256
            else:
                assert c8.span > K.BITMAP_FEATURES  # past one block's window
        leaves = _normal_leaves(lm, 8)
        bits = K.cam_match_bits_cuda(q8, c8, mode="inclusive")
        assert torch.equal(bits, K.cam_match_bits_cuda(q32, c32, mode="inclusive"))
        out = K.cam_match_cuda(q8, c8, leaves, mode="inclusive")
        assert torch.equal(out, K.cam_match_cuda(q32, c32, leaves, mode="inclusive"))
        for i in range(0, b, max(1, b // 5)):
            assert torch.equal(K.cam_match_cuda(q8[i:i + 1], c8, leaves, mode="inclusive"),
                               out[i:i + 1])


def _soft_leaves_c(dev, c: int, *, lattice: bool, b: int):
    """Soft operands with ``c`` normal leaf channels; ``lattice=False``
    shifts the queries by a quarter bin, off the kernel's lattice."""
    (q, lo, hi, lm, cells), _ = _soft_operands(dev, normal=True, b=b)
    if not lattice:
        q = q + 0.25
    return q, lo, hi, _normal_leaves(lm, c), cells


@pytest.mark.gpu
@pytest.mark.parametrize("lattice", [True, False], ids=["lattice", "computed"])
@pytest.mark.parametrize("c", [8, 24])
@pytest.mark.parametrize("tau", [0.1, 0.5])
def test_soft_tau_kernel_within_the_bounds(card, tau, c, lattice):
    """The soft tau > 0 kernel (lattice table or computed log-sigmoids,
    register-tiled leaf product at C = 8 and 24) within the unchanged
    ``soft_score_bound`` / ``soft_margin_bound`` of the plain version at B
    = 1, 37 and 45; B = 1 equals each row of the batch; the two paths
    agree bit for bit."""
    from repro_torch.kernels import cam_match as K

    torch.backends.cuda.matmul.allow_tf32 = False
    for b in (1, 37, 45):
        q, lo, hi, lm, cells = _soft_leaves_c(card, c, lattice=lattice, b=b)
        assert cells.lattice
        s_ref = soft_scores_ref(q, lo, hi, tau=tau)
        m_ref = cam_match_ref(q, lo, hi, lm, mode="soft", tau=tau)
        scores = K.soft_scores_cuda(q, cells, tau=tau)
        out = K.cam_match_soft_cuda(q, cells, lm, tau=tau)
        assert ((scores - s_ref).abs().double() <= soft_score_bound(s_ref, lo.shape[1])).all()
        lim = soft_margin_bound(s_ref, lm, lo.shape[1], extra=K.n_splits(lo.shape[0]) + 2)
        assert ((out - m_ref).abs().double() <= lim).all()
        for i in range(b):
            assert torch.equal(K.cam_match_soft_cuda(q[i:i + 1], cells, lm, tau=tau),
                               out[i:i + 1])
        computed = copy.copy(cells)
        object.__setattr__(computed, "lattice", False)
        assert torch.equal(K.cam_match_soft_cuda(q, computed, lm, tau=tau), out)


@pytest.mark.gpu
@pytest.mark.parametrize("side", ["lo", "hi"])
def test_soft_per_term_error_one_cell_sweep(card, side):
    """A one-cell table (F = 1, the smallest width) swept over x: each
    score expf(log_sigmoid(x)) within the per-term budget of
    ``soft_score_bound`` against float64 — 8u of |ls| and expf's 2 ulp —
    through the computed log-sigmoid (x dense in [-104, 104], +-0,
    subnormals) and the lattice table (half-integer x, tau 1 and 0.1)."""
    from repro_torch.core.precision import soft_inv
    from repro_torch.kernels import cam_match as K

    u = 2.0 ** -24
    dense = np.concatenate([np.linspace(-104, 104, 1 << 18),
                            [0.0, -0.0, 1e-40, -1e-40, 1e-45, -1e-45]])
    half = np.arange(-255.5, 256.0, 1.0)
    q = torch.zeros((1, 1), dtype=torch.float32, device=card)
    for xs, tau, lattice in ((dense, 1.0, False), (half, 1.0, True), (half, 0.1, True)):
        b = (-xs if side == "lo" else xs).astype(np.float32)[:, None]
        inf = np.full_like(b, np.inf)
        lo, hi = (b, inf) if side == "lo" else (-inf, b)
        cells = ops.CellList(np.ones(len(xs), np.int32), np.zeros((len(xs), 1), np.uint16),
                             lo, hi, 1).to(card)
        assert cells.lattice == lattice
        s = K.soft_scores_cuda(q, cells, tau=tau)[0].double().cpu().numpy()
        x = (xs.astype(np.float32) * np.float32(soft_inv(tau))).astype(np.float64)
        ls = np.minimum(x, 0.0) - np.log1p(np.exp(-np.abs(x)))
        s64 = np.exp(ls)
        lim = s64 * (8 * u * np.abs(ls) + 4 * u) + 2.0 ** -126
        assert not np.isnan(s).any() and (np.abs(s - s64) <= lim).all()


# -- the bit-parallel kernel's two routes (uint16, int32, soft tau = 0) ----------------


def _ranked(cells: ops.CellList) -> ops.CellList:
    """The list without its packed words: every tile takes the rank route."""
    out = copy.copy(cells)
    object.__setattr__(out, "words", None)
    return out


def _route_operands(dtype, mode, n_bins, dev, *, b, tiles_on_bins, noisy=False, span=None):
    """``_tables`` at ``n_bins`` (noisy: bounds moved by up to +-3, negative
    ones among them, 2% never-match) whose query tiles ``tiles_on_bins``
    hold bins below 256 (the value route) and the others bins up to
    ``n_bins`` - 1 (the rank route); ``span``: the table that wide, its
    rows listing a feature near the edge."""
    rng = np.random.default_rng(n_bins + len(tiles_on_bins) + 7 * noisy)
    f = F if span is None else span
    q = rng.integers(0, n_bins, size=(b, f))
    for t in tiles_on_bins:
        q[32 * t:32 * t + 32] = rng.integers(0, min(256, n_bins), size=q[32 * t:32 * t + 32].shape)
    if span is None:
        low, high = _tables(rng, n_bins, q, r=R, wild=0.1 if noisy else 0.6, noisy=noisy)
    else:
        low, high = _span_cut(rng, n_bins, q)
    leaf = (rng.integers(-16, 17, size=(R, C)) / 16.0).astype(np.float32)
    incl = mode == "inclusive"
    if incl:
        lo, hi, lm, _ = ops.pack_tables(low, high, leaf, r_blk=R_BLK, f_blk=F_BLK,
                                        n_bins=n_bins, dtype=dtype, inclusive=True)
    else:
        lo, hi, lm = ops.pad_tables(low, high, leaf, r_blk=R_BLK, f_blk=F_BLK, n_bins=n_bins)
        lo, hi = lo.astype(dtype), hi.astype(dtype)
    cells = ops.binding_cells(lo, hi, n_bins=n_bins, inclusive=incl, n_real_rows=R)
    qp = ops.pad_queries(q, lo.shape[1], dtype=dtype, device=dev)
    return (qp, *(torch.from_numpy(a).to(dev) for a in (lo, hi, lm)), cells.to(dev))


def _span_cut(rng, n_bins, q):
    """Tables as wide as ``q``, every row listing 6 cells, one of them the
    last feature, every fourth row widened to hold a query."""
    f = q.shape[1]
    low = np.zeros((R, f), np.int32)
    high = np.full((R, f), n_bins, np.int32)
    for i in range(R):
        cols = [f - 1, *rng.choice(f - 1, size=5, replace=False).tolist()]
        lo = rng.integers(0, n_bins - 1, size=6)
        hi = np.minimum(n_bins, lo + rng.integers(1, n_bins // 2, size=6))
        if i % 4 == 0:
            lo, hi = np.minimum(lo, q[i % q.shape[0], cols]), np.maximum(hi, q[i % q.shape[0], cols] + 1)
        low[i, cols], high[i, cols] = lo, hi
    return low, high


ROUTE_CASES = {  # name: (n_bins, tiles on the bins of 2, noisy, span)
    "value": (256, (0, 1), False, None),
    "rank": (1000, (), False, None),
    "both": (1000, (1,), False, None),
    "both-noisy": (1000, (0,), True, None),
    "rank-span-600": (1000, (0,), False, 600),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,mode,case", [
    (d, m, c) for d, m in (("int32", "direct"), ("int32", "inclusive"), ("int32", "msb_lsb"),
                           ("int32", "two_cycle"), ("uint16", "direct"), ("uint16", "inclusive"))
    for c in ROUTE_CASES if d == "int32" or not ROUTE_CASES[c][2]])  # uint16: no negative bound
def test_cuda_bit_parallel_routes(card, dtype, mode, case):
    """The bit-parallel kernel on its value route (bins below 256), its
    rank route (bins past 255, a list without its words) and both in one
    call, at a span of 600 on a cluster of three blocks a tile (the list
    without its words: one block of rank tables): bits and k/16 margins
    equal the plain version (``_check_hard``, the list as built and
    widened), the list without its words gives the same, packed uint16
    equals int32, B = 1 equals each row."""
    from repro_torch.kernels import cam_match as K

    n_bins, on_bins, noisy, span = ROUTE_CASES[case]
    q, lo, hi, lm, cells = _route_operands(dtype, mode, n_bins, card, b=45,
                                           tiles_on_bins=on_bins, noisy=noisy, span=span)
    if span is not None:  # a cluster of three blocks a tile; without words, one of ranks
        assert K.BITMAP_FEATURES < cells.span <= K.RANK_FEATURES
        assert ops.packing(cells) == "window" and K.kernel_route(cells) == ("bit-parallel", 3)
        assert K.kernel_route(_ranked(cells)) == ("bit-parallel", 1)
    out = _check_hard(K, q, lo, hi, lm, cells, mode, card)
    assert torch.equal(K.cam_match_cuda(q, _ranked(cells), lm, mode=mode), out)
    assert torch.equal(K.cam_match_bits_cuda(q, _ranked(cells), mode=mode),
                       cam_match_bits_ref(q, lo, hi, mode=mode))
    for i in (0, 31, 32, 44):
        assert torch.equal(K.cam_match_cuda(q[i:i + 1], cells, lm, mode=mode), out[i:i + 1])
    if dtype == "uint16":
        q32, _, _, lm32, c32 = _route_operands("int32", mode, n_bins, card, b=45,
                                               tiles_on_bins=on_bins, span=span)
        assert torch.equal(out, K.cam_match_cuda(q32, c32, lm32, mode=mode))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["value", "rank", "odd-queries", "perturbed"])
def test_cuda_soft_tau_zero_routes(card, case):
    """Soft tau = 0 on the bit-parallel kernel: the value route (bin
    queries), the rank route (the list without its words) and queries with
    NaN, +-inf, half bins, -1 and 300 (a query with a non-finite feature
    scores 0): scores and k/16 margins equal the plain version bit for bit,
    and, on bin queries, the int32 `direct` kernel's margins and bits."""
    from repro_torch.kernels import cam_match as K

    (q, lo, hi, lm, cells), (low, high, leaf, qi) = _soft_operands(
        card, perturbed=case == "perturbed")
    assert cells.words is not None
    if case == "odd-queries":
        rng = np.random.default_rng(5)
        pick = torch.from_numpy(rng.random(tuple(q[32:].shape)) < 0.05).to(card)
        odd = torch.tensor([float("nan"), float("inf"), -float("inf"), 2.5, -1.0, 300.0],
                           device=card)
        q[32:][pick] = odd[torch.from_numpy(rng.integers(0, 6, size=int(pick.sum()))).to(card)]
        assert not torch.isfinite(q).all()
    cl = _ranked(cells) if case == "rank" else cells
    s_ref = soft_scores_ref(q, lo, hi, tau=0.0)
    scores = K.soft_scores_cuda(q, cl, tau=0.0)
    out = K.cam_match_soft_cuda(q, cl, lm, tau=0.0)
    assert torch.equal(scores, s_ref) and torch.equal(out, cam_match_ref(q, lo, hi, lm, mode="soft",
                                                                         tau=0.0))
    if case == "odd-queries":
        assert not s_ref[~torch.isfinite(q).all(dim=1)].any()
        return
    ilo, ihi, ilm = ops.pad_tables(low, high, leaf, r_blk=R_BLK, f_blk=F_BLK, n_bins=256)
    icells = ops.binding_cells(ilo, ihi, n_bins=256, inclusive=False, n_real_rows=R).to(card)
    iq = ops.pad_queries(qi, ilo.shape[1], dtype="int32", device=card)
    assert torch.equal(out, K.cam_match_cuda(iq, icells, torch.from_numpy(ilm).to(card),
                                             mode="direct"))
    bits = cam_match_bits_ref(iq, *(torch.from_numpy(a).to(card) for a in (ilo, ihi)),
                              mode="direct")
    assert torch.equal(scores, bits.float())
