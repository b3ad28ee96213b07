"""The CUDA kernels on a card, held to the plain PyTorch version.

Marked ``gpu``: each test skips with a reason where torch sees no CUDA
device.  This file imports no JAX (the machine with the card has none), so
it runs there on its own:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""

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
    the margins, one more for the moments; held to the CPU engine."""
    from repro_torch.kernels import cam_match as K

    torch.backends.cuda.matmul.allow_tf32 = False
    ens = random_deep_ensemble(n_trees=40, depth=6, n_features=30, n_bins=256,
                               task="multiclass", n_classes=5, seed=3)
    cm = repro_torch.build(ens, deploy=repro_torch.DeployConfig(mode="soft", tau=tau))
    q = np.random.default_rng(4).integers(0, 256, size=(77, 30)).astype(np.uint8)
    before = K.cam_match_soft_cuda.launches
    p = cm.predict_proba(q)
    pred, unc = cm.predict(q, return_uncertainty=True)
    assert K.cam_match_soft_cuda.launches == before + 3  # proba, predict, moments
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
