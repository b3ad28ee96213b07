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


def _operands(dtype, mode, n_bins, dev):
    """Seeded exclusive-high tables, 60% wildcard cells, k/16 leaves, in
    the kernel layout of ``dtype`` (inclusive-high for mode='inclusive')."""
    rng = np.random.default_rng(11)
    low = rng.integers(0, n_bins, size=(R, F)).astype(np.int32)
    high = np.minimum(low + rng.integers(1, n_bins, size=(R, F)), n_bins).astype(np.int32)
    wild = rng.random((R, F)) < 0.6
    low[wild], high[wild] = 0, n_bins
    leaf = (rng.integers(-16, 17, size=(R, C)) / 16.0).astype(np.float32)
    q = rng.integers(0, n_bins, size=(B, F))
    incl = mode == "inclusive"
    if incl:
        lo, hi, lm, _ = ops.pack_tables(low, high, leaf, r_blk=R_BLK, f_blk=F_BLK,
                                        n_bins=n_bins, dtype=dtype, inclusive=True)
    else:
        lo, hi, lm = ops.pad_tables(low, high, leaf, r_blk=R_BLK, f_blk=F_BLK, n_bins=n_bins)
        lo, hi = lo.astype(dtype), hi.astype(dtype)
    mask = ops.wildcard_tile_mask(lo, hi, r_blk=R_BLK, f_blk=F_BLK, n_bins=n_bins,
                                  inclusive=incl)
    qp = ops.pad_queries(q, lo.shape[1], dtype=dtype, device=dev)
    return (qp, *(torch.from_numpy(a).to(dev) for a in (lo, hi, lm, mask)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,mode,n_bins", VARIANTS)
def test_cuda_kernel_matches_plain_version(card, dtype, mode, n_bins):
    """Bits and k/16 margins equal the plain version with the tile mask on
    and off; fused bias equals unfused + bias; packed equals int32."""
    from repro_torch.kernels import cam_match as K

    q, lo, hi, lm, mask = _operands(dtype, mode, n_bins, card)
    kw = dict(r_blk=R_BLK, f_blk=F_BLK, mode=mode)
    bits = cam_match_bits_ref(q, lo, hi, mode=mode)
    assert bits.any() and not bits.all()
    want = cam_match_ref(q, lo, hi, lm, mode=mode)
    bias = torch.full((1, lm.shape[1]), 0.75, device=card)
    for m in (mask, None):
        assert torch.equal(K.cam_match_bits_cuda(q, lo, hi, m, **kw), bits)
        out = K.cam_match_cuda(q, lo, hi, lm, m, **kw)
        assert torch.equal(out, want)
        assert torch.equal(K.cam_match_cuda(q, lo, hi, lm, m, bias, **kw), out + bias)
    if dtype != "int32":
        q32, lo32, hi32, lm32, mask32 = _operands("int32", mode, n_bins, card)
        assert torch.equal(out, K.cam_match_cuda(q32, lo32, hi32, lm32, mask32, **kw))


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


def _soft_operands(dev, *, perturbed=False, normal=False):
    """The tables of ``_operands`` in the float32 soft layout; ``perturbed``
    adds never-match cells (high <= low) to the real rows."""
    rng = np.random.default_rng(11)
    n_bins = 256
    low = rng.integers(0, n_bins, size=(R, F)).astype(np.int32)
    high = np.minimum(low + rng.integers(1, n_bins, size=(R, F)), n_bins).astype(np.int32)
    wild = rng.random((R, F)) < 0.6
    low[wild], high[wild] = 0, n_bins
    if perturbed:
        bad = rng.random((R, F)) < 0.01
        high[bad] = low[bad]
    if normal:
        leaf = rng.normal(size=(R, C)).astype(np.float32)
    else:
        leaf = (rng.integers(-16, 17, size=(R, C)) / 16.0).astype(np.float32)
    q = rng.integers(0, n_bins, size=(B, F))
    lo, hi, lm, _ = ops.pack_tables(low, high, leaf, r_blk=R_BLK, f_blk=F_BLK,
                                    n_bins=n_bins, dtype="float32")
    mask = ops.wildcard_tile_mask(lo, hi, r_blk=R_BLK, f_blk=F_BLK, n_bins=n_bins,
                                  inclusive=False)
    qp = ops.pad_queries(q, lo.shape[1], dtype="float32", device=dev)
    return (qp, *(torch.from_numpy(a).to(dev) for a in (lo, hi, lm, mask))), (low, high, leaf, q)


@pytest.mark.gpu
@pytest.mark.parametrize("tau", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("perturbed", [False, True], ids=["compiled", "perturbed"])
def test_cuda_soft_kernel_matches_plain_version(card, tau, perturbed):
    """Scores and margins against the plain version (exact at tau = 0,
    within ``soft_score_bound``/``soft_margin_bound`` otherwise), tile mask
    on and off, fused bias == unfused + bias, two runs identical, no NaN,
    never-match rows score exactly 0."""
    from repro_torch.kernels import cam_match as K

    torch.backends.cuda.matmul.allow_tf32 = False
    (q, lo, hi, lm, mask), _ = _soft_operands(card, perturbed=perturbed, normal=tau > 0)
    kw = dict(r_blk=R_BLK, f_blk=F_BLK, tau=tau)
    s_ref = soft_scores_ref(q, lo, hi, tau=tau)
    m_ref = cam_match_ref(q, lo, hi, lm, mode="soft", tau=tau)
    bias = torch.full((1, lm.shape[1]), 0.75, device=card)
    for m in (mask, None):
        scores = K.soft_scores_cuda(q, lo, hi, m, **kw)
        out = K.cam_match_soft_cuda(q, lo, hi, lm, m, **kw)
        torch.cuda.synchronize()
        assert not torch.isnan(scores).any() and not torch.isnan(out).any()
        never = torch.isposinf(lo).any(dim=1)  # rows holding a (+inf, -inf) cell
        assert never.any() == perturbed and (scores[:, never] == 0).all()
        if tau == 0.0:
            assert torch.equal(scores, s_ref) and torch.equal(out, m_ref)
        else:
            assert ((scores - s_ref).abs().double() <= soft_score_bound(s_ref, lo.shape[1])).all()
            lim = soft_margin_bound(s_ref, lm, lo.shape[1], extra=K.n_splits(lo.shape[0]) + 2)
            assert ((out - m_ref).abs().double() <= lim).all()
        assert torch.equal(K.cam_match_soft_cuda(q, lo, hi, lm, m, **kw), out)
        assert torch.equal(K.cam_match_soft_cuda(q, lo, hi, lm, m, bias, **kw), out + bias)


@pytest.mark.gpu
@pytest.mark.parametrize("normal", [False, True], ids=["k16", "normal"])
def test_cuda_soft_tau_zero_equals_direct_kernel(card, normal):
    """tau = 0 scores are exactly 0 or 1, so the margins are the int32
    `direct` kernel's, bit for bit, on normal leaves too."""
    from repro_torch.kernels import cam_match as K

    (q, lo, hi, lm, mask), (low, high, leaf, qi) = _soft_operands(card, normal=normal)
    ilo, ihi, ilm = ops.pad_tables(low, high, leaf, r_blk=R_BLK, f_blk=F_BLK, n_bins=256)
    imask = ops.wildcard_tile_mask(ilo, ihi, r_blk=R_BLK, f_blk=F_BLK, n_bins=256,
                                   inclusive=False)
    iq = ops.pad_queries(qi, ilo.shape[1], dtype="int32", device=card)
    ilo, ihi, ilm, imask = (torch.from_numpy(a).to(card) for a in (ilo, ihi, ilm, imask))
    direct = K.cam_match_cuda(iq, ilo, ihi, ilm, imask, r_blk=R_BLK, f_blk=F_BLK, mode="direct")
    soft = K.cam_match_soft_cuda(q, lo, hi, lm, mask, r_blk=R_BLK, f_blk=F_BLK, tau=0.0)
    assert torch.equal(soft, direct)
    bits = cam_match_bits_ref(iq, ilo, ihi, mode="direct")
    assert torch.equal(K.soft_scores_cuda(q, lo, hi, mask, r_blk=R_BLK, f_blk=F_BLK, tau=0.0),
                       bits.float())


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
