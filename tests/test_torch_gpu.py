"""The CUDA kernel on a card, held to the plain PyTorch version.

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
from repro_torch.kernels.ref import cam_match_bits_ref, cam_match_ref

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
