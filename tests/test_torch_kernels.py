"""(d) The port's plain ``cam_match_ref``/``cam_match_bits_ref`` against
the JAX package's ``cam_match_ref`` and its Pallas kernel, which runs here
in interpret mode exactly as the JAX package's own CPU tests run it.

Match bits are exact; margins are exact on k/16 leaves (dyadic sums are
order-free) and within the ``tests/oracles.py`` contract (``rtol=1e-6,
atol=1e-7``: float32 reassociation) on normal leaves.  The CUDA kernel
is held to the plain version on the card in ``test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracles import random_tables

from repro.kernels import ops as jops
from repro.kernels.ref import cam_match_bits_ref as j_bits_ref
from repro.kernels.ref import cam_match_ref as j_ref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.ref import cam_match_bits_ref, cam_match_ref

VARIANTS = [  # (table dtype, kernel mode, n_bins)
    ("int32", "direct", 256), ("int32", "inclusive", 256),
    ("int32", "msb_lsb", 256), ("int32", "two_cycle", 256),
    ("uint8", "inclusive", 256), ("uint16", "inclusive", 1000),
]
B, R, F, C = 32, 96, 11, 3
R_BLK, F_BLK = 32, 128


def _problem(seed, dtype, mode, n_bins, dyadic):
    rng = np.random.default_rng(seed)
    low, high = random_tables(rng, R, F, n_bins)
    if dyadic:
        leaf = (rng.integers(-16, 17, size=(R, C)) / 16.0).astype(np.float32)
    else:
        leaf = rng.normal(size=(R, C)).astype(np.float32)
    q = rng.integers(0, n_bins, size=(B, F)).astype(np.int32)
    q[:4], q[4:8] = 0, n_bins - 1  # dtype-boundary queries
    lo, hi, lm, incl = jops.pack_tables(
        low, high, leaf, r_blk=R_BLK, f_blk=F_BLK, n_bins=n_bins, dtype=dtype,
        inclusive=True if mode == "inclusive" else None,
    )
    mask = jops.wildcard_tile_mask(lo, hi, r_blk=R_BLK, f_blk=F_BLK,
                                   n_bins=n_bins, inclusive=incl)
    qp = np.zeros((B, lo.shape[1]), dtype=lo.dtype)
    qp[:, :F] = q
    return qp, lo, hi, lm, mask


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("dyadic", [True, False], ids=["k16", "normal"])
@pytest.mark.parametrize("dtype,mode,n_bins", VARIANTS)
def test_plain_version_matches_jax(dtype, mode, n_bins, dyadic):
    qp, lo, hi, lm, mask = _problem(7, dtype, mode, n_bins, dyadic)
    tq, tlo, thi, tlm = _torch(qp, lo, hi, lm)
    bits = cam_match_bits_ref(tq, tlo, thi, mode=mode).numpy()
    np.testing.assert_array_equal(
        bits, np.asarray(j_bits_ref(jnp.asarray(qp), jnp.asarray(lo), jnp.asarray(hi), mode=mode))
    )
    assert bits.any() and not bits.all()  # the problem exercises both outcomes
    got = cam_match_ref(tq, tlo, thi, tlm, mode=mode).numpy()
    ref = np.asarray(j_ref(jnp.asarray(qp), jnp.asarray(lo), jnp.asarray(hi),
                           jnp.asarray(lm), mode=mode))
    pallas = np.asarray(jops.cam_match(
        jnp.asarray(qp), jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(lm),
        jnp.asarray(mask), out_b=B, out_c=lm.shape[1], b_blk=B, r_blk=R_BLK,
        f_blk=F_BLK, mode=mode, interpret=True,
    ))
    # the port's ops entry on CPU tensors is the plain version (+ bias)
    cells = tops.binding_cells(lo, hi, n_bins=n_bins, inclusive=mode == "inclusive",
                               n_real_rows=R)
    via_ops = tops.cam_match(tq, tlo, thi, tlm, cells, out_b=B,
                             out_c=lm.shape[1], mode=mode).numpy()
    np.testing.assert_array_equal(via_ops, got)
    for other in (ref, pallas):
        if dyadic:
            np.testing.assert_array_equal(got, other)
        else:
            np.testing.assert_allclose(got, other, rtol=1e-6, atol=1e-7)


def test_plain_version_chunks_rows_in_a_fixed_order(monkeypatch):
    """Row chunking changes no bit on k/16 leaves and matches the one-shot
    JAX reference within float32 reassociation on normal leaves."""
    import repro_torch.kernels.ref as tref

    qp, lo, hi, lm, _ = _problem(3, "uint8", "inclusive", 256, dyadic=False)
    tq, tlo, thi, tlm = _torch(qp, lo, hi, lm)
    whole = cam_match_ref(tq, tlo, thi, tlm, mode="inclusive")
    bits = cam_match_bits_ref(tq, tlo, thi, mode="inclusive")
    monkeypatch.setattr(tref, "CHUNK_ELEMS", B * lo.shape[1] * 7)  # 7-row chunks
    chunked = cam_match_ref(tq, tlo, thi, tlm, mode="inclusive")
    assert torch.equal(cam_match_bits_ref(tq, tlo, thi, mode="inclusive"), bits)
    assert torch.equal(chunked, cam_match_ref(tq, tlo, thi, tlm, mode="inclusive"))
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6, atol=1e-7)
