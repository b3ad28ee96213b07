"""(b) The port's host-side table prep is byte-equal to ``repro.kernels.ops``.

Same inputs from numpy seeds (``tests/oracles.py`` generators) through
both packages' ``pad_tables``/``pack_tables``/``wildcard_tile_mask``, for
uint8, uint16 and int32 and both encodings; the query padding and its
wrap check agree as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracles import random_cam_table, random_tables

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

CASES = [  # (n_bins, table dtype, r_blk, f_blk)
    (256, "uint8", 32, 16),
    (256, "uint8", 16, 128),
    (1000, "uint16", 32, 16),
    (65536, "uint16", 8, 8),
    (256, "int32", 32, 16),
    (70000, "int32", 16, 32),
]


def _same(a: np.ndarray, b: np.ndarray) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("inclusive", [None, True])
@pytest.mark.parametrize("n_bins,dtype,r_blk,f_blk", CASES)
def test_pack_and_mask_byte_equal(n_bins, dtype, r_blk, f_blk, inclusive):
    rng = np.random.default_rng(n_bins + r_blk)
    low, high = random_tables(rng, 77, 13, n_bins)
    leaf = rng.normal(size=(77, 3)).astype(np.float32)
    kw = dict(r_blk=r_blk, f_blk=f_blk, n_bins=n_bins, dtype=dtype, inclusive=inclusive)
    ref = jops.pack_tables(low, high, leaf, **kw)
    got = tops.pack_tables(low, high, leaf, **kw)
    for a, b in zip(ref[:3], got[:3]):
        _same(a, b)
    assert ref[3] == got[3]
    mk = dict(r_blk=r_blk, f_blk=f_blk, n_bins=n_bins, inclusive=ref[3])
    _same(jops.wildcard_tile_mask(ref[0], ref[1], **mk),
          tops.wildcard_tile_mask(got[0], got[1], **mk))
    for a, b in zip(jops.pad_tables(low, high, leaf, r_blk=r_blk, f_blk=f_blk, n_bins=n_bins),
                    tops.pad_tables(low, high, leaf, r_blk=r_blk, f_blk=f_blk, n_bins=n_bins)):
        _same(a, b)


def test_pack_cam_table_and_perturbed_int32():
    """A CAMTable from ``random_cam_table`` (wildcard sentinel rows) and a
    perturbed int32 table with negative / degenerate bounds."""
    rng = np.random.default_rng(5)
    t = random_cam_table(rng, r=90, f=21)
    for dtype in ("uint8", "uint16", "int32"):
        a = jops.pack_tables(t.low, t.high, t.leaf_matrix(), n_bins=t.n_bins,
                             r_blk=64, dtype=dtype)
        b = tops.pack_tables(t.low, t.high, t.leaf_matrix(), n_bins=t.n_bins,
                             r_blk=64, dtype=dtype)
        for x, y in zip(a[:3], b[:3]):
            _same(x, y)
    low = rng.integers(-40, 300, size=(50, 7)).astype(np.int32)
    high = rng.integers(-40, 300, size=(50, 7)).astype(np.int32)
    leaf = np.ones((50, 1), np.float32)
    for incl in (None, True):
        a = jops.pack_tables(low, high, leaf, r_blk=16, f_blk=8, dtype="int32", inclusive=incl)
        b = tops.pack_tables(low, high, leaf, r_blk=16, f_blk=8, dtype="int32", inclusive=incl)
        for x, y in zip(a[:3], b[:3]):
            _same(x, y)
    for mod in (jops, tops):  # both refuse what a packed dtype cannot hold
        with pytest.raises(ValueError, match="do not fit"):
            mod.pack_tables(low, high, leaf, r_blk=16, dtype="uint8")


@pytest.mark.parametrize("dtype", ["uint8", "uint16", "int32"])
def test_query_padding_and_range_check(dtype):
    rng = np.random.default_rng(3)
    q = rng.integers(0, 256, size=(9, 6)).astype(np.int64)
    ref = np.asarray(jops.pad_to_bucket(jnp.asarray(q), 16, 32, dtype=dtype))
    for src in (q, torch.from_numpy(q)):
        got = tops.pad_to_bucket(src, 16, 32, dtype=dtype)
        assert got.dtype == tops.TORCH_DTYPES[dtype]
        np.testing.assert_array_equal(got.to(torch.int64).numpy(), ref.astype(np.int64))
    np.testing.assert_array_equal(
        tops.pad_queries(q, 32, b_blk=4, dtype=dtype).to(torch.int64).numpy(),
        np.asarray(jops.pad_queries(q, 32, b_blk=4, dtype=dtype)).astype(np.int64),
    )
    bad = q.copy()
    bad[0, 0] = 70000 if dtype == "uint16" else 300
    if dtype == "int32":
        return  # no narrowing, nothing to reject
    for src in (bad, torch.from_numpy(bad)):
        with pytest.raises(ValueError, match="do not fit"):
            tops.pad_to_bucket(src, 16, 32, dtype=dtype)
    with pytest.raises(ValueError, match="do not fit"):
        jops.check_query_range(bad, dtype)
