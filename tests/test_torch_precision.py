"""(c) The port's torch cell functions equal ``repro.core.precision``.

The full 8-bit sweep: every query in [0, 256) against every (T_L, T_H)
pair of a grid that crosses each MSB/LSB boundary, plus random pairs, for
the four hard modes; int32 tables with negative bounds (the inclusive-high
encoding of degenerate cells) split with the same arithmetic shift; and
the copied registry and soft encoding match.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import precision as jp
from repro_torch.core import precision as tp

HARD = ("direct", "inclusive", "msb_lsb", "two_cycle")
GRID = np.array([0, 1, 2, 14, 15, 16, 17, 31, 32, 33, 127, 128, 129, 239, 240,
                 241, 254, 255, 256])


def _sweep(rng):
    q = np.arange(256).reshape(-1, 1, 1)
    tl = GRID[GRID < 256].reshape(1, -1, 1)
    th = GRID.reshape(1, 1, -1)
    rl = rng.integers(0, 256, size=(1, 64, 1))
    rh = rng.integers(0, 257, size=(1, 1, 64))
    return [(q, tl, th), (q, rl, rh)]


@pytest.mark.parametrize("mode", HARD)
def test_hard_modes_full_8bit_sweep(mode):
    jfn, tfn = jp.CELL_MODES[mode].match, tp.CELL_MODES[mode].match
    for q, tl, th in _sweep(np.random.default_rng(0)):
        for dt in ("int32",) + (("uint8",) if mode == "inclusive" else ()):
            hi = th - 1 if mode == "inclusive" else th  # inclusive-high encoding
            if dt == "uint8":
                hi = np.clip(hi, 0, 255)
            args = [a.astype(dt) for a in (q, tl, hi)]
            ref = np.asarray(jfn(*(jnp.asarray(a) for a in args)))
            got = tfn(*(torch.from_numpy(a) for a in args)).numpy()
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mode", HARD)
def test_negative_int32_bounds_split_like_jnp(mode):
    """Perturbed int32 tables hold negative values (high=0 stored inclusive
    as -1): ``>>`` must be the arithmetic shift on both sides."""
    rng = np.random.default_rng(1)
    q = rng.integers(-20, 280, size=(300, 1)).astype(np.int32)
    lo = rng.integers(-40, 260, size=(1, 200)).astype(np.int32)
    hi = rng.integers(-40, 280, size=(1, 200)).astype(np.int32)
    ref = np.asarray(jp.CELL_MODES[mode].match(jnp.asarray(q), jnp.asarray(lo), jnp.asarray(hi)))
    got = tp.CELL_MODES[mode].match(torch.from_numpy(q), torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_array_equal(got.numpy(), ref)
    v = np.arange(-300, 300, dtype=np.int32)
    for a, b in zip(jp.split_msb_lsb(jnp.asarray(v)), tp.split_msb_lsb(torch.from_numpy(v))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_uint16_inclusive_compares_by_value():
    rng = np.random.default_rng(2)
    q = rng.integers(0, 65536, size=(64, 1)).astype(np.uint16)
    lo = rng.integers(0, 65536, size=(1, 128)).astype(np.uint16)
    hi = rng.integers(0, 65536, size=(1, 128)).astype(np.uint16)
    ref = np.asarray(jp.match_inclusive(jnp.asarray(q), jnp.asarray(lo), jnp.asarray(hi)))
    got = tp.match_inclusive(*(torch.from_numpy(a) for a in (q, lo, hi)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_registry_and_soft_encoding_copied():
    assert tp.mode_names() == jp.mode_names()
    for name, jm in jp.CELL_MODES.items():
        tm = tp.CELL_MODES[name]
        assert (tm.table_dtype_policy, tm.faithful, tm.packable, tm.soft) == (
            jm.table_dtype_policy, jm.faithful, jm.packable, jm.soft)
        assert (tm.match is None) == (jm.match is None)
    with pytest.raises(ValueError, match="registered modes"):
        tp.get_cell_mode("analog")
    rng = np.random.default_rng(3)
    low = rng.integers(0, 257, size=(40, 9))
    high = rng.integers(0, 257, size=(40, 9))
    low[:5], high[:5] = 0, 256
    for a, b in zip(jp.encode_soft_bounds(low, high, 256), tp.encode_soft_bounds(low, high, 256)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
