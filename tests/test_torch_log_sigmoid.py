"""The soft kernel's log-sigmoid (``kernels/csrc/cam_match_soft.cu``
``log_sigmoid``) through its float32 mirror ``kernels.ref.log_sigmoid_f32``,
on the CPU.

The kernel evaluates ``min(x, 0) - log1p(exp(-|x|))`` as a Cody-Waite ex2
(``ex2.approx`` on the card, correctly rounded in the mirror) and a
degree-9 polynomial of log1p, every other step rounded as the mirror rounds
it.  Its header derives the per-term budget that ``ref.soft_score_bound``
grants each log-score, 8u of its magnitude: the mirror's own error
(``ref.MIRROR_ULPS``), plus ex2.approx's 2 ulp (``ref.EX2_ULPS``), plus the
cell's lo + hi add (0.5u).  Here, on a dense grid of x in [-104, 104] with
+-0, the infinities and subnormals, against float64:

(a) the mirror within MIRROR_ULPS u of |ls| (an absolute 2^-126 below
    |ls| = 2^-126, where a term is flushed to 0 and moves no score);
(b) with every ex2 moved 2 ulp either way, within MIRROR_ULPS + EX2_ULPS,
    and a cell's two sides within 8u;
(c) exactly +0 at x = +inf and -inf at x = -inf, never NaN;
(d) the kernel source holds the mirror's constants;
(e) within twice the budget of the JAX package's float32
    ``soft_cell_logscore``, as kernel against plain version;
(f) the lattice flag of the cell list the kernel's table reads through.
(The full sweep of every float32 in [-104, 104] is
``src/repro_torch/tools/log_sigmoid_sweep.py``.)
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import precision as jprec
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref

U = 2.0 ** -24
TINY = 2.0 ** -126
SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
          / "cam_match_soft.cu")


def _grid() -> np.ndarray:
    """Dense [-104, 104], random bit patterns in it, and the special values."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 0x42D00001, size=1 << 20, dtype=np.int64).astype(np.uint32)
    rand = bits.view(np.float32)
    sub = np.array([1e-45, 1e-40, 2.0 ** -126, 2.0 ** -127, 1e-38], np.float32)
    return np.concatenate([np.linspace(-104, 104, 1 << 20, dtype=np.float32), rand, -rand,
                           sub, -sub, np.array([0.0, -0.0, 87.68, 88.0, 103.97], np.float32)])


def _exact(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    return np.minimum(x, 0.0) - np.log1p(np.exp(-np.abs(x)))


def _check(got: np.ndarray, want: np.ndarray, ulps: float) -> float:
    """Worst err / budget; asserts every point within it."""
    err = np.abs(got.astype(np.float64) - want)
    lim = np.where(np.abs(want) >= TINY, ulps * U * np.abs(want), TINY)
    ratio = err / lim
    assert (ratio <= 1.0).all(), f"worst {ratio.max()} at x index {int(np.argmax(ratio))}"
    return float(ratio.max())


def test_mirror_within_its_budget_on_a_dense_grid():
    x = _grid()
    assert _check(ref.log_sigmoid_f32(x), _exact(x), ref.MIRROR_ULPS) > 0.5


@pytest.mark.parametrize("ex2_ulps", [2.0, -2.0])
def test_budget_with_the_cards_ex2_error(ex2_ulps):
    x = _grid()
    got = ref.log_sigmoid_f32(x, ex2_ulps)
    _check(got, _exact(x), ref.MIRROR_ULPS + ref.EX2_ULPS)
    # a cell: two sides of one query (lo side x, hi side 3 - x), added once
    other = (np.float32(3.0) - x).astype(np.float32)
    cell = (got + ref.log_sigmoid_f32(other, ex2_ulps)).astype(np.float32)
    _check(cell, _exact(x) + _exact(other), 8.0)


def test_special_values():
    x = np.array([np.inf, -np.inf, 0.0, -0.0, 200.0, -200.0, 1e-45, -1e-45], np.float32)
    for ulps in (0.0, 2.0, -2.0):
        y = ref.log_sigmoid_f32(x, ulps)
        assert y[0] == 0.0 and not np.signbit(y[0])
        assert y[1] == -np.inf
        assert y[4] == 0.0 and not np.signbit(y[4]) and y[5] == np.float32(-200.0)
        assert np.isfinite(y[[0, 2, 3, 4, 5, 6, 7]]).all() and not np.isnan(y).any()
        assert abs(float(y[2]) + np.log(2.0)) <= 4 * U


def test_kernel_source_holds_the_mirrors_constants():
    body = SOURCE.read_text()
    fn = body[body.index("__device__ __forceinline__ float log_sigmoid(float x)"):]
    fn = fn[:fn.index("\n}\n")]
    hexes = [float.fromhex(h.rstrip("f")) * (-1 if s else 1)
             for s, h in re.findall(r"(-?)(0x[0-9a-f.]+p[+-]?\d+f)", fn)]
    want = [ref.LOG2E_HEAD, ref.LOG2E_TAIL, *ref.LOG1P_COEFFS[::-1]]
    assert hexes == want
    assert f"{ref.ROUND:.1f}" == "12582912.0" and "0x1.8p+23f" in body


@pytest.mark.parametrize("tau", [0.1, 1.0])
def test_mirror_against_the_jax_log_score(tau):
    """The JAX package's float32 cell log-score with one side open (hi =
    +inf) is its log_sigmoid((q - lo) * inv): kernel and plain version
    each within 8u of |ls|."""
    rng = np.random.default_rng(1)
    q = rng.integers(0, 256, size=4096).astype(np.float32)
    lo = (rng.integers(-1, 256, size=4096) + 0.5).astype(np.float32)
    inv = np.float32(1.0 / tau)
    x = ((q - lo) * inv).astype(np.float32)
    j = np.asarray(jprec.soft_cell_logscore(jnp.asarray(q), jnp.asarray(lo),
                                            jnp.float32(np.inf), tau))
    mine = ref.log_sigmoid_f32(x)
    exact = _exact(x)
    err = np.abs(mine.astype(np.float64) - j.astype(np.float64))
    assert (err <= 16 * U * np.abs(exact) + TINY).all()


def test_lattice_flag_of_the_cell_list():
    """The table path needs every finite listed bound a half-integer of
    magnitude <= 256; the ELL padding past a row's count is not read."""
    lo = np.array([[-np.inf, 3.5, 0.0], [250.5, np.inf, 0.0]], np.float32)
    hi = np.array([[4.5, np.inf, 0.0], [np.inf, -np.inf, 0.0]], np.float32)
    count = np.array([2, 2], np.int32)
    feat = np.array([[0, 1, 0], [0, 1, 0]], np.uint16)
    assert tops.CellList(count, feat, lo, hi, 2).lattice
    for bad in (3.0, 256.5, 3.25):
        lo2 = lo.copy()
        lo2[0, 1] = bad
        assert not tops.CellList(count, feat, lo2, hi, 2).lattice
    assert tops.CellList(count, feat, lo, hi, 2).to("cpu").lattice
    ints = np.ones((2, 3), np.int32)
    assert not tops.CellList(count, feat, ints, ints, 2).lattice  # hard lists: no table
