"""Plain PyTorch version of the cam_match kernels (all five cell modes).

Semantics (the whole X-TIME datapath between DAC and router, §III-A):

    match[b, r] = AND_f cell(q[b, f], low[r, f], high[r, f])
    out[b, c]   = SUM_r match[b, r] * leaf_matrix[r, c]

and, for ``mode='soft'`` on float32 soft-encoded tables, the score twin

    score[b, r] = exp(SUM_f soft_cell_logscore(q[b, f], low[r, f], high[r, f], tau))
    out[b, c]   = SUM_r score[b, r] * leaf_matrix[r, c]

It is the CPU backend of the port and the version the CUDA kernels
(``kernels/csrc/cam_match.cu``, ``kernels/csrc/cam_match_soft.cu``) are
held to on the card.  At the full width of xtime-tabular the (B, R, F)
compare would not fit any memory (256 x 1M x 256 is 68 GB), so every
function walks the rows in chunks whose size is a function of the shapes
only and sums the per-chunk leaf products in row order: the same inputs
always give the same bits, and soft at ``tau=0`` (scores exactly 0 or 1)
runs the very products of ``direct``.  The float32 products run at full
precision; a card with TF32 matmuls switched on is refused.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.precision import get_cell_mode, soft_match_scores

# compare elements (B * rows * F) per chunk: bounds the temporaries of the
# cell functions (msb_lsb holds about ten boolean ones, soft a few float32
# ones) to a few hundred MB each
CHUNK_ELEMS = 1 << 26

F32_EPS = 2.0 ** -24  # unit roundoff of float32
F32_TINY = 2.0 ** -126  # smallest normal float32: below it, underflow decides


def _rows_per_chunk(b: int, f: int) -> int:
    return max(1, CHUNK_ELEMS // max(1, b * f))


def _row_fn(mode: str, tau: float):
    """(q, low_rows, high_rows) -> (B, rows) match lines (bool) or soft
    scores (float32)."""
    cell = get_cell_mode(mode)
    if cell.soft:
        return lambda q, lo, hi: soft_match_scores(q, lo, hi, tau)
    return lambda q, lo, hi: cell.match(q[:, None, :], lo[None, :, :], hi[None, :, :]).all(dim=-1)


def _chunks(fn, q, low, high):
    step = _rows_per_chunk(q.shape[0], q.shape[1])
    for r in range(0, low.shape[0], step):
        yield r, step, fn(q, low[r : r + step], high[r : r + step])


def cam_match_bits_ref(
    q: torch.Tensor, low: torch.Tensor, high: torch.Tensor, *, mode: str = "direct"
) -> torch.Tensor:
    """(B, R) boolean match lines only (for MMR / debug paths)."""
    if get_cell_mode(mode).soft:
        raise ValueError("mode='soft' has scores, not match bits: use soft_scores_ref")
    return torch.cat([m for _, _, m in _chunks(_row_fn(mode, 0.0), q, low, high)], dim=1)


def soft_scores_ref(
    q: torch.Tensor,  # (B, F) float32 bins
    low: torch.Tensor,  # (R, F) soft-encoded float32 bounds
    high: torch.Tensor,
    *,
    tau: float,
) -> torch.Tensor:
    """(B, R) float32 soft row scores: the soft kernel's score matrix."""
    return torch.cat([s for _, _, s in _chunks(_row_fn("soft", tau), q, low, high)], dim=1)


def cam_match_ref(
    q: torch.Tensor,  # (B, F) integer bins (float32 for mode='soft')
    low: torch.Tensor,  # (R, F) inclusive lower bin bounds (soft: float32 encoded)
    high: torch.Tensor,  # (R, F) upper bounds (exclusive, or inclusive for 'inclusive')
    leaf_matrix: torch.Tensor,  # (R, C) leaf values routed to class channels
    *,
    mode: str = "direct",  # a repro_torch.core.precision.CELL_MODES name
    tau: float = 0.0,  # soft-mode boundary temperature (ignored otherwise)
) -> torch.Tensor:
    """Returns (B, C) accumulated logits/votes in float32."""
    if q.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "cam_match_ref needs full-precision float32 products; set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )
    out = torch.zeros(
        (q.shape[0], leaf_matrix.shape[1]), dtype=torch.float32, device=q.device
    )
    for r, step, match in _chunks(_row_fn(mode, tau), q, low, high):
        out += match.to(torch.float32) @ leaf_matrix[r : r + step]
    return out


# -- what the kernels are held to -------------------------------------------


def summation_bound(weights: torch.Tensor, leaf: torch.Tensor, extra: int) -> torch.Tensor:
    """(B, C) limit on |kernel - plain| for ``weights @ leaf`` summed in two
    orders: each float32 sum of n nonzero terms is within (n-1)·u·Σ|term|
    of the exact one (u = 2**-24); ``extra`` counts the partial-sum merges
    (splits, chunks) on top of the terms."""
    w = weights.double()
    absum = w @ leaf.abs().double()
    n = (w != 0).sum(dim=1, keepdim=True).double() + extra
    return 2.0 * n * F32_EPS * absum


def soft_score_bound(scores: torch.Tensor, n_features: int) -> torch.Tensor:
    """(B, R) limit on |kernel - plain| soft row scores, from the plain
    ``scores`` s.  Both evaluate each cell's two log-sigmoids from the same
    float32 arguments with expf (2 ulp) and log1pf (1 ulp): each log-score
    is within 8u of its magnitude; the F same-signed terms of a row add up
    in different orders, (F-1)u·|Σ|; so the sums differ by at most
    2(F+8)u·|ln s|, and exp adds 2 ulp each side:
    |Δs| <= s·(2(F+8)u·|ln s| + 8u) + 2**-126 (the last for underflow)."""
    s = scores.double()
    ln = torch.where(s > 0, -torch.log(s), torch.zeros_like(s))
    return s * (2.0 * (n_features + 8) * F32_EPS * ln + 8.0 * F32_EPS) + F32_TINY


def soft_margin_bound(scores: torch.Tensor, leaf: torch.Tensor, n_features: int,
                      extra: int) -> torch.Tensor:
    """(B, C) limit on |kernel - plain| soft margins: the score error
    carried through |leaf|, plus the reassociation of the row sum."""
    carried = soft_score_bound(scores, n_features) @ leaf.abs().double()
    return carried + summation_bound(scores, leaf, extra)


# -- the soft kernel's log-sigmoid, in float32 --------------------------------

# cam_match_soft.cu's constants: log2 e as a float32 head and tail, the
# rounding constant 1.5 * 2^23, and c1..c9 of log1p(t) / t = 1 + t (c1 +
# t (c2 + ... + t c9)), a degree-9 minimax fit on [0, 1] rounded to float32
LOG2E_HEAD = float.fromhex("0x1.715476p+0")
LOG2E_TAIL = float.fromhex("0x1.4ae0c0p-26")
ROUND = float.fromhex("0x1.8p+23")
LOG1P_COEFFS = tuple(float.fromhex(h) for h in (
    "-0x1.ffffd2p-2", "0x1.554df0p-2", "-0x1.ff26e2p-3", "0x1.935ca0p-3", "-0x1.3a7a82p-3",
    "0x1.b579c2p-4", "-0x1.d86322p-5", "0x1.4b0834p-6", "-0x1.b2f586p-9"))
# the header's per-side budget (cam_match_soft.cu): the mirror's own error
# (every float32 in [-104, 104], tools/log_sigmoid_sweep.py) plus the card's
# ex2.approx (2 ulp on [1, 2)), in units of u of |log_sigmoid|; the cell's
# lo + hi add brings it to at most 8u
MIRROR_ULPS = 2.85
EX2_ULPS = 4.0


def _fma32(a: np.ndarray, b, c) -> np.ndarray:
    """float32 a * b + c with one rounding (the product is exact in
    float64; the sum rounds there first, which can differ from the card's
    single rounding only at a float32 tie)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def log_sigmoid_f32(x: np.ndarray, ex2_ulps: float = 0.0) -> np.ndarray:
    """The float32 mirror of cam_match_soft.cu's ``log_sigmoid``:
    ``min(x, 0) - log1p(exp(-|x|))`` step for step as the kernel rounds it,
    with ex2 correctly rounded — or moved by ``ex2_ulps`` ulps (signed), as
    far as the card's ex2.approx may be from it."""
    x = np.asarray(x, dtype=np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        a = np.minimum(np.abs(x), np.float32(88.0))
        kr = _fma32(a, np.float32(LOG2E_HEAD), np.float32(ROUND))
        k = (kr - np.float32(ROUND)).astype(np.float32)
        f = _fma32(a, np.float32(LOG2E_TAIL), _fma32(a, np.float32(LOG2E_HEAD), -k))
        m = np.exp2(-f.astype(np.float64)).astype(np.float32)
        if ex2_ulps:
            m = (m.astype(np.float64) + ex2_ulps * np.spacing(m).astype(np.float64)).astype(
                np.float32)
        bits = (np.uint32(0x3F800000) - (kr.view(np.uint32) << np.uint32(23))).astype(np.uint32)
        t = (m * bits.view(np.float32)).astype(np.float32)
        p = np.full_like(t, np.float32(LOG1P_COEFFS[-1]))
        for c in LOG1P_COEFFS[-2::-1]:
            p = _fma32(p, t, np.float32(c))
        p = _fma32(p, t, np.float32(1.0))
        return _fma32(-t, p, np.minimum(x, np.float32(0.0)))
