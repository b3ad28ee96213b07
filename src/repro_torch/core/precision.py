"""Increased-precision analog CAM arithmetic (§III-B, Eq. 1-3, Table I), in torch.

Memristor cells hold M=4 bits; the paper's macro-cell evaluates an
N=2M=8-bit range compare by splitting the threshold T = 16*T_MSB + T_LSB
and the query q = 16*q_MSB + q_LSB and computing (Eq. 3):

    T_L <= q < T_H  <=>
        [(q_M >= T_LM + 1) OR  (q_L >= T_LL)] AND (q_M >= T_LM)
    AND [(q_M <  T_HM)     OR  (q_L <  T_HL)] AND (q_M <  T_HM + 1)

The four hard cell functions of ``repro.core.precision`` written on torch
tensors: they broadcast over arbitrary leading shapes and are the plain
version the CUDA kernel's cell functors (``kernels/csrc/cam_match.cu``) are
held to.  The soft cell's log-score functions are their torch
counterparts, in the formula the CUDA soft kernel
(``kernels/csrc/cam_match_soft.cu``) computes.  The ``CellMode`` registry
and ``encode_soft_bounds`` are copies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

M_BITS = 4
M_LEVELS = 1 << M_BITS  # 16 analog levels per sub-cell


def _widen(v: torch.Tensor) -> torch.Tensor:
    """Unsigned/short bins -> int32, by zero extension for unsigned types
    (the value, not the bit pattern, is what compares)."""
    return v.to(torch.int32)


def split_msb_lsb(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """v in [0, 256) -> (v >> 4, v & 15), each an M-bit quantity.

    ``>>`` on int32 is an arithmetic shift, as in ``jnp``: perturbed int32
    tables may hold negative bounds (the inclusive-high encoding stores a
    degenerate ``high=0`` as -1), and they must split the same way.
    """
    v = _widen(v)
    return v >> M_BITS, v & (M_LEVELS - 1)


def match_direct(q: torch.Tensor, t_low: torch.Tensor, t_high: torch.Tensor) -> torch.Tensor:
    """The ideal 8-bit comparison the macro-cell must reproduce."""
    q = _widen(q)
    return (_widen(t_low) <= q) & (q < _widen(t_high))


def match_inclusive(q: torch.Tensor, t_low: torch.Tensor, t_high: torch.Tensor) -> torch.Tensor:
    """Compact table format: INCLUSIVE upper bound so all of [0, 255] fits
    in uint8 — low <= q <= high.  Never-match rows encode low=1 > high=0;
    always-match cells low=0, high=255.  uint8 and int32 compare in their
    own dtype; torch has no uint16 comparison, so uint16 compares after a
    zero-extending widening, which preserves every value."""
    if q.dtype == torch.uint16:
        q, t_low, t_high = _widen(q), _widen(t_low), _widen(t_high)
    return (t_low <= q) & (q <= t_high)


def match_msb_lsb(q: torch.Tensor, t_low: torch.Tensor, t_high: torch.Tensor) -> torch.Tensor:
    """Eq. 3 evaluated with only M-bit comparisons (the macro-cell logic)."""
    qm, ql = split_msb_lsb(q)
    tlm, tll = split_msb_lsb(t_low)
    thm, thl = split_msb_lsb(t_high)
    lower = ((qm >= tlm + 1) | (ql >= tll)) & (qm >= tlm)  # Eq. 2
    upper = ((qm < thm) | (ql < thl)) & (qm < thm + 1)  # dual for q < T_H
    return lower & upper


def match_two_cycle(q: torch.Tensor, t_low: torch.Tensor, t_high: torch.Tensor) -> torch.Tensor:
    """Cycle-level simulation of the Table-I two-step search.

    The match line is precharged once and each cycle can only discharge
    it, so the state after cycle 2 is the AND of both cycles:

      cycle 1  the OR brackets, with the MSB sub-cells fed q_MSB-1 (lower
               bound) and q_MSB (upper bound), the LSB sub-cells q_LSB;
      cycle 2  the LSB sub-cells driven to always mismatch, so each
               macro-cell reduces to its MSB term: (q_M >= T_LM) and
               (q_M - 1 < T_HM).
    """
    qm, ql = split_msb_lsb(q)
    tlm, tll = split_msb_lsb(t_low)
    thm, thl = split_msb_lsb(t_high)
    mal_after_1 = (((qm - 1) >= tlm) | (ql >= tll)) & ((qm < thm) | (ql < thl))
    return mal_after_1 & (qm >= tlm) & ((qm - 1) < thm)


def macro_cell_count(n_features: int, n_bits: int = 8) -> int:
    """aCAM sub-cells per row for the given precision (area model input).

    Direct unary extension would need 2^(N-M) cells per threshold; the
    paper's scheme needs exactly 2 sub-cells per macro-cell (×2 thresholds
    folded into one macro-cell pair) — doubling area and search latency
    rather than exponentiating them (§III-B).
    """
    if n_bits <= M_BITS:
        return n_features  # single sub-cell per feature
    if n_bits <= 2 * M_BITS:
        return 2 * n_features  # the paper's macro-cell
    raise ValueError(">8-bit thresholds are out of the paper's design space")


def encode_soft_bounds(
    low, high, n_bins: int
) -> tuple[np.ndarray, np.ndarray]:
    """Int bounds -> the float32 half-integer soft encoding (host-side ok).

    Maps the canonical exclusive-high int32 layout onto the soft cell's
    native float32 form: real cells at ``(low - 0.5, high - 0.5)``,
    wildcard cells (the full grid ``[0, n_bins)``) at ``(-inf, +inf)`` and
    never-match cells (``high <= low``, e.g. row padding's low=1/high=0)
    at ``(+inf, -inf)``.
    """
    low = np.asarray(low, dtype=np.int64)
    high = np.asarray(high, dtype=np.int64)
    lo_f = (low - 0.5).astype(np.float32)
    hi_f = (high - 0.5).astype(np.float32)
    wildcard = (low <= 0) & (high >= n_bins)
    never = high <= low
    lo_f[wildcard], hi_f[wildcard] = -np.inf, np.inf
    lo_f[never], hi_f[never] = np.inf, -np.inf
    return lo_f, hi_f


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``log(sigmoid(x))`` as ``min(x, 0) - log1p(exp(-|x|))``: the CUDA
    kernel's formula.  Exact 0 at ``+inf``, ``-inf`` at ``-inf``, never
    NaN (``jax.nn.log_sigmoid(+inf)`` is -0.0: equal under ``==``)."""
    return torch.clamp(x, max=0.0) - torch.log1p(torch.exp(-torch.abs(x)))


def soft_inv(tau: float) -> float:
    """``float32(1 / tau)`` as a Python float: the factor the soft cell
    multiplies by, here and in the CUDA kernel (``1 / tau`` in double,
    rounded once, as the JAX package computes it)."""
    return float(np.float32(1.0 / tau))


def soft_cell_logscore(
    q: torch.Tensor, low_f: torch.Tensor, high_f: torch.Tensor, tau: float
) -> torch.Tensor:
    """Per-cell log match score on soft-encoded float32 bounds.

    ``tau`` is the boundary temperature in BIN units.  ``tau == 0`` is
    the exact hard limit: log 1 inside ``(low_f, high_f)``, -inf outside.
    Otherwise the arguments are ``(q - low_f) * inv`` with ``inv =
    float32(1 / tau)``, multiplied as the JAX package does (a division
    rounds differently).  Wildcard cells ``(-inf, +inf)`` give exactly 0,
    never-match cells ``(+inf, -inf)`` exactly -inf; no ``hi - lo`` is
    ever formed, so no ``inf - inf``.
    """
    q = q.to(torch.float32)
    if tau == 0.0:
        return torch.where((q > low_f) & (q < high_f), 0.0, -torch.inf)
    inv = soft_inv(tau)
    return _log_sigmoid((q - low_f) * inv) + _log_sigmoid((high_f - q) * inv)


def soft_match_scores(
    q: torch.Tensor,  # (B, F) float32 (or integer bins; cast here)
    low_f: torch.Tensor,  # (R, F) soft-encoded float32 bounds
    high_f: torch.Tensor,
    tau: float,
) -> torch.Tensor:
    """(B, R) row match scores in [0, 1]: exp of the summed log-scores."""
    logs = soft_cell_logscore(q[:, None, :], low_f[None, :, :], high_f[None, :, :], tau)
    return torch.exp(torch.sum(logs, dim=-1))


# ---------------------------------------------------------------------------
# CellMode registry: the one place a cell mode's contract lives
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CellMode:
    """Descriptor for one aCAM cell comparison mode.

    Attributes:
      name: the ``DeployConfig.mode`` string.
      match: the cell-level torch comparison ``(q, low, high) -> bool``
        the plain version dispatches on — ``None`` for the soft mode.
      table_dtype_policy: the dtype this mode PINS its kernel tables to
        (``'int32'`` for the bit-faithful macro-cell modes, ``'float32'``
        for soft), or ``None`` when the mode accepts the compile-selected
        / packed layouts.
      faithful: bit-faithful aCAM macro-cell arithmetic (Eq. 3 / Table I).
      packable: may run the packed unsigned inclusive-high table layout.
      soft: numeric sigmoid match scores instead of a boolean match line.
    """

    name: str
    match: Callable | None
    table_dtype_policy: str | None
    faithful: bool
    packable: bool
    soft: bool = False


CELL_MODES: dict[str, CellMode] = {
    m.name: m
    for m in (
        CellMode("direct", match_direct, None, faithful=False, packable=True),
        CellMode(
            "inclusive", match_inclusive, None, faithful=False, packable=True
        ),
        CellMode("msb_lsb", match_msb_lsb, "int32", faithful=True, packable=False),
        CellMode(
            "two_cycle", match_two_cycle, "int32", faithful=True, packable=False
        ),
        CellMode(
            "soft", None, "float32", faithful=False, packable=False, soft=True
        ),
    )
}


def mode_names() -> tuple[str, ...]:
    """Registered cell-mode names, registration order (user-facing lists)."""
    return tuple(CELL_MODES)


def get_cell_mode(name: str) -> CellMode:
    """Resolve a mode name; unknown names list what IS registered."""
    try:
        return CELL_MODES[name]
    except KeyError:
        raise ValueError(
            f"unknown cell mode {name!r}; registered modes: {mode_names()}"
        ) from None
