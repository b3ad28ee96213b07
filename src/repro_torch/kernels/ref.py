"""Plain PyTorch version of the cam_match kernel (the four hard cell modes).

Semantics (the whole X-TIME datapath between DAC and router, §III-A):

    match[b, r] = AND_f cell(q[b, f], low[r, f], high[r, f])
    out[b, c]   = SUM_r match[b, r] * leaf_matrix[r, c]

It is the CPU backend of the port and the version the CUDA kernel
(``kernels/csrc/cam_match.cu``) is held to on the card.  At the full width
of xtime-tabular the (B, R, F) compare would not fit any memory (256 x 1M x
256 is 68 GB), so both functions walk the rows in chunks whose size is a
function of the shapes only and sum the per-chunk leaf products in row
order: the same inputs always give the same bits.  The float32 products
run at full precision; a card with TF32 matmuls switched on is refused.
"""

from __future__ import annotations

import torch

from repro_torch.core.precision import get_cell_mode

# compare elements (B * rows * F) per chunk: bounds the boolean temporaries
# of the cell functions (msb_lsb holds about ten of them) to a few hundred MB
CHUNK_ELEMS = 1 << 26


def _rows_per_chunk(b: int, f: int) -> int:
    return max(1, CHUNK_ELEMS // max(1, b * f))


def _cell(mode: str):
    cell = get_cell_mode(mode)
    if cell.match is None:
        raise NotImplementedError(
            f"mode {mode!r} is not ported yet (ROADMAP.md, 'soft' slice)"
        )
    return cell.match


def _match_chunk(cell, q, low, high) -> torch.Tensor:
    return cell(q[:, None, :], low[None, :, :], high[None, :, :]).all(dim=-1)


def cam_match_bits_ref(
    q: torch.Tensor, low: torch.Tensor, high: torch.Tensor, *, mode: str = "direct"
) -> torch.Tensor:
    """(B, R) boolean match lines only (for MMR / debug paths)."""
    cell = _cell(mode)
    step = _rows_per_chunk(q.shape[0], q.shape[1])
    return torch.cat(
        [
            _match_chunk(cell, q, low[r : r + step], high[r : r + step])
            for r in range(0, low.shape[0], step)
        ],
        dim=1,
    )


def cam_match_ref(
    q: torch.Tensor,  # (B, F) integer bins
    low: torch.Tensor,  # (R, F) inclusive lower bin bounds
    high: torch.Tensor,  # (R, F) upper bounds (exclusive, or inclusive for 'inclusive')
    leaf_matrix: torch.Tensor,  # (R, C) leaf values routed to class channels
    *,
    mode: str = "direct",  # a hard repro_torch.core.precision.CELL_MODES name
) -> torch.Tensor:
    """Returns (B, C) accumulated logits/votes in float32."""
    if q.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "cam_match_ref needs full-precision float32 products; set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )
    cell = _cell(mode)
    out = torch.zeros(
        (q.shape[0], leaf_matrix.shape[1]), dtype=torch.float32, device=q.device
    )
    step = _rows_per_chunk(q.shape[0], q.shape[1])
    for r in range(0, low.shape[0], step):
        match = _match_chunk(cell, q, low[r : r + step], high[r : r + step])
        out += match.to(torch.float32) @ leaf_matrix[r : r + step]
    return out
