"""Gradient compression with error feedback (1-bit-Adam-style int8 variant).

The port of ``repro.optim.compress``: int8 codes and one float32 scale per
leaf of the JAX layout (a ``Stack`` of per-layer gradients shares the
scale of its stacked array, as in the JAX package), the quantization
error carried in a float32 residual and added back next step.
``torch.round`` rounds half to even, as ``jnp.round``, so the codes and
scales are bit-equal to the JAX package's.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.common import leaf_tensors, stack_map, tree_map, tree_zeros
from repro_torch.optim.adamw import as_tree


def _scale_of(leaf) -> torch.Tensor:
    amax = torch.stack([torch.max(torch.abs(t.float())) for t in leaf_tensors(leaf)]).max()
    return torch.clamp(amax, min=1e-12) / 127.0


def int8_codes(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = _scale_of(x)
    return int8_codes(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_tree(grads: Any, residual: Any | None = None):
    """Returns ((q_tree, scale_tree), new_residual)."""
    grads = as_tree(grads)
    if residual is None:
        residual = tree_zeros(grads, torch.float32)
    corrected = tree_map(lambda g, r: stack_map(lambda gg, rr: gg.float() + rr, g, r),
                         grads, residual)
    s = tree_map(_scale_of, corrected)
    q = tree_map(lambda c, ss: stack_map(lambda t: int8_codes(t, ss), c), corrected, s)
    new_residual = tree_map(
        lambda c, qq, ss: stack_map(lambda ct, qt: ct - dequantize_int8(qt, ss), c, qq),
        corrected, q, s)
    return (q, s), new_residual


def decompress_tree(q: Any, s: Any, like: Any):
    return tree_map(lambda qq, ss, g: stack_map(
        lambda qt, gt: dequantize_int8(qt, ss).to(gt.dtype), qq, g), q, s, as_tree(like))
