"""Optimizer of the LM half: the port of ``repro.optim``."""

from repro_torch.optim.adamw import AdamW, AdamWConfig, lr_schedule  # noqa: F401
from repro_torch.optim.compress import (  # noqa: F401
    quantize_int8,
    dequantize_int8,
    compress_tree,
    decompress_tree,
)
