"""LM substrate: the port of ``repro.models`` (every LM family: the
transformers, the zamba2 hybrid, rwkv6 and whisper).

Parameters are ``nn.Module``s, layers are plain functions on tensors, a
layer stack is a Python loop over its layers, and every model is built on
an explicit device (the card unless ``device="cpu"``).
"""

from repro_torch.models.registry import build_model  # noqa: F401
