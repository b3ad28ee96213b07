"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 — RoPE SwiGLU.  [arXiv:2404.14219; unverified]
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,  # full MHA per the assignment line
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10_000.0,
    act="silu",
    supports_long_context=False,
    notes="long_500k skipped: pure full attention (assignment skip rule).",
    source="arXiv:2404.14219",
))


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=96, n_heads=8, n_kv_heads=8, d_ff=192,
        vocab_size=512, remat=False,
    )
