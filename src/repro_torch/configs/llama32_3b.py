"""llama3.2-3b [dense]: 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3.  [hf:meta-llama/Llama-3.2-1B; unverified]
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    rope_theta=500_000.0,
    act="silu",
    supports_long_context=False,
    notes="long_500k skipped: pure full attention.",
    source="hf:meta-llama/Llama-3.2-1B",
))


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_ff=192,
        vocab_size=512, remat=False,
    )
