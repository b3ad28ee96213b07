"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 — Finch, data-dependent decay.  [arXiv:2404.05892; unverified]
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # wkv heads = d_model / rwkv_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    act="relu",  # squared relu in channel mixing
    rwkv_head_dim=64,
    supports_long_context=True,  # O(1) recurrent state
    notes=(
        "Token-shift lerp uses static per-channel mu (RWKV-5 style); the "
        "signature data-dependent decay w_t keeps its full LoRA form "
        "(DESIGN.md). long_500k runs via the recurrent path."
    ),
    source="arXiv:2404.05892",
))


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, d_ff=224, vocab_size=512, rwkv_head_dim=16,
        n_heads=4, n_kv_heads=4, remat=False,
    )
