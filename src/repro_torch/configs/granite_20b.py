"""granite-20b [dense]: 52L d_model=6144 48H (GQA kv=1 = MQA) d_ff=24576
vocab=49152 — llama-arch code model.  [arXiv:2405.04324; hf]
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,  # MQA
    d_ff=24576,
    vocab_size=49152,
    rope_theta=10_000.0,
    act="silu",
    supports_long_context=False,
    notes="long_500k skipped: pure full attention. MQA (kv=1): decode cache "
          "is sequence-sharded on `model` (cannot shard 1 KV head).",
    source="arXiv:2405.04324",
))


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=96, n_heads=8, n_kv_heads=1, d_ff=192,
        vocab_size=512, remat=False,
    )
