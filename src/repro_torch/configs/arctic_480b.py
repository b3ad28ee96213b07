"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000, MoE 128e top-2 — 128 experts top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,  # dense residual branch
    vocab_size=32000,
    rope_theta=10_000.0,
    act="silu",
    n_experts=128,
    moe_top_k=2,
    moe_d_ff=4864,
    moe_dense_residual=True,  # dense FFN in parallel with the MoE branch
    capacity_factor=1.25,
    supports_long_context=False,
    notes="long_500k skipped: pure full attention.",
    source="hf:Snowflake/snowflake-arctic-base",
))


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, d_ff=96,
        vocab_size=512, n_experts=8, moe_top_k=2, moe_d_ff=96, remat=False,
    )
