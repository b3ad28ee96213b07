"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (shared attn) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    rope_theta=10_000.0,
    act="silu",
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=128,
    shared_attn_period=6,  # one shared attn block every 6 mamba layers
    supports_long_context=True,  # SSM state is O(1) in sequence length
    notes=(
        "Shared attention block reuses one param set every 6 mamba layers "
        "(HF adds per-invocation LoRA deltas + embedding concat — "
        "simplified, see DESIGN.md). long_500k runs via the recurrent path."
    ),
    source="arXiv:2411.15242",
))


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
        shared_attn_period=2, remat=False,
    )
