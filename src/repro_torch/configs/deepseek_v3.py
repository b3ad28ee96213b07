"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff(expert)=2048
vocab=129280, MoE 256e top-8 — MLA, 1 shared + 256 routed experts, MTP.
[arXiv:2412.19437; hf]
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,  # dense layers' ffn (first 3)
    vocab_size=129280,
    rope_theta=10_000.0,
    act="silu",
    # MoE
    n_experts=256,
    n_shared_experts=1,
    moe_top_k=8,
    moe_d_ff=2048,
    first_dense_layers=3,
    dense_d_ff=18432,
    capacity_factor=1.25,
    # MLA
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    # MTP
    mtp_depth=1,
    supports_long_context=False,
    notes=(
        "long_500k skipped: full (MLA) attention. Decode uses the "
        "weight-absorbed MLA path with the compressed (512+64)/token cache, "
        "sequence-sharded on `model`. MTP = depth-1 extra block (aux loss)."
    ),
    source="arXiv:2412.19437",
))


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, n_experts=8, n_shared_experts=1, moe_top_k=2,
        moe_d_ff=32, first_dense_layers=1, dense_d_ff=128,
        q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16, mtp_depth=1, remat=False,
    )
