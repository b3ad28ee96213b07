"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144 — 5:1 local:global interleaving, 128k context.
[hf:google/gemma-3-1b-pt; unverified]
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,  # gemma3 decouples head_dim from d_model/n_heads
    d_ff=6912,
    vocab_size=262144,
    rope_theta=10_000.0,  # local layers
    rope_theta_global=1_000_000.0,  # global layers
    sliding_window=512,
    local_global_period=6,  # 5 local : 1 global
    qk_norm=True,
    act="gelu",
    tie_embeddings=True,
    supports_long_context=True,  # 25/26 layers are 512-window; 1/6 global
    notes=(
        "long_500k runs: local layers cap their KV at the 512-token window; "
        "global layers hold the full cache, sequence-sharded on `model`."
    ),
    source="hf:google/gemma-3-1b-pt",
))


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=512, sliding_window=16, local_global_period=2,
        remat=False,
    )
