"""llava-next-mistral-7b [vlm]: 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000 — anyres tiling frontend (STUB: ``input_specs``
provides precomputed patch/text embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    act="silu",
    embeddings_input=True,  # anyres vision tower + projector stubbed
    supports_long_context=False,
    notes=(
        "Backbone = mistral-7b. Modality frontend is a stub per the "
        "assignment: inputs are precomputed (B, S, d) embeddings mixing "
        "image patches and text. long_500k skipped: full attention."
    ),
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
))


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=96, n_heads=8, n_kv_heads=2, d_ff=192,
        vocab_size=512, remat=False,
    )
