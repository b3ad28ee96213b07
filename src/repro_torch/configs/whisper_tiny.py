"""whisper-tiny [audio]: 4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865
— enc-dec, conv frontend (stub).  [arXiv:2212.04356; unverified]
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,  # decoder layers
    n_encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    act="gelu",
    is_encoder_decoder=True,
    embeddings_input=True,  # frame embeddings from the stubbed conv frontend
    supports_long_context=False,
    notes=(
        "Conv/mel frontend stubbed: encoder consumes precomputed (B, T, d) "
        "frame embeddings. Decoder tokens per cell = seq_len/8. long_500k "
        "skipped: full-attention decoder. vocab 51865 is not divisible by "
        "the 16-way model axis — embed stays replicated on `model` (the "
        "partitioner's divisibility fit)."
    ),
    source="arXiv:2212.04356",
))


def smoke() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, remat=False,
    )
