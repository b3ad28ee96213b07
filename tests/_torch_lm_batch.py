"""The LM training tests' seeded batches (numpy only: the card's tests,
which import no JAX, replay the recorded answers on them too)."""

import numpy as np

B, S = 2, 32  # S = 32: RWKV-6's chunked WKV and two SSD chunks of 16


def lm_batch(cfg, seed: int, b: int = B, s: int = S) -> dict:
    """A seeded numpy training batch of ``cfg``'s kind: tokens, vlm
    embeddings or whisper's 40 frames, and labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.is_encoder_decoder:
        return {"frames": rng.standard_normal((b, 40, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                "labels": labels}
    if cfg.embeddings_input:
        embeds = rng.standard_normal((b, s, cfg.d_model)) * cfg.d_model ** -0.5
        return {"embeds": embeds.astype(np.float32), "labels": labels}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": labels}
