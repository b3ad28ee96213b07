"""Deterministic, resumable synthetic token pipeline for LM training.

A copy of ``repro.data.tokens`` (pure numpy): every batch is byte-equal
to the JAX package's for each (seed, step, host slice).

The stream is a pure function of (seed, step): restart-at-step-k replays
the exact same batches — the property the fault-tolerance tests rely on.
Content is a learnable order-2 Markov chain over the vocabulary with
long-range copy segments, so a small transformer's loss drops well below
the unigram entropy within a few hundred steps (used by the e2e example).

For multi-host production: each host materializes only its slice via
``host_batch`` (slicing is by global batch index, so any host count that
divides the global batch yields identical global content).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TokenPipeline:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        k = min(64, v)  # transition fan-out
        # sparse order-2-ish transition table: next = table[cur, rand<k]
        self._table = rng.integers(0, v, size=(v, k), dtype=np.int64)
        self._start = rng.integers(0, v, size=(4096,), dtype=np.int64)

    def batch(self, step: int) -> dict:
        """Global batch {'tokens' (B,S), 'labels' (B,S)} for one step."""
        return self.host_batch(step, host_id=0, n_hosts=1)

    def host_batch(self, step: int, host_id: int, n_hosts: int) -> dict:
        b = self.global_batch // n_hosts
        rows = []
        for i in range(b):
            g = host_id * b + i  # global row index
            rows.append(self._row(step, g))
        tokens = np.stack(rows)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = tokens[:, 0]
        return {"tokens": tokens.astype(np.int32), "labels": labels.astype(np.int32)}

    def _row(self, step: int, row: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, row])
        )
        s = self.seq_len
        out = np.empty((s,), dtype=np.int64)
        cur = int(self._start[rng.integers(0, len(self._start))])
        # geometric successor choice: skewed transitions => low conditional
        # entropy (~1.7 nats) so a small LM demonstrably beats the unigram
        # floor within a few hundred CPU steps (examples/train_lm.py)
        choices = np.minimum(rng.geometric(0.35, size=s) - 1,
                             self._table.shape[1] - 1)
        noise = rng.random(s)
        for t in range(s):
            out[t] = cur
            if noise[t] < 0.05:  # 5% resets keep the chain mixing
                cur = int(self._start[choices[t] % len(self._start)])
            else:
                cur = int(self._table[cur, choices[t]])
        # long-range copy: second half repeats a slice of the first half
        if s >= 64 and rng.random() < 0.5:
            ln = s // 4
            src = int(rng.integers(0, s // 2 - ln))
            out[-ln:] = out[src : src + ln]
        return out


@dataclass
class EmbeddingPipeline:
    """Synthetic (B, S, d) embedding batches for VLM/audio stub frontends."""

    d_model: int
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    decoder_ratio: int = 8  # enc-dec: decoder tokens per frame

    def batch(self, step: int, kind: str = "vlm") -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        b, s, d = self.global_batch, self.seq_len, self.d_model
        embeds = rng.normal(size=(b, s, d)).astype(np.float32) * (d ** -0.5)
        labels = rng.integers(0, self.vocab_size, size=(b, s)).astype(np.int32)
        if kind == "audio":
            sd = max(64, s // self.decoder_ratio)
            tokens = rng.integers(0, self.vocab_size, size=(b, sd)).astype(np.int32)
            labels = np.roll(tokens, -1, axis=1)
            return {"frames": embeds, "tokens": tokens, "labels": labels}
        return {"embeds": embeds, "labels": labels}
