"""Whisper-style encoder-decoder backbone (arXiv:2212.04356) — the port of
``repro.models.encdec``'s serving half.

As in the reference the conv/mel frontend is a stub: the encoder takes
precomputed frame embeddings (B, T, d).  Pre-LN blocks, fixed sinusoidal
absolute positions (encoder and decoder), ungated GELU MLPs,
bidirectional encoder self-attention, causal decoder self-attention and
cross-attention whose k/v each decoder layer projects from the encoder
states.  The head is tied (``embed.T``).  Each stack is a Python loop
over per-layer modules where the JAX package ``lax.scan``s.

The cache is the reference's dict: ``k``/``v`` (L, B, S, KV, D) of the
decoder's self-attention, written in place by decode, and ``xk``/``xv``
(L, B, T, KV, D) of the cross-attention, read whole.  Under ``cfg.remat``
each encoder and decoder layer's activations are recomputed in the
backward pass while autograd records (``common.remat``, the reference's
``jax.checkpoint`` of its scan bodies).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import common
from repro_torch.models.attention import (
    AttnParams,
    _split_heads,
    attention_decode,
    attention_forward,
    decode_attention,
)
from repro_torch.models.ffn import MLPParams, mlp_forward
from repro_torch.models.transformer import _chunked_ce


def sinusoid_positions(length: int, dim: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / dim)
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


def sinusoid_at(pos: int, dim: int, device=None) -> torch.Tensor:
    """(dim,) float32 sinusoid embedding at ``pos``, computed in float32 on
    ``device`` as the reference computes it (its values, up to the last
    bits of the float32 pow/sin/cos)."""
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    ang = torch.tensor(float(pos), dtype=torch.float32, device=device) / torch.pow(
        torch.tensor(10000.0, dtype=torch.float32, device=device), 2 * i / dim)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDecBlock(nn.Module):
    """ln1, attn, ln2, mlp; a decoder block adds ln_x and xattn."""

    def __init__(self, cfg: ModelConfig, cross: bool, *, device, generator=None):
        super().__init__()
        dtype = common.dtype_of(cfg.dtype)
        init = dict(device=device, generator=generator)
        attn = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, dtype)
        self.ln1 = common.const_param((cfg.d_model,), 0.0, dtype, device)
        self.attn = AttnParams(*attn, **init)
        self.ln2 = common.const_param((cfg.d_model,), 0.0, dtype, device)
        self.mlp = MLPParams(cfg.d_model, cfg.d_ff, dtype, **init)
        fields = ["ln1", "attn", "ln2", "mlp"]
        if cross:
            self.ln_x = common.const_param((cfg.d_model,), 0.0, dtype, device)
            self.xattn = AttnParams(*attn, **init)
            fields += ["ln_x", "xattn"]
        self.FIELDS = tuple(fields)


class EncDecParams(nn.Module):
    """Every parameter of an ``EncDecLM`` (no lm_head: it is ``embed.T``)."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        dtype = common.dtype_of(cfg.dtype)
        init = dict(device=device, generator=generator)
        self.embed = nn.Parameter(common.embed_init((cfg.vocab_size, cfg.d_model), dtype,
                                                    **init))
        self.enc = nn.ModuleList(EncDecBlock(cfg, False, **init)
                                 for _ in range(cfg.n_encoder_layers))
        self.dec = nn.ModuleList(EncDecBlock(cfg, True, **init) for _ in range(cfg.n_layers))
        self.enc_norm = common.const_param((cfg.d_model,), 0.0, dtype, device)
        self.final_norm = common.const_param((cfg.d_model,), 0.0, dtype, device)

    def jax_layout(self) -> dict:
        """These parameters as the JAX package's ``init_params`` pytree."""
        return {"embed": self.embed, "enc": common.stacked_layout(list(self.enc)),
                "dec": common.stacked_layout(list(self.dec)),
                "enc_norm": self.enc_norm, "final_norm": self.final_norm}


class EncDecLM:
    def __init__(self, cfg: ModelConfig, flash_blk: int = 512, *, device: torch.device):
        self.cfg = cfg
        self.flash_blk = flash_blk
        self.device = torch.device(device)
        self.shard_x = lambda t: t  # activation sharding hook (launcher-set)

    # -- params ------------------------------------------------------------

    def init_params(self, seed: int = 0) -> EncDecParams:
        """Seeded random parameters on the model's device (the JAX
        package's init rules, not its bits)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        return EncDecParams(self.cfg, device=self.device, generator=g)

    def empty_params(self, device=None) -> EncDecParams:
        return EncDecParams(self.cfg, device=self.device if device is None else device)

    def _attn_kw(self, positions, causal: bool) -> dict:
        cfg = self.cfg
        return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                    rope_theta=None, positions=positions, causal=causal, window=0,
                    norm_eps=cfg.norm_eps, flash_blk=self.flash_blk)

    # -- encoder --------------------------------------------------------------

    def encode(self, params: EncDecParams, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, T, d) stub frame embeddings -> encoder states."""
        cfg = self.cfg
        t = frames.shape[1]
        table = torch.from_numpy(sinusoid_positions(t, cfg.d_model)).to(frames.device)
        x = frames + table.to(frames.dtype)[None]
        positions = torch.arange(t, device=frames.device)
        x = self.shard_x(x)
        for prm in params.enc:
            def body(h, prm=prm):
                a, _ = attention_forward(prm.attn, common.rms_norm(h, prm.ln1, cfg.norm_eps),
                                         **self._attn_kw(positions, causal=False))
                h = h + a
                return h + mlp_forward(prm.mlp, common.rms_norm(h, prm.ln2, cfg.norm_eps))

            x = self.shard_x(common.remat(cfg, body, x))
        return common.rms_norm(x, params.enc_norm, cfg.norm_eps)

    # -- decoder --------------------------------------------------------------

    def _decoder_states(self, params: EncDecParams, tokens, enc, collect_cache: bool = False):
        cfg = self.cfg
        s = tokens.shape[1]
        x = params.embed[tokens]
        table = torch.from_numpy(sinusoid_positions(s, cfg.d_model)).to(x.device)
        x = x + table.to(x.dtype)[None]
        positions = torch.arange(s, device=x.device)
        cache = {"k": [], "v": [], "xk": [], "xv": []}
        x = self.shard_x(x)
        for prm in params.dec:
            def body(h, prm=prm):
                a, kv = attention_forward(prm.attn, common.rms_norm(h, prm.ln1, cfg.norm_eps),
                                          **self._attn_kw(positions, causal=True))
                h = h + a
                # cross attention over encoder states (kv projected per layer)
                xk = _split_heads(enc @ prm.xattn.wk, cfg.n_kv_heads)
                xv = _split_heads(enc @ prm.xattn.wv, cfg.n_kv_heads)
                c, _ = attention_forward(prm.xattn, common.rms_norm(h, prm.ln_x, cfg.norm_eps),
                                         **self._attn_kw(positions, causal=False),
                                         kv_override=(xk, xv))
                h = h + c
                h = h + mlp_forward(prm.mlp, common.rms_norm(h, prm.ln2, cfg.norm_eps))
                return h, kv[0], kv[1], xk, xv

            x, *kvx = common.remat(cfg, body, x)
            x = self.shard_x(x)
            if collect_cache:
                for key, val in zip(("k", "v", "xk", "xv"), kvx):
                    cache[key].append(val)
        x = common.rms_norm(x, params.final_norm, cfg.norm_eps)
        if not collect_cache:
            return x, None
        return x, {k: torch.stack(v) for k, v in cache.items()}

    # -- training ---------------------------------------------------------------

    def loss_fn(self, params: EncDecParams, batch: dict) -> tuple[torch.Tensor, dict]:
        """batch: {'frames' (B,T,d), 'tokens' (B,S), 'labels' (B,S)}.  The
        head is tied: ``embed.T``.  Returns (loss, {'ce', 'loss'})."""
        enc = self.encode(params, batch["frames"])
        hidden, _ = self._decoder_states(params, batch["tokens"], enc)
        loss = _chunked_ce(hidden, params.embed.T, batch["labels"])
        return loss, {"ce": loss, "loss": loss}

    # -- serving ---------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, params: EncDecParams, batch: dict):
        """batch: {'frames' (B, T, d), 'tokens' (B, S)}.  Returns (last-token
        logits (B, V) float32, cache)."""
        enc = self.encode(params, batch["frames"])
        hidden, cache = self._decoder_states(params, batch["tokens"], enc, collect_cache=True)
        logits = hidden[:, -1, :] @ params.embed.T
        return logits.float(), cache

    def init_cache(self, batch: int, seq: int, enc_len: int | None = None, device=None):
        cfg = self.cfg
        dtype = common.dtype_of(cfg.dtype)
        device = self.device if device is None else device
        el = enc_len if enc_len is not None else seq
        kvh = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        xvh = (cfg.n_layers, batch, el, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(kvh, dtype=dtype, device=device),
                "v": torch.zeros(kvh, dtype=dtype, device=device),
                "xk": torch.zeros(xvh, dtype=dtype, device=device),
                "xv": torch.zeros(xvh, dtype=dtype, device=device)}

    @torch.no_grad()
    def decode_step(self, params: EncDecParams, cache: dict, token: torch.Tensor, pos: int):
        """token: (B,) int; pos: the position written.  Returns (logits
        (B, V) float32, cache) — the same cache tensors, k/v updated in
        place."""
        cfg = self.cfg
        pos = int(pos)
        x = params.embed[token[:, None]]
        x = x + sinusoid_at(pos, cfg.d_model, x.device).to(x.dtype)[None, None, :]
        for i, prm in enumerate(params.dec):
            a, _ = attention_decode(
                prm.attn, common.rms_norm(x, prm.ln1, cfg.norm_eps),
                cache["k"][i], cache["v"][i], pos,
                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=None, norm_eps=cfg.norm_eps,
            )
            x = x + a
            q = _split_heads(common.rms_norm(x, prm.ln_x, cfg.norm_eps) @ prm.xattn.wq,
                             cfg.n_heads)
            xk, xv = cache["xk"][i], cache["xv"][i]
            c = decode_attention(q, xk, xv, xk.shape[1] - 1)
            x = x + c.reshape(x.shape[0], 1, -1) @ prm.xattn.wo
            x = x + mlp_forward(prm.mlp, common.rms_norm(x, prm.ln2, cfg.norm_eps))
        x = common.rms_norm(x, params.final_norm, cfg.norm_eps)
        logits = x[:, 0, :] @ params.embed.T
        return logits.float(), cache
