"""RWKV-6 language model — the port of ``repro.models.rwkv_model``: (time
mix + channel mix) blocks as a Python loop over per-layer modules (the
JAX package ``lax.scan``s over stacked parameters), with an O(1)
recurrent cache for decode.

The cache is the reference's 3-tuple (S (L, B, H, hd, hd) float32,
x_prev_att (L, B, d), x_prev_ffn (L, B, d)); decode writes it in place.
The input layer norm uses the float32 ``ln_in``/``ln_in_b``.  Under
``cfg.remat`` each layer's activations are recomputed in the backward
pass while autograd records (``common.remat``, the reference's
``jax.checkpoint`` of its scan body).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import common
from repro_torch.models.rwkv6 import RWKV6Params, rwkv6_channel_mix, rwkv6_time_mix
from repro_torch.models.transformer import _chunked_ce


class RWKVParams(nn.Module):
    """Every parameter of an ``RWKVLM``; ``ln1``/``ln2`` are the (L, d)
    stacks of the layers' pre-norm scales."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        dtype = common.dtype_of(cfg.dtype)
        init = dict(device=device, generator=generator)
        d = cfg.d_model
        self.embed = nn.Parameter(common.embed_init((cfg.vocab_size, d), dtype, **init))
        self.ln_in = common.const_param((d,), 1.0, torch.float32, device)
        self.ln_in_b = common.const_param((d,), 0.0, torch.float32, device)
        self.final_norm = common.const_param((d,), 0.0, dtype, device)
        self.lm_head = nn.Parameter(common.dense_init((d, cfg.vocab_size), dtype, **init))
        self.layers = nn.ModuleList(RWKV6Params(cfg, dtype, **init)
                                    for _ in range(cfg.n_layers))
        self.ln1 = common.const_param((cfg.n_layers, d), 0.0, dtype, device)
        self.ln2 = common.const_param((cfg.n_layers, d), 0.0, dtype, device)

    def jax_layout(self) -> dict:
        """These parameters as the JAX package's ``init_params`` pytree."""
        return {"embed": self.embed, "ln_in": self.ln_in, "ln_in_b": self.ln_in_b,
                "final_norm": self.final_norm, "lm_head": self.lm_head,
                "layers": common.stacked_layout(list(self.layers)),
                "ln1": self.ln1, "ln2": self.ln2}


class RWKVLM:
    def __init__(self, cfg: ModelConfig, *, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.shard_x = lambda t: t  # activation sharding hook (launcher-set)

    # -- params ------------------------------------------------------------

    def init_params(self, seed: int = 0) -> RWKVParams:
        """Seeded random parameters on the model's device (the JAX
        package's init rules, not its bits)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        return RWKVParams(self.cfg, device=self.device, generator=g)

    def empty_params(self, device=None) -> RWKVParams:
        return RWKVParams(self.cfg, device=self.device if device is None else device)

    # -- forward -------------------------------------------------------------

    def _embed(self, params: RWKVParams, tokens: torch.Tensor) -> torch.Tensor:
        x = params.embed[tokens]
        return common.layer_norm(x, params.ln_in, params.ln_in_b, self.cfg.norm_eps)

    def hidden_states(self, params: RWKVParams, x, collect_cache: bool = False):
        """x: (B, S, d) embeddings.  Returns (hidden, cache tuple or None)."""
        cfg = self.cfg
        states, xp_atts, xp_ffns = [], [], []
        x = self.shard_x(x)
        for prm, ln1, ln2 in zip(params.layers, params.ln1, params.ln2):
            def body(h, prm=prm, ln1=ln1, ln2=ln2):
                a, (s_new, xp_att) = rwkv6_time_mix(prm, common.rms_norm(h, ln1, cfg.norm_eps),
                                                    cfg)
                h = h + a
                f, xp_ffn = rwkv6_channel_mix(prm, common.rms_norm(h, ln2, cfg.norm_eps))
                return h + f, s_new, xp_att, xp_ffn

            x, s_new, xp_att, xp_ffn = common.remat(cfg, body, x)
            x = self.shard_x(x)
            if collect_cache:
                states.append(s_new)
                xp_atts.append(xp_att)
                xp_ffns.append(xp_ffn)
        x = common.rms_norm(x, params.final_norm, cfg.norm_eps)
        if not collect_cache:
            return x, None
        return x, (torch.stack(states), torch.stack(xp_atts), torch.stack(xp_ffns))

    def loss_fn(self, params: RWKVParams, batch: dict) -> tuple[torch.Tensor, dict]:
        """batch: {'tokens' (B,S), 'labels' (B,S)}.  Returns (loss, {'ce',
        'loss'})."""
        hidden, _ = self.hidden_states(params, self._embed(params, batch["tokens"]))
        loss = _chunked_ce(hidden, params.lm_head, batch["labels"])
        return loss, {"ce": loss, "loss": loss}

    # -- serving ---------------------------------------------------------------

    def init_cache(self, batch: int, seq: int, device=None):
        cfg = self.cfg
        device = self.device if device is None else device
        h = cfg.d_model // cfg.rwkv_head_dim
        dtype = common.dtype_of(cfg.dtype)
        return (
            torch.zeros((cfg.n_layers, batch, h, cfg.rwkv_head_dim, cfg.rwkv_head_dim),
                        dtype=torch.float32, device=device),
            torch.zeros((cfg.n_layers, batch, cfg.d_model), dtype=dtype, device=device),
            torch.zeros((cfg.n_layers, batch, cfg.d_model), dtype=dtype, device=device),
        )

    @torch.no_grad()
    def prefill(self, params: RWKVParams, batch: dict):
        """batch: {'tokens' (B, S)}.  Returns (last-token logits (B, V)
        float32, cache)."""
        hidden, cache = self.hidden_states(params, self._embed(params, batch["tokens"]),
                                           collect_cache=True)
        logits = hidden[:, -1, :] @ params.lm_head
        return logits.float(), cache

    @torch.no_grad()
    def decode_step(self, params: RWKVParams, cache, token: torch.Tensor, pos: int):
        """token: (B,) int; pos is unused (the state carries the position).
        Returns (logits (B, V) float32, cache) — the same cache tensors,
        updated in place."""
        cfg = self.cfg
        s_all, xa_all, xf_all = cache
        x = self._embed(params, token[:, None])
        for i, (prm, ln1, ln2) in enumerate(zip(params.layers, params.ln1, params.ln2)):
            a, (s_new, xp_att) = rwkv6_time_mix(
                prm, common.rms_norm(x, ln1, cfg.norm_eps), cfg, state=(s_all[i], xa_all[i]))
            x = x + a
            f, xp_ffn = rwkv6_channel_mix(prm, common.rms_norm(x, ln2, cfg.norm_eps),
                                          x_prev=xf_all[i])
            x = x + f
            s_all[i] = s_new
            xa_all[i] = xp_att
            xf_all[i] = xp_ffn
        x = common.rms_norm(x, params.final_norm, cfg.norm_eps)
        logits = x[:, 0, :] @ params.lm_head
        return logits.float(), cache
