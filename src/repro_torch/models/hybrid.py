"""Zamba2-style hybrid: a Mamba-2 backbone with a *shared* attention block
applied every ``cfg.shared_attn_period`` layers (arXiv:2411.15242) — the
port of ``repro.models.hybrid``'s serving half.

The reference's simplifications are kept (DESIGN.md): the shared block
reuses one full parameter set (the original adds per-invocation LoRA
deltas and concatenates the initial embeddings into its input), with
rotary positions.

Execution: a Python loop over the G = n_layers / period groups, each a
loop over its P mamba layers and then one application of the shared
block, where the JAX package nests two ``lax.scan``s over (G, P, ...)
stacked parameters.  ``mamba[g][i]`` is layer i of group g; the JAX
layout (``HybridParams.jax_layout``) stacks them two deep.  Under
``cfg.remat`` each mamba layer's activations are recomputed in the
backward pass while autograd records (``common.remat``), as the reference
``jax.checkpoint``s its mamba scan body; ``loss_fn`` runs through
``hidden_states``, never the in-place serving paths.

The cache is the reference's dict: ``ssm`` (G, P, B, H, Pd, N) float32,
``conv`` (G, P, B, W-1, C), ``k``/``v`` (G, B, S, KV, D).  Decode writes
every entry in place.

The split program (``sp=``: ``loss_fn(params, batch, sp)``, ``prefill`` and
``decode_step`` with a list of ``Split``s, one a data group, the placed
parameters and the mesh's cache): each mamba layer split by heads
(``mamba2_forward``/``mamba2_decode(sp=)``), the shared block by
``attention_forward``/``ffn_forward(sp=)``, its leaves gathered at every
application (their gradients all go into the same sums), the embedding,
head and cross entropy vocab-parallel (``split_lm``); the cache in
``cache_pspecs``'s layout: the SSM state by heads on `model`
(``split.StateLeaf``), the conv tail whole and equal on every device, k/v
as the transformer's (``split.CacheLeaf``).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import common, split_lm
from repro_torch.models.attention import AttnParams, attention_decode, attention_forward
from repro_torch.models.ffn import FFNParams, ffn_forward
from repro_torch.models.mamba2 import Mamba2Params, mamba2_decode, mamba2_forward
from repro_torch.models.mamba2 import dims as mamba_dims
from repro_torch.models.transformer import _chunked_ce
from repro_torch.sharding.partition import MeshAxes, cache_pspecs
from repro_torch.sharding.placement import zeros_like_cache


class SharedBlock(nn.Module):
    """The shared transformer block: ln1, attn, ln2, ffn."""

    FIELDS = ("ln1", "attn", "ln2", "ffn")

    def __init__(self, cfg: ModelConfig, dtype, *, device, generator=None):
        super().__init__()
        init = dict(device=device, generator=generator)
        self.ln1 = common.const_param((cfg.d_model,), 0.0, dtype, device)
        self.attn = AttnParams(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim, dtype, **init)
        self.ln2 = common.const_param((cfg.d_model,), 0.0, dtype, device)
        self.ffn = FFNParams(cfg.d_model, cfg.d_ff, dtype, **init)


class HybridParams(nn.Module):
    """Every parameter of a ``HybridLM``; ``mamba_ln`` is the (G, P, d)
    stack of the mamba layers' pre-norm scales."""

    def __init__(self, cfg: ModelConfig, n_groups: int, period: int, *, device,
                 generator=None):
        super().__init__()
        dtype = common.dtype_of(cfg.dtype)
        init = dict(device=device, generator=generator)
        self.embed = nn.Parameter(common.embed_init((cfg.vocab_size, cfg.d_model), dtype,
                                                    **init))
        self.final_norm = common.const_param((cfg.d_model,), 0.0, dtype, device)
        self.lm_head = nn.Parameter(common.dense_init((cfg.d_model, cfg.vocab_size), dtype,
                                                      **init))
        self.mamba = nn.ModuleList(
            nn.ModuleList(Mamba2Params(cfg, dtype, **init) for _ in range(period))
            for _ in range(n_groups))
        self.mamba_ln = common.const_param((n_groups, period, cfg.d_model), 0.0, dtype,
                                           device)
        self.shared = SharedBlock(cfg, dtype, **init)

    def jax_layout(self) -> dict:
        """These parameters as the JAX package's ``init_params`` pytree (the
        mamba leaves as lists of G lists of P tensors)."""
        return {"embed": self.embed, "final_norm": self.final_norm,
                "lm_head": self.lm_head,
                "mamba": common.stacked_layout([list(g) for g in self.mamba]),
                "mamba_ln": self.mamba_ln,
                "shared": common.stacked_layout(self.shared)}


class HybridLM:
    def __init__(self, cfg: ModelConfig, flash_blk: int = 512, *, device: torch.device):
        if cfg.shared_attn_period <= 0 or cfg.n_layers % cfg.shared_attn_period:
            raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a multiple of "
                             f"shared_attn_period {cfg.shared_attn_period}")
        self.cfg = cfg
        self.flash_blk = flash_blk
        self.device = torch.device(device)
        self.n_groups = cfg.n_layers // cfg.shared_attn_period
        self.period = cfg.shared_attn_period
        self.shard_x = lambda t: t  # activation sharding hook (launcher-set)

    # -- params ------------------------------------------------------------

    def init_params(self, seed: int = 0) -> HybridParams:
        """Seeded random parameters on the model's device (the JAX
        package's init rules, not its bits)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        return HybridParams(self.cfg, self.n_groups, self.period, device=self.device,
                            generator=g)

    def empty_params(self, device=None) -> HybridParams:
        return HybridParams(self.cfg, self.n_groups, self.period,
                            device=self.device if device is None else device)

    # -- full sequence -------------------------------------------------------

    def _shared_block(self, shared: SharedBlock, x, positions):
        cfg = self.cfg
        h, kv = attention_forward(
            shared.attn, common.rms_norm(x, shared.ln1, cfg.norm_eps),
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta, positions=positions, causal=True, window=0,
            norm_eps=cfg.norm_eps, flash_blk=self.flash_blk,
        )
        x = x + h
        x = x + ffn_forward(shared.ffn, common.rms_norm(x, shared.ln2, cfg.norm_eps))
        return x, kv

    def hidden_states(self, params: HybridParams, x, positions, collect_cache: bool = False):
        """x: (B, S, d) embeddings.  Returns (hidden, cache dict or None)."""
        cfg = self.cfg
        ssm, conv, ks, vs = [], [], [], []
        x = self.shard_x(x)
        for g, group in enumerate(params.mamba):
            states, tails = [], []
            for i, prm in enumerate(group):
                def body(h, prm=prm, ln=params.mamba_ln[g, i]):
                    out, state, tail = mamba2_forward(prm, common.rms_norm(h, ln, cfg.norm_eps),
                                                      cfg)
                    return h + out, state, tail

                x, state, tail = common.remat(cfg, body, x)
                states.append(state)
                tails.append(tail)
            x, kv = self._shared_block(params.shared, x, positions)
            x = self.shard_x(x)
            if collect_cache:
                ssm.append(torch.stack(states))
                conv.append(torch.stack(tails))
                ks.append(kv[0])
                vs.append(kv[1])
        x = common.rms_norm(x, params.final_norm, cfg.norm_eps)
        if not collect_cache:
            return x, None
        return x, {"ssm": torch.stack(ssm), "conv": torch.stack(conv),
                   "k": torch.stack(ks), "v": torch.stack(vs)}

    def loss_fn(self, params: HybridParams, batch: dict, sp=None) -> tuple[torch.Tensor, dict]:
        """batch: {'tokens' (B,S), 'labels' (B,S)}.  Returns (loss, {'ce',
        'loss'}).  ``sp`` set: the split program's loss on data group
        ``sp.group``'s devices (``params`` placed, ``batch`` the group's
        rows; the loss on ``sp.root``'s device)."""
        if sp is not None:
            x = split_lm.embed(sp, params, sp.whole(batch["tokens"]))
            hidden = self._split_hidden(sp, params, x, split_lm.positions(sp))
            loss = split_lm.cross_entropy(sp, params, hidden, sp.whole(batch["labels"]))
            return loss, {"ce": loss, "loss": loss}
        x = params.embed[batch["tokens"]]
        positions = torch.arange(x.shape[1], device=x.device)
        hidden, _ = self.hidden_states(params, x, positions)
        loss = _chunked_ce(hidden, params.lm_head, batch["labels"])
        return loss, {"ce": loss, "loss": loss}

    # -- serving ---------------------------------------------------------------

    def init_cache(self, batch: int, seq: int, device=None, mesh=None):
        """Zeros of the cache; ``mesh`` set: ``Sharded`` leaves in
        ``cache_pspecs``'s layout, each shard allocated where it lives."""
        cfg = self.cfg
        if mesh is not None:
            shape = self.init_cache(batch, seq, device="meta")
            return zeros_like_cache(mesh, shape, cache_pspecs(shape, cfg, MeshAxes(mesh)))
        dtype = common.dtype_of(cfg.dtype)
        device = self.device if device is None else device
        di, h, conv_dim = mamba_dims(cfg)
        g, p = self.n_groups, self.period
        kvh = (g, batch, seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {
            "ssm": torch.zeros((g, p, batch, h, cfg.ssm_head_dim, cfg.ssm_state),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((g, p, batch, cfg.ssm_conv_width - 1, conv_dim), dtype=dtype,
                                device=device),
            "k": torch.zeros(kvh, dtype=dtype, device=device),
            "v": torch.zeros(kvh, dtype=dtype, device=device),
        }

    @torch.no_grad()
    def prefill(self, params: HybridParams, batch: dict, sp=None, cache=None):
        """batch: {'tokens' (B, S)}.  Returns (last-token logits (B, V)
        float32, cache).  ``sp`` set (a list of ``Split``s, one a data group):
        the split program's prefill of each group's rows (``batch`` a list)
        into ``cache`` (``init_cache(mesh=)``); returns (each group's logits
        on its root's device, the cache)."""
        if sp is not None:
            return [self._split_prefill(g, params, b, cache) for g, b in zip(sp, batch)], cache
        x = params.embed[batch["tokens"]]
        positions = torch.arange(x.shape[1], device=x.device)
        hidden, cache = self.hidden_states(params, x, positions, collect_cache=True)
        logits = hidden[:, -1, :] @ params.lm_head
        return logits.float(), cache

    @torch.no_grad()
    def decode_step(self, params: HybridParams, cache: dict, token: torch.Tensor, pos: int,
                    sp=None):
        """token: (B,) int; pos: the position written.  Returns (logits
        (B, V) float32, cache) — the same cache tensors, updated in place.
        ``sp`` set: the split program's step, as ``prefill``'s (``token`` a
        list of the groups' rows)."""
        if sp is not None:
            return [self._split_decode(g, params, cache, t, int(pos))
                    for g, t in zip(sp, token)], cache
        cfg = self.cfg
        shared = params.shared
        pos = int(pos)
        x = params.embed[token[:, None]]
        for g, group in enumerate(params.mamba):
            for i, prm in enumerate(group):
                out, s2, c2 = mamba2_decode(
                    prm, common.rms_norm(x, params.mamba_ln[g, i], cfg.norm_eps),
                    cache["ssm"][g, i], cache["conv"][g, i], cfg)
                cache["ssm"][g, i] = s2
                cache["conv"][g, i] = c2
                x = x + out
            a, _ = attention_decode(
                shared.attn, common.rms_norm(x, shared.ln1, cfg.norm_eps),
                cache["k"][g], cache["v"][g], pos,
                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                norm_eps=cfg.norm_eps,
            )
            x = x + a
            x = x + ffn_forward(shared.ffn, common.rms_norm(x, shared.ln2, cfg.norm_eps))
        x = common.rms_norm(x, params.final_norm, cfg.norm_eps)
        logits = x[:, 0, :] @ params.lm_head
        return logits.float(), cache

    # -- the split program ------------------------------------------------------

    def _rms(self, x, w):
        return x.map(lambda t, m: common.rms_norm(t, w[m], self.cfg.norm_eps))

    def _split_hidden(self, sp, tree, x, positions, keep=None):
        """``hidden_states`` on data group ``sp.group``'s devices (``x`` and
        the final-normed result in ``sp.layout``).  ``keep(key, *entry)``:
        each layer's cache entry (prefill): ("mamba", g, i) with its state
        and conv tail, ("attn", g) with (k, v)."""
        cfg = self.cfg
        for g in range(self.n_groups):
            for i in range(self.period):
                def body(x, g=g, i=i):
                    w = sp.weights(sp.layer(tree["mamba"], (g, i)), f"mamba[{g}][{i}]")
                    ln = sp.weights({"ln": tree["mamba_ln"]}, "mamba_ln").ln
                    h = x.map(lambda t, m: common.rms_norm(t, ln[m][g, i], cfg.norm_eps))
                    out, state, tail = mamba2_forward(w, h, cfg, sp=sp)
                    if keep is not None:
                        keep(("mamba", g, i), state, tail)
                    return x + out, ()

                x, _ = split_lm.remat_layer(cfg, sp, x, body)
            w = sp.weights(tree["shared"], "shared")
            h, kv = attention_forward(
                w.attn, self._rms(x, w.ln1),
                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                rope_theta=cfg.rope_theta, positions=positions, causal=True, window=0,
                norm_eps=cfg.norm_eps, flash_blk=self.flash_blk, sp=sp)
            x = x + h
            x = x + ffn_forward(w.ffn, self._rms(x, w.ln2), sp=sp)
            del w  # one unit's gathered leaves alive at a time
            if keep is not None:
                keep(("attn", g), kv)
        w = sp.weights({"final_norm": tree["final_norm"]}, "final_norm").final_norm
        return self._rms(x, w)

    def _split_prefill(self, sp, tree, batch: dict, cache: dict):
        def keep(key, *entry):
            if key[0] == "mamba":
                state, tail = entry
                sp.state_leaf(cache["ssm"], key[1:]).store(state)
                sp.state_leaf(cache["conv"], key[1:], state=False).store(tail)
                return
            for sh, val in zip((cache["k"], cache["v"]), entry[0]):
                leaf, val = sp.cache_leaf(sh, key[1]), sp.to(val, sp.FULL)
                for m in sp.active:
                    leaf.fill(m, val.parts[m])

        x = split_lm.embed(sp, tree, sp.whole(batch["tokens"]))
        h = self._split_hidden(sp, tree, x, split_lm.positions(sp), keep)
        return split_lm.logits(sp, tree, split_lm.last(sp, h))

    def _split_decode(self, sp, tree, cache: dict, token: torch.Tensor, pos: int):
        cfg = self.cfg
        x = split_lm.embed(sp, tree, [None if t is None else t[:, None] for t in sp.whole(token)])
        for g in range(self.n_groups):
            for i in range(self.period):
                w = sp.weights(sp.layer(tree["mamba"], (g, i)), f"mamba[{g}][{i}]")
                ln = sp.weights({"ln": tree["mamba_ln"]}, "mamba_ln").ln
                ssm = sp.state_leaf(cache["ssm"], (g, i))
                conv = sp.state_leaf(cache["conv"], (g, i), state=False)
                out, state, tail = mamba2_decode(
                    w, x.map(lambda t, m: common.rms_norm(t, ln[m][g, i], cfg.norm_eps)),
                    sp.parts(ssm.read), sp.parts(conv.read), cfg, sp=sp)
                ssm.store(state)
                conv.store(tail)
                x = x + out
            w = sp.weights(tree["shared"], "shared")
            a, _ = attention_decode(
                w.attn, self._rms(x, w.ln1), sp.cache_leaf(cache["k"], g),
                sp.cache_leaf(cache["v"], g), pos,
                n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps, sp=sp)
            x = x + a
            x = x + ffn_forward(w.ffn, self._rms(x, w.ln2), sp=sp)
        w = sp.weights({"final_norm": tree["final_norm"]}, "final_norm").final_norm
        return split_lm.logits(sp, tree, self._rms(x, w))
