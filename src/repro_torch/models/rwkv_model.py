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

The split program (``sp=``: ``loss_fn(params, batch, sp)``, ``prefill`` and
``decode_step`` with a list of ``Split``s, one a data group): each layer's
time and channel mix split by heads (``rwkv6_time_mix``/
``rwkv6_channel_mix(sp=)``), the embedding (then ``ln_in``), head and cross
entropy vocab-parallel (``split_lm``); the cache in ``cache_pspecs``'s
layout: the state by heads on `model` where M divides H, else whole on
every device (``split.StateLeaf``), x_prev whole and equal on every device.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import common, split_lm
from repro_torch.models.rwkv6 import RWKV6Params, rwkv6_channel_mix, rwkv6_time_mix
from repro_torch.models.transformer import _chunked_ce
from repro_torch.sharding.partition import MeshAxes, cache_pspecs
from repro_torch.sharding.placement import zeros_like_cache


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

    def loss_fn(self, params: RWKVParams, batch: dict, sp=None) -> tuple[torch.Tensor, dict]:
        """batch: {'tokens' (B,S), 'labels' (B,S)}.  Returns (loss, {'ce',
        'loss'}).  ``sp`` set: the split program's loss on data group
        ``sp.group``'s devices (``params`` placed, ``batch`` the group's
        rows; the loss on ``sp.root``'s device)."""
        if sp is not None:
            hidden = self._split_hidden(sp, params, self._split_embed(sp, params, batch))
            loss = split_lm.cross_entropy(sp, params, hidden, sp.whole(batch["labels"]))
            return loss, {"ce": loss, "loss": loss}
        hidden, _ = self.hidden_states(params, self._embed(params, batch["tokens"]))
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
    def prefill(self, params: RWKVParams, batch: dict, sp=None, cache=None):
        """batch: {'tokens' (B, S)}.  Returns (last-token logits (B, V)
        float32, cache).  ``sp`` set (a list of ``Split``s, one a data group):
        the split program's prefill of each group's rows (``batch`` a list)
        into ``cache`` (``init_cache(mesh=)``); returns (each group's logits
        on its root's device, the cache)."""
        if sp is not None:
            return [self._split_prefill(g, params, b, cache) for g, b in zip(sp, batch)], cache
        hidden, cache = self.hidden_states(params, self._embed(params, batch["tokens"]),
                                           collect_cache=True)
        logits = hidden[:, -1, :] @ params.lm_head
        return logits.float(), cache

    @torch.no_grad()
    def decode_step(self, params: RWKVParams, cache, token: torch.Tensor, pos: int, sp=None):
        """token: (B,) int; pos is unused (the state carries the position).
        Returns (logits (B, V) float32, cache) — the same cache tensors,
        updated in place.  ``sp`` set: the split program's step, as
        ``prefill``'s (``token`` a list of the groups' rows)."""
        if sp is not None:
            return [self._split_decode(g, params, cache, t) for g, t in zip(sp, token)], cache
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

    # -- the split program ------------------------------------------------------

    def _split_embed(self, sp, tree, batch: dict):
        x = split_lm.embed(sp, tree, sp.whole(batch["tokens"]))
        w = sp.weights({"ln_in": tree["ln_in"], "ln_in_b": tree["ln_in_b"]}, "ln_in")
        return x.map(lambda t, m: common.layer_norm(t, w.ln_in[m], w.ln_in_b[m],
                                                    self.cfg.norm_eps))

    def _split_layer(self, sp, tree, i: int, x, state=None):
        """Layer i on data group ``sp.group``'s devices: (x, (its new state,
        x_prev of the time mix, of the channel mix)); ``state``: each
        device's (S heads, x_prev_att, x_prev_ffn) lists, or None."""
        eps = self.cfg.norm_eps
        w = sp.weights(sp.layer(tree["layers"], i), f"layers[{i}]")
        ln = sp.weights({"ln1": tree["ln1"], "ln2": tree["ln2"]}, "ln")
        a, (s_new, xpa) = rwkv6_time_mix(
            w, x.map(lambda t, m: common.rms_norm(t, ln.ln1[m][i], eps)), self.cfg,
            state=None if state is None else state[:2], sp=sp)
        x = x + a
        f, xpf = rwkv6_channel_mix(w, x.map(lambda t, m: common.rms_norm(t, ln.ln2[m][i], eps)),
                                   x_prev=None if state is None else state[2], sp=sp)
        return x + f, (s_new, xpa, xpf)

    def _split_hidden(self, sp, tree, x, keep=None):
        """``hidden_states`` on data group ``sp.group``'s devices (``x`` and
        the final-normed result in ``sp.layout``); ``keep(i, s, xpa, xpf)``:
        each layer's cache entry (prefill)."""
        cfg = self.cfg
        for i in range(cfg.n_layers):
            def body(x, i=i):
                x, entry = self._split_layer(sp, tree, i, x)
                if keep is not None:
                    keep(i, *entry)
                return x, ()

            x, _ = split_lm.remat_layer(cfg, sp, x, body)
        w = sp.weights({"final_norm": tree["final_norm"]}, "final_norm").final_norm
        return x.map(lambda t, m: common.rms_norm(t, w[m], cfg.norm_eps))

    def _leaves(self, sp, cache, i: int):
        s_all, xa_all, xf_all = cache
        return (sp.state_leaf(s_all, i), sp.state_leaf(xa_all, i, state=False),
                sp.state_leaf(xf_all, i, state=False))

    def _split_prefill(self, sp, tree, batch: dict, cache):
        def keep(i, *entry):
            for leaf, new in zip(self._leaves(sp, cache, i), entry, strict=True):
                leaf.store(new)

        h = self._split_hidden(sp, tree, self._split_embed(sp, tree, batch), keep)
        return split_lm.logits(sp, tree, split_lm.last(sp, h))

    def _split_decode(self, sp, tree, cache, token: torch.Tensor):
        cfg = self.cfg
        x = self._split_embed(sp, tree, {"tokens": token[:, None]})
        for i in range(cfg.n_layers):
            leaves = self._leaves(sp, cache, i)
            x, entry = self._split_layer(sp, tree, i, x, [sp.parts(leaf.read) for leaf in leaves])
            for leaf, new in zip(leaves, entry, strict=True):
                leaf.store(new)
        w = sp.weights({"final_norm": tree["final_norm"]}, "final_norm").final_norm
        return split_lm.logits(sp, tree, x.map(lambda t, m: common.rms_norm(t, w[m], cfg.norm_eps)))
