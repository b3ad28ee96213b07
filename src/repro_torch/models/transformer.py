"""Decoder-only transformer LM covering the dense / MoE / MLA / VLM
architectures (gemma3, phi3, granite, llama3.2, deepseek-v3, arctic,
llava-next) — the port of ``repro.models.transformer``'s serving half.

The layer stack is split into the JAX package's homogeneous *segments*
(e.g. deepseek-v3 = 3 dense layers + 58 MoE layers), but each layer is its
own ``BlockParams`` module and a segment runs as a Python loop over its
layers (no scan).  Per-layer heterogeneity (gemma3's 5:1 local:global
windows and dual RoPE thetas) comes from ``layer_meta`` as in the JAX
package.  Parameters live in a ``TransformerParams`` module;
``TransformerLM`` holds the config and the functions, as the JAX class
does, so ``prefill(params, batch)`` and ``decode_step(params, cache,
token, pos)`` keep the reference's call shape.  The cache layout is the
JAX one: one (k, v) pair per segment, each (n_layers, B, S, KV, D); for MLA
(ckv (n, B, S, kv_lora), k_rope (n, B, S, rope)).  Decode writes the new
token into it in place.

Training: ``loss_fn`` (token-mean cross entropy through ``_chunked_ce``,
which never holds more than a (B, 512, V) block of logits; the MoE
router's aux term and deepseek-v3's depth-1 multi-token prediction loss)
runs through ``hidden_states`` only, never the in-place serving paths.
Under ``cfg.remat`` each layer's activations are recomputed in the
backward pass (``common.remat``), where the JAX package ``jax.checkpoint``s
its scan body.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import common, split_lm
from repro_torch.models.attention import AttnParams, attention_decode, attention_forward
from repro_torch.models.ffn import FFNParams, ffn_forward
from repro_torch.models.mla import MLAParams, mla_decode, mla_forward
from repro_torch.models.moe import MoEParams, moe_forward
from repro_torch.sharding.partition import MeshAxes, cache_pspecs
from repro_torch.sharding.placement import zeros_like_cache

# MoE capacity factor at decode: tiny T, generous capacity (as the reference)
DECODE_CAPACITY_FACTOR = 4.0


# ---------------------------------------------------------------------------
# Per-layer metadata (windows / thetas) for heterogeneous stacks
# ---------------------------------------------------------------------------


def layer_meta(cfg: ModelConfig, n_layers: int, offset: int = 0):
    """(windows (L,) int32, thetas (L,) float32) as numpy."""
    windows = np.zeros((n_layers,), np.int32)
    thetas = np.full((n_layers,), cfg.rope_theta, np.float32)
    if cfg.local_global_period > 0 and cfg.sliding_window > 0:
        for i in range(n_layers):
            gi = i + offset
            is_global = (gi + 1) % cfg.local_global_period == 0
            windows[i] = 0 if is_global else cfg.sliding_window
            thetas[i] = (
                cfg.rope_theta_global if (is_global and cfg.rope_theta_global) else cfg.rope_theta
            )
    elif cfg.sliding_window > 0:
        windows[:] = cfg.sliding_window
    return windows, thetas


def segments_of(cfg: ModelConfig) -> list[tuple[str, int, int]]:
    """(kind, n_layers, global_layer_offset) of each homogeneous segment."""
    if cfg.is_moe and cfg.first_dense_layers > 0:
        return [
            ("dense", cfg.first_dense_layers, 0),
            ("moe", cfg.n_layers - cfg.first_dense_layers, cfg.first_dense_layers),
        ]
    if cfg.is_moe:
        return [("moe", cfg.n_layers, 0)]
    return [("dense", cfg.n_layers, 0)]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _norm(cfg, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros((cfg.d_model,), dtype=dtype, device=device))


class BlockParams(nn.Module):
    """One layer's params.  kind: 'dense' | 'moe'.  ``FIELDS`` lists the
    keys the JAX package's block dict has for this config."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device, generator=None):
        super().__init__()
        init = dict(device=device, generator=generator)
        dtype = common.dtype_of(cfg.dtype)
        fields = ["ln1", "ln2", "attn", "ffn"]
        self.ln1 = _norm(cfg, dtype, device)
        self.ln2 = _norm(cfg, dtype, device)
        if cfg.use_mla:
            self.attn = MLAParams(cfg, dtype, **init)
        else:
            self.attn = AttnParams(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.resolved_head_dim, dtype, cfg.qk_norm, **init)
        if kind == "moe":
            self.ffn = MoEParams(cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts,
                                 cfg.n_shared_experts, dtype, **init)
            if cfg.moe_dense_residual:
                self.dense_ffn = FFNParams(cfg.d_model, cfg.d_ff, dtype, **init)
                fields.append("dense_ffn")
        else:
            ff = cfg.dense_d_ff if (cfg.dense_d_ff and cfg.is_moe) else cfg.d_ff
            self.ffn = FFNParams(cfg.d_model, ff, dtype, **init)
        if cfg.name.startswith("gemma"):  # gemma3 sandwich norms
            self.post_ln1 = _norm(cfg, dtype, device)
            self.post_ln2 = _norm(cfg, dtype, device)
            fields += ["post_ln1", "post_ln2"]
        self.FIELDS = tuple(fields)


class MTPParams(nn.Module):
    """DeepSeek-V3 multi-token prediction (depth 1): proj (2d, d), one
    dense block, ln (d,)."""

    FIELDS = ("proj", "block", "ln")

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        dtype = common.dtype_of(cfg.dtype)
        self.proj = nn.Parameter(common.dense_init(
            (2 * cfg.d_model, cfg.d_model), dtype, generator=generator, device=device))
        self.block = nn.ModuleList([BlockParams(cfg, "dense", device=device,
                                                generator=generator)])
        self.ln = _norm(cfg, dtype, device)


class TransformerParams(nn.Module):
    """Every parameter of a ``TransformerLM``: ``segs[s][i]`` is layer i of
    segment s.  With ``generator`` None the tensors are left uninitialised
    (filled by ``repro_torch.convert.lm_params_from_numpy``); on the meta
    device they are shapes only."""

    def __init__(self, cfg: ModelConfig, *, device, generator=None):
        super().__init__()
        dtype = common.dtype_of(cfg.dtype)
        init = dict(generator=generator, device=device)
        self.embed = nn.Parameter(common.embed_init((cfg.vocab_size, cfg.d_model), dtype,
                                                    **init))
        self.final_norm = _norm(cfg, dtype, device)
        self.register_parameter(
            "lm_head",
            None if cfg.tie_embeddings else nn.Parameter(
                common.dense_init((cfg.d_model, cfg.vocab_size), dtype, **init)),
        )
        self.segs = nn.ModuleList(
            nn.ModuleList(BlockParams(cfg, kind, **init) for _ in range(n))
            for kind, n, _off in segments_of(cfg)
        )
        self.mtp = MTPParams(cfg, **init) if cfg.mtp_depth > 0 else None

    def jax_layout(self) -> dict:
        return jax_layout(self)


# ---------------------------------------------------------------------------
# Block definitions
# ---------------------------------------------------------------------------


def _rms(x, w, eps: float, sp=None):
    """``rms_norm`` of one tensor, or (``sp`` set) of each computed part of
    a split value by that device's copy of ``w``."""
    if sp is None:
        return common.rms_norm(x, w, eps)
    return x.map(lambda t, m: common.rms_norm(t, w[m], eps))


def _each(fn, x, sp=None):
    """``fn`` of one tensor, or (``sp`` set) of each computed part of a split
    value (a ``Dist``, or a list of one tensor a device)."""
    if sp is None:
        return fn(x)
    if isinstance(x, list):
        return [None if t is None else fn(t) for t in x]
    return x.map(lambda t, m: fn(t))


def _block_forward(
    cfg: ModelConfig,
    kind: str,
    x,
    prm,
    window: int,
    theta: float,
    positions,
    flash_blk: int,
    sp=None,
    key=None,
):
    """Full-sequence block.  Returns (x, (k, v) cache entry, aux loss).

    ``sp`` set (a ``repro_torch.sharding.split.Split``): the block on a data
    group's `model` devices, ``prm`` the layer's gathered weights, ``x`` and
    the result in ``sp.layout``, ``positions`` one (S,) a device, ``key``
    the layer's name for the MoE routing; the cache entry as split values
    (each device's part of the cache is kept by ``split.CacheLeaf.fill``),
    the aux on ``sp.root``'s device."""
    eps = cfg.norm_eps
    h = _rms(x, prm.ln1, eps, sp)
    if cfg.use_mla:
        h, kv = mla_forward(prm.attn, h, cfg, positions, flash_blk=flash_blk, sp=sp)
    else:
        h, kv = attention_forward(
            prm.attn, h,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_theta=theta, positions=positions, causal=True, window=window,
            logit_softcap=cfg.attn_logit_softcap, norm_eps=eps,
            flash_blk=flash_blk, sp=sp,
        )
    if getattr(prm, "post_ln1", None) is not None:
        h = _rms(h, prm.post_ln1, eps, sp)
    x = x + h

    f_in = _rms(x, prm.ln2, eps, sp)
    aux = torch.zeros((), dtype=torch.float32,
                      device=x.device if sp is None else sp.devices[sp.root])
    if kind == "moe":
        f, aux = moe_forward(
            prm.ffn, f_in, top_k=cfg.moe_top_k,
            capacity_factor=cfg.capacity_factor, act=cfg.act, sp=sp, key=key,
        )
        if cfg.moe_dense_residual:
            f = f + ffn_forward(prm.dense_ffn, f_in, cfg.act, sp)
    else:
        f = ffn_forward(prm.ffn, f_in, cfg.act, sp)
    if getattr(prm, "post_ln2", None) is not None:
        f = _rms(f, prm.post_ln2, eps, sp)
    return x + f, kv, aux


def _block_decode(cfg: ModelConfig, kind: str, x, prm, cache, window: int,
                  theta: float, pos: int, sp=None, key=None):
    """Single-token block.  cache: this layer's (k, v) or (ckv, k_rope)
    views, written in place.  ``sp`` set: on a data group's `model`
    devices as ``_block_forward``'s, ``x`` and the result ``FULL``, the
    cache two ``split.CacheLeaf``s."""
    eps = cfg.norm_eps
    h = _rms(x, prm.ln1, eps, sp)
    if cfg.use_mla:
        h, cache = mla_decode(prm.attn, h, cache[0], cache[1], pos, cfg, sp=sp)
    else:
        h, cache = attention_decode(
            prm.attn, h, cache[0], cache[1], pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_theta=theta, window=window,
            logit_softcap=cfg.attn_logit_softcap, norm_eps=eps, sp=sp,
        )
    if getattr(prm, "post_ln1", None) is not None:
        h = _rms(h, prm.post_ln1, eps, sp)
    x = x + h

    f_in = _rms(x, prm.ln2, eps, sp)
    if kind == "moe":
        f, _ = moe_forward(
            prm.ffn, f_in, top_k=cfg.moe_top_k,
            capacity_factor=DECODE_CAPACITY_FACTOR, act=cfg.act, sp=sp, key=key,
        )
        if cfg.moe_dense_residual:
            f = f + ffn_forward(prm.dense_ffn, f_in, cfg.act, sp)
    else:
        f = ffn_forward(prm.ffn, f_in, cfg.act, sp)
    if getattr(prm, "post_ln2", None) is not None:
        f = _rms(f, prm.post_ln2, eps, sp)
    return x + f, cache


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class TransformerLM:
    def __init__(self, cfg: ModelConfig, flash_blk: int = 512, *, device: torch.device):
        self.cfg = cfg
        self.flash_blk = flash_blk
        self.device = torch.device(device)
        self.shard_x = lambda t: t  # activation sharding hook (launcher-set)
        # segments: list of (kind, n_layers, global_layer_offset)
        self.segments = segments_of(cfg)

    # -- params ------------------------------------------------------------

    def init_params(self, seed: int = 0) -> TransformerParams:
        """Seeded random parameters on the model's device (truncated-normal
        fan-in init, zero norm scales, as the JAX package; not its bits)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(seed))
        return TransformerParams(self.cfg, device=self.device, generator=g)

    def empty_params(self, device=None) -> TransformerParams:
        """Uninitialised parameters of the right shapes and dtypes
        (``device="meta"``: shapes only)."""
        return TransformerParams(self.cfg, device=self.device if device is None else device)

    def _head(self, params: TransformerParams) -> torch.Tensor:
        return params.embed.T if self.cfg.tie_embeddings else params.lm_head

    def embed_tokens(self, params, tokens, sp=None):
        """The embedding rows of ``tokens``.  ``sp`` set: ``params`` the
        placed tree, ``tokens`` one copy a device, the result in
        ``sp.layout`` (``split_lm.embed``)."""
        x = params.embed[tokens] if sp is None else split_lm.embed(sp, params, tokens)
        if self.cfg.name.startswith("gemma"):
            # the scale rounded to the embedding dtype before the product
            x = _each(lambda t: t * torch.tensor(np.sqrt(self.cfg.d_model), dtype=t.dtype,
                                                 device=t.device), x, sp)
        return x

    # -- forward (train / prefill) ------------------------------------------

    def hidden_states(self, params: TransformerParams, x: torch.Tensor,
                      positions: torch.Tensor, collect_cache: bool = False):
        """x: (B, S, d) embeddings.  Returns (hidden, caches, aux_sum)."""
        cfg = self.cfg
        caches = []
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        x = self.shard_x(x)
        for (kind, n, off), seg in zip(self.segments, params.segs):
            windows, thetas = layer_meta(cfg, n, off)
            ks, vs = [], []
            for i, prm in enumerate(seg):
                def body(h, prm=prm, window=int(windows[i]), theta=float(thetas[i]), kind=kind):
                    return _block_forward(cfg, kind, h, prm, window, theta, positions,
                                          self.flash_blk)

                x, kv, aux = common.remat(cfg, body, x)
                x = self.shard_x(x)
                aux_total = aux_total + aux
                if collect_cache:
                    ks.append(kv[0])
                    vs.append(kv[1])
            if collect_cache:
                caches.append((torch.stack(ks), torch.stack(vs)))
        x = common.rms_norm(x, params.final_norm, cfg.norm_eps)
        return x, caches, aux_total

    # -- losses --------------------------------------------------------------

    def loss_fn(self, params, batch: dict, sp=None) -> tuple[torch.Tensor, dict]:
        """batch: {'tokens' (B,S) | 'embeds' (B,S,d), 'labels' (B,S)}.
        Returns (loss, {'ce', 'aux', ['mtp'], 'loss'}).

        ``sp`` set (a ``repro_torch.sharding.split.Split``): the split
        program's loss on data group ``sp.group``'s `model` devices,
        ``params`` the placed parameters (the JAX layout of ``Sharded``
        leaves, gathered unit by unit), ``batch`` the group's rows; the loss,
        of the same value as on one device, on ``sp.root``'s device."""
        cfg = self.cfg
        whole = (lambda t: t) if sp is None else sp.whole
        tokens = None
        if cfg.embeddings_input:
            x = batch["embeds"] if sp is None else sp.from_whole(batch["embeds"])
        else:
            tokens = whole(batch["tokens"])
            x = self.embed_tokens(params, tokens, sp)
        labels = whole(batch["labels"])
        if sp is None:
            positions = torch.arange(x.shape[1], device=x.device)
            hidden, _, aux = self.hidden_states(params, x, positions)
        else:
            positions = split_lm.positions(sp)
            (hidden,), (aux,) = self._split_hidden([sp], params, [x], [positions])
        loss = self._ce(params, hidden, labels, sp=sp)
        metrics = {"ce": loss, "aux": aux}
        if cfg.is_moe:
            loss = loss + cfg.router_aux_coef * aux
        if cfg.mtp_depth > 0 and not cfg.embeddings_input:
            mtp_loss = self._mtp_loss(params, hidden, tokens, labels, positions, sp)
            loss = loss + 0.3 * mtp_loss
            metrics["mtp"] = mtp_loss
        metrics["loss"] = loss
        return loss, metrics

    def _mtp_loss(self, params, hidden, tokens, labels, positions, sp=None):
        """DeepSeek-V3 multi-token prediction (depth 1): one extra block over
        [h_t ; emb(t+1)] predicting token t+2."""
        cfg = self.cfg

        def ahead(t):
            return torch.roll(t, -1, dims=1)

        emb_next = self.embed_tokens(params, _each(ahead, tokens, sp), sp)
        if sp is None:
            h = torch.cat([hidden, emb_next], dim=-1) @ params.mtp.proj
            block = params.mtp.block[0]
        else:
            mtp = params["mtp"]
            h = hidden.zip(emb_next, lambda a, e, m: torch.cat([a, e], dim=-1))
            proj = sp.weights({"proj": mtp["proj"]}, "mtp.proj").proj
            h = sp.to(sp.mm(h, proj), sp.layout)
            del proj
            block = sp.weights(sp.layer(mtp["block"], 0), "mtp.block[0]")
        windows, thetas = layer_meta(cfg, 1)
        h, _, _ = _block_forward(cfg, "dense", h, block, int(windows[0]), float(thetas[0]),
                                 positions, self.flash_blk, sp, ("mtp", 0))
        del block  # the split program's gathered block: one unit alive at a time
        ln = params.mtp.ln if sp is None else sp.weights({"ln": params["mtp"]["ln"]},
                                                          "mtp.ln").ln
        h = _rms(h, ln, cfg.norm_eps, sp)
        labels2 = _each(ahead, labels, sp)
        first = labels2 if sp is None else labels2[sp.root]
        mask = torch.ones(first.shape, dtype=torch.float32, device=first.device)
        mask[:, -2:] = 0.0
        return self._ce(params, h, labels2, mask=mask, sp=sp)

    def _ce(self, params, hidden, labels, mask=None, sp=None):
        if sp is None:
            return _chunked_ce(hidden, self._head(params), labels, mask=mask)
        return split_lm.cross_entropy(sp, params, hidden, labels, mask=mask)

    # -- the split program's own parts (a mesh step over `model`) -------------

    def _split_layers(self, sps: list, tree, xs: list, block) -> tuple[list, list]:
        """Every layer on the data groups of ``sps`` in lockstep (each layer
        on every group before the next layer, so an MoE layer's ``lockstep``
        routing sees the groups before it), then the final norm: (each
        group's hidden, its aux sum on its root's device).  ``block(g, sp,
        kind, x, layer, key, window, theta)`` runs one layer of group g
        (``layer`` its placed leaves, gathered inside, ``key`` (segment,
        layer)) and returns (x, aux or None)."""
        cfg = self.cfg
        xs = list(xs)
        auxes = [torch.zeros((), dtype=torch.float32, device=sp.devices[sp.root]) for sp in sps]
        for si, (kind, n, off) in enumerate(self.segments):
            windows, thetas = layer_meta(cfg, n, off)
            seg = tree[f"seg{si}"]
            for i in range(n):
                for g, sp in enumerate(sps):
                    xs[g], aux = block(g, sp, kind, xs[g], sp.layer(seg, i), (si, i),
                                       int(windows[i]), float(thetas[i]))
                    if aux is not None:
                        auxes[g] = auxes[g] + aux
        hs = []
        for g, sp in enumerate(sps):
            w = sp.weights({"final_norm": tree["final_norm"]}, "final_norm").final_norm
            hs.append(_rms(xs[g], w, cfg.norm_eps, sp))
        return hs, auxes

    def _split_hidden(self, sps: list, tree, xs: list, positions: list, on_kv=None):
        """``hidden_states`` in the split program (``_split_layers``; the
        final-normed hidden in each group's ``layout``).  Each layer's
        weights are gathered inside its body, so ``common.remat`` gathers
        them again in the backward.  ``on_kv(g, segment, layer, kv)``:
        group g's cache entry of each layer (prefill)."""
        cfg = self.cfg

        def block(g, sp, kind, x, layer, key, window, theta):
            def body(x):
                w = sp.weights(layer, f"seg{key[0]}[{key[1]}]")
                y, kv, aux = _block_forward(cfg, kind, x, w, window, theta, positions[g],
                                            self.flash_blk, sp, key)
                if on_kv is not None:
                    on_kv(g, key[0], key[1], kv)
                return y, (aux,)

            y, (aux,) = split_lm.remat_layer(cfg, sp, x, body)
            return y, aux

        return self._split_layers(sps, tree, xs, block)

    # -- serving --------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, params: TransformerParams, batch: dict, sp=None, cache=None):
        """batch: {'tokens' (B, S)} or, for embeddings-input configs,
        {'embeds' (B, S, d)}.  Returns (last-token logits (B, V) float32,
        cache).

        ``sp`` set (a list of ``repro_torch.sharding.split.Split``s, one a
        data group, run in lockstep): the split program's prefill,
        ``params`` the placed parameters, ``batch`` a list of the groups'
        rows, ``cache`` the mesh's cache (``init_cache(mesh=)``), into which
        each device writes its part of its group's entries.  Returns (each
        group's logits on its root's device, the cache)."""
        if sp is not None:
            return self._split_prefill(sp, params, batch, cache)
        cfg = self.cfg
        x = (
            batch["embeds"] if cfg.embeddings_input
            else self.embed_tokens(params, batch["tokens"])
        )
        positions = torch.arange(x.shape[1], device=x.device)
        hidden, caches, _ = self.hidden_states(params, x, positions, collect_cache=True)
        logits = hidden[:, -1, :] @ self._head(params)
        return logits.float(), caches

    def init_cache(self, batch: int, seq: int, device=None, mesh=None):
        """Zeros of the cache of ``batch`` rows and ``seq`` positions.
        ``mesh`` set: each device's shard of it allocated where it lives,
        ``Sharded`` leaves in ``cache_pspecs``'s layout (``seq`` the final
        length, prompt and new tokens: the sequence's chunks never move)."""
        cfg = self.cfg
        if mesh is not None:
            shape = self.init_cache(batch, seq, device="meta")
            return zeros_like_cache(mesh, shape, cache_pspecs(shape, cfg, MeshAxes(mesh)))
        dtype = common.dtype_of(cfg.dtype)
        device = self.device if device is None else device
        caches = []
        for _kind, n, _off in self.segments:
            if cfg.use_mla:
                caches.append((
                    torch.zeros((n, batch, seq, cfg.kv_lora_rank), dtype=dtype, device=device),
                    torch.zeros((n, batch, seq, cfg.qk_rope_dim), dtype=dtype, device=device),
                ))
            else:
                kvh = (n, batch, seq, cfg.n_kv_heads, cfg.resolved_head_dim)
                caches.append((torch.zeros(kvh, dtype=dtype, device=device),
                               torch.zeros(kvh, dtype=dtype, device=device)))
        return caches

    @torch.no_grad()
    def decode_step(self, params: TransformerParams, cache, token: torch.Tensor, pos: int,
                    sp=None):
        """token: (B,) int (or (B, 1, d) embeds); pos: the position written.
        Returns (logits (B, V) float32, cache) — the same cache tensors,
        updated in place.  ``sp`` set: the split program's step, as
        ``prefill``'s (``token`` a list of the groups' rows)."""
        if sp is not None:
            return self._split_decode(sp, params, cache, token, int(pos))
        cfg = self.cfg
        if cfg.embeddings_input and token.ndim == 3:
            x = token
        else:
            x = self.embed_tokens(params, token[:, None])
        pos = int(pos)
        x = self.shard_x(x)
        for (kind, n, off), seg, c in zip(self.segments, params.segs, cache):
            windows, thetas = layer_meta(cfg, n, off)
            for i, prm in enumerate(seg):
                x, _ = _block_decode(cfg, kind, x, prm, (c[0][i], c[1][i]),
                                     int(windows[i]), float(thetas[i]), pos)
                x = self.shard_x(x)
        x = common.rms_norm(x, params.final_norm, cfg.norm_eps)
        logits = x[:, 0, :] @ self._head(params)
        return logits.float(), cache

    # -- the split program's serve steps ---------------------------------------

    def _split_prefill(self, sps: list, tree, batches: list, cache):
        cfg = self.cfg
        xs = []
        for sp, batch in zip(sps, batches):
            if cfg.embeddings_input:
                xs.append(sp.from_whole(batch["embeds"]))
            else:
                xs.append(self.embed_tokens(tree, sp.whole(batch["tokens"]), sp))

        def keep(g, si, i, kv):
            sp = sps[g]
            for sh, val in zip(cache[si], kv):
                leaf, val = sp.cache_leaf(sh, i), sp.to(val, sp.FULL)
                for m in sp.active:
                    leaf.fill(m, val.parts[m])

        hs, _ = self._split_hidden(sps, tree, xs, [split_lm.positions(sp) for sp in sps],
                                   on_kv=keep)
        return [split_lm.logits(sp, tree, split_lm.last(sp, h)) for sp, h in zip(sps, hs)], cache

    def _split_decode(self, sps: list, tree, cache, tokens: list, pos: int):
        cfg = self.cfg
        xs = []
        for sp, tok in zip(sps, tokens):
            if cfg.embeddings_input and tok.ndim == 3:
                xs.append(sp.dist(sp.FULL, sp.whole(tok)))
            else:
                xs.append(self.embed_tokens(tree, _each(lambda t: t[:, None], sp.whole(tok), sp),
                                            sp))

        def block(g, sp, kind, x, layer, key, window, theta):
            w = sp.weights(layer, f"seg{key[0]}[{key[1]}]")
            c = tuple(sp.cache_leaf(sh, key[1]) for sh in cache[key[0]])
            return _block_decode(cfg, kind, x, w, c, window, theta, pos, sp, key)[0], None

        hs, _ = self._split_layers(sps, tree, xs, block)
        return [split_lm.logits(sp, tree, h) for sp, h in zip(sps, hs)], cache


_CE_CHUNK = split_lm.CE_CHUNK


def _chunked_ce(hidden: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor | None = None, chunk: int = _CE_CHUNK) -> torch.Tensor:
    """Cross entropy with the (B, chunk, V) logits block looped over the
    sequence so the full (B, S, V) logits tensor never materializes (vocab
    up to 262 K); S <= chunk or not a multiple of it takes one block."""
    b, s, _ = hidden.shape
    if s <= chunk or s % chunk:
        return common.cross_entropy(hidden @ head, labels, mask)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(s // chunk):
        cols = slice(c * chunk, (c + 1) * chunk)
        logits = (hidden[:, cols] @ head).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, cols, None].long())[..., 0]
        mc = (mask[:, cols].float() if mask is not None
              else torch.ones((b, chunk), dtype=torch.float32, device=hidden.device))
        tot = tot + torch.sum((logz - gold) * mc)
        cnt = cnt + torch.sum(mc)
    return tot / torch.clamp(cnt, min=1.0)


# ---------------------------------------------------------------------------
# The JAX package's parameter layout
# ---------------------------------------------------------------------------


def jax_layout(params: TransformerParams) -> dict:
    """``params`` arranged as the JAX package's ``init_params`` pytree, with
    its NamedTuples as dicts (None kept): top-level leaves are tensors and
    each segment leaf is the list of its layers' tensors."""
    tree: dict = {"embed": params.embed, "final_norm": params.final_norm}
    if params.lm_head is not None:
        tree["lm_head"] = params.lm_head
    for si, seg in enumerate(params.segs):
        tree[f"seg{si}"] = common.stacked_layout(list(seg))
    if params.mtp is not None:
        tree["mtp"] = {"proj": params.mtp.proj,
                       "block": common.stacked_layout(list(params.mtp.block)),
                       "ln": params.mtp.ln}
    return tree
