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

The split program (``sp=``: ``loss_fn(params, batch, sp)``, ``prefill``
and ``decode_step`` with a list of ``Split``s, one a data group, the
placed parameters and the mesh's cache): the decoder runs on the group's
``Split`` over its S tokens, the encoder on ``sp.over(T)``, the same
devices over the T frames (one sink: one backward reaches both stacks).
Each layer's attention projections are column-parallel and wo row-parallel
(``attention_forward(sp=)``: the encoder's bidirectional and the
decoder's causal self-attention, and the cross-attention, split by query
rows), w1 column-parallel and w2 row-parallel (``mlp_forward(sp=)``, b2
added once after the partials are reduced); each decoder layer's
``xattn.wk``/``wv`` products of the encoder states column-parallel,
all-gathered for the query rows.  The embedding, the tied head and the
cross entropy go through ``split_lm`` (a vocabulary `model` does not
divide leaves the embedding whole).  The cache is laid out as
``cache_pspecs`` says (``split.CacheLeaf``): ``k``/``v`` and the cross
cache ``xk``/``xv`` by KV heads where M divides them, else by chunks of
their positions (S, or the T frames), else whole; decode's
cross-attention reads the new token's query against it
(``attention_decode(update_cache=False, sp=)``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import common, split_lm
from repro_torch.models.attention import (
    AttnParams,
    _split_heads,
    attention_decode,
    attention_forward,
)
from repro_torch.models.ffn import MLPParams, mlp_forward
from repro_torch.models.transformer import _chunked_ce, _rms
from repro_torch.sharding.partition import MeshAxes, cache_pspecs
from repro_torch.sharding.placement import zeros_like_cache


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

    def _sinusoids(self, x, table: torch.Tensor, sp=None):
        """``x`` plus the (S, d) sinusoid ``table``: one tensor, or (``sp``
        set) each part plus its rows of the table (a ``ROWS`` part its
        chunk's)."""
        if sp is None:
            return x + table.to(x.dtype)[None]

        def add(t, m):
            rows = table if x.kind == sp.FULL else table.narrow(0, sp.row_start[m], sp.rows[m])
            return t + rows.to(t.device, t.dtype)[None]

        return x.map(add)

    def _enc_layer(self, w, x, positions, sp=None):
        """One encoder layer (``w`` its weights, gathered where ``sp`` is set)."""
        eps = self.cfg.norm_eps
        a, _ = attention_forward(w.attn, _rms(x, w.ln1, eps, sp),
                                 **self._attn_kw(positions, causal=False), sp=sp)
        x = x + a
        return x + mlp_forward(w.mlp, _rms(x, w.ln2, eps, sp), sp=sp)

    def _cross_kv(self, w, enc, se=None):
        """The cross-attention's k and v (B, T, KV, D) of the encoder states
        ``enc``: ``w``'s (the layer's ``xattn``) wk and wv products; with
        ``se`` (the encoder's split) column-parallel as the specs split
        them, then all-gathered: ``FULL``, the layout the query-row split
        reads."""
        n_kv = self.cfg.n_kv_heads
        if se is None:
            return _split_heads(enc @ w.wk, n_kv), _split_heads(enc @ w.wv, n_kv)
        e = se.to(enc, se.input_kind(w.wk))  # gathered once for both products
        return tuple(se.to(se.mm(e, t), se.FULL).map(lambda y, m: _split_heads(y, n_kv))
                     for t in (w.wk, w.wv))

    def _dec_layer(self, w, x, enc, positions, sp=None, se=None):
        """One decoder layer: (x, its cache entry (k, v, xk, xv))."""
        eps = self.cfg.norm_eps
        a, kv = attention_forward(w.attn, _rms(x, w.ln1, eps, sp),
                                  **self._attn_kw(positions, causal=True), sp=sp)
        x = x + a
        # cross attention over encoder states (kv projected per layer)
        xk, xv = self._cross_kv(w.xattn, enc, se)
        c, _ = attention_forward(w.xattn, _rms(x, w.ln_x, eps, sp),
                                 **self._attn_kw(positions, causal=False),
                                 kv_override=(xk, xv), sp=sp)
        x = x + c
        x = x + mlp_forward(w.mlp, _rms(x, w.ln2, eps, sp), sp=sp)
        return x, (kv[0], kv[1], xk, xv)

    # -- encoder --------------------------------------------------------------

    def encode(self, params, frames: torch.Tensor, sp=None):
        """frames: (B, T, d) stub frame embeddings -> encoder states.  ``sp``
        set (a ``Split`` over the T frames, ``Split.over``): ``params`` the
        placed tree, ``frames`` the group's rows, the states in
        ``sp.layout``."""
        cfg = self.cfg
        t = frames.shape[1]
        table = torch.from_numpy(sinusoid_positions(t, cfg.d_model))
        if sp is not None:
            x = self._sinusoids(sp.from_whole(frames), table, sp)
            positions = split_lm.positions(sp)
            tree = params
            for i in range(cfg.n_encoder_layers):
                def body(x, i=i):
                    w = sp.weights(sp.layer(tree["enc"], i), f"enc[{i}]")
                    return self._enc_layer(w, x, positions, sp), ()

                x, _ = split_lm.remat_layer(cfg, sp, x, body)
            w = sp.weights({"enc_norm": tree["enc_norm"]}, "enc_norm").enc_norm
            return _rms(x, w, cfg.norm_eps, sp)
        x = self._sinusoids(frames, table.to(frames.device))
        positions = torch.arange(t, device=frames.device)
        x = self.shard_x(x)
        for prm in params.enc:
            x = self.shard_x(common.remat(
                cfg, lambda h, prm=prm: self._enc_layer(prm, h, positions), x))
        return common.rms_norm(x, params.enc_norm, cfg.norm_eps)

    # -- decoder --------------------------------------------------------------

    def _decoder_states(self, params, tokens, enc, collect_cache: bool = False, sp=None,
                        enc_sp=None, keep=None):
        """The decoder's final-normed hidden over ``tokens`` (B, S) against
        the encoder states ``enc``, and with ``collect_cache`` the cache
        dict.  ``sp`` set: on the group's split over S (``params`` the
        placed tree, ``tokens`` the group's rows, ``enc`` in ``enc_sp``'s
        layout); ``keep(i, (k, v, xk, xv))`` takes each layer's cache entry
        (``FULL`` values); returns the hidden in ``sp.layout``."""
        cfg = self.cfg
        s = tokens.shape[1]
        table = torch.from_numpy(sinusoid_positions(s, cfg.d_model))
        if sp is not None:
            tree = params
            x = self._sinusoids(split_lm.embed(sp, tree, sp.whole(tokens)), table, sp)
            positions = split_lm.positions(sp)
            for i in range(cfg.n_layers):
                def body(x, i=i):
                    w = sp.weights(sp.layer(tree["dec"], i), f"dec[{i}]")
                    x, entry = self._dec_layer(w, x, enc, positions, sp, enc_sp)
                    if keep is not None:
                        keep(i, entry)
                    return x, ()

                x, _ = split_lm.remat_layer(cfg, sp, x, body)
            w = sp.weights({"final_norm": tree["final_norm"]}, "final_norm").final_norm
            return _rms(x, w, cfg.norm_eps, sp), None
        x = self._sinusoids(params.embed[tokens], table.to(tokens.device))
        positions = torch.arange(s, device=x.device)
        cache = {"k": [], "v": [], "xk": [], "xv": []}
        x = self.shard_x(x)
        for prm in params.dec:
            def body(h, prm=prm):
                h, entry = self._dec_layer(prm, h, enc, positions)
                return h, *entry

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

    def loss_fn(self, params, batch: dict, sp=None) -> tuple[torch.Tensor, dict]:
        """batch: {'frames' (B,T,d), 'tokens' (B,S), 'labels' (B,S)}.  The
        head is tied: ``embed.T``.  Returns (loss, {'ce', 'loss'}).  ``sp``
        set: the split program's loss on data group ``sp.group``'s devices
        (``sp`` over the S tokens; ``params`` placed, ``batch`` the group's
        rows; the loss on ``sp.root``'s device)."""
        if sp is not None:
            se = sp.over(batch["frames"].shape[1])
            enc = self.encode(params, batch["frames"], se)
            hidden, _ = self._decoder_states(params, batch["tokens"], enc, sp=sp, enc_sp=se)
            loss = split_lm.cross_entropy(sp, params, hidden, sp.whole(batch["labels"]))
            return loss, {"ce": loss, "loss": loss}
        enc = self.encode(params, batch["frames"])
        hidden, _ = self._decoder_states(params, batch["tokens"], enc)
        loss = _chunked_ce(hidden, params.embed.T, batch["labels"])
        return loss, {"ce": loss, "loss": loss}

    # -- serving ---------------------------------------------------------------

    @torch.no_grad()
    def prefill(self, params, batch: dict, sp=None, cache=None):
        """batch: {'frames' (B, T, d), 'tokens' (B, S)}.  Returns (last-token
        logits (B, V) float32, cache).  ``sp`` set (a list of ``Split``s over
        the S tokens, one a data group): the split program's prefill of each
        group's rows (``batch`` a list) into ``cache`` (``init_cache(mesh=)``);
        returns (each group's logits on its root's device, the cache)."""
        if sp is not None:
            return [self._split_prefill(g, params, b, cache) for g, b in zip(sp, batch)], cache
        enc = self.encode(params, batch["frames"])
        hidden, cache = self._decoder_states(params, batch["tokens"], enc, collect_cache=True)
        logits = hidden[:, -1, :] @ params.embed.T
        return logits.float(), cache

    def init_cache(self, batch: int, seq: int, enc_len: int | None = None, device=None,
                   mesh=None):
        """Zeros of the cache: ``k``/``v`` of ``seq`` positions, ``xk``/``xv``
        of ``enc_len`` frames (default ``seq``); ``mesh`` set: ``Sharded``
        leaves in ``cache_pspecs``'s layout, each shard allocated where it
        lives."""
        cfg = self.cfg
        if mesh is not None:
            shape = self.init_cache(batch, seq, enc_len, device="meta")
            return zeros_like_cache(mesh, shape, cache_pspecs(shape, cfg, MeshAxes(mesh)))
        dtype = common.dtype_of(cfg.dtype)
        device = self.device if device is None else device
        el = enc_len if enc_len is not None else seq
        kvh = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.resolved_head_dim)
        xvh = (cfg.n_layers, batch, el, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(kvh, dtype=dtype, device=device),
                "v": torch.zeros(kvh, dtype=dtype, device=device),
                "xk": torch.zeros(xvh, dtype=dtype, device=device),
                "xv": torch.zeros(xvh, dtype=dtype, device=device)}

    def _dec_step(self, w, x, cache: dict, i: int, pos: int, sp=None):
        """One decoder layer of one token: ``cache``'s layer ``i`` (``k``/``v``
        written at ``pos``; ``xk``/``xv`` read, every frame valid), one
        tensor's or (``sp`` set) ``split.CacheLeaf``s."""
        cfg = self.cfg
        eps = cfg.norm_eps
        kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                  rope_theta=None, norm_eps=eps, sp=sp)
        k, v, xk, xv = ((cache[n][i] if sp is None else sp.cache_leaf(cache[n], i))
                        for n in ("k", "v", "xk", "xv"))
        a, _ = attention_decode(w.attn, _rms(x, w.ln1, eps, sp), k, v, pos, **kw)
        x = x + a
        t = cache["xk"].shape[2]
        c, _ = attention_decode(w.xattn, _rms(x, w.ln_x, eps, sp), xk, xv, t - 1,
                                update_cache=False, **kw)
        x = x + c
        return x + mlp_forward(w.mlp, _rms(x, w.ln2, eps, sp), sp=sp)

    @torch.no_grad()
    def decode_step(self, params, cache: dict, token, pos: int, sp=None):
        """token: (B,) int; pos: the position written.  Returns (logits
        (B, V) float32, cache) — the same cache tensors, k/v updated in
        place.  ``sp`` set: the split program's step, as ``prefill``'s
        (``token`` a list of the groups' rows)."""
        if sp is not None:
            return [self._split_decode(g, params, cache, t, int(pos))
                    for g, t in zip(sp, token)], cache
        cfg = self.cfg
        pos = int(pos)
        x = params.embed[token[:, None]]
        x = x + sinusoid_at(pos, cfg.d_model, x.device).to(x.dtype)[None, None, :]
        for i, prm in enumerate(params.dec):
            x = self._dec_step(prm, x, cache, i, pos)
        x = common.rms_norm(x, params.final_norm, cfg.norm_eps)
        logits = x[:, 0, :] @ params.embed.T
        return logits.float(), cache

    # -- the split program's serve steps -----------------------------------------

    def _split_prefill(self, sp, tree, batch: dict, cache: dict):
        def keep(i, entry):
            for name, val in zip(("k", "v", "xk", "xv"), entry):
                leaf = sp.cache_leaf(cache[name], i)
                for m in sp.active:
                    leaf.fill(m, val.parts[m])

        se = sp.over(batch["frames"].shape[1])
        enc = self.encode(tree, batch["frames"], se)
        h, _ = self._decoder_states(tree, batch["tokens"], enc, sp=sp, enc_sp=se, keep=keep)
        return split_lm.logits(sp, tree, split_lm.last(sp, h))

    def _split_decode(self, sp, tree, cache: dict, token: torch.Tensor, pos: int):
        cfg = self.cfg
        x = split_lm.embed(sp, tree, [None if t is None else t[:, None] for t in sp.whole(token)])
        x = x.map(lambda t, m: t + sinusoid_at(pos, cfg.d_model, t.device).to(t.dtype)[None, None])
        for i in range(cfg.n_layers):
            w = sp.weights(sp.layer(tree["dec"], i), f"dec[{i}]")
            x = self._dec_step(w, x, cache, i, pos, sp)
        w = sp.weights({"final_norm": tree["final_norm"]}, "final_norm").final_norm
        return split_lm.logits(sp, tree, _rms(x, w, cfg.norm_eps, sp))
