"""Multi-head Latent Attention (DeepSeek-V2/V3) — the port of
``repro.models.mla``.

Train/prefill use the naive (decompressed) path; decode uses the
weight-absorbed path with float32 latent products and a compressed cache
of (kv_lora + qk_rope) values per token, written in place at ``pos``.

Shapes (deepseek-v3): d=7168, q_lora=1536, kv_lora=512, qk_nope=128,
qk_rope=64, v_head=128, H=128.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import common
from repro_torch.models.attention import flash_attention
from repro_torch.models.decode_opt import flash_merge_split, masked_scores, softmax_partial


class MLAParams(nn.Module):
    """wdq (d, q_lora), q_ln (q_lora,), wuq (q_lora, H*(nope+rope)),
    wdkv (d, kv_lora), kv_ln (kv_lora,), wuk (kv_lora, H*nope),
    wuv (kv_lora, H*v_dim), wkr (d, rope), wo (H*v_dim, d)."""

    NAMEDTUPLE = True  # a NamedTuple in the JAX package
    FIELDS = ("wdq", "q_ln", "wuq", "wdkv", "kv_ln", "wuk", "wuv", "wkr", "wo")

    def __init__(self, cfg, dtype, *, device, generator=None):
        super().__init__()
        init = dict(generator=generator, device=device)
        h = cfg.n_heads
        dense = lambda shape: nn.Parameter(common.dense_init(shape, dtype, **init))  # noqa: E731
        self.wdq = dense((cfg.d_model, cfg.q_lora_rank))
        self.q_ln = nn.Parameter(torch.zeros((cfg.q_lora_rank,), dtype=dtype, device=device))
        self.wuq = dense((cfg.q_lora_rank, h * (cfg.qk_nope_dim + cfg.qk_rope_dim)))
        self.wdkv = dense((cfg.d_model, cfg.kv_lora_rank))
        self.kv_ln = nn.Parameter(torch.zeros((cfg.kv_lora_rank,), dtype=dtype, device=device))
        self.wuk = dense((cfg.kv_lora_rank, h * cfg.qk_nope_dim))
        self.wuv = dense((cfg.kv_lora_rank, h * cfg.v_head_dim))
        self.wkr = dense((cfg.d_model, cfg.qk_rope_dim))
        self.wo = dense((h * cfg.v_head_dim, cfg.d_model))


def _project_q(p: MLAParams, x, cfg, positions):
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    cq = common.rms_norm(x @ p.wdq, p.q_ln, cfg.norm_eps)
    q = (cq @ p.wuq).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = common.apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def mla_forward(
    p: MLAParams,
    x: torch.Tensor,  # (B, S, d)
    cfg,
    positions: torch.Tensor,  # (S,) or (B, S)
    *,
    flash_blk: int = 512,
    sp=None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Naive decompressed MLA for train/prefill.

    Returns (out, (ckv_normed, k_rope)) — the compressed-cache entries.
    ``sp`` set: on a data group's `model` devices (``_mla_split``; the
    entries as split values).
    """
    if sp is not None:
        return _mla_split(sp, p, x, cfg, positions, flash_blk=flash_blk)
    b, s, _ = x.shape
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    if positions.ndim == 1:
        positions = positions[None, :]

    q_nope, q_rope = _project_q(p, x, cfg, positions)
    ckv = common.rms_norm(x @ p.wdkv, p.kv_ln, cfg.norm_eps)  # (B, S, kv_lora)
    k_nope = (ckv @ p.wuk).reshape(b, s, h, dn)
    v = (ckv @ p.wuv).reshape(b, s, h, dv)
    k_rope = common.apply_rope((x @ p.wkr)[:, :, None, :], positions, cfg.rope_theta)

    q = torch.cat([q_nope, q_rope], dim=-1)  # (B, S, H, dn+dr)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    out = flash_attention(q, k, v, causal=True, window=0, blk=flash_blk)
    out = out.reshape(b, s, h * dv) @ p.wo
    return out, (ckv, k_rope[:, :, 0, :])


def _mla_split(sp, w, x, cfg, positions: list, *, flash_blk: int = 512):
    """``mla_forward``'s output on a data group's `model` devices (``sp``,
    a ``repro_torch.sharding.split.Split``; ``w`` the gathered
    ``MLAParams`` fields, ``positions[m]`` (S,) on device m, ``x`` and the
    result in ``sp.layout``).

    wdq, wdkv and wkr are column-parallel by the specs, so the latents
    are all-gathered over `model` before q_ln / kv_ln (the norms read the
    whole latent); wuq and wuk give head columns; wuv is row-parallel by
    name (its kv_lora rows on `model`), so v is the sum of the devices'
    partials (an all-reduce in shard order) where ``fit`` keeps that
    split; wo is row-parallel.  As in ``attention._attention_split`` the attention
    is split by query rows (each device's sequence chunk, every head).
    Returns (the output, the cache entry (ckv, k_rope): ckv ``FULL``, or
    ``ROWS`` where the specs keep wdkv whole, and k_rope rotated, ``FULL``)."""
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    b = x.parts[sp.root].shape[0]
    s = sp.seq_len
    x = sp.to(x, sp.FULL)

    cq = sp.whole_cols(sp.mm(x, w.wdq)).map(
        lambda t, m: common.rms_norm(t, w.q_ln[m], cfg.norm_eps))
    q = sp.to(sp.mm(cq, w.wuq), sp.ROWS)
    ckv = sp.whole_cols(sp.mm(x, w.wdkv)).map(
        lambda t, m: common.rms_norm(t, w.kv_ln[m], cfg.norm_eps))
    k_nope = sp.to(sp.mm(ckv, w.wuk), sp.FULL)
    v = sp.to(sp.mm(ckv, w.wuv), sp.FULL)
    k_rope = sp.to(sp.mm(x, w.wkr), sp.FULL).map(lambda t, m: common.apply_rope(
        t[:, :, None, :], positions[m][None, :], cfg.rope_theta))

    def core(qm, m):
        r0, n = sp.row_start[m], qm.shape[1]
        pos = positions[m][None, :]
        qm = qm.reshape(b, n, h, dn + dr)
        q_rope = common.apply_rope(qm[..., dn:], pos[:, r0:r0 + n], cfg.rope_theta)
        qm = torch.cat([qm[..., :dn], q_rope], dim=-1)
        km = torch.cat([k_nope.parts[m].reshape(b, s, h, dn),
                        k_rope.parts[m].expand(b, s, h, dr)], dim=-1)
        out = flash_attention(qm, km, v.parts[m].reshape(b, s, h, dv), causal=True, window=0,
                              blk=flash_blk, q_start=r0)
        return out.reshape(b, n, h * dv)

    out = sp.to(sp.mm(q.map(core), w.wo), sp.layout)
    return out, (ckv, k_rope.map(lambda t, m: t[:, :, 0, :]))


def mla_decode(
    p: MLAParams,
    x: torch.Tensor,  # (B, 1, d)
    ckv_cache: torch.Tensor,  # (B, S, kv_lora) — rms-normed compressed kv
    kr_cache: torch.Tensor,  # (B, S, rope)
    pos: int,
    cfg,
    sp=None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Weight-absorbed decode: scores and context live in the latent space.

    score_h(t) = q_nope_h^T Wuk_h ckv_t + q_rope^T kr_t
    ctx_h      = sum_t p_t ckv_t          (B, H, kv_lora)
    out        = concat_h(ctx_h Wuv_h) Wo

    ``sp`` set: on a data group's `model` devices (``_mla_decode_split``;
    the caches ``split.CacheLeaf``s).
    """
    if sp is not None:
        return (_mla_decode_split(sp, p, x, ckv_cache, kr_cache, int(pos), cfg),
                (ckv_cache, kr_cache))
    b = x.shape[0]
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lr = cfg.kv_lora_rank
    positions = torch.full((b, 1), pos, device=x.device)

    # update caches with this token's compressed kv
    ckv_new = common.rms_norm(x @ p.wdkv, p.kv_ln, cfg.norm_eps)  # (B, 1, lr)
    kr_new = common.apply_rope((x @ p.wkr)[:, :, None, :], positions, cfg.rope_theta)[
        :, :, 0, :
    ]
    ckv_cache[:, pos:pos + 1] = ckv_new.to(ckv_cache.dtype)
    kr_cache[:, pos:pos + 1] = kr_new.to(kr_cache.dtype)

    q_nope, q_rope = _project_q(p, x, cfg, positions)  # (B, 1, H, dn/dr)
    # absorb Wuk into the query: (B, H, lr)
    wuk = p.wuk.reshape(lr, h, dn)
    q_lat = torch.einsum("bhd,lhd->bhl", q_nope[:, 0].float(), wuk.float())

    scale = (dn + dr) ** -0.5
    scores = (
        torch.einsum("bhl,bsl->bhs", q_lat, ckv_cache.float())
        + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].float(), kr_cache.float())
    ) * scale
    mask = torch.arange(ckv_cache.shape[1], device=x.device) <= pos
    scores = torch.where(mask[None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)

    ctx = torch.einsum("bhs,bsl->bhl", probs, ckv_cache.float())  # (B,H,lr)
    wuv = p.wuv.reshape(lr, h, dv)
    out_h = torch.einsum("bhl,lhv->bhv", ctx, wuv.float())  # (B,H,dv)
    out = out_h.reshape(b, 1, h * dv).to(x.dtype) @ p.wo
    return out, (ckv_cache, kr_cache)


def _head_runs(c0: int, c1: int, width: int) -> list[tuple[int, int, int, int, int]]:
    """The columns ``c0`` .. ``c1 - 1`` of a (heads x ``width``) flattening
    as runs (h0, h1, d0, d1, offset): heads h0 .. h1 - 1, their columns d0 ..
    d1 - 1 each, starting at column ``offset`` of the range (whole heads in
    one run, a head cut by the range in a run of its own)."""
    runs, c = [], c0
    while c < c1:
        hh, d = divmod(c, width)
        if d == 0 and c + width <= c1:
            n = (c1 - c) // width
            runs.append((hh, hh + n, 0, width, c - c0))
            c += n * width
        else:
            e = min((hh + 1) * width, c1)
            runs.append((hh, hh + 1, d, d + e - c, c - c0))
            c = e
    return runs


def _mla_decode_split(sp, w, x, cc, kc, pos: int, cfg):
    """``mla_decode`` on a data group's `model` devices (``sp``; ``w`` the
    gathered ``MLAParams`` fields, ``x`` and the result ``FULL``), the latent
    caches ``cc`` (ckv) and ``kc`` (k_rope) laid out by ``cache_pspecs``
    (``split.CacheLeaf``s: the sequence on `model`, or whole).

    The projections follow the specs as ``_mla_split``'s: wdkv, wkr, wdq
    and wuq column-parallel, their outputs all-gathered (the new latent
    entries go into the shard whose chunk holds ``pos``, or every copy of a
    whole leaf); the absorbed query ``q_lat`` is wuk's column-parallel
    product (each device its columns of H * nope, a head cut by a slice
    summed over the devices holding it), all-reduced, so every device has
    q_lat and q_rope of every head for its chunk of positions.  Each
    device's partial softmax over its chunk is merged exactly
    (``decode_opt.flash_merge_split``) into the kv_lora rows of wuv's
    slice (row-parallel by its name, a reduce-scatter), the value products
    summed over `model` into wo's columns, and wo is row-parallel.  A
    weight whose `model` axis ``fit`` dropped is whole on every device and
    multiplied once, on the device holding the token's row (the others
    add zeros)."""
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lr, eps = cfg.kv_lora_rank, cfg.norm_eps
    x = sp.to(x, sp.FULL)
    b, dtype = x.parts[sp.root].shape[0], x.parts[sp.root].dtype

    def at(t):
        return torch.full((b, 1), pos, device=t.device)

    ckv = sp.to(sp.mm(x, w.wdkv), sp.FULL).map(
        lambda t, m: common.rms_norm(t, w.kv_ln[m], eps))
    kr = sp.to(sp.mm(x, w.wkr), sp.FULL).map(
        lambda t, m: common.apply_rope(t[:, :, None, :], at(t), cfg.rope_theta)[:, :, 0, :])
    for m in sp.active:
        cc.write(m, ckv.parts[m], pos)
        kc.write(m, kr.parts[m], pos)

    cq = sp.to(sp.mm(x, w.wdq), sp.FULL).map(lambda t, m: common.rms_norm(t, w.q_ln[m], eps))
    q = sp.to(sp.mm(cq, w.wuq), sp.FULL).map(lambda t, m: t.reshape(b, 1, h, dn + dr))
    q_rope = q.map(lambda t, m: common.apply_rope(t[..., dn:], at(t), cfg.rope_theta)[:, 0])

    def lat(t, m):  # device m's part of q_lat (B, H, lr): its columns of wuk
        qn = t[:, 0, :, :dn].float()
        wk = w.wuk[m]
        if w.wuk.model_dim is None:
            if not sp.rows[m]:
                return torch.zeros((b, h, lr), dtype=torch.float32, device=qn.device)
            return torch.einsum("bhd,lhd->bhl", qn, wk.reshape(lr, h, dn).float())
        out = torch.zeros((b, h, lr), dtype=torch.float32, device=qn.device)
        c0 = m * wk.shape[1]
        for h0, h1, d0, d1, off in _head_runs(c0, c0 + wk.shape[1], dn):
            piece = wk[:, off:off + (h1 - h0) * (d1 - d0)].reshape(lr, h1 - h0, d1 - d0)
            out[:, h0:h1] = torch.einsum("bhd,lhd->bhl", qn[:, h0:h1, d0:d1], piece.float())
        return out

    q_lat = sp.to(sp.dist(sp.PARTIAL, q.map(lat).parts), sp.FULL)
    scale = (dn + dr) ** -0.5

    def part(t, m):
        ck, kk = cc.local(m).float(), kc.local(m).float()
        scores = (torch.einsum("bhl,bsl->bhs", t, ck)
                  + torch.einsum("bhr,bsr->bhs", q_rope.parts[m].float(), kk)) * scale
        mx, p, den = softmax_partial(masked_scores(scores, pos, start=cc.start[m]))
        return mx, torch.einsum("bhs,bsl->bhl", p, ck), den

    num, den = flash_merge_split(sp, q_lat.map(part))
    if w.wuv.model_dim == 0:  # row-parallel: each device its kv_lora rows
        ctx = sp.to(num, sp.COLS)

        def values(c, m):
            wv = w.wuv[m].reshape(c.shape[-1], h, dv).float()
            return torch.einsum("bhl,lhv->bhv", c / torch.clamp(den.parts[m], min=1e-30)[..., None],
                                wv)
    else:
        ctx = sp.to(num, sp.FULL)

        def values(c, m):
            if not sp.rows[m]:
                return torch.zeros((b, h, dv), dtype=torch.float32, device=c.device)
            return torch.einsum("bhl,lhv->bhv", c / torch.clamp(den.parts[m], min=1e-30)[..., None],
                                w.wuv[m].reshape(lr, h, dv).float())
    out_h = sp.dist(sp.PARTIAL, ctx.map(lambda c, m: values(c, m).reshape(b, 1, h * dv)).parts)
    o = sp.to(out_h, sp.input_kind(w.wo)).map(lambda t, m: t.to(dtype))
    return sp.to(sp.mm(o, w.wo), sp.layout)
