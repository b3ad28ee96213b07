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
    ``sp`` set: on a data group's `model` devices (``_mla_split``; no cache
    entry).
    """
    if sp is not None:
        return _mla_split(sp, p, x, cfg, positions, flash_blk=flash_blk), None
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
    is split by query rows (each device's sequence chunk, every head)."""
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
    k_rope = sp.to(sp.mm(x, w.wkr), sp.FULL)

    def core(qm, m):
        r0, n = sp.row_start[m], qm.shape[1]
        pos = positions[m][None, :]
        qm = qm.reshape(b, n, h, dn + dr)
        q_rope = common.apply_rope(qm[..., dn:], pos[:, r0:r0 + n], cfg.rope_theta)
        qm = torch.cat([qm[..., :dn], q_rope], dim=-1)
        kr = common.apply_rope(k_rope.parts[m][:, :, None, :], pos, cfg.rope_theta)
        km = torch.cat([k_nope.parts[m].reshape(b, s, h, dn), kr.expand(b, s, h, dr)], dim=-1)
        out = flash_attention(qm, km, v.parts[m].reshape(b, s, h, dv), causal=True, window=0,
                              blk=flash_blk, q_start=r0)
        return out.reshape(b, n, h * dv)

    return sp.to(sp.mm(q.map(core), w.wo), sp.layout)


def mla_decode(
    p: MLAParams,
    x: torch.Tensor,  # (B, 1, d)
    ckv_cache: torch.Tensor,  # (B, S, kv_lora) — rms-normed compressed kv
    kr_cache: torch.Tensor,  # (B, S, rope)
    pos: int,
    cfg,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Weight-absorbed decode: scores and context live in the latent space.

    score_h(t) = q_nope_h^T Wuk_h ckv_t + q_rope^T kr_t
    ctx_h      = sum_t p_t ckv_t          (B, H, kv_lora)
    out        = concat_h(ctx_h Wuv_h) Wo
    """
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
