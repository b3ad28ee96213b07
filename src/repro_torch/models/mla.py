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
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Naive decompressed MLA for train/prefill.

    Returns (out, (ckv_normed, k_rope)) — the compressed-cache entries.
    """
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
