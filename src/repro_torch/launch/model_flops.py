"""Analytic MODEL_FLOPS per (arch x shape) cell — the port of
``repro.launch.model_flops``, counting the parameters of the port's
meta-device stand-ins in the JAX package's stacked layout (so every count
equals the reference's).

MODEL_FLOPS = 6*N*D for dense training (N = active non-embedding params,
D = tokens), 6*N_active*D for MoE, plus the attention quadratic term
(causal: S/2 average context; windowed: min(S, W)); forward-only cells
(prefill) use 2*N*D; decode cells use 2*N per token plus the KV-cache
attention term.
"""

from __future__ import annotations

import numpy as np

from repro_torch.config import ModelConfig, ShapeCell
from repro_torch.models.common import layout_leaves, layout_shape


def _leaf_shapes(bundle):
    """(key, shape) of every parameter leaf of the bundle's model in the
    JAX layout."""
    for path, leaf in layout_leaves(bundle.params_shape().jax_layout()):
        yield "/".join(path), layout_shape(leaf)


def _param_counts(bundle) -> tuple[float, float]:
    """(total_params, embedding_params) from the shape stand-ins."""
    total = 0.0
    embed = 0.0
    for key, shape in _leaf_shapes(bundle):
        n = float(np.prod(shape))
        total += n
        if "embed" in key or "lm_head" in key:
            embed += n
    return total, embed


def active_params(cfg: ModelConfig, bundle) -> float:
    """Non-embedding params active per token (MoE: top_k+shared of E)."""
    total, embed = _param_counts(bundle)
    body = total - embed
    if not cfg.is_moe:
        return body
    # split expert weights from the rest, scale by activation fraction (a
    # stacked leaf with an axis of length E counts, as in the reference)
    expert = 0.0
    for _key, shape in _leaf_shapes(bundle):
        if len(shape) >= 3 and cfg.n_experts in shape:
            expert += float(np.prod(shape))
    frac = cfg.moe_top_k / cfg.n_experts
    return (body - expert) + expert * frac


def _mamba2_heads(cfg: ModelConfig) -> int:
    """Mamba2 heads (``repro.models.mamba2.dims``: expand*d / head_dim)."""
    return (cfg.ssm_expand * cfg.d_model) // cfg.ssm_head_dim


def _window_of(cfg: ModelConfig, i: int) -> int:
    if cfg.local_global_period > 0 and cfg.sliding_window > 0:
        return 0 if (i + 1) % cfg.local_global_period == 0 else cfg.sliding_window
    return cfg.sliding_window


def _attn_flops_per_seq(cfg: ModelConfig, s: int, fwd_mult: float) -> float:
    """QK^T + AV flops for one sequence across all layers."""
    if cfg.family == "ssm":
        # rwkv: state update per token: H * hd * hd * ~4 ops
        h = cfg.d_model // max(1, cfg.rwkv_head_dim)
        return fwd_mult * cfg.n_layers * s * h * cfg.rwkv_head_dim**2 * 4
    if cfg.family == "hybrid":
        # mamba layers: per token H*P*N*~6 state ops; shared attn every period
        heads = _mamba2_heads(cfg)
        ssm = fwd_mult * cfg.n_layers * s * heads * cfg.ssm_head_dim * cfg.ssm_state * 6
        n_attn = cfg.n_layers // max(1, cfg.shared_attn_period)
        attn = fwd_mult * n_attn * 2 * 2 * (s * s / 2) * cfg.n_heads * cfg.resolved_head_dim
        return ssm + attn
    hd = cfg.v_head_dim if cfg.use_mla else cfg.resolved_head_dim
    qk_hd = (cfg.qk_nope_dim + cfg.qk_rope_dim) if cfg.use_mla else cfg.resolved_head_dim
    per_layer_ctx = []
    for i in range(cfg.n_layers):
        w = _window_of(cfg, i)
        # average attended context per query under causal (+ window) mask
        ctx = min(w, s / 2) if (w and w > 0) else s / 2
        per_layer_ctx.append(ctx)
    total_ctx = sum(per_layer_ctx)
    # 2 matmuls (QK, AV) x 2 flops x S queries x ctx keys x H x hd
    return fwd_mult * 2 * 2 * s * total_ctx * cfg.n_heads * (qk_hd + hd) / 2


def model_flops(cfg: ModelConfig, cell: ShapeCell, bundle) -> float:
    """Useful model FLOPs for one step of this cell (whole cluster)."""
    n_act = active_params(cfg, bundle)
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        fwd_mult = 6.0  # fwd 2N + bwd 4N
        if cfg.is_encoder_decoder:
            s_dec = max(64, s // 8)
            tokens = b * (s + s_dec) / 2  # rough enc+dec split
        else:
            tokens = b * s
        return fwd_mult * n_act * tokens + b * _attn_flops_per_seq(cfg, s, 3.0)
    if cell.kind == "prefill":
        tokens = b * s
        return 2.0 * n_act * tokens + b * _attn_flops_per_seq(cfg, s, 1.0)
    # decode: one token, full cache attended
    hd = cfg.kv_lora_rank if cfg.use_mla else cfg.resolved_head_dim
    if cfg.family == "ssm":
        h = cfg.d_model // max(1, cfg.rwkv_head_dim)
        attn = cfg.n_layers * h * cfg.rwkv_head_dim**2 * 4
    elif cfg.family == "hybrid":
        heads = _mamba2_heads(cfg)
        attn = cfg.n_layers * heads * cfg.ssm_head_dim * cfg.ssm_state * 6
        attn += (cfg.n_layers // max(1, cfg.shared_attn_period)) * 2 * 2 * s * \
            cfg.n_heads * cfg.resolved_head_dim
    else:
        per_layer = []
        for i in range(cfg.n_layers):
            w = _window_of(cfg, i)
            ctx = min(w, s) if (w and w > 0) else s
            per_layer.append(ctx)
        attn = 2 * 2 * sum(per_layer) * cfg.n_heads * hd
    return b * (2.0 * n_act + attn)
