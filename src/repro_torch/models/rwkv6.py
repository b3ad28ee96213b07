"""RWKV-6 "Finch" block (arXiv:2404.05892) — the port of
``repro.models.rwkv6``: attention-free linear recurrence with
data-dependent per-channel decay.

Faithful parts: the WKV6 recurrence S <- diag(w_t) S + k_t v_t^T with
bonus u, data-dependent decay w_t = exp(-exp(w0 + tanh(m @ A) B)), token
shift, per-head group norm, squared-ReLU channel mixing.  The reference's
simplification is kept (DESIGN.md): token-shift interpolation uses static
per-channel mu (RWKV-5 style) instead of the full 5-way ddlerp LoRA.

The WKV streams are float32 throughout (no bfloat16 variant: the
reference's was refuted), and on the card the chunked form's products
refuse to run with TF32 on: its e^{+cum} factors reach e^64.  ``mu_*``,
``w0``, ``w_lora_*``, ``u`` and ``ln_*`` are float32 in every model dtype.

State per layer: (S (B,H,D,D) float32, x_prev_att (B,d), x_prev_ffn
(B,d)) — O(1) in sequence length.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common


class RWKV6Params(nn.Module):
    """Time mixing: mu_r/k/v/g/w (d,), w0 (d,) base decay, w_lora_a (d, 64),
    w_lora_b (64, d), wr/wk/wv/wg/wo (d, d), u (d,) per-channel bonus,
    ln_scale/ln_bias (d,) per-head group norm.  Channel mixing: mu_ck/mu_cr
    (d,), ck (d, d_ff), cv (d_ff, d), cr (d, d)."""

    NAMEDTUPLE = True  # a NamedTuple in the JAX package
    FIELDS = ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w0", "w_lora_a", "w_lora_b",
              "wr", "wk", "wv", "wg", "wo", "u", "ln_scale", "ln_bias",
              "mu_ck", "mu_cr", "ck", "cv", "cr")

    def __init__(self, cfg, dtype, *, device, generator=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        init = dict(generator=generator, device=device)
        f32 = torch.float32
        for name in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
            setattr(self, name, nn.Parameter(common.uniform_init((d,), 0.0, 1.0, **init)))
        self.w0 = common.const_param((d,), -2.0, f32, device)
        self.w_lora_a = nn.Parameter(common.dense_init((d, 64), f32, **init))
        self.w_lora_b = common.const_param((64, d), 0.0, f32, device)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, nn.Parameter(common.dense_init((d, d), dtype, **init)))
        self.u = common.const_param((d,), 0.0, f32, device)
        self.ln_scale = common.const_param((d,), 1.0, f32, device)
        self.ln_bias = common.const_param((d,), 0.0, f32, device)
        self.mu_ck = nn.Parameter(common.uniform_init((d,), 0.0, 1.0, **init))
        self.mu_cr = nn.Parameter(common.uniform_init((d,), 0.0, 1.0, **init))
        self.ck = nn.Parameter(common.dense_init((d, f), dtype, **init))
        self.cv = nn.Parameter(common.dense_init((f, d), dtype, **init))
        self.cr = nn.Parameter(common.dense_init((d, d), dtype, **init))


def _shift(x: torch.Tensor, x_prev: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift: x_prev feeds position 0 (zeros at sequence start)."""
    pad = torch.zeros_like(x[:, :1]) if x_prev is None else x_prev[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _lerp(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


MAX_LOG_DECAY = 4.0  # per-step |log w| cap: keeps the chunked form's
# exp(+cum) factors inside fp32 range (chunk 16 x 4.0 = 64 < log(f32max)≈88)
# while w >= e^-4 ≈ 0.018/step.  The cap is part of the model definition,
# so the scan and chunked paths are consistent.
WKV_CHUNK = 16  # the chunked form's chunk: S > 1 and S % 16 == 0 take it


def _decay(prm: RWKV6Params, mw: torch.Tensor) -> torch.Tensor:
    """Data-dependent decay in (0,1): exp(-exp(w0 + tanh(m A) B))."""
    lora = torch.tanh(mw.float() @ prm.w_lora_a) @ prm.w_lora_b
    return torch.exp(-torch.clamp(torch.exp(prm.w0 + lora), max=MAX_LOG_DECAY))


def _group_norm(y: torch.Tensor, scale, bias, n_heads: int, eps: float) -> torch.Tensor:
    b, s, d = y.shape
    yh = y.reshape(b, s, n_heads, d // n_heads).float()
    mu_ = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, unbiased=False)  # the population variance
    yh = (yh - mu_) * torch.rsqrt(var + eps)
    return (yh.reshape(b, s, d) * scale + bias).to(y.dtype)


def _wkv_scan(r, k, v, w, u, hd: int, s0=None):
    """The WKV6 recurrence.  r/k/v/w: (B, S, d) fp32.  Returns (y, S_final).

    Per head: y_t = r_t^T (S + diag(u) k_t v_t^T);  S <- diag(w_t) S + k_t v_t^T
    """
    b, s, d = r.shape
    h = d // hd
    rh, kh, vh, wh = (t.reshape(b, s, h, hd) for t in (r, k, v, w))
    uh = u.reshape(h, hd)
    state = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
             if s0 is None else s0)
    ys = []
    for t in range(s):
        rt, kt, vt, wt = rh[:, t], kh[:, t], vh[:, t], wh[:, t]  # (B,H,hd)
        kv = kt[..., :, None] * vt[..., None, :]  # (B,H,hd,hd)
        ys.append(torch.einsum("bhi,bhij->bhj", rt, state + uh[None, :, :, None] * kv))
        state = wt[..., :, None] * state + kv
    return torch.stack(ys, dim=1).reshape(b, s, d), state


def _no_tf32(t: torch.Tensor) -> None:
    """The chunked form's float32 products carry e^{+cum} factors up to
    e^64: on the card they must not run in TF32."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "RWKV-6's chunked WKV needs full float32 products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False "
            "(torch.set_float32_matmul_precision('highest'))")


def _wkv_chunked(r, k, v, w, u, hd: int, s0=None, chunk: int = WKV_CHUNK):
    """Chunk-parallel WKV6 (GLA-style), equal to ``_wkv_scan`` up to float32
    rounding.  Within a chunk (length C, relative to chunk start; cum =
    cumulative log-decay, cum[-1] := 0):

        A[t, j] = sum_c r[t,c] e^{cum[t-1,c]} * k[j,c] e^{-cum[j,c]}   (j < t)
        A[t, t] = sum_c r[t,c] u[c] k[t,c]                             (bonus)
        y       = A @ v + (r ⊙ e^{cum_prev}) S_0
        S_end   = diag(e^{cum_end}) S_0 + (k ⊙ e^{cum_end - cum})^T v

    e^{+cum} stays bounded because per-step log-decay is capped at
    MAX_LOG_DECAY and C * MAX_LOG_DECAY < log(f32_max).  A sequence that
    is not a whole number of chunks takes ``_wkv_scan``, as the reference.
    """
    b, s, d = r.shape
    if s % chunk:
        return _wkv_scan(r, k, v, w, u, hd, s0)
    _no_tf32(r)
    h = d // hd
    nc = s // chunk
    c = chunk

    def to_chunks(x):  # (B,S,d) -> (nc, B, H, C, hd)
        return x.reshape(b, nc, c, h, hd).permute(1, 0, 3, 2, 4)

    rh, kh, vh = to_chunks(r), to_chunks(k), to_chunks(v)
    logw = torch.log(to_chunks(w))  # (nc, B, H, C, hd), entries in [-MAX, 0)
    uh = u.reshape(h, hd)

    cum = torch.cumsum(logw, dim=3)  # inclusive cumulative log-decay
    cum_prev = cum - logw  # exclusive (cum[t-1], with cum[-1] = 0)
    cum_end = cum[:, :, :, -1:, :]  # (nc, B, H, 1, hd)

    r_in = rh * torch.exp(cum_prev)  # bounded <= |r|
    k_in = kh * torch.exp(-cum)  # bounded by exp(C * MAX_LOG_DECAY)
    k_out = kh * torch.exp(cum_end - cum)  # bounded <= |k|

    # intra-chunk attention with strict lower-triangular mask + u diagonal
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), diagonal=-1)
    a_intra = torch.einsum("nbhtc,nbhjc->nbhtj", r_in, k_in)
    a_intra = torch.where(tri, a_intra, 0.0)
    diag = torch.einsum("nbhtc,nbhtc->nbht", rh, kh * uh[None, None, :, None, :])
    y_intra = torch.einsum("nbhtj,nbhjc->nbhtc", a_intra, vh)
    y_intra = y_intra + diag[..., None] * vh

    state = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
             if s0 is None else s0)
    y_off = []
    for i in range(nc):
        y_off.append(torch.einsum("bhtc,bhcd->bhtd", r_in[i], state))
        state = torch.exp(cum_end[i][:, :, 0])[:, :, :, None] * state + torch.einsum(
            "bhtc,bhtd->bhcd", k_out[i], vh[i])
    y = y_intra + torch.stack(y_off)  # (nc, B, H, C, hd)
    y = y.permute(1, 0, 3, 2, 4).reshape(b, s, d)
    return y, state


def rwkv6_time_mix(prm: RWKV6Params, x: torch.Tensor, cfg, state=None):
    """x: (B,S,d).  state: (S0, x_prev) or None.  Returns (out, new_state)."""
    s0, x_prev = (None, None) if state is None else state
    xs = _shift(x, x_prev)
    mr, mk, mv, mg, mw = (_lerp(x, xs, prm.mu_r), _lerp(x, xs, prm.mu_k),
                          _lerp(x, xs, prm.mu_v), _lerp(x, xs, prm.mu_g),
                          _lerp(x, xs, prm.mu_w))
    r = (mr @ prm.wr).float()
    k = (mk @ prm.wk).float()
    v = (mv @ prm.wv).float()
    g = F.silu(mg @ prm.wg)
    w = _decay(prm, mw)  # (B,S,d) in (0,1)
    if x.shape[1] > 1 and x.shape[1] % WKV_CHUNK == 0:
        y, s_new = _wkv_chunked(r, k, v, w, prm.u, cfg.rwkv_head_dim, s0)
    else:
        y, s_new = _wkv_scan(r, k, v, w, prm.u, cfg.rwkv_head_dim, s0)
    y = _group_norm(y.to(x.dtype), prm.ln_scale, prm.ln_bias,
                    cfg.d_model // cfg.rwkv_head_dim, cfg.norm_eps)
    return (y * g) @ prm.wo, (s_new, x[:, -1, :])


def rwkv6_channel_mix(prm: RWKV6Params, x: torch.Tensor, x_prev=None):
    xs = _shift(x, x_prev)
    mk = _lerp(x, xs, prm.mu_ck)
    mr = _lerp(x, xs, prm.mu_cr)
    k = torch.square(F.relu(mk @ prm.ck))
    return torch.sigmoid(mr @ prm.cr) * (k @ prm.cv), x[:, -1, :]
