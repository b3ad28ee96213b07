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

from repro_torch.models import common, split_lm


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


def rwkv6_time_mix(prm: RWKV6Params, x: torch.Tensor, cfg, state=None, sp=None):
    """x: (B,S,d).  state: (S0, x_prev) or None.  Returns (out, new_state).
    ``sp`` set: on a data group's `model` devices (``_time_mix_split``)."""
    if sp is not None:
        return _time_mix_split(sp, prm, x, cfg, state)
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


def rwkv6_channel_mix(prm: RWKV6Params, x: torch.Tensor, x_prev=None, sp=None):
    if sp is not None:
        return _channel_mix_split(sp, prm, x, x_prev)
    xs = _shift(x, x_prev)
    mk = _lerp(x, xs, prm.mu_ck)
    mr = _lerp(x, xs, prm.mu_cr)
    k = torch.square(F.relu(mk @ prm.ck))
    return torch.sigmoid(mr @ prm.cr) * (k @ prm.cv), x[:, -1, :]


# ---------------------------------------------------------------------------
# The split program: a data group's `model` devices, split by heads
# ---------------------------------------------------------------------------
#
# wr, wk, wv and wg are column-parallel (at width 2,048 / M columns are whole
# heads of 64), wo row-parallel; where a slice cuts a head (rwkv6's smoke
# config on M = 8), one regroup gives device m its heads'
# (``sp.heads(H)[m]``) columns.  The WKV scan and the group norm are per
# head, so local to a device.  The decay's LoRA (whole matrices) is taken
# by rows (``sp.mm`` of a whole weight) and all-gathered, its second factor
# and the whole vectors (w0, u, ln_scale, ln_bias) read at the device's
# heads.  In the channel mix ck and cr are column-parallel and cv
# row-parallel: sigmoid(mr @ cr) comes out by columns and k @ cv as partial
# sums, and both go to ``sp.layout`` before the product (an all-to-all and
# a reduce-scatter, or an all-gather and an all-reduce): the partials are
# added in ascending shard order, where one device's product adds f's terms
# inside one matmul.


def _shift_split(sp, x, x_prev=None):
    """``_shift`` of a ``FULL`` value (on each device) or of ``ROWS`` (the
    row before a device's first is the last row of the nearest device
    before it that holds rows: all-gathered).  ``x_prev``: one (B, d) a
    device (equal), or None (zeros)."""
    if x.kind == sp.FULL or sp.M == 1:
        return x.map(lambda t, m: _shift(t, None if x_prev is None else x_prev[m]))
    held = [min(1, r) for r in sp.rows]
    lasts = sp.gather(sp.dist(sp.ROWS, x.map(lambda t, m: t[:, t.shape[1] - held[m]:]).parts),
                      1, held)

    def shift(t, m):
        before = sum(held[:m])
        if before:
            pad = lasts.parts[m][:, before - 1]
        else:
            pad = None if x_prev is None else x_prev[m]
        return _shift(t, pad)

    return x.map(shift)


def _time_mix_split(sp, w, x, cfg, state=None):
    """``rwkv6_time_mix`` on a data group's `model` devices (``w`` the
    gathered fields, ``x`` and the output in ``sp.layout``; ``state``: (one
    (B, hn, dk, dv) a device, its heads' state, one whole (B, d) x_prev a
    device) or None).  Returns (the output, (each device's heads' new
    state, the new x_prev (B, d) ``FULL``))."""
    s0, x_prev = (None, None) if state is None else state
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    heads = sp.heads(d // hd)
    want = [[(h0 * hd, hn * hd)] for h0, hn in heads]
    if any(t.model_dim is not None for t in (w.wr, w.wk, w.wv, w.wg)):
        x = sp.to(x, sp.FULL)
    xs = _shift_split(sp, x, x_prev)

    def lerp(mu):
        return x.zip(xs, lambda a, b, m: _lerp(a, b, mu[m]))

    def heads_of(t, wt):
        return sp.cols(sp.mm(t, wt), d, want)

    r = heads_of(lerp(w.mu_r), w.wr).map(lambda t, m: t.float())
    k = heads_of(lerp(w.mu_k), w.wk).map(lambda t, m: t.float())
    v = heads_of(lerp(w.mu_v), w.wv).map(lambda t, m: t.float())
    g = heads_of(lerp(w.mu_g), w.wg).map(lambda t, m: F.silu(t))
    lora = sp.to(sp.mm(lerp(w.mu_w).map(lambda t, m: t.float()), w.w_lora_a)
                 .map(lambda t, m: torch.tanh(t)), sp.FULL)

    def wkv(t, m):
        h0, hn = heads[m]
        c0, c1 = h0 * hd, (h0 + hn) * hd
        decay = torch.exp(-torch.clamp(torch.exp(w.w0[m][c0:c1] + t @ w.w_lora_b[m][:, c0:c1]),
                                       max=MAX_LOG_DECAY))
        rm, km, vm = r.parts[m], k.parts[m], v.parts[m]
        if hn == 0:
            b = rm.shape[0]
            return (g.parts[m], torch.zeros((b, 0, hd, hd), dtype=torch.float32,
                                            device=rm.device))
        init = None if s0 is None else s0[m]
        if rm.shape[1] > 1 and rm.shape[1] % WKV_CHUNK == 0:
            y, s_new = _wkv_chunked(rm, km, vm, decay, w.u[m][c0:c1], hd, init)
        else:
            y, s_new = _wkv_scan(rm, km, vm, decay, w.u[m][c0:c1], hd, init)
        y = _group_norm(y.to(g.parts[m].dtype), w.ln_scale[m][c0:c1], w.ln_bias[m][c0:c1], hn,
                        cfg.norm_eps)
        return y * g.parts[m], s_new

    both = lora.map(wkv)
    y = sp.to_input(sp.dist(sp.HEADS, both.map(lambda t, m: t[0]).parts), d,
                    [c[0] for c in want], w.wo)
    return (sp.to(sp.mm(y, w.wo), sp.layout),
            (both.map(lambda t, m: t[1]), split_lm.last(sp, x).map(lambda t, m: t[:, 0])))


def _channel_mix_split(sp, w, x, x_prev=None):
    """``rwkv6_channel_mix`` on a data group's `model` devices (see the
    section's note).  Returns (the output in ``sp.layout``, the new x_prev
    (B, d) ``FULL``)."""
    layout = x.kind
    if w.ck.model_dim is not None or w.cr.model_dim is not None:
        x = sp.to(x, sp.FULL)
    xs = _shift_split(sp, x, x_prev)
    mk = x.zip(xs, lambda a, b, m: _lerp(a, b, w.mu_ck[m]))
    mr = x.zip(xs, lambda a, b, m: _lerp(a, b, w.mu_cr[m]))
    kv = sp.mm(sp.mm(mk, w.ck).map(lambda t, m: torch.square(F.relu(t))), w.cv)
    rr = sp.mm(mr, w.cr).map(lambda t, m: torch.sigmoid(t))
    out = sp.to(rr, layout).zip(sp.to(kv, layout), lambda a, b, m: a * b)
    return out, split_lm.last(sp, x).map(lambda t, m: t[:, 0])
