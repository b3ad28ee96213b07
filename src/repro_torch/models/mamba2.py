"""Mamba-2 (SSD) block — the port of ``repro.models.mamba2``: a chunked
parallel scan for prefill, an O(1) recurrent state for decode.

The SSD minimal formulation (Dao & Gu 2024, arXiv:2405.21060, Listing 1)
in torch ops.  The chunk loop is a Python loop carrying the (B, H, P, N)
float32 inter-chunk state where the JAX package ``lax.scan``s, so the
(Q x Q) intra-chunk decay matrix is the only quadratic-in-chunk temp
(Q = cfg.ssm_chunk).  Every scan product is float32; the reference's
4-operand einsum is written as explicit products.  Single group
(n_groups=1): B and C are shared across heads.

``a_log``, ``d_skip`` and ``dt_bias`` are float32 in every model dtype.
The intra-chunk decay masks its exponent before the exp (the reference
masks after it, and at chunk 128 its backward overflows to NaN); the
forward's bits are the reference formula's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common


class Mamba2Params(nn.Module):
    """in_proj (d, 2*di + 2*N + H), conv_w (W, conv_dim) depthwise causal
    conv, conv_b (conv_dim,), a_log/d_skip/dt_bias (H,) float32, norm (di,)
    gated RMSNorm scale, out_proj (di, d)."""

    NAMEDTUPLE = True  # a NamedTuple in the JAX package
    FIELDS = ("in_proj", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias", "norm",
              "out_proj")

    def __init__(self, cfg, dtype, *, device, generator=None):
        super().__init__()
        di, h, conv_dim = dims(cfg)
        init = dict(generator=generator, device=device)
        self.in_proj = nn.Parameter(common.dense_init(
            (cfg.d_model, 2 * di + 2 * cfg.ssm_state + h), dtype, **init))
        self.conv_w = nn.Parameter(common.dense_init((cfg.ssm_conv_width, conv_dim), dtype,
                                                     **init))
        self.conv_b = common.const_param((conv_dim,), 0.0, dtype, device)
        a = common.uniform_init((h,), 1.0, 16.0, **init)
        self.a_log = nn.Parameter(torch.log(a))
        self.d_skip = common.const_param((h,), 1.0, torch.float32, device)
        # inverse softplus of U(1e-3, 0.1)
        dt = common.uniform_init((h,), 1e-3, 0.1, **init)
        self.dt_bias = nn.Parameter(torch.log(torch.expm1(dt)))
        self.norm = common.const_param((di,), 0.0, dtype, device)
        self.out_proj = nn.Parameter(common.dense_init((di, cfg.d_model), dtype, **init))


def dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    heads = di // cfg.ssm_head_dim
    conv_dim = di + 2 * cfg.ssm_state
    return di, heads, conv_dim


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via explicit shifts (width is small).

    x: (B, S, C), w: (W, C) -> (B, S, C).
    """
    wsize = w.shape[0]
    out = x * w[-1]
    for i in range(1, wsize):
        shifted = F.pad(x, (0, 0, i, 0))[:, : x.shape[1]]
        out = out + shifted * w[-1 - i]
    return out + b


def ssd_chunk(s: int, chunk: int) -> int:
    """The chunk ``_ssd_chunked`` takes for ``s`` positions: ``chunk`` when
    it divides ``s``, else the largest divisor of ``s`` below it (exactness
    over speed, as the reference; no ragged last chunk)."""
    if s % chunk:
        chunk = next(c for c in range(min(chunk, s), 0, -1) if s % c == 0)
    return chunk


def _intra_decay(cs: torch.Tensor, tri: torch.Tensor) -> torch.Tensor:
    """L[i, j] = exp(cs_i - cs_j) for i >= j, else 0 (per head): cs (B, Q,
    H) -> (B, Q, Q, H).  The exponent is masked before the exp: above the
    diagonal it is positive and overflows at chunk 128, where the
    reference's exp-then-mask backward is 0 * inf = NaN; exp(-inf) = 0
    keeps the forward's bits."""
    li = cs[:, :, None, :] - cs[:, None, :, :]
    return torch.exp(torch.where(tri[None, :, :, None], li, -torch.inf))


def _ssd_chunked(
    xh: torch.Tensor,  # (B, S, H, P) inputs
    dt: torch.Tensor,  # (B, S, H) softplus'd step sizes
    a: torch.Tensor,  # (H,) negative decay rates (A = -exp(a_log))
    bmat: torch.Tensor,  # (B, S, N)
    cmat: torch.Tensor,  # (B, S, N)
    chunk: int,
    h0: torch.Tensor | None = None,  # (B, H, P, N) initial state
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P) float32, final_state (B,H,P,N) float32)."""
    b, s, h, p = xh.shape
    n = bmat.shape[-1]
    q = ssd_chunk(s, chunk)
    nc = s // q

    xc = xh.reshape(b, nc, q, h, p).float()
    dtc = dt.reshape(b, nc, q, h).float()
    bc = bmat.reshape(b, nc, q, n).float()
    cc = cmat.reshape(b, nc, q, n).float()
    ac = dtc * a[None, None, None, :]  # (B, nc, Q, H) log-decay increments

    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
             if h0 is None else h0.float())
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    ys = []
    for c in range(nc):
        xq, dq, bq, cq, aq = xc[:, c], dtc[:, c], bc[:, c], cc[:, c], ac[:, c]
        cs = torch.cumsum(aq, dim=1)  # (B,Q,H) running log-decay
        total = cs[:, -1]  # (B,H)

        lmat = _intra_decay(cs, tri)  # (B,Q,Q,H)
        cb = torch.einsum("bqn,bjn->bqj", cq, bq)  # (B,Q,Q) shared across heads
        # "bqj,bqjh,bjh,bjhp->bqhp" as explicit products
        m = cb[:, :, :, None] * lmat * dq[:, None, :, :]  # (B,Q,Q,H)
        y_diag = torch.einsum("bqjh,bjhp->bqhp", m, xq)

        # inter-chunk contribution from the carried state
        decay_in = torch.exp(cs)  # (B,Q,H)
        y_off = torch.einsum("bqn,bhpn->bqhp", cq, state) * decay_in[..., None]

        # end-of-chunk state
        decay_out = torch.exp(total[:, None, :] - cs)  # (B,Q,H)
        state = state * torch.exp(total)[:, :, None, None] + torch.einsum(
            "bqn,bqhp->bhpn", bq, (decay_out * dq)[..., None] * xq)
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y, state


def mamba2_forward(
    prm: Mamba2Params,
    x: torch.Tensor,  # (B, S, d)
    cfg,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence forward.

    Returns (out (B,S,d), final ssm state (B,H,P,N) float32, conv tail
    (B, W-1, conv_dim)) — the latter two seed the decode cache.
    """
    di, h, conv_dim = dims(cfg)
    n = cfg.ssm_state
    b, s, _ = x.shape

    zxbcdt = x @ prm.in_proj  # (B, S, 2di + 2N + H)
    z, xbc_raw, dt = torch.split(zxbcdt, [di, di + 2 * n, h], dim=-1)
    xbc = F.silu(_causal_conv(xbc_raw, prm.conv_w, prm.conv_b))
    xin, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)
    xh = xin.reshape(b, s, h, cfg.ssm_head_dim)
    dt = F.softplus(dt.float() + prm.dt_bias)  # (B,S,H)
    a = -torch.exp(prm.a_log)  # (H,)

    y, state = _ssd_chunked(xh, dt, a, bmat, cmat, cfg.ssm_chunk, h0)
    y = y + xh.float() * prm.d_skip[None, None, :, None]
    y = y.reshape(b, s, di).to(x.dtype)
    y = common.rms_norm(y * F.silu(z), prm.norm, cfg.norm_eps)
    conv_tail = xbc_raw[:, -(cfg.ssm_conv_width - 1):, :]
    return y @ prm.out_proj, state, conv_tail


def mamba2_decode(
    prm: Mamba2Params,
    x: torch.Tensor,  # (B, 1, d)
    ssm_state: torch.Tensor,  # (B, H, P, N) float32
    conv_state: torch.Tensor,  # (B, W-1, conv_dim)
    cfg,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrent step.  Returns (out, ssm_state, conv_state),
    new tensors (the inputs are read, not written)."""
    di, h, conv_dim = dims(cfg)
    n = cfg.ssm_state
    b = x.shape[0]
    p = cfg.ssm_head_dim

    zxbcdt = x[:, 0] @ prm.in_proj  # (B, 2di+2N+H)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * n, h], dim=-1)

    # conv over (conv_state ++ xbc)
    hist = torch.cat([conv_state, xbc[:, None, :]], dim=1)  # (B, W, C)
    xbc_c = F.silu(torch.einsum("bwc,wc->bc", hist, prm.conv_w) + prm.conv_b)
    conv_state = hist[:, 1:]

    xin, bvec, cvec = torch.split(xbc_c, [di, n, n], dim=-1)
    xh = xin.reshape(b, h, p).float()
    dt = F.softplus(dt.float() + prm.dt_bias)  # (B,H)
    decay = torch.exp(dt * (-torch.exp(prm.a_log))[None, :])  # (B,H)

    # "bh,bhp,bn->bhpn" as explicit products
    ssm_state = ssm_state * decay[:, :, None, None] + (
        (dt[:, :, None] * xh)[..., None] * bvec.float()[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", ssm_state, cvec.float())
    y = y + xh * prm.d_skip[None, :, None]
    y = y.reshape(b, di).to(x.dtype)
    y = common.rms_norm(y * F.silu(z), prm.norm, cfg.norm_eps)
    return (y @ prm.out_proj)[:, None, :], ssm_state, conv_state
