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
    cb_all: torch.Tensor | None = None,  # (B, nc, Q, Q) C B^T of every chunk
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P) float32, final_state (B,H,P,N) float32).
    ``cb_all``: the chunks' C B^T computed elsewhere (the split program's,
    shared by every head), else each chunk's here."""
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
        # (B,Q,Q) shared across heads
        cb = torch.einsum("bqn,bjn->bqj", cq, bq) if cb_all is None else cb_all[:, c]
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
    sp=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence forward.

    Returns (out (B,S,d), final ssm state (B,H,P,N) float32, conv tail
    (B, W-1, conv_dim)) — the latter two seed the decode cache.  ``sp``
    set: on a data group's `model` devices (``_forward_split``).
    """
    if sp is not None:
        return _forward_split(sp, prm, x, cfg)
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
    sp=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrent step.  Returns (out, ssm_state, conv_state),
    new tensors (the inputs are read, not written).  ``sp`` set: on a data
    group's `model` devices (``_decode_split``)."""
    if sp is not None:
        return _decode_split(sp, prm, x, ssm_state, conv_state, cfg)
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


# ---------------------------------------------------------------------------
# The split program: a data group's `model` devices, split by heads
# ---------------------------------------------------------------------------
#
# in_proj is column-parallel over [z | x | B | C | dt], whose slices line up
# with neither heads nor segments: the product is taken by the spec's slice
# (one device's dot FLOPs), then one regroup gives device m the whole
# sequence with z, x and dt of its heads (``sp.heads(H)[m]``) and the whole
# B and C (one group: every head reads them).  The depthwise conv is per
# channel; the SSD scan per head, on the whole sequence; C B^T, which every
# head shares, is computed a chunk range a device and all-gathered.  The
# gated RMSNorm spans d_inner: each device's float32 sums of squares are
# all-reduced in shard order.  out_proj is row-parallel (its rows line up
# with heads where M divides H), its partials reduce-scattered into
# ``sp.layout``.  The whole vectors (a_log, d_skip, dt_bias, norm, conv_w,
# conv_b) are read at the device's heads or channels.


def _own_cols(cfg, h0: int, hn: int) -> list:
    """in_proj's columns device computing heads h0 .. h0 + hn - 1 takes:
    its z, its x, B and C, its dt."""
    di, _, _ = dims(cfg)
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    return [(h0 * p, hn * p), (di + h0 * p, hn * p), (2 * di, 2 * n), (2 * di + 2 * n + h0, hn)]


def _take(t: torch.Tensor, cols: list) -> torch.Tensor:
    """The column ranges ``cols`` of ``t``'s last dim, concatenated."""
    return torch.cat([t[..., c0:c0 + cn] for c0, cn in cols], dim=-1)


def _gated_norm(sp, g, w, heads, p: int, di: int, eps: float):
    """``rms_norm`` over d_inner of ``g`` (device m its heads' columns):
    the float32 sums of squares all-reduced in shard order."""
    ss = g.map(lambda t, m: torch.sum(torch.square(t.float()), dim=-1, keepdim=True))
    total = sp.to(sp.dist(sp.PARTIAL, ss.parts), sp.FULL)

    def norm(t, m):
        h0, hn = heads[m]
        y = t.float() * torch.rsqrt(total.parts[m] / di + eps)
        return (y * (1.0 + w[m][h0 * p:(h0 + hn) * p].float())).to(t.dtype)

    return g.map(norm)


def _heads_out(sp, g, w, heads, p: int, di: int):
    """out_proj of ``g`` (device m its heads' columns) into ``sp.layout``."""
    y = sp.to_input(g, di, [(h0 * p, hn * p) for h0, hn in heads], w)
    return sp.to(sp.mm(y, w), sp.layout)


def _forward_split(sp, w, x, cfg):
    """``mamba2_forward`` on a data group's `model` devices (``w`` the
    gathered fields, ``x`` and the output in ``sp.layout``).  Returns (the
    output, each device's heads' final state (B, hn, P, N) float32, the
    whole conv tail (B, W - 1, conv_dim) equal on every device)."""
    di, h, conv_dim = dims(cfg)
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    heads = sp.heads(h)
    u = sp.cols(sp.mm(x, w.in_proj), 2 * di + 2 * n + h, [_own_cols(cfg, *hh) for hh in heads])
    b, s = u.parts[sp.root].shape[:2]
    parts = u.map(lambda t, m: torch.split(t, [heads[m][1] * p, heads[m][1] * p + 2 * n,
                                               heads[m][1]], dim=-1))

    def conv(zxd, m):
        cols = [(heads[m][0] * p, heads[m][1] * p), (di, 2 * n)]
        return F.silu(_causal_conv(zxd[1], _take(w.conv_w[m], cols), _take(w.conv_b[m], cols)))

    xbc = parts.map(conv)
    q = ssd_chunk(s, cfg.ssm_chunk)
    nc = s // q
    chunks = sp.heads(nc)

    def cb(t, m):  # C B^T of the device's chunks
        c0, cn = chunks[m]
        bm = t[..., -2 * n:-n].reshape(b, nc, q, n)[:, c0:c0 + cn].float()
        cm = t[..., -n:].reshape(b, nc, q, n)[:, c0:c0 + cn].float()
        return torch.einsum("bcqn,bcjn->bcqj", cm, bm)

    cb_all = sp.to(sp.dist(sp.ROWS, xbc.map(cb).parts), sp.FULL, sizes=[c for _, c in chunks])

    def scan(t, m):
        h0, hn = heads[m]
        z, _, dt = parts.parts[m]
        xin, bmat, cmat = torch.split(t, [hn * p, n, n], dim=-1)
        xh = xin.reshape(b, s, hn, p)
        dt = F.softplus(dt.float() + w.dt_bias[m][h0:h0 + hn])
        y, state = _ssd_chunked(xh, dt, -torch.exp(w.a_log[m][h0:h0 + hn]), bmat, cmat,
                                cfg.ssm_chunk, cb_all=cb_all.parts[m])
        y = y + xh.float() * w.d_skip[m][h0:h0 + hn][None, None, :, None]
        return y.reshape(b, s, hn * p).to(z.dtype) * F.silu(z), state

    both = xbc.map(scan)
    g = sp.dist(sp.HEADS, both.map(lambda t, m: t[0]).parts)
    g = _gated_norm(sp, g, w.norm, heads, p, di, cfg.norm_eps)
    out = _heads_out(sp, g, w.out_proj, heads, p, di)
    tail = cfg.ssm_conv_width - 1
    own = sp.dist(sp.COLS, parts.map(lambda t, m: t[1][:, -tail:, :heads[m][1] * p]).parts)
    xt = sp.gather(own, -1, [hn * p for _, hn in heads])
    conv_tail = xt.map(lambda t, m: torch.cat([t, parts.parts[m][1][:, -tail:, -2 * n:]], -1))
    return out, both.map(lambda t, m: t[1]), conv_tail


def _decode_split(sp, w, x, ssm_state: list, conv_state: list, cfg):
    """``mamba2_decode`` on a data group's `model` devices (``x`` and the
    output ``FULL``; ``ssm_state[m]`` device m's heads' state, ``conv_state[m]``
    the whole tail): the in_proj row all-gathered to every device, the conv
    a chunk of channels a device (its product computed once in the group)
    all-gathered, the scan per head.  Returns (the output, each device's
    heads' new state, the whole new conv tail equal on every device)."""
    di, h, conv_dim = dims(cfg)
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    heads, chans = sp.heads(h), sp.heads(conv_dim)
    u = sp.to(sp.mm(x, w.in_proj), sp.FULL)  # (B, 1, 2di + 2N + H) on every device
    hist = u.map(lambda t, m: torch.cat([conv_state[m], t[:, :, di:2 * di + 2 * n]], dim=1))

    def conv(t, m):
        c0, cn = chans[m]
        return F.silu(torch.einsum("bwc,wc->bc", t[..., c0:c0 + cn], w.conv_w[m][:, c0:c0 + cn])
                      + w.conv_b[m][c0:c0 + cn])[:, None]

    xbc = sp.gather(sp.dist(sp.COLS, hist.map(conv).parts), -1, [c for _, c in chans])
    b = u.parts[sp.root].shape[0]

    def step(t, m):
        h0, hn = heads[m]
        row = u.parts[m][:, 0]
        z, dt = row[:, h0 * p:(h0 + hn) * p], row[:, 2 * di + 2 * n + h0:2 * di + 2 * n + h0 + hn]
        xh = t[:, 0, h0 * p:(h0 + hn) * p].reshape(b, hn, p).float()
        bvec, cvec = t[:, 0, di:di + n].float(), t[:, 0, di + n:di + 2 * n].float()
        dt = F.softplus(dt.float() + w.dt_bias[m][h0:h0 + hn])
        decay = torch.exp(dt * (-torch.exp(w.a_log[m][h0:h0 + hn]))[None, :])
        state = ssm_state[m] * decay[:, :, None, None] + (
            (dt[:, :, None] * xh)[..., None] * bvec[:, None, None, :])
        y = torch.einsum("bhpn,bn->bhp", state, cvec)
        y = y + xh * w.d_skip[m][h0:h0 + hn][None, :, None]
        y = y.reshape(b, 1, hn * p).to(z.dtype)
        return y * F.silu(z)[:, None], state

    both = xbc.map(step)
    g = sp.dist(sp.HEADS, both.map(lambda t, m: t[0]).parts)
    g = _gated_norm(sp, g, w.norm, heads, p, di, cfg.norm_eps)
    return (_heads_out(sp, g, w.out_proj, heads, p, di), both.map(lambda t, m: t[1]),
            hist.map(lambda t, m: t[:, 1:]))
