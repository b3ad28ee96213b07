"""Attention: GQA/MQA with RoPE, sliding windows, flash-style chunking.

The port of ``repro.models.attention`` as the same algorithms in torch
ops (no library attention kernel: its masking, softcap and window rules
and its numerics would not be the reference's):

  * ``flash_attention`` — train/prefill.  Python loops over query blocks
    and over the causal KV prefix with an online softmax; it falls back to
    ``full_attention`` unless ``S > blk`` and ``S % blk == 0``.
  * ``decode_attention`` — one new token against the KV cache.
  * ``full_attention`` — the short-sequence path.

Scores and softmax are float32; masked scores are ``-1e30``.  ``window``
(0 = none) and the logit softcap apply in every path.  Decode writes the
new token's k/v into the cache in place and returns the same tensors.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import common
from repro_torch.models.decode_opt import decode_partial, flash_merge_split

_NO_WINDOW = 2**30
_MASKED = -1e30


class AttnParams(nn.Module):
    """wq (d, H*D), wk/wv (d, KV*D), wo (H*D, d); q_norm/k_norm (D,) rms
    scales when ``qk_norm``, else None."""

    NAMEDTUPLE = True  # a NamedTuple in the JAX package
    FIELDS = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")

    def __init__(self, d_model: int, n_heads: int, n_kv: int, head_dim: int, dtype,
                 qk_norm: bool = False, *, device, generator=None):
        super().__init__()
        init = dict(generator=generator, device=device)
        self.wq = nn.Parameter(common.dense_init((d_model, n_heads * head_dim), dtype, **init))
        self.wk = nn.Parameter(common.dense_init((d_model, n_kv * head_dim), dtype, **init))
        self.wv = nn.Parameter(common.dense_init((d_model, n_kv * head_dim), dtype, **init))
        self.wo = nn.Parameter(common.dense_init((n_heads * head_dim, d_model), dtype, **init))
        for name in ("q_norm", "k_norm"):
            scale = torch.zeros((head_dim,), dtype=dtype, device=device)
            self.register_parameter(name, nn.Parameter(scale) if qk_norm else None)


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1)


def _gqa_expand(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, KV, G, D) where G = H // KV."""
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def _window_span(window) -> int:
    window = int(window)
    return window if window > 0 else _NO_WINDOW


# ---------------------------------------------------------------------------
# Full attention (short sequences / smoke)
# ---------------------------------------------------------------------------


def full_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Sk, KV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window=0,
    q_offset: int = 0,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    b, sq, h, d = q.shape
    dv = v.shape[-1]  # may differ from d (MLA)
    n_kv = k.shape[2]
    qq = _gqa_expand(q, n_kv) * (d ** -0.5)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qq.float(), k.float())
    scores = common.softcap(scores, logit_softcap)
    qi = torch.arange(sq, device=q.device)[:, None] + q_offset
    kj = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = kj > qi - _window_span(window)
    if causal:
        mask &= kj <= qi
    scores = torch.where(mask[None, None, None], scores, _MASKED)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, dv).to(q.dtype)


# ---------------------------------------------------------------------------
# Flash-style chunked attention (train / prefill)
# ---------------------------------------------------------------------------


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, KV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window=0,
    logit_softcap: float = 0.0,
    blk: int = 512,
    q_start: int | None = None,
    q_len: int | None = None,
) -> torch.Tensor:
    """``q_start`` set: ``q`` holds only the query rows ``q_start`` ..
    ``q_start + Sq - 1`` of a whole query of ``q_len`` rows (default ``k``'s
    S: a self-attention, as a causal one must be; a cross-attention's
    decoder rows over the encoder's) over ``k``'s S rows (one device's rows
    in the split program).  The path (whole or blocked) and every row's
    blocks of keys, in their order, are then those of the whole query."""
    b, sq, h, d = q.shape
    sk = k.shape[1]  # may differ from sq (cross-attention)
    n_kv = k.shape[2]
    if q_start is not None:
        q_len = sk if q_len is None else q_len
        if q_start + sq > q_len or (causal and q_len != sk):
            raise ValueError(f"query rows {q_start}..{q_start + sq} of a "
                             f"{'causal ' if causal else ''}attention of {q_len} rows "
                             f"over {sk}")
        if q_len <= blk or q_len % blk or sk % blk:
            return full_attention(q, k, v, causal=causal, window=window, q_offset=q_start,
                                  logit_softcap=logit_softcap)
        pieces = []  # the rows cut at block boundaries
        a = q_start
        while a < q_start + sq:
            e = min((a // blk + 1) * blk, q_start + sq)
            pieces.append((a, e))
            a = e
    else:
        if causal and sq != sk:
            raise ValueError(f"causal flash requires sq == sk, got {sq} vs {sk}")
        if sq <= blk or sq % blk or sk % blk:
            return full_attention(
                q, k, v, causal=causal, window=window, logit_softcap=logit_softcap
            )
        q_start = 0
        pieces = [(i * blk, (i + 1) * blk) for i in range(sq // blk)]
    dv = v.shape[-1]  # may differ from d (MLA)
    n_kv_blocks = sk // blk
    g = h // n_kv
    scale = d ** -0.5
    span = _window_span(window)

    # (B, Sq, KV, G, D) queries, (nb, B, blk, KV, D) key/value blocks; fp32 math inside
    qg = _gqa_expand(q, n_kv)
    kb = k.reshape(b, n_kv_blocks, blk, n_kv, d).transpose(0, 1)
    vb = v.reshape(b, n_kv_blocks, blk, n_kv, dv).transpose(0, 1)
    ar = torch.arange(blk, device=q.device)

    outs = []
    for a, e in pieces:
        n = e - a
        qi = (qg[:, a - q_start:e - q_start] * scale).float()  # (B, n, KV, G, D)
        q_pos = torch.arange(a, e, device=q.device)
        n_kv_chunks = (a // blk + 1) if causal else n_kv_blocks
        m = torch.full((b, n_kv, g, n), _MASKED, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, n_kv, g, n), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, n_kv, g, n, dv), dtype=torch.float32, device=q.device)
        for cid in range(n_kv_chunks):
            sc = torch.einsum("bqkgd,bskd->bkgqs", qi, kb[cid].float())
            sc = common.softcap(sc, logit_softcap)
            k_pos = cid * blk + ar
            mask = k_pos[None, :] > q_pos[:, None] - span
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            sc = torch.where(mask[None, None, None], sc, _MASKED)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vb[cid].float())
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, KV, G, n, Dv)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, n, h, dv))

    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode (single token, KV cache)
# ---------------------------------------------------------------------------


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k_cache: torch.Tensor,  # (B, S, KV, D)
    v_cache: torch.Tensor,
    pos: int,  # current position (number of valid cache entries - 1)
    *,
    window=0,
    logit_softcap: float = 0.0,
) -> torch.Tensor:
    b, _, h, d = q.shape
    n_kv = k_cache.shape[2]
    qq = _gqa_expand(q, n_kv)[:, 0] * (d ** -0.5)  # (B, KV, G, D)
    scores = torch.einsum("bkgd,bskd->bkgs", qq.float(), k_cache.float())
    scores = common.softcap(scores, logit_softcap)
    kj = torch.arange(k_cache.shape[1], device=q.device)
    mask = (kj <= pos) & (kj > pos - _window_span(window))
    scores = torch.where(mask[None, None, None], scores, _MASKED)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Block-level forward (projection + rope + attend + out-proj)
# ---------------------------------------------------------------------------


def attention_forward(
    p: AttnParams,
    x: torch.Tensor,  # (B, S, d)
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta,
    positions: torch.Tensor,  # (B, S) or (S,)
    causal: bool = True,
    window=0,
    logit_softcap: float = 0.0,
    norm_eps: float = 1e-6,
    flash_blk: int = 512,
    kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,  # cross-attn
    sp=None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Returns (output (B,S,d), (k, v) for cache).  ``sp`` set: on a data
    group's `model` devices (``_attention_split``; ``kv_override`` two
    ``FULL`` values, the cache entry as two ``FULL`` values)."""
    if sp is not None:
        return _attention_split(
            sp, p, x, n_heads=n_heads, n_kv=n_kv, rope_theta=rope_theta, positions=positions,
            causal=causal, window=window, logit_softcap=logit_softcap, norm_eps=norm_eps,
            flash_blk=flash_blk, kv_override=kv_override)
    q = _split_heads(x @ p.wq, n_heads)
    if kv_override is None:
        k = _split_heads(x @ p.wk, n_kv)
        v = _split_heads(x @ p.wv, n_kv)
    else:
        k, v = kv_override
    if p.q_norm is not None:
        q = common.rms_norm(q, p.q_norm, norm_eps)
        k = common.rms_norm(k, p.k_norm, norm_eps) if kv_override is None else k
    if rope_theta is not None:
        if positions.ndim == 1:
            positions = positions[None, :]
        q = common.apply_rope(q, positions, rope_theta)
        if kv_override is None:
            k = common.apply_rope(k, positions, rope_theta)
    out = flash_attention(
        q, k, v, causal=causal, window=window, logit_softcap=logit_softcap, blk=flash_blk
    )
    return out.reshape(*x.shape[:2], -1) @ p.wo, (k, v)


def _attention_split(sp, w, x, *, n_heads: int, n_kv: int, rope_theta, positions: list,
                     causal: bool = True, window=0, logit_softcap: float = 0.0,
                     norm_eps: float = 1e-6, flash_blk: int = 512, kv_override=None):
    """``attention_forward`` on a data group's `model` devices (``sp``, a
    ``repro_torch.sharding.split.Split``; ``w`` the gathered ``AttnParams``
    fields, ``positions[m]`` (S,) on device m, ``x`` and the result in
    ``sp.layout``): a causal or a bidirectional self-attention, or with
    ``kv_override`` a cross-attention (its k and v (B, T, KV, D) whole on
    every device, ``FULL``: whisper's encoder states' products, which the
    caller computes column-parallel and all-gathers).

    The projections follow the specs: wq/wk/wv column-parallel where `fit`
    keeps `model` on their columns (else whole, on each device's own rows),
    wo row-parallel.  The specs split the head columns wherever H * D does
    (mid-head where H does not), so the attention itself is split by query
    rows: each device takes its sequence chunk of q with every head (an
    all-to-all), the whole k and v (all-gathered), and the same blocks of
    keys per row as the whole attention (a bidirectional or cross row
    every block of keys); its rows of the output go back to the columns
    wo's slice reads (the inverse all-to-all).  Returns (the output, the
    cache entry (k, v): every device the whole k, normed and rotated, and
    v, as ``FULL`` values)."""
    b = x.parts[sp.root].shape[0]

    def keys(km, m):
        km = _split_heads(km, n_kv)
        if w.k_norm is not None:
            km = common.rms_norm(km, w.k_norm[m], norm_eps)
        if rope_theta is not None:
            km = common.apply_rope(km, positions[m][None, :], rope_theta)
        return km

    if kv_override is None:  # gathered once for the three products
        x = sp.to(x, sp.FULL if w.wq.model_dim is not None or w.wk.model_dim is not None
                  else sp.ROWS)
    q = sp.to(sp.mm(x, w.wq), sp.ROWS)
    if kv_override is None:
        k = sp.to(sp.mm(x, w.wk), sp.FULL)
        v = sp.to(sp.mm(x, w.wv), sp.FULL).map(lambda t, m: _split_heads(t, n_kv))
        k = k.map(keys)
    else:
        k, v = kv_override

    def core(qm, m):
        r0 = sp.row_start[m]
        qm = _split_heads(qm, n_heads)
        if w.q_norm is not None:
            qm = common.rms_norm(qm, w.q_norm[m], norm_eps)
        if rope_theta is not None:
            pos = positions[m][None, :]
            qm = common.apply_rope(qm, pos[:, r0:r0 + qm.shape[1]], rope_theta)
        out = flash_attention(qm, k.parts[m], v.parts[m], causal=causal, window=window,
                              logit_softcap=logit_softcap, blk=flash_blk, q_start=r0,
                              q_len=sp.seq_len)
        return out.reshape(b, out.shape[1], -1)

    o = q.map(core)
    return sp.to(sp.mm(o, w.wo), sp.layout), (k, v)


def attention_decode(
    p: AttnParams,
    x: torch.Tensor,  # (B, 1, d)
    k_cache: torch.Tensor,  # (B, S, KV, D)
    v_cache: torch.Tensor,
    pos: int,  # write/read position
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta,
    window=0,
    logit_softcap: float = 0.0,
    norm_eps: float = 1e-6,
    update_cache: bool = True,
    sp=None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """One token; with ``update_cache`` its k/v are written into the caches
    at ``pos`` in place (without: the caches read as they are, whisper's
    cross-attention, ``pos`` their last position).  Returns (output
    (B,1,d), (k_cache, v_cache)).  ``sp`` set: on a data group's `model`
    devices (``_attention_decode_split``; the caches ``split.CacheLeaf``s)."""
    if sp is not None:
        return _attention_decode_split(
            sp, p, x, k_cache, v_cache, int(pos), n_heads=n_heads, n_kv=n_kv,
            head_dim=head_dim, rope_theta=rope_theta, window=window,
            logit_softcap=logit_softcap, norm_eps=norm_eps,
            update_cache=update_cache), (k_cache, v_cache)
    q = _split_heads(x @ p.wq, n_heads)
    at = torch.full((1, 1), pos, device=x.device)
    if update_cache:
        k_new = _split_heads(x @ p.wk, n_kv)
        v_new = _split_heads(x @ p.wv, n_kv)
        if p.q_norm is not None:
            k_new = common.rms_norm(k_new, p.k_norm, norm_eps)
        if rope_theta is not None:
            k_new = common.apply_rope(k_new, at, rope_theta)
        k_cache[:, pos:pos + 1] = k_new.to(k_cache.dtype)
        v_cache[:, pos:pos + 1] = v_new.to(v_cache.dtype)
    if p.q_norm is not None:
        q = common.rms_norm(q, p.q_norm, norm_eps)
    if rope_theta is not None:
        q = common.apply_rope(q, at, rope_theta)
    out = decode_attention(
        q, k_cache, v_cache, pos, window=window, logit_softcap=logit_softcap
    )
    return out.reshape(x.shape[0], 1, -1) @ p.wo, (k_cache, v_cache)


def _attention_decode_split(sp, w, x, kc, vc, pos: int, *, n_heads: int, n_kv: int,
                            head_dim: int, rope_theta, window=0, logit_softcap: float = 0.0,
                            norm_eps: float = 1e-6, update_cache: bool = True):
    """``attention_decode`` of one token on a data group's `model` devices
    (``sp``; ``w`` the gathered ``AttnParams`` fields, ``x`` and the result
    ``FULL``), in the layout ``cache_pspecs`` gives the caches ``kc``/``vc``
    (``split.CacheLeaf``s):

      * KV heads on `model` (M divides KV): wq, wk and wv are
        column-parallel at head boundaries (H = KV * G), so device m
        projects, caches and attends with its KV heads' query groups alone;
        wo is row-parallel, its partials all-reduced in shard order;
      * the sequence on `model`, or the cache whole on every device (``fit``
        dropped `model`): q, k and v are all-gathered, the new k/v written
        into the shard whose chunk holds ``pos`` (into every copy of a whole
        cache), each device takes the partial softmax over its chunk of
        positions (window and softcap as ``decode_attention``), and the
        chunks are merged exactly (``decode_opt.flash_merge_split``) into
        the columns wo's slice reads.

    Without ``update_cache`` (whisper's cross cache, every position valid)
    only q is projected and nothing is written."""
    heads = kc.dim == 2
    projected = (w.wq, w.wk, w.wv) if update_cache else (w.wq,)
    if heads and not all(t.model_dim == 1 for t in projected):
        raise ValueError("a KV-head cache split needs column-parallel wq/wk/wv")
    x = sp.to(x, sp.FULL if any(t.model_dim is not None for t in projected[:2]) else sp.ROWS)
    q, *kv = (sp.mm(x, t) for t in projected)
    hq, hk = n_heads, n_kv
    if heads:
        hq, hk = n_heads // sp.M, n_kv // sp.M
    else:
        q, *kv = (sp.to(t, sp.FULL) for t in (q, *kv))

    def at(t):
        return torch.full((1, 1), pos, device=t.device)

    def store(km, m):
        km = _split_heads(km, hk)
        if w.k_norm is not None:
            km = common.rms_norm(km, w.k_norm[m], norm_eps)
        if rope_theta is not None:
            km = common.apply_rope(km, at(km), rope_theta)
        kc.write(m, km, pos)
        vc.write(m, _split_heads(kv[1].parts[m], hk), pos)
        return km

    if update_cache:
        kv[0].map(store)

    def query(qm, m):
        qm = _split_heads(qm, hq)
        if w.q_norm is not None:
            qm = common.rms_norm(qm, w.q_norm[m], norm_eps)
        if rope_theta is not None:
            qm = common.apply_rope(qm, at(qm), rope_theta)
        return qm

    q = q.map(query)
    b, dtype = x.parts[sp.root].shape[0], q.parts[sp.root].dtype
    if heads:
        o = q.map(lambda qm, m: decode_attention(
            qm, kc.local(m), vc.local(m), pos, window=window,
            logit_softcap=logit_softcap).reshape(b, 1, -1))
        return sp.to(sp.mm(o, w.wo), sp.layout)

    d = head_dim
    parts = q.map(lambda qm, m: decode_partial(
        (_gqa_expand(qm, n_kv)[:, 0] * (d ** -0.5)).float(), kc.local(m), vc.local(m), pos,
        start=kc.start[m], window=window, logit_softcap=logit_softcap))
    num, den = flash_merge_split(sp, parts)
    kind = sp.input_kind(w.wo)
    num = sp.to(num.map(lambda t, m: t.reshape(b, 1, n_heads * d)), kind)
    den = sp.to(den.map(lambda t, m: t.reshape(b, 1, n_heads).repeat_interleave(d, dim=-1)),
                kind)
    o = num.zip(den, lambda a, c, m: (a / torch.clamp(c, min=1e-30)).to(dtype))
    return sp.to(sp.mm(o, w.wo), sp.layout)
