"""Optimized decode paths — the port of ``repro.models.decode_opt``.

``flash_decode_shardmap``: explicit partial-softmax merge for a KV cache
sharded along the *sequence* axis of the mesh `model` dimension — the
layout ``cache_pspecs`` picks when KV heads cannot be sharded (granite /
gemma3 have kv=1).  Each shard attends over its local cache slice and the
shards combine with the numerically exact flash merge:

    m_g   = max_j m_j
    out_g = sum_j exp(m_j - m_g) * num_j / max(sum_j exp(m_j - m_g) * den_j, 1e-30)

The JAX package writes it as a ``shard_map`` with ``pmax``/``psum``; here
it is one explicit program driven from this process, as the port's other
mesh programs: shard j computes on the device at index j of the axis
(index 0 of the others), and the merge takes the max, then the scaled
sums, in ascending shard order on shard 0's device — the result does not
depend on which devices the mesh names.  Its parts are the helpers the
split serve step (``attention._attention_decode_split``) shares:
``decode_partial`` (one chunk's partial softmax, ``decode_attention``'s
window and softcap masks), ``merge_partials`` and, over a data group's
devices, ``flash_merge_split``.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import check_mesh
from repro_torch.models import common
from repro_torch.sharding.placement import Sharded

MASKED = -1e30  # the score of a position past ``pos``
_NO_WINDOW = 2**30


def _local_slice(cache, j: int, s_loc: int, device: torch.device, axis: str) -> torch.Tensor:
    """Shard j's (B, S_loc, KV, D) slice: a ``Sharded`` cache's own shard,
    or the slice of a whole tensor copied to ``device``."""
    if isinstance(cache, Sharded):
        idx = tuple(j if name == axis else 0 for name in cache.mesh.axis_names)
        return cache.shards[idx]
    return cache[:, j * s_loc:(j + 1) * s_loc].to(device)


def masked_scores(scores: torch.Tensor, pos: int, *, start: int = 0, window=0,
                  logit_softcap: float = 0.0) -> torch.Tensor:
    """``scores`` (..., S_loc) over the cache positions ``start`` ..
    ``start + S_loc - 1``, softcapped, then masked as ``decode_attention``
    masks: a position past ``pos`` or outside the ``window`` before it
    (0: none) scores ``MASKED``."""
    scores = common.softcap(scores, logit_softcap)
    kj = torch.arange(scores.shape[-1], device=scores.device) + start
    span = int(window) if int(window) > 0 else _NO_WINDOW
    mask = (kj <= pos) & (kj > pos - span)
    return torch.where(mask, scores, MASKED)


def softmax_partial(scores: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One chunk's partial softmax of masked ``scores`` (..., S_loc):
    (its max m (...), the exponentials p = exp(scores - m), their sum)."""
    m = scores.max(dim=-1).values
    p = torch.exp(scores - m[..., None])
    return m, p, p.sum(dim=-1)


def decode_partial(qq: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, *,
                   start: int = 0, window=0, logit_softcap: float = 0.0) -> tuple:
    """One chunk of a GQA decode: ``qq`` (B, KV, G, D) the float32 scaled
    query, ``k``/``v`` (B, S_loc, KV, D) the cache positions ``start`` ..
    ``start + S_loc - 1``.  Returns (m (B, KV, G), num (B, KV, G, D), den
    (B, KV, G)) in float32 for ``merge_partials``."""
    scores = torch.einsum("bkgd,bskd->bkgs", qq, k.float())
    m, p, den = softmax_partial(masked_scores(scores, pos, start=start, window=window,
                                              logit_softcap=logit_softcap))
    return m, torch.einsum("bkgs,bskd->bkgd", p, v.float()), den


def merge_partials(parts) -> torch.Tensor:
    """The exact flash merge of chunks' (m, num, den) on one device, summed
    in the parts' order: sum_j exp(m_j - m_g) num_j / max(sum_j exp(m_j -
    m_g) den_j, 1e-30)."""
    m_g = parts[0][0]
    for m_loc, _, _ in parts[1:]:
        m_g = torch.maximum(m_g, m_loc)
    num_g = den_g = None
    for m_loc, num, den in parts:
        scale = torch.exp(m_loc - m_g)
        num_s, den_s = num * scale[..., None], den * scale
        num_g = num_s if num_g is None else num_g + num_s
        den_g = den_s if den_g is None else den_g + den_s
    return num_g / torch.clamp(den_g, min=1e-30)[..., None]


def flash_merge_split(sp, parts) -> tuple:
    """``merge_partials`` over a data group's `model` devices (``sp``, a
    ``repro_torch.sharding.split.Split``): ``parts`` a ``Dist`` of each
    device's (m, num, den) over its chunk of positions.  Every device
    receives every chunk's max (an all-gather; the max is exact in any
    order) and scales its own num and den.  Returns (the scaled numerators,
    a ``PARTIAL`` value whose sum, in ascending shard order, is the merged
    numerator; the denominators summed in that order, ``FULL``): the
    caller converts the numerators to the layout it reads and divides."""
    maxes = sp.stack(parts.map(lambda p, m: p[0]))

    def scaled(p, m):
        scale = torch.exp(p[0] - maxes.parts[m].amax(dim=0))
        return p[1] * scale[..., None], p[2] * scale

    both = parts.map(scaled)
    num = sp.dist(sp.PARTIAL, both.map(lambda t, m: t[0]).parts)
    den = sp.to(sp.dist(sp.PARTIAL, both.map(lambda t, m: t[1]).parts), sp.FULL)
    return num, den


def flash_decode_shardmap(
    mesh,
    q: torch.Tensor,  # (B, 1, H, D) — replicated over `axis`
    k_cache,  # (B, S, KV, D) — S split over `axis` (whole, or Sharded so)
    v_cache,
    pos,  # number of valid positions - 1
    *,
    axis: str = "model",
) -> torch.Tensor:
    """Exact decode attention with per-shard partial softmax (float32)."""
    mesh = check_mesh(mesh)
    b, _, h, d = q.shape
    n_kv = k_cache.shape[2]
    g = h // n_kv
    s_total = k_cache.shape[1]
    n_shards = mesh.shape[axis]
    if s_total % n_shards:
        raise ValueError(f"a cache of {s_total} positions does not split over "
                         f"{n_shards} shards of {axis!r}")
    s_loc = s_total // n_shards
    pos = int(pos)

    parts = []
    for j in range(n_shards):
        dev = mesh.device_at({axis: j})
        kb = _local_slice(k_cache, j, s_loc, dev, axis)
        vb = _local_slice(v_cache, j, s_loc, dev, axis)
        qq = q.to(dev).reshape(b, n_kv, g, d).float() * (d ** -0.5)
        parts.append(decode_partial(qq, kb, vb, pos, start=j * s_loc))

    # exact flash merge across shards, in ascending shard order
    home = mesh.device_at({axis: 0})
    out = merge_partials([tuple(t.to(home) for t in part) for part in parts])
    return out.reshape(b, 1, h, d).to(q.dtype)
