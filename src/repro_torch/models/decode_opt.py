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
depend on which devices the mesh names.
"""

from __future__ import annotations

import torch

from repro_torch.launch.mesh import check_mesh
from repro_torch.sharding.placement import Sharded

MASKED = -1e30  # the score of a position past ``pos``


def _local_slice(cache, j: int, s_loc: int, device: torch.device, axis: str) -> torch.Tensor:
    """Shard j's (B, S_loc, KV, D) slice: a ``Sharded`` cache's own shard,
    or the slice of a whole tensor copied to ``device``."""
    if isinstance(cache, Sharded):
        idx = tuple(j if name == axis else 0 for name in cache.mesh.axis_names)
        return cache.shards[idx]
    return cache[:, j * s_loc:(j + 1) * s_loc].to(device)


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
        kb = _local_slice(k_cache, j, s_loc, dev, axis).float()
        vb = _local_slice(v_cache, j, s_loc, dev, axis).float()
        qq = q.to(dev).reshape(b, n_kv, g, d).float() * (d ** -0.5)
        scores = torch.einsum("bkgd,bskd->bkgs", qq, kb)
        mask = (torch.arange(s_loc, device=dev) + j * s_loc) <= pos
        scores = torch.where(mask[None, None, None], scores, MASKED)
        m_loc = scores.max(dim=-1).values  # (B, KV, G)
        p = torch.exp(scores - m_loc[..., None])
        num = torch.einsum("bkgs,bskd->bkgd", p, vb)
        den = p.sum(dim=-1)  # (B, KV, G)
        parts.append((m_loc, num, den))

    # exact flash merge across shards, in ascending shard order
    home = mesh.device_at({axis: 0})
    parts = [tuple(t.to(home) for t in part) for part in parts]
    m_g = parts[0][0]
    for m_loc, _, _ in parts[1:]:
        m_g = torch.maximum(m_g, m_loc)
    num_g = den_g = None
    for m_loc, num, den in parts:
        scale = torch.exp(m_loc - m_g)
        num_s, den_s = num * scale[..., None], den * scale
        num_g = num_s if num_g is None else num_g + num_s
        den_g = den_s if den_g is None else den_g + den_s
    out = num_g / torch.clamp(den_g, min=1e-30)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)
