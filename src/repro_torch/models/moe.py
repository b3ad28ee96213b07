"""Mixture-of-Experts FFN with capacity-based cumsum-rank dispatch.

The port of ``repro.models.moe.moe_forward``; it routes to the same
experts and drops the same tokens:
  * softmax -> top-k, ties to the lower expert index (a stable descending
    sort, as ``jax.lax.top_k``), the k gates renormalised;
  * capacity ``C = max(1, round(T*k/E * capacity_factor))``;
  * rank within expert = the token-major exclusive cumsum of the one-hot
    routing matrix (the JAX package's two-level blocked form sums the same
    integers);
  * dispatch into a dense (E, C, d) buffer; a dropped assignment's
    ``dest`` is ``E*C``, written into one spare row that is sliced off
    (the reference's out-of-bounds ``mode="drop"`` scatter);
  * grouped expert SwiGLU/GeGLU as batched matmuls, a token-major combine,
    plus the always-on shared expert.

The launcher's sharding hooks (``set_shard_hooks``/``set_impl``) belong to
the LM mesh and are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common
from repro_torch.models.ffn import FFNParams, ffn_forward


class MoEParams(nn.Module):
    """router (d, E) float32, w_gate/w_up (E, d, f), w_down (E, f, d),
    shared: ``FFNParams`` of width f * n_shared or None."""

    NAMEDTUPLE = True  # a NamedTuple in the JAX package
    FIELDS = ("router", "w_gate", "w_up", "w_down", "shared")

    def __init__(self, d_model: int, d_ff: int, n_experts: int, n_shared: int, dtype, *,
                 device, generator=None):
        super().__init__()
        init = dict(generator=generator, device=device)
        self.router = nn.Parameter(
            common.dense_init((d_model, n_experts), torch.float32, **init))
        self.w_gate = nn.Parameter(
            common.dense_init((n_experts, d_model, d_ff), dtype, in_axis=1, **init))
        self.w_up = nn.Parameter(
            common.dense_init((n_experts, d_model, d_ff), dtype, in_axis=1, **init))
        self.w_down = nn.Parameter(
            common.dense_init((n_experts, d_ff, d_model), dtype, in_axis=1, **init))
        self.shared = (FFNParams(d_model, d_ff * n_shared, dtype, **init)
                       if n_shared else None)


class Routing(NamedTuple):
    """One ``moe_forward``'s routing, token-major over the T*k assignments."""

    probs: torch.Tensor  # (T, E) float32 router softmax
    gate_vals: torch.Tensor  # (T, k) renormalised gates
    gate_idx: torch.Tensor  # (T, k) int64 expert ids
    keep: torch.Tensor  # (T*k,) bool: within capacity
    dest: torch.Tensor  # (T*k,) int64 buffer row, E*C when dropped
    capacity: int


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: descending, ties to the lower
    index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router: torch.Tensor, xt: torch.Tensor, *, k: int,
          capacity_factor: float) -> Routing:
    """Top-k routing and the capacity ranks of ``xt`` (T, d)."""
    t = xt.shape[0]
    e = router.shape[1]
    logits = xt.float() @ router  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)  # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    capacity = int(max(1, round(t * k / e * capacity_factor)))
    flat_expert = gate_idx.reshape(t * k)
    onehot = F.one_hot(flat_expert, e)  # (T*k, E) int64
    rank = torch.cumsum(onehot, dim=0).gather(1, flat_expert[:, None])[:, 0] - 1
    keep = rank < capacity
    dest = torch.where(keep, flat_expert * capacity + rank,
                       torch.full_like(rank, e * capacity))
    return Routing(probs, gate_vals, gate_idx, keep, dest, capacity)


def moe_forward(
    p: MoEParams,
    x: torch.Tensor,  # (B, S, d)
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    act: str = "silu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,d), aux load-balance loss scalar)."""
    b, s, d = x.shape
    e = p.router.shape[1]
    t = b * s
    tk = t * top_k
    xt = x.reshape(t, d)
    r = route(p.router, xt, k=top_k, capacity_factor=capacity_factor)
    cap = r.capacity

    # -- aux loss (Switch-style) --
    dispatch_frac = torch.bincount(r.gate_idx.reshape(-1), minlength=e).float() / tk
    aux = e * torch.sum(dispatch_frac * r.probs.mean(dim=0))

    # -- dispatch: scatter the token ids (one spare row takes the drops) --
    flat_token = torch.arange(tk, device=x.device) // top_k
    buf_tok = torch.full((e * cap + 1,), tk, dtype=torch.int64, device=x.device)
    buf_tok[r.dest] = flat_token
    buf_tok = buf_tok[: e * cap]
    valid = (buf_tok < tk)[:, None]
    rows = xt[torch.clamp(buf_tok, max=t - 1)]
    buf = torch.where(valid, rows, torch.zeros((), dtype=x.dtype, device=x.device))
    buf = buf.reshape(e, cap, d)

    # -- grouped expert FFN --
    a = common.act_fn(act)
    h = a(torch.bmm(buf, p.w_gate)) * torch.bmm(buf, p.w_up)
    out_buf = torch.bmm(h, p.w_down).reshape(e * cap, d)

    # -- combine (token-major) --
    gathered = out_buf[torch.clamp(r.dest, max=e * cap - 1)]
    gathered = gathered * (r.gate_vals.reshape(-1) * r.keep)[:, None].to(x.dtype)
    out = gathered.reshape(t, top_k, d).sum(dim=1)

    if p.shared is not None:
        out = out + ffn_forward(p.shared, xt, act)
    return out.reshape(b, s, d), aux
