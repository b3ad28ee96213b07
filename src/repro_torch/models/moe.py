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

``set_shard_hooks`` installs the launcher's layout hooks (token-dim,
expert-dim and expert-weight), applied where the JAX package applies its
``with_sharding_constraint``s; identity when unset.  ``set_impl`` installs
a whole-layer override: the all-to-all program of
``repro_torch.models.moe_shardmap``, or the data-group routing of the
mesh train step (``repro_torch.launch.train``).  ``route`` takes a
capacity and per-expert rank offsets for a caller that routes one block
of a larger token set.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import common
from repro_torch.models.ffn import FFNParams, ffn_forward


def _identity(x):
    return x


# launcher-installed sharding hooks (identity by default)
_HOOKS: dict[str, Callable | None] = {
    "tokens": _identity,
    "experts": _identity,
    "weights": _identity,
    "impl": None,  # optional whole-layer override (moe_shardmap, the mesh step)
}


def set_shard_hooks(tokens: Callable | None, experts: Callable | None,
                    weights: Callable | None = None) -> None:
    _HOOKS["tokens"] = tokens or _identity
    _HOOKS["experts"] = experts or _identity
    _HOOKS["weights"] = weights or _identity


def set_impl(fn: Callable | None) -> None:
    """Install a drop-in ``moe_forward`` override (None removes it)."""
    _HOOKS["impl"] = fn


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
          capacity_factor: float = 1.25, capacity: int | None = None,
          offset: torch.Tensor | None = None, hook: Callable = _identity) -> Routing:
    """Top-k routing and the capacity ranks of ``xt`` (T, d).

    ``capacity`` (default ``max(1, round(T*k/E * capacity_factor))``) and
    ``offset`` (E,), the assignments each expert already holds from tokens
    before these, let a caller route one block of a larger token set with
    that set's ranks; ``hook`` is applied to the logits."""
    t = xt.shape[0]
    e = router.shape[1]
    logits = hook(xt.float() @ router)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)  # (T, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    if capacity is None:
        capacity = int(max(1, round(t * k / e * capacity_factor)))
    flat_expert = gate_idx.reshape(t * k)
    onehot = hook(F.one_hot(flat_expert, e))  # (T*k, E) int64
    rank = torch.cumsum(onehot, dim=0).gather(1, flat_expert[:, None])[:, 0] - 1
    if offset is not None:
        rank = rank + offset[flat_expert]
    keep = rank < capacity
    dest = torch.where(keep, flat_expert * capacity + rank,
                       torch.full_like(rank, e * capacity))
    return Routing(probs, gate_vals, gate_idx, keep, dest, capacity)


def expert_counts(gate_idx: torch.Tensor, e: int) -> torch.Tensor:
    """(E,) int64: how many of ``gate_idx``'s assignments each expert takes
    (``bincount(minlength=e)``, as an integer ``scatter_add_``, which also
    has a meta kernel: the dry run traces it)."""
    idx = gate_idx.reshape(-1)
    return torch.zeros(e, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx, torch.ones_like(idx))


def aux_loss(r: Routing, dispatch_frac: torch.Tensor | None = None) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum(dispatch fraction * mean
    router probability).  ``dispatch_frac`` (E,): the fractions of a
    larger token set whose block ``r`` routes (default: ``r``'s own)."""
    e = r.probs.shape[1]
    if dispatch_frac is None:
        tk = r.gate_idx.numel()
        dispatch_frac = expert_counts(r.gate_idx, e).float() / tk
    return e * torch.sum(dispatch_frac * r.probs.mean(dim=0))


def experts(p: MoEParams, xt: torch.Tensor, r: Routing, act: str) -> torch.Tensor:
    """Dispatch ``xt`` (T, d) by ``r`` into the (E, C, d) buffer, the grouped
    expert FFN, the token-major combine and the shared expert: (T, d)."""
    t, d = xt.shape
    e = p.router.shape[1]
    cap = r.capacity
    tk = r.dest.shape[0]
    top = tk // t
    st, se, sw = _HOOKS["tokens"], _HOOKS["experts"], _HOOKS["weights"]

    # -- dispatch: scatter the token ids (one spare row takes the drops) --
    flat_token = torch.arange(tk, device=xt.device) // top
    buf_tok = torch.full((e * cap + 1,), tk, dtype=torch.int64, device=xt.device)
    buf_tok[r.dest] = flat_token
    buf_tok = buf_tok[: e * cap]
    valid = (buf_tok < tk)[:, None]
    rows = xt[torch.clamp(buf_tok, max=t - 1)]
    buf = torch.where(valid, rows, torch.zeros((), dtype=xt.dtype, device=xt.device))
    buf = se(buf.reshape(e, cap, d))

    # -- grouped expert FFN --
    a = common.act_fn(act)
    w_gate, w_up, w_down = sw(p.w_gate), sw(p.w_up), sw(p.w_down)
    h = a(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    out_buf = se(torch.bmm(h, w_down)).reshape(e * cap, d)

    # -- combine (token-major) --
    gathered = out_buf[torch.clamp(r.dest, max=e * cap - 1)]
    gathered = st(gathered * (r.gate_vals.reshape(-1) * r.keep)[:, None].to(xt.dtype))
    out = gathered.reshape(t, top, d).sum(dim=1)

    if p.shared is not None:
        out = out + ffn_forward(p.shared, xt, act)
    return out


def moe_forward(
    p: MoEParams,
    x: torch.Tensor,  # (B, S, d)
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    act: str = "silu",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,d), aux load-balance loss scalar)."""
    if _HOOKS["impl"] is not None:
        return _HOOKS["impl"](p, x, top_k=top_k, capacity_factor=capacity_factor, act=act)
    b, s, d = x.shape
    st = _HOOKS["tokens"]
    xt = st(x.reshape(b * s, d))
    r = route(p.router, xt, k=top_k, capacity_factor=capacity_factor, hook=st)
    return experts(p, xt, r, act).reshape(b, s, d), aux_loss(r)
