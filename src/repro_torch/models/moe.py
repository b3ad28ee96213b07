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
    return route_logits(hook(xt.float() @ router), k=k, capacity_factor=capacity_factor,
                        capacity=capacity, offset=offset, hook=hook)


def route_logits(logits: torch.Tensor, *, k: int, capacity_factor: float = 1.25,
                 capacity: int | None = None, offset: torch.Tensor | None = None,
                 hook: Callable = _identity) -> Routing:
    """``route`` from the router's (T, E) float32 logits (the split
    program computes them on each device's own tokens)."""
    t, e = logits.shape
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
    sw = _HOOKS["weights"]
    out = expert_block(sw(p.w_gate), sw(p.w_up), sw(p.w_down), xt, r, act)
    if p.shared is not None:
        out = out + ffn_forward(p.shared, xt, act)
    return out


def expert_block(w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                 xt: torch.Tensor, r: Routing, act: str, first: int = 0) -> torch.Tensor:
    """The routed part of ``experts`` for the experts ``first`` ..
    ``first + len(w_gate) - 1`` (all of them by default): their rows of the
    (E, C, d) buffer filled from ``xt`` (T, d), their FFN, and the (T, d)
    token-major combine of their weighted outputs (the other experts'
    assignments add zeros)."""
    t, d = xt.shape
    el = w_gate.shape[0]
    cap = r.capacity
    tk = r.dest.shape[0]
    top = tk // t
    n = el * cap
    st, se = _HOOKS["tokens"], _HOOKS["experts"]

    # -- dispatch: scatter the token ids (one spare row takes the drops and
    # the other experts' assignments) --
    local = r.dest - first * cap
    mine = (local >= 0) & (local < n)
    flat_token = torch.arange(tk, device=xt.device) // top
    buf_tok = torch.full((n + 1,), tk, dtype=torch.int64, device=xt.device)
    buf_tok[torch.where(mine, local, n)] = flat_token
    buf_tok = buf_tok[:n]
    valid = (buf_tok < tk)[:, None]
    buf = torch.where(valid, xt[torch.clamp(buf_tok, max=t - 1)],
                      torch.zeros((), dtype=xt.dtype, device=xt.device))
    buf = se(buf.reshape(el, cap, d))

    # -- grouped expert FFN (each buffer dropped once read: the whole
    # batch's capacity makes them the largest temps) --
    a = common.act_fn(act)
    h = a(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    del buf
    out_buf = se(torch.bmm(h, w_down)).reshape(n, d)
    del h

    # -- combine (token-major) --
    gathered = out_buf[torch.clamp(local, min=0, max=n - 1)]
    weight = r.gate_vals.reshape(-1) * (r.keep & mine)
    gathered = st(gathered * weight[:, None].to(xt.dtype))
    return gathered.reshape(t, top, d).sum(dim=1)


def moe_forward(
    p: MoEParams,
    x: torch.Tensor,  # (B, S, d)
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    act: str = "silu",
    sp=None,
    key=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B,S,d), aux load-balance loss scalar).  ``sp`` set:
    expert-parallel on a data group's `model` devices (``_moe_split``;
    ``key`` the layer's name for ``sp.routing``)."""
    if sp is not None:
        return _moe_split(sp, p, x, key=key, top_k=top_k, capacity_factor=capacity_factor,
                          act=act)
    if _HOOKS["impl"] is not None:
        return _HOOKS["impl"](p, x, top_k=top_k, capacity_factor=capacity_factor, act=act)
    b, s, d = x.shape
    st = _HOOKS["tokens"]
    xt = st(x.reshape(b * s, d))
    r = route(p.router, xt, k=top_k, capacity_factor=capacity_factor, hook=st)
    return experts(p, xt, r, act).reshape(b, s, d), aux_loss(r)


def _moe_split(sp, w, x, *, key, top_k: int, capacity_factor: float = 1.25,
               act: str = "silu"):
    """``moe_forward`` on a data group's `model` devices (``sp``, a
    ``repro_torch.sharding.split.Split`` whose ``routing`` routes; ``w``
    the gathered ``MoEParams`` fields, ``key`` the layer's name for the
    routing, ``x`` and the result in ``sp.layout``).  Returns (output,
    aux on ``sp.root``'s device).

    Expert-parallel: the router (whole on every device) takes each
    device's own tokens, the logits are all-gathered, and every device
    routes the group's tokens alike (the routing's whole-batch capacity
    and ranks).  Device m holds experts m*E/M .. (m+1)*E/M - 1: it fills
    their rows of the (E, C, d) buffer from the group's tokens, runs them,
    and combines their weighted outputs token-major; the combine is summed
    over `model` in shard order.  Where ``fit`` drops `model` from the
    experts (E not a multiple of M) every device runs them all over the
    group's tokens and keeps its rows.  The shared expert is
    ``ffn_forward`` on the split."""
    e = w.router[sp.root].shape[1]
    s = sp.seq_len
    logits = sp.to(sp.mm(x.map(lambda t, m: t.float()), w.router), sp.FULL)
    xf = sp.to(x, sp.FULL)
    b = xf.parts[sp.root].shape[0]
    rs, aux = sp.routing.route(key, [None if t is None else t.reshape(b * s, e)
                                     for t in logits.parts],
                               top_k=top_k, capacity_factor=capacity_factor, group=sp.group)
    split = w.w_gate.model_dim is not None

    def part(t, m):
        el = w.w_gate[m].shape[0]
        out = expert_block(w.w_gate[m], w.w_up[m], w.w_down[m], t.reshape(b * s, -1), rs[m],
                           act, first=m * el if split else 0)
        return out.reshape(t.shape)

    out = xf.map(part)
    out = sp.to(sp.dist(sp.PARTIAL if split else sp.FULL, out.parts), sp.layout)
    if w.shared is not None:
        out = out + ffn_forward(w.shared, x, act, sp)
    return out, aux
