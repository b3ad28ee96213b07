"""Collectives between the devices of a mesh driven from one process, as
``torch.autograd.Function``s with a fixed order.

Each collective takes ``parts``, one tensor a position (a data group's
``model`` devices, or the ``fsdp`` blocks of one leaf), and returns one
tensor an output position, each its own tensor (a copy also where two
logical shards share a card).  Copies are ``.to(device)``; sums add the
parts one by one in ascending position order on the receiving device, so
a result never depends on the order in which autograd's backward reaches
the collective (no ``torch.distributed``, no float atomics):

  * ``all_gather(parts, dim)``: every output the parts concatenated along
    ``dim``; backward a reduce-scatter (each part's slice of every
    output's gradient, summed in ascending output order);
  * ``reduce_scatter(parts, dim)``: output m the sum of every part's m-th
    chunk along ``dim``; backward an all-gather;
  * ``all_reduce(parts)``: every output the parts' sum (a reduce-scatter
    and an all-gather; to fewer outputs, summed once on the first one's
    device and copied); backward the same on the gradients (summed, then
    sent back to every part: the broadcast);
  * ``all_to_all(parts, split_dim, cat_dim)``: output m the m-th chunk
    along ``split_dim`` of every part, concatenated along ``cat_dim``;
    backward the inverse all-to-all;
  * ``gather_to(parts, dim, device)``: one output on ``device`` (the FSDP
    gather of one leaf's blocks), backward each part's slice;
  * ``regroup(parts, have, want)``: the parts tile one (B, S, C) value in
    blocks of rows and columns; output m the rows and column ranges
    ``want[m]`` names, taken from the parts that hold them (columns may
    go to several outputs); backward each part's pieces of the outputs'
    gradients added in ascending output order.

Chunks along a dim are ``torch.tensor_split``'s (the first ``n % k``
chunks one longer).  ``outs`` names the output positions wanted (default
all); ``active`` the positions this process computes (default all).  A
solo trace (the dry run, on meta tensors) computes only some positions: a
part at an inactive position is None and a meta tensor of its shape
stands in for it, and the backward stands meta gradients in for the
outputs wanted but not computed, so the active positions run the ops and
receive the bytes they would in the whole program.

``recording()`` counts, by (position key, kind), the bytes each output
position receives from other positions (``keys`` names the positions,
default their indices; ``kind`` overrides the collective's own name):
the dry run's collective bytes.
"""

from __future__ import annotations

from collections import defaultdict, namedtuple
from contextlib import contextmanager

import torch
from torch.autograd import Function
from torch.utils._python_dispatch import _disable_current_modes

_RECORDERS: list[dict] = []


@contextmanager
def recording():
    """A dict (key, kind) -> bytes received, filled while the block runs."""
    rec: dict = defaultdict(float)
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


@contextmanager
def quiet():
    """No bytes recorded while the block runs."""
    saved = _RECORDERS[:]
    _RECORDERS.clear()
    try:
        yield
    finally:
        _RECORDERS[:] = saved


def record(key, kind: str, t: torch.Tensor) -> None:
    """``t``'s bytes as received by position ``key``."""
    if _RECORDERS:
        n = t.numel() * t.element_size()
        for rec in _RECORDERS:
            rec[(key, kind)] += n


def chunk_sizes(n: int, k: int) -> list[int]:
    """The lengths of ``torch.tensor_split``'s k chunks of n."""
    return [n // k + (1 if i < n % k else 0) for i in range(k)]


def _offsets(sizes) -> list[int]:
    out, o = [], 0
    for s in sizes:
        out.append(o)
        o += s
    return out


def _copy(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device`` as a tensor of its own (never an alias of ``t``)."""
    return t.to(device, copy=True)


_Like = namedtuple("_Like", "dtype device")  # what a stand-in copies of a part


def _like(t: torch.Tensor) -> _Like:
    return _Like(t.dtype, t.device)


def _stand_in(shape, like) -> torch.Tensor:
    """A meta tensor standing in for a part or gradient of a solo trace:
    the active positions' program does not allocate it (a counting mode
    does not see it)."""
    if like.device.type != "meta":
        raise ValueError("a missing part is only allowed on meta tensors (a solo trace)")
    with _disable_current_modes():
        return torch.empty(shape, dtype=like.dtype, device="meta")


class _Plan:
    """What one collective call moves: its positions and shapes (``kind``
    names its bytes in ``recording``, default the collective's own)."""

    def __init__(self, n: int, keys, outs, active, devices, kind: str | None = None):
        self.n = n
        self.kind = kind
        self.keys = list(range(n)) if keys is None else list(keys)
        self.outs = list(range(n)) if outs is None else list(outs)
        active = set(range(n)) if active is None else set(active)
        self.computed = [m for m in self.outs if m in active]
        self.phantom = [m for m in self.outs if m not in active]
        self.devices = devices


def _fill(parts, shape_of) -> list[torch.Tensor]:
    like = next(p for p in parts if p is not None)
    return [p if p is not None else _stand_in(shape_of(j, like), _like(like))
            for j, p in enumerate(parts)]


def _result(plan: _Plan, outs) -> list:
    res = [None] * plan.n
    for m, t in zip(plan.computed, outs):
        res[m] = t
    return res


def _grads_in(ctx, grads, shape_of) -> dict:
    """Output position -> gradient: the computed outputs' (None dropped),
    and a meta stand-in for each phantom output."""
    out = {m: g for m, g in zip(ctx.plan.computed, grads) if g is not None}
    for m in ctx.plan.phantom:
        out[m] = _stand_in(shape_of(m), ctx.like)
    return dict(sorted(out.items()))


class _AllGather(Function):
    @staticmethod
    def forward(ctx, plan, dim, *parts):
        ctx.plan, ctx.dim, ctx.like = plan, dim, _like(parts[0])
        ctx.sizes = [p.shape[dim] for p in parts]
        ctx.part_dev = [p.device for p in parts]
        ctx.needs = [p.requires_grad for p in parts]
        shape = list(parts[0].shape)
        shape[dim] = sum(ctx.sizes)
        ctx.shape = tuple(shape)
        outs = []
        for m in plan.computed:
            dev = plan.devices[m]
            # one concatenation an output (a new tensor: parts already on its
            # device, logical shards of one card, are read in place)
            outs.append(torch.cat([p if p.device == dev else p.to(dev) for p in parts], dim))
            for j, p in enumerate(parts):
                if plan.keys[j] != plan.keys[m]:
                    record(plan.keys[m], plan.kind or "all-gather", p)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        plan, dim = ctx.plan, ctx.dim
        gin = _grads_in(ctx, grads, lambda m: ctx.shape)
        res = []
        for j, o in enumerate(_offsets(ctx.sizes)):
            total = None
            if ctx.needs[j]:
                for m, g in gin.items():  # ascending output order
                    piece = g.narrow(dim, o, ctx.sizes[j])
                    if plan.keys[m] != plan.keys[j]:
                        record(plan.keys[j], plan.kind or "reduce-scatter", piece)
                    total = (_copy(piece, ctx.part_dev[j]) if total is None
                             else total + piece.to(ctx.part_dev[j]))
            res.append(total)
        return (None, None, *res)


class _ReduceScatter(Function):
    @staticmethod
    def forward(ctx, plan, dim, sizes, *parts):
        ctx.plan, ctx.dim, ctx.sizes, ctx.like = plan, dim, sizes, _like(parts[0])
        ctx.shape = tuple(parts[0].shape)
        ctx.needs = [p.requires_grad for p in parts]
        offs = _offsets(sizes)
        outs = []
        for m in plan.computed:
            dev = plan.devices[m]
            total = None
            for j, p in enumerate(parts):  # ascending part order
                piece = p.narrow(dim, offs[m], sizes[m])
                if plan.keys[j] != plan.keys[m]:
                    record(plan.keys[m], plan.kind or "reduce-scatter", piece)
                total = piece.to(dev) if total is None else total + piece.to(dev)
            # the first sum makes the output its own tensor; one part is copied
            outs.append(_copy(total, dev) if len(parts) == 1 else total)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        plan, dim, sizes = ctx.plan, ctx.dim, ctx.sizes
        offs = _offsets(sizes)

        def chunk_shape(m):
            s = list(ctx.shape)
            s[dim] = sizes[m]
            return tuple(s)

        gin = _grads_in(ctx, grads, chunk_shape)
        res = []
        for j in range(plan.n):
            if not ctx.needs[j]:
                res.append(None)
                continue
            dev = plan.devices[j]
            full = torch.zeros(ctx.shape, dtype=ctx.like.dtype, device=dev)
            for m, g in gin.items():
                full.narrow(dim, offs[m], sizes[m]).copy_(g)
                if plan.keys[m] != plan.keys[j]:
                    record(plan.keys[j], plan.kind or "all-gather", g)
            res.append(full)
        return (None, None, None, *res)


class _AllReduce(Function):
    @staticmethod
    def forward(ctx, plan, *parts):
        ctx.plan, ctx.like = plan, _like(parts[0])
        ctx.shape = tuple(parts[0].shape)
        ctx.needs = [p.requires_grad for p in parts]
        if not plan.computed:
            return ()
        root = plan.computed[0]
        dev = plan.devices[root]
        total = None
        for j, p in enumerate(parts):
            if plan.keys[j] != plan.keys[root]:
                record(plan.keys[root], plan.kind or "all-reduce", p)
            total = _copy(p, dev) if total is None else total + p.to(dev)
        outs = []
        for m in plan.computed:
            if m == root:
                outs.append(total)
            else:
                record(plan.keys[m], plan.kind or "all-reduce", total)
                outs.append(_copy(total, plan.devices[m]))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        gin = _grads_in(ctx, grads, lambda m: ctx.shape)
        total = None
        if gin:
            root = next(iter(gin))
            dev = gin[root].device
            for m, g in gin.items():
                if plan.keys[m] != plan.keys[root]:
                    record(plan.keys[root], plan.kind or "all-reduce", g)
                total = _copy(g, dev) if total is None else total + g.to(dev)
        res = []
        for j in range(plan.n):
            if not ctx.needs[j] or total is None:
                res.append(None)
                continue
            if plan.keys[j] != plan.keys[root]:
                record(plan.keys[j], plan.kind or "all-reduce", total)
            res.append(_copy(total, plan.devices[j]))
        return (None, *res)


class _AllToAll(Function):
    @staticmethod
    def forward(ctx, plan, split_dim, cat_dim, split_sizes, *parts):
        ctx.plan, ctx.like = plan, _like(parts[0])
        ctx.split_dim, ctx.cat_dim, ctx.split_sizes = split_dim, cat_dim, split_sizes
        ctx.cat_sizes = [p.shape[cat_dim] for p in parts]
        ctx.part_shapes = [tuple(p.shape) for p in parts]
        ctx.needs = [p.requires_grad for p in parts]
        offs = _offsets(split_sizes)
        outs = []
        for m in plan.computed:
            pieces = []
            for j, p in enumerate(parts):
                piece = p.narrow(split_dim, offs[m], split_sizes[m])
                if plan.keys[j] != plan.keys[m]:
                    record(plan.keys[m], plan.kind or "all-to-all", piece)
                pieces.append(piece.to(plan.devices[m]))
            outs.append(torch.cat(pieces, dim=cat_dim))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        sd, cd = ctx.split_dim, ctx.cat_dim

        def out_shape(m):
            s = list(ctx.part_shapes[0])
            s[sd] = ctx.split_sizes[m]
            s[cd] = sum(ctx.cat_sizes)
            return tuple(s)

        gin = _grads_in(ctx, grads, out_shape)
        soffs, coffs = _offsets(ctx.split_sizes), _offsets(ctx.cat_sizes)
        res = []
        for j in range(plan.n):
            if not ctx.needs[j]:
                res.append(None)
                continue
            dev = plan.devices[j]
            full = torch.zeros(ctx.part_shapes[j], dtype=ctx.like.dtype, device=dev)
            for m, g in gin.items():
                piece = g.narrow(cd, coffs[j], ctx.cat_sizes[j])
                if plan.keys[m] != plan.keys[j]:
                    record(plan.keys[j], plan.kind or "all-to-all", piece)
                full.narrow(sd, soffs[m], ctx.split_sizes[m]).copy_(piece)
            res.append(full)
        return (None, None, None, None, *res)


class _Regroup(Function):
    @staticmethod
    def forward(ctx, plan, have, want, *parts):
        ctx.plan, ctx.have, ctx.want, ctx.like = plan, have, want, _like(parts[0])
        ctx.part_shapes = [tuple(p.shape) for p in parts]
        ctx.needs = [p.requires_grad for p in parts]
        outs = []
        for m in plan.computed:
            dev = plan.devices[m]
            out = torch.empty(_regroup_shape(parts[0].shape, want[m]), dtype=parts[0].dtype,
                              device=dev)
            for j, p in enumerate(parts):
                for (src, dst, rn, cn) in _overlaps(have[j], want[m]):
                    piece = p[:, src[0]:src[0] + rn, src[1]:src[1] + cn]
                    if plan.keys[j] != plan.keys[m]:
                        record(plan.keys[m], plan.kind or "all-to-all", piece)
                    out[:, dst[0]:dst[0] + rn, dst[1]:dst[1] + cn] = piece.to(dev)
            outs.append(out)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        plan = ctx.plan
        gin = _grads_in(ctx, grads, lambda m: _regroup_shape(ctx.part_shapes[0], ctx.want[m]))
        res = []
        for j in range(plan.n):
            if not ctx.needs[j]:
                res.append(None)
                continue
            dev = plan.devices[j]
            full = torch.zeros(ctx.part_shapes[j], dtype=ctx.like.dtype, device=dev)
            for m, g in gin.items():  # ascending output order
                for (src, dst, rn, cn) in _overlaps(ctx.have[j], ctx.want[m]):
                    piece = g[:, dst[0]:dst[0] + rn, dst[1]:dst[1] + cn]
                    if plan.keys[m] != plan.keys[j]:
                        record(plan.keys[j], plan.kind or "all-to-all", piece)
                    full[:, src[0]:src[0] + rn, src[1]:src[1] + cn] += piece.to(dev)
            res.append(full)
        return (None, None, None, *res)


def _regroup_shape(shape, want) -> tuple:
    (_, rows), cols = want
    return (shape[0], rows, sum(n for _, n in cols))


def _overlaps(have, want) -> list:
    """The pieces a part of rows/columns ``have`` ((r0, rn), (c0, cn)) gives
    an output of ``want`` ((r0, rn), [(c0, cn), ...]): (offsets in the part,
    offsets in the output, rows, columns), in the output's column order."""
    (hr0, hrn), (hc0, hcn) = have
    (wr0, wrn), cols = want
    r0, r1 = max(hr0, wr0), min(hr0 + hrn, wr0 + wrn)
    out, at = [], 0
    for c0, cn in cols:
        a, b = max(hc0, c0), min(hc0 + hcn, c0 + cn)
        if r1 > r0 and b > a:
            out.append(((r0 - hr0, a - hc0), (r0 - wr0, at + a - c0), r1 - r0, b - a))
        at += cn
    return out


def _norm_dim(dim: int, parts) -> int:
    nd = next(p for p in parts if p is not None).ndim
    return dim % nd


def all_gather(parts, dim: int, *, sizes=None, keys=None, outs=None, active=None,
               kind=None) -> list:
    """Every wanted output (on its part's device) the parts concatenated
    along ``dim``; ``sizes`` gives each part's length along it (needed
    only for a stand-in of an uneven part)."""
    dim = _norm_dim(dim, parts)

    def shape_of(j, like):
        s = list(like.shape)
        if sizes is not None:
            s[dim] = sizes[j]
        return tuple(s)

    parts = _fill(parts, shape_of)
    plan = _Plan(len(parts), keys, outs, active, [p.device for p in parts], kind)
    return _result(plan, _AllGather.apply(plan, dim, *parts))


def gather_to(parts, dim: int, device, *, key=None, part_keys=None) -> torch.Tensor:
    """The parts concatenated along ``dim`` on ``device`` (position
    ``key``): the FSDP gather of one leaf's blocks."""
    dim = _norm_dim(dim, parts)
    n = len(parts)
    part_keys = list(range(n)) if part_keys is None else list(part_keys)
    plan = _Plan(n + 1, part_keys + [key if key is not None else "out"], [n], None,
                 [p.device for p in parts] + [torch.device(device)])
    return _AllGather.apply(plan, dim, *parts)[0]


def reduce_scatter(parts, dim: int, *, sizes=None, keys=None, outs=None, active=None,
                   kind=None) -> list:
    """Output m (on part m's device) the sum, in ascending part order, of
    every part's m-th chunk along ``dim`` (``sizes``: the chunks' lengths,
    default ``tensor_split``'s)."""
    dim = _norm_dim(dim, parts)
    parts = _fill(parts, lambda j, like: tuple(like.shape))
    n = len(parts)
    sizes = chunk_sizes(parts[0].shape[dim], n) if sizes is None else list(sizes)
    plan = _Plan(n, keys, outs, active, [p.device for p in parts], kind)
    return _result(plan, _ReduceScatter.apply(plan, dim, sizes, *parts))


def all_reduce(parts, *, keys=None, outs=None, active=None) -> list:
    """Every wanted output the sum of the parts in ascending order.  Wanted
    on every position: a reduce-scatter of the flattened parts and an
    all-gather of the sums (each position receives 2 (n - 1) / n of a
    part); wanted on fewer: summed once, on the first computed output's
    device, and copied."""
    n = len(parts)
    like = next(p for p in parts if p is not None)
    shape = tuple(like.shape)
    if outs is None and n > 1 and like.numel() >= n:
        flat = [None if p is None else p.reshape(-1) for p in parts]
        sizes = chunk_sizes(like.numel(), n)
        kw = dict(keys=keys, active=active, kind="all-reduce")
        sums = reduce_scatter(flat, 0, sizes=sizes, **kw)
        whole = all_gather(sums, 0, sizes=sizes, **kw)
        return [None if t is None else t.reshape(shape) for t in whole]
    parts = _fill(parts, lambda j, like: tuple(like.shape))
    plan = _Plan(n, keys, outs, active, [p.device for p in parts])
    return _result(plan, _AllReduce.apply(plan, *parts))


def all_to_all(parts, split_dim: int, cat_dim: int, *, split_sizes=None, cat_sizes=None,
               keys=None, outs=None, active=None) -> list:
    """Output m: chunk m along ``split_dim`` of every part, concatenated
    along ``cat_dim`` in part order (``split_sizes`` the chunks' lengths,
    default ``tensor_split``'s; ``cat_sizes`` each part's length along
    ``cat_dim``, needed only for a stand-in of an uneven part)."""
    split_dim, cat_dim = _norm_dim(split_dim, parts), _norm_dim(cat_dim, parts)

    def shape_of(j, like):
        s = list(like.shape)
        if cat_sizes is not None:
            s[cat_dim] = cat_sizes[j]
        return tuple(s)

    parts = _fill(parts, shape_of)
    n = len(parts)
    split_sizes = (chunk_sizes(parts[0].shape[split_dim], n) if split_sizes is None
                   else list(split_sizes))
    plan = _Plan(n, keys, outs, active, [p.device for p in parts])
    return _result(plan, _AllToAll.apply(plan, split_dim, cat_dim, split_sizes, *parts))


def regroup(parts, have, want, *, keys=None, outs=None, active=None, kind=None) -> list:
    """The parts are blocks of one (B, S, C) value: part j its rows and
    columns ``have[j]`` = ((r0, rn), (c0, cn)), every position of the value
    in one part.  Output m (on part m's device) holds the rows ``want[m][0]``
    = (r0, rn) and the column ranges ``want[m][1]`` = [(c0, cn), ...],
    concatenated in that order: each piece copied from the part that holds
    it (the bytes from other positions recorded as ``kind``, default
    all-to-all)."""
    def shape_of(j, like):
        (_, rn), (_, cn) = have[j]
        return (like.shape[0], rn, cn)

    parts = _fill(parts, shape_of)
    plan = _Plan(len(parts), keys, outs, active, [p.device for p in parts], kind)
    return _result(plan, _Regroup.apply(plan, have, want, *parts))
