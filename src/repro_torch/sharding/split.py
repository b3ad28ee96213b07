"""The split program's layouts: one data group's `model` devices computing
one step together, driven from one process.

Device (g, m) of a mesh computes data group g's rows with model slice m of
every weight the specs split over `model`.  A ``Split`` holds one group's
M devices, its ``Dist`` values (one tensor a device) and the collectives
between them (``repro_torch.sharding.collectives``).  A ``Dist`` of a
(B, S, ...) activation is one of:

  * ``FULL``: every device holds the whole tensor;
  * ``ROWS``: device m holds its chunk of the sequence (``tensor_split``
    of S into M);
  * ``COLS``: device m holds its block of the last dim (the block a
    column-parallel weight's model slice gives);
  * ``PARTIAL``: every device holds a whole tensor of partial sums;
  * ``HEADS``: every device holds the whole sequence and its own columns
    (a recurrent block's heads, ``Split.heads``; ``Split.cols`` makes one
    with ``collectives.regroup``, ``Split.to_input`` gives it to a
    weight).

Between blocks an activation is ``layout``: ``ROWS`` where
``ActivationSharder.spec`` puts `model` on the sequence (S divides), else
``FULL``.  ``mm`` multiplies by a weight as its spec splits it: a
column-parallel weight takes ``FULL`` rows and gives ``COLS``, a
row-parallel one takes ``COLS`` and gives ``PARTIAL``, a weight whose
`model` axis ``fit`` dropped is whole on every device and takes its own
``ROWS`` (so no product is computed twice).  ``to`` converts: all-gathers
(``ROWS``/``COLS`` -> ``FULL``), all-to-alls (``COLS`` <-> ``ROWS``),
reduce-scatters and all-reduces (``PARTIAL`` -> ...), slices (``FULL`` ->
``ROWS``/``COLS``).

Weights: ``weights(tree, unit)`` gathers one unit's leaves (a layer, the
embedding, the head) for the group's devices just before use: device
(g, m) receives the `fsdp` blocks of its model slice from the devices
(g', m) that hold them (``gather_to``), nothing more.  The gathered
tensors are not kept for the backward: under ``saving()`` a saved tensor
that is a gathered weight (or a view of one) is packed as its recipe and
gathered again when the backward needs it; under ``cfg.remat`` the
layer's recomputation gathers again.  So at most one unit's gathered
blocks are alive on a device outside that unit's backward.  The leaves a
device differentiates are aliases of the shards (``GradSink``): each
alias's gradient goes into the float32 sums of every position holding
its block as soon as the backward produces it, the contributions to one
block summed in the order they were gathered.

Caches: ``CacheLeaf`` gives each device its view of an attention cache
leaf (KV heads, sequence chunks, or whole); ``StateLeaf`` of a recurrent
one (a state by heads, its heads ``Split.heads``'s, or whole on every
device and kept equal there; a conv tail or an x_prev whole).
"""

from __future__ import annotations

import copy
import weakref
from contextlib import contextmanager
from functools import partial

import numpy as np
import torch

from repro_torch.sharding import collectives as col
from repro_torch.sharding.partition import MeshAxes, leaf_axes

FULL, ROWS, COLS, PARTIAL, HEADS = "full", "rows", "cols", "partial", "heads"

_GATHERING = [0]
_WATCHERS: list = []


def gathering() -> bool:
    """True while an FSDP gather allocates (the dry run's counter keeps
    those bytes apart from the temps)."""
    return _GATHERING[0] > 0


@contextmanager
def watch_gathers(fn):
    """``fn(unit, leaf, m, tensor)`` for every tensor an FSDP gather makes
    (the forward's, a saved weight's regather, a recomputation's): the
    unit's name, the ``Sharded`` leaf, the model index it is for."""
    _WATCHERS.append(fn)
    try:
        yield
    finally:
        _WATCHERS.remove(fn)


class Dist:
    """One value over a group's devices: ``parts[m]`` on device m (None at
    a position a solo trace does not compute)."""

    __slots__ = ("kind", "parts")

    def __init__(self, kind: str, parts: list):
        self.kind, self.parts = kind, list(parts)

    def map(self, fn) -> "Dist":
        """``fn(part, m)`` on every computed part."""
        return Dist(self.kind, [None if p is None else fn(p, m) for m, p in enumerate(self.parts)])

    def zip(self, other: "Dist", fn) -> "Dist":
        if other.kind != self.kind:
            raise ValueError(f"{self.kind} and {other.kind} values do not combine")
        return Dist(self.kind, [None if a is None else fn(a, b, m)
                                for m, (a, b) in enumerate(zip(self.parts, other.parts))])

    def __add__(self, other: "Dist") -> "Dist":
        return self.zip(other, lambda a, b, m: a + b)


class Weight:
    """One leaf as a group's devices compute with it: ``parts[m]`` device
    m's model slice (gathered over `fsdp`), ``model_dim`` the dim the slice
    is taken along (None: whole on every device)."""

    __slots__ = ("parts", "model_dim")

    def __init__(self, parts: list, model_dim: int | None):
        self.parts, self.model_dim = parts, model_dim

    def __getitem__(self, m: int) -> torch.Tensor:
        return self.parts[m]

    @property
    def T(self) -> "Weight":
        md = None if self.model_dim is None else 1 - self.model_dim
        return Weight([None if p is None else p.T for p in self.parts], md)


class NS(dict):
    """A unit's gathered weights by field name (``w.attn.wq``; a missing or
    None field reads None)."""

    def __getattr__(self, name):
        return self.get(name)


def layer_of(tree, i):
    """Layer i of a segment's layout (each ``Stack`` leaf's i-th entry); a
    tuple (g, i) indexes a ``Stack`` of ``Stack``s (the hybrid's G groups of
    P mamba layers)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, layer_of(v, i)) for k, v in tree.items())
    for j in (i if isinstance(i, tuple) else (i,)):
        tree = tree[j]
    return tree


def position(mesh, group: int, m: int) -> tuple:
    """The mesh index of data group ``group``'s model device ``m`` (groups
    row-major over the batch axes)."""
    axes = MeshAxes(mesh)
    sizes = mesh.shape
    batch = axes.batch_axes()
    coords = {}
    if batch:
        idx = np.unravel_index(group, [sizes[a] for a in batch])
        coords = {a: int(i) for a, i in zip(batch, idx)}
    if axes.model is not None:
        coords[axes.model] = m
    return tuple(coords.get(a, 0) for a in mesh.axis_names)


def fsdp_positions(mesh, sh, m: int) -> list:
    """The positions holding model slice m's `fsdp` blocks of ``sh`` (a
    ``Sharded``), in block order: the first device of each block along
    the batch axes."""
    axes = MeshAxes(mesh)
    n_groups = int(np.prod([axes.axis_size(a) for a in axes.batch_axes()], dtype=np.int64))
    seen, out = set(), []
    for g in range(n_groups):
        p = position(mesh, g, m)
        b = sh._block(p)
        if b not in seen:
            seen.add(b)
            out.append(p)
    return out


def uses(mesh, sh, group: int, m: int) -> list:
    """The positions of the shards of ``sh`` device (group, m) computes
    with (gathers over `fsdp`, or its own)."""
    _, fd = leaf_axes(sh.spec, MeshAxes(mesh))
    return [position(mesh, group, m)] if fd is None else fsdp_positions(mesh, sh, m)


class GradSink:
    """Gradients of one group's shard aliases into ``sums`` (param leaf id
    -> its float32 ``Sharded`` sum).  ``write``: the positions whose sums
    this process writes (None: all; a solo trace writes its own)."""

    def __init__(self, sums: dict, write=None):
        self.sums, self.write = sums, write
        self.inputs: list[torch.Tensor] = []
        self.slots: dict = {}  # (leaf id, block) -> (leaf, [[position, grad], ...])
        self.closed = False
        self._positions: dict = {}

    def alias(self, sh, pos: tuple) -> torch.Tensor:
        a = sh.shards[pos].detach().requires_grad_()
        if self.closed:  # a recomputation in the backward: not a new use
            return a
        key = (id(sh), sh._block(pos))
        _, slots = self.slots.setdefault(key, (sh, []))
        slots.append([pos, None])
        a.register_post_accumulate_grad_hook(partial(self._arrived, key, len(slots) - 1))
        self.inputs.append(a)
        return a

    def _arrived(self, key, i: int, a: torch.Tensor) -> None:
        _, slots = self.slots[key]
        slots[i][1], a.grad = a.grad, None
        if all(g is not None for _, g in slots):
            self._flush(key)

    def _block_positions(self, sh, block) -> list:
        spec = tuple(sh.spec)
        table = self._positions.get(spec)
        if table is None:
            table = {}
            for idx in np.ndindex(sh.shards.shape):
                table.setdefault(sh._block(idx), []).append(idx)
            self._positions[spec] = table
        return table[block]

    def _flush(self, key) -> None:
        sh, slots = self.slots.pop(key)
        slots = [(p, g) for p, g in slots if g is not None]
        if not slots:
            return
        acc = self.sums[id(sh)]
        if len(slots) == 1:
            total = slots[0][1]
        else:  # the uses of one block, in the order they were gathered
            dev = slots[0][1].device
            total = slots[0][1].to(dev, torch.float32, copy=True)
            for _, g in slots[1:]:
                total += g.to(dev, torch.float32)
        for p in self._block_positions(sh, key[1]):
            if self.write is not None and p not in self.write:
                continue
            t = acc.shards[p]
            for q, g in slots:
                if q != p:
                    col.record(p, "reduce-scatter", g)
            t.add_(total.to(t.device))

    def backward(self, loss: torch.Tensor) -> None:
        """The backward of ``loss`` into the sums; every alias's gradient
        is consumed as it arrives."""
        self.closed = True
        if self.inputs:
            torch.autograd.backward(loss, inputs=self.inputs)
        for key in list(self.slots):  # blocks some use of which got no gradient
            self._flush(key)
        self.inputs = []


class CacheLeaf:
    """One layer's entry of a ``Sharded`` cache leaf (L, B, S, ...) on a
    data group's devices, as ``cache_pspecs`` lays it out (S the leaf's
    own positions: a self cache's, or whisper's cross cache's T frames).
    ``views[m]``: device m's (B, S_m, ...) view of its shard's entry (None
    where not computed); ``dim``: the view's dim the spec puts on `model` (1 the
    sequence, 2 the KV heads, None: whole on every device).  Attention over
    a sequence split, or over a whole cache, is chunked: device m reads the
    positions ``start[m]`` .. ``start[m] + size[m] - 1`` (``tensor_split``'s
    chunks of S, which are the shards' where the spec splits S)."""

    def __init__(self, sp: "Split", sh, layer: int):
        md, _ = leaf_axes(sh.spec, sp.axes)
        self.dim = None if md is None else md - 1
        self.size = col.chunk_sizes(sh.shape[2], sp.M)
        self.start = [sum(self.size[:m]) for m in range(sp.M)]
        self.views = sp.parts(lambda m: sh.shards[sp.pos[m]][layer])

    def local(self, m: int) -> torch.Tensor:
        """The positions device m attends over (its chunk, or its heads)."""
        v = self.views[m]
        return v.narrow(1, self.start[m], self.size[m]) if self.dim is None else v

    def write(self, m: int, new: torch.Tensor, pos: int) -> None:
        """One position's entry ``new`` (B, 1, ...) at ``pos``: into the
        shard whose chunk holds it (sequence), into every device's copy
        (whole), or into the device's own heads (``new`` those heads)."""
        v, at = self.views[m], pos
        if self.dim == 1:
            at = pos - self.start[m]
            if not 0 <= at < self.size[m]:
                return
        v[:, at:at + 1] = new.to(v.dtype)

    def fill(self, m: int, full: torch.Tensor) -> None:
        """A prompt's entries ``full`` (B, S_p, ...), whole on device m,
        into positions 0 .. S_p - 1 of its part."""
        v, n = self.views[m], full.shape[1]
        if self.dim == 1:
            k = min(self.size[m], n - self.start[m])
            if k > 0:
                v[:, :k] = full[:, self.start[m]:self.start[m] + k].to(v.dtype)
        elif self.dim == 2:
            v[:, :n] = full.narrow(2, m * v.shape[2], v.shape[2]).to(v.dtype)
        else:
            v[:, :n] = full.to(v.dtype)


class StateLeaf:
    """One layer's entry of a recurrent cache leaf on a data group's devices,
    as ``cache_pspecs`` lays it out: a state (B, H, ...) (the SSM state's
    (B, H, Pd, N), RWKV's (B, H, dk, dv)), heads on `model` where M divides
    H, else whole on every device; or a leaf the specs never split (the
    conv tail (B, W - 1, C), RWKV's x_prev (B, d)), whole on every device.
    ``index``: the layer's index in the leaf's leading dims; ``state``:
    the leaf is a state, its heads at the view's dim 1.  Device m computes
    the heads ``sp.heads(H)[m]``, which are its shard's where the state is
    split."""

    def __init__(self, sp: "Split", sh, index, state: bool):
        index = index if isinstance(index, tuple) else (index,)
        md, _ = leaf_axes(sh.spec, sp.axes)
        self.sp = sp
        self.split = md is not None
        self.views = sp.parts(lambda m: sh.shards[sp.pos[m]][index])
        self.heads = sp.heads(sh.shape[len(index) + 1]) if state else None

    def read(self, m: int) -> torch.Tensor:
        """Device m's heads of the state (or the whole leaf)."""
        v = self.views[m]
        if self.heads is None or self.split:
            return v
        h0, hn = self.heads[m]
        return v.narrow(1, h0, hn)

    def store(self, new: Dist) -> None:
        """The new entry: a state's heads on each device (``new``) into its
        own shard where the state is split, else all-gathered over the heads
        into every device's whole copy; a leaf kept whole (``new`` equal on
        every device) into every copy.  The copies stay equal."""
        if self.heads is not None and not self.split:
            new = self.sp.gather(new, 1, [n for _, n in self.heads])
        for m in self.sp.active:
            self.views[m].copy_(new.parts[m])


class Split:
    """Data group ``group``'s devices on ``mesh`` for a sequence of
    ``seq_len`` (``over``: the same devices for another sequence).
    ``active``: the model indices this process computes (None: all; the
    dry run traces the last alone); ``root``, the first
    of them, receives the loss.  ``rows``: each device's length of the
    sequence in ``ROWS`` (default ``tensor_split``'s chunks; a decode step
    puts its one token on the last device).  ``sink``: where the aliases'
    gradients go (None: no gradients).  ``routing``: the MoE layers'
    router state (``launch.train.GroupRouting``)."""

    FULL, ROWS, COLS, PARTIAL, HEADS = FULL, ROWS, COLS, PARTIAL, HEADS

    def __init__(self, mesh, group: int, seq_len: int, *, sink: GradSink | None = None,
                 routing=None, active=None, rows=None):
        axes = MeshAxes(mesh)
        self.mesh, self.axes, self.group = mesh, axes, group
        self.sink, self.routing = sink, routing
        sizes = mesh.shape
        self.batch_axes = axes.batch_axes()
        self.n_groups = int(np.prod([sizes[a] for a in self.batch_axes], dtype=np.int64))
        self.M = axes.axis_size(axes.model)
        self.active = list(range(self.M)) if active is None else list(active)
        self.root = self.active[0]
        self.pos = [self.position(group, m) for m in range(self.M)]
        self.devices = [mesh.devices[p] for p in self.pos]
        self._sequence(seq_len, rows)
        self.unit = ""
        self._recipes: dict = {}
        self._fsdp: dict = {}

    def _sequence(self, seq_len: int, rows) -> None:
        self.seq_len = seq_len
        self.rows = col.chunk_sizes(seq_len, self.M) if rows is None else list(rows)
        self.row_start = [sum(self.rows[:m]) for m in range(self.M)]
        self.layout = ROWS if self.M == 1 or (seq_len > 1 and seq_len % self.M == 0) else FULL

    def over(self, seq_len: int) -> "Split":
        """This group's devices for another sequence of ``seq_len``
        (whisper's encoder frames beside its decoder tokens): its own rows
        and layout, and this split's sink, routing, active set and gathered
        weights' recipes, so one backward reaches both sequences' weights."""
        sp = copy.copy(self)
        sp._sequence(seq_len, None)
        return sp

    # -- positions ------------------------------------------------------------

    def position(self, group: int, m: int) -> tuple:
        return position(self.mesh, group, m)

    @staticmethod
    def dist(kind: str, parts: list) -> Dist:
        return Dist(kind, parts)

    layer = staticmethod(layer_of)

    def cache_leaf(self, sh, layer: int) -> CacheLeaf:
        """Layer ``layer``'s entry of the cache leaf ``sh`` on this group."""
        return CacheLeaf(self, sh, layer)

    def state_leaf(self, sh, index, state: bool = True) -> StateLeaf:
        """Layer ``index``'s entry of the recurrent cache leaf ``sh`` (a
        state by heads, or with ``state=False`` a leaf kept whole)."""
        return StateLeaf(self, sh, index, state)

    def heads(self, n: int) -> list[tuple[int, int]]:
        """(first, count) of the heads of ``n`` each device computes: whole
        heads in ascending order, ``tensor_split``'s chunks (the shards'
        where M divides n; none on the last devices where n < M)."""
        sizes = col.chunk_sizes(n, self.M)
        return [(sum(sizes[:m]), sizes[m]) for m in range(self.M)]

    def parts(self, fn) -> list:
        """``fn(m)`` at every computed model index, None elsewhere."""
        return [fn(m) if m in self.active else None for m in range(self.M)]

    def whole(self, t: torch.Tensor) -> list:
        """A copy of ``t`` (the group's batch) on every computed device."""
        return self.parts(lambda m: t.to(self.devices[m]))

    def from_whole(self, t: torch.Tensor) -> Dist:
        """The group's whole (B, S, ...) input in ``layout``."""
        if self.layout == FULL:
            return Dist(FULL, self.whole(t))
        return Dist(ROWS, self.parts(lambda m: t.narrow(1, self.row_start[m], self.rows[m])
                                     .to(self.devices[m])))

    # -- collectives on values ------------------------------------------------

    def _kw(self, **kw) -> dict:
        return dict(keys=self.pos, active=self.active, **kw)

    def to(self, d: Dist, kind: str, sizes=None) -> Dist:
        """``d`` as ``kind`` (see the module docstring); ``sizes``: each
        device's rows where they are not ``rows``."""
        src = d.kind
        if src == kind:
            return d
        if self.M == 1:
            return Dist(kind, d.parts)
        rows = self.rows if sizes is None else list(sizes)
        if (src, kind) == (ROWS, FULL):
            return Dist(FULL, col.all_gather(d.parts, 1, sizes=rows, **self._kw()))
        if (src, kind) == (COLS, FULL):
            return Dist(FULL, col.all_gather(d.parts, -1, **self._kw()))
        if (src, kind) == (FULL, ROWS):
            return Dist(ROWS, d.map(lambda t, m: t.narrow(1, self.row_start[m], rows[m])).parts)
        if (src, kind) == (FULL, COLS):
            return Dist(COLS, d.map(lambda t, m: t.chunk(self.M, dim=-1)[m]).parts)
        if (src, kind) == (COLS, ROWS):
            return Dist(ROWS, col.all_to_all(d.parts, 1, -1, split_sizes=rows, **self._kw()))
        if (src, kind) == (ROWS, COLS):
            return Dist(COLS, col.all_to_all(d.parts, -1, 1, cat_sizes=rows, **self._kw()))
        if (src, kind) == (PARTIAL, ROWS):
            return Dist(ROWS, col.reduce_scatter(d.parts, 1, sizes=rows, **self._kw()))
        if (src, kind) == (PARTIAL, FULL):
            return Dist(FULL, col.all_reduce(d.parts, **self._kw()))
        if (src, kind) == (PARTIAL, COLS):
            return Dist(COLS, col.reduce_scatter(d.parts, -1, **self._kw()))
        raise ValueError(f"no conversion from {src} to {kind}")

    def gather(self, d: Dist, dim: int, sizes: list) -> Dist:
        """The parts (each device's ``sizes[m]`` along ``dim``, some may be
        none) concatenated in shard order on every device: ``FULL``."""
        if self.M == 1:
            return Dist(FULL, d.parts)
        return Dist(FULL, col.all_gather(d.parts, dim, sizes=list(sizes), **self._kw()))

    def stack(self, d: Dist) -> Dist:
        """Every device's part (equal shapes) stacked on a new leading dim,
        on every device (an all-gather)."""
        parts = [None if p is None else p[None] for p in d.parts]
        return Dist(FULL, col.all_gather(parts, 0, **self._kw()))

    def whole_cols(self, d: Dist) -> Dist:
        """``d`` with every device holding whole feature rows: ``COLS`` and
        ``PARTIAL`` become ``FULL``, ``ROWS`` and ``FULL`` stay."""
        return self.to(d, FULL) if d.kind in (COLS, PARTIAL) else d

    def _have(self, d: Dist, width: int, have_cols=None) -> list:
        """Each part's (rows, columns) block of a (B, S, width) value."""
        full = (0, self.seq_len)
        if d.kind == ROWS:
            return [((self.row_start[m], self.rows[m]), (0, width)) for m in range(self.M)]
        if d.kind == COLS:
            sizes = col.chunk_sizes(width, self.M)
            return [(full, (sum(sizes[:m]), sizes[m])) for m in range(self.M)]
        if d.kind == HEADS:
            return [(full, c) for c in have_cols]
        raise ValueError(f"{d.kind} parts are not blocks of one value")

    def _regroup(self, d: Dist, have: list, want: list, kind: str) -> Dist:
        if all(m not in self.active or [have[m][1]] == want[m][1] and have[m][0] == want[m][0]
               for m in range(self.M)):
            return Dist(kind, d.parts)  # each device holds its own already
        return Dist(kind, col.regroup(d.parts, have, want, **self._kw()))

    def cols(self, d: Dist, width: int, want: list) -> Dist:
        """``d`` (a (B, S, width) value, ``FULL``, ``ROWS`` or ``COLS``) as
        ``HEADS``: device m the whole sequence and the column ranges
        ``want[m]`` ([(first, count), ...], concatenated): local slices of a
        ``FULL`` value, else one ``collectives.regroup``."""
        if d.kind == FULL or self.M == 1:
            return Dist(HEADS, d.map(lambda t, m: torch.cat(
                [t[..., c0:c0 + cn] for c0, cn in want[m]], dim=-1)).parts)
        full = (0, self.seq_len)
        return self._regroup(d, self._have(d, width), [(full, w) for w in want], HEADS)

    def to_input(self, d: Dist, width: int, have_cols: list, w: Weight) -> Dist:
        """A ``HEADS`` value (device m the whole sequence and the one column
        range ``have_cols[m]`` of ``width``) as ``mm`` by ``w`` takes it:
        ``COLS`` for a row-parallel weight (the identity where the ranges
        are its slices), ``ROWS`` for a whole one, ``FULL`` for a
        column-parallel one (one ``collectives.regroup``)."""
        kind = self.input_kind(w)
        full = (0, self.seq_len)
        if kind == COLS:
            sizes = col.chunk_sizes(width, self.M)
            want = [(full, [(sum(sizes[:m]), sizes[m])]) for m in range(self.M)]
        elif kind == ROWS:
            want = [((self.row_start[m], self.rows[m]), [(0, width)]) for m in range(self.M)]
        else:
            want = [(full, [(0, width)])] * self.M
        if self.M == 1:
            return Dist(kind, d.parts)
        return self._regroup(d, self._have(d, width, have_cols), want, kind)

    def input_kind(self, w: Weight) -> str:
        """The kind ``mm`` by ``w`` takes."""
        if w.model_dim is None:
            return ROWS
        return FULL if w.model_dim == 1 else COLS

    def mm(self, x: Dist, w: Weight) -> Dist:
        """``x @ w`` as ``w``'s spec splits it (``x`` converted first)."""
        kind = self.input_kind(w)
        out = {ROWS: ROWS, FULL: COLS, COLS: PARTIAL}[kind]
        x = self.to(x, kind)
        return Dist(out, [None if a is None else a @ w[m] for m, a in enumerate(x.parts)])

    def gather_to_root(self, d: Dist) -> torch.Tensor:
        """The parts (equal shapes) stacked on a new leading dim on ``root``."""
        parts = [None if p is None else p[None] for p in d.parts]
        return self._to_root(lambda: col.all_gather(parts, 0, outs=[self.root], **self._kw()),
                             d, "reduce-scatter")

    def sum_to_root(self, d: Dist) -> torch.Tensor:
        """The parts summed on ``root`` in ascending order."""
        return self._to_root(lambda: col.all_reduce(d.parts, outs=[self.root], **self._kw()),
                             d, "all-reduce")

    def to_root(self, d: Dist) -> torch.Tensor:
        """The whole value of ``d`` on ``root`` (the parts concatenated, or
        summed in ascending order)."""
        if d.kind == FULL or self.M == 1:
            return d.parts[self.root]
        if d.kind == PARTIAL:
            return self.sum_to_root(d)
        dim, sizes = (-1, None) if d.kind == COLS else (1, self.rows)
        return self._to_root(lambda: col.all_gather(d.parts, dim, sizes=sizes, outs=[self.root],
                                                    **self._kw()), d, "reduce-scatter")

    def _to_root(self, reduce, d: Dist, kind: str) -> torch.Tensor:
        """``reduce()``'s output on ``root``.  Where a solo trace's root is
        not the group's first device (which takes the loss in the whole
        program), the traced device receives what the whole program sends
        it instead of the other parts: its own part's gradient (``kind``)."""
        if self.root == 0:
            return reduce()[0]
        with col.quiet():
            out = reduce()[self.root]
        own = d.parts[self.root]
        if torch.is_grad_enabled() and own.requires_grad:
            col.record(self.pos[self.root], kind, own)
        return out

    # -- weights ---------------------------------------------------------------

    def weights(self, tree, unit: str) -> NS:
        """One unit's leaves (a dict of ``Sharded``) as ``Weight``s, each
        device's model slice gathered over `fsdp` onto it."""
        self.unit = unit
        return self._weights(tree)

    def _weights(self, node):
        # a method, not a recursive closure: a closure's cycle would keep
        # the step's float32 sums alive until the cyclic collector runs
        if node is None:
            return None
        if isinstance(node, dict):
            return NS((k, self._weights(v)) for k, v in node.items())
        md, fd = leaf_axes(node.spec, self.axes)
        return Weight(self.parts(lambda m: self._leaf(node, m, fd)), md)

    def _alias(self, sh, pos: tuple) -> torch.Tensor:
        if self.sink is None or not torch.is_grad_enabled():
            return sh.shards[pos]
        return self.sink.alias(sh, pos)

    def _fsdp_positions(self, sh, m: int) -> list:
        key = (tuple(sh.spec), m)
        out = self._fsdp.get(key)
        if out is None:
            out = self._fsdp[key] = fsdp_positions(self.mesh, sh, m)
        return out

    def _leaf(self, sh, m: int, fsdp_dim) -> torch.Tensor:
        if fsdp_dim is None:
            return self._alias(sh, self.pos[m])
        where = self._fsdp_positions(sh, m)
        parts = [self._alias(sh, p) for p in where]
        if where == [self.pos[m]]:  # one block, its own
            return parts[0]
        w = self._gather(sh, parts, fsdp_dim, m, where)
        if torch.is_grad_enabled():
            self._remember(w, (sh, [p.detach() for p in parts], fsdp_dim, m, where, self.unit))
        return w

    def _gather(self, sh, parts, dim: int, m: int, where) -> torch.Tensor:
        _GATHERING[0] += 1
        try:
            w = col.gather_to(parts, dim, self.devices[m], key=self.pos[m], part_keys=where)
        finally:
            _GATHERING[0] -= 1
        for fn in _WATCHERS:
            fn(self.unit, sh, m, w)
        return w

    def _remember(self, w, recipe) -> None:
        storage = w.untyped_storage()
        key = storage._cdata
        self._recipes[key] = recipe
        weakref.finalize(storage, self._recipes.pop, key, None)

    def _pack(self, t: torch.Tensor):
        recipe = self._recipes.get(t.untyped_storage()._cdata)
        if recipe is None:
            return t
        return (recipe, tuple(t.shape), t.stride(), t.storage_offset())

    def _unpack(self, x):
        if isinstance(x, torch.Tensor):
            return x
        (sh, parts, dim, m, where, unit), shape, stride, offset = x
        prev, self.unit = self.unit, unit
        with torch.no_grad():
            w = self._gather(sh, parts, dim, m, where)
        self.unit = prev
        return w.as_strided(shape, stride, offset)

    @contextmanager
    def saving(self):
        """Saved tensors that are gathered weights kept as recipes."""
        with torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack):
            yield
