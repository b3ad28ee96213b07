"""Tensors placed on a mesh by a partition spec, driven from one process.

A ``Sharded`` is one logical tensor on a ``repro_torch.launch.mesh.Mesh``:
each mesh device holds its own tensor with exactly the slice the spec
gives it (the counterpart of a ``jax.Array`` with a ``NamedSharding``).
A shard is never a view of a whole tensor, so the bytes a device holds
are the spec's, also where logical shards share one card.  Devices that
differ only along axes the spec does not name hold equal slices
(replicas), each in its own tensor.

A dim sharded on a composite axis (``("pod", "data")``) is split in the
row-major order of the named axes, as in the JAX package.  ``Sharded``
answers what the JAX-layout helpers ask of a tensor (``shape``,
``dtype``, ``device``, ``new_zeros``), so ``AdamW.init`` and
``tree_zeros`` build sharded moments and residuals from a sharded tree.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.models.common import stack_map, tree_map
from repro_torch.sharding.partition import MeshAxes, P


class Sharded:
    """One tensor of global ``shape`` on ``mesh``, split by ``spec``;
    ``shards`` is an object array of the mesh's shape, one tensor a
    device."""

    def __init__(self, mesh, spec: P, shape: tuple, dtype: torch.dtype, shards: np.ndarray):
        self.mesh = mesh
        self.spec = P(*(tuple(spec) + (None,) * (len(shape) - len(spec))))
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.shards = shards
        axes = MeshAxes(mesh)
        for dim, axis in zip(self.shape, self.spec):
            if dim % axes.axis_size(axis):
                raise ValueError(f"spec {spec} does not divide shape {tuple(shape)}")

    # -- layout --------------------------------------------------------------

    def _block(self, idx: tuple) -> tuple[int, ...]:
        """The block index of each dim at mesh index ``idx``."""
        coords = dict(zip(self.mesh.axis_names, idx))
        sizes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        out = []
        for axis in self.spec:
            names = () if axis is None else (axis if isinstance(axis, tuple) else (axis,))
            b = 0
            for a in names:  # row-major over a composite axis
                b = b * sizes[a] + coords[a]
            out.append(b)
        return tuple(out)

    def slices(self, idx: tuple) -> tuple[slice, ...]:
        """The slice of the whole tensor the device at mesh index ``idx`` holds."""
        axes = MeshAxes(self.mesh)
        out = []
        for dim, axis, b in zip(self.shape, self.spec, self._block(idx)):
            n = dim // axes.axis_size(axis)
            out.append(slice(b * n, (b + 1) * n))
        return tuple(out)

    def local_shape(self) -> tuple[int, ...]:
        axes = MeshAxes(self.mesh)
        return tuple(d // axes.axis_size(a) for d, a in zip(self.shape, self.spec))

    def items(self) -> Iterator[tuple[tuple, torch.Tensor]]:
        """(mesh index, shard) of every device, in mesh order."""
        for idx in np.ndindex(self.shards.shape):
            yield idx, self.shards[idx]

    def unique(self) -> list[tuple[tuple, torch.Tensor]]:
        """(mesh index, shard) of the first device holding each block, in
        mesh order: the shards that tile the whole tensor once."""
        seen, out = set(), []
        for idx, t in self.items():
            key = self._block(idx)
            if key not in seen:
                seen.add(key)
                out.append((idx, t))
        return out

    @property
    def device(self) -> torch.device:
        return self.shards.flat[0].device

    def local(self, k: int) -> torch.Tensor:
        """The shard of the k-th mesh device (flat mesh order)."""
        return self.shards.flat[k]

    # -- construction and gathers ----------------------------------------------

    @classmethod
    def place(cls, mesh, spec: P, whole: torch.Tensor) -> "Sharded":
        """``whole`` split onto ``mesh``: each device gets a copy of its slice."""
        shards = np.empty(mesh.devices.shape, dtype=object)
        out = cls(mesh, spec, tuple(whole.shape), whole.dtype, shards)
        with torch.no_grad():
            for idx in np.ndindex(shards.shape):
                part = whole[out.slices(idx)]
                t = torch.empty(part.shape, dtype=whole.dtype, device=mesh.devices[idx])
                shards[idx] = t.copy_(part)
        return out

    @classmethod
    def zeros(cls, mesh, spec: P, shape: tuple, dtype: torch.dtype) -> "Sharded":
        """Zeros of ``shape`` split onto ``mesh``: each device's shard
        allocated on it (no whole tensor anywhere)."""
        shards = np.empty(mesh.devices.shape, dtype=object)
        out = cls(mesh, spec, tuple(shape), dtype, shards)
        local = out.local_shape()
        for idx in np.ndindex(shards.shape):
            shards[idx] = torch.zeros(local, dtype=dtype, device=mesh.devices[idx])
        return out

    def new_zeros(self, shape=None, *, dtype: torch.dtype | None = None, **_kw) -> "Sharded":
        """Zeros of ``dtype`` with this tensor's spec (``shape`` must be its own)."""
        if shape is not None and torch.Size(shape) != self.shape:
            raise ValueError(f"new_zeros{tuple(shape)} of a sharded {tuple(self.shape)}")
        dtype = self.dtype if dtype is None else dtype
        shards = np.empty(self.shards.shape, dtype=object)
        for idx, t in self.items():
            shards[idx] = torch.zeros(t.shape, dtype=dtype, device=t.device)
        return Sharded(self.mesh, self.spec, tuple(self.shape), dtype, shards)

    def gather_into(self, out: torch.Tensor) -> torch.Tensor:
        """All-gather: copy each block into its slice of ``out`` (the whole
        shape), blocks in mesh order."""
        with torch.no_grad():
            for idx, t in self.unique():
                out[self.slices(idx)].copy_(t)
        return out

    def gather(self, device) -> torch.Tensor:
        """The whole tensor on ``device``."""
        return self.gather_into(torch.empty(self.shape, dtype=self.dtype, device=device))

    def __repr__(self) -> str:
        return (f"Sharded({tuple(self.shape)}, {self.dtype}, {self.spec}, "
                f"local {self.local_shape()})")


def _stack_depth(leaf) -> int:
    depth = 0
    while isinstance(leaf, list):
        depth, leaf = depth + 1, leaf[0]
    return depth


def place_leaf(mesh, leaf, spec: P):
    """A layout leaf (a tensor or a ``Stack``) placed by its spec: a
    ``Stack`` becomes a ``Stack`` of per-layer ``Sharded`` with the spec
    past its stacked axes.  Where the spec shards a stacked axis (the
    rank rule reads gemma3's per-head (L, D) q_norm / k_norm as a
    matrix), no per-layer slice is a layer's own: each layer's tensor is
    replicated whole."""
    inner = layer_spec(leaf, spec)
    return stack_map(lambda t: Sharded.place(mesh, inner, torch.as_tensor(t)), leaf)


def layer_spec(leaf, spec: P) -> P:
    """The spec each per-layer tensor of a layout leaf is placed by (see
    ``place_leaf``)."""
    depth = _stack_depth(leaf)
    spec = tuple(spec)
    inner = P(*spec[depth:])
    if any(a is not None for a in spec[:depth]):
        inner = P(*(None for _ in inner))
    return inner


def place_tree(mesh, tree: Any, specs: Any):
    """Every leaf of a JAX-layout ``tree`` placed by the matching spec of
    ``specs`` (a tree of ``P`` of the same structure)."""
    return tree_map(lambda leaf, spec: place_leaf(mesh, leaf, spec), tree, specs)


def local_tree(tree: Any, k: int):
    """The k-th mesh device's shards of a placed tree, in its structure."""
    return tree_map(lambda leaf: stack_map(lambda s: s.local(k), leaf), tree)


def gather_tree(tree: Any, device) -> Any:
    """A placed tree's whole tensors on ``device`` (a ``Stack`` kept a
    ``Stack`` of whole per-layer tensors)."""
    return tree_map(lambda leaf: stack_map(lambda s: s.gather(device), leaf), tree)


def zeros_like_cache(mesh, shape, specs, make=None):
    """A cache of ``Sharded`` zeros in ``specs``' layout (``cache_pspecs``)
    beside ``shape`` (the model's cache on the meta device: a list of
    per-segment tuples, a dict, a tuple), each device's shard allocated
    where it lives; ``make(mesh, spec, shape, dtype)`` makes a leaf
    (default ``Sharded.zeros``)."""
    make = Sharded.zeros if make is None else make
    if isinstance(shape, dict):
        return {k: zeros_like_cache(mesh, shape[k], specs[k], make) for k in shape}
    if isinstance(shape, (list, tuple)):
        return type(shape)(zeros_like_cache(mesh, t, s, make) for t, s in zip(shape, specs))
    return make(mesh, specs, tuple(shape.shape), shape.dtype)
