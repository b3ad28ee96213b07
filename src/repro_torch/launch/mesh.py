"""Device meshes: the port's copy of ``repro.launch.mesh``.

A ``Mesh`` is an array of ``torch.device`` with one named axis per
dimension, driven by ONE process: the mesh engine
(``repro_torch.core.engine``) runs its shard program over it as plain
tensor ops and device copies, with no ``torch.distributed``.  A device may
appear several times — logical shards that share it, the port's
counterpart of the JAX package's ``--xla_force_host_platform_device_count``
fake devices: ``make_host_mesh(2, 4, devices=["cuda:0"] * 8)`` on one card,
``["cpu"] * 8`` in the tests.

Without ``devices`` a mesh takes every visible card; with no card, or too
few for the shape, it raises.  It never drops to the CPU unless the CPU is
named.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _device(d) -> torch.device:
    """One mesh device; a bare ``'cuda'`` resolves to the current card, and
    a CUDA device with no card raises."""
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"mesh device {str(dev)!r} requested but torch sees no CUDA device; "
                "pass devices=['cpu'] * n for a mesh of logical CPU shards"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _visible_cards(n: int | None) -> list[torch.device]:
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "a mesh over the visible cards needs a card, and torch sees no CUDA "
            "device; pass devices=['cpu'] * n for a mesh of logical CPU shards"
        )
    if n is not None and count < n:
        raise RuntimeError(
            f"a mesh of {n} devices needs {n} cards, torch sees {count}; pass "
            f"devices=['cuda:0'] * {n} for logical shards on one card"
        )
    return [torch.device("cuda", i) for i in range(count if n is None else n)]


class Mesh:
    """Named axes over an array of devices, like ``jax.sharding.Mesh``.

    ``devices`` is an array (or nested list) of devices with one dimension
    per name in ``axis_names``; ``.shape`` maps each axis to its size in
    axis order.  Two meshes are equal when their axis names and devices
    are, so the engine cache keys on the mesh's value."""

    def __init__(self, devices, axis_names) -> None:
        names = tuple(axis_names)
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != len(names):
            raise ValueError(
                f"devices of shape {grid.shape} do not match axis names {names}"
            )
        if len(set(names)) != len(names):
            raise ValueError(f"axis names {names} repeat")
        if grid.size == 0:
            raise ValueError("a mesh needs at least one device")
        flat = [_device(d) for d in grid.flat]
        self.devices = np.empty(grid.shape, dtype=object)
        for i, d in enumerate(flat):
            self.devices.flat[i] = d
        self.axis_names = names

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device_at(self, coords: dict[str, int]) -> torch.device:
        """The device at ``coords`` (axis -> index; a missing axis is 0)."""
        return self.devices[tuple(coords.get(ax, 0) for ax in self.axis_names)]

    def _key(self) -> tuple:
        return self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})})"


def check_mesh(mesh) -> Mesh:
    """``mesh`` itself, or a ``TypeError`` for anything but a ``Mesh``."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a repro_torch.launch.mesh.Mesh, got {type(mesh).__name__}")
    return mesh


def _make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], devices) -> Mesh:
    n = math.prod(shape)
    devs = _visible_cards(n) if devices is None else list(devices)
    if len(devs) != n:
        raise ValueError(f"mesh shape {shape} needs {n} devices, got {len(devs)}")
    grid = np.empty(n, dtype=object)
    for i, d in enumerate(devs):
        grid[i] = d
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """16x16 = 256 devices per pod; ``multi_pod`` stacks 2 pods (512).

    Axes: ``data`` (batch), ``model`` (CAM rows); ``pod`` (multi-pod) acts
    as outer data parallelism."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, devices)


def make_host_mesh(n_data: int | None = None, n_model: int | None = None, *,
                   devices=None) -> Mesh:
    """A small ``("data", "model")`` mesh over ``devices`` (default: every
    visible card).  Without both sizes, ``model`` takes 4 or 2 devices where
    the count divides, and ``data`` the rest."""
    if devices is None:
        n = len(_visible_cards(None)) if n_data is None or n_model is None else None
    else:
        devices = list(devices)
        n = len(devices)
    if n_data is None or n_model is None:
        n_model, n_data = 1, n
        for m in (4, 2):
            if n % m == 0:
                n_model, n_data = m, n // m
                break
    return _make_mesh((n_data, n_model), ("data", "model"), devices)
