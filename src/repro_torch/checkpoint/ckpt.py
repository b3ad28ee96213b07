"""Checkpointing: atomic, async-capable, device-elastic.

The port of ``repro.checkpoint.ckpt``, on trees of nested dicts, lists,
tuples and namedtuples whose leaves are tensors, numpy arrays or numbers
(``None`` is an empty subtree).  The LM half's JAX-layout trees
(``repro_torch.models.common``) checkpoint as the JAX package's parameter
pytrees: a ``Record`` as its NamedTuple (``.field``, in field order) and a
``Stack`` of per-layer tensors as one stacked leaf.  The format is the
JAX package's: one
``.npz`` per step holding every leaf under its key path — exactly
``jax.tree_util.keystr`` of the same structure (``['params']['w']``,
``[0]``, ``.field``, dict keys in sorted order) — plus a small JSON
manifest, so a checkpoint written by either package restores in the
other, bit for bit.  Leaves are gathered to the host, so a checkpoint
written on one device (or mesh) restores onto any other; dtypes that npz
cannot hold (bfloat16, the float8s) are stored as float32, which holds
them exactly, and cast back to the template's dtype.  A leaf placed on
a mesh (``repro_torch.sharding.placement.Sharded``) is saved whole and
restored whole on the host, for the caller's placer to split onto its
mesh.

Atomicity: write to ``<dir>/tmp.<step>.npz`` then ``os.replace`` into
place — a crash mid-write never corrupts the latest checkpoint.
``CheckpointManager(async_save=True)`` snapshots to host memory
synchronously and writes on a background thread.
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.common import Record, Stack
from repro_torch.sharding.placement import Sharded

_STEP_FILE = re.compile(r"step_(\d+)\.npz")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    """(key path, leaf) pairs in the JAX package's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, Record):
        return [kv for f, v in tree.items() for kv in _leaves(v, f"{path}.{f}")]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, Stack):
        return [(path, tree)]
    if _is_namedtuple(tree):
        return [kv for f, v in zip(tree._fields, tree) for kv in _leaves(v, f"{path}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _leaves(v, f"{path}[{i}]")]
    return [(path, tree)]


def _map_leaves(fn: Callable[[str, Any], Any], tree: Any, path: str = "") -> Any:
    """``tree`` with each leaf replaced by ``fn(key path, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, Record):
        return Record((f, _map_leaves(fn, v, f"{path}.{f}")) for f, v in tree.items())
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, tree[k], f"{path}[{k!r}]") for k in sorted(tree)}
    if isinstance(tree, Stack):
        return fn(path, tree)
    if _is_namedtuple(tree):
        return type(tree)(*(_map_leaves(fn, v, f"{path}.{f}")
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, f"{path}[{i}]") for i, v in enumerate(tree))
    return fn(path, tree)


def _host_copy(leaf) -> np.ndarray:
    """A host numpy copy of ``leaf`` that npz can store (float32 for the
    dtypes it cannot), taken now: later in-place writes do not reach it.
    A ``Stack`` is stacked on a leading axis; a ``Sharded`` tensor is
    gathered whole."""
    if isinstance(leaf, Stack):
        return np.stack([_host_copy(x) for x in leaf])
    if isinstance(leaf, Sharded):
        leaf = leaf.gather("cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        try:
            return t.numpy()
        except TypeError:  # bfloat16, float8: float32 holds them exactly
            return t.to(torch.float32).numpy()
    arr = np.array(leaf, copy=True)
    if arr.dtype.kind not in "biufc":  # ml_dtypes (bfloat16, fp8)
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {key: _host_copy(leaf) for key, leaf in _leaves(tree)}


def _restored(key: str, arr: np.ndarray, tmpl) -> Any:
    """``arr`` checked against the template leaf's shape and cast to its
    dtype: a tensor on the template tensor's device, else a numpy array
    (a number's template is its 0-d array; a ``Stack``'s, a ``Stack`` of
    its rows)."""
    if isinstance(tmpl, Stack):
        if arr.shape[:1] != (len(tmpl),):
            raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs model a stack "
                             f"of {len(tmpl)}")
        return Stack(_restored(key, a, t) for a, t in zip(arr, tmpl))
    if not hasattr(tmpl, "shape"):
        tmpl = np.asarray(tmpl)
    if tuple(arr.shape) != tuple(tmpl.shape):
        raise ValueError(
            f"shape mismatch for {key}: ckpt {arr.shape} vs model {tuple(tmpl.shape)}"
        )
    if isinstance(tmpl, torch.Tensor) or isinstance(getattr(tmpl, "dtype", None), torch.dtype):
        device = tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu"
        return torch.as_tensor(arr).to(device=device, dtype=tmpl.dtype)
    return arr.astype(tmpl.dtype)


def _write(ckpt_dir: str, step: int, flat: dict[str, np.ndarray], extra: dict | None) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}.npz")
    final = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, final)
    manifest = {"step": step, "n_leaves": len(flat), **(extra or {})}
    mtmp = os.path.join(ckpt_dir, f"tmp.{step}.json")
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(ckpt_dir, f"step_{step:08d}.json"))
    return final


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None) -> str:
    """Write ``tree`` as step ``step``; returns the ``.npz`` path."""
    return _write(ckpt_dir, step, _flatten(tree), extra)


def _steps(ckpt_dir: str) -> list[int]:
    return sorted(int(m.group(1)) for fn in os.listdir(ckpt_dir)
                  if (m := _STEP_FILE.fullmatch(fn)))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(
    ckpt_dir: str,
    template: Any,
    step: int | None = None,
    placer: Callable[[Any], Any] | None = None,
) -> tuple[int, Any]:
    """Restore into the structure of ``template`` (a tree of tensors,
    arrays, or objects with ``.shape`` and ``.dtype``): each leaf takes
    its template's dtype, and a tensor template's device.  ``placer``
    re-places the restored tree (onto the card, or onto a mesh's
    devices); identity when None."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}

    def leaf(key: str, tmpl) -> Any:
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        return _restored(key, data[key], tmpl)

    tree = _map_leaves(leaf, template)
    if placer is not None:
        tree = placer(tree)
    return step, tree


class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; optional async writes."""

    def __init__(self, ckpt_dir: str, keep: int = 3, async_save: bool = True):
        self.dir = ckpt_dir
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree: Any, extra: dict | None = None) -> None:
        self.wait()
        # snapshot to host synchronously (consistent view), write async
        flat = _flatten(tree)

        def _write_and_gc():
            try:
                _write(self.dir, step, flat, extra)
                self._gc()
            except BaseException as e:  # noqa: BLE001 - surfaced on the next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=_write_and_gc, daemon=True)
            self._thread.start()
        else:
            _write_and_gc()
            self.wait()

    def _gc(self) -> None:
        for s in _steps(self.dir)[: -self.keep]:
            for ext in ("npz", "json"):
                try:
                    os.remove(os.path.join(self.dir, f"step_{s:08d}.{ext}"))
                except FileNotFoundError:
                    pass
