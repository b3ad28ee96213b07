"""The cost of one eager call, counted op by op: the dry run's counterpart
of ``hlo_analysis.analyze``.

``OpCounter`` is a ``TorchDispatchMode``.  Run a call under it, on meta
tensors at full size (no memory, no arithmetic) or on real ones, and it
counts every aten op that call dispatches:

  * **dot FLOPs**: the ops and formulas ``torch.utils.flop_counter``
    counts (mm, addmm, bmm, baddbmm, the einsums they come from,
    convolutions, attention kernels), an op outside its table decomposed
    first as ``FlopCounterMode`` decomposes it, so the two give one count
    on the same call; the counterpart of ``HLOCost.dot_flops``;
  * **op bytes**: the inputs plus the outputs of every op that moves data
    (views and allocations move none).  Eager PyTorch materialises every
    op's result, so this is the port's counterpart of XLA's
    fusion-boundary bytes, not the same quantity: a fused program moves
    fewer;
  * **temp bytes**: the peak bytes of the storages the call allocated that
    were alive at once (storages from before the call are its arguments),
    each freed when its last tensor is (a finalizer on the storage), the
    counterpart of XLA's ``memory_analysis().temp_size_in_bytes``;
    ``end_bytes``: those still alive when the call returns (its outputs).

Bytes come from each tensor's shape and dtype (``numel * itemsize``, an
expanded input counted at its expanded size), read off the op's own
arguments and results; nothing is flattened beyond a list argument.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd
_aten = torch.ops.aten
# ops that allocate storage without reading or writing it (views are
# told apart by ``OpOverload.is_view``)
_NO_DATA = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.new_empty.default,
            _aten.new_empty_strided.default, _aten.empty_like.default}


@dataclass
class OpCost:
    """What ``OpCounter`` counted over one call."""

    dot_flops: float = 0.0
    op_bytes: float = 0.0
    temp_bytes: int = 0
    end_bytes: int = 0
    n_ops: int = 0
    excluded_bytes: int = 0


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(t.numel() * t.element_size() for t in x if isinstance(t, torch.Tensor))
    return 0


class _Live:
    """The storages a counted call allocated, and the peak of their bytes."""

    def __init__(self) -> None:
        self.storages: dict[int, int] = {}  # storage key -> bytes
        self.bytes = 0
        self.peak = 0

    def add(self, storage: torch.UntypedStorage) -> None:
        key = storage._cdata
        n = storage.nbytes()
        self.storages[key] = n
        self.bytes += n
        self.peak = max(self.peak, self.bytes)
        weakref.finalize(storage, self.drop, key)

    def drop(self, key: int) -> None:
        self.bytes -= self.storages.pop(key)


class OpCounter(TorchDispatchMode):
    """``with OpCounter() as c: fn(...)``, then ``c.cost()``.  ``exclude``
    (a callable): storages allocated while it returns True are kept out of
    the temps, their own peak ``excluded_bytes`` (the dry run's FSDP
    gathers)."""

    def __init__(self, exclude=None) -> None:
        super().__init__()
        self.flops_table = FlopCounterMode(display=False).flop_registry
        self.dot_flops = 0.0
        self.op_bytes = 0.0
        self.n_ops = 0
        self.live = _Live()
        self.excluded = _Live()
        self.exclude = exclude
        self._decomposes: dict = {}

    def _has_decomposition(self, func) -> bool:
        known = self._decomposes.get(func)
        if known is None:
            # as FlopCounterMode: any op with an implicit decomposition
            known = (func is not torch.ops.prim.device.default
                     and (_COMPOSITE in func.py_kernels
                          or torch._C._dispatch_has_kernel_for_dispatch_key(
                              func.name(), _COMPOSITE)))
            self._decomposes[func] = known
        return known

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._has_decomposition(func):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        self.n_ops += 1
        count = self.flops_table.get(func._overloadpacket)
        if count is not None:
            self.dot_flops += count(*args, **kwargs, out_val=out)
        if func.is_view:
            return out
        outs = out if isinstance(out, (list, tuple)) else (out,)
        if func not in _NO_DATA:
            self.op_bytes += (sum(_tensor_bytes(a) for a in args)
                              + sum(_tensor_bytes(v) for v in kwargs.values())
                              + sum(_tensor_bytes(o) for o in outs))
        for o in outs:
            if isinstance(o, torch.Tensor):
                self._allocated(o, (*args, *kwargs.values()))
        return out

    def _allocated(self, t: torch.Tensor, args) -> None:
        """Track ``t``'s storage unless an argument owns it (an in-place op
        or an ``out=`` returns its input)."""
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self.live.storages or key in self.excluded.storages:
            return
        for a in args:
            if isinstance(a, torch.Tensor) and a.untyped_storage()._cdata == key:
                return
        excluded = self.exclude is not None and self.exclude()
        (self.excluded if excluded else self.live).add(storage)

    def cost(self) -> OpCost:
        return OpCost(dot_flops=float(self.dot_flops), op_bytes=float(self.op_bytes),
                      temp_bytes=self.live.peak, end_bytes=self.live.bytes, n_ops=self.n_ops,
                      excluded_bytes=self.excluded.peak)


def count(fn, *args, **kwargs) -> tuple[object, OpCost]:
    """(``fn(*args, **kwargs)``, its ``OpCost``)."""
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.cost()
