"""PartitionSpec rules: TP on heads / ffn / experts / vocab, FSDP wrap on
the data axis, EP for MoE — the port of ``repro.sharding.partition``.

The rules are the JAX package's, derived from parameter *names* (the
last key of a leaf's path in the JAX layout) with shape-aware fallbacks,
and fitted for divisibility (axes that do not divide a dim are dropped
from its spec rather than producing uneven shards).

Conventions (single-pod mesh ("data", "model"); multi-pod adds a leading
"pod" axis used as extra data parallelism / FSDP):

  embed (V, d)            -> (tp, fsdp)        vocab-sharded embedding
  lm_head (d, V)          -> (fsdp, tp)
  wq/wk/wv (d, H*hd)      -> (fsdp, tp)        column parallel
  wo (H*hd, d)            -> (tp, fsdp)        row parallel
  ffn w_gate/w_up (d, f)  -> (fsdp, tp)
  ffn w_down (f, d)       -> (tp, fsdp)
  moe router (d, E)       -> (fsdp, None)
  moe w_* (E, d, f)       -> (EP on E, fsdp, None)
  1-D / scalar leaves     -> replicated

Trees are the port's JAX layout (``repro_torch.models.common``): a
``Stack`` leaf has its stacked shape (each stack level one leading axis),
and the leading axes the rank rule finds beyond a name's per-layer rank
get None, as the JAX package prepends None for a scan segment.  A spec is
``P``, a tuple whose ``tuple(spec)`` equals ``tuple(PartitionSpec(...))``
of the JAX package.  A mesh is the port's ``Mesh`` or anything with
``axis_names`` and a ``devices`` array (a stand-in of the production mesh
needs no devices).

KV caches (decode): batch over data(+pod); heads on model when divisible
(gemma3/granite have 1 KV head), otherwise the *sequence* axis is sharded
on model — the flash-decode partial-softmax layout
(``repro_torch.models.decode_opt``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.models.common import Record, Stack, first_leaf, layout_shape


class P(tuple):
    """A partition spec: one entry a dim — None (replicated), an axis name,
    or a tuple of axis names (a composite axis)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class MeshAxes:
    """Resolved axis names + sizes for the active mesh."""

    def __init__(self, mesh, *, fsdp: bool = True):
        names = tuple(mesh.axis_names)
        sizes = dict(zip(names, np.shape(mesh.devices)))
        self.sizes = sizes
        self.model = "model" if "model" in names else None
        self.data = "data" if "data" in names else None
        self.pod = "pod" if "pod" in names else None
        self.fsdp_enabled = fsdp
        if not fsdp:
            self.fsdp: Any = None
        elif self.pod and self.data:
            self.fsdp = ("pod", "data")
        else:
            self.fsdp = self.data

    def axis_size(self, axis) -> int:
        if axis is None:
            return 1
        if isinstance(axis, tuple):
            return int(np.prod([self.sizes[a] for a in axis]))
        return int(self.sizes.get(axis, 1))

    def batch_axes(self) -> tuple:
        return tuple(a for a in (self.pod, self.data) if a)

    def fit(self, spec: tuple, shape: tuple) -> P:
        """Drop axes that do not evenly divide their dim."""
        out = []
        for axis, dim in zip(spec, shape):
            if axis is None:
                out.append(None)
            elif dim % self.axis_size(axis) == 0:
                out.append(axis)
            elif isinstance(axis, tuple):
                # try a prefix of the composite axis (e.g. just 'pod')
                kept = None
                for cut in range(len(axis) - 1, 0, -1):
                    sub = axis[:cut]
                    if dim % self.axis_size(sub) == 0:
                        kept = sub if len(sub) > 1 else sub[0]
                        break
                out.append(kept)
            else:
                out.append(None)
        return P(*out)


_ROW_PARALLEL = {"wo", "w_down", "out_proj", "cv", "wuv"}  # contraction dim sharded
_COL_PARALLEL = {
    "wq", "wk", "wv", "w_gate", "w_up", "in_proj", "wuq", "wuk",
    "wr", "wg", "ck", "cr", "w1", "wdq", "wdkv", "wkr", "proj",
}
_REPLICATED_2D = {"conv_w", "w_lora_a", "w_lora_b"}
_VECTOR_NAMES = {
    "ln1", "ln2", "ln_x", "post_ln1", "post_ln2", "norm", "q_ln", "kv_ln",
    "mamba_ln", "ln_scale", "ln_bias", "b1", "b2", "conv_b", "a_log",
    "d_skip", "dt_bias", "u", "w0", "final_norm", "enc_norm", "ln_in",
    "ln_in_b", "ln",
}


# ---------------------------------------------------------------------------
# Trees: the JAX layout of parameters, and caches of nested lists/tuples/dicts
# ---------------------------------------------------------------------------


def map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over the leaves of ``tree`` in the JAX package's
    flatten order, into its structure: a ``Record``'s fields in order, a
    dict's keys sorted, a list's or tuple's items by index (path entry
    ``"[i]"``, as ``str`` of JAX's ``SequenceKey``); a ``Stack`` or a
    ``P`` is one leaf, None an empty subtree."""
    if tree is None:
        return None
    if isinstance(tree, Record):
        return Record((k, map_with_path(fn, v, path + (k,))) for k, v in tree.items())
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], path + (k,)) for k in sorted(tree)}
    if isinstance(tree, (Stack, P)):
        return fn(path, tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (f"[{i}]",)) for i, v in enumerate(tree))
    return fn(path, tree)


def leaves_with_path(tree) -> list[tuple[tuple, Any]]:
    """(path, leaf) of ``tree`` in flatten order (``map_with_path``'s)."""
    out: list = []
    map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out


def leaf_axes(spec, axes: MeshAxes) -> tuple[int | None, int | None]:
    """(the dim a fitted ``spec`` puts on `model`, the dim it puts on the
    fsdp (batch) axes), None where it puts none: the split program reads
    which slice of a leaf a device computes with, and which dim it gathers
    over the data axis, from this alone (an axis ``fit`` dropped is no
    split: the leaf is whole on every model shard)."""
    model = fsdp = None
    batch = set(axes.batch_axes())
    for i, axis in enumerate(tuple(spec)):
        names = () if axis is None else (axis if isinstance(axis, tuple) else (axis,))
        if axes.model is not None and axes.model in names:
            model = i
        if batch & set(names):
            fsdp = i
    return model, fsdp


def _shape(leaf) -> tuple[int, ...]:
    return layout_shape(leaf) if isinstance(leaf, list) else tuple(leaf.shape)


def _leaf_name(path) -> str:
    return str(path[-1])


def _core_rank(name: str, shape: tuple, cfg) -> int:
    """Rank of the per-layer (unstacked) parameter for this name."""
    if name in _VECTOR_NAMES or name.startswith("mu_"):
        return 1
    if name == "w2":
        return 2
    if cfg is not None and getattr(cfg, "n_experts", 0):
        if name in ("w_gate", "w_up", "w_down") and cfg.n_experts in shape:
            return 3  # (E, d, f)
    return 2


def _core_spec(name: str, shape: tuple, cfg, axes: MeshAxes) -> tuple:
    tp, fsdp = axes.model, axes.fsdp
    nd = len(shape)
    if nd == 1:
        return (None,)
    if nd == 3:
        return (tp, fsdp, None)  # expert weights: EP + FSDP
    if nd == 2:
        v = getattr(cfg, "vocab_size", -1) if cfg is not None else -1
        if name == "embed" and shape[0] == v:
            return (tp, fsdp)
        if name == "lm_head":
            return (fsdp, tp)
        if name in _REPLICATED_2D:
            return (None, None)
        if name in _ROW_PARALLEL or name == "w2":
            return (tp, fsdp)
        if name in _COL_PARALLEL:
            return (fsdp, tp)
        if name == "router":
            return (fsdp, None)
        return (fsdp, tp) if shape[1] >= shape[0] else (tp, fsdp)
    return tuple(None for _ in shape)


def _spec_for_leaf(path, leaf, cfg, axes: MeshAxes) -> P:
    name = _leaf_name(path)
    shape = _shape(leaf)
    if len(shape) == 0:
        return P()
    core = _core_rank(name, shape, cfg)
    stack = max(0, len(shape) - core)
    spec = _core_spec(name, shape[stack:], cfg, axes)
    return axes.fit(tuple([None] * stack) + tuple(spec), shape)


def param_pspecs(params_shape: Any, cfg, axes: MeshAxes):
    """A tree of ``P`` matching a params tree: a params module (its
    ``jax_layout()``) or a JAX-layout tree of tensors (meta tensors for
    shapes only), numpy arrays or ``Stack``s, one spec a leaf."""
    tree = params_shape.jax_layout() if hasattr(params_shape, "jax_layout") else params_shape
    return map_with_path(lambda path, leaf: _spec_for_leaf(path, leaf, cfg, axes), tree)


def batch_pspec(axes: MeshAxes) -> P:
    b = axes.batch_axes()
    return P(b if len(b) > 1 else (b[0] if b else None))


def _batch_entry(axes: MeshAxes):
    b = axes.batch_axes()
    return b if len(b) > 1 else (b[0] if b else None)


def _cache_spec(path, leaf, cfg, axes: MeshAxes) -> P:
    shape = _shape(leaf)
    name = _leaf_name(path)
    bspec = _batch_entry(axes)
    tp = axes.model
    tp_size = axes.axis_size(tp)
    if name == "conv" and len(shape) == 5:  # (G, P, B, W-1, C) zamba conv tail
        spec = (None, None, bspec, None, None)
    elif len(shape) == 5 and shape[3] == shape[4]:  # (L, B, H, dk, dv) rwkv state
        spec = (None, bspec, tp, None, None)
    elif len(shape) == 5:  # (L, B, S, KV, D) attention cache
        if shape[3] % tp_size == 0:
            spec = (None, bspec, None, tp, None)
        else:
            spec = (None, bspec, tp, None, None)  # sequence-sharded KV
    elif len(shape) == 6:  # (G, P, B, H, Pd, N) zamba ssm state
        spec = (None, None, bspec, tp, None, None)
    elif len(shape) == 4:
        if name == "ssm" or shape[-1] == shape[-2]:  # rwkv (L,B,hd,hd)-ish state
            spec = (None, bspec, None, None)
        else:  # (L, B, S, lora) MLA compressed cache: shard sequence
            spec = (None, bspec, tp, None)
    elif len(shape) == 3:
        spec = (None, bspec, None)
    elif len(shape) == 2:
        spec = (bspec, None)
    else:
        spec = tuple(None for _ in shape)
    return axes.fit(spec, shape)


def cache_pspecs(cache_shape: Any, cfg, axes: MeshAxes):
    """A tree of ``P`` matching a cache (``LMBundle.cache_shape(b, s)``:
    a list of per-segment (k, v) tuples, the hybrid's and whisper's dicts,
    rwkv's 3-tuple)."""
    return map_with_path(lambda path, leaf: _cache_spec(path, leaf, cfg, axes), cache_shape)


class ActivationSharder:
    """``shard_x(t)``: the layout hint for activations between blocks.

    The JAX package's ``with_sharding_constraint`` (Megatron-SP style):
    batch over (pod, data); a full-sequence activation (B, S, d) also has
    its *sequence* axis on `model` when it divides.  The constraint leaves
    the value as it is, and so does this call.  The layout is kept by the
    mesh step itself (``repro_torch.launch.train``): for every LM family
    its split program (``repro_torch.sharding.split``) holds each data
    group's activations between blocks sequence-sharded over the group's
    `model` devices exactly where ``spec`` puts `model` on the sequence
    (whisper's encoder states over its frames, its decoder's over its
    tokens), and replicated where it does not.  ``spec(shape)`` is the fitted spec
    the JAX package would constrain to (None where it leaves the tensor
    alone)."""

    def __init__(self, mesh, axes: MeshAxes | None = None):
        self.axes = axes or MeshAxes(mesh)

    def spec(self, shape: tuple) -> P | None:
        axes = self.axes
        bspec = _batch_entry(axes)
        tp = axes.model
        tp_size = axes.axis_size(tp)
        shape = tuple(shape)
        if len(shape) == 3:
            if shape[1] > 1 and shape[1] % tp_size == 0:
                spec = (bspec, tp, None)  # sequence-parallel between blocks
            else:
                spec = (bspec, None, None)
        elif len(shape) == 2:
            spec = (bspec, None)
        else:
            return None
        return axes.fit(spec, shape)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t


def activation_sharder(mesh, axes: MeshAxes | None = None) -> ActivationSharder:
    """The ``shard_x`` hook a launcher sets on a model (``model.shard_x``)."""
    return ActivationSharder(mesh, axes)


@dataclass(frozen=True)
class ShardedShape:
    """A shape stand-in with its spec on a mesh (the JAX package's
    ``ShapeDtypeStruct`` with a ``NamedSharding``)."""

    shape: tuple
    dtype: torch.dtype
    spec: P
    mesh: Any

    def local_shape(self) -> tuple:
        """The shape of one device's shard."""
        axes = MeshAxes(self.mesh)
        return tuple(d // axes.axis_size(a) for d, a in
                     zip(self.shape, tuple(self.spec) + (None,) * len(self.shape)))

    def local_bytes(self) -> int:
        """The bytes one device holds of this leaf."""
        n = int(np.prod(self.local_shape(), dtype=np.int64))
        return n * torch.empty((), dtype=self.dtype).element_size()


def attach(mesh, tree_shape: Any, specs: Any):
    """``ShardedShape`` stand-ins of ``tree_shape``'s leaves (tensors,
    meta tensors or ``Stack``s) with the matching spec of ``specs``."""
    spec_list = [s for _, s in leaves_with_path(specs)]
    it = iter(spec_list)

    def one(_path, leaf):
        return ShardedShape(_shape(leaf), first_leaf(leaf).dtype, next(it), mesh)

    tree = tree_shape.jax_layout() if hasattr(tree_shape, "jax_layout") else tree_shape
    out = map_with_path(one, tree)
    if next(it, None) is not None:
        raise ValueError("specs has more leaves than the tree")
    return out
