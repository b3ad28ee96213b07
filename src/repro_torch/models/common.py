"""Shared building blocks: norms, RoPE, embeddings, init, dtype policy.

The port of ``repro.models.common`` in torch ops.  The math follows the
JAX functions step for step: norms and RoPE in float32, cast back to the
input's dtype; ``gelu`` is the tanh approximation (``jax.nn.gelu``'s
default).  Initialisers draw from an explicit ``torch.Generator``; they
follow the JAX package's rules (truncated normal, fan-in scaling) but not
its bits — weights are carried across with
``repro_torch.convert.lm_params_from_numpy``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}

# elements of the float32 scratch one initialiser chunk may hold
_INIT_CHUNK = 1 << 26


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# Initializers (all params created in the config dtype)
# ---------------------------------------------------------------------------


def _truncated_normal(shape, std: float, dtype: torch.dtype, *, generator, device):
    """N(0, std²) truncated to ±2 std (inverse-CDF draw in float32, cast to
    ``dtype``), filled in chunks of the leading axis so the float32 scratch
    stays small.  With no ``generator`` (or on the meta device) the tensor
    is left uninitialised."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if generator is None or out.device.type == "meta" or out.numel() == 0:
        return out
    cdf_2 = (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0  # Φ(2); Φ(-2) = 1 - Φ(2)
    lead = shape[0] if len(shape) else 1
    per_row = max(1, out.numel() // max(1, lead))
    step = max(1, _INIT_CHUNK // per_row)
    flat = out.reshape(lead, -1) if len(shape) else out.reshape(1, 1)
    for i in range(0, lead, step):
        rows = flat[i:i + step]
        tmp = torch.empty(rows.shape, dtype=torch.float32, device=out.device)
        tmp.uniform_(1.0 - 2.0 * cdf_2, 2.0 * cdf_2 - 1.0, generator=generator)
        tmp.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)
        rows.copy_(tmp)
    return out


def dense_init(shape, dtype, *, generator, device, in_axis: int = 0) -> torch.Tensor:
    """Truncated-normal fan-in scaling (maxtext-style)."""
    fan_in = shape[in_axis] if isinstance(in_axis, int) else int(
        np.prod([shape[a] for a in in_axis])
    )
    return _truncated_normal(shape, 1.0 / np.sqrt(fan_in), dtype,
                             generator=generator, device=device)


def embed_init(shape, dtype, *, generator, device) -> torch.Tensor:
    """std = 1/sqrt(d_model): keeps tied-head logits O(1) at init."""
    return _truncated_normal(shape, 1.0 / np.sqrt(shape[1]), dtype,
                             generator=generator, device=device)


def uniform_init(shape, low: float, high: float, *, generator, device,
                 dtype=torch.float32) -> torch.Tensor:
    """U(low, high) in ``dtype`` (left uninitialised without a generator or
    on the meta device, as ``_truncated_normal``)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if generator is not None and out.device.type != "meta":
        out.uniform_(low, high, generator=generator)
    return out


def const_param(shape, value: float, dtype, device) -> nn.Parameter:
    """A parameter filled with ``value`` (zeros and ones of the inits)."""
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 math, cast back to input dtype; scales by 1 + scale."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta, device=None) -> torch.Tensor:
    """(head_dim/2,) float32 inverse frequencies; ``theta`` is taken as a
    float32 scalar (the JAX package's per-layer thetas are float32)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    base = torch.tensor(float(theta), dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: broadcastable to (..., S).
    Rotates the two halves of D (not interleaved pairs)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)  # (D/2,)
    ang = positions[..., :, None, None].float() * inv  # (..., S, 1, D/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu(approximate=True)


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return logits
    return cap * torch.tanh(logits / cap)


# ---------------------------------------------------------------------------
# Rematerialisation
# ---------------------------------------------------------------------------


def remat(cfg, fn, *args):
    """``fn(*args)``; under ``cfg.remat`` while autograd records, its
    activations are recomputed in the backward pass instead of kept
    (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint`` of a
    scan body).  Inference forwards run ``fn`` as it is."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean cross entropy in fp32; logits (..., V), labels (...)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


# ---------------------------------------------------------------------------
# The JAX package's parameter layout
# ---------------------------------------------------------------------------


class Record(dict):
    """A parameter NamedTuple of the JAX package (``AttnParams``,
    ``FFNParams``, ...) in the JAX layout: its fields in their declared
    order, in which the JAX package flattens them (dicts flatten in sorted
    key order)."""


class Stack(list):
    """A stacked leaf of the JAX layout: the per-layer tensors of one
    field, stacked on a leading axis in the JAX layout (a Stack of Stacks:
    two axes deep)."""


def _nested(fn, x):
    """``fn`` over the modules of ``x``: a module or a (nested) list of them."""
    return Stack(_nested(fn, v) for v in x) if isinstance(x, list) else fn(x)


def first_leaf(x):
    """The first element of a (nested) list, or ``x`` itself."""
    while isinstance(x, list):
        x = x[0]
    return x


def stacked_layout(mods) -> dict:
    """The JAX layout of one module type: a dict (a ``Record`` where the
    JAX package has a NamedTuple: the module class sets ``NAMEDTUPLE``)
    with, for each of its ``FIELDS``, None, a nested dict, or its tensor.
    ``mods`` is one module (tensor leaves), a list of modules (the layers
    of a stack: a ``Stack`` of per-layer tensors, stacked on a leading
    axis in the JAX layout) or a list of lists (stacked two deep)."""
    first = first_leaf(mods)
    out = Record() if getattr(first, "NAMEDTUPLE", False) else {}
    for name in first.FIELDS:
        val = getattr(first, name)
        if val is None:
            out[name] = None
        elif isinstance(val, nn.Module):
            out[name] = stacked_layout(_nested(lambda m: getattr(m, name), mods))
        else:
            out[name] = _nested(lambda m: getattr(m, name), mods)
    return out


def layout_leaves(tree: dict, path: tuple = ()):
    """(path, leaf) of every leaf of a JAX-layout tree that is not None, in
    sorted key order (a leaf: a tensor, an array or a nested list of
    tensors)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from layout_leaves(v, path + (k,))
        elif v is not None:
            yield path + (k,), v


def layout_shape(leaf) -> tuple[int, ...]:
    """A layout leaf's shape in the JAX layout (each list level stacks on a
    leading axis)."""
    if isinstance(leaf, list):
        return (len(leaf),) + layout_shape(leaf[0])
    return tuple(leaf.shape)


# ---------------------------------------------------------------------------
# Trees in the JAX layout (parameters, gradients, optimizer moments)
# ---------------------------------------------------------------------------


def _keys(tree: dict) -> list:
    """A node's keys in the JAX package's flatten order: a dict's sorted, a
    ``Record``'s in its field order."""
    return list(tree) if isinstance(tree, Record) else sorted(tree)


def tree_leaves(tree, path: tuple = ()):
    """(path, leaf) of every leaf of a JAX-layout tree that is not None, in
    the JAX package's flatten order.  A leaf is a tensor, an array or a
    ``Stack``."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in _keys(tree):
            yield from tree_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def tree_map(fn, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over the leaves of a
    JAX-layout tree (a ``Stack`` is one leaf), in flatten order, into its
    structure (None kept)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, tree[k], *(r[k] for r in rest)))
                          for k in _keys(tree))
    return fn(tree, *rest)


def leaf_tensors(leaf) -> list:
    """The tensors of one leaf: itself, or a ``Stack``'s in stack order."""
    if isinstance(leaf, list):
        return [t for x in leaf for t in leaf_tensors(x)]
    return [leaf]


def stack_map(fn, leaf, *rest):
    """``fn`` over the tensors of one leaf (and the matching tensors of
    ``rest``), in the leaf's structure."""
    if isinstance(leaf, list):
        return Stack(stack_map(fn, *xs) for xs in zip(leaf, *rest))
    return fn(leaf, *rest)


def tree_tensors(tree) -> list:
    """Every tensor of a JAX-layout tree, leaves in flatten order and each
    ``Stack``'s tensors in stack order."""
    return [t for _, leaf in tree_leaves(tree) for t in leaf_tensors(leaf)]


def tree_zeros(tree, dtype: torch.dtype) -> dict:
    """Zeros of ``dtype`` beside every tensor of ``tree``, in its structure
    (``new_zeros``: on each tensor's device, or each shard's)."""
    return tree_map(lambda leaf: stack_map(
        lambda t: t.new_zeros(t.shape, dtype=dtype), leaf), tree)


def tree_like(tree, tensors) -> dict:
    """``tensors`` (in ``tree_tensors(tree)``'s order) in ``tree``'s
    structure."""
    it = iter(tensors)
    return tree_map(lambda leaf: stack_map(lambda _: next(it), leaf), tree)
