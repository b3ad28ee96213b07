"""AdamW on the port's parameters: global-norm clipping, decoupled weight
decay (matrix parameters only), warmup + cosine schedule, configurable
moment dtype.

The port of ``repro.optim.adamw``, the reference's formula as it stands,
elementwise in float32: the clip scale from the global gradient norm
(leaves summed in the JAX package's flatten order), the bias corrections
``1 - b ** step`` taken in float32, ``mhat / (sqrt(vhat) + eps)`` and
decoupled decay, each result cast back to its parameter's dtype and the
moments kept in ``moment_dtype``.  Not ``torch.optim.AdamW``: its eps
placement and its in-place bfloat16 update round differently.

Trees are in the JAX layout (``repro_torch.models.common``): a params
module (anything with ``jax_layout()``) or nested dicts whose leaves are
tensors or ``Stack``s of per-layer tensors.  The decay mask is taken on
that layout, where a stacked per-layer norm scale is 2-D and decayed, as
in the JAX package.  ``update`` writes the new parameters and moments into
the tensors it is given (under ``torch.no_grad``) and returns them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models.common import (
    layout_shape,
    leaf_tensors,
    tree_leaves,
    tree_map,
    tree_tensors,
    tree_zeros,
)


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"  # 'bfloat16' halves optimizer memory


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor or an int) as a float32
    tensor, op for op as the JAX package computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(1.0, cfg.decay_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cos)


def as_tree(params: Any):
    """``params`` in the JAX layout: a module's ``jax_layout()``, else
    ``params`` itself (already a tree)."""
    return params.jax_layout() if hasattr(params, "jax_layout") else params


def _decay_mask(params: Any):
    """Weight decay on >= 2-D weights only (norms, biases, scalars exempt),
    taken on the JAX layout: a tree of 1.0 / 0.0, one a leaf."""
    return tree_map(lambda p: float(len(layout_shape(p)) >= 2), as_tree(params))


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares in float32, leaves in the
    JAX package's flatten order."""
    total = 0
    for _, leaf in tree_leaves(as_tree(grads)):
        for g in leaf_tensors(leaf):
            total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


class AdamW:
    def __init__(self, cfg: AdamWConfig):
        self.cfg = cfg

    def init(self, params: Any) -> dict:
        """Zero moments in ``moment_dtype`` beside each parameter, and step 0
        (int32), on the parameters' device."""
        mdt = torch.bfloat16 if self.cfg.moment_dtype == "bfloat16" else torch.float32
        tree = as_tree(params)
        return {
            "m": tree_zeros(tree, mdt),
            "v": tree_zeros(tree, mdt),
            "step": torch.zeros((), dtype=torch.int32, device=tree_tensors(tree)[0].device),
        }

    @torch.no_grad()
    def update(self, grads: Any, state: dict, params: Any, *,
               gnorm: torch.Tensor | None = None) -> tuple[Any, dict, dict]:
        """One step: the new parameters and moments written in place.
        ``gnorm``: the global gradient norm where ``grads`` are one device's
        shards of it (the mesh step sums it over every shard).  Returns
        (params, state with step + 1, {"lr", "grad_norm"})."""
        cfg = self.cfg
        step = state["step"] + 1
        lr = lr_schedule(cfg, step)

        # global-norm clip in fp32
        if gnorm is None:
            gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

        bc1 = 1 - cfg.b1 ** step.to(torch.float32)
        bc2 = 1 - cfg.b2 ** step.to(torch.float32)
        tree = as_tree(params)
        decay = _decay_mask(tree)

        def upd(g, m, v, p, dmask):
            gf = g.float() * scale
            m2 = cfg.b1 * m.float() + (1 - cfg.b1) * gf
            v2 = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
            mhat = m2 / bc1
            vhat = v2 / bc2
            delta = mhat / (torch.sqrt(vhat) + cfg.eps)
            if dmask:  # + 0 * p leaves delta's bits as they are
                delta = delta + cfg.weight_decay * dmask * p.float()
            p.copy_(p.float() - lr * delta)
            m.copy_(m2)
            v.copy_(v2)

        for (_, g), (_, m), (_, v), (_, p), (_, d) in zip(
                tree_leaves(as_tree(grads)), tree_leaves(state["m"]), tree_leaves(state["v"]),
                tree_leaves(tree), tree_leaves(decay), strict=True):
            for args in zip(leaf_tensors(g), leaf_tensors(m), leaf_tensors(v),
                            leaf_tensors(p), strict=True):
                upd(*args, d)
        new_state = {"m": state["m"], "v": state["v"], "step": step}
        return params, new_state, {"lr": lr, "grad_norm": gnorm}
