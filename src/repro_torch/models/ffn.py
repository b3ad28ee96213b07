"""Gated feed-forward (SwiGLU / GeGLU) blocks — the port of
``repro.models.ffn``: the parameters are ``nn.Module``s with the JAX
NamedTuples' field names, the forwards plain functions on tensors."""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import common


class FFNParams(nn.Module):
    """w_gate (d, f), w_up (d, f), w_down (f, d)."""

    NAMEDTUPLE = True  # a NamedTuple in the JAX package
    FIELDS = ("w_gate", "w_up", "w_down")

    def __init__(self, d_model: int, d_ff: int, dtype, *, device, generator=None):
        super().__init__()
        init = dict(generator=generator, device=device)
        self.w_gate = nn.Parameter(common.dense_init((d_model, d_ff), dtype, **init))
        self.w_up = nn.Parameter(common.dense_init((d_model, d_ff), dtype, **init))
        self.w_down = nn.Parameter(common.dense_init((d_ff, d_model), dtype, **init))


def ffn_forward(p: FFNParams, x, act: str = "silu", sp=None):
    """``sp`` set (a ``repro_torch.sharding.split.Split``): on a data
    group's `model` devices, ``p`` the gathered fields and ``x`` and the
    result in ``sp.layout``: w_gate and w_up column-parallel, w_down
    row-parallel, its partials reduce-scattered over the sequence."""
    a = common.act_fn(act)
    if sp is None:
        return (a(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down
    x = sp.to(x, sp.input_kind(p.w_gate))  # gathered once for both products
    h = sp.mm(x, p.w_gate).zip(sp.mm(x, p.w_up), lambda g, u, m: a(g) * u)
    return sp.to(sp.mm(h, p.w_down), sp.layout)


class MLPParams(nn.Module):
    """Ungated two-matrix MLP (whisper-style fc1/fc2): w1 (d, f), b1 (f,),
    w2 (f, d), b2 (d,)."""

    NAMEDTUPLE = True  # a NamedTuple in the JAX package
    FIELDS = ("w1", "b1", "w2", "b2")

    def __init__(self, d_model: int, d_ff: int, dtype, *, device, generator=None):
        super().__init__()
        init = dict(generator=generator, device=device)
        self.w1 = nn.Parameter(common.dense_init((d_model, d_ff), dtype, **init))
        self.b1 = nn.Parameter(torch.zeros((d_ff,), dtype=dtype, device=device))
        self.w2 = nn.Parameter(common.dense_init((d_ff, d_model), dtype, **init))
        self.b2 = nn.Parameter(torch.zeros((d_model,), dtype=dtype, device=device))


def mlp_forward(p: MLPParams, x, act: str = "gelu", sp=None):
    """``sp`` set: as ``ffn_forward``'s, w1 column-parallel (each device
    adds its block of b1, which the specs leave whole), w2 row-parallel;
    b2 is added once, to the reduced sum in ``sp.layout``, never to the
    partials (M of them would add it M times)."""
    a = common.act_fn(act)
    if sp is None:
        return a(x @ p.w1 + p.b1) @ p.w2 + p.b2

    def hidden(t, m):
        b1 = p.b1[m]
        if p.w1.model_dim is not None:  # this device's columns of w1
            b1 = b1.narrow(0, m * t.shape[-1], t.shape[-1])
        return a(t + b1)

    y = sp.to(sp.mm(sp.mm(x, p.w1).map(hidden), p.w2), sp.layout)
    return y.map(lambda t, m: t + p.b2[m])
