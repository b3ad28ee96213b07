"""Training driver: data pipeline -> train step -> fault-tolerant loop with
async checkpoints — the port of ``repro.launch.train``.

Eager PyTorch (no ``torch.compile``), on the card unless ``device="cpu"``
(``--device cpu``).  Gradients come from ``torch.autograd.grad`` of the
model's ``loss_fn`` in the parameters' JAX layout; ``AdamW`` writes the new
parameters and moments in place.  The state the runner checkpoints is
that layout ({'params', 'opt': {'m', 'v', 'step'}, 'residual'}), so a
checkpoint written by either package resumes in the other.

On a mesh (``mesh=``, ``--use-mesh``) the parameters, moments, gradient
sums and residuals are ``Sharded`` by ``param_pspecs``
(``place_params``), and a step is one explicit shard program driven from
this process, as the tabular mesh engine's (no ``torch.distributed``).
Every LM family runs the split program (``SPLIT_FAMILIES``: the
transformers ``dense``, ``moe`` and ``vlm``, the hybrid (zamba2), the ssm
(rwkv6) and the audio family (whisper); ``repro_torch.sharding.split``):
device (g, m) computes data group g's rows with model slice m of every
weight the specs split over `model` (column-parallel projections,
row-parallel outputs whose partials are reduce-scattered over the
sequence, the attention split by query rows, the recurrent scans by
heads, experts on `model`, vocab-parallel embedding and logits),
activations between blocks sequence-sharded over the group's devices
where the specs say so (whisper's encoder over its T frames, its decoder
over its S tokens: ``Split.over``); each layer's `fsdp` blocks are
gathered over the data axis onto the device just before use and
gathered again for its backward; each device's gradients of its slices
go into the float32 sums of the shards that hold them, group by group in
ascending order (the reduce-scatter over data).  Then ``AdamW.update``
on each device's shards with the clip norm summed over every leaf's
blocks in flatten order.  The gathered program (``_gather``: whole
parameters once per compute device, each data group's loss and
gradients there, ``_group_grads``) stays as the program tests' dot-FLOP
yardstick (the dry run's gathered cells reckon the same program); no
family's step runs it. The program gives the one-device step: the loss is the
groups' mean (equal rows and whole-column masks give equal token
counts), and an MoE layer routes each group's tokens with the whole
batch's ranks and capacity (``GroupRouting``).

CLI:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --steps 50 --global-batch 8 --seq 256 --scale 0.05 [--device cpu] \
      [--use-mesh]
``--scale`` shrinks width/depth for small runs (examples use it); the
config dims stay exact when --scale 1.  ``--use-mesh`` trains on a mesh
over the visible cards, or with ``--device`` on 8 logical shards of that
device (``make_host_mesh(devices=[device] * 8)``: 2 x 4).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any

import numpy as np
import torch

from repro_torch.config import get_config
from repro_torch.data.tokens import EmbeddingPipeline, TokenPipeline
from repro_torch.ft.runtime import FaultTolerantRunner
from repro_torch.launch.mesh import check_mesh, make_host_mesh
from repro_torch.models import common, moe
from repro_torch.models.common import (
    leaf_tensors,
    stack_map,
    tree_leaves,
    tree_like,
    tree_map,
    tree_tensors,
    tree_zeros,
)
from repro_torch.models.registry import LMBundle, build_model
from repro_torch.optim.adamw import AdamW, AdamWConfig
from repro_torch.optim.compress import (
    compress_tree,
    decompress_tree,
    dequantize_int8,
    int8_codes,
)
from repro_torch.sharding.partition import (
    MeshAxes,
    activation_sharder,
    batch_pspec,
    param_pspecs,
)
from repro_torch.sharding.placement import Sharded, local_tree, place_tree
from repro_torch.sharding.split import GradSink, Split, position


def loss_and_grads(bundle: LMBundle, params, batch: dict) -> tuple:
    """(loss, metrics, gradients) of ``bundle.loss_fn`` at ``params`` (a
    params module): the gradients in the parameters' JAX layout, zeros
    for a parameter the loss does not reach (the JAX package's
    ``value_and_grad(loss_fn, has_aux=True)``)."""
    tree = params.jax_layout()
    leaves = tree_tensors(tree)
    loss, metrics = bundle.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree_like(tree, grads)


def _rows(batch: dict) -> int:
    return next(iter(batch.values())).shape[0]


def _check_microbatch(batch: dict, microbatch: int) -> None:
    """The reference reshapes the batch to (microbatch, B // microbatch,
    ...), which refuses a batch the count does not divide."""
    b = _rows(batch)
    if microbatch > 1 and b % microbatch:
        raise ValueError(f"a batch of {b} rows does not split into {microbatch} microbatches")


def make_train_step(bundle: LMBundle, opt: AdamW, mesh=None, *,
                    microbatch: int = 0, compress: bool = False):
    """Returns (params, opt_state, residual, batch) -> (params, opt_state,
    residual, metrics); ``params`` is the model's params module, updated
    in place (on a mesh: the tree ``place_params`` returns, its shards
    updated in place; the batch whole tensors or ``place_batch``'s).

    ``microbatch`` > 1 splits the batch into that many accumulation steps,
    their gradients summed in float32 and divided by ``microbatch``; a
    batch it does not divide raises ``ValueError``.
    ``compress`` int8-quantizes gradients with error feedback before the
    optimizer (the compressed cross-pod reduction's wire format).
    """
    if mesh is not None:
        return MeshStep(bundle, opt, check_mesh(mesh), microbatch=microbatch,
                        compress=compress)

    def step(params, opt_state, residual, batch):
        _check_microbatch(batch, microbatch)
        if microbatch and microbatch > 1:
            n = _rows(batch) // microbatch
            acc = tree_zeros(params.jax_layout(), torch.float32)
            loss_sum = torch.zeros((), dtype=torch.float32, device=bundle.device)
            for i in range(microbatch):
                loss, _, g = loss_and_grads(
                    bundle, params, {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
                for a, gg in zip(tree_tensors(acc), tree_tensors(g), strict=True):
                    a.add_(gg)
                loss_sum = loss_sum + loss
                del g  # freed before the next microbatch's backward
            grads = tree_map(lambda a: stack_map(lambda t: t / microbatch, a), acc)
            loss = loss_sum / microbatch
        else:
            loss, _, grads = loss_and_grads(bundle, params, batch)

        if compress:
            (q, s), residual = compress_tree(grads, residual)
            grads = decompress_tree(q, s, grads)
        params, opt_state, om = opt.update(grads, opt_state, params)
        return params, opt_state, residual, {"loss": loss, **om}

    return step


# ---------------------------------------------------------------------------
# The mesh: placement and the shard program
# ---------------------------------------------------------------------------


def place_params(mesh, cfg, params):
    """``params`` (a params module, or a JAX-layout tree of whole tensors)
    split onto ``mesh`` by ``param_pspecs``: a tree of ``Sharded`` leaves
    (a ``Stack`` of per-layer ``Sharded``)."""
    tree = params.jax_layout() if hasattr(params, "jax_layout") else params
    return place_tree(mesh, tree, param_pspecs(tree, cfg, MeshAxes(mesh)))


def place_batch(mesh, batch: dict) -> dict:
    """Each tensor of ``batch`` split onto ``mesh`` by ``batch_pspec``
    (rows over the batch axes; a 0-d tensor replicated)."""
    bp = batch_pspec(MeshAxes(mesh))
    return {k: Sharded.place(mesh, bp if torch.as_tensor(v).ndim >= 1 else (),
                             torch.as_tensor(v)) for k, v in batch.items()}


class GroupRouting:
    """``moe_forward`` over one data group's rows with the whole batch's
    routing (the ``moe.set_impl`` override of the gathered mesh step; the
    split program calls ``route``; with one group, ``moe_forward``'s own
    routing, no counting pass).

    One device routes all T tokens at once: capacity from T, each token's
    rank within its expert counted over every token before it, and the aux
    term a product of whole-batch means.  Groups hold consecutive row
    blocks, so a group's ranks are its own plus the assignments of the
    groups before it.  A first pass without gradients (``counting``)
    records, per layer (a key: its name in the params module, or the split
    program's (segment, layer)), those offsets and the whole batch's
    counts; the gradient pass replays them, and its aux is E * sum(whole-
    batch dispatch fraction * the group's mean probability), whose mean
    over the equal groups is the one-device aux.  ``layers`` maps ``id`` of
    each compute device's ``MoEParams`` to its name, so groups on
    different devices share a layer's counts.  ``dropped`` holds, per
    (group, layer), the count of assignments the gradient pass dropped (a
    0-d tensor).

    ``lockstep`` (the serve programs, which run every group's layer l
    before any group's layer l + 1): no counting pass; a group's offsets
    are the counts of the row blocks before its own, taken as those route,
    and the aux is zero (serving drops it).  ``blocks[g]``: group g's row
    block (default g; where the batch does not split over the groups,
    every group computes block 0, the whole batch)."""

    def __init__(self, n_groups: int, layers: dict | None = None, *, lockstep: bool = False,
                 blocks=None):
        self.n_groups = n_groups
        self.layers = layers or {}
        self.group = 0
        self.lockstep = lockstep
        self.blocks = list(range(n_groups)) if blocks is None else list(blocks)
        self.n_blocks = max(self.blocks) + 1
        # one group: its own counts, no first pass
        self.counting = n_groups > 1 and not lockstep
        self.counts: dict = {}  # layer -> (E,) assignments of the groups so far
        self.block_counts: dict = {}  # lockstep: layer -> {block: (E,) assignments}
        self.offsets: list[dict] = [{} for _ in range(n_groups)]
        self.dropped: dict = {}

    def route(self, key, logits: list, *, top_k: int, capacity_factor: float,
              group: int | None = None) -> tuple:
        """Routing of each of ``logits`` (equal (T, E) copies of group
        ``group``'s router logits (default ``self.group``), one a device;
        None where not computed) and the aux term (on the first copy's
        device)."""
        g = self.group if group is None else group
        first = next(x for x in logits if x is not None)
        t, e = first.shape
        t_all = t * (self.n_blocks if self.lockstep else self.n_groups)
        capacity = int(max(1, round(t_all * top_k / e * capacity_factor)))
        seen = None
        if self.lockstep:
            seen = self.block_counts.setdefault(key, {})
            off = None
            for c in range(self.blocks[g]):  # the blocks before, in ascending order
                off = seen[c].to(first.device) if off is None else off + seen[c].to(first.device)
        elif self.counting:
            off = self.counts.get(key)
            if off is None:
                off = torch.zeros((e,), dtype=torch.int64, device=first.device)
            self.offsets[g][key] = off
        else:
            off = self.offsets[g].get(key)
        rs = [None if x is None else moe.route_logits(
            x, k=top_k, capacity=capacity, offset=None if off is None else off.to(x.device))
              for x in logits]
        r = next(x for x in rs if x is not None)
        zero = torch.zeros((), dtype=torch.float32, device=first.device)
        if self.counting:
            self.counts[key] = off + moe.expert_counts(r.gate_idx, e)
            return rs, zero
        self.dropped[(g, key)] = (~r.keep).sum()
        if self.lockstep:
            if self.n_blocks > 1:
                seen[self.blocks[g]] = moe.expert_counts(r.gate_idx, e)
            return rs, zero
        if self.n_groups == 1:
            return rs, moe.aux_loss(r)
        return rs, moe.aux_loss(r, self.counts[key].to(first.device).float() / (t_all * top_k))

    def __call__(self, p, x, *, top_k: int, capacity_factor: float, act: str):
        b, s, d = x.shape
        xt = x.reshape(b * s, d)
        (r,), aux = self.route(self.layers[id(p)], [xt.float() @ p.router], top_k=top_k,
                               capacity_factor=capacity_factor)
        return moe.experts(p, xt, r, act).reshape(b, s, d), aux


# the families on the split program: every LM family (the transformers, zamba2, rwkv6, whisper)
SPLIT_FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")


class MeshStep:
    """The mesh train step (``make_train_step(bundle, opt, mesh)``): see the
    module docstring.  ``split``: the step runs the split program
    (``SPLIT_FAMILIES``, every LM family's; another family raises).  The
    gathered program (``_gather``, ``_group_grads``), which only the
    tests call, keeps one whole copy of the parameters on each
    compute device (the all-gather's destination), reused every call.
    ``routing``: the last step's MoE routing state (its ``dropped``
    counts)."""

    def __init__(self, bundle: LMBundle, opt: AdamW, mesh, *, microbatch: int = 0,
                 compress: bool = False):
        self.bundle, self.opt, self.mesh = bundle, opt, mesh
        self.microbatch, self.compress = microbatch, compress
        self.split = bundle.cfg.family in SPLIT_FAMILIES
        if not self.split:
            raise ValueError(f"the {bundle.cfg.family} family has no split train step")
        self.routing = None
        axes = MeshAxes(mesh)
        sizes = mesh.shape
        batch_axes = axes.batch_axes()
        self.n_groups = int(np.prod([sizes[a] for a in batch_axes], dtype=np.int64))
        self.group_devices = []
        for g in range(self.n_groups):
            coords = dict(zip(batch_axes, np.unravel_index(g, [sizes[a] for a in batch_axes])))
            self.group_devices.append(mesh.device_at({a: int(i) for a, i in coords.items()}))
        self._workers: dict = {}  # device -> (bundle, whole params module)

    def _worker(self, device: torch.device):
        if device not in self._workers:
            b = self.bundle
            if device != b.device:
                b = build_model(b.cfg, getattr(b.model, "flash_blk", 512), device=device)
                b.model.shard_x = self.bundle.model.shard_x
            self._workers[device] = (b, b.model.empty_params())
        return self._workers[device]

    def _gather(self, params) -> None:
        """All-gather the shards into each compute device's whole copy."""
        shards = tree_tensors(params)
        for device in dict.fromkeys(self.group_devices):
            _, module = self._worker(device)
            for dst, src in zip(tree_tensors(module.jax_layout()), shards, strict=True):
                src.gather_into(dst)

    def _group_grads(self, rows: dict, acc) -> torch.Tensor:
        """Loss and gradients of each group's block of ``rows``, the
        gradients summed into ``acc``'s shards group by group; returns
        the sum of the groups' losses."""
        n = _rows(rows) // self.n_groups
        parts = []
        for g, device in enumerate(self.group_devices):
            b, module = self._worker(device)
            parts.append((b, module, {k: v[g * n:(g + 1) * n].to(device)
                                      for k, v in rows.items()}))
        routing = None
        if self.bundle.cfg.is_moe and self.n_groups > 1:
            layers = {id(m): name for _, module in self._workers.values()
                      for name, m in module.named_modules() if isinstance(m, moe.MoEParams)}
            routing = GroupRouting(self.n_groups, layers)
        acc_shards = tree_tensors(acc)
        loss_sum = None
        prev = moe._HOOKS["impl"]
        try:
            if routing is not None:
                moe.set_impl(routing)
                with torch.no_grad():
                    for g, (b, module, part) in enumerate(parts):
                        routing.group = g
                        b.loss_fn(module, part)
                routing.counting = False
            for g, (b, module, part) in enumerate(parts):
                if routing is not None:
                    routing.group = g
                loss, _, grads = loss_and_grads(b, module, part)
                for sh, gt in zip(acc_shards, tree_tensors(grads), strict=True):
                    for idx, t in sh.items():
                        t.add_(gt[sh.slices(idx)].to(t.device))
                del grads
                loss = loss.to(self.group_devices[0])
                loss_sum = loss if loss_sum is None else loss_sum + loss
        finally:
            moe.set_impl(prev)
        return loss_sum

    def split_grads(self, rows: dict, acc, params, *, groups=None, only: int | None = None):
        """The split program's loss and gradients of each group's block of
        ``rows`` (``groups``: which, default all), the gradients summed into
        ``acc``'s shards group by group; returns the sum of the groups'
        losses (on the mesh's first device).  ``only``: compute only that
        model device of each group and write only its sums (the dry run's
        solo trace on meta)."""
        cfg = self.bundle.cfg
        groups = range(self.n_groups) if groups is None else groups
        n = _rows(rows) // self.n_groups
        seq = rows["labels"].shape[1]
        active = None if only is None else [only]
        parts = {g: {k: v[g * n:(g + 1) * n] for k, v in rows.items()} for g in groups}
        routing = GroupRouting(self.n_groups) if cfg.is_moe else None
        self.routing = routing
        model = self.bundle.model

        def loss_of(g, sp):
            return model.loss_fn(params, {k: v.to(sp.devices[sp.root])
                                          for k, v in parts[g].items()}, sp)[0]

        if routing is not None and routing.counting:
            with torch.no_grad():
                for g in groups:
                    routing.group = g
                    loss_of(g, Split(self.mesh, g, seq, routing=routing, active=active))
            routing.counting = False
        sums = {id(p): a for p, a in zip(tree_tensors(params), tree_tensors(acc), strict=True)}
        loss_sum = None
        for g in groups:
            if routing is not None:
                routing.group = g
            sink = GradSink(sums, write=None if only is None else {position(self.mesh, g, only)})
            sp = Split(self.mesh, g, seq, sink=sink, routing=routing, active=active)
            with sp.saving():
                loss = loss_of(g, sp)
            sink.backward(loss)
            loss = loss.detach().to(self.group_devices[0])
            loss_sum = loss if loss_sum is None else loss_sum + loss
        return loss_sum

    def _global_norm(self, grads) -> torch.Tensor:
        dev = self.group_devices[0]
        total = 0
        for _, leaf in tree_leaves(grads):
            for sh in leaf_tensors(leaf):
                for _, t in sh.unique():
                    total = total + torch.sum(torch.square(t.float())).to(dev)
        return torch.sqrt(total)

    def _compress(self, grads, residual):
        """``compress_tree`` + ``decompress_tree`` on shards: one int8
        scale a leaf (a ``Stack``'s over all its layers) from the max over
        every block; the residual kept per shard."""
        dev = self.group_devices[0]
        for (_, g), (_, r) in zip(tree_leaves(grads), tree_leaves(residual), strict=True):
            pairs = list(zip(leaf_tensors(g), leaf_tensors(r), strict=True))
            for gs, rs in pairs:
                for (_, gt), (_, rt) in zip(gs.items(), rs.items()):
                    gt.add_(rt)  # corrected = g + residual, in place
            amax = torch.stack([torch.max(torch.abs(t)).to(dev)
                                for gs, _ in pairs for _, t in gs.unique()]).max()
            scale = torch.clamp(amax, min=1e-12) / 127.0
            for gs, rs in pairs:
                for (_, gt), (_, rt) in zip(gs.items(), rs.items()):
                    deq = dequantize_int8(int8_codes(gt, scale.to(gt.device)),
                                          scale.to(gt.device))
                    rt.copy_(gt - deq)
                    gt.copy_(deq)
        return grads, residual

    def __call__(self, params, opt_state, residual, batch):
        first = self.group_devices[0]
        rows = {k: (v.gather(first) if isinstance(v, Sharded) else v) for k, v in batch.items()}
        _check_microbatch(rows, self.microbatch)
        n_mb = self.microbatch if self.microbatch > 1 else 1
        per_mb = _rows(rows) // n_mb
        if per_mb % self.n_groups:
            raise ValueError(f"{per_mb} rows a microbatch do not split over "
                             f"{self.n_groups} data groups")
        acc = tree_zeros(params, torch.float32)
        loss_sum = None
        for i in range(n_mb):
            part = {k: v[i * per_mb:(i + 1) * per_mb] for k, v in rows.items()}
            loss = self.split_grads(part, acc, params) / self.n_groups
            loss_sum = loss if loss_sum is None else loss_sum + loss
        loss = loss_sum / n_mb
        if n_mb * self.n_groups > 1:
            scale = 1.0 / (n_mb * self.n_groups)
            for sh in tree_tensors(acc):
                for _, t in sh.items():
                    t.mul_(scale)
        if self.compress:
            if residual is None:  # as compress_tree: a zero residual to start
                residual = tree_zeros(params, torch.float32)
            acc, residual = self._compress(acc, residual)
        gnorm = self._global_norm(acc)
        om = None
        for k, device in enumerate(self.mesh.devices.flat):
            state_k = {"m": local_tree(opt_state["m"], k), "v": local_tree(opt_state["v"], k),
                       "step": opt_state["step"].to(device)}
            _, new_k, om_k = self.opt.update(local_tree(acc, k), state_k,
                                             local_tree(params, k), gnorm=gnorm.to(device))
            if om is None:
                om, step = om_k, new_k["step"].to(opt_state["step"].device)
        opt_state = {"m": opt_state["m"], "v": opt_state["v"], "step": step}
        return params, opt_state, residual, {"loss": loss, **om}


def on_device(batch: dict, device, dtype: torch.dtype) -> dict:
    """A numpy batch as tensors on ``device``: integers as int64, floats
    (embeddings, frames) in the model's ``dtype`` (torch does not promote
    a float32 input against bfloat16 weights as JAX does)."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = torch.as_tensor(v).to(device, torch.int64 if v.dtype.kind in "iu" else dtype)
    return out


def batch_source(cfg, global_batch: int, seq_len: int, seed: int):
    """The trainer's data: step -> numpy batch (token pipeline, or the
    embedding pipeline for vlm/audio configs), a pure function of (seed,
    step)."""
    if cfg.embeddings_input or cfg.is_encoder_decoder:
        pipe: Any = EmbeddingPipeline(
            d_model=cfg.d_model, global_batch=global_batch, seq_len=seq_len,
            vocab_size=cfg.vocab_size, seed=seed,
        )
        kind = "audio" if cfg.is_encoder_decoder else "vlm"
        return lambda step: pipe.batch(step, kind=kind)
    return TokenPipeline(cfg.vocab_size, global_batch, seq_len, seed=seed).batch


def train(
    cfg,
    *,
    steps: int,
    global_batch: int,
    seq_len: int,
    run_dir: str,
    mesh=None,
    ckpt_every: int = 20,
    microbatch: int = 0,
    compress: bool = False,
    failure_at: int | None = None,
    seed: int = 0,
    opt_cfg: AdamWConfig | None = None,
    log_every: int = 10,
    device=None,
) -> list[dict]:
    """Fault-tolerant training loop on ``device`` (None: the card, which
    raises where torch sees none), or on ``mesh`` (its first data group's
    device computes the initial parameters).  Returns per-step metric
    history."""
    if mesh is not None:
        device = check_mesh(mesh).devices.flat[0]
    bundle = build_model(cfg, device=device)
    if mesh is not None:
        bundle.model.shard_x = activation_sharder(mesh)
    dtype = common.dtype_of(cfg.dtype)
    opt = AdamW(opt_cfg or AdamWConfig(warmup_steps=max(5, steps // 20),
                                       decay_steps=steps))
    get_batch = batch_source(cfg, global_batch, seq_len, seed)
    step_fn = make_train_step(bundle, opt, mesh, microbatch=microbatch, compress=compress)
    live: dict = {}  # the params module of the state the runner holds (one device)

    def init_state():
        params = bundle.init_params(seed)
        if mesh is not None:
            tree = place_params(mesh, cfg, params)
            del params
        else:
            live["params"] = params
            tree = params.jax_layout()
        residual = (tree_zeros(tree, torch.float32) if compress
                    else {"none": torch.zeros((), device=bundle.device)})
        return {"params": tree, "opt": opt.init(tree), "residual": residual}

    def one_step(state, step):
        batch = on_device(get_batch(step), bundle.device, dtype)
        if mesh is not None:
            params = state["params"]
            batch = place_batch(mesh, batch)
        else:
            params = live["params"]
        _, opt_state, residual, metrics = step_fn(
            params, state["opt"], state["residual"], batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        return {"params": state["params"], "opt": opt_state, "residual": residual}, metrics

    def placer(state):
        if mesh is not None:
            # elastic re-placement: the whole tensors split for this mesh
            specs = param_pspecs(state["params"], cfg, MeshAxes(mesh))
            residual = state["residual"]
            residual = (place_tree(mesh, residual, specs) if compress
                        else tree_map(lambda t: t.to(bundle.device), residual))
            return {"params": place_tree(mesh, state["params"], specs),
                    "opt": {"m": place_tree(mesh, state["opt"]["m"], specs),
                            "v": place_tree(mesh, state["opt"]["v"], specs),
                            "step": state["opt"]["step"].to(bundle.device)},
                    "residual": residual}
        # a restored checkpoint's parameters into the module's tensors
        tree = live["params"].jax_layout()
        with torch.no_grad():
            for dst, src in zip(tree_tensors(tree), tree_tensors(state["params"]), strict=True):
                dst.copy_(src)
        return {**state, "params": tree}

    runner = FaultTolerantRunner(run_dir, one_step, init_state, ckpt_every=ckpt_every)

    def on_metrics(step, m):
        if step % log_every == 0 or step == steps - 1:
            line = {k: (round(v, 4) if isinstance(v, float) else v)
                    for k, v in m.items() if k in ("step", "loss", "lr", "dt")}
            print(json.dumps(line), flush=True)

    _state, history = runner.run(
        steps, failure_at=failure_at, placer=placer, on_metrics=on_metrics
    )
    return history


def _scaled(cfg, scale: float):
    """A config cut to ``scale`` of its widths and depth (``scale`` >= 1:
    the config itself)."""
    if scale >= 1.0:
        return cfg
    d = max(64, int(cfg.d_model * scale) // 16 * 16)
    heads = max(2, int(cfg.n_heads * scale))
    while d % heads:
        heads -= 1
    kv = max(1, min(cfg.n_kv_heads, heads))
    while heads % kv:
        kv -= 1
    return cfg.replace(
        n_layers=max(2, int(cfg.n_layers * scale)),
        d_model=d, n_heads=heads, n_kv_heads=kv, head_dim=0,
        d_ff=max(128, int(cfg.d_ff * scale) // 16 * 16),
        vocab_size=min(cfg.vocab_size, 8192),
    )


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--run-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--use-mesh", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run there)")
    args = ap.parse_args(argv)

    cfg = _scaled(get_config(args.arch), args.scale)
    mesh = None
    if args.use_mesh:
        # the visible cards, or 8 logical shards of the named device
        mesh = (make_host_mesh() if args.device is None
                else make_host_mesh(devices=[args.device] * 8))
    t0 = time.time()
    hist = train(
        cfg, steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq, run_dir=args.run_dir, mesh=mesh,
        ckpt_every=args.ckpt_every, microbatch=args.microbatch,
        compress=args.compress, device=args.device,
    )
    print(f"done: {len(hist)} steps in {time.time()-t0:.1f}s; "
          f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")


if __name__ == "__main__":
    main()
