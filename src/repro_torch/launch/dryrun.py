"""Multi-pod dry run on meta devices: reckon every (arch x shape x mesh)
cell of the port's own program — the port of ``repro.launch.dryrun``.

    python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k \
        [--multi-pod] [--out-dir results/dryrun_torch] [--flash-blk 1024]

No environment flag: the production mesh (16 x 16, or 2 x 16 x 16 with
``--multi-pod``) is ``make_production_mesh(devices=[meta] * n)``, and every
tensor is a meta tensor (shapes and dtypes, no memory, no arithmetic).
For each cell it reports, for the fullest device (the split program's
device (0, M - 1), the last of group 0's `model` devices; a data group's
compute device otherwise):

  * **argument bytes**, exactly, from the specs: ``ShardedShape.local_bytes``
    (``sharding.partition.attach``) of the parameters, the AdamW moments
    (in ``_moe_moment_dtype``) and ``step``, and the batch — or, for decode
    cells, the cache, token and pos — placed by ``batch_pspec`` /
    ``cache_pspecs`` (``argument_bytes``; no trace);
  * the port's mesh program, traced once on meta under ``OpCounter``
    (``repro_torch.launch.op_count``).  A cell of a family on the split
    program (``SPLIT_FAMILIES``: every LM family, the transformers,
    zamba2's hybrid, rwkv6's ssm and whisper's encoder-decoder) traces
    device (0, M - 1)'s part of the split program, every device of the
    mesh computing (``n_compute_devices``): ``train``, its step
    (``MeshStep.split_grads(only=M - 1)``: group 0's rows with its model
    slices, its counting pass where MoE layers route more than one group,
    its gradients into its float32 sums, then its ``AdamW.update``);
    ``prefill``, its part of group 0's prefill (``MeshServe.prefill``: its
    query chunk, its vocab slice of the logits, its part of the cache
    written, its shard of the cache a temp); ``decode``, its part of one
    step at the cache's last position (``MeshServe.decode_step``: the
    token's row, the chunk or heads of the cache it holds, the position
    written into its own shard; a recurrent state read and written by its
    heads; whisper's cross cache read by its KV heads or its chunk of the
    frames).  A cell outside ``SPLIT_FAMILIES`` (a serve cell under
    ``REPRO_MOE_IMPL=shardmap``, or any cell where a caller narrows
    ``SPLIT_FAMILIES``, as the tests and ``chip_smoke.py`` do to set the
    split program beside the gathered one) traces the program the gathered
    ``MeshStep`` runs (each data group gathers whole parameters
    onto its compute device and computes there): ``train``: ``loss_fn`` +
    backward on ``global_batch / n_groups`` rows with whole parameters (an
    MoE layer routed by ``GroupRouting``, its counting pass included),
    the group's gradients added into the device's float32 sums, and one
    ``AdamW.update`` on the device's shards; ``prefill`` and ``decode``:
    the forward on the group's rows (and its rows of the cache).  Its dot
    FLOPs, op bytes and peak temp bytes;
  * the bytes the device holds beyond its arguments: the gathered bytes
    (split: the peak of the FSDP-gathered slices alive at once, kept
    apart from the temps, plus its group's batch rows; gathered: the
    whole parameters and the group's batch, or its rows of the cache),
    the float32 gradient sums, the trace's temps;
  * **transfer bytes**, by kind.  Split: what device (0, M - 1) receives
    in its trace (``collectives.recording``: the FSDP gathers and their
    backward, the activations' all-gathers, reduce-scatters, all-reduces
    and all-to-alls, the decode merge's), plus its group's batch rows
    (the whole batch where M = 1 in training, gathered onto (0, 0) by
    ``MeshStep``; the prompt's or the tokens' rows from the mesh's first
    device in serving) and, in training, from the specs, every other
    device's gradient of a shard of its blocks (``reduce-scatter``).
    Gathered: what ``MeshStep._gather`` brings to the device
    (``all-gather``: whole minus its own shard) and what its shard sums
    send (``reduce-scatter``: its gradient's slice for every other
    device's shard).  On a meta mesh ``.to(device)`` moves nothing, so
    ``MeshStep`` is never driven on devices here;
  * the roofline terms with one H100's constants (``hlo_analysis``) and the
    fit against its 80 GiB.

Deliberate differences from the JAX package's dry run:
  * there is no XLA ``memory_analysis``, ``cost_analysis`` or code size;
  * op bytes (every eager op's inputs and outputs) stand in for XLA's
    fusion-boundary bytes;
  * Python loops over layers stand in for ``while`` trips: every layer's
    ops are counted as they dispatch;
  * the split program splits attention by query rows where GSPMD splits
    heads: device (0, M - 1) holds the sequence's last chunk, the most
    causal work, so it is the fullest (under remat the recomputation stops
    after the last saved tensor, which skips its final product of a layer
    alone and in the whole program alike); traced alone, it also computes
    the loss's reductions over `model`, which device (0, 0) computes in
    the whole program (a few ops on (B, 512) float32 blocks; the bytes it
    is counted to receive are the whole program's); in serving it also
    gathers the logits a device (0, 0) receives in the whole program
    (received bytes: the whole program's, nothing); a split decode holds
    the token's row on the group's last device, which so computes any
    product by a weight `fit` leaves whole, and the chunk with ``pos``;
    the decode cache is split by KV heads or by sequence chunks merged in
    shard order, where GSPMD picks its own (whisper's cross cache too, by
    KV heads or chunks of its frames); the recurrent scans by heads, as
    the reference's states; whisper's encoder chunks of frames carry equal
    work (bidirectional), its decoder's causal chunks do not, so (0, M - 1)
    stays the fullest;
  * ``REPRO_MOE_IMPL=shardmap`` traces a transformer's prefill or decode
    cell on the gathered forward, whose MoE layers it replaces (the
    split program's experts are split over `model` already);
  * the roofline uses the H100's constants and the fit is 80 GiB;
  * a decode cell traced on the gathered program writes one position into
    the cache; sending it back to the cache's shards is left out of the
    transfer bytes (at most the group's cache / seq_len).

Results land in results/dryrun_torch/<arch>__<shape>__<mesh>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from collections import defaultdict

import numpy as np
import torch

from repro_torch.config import SHAPES, ShapeCell, get_config
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.model_flops import model_flops
from repro_torch.launch.op_count import OpCost, OpCounter, count
from repro_torch.launch.serve import MeshServe
from repro_torch.launch.train import SPLIT_FAMILIES, GroupRouting, MeshStep, loss_and_grads
from repro_torch.models import common, moe as moe_mod
from repro_torch.models.common import stack_map, tree_map, tree_tensors
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamW, AdamWConfig
from repro_torch.sharding import split as split_mod
from repro_torch.sharding.collectives import recording
from repro_torch.sharding.placement import Sharded, layer_spec, local_tree, zeros_like_cache
from repro_torch.sharding.partition import (
    MeshAxes,
    P,
    ShardedShape,
    activation_sharder,
    attach,
    batch_pspec,
    cache_pspecs,
    leaves_with_path,
    param_pspecs,
)

META = torch.device("meta")
FITS_BYTES = 80 * 2**30  # one H100's HBM


def _moe_moment_dtype(cfg) -> str:
    # 671B-class models need bf16 moments to fit (DESIGN.md §5)
    return "bfloat16" if getattr(cfg, "n_experts", 0) >= 128 else "float32"


class SkipCell(Exception):
    pass


def meta_mesh(multi_pod: bool) -> Mesh:
    """The production mesh over meta devices."""
    n = 512 if multi_pod else 256
    return make_production_mesh(multi_pod=multi_pod, devices=[META] * n)


# ---------------------------------------------------------------------------
# Bytes from the specs
# ---------------------------------------------------------------------------


def _meta_like(tree, dtype: torch.dtype):
    """Meta tensors of ``dtype`` beside every tensor of a JAX-layout tree."""
    return tree_map(lambda leaf: stack_map(
        lambda t: torch.empty(t.shape, dtype=dtype, device=META), leaf), tree)


def _batch_spec_of(axes: MeshAxes, shape: tuple, global_batch: int) -> P:
    """The reference's rule: a leading dim of ``global_batch`` rows splits
    over the batch axes (fitted), anything else is replicated."""
    if len(shape) >= 1 and shape[0] == global_batch:
        return axes.fit(tuple(batch_pspec(axes)) + (None,) * (len(shape) - 1), shape)
    return P()


def _local_bytes(tree) -> int:
    return sum(s.local_bytes() for _, s in leaves_with_path(tree))


def argument_shapes(cfg, cell: ShapeCell, mesh, bundle=None) -> dict:
    """``ShardedShape`` trees of one cell's arguments on ``mesh`` (the
    production mesh, a meta mesh or one of cards): 'params', then
    'opt' ({'m', 'v', 'step'}) and 'batch' for train, 'batch' for prefill,
    'cache', 'token' and 'pos' for decode."""
    axes = MeshAxes(mesh)
    bundle = bundle or build_model(cfg, device=META)
    params = bundle.params_shape().jax_layout()
    pspecs = param_pspecs(params, cfg, axes)
    out = {"params": attach(mesh, params, pspecs)}
    specs = bundle.input_specs(cell)
    if cell.kind == "train":
        mdt = common.dtype_of(_moe_moment_dtype(cfg))
        moments = _meta_like(params, mdt)
        out["opt"] = {"m": attach(mesh, moments, pspecs), "v": attach(mesh, moments, pspecs),
                      "step": ShardedShape((), torch.int32, P(), mesh)}
    if cell.kind == "decode":
        cache = specs["cache"]
        out["cache"] = attach(mesh, cache, cache_pspecs(cache, cfg, axes))
        tok = specs["token"]
        out["token"] = ShardedShape(tuple(tok.shape), tok.dtype,
                                    axes.fit(tuple(batch_pspec(axes)), tuple(tok.shape)), mesh)
        out["pos"] = ShardedShape((), specs["pos"].dtype, P(), mesh)
    else:
        out["batch"] = {k: ShardedShape(tuple(v.shape), v.dtype,
                                        _batch_spec_of(axes, tuple(v.shape), cell.global_batch),
                                        mesh)
                        for k, v in specs.items()}
    return out


def argument_bytes(cfg, cell: ShapeCell, mesh, bundle=None) -> int:
    """The bytes of one cell's arguments that one device holds (every
    device holds as many: the specs split evenly)."""
    return sum(_local_bytes(t) for t in argument_shapes(cfg, cell, mesh, bundle).values())


def _whole_bytes(tree) -> int:
    return sum(int(np.prod(s.shape, dtype=np.int64)) * s.dtype.itemsize
               for _, s in leaves_with_path(tree))


def _local_tree(tree, specs, axes: MeshAxes, dtype: torch.dtype | None = None):
    """Meta tensors of one device's shards of a JAX-layout ``tree`` (a
    ``Stack``'s per-layer tensors split by the spec past its stacked axes)."""

    def leaf_of(leaf, spec):
        spec = tuple(spec)
        inner = spec[len(spec) - len(common.first_leaf(leaf).shape):]

        def one(t):
            shape = tuple(d // axes.axis_size(a) for d, a in zip(t.shape, inner))
            return torch.empty(shape, dtype=dtype or t.dtype, device=META)

        return stack_map(one, leaf)

    return tree_map(leaf_of, tree, specs)


# ---------------------------------------------------------------------------
# The LM cells
# ---------------------------------------------------------------------------


def _groups(axes: MeshAxes) -> int:
    """Data groups: the batch axes' blocks, one compute device each."""
    return int(np.prod([axes.axis_size(a) for a in axes.batch_axes()], dtype=np.int64))


def _group_rows(cell: ShapeCell, axes: MeshAxes) -> int:
    """The rows one group computes: the batch split by its fitted spec
    (a batch the axes do not divide is computed whole by every group)."""
    spec = axes.fit((tuple(batch_pspec(axes))[0],), (cell.global_batch,))
    return cell.global_batch // axes.axis_size(spec[0])


def _install_moe_hooks(cfg, axes: MeshAxes) -> None:
    """The MoE hooks of the traced program.  The port's layout hooks are
    value identities (no activation is split), so only the whole-layer
    override is set: REPRO_MOE_IMPL=shardmap selects the explicit
    all-to-all program (``make_shardmap_moe``) over one data group's
    ``model`` devices, whose whole cost the trace then puts on the compute
    device; a train step on more than one group routes by ``GroupRouting``
    instead, as ``MeshStep`` does."""
    moe_mod.set_shard_hooks(None, None)
    if not getattr(cfg, "n_experts", 0):
        moe_mod.set_impl(None)
        return
    if os.environ.get("REPRO_MOE_IMPL", "") == "shardmap":
        from repro_torch.models.moe_shardmap import make_shardmap_moe

        m = axes.axis_size(axes.model)
        group = Mesh(np.array([META] * m, dtype=object).reshape(1, m), ("data", "model"))
        moe_mod.set_impl(make_shardmap_moe(group))
    else:
        moe_mod.set_impl(None)


def _trace_train(bundle, cfg, cell, axes, whole) -> OpCost:
    """One data group's step on its compute device (``MeshStep``)."""
    n_groups = _groups(axes)
    if cell.global_batch % n_groups:
        raise ValueError(f"{cell.global_batch} rows do not split over {n_groups} data groups")
    rows = cell.global_batch // n_groups
    part = bundle.input_specs(ShapeCell(cell.name, cell.seq_len, rows, "train"))
    tree = whole.jax_layout()
    pspecs = param_pspecs(tree, cfg, axes)
    acc = _local_tree(tree, pspecs, axes, torch.float32)  # the float32 sums
    local = _local_tree(tree, pspecs, axes)
    mdt = common.dtype_of(_moe_moment_dtype(cfg))
    opt = AdamW(AdamWConfig(moment_dtype=_moe_moment_dtype(cfg)))
    state = {"m": _local_tree(tree, pspecs, axes, mdt), "v": _local_tree(tree, pspecs, axes, mdt),
             "step": torch.zeros((), dtype=torch.int32, device=META)}
    gnorm = torch.zeros((), dtype=torch.float32, device=META)
    routing = None
    if cfg.is_moe and n_groups > 1:
        layers = {id(m): name for name, m in whole.named_modules()
                  if isinstance(m, moe_mod.MoEParams)}
        routing = GroupRouting(n_groups, layers)
    prev = moe_mod._HOOKS["impl"]
    with OpCounter() as c:
        try:
            if routing is not None:
                moe_mod.set_impl(routing)
                with torch.no_grad():
                    bundle.loss_fn(whole, part)
                routing.counting = False
            _, _, grads = loss_and_grads(bundle, whole, part)
        finally:
            moe_mod.set_impl(prev)
        with torch.no_grad():
            for a, g in zip(tree_tensors(acc), tree_tensors(grads), strict=True):
                a.add_(g[tuple(slice(0, n) for n in a.shape)])  # its own shard's block
        del grads
        opt.update(acc, state, local, gnorm=gnorm)
    return c.cost()


def _meta_sharded(mesh, spec, shape: tuple, dtype: torch.dtype) -> Sharded:
    """A ``Sharded`` of meta shards: one meta tensor of the local shape
    stands for every position's shard."""
    shards = np.empty(mesh.devices.shape, dtype=object)
    sh = Sharded(mesh, spec, tuple(shape), dtype, shards)
    local = torch.empty(sh.local_shape(), dtype=dtype, device=META)
    for idx in np.ndindex(shards.shape):
        shards[idx] = local
    return sh


def _meta_placed(mesh, tree, specs, dtype: torch.dtype | None = None):
    """A placed tree of ``Sharded`` meta leaves: every position holds one
    meta tensor of its local shape (the shapes ``place_tree`` gives)."""

    def leaf_of(leaf, spec):
        inner = layer_spec(leaf, spec)
        return stack_map(lambda t: _meta_sharded(mesh, inner, tuple(t.shape), dtype or t.dtype),
                         leaf)

    return tree_map(leaf_of, tree, specs)


def _meta_cache(mesh, shape, specs):
    """A cache of ``Sharded`` meta leaves in ``specs``' layout, in the
    model's structure (``MeshServe``'s ``init_cache``)."""
    return zeros_like_cache(mesh, shape, specs, make=_meta_sharded)


def _remote_grad_bytes(mesh, params, target: tuple) -> int:
    """The gradient bytes ``target`` receives from the other devices' uses
    of its blocks in one step (device ``target``'s own uses are traced):
    per leaf, one shard's bytes for every use by another (group, model)
    device of a shard of ``target``'s block, which reaches ``target``
    either through the FSDP gather's backward (a use of ``target``'s own
    shard) or through ``GradSink``'s sum of a block's uses (a replica's)."""
    axes = MeshAxes(mesh)
    n_groups, n_model = _groups(axes), axes.axis_size(axes.model)
    memo: dict = {}
    total = 0
    for sh in tree_tensors(params):
        key = (tuple(sh.spec), tuple(sh.shape))
        if key not in memo:
            block = sh._block(target)
            n = 0
            for g in range(n_groups):
                for m in range(n_model):
                    if split_mod.position(mesh, g, m) == target:
                        continue
                    n += sum(1 for p in split_mod.uses(mesh, sh, g, m) if sh._block(p) == block)
            memo[key] = n
        total += memo[key] * sh.local(0).numel() * sh.dtype.itemsize
    return total


def _trace_split_train(bundle, cfg, cell, mesh, axes) -> tuple[OpCost, dict]:
    """Device (0, M - 1)'s step in the split program (``MeshStep.split_grads``
    with ``only=M - 1``: its forward and backward over group 0's rows with its model
    slices, its gradients into its sums; the counting pass too where more
    than one group routes an MoE layer), then its ``AdamW.update``.
    Returns (cost, bytes received by kind)."""
    n_groups = _groups(axes)
    if cell.global_batch % n_groups:
        raise ValueError(f"{cell.global_batch} rows do not split over {n_groups} data groups")
    mesh = Mesh(np.full(mesh.devices.shape, META, dtype=object), mesh.axis_names)
    tree = bundle.params_shape().jax_layout()
    pspecs = param_pspecs(tree, cfg, axes)
    params = _meta_placed(mesh, tree, pspecs)
    acc = _meta_placed(mesh, tree, pspecs, torch.float32)
    mdt = common.dtype_of(_moe_moment_dtype(cfg))
    opt = AdamW(AdamWConfig(moment_dtype=_moe_moment_dtype(cfg)))
    state = {"m": _local_tree(tree, pspecs, axes, mdt), "v": _local_tree(tree, pspecs, axes, mdt),
             "step": torch.zeros((), dtype=torch.int32, device=META)}
    gnorm = torch.zeros((), dtype=torch.float32, device=META)
    batch = bundle.input_specs(cell)
    step = MeshStep(bundle, opt, mesh)
    last = axes.axis_size(axes.model) - 1
    target = split_mod.position(mesh, 0, last)
    flat = int(np.ravel_multi_index(target, mesh.devices.shape))
    with OpCounter(exclude=split_mod.gathering) as c, recording() as rec:
        step.split_grads(batch, acc, params, groups=[0], only=last)
        opt.update(local_tree(acc, flat), state, local_tree(params, flat), gnorm=gnorm)
    received = defaultdict(float)
    for (key, kind), n in rec.items():
        if key == target:
            received[kind] += n
    received["reduce-scatter"] += _remote_grad_bytes(mesh, params, target)
    return c.cost(), received


def _trace_split_serve(bundle, cfg, cell, mesh, axes) -> tuple[OpCost, dict]:
    """Device (0, M - 1)'s part of the split serve program (``MeshServe``
    with ``groups=[0], only=M - 1``): a prefill of group 0's rows writing
    the device's part of the cache (allocated in the trace, its shard's
    bytes a temp), or one decode step at the cache's last position on its
    shard of the cache (an argument).  Returns (cost, bytes received by
    kind)."""
    mesh = Mesh(np.full(mesh.devices.shape, META, dtype=object), mesh.axis_names)
    tree = bundle.params_shape().jax_layout()
    params = _meta_placed(mesh, tree, param_pspecs(tree, cfg, axes))
    serve = MeshServe(bundle, mesh)
    last = axes.axis_size(axes.model) - 1
    target = split_mod.position(mesh, 0, last)
    b = cell.global_batch
    shape = bundle.cache_shape(b, cell.seq_len)
    specs = cache_pspecs(shape, cfg, axes)
    cache = None if cell.kind == "prefill" else _meta_cache(mesh, shape, specs)
    with OpCounter(exclude=split_mod.gathering) as c, recording() as rec:
        if cell.kind == "prefill":
            cache = _meta_cache(mesh, shape, specs)
            serve.prefill(params, bundle.input_specs(cell), groups=[0], only=last, cache=cache)
        else:
            token = torch.empty((b,), dtype=torch.int32, device=META)
            serve.decode_step(params, cache, token, cell.seq_len - 1, groups=[0], only=last)
        del cache
    received = defaultdict(float)
    for (key, kind), n in rec.items():
        if key == target:
            received[kind] += n
    return c.cost(), received


def _trace_serve(bundle, cell, axes, whole, group_cache) -> OpCost:
    """One data group's forward on its compute device; its outputs (the
    logits, and prefill's cache) count as ``end_bytes``."""
    rows = _group_rows(cell, axes)
    with torch.inference_mode():
        if cell.kind == "prefill":
            part = bundle.input_specs(ShapeCell(cell.name, cell.seq_len, rows, "prefill"))
            _, cost = count(bundle.prefill, whole, part)
        else:
            token = torch.empty((rows,), dtype=torch.int32, device=META)
            _, cost = count(bundle.decode_step, whole, group_cache, token, cell.seq_len - 1)
    return cost


def reckon_lm(cfg, cell: ShapeCell, mesh, flash_blk: int = 1024) -> tuple[OpCost, dict]:
    """The counted cost of the fullest device's program on ``mesh`` (device
    (0, M - 1) of the split program for a ``SPLIT_FAMILIES`` cell, else one
    data group's), and what it holds and moves: ``memory`` and ``transfer``
    dicts (bytes; the split program's transfer is what the device
    receives)."""
    axes = MeshAxes(mesh)
    bundle = build_model(cfg, flash_blk, device=META)
    bundle.model.shard_x = activation_sharder(mesh, axes)
    shapes = argument_shapes(cfg, cell, mesh, bundle)
    whole = bundle.model.empty_params(device=META)  # the gathered copy
    params_whole = _whole_bytes(shapes["params"])
    params_local = _local_bytes(shapes["params"])
    gathered, gather_in, scatter_out, sums = params_whole, params_whole - params_local, 0, 0
    group_cache = None
    prev = dict(moe_mod._HOOKS)
    _install_moe_hooks(cfg, axes)
    n_dev = int(np.prod(mesh.devices.shape))
    split = cfg.family in SPLIT_FAMILIES and (
        cell.kind == "train" or os.environ.get("REPRO_MOE_IMPL", "") != "shardmap")
    transfer: dict = {}
    try:
        if cell.kind == "train":
            batch_whole, batch_local = _whole_bytes(shapes["batch"]), _local_bytes(shapes["batch"])
            gather_in += batch_whole - batch_local  # MeshStep gathers the batch on (0, 0)
            sums = sum(int(np.prod(s.local_shape(), dtype=np.int64)) * 4
                       for _, s in leaves_with_path(shapes["params"]))
        if split and cell.kind != "train":
            cost, transfer = _trace_split_serve(bundle, cfg, cell, mesh, axes)
            # (0, M - 1) receives group 0's rows (the prompt, or the tokens) from
            # the mesh's first device, where MeshServe takes the batch
            rows = int(_whole_bytes(shapes["batch" if cell.kind == "prefill" else "token"])
                       * _group_rows(cell, axes) // cell.global_batch)
            if axes.axis_size(axes.model) > 1:
                transfer["all-gather"] += rows
            gathered = cost.excluded_bytes + rows
        elif split:
            cost, transfer = _trace_split_train(bundle, cfg, cell, mesh, axes)
            # (0, M - 1) receives group 0's rows from (0, 0), which gathers the batch
            last_is_first = axes.axis_size(axes.model) == 1
            transfer["all-gather"] += (batch_whole - batch_local if last_is_first
                                       else batch_whole // _groups(axes))
            gathered = cost.excluded_bytes + batch_whole // _groups(axes)
        elif cell.kind == "train":
            gathered += batch_whole
            scatter_out = (n_dev - 1) * params_local  # its gradient's slice to every shard
            cost = _trace_train(bundle, cfg, cell, axes, whole)
        else:
            if cell.kind == "decode":
                group_cache = bundle.cache_shape(_group_rows(cell, axes), cell.seq_len)
                cache_group = sum(t.numel() * t.element_size() for _, t in
                                  leaves_with_path(group_cache))
                gathered += cache_group
                gather_in += cache_group - _local_bytes(shapes["cache"])
            cost = _trace_serve(bundle, cell, axes, whole, group_cache)
    finally:
        moe_mod.set_shard_hooks(prev["tokens"], prev["experts"], prev["weights"])
        moe_mod.set_impl(prev["impl"])
    memory = {"argument_bytes": sum(_local_bytes(t) for t in shapes.values()),
              "gathered_bytes": gathered, "sum_bytes": sums}
    if not split:
        transfer = {"all-gather": float(gather_in)}
        if cell.kind == "train":
            transfer["reduce-scatter"] = float(scatter_out)
    transfer = {k: float(v) for k, v in sorted(transfer.items())}
    return cost, {"memory": memory, "transfer": transfer, "bundle": bundle,
                  "n_compute": n_dev if split else _groups(axes)}


def lower_cell(arch: str, shape: str, multi_pod: bool, flash_blk: int = 1024):
    """Returns (cost, meta) for one dry-run cell: the ``OpCost`` of the
    fullest device's traced program, and the cell's reckoning."""
    cfg = get_config(arch)
    mesh = meta_mesh(multi_pod)
    axes = MeshAxes(mesh)

    if getattr(cfg, "family", "") == "xtime":
        return _lower_xtime(cfg, shape, mesh, axes)

    cell = SHAPES[shape]
    if cell.name == "long_500k" and not cfg.supports_long_context:
        raise SkipCell(f"{arch} is pure full-attention; long_500k skipped per "
                       "assignment rule (see DESIGN.md §Arch-applicability)")

    cost, r = reckon_lm(cfg, cell, mesh, flash_blk)
    fn_kind = {"train": "train_step", "prefill": "serve_prefill", "decode": "serve_step"}
    meta = {
        "arch": arch, "shape": shape, "kind": fn_kind[cell.kind],
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": int(np.prod(mesh.devices.shape)),
        "n_compute_devices": r["n_compute"],
        "model_flops_total": model_flops(cfg, cell, r["bundle"]),
        "memory": r["memory"], "transfer": r["transfer"],
    }
    return cost, meta


# ---------------------------------------------------------------------------
# X-TIME tabular cell (the paper's own workload on the production mesh)
# ---------------------------------------------------------------------------


def _lower_xtime(cfg, shape: str, mesh, axes: MeshAxes):
    """The reference's compact program, one device's share of it: CAM rows
    sharded on `model`, queries on the batch axes; uint8 bounds with an
    INCLUSIVE upper bound (match = low <= q <= high) and bf16 leaf values,
    row chunks of 65,536 and query chunks of 131,072 (each split over the
    mesh as the reference's chunk constraints split them), the (Bq, Rc)
    match tile against the leaf block accumulated in float32.  The sum
    over `model` (the H-tree reduction) is the port's accumulate program:
    each row shard's partial margins go to the group's device at model
    index 0 (``transfer['reduce']``)."""
    batch = {"serve_32k": 32768, "serve_1m": 1_048_576}[shape]
    rows = cfg.n_trees * cfg.max_leaves  # 4096 x 256 = 1,048,576 CAM rows
    f_pad = int(np.ceil(cfg.n_features / 128)) * 128
    c_pad = 8
    n_b = axes.axis_size(tuple(batch_pspec(axes))[0])
    n_m = axes.axis_size(axes.model)
    r_chunk = 65536
    b_chunk = min(batch, 131072)
    nc, nbq = rows // r_chunk, batch // b_chunk
    rc, bq = r_chunk // n_m, b_chunk // n_b  # one device's block of a chunk

    def m(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=META)

    q = m((batch // n_b, f_pad), torch.uint8)
    low, high = m((rows // n_m, f_pad), torch.uint8), m((rows // n_m, f_pad), torch.uint8)
    leaf = m((rows // n_m, c_pad), torch.bfloat16)

    def serve_step(q, low, high, leaf):
        lows, highs = low.reshape(nc, rc, f_pad), high.reshape(nc, rc, f_pad)
        leafs, qs = leaf.reshape(nc, rc, c_pad), q.reshape(nbq, bq, f_pad)
        outs = []
        for b in range(nbq):
            qc = qs[b]
            acc = torch.zeros((bq, c_pad), dtype=torch.float32, device=META)
            for r in range(nc):
                cell = (lows[r][None] <= qc[:, None, :]) & (qc[:, None, :] <= highs[r][None])
                match = torch.all(cell, dim=-1)  # (Bq, Rc)
                acc = acc + torch.mm(match.to(leafs.dtype), leafs[r]).float()
            outs.append(acc)
        return torch.cat(outs)

    _, cost = count(serve_step, q, low, high, leaf)
    arg = sum(t.numel() * t.element_size() for t in (q, low, high, leaf))
    # MODEL_FLOPS counts only the match @ leaf products; the range compares
    # are integer ops, reported apart so the useful-FLOP ratio stays
    # comparable with the LM rows
    mf = 2.0 * float(batch) * rows * c_pad
    meta = {
        "arch": cfg.name, "shape": shape, "kind": "xtime_serve",
        "mesh": "2x16x16" if axes.pod else "16x16",
        "n_devices": int(np.prod(mesh.devices.shape)),
        "n_compute_devices": int(np.prod(mesh.devices.shape)),
        "model_flops_total": mf,
        "compare_ops_total": 2.0 * float(batch) * rows * cfg.n_features,
        "memory": {"argument_bytes": arg, "gathered_bytes": 0, "sum_bytes": 0},
        "transfer": {"reduce": float((n_m - 1) * (batch // n_b) * c_pad * 4)},
    }
    return cost, meta


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def result_of(cost: OpCost, meta: dict) -> dict:
    """The cell's JSON fields (the reference's keys where the quantity
    exists) from its counted cost and reckoning."""
    meta = dict(meta)
    mem, transfer = meta.pop("memory"), meta.pop("transfer")
    hlo = hlo_analysis.HLOCost(dot_flops=cost.dot_flops, fusion_boundary_bytes=cost.op_bytes,
                               collective_bytes=float(sum(transfer.values())),
                               collective_breakdown=transfer)
    terms = hlo_analysis.roofline_from_cost(
        hlo, model_flops_per_dev=meta["model_flops_total"] / meta["n_compute_devices"])
    per_dev = (mem["argument_bytes"] + mem["gathered_bytes"] + mem["sum_bytes"]
               + cost.temp_bytes)
    return {
        **meta,
        "memory": {
            "argument_bytes": int(mem["argument_bytes"]),
            "gathered_bytes": int(mem["gathered_bytes"]),
            "sum_bytes": int(mem["sum_bytes"]),
            "temp_bytes": int(cost.temp_bytes),
            "output_bytes": int(cost.end_bytes),
            "code_bytes": None,
            "total_per_device_gib": round(per_dev / 2**30, 3),
            "fits_h100_80gib": bool(per_dev < FITS_BYTES),
        },
        "cost_analysis_raw": None,
        "counted": {
            "dot_flops_per_dev": cost.dot_flops,
            "op_bytes_per_dev": cost.op_bytes,
            "collective_bytes_per_dev": hlo.collective_bytes,
            "collective_breakdown": transfer,
            "n_ops": cost.n_ops,
        },
        "roofline": {
            "compute_s": terms.compute_s,
            "memory_s": terms.memory_s,
            "collective_s": terms.collective_s,
            "dominant": terms.dominant,
            "bound_s": terms.bound_s,
            "model_flops_ratio": terms.useful_flop_ratio,
        },
    }


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: str,
             flash_blk: int = 1024) -> dict:
    t0 = time.time()
    mesh_name = "multi" if multi_pod else "single"
    result: dict = {"arch": arch, "shape": shape, "mesh": mesh_name}
    try:
        cost, meta = lower_cell(arch, shape, multi_pod, flash_blk)
        result.update(result_of(cost, meta))
        result["status"] = "ok"
        result["trace_s"] = round(time.time() - t0, 1)
    except SkipCell as e:
        result.update({"status": "skip", "reason": str(e)})
    except Exception as e:  # noqa: BLE001 — a failed cell is a result
        result.update({
            "status": "error",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        })
    result["wall_s"] = round(time.time() - t0, 1)
    os.makedirs(out_dir, exist_ok=True)
    fn = os.path.join(out_dir, f"{arch}__{shape}__{mesh_name}.json")
    with open(fn, "w") as f:
        json.dump(result, f, indent=1, default=float)
    return result


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="X-TIME port multi-pod dry run on meta devices")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out-dir", default="results/dryrun_torch")
    ap.add_argument("--flash-blk", type=int, default=1024)
    args = ap.parse_args(argv)
    res = run_cell(args.arch, args.shape, args.multi_pod, args.out_dir, args.flash_blk)
    brief = {k: v for k, v in res.items()
             if k in ("arch", "shape", "mesh", "status", "trace_s", "wall_s",
                      "error", "reason")}
    print(json.dumps(brief))
    if res["status"] == "ok":
        print("memory_analysis:", json.dumps(res["memory"]))
        print("roofline:", json.dumps(res["roofline"]))


if __name__ == "__main__":
    main()
