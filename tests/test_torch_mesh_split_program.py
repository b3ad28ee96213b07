"""The split program's parts on the CPU (``repro_torch.sharding.split``
and ``collectives``), no XLA flag:

  * each transformer config really splits its query heads, FFN hidden,
    experts and vocab over `model`;
  * each collective against explicit sums in ascending order, and its
    backward by ``torch.autograd.gradcheck`` in float64; a solo trace's
    stand-ins and the received-bytes recording;
  * a recording of every FSDP gather: each at most one leaf's model
    slice, and at most one unit's gathered blocks alive at once;
  * the split program's dot FLOPs (a group's M devices, traced on meta)
    equal the gathered program's, exactly, for the train step and for the
    serve steps (prefill and decode, ``launch.serve.MeshServe``), for the
    transformer configs, the recurrent families (zamba2's hybrid and
    rwkv6's ssm) and whisper's encoder-decoder; the device the dry run
    traces, the group's last, computes the most.

The step against one device and the JAX package: test_torch_mesh_split.py.
"""

import weakref

import numpy as np
import pytest
import torch

from _torch_lm import smoke_pair
from _torch_lm_train import weights
from repro_torch.config import ShapeCell
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import dryrun
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.launch.op_count import OpCounter
from repro_torch.models import moe as tmoe
from repro_torch.models.common import leaf_tensors, tree_leaves
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim import adamw as tadamw
from repro_torch.sharding import collectives as col
from repro_torch.sharding import partition as tpart
from repro_torch.sharding import split as tsplit

CPU = torch.device("cpu")
META = torch.device("meta")
SHAPES = [(4, 2), (2, 4), (1, 8), (8, 1)]
# every transformer config; the MoE ones at a capacity where tokens drop
CONFIGS = {
    "llama3.2-3b": {},
    "gemma3-1b": {},
    "phi3-mini-3.8b": {},
    "granite-20b": {},
    "llava-next-mistral-7b": {},
    "deepseek-v3-671b": {"capacity_factor": 0.5, "remat": True},
    "arctic-480b": {"capacity_factor": 0.5},
}
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its steps are many small
    ops on 8 logical shards, which a thread pool shared with the other
    test workers only slows down; the previous count is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cpu_mesh(shape):
    return make_host_mesh(*shape, devices=["cpu"] * 8)


def _config(name):
    return smoke_pair(name, dtype="float32", **CONFIGS[name])[1]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_each_config_splits_over_model(name):
    """On one of the four shapes at least, `fit` keeps `model` on the query
    heads' columns (wq, or MLA's wuq), the FFN hidden (a dense FFN's w_gate),
    the experts (an MoE layer's w_gate) and the vocab (the embedding's
    rows, the untied head's columns), each shard 1/M of the dim."""
    cfg = _config(name)
    shapes = tbuild(cfg, device="meta").params_shape().jax_layout()
    split_on = []
    for shape in SHAPES:
        mesh = cpu_mesh(shape)
        axes = tpart.MeshAxes(mesh)
        placed = dryrun._meta_placed(mesh, shapes, tpart.param_pspecs(shapes, cfg, axes))
        by = {"/".join(map(str, p)): leaf_tensors(leaf)[0] for p, leaf in tree_leaves(placed)}

        def on_model(path, dim):
            sh = by[path]
            md, _ = tpart.leaf_axes(sh.spec, axes)
            return md == dim and sh.local_shape()[dim] * shape[1] == sh.shape[dim]

        heads = on_model("seg0/attn/wuq" if cfg.use_mla else "seg0/attn/wq", 1)
        dense = [p for p in by if p.endswith("w_gate") and len(by[p].shape) == 2]
        ffn = any(on_model(p, 1) for p in dense)
        experts = (not cfg.is_moe) or all(on_model(p, 0) for p in by
                                          if p.endswith("w_gate") and len(by[p].shape) == 3)
        vocab = on_model("embed", 0) and (cfg.tie_embeddings or on_model("lm_head", 1))
        if shape[1] > 1 and heads and ffn and experts and vocab:
            split_on.append(shape)
    assert split_on, name


# -- the collectives --------------------------------------------------------------------------


def _parts(shapes, seed=3, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(s), dtype=dtype) for s in shapes]


def _ordered_sum(xs):
    total = xs[0].clone()
    for x in xs[1:]:
        total = total + x
    return total


COLLECTIVES = {
    "all_gather": (
        [(2, 3, 4), (2, 2, 4), (2, 2, 4)],
        lambda ps: col.all_gather(ps, 1),
        lambda ps: [torch.cat(ps, 1)] * 3),
    "reduce_scatter": (
        [(2, 7, 4)] * 3,
        lambda ps: col.reduce_scatter(ps, 1),
        lambda ps: list(torch.tensor_split(_ordered_sum(ps), 3, dim=1))),
    "all_reduce": (
        [(2, 5, 3)] * 3,
        lambda ps: col.all_reduce(ps),
        lambda ps: [_ordered_sum(ps)] * 3),
    "all_to_all": (
        [(2, 7, 6)] * 3,
        lambda ps: col.all_to_all(ps, 1, -1),
        lambda ps: [torch.cat([torch.tensor_split(p, 3, dim=1)[m] for p in ps], -1)
                    for m in range(3)]),
    "gather_to": (
        [(3, 4), (3, 4)],
        lambda ps: [col.gather_to(ps, 0, CPU)],
        lambda ps: [torch.cat(ps, 0)]),
    # three column blocks of a (2, 4, 18) value to column sets that overlap
    # (columns 15-17 go to two outputs) and cut the blocks
    "regroup": (
        [(2, 4, 6)] * 3,
        lambda ps: col.regroup(ps, [((0, 4), (6 * j, 6)) for j in range(3)],
                               [((0, 4), w) for w in REGROUP_WANT]),
        lambda ps: [torch.cat([torch.cat(ps, -1)[..., a:a + n] for a, n in w], -1)
                    for w in REGROUP_WANT]),
    # uneven row blocks of a (2, 6, 5) value to whole rows and column sets
    "regroup_rows": (
        [(2, 2, 5), (2, 3, 5), (2, 1, 5)],
        lambda ps: col.regroup(ps, [((0, 2), (0, 5)), ((2, 3), (0, 5)), ((5, 1), (0, 5))],
                               [((0, 6), [(0, 2), (4, 1)]), ((0, 6), [(1, 4)]),
                                ((1, 4), [(0, 5)])]),
        lambda ps: [torch.cat(ps, 1)[..., [0, 1, 4]], torch.cat(ps, 1)[..., 1:5],
                    torch.cat(ps, 1)[:, 1:5]]),
}
REGROUP_WANT = [[(0, 3), (15, 3)], [(3, 9)], [(12, 6)]]


@pytest.mark.parametrize("which", sorted(COLLECTIVES))
def test_collective_against_ordered_sums_and_gradcheck(which):
    """Forward: bit-equal to the explicit concatenation or the sum taken
    in ascending part order (float32), each output its own tensor;
    backward: ``gradcheck`` in float64."""
    shapes, fn, want = COLLECTIVES[which]
    ps = _parts(shapes, dtype=torch.float32)
    got = fn(ps)
    for g, w in zip(got, want(ps), strict=True):
        assert torch.equal(g, w)
    storages = [t.untyped_storage().data_ptr() for t in got + ps]
    assert len(set(storages)) == len(storages)
    ps64 = [p.requires_grad_() for p in _parts(shapes)]
    assert torch.autograd.gradcheck(lambda *xs: tuple(fn(list(xs))), tuple(ps64))


def test_collective_stand_ins_and_recording():
    """A solo trace: an inactive part is None and a meta stand-in takes its
    place; only the active outputs are computed; ``recording`` counts the
    bytes each position receives from the others."""
    ps = [torch.empty((2, 4, 8), device=META), None, None, None]
    with col.recording() as rec:
        out = col.all_gather(ps, 1, active=[0])
        assert out[0].shape == (2, 16, 8) and out[1:] == [None] * 3
    assert rec[(0, "all-gather")] == 3 * 2 * 4 * 8 * 4
    cpu = _parts([(4, 6)] * 4, dtype=torch.float32)
    with col.recording() as rec:
        col.reduce_scatter(cpu, 0)
    assert rec[(1, "reduce-scatter")] == 3 * 6 * 4


# -- the gathers -----------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama3.2-3b", "gemma3-1b", "deepseek-v3-671b"])
def test_gathers_hold_one_model_slice_and_one_unit(name):
    """One step on (4, 2): every FSDP gather is one leaf's model slice on
    its device (never more), and when a unit's gather starts no other
    unit's gathered tensor is alive (the backward's regathers and, under
    remat, recomputations included)."""
    cfg = _config(name)
    mesh = cpu_mesh((4, 2))
    bundle = tbuild(cfg, flash_blk=16, device="cpu")
    bundle.model.shard_x = tpart.activation_sharder(mesh)
    params = ttrain.place_params(mesh, cfg, lm_params_from_numpy(
        cfg, weights(name, "float32", 11), device="cpu"))
    opt = tadamw.AdamW(tadamw.AdamWConfig(**OPT))
    step = ttrain.make_train_step(bundle, opt, mesh)
    alive: dict = {}
    events = []

    def seen(unit, sh, m, t):
        md, _ = tpart.leaf_axes(sh.spec, tpart.MeshAxes(mesh))
        want = list(sh.shape)
        if md is not None:
            want[md] //= 2
        assert tuple(t.shape) == tuple(want), (unit, tuple(t.shape), want)
        others = {u for u in alive.values() if u != unit}
        assert not others, (unit, others)
        key = object()
        alive[key] = unit
        weakref.finalize(t.untyped_storage(), alive.pop, key, None)
        events.append(unit)

    batch = ttrain.place_batch(mesh, ttrain.on_device(
        ttrain.batch_source(cfg, 8, 32, seed=11)(0), CPU, torch.float32))
    with tsplit.watch_gathers(seen):
        step(params, opt.init(params), None, batch)
    layers = [u for u in events if u.startswith("seg")]
    assert len(set(layers)) == cfg.n_layers
    assert len(events) > len(set(events))  # gathered again in the backward


# -- dot FLOPs against the gathered program ---------------------------------------------------


def _group_flops(cfg, shape, seq, split: bool) -> float:
    """The dot FLOPs of one step's gradients on a meta mesh of ``shape``:
    every group's M devices in the split program, or every group's device
    in the gathered one."""
    mesh = Mesh(np.full(shape, META, dtype=object), ("data", "model"))
    bundle = tbuild(cfg, flash_blk=32, device="meta")
    tree = bundle.params_shape().jax_layout()
    specs = tpart.param_pspecs(tree, cfg, tpart.MeshAxes(mesh))
    params = dryrun._meta_placed(mesh, tree, specs)
    acc = dryrun._meta_placed(mesh, tree, specs, torch.float32)
    step = ttrain.MeshStep(bundle, tadamw.AdamW(tadamw.AdamWConfig()), mesh)
    batch = bundle.input_specs(ShapeCell("train", seq, 2 * shape[0], "train"))
    if split:
        with OpCounter() as c:
            step.split_grads(batch, acc, params)
    else:
        step._gather(params)
        with OpCounter() as c:
            step._group_grads(batch, acc)
    return c.cost().dot_flops


RECURRENT = ("rwkv6-1.6b", "zamba2-2.7b")  # split by heads, states on `model`
AUDIO = ("whisper-tiny",)  # an encoder over T frames beside a decoder over S tokens
FLOP_CASES = ([(n, (2, 4), 64) for n in sorted(CONFIGS) + list(RECURRENT + AUDIO)]
              + [(n, (1, 8), 60) for n in ("deepseek-v3-671b", "gemma3-1b", "llama3.2-3b")
                 + RECURRENT + AUDIO])


@pytest.mark.parametrize("name,shape,seq", FLOP_CASES,
                         ids=[f"{n}-{s[0]}x{s[1]}-S{q}" for n, s, q in FLOP_CASES])
def test_split_dot_flops_sum_to_the_gathered_programs(name, shape, seq):
    """Traced on meta, each smoke config as it is (bfloat16, no remat): the
    split program's dot FLOPs over a group's M devices equal the group's
    in the gathered program, exactly (flash blocks of 32: S 64 runs the
    blocked path, its query chunks within blocks; S 60 the whole path,
    chunks uneven and activations replicated; the recurrent families' SSD
    C B^T and RWKV's decay LoRA, which every head shares, computed once in
    the group, the rest by heads; on (1, 8) rwkv6's 4 heads on 4 of the 8
    devices; whisper's encoder over 64 or 60 frames, its decoder over 64
    tokens, the cross-attention's k and v column-parallel products of the
    encoder states).  Under remat the two differ
    by design: the recomputation stops once the last saved tensor is
    packed, which skips a layer's final product on one device only, so
    the split program recomputes M - 1 more of them."""
    _, cfg = smoke_pair(name)
    got = _group_flops(cfg, shape, seq, split=True)
    assert got == _group_flops(cfg, shape, seq, split=False) > 0


FULLEST_CASES = [(n, remat) for n in ("deepseek-v3-671b", "gemma3-1b", "llama3.2-3b")
                 + RECURRENT + AUDIO for remat in (False, True)]


@pytest.mark.parametrize("name,remat", FULLEST_CASES,
                         ids=[f"{n}-remat{int(r)}" for n, r in FULLEST_CASES])
def test_the_last_model_device_is_the_fullest(name, remat):
    """Each of a group's M devices traced alone on meta (``only=m``, as the
    dry run traces one) on (2, 4), S 64 in flash blocks of 32: the last
    holds the sequence's last chunk and computes the most dot FLOPs (the
    causal attention's key blocks grow with the chunk), with remat and
    without; the dry run's ``compute_s`` is that device's.  rwkv6 attends
    over nothing: its devices compute equal FLOPs (each its heads), the
    last among the most.  whisper's encoder and cross-attention chunks
    carry equal work (every row attends every key); its decoder's causal
    chunks make the last the fullest."""
    _, cfg = smoke_pair(name)
    cfg = cfg.replace(remat=remat)
    shape = (2, 4)
    mesh = Mesh(np.full(shape, META, dtype=object), ("data", "model"))
    bundle = tbuild(cfg, flash_blk=32, device="meta")
    tree = bundle.params_shape().jax_layout()
    specs = tpart.param_pspecs(tree, cfg, tpart.MeshAxes(mesh))
    params = dryrun._meta_placed(mesh, tree, specs)
    batch = bundle.input_specs(ShapeCell("train", 64, 2 * shape[0], "train"))
    flops = []
    for m in range(shape[1]):
        acc = dryrun._meta_placed(mesh, tree, specs, torch.float32)
        step = ttrain.MeshStep(bundle, tadamw.AdamW(tadamw.AdamWConfig()), mesh)
        with OpCounter() as c:
            step.split_grads(batch, acc, params, groups=[0], only=m)
        flops.append(c.cost().dot_flops)
    assert flops[-1] == max(flops) > 0, flops
    if name != "rwkv6-1.6b":
        assert flops[-1] > flops[0], flops


# -- the split serve program -----------------------------------------------------------------


def _serve_flops(cfg, shape, kind: str, seq: int, split: bool, only=None) -> float:
    """The dot FLOPs of group 0's prefill of 2 rows x ``seq``, or of its
    decode step at the last of ``seq`` positions, on a meta mesh of
    ``shape``: its M devices in the split program (``only``: that one), or
    its device in the gathered program (whole parameters, an MoE layer
    routed with the whole batch's capacity, ``GroupRouting``)."""
    mesh = Mesh(np.full(shape, META, dtype=object), ("data", "model"))
    axes = tpart.MeshAxes(mesh)
    bundle = tbuild(cfg, flash_blk=32, device="meta")
    b = 2 * shape[0]
    token = torch.empty((b,), dtype=torch.int32, device=META)
    if split:
        tree = bundle.params_shape().jax_layout()
        params = dryrun._meta_placed(mesh, tree, tpart.param_pspecs(tree, cfg, axes))
        cshape = bundle.cache_shape(b, seq)
        prompt = bundle.input_specs(ShapeCell(kind, seq, b, kind))
        if kind == "prefill" and cfg.is_encoder_decoder:  # k/v of the decoder's prompt
            cshape = bundle.model.init_cache(b, prompt["tokens"].shape[1], enc_len=seq,
                                             device=META)
        cache = dryrun._meta_cache(mesh, cshape, tpart.cache_pspecs(cshape, cfg, axes))
        serve = tserve.MeshServe(bundle, mesh)
        with OpCounter() as c:
            if kind == "prefill":
                serve.prefill(params, prompt, groups=[0], only=only, cache=cache)
            else:
                serve.decode_step(params, cache, token, seq - 1, groups=[0], only=only)
        return c.cost().dot_flops
    whole = bundle.model.empty_params(device=META)
    routing = ttrain.GroupRouting(shape[0], {id(m): name for name, m in whole.named_modules()
                                             if isinstance(m, tmoe.MoEParams)}, lockstep=True)
    tmoe.set_impl(routing if cfg.is_moe else None)
    try:
        with OpCounter() as c, torch.no_grad():
            if kind == "prefill":
                bundle.prefill(whole, bundle.input_specs(ShapeCell(kind, seq, 2, kind)))
            else:
                bundle.decode_step(whole, bundle.cache_shape(2, seq), token[:2], seq - 1)
    finally:
        tmoe.set_impl(None)
    return c.cost().dot_flops


SERVE_CASES = ([(n, k, (2, 4), 64) for n in sorted(CONFIGS) + list(RECURRENT + AUDIO)
                for k in ("prefill", "decode")]
               + [(n, k, (1, 8), 60) for n in ("deepseek-v3-671b", "gemma3-1b", "llama3.2-3b")
                  + RECURRENT + AUDIO for k in ("prefill", "decode")])


@pytest.mark.parametrize("name,kind,shape,seq", SERVE_CASES,
                         ids=[f"{n}-{k}-{s[0]}x{s[1]}-S{q}" for n, k, s, q in SERVE_CASES])
def test_split_serve_dot_flops_sum_to_the_gathered_programs(name, kind, shape, seq):
    """Traced on meta, each smoke config as it is: the split serve step's
    dot FLOPs over a group's M devices equal its group's in the gathered
    program, exactly, for prefill (flash blocks of 32) and decode (the KV
    cache on heads or sequence chunks at S 64 on (2, 4); at S 60 on
    (1, 8) whole on every device, its chunks uneven, and heads cut by the
    model slices; the recurrent states by heads, the decode's conv a chunk
    of channels a device): no product is computed twice (a replicated q,
    cache, router or C B^T would count M times; whisper's cross cache of
    64 or 60 frames by KV heads or whole, its encoder's and the cross k/v
    products in prefill)."""
    _, cfg = smoke_pair(name)
    got = _serve_flops(cfg, shape, kind, seq, split=True)
    assert got == _serve_flops(cfg, shape, kind, seq, split=False) > 0


FULLEST_SERVE = [(n, k) for n in ("deepseek-v3-671b", "gemma3-1b", "llama3.2-3b") + RECURRENT
                 + AUDIO for k in ("prefill", "decode")]


@pytest.mark.parametrize("name,kind", FULLEST_SERVE, ids=[f"{n}-{k}" for n, k in FULLEST_SERVE])
def test_the_last_model_device_is_the_fullest_in_serving(name, kind):
    """Each of a group's M devices traced alone on meta (``only=m``) on
    (2, 4), S 64: the last computes the most dot FLOPs, in prefill (the
    sequence's last chunk: the most causal work) and in decode (the
    token's row, where a weight `fit` leaves whole is multiplied, and the
    chunk that holds ``pos``; the recurrent families' devices each their
    heads, zamba2's shared attention the causal work)."""
    _, cfg = smoke_pair(name)
    flops = [_serve_flops(cfg, (2, 4), kind, 64, split=True, only=m) for m in range(4)]
    assert flops[-1] == max(flops) > 0, flops
    if kind == "prefill" and name != "rwkv6-1.6b":
        assert flops[-1] > flops[0], flops
