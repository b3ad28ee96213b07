"""The split program of the recurrent families on the CPU: zamba2's hybrid
(Mamba-2 + a shared attention block) and rwkv6's ssm split over `model`
(``repro_torch.sharding.split``), on logical CPU shards
(``make_host_mesh(..., devices=["cpu"] * 8)``), no XLA flag, the smoke
configs in float32:

  * the train step on (4, 2), (2, 4), (1, 8) and (8, 1) against the port's
    one-device step: losses within rtol 2e-4, every updated parameter within
    2e-4 of its scale, no compute device holding a whole copy; two runs
    bit-equal on (2, 4);
  * ``MeshServe``'s prefill and 4 greedy decode steps on the same shapes
    against one device: logits within 1e-4 of their scale, tokens equal,
    the gathered cache within 1e-5 of its scale, every shard of
    ``ShardedShape.local_shape``'s shape (the SSM state by heads on
    `model`; rwkv6's 4 heads on (1, 8) whole on every device), the conv
    tails, x_prev and a whole state equal on every device; two runs
    bit-equal on (2, 4);
  * on (2, 4), two train steps and ``generate(mesh=)`` against the JAX
    package's one-device step and prefill/decode, within the bounds of
    test_torch_mesh_split.py and test_torch_mesh_split_serve.py.

The dot FLOPs against the gathered program and the fullest device:
test_torch_mesh_split_program.py.
"""

import functools

import numpy as np
import pytest
import torch

from _torch_lm import flat_cache, model_pair, run_prefill_decode, smoke_pair
from _torch_lm_train import flat, global_rel, reference_steps, weights
from repro.models.registry import build_model as jbuild
from repro_torch.convert import lm_params_from_numpy, lm_tree_to_numpy
from repro_torch.data import TokenPipeline
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim import adamw as tadamw
from repro_torch.sharding import partition as tpart
from repro_torch.sharding.placement import gather_tree

CPU = torch.device("cpu")
SHAPES = [(4, 2), (2, 4), (1, 8), (8, 1)]
IDS = ["4x2", "2x4", "1x8", "8x1"]
NAMES = ["rwkv6-1.6b", "zamba2-2.7b"]
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
B, S, NEW = 8, 20, 4  # prefill of 8 x 20, 4 greedy steps: a cache of 24 positions


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (as the split step's
    tests): many small ops on 8 logical shards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cpu_mesh(shape):
    return make_host_mesh(*shape, devices=["cpu"] * 8)


def _config(name):
    return smoke_pair(name, dtype="float32")[1]


# -- the train step ----------------------------------------------------------------------------


def _batches(cfg, seq=32):
    get_batch = ttrain.batch_source(cfg, 8, seq, seed=11)
    return [get_batch(i) for i in range(2)]


def _steps(name, mesh=None, seq=32):
    """Two steps of ``make_train_step`` from ``weights(11)`` on B 8 x
    ``seq``, one device or ``mesh``: (losses, final params as numpy, the
    step)."""
    cfg = _config(name)
    bundle = tbuild(cfg, flash_blk=16, device="cpu")
    opt = tadamw.AdamW(tadamw.AdamWConfig(**OPT))
    params = lm_params_from_numpy(cfg, weights(name, "float32", 11), device="cpu")
    if mesh is not None:
        bundle.model.shard_x = tpart.activation_sharder(mesh)
        params = ttrain.place_params(mesh, cfg, params)
    step = ttrain.make_train_step(bundle, opt, mesh)
    state = opt.init(params)
    losses = []
    for b in _batches(cfg, seq):
        batch = ttrain.on_device(b, CPU, torch.float32)
        if mesh is not None:
            batch = ttrain.place_batch(mesh, batch)
        params, state, _, m = step(params, state, None, batch)
        losses.append(float(m["loss"]))
    tree = gather_tree(params, CPU) if mesh is not None else params.jax_layout()
    return losses, flat(lm_tree_to_numpy(tree)), step


@functools.cache
def _one_device_steps(name, seq=32):
    losses, params, _ = _steps(name, seq=seq)
    return losses, params


def _check_step(name, mesh, seq=32):
    ref_losses, ref = _one_device_steps(name, seq)
    losses, got, step = _steps(name, mesh, seq)
    assert step.split and not step._workers
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-4)
    assert got.keys() == ref.keys()
    for k in ref:
        err = np.abs(got[k] - ref[k]).max()
        assert err <= 2e-4 * max(1.0, np.abs(ref[k]).max()), (k, err)
    return losses, got


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("name", NAMES)
def test_split_step_matches_one_device(name, shape):
    """Two steps on the mesh: losses within rtol 2e-4 of one device's, every
    updated parameter within 2e-4 of its scale; the step is the split
    program and keeps no whole copy of the parameters on any device; on
    (2, 4) two runs bit-equal."""
    losses, got = _check_step(name, cpu_mesh(shape))
    if shape == (2, 4):
        losses2, got2, _ = _steps(name, cpu_mesh(shape))
        assert losses2 == losses
        assert all(np.array_equal(got2[k], got[k]) for k in got)


# -- prefill and decode ------------------------------------------------------------------------


def _prompt(cfg):
    rng = np.random.default_rng(5)
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))}


@functools.cache
def _one_device_serve(name):
    """One device's prefill and ``NEW`` greedy decode steps: (logits a step,
    tokens, the final cache's leaves)."""
    cfg = _config(name)
    bundle = tbuild(cfg, flash_blk=8, device="cpu")
    params = bundle.init_params(2)
    with torch.inference_mode():
        logits, cache = bundle.prefill(params, _prompt(cfg))
        cache = tserve._pad_cache_seq(cfg, cache, S, S + NEW)
        out, toks = [logits], [torch.argmax(logits, -1)]
        for i in range(NEW):
            logits, cache = bundle.decode_step(params, cache, toks[-1], S + i)
            out.append(logits)
            toks.append(torch.argmax(logits, -1))
    return out, toks, [t.clone() for t in flat_cache(cache)]


def _mesh_serve(name, shape):
    """The same through ``MeshServe`` on the mesh, fed one device's tokens:
    (logits, the cache's ``Sharded`` leaves)."""
    cfg = _config(name)
    mesh = cpu_mesh(shape)
    bundle = tbuild(cfg, flash_blk=8, device="cpu")
    placed = ttrain.place_params(mesh, cfg, bundle.init_params(2))
    serve = tserve.MeshServe(bundle, mesh)
    assert serve.split
    _, ref_toks, _ = _one_device_serve(name)
    logits, cache = serve.prefill(placed, _prompt(cfg), S + NEW)
    out = [logits]
    for i in range(NEW):
        logits, cache = serve.decode_step(placed, cache, ref_toks[i], S + i)
        out.append(logits)
    return out, flat_cache(cache)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("name", NAMES)
def test_split_serve_matches_one_device(name, shape):
    """Prefill of 8 x 20 and 4 greedy decode steps into a cache of 24
    positions (flash blocks of 8): logits within 1e-4 of their scale and
    their tokens one device's, the cache within 1e-5 of its scale and in
    ``cache_pspecs``'s layout, a leaf the specs leave whole (conv tails,
    x_prev, a state whose heads M does not divide) equal on every device;
    on (2, 4) two runs bit-equal."""
    cfg = _config(name)
    mesh = cpu_mesh(shape)
    axes = tpart.MeshAxes(mesh)
    ref, ref_toks, ref_cache = _one_device_serve(name)
    got, cache = _mesh_serve(name, shape)
    for step, (g, r) in enumerate(zip(got, ref, strict=True)):
        assert g.dtype == torch.float32 and g.shape == r.shape
        err = float((g - r).abs().max())
        assert err <= 1e-4 * max(1.0, float(r.abs().max())), (step, err)
        assert torch.equal(torch.argmax(g, -1), ref_toks[step])
    shape_tree = tbuild(cfg, device="meta").cache_shape(B, S + NEW)
    specs = [p for _, p in tpart.leaves_with_path(tpart.cache_pspecs(shape_tree, cfg, axes))]
    whole_seen = 0
    for sh, ref_leaf, spec in zip(cache, ref_cache, specs, strict=True):
        assert tuple(sh.spec) == tuple(spec)
        want = tpart.ShardedShape(tuple(sh.shape), sh.dtype, spec, mesh).local_shape()
        assert all(tuple(t.shape) == want for _, t in sh.items())
        err = float((sh.gather("cpu") - ref_leaf).abs().max())
        assert err <= 1e-5 * max(1.0, float(ref_leaf.abs().max())), err
        blocks: dict = {}  # every device holding a block holds the same bits
        for idx, t in sh.items():
            assert torch.equal(t, blocks.setdefault(sh._block(idx), t))
        whole_seen += tpart.leaf_axes(sh.spec, axes)[0] is None
    assert whole_seen > 0
    if name == "rwkv6-1.6b" and shape == (1, 8):  # 4 heads on 8 devices: the state whole
        assert tpart.leaf_axes(cache[0].spec, axes)[0] is None
    if name == "zamba2-2.7b":  # the SSM state (G, P, B, H, Pd, N) by heads
        assert tpart.leaf_axes(cache[2].spec, axes)[0] == 3
    if shape == (2, 4):
        got2, cache2 = _mesh_serve(name, shape)
        assert all(torch.equal(a, b) for a, b in zip(got2, got, strict=True))
        for a, b in zip(cache2, cache, strict=True):
            assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a.items(), b.items()))


# -- against the JAX package on (2, 4) ---------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_split_step_matches_the_reference(name):
    """Two steps on a (2, 4) mesh against the JAX package's one-device step
    (B 4 x S 32): losses within rtol 1e-5, parameters within 1e-3 in
    relative L2 over the tree (the bounds of test_torch_mesh_split.py)."""
    jcfg, tcfg = smoke_pair(name, dtype="float32")
    tree = weights(name, "float32", 4)
    pipe = TokenPipeline(tcfg.vocab_size, 4, 32, seed=4)
    batches = [pipe.batch(i) for i in range(2)]
    opt_kw = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)
    ref_losses, ref_params = reference_steps(jbuild(jcfg, flash_blk=16), tree, batches, opt_kw)
    mesh = cpu_mesh((2, 4))
    bundle = tbuild(tcfg, flash_blk=16, device="cpu")
    bundle.model.shard_x = tpart.activation_sharder(mesh)
    opt = tadamw.AdamW(tadamw.AdamWConfig(**opt_kw))
    params = ttrain.place_params(mesh, tcfg, lm_params_from_numpy(tcfg, tree, device="cpu"))
    step = ttrain.make_train_step(bundle, opt, mesh)
    state = opt.init(params)
    losses = []
    for b in batches:
        batch = ttrain.place_batch(mesh, ttrain.on_device(b, CPU, torch.float32))
        params, state, _, m = step(params, state, None, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    got = flat(lm_tree_to_numpy(gather_tree(params, CPU)))
    assert global_rel(got, flat(ref_params)) < 1e-3


@pytest.mark.parametrize("name", NAMES)
def test_split_serve_matches_the_reference(name):
    """``generate(mesh=)`` and ``MeshServe`` on (2, 4) against the JAX
    package's one-device prefill and decode (``run_prefill_decode``: a
    prompt of 4 x 28, one decode of token 7), weights from the JAX
    package's init: logits within 1e-4 of their scale and their greedy
    tokens equal (``generate``'s first), the prefill cache within 1e-5 of
    its scale (the bounds of test_torch_mesh_split_serve.py)."""
    jb, jp, tb, tp, _ = model_pair(name, "float32", seed=3, seeded=False, flash_blk=8)
    rng = np.random.default_rng(9)
    batch = {"tokens": rng.integers(0, tb.cfg.vocab_size, (4, 28)).astype(np.int32)}
    nxt = np.full(4, 7, np.int32)
    (_, jl), (_, jd), caches = run_prefill_decode(jb, jp, tb, tp, batch, nxt)
    mesh = cpu_mesh((2, 4))
    placed = ttrain.place_params(mesh, tb.cfg, tp)
    toks = tserve.generate(tb, placed, ttrain.place_batch(mesh, {"tokens": torch.as_tensor(
        batch["tokens"])})["tokens"], max_new=2, mesh=mesh)
    assert np.array_equal(toks[:, 0], np.argmax(jl, -1))
    serve = tserve.MeshServe(tb, mesh)
    logits, cache = serve.prefill(placed, {"tokens": torch.as_tensor(batch["tokens"])}, 32)
    prefilled = [sh.gather("cpu").numpy() for sh in flat_cache(cache)]
    step, _ = serve.decode_step(placed, cache, torch.as_tensor(nxt), 28)
    for got, ref in ((logits, jl), (step, jd)):
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())
        assert np.array_equal(np.argmax(got.numpy(), -1), np.argmax(ref, -1))
    for got, (_, ref) in zip(prefilled, caches, strict=True):
        if got.shape != ref.shape:  # k/v: the prompt's positions of the grown cache
            got = got[:, :, :ref.shape[2]]
        assert np.abs(got - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("name", NAMES)
def test_split_where_model_does_not_divide_the_weights(name):
    """A (2, 3) mesh, S 30: `fit` keeps `model` on no projection (in_proj's
    296, out_proj's 128, RWKV's 64 columns do not divide by 3), so every
    weight is whole and takes its own rows, the heads (8 or 4) go 3, 3, 2
    or 2, 1, 1 to the devices, the products' rows regrouped into them and
    back; RWKV's token shift under sequence rows reads the row before from
    the device before.  The train step within the bounds above, and one
    prefill and decode step's logits within 1e-4 of their scale."""
    mesh = make_host_mesh(2, 3, devices=["cpu"] * 6)
    _check_step(name, mesh, seq=30)
    cfg = _config(name)
    bundle = tbuild(cfg, flash_blk=8, device="cpu")
    params = bundle.init_params(2)
    prompt = {"tokens": _prompt(cfg)["tokens"][:6, :18]}  # 6 rows: 3 a group; 18 rows: 6 a device
    nxt = torch.arange(6) + 3
    ref = tserve.teacher_forced(bundle, params, prompt, torch.stack([nxt, nxt], 1))
    got = tserve.teacher_forced(bundle, ttrain.place_params(mesh, cfg, params), prompt,
                                torch.stack([nxt, nxt], 1), mesh=mesh)
    assert float((got - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))
