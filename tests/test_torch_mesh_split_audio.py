"""The split program of the audio family on the CPU: whisper's
encoder-decoder split over `model` (``repro_torch.sharding.split``), its
encoder over the T frames and its decoder over the S tokens on one data
group's devices, on logical CPU shards (``make_host_mesh(...,
devices=["cpu"] * 8)``), no XLA flag, the smoke config in float32:

  * the train step on (4, 2), (2, 4), (1, 8) and (8, 1) against the port's
    one-device step: losses within rtol 2e-4, every updated parameter within
    2e-4 of its scale, no compute device holding a whole copy; two runs
    bit-equal on (2, 4); under remat on (2, 4);
  * ``MeshServe``'s prefill and 4 greedy decode steps on the same shapes
    against one device: logits within 1e-4 of their scale, tokens equal,
    the gathered cache within 1e-5 of its scale, every shard of
    ``ShardedShape.local_shape``'s shape (the 4 KV heads on `model` on
    (4, 2) and (2, 4); on (1, 8) the cross cache by chunks of T = 24 frames,
    whole with T = 20); two runs bit-equal on (2, 4);
  * on (2, 4), two train steps and ``prefill``/``decode_step`` against the
    JAX package's one-device ``EncDecLM`` with weights from its init,
    within the bounds of test_torch_mesh_split.py and
    test_torch_mesh_split_serve.py;
  * a (2, 3) mesh, where `model` divides no weight.

The dot FLOPs against the gathered program and the fullest device:
test_torch_mesh_split_program.py.
"""

import functools

import numpy as np
import pytest
import torch

from _torch_lm import flat_cache, model_pair, run_prefill_decode, smoke_pair
from _torch_lm_train import flat, global_rel, reference_steps, weights
from repro_torch.convert import lm_params_from_numpy, lm_tree_to_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim import adamw as tadamw
from repro_torch.sharding import partition as tpart
from repro_torch.sharding.placement import gather_tree

CPU = torch.device("cpu")
NAME = "whisper-tiny"
SHAPES = [(4, 2), (2, 4), (1, 8), (8, 1)]
IDS = ["4x2", "2x4", "1x8", "8x1"]
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
B, S, NEW = 8, 20, 4  # prefill of 8 x 20 tokens, 4 greedy steps: a self cache of 24


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


def _config(**replace):
    return smoke_pair(NAME, dtype="float32", **replace)[1]


# -- the train step ----------------------------------------------------------------------------


def _steps(mesh=None, frames=32, remat=False):
    """Two steps of ``make_train_step`` from ``weights(11)`` on the
    trainer's audio batches (B 8, ``frames`` frames, 64 decoder tokens),
    one device or ``mesh``: (losses, final params as numpy, the step)."""
    cfg = _config(remat=remat)
    bundle = tbuild(cfg, flash_blk=16, device="cpu")
    opt = tadamw.AdamW(tadamw.AdamWConfig(**OPT))
    params = lm_params_from_numpy(cfg, weights(NAME, "float32", 11), device="cpu")
    if mesh is not None:
        bundle.model.shard_x = tpart.activation_sharder(mesh)
        params = ttrain.place_params(mesh, cfg, params)
    step = ttrain.make_train_step(bundle, opt, mesh)
    state = opt.init(params)
    get_batch = ttrain.batch_source(cfg, 8, frames, seed=11)
    losses = []
    for i in range(2):
        batch = ttrain.on_device(get_batch(i), CPU, torch.float32)
        if mesh is not None:
            batch = ttrain.place_batch(mesh, batch)
        params, state, _, m = step(params, state, None, batch)
        losses.append(float(m["loss"]))
    tree = gather_tree(params, CPU) if mesh is not None else params.jax_layout()
    return losses, flat(lm_tree_to_numpy(tree)), step


@functools.cache
def _one_device_steps(frames=32):
    losses, params, _ = _steps(frames=frames)
    return losses, params


def _check_step(mesh, frames=32, remat=False):
    ref_losses, ref = _one_device_steps(frames)
    losses, got, step = _steps(mesh, frames, remat)
    assert step.split and not step._workers
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-4)
    assert got.keys() == ref.keys()
    assert any(k.startswith("/enc/") for k in ref)
    for k in ref:
        err = np.abs(got[k] - ref[k]).max()
        assert err <= 2e-4 * max(1.0, np.abs(ref[k]).max()), (k, err)
    return losses, got


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_split_step_matches_one_device(shape):
    """Two steps on the mesh: losses within rtol 2e-4 of one device's, every
    updated parameter within 2e-4 of its scale (the encoder's too, whose
    gradients arrive through every decoder layer's cross-attention); the
    step is the split program and keeps no whole copy of the parameters
    on any device; on (2, 4) two runs bit-equal."""
    losses, got = _check_step(cpu_mesh(shape))
    if shape == (2, 4):
        losses2, got2, _ = _steps(cpu_mesh(shape))
        assert losses2 == losses
        assert all(np.array_equal(got2[k], got[k]) for k in got)


def test_split_step_under_remat():
    """The same on (2, 4) with ``cfg.remat``: each encoder and decoder layer
    runs under ``split_lm.remat_layer`` (its weights gathered again and the
    cross-attention's k/v recomputed from the encoder states in the
    backward), within the bounds above of one device's step without remat
    (remat gives bit-equal gradients on one device)."""
    _check_step(cpu_mesh((2, 4)), remat=True)


# -- prefill and decode ------------------------------------------------------------------------


def _prompt(cfg, frames: int):
    rng = np.random.default_rng(5)
    return {"frames": torch.as_tensor(rng.standard_normal((B, frames, cfg.d_model))
                                      .astype(np.float32)),
            "tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))}


@functools.cache
def _one_device_serve(frames: int):
    """One device's prefill and ``NEW`` greedy decode steps: (logits a step,
    tokens, the final cache's leaves)."""
    cfg = _config()
    bundle = tbuild(cfg, flash_blk=8, device="cpu")
    params = bundle.init_params(2)
    with torch.inference_mode():
        logits, cache = bundle.prefill(params, _prompt(cfg, frames))
        cache = tserve._pad_cache_seq(cfg, cache, S, S + NEW)
        out, toks = [logits], [torch.argmax(logits, -1)]
        for i in range(NEW):
            logits, cache = bundle.decode_step(params, cache, toks[-1], S + i)
            out.append(logits)
            toks.append(torch.argmax(logits, -1))
    return out, toks, [t.clone() for t in flat_cache(cache)]


def _mesh_serve(shape, frames: int):
    """The same through ``MeshServe`` on the mesh, fed one device's tokens:
    (logits, the cache's ``Sharded`` leaves)."""
    cfg = _config()
    mesh = cpu_mesh(shape)
    bundle = tbuild(cfg, flash_blk=8, device="cpu")
    placed = ttrain.place_params(mesh, cfg, bundle.init_params(2))
    serve = tserve.MeshServe(bundle, mesh)
    assert serve.split
    _, ref_toks, _ = _one_device_serve(frames)
    logits, cache = serve.prefill(placed, _prompt(cfg, frames), S + NEW)
    out = [logits]
    for i in range(NEW):
        logits, cache = serve.decode_step(placed, cache, ref_toks[i], S + i)
        out.append(logits)
    return out, flat_cache(cache)


SERVE_CASES = [(s, 24) for s in SHAPES] + [((1, 8), 20)]


@pytest.mark.parametrize("shape,frames", SERVE_CASES,
                         ids=[f"{i}-T{t}" for i, (_, t) in zip(IDS + ["1x8"], SERVE_CASES)])
def test_split_serve_matches_one_device(shape, frames):
    """Prefill of 8 x 20 tokens over ``frames`` frames and 4 greedy decode
    steps into a self cache of 24 positions (flash blocks of 8): logits
    within 1e-4 of their scale and their tokens one device's, the cache
    (``k``, ``v``, ``xk``, ``xv``) within 1e-5 of its scale and in
    ``cache_pspecs``'s layout: by the 4 KV heads where `model` divides them,
    else by chunks of the positions (the self cache's 24, the cross
    cache's T = 24 frames on (1, 8)), else whole and equal on every device
    (T = 20 on (1, 8)); on (2, 4) two runs bit-equal."""
    cfg = _config()
    mesh = cpu_mesh(shape)
    axes = tpart.MeshAxes(mesh)
    ref, ref_toks, ref_cache = _one_device_serve(frames)
    got, cache = _mesh_serve(shape, frames)
    for step, (g, r) in enumerate(zip(got, ref, strict=True)):
        assert g.dtype == torch.float32 and g.shape == r.shape
        err = float((g - r).abs().max())
        assert err <= 1e-4 * max(1.0, float(r.abs().max())), (step, err)
        assert torch.equal(torch.argmax(g, -1), ref_toks[step])
    shape_tree = tbuild(cfg, device="meta").model.init_cache(B, S + NEW, enc_len=frames,
                                                             device="meta")
    specs = [p for _, p in tpart.leaves_with_path(tpart.cache_pspecs(shape_tree, cfg, axes))]
    model_dims = []
    for sh, ref_leaf, spec in zip(cache, ref_cache, specs, strict=True):
        assert tuple(sh.spec) == tuple(spec)
        want = tpart.ShardedShape(tuple(sh.shape), sh.dtype, spec, mesh).local_shape()
        assert all(tuple(t.shape) == want for _, t in sh.items())
        err = float((sh.gather("cpu") - ref_leaf).abs().max())
        assert err <= 1e-5 * max(1.0, float(ref_leaf.abs().max())), err
        blocks: dict = {}  # every device holding a block holds the same bits
        for idx, t in sh.items():
            assert torch.equal(t, blocks.setdefault(sh._block(idx), t))
        model_dims.append(tpart.leaf_axes(sh.spec, axes)[0])
    # k, v, xk, xv (L, B, S or T, KV, D): KV heads (3), positions (2) or whole (None)
    want_dims = {(4, 2): [3] * 4, (2, 4): [3] * 4, (8, 1): [3] * 4,
                 (1, 8): [2, 2] + ([2, 2] if frames % 8 == 0 else [None, None])}[shape]
    assert model_dims == want_dims
    if shape == (2, 4):
        got2, cache2 = _mesh_serve(shape, frames)
        assert all(torch.equal(a, b) for a, b in zip(got2, got, strict=True))
        for a, b in zip(cache2, cache, strict=True):
            assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a.items(), b.items()))


# -- against the JAX package on (2, 4) ---------------------------------------------------------


def test_split_step_matches_the_reference():
    """Two steps on a (2, 4) mesh against the JAX package's one-device step
    (B 4, 32 frames, 64 decoder tokens) from the JAX package's initial
    weights: losses within rtol 1e-5, parameters within 1e-3 in relative L2
    over the tree (the bounds of test_torch_mesh_split.py)."""
    jb, _, tb, _, tree = model_pair(NAME, "float32", seed=4, seeded=False, flash_blk=16)
    tcfg = tb.cfg
    get_batch = ttrain.batch_source(tcfg, 4, 32, seed=4)
    batches = [get_batch(i) for i in range(2)]
    opt_kw = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)
    ref_losses, ref_params = reference_steps(jb, tree, batches, opt_kw)
    mesh = cpu_mesh((2, 4))
    tb.model.shard_x = tpart.activation_sharder(mesh)
    opt = tadamw.AdamW(tadamw.AdamWConfig(**opt_kw))
    params = ttrain.place_params(mesh, tcfg, lm_params_from_numpy(tcfg, tree, device="cpu"))
    step = ttrain.make_train_step(tb, opt, mesh)
    assert step.split
    state = opt.init(params)
    losses = []
    for b in batches:
        batch = ttrain.place_batch(mesh, ttrain.on_device(b, CPU, torch.float32))
        params, state, _, m = step(params, state, None, batch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    got = flat(lm_tree_to_numpy(gather_tree(params, CPU)))
    assert global_rel(got, flat(ref_params)) < 1e-3


def test_split_serve_matches_the_reference():
    """``MeshServe`` on (2, 4) against the JAX package's one-device prefill
    and decode (``run_prefill_decode``: 24 frames and a prompt of 4 x 20
    tokens, one decode of token 7), weights from the JAX package's init:
    logits within 1e-4 of their scale and their greedy tokens equal, the
    prefill cache (self and cross) within 1e-5 of its scale (the bounds of
    test_torch_mesh_split_serve.py)."""
    jb, jp, tb, tp, _ = model_pair(NAME, "float32", seed=3, seeded=False, flash_blk=8)
    rng = np.random.default_rng(9)
    batch = {"frames": rng.standard_normal((4, 24, tb.cfg.d_model)).astype(np.float32),
             "tokens": rng.integers(0, tb.cfg.vocab_size, (4, 20)).astype(np.int32)}
    nxt = np.full(4, 7, np.int32)
    (_, jl), (_, jd), caches = run_prefill_decode(jb, jp, tb, tp, batch, nxt)
    mesh = cpu_mesh((2, 4))
    placed = ttrain.place_params(mesh, tb.cfg, tp)
    serve = tserve.MeshServe(tb, mesh)
    prompt = {k: torch.as_tensor(v) for k, v in batch.items()}
    logits, cache = serve.prefill(placed, prompt, 24)
    prefilled = [sh.gather("cpu").numpy() for sh in flat_cache(cache)]
    step, _ = serve.decode_step(placed, cache, torch.as_tensor(nxt), 20)
    for got, ref in ((logits, jl), (step, jd)):
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())
        assert np.array_equal(np.argmax(got.numpy(), -1), np.argmax(ref, -1))
    for got, (_, ref) in zip(prefilled, caches, strict=True):
        got = got[:, :, :ref.shape[2]]  # k/v: the prompt's positions of the grown cache
        assert np.abs(got - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


def test_split_where_model_does_not_divide_the_weights():
    """A (2, 3) mesh: `fit` keeps `model` on no weight (64 head columns, 128
    MLP columns and 512 vocabulary rows do not divide by 3), so every
    product takes each device's own rows and b1 is added whole; the
    encoder's 30 frames go 10 a device, the decoder's 64 tokens are not
    split between blocks (``FULL``), and 18 prompt tokens over 20 frames
    leave the cross cache (4 KV heads, 20 frames) whole on every device.
    The train step within the bounds above, and a teacher-forced prefill
    and two decode steps within 1e-4 of one device's logits' scale."""
    mesh = make_host_mesh(2, 3, devices=["cpu"] * 6)
    _check_step(mesh, frames=30)
    cfg = _config()
    bundle = tbuild(cfg, flash_blk=8, device="cpu")
    params = bundle.init_params(2)
    prompt = {"frames": _prompt(cfg, 20)["frames"][:6],
              "tokens": _prompt(cfg, 20)["tokens"][:6, :18]}
    nxt = torch.arange(6) + 3
    ref = tserve.teacher_forced(bundle, params, prompt, torch.stack([nxt, nxt], 1))
    got = tserve.teacher_forced(bundle, ttrain.place_params(mesh, cfg, params), prompt,
                                torch.stack([nxt, nxt], 1), mesh=mesh)
    assert float((got - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))
