"""The split serve program on the CPU: prefill and decode of the transformer
family split over `model` (``launch.serve.MeshServe``, the caches laid out
by ``cache_pspecs``), on logical CPU shards (``make_host_mesh(...,
devices=["cpu"] * 8)``), no XLA flag.

  * every transformer smoke config on (4, 2), (2, 4), (1, 8) and (8, 1)
    against the port's one-device ``prefill`` and 4 greedy
    ``decode_step``s, in float32: logits within 1e-4 of their scale,
    greedy tokens equal, the gathered cache within 1e-5 of one device's,
    every cache shard of ``ShardedShape.local_shape``'s shape; the MoE
    configs at capacities where tokens drop (0.5 in prefill and decode),
    their drops one device's; two runs bit-equal on (2, 4); a final length
    `model` does not divide (the cache whole on every device);
  * whisper-tiny (the audio family, on the split program: its self and
    cross caches in ``cache_pspecs``'s layout) through
    ``teacher_forced(mesh=)`` against one device;
  * ``generate(mesh=)`` on (2, 4) against the JAX package's one-device
    prefill and decode (``run_prefill_decode``) for a dense GQA config,
    gemma3-1b (one KV head, windows, tied head) and deepseek-v3 (MLA, MoE);
  * the flash merge's helpers (``decode_opt.decode_partial`` and
    ``merge_partials``) with a window and a softcap against
    ``decode_attention``.

The program's dot FLOPs and its fullest device:
test_torch_mesh_split_program.py.
"""

import functools

import numpy as np
import pytest
import torch

from _torch_lm import flat_cache, model_pair, run_prefill_decode, smoke_pair
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import decode_opt
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.attention import decode_attention
from repro_torch.models.registry import build_model as tbuild
from repro_torch.sharding import partition as tpart

SHAPES = [(4, 2), (2, 4), (1, 8), (8, 1)]
IDS = ["4x2", "2x4", "1x8", "8x1"]
# every transformer config; the MoE ones at a capacity where tokens drop
CONFIGS = {
    "llama3.2-3b": {},
    "gemma3-1b": {},
    "phi3-mini-3.8b": {},
    "granite-20b": {},
    "llava-next-mistral-7b": {},
    "deepseek-v3-671b": {"capacity_factor": 0.5},
    "arctic-480b": {"capacity_factor": 0.5},
}
B, S, NEW = 8, 20, 4  # the cache's final length 24 (MLA widths 16 and 8 kept clear)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (as the split step's
    tests): many small ops on 8 logical shards."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def decode_capacity(monkeypatch):
    """A decode capacity where the MoE smoke configs drop tokens (at 4.0
    their top-2 of 8 experts never overflow)."""
    monkeypatch.setattr(ttransformer, "DECODE_CAPACITY_FACTOR", 0.5)


def cpu_mesh(shape):
    return make_host_mesh(*shape, devices=["cpu"] * 8)


def _config(name):
    return smoke_pair(name, dtype="float32", **CONFIGS[name])[1]


def _batch(cfg, s=S, b=B):
    rng = np.random.default_rng(5)
    if cfg.embeddings_input:
        return {"embeds": torch.as_tensor(rng.standard_normal((b, s, cfg.d_model))
                                          .astype(np.float32))}
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)))}


def _params(cfg):
    return tbuild(cfg, flash_blk=8, device="cpu").init_params(2)


@functools.cache
def _one_device(name, s=S, b=B):
    """The port's one-device prefill and ``NEW`` greedy decode steps:
    (logits a step, greedy tokens, the final cache's leaves, the dropped
    assignments of every MoE layer call in order)."""
    cfg = _config(name)
    bundle = tbuild(cfg, flash_blk=8, device="cpu")
    params = _params(cfg)
    drops, route = [], tmoe.route_logits

    def counted(*a, **kw):
        r = route(*a, **kw)
        drops.append(int((~r.keep).sum()))
        return r

    tmoe.route_logits = counted
    try:
        with torch.inference_mode():
            logits, cache = bundle.prefill(params, _batch(cfg, s, b))
            cache = tserve._pad_cache_seq(cfg, cache, s, s + NEW)
            out, toks = [logits], [torch.argmax(logits, -1)]
            for i in range(NEW):
                logits, cache = bundle.decode_step(params, cache, toks[-1], s + i)
                out.append(logits)
                toks.append(torch.argmax(logits, -1))
    finally:
        tmoe.route_logits = route
    return out, toks, [t.clone() for t in flat_cache(cache)], drops


def _on_mesh(name, shape, s=S, b=B):
    """The same on the mesh through ``MeshServe``, fed one device's greedy
    tokens: (logits, their tokens, the cache's ``Sharded`` leaves, drops)."""
    cfg = _config(name)
    mesh = cpu_mesh(shape)
    bundle = tbuild(cfg, flash_blk=8, device="cpu")
    params = ttrain.place_params(mesh, cfg, _params(cfg))
    serve = tserve.MeshServe(bundle, mesh)
    _, ref_toks, _, _ = _one_device(name, s, b)
    logits, cache = serve.prefill(params, _batch(cfg, s, b), s + NEW)
    out, drops = [logits], serve.drops()
    for i in range(NEW):
        logits, cache = serve.decode_step(params, cache, ref_toks[i], s + i)
        out.append(logits)
        drops += serve.drops()
    return out, [torch.argmax(t, -1) for t in out], flat_cache(cache), drops


def _check(name, shape, s=S, again=False, b=B):
    cfg = _config(name)
    ref, ref_toks, ref_cache, ref_drops = _one_device(name, s, b)
    got, toks, cache, drops = _on_mesh(name, shape, s, b)
    for step, (g, r) in enumerate(zip(got, ref, strict=True)):
        assert g.dtype == torch.float32 and g.shape == r.shape
        err = float((g - r).abs().max())
        assert err <= 1e-4 * max(1.0, float(r.abs().max())), (step, err)
    for t, r in zip(toks, ref_toks, strict=True):
        assert torch.equal(t, r)
    axes = tpart.MeshAxes(cpu_mesh(shape))
    shape_tree = tbuild(cfg, device="meta").cache_shape(b, s + NEW)
    specs = tpart.cache_pspecs(shape_tree, cfg, axes)
    for sh, ref_leaf, spec in zip(cache, ref_cache, [p for seg in specs for p in seg],
                                  strict=True):
        assert tuple(sh.spec) == tuple(spec)
        want = tpart.ShardedShape(tuple(sh.shape), sh.dtype, spec, cpu_mesh(shape)).local_shape()
        assert all(tuple(t.shape) == want for _, t in sh.items())
        err = float((sh.gather("cpu") - ref_leaf).abs().max())
        assert err <= 1e-5 * max(1.0, float(ref_leaf.abs().max())), err
    if cfg.is_moe:
        assert sum(ref_drops) > 0 and drops == ref_drops
    if again:
        got2, _, cache2, _ = _on_mesh(name, shape, s)
        assert all(torch.equal(a, b) for a, b in zip(got2, got, strict=True))
        for a, b in zip(cache2, cache, strict=True):
            assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a.items(), b.items()))
    return cache


@pytest.mark.usefixtures("decode_capacity")
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_split_serve_matches_one_device(name, shape):
    """Prefill of 8 x 20 and 4 greedy decode steps into a cache of 24
    positions (flash blocks of 8): logits within 1e-4 of their scale,
    tokens and MoE drops equal, the cache within 1e-5 of its scale and in
    ``cache_pspecs``'s layout (KV heads, sequence chunks or whole, as the
    shape gives); on (2, 4) two runs bit-equal."""
    _check(name, shape, again=shape == (2, 4))


@pytest.mark.usefixtures("decode_capacity")
@pytest.mark.parametrize("name", ["llama3.2-3b", "gemma3-1b", "deepseek-v3-671b"])
def test_split_serve_where_model_does_not_divide_the_length(name):
    """A prompt of 19 into a cache of 23 positions on (2, 4): `fit` drops
    `model` from the sequence, so the cache is whole on every device and
    the attention still runs once a group (each device its chunk of
    positions, merged); the prompt's activations are replicated."""
    cache = _check(name, (2, 4), s=19)
    assert all(tpart.leaf_axes(sh.spec, tpart.MeshAxes(cpu_mesh((2, 4))))[0] is None
               for sh in cache)


@pytest.mark.usefixtures("decode_capacity")
@pytest.mark.parametrize("name", ["gemma3-1b", "deepseek-v3-671b"])
def test_split_serve_where_the_batch_does_not_split_over_the_groups(name):
    """6 rows on (4, 2): `fit` drops the batch axes from the cache and the
    batch, so every data group computes the whole batch (an MoE layer
    routes it as one block: one device's drops)."""
    cache = _check(name, (4, 2), b=6)
    assert all(tpart.leaf_axes(sh.spec, tpart.MeshAxes(cpu_mesh((4, 2))))[1] is None
               for sh in cache)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)], ids=["2x4", "4x2"])
def test_whisper_serves_on_the_split_program(shape):
    """whisper-tiny (audio) on the split serve program (its encoder over the
    frames and its decoder over the tokens split over `model`, the self and
    cross caches in ``cache_pspecs``'s layout): ``teacher_forced(mesh=)``
    over a prompt of 1,500 / 8 frames and 6 tokens, then 4 decode steps fed
    one device's greedy tokens, gives one device's logits within 1e-4 of
    their scale and their tokens."""
    _, cfg = smoke_pair("whisper-tiny", dtype="float32")
    bundle = tbuild(cfg, device="cpu")
    params = bundle.init_params(4)
    rng = np.random.default_rng(6)
    batch = {"frames": torch.as_tensor(rng.standard_normal((4, 24, cfg.d_model))
                                       .astype(np.float32)),
             "tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 6)))}
    ref = tserve.teacher_forced(bundle, params, batch, torch.zeros((4, 5), dtype=torch.long))
    toks = torch.argmax(ref, -1).T  # one device's greedy tokens, fed back
    ref = tserve.teacher_forced(bundle, params, batch, toks)
    mesh = cpu_mesh(shape)
    assert tserve.MeshServe(bundle, mesh).split
    got = tserve.teacher_forced(bundle, ttrain.place_params(mesh, cfg, params), batch, toks,
                                mesh=mesh)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-4 * max(1.0, float(ref.abs().max()))
    assert torch.equal(torch.argmax(got, -1), torch.argmax(ref, -1))


@pytest.mark.parametrize("name", ["llama3.2-3b", "gemma3-1b", "deepseek-v3-671b"])
def test_split_serve_matches_the_reference(name):
    """``generate(mesh=)`` and ``MeshServe`` on (2, 4) against the JAX
    package's one-device prefill and decode (``run_prefill_decode``: a
    prompt of 4 x 28, the caches grown by 4, one decode of the prefill's
    token 7), weights from the JAX package's init: logits within 1e-4 of
    their scale and their greedy tokens equal (``generate``'s first), the
    prefill cache within 1e-5 of its scale."""
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
    step, _ = serve.decode_step(placed, cache, torch.as_tensor(nxt), 28)
    for got, ref in ((logits, jl), (step, jd)):
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())
        assert np.array_equal(np.argmax(got.numpy(), -1), np.argmax(ref, -1))
    for sh, (_, ref) in zip(flat_cache(cache), caches, strict=True):
        got = sh.gather("cpu").numpy()[:, :, :28]
        assert np.abs(got - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 3.0), (6, 2.5)])
def test_merge_helpers_with_window_and_softcap(window, softcap):
    """``decode_partial`` over 4 chunks of a 40-position cache and
    ``merge_partials`` against ``decode_attention`` with the same window and
    softcap (GQA: 8 heads on 2 KV heads), pos mid-cache: within 1e-5 of the
    scale; a chunk that holds no valid position adds nothing."""
    rng = np.random.default_rng(window + int(softcap * 10))
    q, k, v = (torch.as_tensor(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 1, 8, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    pos = 23
    ref = decode_attention(q, k, v, pos, window=window, logit_softcap=softcap)
    qq = q.reshape(2, 2, 4, 16) * 16 ** -0.5
    parts = [decode_opt.decode_partial(qq, k[:, a:a + 10], v[:, a:a + 10], pos, start=a,
                                       window=window, logit_softcap=softcap)
             for a in range(0, 40, 10)]
    out = decode_opt.merge_partials(parts).reshape(2, 1, 8, 16)
    assert float((out - ref).abs().max()) <= 1e-5 * max(1.0, float(ref.abs().max()))
