"""The split mesh step on the CPU: the transformer family's train step
split over `model` (``repro_torch.sharding.split``), on logical CPU shards
(``make_host_mesh(..., devices=["cpu"] * 8)``), no XLA flag.

  * every transformer smoke config on (4, 2), (2, 4), (1, 8) and (8, 1)
    against the port's one-device step, in float32: losses within rtol
    2e-4, every parameter within 2e-4 of its scale (the bounds of
    test_torch_mesh_train.py); the MoE configs at capacity factor 0.5
    drop tokens, and the mesh's drops equal one device's; two runs
    bit-equal; a sequence `model` does not divide (activations
    replicated, uneven query chunks);
  * the whole slice against the JAX package's one-device step on (2, 4)
    (a dense GQA config, gemma3's single KV head, tied head, windows and
    post-norms, and deepseek-v3's MLA, MoE and MTP).

The program's parts (collectives, gathers, specs, FLOPs):
test_torch_mesh_split_program.py.
"""

import functools

import numpy as np
import pytest
import torch

from _torch_lm import smoke_pair
from _torch_lm_train import flat, global_rel, reference_steps, weights
from repro.models.registry import build_model as jbuild
from repro_torch.convert import lm_params_from_numpy, lm_tree_to_numpy
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim import adamw as tadamw
from repro_torch.sharding import partition as tpart
from repro_torch.sharding.placement import gather_tree

CPU = torch.device("cpu")
SHAPES = [(4, 2), (2, 4), (1, 8), (8, 1)]
IDS = ["4x2", "2x4", "1x8", "8x1"]
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


def _batches(cfg, seq):
    get_batch = ttrain.batch_source(cfg, 8, seq, seed=11)
    return [get_batch(i) for i in range(2)]


def _steps(cfg, batches, mesh=None):
    """Two steps of the port's ``make_train_step`` from ``weights(11)``, one
    device or ``mesh``: (losses, final params as numpy, the first step's
    dropped assignments a MoE layer)."""
    bundle = tbuild(cfg, flash_blk=16, device="cpu")
    opt = tadamw.AdamW(tadamw.AdamWConfig(**OPT))
    params = lm_params_from_numpy(cfg, weights(cfg.name, "float32", 11), device="cpu")
    drops = None
    if mesh is None and cfg.is_moe:
        seen, route = [], tmoe.route_logits

        def counted(*a, **kw):
            r = route(*a, **kw)
            seen.append(int((~r.keep).sum()))
            return r

        tmoe.route_logits = counted
        try:
            with torch.no_grad():
                bundle.loss_fn(params, ttrain.on_device(batches[0], CPU, torch.float32))
        finally:
            tmoe.route_logits = route
        drops = seen
    if mesh is not None:
        bundle.model.shard_x = tpart.activation_sharder(mesh)
        params = ttrain.place_params(mesh, cfg, params)
    step = ttrain.make_train_step(bundle, opt, mesh)
    state = opt.init(params)
    losses = []
    for i, b in enumerate(batches):
        batch = ttrain.on_device(b, CPU, torch.float32)
        if mesh is not None:
            batch = ttrain.place_batch(mesh, batch)
        params, state, _, m = step(params, state, None, batch)
        losses.append(float(m["loss"]))
        if i == 0 and mesh is not None and cfg.is_moe:
            by_layer: dict = {}
            for (_, key), n in step.routing.dropped.items():
                by_layer[key] = by_layer.get(key, 0) + int(n)
            drops = [by_layer[k] for k in sorted(by_layer)]
    tree = gather_tree(params, CPU) if mesh is not None else params.jax_layout()
    return losses, flat(lm_tree_to_numpy(tree)), drops


@functools.cache
def _one_device(name, seq):
    cfg = _config(name)
    return _steps(cfg, _batches(cfg, seq))


def _close(got: dict, ref: dict, rtol: float) -> None:
    """Each leaf within ``rtol`` of its own scale (at least 1)."""
    assert got.keys() == ref.keys()
    for k in ref:
        err = np.abs(got[k] - ref[k]).max()
        assert err <= rtol * max(1.0, np.abs(ref[k]).max()), (k, err)


def _check_against_one_device(name, shape, seq, again: bool):
    cfg = _config(name)
    ref_losses, ref, ref_drops = _one_device(name, seq)
    losses, got, drops = _steps(cfg, _batches(cfg, seq), cpu_mesh(shape))
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-4)
    _close(got, ref, 2e-4)
    if cfg.is_moe:
        assert sum(ref_drops) > 0
        assert drops == ref_drops
    if again:
        losses2, got2, _ = _steps(cfg, _batches(cfg, seq), cpu_mesh(shape))
        assert losses2 == losses
        for k in got:
            assert np.array_equal(got2[k], got[k]), k


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_split_step_matches_one_device(name, shape):
    """Two steps on the mesh, B 8 x S 32 (flash blocks of 16): losses
    within rtol 2e-4 of one device's, every updated parameter within 2e-4
    of its scale, the MoE drops one device's; on (2, 4) two runs are
    bit-equal."""
    _check_against_one_device(name, shape, 32, again=shape == (2, 4))


@pytest.mark.parametrize("name", ["llama3.2-3b", "gemma3-1b", "deepseek-v3-671b"])
def test_split_step_where_model_does_not_divide_the_sequence(name):
    """S 30 on (2, 4): activations stay replicated between blocks (as
    ``ActivationSharder.spec`` says), the query chunks are 8, 8, 7, 7 rows
    of the whole attention; the bounds of the test above."""
    _check_against_one_device(name, (2, 4), 30, again=False)


@pytest.mark.parametrize("name", ["llama3.2-3b", "gemma3-1b", "deepseek-v3-671b"])
def test_split_step_matches_the_reference(name):
    """Two steps on a (2, 4) mesh against the JAX package's one-device step
    at each config's smoke size (MoE at its default capacity): losses
    within rtol 1e-5, parameters within 1e-3 in relative L2 over the
    tree (the bounds of test_torch_mesh_train.py's reference test)."""
    jcfg, tcfg = smoke_pair(name, dtype="float32")
    tree = weights(name, "float32", 4)
    if tcfg.embeddings_input:
        get = ttrain.batch_source(tcfg, 4, 32, seed=4)
        batches = [get(i) for i in range(2)]
    else:
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
