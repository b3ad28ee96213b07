"""The LM mesh's train step on the CPU: logical CPU shards
(``make_host_mesh(..., devices=["cpu"] * 8)``), no XLA flag.

The port's mesh step on (4, 2) and (2, 4) against its one-device step
(every family's smoke config in float32, an MoE config where tokens
drop), against the JAX package's one-device step, ``place_params``'
shards, ``train(mesh=)`` crashed and resumed onto another mesh and onto
one device, and the microbatch refusal both packages share."""

import numpy as np
import pytest
import torch

from _torch_lm import smoke_pair
from _torch_lm_train import flat, global_rel, reference_steps, weights
from repro.models.registry import build_model as jbuild
from repro_torch.convert import lm_params_from_numpy, lm_tree_to_numpy
from repro_torch.data import TokenPipeline
from repro_torch.ft.runtime import InjectedFailure
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.common import leaf_tensors, tree_leaves
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim import adamw as tadamw
from repro_torch.sharding import partition as tpart
from repro_torch.sharding.placement import Sharded, gather_tree

CPU = torch.device("cpu")
SHAPES = [(4, 2), (2, 4)]
# every family's smoke config; the MoE ones at a capacity where tokens drop
CONFIGS = {
    "llama3.2-3b": {},
    "deepseek-v3-671b": {"capacity_factor": 0.5, "remat": True},
    "arctic-480b": {"capacity_factor": 0.5},
    "llava-next-mistral-7b": {},
    "zamba2-2.7b": {},
    "rwkv6-1.6b": {},
    "whisper-tiny": {},
}
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)


def cpu_mesh(shape):
    return make_host_mesh(*shape, devices=["cpu"] * 8)


def _steps(cfg, tree, batches, opt_kw, mesh=None, **kw):
    """The port's ``make_train_step`` on the CPU from the numpy weights
    ``tree``, one device or ``mesh``: (losses, final params as numpy)."""
    bundle = tbuild(cfg, flash_blk=16, device="cpu")
    opt = tadamw.AdamW(tadamw.AdamWConfig(**opt_kw))
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    if mesh is not None:
        bundle.model.shard_x = tpart.activation_sharder(mesh)
        params = ttrain.place_params(mesh, cfg, params)
    step = ttrain.make_train_step(bundle, opt, mesh, **kw)
    state = opt.init(params)
    residual = None  # the int8 compression starts from a zero residual
    losses = []
    for b in batches:
        batch = ttrain.on_device(b, CPU, torch.float32)
        if mesh is not None:
            batch = ttrain.place_batch(mesh, batch)
        params, state, residual, m = step(params, state, residual, batch)
        losses.append(float(m["loss"]))
    tree_out = gather_tree(params, CPU) if mesh is not None else params.jax_layout()
    return losses, lm_tree_to_numpy(tree_out)


def _close(got: dict, ref: dict, rtol: float) -> None:
    """Each leaf within ``rtol`` of its own scale (at least 1), as the JAX
    package's mesh tests bound their errors."""
    assert got.keys() == ref.keys()
    for k in ref:
        err = np.abs(got[k] - ref[k]).max()
        assert err <= rtol * max(1.0, np.abs(ref[k]).max()), (k, err)


@pytest.mark.parametrize("shape", SHAPES, ids=["4x2", "2x4"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mesh_step_matches_one_device(name, shape, monkeypatch):
    """Two steps on the mesh: losses within rtol 2e-4 of one device's (the
    bound the JAX package's own mesh test holds), every updated parameter
    within 2e-4 of its scale.  The MoE configs drop tokens: one device
    routes all of a batch's tokens at once, and so must the mesh."""
    _, cfg = smoke_pair(name, dtype="float32", **CONFIGS[name])
    tree = weights(name, "float32", 11)
    get_batch = ttrain.batch_source(cfg, 8, 32, seed=11)
    batches = [get_batch(i) for i in range(2)]
    route, drops = tmoe.route, []

    def counted(*a, **kw):
        r = route(*a, **kw)
        drops.append(int((~r.keep).sum()))
        return r

    monkeypatch.setattr(tmoe, "route", counted)
    ref_losses, ref = _steps(cfg, tree, batches, OPT)
    if cfg.is_moe:
        assert sum(drops) > 0
    losses, got = _steps(cfg, tree, batches, OPT, cpu_mesh(shape))
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-4)
    _close(flat(got), flat(ref), 2e-4)


@pytest.mark.parametrize("kw", [{}, {"microbatch": 2}, {"compress": True}],
                         ids=["plain", "microbatch2", "compress"])
def test_mesh_step_matches_the_reference(kw):
    """Three steps on a (2, 4) mesh against the JAX package's one-device
    step, on the inputs and within the bounds of the port's one-device test
    (test_torch_lm_train_steps.py): losses 1e-5, parameters 1e-3 in
    relative L2 over the tree, each leaf's update within 1e-2 of the
    reference's in relative L2."""
    jcfg, tcfg = smoke_pair("llama3.2-3b", dtype="float32")
    tree = weights("llama3.2-3b", "float32", 4)
    pipe = TokenPipeline(tcfg.vocab_size, 4, 32, seed=4)
    batches = [pipe.batch(i) for i in range(3)]
    opt_kw = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)
    ref_losses, ref_params = reference_steps(jbuild(jcfg), tree, batches, opt_kw, **kw)
    losses, params = _steps(tcfg, tree, batches, opt_kw, cpu_mesh((2, 4)), **kw)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    a, b, p0 = flat(params), flat(ref_params), flat(tree)
    assert global_rel(a, b) < 1e-3
    for k in b:
        moved = np.linalg.norm(b[k] - p0[k])
        assert moved > 0, k
        assert np.linalg.norm(a[k] - b[k]) / moved < 1e-2, k


@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (1, 8)], ids=["4x2", "2x2", "1x8"])
def test_place_params_shards_hold_their_slices(shape):
    """Each device's shard is its own tensor (no view of the whole) holding
    exactly the slice its spec gives; the bytes each device holds are the
    specs' reckoning (``attach``); the gather returns the whole."""
    n = shape[0] * shape[1]
    mesh = make_host_mesh(*shape, devices=["cpu"] * n)
    _, cfg = smoke_pair("deepseek-v3-671b", dtype="float32")
    params = tbuild(cfg, device="cpu").init_params(3)
    layout = params.jax_layout()
    placed = ttrain.place_params(mesh, cfg, params)
    specs = tpart.param_pspecs(layout, cfg, tpart.MeshAxes(mesh))
    held = np.zeros(n, np.int64)
    whole_ptrs = {t.untyped_storage().data_ptr() for _, leaf in tree_leaves(layout)
                  for t in leaf_tensors(leaf)}
    ptrs = set()
    for (_, leaf), (_, pl), (_, spec) in zip(tree_leaves(layout), tree_leaves(placed),
                                             tpart.leaves_with_path(specs)):
        for whole, sh in zip(leaf_tensors(leaf), leaf_tensors(pl)):
            assert isinstance(sh, Sharded)
            assert tuple(sh.spec) == tuple(spec)[len(spec) - whole.ndim:]  # past the stack
            for k, (idx, t) in enumerate(sh.items()):
                assert torch.equal(t, whole.detach()[sh.slices(idx)])
                assert tuple(t.shape) == sh.local_shape()
                ptr = t.untyped_storage().data_ptr()
                assert ptr not in whole_ptrs and ptr not in ptrs
                ptrs.add(ptr)
                held[k] += t.numel() * t.element_size()
            assert torch.equal(sh.gather(CPU), whole.detach())
    reckoned = sum(s.local_bytes() for _, s in
                   tpart.leaves_with_path(tpart.attach(mesh, layout, specs)))
    assert held.tolist() == [reckoned] * n


TRAIN_KW = dict(global_batch=4, seq_len=32, ckpt_every=4, seed=3, log_every=100)


@pytest.mark.parametrize("resume_on", ["2x2", "one device"])
def test_train_mesh_crash_resumes_onto_another_mesh(tmp_path, resume_on):
    """``train(mesh=(4, 2))`` crashed after step 6 resumes from its step-4
    checkpoint (whole tensors in the JAX layout) onto a (2, 2) mesh or one
    device: the losses of steps 4-9 within 1e-5 of the uninterrupted
    mesh run's."""
    _, cfg = smoke_pair("llama3.2-3b", dtype="float32", remat=False)
    mesh = cpu_mesh((4, 2))
    with pytest.raises(InjectedFailure):
        ttrain.train(cfg, steps=10, run_dir=str(tmp_path / "a"), failure_at=6, mesh=mesh,
                     **TRAIN_KW)
    where = ({"mesh": make_host_mesh(2, 2, devices=["cpu"] * 4)} if resume_on == "2x2"
             else {"device": "cpu"})
    resumed = ttrain.train(cfg, steps=10, run_dir=str(tmp_path / "a"), **where, **TRAIN_KW)
    whole = ttrain.train(cfg, steps=10, run_dir=str(tmp_path / "b"), mesh=mesh, **TRAIN_KW)
    ref = {h["step"]: h["loss"] for h in whole}
    assert [h["step"] for h in resumed] == list(range(4, 10))
    for h in resumed:
        np.testing.assert_allclose(h["loss"], ref[h["step"]], rtol=1e-5)


def test_train_mesh_equals_one_device_and_runs_twice_equal(tmp_path):
    """``train(mesh=)`` and ``train(device="cpu")``: losses within 2e-4
    over 4 steps; two mesh runs bit-equal."""
    _, cfg = smoke_pair("deepseek-v3-671b", dtype="float32", capacity_factor=0.5)
    kw = dict(steps=4, global_batch=4, seq_len=32, seed=2, log_every=100)
    one = ttrain.train(cfg, run_dir=str(tmp_path / "one"), device="cpu", **kw)
    mesh = [ttrain.train(cfg, run_dir=str(tmp_path / f"m{i}"), mesh=cpu_mesh((2, 4)), **kw)
            for i in range(2)]
    np.testing.assert_allclose([h["loss"] for h in mesh[0]], [h["loss"] for h in one],
                               rtol=2e-4)
    assert [h["loss"] for h in mesh[0]] == [h["loss"] for h in mesh[1]]


def test_microbatch_that_does_not_divide_is_refused_by_both_packages():
    """A global batch of 5 in 2 microbatches: the reference's reshape
    raises, and the port raises ``ValueError`` (one device and a mesh);
    a batch of 4 gives both packages the same loss."""
    jcfg, tcfg = smoke_pair("llama3.2-3b", dtype="float32")
    tree = weights("llama3.2-3b", "float32", 1)
    opt_kw = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
    five = [TokenPipeline(tcfg.vocab_size, 5, 16, seed=1).batch(0)]
    with pytest.raises(TypeError, match="reshape"):
        reference_steps(jbuild(jcfg), tree, five, opt_kw, microbatch=2)
    with pytest.raises(ValueError, match="does not split into 2 microbatches"):
        _steps(tcfg, tree, five, opt_kw, microbatch=2)
    with pytest.raises(ValueError, match="does not split into 2 microbatches"):
        _steps(tcfg, tree, five, opt_kw, cpu_mesh((1, 8)), microbatch=2)
    four = [TokenPipeline(tcfg.vocab_size, 4, 16, seed=1).batch(0)]
    ref, _ = reference_steps(jbuild(jcfg), tree, four, opt_kw, microbatch=2)
    got, _ = _steps(tcfg, tree, four, opt_kw, microbatch=2)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
