"""Helpers shared by the LM training differential tests
(``test_torch_lm_train*.py``): seeded batches, and one loss + gradient
evaluation of each package on the same seeded weights, memoised per
process (``--dist loadfile`` keeps a file's tests in one worker)."""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_lm import jax_params_from_numpy, jax_to_numpy, smoke_pair
from _torch_lm_batch import B, S, lm_batch  # noqa: F401 (B, S: the fixture's batch)
from repro.launch import train as jtrain
from repro.models.registry import build_model as jbuild
from repro.optim import adamw as jadamw
from repro_torch.convert import (
    lm_params_from_numpy,
    lm_params_to_numpy,
    lm_tree_to_numpy,
    seeded_numpy_params,
)
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as ttrain
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim import adamw as tadamw

FLASH_BLK = 16
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "torch_lm" / "train.json"
FIXTURE_CONFIGS = ["llama3.2-3b", "deepseek-v3-671b", "zamba2-2.7b", "rwkv6-1.6b", "whisper-tiny"]
FIXTURE_SEED = 0  # check_loss_and_grads' seed: one reference run serves both
# the recorded train steps: llama3.2-3b, microbatch 2 and int8 compression
STEPS = dict(config="llama3.2-3b", seed=5, global_batch=4, seq_len=32, microbatch=2,
             compress=True, n_steps=3,
             opt=dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10, clip_norm=0.5))


def flat(tree, path: str = "") -> dict:
    """A numpy tree (nested dicts) as {'/'-joined path: float64 array}."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in flat(tree[key], f"{path}/{key}").items()}
    return {path: np.asarray(tree, np.float64)}


def global_rel(got: dict, ref: dict) -> float:
    """||got - ref||_2 / ||ref||_2 over every leaf at once."""
    num = sum(float(np.sum((got[k] - ref[k]) ** 2)) for k in ref)
    return float(np.sqrt(num / sum(float(np.sum(ref[k] ** 2)) for k in ref)))


def weights(name: str, dtype: str, seed: int) -> dict:
    """``seeded_numpy_params`` of ``name``'s smoke config in ``dtype``."""
    return seeded_numpy_params(smoke_pair(name, dtype=dtype)[1], seed)


@functools.cache
def _reference_model(name: str, dtype: str):
    """The JAX package's bundle of ``name``'s smoke config in ``dtype`` and
    its jitted loss-and-gradient function (compiled once a process)."""
    jb = jbuild(smoke_pair(name, dtype=dtype)[0], flash_blk=FLASH_BLK)
    return jb, jax.jit(jax.value_and_grad(jb.loss_fn, has_aux=True))


@functools.cache
def reference_grads(name: str, dtype: str, seed: int, run_dtype: str | None = None):
    """The JAX package's (loss, metrics, flat grads, global grad norm) of
    ``name``'s smoke config on the weights drawn for ``dtype`` from
    ``seed``, run in ``run_dtype`` (default ``dtype``; float32 on bfloat16
    weights is the float32 truth those weights have), on ``lm_batch(seed)``."""
    run_dtype = run_dtype or dtype
    jb, loss_and_grads = _reference_model(name, run_dtype)
    jp = jax_params_from_numpy(jb, weights(name, dtype, seed))
    jdt = jnp.bfloat16 if run_dtype == "bfloat16" else jnp.float32
    batch = {k: jnp.asarray(v) if v.dtype.kind == "i" else jnp.asarray(v, jdt)
             for k, v in lm_batch(jb.cfg, seed).items()}
    (loss, metrics), grads = loss_and_grads(jp, batch)
    gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                         for g in jax.tree.leaves(grads)))
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            flat(jax_to_numpy(grads)), float(gnorm))


def port_grads(name: str, dtype: str, seed: int, **replace):
    """The port's (loss, metrics, flat grads, global grad norm) on the CPU,
    as ``reference_grads``; ``replace`` changes the smoke config."""
    _, tcfg = smoke_pair(name, dtype=dtype, **replace)
    tb = tbuild(tcfg, flash_blk=FLASH_BLK, device="cpu")
    tp = lm_params_from_numpy(tcfg, weights(name, dtype, seed), device="cpu")
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    batch = {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v).to(tdt)
             for k, v in lm_batch(tcfg, seed).items()}
    loss, metrics, grads = ttrain.loss_and_grads(tb, tp, batch)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            flat(lm_tree_to_numpy(grads)), float(tadamw.global_norm(grads)))


def check_loss_and_grads(name: str, seed: int = 0) -> None:
    """float32: the port's loss within 1e-5 relative of the reference's (each
    metric too) and every gradient leaf within max|d|/max|ref| < 1e-4.
    bfloat16: the loss within 1e-2 relative, and the port's gradients no
    farther from the float32 gradients of the same weights than 2.5x the
    reference's own bfloat16 gradients are (global relative L2): the two
    packages round bfloat16 at different places, so their gradients
    differ by about the bfloat16 error itself, more where the MoE
    router's top-k flips (tests/_torch_lm_train_report.py prints the
    distances)."""
    ref_loss, ref_m, ref_g, ref_norm = reference_grads(name, "float32", seed)
    loss, m, g, norm = port_grads(name, "float32", seed)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss), (loss, ref_loss)
    assert set(m) == set(ref_m)
    for k in m:
        assert abs(m[k] - ref_m[k]) <= 1e-5 * max(abs(ref_m[k]), 1e-3), (k, m[k], ref_m[k])
    assert set(g) == set(ref_g)
    for k in ref_g:
        scale = np.abs(ref_g[k]).max()
        err = np.abs(g[k] - ref_g[k]).max() / scale if scale > 0 else np.abs(g[k]).max()
        assert err < 1e-4, (k, err)
    assert abs(norm - ref_norm) <= 1e-5 * ref_norm, (norm, ref_norm)

    truth = reference_grads(name, "bfloat16", seed, "float32")[2]
    ref_loss, _, ref_g, _ = reference_grads(name, "bfloat16", seed)
    loss, _, g, _ = port_grads(name, "bfloat16", seed)
    assert abs(loss - ref_loss) <= 1e-2 * abs(ref_loss), (loss, ref_loss)
    port_err, ref_err = global_rel(g, truth), global_rel(ref_g, truth)
    assert port_err <= 2.5 * ref_err, (port_err, ref_err)


def check_remat_bit_equal(name: str) -> None:
    """``cfg.remat`` recomputes each layer in the backward pass: the loss and
    every gradient bit-equal to the run that keeps the activations."""
    on = port_grads(name, "float32", 3, remat=True)
    off = port_grads(name, "float32", 3, remat=False)
    assert on[0] == off[0] and on[1] == off[1]
    assert all(np.array_equal(on[2][k], off[2][k]) for k in off[2])


# -- the reference's recorded answers (tests/fixtures/torch_lm/train.json) ------------------


def answers(name: str) -> dict:
    """The JAX package's float32 loss, metrics and gradient norm of the
    fixture's run of ``name``."""
    loss, metrics, _, gnorm = reference_grads(name, "float32", FIXTURE_SEED)
    return {"loss": loss, "metrics": metrics, "grad_norm": gnorm}


def fixture() -> dict:
    return json.loads(FIXTURE.read_text())


def check_fixture_equals_reference(name: str) -> None:
    fx = fixture()["configs"][name]
    ans = answers(name)
    assert fx["metrics"].keys() == ans["metrics"].keys()
    for k, v in [("loss", ans["loss"]), ("grad_norm", ans["grad_norm"]),
                 *ans["metrics"].items()]:
        want = fx[k] if k in ("loss", "grad_norm") else fx["metrics"][k]
        assert abs(v - want) <= 1e-6 * max(abs(want), 1e-3), (k, v, want)


def check_port_replays_fixture(name: str) -> None:
    """The port on the CPU: loss, metrics and gradient norm within 1e-5."""
    fx = fixture()["configs"][name]
    loss, metrics, _, gnorm = port_grads(name, "float32", FIXTURE_SEED)
    assert abs(loss / fx["loss"] - 1) < 1e-5
    assert abs(gnorm / fx["grad_norm"] - 1) < 1e-5
    assert metrics.keys() == fx["metrics"].keys()
    for k, v in metrics.items():
        assert abs(v - fx["metrics"][k]) <= 1e-5 * max(abs(fx["metrics"][k]), 1e-3), k


def reference_steps(jb, tree, batches, opt_kw, **kw):
    """The JAX package's ``make_train_step`` over ``batches`` from the numpy
    weights ``tree``: (losses, final params as numpy)."""
    opt = jadamw.AdamW(jadamw.AdamWConfig(**opt_kw))
    step = jtrain.make_train_step(jb, opt, **kw)
    params = jax_params_from_numpy(jb, tree)
    state = opt.init(params)
    residual = (jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
                if kw.get("compress") else {"none": jnp.zeros(())})
    losses = []
    for b in batches:
        params, state, residual, m = step(params, state, residual,
                                          {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return losses, jax_to_numpy(params)


def port_steps(cfg, tree, batches, opt_kw, **kw):
    """The port's ``make_train_step`` on the CPU, as ``reference_steps``."""
    bundle = tbuild(cfg, device="cpu")
    opt = tadamw.AdamW(tadamw.AdamWConfig(**opt_kw))
    step = ttrain.make_train_step(bundle, opt, **kw)
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    state = opt.init(params)
    residual = None  # compress_tree starts from a zero residual
    losses = []
    for b in batches:
        params, state, residual, m = step(params, state, residual,
                                          ttrain.on_device(b, "cpu", torch.float32))
        losses.append(float(m["loss"]))
    return losses, lm_params_to_numpy(params)


def reference_step_losses() -> list[float]:
    """The JAX package's losses over STEPS' train steps."""
    jcfg, tcfg = smoke_pair(STEPS["config"], dtype="float32")
    pipe = TokenPipeline(tcfg.vocab_size, STEPS["global_batch"], STEPS["seq_len"],
                         seed=STEPS["seed"])
    batches = [pipe.batch(i) for i in range(STEPS["n_steps"])]
    losses, _ = reference_steps(jbuild(jcfg), weights(STEPS["config"], "float32", STEPS["seed"]),
                                 batches, STEPS["opt"], microbatch=STEPS["microbatch"],
                                 compress=STEPS["compress"])
    return losses


def check_train_steps(name: str) -> None:
    """Two train steps from carried-across float32 weights on the trainer's
    own batches: losses and gradient norms within 1e-5."""
    jcfg, tcfg = smoke_pair(name, dtype="float32")
    tree = weights(name, "float32", 6)
    get_batch = ttrain.batch_source(tcfg, 2, 32, seed=6)
    batches = [get_batch(i) for i in range(2)]
    opt_kw = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)

    jb = jbuild(jcfg, flash_blk=16)
    jopt = jadamw.AdamW(jadamw.AdamWConfig(**opt_kw))
    jstep = jtrain.make_train_step(jb, jopt)
    jp = jax_params_from_numpy(jb, tree)
    js, jres = jopt.init(jp), {"none": jnp.zeros(())}
    bundle = tbuild(tcfg, flash_blk=16, device="cpu")
    topt = tadamw.AdamW(tadamw.AdamWConfig(**opt_kw))
    tstep = ttrain.make_train_step(bundle, topt)
    tp = lm_params_from_numpy(tcfg, tree, device="cpu")
    ts = topt.init(tp)
    for b in batches:
        jp, js, jres, jm = jstep(jp, js, jres, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, _, tm = tstep(tp, ts, None, ttrain.on_device(b, "cpu", torch.float32))
        assert abs(float(tm["loss"]) / float(jm["loss"]) - 1) < 1e-5
        assert abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1) < 1e-5
