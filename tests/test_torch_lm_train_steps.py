"""The LM half's train step and trainer, the port against the JAX package
on the CPU (see test_torch_lm_train.py): ``make_train_step`` (plain,
microbatched, int8-compressed) from carried-across weights, the recorded
train steps of tests/fixtures/torch_lm/train.json, ``train()`` crashed and
resumed, checkpoints crossing between the packages both ways, a mesh
that is not the port's refused, and the command line (also on a mesh)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_lm import smoke_pair
from _torch_lm_train import (
    STEPS,
    fixture,
    flat,
    global_rel,
    port_steps,
    reference_step_losses,
    reference_steps,
    weights,
)
from repro.launch import train as jtrain
from repro.models.registry import build_model as jbuild
from repro_torch.data import TokenPipeline
from repro_torch.ft.runtime import InjectedFailure
from repro_torch.launch import train as ttrain
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim import adamw as tadamw

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kw", [{}, {"microbatch": 2}, {"compress": True}],
                         ids=["plain", "microbatch2", "compress"])
def test_train_step_matches_reference(kw):
    """Three steps from carried-across params: losses within 1e-5 of the JAX
    package's; the parameters within 1e-3 in relative L2 over the whole
    tree, and each leaf's update over the three steps within 1e-2 of the
    reference's in relative L2.  Not elementwise: Adam's eps = 1e-8 maps a
    gradient at float32 cancellation noise (|g| ~ 1e-9 where the leaf's
    largest is ~0.1) to an update up to ~0.4 lr away from the other
    package's, and int8 codes at a rounding boundary flip."""
    jcfg, tcfg = smoke_pair("llama3.2-3b", dtype="float32")
    tree = weights("llama3.2-3b", "float32", 4)
    pipe = TokenPipeline(tcfg.vocab_size, 4, 32, seed=4)
    batches = [pipe.batch(i) for i in range(3)]
    opt_kw = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=10)
    ref_losses, ref_params = reference_steps(jbuild(jcfg), tree, batches, opt_kw, **kw)
    losses, params = port_steps(tcfg, tree, batches, opt_kw, **kw)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    a, b, p0 = flat(params), flat(ref_params), flat(tree)
    assert global_rel(a, b) < 1e-3
    for k in b:
        moved = np.linalg.norm(b[k] - p0[k])
        assert moved > 0, k
        assert np.linalg.norm(a[k] - b[k]) / moved < 1e-2, k


TRAIN_KW = dict(global_batch=2, seq_len=32, ckpt_every=4, seed=3, log_every=100)


def test_train_crash_resume_equals_uninterrupted(tmp_path):
    """Crash after step 6, resume from the step-4 checkpoint: losses equal an
    uninterrupted run's (rtol 1e-6, as the JAX package's own test)."""
    _, cfg = smoke_pair("llama3.2-3b", dtype="float32", remat=False)
    with pytest.raises(InjectedFailure):
        ttrain.train(cfg, steps=10, run_dir=str(tmp_path / "a"), failure_at=6, device="cpu",
                     **TRAIN_KW)
    resumed = ttrain.train(cfg, steps=10, run_dir=str(tmp_path / "a"), device="cpu", **TRAIN_KW)
    whole = ttrain.train(cfg, steps=10, run_dir=str(tmp_path / "b"), device="cpu", **TRAIN_KW)
    ref = {h["step"]: h["loss"] for h in whole}
    assert [h["step"] for h in resumed] == list(range(4, 10))
    for h in resumed:
        np.testing.assert_allclose(h["loss"], ref[h["step"]], rtol=1e-6)
    assert all(np.isfinite(h["grad_norm"]) and h["lr"] > 0 for h in whole)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_between_packages(tmp_path, writer):
    """A run crashed after step 4 by one package resumes in the other: the
    losses of steps 4-9 within 1e-5 of the writer's uninterrupted run."""
    jcfg, tcfg = smoke_pair("llama3.2-3b", dtype="float32", remat=False)
    run = str(tmp_path / "run")
    jrun = lambda **kw: jtrain.train(jcfg, steps=10, **TRAIN_KW, **kw)  # noqa: E731
    trun = lambda **kw: ttrain.train(tcfg, steps=10, device="cpu", **TRAIN_KW, **kw)  # noqa: E731
    first, second = (jrun, trun) if writer == "reference" else (trun, jrun)
    with pytest.raises(Exception, match="injected crash"):
        first(run_dir=run, failure_at=4)
    resumed = second(run_dir=run)
    whole = {h["step"]: h["loss"] for h in first(run_dir=str(tmp_path / "whole"))}
    assert [h["step"] for h in resumed] == list(range(4, 10))
    for h in resumed:
        np.testing.assert_allclose(h["loss"], whole[h["step"]], rtol=1e-5)


def test_train_mesh_raises_naming_the_roadmap_item(tmp_path):
    """The mesh is ported (tests/test_torch_mesh_train.py): what is refused
    now is a mesh that is not the port's ``Mesh``, before anything is
    written."""
    _, cfg = smoke_pair("llama3.2-3b", dtype="float32")
    with pytest.raises(TypeError, match="repro_torch.launch.mesh.Mesh"):
        ttrain.train(cfg, steps=2, global_batch=2, seq_len=16, run_dir=str(tmp_path),
                     mesh=object(), device="cpu")
    bundle = tbuild(cfg, device="cpu")
    with pytest.raises(TypeError, match="repro_torch.launch.mesh.Mesh"):
        ttrain.make_train_step(bundle, tadamw.AdamW(tadamw.AdamWConfig()), mesh=object())
    assert not list(tmp_path.iterdir())


def test_train_command_line(tmp_path):
    """``python -m repro_torch.launch.train --scale 0.05 --steps 3 --device
    cpu``: three steps, a finite loss, the step-3 checkpoint written."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-3b",
           "--scale", "0.05", "--steps", "3", "--global-batch", "2", "--seq", "64",
           "--run-dir", str(tmp_path), "--device", "cpu"]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=str(ROOT), env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("done: 3 steps in "), out.stdout
    assert np.isfinite(float(last.rsplit("-> ", 1)[1]))
    assert (tmp_path / "ckpt" / "step_00000003.npz").exists()
    meshed = subprocess.run(cmd + ["--use-mesh", "--run-dir", str(tmp_path / "mesh")],
                            capture_output=True, text=True, cwd=str(ROOT), env=env, timeout=300)
    assert meshed.returncode == 0, meshed.stderr
    last = meshed.stdout.strip().splitlines()[-1]
    assert last.startswith("done: 3 steps in "), meshed.stdout
    assert (tmp_path / "mesh" / "ckpt" / "step_00000003.npz").exists()


def test_train_steps_fixture_equals_the_reference_and_the_port_replays_it():
    fx = fixture()["train_steps"]
    assert {k: v for k, v in fx.items() if k != "losses"} == STEPS
    np.testing.assert_allclose(reference_step_losses(), fx["losses"], rtol=1e-6)
    _, tcfg = smoke_pair(STEPS["config"], dtype="float32")
    pipe = TokenPipeline(tcfg.vocab_size, STEPS["global_batch"], STEPS["seq_len"],
                         seed=STEPS["seed"])
    losses, _ = port_steps(tcfg, weights(STEPS["config"], "float32", STEPS["seed"]),
                            [pipe.batch(i) for i in range(STEPS["n_steps"])], STEPS["opt"],
                            microbatch=STEPS["microbatch"], compress=STEPS["compress"])
    np.testing.assert_allclose(losses, fx["losses"], rtol=1e-5)
