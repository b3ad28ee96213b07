"""The port's checkpoint module and checkpoint/restart runner.

``tests/test_checkpoint.py``'s six cases and the crash/resume and placer
cases of ``tests/test_ft.py`` on trees of torch tensors, then the format
against the JAX package's: the same leaf keys (``jax.tree_util.keystr``)
and a checkpoint written by either package restoring in the other, bit
for bit, bfloat16 leaves included.
"""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jckpt
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.ft.runtime import FaultTolerantRunner, InjectedFailure

Pair = collections.namedtuple("Pair", "w b")


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {
            "embed": torch.randn(16, 8, generator=g).to(torch.bfloat16),
            "attn": (torch.randn(8, 8, generator=g),),
        },
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _flat(tree):
    return [v for _, v in ckpt._leaves(tree)]


# -- tests/test_checkpoint.py on tensors ----------------------------------------------


def test_roundtrip_bitexact(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 7, tree)
    step, restored = restore_checkpoint(str(tmp_path), _tree(1))
    assert step == 7
    for a, b in zip(_flat(tree), _flat(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_step_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (10, 20, 30):
        mgr.save(s, _tree(s))
    mgr.wait()
    assert latest_step(str(tmp_path)) == 30
    files = sorted(os.listdir(tmp_path))
    assert "step_00000010.npz" not in files  # gc'd
    assert "step_00000020.npz" in files and "step_00000030.npz" in files


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    tree = _tree(1)
    mgr.save(1, tree)
    tree["params"]["attn"][0].add_(1.0)  # after save() returns: not in the checkpoint
    mgr.wait()
    assert latest_step(str(tmp_path)) == 1
    _, restored = restore_checkpoint(str(tmp_path), _tree())
    assert torch.equal(restored["params"]["attn"][0], _tree(1)["params"]["attn"][0])


def test_no_tmp_leftovers(tmp_path):
    save_checkpoint(str(tmp_path), 5, _tree())
    assert not [f for f in os.listdir(tmp_path) if f.startswith("tmp.")]


def test_restore_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    bad = _tree()
    bad["params"]["embed"] = torch.zeros((4, 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), bad)
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(str(tmp_path), {**_tree(), "extra": torch.zeros(2)})


def test_restore_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nope"), _tree())


# -- tests/test_ft.py's crash/resume and placer cases ----------------------------------


def _counter_step(state, step):
    new = {"x": state["x"] * 1.01 + step, "n": state["n"] + 1}
    return new, {"loss": float(new["x"].sum())}


def _init():
    return {"x": torch.ones(4, dtype=torch.float32), "n": torch.tensor(0, dtype=torch.int32)}


def test_crash_resume_identical_history(tmp_path):
    run = str(tmp_path / "run")
    with pytest.raises(InjectedFailure):
        FaultTolerantRunner(run, _counter_step, _init, ckpt_every=5).run(20, failure_at=12)
    # restart: resumes from the step 10 checkpoint, replays 10..19
    state2, hist2 = FaultTolerantRunner(run, _counter_step, _init, ckpt_every=5).run(20)
    assert hist2[0]["step"] == 10
    state_ref, hist_ref = FaultTolerantRunner(str(tmp_path / "ref"), _counter_step, _init,
                                              ckpt_every=5).run(20)
    assert torch.equal(state2["x"], state_ref["x"]) and torch.equal(state2["n"], state_ref["n"])
    ref_by_step = {h["step"]: h["loss"] for h in hist_ref}
    for h in hist2:
        assert h["loss"] == ref_by_step[h["step"]]


def test_elastic_placer_called_on_resume(tmp_path):
    run = str(tmp_path / "run")
    with pytest.raises(InjectedFailure):
        FaultTolerantRunner(run, _counter_step, _init, ckpt_every=2).run(10, failure_at=4)
    called = {}

    def placer(state):  # stands in for re-placing onto other devices
        called["yes"] = True
        return {k: v.clone() for k, v in state.items()}

    start, state = FaultTolerantRunner(run, _counter_step, _init,
                                       ckpt_every=2).resume_or_init(placer)
    assert start == 4 and called.get("yes")
    assert state["x"].dtype == torch.float32 and state["n"].dtype == torch.int32


# -- the format against the JAX package's ---------------------------------------------


def _both(seed=0):
    """One tree in both packages: numpy values, bfloat16 included, nested
    in dicts (unsorted keys), a list, a tuple, a namedtuple and a None."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(6, 5)).astype(np.float32)
    w, b = rng.normal(size=(3, 3)).astype(np.float32), np.arange(3, dtype=np.int32)
    layers = [rng.normal(size=(2,)).astype(np.float32), np.int32(4)]
    jtree = {"zeta": {"embed": jnp.asarray(emb, jnp.bfloat16), "pair": Pair(jnp.asarray(w), b)},
             "alpha": (layers, None), "step": jnp.int32(9)}
    ttree = {"zeta": {"embed": torch.from_numpy(emb).to(torch.bfloat16),
                      "pair": Pair(torch.from_numpy(w), torch.from_numpy(b))},
             "alpha": ([torch.from_numpy(layers[0]), torch.tensor(4, dtype=torch.int32)], None),
             "step": torch.tensor(9, dtype=torch.int32)}
    return jtree, ttree


def _jax_keys(tree):
    return [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_leaf_keys_are_jax_keystr():
    jtree, ttree = _both()
    keys = [k for k, _ in ckpt._leaves(ttree)]
    assert keys == _jax_keys(jtree)
    assert "['zeta']['pair'].w" in keys and "['alpha'][0][1]" in keys


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jtree, ttree = _both(1)
    jckpt.save_checkpoint(str(tmp_path), 3, jtree)
    step, restored = restore_checkpoint(str(tmp_path), _both(2)[1])
    assert step == 3
    for (k, got), (_, want) in zip(ckpt._leaves(restored), ckpt._leaves(ttree)):
        assert got.dtype == want.dtype and torch.equal(got, want), k


def test_port_checkpoint_restores_in_jax(tmp_path):
    jtree, ttree = _both(1)
    save_checkpoint(str(tmp_path), 4, ttree)
    template = jax.eval_shape(lambda: _both(2)[0])
    step, restored = jckpt.restore_checkpoint(str(tmp_path), template)
    assert step == 4
    got = jax.tree_util.tree_leaves(restored)
    want = jax.tree_util.tree_leaves(jtree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes()
