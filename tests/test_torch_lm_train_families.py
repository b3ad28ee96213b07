"""The recurrent families' training path, the port against the JAX package
on the CPU (see test_torch_lm_train.py): zamba2 (Mamba-2 + the shared
block) and rwkv6 — their losses and gradients in float32 and bfloat16,
remat, zamba2's train steps from carried-across weights, their recorded
answers, and the SSD's masked exponent, which keeps the gradients finite
at chunk 128 where the reference's formula gives NaN.  Whisper's are in
test_torch_lm_train_whisper.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import rel_err
from _torch_lm_train import (
    check_fixture_equals_reference,
    check_loss_and_grads,
    check_port_replays_fixture,
    check_remat_bit_equal,
    check_train_steps,
)
from repro.models import mamba2 as jmamba2
from repro_torch.models import mamba2 as tmamba2

FAMILIES = ["zamba2-2.7b", "rwkv6-1.6b"]


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads(name):
    check_loss_and_grads(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_gives_bit_equal_gradients(name):
    check_remat_bit_equal(name)


@pytest.mark.parametrize("name", FAMILIES)
def test_train_fixture_equals_the_reference_and_the_port_replays_it(name):
    check_fixture_equals_reference(name)
    check_port_replays_fixture(name)


def test_train_steps_match_reference():
    check_train_steps("zamba2-2.7b")


def _ssd_inputs(seed: int = 0):
    """Decays that reach e^-204 over a 128-step chunk: dt = 0.1, A = -16."""
    rng = np.random.default_rng(seed)
    b, s, h, p, n = 1, 256, 2, 4, 8
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            np.full((b, s, h), 0.1, np.float32), np.full((h,), -16.0, np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32))


def _exp_then_mask(cs, tri):
    """The reference's formula: where(tri, exp(li), 0)."""
    li = cs[:, :, None, :] - cs[:, None, :, :]
    return torch.where(tri[None, :, :, None], torch.exp(li), 0.0)


def test_ssd_masked_exponent_keeps_the_forward_and_removes_the_nan(monkeypatch):
    """At chunk 128 exp(cs_i - cs_j) above the diagonal overflows: the
    reference's exp-then-mask gives NaN gradients (0 * inf) in both
    packages' formula; the port masks the exponent first, with the same
    forward bits and finite gradients, within 1e-4 of the gradients at
    chunk 32 (the same scan; e^51 does not overflow there)."""
    arrays = _ssd_inputs()

    def run(chunk):
        xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
        y, state = tmamba2._ssd_chunked(*xs, chunk)
        grads = torch.autograd.grad((y ** 2).sum() + state.sum(), xs)
        return y.detach(), state.detach(), grads

    y, state, grads = run(128)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with monkeypatch.context() as m:
        m.setattr(tmamba2, "_intra_decay", _exp_then_mask)
        y_old, state_old, grads_old = run(128)
        _, _, grads_32 = run(32)
    assert torch.equal(y, y_old) and torch.equal(state, state_old)
    assert not all(bool(torch.isfinite(g).all()) for g in grads_old)
    for g, g32 in zip(grads, grads_32):
        assert rel_err(g.numpy(), g32.numpy()) < 1e-4

    def ref(*xs):
        yy, ss = jmamba2._ssd_chunked(*xs, 128)
        return (yy ** 2).sum() + ss.sum()

    ref_grads = jax.grad(ref, argnums=tuple(range(5)))(*map(jnp.asarray, arrays))
    assert not all(bool(jnp.isfinite(g).all()) for g in ref_grads)  # the shared fault
    ref_y, _ = jmamba2._ssd_chunked(*map(jnp.asarray, arrays), 128)
    assert rel_err(y.numpy(), np.asarray(ref_y)) < 1e-5
