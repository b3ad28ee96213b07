"""The port's whisper encoder-decoder (``models/encdec.py``) against the JAX
package's, on the CPU, at the smoke config with T = 40 frames and S = 24
decoder tokens (T != S).

  * ``sinusoid_positions`` bit-equal (numpy in both);
  * ``sinusoid_at`` within 2e-6 of the reference's eager function and, of
    its jitted one, within that function's own distance from its eager
    form plus 2e-6.  Bit-equality is out of reach: the port computes the
    same float32 formula with torch's pow/sin/cos, whose last bits differ
    from XLA's (~5% of the values by an ulp), and the jitted reference
    differs from its eager self by up to 3.1e-5 at positions below 448;
  * ``EncDecLM.encode``, prefill (caches included) and one decode step
    within max|Δ| / max|ref| < 1e-4 in float32 and < 2e-2 in bfloat16;
  * the params round trip bit-equal in both dtypes, the seeded weights
    taken by both packages, and decode against the port's own forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_lm import (
    jax_params_from_numpy,
    jax_to_numpy,
    leaves_equal,
    model_pair,
    rel_err,
    run_prefill_decode,
    smoke_pair,
)

from repro.models import encdec as jencdec
from repro.models.registry import build_model as jbuild
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy, seeded_numpy_params
from repro_torch.launch import serve as tserve
from repro_torch.models import encdec as tencdec
from repro_torch.models.registry import build_model as tbuild

NAME = "whisper-tiny"
B, T, S = 2, 40, 24
CONTEXT = 448  # whisper's decoder context


def _batch(cfg, seed=10, s=S):
    rng = np.random.default_rng(seed)
    return ({"frames": rng.standard_normal((B, T, cfg.d_model)).astype(np.float32),
             "tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)},
            rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32))


@pytest.mark.parametrize("length,dim", [(40, 64), (1500, 384), (448, 384)])
def test_sinusoid_positions_bit_equal(length, dim):
    got, ref = tencdec.sinusoid_positions(length, dim), jencdec.sinusoid_positions(length, dim)
    assert got.dtype == ref.dtype == np.float32
    assert got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("dim", [64, 384])
def test_sinusoid_at(dim):
    pos = range(0, CONTEXT, 3)
    got = np.stack([tencdec.sinusoid_at(p, dim).numpy() for p in pos])
    eager = np.stack([np.asarray(jencdec.sinusoid_at(jnp.int32(p), dim)) for p in pos])
    at = jax.jit(jencdec.sinusoid_at, static_argnums=1)
    jitted = np.stack([np.asarray(at(jnp.int32(p), dim)) for p in pos])
    assert got.dtype == np.float32 and got.shape == eager.shape
    assert np.abs(got - eager).max() <= 2e-6
    assert np.abs(got - jitted).max() <= np.abs(jitted - eager).max() + 2e-6


def test_encode():
    jb, jp, tb, tp, _ = model_pair(NAME, "float32", seed=1)
    frames = _batch(tb.cfg)[0]["frames"]
    got = tb.model.encode(tp, torch.from_numpy(frames))
    ref = jax.jit(jb.model.encode)(jp, frames)
    assert got.shape == (B, T, tb.cfg.d_model)
    assert rel_err(got.detach().numpy(), ref) < 1e-4, rel_err(got.detach().numpy(), ref)


@pytest.mark.parametrize("seeded", [True, False])
def test_prefill_and_decode_match_float32(seeded):
    """Logits and the four cache leaves (k, v (L, B, S, ...), xk, xv (L, B,
    T, ...)) within 1e-4 of their largest."""
    jb, jp, tb, tp, _ = model_pair(NAME, "float32", seed=1, seeded=seeded)
    batch, nxt = _batch(tb.cfg)
    (tl, jl), (td, jd), caches = run_prefill_decode(jb, jp, tb, tp, batch, nxt)
    assert tl.shape == (B, tb.cfg.vocab_size) and np.isfinite(tl).all()
    assert rel_err(tl, jl) < 1e-4, rel_err(tl, jl)
    assert rel_err(td, jd) < 1e-4, rel_err(td, jd)
    assert [t.shape[2] for t, _ in caches] == [S, S, T, T]  # k, v, xk, xv
    for t, j in caches:
        assert t.shape == j.shape and rel_err(t, j) < 1e-4


def test_prefill_and_decode_match_bfloat16():
    jb, jp, tb, tp, _ = model_pair(NAME, "bfloat16", seed=2)
    batch, nxt = _batch(tb.cfg)
    (tl, jl), (td, jd), _ = run_prefill_decode(jb, jp, tb, tp, batch, nxt)
    assert rel_err(tl, jl) < 2e-2, rel_err(tl, jl)
    assert rel_err(td, jd) < 2e-2, rel_err(td, jd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_bit_equal(dtype):
    *_, tp, tree = model_pair(NAME, dtype, seed=3, seeded=False)
    back = lm_params_to_numpy(tp)
    assert leaves_equal(back, tree)
    assert set(back["enc"]) == {"ln1", "attn", "ln2", "mlp"}
    assert set(back["dec"]) == {"ln1", "attn", "ln2", "mlp", "ln_x", "xattn"}
    assert back["dec"]["xattn"]["wq"].shape[0] == 2 and "lm_head" not in back


def test_seeded_params_carry_into_both_packages():
    jcfg, tcfg = smoke_pair(NAME, dtype="bfloat16")
    tree = seeded_numpy_params(tcfg, 5)
    jp = jax_params_from_numpy(jbuild(jcfg), tree)
    assert leaves_equal(jax_to_numpy(jp), tree)
    assert leaves_equal(lm_params_to_numpy(lm_params_from_numpy(tcfg, tree, device="cpu")), tree)


def test_decode_equals_the_forward():
    """Teacher-forced greedy decode of 8 tokens after a 24-token prompt,
    then a prefill over prompt + generated[:-1]: its last logits match the
    last decode step's, and its argmax is the last greedy token."""
    _, tcfg = smoke_pair(NAME, dtype="float32")
    tb = tbuild(tcfg, device="cpu")
    tp = lm_params_from_numpy(tcfg, seeded_numpy_params(tcfg, 4), device="cpu")
    batch, _ = _batch(tcfg, seed=11)
    toks = np.zeros((B, 0), np.int64)
    for _ in range(8):  # greedy: each step's argmax fed back
        steps = tserve.teacher_forced(tb, tp, batch, np.concatenate([toks, toks[:, :1]], 1))
        toks = np.concatenate([toks, steps[-1].argmax(-1).numpy()[:, None]], 1)
    steps = tserve.teacher_forced(tb, tp, batch, toks)
    np.testing.assert_array_equal(steps.argmax(-1).T.numpy(), toks)
    full = {"frames": batch["frames"], "tokens": np.concatenate([batch["tokens"], toks[:, :-1]], 1)}
    logits, _ = tb.prefill(tp, {k: torch.from_numpy(v) for k, v in full.items()})
    assert rel_err(steps[-1].numpy(), logits.numpy()) < 1e-4
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), toks[:, -1])
