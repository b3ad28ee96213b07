"""The port's recurrent LM families against the JAX package's, on the CPU:
Mamba-2 and the zamba2 hybrid (``models/mamba2.py``, ``models/hybrid.py``)
and RWKV-6 (``models/rwkv6.py``, ``models/rwkv_model.py``).

The same weights (``repro_torch.convert.seeded_numpy_params`` at the smoke
configs, or the JAX package's ``init_params`` carried across with
``lm_params_from_numpy``) and numpy-seeded inputs go through both:
  * the layers in float32 within rtol = atol = 2e-5: ``_causal_conv``,
    ``_ssd_chunked`` (S a multiple of the chunk, S = 20 with chunk 16 ->
    the largest divisor 10, with and without ``h0``), ``mamba2_forward``
    and ``mamba2_decode``; ``_decay`` at its cap, ``_wkv_scan`` and
    ``_wkv_chunked`` (each against the reference and against each other),
    ``rwkv6_time_mix``/``channel_mix`` with and without state,
    ``_group_norm``;
  * whole-model prefill (caches included) and one decode step within
    max|Δ| / max|ref| < 1e-4 in float32 and < 2e-2 in bfloat16, at prompt
    lengths that take both RWKV branches (S = 32 chunked, S = 20 scan) and
    both SSD chunkings;
  * the params round trip bit-equal in both dtypes (float32 leaves of a
    bfloat16 model kept), the seeded weights taken by both packages, and
    decode against the port's own full forward.
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

from repro.models import mamba2 as jmamba
from repro.models import rwkv6 as jrwkv
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy, seeded_numpy_params
from repro_torch.launch import serve as tserve
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.registry import build_model as tbuild

TOL = dict(rtol=2e-5, atol=2e-5)
CPU = torch.device("cpu")
B = 2


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _layer(module_cls, jax_cls, cfg, arrays: dict):
    """One layer's parameters in both packages from numpy ``arrays``."""
    mod = module_cls(cfg, torch.float32, device=CPU)
    with torch.no_grad():
        for k, v in arrays.items():
            getattr(mod, k).copy_(_t(v))
    return mod, jax_cls(**{k: jnp.asarray(v) for k, v in arrays.items()})


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------


def _mamba_cfg():
    return smoke_pair("zamba2-2.7b", dtype="float32")[1]


def _mamba_layer(seed=0):
    cfg = _mamba_cfg()
    mamba = seeded_numpy_params(cfg, seed)["mamba"]
    arrays = {k: v[0, 1] for k, v in mamba.items()}  # group 0, layer 1
    return cfg, _layer(tmamba.Mamba2Params, jmamba.Mamba2Params, cfg, arrays)


def test_causal_conv():
    rng = np.random.default_rng(0)
    x, w, b = _normal(rng, B, 11, 24), _normal(rng, 4, 24), _normal(rng, 24)
    got = tmamba._causal_conv(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(_np(got), jmamba._causal_conv(x, w, b), **TOL)


@pytest.mark.parametrize("s,chunk,with_h0", [(32, 16, False), (32, 16, True),
                                             (20, 16, False), (20, 16, True), (7, 16, False)])
def test_ssd_chunked(s, chunk, with_h0):
    """S a multiple of the chunk (2 chunks), S = 20 with chunk 16 (the
    largest divisor 10: two chunks, no ragged one), a prime S below the
    chunk (one chunk of 7); with and without an initial state."""
    rng = np.random.default_rng(s + with_h0)
    h, p, n = 3, 8, 5
    xh = _normal(rng, B, s, h, p)
    dt = np.log1p(np.exp(_normal(rng, B, s, h))).astype(np.float32)  # softplus'd
    a = -np.exp(_normal(rng, h, scale=0.5))
    bm, cm = _normal(rng, B, s, n), _normal(rng, B, s, n)
    h0 = _normal(rng, B, h, p, n) if with_h0 else None
    y, st = tmamba._ssd_chunked(_t(xh), _t(dt), _t(a), _t(bm), _t(cm), chunk,
                                None if h0 is None else _t(h0))
    ry, rst = jax.jit(jmamba._ssd_chunked, static_argnums=5)(xh, dt, a, bm, cm, chunk, h0)
    np.testing.assert_allclose(_np(y), ry, **TOL)
    np.testing.assert_allclose(_np(st), rst, **TOL)
    assert tmamba.ssd_chunk(s, chunk) == {32: 16, 20: 10, 7: 7}[s]


@pytest.mark.parametrize("s", [32, 20])
def test_mamba2_forward_and_decode(s):
    """The forward's output, final state and conv tail; then a decode step
    from them: its output and both new states."""
    cfg, (pt, pj) = _mamba_layer()
    rng = np.random.default_rng(s)
    x = _normal(rng, B, s, cfg.d_model)
    with torch.no_grad():
        out, st, tail = tmamba.mamba2_forward(pt, _t(x), cfg)
    rout, rst, rtail = jax.jit(lambda p, x: jmamba.mamba2_forward(p, x, cfg))(pj, x)
    for a, r in ((out, rout), (st, rst), (tail, rtail)):
        np.testing.assert_allclose(_np(a), r, **TOL)
    assert st.dtype == torch.float32 and tail.shape == (B, cfg.ssm_conv_width - 1,
                                                        tmamba.dims(cfg)[2])
    x1 = _normal(rng, B, 1, cfg.d_model)
    with torch.no_grad():
        got = tmamba.mamba2_decode(pt, _t(x1), _t(rst), _t(rtail), cfg)
    ref = jax.jit(lambda *a: jmamba.mamba2_decode(*a, cfg))(pj, x1, rst, rtail)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(_np(a), r, **TOL)


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------


def _rwkv_layer(seed=0):
    cfg = smoke_pair("rwkv6-1.6b", dtype="float32")[1]
    layers = seeded_numpy_params(cfg, seed)["layers"]
    arrays = {k: v[1] for k, v in layers.items()}  # layer 1
    return cfg, _layer(trwkv.RWKV6Params, jrwkv.RWKV6Params, cfg, arrays)


def test_decay_at_the_cap():
    """w0 + lora past log(MAX_LOG_DECAY) on some channels: each package's
    decays there are one value, e^-4 to float32 rounding; the rest lie in
    (e^-4, 1)."""
    cfg, (pt, pj) = _rwkv_layer()
    with torch.no_grad():
        pt.w0[: cfg.d_model // 2] = 6.0
    pj = pj._replace(w0=jnp.asarray(_np(pt.w0)))
    mw = _normal(np.random.default_rng(1), B, 6, cfg.d_model)
    got, ref = _np(trwkv._decay(pt, _t(mw))), np.asarray(jrwkv._decay(pj, mw))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    cap = np.exp(-trwkv.MAX_LOG_DECAY)
    assert trwkv.MAX_LOG_DECAY == jrwkv.MAX_LOG_DECAY
    for a in (got, ref):
        capped = np.unique(a[..., : cfg.d_model // 2])
        assert capped.size == 1 and abs(capped[0] - cap) < 1e-7, capped
        assert (a > cap - 1e-7).all() and (a < 1).all()


def _wkv_inputs(rng, s, d=64, with_s0=False, hd=16):
    r, k, v = (_normal(rng, B, s, d) for _ in range(3))
    w = np.exp(-rng.uniform(0.01, trwkv.MAX_LOG_DECAY, (B, s, d))).astype(np.float32)
    u = _normal(rng, d, scale=0.5)
    s0 = _normal(rng, B, d // hd, hd, hd) if with_s0 else None
    return r, k, v, w, u, s0


@pytest.mark.parametrize("s,with_s0", [(32, False), (32, True), (48, True)])
def test_wkv_scan_and_chunked(s, with_s0):
    """Each form against the reference's, and the chunked form against the
    scan (the decays reach the cap's neighbourhood: e^{+cum} up to ~e^64)."""
    r, k, v, w, u, s0 = _wkv_inputs(np.random.default_rng(s + with_s0), s, with_s0=with_s0)
    ts0 = None if s0 is None else _t(s0)
    y_s, st_s = trwkv._wkv_scan(_t(r), _t(k), _t(v), _t(w), _t(u), 16, ts0)
    y_c, st_c = trwkv._wkv_chunked(_t(r), _t(k), _t(v), _t(w), _t(u), 16, ts0)
    ry_s, rst_s = jax.jit(jrwkv._wkv_scan, static_argnums=5)(r, k, v, w, u, 16, s0)
    ry_c, rst_c = jax.jit(jrwkv._wkv_chunked, static_argnums=5)(r, k, v, w, u, 16, s0)
    for a, ref in ((y_s, ry_s), (st_s, rst_s), (y_c, ry_c), (st_c, rst_c)):
        assert rel_err(_np(a), ref) < 1e-5, rel_err(_np(a), ref)
    assert rel_err(_np(y_c), _np(y_s)) < 1e-4 and rel_err(_np(st_c), _np(st_s)) < 1e-4


def test_wkv_chunked_falls_back_to_the_scan():
    """S not a whole number of chunks: the chunked form is the scan, as in
    the reference."""
    r, k, v, w, u, _ = _wkv_inputs(np.random.default_rng(5), 20)
    got = trwkv._wkv_chunked(_t(r), _t(k), _t(v), _t(w), _t(u), 16)
    scan = trwkv._wkv_scan(_t(r), _t(k), _t(v), _t(w), _t(u), 16)
    ref = jrwkv._wkv_chunked(r, k, v, w, u, 16)
    for a, b, c in zip(got, scan, ref):
        assert torch.equal(a, b)
        np.testing.assert_allclose(_np(a), c, **TOL)


def test_wkv_chunked_refuses_tf32_on_the_card(monkeypatch):
    """On a CUDA tensor with TF32 on, the chunked form raises before any
    product (checked here through a stand-in for ``is_cuda``)."""
    r, k, v, w, u, _ = _wkv_inputs(np.random.default_rng(6), 16)

    class _OnCard(torch.Tensor):
        is_cuda = True

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        trwkv._wkv_chunked(_t(r).as_subclass(_OnCard), _t(k), _t(v), _t(w), _t(u), 16)


@pytest.mark.parametrize("s,with_state", [(32, False), (32, True), (20, False), (20, True),
                                          (1, True)])
def test_time_mix_and_channel_mix(s, with_state):
    cfg, (pt, pj) = _rwkv_layer()
    rng = np.random.default_rng(s * 2 + with_state)
    d, h = cfg.d_model, cfg.d_model // cfg.rwkv_head_dim
    x = _normal(rng, B, s, d)
    s0 = _normal(rng, B, h, cfg.rwkv_head_dim, cfg.rwkv_head_dim) if with_state else None
    xp, xf = (_normal(rng, B, d), _normal(rng, B, d)) if with_state else (None, None)
    tstate = (_t(s0), _t(xp)) if with_state else None
    with torch.no_grad():
        out, (st, last) = trwkv.rwkv6_time_mix(pt, _t(x), cfg, tstate)
        cout, clast = trwkv.rwkv6_channel_mix(pt, _t(x), None if xf is None else _t(xf))
    rout, (rst, rlast) = jax.jit(lambda p, x, st: jrwkv.rwkv6_time_mix(p, x, cfg, st))(
        pj, x, (s0, xp) if with_state else None)
    rcout, rclast = jax.jit(jrwkv.rwkv6_channel_mix)(pj, x, xf)
    for a, r in ((out, rout), (st, rst), (last, rlast), (cout, rcout), (clast, rclast)):
        np.testing.assert_allclose(_np(a), r, **TOL)


def test_group_norm():
    """Per-head normalisation with the population variance."""
    rng = np.random.default_rng(7)
    y, scale, bias = _normal(rng, B, 5, 64, scale=3.0), _normal(rng, 64), _normal(rng, 64)
    got = _np(trwkv._group_norm(_t(y), _t(scale), _t(bias), 4, 1e-5))
    np.testing.assert_allclose(got, jrwkv._group_norm(y, scale, bias, 4, 1e-5), **TOL)
    yh = y.reshape(B, 5, 4, 16).astype(np.float64)
    want = (yh - yh.mean(-1, keepdims=True)) / np.sqrt(yh.var(-1, keepdims=True) + 1e-5)
    np.testing.assert_allclose(got, want.reshape(B, 5, 64) * scale + bias, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

NAMES = ["zamba2-2.7b", "rwkv6-1.6b"]


def _tokens(cfg, s, seed=10):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32))


@pytest.mark.parametrize("name,s", [("zamba2-2.7b", 32), ("zamba2-2.7b", 20),
                                    ("rwkv6-1.6b", 32), ("rwkv6-1.6b", 20)])
def test_prefill_and_decode_match_float32(name, s):
    """Seeded weights (nonzero bonus and decay LoRA); S = 32 takes RWKV's
    chunked form and two SSD chunks, S = 20 RWKV's scan and SSD chunks of
    10.  Logits and every cache leaf within 1e-4 of their largest."""
    jb, jp, tb, tp, _ = model_pair(name, "float32", seed=1)
    prompt, nxt = _tokens(tb.cfg, s)
    (tl, jl), (td, jd), caches = run_prefill_decode(jb, jp, tb, tp, {"tokens": prompt}, nxt)
    assert tl.shape == jl.shape == (B, tb.cfg.vocab_size) and np.isfinite(tl).all()
    assert rel_err(tl, jl) < 1e-4, rel_err(tl, jl)
    assert rel_err(td, jd) < 1e-4, rel_err(td, jd)
    assert len(caches) == (4 if name.startswith("zamba") else 3)
    for t, j in caches:
        assert t.shape == j.shape and rel_err(t, j) < 1e-4, (t.shape, rel_err(t, j))


@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_bfloat16(name):
    jb, jp, tb, tp, _ = model_pair(name, "bfloat16", seed=2)
    prompt, nxt = _tokens(tb.cfg, 32)
    (tl, jl), (td, jd), _ = run_prefill_decode(jb, jp, tb, tp, {"tokens": prompt}, nxt)
    assert rel_err(tl, jl) < 2e-2, rel_err(tl, jl)
    assert rel_err(td, jd) < 2e-2, rel_err(td, jd)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_bit_equal(name, dtype):
    """The JAX package's ``init_params`` -> the port -> numpy: the same
    bits and dtypes; a bfloat16 model keeps its float32 leaves."""
    *_, tp, tree = model_pair(name, dtype, seed=3, seeded=False)
    back = lm_params_to_numpy(tp)
    assert leaves_equal(back, tree)
    if name.startswith("zamba"):
        f32 = [back["mamba"][k] for k in ("a_log", "d_skip", "dt_bias")]
        assert back["mamba"]["in_proj"].shape[:2] == (2, 2)  # (G, P, ...)
    else:
        f32 = [back["ln_in"], back["ln_in_b"]] + [
            back["layers"][k] for k in ("mu_r", "mu_w", "w0", "w_lora_a", "w_lora_b", "u",
                                        "ln_scale", "ln_bias", "mu_ck", "mu_cr")]
    assert all(a.dtype == np.float32 for a in f32)
    assert back["embed"].dtype == (np.float32 if dtype == "float32" else tree["embed"].dtype)


@pytest.mark.parametrize("name", NAMES)
def test_seeded_params_carry_into_both_packages(name):
    """The numpy-seeded rule gives a tree both packages take, with the JAX
    ``init_params``' structure, shapes and dtypes; decays stay in (0, 1)."""
    jcfg, tcfg = smoke_pair(name, dtype="bfloat16")
    from repro.models.registry import build_model as jbuild

    tree = seeded_numpy_params(tcfg, 5)
    jp = jax_params_from_numpy(jbuild(jcfg), tree)
    assert leaves_equal(jax_to_numpy(jp), tree)
    assert leaves_equal(lm_params_to_numpy(lm_params_from_numpy(tcfg, tree, device="cpu")), tree)
    if name.startswith("zamba"):
        a = -np.exp(tree["mamba"]["a_log"])
        assert (a > -16).all() and (a < -1).all()
        dt = np.log1p(np.exp(tree["mamba"]["dt_bias"]))
        assert (dt > 1e-3 * 0.99).all() and (dt < 0.1 * 1.01).all()
    else:
        mu = tree["layers"]["mu_r"]
        assert (mu > 0).all() and (mu < 1).all()


@pytest.mark.parametrize("name,prompt_len", [("zamba2-2.7b", 25), ("rwkv6-1.6b", 25)])
def test_decode_equals_the_forward(name, prompt_len):
    """A greedy run of 8 tokens, then a prefill over prompt + generated[:-1]
    (32 positions: RWKV's chunked form, two SSD chunks): its last logits
    match the last decode step's and its argmax is the last token."""
    _, tcfg = smoke_pair(name, dtype="float32")
    tb = tbuild(tcfg, device="cpu")
    tp = lm_params_from_numpy(tcfg, seeded_numpy_params(tcfg, 4), device="cpu")
    prompt, _ = _tokens(tcfg, prompt_len, seed=11)
    toks = tserve.generate(tb, tp, prompt, max_new=8)
    steps = tserve.teacher_forced(tb, tp, {"tokens": prompt}, toks)
    np.testing.assert_array_equal(steps.argmax(-1).T.numpy(), toks)
    full = np.concatenate([prompt, toks[:, :-1]], axis=1)
    assert full.shape[1] == 32
    logits, _ = tb.prefill(tp, {"tokens": torch.from_numpy(full)})
    assert rel_err(steps[-1].numpy(), logits.numpy()) < 1e-4
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), toks[:, -1])


def test_hybrid_decode_writes_the_cache_in_place():
    """``decode_step`` returns the cache it was given, every entry updated
    in place (the ssm and conv states, and k/v at the position)."""
    jb, jp, tb, tp, _ = model_pair("zamba2-2.7b", "float32", seed=6)
    prompt, nxt = _tokens(tb.cfg, 16)
    _, cache = tb.prefill(tp, {"tokens": torch.from_numpy(prompt)})
    cache = tserve._pad_cache_seq(tb.cfg, cache, 16, 18)
    before = {k: v.clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    _, out = tb.decode_step(tp, cache, torch.from_numpy(nxt).long(), 16)
    assert out is cache and {k: v.data_ptr() for k, v in out.items()} == ptrs
    assert not torch.equal(before["ssm"], out["ssm"]) and not torch.equal(before["conv"],
                                                                           out["conv"])
    assert torch.equal(before["k"][:, :, :16], out["k"][:, :, :16])
    assert out["k"][:, :, 16].abs().sum() > 0 and (out["k"][:, :, 17] == 0).all()
