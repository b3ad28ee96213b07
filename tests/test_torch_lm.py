"""The port's LM layers and models against the JAX package's, on the CPU.

The same numpy-seeded inputs (and weights, carried across with
``repro_torch.convert.lm_params_from_numpy``) go through both packages:
  * every config field of the 11 configs and their ``smoke()`` equal;
  * ``common``, ``ffn``, ``attention`` and ``mla`` in float32 within
    rtol = atol = 2e-5 (full and flash paths, windows, softcap, GQA/MQA,
    decode at a mid-cache position, gelu, rope at theta 5e5);
  * ``moe_forward``'s routing, kept mask and ``dest`` exactly equal, at a
    capacity factor that drops tokens and at one that drops none;
  * prefill and decode logits of the 7 transformer configs' smoke configs
    within max|Δ| / max|ref| < 1e-4 in float32, < 2e-2 in bfloat16 (llama,
    gemma);
  * the parameter round trip bit-equal, and ``model_flops``/
    ``active_params`` and the decode cache's shapes equal for all ten LM
    configs (the hybrid, ssm and audio families' layers and models are in
    ``test_torch_lm_ssm.py`` and ``test_torch_lm_encdec.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_lm import (
    ALL,
    TRANSFORMER,
    config_modules,
    flat_cache,
    jax_params_from_numpy,
    jax_to_numpy,
    jit_once,
    leaves_equal,
    model_pair,
    rel_err,
    run_prefill_decode,
    smoke_pair,
)

import repro.config as jconfig
import repro.configs as jconfigs
import repro_torch.config as tconfig
import repro_torch.configs as tconfigs
from repro.launch import model_flops as jflops
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import mla as jmla
from repro.models import moe as jmoe
from repro.models import transformer as jtransformer
from repro.models.registry import build_model as jbuild
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy, seeded_numpy_params
from repro_torch.launch import model_flops as tflops
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import ffn as tffn
from repro_torch.models import mla as tmla
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.models.registry import build_model as tbuild

TOL = dict(rtol=2e-5, atol=2e-5)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jitted():
    return {}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _load(module: torch.nn.Module, arrays: dict) -> torch.nn.Module:
    """Copy ``arrays`` (name -> numpy) into ``module``'s parameters."""
    with torch.no_grad():
        for name, arr in arrays.items():
            val = getattr(module, name)
            if isinstance(val, torch.nn.Module):
                _load(val, arr)
            elif arr is not None:
                val.copy_(_t(arr))
    return module


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(ALL))
def test_config_fields_equal(name):
    jm, tm = config_modules(name)
    assert dataclasses.asdict(tm.CONFIG) == dataclasses.asdict(jm.CONFIG)
    assert dataclasses.asdict(tm.smoke()) == dataclasses.asdict(jm.smoke())
    assert tconfig.get_config(name) is tm.CONFIG
    for cfg_t, cfg_j in ((tm.CONFIG, jm.CONFIG), (tm.smoke(), jm.smoke())):
        assert [dataclasses.asdict(c) for c in cfg_t.shapes()] == \
            [dataclasses.asdict(c) for c in cfg_j.shapes()]
        if name != "xtime-tabular":
            assert (cfg_t.resolved_head_dim, cfg_t.is_moe) == \
                (cfg_j.resolved_head_dim, cfg_j.is_moe)


def test_config_system_equal():
    """Field names and defaults of both dataclasses, the shape cells, the
    arch lists and the registry."""
    for a, b in ((tconfig.ModelConfig, jconfig.ModelConfig),
                 (tconfig.XTimeConfig, jconfig.XTimeConfig),
                 (tconfig.ShapeCell, jconfig.ShapeCell)):
        assert [(f.name, f.default) for f in dataclasses.fields(a)] == \
            [(f.name, f.default) for f in dataclasses.fields(b)]
    assert {k: dataclasses.asdict(v) for k, v in tconfig.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfig.SHAPES.items()}
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert tconfigs.ALL_ARCHS == jconfigs.ALL_ARCHS
    assert tconfig.list_configs() == jconfig.list_configs()
    with pytest.raises(KeyError, match="unknown arch"):
        tconfig.get_config("no-such-arch")
    cfg = tconfig.get_config("llama3.2-3b").replace(n_layers=2)
    assert cfg.n_layers == 2 and tconfig.get_config("llama3.2-3b").n_layers == 28


# ---------------------------------------------------------------------------
# common / ffn
# ---------------------------------------------------------------------------


def test_norms_and_rope():
    rng = np.random.default_rng(0)
    x = _normal(rng, 2, 7, 3, 16, scale=3.0)
    scale, bias = _normal(rng, 16, scale=0.3), _normal(rng, 16, scale=0.3)
    np.testing.assert_allclose(_np(tcommon.rms_norm(_t(x), _t(scale), 1e-6)),
                               jcommon.rms_norm(x, scale, 1e-6), **TOL)
    np.testing.assert_allclose(_np(tcommon.layer_norm(_t(x), _t(scale), _t(bias))),
                               jcommon.layer_norm(x, scale, bias), **TOL)
    # rope at a float32 theta of 5e5, positions far into a long context
    pos = np.array([[0, 1, 17, 511, 4096, 30000, 32767]] * 2, np.int32)
    theta = np.float32(5e5)
    np.testing.assert_allclose(_np(tcommon.rope_freqs(16, theta)),
                               jcommon.rope_freqs(16, theta), **TOL)
    np.testing.assert_allclose(_np(tcommon.apply_rope(_t(x), _t(pos), float(theta))),
                               jcommon.apply_rope(x, jnp.asarray(pos), jnp.float32(theta)),
                               **TOL)
    # bfloat16 input: float32 math, cast back
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tcommon.rms_norm(xb, _t(scale))
    ref = jcommon.rms_norm(jnp.asarray(x, jnp.bfloat16), scale)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activations(name):
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    np.testing.assert_allclose(_np(tcommon.act_fn(name)(_t(x))), jcommon.act_fn(name)(x),
                               **TOL)


def test_softcap_and_cross_entropy():
    rng = np.random.default_rng(1)
    logits = _normal(rng, 3, 5, 40, scale=20.0)
    labels = rng.integers(0, 40, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) < 0.6).astype(np.float32)
    for cap in (0.0, 30.0):
        np.testing.assert_allclose(_np(tcommon.softcap(_t(logits), cap)),
                                   jcommon.softcap(logits, cap), **TOL)
    np.testing.assert_allclose(_np(tcommon.cross_entropy(_t(logits), _t(labels))),
                               jcommon.cross_entropy(logits, labels), **TOL)
    np.testing.assert_allclose(
        _np(tcommon.cross_entropy(_t(logits), _t(labels), _t(mask))),
        jcommon.cross_entropy(logits, labels, mask), **TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_ffn_and_mlp(act):
    rng = np.random.default_rng(2)
    d, f = 24, 40
    x = _normal(rng, 2, 5, d)
    w = {"w_gate": _normal(rng, d, f, scale=0.2), "w_up": _normal(rng, d, f, scale=0.2),
         "w_down": _normal(rng, f, d, scale=0.2)}
    p = _load(tffn.FFNParams(d, f, torch.float32, device=CPU), w)
    with torch.no_grad():
        got = tffn.ffn_forward(p, _t(x), act)
    np.testing.assert_allclose(_np(got), jffn.ffn_forward(jffn.FFNParams(**w), x, act), **TOL)
    m = {"w1": _normal(rng, d, f, scale=0.2), "b1": _normal(rng, f, scale=0.2),
         "w2": _normal(rng, f, d, scale=0.2), "b2": _normal(rng, d, scale=0.2)}
    pm = _load(tffn.MLPParams(d, f, torch.float32, device=CPU), m)
    with torch.no_grad():
        got = tffn.mlp_forward(pm, _t(x), act)
    np.testing.assert_allclose(_np(got), jffn.mlp_forward(jffn.MLPParams(**m), x, act), **TOL)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

# (path, kv heads of 4, window, softcap): MHA / GQA / MQA, windows, softcap
ATTN_CASES = [
    ("full", 4, 0, 0.0), ("full", 2, 8, 0.0), ("full", 1, 0, 30.0), ("full", 2, 5, 20.0),
    ("flash", 4, 0, 0.0), ("flash", 2, 8, 0.0), ("flash", 1, 0, 30.0), ("flash", 2, 20, 20.0),
]


@pytest.mark.parametrize("path,kv,window,cap", ATTN_CASES)
def test_attention_paths(jitted, path, kv, window, cap):
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 32, 4, 16
    q, k, v = (_normal(rng, b, s, n, d) for n in (h, kv, kv))
    if path == "full":
        got = tattn.full_attention(_t(q), _t(k), _t(v), window=window, logit_softcap=cap)
        fn = jit_once(jitted, ("full", cap), lambda q, k, v, w: jattn.full_attention(
            q, k, v, window=w, logit_softcap=cap))
    else:  # S > blk and S % blk == 0: the online-softmax scan, 2 blocks
        got = tattn.flash_attention(_t(q), _t(k), _t(v), window=window, logit_softcap=cap,
                                    blk=16)
        fn = jit_once(jitted, ("flash", cap), lambda q, k, v, w: jattn.flash_attention(
            q, k, v, window=w, logit_softcap=cap, blk=16))
    np.testing.assert_allclose(_np(got), fn(q, k, v, jnp.int32(window)), **TOL)


def test_flash_falls_back_to_full():
    """S not a multiple of blk, or S <= blk: the full path, as the reference."""
    rng = np.random.default_rng(4)
    q, k, v = (_normal(rng, 1, 24, 2, 8) for _ in range(3))
    for blk in (16, 32):
        got = tattn.flash_attention(_t(q), _t(k), _t(v), window=6, blk=blk)
        ref = jattn.flash_attention(q, k, v, window=6, blk=blk)
        np.testing.assert_allclose(_np(got), ref, **TOL)
        np.testing.assert_array_equal(
            _np(got), _np(tattn.full_attention(_t(q), _t(k), _t(v), window=6)))


@pytest.mark.parametrize("kv,window,cap", [(4, 0, 0.0), (2, 6, 0.0), (1, 0, 25.0)])
def test_decode_attention_mid_cache(kv, window, cap):
    rng = np.random.default_rng(5)
    b, s, h, d, pos = 2, 32, 4, 16, 20
    q = _normal(rng, b, 1, h, d)
    kc, vc = _normal(rng, b, s, kv, d), _normal(rng, b, s, kv, d)
    got = tattn.decode_attention(_t(q), _t(kc), _t(vc), pos, window=window, logit_softcap=cap)
    ref = jattn.decode_attention(q, kc, vc, jnp.int32(pos), window=jnp.int32(window),
                                 logit_softcap=cap)
    np.testing.assert_allclose(_np(got), ref, **TOL)


def _attn_arrays(rng, d, h, kv, hd, qk_norm):
    return {"wq": _normal(rng, d, h * hd, scale=0.2), "wk": _normal(rng, d, kv * hd, scale=0.2),
            "wv": _normal(rng, d, kv * hd, scale=0.2), "wo": _normal(rng, h * hd, d, scale=0.2),
            "q_norm": _normal(rng, hd, scale=0.1) if qk_norm else None,
            "k_norm": _normal(rng, hd, scale=0.1) if qk_norm else None}


@pytest.mark.parametrize("qk_norm,window", [(False, 0), (True, 8)])
def test_attention_block_forward_and_decode(qk_norm, window):
    """Projection, qk-norm, rope (theta 5e5), attend, out-projection; then a
    decode at a mid-cache position that writes its k/v into the cache."""
    rng = np.random.default_rng(6)
    b, s, d, h, kv, hd = 2, 32, 32, 4, 2, 8
    w = _attn_arrays(rng, d, h, kv, hd, qk_norm)
    p_t = _load(tattn.AttnParams(d, h, kv, hd, torch.float32, qk_norm, device=CPU), w)
    p_j = jattn.AttnParams(**w)
    x = _normal(rng, b, s, d)
    kw = dict(n_heads=h, n_kv=kv, head_dim=hd, rope_theta=5e5, window=window)
    with torch.no_grad():
        out, (k, v) = tattn.attention_forward(p_t, _t(x), positions=torch.arange(s),
                                              flash_blk=16, **kw)
    ref, (rk, rv) = jattn.attention_forward(p_j, x, positions=jnp.arange(s), flash_blk=16,
                                            **{**kw, "window": jnp.int32(window)})
    for a, r in ((out, ref), (k, rk), (v, rv)):
        np.testing.assert_allclose(_np(a), r, **TOL)

    pos = 20
    kc, vc = _normal(rng, b, s, kv, hd), _normal(rng, b, s, kv, hd)
    x1 = _normal(rng, b, 1, d)
    kc_t, vc_t = _t(kc), _t(vc)
    with torch.no_grad():
        out, (k2, v2) = tattn.attention_decode(p_t, _t(x1), kc_t, vc_t, pos, **kw)
    ref, (rk2, rv2) = jattn.attention_decode(p_j, x1, kc, vc, jnp.int32(pos),
                                             **{**kw, "window": jnp.int32(window)})
    assert k2 is kc_t and v2 is vc_t  # written in place
    for a, r in ((out, ref), (k2, rk2), (v2, rv2)):
        np.testing.assert_allclose(_np(a), r, **TOL)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _jax_routing(p, x, top_k, capacity_factor):
    """The reference's routing lines (``repro.models.moe.moe_forward``,
    top-k through the two-level blocked rank) with its dispatch, expert FFN
    and combine, so the routing it returns is bound to the reference's
    output by the caller."""
    b, s, d = x.shape
    e = p.router.shape[1]
    t = b * s
    xt = x.reshape(t, d)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ p.router, axis=-1)
    gate_vals, gate_idx = jax.lax.top_k(probs, top_k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True), 1e-9)
    onehot = jax.nn.one_hot(gate_idx, e, dtype=jnp.float32)
    capacity = int(max(1, round(t * top_k / e * capacity_factor)))
    tk = t * top_k
    blk = next(c for c in (4096, 2048, 1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1)
               if tk % c == 0)
    nb = tk // blk
    local_cum = jnp.cumsum(onehot.reshape(nb, blk, e).astype(jnp.int32), axis=1)
    block_counts = local_cum[:, -1, :]
    block_offsets = jnp.cumsum(block_counts, axis=0) - block_counts
    flat_expert = gate_idx.reshape(tk)
    rank = jnp.take_along_axis(local_cum.reshape(tk, e), flat_expert[:, None], axis=1)[:, 0] - 1
    rank = rank + jnp.take_along_axis(jnp.repeat(block_offsets, blk, axis=0),
                                      flat_expert[:, None], axis=1)[:, 0]
    keep = rank < capacity
    dest = jnp.where(keep, flat_expert * capacity + rank, e * capacity)
    return gate_vals, gate_idx, keep, dest, capacity


def _moe_arrays(rng, d, f, e, shared):
    arr = {"router": _normal(rng, d, e), "w_gate": _normal(rng, e, d, f, scale=0.2),
           "w_up": _normal(rng, e, d, f, scale=0.2), "w_down": _normal(rng, e, f, d, scale=0.2),
           "shared": None}
    if shared:
        arr["shared"] = {"w_gate": _normal(rng, d, f, scale=0.2),
                         "w_up": _normal(rng, d, f, scale=0.2),
                         "w_down": _normal(rng, f, d, scale=0.2)}
    return arr


def _moe_pair(arr, d, f, e):
    p_t = _load(tmoe.MoEParams(d, f, e, 1 if arr["shared"] else 0, torch.float32, device=CPU),
                arr)
    shared = jffn.FFNParams(**arr["shared"]) if arr["shared"] else None
    return p_t, jmoe.MoEParams(**{**arr, "shared": shared})


@pytest.mark.parametrize("cf,drops", [(0.5, True), (8.0, False)])
def test_moe_routing_exact(cf, drops):
    rng = np.random.default_rng(7)
    b, s, d, f, e, k = 2, 16, 24, 32, 8, 2
    arr = _moe_arrays(rng, d, f, e, shared=True)
    p_t, p_j = _moe_pair(arr, d, f, e)
    x = _normal(rng, b, s, d)
    gv, gi, keep, dest, cap = _jax_routing(p_j, jnp.asarray(x), k, cf)
    r = tmoe.route(p_t.router, _t(x).reshape(-1, d), k=k, capacity_factor=cf)
    assert r.capacity == cap
    np.testing.assert_array_equal(_np(r.gate_idx), np.asarray(gi))
    np.testing.assert_array_equal(_np(r.keep), np.asarray(keep))
    np.testing.assert_array_equal(_np(r.dest), np.asarray(dest))
    np.testing.assert_allclose(_np(r.gate_vals), gv, **TOL)
    assert bool((~_np(r.keep)).any()) == drops
    with torch.no_grad():
        out, aux = tmoe.moe_forward(p_t, _t(x), top_k=k, capacity_factor=cf)
    ref, raux = jmoe.moe_forward(p_j, x, top_k=k, capacity_factor=cf)
    np.testing.assert_allclose(_np(out), ref, **TOL)
    np.testing.assert_allclose(float(aux), float(raux), **TOL)


def test_moe_ties_go_to_the_lower_expert():
    """A zero router makes every expert tie: both packages pick experts
    0..k-1 for every token, in that order, and drop the same tokens."""
    rng = np.random.default_rng(8)
    b, s, d, f, e, k = 1, 12, 16, 16, 8, 3
    arr = _moe_arrays(rng, d, f, e, shared=False)
    arr["router"] = np.zeros((d, e), np.float32)
    p_t, p_j = _moe_pair(arr, d, f, e)
    x = _normal(rng, b, s, d)
    _, gi, keep, dest, _ = _jax_routing(p_j, jnp.asarray(x), k, 1.0)
    r = tmoe.route(p_t.router, _t(x).reshape(-1, d), k=k, capacity_factor=1.0)
    np.testing.assert_array_equal(_np(r.gate_idx), np.tile(np.arange(k), (s, 1)))
    np.testing.assert_array_equal(_np(r.gate_idx), np.asarray(gi))
    np.testing.assert_array_equal(_np(r.keep), np.asarray(keep))
    np.testing.assert_array_equal(_np(r.dest), np.asarray(dest))
    with torch.no_grad():
        out, _ = tmoe.moe_forward(p_t, _t(x), top_k=k, capacity_factor=1.0)
    np.testing.assert_allclose(_np(out), jmoe.moe_forward(p_j, x, top_k=k,
                                                          capacity_factor=1.0)[0], **TOL)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------


def test_mla_forward_and_decode():
    _, cfg = smoke_pair("deepseek-v3-671b", dtype="float32")
    rng = np.random.default_rng(9)
    h = cfg.n_heads
    arr = {"wdq": (cfg.d_model, cfg.q_lora_rank), "q_ln": (cfg.q_lora_rank,),
           "wuq": (cfg.q_lora_rank, h * (cfg.qk_nope_dim + cfg.qk_rope_dim)),
           "wdkv": (cfg.d_model, cfg.kv_lora_rank), "kv_ln": (cfg.kv_lora_rank,),
           "wuk": (cfg.kv_lora_rank, h * cfg.qk_nope_dim),
           "wuv": (cfg.kv_lora_rank, h * cfg.v_head_dim), "wkr": (cfg.d_model, cfg.qk_rope_dim),
           "wo": (h * cfg.v_head_dim, cfg.d_model)}
    arr = {k: _normal(rng, *shape, scale=0.1 if len(shape) == 1 else shape[0] ** -0.5)
           for k, shape in arr.items()}
    p_t = _load(tmla.MLAParams(cfg, torch.float32, device=CPU), arr)
    p_j = jmla.MLAParams(**arr)
    b, s = 2, 32
    x = _normal(rng, b, s, cfg.d_model)
    with torch.no_grad():
        out, (ckv, kr) = tmla.mla_forward(p_t, _t(x), cfg, torch.arange(s), flash_blk=16)
    ref, (rckv, rkr) = jmla.mla_forward(p_j, x, cfg, jnp.arange(s), flash_blk=16)
    for a, r in ((out, ref), (ckv, rckv), (kr, rkr)):
        np.testing.assert_allclose(_np(a), r, **TOL)

    pos = 20
    ckv_c = _normal(rng, b, s, cfg.kv_lora_rank)
    kr_c = _normal(rng, b, s, cfg.qk_rope_dim)
    x1 = _normal(rng, b, 1, cfg.d_model)
    with torch.no_grad():
        out, (c1, c2) = tmla.mla_decode(p_t, _t(x1), _t(ckv_c), _t(kr_c), pos, cfg)
    ref, (r1, r2) = jmla.mla_decode(p_j, x1, ckv_c, kr_c, jnp.int32(pos), cfg)
    for a, r in ((out, ref), (c1, r1), (c2, r2)):
        np.testing.assert_allclose(_np(a), r, **TOL)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

B, S = 2, 32


def _pair(name, dtype, seed=0):
    """Both packages' bundles of ``name``'s smoke config on the JAX
    package's ``init_params(key(seed))`` weights, carried across."""
    return model_pair(name, dtype, seed=seed, seeded=False)


def _prompt(cfg, rng, s=S):
    if cfg.embeddings_input:
        e = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
        return {"embeds": e}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}


def _run_prefill_decode(name, dtype):
    """Prefill of S prompt positions, the caches grown by 4, one decode at
    position S: (port, reference) logits of both, and the prefill caches."""
    jb, jp, tb, tp, _ = _pair(name, dtype)
    rng = np.random.default_rng(10)
    batch = _prompt(tb.cfg, rng)
    nxt = rng.integers(0, tb.cfg.vocab_size, (B,)).astype(np.int32)
    return run_prefill_decode(jb, jp, tb, tp, batch, nxt)


@pytest.mark.parametrize("name", sorted(TRANSFORMER))
def test_prefill_and_decode_match_float32(name):
    (tl, jl), (td, jd), caches = _run_prefill_decode(name, "float32")
    assert tl.shape == jl.shape == (B, 512) and np.isfinite(tl).all()
    assert rel_err(tl, jl) < 1e-4, (name, rel_err(tl, jl))
    assert rel_err(td, jd) < 1e-4, (name, rel_err(td, jd))
    for t, j in caches:  # the JAX cache layout, segment by segment
        assert t.shape == j.shape and rel_err(t, j) < 1e-4


@pytest.mark.parametrize("name", ["llama3.2-3b", "gemma3-1b"])
def test_prefill_and_decode_match_bfloat16(name):
    (tl, jl), (td, jd), _ = _run_prefill_decode(name, "bfloat16")
    assert rel_err(tl, jl) < 2e-2, (name, rel_err(tl, jl))
    assert rel_err(td, jd) < 2e-2, (name, rel_err(td, jd))


@pytest.mark.parametrize("name", ["gemma3-1b", "deepseek-v3-671b"])
def test_layer_meta_equal(name):
    jm, tm = config_modules(name)
    for cj, ct in ((jm.CONFIG, tm.CONFIG), (jm.smoke(), tm.smoke())):
        for n, off in ((ct.n_layers, 0), (3, 1)):
            w, th = ttransformer.layer_meta(ct, n, off)
            rw, rth = jtransformer.layer_meta(cj, n, off)
            np.testing.assert_array_equal(w, np.asarray(rw))
            np.testing.assert_array_equal(th, np.asarray(rth))
            assert th.dtype == np.float32


@pytest.mark.parametrize("name,dtype", [("llama3.2-3b", "bfloat16"),
                                        ("deepseek-v3-671b", "bfloat16"),
                                        ("gemma3-1b", "float32"),
                                        ("arctic-480b", "float32")])
def test_params_round_trip_bit_equal(name, dtype):
    """JAX params -> the port -> numpy: the same bits, bfloat16 included
    (deepseek mixes a float32 router into a bfloat16 model), None fields
    kept, the mtp parameters carried."""
    _, _, _, tp, tree = _pair(name, dtype, seed=3)
    back = lm_params_to_numpy(tp)
    assert leaves_equal(back, tree)
    if name.startswith("deepseek"):
        assert "mtp" in back and back["seg1"]["ffn"]["router"].dtype == np.float32


def test_seeded_params_carry_into_both_packages():
    """The numpy-seeded rule gives a tree both packages take; the JAX
    package's ``init_params`` has the same structure, shapes and dtypes."""
    jcfg, tcfg = smoke_pair("deepseek-v3-671b", dtype="float32")
    tree = seeded_numpy_params(tcfg, 5)
    jp = jax_params_from_numpy(jbuild(jcfg), tree)
    assert leaves_equal(jax_to_numpy(jp), tree)
    tp = lm_params_from_numpy(tcfg, tree, device="cpu")
    assert leaves_equal(lm_params_to_numpy(tp), tree)
    with pytest.raises(ValueError, match="want"):
        bad = seeded_numpy_params(tcfg.replace(dtype="bfloat16"), 5)
        lm_params_from_numpy(tcfg, bad, device="cpu")


LM_CONFIGS = sorted(n for n in ALL if n != "xtime-tabular")


@pytest.mark.parametrize("name", LM_CONFIGS)
def test_model_flops_equal(name):
    """``active_params`` and ``model_flops`` at every applicable cell of the
    full config equal the JAX package's, and so do the input stand-ins'
    shapes (a decode cell's cache flattened: segment tuples, the hybrid's
    and whisper's dicts, rwkv's tuple)."""
    jcfg = jconfig.get_config(name)
    tcfg = tconfig.get_config(name)
    jb, tb = jbuild(jcfg), tbuild(tcfg, device="cpu")
    assert tflops.active_params(tcfg, tb) == jflops.active_params(jcfg, jb)
    assert tflops._param_counts(tb) == jflops._param_counts(jb)
    for jcell, tcell in zip(jcfg.shapes(), tcfg.shapes()):
        assert tflops.model_flops(tcfg, tcell, tb) == jflops.model_flops(jcfg, jcell, jb)
        if jcell.kind == "decode":
            tspec, jspec = tb.input_specs(tcell), jb.input_specs(jcell)
            assert [tuple(c.shape) for c in flat_cache(tspec["cache"])] == \
                [tuple(c.shape) for c in jax.tree.leaves(jspec["cache"])]
        else:
            assert {k: tuple(v.shape) for k, v in tb.input_specs(tcell).items()} == \
                {k: tuple(v.shape) for k, v in jb.input_specs(jcell).items()}

