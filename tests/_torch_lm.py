"""Helpers shared by the LM half's differential tests (``test_torch_lm*.py``):
the smoke configs of both packages, and JAX parameter pytrees <-> the
nested numpy dicts ``repro_torch.convert.lm_params_from_numpy`` takes."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np

# the 7 configs ``TransformerLM`` carries, by their configs/ module
TRANSFORMER = {
    "llama3.2-3b": "llama32_3b",
    "gemma3-1b": "gemma3_1b",
    "phi3-mini-3.8b": "phi3_mini",
    "granite-20b": "granite_20b",
    "deepseek-v3-671b": "deepseek_v3",
    "arctic-480b": "arctic_480b",
    "llava-next-mistral-7b": "llava_next_mistral",
}
OTHER = {
    "zamba2-2.7b": "zamba2_2p7b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "whisper-tiny": "whisper_tiny",
    "xtime-tabular": "xtime_tabular",
}
ALL = {**TRANSFORMER, **OTHER}


def config_modules(name: str):
    """(the JAX package's configs module, the port's) of ``name``."""
    mod = ALL[name]
    return (importlib.import_module(f"repro.configs.{mod}"),
            importlib.import_module(f"repro_torch.configs.{mod}"))


def smoke_pair(name: str, **replace):
    """The smoke config of ``name`` in both packages, with ``replace``."""
    jm, tm = config_modules(name)
    return jm.smoke().replace(**replace), tm.smoke().replace(**replace)


def jax_to_numpy(tree):
    """A JAX params pytree as nested dicts of numpy arrays: NamedTuples as
    their ``_asdict()``, None kept."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_asdict"):
        return {k: jax_to_numpy(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


def numpy_to_jax(template, tree):
    """``tree`` (nested numpy dicts) in the structure of the JAX pytree
    ``template``, each leaf in the template leaf's dtype."""
    if template is None:
        assert tree is None
        return None
    if isinstance(template, dict):
        assert set(template) == set(tree), (sorted(template), sorted(tree))
        return {k: numpy_to_jax(template[k], tree[k]) for k in template}
    if isinstance(template, tuple) and hasattr(template, "_asdict"):
        return type(template)(**{k: numpy_to_jax(v, tree[k])
                                 for k, v in template._asdict().items()})
    assert tuple(tree.shape) == tuple(template.shape)
    return jnp.asarray(tree, dtype=template.dtype)


def jax_params_from_numpy(bundle, tree):
    """JAX parameters of ``bundle`` holding the numpy tree's values."""
    return numpy_to_jax(bundle.params_shape(), tree)


def rel_err(got, ref) -> float:
    """max|got - ref| / max|ref| in float64."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def leaves_equal(a, b) -> bool:
    """Two numpy trees with the same keys, None leaves and bits."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, dict):
        return isinstance(b, dict) and set(a) == set(b) and all(
            leaves_equal(a[k], b[k]) for k in a)
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


def jit_once(cache: dict, key, fn):
    """``jax.jit(fn)`` memoised under ``key`` in ``cache``."""
    if key not in cache:
        cache[key] = jax.jit(fn)
    return cache[key]


def flat_cache(cache) -> list:
    """A cache's tensors or arrays in the JAX package's leaf order: a dict's
    values by sorted key, a list's or tuple's in order."""
    if isinstance(cache, dict):
        return [leaf for k in sorted(cache) for leaf in flat_cache(cache[k])]
    if isinstance(cache, (list, tuple)):
        return [leaf for c in cache for leaf in flat_cache(c)]
    return [cache]


def model_pair(name: str, dtype: str, *, seed: int = 0, seeded: bool = True,
               flash_blk: int = 16, **replace):
    """Both packages' bundles of ``name``'s smoke config (with ``replace``)
    and one set of weights in both: ``seeded_numpy_params(cfg, seed)``, or
    with ``seeded=False`` the JAX package's ``init_params(key(seed))``.
    Returns (jax bundle, jax params, port bundle, port params, numpy tree)."""
    from repro.models.registry import build_model as jbuild
    from repro_torch.convert import lm_params_from_numpy, seeded_numpy_params
    from repro_torch.models.registry import build_model as tbuild

    jcfg, tcfg = smoke_pair(name, dtype=dtype, **replace)
    jb = jbuild(jcfg, flash_blk=flash_blk)
    if seeded:
        tree = seeded_numpy_params(tcfg, seed)
        jp = jax_params_from_numpy(jb, tree)
    else:
        jp = jax.jit(jb.init_params)(jax.random.key(seed))
        tree = jax_to_numpy(jp)
    tb = tbuild(tcfg, flash_blk=flash_blk, device="cpu")
    return jb, jp, tb, lm_params_from_numpy(tcfg, tree, device="cpu"), tree


def run_prefill_decode(jb, jp, tb, tp, batch: dict, nxt, grow: int = 4):
    """Both packages' prefill of ``batch`` (numpy), the caches grown by
    ``grow`` positions and one decode of ``nxt`` (B,) at the prompt's end.
    Float inputs take the model's dtype.  Returns ((port, ref) prefill
    logits, (port, ref) decode logits, [(port, ref) prefill cache leaf])
    as float32 numpy."""
    import torch

    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    bf16 = tb.cfg.dtype == "bfloat16"
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jbatch = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else jdt)
              for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) if v.dtype.kind == "i" else torch.from_numpy(v).to(tdt)
              for k, v in batch.items()}
    s = batch["tokens"].shape[1] if "tokens" in batch else batch["embeds"].shape[1]
    jl, jc = jax.jit(jb.prefill)(jp, jbatch)
    tl, tc = tb.prefill(tp, tbatch)
    caches = [(t.float().numpy().copy(), np.asarray(j, np.float32))  # decode writes in place
              for t, j in zip(flat_cache(tc), jax.tree.leaves(jc))]
    jc = jserve._pad_cache_seq(jb.cfg, jc, s, s + grow)
    tc = tserve._pad_cache_seq(tb.cfg, tc, s, s + grow)
    jd, _ = jax.jit(jb.decode_step)(jp, jc, jnp.asarray(nxt, jnp.int32), jnp.int32(s))
    td, _ = tb.decode_step(tp, tc, torch.from_numpy(np.asarray(nxt)).long(), s)
    return ((tl.float().numpy(), np.asarray(jl, np.float32)),
            (td.float().numpy(), np.asarray(jd, np.float32)), caches)
