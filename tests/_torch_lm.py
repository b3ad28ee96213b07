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
