"""The port's LM serving path (``repro_torch.launch.serve``) against the
JAX package's, on the CPU, and the reference's answers as a fixture.

  * ``generate`` greedy, teacher-forced: the JAX package's greedy tokens
    fed into the port's decode give each step's logits within
    max|Δ| / max|ref| < 1e-4 (float32), and the port's own greedy run gives
    the same tokens (the token-prompt configs, zamba2 and rwkv6 included);
    whisper through ``prefill`` + ``teacher_forced`` on {frames, tokens}
    with T != S;
  * ``tests/fixtures/torch_lm/`` holds the JAX package's answers for the
    smoke configs of llama3.2-3b, gemma3-1b, deepseek-v3, llava-next,
    zamba2, rwkv6 and whisper on weights made by
    ``repro_torch.convert.seeded_numpy_params`` (numpy seed and rule in
    ``manifest.json`` with a sha256 of every weight leaf): the reference
    recomputed here must equal it, and the port must replay it
    (``chip_smoke.py`` replays it on the card);
  * ``_pad_cache_seq`` on each family's cache: only self-attention k/v grow;
  * ``python -m repro_torch.launch.serve --device cpu``.

Regenerate the fixture (JAX on the CPU) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_serve.py [ARCH ...]

(the named configs only, default all; ``np.savez`` stamps the time, so a
file rewritten is not byte-identical to the one before).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_lm import (
    ALL,
    TRANSFORMER,
    jax_params_from_numpy,
    jax_to_numpy,
    rel_err,
    smoke_pair,
)

from repro.launch import serve as jserve
from repro.models.registry import build_model as jbuild
from repro_torch.convert import leaf_checksums, lm_params_from_numpy, seeded_numpy_params
from repro_torch.launch import serve as tserve
from repro_torch.models.registry import build_model as tbuild

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "torch_lm"
FIXTURE_CONFIGS = ["llama3.2-3b", "gemma3-1b", "deepseek-v3-671b", "llava-next-mistral-7b",
                   "zamba2-2.7b", "rwkv6-1.6b", "whisper-tiny"]
B, S, N = 2, 24, 8  # prompts, prompt length (past gemma's 16-token smoke window), new tokens
T = 40  # whisper's frames (T != S)


def _jax_greedy(jb, jp, batch, n):
    """The reference's greedy decode: prefill, then ``decode_step`` on each
    argmax (``repro.launch.serve.generate``'s loop at temperature 0, which
    also takes embeddings and whisper's frames).  Returns (tokens (B, n),
    logits (n, B, V))."""
    s = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[1]
    logits, cache = jax.jit(jb.prefill)(jp, batch)
    cache = jserve._pad_cache_seq(jb.cfg, cache, s, s + n)
    decode = jax.jit(jb.decode_step)
    steps, toks = [logits], [jnp.argmax(logits, -1).astype(jnp.int32)]
    for i in range(n - 1):
        logits, cache = decode(jp, cache, toks[-1], jnp.int32(s + i))
        steps.append(logits)
        toks.append(jnp.argmax(logits, -1).astype(jnp.int32))
    return (np.stack([np.asarray(t) for t in toks], 1),
            np.stack([np.asarray(x) for x in steps]))


def _prompt(cfg, seed):
    rng = np.random.default_rng(seed + 1)
    if cfg.is_encoder_decoder:
        return {"frames": rng.standard_normal((B, T, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.embeddings_input:
        return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def reference_answers(name: str, seed: int) -> dict:
    """The JAX package's greedy answers for ``name``'s float32 smoke config
    on the seeded weights."""
    jcfg, tcfg = smoke_pair(name, dtype="float32")
    tree = seeded_numpy_params(tcfg, seed)
    jb = jbuild(jcfg)
    jp = jax_params_from_numpy(jb, tree)
    batch = _prompt(tcfg, seed)
    toks, logits = _jax_greedy(jb, jp, {k: jnp.asarray(v) for k, v in batch.items()}, N)
    if set(batch) == {"tokens"}:  # the reference's own entry point agrees
        np.testing.assert_array_equal(
            jserve.generate(jb, jp, jnp.asarray(batch["tokens"]), max_new=N), toks)
    return {**batch, "greedy": toks, "logits": logits, "checksums": leaf_checksums(tree)}


PROMPT_KEYS = ("tokens", "embeds", "frames")


def write_fixture(names=FIXTURE_CONFIGS) -> None:
    """Write the answers of ``names`` and their manifest entries, keeping
    the other configs' entries."""
    FIXTURE.mkdir(parents=True, exist_ok=True)
    path = FIXTURE / "manifest.json"
    configs = json.loads(path.read_text())["configs"] if path.exists() else {}
    manifest = {"rule": "repro_torch.convert.seeded_numpy_params(cfg, seed)",
                "config": "<module>.smoke().replace(dtype='float32')",
                "batch": B, "prompt_len": S, "new_tokens": N, "frames": T,
                "prompt": "np.random.default_rng(seed + 1): integers(0, vocab, (B, S)) "
                          "or standard_normal((B, S, d_model)) for embeddings; whisper "
                          "standard_normal((B, frames, d_model)), then the tokens",
                "configs": configs}
    for name in names:
        seed = 100 + FIXTURE_CONFIGS.index(name)
        ans = reference_answers(name, seed)
        arrays = {k: ans[k] for k in (*PROMPT_KEYS, "greedy", "logits") if k in ans}
        np.savez(FIXTURE / f"{ALL[name]}.npz", **arrays)
        configs[name] = {"file": f"{ALL[name]}.npz", "seed": seed,
                         "checksums": ans["checksums"]}
    path.write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")


def _fixture(name):
    manifest = json.loads((FIXTURE / "manifest.json").read_text())
    entry = manifest["configs"][name]
    with np.load(FIXTURE / entry["file"]) as z:
        return entry, {k: z[k] for k in z.files}


# ---------------------------------------------------------------------------
# the fixture
# ---------------------------------------------------------------------------


def test_fixture_is_small():
    total = sum(f.stat().st_size for f in FIXTURE.iterdir())
    assert total < 1 << 20, total


@pytest.mark.parametrize("name", FIXTURE_CONFIGS)
def test_fixture_equals_the_reference(name):
    """Recomputed from the JAX package: the same weights (checksums), the
    same greedy tokens and the same logits up to float32 rounding."""
    entry, fx = _fixture(name)
    ans = reference_answers(name, entry["seed"])
    assert ans["checksums"] == entry["checksums"]
    assert set(PROMPT_KEYS) & set(fx) == set(PROMPT_KEYS) & set(ans)
    for k in PROMPT_KEYS:
        if k in fx:
            np.testing.assert_array_equal(ans[k], fx[k])
    np.testing.assert_array_equal(ans["greedy"], fx["greedy"])
    assert rel_err(ans["logits"], fx["logits"]) < 1e-6


@pytest.mark.parametrize("name", FIXTURE_CONFIGS)
def test_port_replays_the_fixture(name):
    """The port on the CPU, from the same numpy seed: every weight leaf's
    checksum, each teacher-forced step's logits within 1e-4, equal greedy
    tokens (and its own ``generate`` for token prompts)."""
    entry, fx = _fixture(name)
    _, tcfg = smoke_pair(name, dtype="float32")
    tree = seeded_numpy_params(tcfg, entry["seed"])
    assert leaf_checksums(tree) == entry["checksums"]
    tb = tbuild(tcfg, device="cpu")
    tp = lm_params_from_numpy(tcfg, tree, device="cpu")
    batch = {k: fx[k] for k in PROMPT_KEYS if k in fx}
    logits = tserve.teacher_forced(tb, tp, batch, fx["greedy"]).numpy()
    assert logits.shape == fx["logits"].shape
    assert rel_err(logits, fx["logits"]) < 1e-4
    np.testing.assert_array_equal(logits.argmax(-1).T, fx["greedy"])
    if set(batch) == {"tokens"}:
        np.testing.assert_array_equal(
            tserve.generate(tb, tp, fx["tokens"], max_new=N), fx["greedy"])


# ---------------------------------------------------------------------------
# generate against the reference on carried-across weights
# ---------------------------------------------------------------------------

TOKEN_CONFIGS = sorted([n for n in TRANSFORMER if n != "llava-next-mistral-7b"]
                       + ["zamba2-2.7b", "rwkv6-1.6b"])


@pytest.mark.parametrize("name", TOKEN_CONFIGS)
def test_generate_greedy_teacher_forced(name):
    """The JAX package's ``init_params`` weights carried across: its greedy
    tokens fed into the port's decode give each step's logits within 1e-4,
    and the port's ``generate`` gives the same tokens."""
    jcfg, tcfg = smoke_pair(name, dtype="float32")
    jb = jbuild(jcfg)
    jp = jb.init_params(jax.random.key(7))
    tp = lm_params_from_numpy(tcfg, jax_to_numpy(jp), device="cpu")
    tb = tbuild(tcfg, device="cpu")
    prompt = np.random.default_rng(7).integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    toks, ref = _jax_greedy(jb, jp, {"tokens": jnp.asarray(prompt)}, N)
    np.testing.assert_array_equal(jserve.generate(jb, jp, jnp.asarray(prompt), max_new=N), toks)
    got = tserve.teacher_forced(tb, tp, {"tokens": prompt}, toks).numpy()
    assert rel_err(got, ref) < 1e-4, rel_err(got, ref)
    np.testing.assert_array_equal(tserve.generate(tb, tp, prompt, max_new=N), toks)


def test_whisper_prefill_and_teacher_forced():
    """Whisper's {frames (T = 40), tokens (S = 24)} prompt on the JAX
    package's ``init_params`` weights: the reference's greedy tokens fed
    into the port's ``teacher_forced`` give each step's logits within 1e-4,
    whose argmaxes are those tokens (the prompt length is the decoder's S,
    not T)."""
    jcfg, tcfg = smoke_pair("whisper-tiny", dtype="float32")
    jb = jbuild(jcfg)
    jp = jb.init_params(jax.random.key(7))
    tp = lm_params_from_numpy(tcfg, jax_to_numpy(jp), device="cpu")
    tb = tbuild(tcfg, device="cpu")
    batch = _prompt(tcfg, 7)
    assert batch["frames"].shape[1] != batch["tokens"].shape[1]
    toks, ref = _jax_greedy(jb, jp, {k: jnp.asarray(v) for k, v in batch.items()}, N)
    got = tserve.teacher_forced(tb, tp, batch, toks).numpy()
    assert got.shape == ref.shape == (N, B, tcfg.vocab_size)
    assert rel_err(got, ref) < 1e-4, rel_err(got, ref)
    np.testing.assert_array_equal(got.argmax(-1).T, toks)


def _family_cache(name, b, s, t=None):
    """The port's zero cache of ``name``'s smoke config filled with numpy
    normals, and the same arrays as the JAX package's cache."""
    jcfg, tcfg = smoke_pair(name, dtype="float32")
    tb = tbuild(tcfg, device="cpu")
    kw = {} if t is None else {"enc_len": t}
    cache = tb.init_cache(b, s, **kw)
    rng = np.random.default_rng(4)

    def fill(c):
        return torch.from_numpy(rng.standard_normal(tuple(c.shape)).astype(np.float32))

    if isinstance(cache, dict):
        cache = {k: fill(v) for k, v in cache.items()}
        return jcfg, tcfg, cache, {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    cache = tuple(fill(v) for v in cache)
    return jcfg, tcfg, cache, tuple(jnp.asarray(v.numpy()) for v in cache)


@pytest.mark.parametrize("name,b,s,t", [("zamba2-2.7b", 2, 5, None), ("zamba2-2.7b", 5, 5, None),
                                        ("whisper-tiny", 2, 5, 7), ("whisper-tiny", 2, 5, 5),
                                        ("rwkv6-1.6b", 2, 5, None)])
def test_pad_cache_seq_each_family(name, b, s, t):
    """Only the self-attention k/v grow (zeros appended on axis 2); the
    hybrid's ssm/conv states and whisper's cross cache are kept, also where
    B == S or T == S (there the reference also pads them: a deliberate
    difference).  Where B != S and T != S the result is the reference's."""
    jcfg, tcfg, cache, jcache = _family_cache(name, b, s, t)
    got = tserve._pad_cache_seq(tcfg, cache, s, s + 3)
    if name.startswith("rwkv"):
        assert got is cache
        return
    for k, v in got.items():
        if k in ("k", "v"):
            assert v.shape[2] == s + 3 and torch.equal(v[:, :, :s], cache[k])
            assert (v[:, :, s:] == 0).all()
        else:
            assert v is cache[k]
    if b != s and (t or 0) != s:
        ref = jserve._pad_cache_seq(jcfg, jcache, s, s + 3)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_pad_cache_seq_matches():
    jcfg, tcfg = smoke_pair("deepseek-v3-671b", dtype="float32")
    rng = np.random.default_rng(3)
    cache = [(rng.standard_normal((1, 2, 5, 16)).astype(np.float32),
              rng.standard_normal((1, 2, 5, 8)).astype(np.float32)),
             (rng.standard_normal((3, 2, 5, 4, 8)).astype(np.float32),
              rng.standard_normal((3, 2, 5, 4, 8)).astype(np.float32))]
    got = tserve._pad_cache_seq(tcfg, [tuple(torch.from_numpy(c) for c in seg) for seg in cache],
                                5, 9)
    ref = jserve._pad_cache_seq(jcfg, [tuple(jnp.asarray(c) for c in seg) for seg in cache], 5, 9)
    for gs, rs in zip(got, ref):
        for g, r in zip(gs, rs):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_generate_with_temperature_is_seeded():
    _, tcfg = smoke_pair("llama3.2-3b", dtype="float32")
    tb = tbuild(tcfg, device="cpu")
    tp = tb.init_params(0)
    prompt = np.random.default_rng(0).integers(0, tcfg.vocab_size, (B, 8))
    a = tserve.generate(tb, tp, prompt, max_new=6, temperature=0.8, seed=1)
    b = tserve.generate(tb, tp, prompt, max_new=6, temperature=0.8, seed=1)
    c = tserve.generate(tb, tp, prompt, max_new=6, temperature=0.8, seed=2)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (B, 6) and a.dtype == np.int32 and (a >= 0).all()
    assert (a < tcfg.vocab_size).all() and not np.array_equal(a, c)


def test_serve_command_line_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--batch", "2",
         "--prompt-len", "16", "--max-new", "5"],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("generated (2, 5) tokens in ") and "tok/s); sample row: [" in line


if __name__ == "__main__":
    write_fixture(sys.argv[1:] or FIXTURE_CONFIGS)
