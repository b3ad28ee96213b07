"""The port's LM serving path (``repro_torch.launch.serve``) against the
JAX package's, on the CPU, and the reference's answers as a fixture.

  * ``generate`` greedy, teacher-forced: the JAX package's greedy tokens
    fed into the port's decode give each step's logits within
    max|Δ| / max|ref| < 1e-4 (float32), and the port's own greedy run gives
    the same tokens;
  * ``tests/fixtures/torch_lm/`` holds the JAX package's answers for the
    smoke configs of llama3.2-3b, gemma3-1b, deepseek-v3 and llava-next on
    weights made by ``repro_torch.convert.seeded_numpy_params`` (numpy seed
    and rule in ``manifest.json`` with a sha256 of every weight leaf): the
    reference recomputed here must equal it, and the port must replay it
    (``chip_smoke.py`` replays it on the card);
  * ``python -m repro_torch.launch.serve --device cpu``.

Regenerate the fixture (JAX on the CPU) with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lm_serve.py
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
FIXTURE_CONFIGS = ["llama3.2-3b", "gemma3-1b", "deepseek-v3-671b", "llava-next-mistral-7b"]
B, S, N = 2, 24, 8  # prompts, prompt length (past gemma's 16-token smoke window), new tokens


def _jax_greedy(jb, jp, batch, n):
    """The reference's greedy decode: prefill, then ``decode_step`` on each
    argmax (``repro.launch.serve.generate``'s loop at temperature 0, which
    also takes embeddings).  Returns (tokens (B, n), logits (n, B, V))."""
    s = next(iter(batch.values())).shape[1]
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
    if "tokens" in batch:  # the reference's own entry point agrees
        np.testing.assert_array_equal(
            jserve.generate(jb, jp, jnp.asarray(batch["tokens"]), max_new=N), toks)
    return {**batch, "greedy": toks, "logits": logits, "checksums": leaf_checksums(tree)}


def write_fixture() -> None:
    FIXTURE.mkdir(parents=True, exist_ok=True)
    manifest = {"rule": "repro_torch.convert.seeded_numpy_params(cfg, seed)",
                "config": "<module>.smoke().replace(dtype='float32')",
                "batch": B, "prompt_len": S, "new_tokens": N,
                "prompt": "np.random.default_rng(seed + 1): integers(0, vocab, (B, S)) "
                          "or standard_normal((B, S, d_model)) for embeddings",
                "configs": {}}
    for i, name in enumerate(FIXTURE_CONFIGS):
        seed = 100 + i
        ans = reference_answers(name, seed)
        arrays = {k: ans[k] for k in ("tokens", "embeds", "greedy", "logits") if k in ans}
        np.savez(FIXTURE / f"{TRANSFORMER[name]}.npz", **arrays)
        manifest["configs"][name] = {"file": f"{TRANSFORMER[name]}.npz", "seed": seed,
                                     "checksums": ans["checksums"]}
    (FIXTURE / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")


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
    for k in ("tokens", "embeds"):
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
    batch = {k: fx[k] for k in ("tokens", "embeds") if k in fx}
    logits = tserve.teacher_forced(tb, tp, batch, fx["greedy"]).numpy()
    assert logits.shape == fx["logits"].shape
    assert rel_err(logits, fx["logits"]) < 1e-4
    np.testing.assert_array_equal(logits.argmax(-1).T, fx["greedy"])
    if "tokens" in fx:
        np.testing.assert_array_equal(
            tserve.generate(tb, tp, fx["tokens"], max_new=N), fx["greedy"])


# ---------------------------------------------------------------------------
# generate against the reference on carried-across weights
# ---------------------------------------------------------------------------

TOKEN_CONFIGS = sorted(n for n in TRANSFORMER if n != "llava-next-mistral-7b")


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
    write_fixture()
