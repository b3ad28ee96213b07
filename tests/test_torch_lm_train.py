"""The LM half's training path, the port against the JAX package on the CPU.

The token and embedding pipelines (byte-equal batches), ``lr_schedule``
(1 float32 ULP), ``AdamW`` (3 steps on carried-across trees), the decay
mask on the stacked layout, int8 compression (bit-equal codes and
scales), the checkpoint's key paths, ``_chunked_ce``, llama's loss and
gradients, remat, and the reference's recorded training answers
(tests/fixtures/torch_lm/train.json,
regenerated by ``PYTHONPATH=src JAX_PLATFORMS=cpu python
tests/test_torch_lm_train.py``).  The losses and gradients of the other
configs are in ``test_torch_lm_train_{transformers,moe,families,whisper}.py``,
the train step and the trainer in ``test_torch_lm_train_steps.py``.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import ALL, jax_params_from_numpy, jax_to_numpy, rel_err, smoke_pair
from _torch_lm_train import (
    FIXTURE,
    FIXTURE_CONFIGS,
    FIXTURE_SEED,
    STEPS,
    answers,
    check_fixture_equals_reference,
    check_loss_and_grads,
    check_port_replays_fixture,
    check_remat_bit_equal,
    flat,
    reference_step_losses,
    weights,
)
from repro.data.tokens import EmbeddingPipeline as JEmbeddingPipeline
from repro.data.tokens import TokenPipeline as JTokenPipeline
from repro.models import transformer as jtransformer
from repro.models.registry import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch.checkpoint.ckpt import _leaves
from repro_torch.convert import (
    lm_decay_mask,
    lm_opt_state_to_numpy,
    lm_params_from_numpy,
    lm_params_to_numpy,
    lm_tree_from_numpy,
    lm_tree_to_numpy,
)
from repro_torch.data import EmbeddingPipeline, TokenPipeline
from repro_torch.models import transformer as ttransformer
from repro_torch.models.common import layout_shape, tree_tensors
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress

ROOT = Path(__file__).resolve().parents[1]
LM = sorted(n for n in ALL if n != "xtime-tabular")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def _same_bytes(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_token_pipeline_byte_equal(seed, n_hosts):
    kw = dict(vocab_size=512, global_batch=8, seq_len=80, seed=seed)  # >= 64: copy segments
    ref, port = JTokenPipeline(**kw), TokenPipeline(**kw)
    for step in (0, 3, 1000):
        _same_bytes(port.batch(step), ref.batch(step))
        for host in range(n_hosts):
            _same_bytes(port.host_batch(step, host, n_hosts), ref.host_batch(step, host, n_hosts))


@pytest.mark.parametrize("kind", ["vlm", "audio"])
def test_embedding_pipeline_byte_equal(kind):
    for seed in (0, 3):
        kw = dict(d_model=48, global_batch=3, seq_len=96, vocab_size=300, seed=seed)
        ref, port = JEmbeddingPipeline(**kw), EmbeddingPipeline(**kw)
        for step in (0, 5):
            _same_bytes(port.batch(step, kind=kind), ref.batch(step, kind=kind))


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

OPT_CONFIGS = [{}, dict(peak_lr=1e-2, warmup_steps=7, decay_steps=50, min_lr_ratio=0.05)]


@pytest.mark.parametrize("kw", OPT_CONFIGS)
def test_lr_schedule_within_one_ulp(kw):
    """Within 1 float32 ULP of the reference's lr, plus what 1 ULP of the
    float32 cosine becomes in it: XLA's and torch's cos may differ in the
    last bit, and ``1 + cos`` near cos = -1 magnifies that into a few ULPs
    of the lr.  The warmup (no transcendental) is exactly equal."""
    cfg = tadamw.AdamWConfig(**kw)
    steps = np.arange(0, 40, dtype=np.int32)
    steps = np.concatenate([steps, np.arange(40, cfg.decay_steps + 50, 97, dtype=np.int32)])
    ref = np.asarray(jadamw.lr_schedule(jadamw.AdamWConfig(**kw), jnp.asarray(steps)))
    got = tadamw.lr_schedule(cfg, torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32 and ref.dtype == np.float32
    warm = steps < cfg.warmup_steps
    assert np.array_equal(got[warm], ref[warm])
    prog = np.clip((steps - cfg.warmup_steps) / max(1, cfg.decay_steps - cfg.warmup_steps), 0, 1)
    cos_ulp = np.spacing(np.abs(np.cos(np.pi * prog)).astype(np.float32))
    tol = np.spacing(np.abs(ref)) + cfg.peak_lr * (1 - cfg.min_lr_ratio) * 0.5 * cos_ulp
    assert (np.abs(got - ref) <= tol).all()


def _grads_np(tree: dict, seed: int, dtype) -> dict:
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (0.05 * rng.standard_normal(a.shape)).astype(dtype), tree)


@pytest.mark.parametrize("moment_dtype,param_dtype,clip_norm",
                         [("float32", "float32", 0.5), ("bfloat16", "bfloat16", 1e3)])
def test_adamw_matches_reference(moment_dtype, param_dtype, clip_norm):
    """Three steps on the llama smoke config's carried-across params: params,
    m and v within rtol 2e-5 / atol 2e-6 of the JAX package's, lr and the
    gradient norm too (clip active in float32; in bfloat16 the clip scale
    is exactly 1, so the moments' bfloat16 rounding sees equal inputs)."""
    name = "llama3.2-3b"
    kw = dict(peak_lr=1e-2, warmup_steps=4, decay_steps=20, weight_decay=0.05,
              clip_norm=clip_norm, moment_dtype=moment_dtype)
    jcfg, tcfg = smoke_pair(name, dtype=param_dtype)
    tree = weights(name, param_dtype, 1)
    jb = jbuild(jcfg)
    jp = jax_params_from_numpy(jb, tree)
    tp = lm_params_from_numpy(tcfg, tree, device="cpu")
    jopt, topt = jadamw.AdamW(jadamw.AdamWConfig(**kw)), tadamw.AdamW(tadamw.AdamWConfig(**kw))
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = _grads_np(jax_to_numpy(jp), 10 + step, next(iter(jax.tree.leaves(tree))).dtype)
        jp, jstate, jm = jopt.update(jax_params_from_numpy(jb, g), jstate, jp)
        tp, tstate, tm = topt.update(lm_tree_from_numpy(tcfg, g, device="cpu"), tstate, tp)
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= np.spacing(np.float32(jm["lr"]))
        # sums of ~10^5 squares in another order: float32 rounding
        assert abs(float(tm["grad_norm"]) / float(jm["grad_norm"]) - 1) < 1e-5
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    got = {"params": lm_params_to_numpy(tp), **lm_opt_state_to_numpy(tstate)}
    ref = {"params": jax_to_numpy(jp), "m": jax_to_numpy(jstate["m"]),
           "v": jax_to_numpy(jstate["v"])}
    for part in ("params", "m", "v"):
        a, b = flat(got[part]), flat(ref[part])
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=2e-5, atol=2e-6, err_msg=f"{part}{k}")
    want = jnp.bfloat16 if moment_dtype == "bfloat16" else jnp.float32
    assert all(x.dtype == want for x in jax.tree.leaves(jstate["m"]))
    assert all(t.dtype == getattr(torch, moment_dtype) for t in tree_tensors(tstate["m"]))


@pytest.mark.parametrize("name", LM)
def test_decay_mask_equals_reference_on_the_stacked_layout(name):
    """Leaf by leaf the JAX package's ``_decay_mask``: decided on the stacked
    layout, where a per-layer norm scale is 2-D (decayed) and the top-level
    ``final_norm`` 1-D (not)."""
    jcfg, tcfg = smoke_pair(name)
    ref = flat(jax_to_numpy(jadamw._decay_mask(jbuild(jcfg).params_shape())))
    got = flat(lm_decay_mask(tbuild(tcfg, device="cpu").params_shape()))
    assert got == ref
    assert got["/final_norm"] == 0.0
    stacked_norms = [k for k in got if k.split("/")[-1] in ("ln1", "mamba_ln")
                     and not k.startswith("/shared/")]  # zamba2's one shared block
    assert stacked_norms and all(got[k] == 1.0 for k in stacked_norms)


@pytest.mark.parametrize("name", LM)
def test_checkpoint_keys_are_the_references(name):
    """The port's training state flattens to the JAX package's key paths and
    shapes (NamedTuple fields as ``.name``, stacks as one leaf), so either
    package restores the other's checkpoints."""
    jcfg, tcfg = smoke_pair(name)
    jparams = jbuild(jcfg).params_shape()
    jstate = {"params": jparams, "opt": {"m": jparams, "step": jax.ShapeDtypeStruct((), jnp.int32)}}
    ref = {jax.tree_util.keystr(p): tuple(x.shape)
           for p, x in jax.tree_util.tree_flatten_with_path(jstate)[0]}
    tree = tbuild(tcfg, device="cpu").params_shape().jax_layout()
    tstate = {"params": tree, "opt": {"m": tree, "step": torch.zeros((), dtype=torch.int32)}}
    got = {k: layout_shape(v) for k, v in _leaves(tstate)}
    assert list(got) == list(ref)  # the flatten order too
    assert got == ref


def test_compress_tree_bit_equal_codes_and_scales():
    """Two rounds with the residual carried: the int8 codes and the scales
    bit-equal, the residual within 1 float32 ULP; bfloat16 gradients too."""
    name = "llama3.2-3b"
    jcfg, tcfg = smoke_pair(name)
    tree = weights(name, "bfloat16", 2)
    jres, tres = None, None
    for step in range(2):
        g = _grads_np(tree, 20 + step, np.float32)
        g = jax.tree.map(lambda a, p: a.astype(p.dtype), g, tree)
        (jq, js), jres = jcompress.compress_tree(jax_params_from_numpy(jbuild(jcfg), g), jres)
        (tq, ts), tres = tcompress.compress_tree(lm_tree_from_numpy(tcfg, g, device="cpu"), tres)
        for a, b in ((lm_tree_to_numpy(tq), jax_to_numpy(jq)), (lm_tree_to_numpy(ts), jax_to_numpy(js))):
            fa, fb = flat(a), flat(b)
            assert set(fa) == set(fb)
            for k in fb:
                assert np.array_equal(fa[k], fb[k]), k
        ra, rb = flat(lm_tree_to_numpy(tres)), flat(jax_to_numpy(jres))
        for k in rb:
            assert (np.abs(ra[k] - rb[k]) <= np.spacing(np.abs(rb[k]).astype(np.float32))).all(), k
        back = tcompress.decompress_tree(tq, ts, lm_tree_from_numpy(tcfg, g, device="cpu"))
        jback = jcompress.decompress_tree(jq, js, jax_params_from_numpy(jbuild(jcfg), g))
        fa, fb = flat(lm_tree_to_numpy(back)), flat(jax_to_numpy(jback))
        for k in fb:
            assert np.array_equal(fa[k], fb[k]), k
    q, s = tcompress.quantize_int8(torch.linspace(-3.0, 2.0, 101))
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    assert float(s) == np.float32(3.0) / np.float32(127.0)


# ---------------------------------------------------------------------------
# the losses
# ---------------------------------------------------------------------------


def test_loss_and_grads():
    """llama3.2-3b at the smoke size: ``check_loss_and_grads``'s float32 and
    bfloat16 bounds (the other configs: test_torch_lm_train_{transformers,
    moe,families}.py)."""
    check_loss_and_grads("llama3.2-3b")


@pytest.mark.parametrize("masked", [False, True])
def test_chunked_ce_takes_the_chunked_branch(masked):
    """S = 1,024: two 512-token chunks on both sides, the loss within 1e-6
    and its gradients within 1e-5 of the reference's."""
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 1024, 24)).astype(np.float32)
    w = (rng.standard_normal((24, 300)) / 5).astype(np.float32)
    lab = rng.integers(0, 300, (2, 1024)).astype(np.int32)
    mask = (rng.random((2, 1024)) < 0.8).astype(np.float32) if masked else None

    def ref_fn(h, w):
        return jtransformer._chunked_ce(h, w, jnp.asarray(lab),
                                        None if mask is None else jnp.asarray(mask))

    ref, (rh, rw) = jax.value_and_grad(ref_fn, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    got = ttransformer._chunked_ce(th, tw, torch.from_numpy(lab),
                                   None if mask is None else torch.from_numpy(mask))
    gh, gw = torch.autograd.grad(got, (th, tw))
    assert abs(float(got.detach()) / float(ref) - 1) < 1e-6
    assert rel_err(gh.numpy(), rh) < 1e-5 and rel_err(gw.numpy(), rw) < 1e-5


def test_remat_gives_bit_equal_gradients():
    check_remat_bit_equal("llama3.2-3b")


# ---------------------------------------------------------------------------
# the reference's recorded answers
# ---------------------------------------------------------------------------


def write_fixture() -> None:
    from _torch_lm_train import B, FLASH_BLK, S

    out = {"note": "the JAX package's training answers on seeded_numpy_params(smoke, seed) "
                   "in float32 and lm_batch(cfg, seed) of tests/_torch_lm_batch.py",
           "batch": {"b": B, "s": S, "flash_blk": FLASH_BLK, "seed": FIXTURE_SEED},
           "configs": {n: answers(n) for n in FIXTURE_CONFIGS},
           "train_steps": {**STEPS, "losses": reference_step_losses()}}
    FIXTURE.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")


def test_train_fixture_is_small():
    assert FIXTURE.stat().st_size < 16 << 10


def test_train_fixture_equals_the_reference():
    check_fixture_equals_reference("llama3.2-3b")


def test_port_replays_the_train_fixture():
    check_port_replays_fixture("llama3.2-3b")


if __name__ == "__main__":
    write_fixture()
    print(f"wrote {FIXTURE}")
