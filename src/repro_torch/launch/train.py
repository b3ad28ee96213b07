"""Training driver: data pipeline -> train step -> fault-tolerant loop with
async checkpoints — the port of ``repro.launch.train``.

Eager PyTorch (no ``torch.compile``), on the card unless ``device="cpu"``
(``--device cpu``).  Gradients come from ``torch.autograd.grad`` of the
model's ``loss_fn`` in the parameters' JAX layout; ``AdamW`` writes the new
parameters and moments in place.  The state the runner checkpoints is
that layout ({'params', 'opt': {'m', 'v', 'step'}, 'residual'}), so a
checkpoint written by either package resumes in the other.  The LM mesh
is not ported yet: ``mesh=`` and ``--use-mesh`` raise.

CLI:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --steps 50 --global-batch 8 --seq 256 --scale 0.05 [--device cpu]
``--scale`` shrinks width/depth for small runs (examples use it); the
config dims stay exact when --scale 1.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Any

import numpy as np
import torch

from repro_torch.config import get_config
from repro_torch.data.tokens import EmbeddingPipeline, TokenPipeline
from repro_torch.ft.runtime import FaultTolerantRunner
from repro_torch.models import common
from repro_torch.models.common import stack_map, tree_like, tree_map, tree_tensors, tree_zeros
from repro_torch.models.registry import LMBundle, build_model
from repro_torch.optim.adamw import AdamW, AdamWConfig
from repro_torch.optim.compress import compress_tree, decompress_tree

NO_MESH = ("the LM mesh (sharding/partition.py, models/decode_opt.py, "
           "models/moe_shardmap.py) is not ported yet: ROADMAP.md queue 1 item 3.4")


def loss_and_grads(bundle: LMBundle, params, batch: dict) -> tuple:
    """(loss, metrics, gradients) of ``bundle.loss_fn`` at ``params`` (a
    params module): the gradients in the parameters' JAX layout, zeros
    for a parameter the loss does not reach (the JAX package's
    ``value_and_grad(loss_fn, has_aux=True)``)."""
    tree = params.jax_layout()
    leaves = tree_tensors(tree)
    loss, metrics = bundle.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, tree_like(tree, grads)


def make_train_step(bundle: LMBundle, opt: AdamW, mesh=None, *,
                    microbatch: int = 0, compress: bool = False):
    """Returns (params, opt_state, residual, batch) -> (params, opt_state,
    residual, metrics); ``params`` is the model's params module, updated
    in place.

    ``microbatch`` > 1 splits the batch into that many accumulation steps,
    their gradients summed in float32 and divided by ``microbatch``.
    ``compress`` int8-quantizes gradients with error feedback before the
    optimizer (the compressed cross-pod reduction's wire format).
    """
    if mesh is not None:
        raise NotImplementedError(f"make_train_step(mesh=...): {NO_MESH}")

    def step(params, opt_state, residual, batch):
        if microbatch and microbatch > 1:
            n = next(iter(batch.values())).shape[0] // microbatch
            acc = tree_zeros(params.jax_layout(), torch.float32)
            loss_sum = torch.zeros((), dtype=torch.float32, device=bundle.device)
            for i in range(microbatch):
                loss, _, g = loss_and_grads(
                    bundle, params, {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
                for a, gg in zip(tree_tensors(acc), tree_tensors(g), strict=True):
                    a.add_(gg)
                loss_sum = loss_sum + loss
                del g  # freed before the next microbatch's backward
            grads = tree_map(lambda a: stack_map(lambda t: t / microbatch, a), acc)
            loss = loss_sum / microbatch
        else:
            loss, _, grads = loss_and_grads(bundle, params, batch)

        if compress:
            (q, s), residual = compress_tree(grads, residual)
            grads = decompress_tree(q, s, grads)
        params, opt_state, om = opt.update(grads, opt_state, params)
        return params, opt_state, residual, {"loss": loss, **om}

    return step


def on_device(batch: dict, device, dtype: torch.dtype) -> dict:
    """A numpy batch as tensors on ``device``: integers as int64, floats
    (embeddings, frames) in the model's ``dtype`` (torch does not promote
    a float32 input against bfloat16 weights as JAX does)."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = torch.as_tensor(v).to(device, torch.int64 if v.dtype.kind in "iu" else dtype)
    return out


def batch_source(cfg, global_batch: int, seq_len: int, seed: int):
    """The trainer's data: step -> numpy batch (token pipeline, or the
    embedding pipeline for vlm/audio configs), a pure function of (seed,
    step)."""
    if cfg.embeddings_input or cfg.is_encoder_decoder:
        pipe: Any = EmbeddingPipeline(
            d_model=cfg.d_model, global_batch=global_batch, seq_len=seq_len,
            vocab_size=cfg.vocab_size, seed=seed,
        )
        kind = "audio" if cfg.is_encoder_decoder else "vlm"
        return lambda step: pipe.batch(step, kind=kind)
    return TokenPipeline(cfg.vocab_size, global_batch, seq_len, seed=seed).batch


def train(
    cfg,
    *,
    steps: int,
    global_batch: int,
    seq_len: int,
    run_dir: str,
    mesh=None,
    ckpt_every: int = 20,
    microbatch: int = 0,
    compress: bool = False,
    failure_at: int | None = None,
    seed: int = 0,
    opt_cfg: AdamWConfig | None = None,
    log_every: int = 10,
    device=None,
) -> list[dict]:
    """Fault-tolerant training loop on ``device`` (None: the card, which
    raises where torch sees none).  Returns per-step metric history."""
    if mesh is not None:
        raise NotImplementedError(f"train(mesh=...): {NO_MESH}")
    bundle = build_model(cfg, device=device)
    dtype = common.dtype_of(cfg.dtype)
    opt = AdamW(opt_cfg or AdamWConfig(warmup_steps=max(5, steps // 20),
                                       decay_steps=steps))
    get_batch = batch_source(cfg, global_batch, seq_len, seed)
    step_fn = make_train_step(bundle, opt, microbatch=microbatch, compress=compress)
    live: dict = {}  # the params module of the state the runner holds

    def init_state():
        params = bundle.init_params(seed)
        live["params"] = params
        tree = params.jax_layout()
        residual = (tree_zeros(tree, torch.float32) if compress
                    else {"none": torch.zeros((), device=bundle.device)})
        return {"params": tree, "opt": opt.init(tree), "residual": residual}

    def one_step(state, step):
        batch = on_device(get_batch(step), bundle.device, dtype)
        _, opt_state, residual, metrics = step_fn(
            live["params"], state["opt"], state["residual"], batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        return {"params": state["params"], "opt": opt_state, "residual": residual}, metrics

    def placer(state):
        # a restored checkpoint's parameters into the module's tensors
        tree = live["params"].jax_layout()
        with torch.no_grad():
            for dst, src in zip(tree_tensors(tree), tree_tensors(state["params"]), strict=True):
                dst.copy_(src)
        return {**state, "params": tree}

    runner = FaultTolerantRunner(run_dir, one_step, init_state, ckpt_every=ckpt_every)

    def on_metrics(step, m):
        if step % log_every == 0 or step == steps - 1:
            line = {k: (round(v, 4) if isinstance(v, float) else v)
                    for k, v in m.items() if k in ("step", "loss", "lr", "dt")}
            print(json.dumps(line), flush=True)

    _state, history = runner.run(
        steps, failure_at=failure_at, placer=placer, on_metrics=on_metrics
    )
    return history


def _scaled(cfg, scale: float):
    """A config cut to ``scale`` of its widths and depth (``scale`` >= 1:
    the config itself)."""
    if scale >= 1.0:
        return cfg
    d = max(64, int(cfg.d_model * scale) // 16 * 16)
    heads = max(2, int(cfg.n_heads * scale))
    while d % heads:
        heads -= 1
    kv = max(1, min(cfg.n_kv_heads, heads))
    while heads % kv:
        kv -= 1
    return cfg.replace(
        n_layers=max(2, int(cfg.n_layers * scale)),
        d_model=d, n_heads=heads, n_kv_heads=kv, head_dim=0,
        d_ff=max(128, int(cfg.d_ff * scale) // 16 * 16),
        vocab_size=min(cfg.vocab_size, 8192),
    )


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--run-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--use-mesh", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run there)")
    args = ap.parse_args(argv)
    if args.use_mesh:
        raise SystemExit(f"--use-mesh: {NO_MESH}")

    cfg = _scaled(get_config(args.arch), args.scale)
    t0 = time.time()
    hist = train(
        cfg, steps=args.steps, global_batch=args.global_batch,
        seq_len=args.seq, run_dir=args.run_dir,
        ckpt_every=args.ckpt_every, microbatch=args.microbatch,
        compress=args.compress, device=args.device,
    )
    print(f"done: {len(hist)} steps in {time.time()-t0:.1f}s; "
          f"loss {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f}")


if __name__ == "__main__":
    main()
