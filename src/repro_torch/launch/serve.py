"""Batched serving: prefill -> a decode loop with sampling.

The port of ``repro.launch.serve`` (the shard_map flash-decode variant
waits for the LM mesh).  Eager PyTorch under ``torch.inference_mode()``:
no jit and no ``torch.compile``.  On the card unless ``--device cpu``.

CLI:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --scale 0.05 --batch 4 --prompt-len 64 --max-new 32 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import get_config
from repro_torch.launch.train import _scaled
from repro_torch.models.registry import LMBundle, build_model


def _pad_cache_seq(cfg, cache, prefill_len: int, total_len: int):
    """Grow every per-position cache leaf from prefill_len to total_len.

    The transformer's segment leaves grow where axis 2 is the prompt's
    length, as in the reference.  Of the hybrid's and whisper's dicts only
    the self-attention ``k``/``v`` grow.  The reference pads every leaf
    of ndim >= 4 whose axis 2 equals the prompt length, which also catches
    the hybrid's ``ssm``/``conv`` when B == S (axis 2 is their batch) and
    whisper's cross cache ``xk``/``xv`` when T == S (whose zero keys are
    then attended); the port does not (a deliberate difference).  rwkv's
    recurrent state has no positions."""
    extra = total_len - prefill_len

    def pad(leaf):
        if leaf.ndim >= 4 and leaf.shape[2] == prefill_len:
            return F.pad(leaf, [0, 0] * (leaf.ndim - 3) + [0, extra])
        return leaf

    if cfg.family == "ssm":
        return cache  # recurrent state only
    if isinstance(cache, dict):  # hybrid, audio
        return {k: pad(v) if k in ("k", "v") else v for k, v in cache.items()}
    return [tuple(pad(leaf) for leaf in seg) for seg in cache]


def _on(dev: torch.device, x) -> torch.Tensor:
    """``x`` (a tensor or an array) as a tensor on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.asarray(x), device=dev)


def generate(
    bundle: LMBundle,
    params,
    tokens,  # (B, S) prompt: a tensor or an integer array
    *,
    max_new: int,
    temperature: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """Greedy / temperature sampling.  Returns (B, max_new) int32 new tokens.

    Greedy is the argmax of the float32 logits (ties to the lower index,
    as the reference).  Temperature sampling draws from a
    ``torch.Generator`` seeded with ``seed`` on the model's device; it
    cannot reproduce the bits of the JAX package's
    ``jax.random.categorical`` draws, only their distribution.
    """
    cfg = bundle.cfg
    dev = bundle.device
    with torch.inference_mode():
        tokens = _on(dev, tokens).long()
        b, s = tokens.shape
        logits, cache = bundle.prefill(params, {"tokens": tokens})
        cache = _pad_cache_seq(cfg, cache, s, s + max_new)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))

        def sample(logits):
            if temperature <= 0.0:
                return torch.argmax(logits, dim=-1)
            probs = torch.softmax(logits / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen)[:, 0]

        out = [sample(logits)]
        for i in range(max_new - 1):
            logits, cache = bundle.decode_step(params, cache, out[-1], s + i)
            out.append(sample(logits))
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()


def teacher_forced(bundle: LMBundle, params, batch: dict, tokens) -> torch.Tensor:
    """The logits of a decode fed ``tokens`` (B, N) after the prompt
    ``batch`` ({'tokens' (B, S)}, {'embeds' (B, S, d)} or whisper's
    {'frames' (B, T, d), 'tokens' (B, S)}): step 0 is the prefill's
    last-token logits, step i the decode of ``tokens[:, i-1]`` at position
    S+i-1.  Returns (N, B, V) float32 on the model's device; with a greedy
    run's tokens, step i's argmax is its token i."""
    dev = bundle.device
    with torch.inference_mode():
        batch = {k: _on(dev, v) for k, v in batch.items()}
        tokens = _on(dev, tokens).long()
        s = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[1]
        n = tokens.shape[1]
        logits, cache = bundle.prefill(params, batch)
        cache = _pad_cache_seq(bundle.cfg, cache, s, s + n)
        out = [logits]
        for i in range(n - 1):
            logits, cache = bundle.decode_step(params, cache, tokens[:, i], s + i)
            out.append(logits)
        return torch.stack(out)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run there)")
    args = ap.parse_args(argv)

    cfg = _scaled(get_config(args.arch), args.scale)
    bundle = build_model(cfg, device=args.device)
    params = bundle.init_params(0)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    t0 = time.time()
    toks = generate(bundle, params, prompts, max_new=args.max_new,
                    temperature=args.temperature)
    dt = time.time() - t0
    total = args.batch * args.max_new
    print(f"generated {toks.shape} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s); sample row: {toks[0][:16].tolist()}")


if __name__ == "__main__":
    main()
