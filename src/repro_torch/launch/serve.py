"""Batched serving: prefill -> a decode loop with sampling.

The port of ``repro.launch.serve``.  Eager PyTorch under
``torch.inference_mode()``: no jit and no ``torch.compile``.  On the card
unless ``--device cpu``.

On a mesh (``generate(..., mesh=)``, parameters placed by
``launch.train.place_params``) a step is one explicit program driven
from this process, the serving counterpart of ``launch.train.MeshStep``
(``MeshServe``). Every LM family (``launch.train.SPLIT_FAMILIES``: the
transformers, zamba2's hybrid, rwkv6's ssm and whisper's encoder-decoder)
runs the split program (``repro_torch.sharding.split``): device (g, m)
computes data group g's rows with model slice m of every weight, each
layer's `fsdp` blocks gathered just before use, the data groups in
lockstep a layer at a time (an MoE layer routes each group with the
whole batch's capacity and ranks, ``GroupRouting(lockstep=True)``, so the
drops are one device's); the cache is allocated at its final length
(prompt and new tokens) in ``cache_pspecs``'s layout, ``Sharded``
leaves: KV heads on `model` where they divide it, else the sequence (the
MLA latents always: the exact flash merge over each device's chunk of
positions), else whole on every device; whisper's cross cache
``xk``/``xv`` (L, B, T, KV, D) the same way over its T frames (by KV
heads, else T chunks, else whole), written by the prefill and read by
every decode step, its self cache ``k``/``v`` at the final length (the
leaves ``_pad_cache_seq`` grows); the recurrent states by heads on
`model` where M divides the heads, else whole, and the conv tails and
x_prev whole and equal on every device. The last-token logits are
gathered to the mesh's first device, where the next token is drawn.

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
from repro_torch.launch.mesh import check_mesh
from repro_torch.launch.train import SPLIT_FAMILIES, GroupRouting, _scaled
from repro_torch.models.registry import LMBundle, build_model
from repro_torch.sharding.partition import MeshAxes, batch_pspec
from repro_torch.sharding.placement import Sharded
from repro_torch.sharding.split import Split, position


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


def _prompt_len(batch: dict) -> int:
    """The prompt's positions: its tokens' (whisper's decoder tokens beside
    its frames), or its embeddings'."""
    return (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[1]


def _on(dev: torch.device, x) -> torch.Tensor:
    """``x`` (a tensor or an array) as a tensor on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.asarray(x), device=dev)


def generate(
    bundle: LMBundle,
    params,
    tokens,  # (B, S) prompt: a tensor, an integer array or a placed batch's Sharded
    *,
    max_new: int,
    temperature: float = 0.0,
    seed: int = 0,
    mesh=None,
) -> np.ndarray:
    """Greedy / temperature sampling.  Returns (B, max_new) int32 new tokens.

    Greedy is the argmax of the float32 logits (ties to the lower index,
    as the reference).  Temperature sampling draws from a
    ``torch.Generator`` seeded with ``seed`` on the model's device; it
    cannot reproduce the bits of the JAX package's
    ``jax.random.categorical`` draws, only their distribution.  ``mesh``
    set: ``params`` placed by ``place_params`` on it, the steps
    ``MeshServe``'s.
    """
    cfg = bundle.cfg
    serve = None if mesh is None else MeshServe(bundle, mesh)
    dev = bundle.device if serve is None else serve.first
    with torch.inference_mode():
        if isinstance(tokens, Sharded):
            tokens = tokens.gather(dev)
        tokens = _on(dev, tokens).long()
        b, s = tokens.shape
        if serve is None:
            logits, cache = bundle.prefill(params, {"tokens": tokens})
            cache = _pad_cache_seq(cfg, cache, s, s + max_new)
            step = bundle.decode_step
        else:
            logits, cache = serve.prefill(params, {"tokens": tokens}, s + max_new)
            step = serve.decode_step
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))

        def sample(logits):
            if temperature <= 0.0:
                return torch.argmax(logits, dim=-1)
            probs = torch.softmax(logits / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=gen)[:, 0]

        out = [sample(logits)]
        for i in range(max_new - 1):
            logits, cache = step(params, cache, out[-1], s + i)
            out.append(sample(logits))
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()


class MeshServe:
    """The mesh serve program (see the module docstring): ``prefill(params,
    batch, total_len)`` and ``decode_step(params, cache, token, pos)`` with
    ``params`` placed by ``place_params`` and the batch whole tensors (or
    ``place_batch``'s), the logits (B, V) float32 on ``first``, the mesh's
    first device.  ``routing``: the last call's MoE routing (its
    ``dropped``); ``drops()`` sums it a layer over the row blocks.
    ``groups`` and ``only`` (the dry run's solo trace): compute only those
    data groups, and only that model device of each.  ``split``: the split
    program serves the family (every LM family's; another raises)."""

    def __init__(self, bundle: LMBundle, mesh):
        self.bundle, self.mesh = bundle, check_mesh(mesh)
        self.split = bundle.cfg.family in SPLIT_FAMILIES
        if not self.split:
            raise ValueError(f"the {bundle.cfg.family} family has no split serve program")
        self.routing = None
        axes = MeshAxes(self.mesh)
        self.n_groups = int(np.prod([axes.axis_size(a) for a in axes.batch_axes()],
                                    dtype=np.int64))
        self.first = self.mesh.devices.flat[0]

    def blocks(self, b: int) -> tuple[list[int], int]:
        """Each data group's block of ``b`` rows under the fitted batch
        spec, and the block count (1 where the spec is dropped: every group
        computes the whole batch)."""
        axes = MeshAxes(self.mesh)
        entry = tuple(axes.fit(tuple(batch_pspec(axes)), (b,)))[0]
        names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        sizes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        out = []
        for g in range(self.n_groups):
            at = dict(zip(self.mesh.axis_names, position(self.mesh, g, 0)))
            blk = 0
            for a in names:
                blk = blk * sizes[a] + at[a]
            out.append(blk)
        return out, int(np.prod([sizes[a] for a in names], dtype=np.int64))

    def _rows(self, t: torch.Tensor, g: int, blocks, n_blocks: int) -> torch.Tensor:
        n = t.shape[0] // n_blocks
        return t[blocks[g] * n:(blocks[g] + 1) * n]

    def _splits(self, seq: int, groups, only, rows=None) -> list[Split]:
        active = None if only is None else [only]
        return [Split(self.mesh, g, seq, routing=self.routing, active=active, rows=rows)
                for g in groups]

    def _whole(self, t) -> torch.Tensor:
        return t.gather(self.first) if isinstance(t, Sharded) else _on(self.first, t)

    def _logits(self, parts: list, groups, blocks) -> torch.Tensor:
        """The groups' logits on ``first``, one group a row block."""
        seen, out = set(), []
        for g, t in zip(groups, parts):
            if blocks[g] not in seen:
                seen.add(blocks[g])
                out.append(t.to(self.first))
        return torch.cat(out)

    def _routing(self, blocks) -> None:
        self.routing = (GroupRouting(self.n_groups, lockstep=True, blocks=blocks)
                        if self.bundle.cfg.is_moe else None)

    def drops(self) -> list[int]:
        """The last call's dropped assignments a MoE layer (layer order),
        summed over the row blocks."""
        if self.routing is None:
            return []
        by: dict = {}
        first = {}
        for (g, key), n in self.routing.dropped.items():
            blk = self.routing.blocks[g]
            if first.setdefault((blk, key), g) == g:
                by[key] = by.get(key, 0) + int(n)
        return [by[k] for k in sorted(by)]

    @torch.no_grad()
    def prefill(self, params, batch: dict, total_len: int | None = None, *, groups=None,
                only=None, cache=None):
        """Each group's prefill of its rows of ``batch``; returns (logits
        (B, V) on ``first``, the cache, of ``total_len`` positions (default
        the prompt's; whisper's cross cache of its frames' T))."""
        batch = {k: self._whole(v) for k, v in batch.items()}
        first = next(iter(batch.values()))
        b, s = first.shape[0], _prompt_len(batch)
        blocks, n_blocks = self.blocks(b)
        groups = list(range(self.n_groups)) if groups is None else list(groups)
        part = {g: {k: self._rows(v, g, blocks, n_blocks) for k, v in batch.items()}
                for g in groups}
        total = s if total_len is None else int(total_len)
        self._routing(blocks)
        if cache is None:
            frames = {"enc_len": batch["frames"].shape[1]} if "frames" in batch else {}
            cache = self.bundle.model.init_cache(b, total, mesh=self.mesh, **frames)
        sps = self._splits(s, groups, only)
        logits, cache = self.bundle.model.prefill(
            params, [{k: v.to(sp.devices[sp.root]) for k, v in part[g].items()}
                     for g, sp in zip(groups, sps)], sp=sps, cache=cache)
        return self._logits(logits, groups, blocks), cache

    @torch.no_grad()
    def decode_step(self, params, cache, token, pos: int, *, groups=None, only=None):
        """Each group's decode of its rows of ``token`` (B,) at ``pos``: the
        logits (B, V) on ``first`` and the cache, written in place."""
        token = self._whole(token)
        blocks, n_blocks = self.blocks(token.shape[0])
        groups = list(range(self.n_groups)) if groups is None else list(groups)
        self._routing(blocks)
        m_last = MeshAxes(self.mesh).axis_size(MeshAxes(self.mesh).model) - 1
        sps = self._splits(1, groups, only, rows=[0] * m_last + [1])
        logits, cache = self.bundle.model.decode_step(
            params, cache, [self._rows(token, g, blocks, n_blocks).to(sp.devices[sp.root])
                            for g, sp in zip(groups, sps)], pos, sp=sps)
        return self._logits(logits, groups, blocks), cache


def teacher_forced(bundle: LMBundle, params, batch: dict, tokens, mesh=None) -> torch.Tensor:
    """The logits of a decode fed ``tokens`` (B, N) after the prompt
    ``batch`` ({'tokens' (B, S)}, {'embeds' (B, S, d)} or whisper's
    {'frames' (B, T, d), 'tokens' (B, S)}): step 0 is the prefill's
    last-token logits, step i the decode of ``tokens[:, i-1]`` at position
    S+i-1.  Returns (N, B, V) float32 on the model's device; with a greedy
    run's tokens, step i's argmax is its token i.  ``mesh`` set: ``params``
    placed by ``place_params`` on it, the steps ``MeshServe``'s, the logits
    on the mesh's first device."""
    serve = None if mesh is None else MeshServe(bundle, mesh)
    dev = bundle.device if serve is None else serve.first
    with torch.inference_mode():
        batch = {k: _on(dev, v) for k, v in batch.items()}
        tokens = _on(dev, tokens).long()
        s, n = _prompt_len(batch), tokens.shape[1]
        if serve is None:
            logits, cache = bundle.prefill(params, batch)
            cache = _pad_cache_seq(bundle.cfg, cache, s, s + n)
            step = bundle.decode_step
        else:
            logits, cache = serve.prefill(params, batch, s + n)
            step = serve.decode_step
        out = [logits]
        for i in range(n - 1):
            logits, cache = step(params, cache, tokens[:, i], s + i)
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
