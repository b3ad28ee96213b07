"""Uniform model bundle: config -> (init, loss, prefill, decode, specs).

The port of ``repro.models.registry``.  ``build_model(cfg)`` returns an
``LMBundle`` whose members are what the trainer and the server consume,
on the card unless ``device="cpu"`` is given.  The shape stand-ins of the JAX bundle
(``params_shape``, ``cache_shape``, ``input_specs``) are tensors on the
``meta`` device.  Every LM family is served: dense, moe and vlm by
``TransformerLM``, hybrid (zamba2) by ``HybridLM``, ssm (rwkv6) by
``RWKVLM`` and audio (whisper) by ``EncDecLM``.  A model's cache is the
reference's: a list of per-segment (k, v) tuples, the hybrid's and
whisper's dicts, rwkv's 3-tuple.  ``loss_fn(params, batch)`` returns
(loss, metrics) with the reference's metric keys, for every family.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.config import ModelConfig, ShapeCell
from repro_torch.core.engine import resolve_device
from repro_torch.models import common
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.rwkv_model import RWKVLM
from repro_torch.models.transformer import TransformerLM

META = torch.device("meta")


@dataclass
class LMBundle:
    cfg: ModelConfig
    model: Any
    init_params: Callable  # (seed) -> params module on the model's device
    loss_fn: Callable  # (params, batch) -> (loss, metrics)
    prefill: Callable  # (params, batch) -> (logits, cache)
    decode_step: Callable  # (params, cache, token, pos) -> (logits, cache)
    init_cache: Callable  # (batch, seq) -> cache

    @property
    def device(self) -> torch.device:
        return self.model.device

    # -- shape stand-ins (meta device) ----------------------------------------

    def params_shape(self):
        return self.model.empty_params(device=META)

    def cache_shape(self, batch: int, seq: int):
        return self.model.init_cache(batch, seq, device=META)

    def input_specs(self, cell: ShapeCell) -> dict:
        """Meta-device stand-ins for every input of one (arch x shape) cell."""
        cfg = self.cfg
        b, s = cell.global_batch, cell.seq_len
        dt = common.dtype_of(cfg.dtype)

        def spec(shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device=META)

        if cell.kind == "decode":  # one new token against a seq_len cache
            return {"cache": self.cache_shape(b, s), "token": spec((b,)),
                    "pos": spec(())}
        out = {}
        if cfg.is_encoder_decoder:
            sd = max(64, s // 8)  # decoder tokens per frame window
            out = {"frames": spec((b, s, cfg.d_model), dt), "tokens": spec((b, sd))}
            lab = (b, sd)
        elif cfg.embeddings_input:
            out = {"embeds": spec((b, s, cfg.d_model), dt)}
            lab = (b, s)
        else:
            out = {"tokens": spec((b, s))}
            lab = (b, s)
        if cell.kind == "train":
            out["labels"] = spec(lab)
        return out


def lm_model(cfg: ModelConfig, flash_blk: int = 512, *, device: torch.device):
    """The model object of ``cfg``'s family on ``device`` (not resolved:
    'meta' gives shape stand-ins)."""
    if cfg.family == "hybrid":
        return HybridLM(cfg, flash_blk, device=device)
    if cfg.family == "ssm":
        return RWKVLM(cfg, device=device)
    if cfg.family == "audio":
        return EncDecLM(cfg, flash_blk, device=device)
    return TransformerLM(cfg, flash_blk, device=device)  # dense | moe | vlm


def build_model(cfg: ModelConfig, flash_blk: int = 512, *, device=None) -> LMBundle:
    """The bundle of ``cfg``'s model on ``device`` (None: the card, which
    raises where torch sees none)."""
    m = lm_model(cfg, flash_blk, device=resolve_device(device))
    return LMBundle(
        cfg=cfg,
        model=m,
        init_params=m.init_params,
        loss_fn=m.loss_fn,
        prefill=m.prefill,
        decode_step=m.decode_step,
        init_cache=m.init_cache,
    )
