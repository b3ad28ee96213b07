"""Config system: one frozen dataclass drives model build, sharding,
launcher, dry-run and smoke tests for every architecture (incl. the
paper's own `xtime-tabular` workload).

The port's copy of ``repro.config``, field for field (the machine with
the card has no ``repro``); ``repro_torch.configs`` registers the same 11
configs.

Shape cells (assignment): train_4k / prefill_32k / decode_32k / long_500k.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio | xtime
    # transformer dims
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads
    d_ff: int = 0
    vocab_size: int = 0
    # attention details
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0  # gemma3: different theta for global layers
    sliding_window: int = 0  # 0 -> full attention
    local_global_period: int = 0  # gemma3: 1 global layer every N (5 local : 1 global)
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    # activation / norm
    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0  # leading dense layers (deepseek-v3: 3)
    dense_d_ff: int = 0  # d_ff of those dense layers
    moe_dense_residual: bool = False  # arctic: parallel dense FFN residual
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # MLA (deepseek)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MTP (deepseek)
    mtp_depth: int = 0
    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 0  # P
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    shared_attn_period: int = 0  # zamba2: shared attn block every N mamba layers
    # RWKV6
    rwkv_head_dim: int = 0
    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    max_decoder_len: int = 0  # decoder positions for enc-dec shapes
    # modality frontend stub (vlm / audio): inputs are precomputed embeddings
    embeddings_input: bool = False
    # training
    dtype: str = "bfloat16"
    remat: bool = True
    # long-context applicability (assignment: skip long_500k for pure full attn)
    supports_long_context: bool = False
    # free-form notes (applicability, simplifications)
    notes: str = ""
    # source citation
    source: str = ""

    # -- derived ------------------------------------------------------------

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def shapes(self) -> list[ShapeCell]:
        """The assigned shape cells applicable to this architecture."""
        out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
        if self.supports_long_context:
            out.append(SHAPES["long_500k"])
        return out

    def replace(self, **kw: Any) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class XTimeConfig:
    """The paper's own workload as a framework config (11th arch)."""

    name: str = "xtime-tabular"
    family: str = "xtime"
    n_trees: int = 4096  # the paper's maximum ensemble constraint
    max_leaves: int = 256
    n_features: int = 130
    n_bins: int = 256
    n_classes: int = 8
    task: str = "multiclass"
    notes: str = "CAM rows sharded on `model`, batch on `data`(x`pod`)"

    def shapes(self) -> list[ShapeCell]:
        # serving batches: the engine is inference-only (as in the paper)
        return [
            ShapeCell("serve_32k", 1, 32768, "xtime"),
            ShapeCell("serve_1m", 1, 1_048_576, "xtime"),
        ]


# populated by repro_torch.configs at import time
_REGISTRY: dict[str, Any] = {}


def register(cfg: Any) -> Any:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> Any:
    import repro_torch.configs  # noqa: F401  (trigger registration)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)
