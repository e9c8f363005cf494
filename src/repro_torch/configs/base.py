"""Architecture + run-shape configuration (the ``--arch`` registry backbone).

The port's copy of the reference's ``repro.configs.base``: the same fields
and defaults; ``pdtype`` / ``adtype`` name torch dtypes."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"no torch dtype named {name!r}")
    return dtype


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # attention
    causal: bool = True
    qk_norm: bool = False
    attn_bias: bool = False
    rope_theta: float = 1e4
    rope_theta_global: Optional[float] = None   # gemma3 global layers
    window: Optional[int] = None                # sliding window for local layers
    local_per_global: int = 0                   # N local : 1 global (0 = all global)
    attn_logit_softcap: Optional[float] = None
    q_chunk: int = 512
    kv_chunk: int = 512
    flash_unroll: bool = False   # unrolled flash blocks (roofline measurement)

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    router_fn: str = "softmax"                  # softmax | sigmoid (deepseek)
    router_norm_topk: bool = False
    capacity_factor: float = 1.25

    # MLA (DeepSeek)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False                           # multi-token-prediction extra block

    # recurrent families
    block_pattern: Tuple[str, ...] = ()         # e.g. ("rg", "rg", "attn")
    lru_width: int = 0
    conv_width: int = 4
    rwkv_lora: int = 64
    rwkv_chunk: int = 16

    # enc-dec / frontends
    n_enc_layers: int = 0
    frontend: Optional[str] = None              # audio_stub | vision_stub
    n_frontend_tokens: int = 0
    frontend_dim: int = 0

    # norm / act / embeddings
    norm_type: str = "rmsnorm"                  # rmsnorm | layernorm_np
    act: str = "silu"
    tie_embeddings: bool = False
    embed_scale: bool = False                   # gemma multiplies by sqrt(d)

    # numerics
    param_dtype: str = "float32"
    activ_dtype: str = "float32"

    # distribution
    remat: bool = True
    scan_layers: bool = True

    @property
    def pdtype(self) -> torch.dtype:
        return _torch_dtype(self.param_dtype)

    @property
    def adtype(self) -> torch.dtype:
        return _torch_dtype(self.activ_dtype)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer mixer kind: attn | attn_local | rg | rwkv."""
        if self.family == "ssm":
            return ("rwkv",) * self.n_layers
        if self.block_pattern:
            pat = self.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        if self.local_per_global:
            # gemma3: N local then 1 global, repeating
            kinds = []
            for i in range(self.n_layers):
                kinds.append("attn" if (i % (self.local_per_global + 1) ==
                                        self.local_per_global) else "attn_local")
            return tuple(kinds)
        return ("attn",) * self.n_layers

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced config of the same family (smoke tests)."""
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode
    needs_subquadratic: bool = False


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode", needs_subquadratic=True)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Cell applicability (DESIGN.md §4)."""
    if shape.needs_subquadratic:
        kinds = cfg.layer_kinds()
        bounded = all(k in ("rg", "rwkv", "attn_local") for k in kinds)
        mostly_local = cfg.local_per_global > 0 or bounded
        if not (bounded or mostly_local):
            return False, ("pure full-attention arch: 500k-token decode cache "
                           "is unbounded; skipped per brief")
    return True, ""
