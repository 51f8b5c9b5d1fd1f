"""Config dataclasses for models, input shapes, and runtime.

Every assigned architecture gets one file in this package defining a
``ModelConfig`` with the exact dimensions from the assignment sheet (source
paper / model card cited in the module docstring). ``layer_groups`` describes
the repeated block pattern that ``models.model_zoo`` scans over — keeping the
HLO small enough for 1-core CPU AOT compiles of 88-layer models.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Block kinds understood by models.model_zoo
ATTN = "attn"                # self-attention (+ MLP)
ATTN_LOCAL = "attn_local"    # sliding-window self-attention (+ MLP)
ATTN_GLOBAL = "attn_global"  # full self-attention (+ MLP), used by alternating archs
MOE = "moe"                  # self-attention + MoE MLP
MAMBA = "mamba"              # Mamba2 SSM block
SHARED_ATTN = "shared_attn"  # attention block with SHARED weights (zamba2)
CROSS = "cross"              # cross-attention (+ MLP) consuming encoder/vision states
SLSTM = "slstm"              # xLSTM sLSTM block
MLSTM = "mlstm"              # xLSTM mLSTM block

BLOCK_KINDS = (ATTN, ATTN_LOCAL, ATTN_GLOBAL, MOE, MAMBA, SHARED_ATTN, CROSS,
               SLSTM, MLSTM)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int                  # total decoder blocks (== groups * len(group))
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # Layer pattern: the model scans `num_groups` copies of `group_pattern`.
    group_pattern: Tuple[str, ...] = (ATTN,)
    num_groups: int = 0              # filled in __post_init__ if 0

    # attention details
    attn_window: Optional[int] = None     # sliding-window size for ATTN_LOCAL
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mlp_type: str = "swiglu"              # swiglu | geglu | gelu

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    # expert parallelism: store experts EP-major as (E*r, d, f/r) with the
    # leading dim on "model" and dispatch tokens via all_to_all
    # (sharding/ep_moe.py). 0 = tensor-parallel MoE (baseline).
    moe_ep_shards: int = 0

    # SSM (mamba2) / xLSTM
    ssm_state_dim: int = 0
    ssm_num_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # VLM
    cross_attn_states: int = 0       # number of encoder/vision tokens
    vision_dim: int = 0              # raw patch-embedding dim before projector

    # audio / enc-dec
    encoder_layers: int = 0
    encoder_frames: int = 0          # audio frame count fed to the encoder

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # "int8": symmetric per-(head, slot) quantised KV cache — halves the
    # decode HBM roofline term (EXPERIMENTS.md §Perf iteration 1.4)
    kv_cache_dtype: str = "native"   # native | int8

    # set True (via replace) to force sliding-window KV for long_500k on
    # pure full-attention archs — the explicit variant flagged in DESIGN.md §4
    long_context_window: Optional[int] = None

    def __post_init__(self):
        if self.num_groups == 0:
            if self.num_layers % len(self.group_pattern):
                raise ValueError(
                    f"{self.name}: num_layers {self.num_layers} not a "
                    f"multiple of group_pattern {self.group_pattern}")
            object.__setattr__(self, "num_groups",
                               self.num_layers // len(self.group_pattern))
        if self.num_groups * len(self.group_pattern) != self.num_layers:
            raise ValueError(
                f"{self.name}: num_groups {self.num_groups} x pattern "
                f"{self.group_pattern} != num_layers {self.num_layers}")
        for k in self.group_pattern:
            if k not in BLOCK_KINDS:
                raise ValueError(f"{self.name}: unknown block kind {k!r} "
                                 f"(known: {sorted(BLOCK_KINDS)})")
        if self.num_heads and self.num_kv_heads:
            if self.num_heads % self.num_kv_heads:
                raise ValueError(
                    f"{self.name}: num_heads {self.num_heads} not a "
                    f"multiple of num_kv_heads {self.num_kv_heads}")

    # ---- convenience ----
    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_recurrent(self) -> bool:
        """True if decode state is O(1) in context length (no growing KV)."""
        return all(k in (MAMBA, SLSTM, MLSTM) for k in self.group_pattern)

    @property
    def has_quadratic_prefill(self) -> bool:
        return any(k in (ATTN, ATTN_GLOBAL, MOE, CROSS, SHARED_ATTN)
                   for k in self.group_pattern) and self.attn_window is None

    def reduced(self, *, layers: Optional[int] = None, d_model: int = 256,
                vocab: int = 512) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests (<=2 groups,
        d_model<=512, <=4 experts)."""
        pat = self.group_pattern
        groups = 1 if layers is None else max(1, layers // len(pat))
        heads = max(1, min(4, self.num_heads))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        hd = max(8, d_model // heads)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=groups * len(pat),
            num_groups=groups,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=d_model * 2 if self.d_ff else 0,
            vocab_size=vocab,
            num_experts=min(4, self.num_experts) if self.num_experts else 0,
            num_experts_per_tok=min(2, self.num_experts_per_tok)
            if self.num_experts_per_tok else 0,
            # dropless in smoke tests so prefix logits are length-invariant
            moe_capacity_factor=float(min(4, self.num_experts) or 1),
            ssm_state_dim=min(16, self.ssm_state_dim) if self.ssm_state_dim else 0,
            ssm_num_heads=min(2, self.ssm_num_heads) if self.ssm_num_heads else 0,
            ssm_head_dim=(d_model * self.ssm_expand) // max(1, min(2, self.ssm_num_heads))
            if self.ssm_num_heads else 0,
            ssm_chunk=64,
            attn_window=min(64, self.attn_window) if self.attn_window else None,
            cross_attn_states=min(16, self.cross_attn_states)
            if self.cross_attn_states else 0,
            vision_dim=min(64, self.vision_dim) if self.vision_dim else 0,
            encoder_layers=min(2, self.encoder_layers) if self.encoder_layers else 0,
            encoder_frames=min(32, self.encoder_frames) if self.encoder_frames else 0,
            dtype="float32",
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


INPUT_SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}
