"""Mixtral 8x7B [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088].

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336 per expert, vocab=32000,
MoE 8 experts top-2, SWA window 4096 (per the assignment sheet).
"""
from repro_torch.configs.base import MOE, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32_000,
    group_pattern=(MOE,),
    attn_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    rope_theta=1_000_000.0,
)
