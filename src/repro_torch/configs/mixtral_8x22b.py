"""Mixtral 8x22B [moe] — 8 experts top-2, sliding-window attention
[arXiv:2401.04088].

56L, d_model=6144, 48 heads (GQA kv=8), d_ff=16384 per expert, vocab=32768.
"""
from repro_torch.configs.base import MOE, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32_768,
    group_pattern=(MOE,),
    attn_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    rope_theta=1_000_000.0,
)
