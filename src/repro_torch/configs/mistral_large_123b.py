"""Mistral-Large 123B [dense] [hf:mistralai/Mistral-Large-Instruct-2407].

88L, d_model=12288, 96 heads (GQA kv=8), d_ff=28672, vocab=32768. The
memory-pressure stressor of the assigned pool — FSDPxTP sharding essential.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32_768,
    group_pattern=(ATTN,),
    rope_theta=1_000_000.0,
)
