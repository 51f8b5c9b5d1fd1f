"""Qwen2-1.5B [dense] — GQA with QKV bias [arXiv:2407.10671].

28L, d_model=1536, 12 heads (GQA kv=2), d_ff=8960, vocab=151936.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    group_pattern=(ATTN,),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
    tie_embeddings=True,
)
