"""Gemma 2B [dense] — GeGLU, head_dim=256, MQA (kv=1) [arXiv:2403.08295].

18L, d_model=2048, 8 heads (kv=1), d_ff=16384, vocab=256000.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256_000,
    group_pattern=(ATTN,),
    mlp_type="geglu",
    rope_theta=10_000.0,
    norm_eps=1e-6,
    tie_embeddings=True,
)
