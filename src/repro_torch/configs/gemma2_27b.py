"""Gemma-2 27B [dense] — local+global alternating attention, logit softcaps
[arXiv:2408.00118].

46L, d_model=4608, 32 heads (GQA kv=16), d_ff=36864, vocab=256000.
head_dim=128 (model card; 32*128 != d_model — Gemma2 projects q/k/v
independently of d_model). Sliding window 4096 on local layers, attention
logit softcap 50.0, final logit softcap 30.0, GeGLU MLP.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256_000,
    group_pattern=(ATTN_LOCAL, ATTN_GLOBAL),
    attn_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_type="geglu",
    rope_theta=10_000.0,
    norm_eps=1e-6,
    tie_embeddings=True,
)
