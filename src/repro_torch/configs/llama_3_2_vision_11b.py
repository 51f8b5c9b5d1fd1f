"""Llama-3.2-Vision 11B [vlm] — text decoder with cross-attention image layers
[hf:meta-llama/Llama-3.2-11B-Vision].

40L, d_model=4096, 32 heads (GQA kv=8), d_ff=14336, vocab=128256. Every 5th
layer is a gated cross-attention layer over projected vision-patch embeddings.
Per the assignment carve-out, the ViT vision frontend is a STUB:
``input_specs`` provides precomputed patch embeddings of shape
(batch, cross_attn_states, vision_dim); the in-model projector maps
vision_dim -> d_model.
"""
from repro_torch.configs.base import ATTN, CROSS, ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128_256,
    group_pattern=(ATTN, ATTN, ATTN, ATTN, CROSS),
    rope_theta=500_000.0,
    cross_attn_states=4096,   # ~4 image tiles x ~1600 patches, rounded for sharding
    vision_dim=1280,          # ViT-H patch embedding width
)
