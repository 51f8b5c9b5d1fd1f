"""Zamba2-2.7B [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

54 blocks, d_model=2560, attention 32 heads (kv=32), d_ff=10240, vocab=32000,
ssm_state=64. Layout: each scanned group is 5 Mamba2 blocks followed by one
SHARED attention block (the attention weights are a single set reused by
every shared_attn position — Zamba2's defining trick), 9 groups = 54 blocks
(45 mamba + 9 shared-attn applications).
"""
from repro_torch.configs.base import MAMBA, SHARED_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32_000,
    group_pattern=(MAMBA,) * 5 + (SHARED_ATTN,),
    ssm_state_dim=64,
    ssm_num_heads=80,      # d_inner (=2*2560=5120) / ssm_head_dim 64
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
)
