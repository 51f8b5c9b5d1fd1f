"""xLSTM-350M [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].

24L, d_model=1024, 4 heads (kv=4), d_ff=0 (xLSTM blocks carry their own
up/down projections), vocab=50304. Block ratio follows the paper's xLSTM[7:1]
recipe: each scanned group is 7 mLSTM + 1 sLSTM blocks, 3 groups = 24 layers.
Decode state is O(1) in context (matrix memory + scalar cell states).
"""
from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    group_pattern=(MLSTM,) * 7 + (SLSTM,),
    ssm_num_heads=4,
    ssm_head_dim=512,      # d_inner (=expand*d_model=2048) / 4 heads
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    ssm_state_dim=512,     # mLSTM matrix memory is (head_dim x head_dim) per head
    tie_embeddings=True,
)
