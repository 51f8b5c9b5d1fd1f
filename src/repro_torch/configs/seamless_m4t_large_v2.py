"""SeamlessM4T-Large v2 [audio] — encoder-decoder, multimodal
[arXiv:2308.11596].

24 decoder layers + 24 encoder layers, d_model=1024, 16 heads (kv=16),
d_ff=8192, vocab=256206. Per the assignment carve-out, the speech frontend
(mel-spectrogram + conv feature extractor) is a STUB: ``input_specs`` feeds
precomputed frame embeddings (batch, encoder_frames, d_model) to the encoder.
Deviation note: positions use RoPE rather than Seamless' learned positional
embeddings — positional scheme does not affect allocation/roofline structure.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    group_pattern=(ATTN,),
    mlp_type="gelu",
    encoder_layers=24,
    encoder_frames=1024,
    cross_attn_states=1024,   # decoder cross-attends to encoder outputs
)
