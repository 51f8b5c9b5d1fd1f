"""Deterministic synthetic model batches, as the reference's
`data/pipeline.py` makes them.

The arrays are drawn with numpy from the seed exactly as the reference
draws them, then handed to torch on the CPU (the serving engine moves them
to its device). Tokens are int64, torch's index type; the reference's are
int32 with the same values. `MarkovTokenDataset` waits for the training
slice; `shard_batch` has no counterpart on one card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def vision_stub(batch: int, cfg: ModelConfig, seed: int = 0) -> torch.Tensor:
    """Precomputed ViT patch embeddings (the assignment carve-out)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, cfg.cross_attn_states, cfg.vision_dim),
                            dtype=np.float32)
    return torch.as_tensor(x).to(getattr(torch, cfg.dtype))


def audio_stub(batch: int, cfg: ModelConfig, seed: int = 0) -> torch.Tensor:
    """Precomputed conv-frontend frame embeddings."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, cfg.encoder_frames, cfg.d_model),
                            dtype=np.float32)
    return torch.as_tensor(x).to(getattr(torch, cfg.dtype))


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0) -> dict:
    """A full model batch (tokens + modality stubs) for any arch."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (batch, seq)), dtype=torch.int64)}
    if cfg.family == "vlm":
        out["vision_embeds"] = vision_stub(batch, cfg, seed)
    if cfg.is_encdec:
        out["frames"] = audio_stub(batch, cfg, seed)
    return out
