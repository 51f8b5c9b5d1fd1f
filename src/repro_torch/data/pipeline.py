"""Deterministic synthetic model batches, as the reference's
`data/pipeline.py` makes them.

The arrays are drawn with numpy from the seed exactly as the reference
draws them, then handed to torch on the CPU (the serving engine moves them
to its device). Tokens are int64, torch's index type; the reference's are
int32 with the same values. `shard_batch` places a batch on a mesh
(batch on dp where it divides, the rest replicated).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class MarkovTokenDataset:
    """Tokens that follow a fixed random bigram table (out-degree
    `branching`), so a language model's loss drops measurably below the
    uniform entropy: the reference's dataset, drawn with the same numpy
    generators from the same seeds, so both packages see the same
    batches."""
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    branching: int = 4          # out-degree of the bigram graph

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.table = rng.integers(0, self.vocab_size,
                                  size=(self.vocab_size, self.branching))

    def batches(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + 1)
        while True:
            tok = np.empty((self.batch_size, self.seq_len), np.int32)
            tok[:, 0] = rng.integers(0, self.vocab_size, self.batch_size)
            choices = rng.integers(0, self.branching,
                                   (self.batch_size, self.seq_len))
            for t in range(1, self.seq_len):
                tok[:, t] = self.table[tok[:, t - 1], choices[:, t]]
            yield {"tokens": torch.as_tensor(tok, dtype=torch.int64)}

    @property
    def entropy_floor(self) -> float:
        """Cross-entropy of the true bigram process (uniform over
        branches)."""
        return float(np.log(self.branching))


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


def shard_batch(batch: dict, mesh, specs: dict | None = None) -> dict:
    """The batch as DTensors on `mesh`, placed by `specs`
    (`sharding.policy.batch_specs` of the batch by default). Every rank
    passes the same whole batch."""
    from repro_torch.sharding import policy
    if specs is None:
        specs = policy.batch_specs(batch, mesh)
    return policy.distribute(batch, specs, mesh)
