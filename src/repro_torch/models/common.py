"""Parameter init helpers."""
from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, in_dim: int, *out_dims: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal weights of shape (in_dim, *out_dims), std 1/sqrt(in_dim),
    drawn on the CPU from `generator`."""
    shape = (in_dim, *out_dims)
    std = 1.0 / math.sqrt(in_dim)
    return (torch.randn(shape, generator=generator, dtype=torch.float32)
            * std).to(dtype)
