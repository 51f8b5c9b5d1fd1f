"""Carry parameters of the JAX reference into the port's modules.

torch cannot replay `jax.random`, so a test that runs both packages on the
same weights draws or inits them once, turns them into numpy arrays, and
passes them here. This module takes numpy arrays only and imports nothing
of the reference.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def icu_lstm_params_from_numpy(tree) -> Dict[str, torch.Tensor]:
    """The reference's `ICULSTM.init` pytree as numpy arrays,
    {"layers": [{"wx", "wh", "b"}, ...], "head", "head_b"}, as a state
    dict of the port's `models.lstm.ICULSTM` (same layouts, float32, on
    the CPU; `load_state_dict` copies it to the module's device)."""
    out = {}
    for i, layer in enumerate(tree["layers"]):
        for name in ("wx", "wh", "b"):
            out[f"layers.{i}.{name}"] = _tensor(layer[name])
    out["head"] = _tensor(tree["head"])
    out["head_b"] = _tensor(tree["head_b"])
    return out
