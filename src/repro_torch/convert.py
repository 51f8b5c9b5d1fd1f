"""Carry parameters of the JAX reference into the port's models.

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


def _leaf(a) -> torch.Tensor:
    """A numpy array (ml_dtypes bfloat16 included) as a CPU tensor of the
    same dtype and values."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return _leaf(tree)


def decoder_params_from_numpy(tree, cfg) -> Dict:
    """The reference's `DecoderModel.init` pytree as numpy arrays
    (group leaves stacked on a leading num_groups axis, the shared block
    under stack.shared) as the port's `DecoderModel` parameters: the same
    tree of leaf names, each leaf a CPU tensor of the same dtype."""
    out = _tree(tree)
    _check_groups(out["stack"]["groups"], cfg.group_pattern, cfg.num_groups)
    return out


def encdec_params_from_numpy(tree, cfg) -> Dict:
    """The reference's `EncDecModel.init` pytree as numpy arrays (the
    encoder's groups of pattern (ATTN,) stacked on encoder_layers, the
    decoder's of pattern (ATTN, CROSS) on num_layers) as the port's
    `EncDecModel` parameters: the same tree, each leaf a CPU tensor of the
    same dtype."""
    from repro_torch.models.encdec import DECODER_PATTERN, ENCODER_PATTERN
    out = _tree(tree)
    _check_groups(out["encoder"]["groups"], ENCODER_PATTERN,
                  cfg.encoder_layers)
    _check_groups(out["decoder"]["groups"], DECODER_PATTERN, cfg.num_layers)
    return out


def _check_groups(groups: Dict, pattern, num_groups: int) -> None:
    for i, kind in enumerate(pattern):
        key = f"b{i}_{kind}"
        if key not in groups:
            raise ValueError(f"the tree has no group leaf {key!r}")
        lead = {int(t.shape[0]) for t in _leaves(groups[key])}
        if lead != {num_groups}:
            raise ValueError(f"{key}: leading axes {sorted(lead)} != "
                             f"num_groups {num_groups}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
