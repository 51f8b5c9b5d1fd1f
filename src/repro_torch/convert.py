"""Carry parameters and optimizer state between the JAX reference and the
port, as numpy arrays, both ways.

torch cannot replay `jax.random`, so a test that runs both packages on the
same weights draws or inits them once, turns them into numpy arrays, and
passes them here; a trajectory of AdamW steps starts both packages from
the same state. This module takes and gives numpy arrays only and imports
nothing of the reference. A bfloat16 tensor leaves as float32 numpy
(every bf16 value is exact in float32; numpy has no bf16 without
`ml_dtypes`), which the reference's `jnp.asarray(a, jnp.bfloat16)` takes
back exactly.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.training.optimizer import AdamWState, tree_leaves, tree_map


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


def decoder_params_from_numpy(tree, cfg) -> Dict:
    """The reference's `DecoderModel.init` pytree as numpy arrays
    (group leaves stacked on a leading num_groups axis, the shared block
    under stack.shared) as the port's `DecoderModel` parameters: the same
    tree of leaf names, each leaf a CPU tensor of the same dtype."""
    out = tree_map(_leaf, tree)
    _check_groups(out["stack"]["groups"], cfg.group_pattern, cfg.num_groups)
    return out


def encdec_params_from_numpy(tree, cfg) -> Dict:
    """The reference's `EncDecModel.init` pytree as numpy arrays (the
    encoder's groups of pattern (ATTN,) stacked on encoder_layers, the
    decoder's of pattern (ATTN, CROSS) on num_layers) as the port's
    `EncDecModel` parameters: the same tree, each leaf a CPU tensor of the
    same dtype."""
    from repro_torch.models.encdec import DECODER_PATTERN, ENCODER_PATTERN
    out = tree_map(_leaf, tree)
    _check_groups(out["encoder"]["groups"], ENCODER_PATTERN,
                  cfg.encoder_layers)
    _check_groups(out["decoder"]["groups"], DECODER_PATTERN, cfg.num_layers)
    return out


def _check_groups(groups: Dict, pattern, num_groups: int) -> None:
    for i, kind in enumerate(pattern):
        key = f"b{i}_{kind}"
        if key not in groups:
            raise ValueError(f"the tree has no group leaf {key!r}")
        lead = {int(t.shape[0]) for t in tree_leaves(groups[key])}
        if lead != {num_groups}:
            raise ValueError(f"{key}: leading axes {sorted(lead)} != "
                             f"num_groups {num_groups}")


def tree_to_numpy(tree):
    """A tree (dicts and lists) of tensors as numpy arrays on the host,
    bfloat16 as float32."""
    return tree_map(_to_numpy, tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def icu_lstm_params_to_numpy(state_dict) -> Dict:
    """The port's `ICULSTM` state dict as the reference's `ICULSTM.init`
    pytree of numpy arrays (the inverse of
    `icu_lstm_params_from_numpy`)."""
    depth = 1 + max(int(k.split(".")[1]) for k in state_dict
                    if k.startswith("layers."))
    return {"layers": [{name: tree_to_numpy(state_dict[f"layers.{i}.{name}"])
                        for name in ("wx", "wh", "b")}
                       for i in range(depth)],
            "head": tree_to_numpy(state_dict["head"]),
            "head_b": tree_to_numpy(state_dict["head_b"])}


def adamw_state_to_numpy(state):
    """The port's `training.optimizer.AdamWState` as (step, m, v): an int
    and two numpy trees in the parameters' structure, the reference's
    `AdamWState` fields."""
    return int(state.step), tree_to_numpy(state.m), tree_to_numpy(state.v)


def adamw_state_from_numpy(step, m, v, device="cpu"):
    """The reference's `AdamWState` fields (step, m, v) as numpy as the
    port's `AdamWState`: float32 moments on `device`."""
    def to_dev(a):
        return _tensor(a).to(device)
    return AdamWState(int(np.asarray(step)), tree_map(to_dev, m),
                      tree_map(to_dev, v))
