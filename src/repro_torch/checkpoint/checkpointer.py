"""Checkpointing to .npz in the reference's layout
(src/repro/checkpoint/checkpointer.py): one file
`step_<8 digits>.proc<i>.npz` per step and process, each leaf under its
tree path (dict keys and list indices joined by "/"), and `latest.json`
with the step and the leaf count. Restore checks the structure and every
shape against a template and casts to the template's dtype and device.

bfloat16: the reference saves a bf16 leaf through `ml_dtypes`, which
numpy stores as the raw type `|V2`; this module reads `|V2` back as
bfloat16 bits (the GPU machine has no `ml_dtypes`). It saves a bf16 leaf
as float32, which holds every bf16 value exactly and which the
reference's `restore` casts to a bf16 template (it cannot cast `|V2`).
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.convert import tree_to_numpy
from repro_torch.training.optimizer import tree_items, tree_map


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:   # ml_dtypes bfloat16
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _path(ckpt_dir: str, step: int, process_index: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.proc{process_index}.npz")


def save(ckpt_dir: str, step: int, tree: Any, *,
         process_index: int = 0) -> str:
    """Write `tree` (dicts and lists of tensors) as step `step`; returns
    the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {key: tree_to_numpy(t) for key, t in tree_items(tree)}
    fn = _path(ckpt_dir, step, process_index)
    np.savez(fn, **arrays)
    with open(os.path.join(ckpt_dir, "latest.json"), "w") as f:
        json.dump({"step": step, "leaves": len(arrays)}, f)
    return fn


def latest_step(ckpt_dir: str) -> int:
    with open(os.path.join(ckpt_dir, "latest.json")) as f:
        return json.load(f)["step"]


def restore(ckpt_dir: str, template: Any, step: int | None = None, *,
            process_index: int = 0) -> Any:
    """Restore into the structure of `template` (shapes checked; dtypes
    and devices taken from it)."""
    step = latest_step(ckpt_dir) if step is None else step
    with np.load(_path(ckpt_dir, step, process_index)) as data:
        leaves = []
        for key, tmpl in tree_items(template):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(tmpl.shape)}")
            leaves.append(_from_numpy(arr).to(dtype=tmpl.dtype,
                                              device=tmpl.device))
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)
