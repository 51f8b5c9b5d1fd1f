"""AdamW and its schedule, from scratch, as the reference writes them
(src/repro/training/optimizer.py).

Parameters, gradients and the moments are trees of tensors: nested dicts
(the LLMs' parameter trees) or flat dicts of name -> parameter (an
`nn.Module`'s `named_parameters()`). `m` and `v` are float32 whatever the
parameter dtype; weight decay acts only on leaves with ndim >= 2 (norms
and biases are exempt). `update` writes the parameters and moments in
place, where the reference's jitted step donates them. The step count and
the learning rate are host numbers, the learning rate computed in float32
as the reference's traced schedule computes it, so a step reads nothing
back from the card. DTensor parameters (a model on a mesh) keep DTensor
moments of the same placements; a gradient is redistributed to its
parameter's placements first, and the global norm sums each rank's
partial squares before the root.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.sharding.policy import placed_like


class AdamWState(NamedTuple):
    step: int
    m: dict
    v: dict


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000


def tree_items(tree, prefix: str = ""):
    """(path, tensor) for each leaf of a tree of dicts and lists, dict keys
    in sorted order (the order `jax.tree.leaves` gives a dict), the path
    its dict keys and list indices joined by "/"."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def tree_leaves(tree) -> list:
    """The tensors of a tree, in `tree_items` order."""
    return [t for _, t in tree_items(tree)]


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` (and of the trees in `rest`, which
    share its structure), called in `tree_leaves` order; a tree of the
    same structure, its dicts' keys sorted (as `jax.tree.map` gives
    them)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """float32 zeros shaped and placed as `p` (a DTensor's on its mesh)."""
    return torch.zeros_like(p, dtype=torch.float32,
                            memory_format=torch.contiguous_format)


def init(params) -> AdamWState:
    return AdamWState(step=0, m=tree_map(zeros_f32, params),
                      v=tree_map(zeros_f32, params))


def schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup -> cosine decay to 10%, in float32 as the reference's
    jnp arithmetic on an int32 step."""
    f = np.float32
    warm = min(f(1.0), f(step + 1) / f(max(1, cfg.warmup_steps)))
    frac = np.clip(f(step - cfg.warmup_steps)
                   / f(max(1, cfg.total_steps - cfg.warmup_steps)),
                   f(0.0), f(1.0))
    cos = f(0.1) + f(0.45) * (f(1.0) + np.cos(f(math.pi) * frac))
    return float(f(cfg.lr) * f(warm) * f(cos))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (a 0-dim
    tensor on the leaves' device; of DTensor leaves a replicated 0-dim
    DTensor, the partial sums reduced before the root)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """Returns (params, new_state, stats), stats {"grad_norm": 0-dim
    tensor, "lr": float}. The parameters and the moments are overwritten
    in place and returned, as the reference's train step donates them
    (a caller that needs the old values clones them first)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, state.step)
    b1c = float(np.float32(1.0) - np.float32(cfg.b1) ** np.float32(step))
    b2c = float(np.float32(1.0) - np.float32(cfg.b2) ** np.float32(step))

    def upd(g, m, v, p):
        g = placed_like(g, p).to(torch.float32) * scale
        new_m = cfg.b1 * m + (1 - cfg.b1) * g
        new_v = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (new_m / b1c) / (torch.sqrt(new_v / b2c) + cfg.eps)
        if p.dim() >= 2:   # decay matrices only (norms/biases exempt)
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        m.copy_(new_m)
        v.copy_(new_v)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))

    with torch.no_grad():
        tree_map(upd, grads, state.m, state.v, params)
    return params, AdamWState(step, state.m, state.v), \
        {"grad_norm": gnorm, "lr": lr}
