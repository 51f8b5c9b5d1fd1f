"""The train step: loss -> gradients -> AdamW, as the reference's
`make_train_step` (src/repro/training/train_loop.py), eagerly.

`make_train_step(model, opt_cfg)` returns
`step(params, opt_state, batch) -> (params, opt_state, metrics)`. The
reference's jitted step donates its parameters and optimizer state; this
one updates them in place and returns them. A model is either functional,
`model.loss(params, batch)` over a tree of tensors (the LLMs), or an
`nn.Module` whose `loss(batch)` reads its own parameters (the ICU LSTMs),
and then `params` is `dict(model.named_parameters())`. Gradients come from
`torch.autograd.grad`; on the card they run through the kernels'
backward kernels (`kernels/`), on the CPU through autograd of the plain
versions. With DTensor parameters and batch (a model on a mesh, the step
called under an activation policy) the step is the same program; the
loss it reports is the replicated value as a plain tensor, and
microbatches cut each rank's batch shard.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.sharding.policy import is_dtensor, placed_like
from repro_torch.training import optimizer


def _loss(model, params, batch) -> torch.Tensor:
    if isinstance(model, torch.nn.Module):
        return model.loss(batch)
    return model.loss(params, batch)


def _grads_of(model, params, batch):
    """(loss, gradient tree in the parameters' dtypes). Every parameter
    must reach the loss: a leaf autograd cannot see (a kernel's output
    outside the graph) raises here instead of training with a zero
    gradient."""
    leaves = optimizer.tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    loss = _loss(model, params, batch)
    grads = iter(torch.autograd.grad(loss, leaves))
    loss = loss.detach()
    if hasattr(loss, "full_tensor"):     # a DTensor: its replicated value
        loss = loss.full_tensor()
    return loss, optimizer.tree_map(lambda _: next(grads), params)


def _split(batch: dict, n: int) -> list:
    """The batch cut into n microbatches on its leading axis; a DTensor
    batch on each rank's shard (microbatch i takes the i-th n-th of every
    shard: another grouping of the same rows, each row's tokens weighted
    alike, so the same mean)."""
    def cut(v, i):
        if is_dtensor(v):
            from torch.distributed.tensor import DTensor
            local = v.to_local()
            size = local.shape[0] // n
            return DTensor.from_local(local[i * size:(i + 1) * size],
                                      v.device_mesh, v.placements,
                                      run_check=False)
        size = v.shape[0] // n
        return v[i * size:(i + 1) * size]

    for v in batch.values():
        local = v.to_local() if is_dtensor(v) else v
        if local.shape[0] % n:
            raise ValueError(f"batch {local.shape[0]} does not split into "
                             f"{n} microbatches")
    return [{k: cut(v, i) for k, v in batch.items()} for i in range(n)]


def make_train_step(model, opt_cfg: optimizer.AdamWConfig,
                    microbatches: int = 1) -> Callable:
    """microbatches > 1 accumulates gradients over the batch cut on its
    leading axis, in float32, dividing the activation high-water by the
    microbatch count, as the reference's scan does."""

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = _grads_of(model, params, batch)
        else:
            acc = optimizer.tree_map(optimizer.zeros_f32, params)
            lsum = 0.0
            for mb in _split(batch, microbatches):
                loss, g = _grads_of(model, params, mb)
                optimizer.tree_map(
                    lambda a, x: a.add_(placed_like(x, a)
                                        .to(torch.float32)), acc, g)
                lsum = lsum + loss
            grads = optimizer.tree_map(lambda a: a / microbatches, acc)
            loss = lsum / microbatches
        params, opt_state, stats = optimizer.update(opt_cfg, grads,
                                                    opt_state, params)
        return params, opt_state, {"loss": loss, **stats}

    return step


def make_eval_step(model) -> Callable:
    def step(params, batch):
        with torch.no_grad():
            return _loss(model, params, batch)
    return step


def train(model, params, batches, *, steps: int,
          opt_cfg: Optional[optimizer.AdamWConfig] = None,
          log_every: int = 10, log_fn=print):
    """The reference's simple host-loop trainer. `params` is None for an
    `nn.Module` (its own parameters). Returns (params, opt_state,
    history [(step, loss)] at every `log_every`-th step and the last)."""
    if params is None:
        params = dict(model.named_parameters())
    opt_cfg = opt_cfg or optimizer.AdamWConfig(total_steps=steps)
    opt_state = optimizer.init(params)
    step_fn = make_train_step(model, opt_cfg)
    history = []
    for i, batch in zip(range(steps), batches):
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if i % log_every == 0 or i == steps - 1:
            loss = float(metrics["loss"])
            history.append((i, loss))
            log_fn(f"step {i:5d} loss {loss:.4f} "
                   f"gnorm {float(metrics['grad_norm']):.3f}")
    return params, opt_state, history
