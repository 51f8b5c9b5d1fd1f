"""Training launcher, as the reference's (src/repro/launch/train.py), and
the paper's offline phase: the three ICU classifiers trained before
Algorithms 1 and 2 place any job (examples/serve_hierarchical.py,
`train_offline`).

It runs on the card unless asked for the CPU, and raises without one:

  python -m repro_torch.launch.train --arch qwen2-1.5b --steps 5 \\
      --batch 8 --seq 1024                       # full width, on the card
  python -m repro_torch.launch.train --arch qwen2-1.5b --reduced \\
      --steps 20 --device cpu                    # reduced, plain path
  python -m repro_torch.launch.train --icu --device cpu
  python -m repro_torch.launch.train --arch zamba2-2.7b --steps 3 \\
      --batch 4 --seq 1024                       # ssm_scan's backward
  python -m repro_torch.launch.train --arch xlstm-350m --steps 3 \\
      --batch 8 --seq 1024                       # mlstm_chunk's backward
  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen2-1.5b --reduced --steps 5 --mesh host --device cpu

`--mesh host | prod | prod-multipod` trains on a mesh of the ranks of
the process group (`launch.mesh`): under torchrun, or as a single process
of one rank (a process group of world size 1 made here). Parameters and
AdamW state are DTensors placed by `sharding.policy.param_specs`, batches
by `data.pipeline.shard_batch`, and the step runs under the activation
policy. Without --mesh the step runs on one device. On the card the
gradients run through the kernels' backward kernels (flash_attention,
lstm_sequence, ssm_scan, mlstm_chunk), so every LLM arch of
`build_model` trains there; the one-step lstm_cell, on no training path,
has none.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint import checkpointer
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.icu_lstm import ICU_WORKLOADS
from repro_torch.data import icu
from repro_torch.data.pipeline import (MarkovTokenDataset, audio_stub,
                                       shard_batch, vision_stub)
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build_model
from repro_torch.models.lstm import ICULSTM
from repro_torch.sharding import policy
from repro_torch.training import optimizer, train_loop

MESHES = ("host", "prod", "prod-multipod")


def make_batches(cfg, batch: int, seq: int, seed: int = 0,
                 device: str | torch.device = "cpu") -> Iterator[dict]:
    """MarkovTokenDataset batches (+ the modality stubs), on `device`."""
    dev = torch.device(device)
    ds = MarkovTokenDataset(vocab_size=cfg.vocab_size, seq_len=seq,
                            batch_size=batch, seed=seed)
    for b in ds.batches():
        if cfg.family == "vlm":
            b["vision_embeds"] = vision_stub(batch, cfg, seed)
        if cfg.is_encdec:
            b["frames"] = audio_stub(batch, cfg, seed)
        yield {k: v.to(dev) for k, v in b.items()}


def opt_config(lr: float, steps: int) -> optimizer.AdamWConfig:
    """The reference launcher's AdamW settings."""
    return optimizer.AdamWConfig(lr=lr, total_steps=steps,
                                 warmup_steps=min(20, steps // 5))


@dataclasses.dataclass
class TrainRun:
    """What `run` did and what it holds: the per-step losses, learning
    rates and host seconds (each after a synchronise), the peak device
    memory (bytes, CUDA only), and the live model, parameters, optimizer
    state, step function and batch stream, so a caller can take one more
    step (to trace it)."""
    cfg: object
    model: object
    params: dict
    opt_state: optimizer.AdamWState
    step_fn: Callable
    batches: Iterator[dict]
    losses: list
    lrs: list
    step_seconds: list
    peak_bytes: Optional[int]


def init_distributed(device: torch.device) -> torch.device:
    """The default process group, made unless it exists: from torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR), else one rank of its own
    on a free localhost port; NCCL for CUDA, gloo for the CPU. Returns
    this rank's device (cuda:LOCAL_RANK under torchrun)."""
    import os
    import socket

    import torch.distributed as dist
    if device.type == "cuda" and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group(backend, init_method=f"tcp://localhost:"
                                f"{port}", world_size=1, rank=0)
    return device


def make_mesh(name: str, device: torch.device):
    """The mesh `--mesh name` names, over the default process group."""
    if name not in MESHES:
        raise ValueError(f"mesh must be one of {MESHES}, got {name!r}")
    dev = device.type
    if name == "host":
        return mesh_lib.make_host_mesh(device=dev)
    return mesh_lib.make_production_mesh(multi_pod=name == "prod-multipod",
                                         device=dev)


def run(arch: str, *, reduced: bool = False, steps: int = 100,
        batch: int = 8, seq: int = 128, lr: float = 3e-4,
        microbatches: int = 1, checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0, device: str | torch.device | None = None,
        seed: int = 0, log_every: int = 10, log_fn=print,
        mesh: Optional[str] = None) -> TrainRun:
    """Train `arch` (reduced to d_model 256, vocab 512 with `reduced`, as
    the reference) from parameters drawn on the device from `seed`. With
    `mesh` (one of MESHES) the parameters, the AdamW state and each batch
    are DTensors on that mesh and the step runs under the activation
    policy (`residual_for` the family); every rank draws the same weights
    and batches, and only rank 0 logs."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced(d_model=256, vocab=512)
    dmesh = None
    if mesh is not None:
        dev = init_distributed(dev)
        dmesh = make_mesh(mesh, dev)
        if torch.distributed.get_rank() != 0:
            log_fn = lambda *_: None  # noqa: E731
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    step_fn = train_loop.make_train_step(model, opt_config(lr, steps),
                                         microbatches=microbatches)
    if dmesh is not None:
        params = policy.distribute(params, policy.param_specs(params, dmesh),
                                   dmesh)
        step_fn = meshed_step(step_fn, dmesh, policy.residual_for(cfg))
    opt_state = optimizer.init(params)
    batches = make_batches(cfg, batch, seq, seed, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses, lrs, secs = [], [], []
    for i, b in zip(range(steps), batches):
        synchronize(dev)
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, b)
        losses.append(float(m["loss"]))
        synchronize(dev)
        secs.append(time.perf_counter() - t0)
        lrs.append(m["lr"])
        if i % log_every == 0 or i == steps - 1:
            log_fn(f"step {i:5d} loss {losses[-1]:.4f} lr {m['lr']:.2e} "
                   f"({sum(secs) / (i + 1):.2f}s/step)")
        if checkpoint_dir and checkpoint_every and \
                (i + 1) % checkpoint_every == 0:
            _save(checkpoint_dir, i + 1, params)
    if checkpoint_dir:
        log_fn(f"saved {_save(checkpoint_dir, steps, params)}")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    return TrainRun(cfg, model, params, opt_state, step_fn, batches, losses,
                    lrs, secs, peak)


def meshed_step(step_fn: Callable, mesh, residual: str) -> Callable:
    """`step_fn` on `mesh`: the batch placed by `shard_batch`, the step
    under `activation_policy(mesh, residual)`."""
    def step(params, opt_state, batch):
        with policy.activation_policy(mesh, residual=residual):
            return step_fn(params, opt_state, shard_batch(batch, mesh))
    return step


def _save(checkpoint_dir: str, step: int, params: dict) -> Optional[str]:
    """A checkpoint of the whole parameters; on a mesh each leaf is
    gathered and rank 0 writes it."""
    if any(policy.is_dtensor(t) for t in optimizer.tree_leaves(params)):
        params = optimizer.tree_map(lambda t: t.full_tensor(), params)
        if torch.distributed.get_rank() != 0:
            return None
    return checkpointer.save(checkpoint_dir, step, {"params": params})


def _icu_batches(cfg, x: np.ndarray, y: np.ndarray,
                device: torch.device) -> Iterator[dict]:
    """The offline phase's batches: 32 records drawn with replacement
    from the training set, numpy seed 0, as the reference's example."""
    rng = np.random.default_rng(0)
    while True:
        idx = rng.integers(0, len(x), 32)
        yield {"features": torch.as_tensor(x[idx], device=device),
               "labels": torch.as_tensor(y[idx], device=device)}


def _icu_accuracy(model: ICULSTM, cfg, x: np.ndarray, y: np.ndarray) -> float:
    """Held-out accuracy as the reference's example scores it: argmax for
    the binary tasks, per-label sign for the 25 phenotypes."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        logits = model(torch.as_tensor(x, device=dev)).cpu()
    yt = torch.as_tensor(y)
    if cfg.num_classes == 25:
        return float(((logits > 0) == yt.bool()).float().mean())
    return float((logits.argmax(-1) == yt).float().mean())


def train_offline(steps: int = 60, *, device: str | torch.device | None = None,
                  state_dicts: Optional[dict] = None, log_fn=print) -> dict:
    """The paper's offline phase: each ICU workload's model trained for
    `steps` AdamW steps at batch 32 on 256 generated records (seed 0),
    scored on 128 held-out ones (seed 9). Models start from
    `state_dicts[name]` when given, else from torch seed 0. Returns
    {name: {"model", "losses" (every step), "accuracy"}}."""
    dev = resolve_device(device)
    out = {}
    for wl in ICU_WORKLOADS:
        model = ICULSTM(wl, generator=torch.Generator().manual_seed(0),
                        device=dev)
        if state_dicts is not None:
            model.load_state_dict(state_dicts[wl.name])
        x, y = icu.generate(wl, 256, seed=0)
        _, _, hist = train_loop.train(model, None, _icu_batches(wl, x, y, dev),
                                      steps=steps, log_every=1,
                                      log_fn=lambda *_: None)
        xt, yt = icu.generate(wl, 128, seed=9)
        acc = _icu_accuracy(model, wl, xt, yt)
        losses = [loss for _, loss in hist]
        log_fn(f"  {wl.name:36s} loss {losses[0]:.3f}->{losses[-1]:.3f} "
               f"acc {acc:.2%}")
        out[wl.name] = {"model": model, "losses": losses, "accuracy": acc}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--icu", action="store_true",
                    help="the paper's offline phase: train the three ICU "
                         "classifiers")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family variant (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=None,
                    help="default 100 (--icu: 60)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--mesh", choices=MESHES, default=None,
                    help="train on a mesh of the process group's ranks "
                         "(default: one device, no mesh)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.icu == (args.arch is not None):
        ap.error("give exactly one of --arch and --icu")
    if args.icu:
        print("=== offline phase: training the three ICU models ===")
        train_offline(args.steps or 60, device=args.device)
        return
    run(args.arch, reduced=args.reduced, steps=args.steps or 100,
        batch=args.batch, seq=args.seq, lr=args.lr,
        microbatches=args.microbatches, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, device=args.device,
        mesh=args.mesh)


if __name__ == "__main__":
    main()
