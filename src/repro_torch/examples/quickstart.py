"""Quickstart: train a small LM on synthetic bigram data, then serve it.

    python -m repro_torch.examples.quickstart [--steps 200] [--arch qwen2-1.5b]
    python -m repro_torch.examples.quickstart --steps 20 --device cpu

Runs a reduced variant (2 layers, d_model 128, vocab 128) on `--device`
(default cuda; raises without one); `launch.train` trains the full-width
configs.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data.pipeline import MarkovTokenDataset, make_batch
from repro_torch.device import resolve_device
from repro_torch.launch.train import make_batches
from repro_torch.models import build_model
from repro_torch.serving.engine import ServingEngine
from repro_torch.training import optimizer, train_loop


def main(argv=None):
    """Returns (the training history [(step, loss)], the served
    GenerationResult)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b", choices=ARCH_NAMES)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).reduced(layers=2, d_model=128, vocab=128)
    print(f"arch={cfg.name} family={cfg.family} layers={cfg.num_layers} "
          f"d_model={cfg.d_model}")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)

    ds = MarkovTokenDataset(vocab_size=cfg.vocab_size, seq_len=args.seq,
                            batch_size=args.batch)
    print(f"true process entropy: {ds.entropy_floor:.3f} nats")
    opt_cfg = optimizer.AdamWConfig(total_steps=args.steps, warmup_steps=20)
    params, _, hist = train_loop.train(
        model, params, make_batches(cfg, args.batch, args.seq, device=dev),
        steps=args.steps, opt_cfg=opt_cfg, log_every=20)
    print(f"loss: {hist[0][1]:.3f} -> {hist[-1][1]:.3f} "
          f"(floor {ds.entropy_floor:.3f})")

    engine = ServingEngine(model, params, device=dev)
    res = engine.generate(make_batch(cfg, 2, 16, seed=1), steps=16)
    print(f"served batch: prefill {res.prefill_seconds*1e3:.1f} ms, "
          f"16 decode steps {res.decode_seconds*1e3:.1f} ms")
    print("sample continuation:", res.tokens[0, -16:].tolist())
    return hist, res


if __name__ == "__main__":
    main()
