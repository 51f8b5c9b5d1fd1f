"""Long-context decode across architecture families (the long_500k story
at CPU-runnable scale).

Compares decode state growth: recurrent archs (xlstm) carry O(1) state,
SWA archs (mixtral) carry O(window), full-attention archs carry O(context)
— the reason long_500k is restricted to sub-quadratic archs (DESIGN.md §4).

    python -m repro_torch.examples.long_context_decode
    python -m repro_torch.examples.long_context_decode --device cpu

The reference's example (examples/long_context_decode.py) on `--device`
(default cuda; raises without one). The decode position is a host int in
the port, so the cache's bytes are those of its tensors, the groups'
state.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import make_batch
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import build_model

ARCHS = (("xlstm-350m", "recurrent: O(1) state"),
         ("zamba2-2.7b", "hybrid: O(1) mamba + shared KV"),
         ("mixtral-8x7b", "SWA: O(window) ring buffer"),
         ("qwen2-1.5b", "full attention: O(context) KV"))


def cache_bytes(cache) -> int:
    """Bytes of every tensor in a cache tree (dicts and lists)."""
    if isinstance(cache, dict):
        return sum(cache_bytes(v) for v in cache.values())
    if isinstance(cache, list):
        return sum(cache_bytes(v) for v in cache)
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    return 0


def reduced(arch: str):
    """The example's reduced config of `arch` (mixtral's window cut to
    64 so that the ring buffer wraps)."""
    cfg = get_config(arch)
    cfg = cfg.reduced(layers=2 if len(cfg.group_pattern) <= 2 else None,
                      d_model=128, vocab=256)
    if arch == "mixtral-8x7b":
        cfg = dataclasses.replace(cfg, attn_window=64)
    return cfg


def main(argv=None):
    """Returns {arch: cache bytes after prefills of ctx/4, ctx/2, ctx}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    ctx = 512   # stand-in for 500k at CPU scale; scaling is the point
    out = {}
    for arch, note in ARCHS:
        cfg = reduced(arch)
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        sizes = []
        with torch.inference_mode():
            for c in (ctx // 4, ctx // 2, ctx):
                batch = {k: v.to(dev)
                         for k, v in make_batch(cfg, 1, c, seed=1).items()}
                _, cache = model.prefill(params, batch, max_len=c + 8)
                sizes.append(cache_bytes(cache))
            synchronize(dev)
            t0 = time.perf_counter()
            tok = batch["tokens"][:, -1]
            for _ in range(4):
                logits, cache = model.decode_step(params, tok, cache)
                tok = torch.argmax(logits, -1)
            synchronize(dev)
        dt = (time.perf_counter() - t0) / 4
        growth = sizes[-1] / sizes[0]
        print(f"{arch:16s} cache@{ctx//4}/{ctx//2}/{ctx} tokens = "
              f"{sizes[0]//1024}/{sizes[1]//1024}/{sizes[2]//1024} KiB "
              f"(x{growth:.1f})  decode {dt*1e3:.0f} ms/tok  <- {note}")
        out[arch] = sizes
    return out


if __name__ == "__main__":
    main()
