"""Self-attention with GQA, RoPE, sliding window, softcap and KV caches.

Two paths, as in the reference:
  * full sequence (prefill): `kernels.ops.attention` (the CUDA flash
    kernel on the card, the plain oracle on the CPU);
  * cached decode (1 query token): a masked GEMV in plain torch, which
    the reference also leaves outside Pallas: it is bound by the cache
    read.

KV caches are linear (length = context) or ring buffers (length = sliding
window), in the model's dtype. Keys are stored after RoPE so decode never
re-rotates. Decode writes the new token's K/V into the cache in place
(the reference returns an updated copy). The reference's sharding
constraints have no counterpart on one card and are left out. Cross
attention and the int8 KV cache wait for later slices (ROADMAP).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common

NEG_INF = -1e30
_INT8_TODO = ("kv_cache_dtype='int8' is not ported yet (ROADMAP, queue 1 "
              "item 9: the int8 KV cache)")


def attn_init(generator: torch.Generator, cfg: ModelConfig,
              dtype: Optional[torch.dtype] = None) -> dict:
    dtype = dtype or common.torch_dtype(cfg.dtype)
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = generator.device
    p = {
        "norm": common.norm_init(d, dtype, dev),
        "wq": common.dense_init(generator, d, hq, hd, dtype=dtype),
        "wk": common.dense_init(generator, d, hkv, hd, dtype=dtype),
        "wv": common.dense_init(generator, d, hkv, hd, dtype=dtype),
        "wo": (common.dense_init(generator, hq * hd, d, dtype=dtype)
               .reshape(hq, hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((hkv, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((hkv, hd), dtype=dtype, device=dev)
    return p


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, L, d) -> q (B, Hq, L, hd), k and v (B, Hkv, L, hd)."""
    q = torch.einsum("bld,dhe->bhle", x, p["wq"])
    k = torch.einsum("bld,dhe->bhle", x, p["wk"])
    v = torch.einsum("bld,dhe->bhle", x, p["wv"])
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    return q, k, v


def attn_full(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              window: Optional[int] = None,
              positions: Optional[torch.Tensor] = None,
              causal: bool = True,
              make_cache: bool = False,
              cache_len: int = 0):
    """Full-sequence self-attention. Returns (y, cache | None).

    positions: (L,) absolute positions for RoPE."""
    h = common.rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg)
    l = x.shape[1]
    if positions is None:
        positions = torch.arange(l, device=x.device)
    q = common.rope(q, positions[None, None, :], cfg.rope_theta)
    k = common.rope(k, positions[None, None, :], cfg.rope_theta)
    y = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                      causal=causal, window=window,
                      softcap=cfg.attn_logit_softcap)
    y = torch.einsum("bhle,hed->bld", y, p["wo"])
    out = x + y

    cache = None
    if make_cache:
        cache = _cache_from_prefill(k, v, window, cache_len,
                                    cfg.kv_cache_dtype)
    return out, cache


def _cache_from_prefill(k, v, window, cache_len, kv_dtype="native"):
    """Build a decode cache from prefill K/V: (B, Hkv, L, hd) -> slots."""
    if kv_dtype == "int8":
        raise NotImplementedError(_INT8_TODO)
    b, hkv, l, hd = k.shape
    slots = min(window, cache_len) if window else cache_len
    kc = k.new_zeros((b, hkv, slots, hd))
    vc = v.new_zeros((b, hkv, slots, hd))
    if window and slots <= l:
        # ring buffer: last `slots` tokens, placed at their pos % slots
        idx = torch.arange(l - slots, l, device=k.device) % slots
        kc[:, :, idx] = k[:, :, l - slots:]
        vc[:, :, idx] = v[:, :, l - slots:]
    else:
        n = min(l, slots)
        kc[:, :, :n] = k[:, :, :n]
        vc[:, :, :n] = v[:, :, :n]
    return {"k": kc, "v": vc}


def empty_cache(batch: int, cfg: ModelConfig, cache_len: int,
                window: Optional[int], dtype: torch.dtype,
                device: torch.device | str) -> dict:
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(_INT8_TODO)
    slots = min(window, cache_len) if window else cache_len
    shape = (batch, cfg.num_kv_heads, slots, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p: dict, x: torch.Tensor, cache: dict, pos: int,
                cfg: ModelConfig, *, window: Optional[int] = None):
    """One decode step. x: (B, 1, d); pos: tokens already in context.
    Writes the new K/V into `cache` and returns (y, cache)."""
    if "k_scale" in cache:
        raise NotImplementedError(_INT8_TODO)
    h = common.rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cfg)
    # filled on the device: a host tensor copied there would wait for the
    # queue to drain
    where = torch.full((1, 1, 1), pos, device=x.device)
    q = common.rope(q, where, cfg.rope_theta)
    k = common.rope(k, where, cfg.rope_theta)
    slots = cache["k"].shape[2]
    slot = pos % slots if window else pos
    if slot >= slots:
        raise ValueError(f"decode position {pos} is past the cache's "
                         f"{slots} slots; prefill with a larger max_len")
    cache["k"][:, :, slot] = k[:, :, 0].to(cache["k"].dtype)
    cache["v"][:, :, slot] = v[:, :, 0].to(cache["v"].dtype)
    y = _cached_attention(q, cache["k"], cache["v"], pos, window, cfg)
    y = torch.einsum("bhle,hed->bld", y, p["wo"])
    return x + y, cache


def _cached_attention(q, kc, vc, pos: int, window, cfg: ModelConfig):
    """q: (B, Hq, 1, hd); kc/vc: (B, Hkv, S, hd). Masked GEMV decode
    attention with grouped contractions (no repeat of the KV heads). Both
    contractions read their operands in the cache's dtype and sum in
    float32 with a float32 result, as the reference's
    `preferred_element_type=float32` does."""
    b, hq, _, hd = q.shape
    hkv, slots = kc.shape[1], kc.shape[2]
    group = hq // hkv
    f32 = torch.float32
    qf = q.to(kc.dtype).reshape(b, hkv, group, hd)
    logits = torch.einsum("bkge,bkse->bkgs", qf.to(f32),
                          kc.to(f32)) / (hd ** 0.5)
    if cfg.attn_logit_softcap is not None:
        logits = common.softcap(logits, cfg.attn_logit_softcap)
    slot_idx = torch.arange(slots, device=q.device)
    if window:
        # ring buffer: valid slots are the last min(pos+1, slots) writes
        n_valid = min(pos + 1, slots)
        age = (pos % slots - slot_idx + slots) % slots     # 0 = newest
        mask = age < n_valid
    else:
        mask = slot_idx <= pos
    logits = logits.masked_fill(~mask[None, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bkse->bkge", probs.to(vc.dtype).to(f32),
                       vc.to(f32))
    return out.reshape(b, hq, 1, hd).to(q.dtype)
