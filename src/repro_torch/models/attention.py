"""Self and cross attention with GQA, RoPE, sliding window, softcap and
KV caches.

Two paths, as in the reference:
  * full sequence (prefill): `kernels.ops.attention` (the CUDA flash
    kernel on the card, the plain oracle on the CPU);
  * cached decode (1 query token): a masked GEMV in plain torch, which
    the reference also leaves outside Pallas: it is bound by the cache
    read.

KV caches are linear (length = context) or ring buffers (length = sliding
window), in the model's dtype or, with `kv_cache_dtype="int8"`, as int8
with a float32 scale per (batch, head, slot). Keys are stored after RoPE
so decode never re-rotates. Decode writes the new token's K/V into the
cache in place (the reference returns an updated copy). Cross attention
(llama-vision, the encoder-decoder) reads a static cache of the cross
states' K/V built at prefill. The reference's sharding constraints have no
counterpart on one card and are left out.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common

NEG_INF = -1e30


def attn_init(generator: torch.Generator, cfg: ModelConfig,
              dtype: Optional[torch.dtype] = None,
              cross: bool = False) -> dict:
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
    if cross:
        # tanh-gated residual (llama-vision)
        p["gate_attn"] = torch.zeros((), dtype=dtype, device=dev)
    return p


def _qkv(p: dict, x: torch.Tensor, states: Optional[torch.Tensor]):
    """x: (B, L, d) queries' source; states: the keys' and values' source
    (x when None). -> q (B, Hq, L, hd), k and v (B, Hkv, S, hd)."""
    kv_src = x if states is None else states
    q = torch.einsum("bld,dhe->bhle", x, p["wq"])
    k = torch.einsum("bld,dhe->bhle", kv_src, p["wk"])
    v = torch.einsum("bld,dhe->bhle", kv_src, p["wv"])
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    return q, k, v


def attn_full(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              window: Optional[int] = None,
              positions: Optional[torch.Tensor] = None,
              causal: bool = True,
              cross_states: Optional[torch.Tensor] = None,
              make_cache: bool = False,
              cache_len: int = 0):
    """Full-sequence attention. Returns (y, cache | None).

    positions: (L,) absolute positions for RoPE (self-attention only).
    With `cross_states` (B, S, d) the keys and values come from them,
    without RoPE, and every query sees every state."""
    h = common.rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cross_states)
    if cross_states is None:
        l = x.shape[1]
        if positions is None:
            positions = torch.arange(l, device=x.device)
        q = common.rope(q, positions[None, None, :], cfg.rope_theta)
        k = common.rope(k, positions[None, None, :], cfg.rope_theta)
    y = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                      causal=causal and cross_states is None, window=window,
                      softcap=cfg.attn_logit_softcap)
    y = torch.einsum("bhle,hed->bld", y, p["wo"])
    out = x + _gate(p, y)

    cache = None
    if make_cache:
        cache = _cache_from_prefill(k, v, window, cache_len,
                                    cfg.kv_cache_dtype)
    return out, cache


def _gate(p: dict, y: torch.Tensor) -> torch.Tensor:
    """tanh(gate_attn) * y for a gated cross-attention block, the gate
    taken in float32 and rounded to y's dtype; y itself otherwise."""
    if "gate_attn" not in p:
        return y
    return torch.tanh(p["gate_attn"].to(torch.float32)).to(y.dtype) * y


def _quantize(x: torch.Tensor):
    """Symmetric int8 quantisation over the last axis with a float32
    scale per (b, h, slot): max(amax, 1e-6) / 127, values rounded half to
    even and clipped to +-127."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _cache_from_prefill(k, v, window, cache_len, kv_dtype="native"):
    """Build a decode cache from prefill K/V: (B, Hkv, L, hd) -> slots."""
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
    if kv_dtype == "int8":
        kq, ks = _quantize(kc)
        vq, vs = _quantize(vc)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": kc, "v": vc}


def empty_cache(batch: int, cfg: ModelConfig, cache_len: int,
                window: Optional[int], dtype: torch.dtype,
                device: torch.device | str) -> dict:
    slots = min(window, cache_len) if window else cache_len
    shape = (batch, cfg.num_kv_heads, slots, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        i8, f32 = torch.int8, torch.float32
        return {"k": torch.zeros(shape, dtype=i8, device=device),
                "v": torch.zeros(shape, dtype=i8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=f32, device=device),
                "v_scale": torch.zeros(shape[:3], dtype=f32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p: dict, x: torch.Tensor, cache: dict, pos: int,
                cfg: ModelConfig, *, window: Optional[int] = None,
                cross: bool = False):
    """One decode step. x: (B, 1, d); pos: tokens already in context.
    Self-attention writes the new K/V into `cache`; cross-attention reads
    its static cache as it is. Returns (y, cache)."""
    h = common.rms_norm(x, p["norm"], cfg.norm_eps)
    if cross:
        # no RoPE and no bias on q, as in the reference
        q = torch.einsum("bld,dhe->bhle", h, p["wq"])
        y = _cached_attention(q, cache["k"], cache["v"], pos, None, cfg,
                              full=True)
    else:
        q, k, v = _qkv(p, h, None)
        # filled on the device: a host tensor copied there would wait for
        # the queue to drain
        where = torch.full((1, 1, 1), pos, device=x.device)
        q = common.rope(q, where, cfg.rope_theta)
        k = common.rope(k, where, cfg.rope_theta)
        slots = cache["k"].shape[2]
        slot = pos % slots if window else pos
        if slot >= slots:
            raise ValueError(f"decode position {pos} is past the cache's "
                             f"{slots} slots; prefill with a larger max_len")
        if "k_scale" in cache:
            kq, ks = _quantize(k[:, :, 0])
            vq, vs = _quantize(v[:, :, 0])
            cache["k"][:, :, slot] = kq
            cache["v"][:, :, slot] = vq
            cache["k_scale"][:, :, slot] = ks
            cache["v_scale"][:, :, slot] = vs
        else:
            cache["k"][:, :, slot] = k[:, :, 0].to(cache["k"].dtype)
            cache["v"][:, :, slot] = v[:, :, 0].to(cache["v"].dtype)
        y = _cached_attention(q, cache["k"], cache["v"], pos, window, cfg,
                              full=False, k_scale=cache.get("k_scale"),
                              v_scale=cache.get("v_scale"))
    y = torch.einsum("bhle,hed->bld", y, p["wo"])
    return x + _gate(p, y), cache


def _cached_attention(q, kc, vc, pos: Optional[int], window,
                      cfg: ModelConfig, *, full: bool,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None):
    """q: (B, Hq, 1, hd); kc/vc: (B, Hkv, S, hd). Masked GEMV decode
    attention with grouped contractions (no repeat of the KV heads); with
    `full` every slot is live (cross attention). Both contractions read
    their operands in the compute dtype (the cache's, bfloat16 for an
    int8 cache) and sum in float32 with a float32 result, as the
    reference's `preferred_element_type=float32` does (int8 values are
    exact in bfloat16, so an int8 cache goes to float32 directly). An int8
    cache's scales are folded in after the integer-weight contractions:
    k_scale into the logits, v_scale into the probabilities."""
    b, hq, _, hd = q.shape
    hkv, slots = kc.shape[1], kc.shape[2]
    group = hq // hkv
    f32 = torch.float32
    compute = torch.bfloat16 if kc.dtype == torch.int8 else kc.dtype
    qf = q.to(compute).reshape(b, hkv, group, hd)
    logits = torch.einsum("bkge,bkse->bkgs", qf.to(f32),
                          kc.to(f32)) / (hd ** 0.5)
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, :]
    if cfg.attn_logit_softcap is not None:
        logits = common.softcap(logits, cfg.attn_logit_softcap)
    if not full:
        slot_idx = torch.arange(slots, device=q.device)
        if window:
            # ring buffer: valid slots are the last min(pos+1, slots)
            # writes
            n_valid = min(pos + 1, slots)
            age = (pos % slots - slot_idx + slots) % slots   # 0 = newest
            mask = age < n_valid
        else:
            mask = slot_idx <= pos
        logits = logits.masked_fill(~mask[None, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale[:, :, None, :]
    out = torch.einsum("bkgs,bkse->bkge", probs.to(compute).to(f32),
                       vc.to(f32))
    return out.reshape(b, hq, 1, hd).to(q.dtype)
