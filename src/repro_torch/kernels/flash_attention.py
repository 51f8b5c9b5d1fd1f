"""Forward flash attention: a hand-written CUDA kernel and its plain
version.

Port of the Pallas TPU kernel `flash_attention`
(src/repro/kernels/flash_attention.py): GQA, end-aligned queries, causal
and sliding-window masks, tanh softcap, float32 sums, and 0 for a row with
no live key. bf16 runs on the tensor cores (`mma.sync`), float32 on the
CUDA cores, to keep the float32 tolerance of 2e-5. The CUDA source,
`csrc/flash_attention.cu`, says what bounds it on an H100 and how its
design answers that. Unlike the Pallas kernel it
takes ragged lengths: nothing has to divide a tile, so `block_q` and
`block_k` are accepted for the signature and not used.

Any Lq and Lk: with Lq > Lk the query offset Lk - Lq is negative, as in
the Pallas kernel, so a causal row before the first key has no live key
and gives 0, and without a causal mask or a window every query sees every
key (cross attention to fewer states than there are queries).

`flash_attention` takes the kernel for CUDA tensors and the plain PyTorch
version for CPU tensors; on the card it launches the kernel or raises. It
counts its launches in `flash_attention.launches`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None,
                          block_q: int = 128, block_k: int = 128):
    """The kernel's function in plain PyTorch: `ref.attention_reference`,
    except that a row with no live key gives 0, as the Pallas kernel's
    `l == 0 -> 1` does (the oracle averages over such a row)."""
    out = ref.attention_reference(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale)
    lq, lk = q.shape[2], k.shape[2]
    q_pos = torch.arange(lq, device=q.device)[:, None] + (lk - lq)
    k_pos = torch.arange(lk, device=q.device)[None, :]
    live = ref.causal_window_mask(q_pos, k_pos, causal, window).any(dim=-1)
    return out * live[None, None, :, None].to(out.dtype)


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must have 4 dims (B, H, L, D), got "
                             f"{t.dim()}")
    b, hq, _, d = q.shape
    _, hkv, _, _ = k.shape
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"both be (B={b}, Hkv, Lk, D={d})")
    if hq % hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0, got ({hq}, {hkv})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention takes q, k, v of one dtype, "
                        "float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention inputs lie on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention inputs must be contiguous")


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("flash_attention").repro_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """q: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D). Returns (B, Hq, Lq, D) in
    q's dtype. Queries are aligned to the end of the key sequence (query
    i sits at key position Lk - Lq + i, which is negative for Lq > Lk).
    Launches on the current CUDA stream and does not synchronise."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"flash_attention inputs lie on {q.device}, but the "
                         f"current device is cuda:"
                         f"{torch.cuda.current_device()}")
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds the kernel's "
                         f"{MAX_HEAD_DIM}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   _DTYPES[q.dtype], b, hq, hkv, lq, lk, d, int(causal),
                   int(window is not None),
                   0 if window is None else int(window),
                   int(softcap is not None),
                   0.0 if softcap is None else float(softcap), float(scale),
                   stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
