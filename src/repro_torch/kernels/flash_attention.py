"""Flash attention: hand-written CUDA kernels, forward and backward, and
their plain versions.

Port of the Pallas TPU kernel `flash_attention`
(src/repro/kernels/flash_attention.py): GQA, end-aligned queries, causal
and sliding-window masks, tanh softcap, float32 sums, and 0 for a row with
no live key. bf16 runs on the tensor cores (`wgmma`, fed by TMA loads
from a producer warpgroup beside two consumer warpgroups), float32 on
the CUDA cores, to keep the float32 tolerance of 2e-5. The CUDA source,
`csrc/flash_attention.cu`, says what bounds it on an H100 and how its
design answers that. Unlike the Pallas kernel it
takes ragged lengths: nothing has to divide a tile, so `block_q` and
`block_k` are accepted for the signature and not used.

Any Lq and Lk: with Lq > Lk the query offset Lk - Lq is negative, as in
the Pallas kernel, so a causal row before the first key has no live key
and gives 0, and without a causal mask or a window every query sees every
key (cross attention to fewer states than there are queries).

Training: on the card, `flash_attention` under autograd is a
`torch.autograd.Function` whose forward also writes each row's
log-sum-exp and whose backward is `flash_attention_backward`, the
hand-written `csrc/flash_attention_bwd.cu` (the Pallas kernel has no
backward; the reference differentiates its attention by autodiff). Its
plain version, `flash_attention_backward_plain`, is written from the
formulas; nothing on the card's path runs a plain version.

Each wrapper takes its kernel for CUDA tensors and its plain PyTorch
version for CPU tensors (where autograd differentiates the plain
forward); on the card it launches the kernel or raises. They count their
launches in `flash_attention.launches` and
`flash_attention_backward.launches`.
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
    live = _live(q.shape[2], k.shape[2], causal, window, q.device).any(-1)
    return out * live[None, None, :, None].to(out.dtype)


def _live(lq: int, lk: int, causal: bool, window: Optional[int],
          device) -> torch.Tensor:
    """(Lq, Lk) bool: the live (query, key) pairs, queries end-aligned."""
    q_pos = torch.arange(lq, device=device)[:, None] + (lk - lq)
    k_pos = torch.arange(lk, device=device)[None, :]
    return ref.causal_window_mask(q_pos, k_pos, causal, window)


def _scores(q, k, causal, window, softcap, scale):
    """float32 logits s (B, Hq, Lq, Lk) after scale and softcap, with the
    K heads repeated over their group, and the live mask."""
    group = q.shape[1] // k.shape[1]
    kf = torch.repeat_interleave(k.to(torch.float32), group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kf) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s, _live(q.shape[2], k.shape[2], causal, window, q.device)


def flash_attention_lse_plain(q, k, v, *, causal: bool = True,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              scale: Optional[float] = None):
    """The training forward's function in plain PyTorch: (out, lse), out
    as `flash_attention_plain` gives it and lse (B, Hq, Lq) float32 the
    row log-sum-exp of the live logits, +inf for a row with no live key
    (as the kernel writes it)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    out = flash_attention_plain(q, k, v, causal=causal, window=window,
                                softcap=softcap, scale=scale)
    s, live = _scores(q, k, causal, window, softcap, scale)
    lse = torch.logsumexp(s.masked_fill(~live, -math.inf), dim=-1)
    return out, torch.where(live.any(-1), lse, math.inf)


def flash_attention_backward_plain(q, k, v, out, lse, dout, *,
                                   causal: bool = True,
                                   window: Optional[int] = None,
                                   softcap: Optional[float] = None,
                                   scale: Optional[float] = None):
    """The backward kernel's function in plain PyTorch, written from the
    formulas (csrc/flash_attention_bwd.cu): P = exp(s - lse) on live
    pairs, D = rowsum(dO O), dS = P (dP - D), through the softcap's
    1 - tanh^2 and the scale; dK and dV summed over each K/V head's
    group. float32 math; returns (dq, dk, dv) in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    f32 = torch.float32
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    group = hq // hkv
    s, live = _scores(q, k, causal, window, softcap, scale)
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
    do = dout.to(f32)
    vf = torch.repeat_interleave(v.to(f32), group, dim=1)
    kf = torch.repeat_interleave(k.to(f32), group, dim=1)
    delta = (do * out.to(f32)).sum(-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, vf) - delta[..., None])
    if softcap is not None:
        ds = ds * (1.0 - (s / softcap) ** 2)
    ds = ds * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(f32))
    dk = dk.reshape(b, hkv, group, lk, d).sum(2)
    dv = dv.reshape(b, hkv, group, lk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _backward_entry():
    fn = build.load("flash_attention_bwd").repro_flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _backward_work():
    """Floats of float32 workspace the backward needs at a shape: the
    rows' D, then the dK/dV partials when the kernel splits a GQA group."""
    fn = build.load("flash_attention_bwd").repro_flash_attention_bwd_work
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong
    return fn



def _mask_args(causal, window, softcap):
    return (int(causal), int(window is not None),
            0 if window is None else int(window), int(softcap is not None),
            0.0 if softcap is None else float(softcap))


def _forward(q, k, v, causal, window, softcap, scale, with_lse):
    """One launch of the forward kernel; returns (out, lse or None)."""
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds the kernel's "
                         f"{MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    lse = (q.new_empty((b, hq, lq), dtype=torch.float32) if with_lse
           else None)
    if out.numel() == 0:
        return out, lse
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   None if lse is None else lse.data_ptr(),
                   _DTYPES[q.dtype], b, hq, hkv, lq, lk, d,
                   *_mask_args(causal, window, softcap), float(scale),
                   stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    """The kernel under autograd: the forward launches the forward kernel
    with the row log-sum-exp, the backward `flash_attention_backward`'s
    kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        out, lse = _forward(q, k, v, causal, window, softcap, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = dict(causal=causal, window=window, softcap=softcap,
                         scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse,
                                              dout.contiguous(), **ctx.masks)
        return dq, dk, dv, None, None, None, None


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
    Launches on the current CUDA stream and does not synchronise. With
    grad enabled and an input that requires it, the launch also writes the
    row log-sum-exp, and the backward launches `flash_attention_backward`'s
    kernels; otherwise it launches the forward kernel alone."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale)
    build.check_card("flash_attention", q)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, softcap,
                                     float(scale))
    return _forward(q, k, v, causal, window, softcap, scale, False)[0]


flash_attention.launches = 0


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None):
    """The training forward without autograd: (out, lse) as
    `flash_attention_lse_plain` gives them. One launch of the kernel on
    the card (counted in `flash_attention.launches`), the plain version
    on the CPU."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, causal=causal,
                                         window=window, softcap=softcap,
                                         scale=scale)
    build.check_card("flash_attention", q)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _forward(q, k, v, causal, window, softcap, scale, True)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None,
                             scale: Optional[float] = None):
    """The gradient of `flash_attention` at (q, k, v): out and lse (B, Hq,
    Lq) float32 as the training forward wrote them, dout the gradient of
    out (contiguous). Returns (dq, dk, dv) in q's dtype. On the card: one
    call of `csrc/flash_attention_bwd.cu` (three launches: D = rowsum(dO
    O), dK and dV, dQ; four when dK and dV are summed from partials),
    counted once in `flash_attention_backward.launches`; on the CPU,
    `flash_attention_backward_plain`."""
    _check(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or \
                t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {q.dtype} tensor "
                             f"of q's shape {tuple(q.shape)} on {q.device}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 "
                         f"{tuple(q.shape[:3])} on {q.device}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_backward_plain(
            q, k, v, out, lse, dout, causal=causal, window=window,
            softcap=softcap, scale=scale)
    build.check_card("flash_attention_backward", q)
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds the kernel's "
                         f"{MAX_HEAD_DIM}")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    work = lse.new_empty(_backward_work()(_DTYPES[q.dtype], b, hq, hkv, lq,
                                          lk, d))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _backward_entry()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], b, hq, hkv, lq, lk,
        d, *_mask_args(causal, window, softcap), float(scale), stream)
    if err:
        raise RuntimeError(f"flash_attention_backward kernel launch failed: "
                           f"CUDA error {err}")
    flash_attention_backward.launches += 1
    return dq, dk, dv


flash_attention_backward.launches = 0
