"""Mamba2 selective-state-space scan: a hand-written CUDA kernel and its
plain version.

Port of the Pallas TPU kernel `ssm_scan` (src/repro/kernels/ssm_scan.py):
one B/C group shared by all heads, a float32 state from zero, y in x's
dtype and the final state in float32. The CUDA source, `csrc/ssm_scan.cu`,
says what bounds it on an H100 and how its design answers that: bf16
inputs take the Pallas kernel's chunked form on the tensor cores, in
chunks of 64 steps; float32 inputs take the recurrence step by step on
the CUDA cores. Both take any L, H and P, so `chunk` and `block_h` are
accepted for the signature and not used.

`ssm_scan` takes the kernel for CUDA tensors and the plain PyTorch
version for CPU tensors; on the card it launches the kernel or raises. It
has no backward kernel yet: on a CUDA tensor with grad enabled and an
input that requires grad it raises NotImplementedError rather than return
a tensor autograd cannot see (on the CPU autograd differentiates the
plain version). It counts its launches in `ssm_scan.launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE_DIM = 128


def ssm_scan_plain(x, dt, a, b, c, d, *, chunk: int = 256,
                   block_h: int = 8):
    """The kernel's function in plain PyTorch: the sequential
    `ref.ssm_scan_reference` from a zero state."""
    return ref.ssm_scan_reference(x, dt, a, b, c, d)


def _check(x, dt, a, b, c, d) -> None:
    for name, t, nd in (("x", x, 4), ("dt", dt, 3), ("a", a, 1),
                        ("b", b, 3), ("c", c, 3), ("d", d, 1)):
        if t.dim() != nd:
            raise ValueError(f"{name} must have {nd} dims, got {t.dim()}")
    bsz, l, h, _ = x.shape
    n = b.shape[-1]
    if dt.shape != (bsz, l, h):
        raise ValueError(f"dt shape {tuple(dt.shape)} != {(bsz, l, h)}")
    if a.shape != (h,) or d.shape != (h,):
        raise ValueError(f"a {tuple(a.shape)} and d {tuple(d.shape)} must "
                         f"both be {(h,)}")
    if b.shape != (bsz, l, n) or c.shape != (bsz, l, n):
        raise ValueError(f"b {tuple(b.shape)} and c {tuple(c.shape)} must "
                         f"both be (B={bsz}, L={l}, N)")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError("ssm_scan takes x, b, c of one dtype, float32 or "
                        f"bfloat16, got {x.dtype}, {b.dtype}, {c.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, a, d)):
        raise TypeError("ssm_scan takes dt, a, d in float32, got "
                        f"{dt.dtype}, {a.dtype}, {d.dtype}")
    tensors = (x, dt, a, b, c, d)
    if any(t.device != x.device for t in tensors):
        raise ValueError("ssm_scan inputs lie on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssm_scan inputs must be contiguous")


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("ssm_scan").repro_ssm_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, d: torch.Tensor, *,
             chunk: int = 256,
             block_h: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, H, P); dt: (B, L, H) (post-softplus, > 0); a: (H,) (< 0);
    b, c: (B, L, N) (single group shared across heads); d: (H,).
    Returns (y (B, L, H, P), final_state (B, H, P, N) float32). Launches
    on the current CUDA stream and does not synchronise."""
    _check(x, dt, a, b, c, d)
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, a, b, c, d)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu, not {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"ssm_scan inputs lie on {x.device}, but the "
                         f"current device is cuda:"
                         f"{torch.cuda.current_device()}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, b, c, d)):
        raise NotImplementedError(
            "ssm_scan has no backward kernel yet (ROADMAP queue 2 item 3, "
            "its backward): on the card zamba2's Mamba2 blocks run under "
            "torch.no_grad() only; train them on the CPU")
    bsz, l, h, p = x.shape
    n = b.shape[-1]
    if n > MAX_STATE_DIM:
        raise ValueError(f"state dim N={n} exceeds the kernel's "
                         f"{MAX_STATE_DIM}")
    y = torch.empty_like(x)
    if x.numel() == 0 or n == 0:      # nothing to scan: the zero state
        return y, torch.zeros((bsz, h, p, n), dtype=torch.float32,
                              device=x.device)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32,
                        device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                   c.data_ptr(), d.data_ptr(), y.data_ptr(),
                   state.data_ptr(), _DTYPES[x.dtype], bsz, l, h, p, n,
                   stream)
    if err:
        raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error "
                           f"{err}")
    ssm_scan.launches += 1
    return y, state


ssm_scan.launches = 0
