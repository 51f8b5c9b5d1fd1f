"""Fused LSTM cell step: a hand-written CUDA kernel and its plain version.

Port of the Pallas TPU kernel `lstm_cell` (src/repro/kernels/lstm_cell.py).
The CUDA source, `csrc/lstm_cell.cu`, says what bounds the step on an H100
and how its design answers that. Weights keep the reference's (I, 4, H) /
(H, 4, H) / (4, H) layout, so a hidden unit's four gates sit H apart.

`lstm_cell` takes the kernel for CUDA tensors and the plain PyTorch
version for CPU tensors; on the card it launches the kernel or raises. It
counts its launches in `lstm_cell.launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

# the largest x-row + h-row a block can stage in shared memory on Hopper
_MAX_SMEM_BYTES = 232_448


def lstm_cell_plain(x, h, c, wx, wh, b):
    """The plain PyTorch version of the kernel, on the (I, 4, H) layout."""
    i_dim, _, h_dim = wx.shape
    return ref.lstm_cell_reference(x, h, c, wx.reshape(i_dim, 4 * h_dim),
                                   wh.reshape(h_dim, 4 * h_dim),
                                   b.reshape(4 * h_dim))


def _check(x, h, c, wx, wh, b) -> None:
    for name, t, nd in (("x", x, 2), ("h", h, 2), ("c", c, 2),
                        ("wx", wx, 3), ("wh", wh, 3), ("b", b, 2)):
        if t.dim() != nd:
            raise ValueError(f"{name} must have {nd} dims, got {t.dim()}")
    bsz, i_dim = x.shape
    h_dim = h.shape[1]
    if h.shape != (bsz, h_dim) or c.shape != (bsz, h_dim):
        raise ValueError(f"h {tuple(h.shape)} and c {tuple(c.shape)} must "
                         f"both be {(bsz, h_dim)}")
    if wx.shape != (i_dim, 4, h_dim):
        raise ValueError(f"wx shape {tuple(wx.shape)} != {(i_dim, 4, h_dim)}")
    if wh.shape != (h_dim, 4, h_dim):
        raise ValueError(f"wh shape {tuple(wh.shape)} != {(h_dim, 4, h_dim)}")
    if b.shape != (4, h_dim):
        raise ValueError(f"b shape {tuple(b.shape)} != {(4, h_dim)}")
    tensors = (x, h, c, wx, wh, b)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("lstm_cell takes float32 only, got "
                        f"{sorted({str(t.dtype) for t in tensors})}")
    if any(t.device != x.device for t in tensors):
        raise ValueError("lstm_cell inputs lie on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lstm_cell inputs must be contiguous")


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("lstm_cell").repro_lstm_cell_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              wx: torch.Tensor, wh: torch.Tensor,
              b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, I); h, c: (B, H); wx: (I, 4, H); wh: (H, 4, H); b: (4, H).

    Gate order i, f, g, o. Returns (h', c'). Launches on the current CUDA
    stream and does not synchronise."""
    _check(x, h, c, wx, wh, b)
    if x.device.type == "cpu":
        return lstm_cell_plain(x, h, c, wx, wh, b)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_cell runs on cuda or cpu, not {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"lstm_cell inputs lie on {x.device}, but the "
                         f"current device is cuda:"
                         f"{torch.cuda.current_device()}")
    bsz, i_dim = x.shape
    h_dim = h.shape[1]
    if (i_dim + h_dim) * 4 > _MAX_SMEM_BYTES:
        raise ValueError(f"I + H = {i_dim + h_dim} floats exceed a block's "
                         f"shared memory")
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    if bsz == 0 or h_dim == 0:
        return h_out, c_out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(),
                   wh.data_ptr(), b.data_ptr(), h_out.data_ptr(),
                   c_out.data_ptr(), bsz, i_dim, h_dim, stream)
    if err:
        raise RuntimeError(f"lstm_cell kernel launch failed: CUDA error "
                           f"{err}")
    lstm_cell.launches += 1
    return h_out, c_out


lstm_cell.launches = 0
