"""Fused LSTM cell: hand-written CUDA kernels and their plain versions.

Port of the Pallas TPU kernel `lstm_cell` (src/repro/kernels/lstm_cell.py)
and of its scan over time in the reference's `ICULSTM.forward`. Two entry
points: `lstm_cell`, one step, and `lstm_sequence`, a whole layer over T
steps from a zero state in one launch. The CUDA source,
`csrc/lstm_cell.cu`, says what bounds them on an H100 and how their
designs answer that. Weights keep the reference's (I, 4, H) / (H, 4, H) /
(4, H) layout, so a hidden unit's four gates sit H apart.

Inputs are float32 or bfloat16 and the math is float32, as the Pallas
cell casts them: `lstm_cell` reads each input in its own dtype and writes
h' and c' in h's and c's; `lstm_sequence` takes one dtype for all its
inputs and returns h and c in it (rounded to it after every step, as a
scan of the cell carries them).

Each wrapper takes its kernel for CUDA tensors and its plain PyTorch
version for CPU tensors; on the card it launches the kernel or raises. It
counts its launches in `lstm_cell.launches` / `lstm_sequence.launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

# the largest x-row + h-row a block can stage in shared memory on Hopper
_MAX_SMEM_BYTES = 232_448
# lstm_sequence: one thread per gate column, at most 1024 a block; a
# segment of at least _SEQ_TC steps in csrc/lstm_cell.cu's SEQ_SMEM_CAP
MAX_SEQUENCE_HIDDEN = 256
_SEQ_TC = 16
_SEQ_SMEM_CAP = 200 * 1024


def lstm_cell_plain(x, h, c, wx, wh, b):
    """The plain PyTorch version of the kernel, on the (I, 4, H) layout."""
    i_dim, _, h_dim = wx.shape
    return ref.lstm_cell_reference(x, h, c, wx.reshape(i_dim, 4 * h_dim),
                                   wh.reshape(h_dim, 4 * h_dim),
                                   b.reshape(4 * h_dim))


def lstm_sequence_plain(xs, wx, wh, b, *, return_sequence: bool = False):
    """The plain version of the sequence kernel: a Python scan of
    `lstm_cell_plain` from h = c = 0, as the reference's `ICULSTM.forward`
    scans its cell. Returns (h_T, c_T, hs (T, B, H) or None)."""
    h = c = xs.new_zeros((xs.shape[1], wh.shape[0]))
    hs = []
    for xt in xs:
        h, c = lstm_cell_plain(xt, h, c, wx, wh, b)
        hs.append(h)
    if not return_sequence:
        return h, c, None
    return h, c, torch.stack(hs) if hs else xs.new_zeros((0,) + h.shape)


def _check_weights(i_dim, h_dim, wx, wh, b) -> None:
    if wx.shape != (i_dim, 4, h_dim):
        raise ValueError(f"wx shape {tuple(wx.shape)} != {(i_dim, 4, h_dim)}")
    if wh.shape != (h_dim, 4, h_dim):
        raise ValueError(f"wh shape {tuple(wh.shape)} != {(h_dim, 4, h_dim)}")
    if b.shape != (4, h_dim):
        raise ValueError(f"b shape {tuple(b.shape)} != {(4, h_dim)}")


_DTYPES = (torch.float32, torch.bfloat16)


def _check_tensors(op, tensors, *, one_dtype: bool) -> None:
    dtypes = {t.dtype for t in tensors}
    if not dtypes <= set(_DTYPES) or (one_dtype and len(dtypes) > 1):
        kind = "one dtype, float32 or bfloat16" if one_dtype \
            else "float32 or bfloat16 inputs"
        raise TypeError(f"{op} takes {kind}, got "
                        f"{sorted(str(d) for d in dtypes)}")
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{op} inputs lie on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{op} inputs must be contiguous")


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
    _check_weights(i_dim, h_dim, wx, wh, b)
    _check_tensors("lstm_cell", (x, h, c, wx, wh, b), one_dtype=False)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("lstm_cell").repro_lstm_cell
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_sequence(xs, wx, wh, b) -> None:
    for name, t, nd in (("xs", xs, 3), ("wx", wx, 3), ("wh", wh, 3),
                        ("b", b, 2)):
        if t.dim() != nd:
            raise ValueError(f"{name} must have {nd} dims, got {t.dim()}")
    _check_weights(xs.shape[2], wh.shape[0], wx, wh, b)
    _check_tensors("lstm_sequence", (xs, wx, wh, b), one_dtype=True)


@functools.lru_cache(maxsize=None)
def _sequence_entry():
    fn = build.load("lstm_cell").repro_lstm_sequence
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              wx: torch.Tensor, wh: torch.Tensor,
              b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, I); h, c: (B, H); wx: (I, 4, H); wh: (H, 4, H); b: (4, H).

    Gate order i, f, g, o; each input float32 or bfloat16, float32 math.
    Returns (h', c') in h's and c's dtypes. Launches on the current CUDA
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
    # bit k: input k of (x, h, c, wx, wh, b) is bfloat16
    dtypes = sum(1 << k for k, t in enumerate((x, h, c, wx, wh, b))
                 if t.dtype == torch.bfloat16)
    err = _entry()(x.data_ptr(), h.data_ptr(), c.data_ptr(), wx.data_ptr(),
                   wh.data_ptr(), b.data_ptr(), h_out.data_ptr(),
                   c_out.data_ptr(), bsz, i_dim, h_dim, dtypes, stream)
    if err:
        raise RuntimeError(f"lstm_cell kernel launch failed: CUDA error "
                           f"{err}")
    lstm_cell.launches += 1
    return h_out, c_out


lstm_cell.launches = 0


def lstm_sequence(xs: torch.Tensor, wx: torch.Tensor, wh: torch.Tensor,
                  b: torch.Tensor, *, return_sequence: bool = False
                  ) -> tuple[torch.Tensor, torch.Tensor,
                             torch.Tensor | None]:
    """xs: (T, B, I); wx: (I, 4, H); wh: (H, 4, H); b: (4, H).

    T steps of `lstm_cell` from h = c = 0, gate order i, f, g, o; the
    inputs all float32 or all bfloat16, float32 math, h and c carried in
    the inputs' dtype. Returns (h_T, c_T, hs): hs is the (T, B, H) hidden
    sequence when `return_sequence`, else None. On the card: one launch, on the current
    CUDA stream, no synchronise."""
    _check_sequence(xs, wx, wh, b)
    if xs.device.type == "cpu":
        return lstm_sequence_plain(xs, wx, wh, b,
                                   return_sequence=return_sequence)
    if xs.device.type != "cuda":
        raise ValueError(f"lstm_sequence runs on cuda or cpu, not "
                         f"{xs.device}")
    if xs.device.index != torch.cuda.current_device():
        raise ValueError(f"lstm_sequence inputs lie on {xs.device}, but the "
                         f"current device is cuda:"
                         f"{torch.cuda.current_device()}")
    t_len, bsz, i_dim = xs.shape
    h_dim = wh.shape[0]
    if h_dim > MAX_SEQUENCE_HIDDEN:
        raise ValueError(f"hidden size {h_dim} exceeds the sequence "
                         f"kernel's {MAX_SEQUENCE_HIDDEN} (one thread per "
                         f"gate column)")
    h_floats = max(-(-h_dim // 4) * 4, 32)
    if (h_floats + 4 * h_dim + _SEQ_TC * (i_dim + 4 * h_dim)) * 4 \
            > _SEQ_SMEM_CAP:
        raise ValueError(f"a segment of {_SEQ_TC} steps at I = {i_dim}, "
                         f"H = {h_dim} exceeds a block's shared memory")
    hs = xs.new_empty((t_len, bsz, h_dim)) if return_sequence else None
    if t_len == 0 or bsz == 0 or h_dim == 0:
        return (xs.new_zeros((bsz, h_dim)), xs.new_zeros((bsz, h_dim)), hs)
    h_out = xs.new_empty((bsz, h_dim))
    c_out = xs.new_empty((bsz, h_dim))
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    err = _sequence_entry()(xs.data_ptr(), wx.data_ptr(), wh.data_ptr(),
                            b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
                            None if hs is None else hs.data_ptr(),
                            t_len, bsz, i_dim, h_dim,
                            int(xs.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"lstm_sequence kernel launch failed: CUDA error "
                           f"{err}")
    lstm_sequence.launches += 1
    return h_out, c_out, hs


lstm_sequence.launches = 0
