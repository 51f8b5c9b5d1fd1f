"""Chunkwise mLSTM (xLSTM matrix memory): a hand-written CUDA kernel and
its plain version.

Port of the Pallas TPU kernel `mlstm_chunk` (src/repro/kernels/
mlstm_chunk.py): q, k, v (B, L, H, D) and the pre-activation gates
(B, L, H) from a zero state; y in q's dtype and the final (C, n, m) in
float32. The CUDA source, `csrc/mlstm_chunk.cu`, says what bounds it on an
H100 and how its design answers that: a block owns 64 value columns of
one head's D×D memory and walks the chunks in order, bf16 inputs run its
products on the tensor cores and float32 inputs on the CUDA cores, and
the last chunk may be ragged, so any L and H work and `block_h` is
accepted for the signature and not used.

`mlstm_chunk` takes the kernel for CUDA tensors and the plain PyTorch
version for CPU tensors; on the card it launches the kernel or raises. It
has no backward kernel yet: on a CUDA tensor with grad enabled and an
input that requires grad it raises NotImplementedError rather than return
a tensor autograd cannot see (on the CPU autograd differentiates the
plain version). It counts its launches in `mlstm_chunk.launches`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 512
CHUNK = 64          # the kernel's chunk length, the xLSTM call site's


def mlstm_chunk_plain(q, k, v, i_gate, f_gate, *, chunk: int = CHUNK,
                      block_h: int = 4):
    """The kernel's function in plain PyTorch: the chunkwise
    `ref.mlstm_chunk_torch` at the kernel's chunk, which takes the
    sequential oracle where the chunk does not divide L."""
    return ref.mlstm_chunk_torch(q, k, v, i_gate, f_gate, chunk=chunk)


def _check(q, k, v, i_gate, f_gate) -> None:
    for name, t, nd in (("q", q, 4), ("k", k, 4), ("v", v, 4),
                        ("i_gate", i_gate, 3), ("f_gate", f_gate, 3)):
        if t.dim() != nd:
            raise ValueError(f"{name} must have {nd} dims, got {t.dim()}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must have one shape")
    bsz, l, h, d = q.shape
    if i_gate.shape != (bsz, l, h) or f_gate.shape != (bsz, l, h):
        raise ValueError(f"gate shapes {tuple(i_gate.shape)} and "
                         f"{tuple(f_gate.shape)} must both be {(bsz, l, h)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("mlstm_chunk takes q, k, v of one dtype, float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if i_gate.dtype != torch.float32 or f_gate.dtype != torch.float32:
        raise TypeError("mlstm_chunk takes the gates in float32, got "
                        f"{i_gate.dtype}, {f_gate.dtype}")
    tensors = (q, k, v, i_gate, f_gate)
    if any(t.device != q.device for t in tensors):
        raise ValueError("mlstm_chunk inputs lie on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim D={d} exceeds the kernel's "
                         f"{MAX_HEAD_DIM}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mlstm_chunk inputs must be contiguous")


@functools.lru_cache(maxsize=None)
def _entry():
    fn = build.load("mlstm_chunk").repro_mlstm_chunk
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                i_gate: torch.Tensor, f_gate: torch.Tensor, *,
                chunk: int = CHUNK, block_h: int = 4):
    """q, k, v: (B, L, H, D), float32 or bfloat16; i_gate, f_gate:
    (B, L, H) float32 pre-activation. Returns (y (B, L, H, D) in q's
    dtype, (C (B, H, D, D), n (B, H, D), m (B, H)) float32 final state).
    On the card the kernel's chunk is 64 whatever `chunk` says (the
    chunking changes only the order of float32 sums). Launches on the
    current CUDA stream and does not synchronise."""
    _check(q, k, v, i_gate, f_gate)
    if q.device.type == "cpu":
        return mlstm_chunk_plain(q, k, v, i_gate, f_gate, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_chunk runs on cuda or cpu, not {q.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"mlstm_chunk inputs lie on {q.device}, but the "
                         f"current device is cuda:"
                         f"{torch.cuda.current_device()}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, i_gate, f_gate)):
        raise NotImplementedError(
            "mlstm_chunk has no backward kernel yet (ROADMAP queue 2 item 4, "
            "its backward): on the card xlstm's mLSTM blocks run under "
            "torch.no_grad() only; train them on the CPU")
    bsz, l, h, d = q.shape
    f32 = torch.float32
    y = torch.empty_like(q)
    c = torch.empty((bsz, h, d, d), dtype=f32, device=q.device)
    n = torch.empty((bsz, h, d), dtype=f32, device=q.device)
    m = torch.empty((bsz, h), dtype=f32, device=q.device)
    if q.numel() == 0:                # nothing to scan: the zero state
        return y, (c.zero_(), n.zero_(), m.fill_(ref.NEG_INF))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                   i_gate.data_ptr(), f_gate.data_ptr(), y.data_ptr(),
                   c.data_ptr(), n.data_ptr(), m.data_ptr(),
                   _DTYPES[q.dtype], bsz, l, h, d, stream)
    if err:
        raise RuntimeError(f"mlstm_chunk kernel launch failed: CUDA error "
                           f"{err}")
    mlstm_chunk.launches += 1
    return y, (c, n, m)


mlstm_chunk.launches = 0
