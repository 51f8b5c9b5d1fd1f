"""Entry points the models call for the port's kernels.

Each op takes the hand-written CUDA kernel for CUDA tensors, at any shape
(the kernels take ragged lengths), and for CPU tensors the plain path the
reference takes off the TPU. There is no switch to the plain path on the
card: a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.lstm_cell import lstm_cell
from repro_torch.kernels.mlstm_chunk import mlstm_chunk
from repro_torch.kernels.ssm_scan import ssm_scan

__all__ = ["attention", "lstm_step", "ssm", "mlstm", "flash_attention",
           "lstm_cell", "ssm_scan", "mlstm_chunk"]


def attention(q, k, v, *, causal=True, window=None, softcap=None,
              scale=None, block_q=128, block_k=128):
    if q.device.type != "cpu":
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale,
                               block_q=block_q, block_k=block_k)
    if q.shape[-2] >= 1024:  # production shapes: block-wise, memory-bounded
        return ref.attention_blockwise(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale)
    return ref.attention_reference(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)


def lstm_step(x, h, c, wx, wh, b):
    """wx: (I, 4, H); wh: (H, 4, H); b: (4, H)."""
    return lstm_cell(x, h, c, wx, wh, b)


def ssm(x, dt, a, b, c, d, *, chunk=256, block_h=8):
    if x.device.type != "cpu":
        return ssm_scan(x, dt, a, b, c, d, chunk=chunk, block_h=block_h)
    return ref.ssm_scan_reference(x, dt, a, b, c, d)


def mlstm(q, k, v, i_gate, f_gate, *, chunk=64, block_h=4):
    """Returns (y, (C, n, m) final state)."""
    if q.device.type != "cpu":
        return mlstm_chunk(q, k, v, i_gate, f_gate, chunk=chunk,
                           block_h=block_h)
    if q.shape[1] >= 256:   # chunkwise: O(L/chunk) state, as the reference
        return ref.mlstm_chunk_torch(q, k, v, i_gate, f_gate, chunk=256)
    return ref.mlstm_chunk_reference(q, k, v, i_gate, f_gate)
