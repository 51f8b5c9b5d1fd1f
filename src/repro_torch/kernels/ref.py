"""Plain PyTorch versions of the port's kernels.

They are the ground truth the CUDA kernels are held against (on the card
in chip_smoke.py, on the CPU against the JAX package in the tests), and
the path a wrapper takes for tensors that lie on the CPU.
"""
from __future__ import annotations

import torch


def lstm_cell_reference(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
                        wx: torch.Tensor, wh: torch.Tensor,
                        b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused LSTM cell step (the paper's ICU workload hot-spot).

    x: (B, I); h, c: (B, H); wx: (I, 4H); wh: (H, 4H); b: (4H,).
    Gate order: input, forget, cell(g), output. Returns (h', c') in the
    dtypes of h and c, computed in float32.
    """
    f32 = torch.float32
    gates = (x.to(f32) @ wx.to(f32) + h.to(f32) @ wh.to(f32) + b.to(f32))
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c_new = f * c.to(f32) + i * g
    h_new = o * torch.tanh(c_new)
    return h_new.to(h.dtype), c_new.to(c.dtype)
