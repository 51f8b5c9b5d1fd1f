"""Entry points the models call for the port's kernels.

Each op takes the hand-written CUDA kernel for CUDA tensors and the plain
PyTorch version for CPU tensors (the wrapper decides from the tensors'
device), so the same model code runs in the CPU tests and on the card.
"""
from __future__ import annotations

from repro_torch.kernels.lstm_cell import lstm_cell

__all__ = ["lstm_step", "lstm_cell"]


def lstm_step(x, h, c, wx, wh, b):
    """wx: (I, 4, H); wh: (H, 4, H); b: (4, H)."""
    return lstm_cell(x, h, c, wx, wh, b)
