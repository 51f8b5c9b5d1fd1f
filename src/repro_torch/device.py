"""Device choice for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. Without a
CUDA device they raise instead of dropping to the CPU, so a number taken on
the CPU is never reported as if it came from the card.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None means "cuda". Raises RuntimeError for a CUDA device when
    torch sees none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU), so that a
    host clock read after it covers the work and not only its enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
