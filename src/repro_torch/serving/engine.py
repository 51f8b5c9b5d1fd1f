"""Single-shot inference engine for the paper's ICU LSTM classifiers.

The engine is tier-agnostic compute; tier *placement* of requests is the
paper's contribution and lives in core/ (launch/serve.py glues them: the
scheduler decides which tier's engine a request batch runs on).
"""
from __future__ import annotations

import time

import torch

from repro_torch.device import resolve_device, synchronize


class ClassifierEngine:
    """Runs `model` eagerly under inference mode on `device` (default
    "cuda"; pass device="cpu" for the plain path)."""

    def __init__(self, model: torch.nn.Module,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    def infer(self, features):
        """features: (B, T, I) array or tensor -> (logits, seconds). The
        copy to the device happens before the clock starts; the clock
        reads follow a synchronise, so they bracket the device's work."""
        x = torch.as_tensor(features, dtype=torch.float32,
                            device=self.device)
        with torch.inference_mode():
            synchronize(self.device)
            t0 = time.perf_counter()
            logits = self.model(x)
            synchronize(self.device)
            return logits, time.perf_counter() - t0
