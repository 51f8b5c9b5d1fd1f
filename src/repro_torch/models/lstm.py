"""The paper's ICU LSTM workloads (Edge AIBench, Table IV).

LSTM classifier over clinical time series: (B, T, features) -> class
logits. Each layer is one call of `kernels.ops.lstm_layer`, which on the
card runs the whole sequence in one CUDA launch (the reference scans its
per-step cell over T) — the exact compute the paper's allocator places on
a tier.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.icu_lstm import ICULSTMConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import common


class ICULSTM(nn.Module):
    """Parameters keep the reference's layouts: per layer wx (I, 4, H),
    wh (H, 4, H), b (4, H); then head (H, classes), head_b (classes,).
    They are drawn on the CPU from `generator` and moved to `device`
    (default "cuda"; pass device="cpu" for the plain path)."""

    def __init__(self, cfg: ICULSTMConfig, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        layers = []
        in_dim = cfg.input_dim
        for _ in range(cfg.depth):
            layers.append(nn.ParameterDict({
                "wx": nn.Parameter(common.dense_init(generator, in_dim, 4,
                                                     cfg.hidden)),
                "wh": nn.Parameter(common.dense_init(generator, cfg.hidden,
                                                     4, cfg.hidden)),
                "b": nn.Parameter(torch.zeros(4, cfg.hidden)),
            }))
            in_dim = cfg.hidden
        self.layers = nn.ModuleList(layers)
        self.head = nn.Parameter(common.dense_init(generator, cfg.hidden,
                                                   cfg.num_classes))
        self.head_b = nn.Parameter(torch.zeros(cfg.num_classes))
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, input_dim) -> logits (B, num_classes)."""
        seq = x.transpose(0, 1).contiguous()        # (T, B, features)
        for li, layer in enumerate(self.layers):
            h, _, seq = ops.lstm_layer(
                seq, layer["wx"], layer["wh"], layer["b"],
                return_sequence=li + 1 < len(self.layers))
        return h @ self.head + self.head_b

    def loss(self, batch) -> torch.Tensor:
        """batch: {"features": (B, T, I), "labels": (B,) class ids or
        (B, classes) multi-hot}."""
        logits = self.forward(batch["features"])
        labels = batch["labels"]
        if self.cfg.num_classes == 2 and labels.dim() == 1:
            lp = torch.log_softmax(logits, dim=-1)
            return -torch.mean(lp.gather(-1, labels[:, None].long()))
        # multi-label (phenotype): sigmoid BCE over num_classes
        z = logits.to(torch.float32)
        y = labels.to(torch.float32)
        return torch.mean(torch.clamp(z, min=0) - z * y
                          + torch.log1p(torch.exp(-torch.abs(z))))
