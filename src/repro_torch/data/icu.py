"""Synthetic MIMIC-III-like ICU time series (the paper's data substrate).

MIMIC-III requires credentialed access, so we generate a statistically
similar stand-in following the Harutyunyan et al. clinical benchmark format
the paper uses: 48 hourly timesteps x 76 features (17 vitals + one-hot
masks), with label-dependent drift so the paper's three LSTM tasks are
learnable:

  * short-of-breath alerts     — binary, respiratory features drift up
  * life-death prediction      — binary (in-hospital mortality)
  * phenotype classification   — 25 independent binary labels

Byte sizes per record are matched to the paper's Table IV real sizes so the
transmission-time model sees realistic payloads.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.configs.icu_lstm import ICULSTMConfig

# paper Table IV: real dataset bytes per (workload, size-unit) — KB / units
PAPER_BYTES_PER_UNIT = {
    "short-of-breath-alerts": 700 * 1024 / 64,          # ~10.9 KiB/unit
    "life-death-prediction": 479 * 1024 / 64,           # ~7.5 KiB/unit
    "patient-phenotype-classification": 836 * 1024 / 64,  # ~13.1 KiB/unit
}


def generate(cfg: ICULSTMConfig, n: int, seed: int = 0
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (features (n, T, input_dim) f32, labels).

    Binary tasks: labels (n,) int32. Phenotype: (n, 25) multi-hot."""
    rng = np.random.default_rng(seed)
    t, f = cfg.seq_len, cfg.input_dim
    x = rng.standard_normal((n, t, f)).astype(np.float32)
    drift = np.linspace(0.0, 1.0, t, dtype=np.float32)[None, :, None]

    if cfg.num_classes == 25:  # phenotype multi-label
        y = (rng.random((n, 25)) < 0.3).astype(np.int32)
        # each phenotype k adds signal on features 3k..3k+2
        for k in range(25):
            sel = y[:, k].astype(np.float32)[:, None, None]
            x[..., 3 * k % f:(3 * k % f) + 3] += 0.8 * sel * drift
        return x, y

    y = (rng.random(n) < 0.35).astype(np.int32)
    sel = y.astype(np.float32)[:, None, None]
    x[..., : max(4, f // 4)] += 1.0 * sel * drift      # vitals deteriorate
    return x, y


def record_bytes(cfg: ICULSTMConfig) -> float:
    """Bytes per data unit, matched to the paper's Table IV sizes."""
    return PAPER_BYTES_PER_UNIT[cfg.name]
