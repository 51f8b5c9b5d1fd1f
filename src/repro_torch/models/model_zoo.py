"""build_model(cfg): the entry point for every arch of `configs`."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.decoder import DecoderModel
from repro_torch.models.encdec import EncDecModel


def build_model(cfg: ModelConfig) -> DecoderModel | EncDecModel:
    if cfg.is_encdec:
        return EncDecModel(cfg)
    return DecoderModel(cfg)
