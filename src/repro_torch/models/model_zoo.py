"""build_model(cfg): the entry point for every arch of `configs`."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.decoder import DecoderModel
from repro_torch.models.encdec import EncDecModel


def build_model(cfg: ModelConfig,
                remat: bool = False) -> DecoderModel | EncDecModel:
    """remat: recompute each group in the backward of a training forward
    (`TransformerStack`), trading one more forward for the activations."""
    if cfg.is_encdec:
        return EncDecModel(cfg, remat=remat)
    return DecoderModel(cfg, remat=remat)
