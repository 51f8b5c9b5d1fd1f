"""build_model(cfg): the entry point for the archs of `configs`.

The port builds the decoder-only archs whose block kinds it has ported
(zamba2 in this slice) and refuses the rest with NotImplementedError
naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.decoder import DecoderModel


def build_model(cfg: ModelConfig) -> DecoderModel:
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models are not ported yet "
            "(ROADMAP, queue 1 item 9: encdec.py)")
    for kind in cfg.group_pattern:
        if kind not in blocks._APPLY:
            raise blocks.not_ported(kind)
    return DecoderModel(cfg)
