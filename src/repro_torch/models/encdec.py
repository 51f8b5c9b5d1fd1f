"""Encoder-decoder model (seamless-m4t family).

As in the reference, the speech frontend is a stub: the encoder consumes
precomputed frame embeddings (B, frames, d_model) through a non-causal
stack of ATTN blocks. The decoder is a causal stack where every layer is
(self-attention, cross-attention, MLP), a TransformerStack with pattern
(ATTN, CROSS) applied num_layers times, cross-attending to the encoder's
output. Parameters keep the reference's pytree: {"embed", "enc_norm",
"final_norm", "encoder", "decoder", "unembed"}.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs import base
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common
from repro_torch.models.decoder import (TransformerStack, _mask_vocab_pad,
                                        chunked_nll, next_token_targets,
                                        padded_vocab)

ENCODER_PATTERN = (base.ATTN,)
DECODER_PATTERN = (base.ATTN, base.CROSS)


class EncDecModel:
    """batch keys: "tokens" (B, L) integer target ids, "frames" (B, F,
    d_model) stub-encoder frame embeddings."""

    def __init__(self, cfg: ModelConfig, remat: bool = False):
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.name}: EncDecModel needs "
                             f"encoder_layers > 0")
        self.cfg = cfg
        self.encoder = TransformerStack(cfg, pattern=ENCODER_PATTERN,
                                        num_groups=cfg.encoder_layers,
                                        remat=remat)
        self.decoder = TransformerStack(cfg, pattern=DECODER_PATTERN,
                                        num_groups=cfg.num_layers,
                                        remat=remat)

    def init(self, generator: Optional[torch.Generator] = None,
             device: str | torch.device | None = None) -> dict:
        """Parameters drawn on `device` (default "cuda"; pass device="cpu"
        for the plain path) from `generator`, which must live there
        (default: seed 0). Norms, biases and gate_attn are 0, as in the
        reference."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        elif generator.device.type != dev.type:
            raise ValueError(f"the generator lives on {generator.device}, "
                             f"the parameters are drawn on {dev}")
        cfg = self.cfg
        dtype = common.torch_dtype(cfg.dtype)
        vpad = padded_vocab(cfg.vocab_size)
        p = {"embed": common.embed_init(generator, vpad, cfg.d_model, dtype),
             "enc_norm": common.norm_init(cfg.d_model, dtype, dev),
             "final_norm": common.norm_init(cfg.d_model, dtype, dev),
             "encoder": self.encoder.init(generator),
             "decoder": self.decoder.init(generator)}
        if not cfg.tie_embeddings:
            p["unembed"] = common.dense_init(generator, cfg.d_model, vpad,
                                             dtype=dtype)
        return p

    def encode(self, p: dict, frames: torch.Tensor) -> torch.Tensor:
        ctx = {"cfg": self.cfg, "causal": False, "cross_states": None}
        x, _, _ = self.encoder.apply(p["encoder"], frames, ctx, mode="train")
        return common.rms_norm(x, p["enc_norm"], self.cfg.norm_eps)

    def _embed(self, p: dict, tokens: torch.Tensor) -> torch.Tensor:
        x = p["embed"][tokens]
        # sqrt(d) rounded to the model's dtype, as the reference scales
        scale = float(torch.tensor(math.sqrt(self.cfg.d_model),
                                   dtype=x.dtype))
        return x * scale

    def _head(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = common.rms_norm(x, p["final_norm"], cfg.norm_eps)
        w = p["embed"].t() if cfg.tie_embeddings else p["unembed"]
        return _mask_vocab_pad((x @ w).to(torch.float32), cfg.vocab_size)

    def forward(self, p: dict, batch: dict):
        """Full-sequence forward. Returns (logits, aux)."""
        enc = self.encode(p, batch["frames"])
        x = self._embed(p, batch["tokens"])
        ctx = {"cfg": self.cfg, "causal": True, "cross_states": enc}
        x, _, aux = self.decoder.apply(p["decoder"], x, ctx, mode="train")
        return self._head(p, x), aux

    def loss(self, p: dict, batch: dict, *,
             loss_chunk: int = 512) -> torch.Tensor:
        """Next-token cross-entropy of the decoder over the encoded
        frames, the LM head in chunks (`chunked_nll`)."""
        enc = self.encode(p, batch["frames"])
        tokens = batch["tokens"]
        x = self._embed(p, tokens)
        ctx = {"cfg": self.cfg, "causal": True, "cross_states": enc}
        x, _, _ = self.decoder.apply(p["decoder"], x, ctx, mode="train")
        labels, weights = next_token_targets(tokens)
        return chunked_nll(lambda h: self._head(p, h), x, labels, weights,
                           loss_chunk)

    def prefill(self, p: dict, batch: dict, max_len: Optional[int] = None):
        """Returns (last-token logits (B, V), cache); max_len as in
        DecoderModel.prefill."""
        enc = self.encode(p, batch["frames"])
        tokens = batch["tokens"]
        cache_len = max_len or tokens.shape[1]
        x = self._embed(p, tokens)
        ctx = {"cfg": self.cfg, "causal": True, "cross_states": enc,
               "cache_len": cache_len}
        x, caches, _ = self.decoder.apply(p["decoder"], x, ctx,
                                          mode="prefill")
        logits = self._head(p, x[:, -1:])[:, 0]
        return logits, {"pos": tokens.shape[1], "groups": caches}

    def decode_step(self, p: dict, token: torch.Tensor, cache: dict):
        """token: (B,) ids; returns (logits (B, V), cache). The self
        attention caches are written in place."""
        x = self._embed(p, token[:, None])
        ctx = {"cfg": self.cfg, "causal": True, "pos": cache["pos"],
               "cross_states": None}
        x, caches, _ = self.decoder.apply(p["decoder"], x, ctx,
                                          caches=cache["groups"],
                                          mode="decode")
        logits = self._head(p, x)[:, 0]
        return logits, {"pos": cache["pos"] + 1, "groups": caches}

    def init_cache(self, batch: int, cache_len: int,
                   device: str | torch.device | None = None) -> dict:
        """Zero decode cache (for fresh decode sessions)."""
        dtype = common.torch_dtype(self.cfg.dtype)
        return {"pos": 0,
                "groups": self.decoder.empty_caches(batch, cache_len, dtype,
                                                    resolve_device(device))}
