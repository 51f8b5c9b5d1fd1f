"""Serving engines: batched LLM generation (prefill once, decode
autoregressively) and single-shot inference for the paper's ICU LSTM
classifiers.

The engines are tier-agnostic compute; tier *placement* of requests is the
paper's contribution and lives in core/ (launch/serve.py glues them: the
scheduler decides which tier's engine a request batch runs on).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.device import resolve_device, synchronize


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor         # (B, prompt + steps) int64
    prefill_seconds: float
    decode_seconds: float

    @property
    def total_seconds(self):
        return self.prefill_seconds + self.decode_seconds


def _tree_to(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class ServingEngine:
    """Runs `model` (a `DecoderModel` or an `EncDecModel`) eagerly under
    inference mode on `device` (default "cuda"; pass device="cpu" for the
    plain path). `params` are moved there; without them the model's
    parameters are drawn there by `model.init` (random, seed 0)."""

    def __init__(self, model, params: Optional[dict] = None, *,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.model = model
        if params is None:
            params = model.init(device=self.device)
        self.params = _tree_to(params, self.device)

    def generate(self, batch: dict, steps: int, *, greedy: bool = True,
                 generator: Optional[torch.Generator] = None,
                 max_len: Optional[int] = None) -> GenerationResult:
        """Prefill the prompt batch, then decode `steps` tokens. Greedy
        takes the first maximum, as `jnp.argmax` does; otherwise tokens
        are sampled from `generator` (torch cannot replay jax.random, so
        only greedy runs compare with the reference). Each clock read
        follows a synchronise, so it covers the device's work."""
        # the modality stubs (vision_embeds, frames) in the model's dtype:
        # torch does not promote a float32 input against bf16 weights
        dtype = getattr(torch, self.model.cfg.dtype)
        batch = {k: torch.as_tensor(v, device=self.device)
                 for k, v in batch.items()}
        batch = {k: v.to(dtype) if v.is_floating_point() else v
                 for k, v in batch.items()}
        prompt = batch["tokens"].to(torch.int64)
        batch["tokens"] = prompt
        plen = prompt.shape[1]
        max_len = max_len or plen + steps

        with torch.inference_mode():
            synchronize(self.device)
            t0 = time.perf_counter()
            logits, cache = self.model.prefill(self.params, batch,
                                               max_len=max_len)
            synchronize(self.device)
            t1 = time.perf_counter()

            out = [prompt]
            tok = self._sample(logits, greedy, generator)
            for i in range(steps):
                out.append(tok[:, None])
                if i == steps - 1:
                    break
                logits, cache = self.model.decode_step(self.params, tok,
                                                       cache)
                tok = self._sample(logits, greedy, generator)
            tokens = torch.cat(out, dim=1)
            synchronize(self.device)
            t2 = time.perf_counter()
        return GenerationResult(tokens=tokens, prefill_seconds=t1 - t0,
                                decode_seconds=t2 - t1)

    @staticmethod
    def _sample(logits: torch.Tensor, greedy: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if greedy or generator is None:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.to(torch.float32), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]


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
