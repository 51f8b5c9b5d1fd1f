"""Decoder-only model: embeddings + a stack of block groups + LM head.

Parameters keep the reference's pytree: {"embed", "final_norm", "stack":
{"groups": {"b<i>_<kind>": ...}, "shared": ...}, "unembed"}, each group
leaf stacked on a leading num_groups axis, and the shared attention block
(zamba2) initialised once and routed through ctx. The reference's
`lax.scan` over groups is a Python loop here; decode caches are a list
with one dict per group, and the decode position is a host int, so a
decode step reads nothing back from the card. Group leaves are drawn one
group at a time into tensors allocated once for all groups, so a model
that takes most of the card is never held twice. The reference's sharding
constraints have no counterpart on one card and are left out. `loss`
evaluates the LM head in sequence chunks, each recomputed in the backward
(`chunked_nll`), as the reference's `jax.checkpoint`ed scan does. With
`remat`, training under grad recomputes each group in the backward as
well (`TransformerStack.apply`), as the reference's `jax.checkpoint` of
its scan body does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import base
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks, common

AUX_KEYS = ("moe_aux",)
VOCAB_PAD_MULTIPLE = 256   # the reference pads the vocab to shard it evenly


def padded_vocab(vocab_size: int) -> int:
    m = VOCAB_PAD_MULTIPLE
    return ((vocab_size + m - 1) // m) * m


def _mask_vocab_pad(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """-1e30 on the padding logits (additive, keeps the padded shape)."""
    vpad = logits.shape[-1]
    if vpad == vocab_size:
        return logits
    pad = torch.arange(vpad, device=logits.device) >= vocab_size
    return logits + torch.where(pad, -1e30, 0.0).to(logits.dtype)


def chunked_nll(head_fn, x: torch.Tensor, labels: torch.Tensor,
                weights: torch.Tensor, chunk: int) -> torch.Tensor:
    """Mean next-token NLL without materialising the full-vocab logits.

    head_fn: (B, T, d) -> (B, T, V) float32 logits. x: (B, S, d); labels,
    weights: (B, S). The head runs over S in `chunk`-token slices (when
    `chunk` divides S and S > chunk; else once over all of S), each slice
    recomputed in the backward instead of saved (`torch.utils.checkpoint`,
    as the reference's `jax.checkpoint` of its scan body); positions with
    weight 0 are ignored."""
    s = x.shape[1]
    denom = torch.clamp(torch.sum(weights), min=1.0)
    if s % chunk or s <= chunk:
        return -_nll_sum(head_fn(x), labels, weights) / denom

    def body(xs, ls, ws):
        return _nll_sum(head_fn(xs), ls, ws)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        total = total + checkpoint(body, x[:, sl], labels[:, sl],
                                   weights[:, sl], use_reentrant=False)
    return -total / denom


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor,
             weights: torch.Tensor) -> torch.Tensor:
    """Weighted sum of log p(labels): an explicit log-sum-exp under a
    stopped max, as the reference; the target logit is gathered where the
    reference contracts a one-hot (the same value, without a (B, T, V)
    one-hot)."""
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    tgt = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum((tgt - lse) * weights)


def next_token_targets(tokens: torch.Tensor):
    """(labels, weights): token t + 1 at position t, the last position
    masked (weight 0) so the sequence length stays that of the tokens."""
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       dim=1)
    weights = torch.ones(tokens.shape, dtype=torch.float32,
                         device=tokens.device)
    weights[:, -1] = 0.0
    return labels, weights


def _alloc_stacked(tree, n: int):
    """An empty tree like `tree` with a leading axis of n on every leaf."""
    if isinstance(tree, dict):
        return {k: _alloc_stacked(v, n) for k, v in tree.items()}
    return tree.new_empty((n,) + tuple(tree.shape))


def _put(stacked, tree, g: int) -> None:
    """Copy `tree` into slot g of the stacked tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _put(stacked[k], v, g)
    else:
        stacked[g].copy_(tree)


def _unbind(tree, n: int) -> list:
    """The n groups of a stacked tree (views, no copy), each leaf split
    by one `unbind`: under autograd its backward stacks the groups'
    gradients once, where indexing group by group would add a zero-filled
    gradient of the whole stacked leaf per group."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][g] for k in tree} for g in range(n)]
    return list(torch.unbind(tree, 0))


class TransformerStack:
    """num_groups copies of a block pattern (cfg.group_pattern unless
    given), applied one after another. Shared-weight blocks (zamba2) are
    initialised once and reach the blocks through ctx. With `remat`, a
    training forward under grad saves only each group's input and
    recomputes the group in the backward."""

    def __init__(self, cfg: ModelConfig, pattern: Optional[tuple] = None,
                 num_groups: Optional[int] = None, remat: bool = False):
        self.cfg = cfg
        self.pattern = pattern or cfg.group_pattern
        self.num_groups = num_groups or cfg.num_groups
        self.has_shared = base.SHARED_ATTN in self.pattern
        self.remat = remat

    def _init_group(self, generator: torch.Generator) -> dict:
        return {f"b{i}_{kind}": blocks.init_block(kind, generator, self.cfg)
                for i, kind in enumerate(self.pattern)}

    def init(self, generator: torch.Generator) -> dict:
        first = self._init_group(generator)
        groups = _alloc_stacked(first, self.num_groups)
        _put(groups, first, 0)
        del first
        for g in range(1, self.num_groups):
            _put(groups, self._init_group(generator), g)
        p = {"groups": groups}
        if self.has_shared:
            p["shared"] = blocks._init_attn_mlp(generator, self.cfg)
        return p

    def _group(self, gp: dict, x: torch.Tensor, ctx: dict,
               gcache: Optional[dict], mode: str):
        """One group's blocks: (x, {block: cache out}, {aux key: sum})."""
        out, aux_sum = {}, {k: 0.0 for k in AUX_KEYS}
        for i, kind in enumerate(self.pattern):
            key = f"b{i}_{kind}"
            x, out[key], aux = blocks.apply_block(
                kind, gp[key], x, ctx,
                gcache[key] if gcache is not None else None, mode)
            for k in AUX_KEYS:
                aux_sum[k] = aux_sum[k] + aux.get(k, 0.0)
        return x, out, aux_sum

    def apply(self, p: dict, x: torch.Tensor, ctx: dict,
              caches: Optional[list] = None, mode: str = "train"):
        """caches: one dict per group (decode) or None.

        Returns (x, caches_out | None, aux dict). With `remat`, in train
        mode under grad each group runs through a non-reentrant
        `torch.utils.checkpoint`: it follows the tensors the group reads
        through ctx (zamba2's shared weights, the cross states) without
        taking them as inputs, and hands the group's outputs, the MoE aux
        terms included, to autograd as they are."""
        ctx = dict(ctx)
        if self.has_shared:
            ctx["shared_attn"] = p["shared"]
        collect = mode in ("prefill", "decode")
        remat = self.remat and mode == "train" and torch.is_grad_enabled()
        caches_out = [] if collect else None
        aux_sum = {k: 0.0 for k in AUX_KEYS}
        for g, gp in enumerate(_unbind(p["groups"], self.num_groups)):
            gcache = caches[g] if mode == "decode" else None
            if remat:
                x, out, aux = checkpoint(self._group, gp, x, ctx, gcache,
                                         mode, use_reentrant=False)
            else:
                x, out, aux = self._group(gp, x, ctx, gcache, mode)
            for k in AUX_KEYS:
                aux_sum[k] = aux_sum[k] + aux[k]
            if collect:
                caches_out.append(out)
        return x, caches_out, aux_sum

    def empty_caches(self, batch: int, cache_len: int, dtype: torch.dtype,
                     device: torch.device) -> list:
        return [{f"b{i}_{kind}": blocks.empty_block_cache(
                    kind, self.cfg, batch, cache_len, dtype, device)
                 for i, kind in enumerate(self.pattern)}
                for _ in range(self.num_groups)]


class DecoderModel:
    """tokens (+ vision embeddings for the vlm family) -> logits, with
    KV/state caches.

    batch dict keys: "tokens" (B, L) integer token ids; vlm additionally
    "vision_embeds" (B, S_v, vision_dim)."""

    def __init__(self, cfg: ModelConfig, remat: bool = False):
        self.cfg = cfg
        self.stack = TransformerStack(cfg, remat=remat)

    # ------------------------------------------------------------- params
    def init(self, generator: Optional[torch.Generator] = None,
             device: str | torch.device | None = None) -> dict:
        """Parameters drawn on `device` (default "cuda"; pass device="cpu"
        for the plain path) from `generator`, which must live there
        (default: seed 0). Constant leaves as in the reference: norms,
        lora_b, dt_bias, a_log, conv biases, qkv biases and gate_attn 0,
        d_skip 1."""
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
             "final_norm": common.norm_init(cfg.d_model, dtype, dev),
             "stack": self.stack.init(generator)}
        if not cfg.tie_embeddings:
            p["unembed"] = common.dense_init(generator, cfg.d_model, vpad,
                                             dtype=dtype)
        if cfg.family == "vlm":
            p["vision_proj"] = common.dense_init(generator, cfg.vision_dim,
                                                 cfg.d_model, dtype=dtype)
        return p

    # -------------------------------------------------------------- pieces
    def _embed(self, p: dict, tokens: torch.Tensor) -> torch.Tensor:
        x = p["embed"][tokens]
        # sqrt(d) rounded to the model's dtype, as the reference scales;
        # a Python scalar, so nothing is copied to the device
        scale = float(torch.tensor(math.sqrt(self.cfg.d_model),
                                   dtype=x.dtype))
        return x * scale

    def _head(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = common.rms_norm(x, p["final_norm"], cfg.norm_eps)
        w = p["embed"].t() if cfg.tie_embeddings else p["unembed"]
        logits = (x @ w).to(torch.float32)
        if cfg.final_logit_softcap is not None:
            logits = common.softcap(logits, cfg.final_logit_softcap)
        return _mask_vocab_pad(logits, cfg.vocab_size)

    def _cross_states(self, p: dict, batch: dict) -> Optional[torch.Tensor]:
        if self.cfg.family != "vlm":
            return None
        return batch["vision_embeds"] @ p["vision_proj"]

    def _ctx(self, p: Optional[dict] = None, batch: Optional[dict] = None,
             cache_len: int = 0) -> dict:
        """The blocks' context; the cross states only when `batch` is
        given (a prefill or forward; decode reads the cross caches)."""
        cross = None if batch is None else self._cross_states(p, batch)
        return {"cfg": self.cfg, "causal": True, "cross_states": cross,
                "cache_len": cache_len}

    # ---------------------------------------------------------------- api
    def forward(self, p: dict, batch: dict):
        """Full-sequence forward. Returns (logits, aux)."""
        x = self._embed(p, batch["tokens"])
        x, _, aux = self.stack.apply(p["stack"], x, self._ctx(p, batch),
                                     mode="train")
        return self._head(p, x), aux

    def loss(self, p: dict, batch: dict, *,
             loss_chunk: int = 512) -> torch.Tensor:
        """Next-token cross-entropy (+ the MoE load-balance aux term), the
        LM head evaluated in `loss_chunk`-token chunks (`chunked_nll`)."""
        tokens = batch["tokens"]
        x = self._embed(p, tokens)
        x, _, aux = self.stack.apply(p["stack"], x, self._ctx(p, batch),
                                     mode="train")
        labels, weights = next_token_targets(tokens)
        loss = chunked_nll(lambda h: self._head(p, h), x, labels, weights,
                           loss_chunk)
        if self.cfg.num_experts:
            loss = loss + 0.01 * aux["moe_aux"] / max(1, self.cfg.num_layers)
        return loss

    def prefill(self, p: dict, batch: dict, max_len: Optional[int] = None):
        """Returns (last-token logits (B, V), cache).

        max_len: total context budget (prompt + decode steps); defaults to
        the prompt length (no decode growth room)."""
        tokens = batch["tokens"]
        cache_len = max_len or tokens.shape[1]
        x = self._embed(p, tokens)
        x, caches, _ = self.stack.apply(
            p["stack"], x, self._ctx(p, batch, cache_len), mode="prefill")
        logits = self._head(p, x[:, -1:])[:, 0]
        return logits, {"pos": tokens.shape[1], "groups": caches}

    def decode_step(self, p: dict, token: torch.Tensor, cache: dict):
        """token: (B,) ids; returns (logits (B, V), cache). The KV caches
        are written in place."""
        x = self._embed(p, token[:, None])
        ctx = dict(self._ctx(), pos=cache["pos"])
        x, caches, _ = self.stack.apply(p["stack"], x, ctx,
                                        caches=cache["groups"],
                                        mode="decode")
        logits = self._head(p, x)[:, 0]
        return logits, {"pos": cache["pos"] + 1, "groups": caches}

    def init_cache(self, batch: int, cache_len: int,
                   device: str | torch.device | None = None) -> dict:
        """Zero decode cache (for fresh decode sessions)."""
        dtype = common.torch_dtype(self.cfg.dtype)
        return {"pos": 0,
                "groups": self.stack.empty_caches(batch, cache_len, dtype,
                                                  resolve_device(device))}
