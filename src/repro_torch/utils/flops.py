"""Analytic parameter and FLOP accounting per architecture, as the
reference's (src/repro/utils/flops.py).

The allocator's cost model (core.cost_model) consumes these, and
`examples/llm_fleet_allocation.py` sizes its jobs with them.

Param counts are exact by construction: the real model's
`param_specs()` (its init drawn under `FakeTensorMode`: shapes and dtypes,
no storage, the counterpart of the reference's `jax.eval_shape`) has its
leaves' sizes summed (no duplicated formulas to drift out of sync).
"""
from __future__ import annotations

from functools import lru_cache

from repro_torch.configs import base
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.training.optimizer import tree_leaves


@lru_cache(maxsize=64)
def _param_specs(cfg: ModelConfig) -> tuple:
    """(elements, bytes per element) of every leaf of the model's init."""
    from repro_torch.models import build_model
    return tuple((t.numel(), t.element_size())
                 for t in tree_leaves(build_model(cfg).param_specs()))


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count (from the real model's shapes)."""
    return sum(n for n, _ in _param_specs(cfg))


def param_bytes(cfg: ModelConfig) -> int:
    return sum(n * size for n, size in _param_specs(cfg))


def _expert_params_per_layer(cfg: ModelConfig) -> int:
    return 3 * cfg.d_model * cfg.d_ff  # w_gate + w_up + w_down per expert


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE counts only top-k experts)."""
    n = param_count(cfg)
    if cfg.num_experts:
        n_moe_layers = sum(k == base.MOE for k in cfg.group_pattern) \
            * cfg.num_groups
        n -= (cfg.num_experts - cfg.num_experts_per_tok) \
            * _expert_params_per_layer(cfg) * n_moe_layers
    return n


def _embed_params(cfg: ModelConfig) -> int:
    n = cfg.vocab_size * cfg.d_model
    return n  # unembed (tied or not) is a real matmul, counted in compute


def _attn_layers(cfg: ModelConfig):
    """(n_attn_layers incl. shared/moe/cross, n_cross) over the stack."""
    kinds = list(cfg.group_pattern) * cfg.num_groups
    if cfg.is_encdec:
        kinds = [base.ATTN] * cfg.encoder_layers + \
            [base.ATTN, base.CROSS] * cfg.num_layers
    n_self = sum(k in (base.ATTN, base.ATTN_LOCAL, base.ATTN_GLOBAL,
                       base.MOE, base.SHARED_ATTN) for k in kinds)
    n_cross = sum(k == base.CROSS for k in kinds)
    return n_self, n_cross


def _avg_context(cfg: ModelConfig, kind: str, seq: int) -> float:
    """Average attended context per query token during a full-seq pass."""
    win = None
    if kind == base.ATTN_LOCAL or cfg.attn_window:
        win = cfg.attn_window
    win = win or cfg.long_context_window
    causal_avg = (seq + 1) / 2
    return min(win, causal_avg) if win else causal_avg


def forward_flops(cfg: ModelConfig, batch: int, seq: int,
                  kind: str = "prefill") -> float:
    """Matmul-dominant forward FLOPs for one step.

    kind: "prefill"/"train" = full sequence; "decode" = 1 token with a
    `seq`-long context.
    """
    tokens = batch * (seq if kind != "decode" else 1)
    n_active = active_param_count(cfg)
    # parameter matmuls: 2 FLOPs per param per token; embedding gather is
    # not a matmul, but the LM head is (tied weights still multiply)
    n_matmul = n_active - _embed_params(cfg)
    if cfg.tie_embeddings:
        n_matmul += cfg.vocab_size * cfg.d_model
    # MoE capacity padding computes cap-factor more slots than active tokens
    if cfg.num_experts:
        n_moe_layers = sum(k == base.MOE for k in cfg.group_pattern) \
            * cfg.num_groups
        pad = (cfg.moe_capacity_factor - 1.0) * cfg.num_experts_per_tok \
            * _expert_params_per_layer(cfg) * n_moe_layers
        n_matmul += max(0.0, pad)
    flops = 2.0 * n_matmul * tokens

    # attention score/value contractions
    n_self, n_cross = _attn_layers(cfg)
    hq, hd = cfg.num_heads, cfg.head_dim
    if kind == "decode":
        ctx = seq
        win = cfg.attn_window or cfg.long_context_window
        if win:
            ctx = min(win, seq)
        flops += 4.0 * hq * hd * ctx * n_self * tokens
        flops += 4.0 * hq * hd * cfg.cross_attn_states * n_cross * tokens
    else:
        kinds = list(cfg.group_pattern) * cfg.num_groups
        if cfg.is_encdec:
            kinds = [base.ATTN] * cfg.encoder_layers + \
                [base.ATTN, base.CROSS] * cfg.num_layers
        for k in kinds:
            if k == base.CROSS:
                flops += 4.0 * hq * hd * cfg.cross_attn_states * tokens
            elif k in (base.ATTN, base.ATTN_GLOBAL, base.MOE,
                       base.SHARED_ATTN, base.ATTN_LOCAL):
                flops += 4.0 * hq * hd * _avg_context(cfg, k, seq) * tokens
    # recurrent state ops (mamba / xlstm): ~6 * d_inner * state per token
    d_inner = cfg.ssm_expand * cfg.d_model
    kinds = list(cfg.group_pattern) * cfg.num_groups
    for k in kinds:
        if k == base.MAMBA:
            flops += 6.0 * d_inner * cfg.ssm_state_dim * tokens
        elif k == base.MLSTM:
            ph = d_inner // max(1, cfg.ssm_num_heads)
            flops += 6.0 * d_inner * ph * tokens
        elif k == base.SLSTM:
            ph = cfg.d_model // cfg.num_heads
            flops += 6.0 * cfg.d_model * ph * tokens
    return flops


def step_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """FLOPs of the step the dry-run lowers for this shape."""
    if shape.kind == "train":
        return 3.0 * forward_flops(cfg, shape.global_batch, shape.seq_len,
                                   "train")
    return forward_flops(cfg, shape.global_batch, shape.seq_len, shape.kind)


def model_flops_6nd(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The roofline report's MODEL_FLOPS: 6*N*D (6*N_active*D for MoE)."""
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind == "train" else
                                   (shape.seq_len if shape.kind == "prefill"
                                    else 1))
    n = active_param_count(cfg)
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * n * tokens


def lstm_flops(input_dim: int, hidden: int, seq_len: int = 1) -> float:
    """Paper Section III.C FC-layer formula, (2I-1)O summed over gates."""
    per_step = (2 * input_dim - 1) * 4 * hidden + \
        (2 * hidden - 1) * 4 * hidden
    return per_step * seq_len
