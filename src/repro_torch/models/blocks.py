"""Block library: the block kinds the port builds so far.

Uniform interface, as in the reference:
    init_block(kind, generator, cfg)                -> params dict
    apply_block(kind, p, x, ctx, cache, mode)       -> (x', cache', aux)

mode in {"prefill", "decode"} (and "train" for a forward without caches).
ctx carries the config, positions, the decode position and the shared
weights. The port has MAMBA and SHARED_ATTN (zamba2), MLSTM and SLSTM
(xlstm-350m); every other kind raises NotImplementedError naming its
ROADMAP item. The reference's sharding constraints have no counterpart on
one card and are left out.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs import base
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import attention, common

LORA_RANK = 64  # zamba2 per-block adapters on the shared attention weights

_NOT_PORTED = {
    base.ATTN: "queue 1 item 9: dense attention blocks",
    base.ATTN_LOCAL: "queue 1 item 9: dense attention blocks",
    base.ATTN_GLOBAL: "queue 1 item 9: dense attention blocks",
    base.MOE: "queue 1 item 9: the MoE block (_moe_ffn)",
    base.CROSS: "queue 1 item 9: cross attention (llama-vision)",
}


def not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"block kind {kind!r} is not ported yet (ROADMAP, "
        f"{_NOT_PORTED.get(kind, 'unknown kind')})")


# =============================================================== attn + mlp
def _init_attn_mlp(generator: torch.Generator, cfg: ModelConfig) -> dict:
    return {"attn": attention.attn_init(generator, cfg),
            "mlp": common.mlp_init(generator, cfg)}


# ===================================================================== mamba2
def _init_mamba(generator: torch.Generator, cfg: ModelConfig) -> dict:
    dtype = common.torch_dtype(cfg.dtype)
    dev = generator.device
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    h, n = cfg.ssm_num_heads, cfg.ssm_state_dim
    conv_dim = d_inner + 2 * n
    f32 = torch.float32
    return {
        "norm": common.norm_init(d, dtype, dev),
        "w_in": common.dense_init(generator, d, 2 * d_inner + 2 * n + h,
                                  dtype=dtype),
        "conv": common.causal_conv_init(generator, conv_dim,
                                        cfg.ssm_conv_width, dtype=dtype),
        "dt_bias": torch.zeros((h,), dtype=f32, device=dev),
        "a_log": torch.zeros((h,), dtype=f32, device=dev),  # A = -1
        "d_skip": torch.ones((h,), dtype=f32, device=dev),
        "norm_gate": common.norm_init(d_inner, dtype, dev),
        "w_out": common.dense_init(generator, d_inner, d, dtype=dtype),
    }


def _mamba_split(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_inner = cfg.ssm_expand * cfg.d_model
    n, h = cfg.ssm_state_dim, cfg.ssm_num_heads
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_inner + 2 * n]
    dt_raw = zxbcdt[..., -h:]
    return z, xbc, dt_raw


def _apply_mamba(p, x, ctx, cache, mode):
    cfg = ctx["cfg"]
    d_inner = cfg.ssm_expand * cfg.d_model
    n, h = cfg.ssm_state_dim, cfg.ssm_num_heads
    ph = cfg.ssm_head_dim
    bsz, l, _ = x.shape
    f32 = torch.float32

    hid = common.rms_norm(x, p["norm"], cfg.norm_eps)
    z, xbc, dt_raw = _mamba_split(cfg, hid @ p["w_in"])
    conv_state = cache["conv"] if mode == "decode" else None
    xbc, conv_state = common.causal_conv_apply(p["conv"], xbc, conv_state)
    xbc = F.silu(xbc)
    xs = xbc[..., :d_inner].reshape(bsz, l, h, ph)
    b_mat = xbc[..., d_inner:d_inner + n]
    c_mat = xbc[..., d_inner + n:]
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])

    if mode == "decode":
        # single-step recurrence
        state = cache["ssm"]                                   # (B, H, P, N)
        dt1 = dt[:, 0]                                         # (B, H)
        decay = torch.exp(dt1 * a[None])                       # (B, H)
        upd = torch.einsum("bhp,bn->bhpn",
                           xs[:, 0].to(f32) * dt1[..., None],
                           b_mat[:, 0].to(f32))
        state = state * decay[..., None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", state, c_mat[:, 0].to(f32))
        y = y + xs[:, 0].to(f32) * p["d_skip"][None, :, None]
        y = y.reshape(bsz, 1, d_inner).to(x.dtype)
        new_cache = {"conv": conv_state, "ssm": state}
    else:
        y, final_state = ops.ssm(xs.contiguous(), dt.contiguous(), a,
                                 b_mat.contiguous(), c_mat.contiguous(),
                                 p["d_skip"], chunk=cfg.ssm_chunk)
        y = y.reshape(bsz, l, d_inner)
        new_cache = ({"conv": conv_state, "ssm": final_state}
                     if mode == "prefill" else None)

    y = y * F.silu(z)
    y = common.rms_norm(y, p["norm_gate"], cfg.norm_eps)
    return x + y @ p["w_out"], new_cache, {}


# ============================================================== shared attn
def _init_shared_lora(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Per-group LoRA adapters over the shared attention block (zamba2)."""
    dtype = common.torch_dtype(cfg.dtype)
    d = cfg.d_model
    return {
        "lora_a": common.dense_init(generator, d, LORA_RANK, dtype=dtype),
        "lora_b": torch.zeros((LORA_RANK, d), dtype=dtype,
                              device=generator.device),
    }


def _apply_shared_attn(lora_p, x, ctx, cache, mode):
    """Shared full-attention block (one weight set reused across groups),
    specialised per group by a LoRA residual on the block input."""
    cfg = ctx["cfg"]
    shared = ctx["shared_attn"]
    x = x + (x @ lora_p["lora_a"]) @ lora_p["lora_b"]
    window = cfg.long_context_window  # zamba2 shared attn is full by default
    if mode == "decode":
        x, cache_a = attention.attn_decode(shared["attn"], x, cache["attn"],
                                           ctx["pos"], cfg, window=window)
        x = common.mlp_apply(shared["mlp"], x, cfg)
        return x, {"attn": cache_a}, {}
    x, cache_a = attention.attn_full(
        shared["attn"], x, cfg, window=window,
        positions=ctx.get("positions"), make_cache=(mode == "prefill"),
        cache_len=ctx.get("cache_len", 0))
    x = common.mlp_apply(shared["mlp"], x, cfg)
    return x, ({"attn": cache_a} if mode == "prefill" else None), {}


# ====================================================================== xLSTM
def _init_mlstm(generator: torch.Generator, cfg: ModelConfig) -> dict:
    dtype = common.torch_dtype(cfg.dtype)
    dev = generator.device
    d = cfg.d_model
    d_inner = cfg.ssm_expand * d
    h = cfg.ssm_num_heads
    f32 = torch.float32
    return {
        "norm": common.norm_init(d, dtype, dev),
        "w_up": common.dense_init(generator, d, 2 * d_inner, dtype=dtype),
        "conv": common.causal_conv_init(generator, d_inner,
                                        cfg.ssm_conv_width, dtype=dtype),
        "wq": common.dense_init(generator, d_inner, d_inner, dtype=dtype),
        "wk": common.dense_init(generator, d_inner, d_inner, dtype=dtype),
        "wv": common.dense_init(generator, d_inner, d_inner, dtype=dtype),
        "w_gates": common.dense_init(generator, d_inner, 2 * h, dtype=f32),
        "gate_bias": torch.cat([torch.zeros((h,), dtype=f32, device=dev),
                                torch.full((h,), 3.0, dtype=f32,
                                           device=dev)]),
        "norm_out": common.norm_init(d_inner, dtype, dev),
        "w_down": common.dense_init(generator, d_inner, d, dtype=dtype),
    }


def _apply_mlstm(p, x, ctx, cache, mode):
    cfg = ctx["cfg"]
    d_inner = cfg.ssm_expand * cfg.d_model
    h = cfg.ssm_num_heads
    ph = d_inner // h
    bsz, l, _ = x.shape
    f32 = torch.float32

    hid = common.rms_norm(x, p["norm"], cfg.norm_eps)
    up = hid @ p["w_up"]
    xin, z = up[..., :d_inner], up[..., d_inner:]
    conv_state = cache["conv"] if mode == "decode" else None
    cx, conv_state = common.causal_conv_apply(p["conv"], xin, conv_state)
    cx = F.silu(cx)
    q = (cx @ p["wq"]).reshape(bsz, l, h, ph)
    k = (cx @ p["wk"]).reshape(bsz, l, h, ph)
    v = (xin @ p["wv"]).reshape(bsz, l, h, ph)
    gates = cx.to(f32) @ p["w_gates"] + p["gate_bias"]
    ig, fg = gates[..., :h], gates[..., h:]

    if mode == "decode":
        # one step of the sequential recurrence from the cached state,
        # plain torch as the reference leaves it
        y, (c, nvec, m) = ref.mlstm_chunk_reference(
            q, k, v, ig, fg, c0=cache["c"], n0=cache["n"], m0=cache["m"])
        y = y.reshape(bsz, 1, d_inner)
        new_cache = {"conv": conv_state, "c": c, "n": nvec, "m": m}
    else:
        y, (c, nvec, m) = ops.mlstm(q, k, v, ig.contiguous(), fg.contiguous(),
                                    chunk=min(cfg.ssm_chunk, 64))
        y = y.reshape(bsz, l, d_inner)
        new_cache = ({"conv": conv_state, "c": c, "n": nvec, "m": m}
                     if mode == "prefill" else None)

    y = y * F.silu(z)
    y = common.rms_norm(y, p["norm_out"], cfg.norm_eps)
    return x + y @ p["w_down"], new_cache, {}


def _init_slstm(generator: torch.Generator, cfg: ModelConfig) -> dict:
    dtype = common.torch_dtype(cfg.dtype)
    dev = generator.device
    d = cfg.d_model
    h = cfg.num_heads
    ph = d // h
    f32 = torch.float32
    r_gates = torch.randn((4, h, ph, ph), generator=generator, dtype=f32,
                          device=dev) / math.sqrt(ph)
    return {
        "norm": common.norm_init(d, dtype, dev),
        "conv": common.causal_conv_init(generator, d, cfg.ssm_conv_width,
                                        dtype=dtype),
        "w_gates": common.dense_init(generator, d, 4 * d, dtype=dtype),
        "r_gates": r_gates.to(dtype),
        "gate_bias": torch.cat([torch.zeros((2 * d,), dtype=f32, device=dev),
                                torch.full((d,), 3.0, dtype=f32, device=dev),
                                torch.zeros((d,), dtype=f32, device=dev)]),
        "norm_out": common.norm_init(d, dtype, dev),
        "w_up": common.dense_init(generator, d, 2 * cfg.d_model,
                                  dtype=dtype),
        "w_down": common.dense_init(generator, cfg.d_model, d, dtype=dtype),
    }


def _slstm_step(p, cfg, xg_t, state):
    """xg_t: (B, 4d) input gate preactivations; state: (h, c, n, m).
    Gate order z, i, f, o."""
    h_prev, c_prev, n_prev, m_prev = state
    d = cfg.d_model
    nh = cfg.num_heads
    ph = d // nh
    bsz = xg_t.shape[0]
    hp = h_prev.reshape(bsz, nh, ph)
    rec = torch.einsum("bhp,ghpq->bghq", hp,
                       p["r_gates"].to(torch.float32)).reshape(bsz, 4 * d)
    g = xg_t + rec + p["gate_bias"]
    zt = torch.tanh(g[..., 0:d])
    it = g[..., d:2 * d]
    ft = g[..., 2 * d:3 * d]
    ot = torch.sigmoid(g[..., 3 * d:])
    log_f = F.logsigmoid(ft)
    m_new = torch.maximum(log_f + m_prev, it)
    i_act = torch.exp(it - m_new)
    f_act = torch.exp(log_f + m_prev - m_new)
    c_new = f_act * c_prev + i_act * zt
    n_new = f_act * n_prev + i_act
    h_new = ot * c_new / torch.clamp(n_new, min=1.0)
    return h_new, c_new, n_new, m_new


def _apply_slstm(p, x, ctx, cache, mode):
    cfg = ctx["cfg"]
    d = cfg.d_model
    bsz, l, _ = x.shape
    f32 = torch.float32
    hid = common.rms_norm(x, p["norm"], cfg.norm_eps)
    conv_state = cache["conv"] if mode == "decode" else None
    cx, conv_state = common.causal_conv_apply(p["conv"], hid, conv_state)
    cx = F.silu(cx)
    xg = (cx @ p["w_gates"]).to(f32)                           # (B, L, 4d)

    if mode == "decode":
        state = (cache["h"], cache["c"], cache["n"], cache["m"])
        state = _slstm_step(p, cfg, xg[:, 0], state)
        y = state[0][:, None, :]
        new_cache = {"conv": conv_state, "h": state[0], "c": state[1],
                     "n": state[2], "m": state[3]}
    else:
        # the reference's lax.scan over L as a loop of plain torch steps
        # (no Pallas kernel there); r_gates cast to float32 once, not per
        # step, which gives the same numbers
        step_p = {"r_gates": p["r_gates"].to(f32),
                  "gate_bias": p["gate_bias"]}
        state = tuple(torch.zeros((bsz, d), dtype=f32, device=x.device)
                      for _ in range(3)) + (
            torch.full((bsz, d), -1e30, dtype=f32, device=x.device),)
        ys = []
        for t in range(l):
            state = _slstm_step(step_p, cfg, xg[:, t], state)
            ys.append(state[0])
        y = torch.stack(ys, dim=1)
        new_cache = ({"conv": conv_state, "h": state[0], "c": state[1],
                      "n": state[2], "m": state[3]}
                     if mode == "prefill" else None)

    y = common.rms_norm(y.to(x.dtype), p["norm_out"], cfg.norm_eps)
    up = y @ p["w_up"]
    half = cfg.d_model
    # jax.nn.gelu defaults to the tanh approximation
    y = F.gelu(up[..., :half], approximate="tanh") * up[..., half:]
    return x + y @ p["w_down"], new_cache, {}


# ================================================================= dispatch
_INIT = {
    base.MAMBA: _init_mamba,
    base.SHARED_ATTN: _init_shared_lora,
    base.SLSTM: _init_slstm,
    base.MLSTM: _init_mlstm,
}
_APPLY = {
    base.MAMBA: _apply_mamba,
    base.SHARED_ATTN: _apply_shared_attn,
    base.SLSTM: _apply_slstm,
    base.MLSTM: _apply_mlstm,
}


def init_block(kind: str, generator: torch.Generator,
               cfg: ModelConfig) -> dict:
    if kind not in _INIT:
        raise not_ported(kind)
    return _INIT[kind](generator, cfg)


def apply_block(kind: str, p, x, ctx, cache, mode: str):
    if kind not in _APPLY:
        raise not_ported(kind)
    return _APPLY[kind](p, x, ctx, cache, mode)


def empty_block_cache(kind: str, cfg: ModelConfig, batch: int,
                      cache_len: int, dtype: torch.dtype,
                      device: torch.device | str) -> dict:
    """Zero decode cache for one block."""
    if kind == base.SHARED_ATTN:
        return {"attn": attention.empty_cache(
            batch, cfg, cache_len, cfg.long_context_window, dtype, device)}
    if kind == base.MAMBA:
        d_inner = cfg.ssm_expand * cfg.d_model
        n, h, ph = cfg.ssm_state_dim, cfg.ssm_num_heads, cfg.ssm_head_dim
        conv_dim = d_inner + 2 * n
        return {"conv": torch.zeros(
                    (batch, cfg.ssm_conv_width - 1, conv_dim), dtype=dtype,
                    device=device),
                "ssm": torch.zeros((batch, h, ph, n), dtype=torch.float32,
                                   device=device)}
    f32 = torch.float32
    if kind == base.MLSTM:
        d_inner = cfg.ssm_expand * cfg.d_model
        h = cfg.ssm_num_heads
        ph = d_inner // h
        return {"conv": torch.zeros(
                    (batch, cfg.ssm_conv_width - 1, d_inner), dtype=dtype,
                    device=device),
                "c": torch.zeros((batch, h, ph, ph), dtype=f32,
                                 device=device),
                "n": torch.zeros((batch, h, ph), dtype=f32, device=device),
                "m": torch.full((batch, h), -1e30, dtype=f32,
                                device=device)}
    if kind == base.SLSTM:
        d = cfg.d_model
        return {"conv": torch.zeros((batch, cfg.ssm_conv_width - 1, d),
                                    dtype=dtype, device=device),
                "h": torch.zeros((batch, d), dtype=f32, device=device),
                "c": torch.zeros((batch, d), dtype=f32, device=device),
                "n": torch.zeros((batch, d), dtype=f32, device=device),
                "m": torch.full((batch, d), -1e30, dtype=f32,
                                device=device)}
    raise not_ported(kind)
