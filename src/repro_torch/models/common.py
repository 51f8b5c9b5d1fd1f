"""Shared building blocks: norms, RoPE, MLPs, causal conv, init helpers.

Parameters are plain dicts of tensors with the reference's leaf names and
layouts. Init helpers draw on the device of the `torch.Generator` they are
given, so a full-width model is drawn on the card, not on the host.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding import policy

f32 = torch.float32


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a config's dtype string ("bfloat16", ...) names."""
    return getattr(torch, name)


# ---------------------------------------------------------------- init utils
def dense_init(generator: torch.Generator, in_dim: int, *out_dims: int,
               dtype: torch.dtype = f32) -> torch.Tensor:
    """Normal weights of shape (in_dim, *out_dims), std 1/sqrt(in_dim),
    drawn in float32 on the generator's device."""
    shape = (in_dim, *out_dims)
    std = 1.0 / math.sqrt(in_dim)
    return (torch.randn(shape, generator=generator, dtype=f32,
                        device=generator.device) * std).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype = f32) -> torch.Tensor:
    return (torch.randn((vocab, dim), generator=generator, dtype=f32,
                        device=generator.device)
            * (1.0 / math.sqrt(dim))).to(dtype)


# ---------------------------------------------------------------------- norm
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float) -> torch.Tensor:
    xf = x.to(f32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.to(f32))
    return out.to(x.dtype)


def norm_init(dim: int, dtype: torch.dtype = f32,
              device: torch.device | str = "cpu") -> torch.Tensor:
    # stored as (gamma - 1): zeros init, gemma convention (1 + g)
    return torch.zeros((dim,), dtype=dtype, device=device)


# --------------------------------------------------------------- embedding
def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of `table` that `tokens` name; a DTensor table split on dp
    for tokens held whole by every dp rank is read where it lies
    (`policy.local_lookup`)."""
    if policy.fsdp_local(tokens, table):
        return policy.local_lookup(table, tokens)
    return table[tokens]


# ---------------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., L, D) with D even; positions: broadcastable to (..., L)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=f32, device=x.device)
                     / half)
    ang = positions[..., None].to(f32) * freq          # (..., L, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].to(f32), x[..., half:].to(f32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------- mlp
def mlp_init(generator: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None,
             dtype: Optional[torch.dtype] = None) -> dict:
    dtype = dtype or torch_dtype(cfg.dtype)
    d_ff = d_ff or cfg.d_ff
    p = {"norm": norm_init(cfg.d_model, dtype, generator.device),
         "w_up": dense_init(generator, cfg.d_model, d_ff, dtype=dtype),
         "w_down": dense_init(generator, d_ff, cfg.d_model, dtype=dtype)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(generator, cfg.d_model, d_ff, dtype=dtype)
    return p


def mlp_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x plus the MLP of its norm. DTensor weights whose d_ff is split on
    "model", on rows whose batch is split on dp, run Megatron's MLP in a
    `run_local` region (`_mlp_local`); on rows held whole by every dp rank
    the weights are multiplied where they lie (`policy.local_matmul`)."""
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    if policy.split_on_model(p["w_up"], 1) and _rows_on_dp(h):
        return x + _mlp_local(p, h, cfg)
    mm = (policy.local_matmul if policy.fsdp_local(h, p["w_up"])
          else torch.matmul)
    return x + _mlp(h, p["w_up"], p.get("w_gate"), p["w_down"], cfg.mlp_type,
                    mm)


def _mlp(h, w_up, w_gate, w_down, mlp_type: str, mm=torch.matmul):
    up = mm(h, w_up)
    # jax.nn.gelu defaults to the tanh approximation
    if mlp_type == "swiglu":
        up = F.silu(mm(h, w_gate)) * up
    elif mlp_type == "geglu":
        up = F.gelu(mm(h, w_gate), approximate="tanh") * up
    else:
        up = F.gelu(up, approximate="tanh")
    return mm(up, w_down)


def _rows_on_dp(h) -> bool:
    """DTensor `h`'s batch (its dim 0) divides the dp mesh dims."""
    from torch.distributed.tensor import Shard
    return any(pl == Shard(0) for pl in
               policy.layout(h.device_mesh, h.shape[0]))


def _mlp_local(p: dict, h, cfg: ModelConfig):
    """The MLP on local shards (Megatron's): each rank takes its rows of h
    (the batch on dp, as `layout` places it) whole on "model", its
    columns of w_up / w_gate and rows of w_down (d_ff on "model", gathered
    off dp), and returns a partial sum over "model", which the residual
    sums where it needs it. DTensor's own plans of these products may
    repeat them on every dp rank: zamba2-2.7b's shared MLP on 16 x 16
    (its backward 8-17x the forward), qwen2-1.5b's decode on 2 x 16 x 16
    (6.4x the oracle's FLOPs). `policy.local_matmul` would plan each
    product's shards alike, but it reduces each output's partial sums as
    it leaves its region (the down product's over "model"), and it does
    not take h's gradient summed over "model" (`policy.summed_grad`)."""
    from torch.distributed.tensor import Partial
    mesh = h.device_mesh
    rows = policy.layout(mesh, h.shape[0])
    cols = policy.layout(mesh, None, heads_dim=1)
    out = tuple(Partial() if name == "model" else pl
                for name, pl in zip(mesh.mesh_dim_names, rows))
    names = ("w_up", "w_gate", "w_down") if "w_gate" in p else (
        "w_up", "w_down")
    pls = {"w_up": cols, "w_gate": cols,
           "w_down": policy.layout(mesh, None, heads_dim=0)}

    def body(hl, *ws):
        w = dict(zip(names, ws))
        return _mlp(hl, w["w_up"], w.get("w_gate"), w["w_down"],
                    cfg.mlp_type)

    return policy.run_local(body, mesh,
                            (policy.summed_grad(h), *(p[k] for k in names)),
                            (rows, *(pls[k] for k in names)), out)


# --------------------------------------------------------------- causal conv
def causal_conv_init(generator: torch.Generator, channels: int, width: int,
                     dtype: torch.dtype = f32) -> dict:
    w = torch.randn((width, channels), generator=generator, dtype=f32,
                    device=generator.device) / math.sqrt(width)
    return {"w": w.to(dtype),
            "b": torch.zeros((channels,), dtype=dtype,
                             device=generator.device)}


def causal_conv_apply(p: dict, x: torch.Tensor,
                      state: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x: (B, L, C); state: (B, width-1, C) history.

    Returns (y, new_state). With state=None a zero history is used.
    """
    w, b = p["w"], p["b"]
    width = w.shape[0]
    bsz, l, c = x.shape
    if state is None:
        state = x.new_zeros((bsz, width - 1, c))
    xp = torch.cat([state, x], dim=1)                 # (B, L+width-1, C)
    xpf, wf = xp.to(f32), w.to(f32)                   # cast once, not per tap
    y = torch.zeros((bsz, l, c), dtype=f32, device=x.device)
    for i in range(width):                            # width is tiny (4)
        y = y + xpf[:, i:i + l] * wf[i]
    y = y + b.to(f32)
    # last width-1 inputs, copied so the cache does not keep xp alive
    new_state = xp[:, l:].clone()
    return y.to(x.dtype), new_state


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(f32) / cap)).to(x.dtype)
