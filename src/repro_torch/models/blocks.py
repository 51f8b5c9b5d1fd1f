"""Block library: every block kind in configs.base.BLOCK_KINDS.

Uniform interface, as in the reference:
    init_block(kind, generator, cfg)                -> params dict
    apply_block(kind, p, x, ctx, cache, mode)       -> (x', cache', aux)

mode in {"prefill", "decode"} (and "train" for a forward without caches).
ctx carries the config, positions, the decode position, the cross states
and the shared weights. aux is a dict of scalars (the MoE load-balance
term). Under an activation policy the mLSTM cell inputs take the
reference's constraint (batch on dp), and the MoE routes and dispatches
each batch shard locally (`_sharded_moe`); EP-major expert weights take
the expert-parallel path (`sharding.ep_moe.ep_moe_ffn`, all-to-all over
"model") on a mesh whose model axis is experts x shards, as the
reference's, and are rebuilt into the logical (E, d, f) layout
elsewhere.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs import base
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import attention, common
from repro_torch.sharding import policy

LORA_RANK = 64  # zamba2 per-block adapters on the shared attention weights
MOE_GROUP = 2048  # the most tokens one MoE dispatch group holds
MOE_CHUNK = 8     # dispatch groups per pass when there are many


# =============================================================== dense / attn
def _init_attn_mlp(generator: torch.Generator, cfg: ModelConfig,
                   cross: bool = False) -> dict:
    return {"attn": attention.attn_init(generator, cfg, cross=cross),
            "mlp": common.mlp_init(generator, cfg)}


def _attn_window(kind: str, cfg: ModelConfig) -> Optional[int]:
    if kind == base.ATTN_LOCAL:
        return cfg.attn_window
    if kind == base.ATTN_GLOBAL:
        return None
    # plain ATTN / MOE: cfg.attn_window if the arch is natively SWA
    # (mixtral), else the explicit long-context window, else full
    return cfg.attn_window or cfg.long_context_window


def _apply_attn_block(kind, p, x, ctx, cache, mode):
    cfg = ctx["cfg"]
    window = _attn_window(kind, cfg)
    if mode == "decode":
        x, cache_a = attention.attn_decode(p["attn"], x, cache["attn"],
                                           ctx["pos"], cfg, window=window)
        x = common.mlp_apply(p["mlp"], x, cfg)
        return x, {"attn": cache_a}, {}
    x, cache_a = attention.attn_full(
        p["attn"], x, cfg, window=window, positions=ctx.get("positions"),
        causal=ctx.get("causal", True), make_cache=(mode == "prefill"),
        cache_len=ctx.get("cache_len", 0))
    x = common.mlp_apply(p["mlp"], x, cfg)
    return x, ({"attn": cache_a} if mode == "prefill" else None), {}


# ======================================================================== moe
def _init_moe(generator: torch.Generator, cfg: ModelConfig) -> dict:
    dtype = common.torch_dtype(cfg.dtype)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    w_gate = common.dense_init(generator, d, e, f,
                               dtype=dtype).transpose(0, 1)
    w_up = common.dense_init(generator, d, e, f, dtype=dtype).transpose(0, 1)
    w_down = common.dense_init(generator, f, e, d,
                               dtype=dtype).transpose(0, 1)
    if cfg.moe_ep_shards:
        # EP-major storage, as the reference keeps it for its mesh:
        # (E*r, d, f/r) / (E*r, f/r, d)
        r = cfg.moe_ep_shards
        fr = f // r
        experts = {
            "ep_gate": w_gate.reshape(e, d, r, fr).permute(0, 2, 1, 3)
            .reshape(e * r, d, fr),
            "ep_up": w_up.reshape(e, d, r, fr).permute(0, 2, 1, 3)
            .reshape(e * r, d, fr),
            "ep_down": w_down.reshape(e * r, fr, d)}
    else:
        experts = {"w_gate": w_gate.contiguous(), "w_up": w_up.contiguous(),
                   "w_down": w_down.contiguous()}
    return {"attn": attention.attn_init(generator, cfg),
            "moe_norm": common.norm_init(d, dtype, generator.device),
            "router": common.dense_init(generator, d, e,
                                        dtype=torch.float32),
            "experts": experts}


def _logical_experts(we: dict, cfg: ModelConfig) -> dict:
    """EP-major (E*r, d, f/r) / (E*r, f/r, d) expert weights as the
    logical (E, d, f) / (E, f, d) ones; logical weights as they are."""
    if "ep_gate" not in we:
        return we
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    r = cfg.moe_ep_shards
    fr = f // r
    return {
        "w_gate": we["ep_gate"].reshape(e, r, d, fr).permute(0, 2, 1, 3)
        .reshape(e, d, f),
        "w_up": we["ep_up"].reshape(e, r, d, fr).permute(0, 2, 1, 3)
        .reshape(e, d, f),
        "w_down": we["ep_down"].reshape(e, f, d)}


def _top_k(probs: torch.Tensor, k: int):
    """The k largest probabilities and their experts, the lower index
    first on a tie, as `jax.lax.top_k` orders them (a stable descending
    sort keeps equal values in index order)."""
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return w[..., :k], idx[..., :k]


def _dispatch(h, ids, w, we, e: int, k: int, cap: int, summed=None):
    """Sort-based capacity dispatch of R groups of g tokens each, the
    reference's `dispatch_group` over a batch of groups. h: (R, g, d);
    ids, w: (R, g, k) experts and weights. A copy past its expert's `cap`
    slots goes to the drop bucket and adds nothing. Returns (R, g, d).
    `summed` (the identity by default) takes the gate and up products
    before the activation: the sum over the ranks whose shards of d they
    are partial sums of."""
    summed = summed or (lambda t: t)
    rows, g, d = h.shape
    n = g * k
    dev = h.device
    flat_e = ids.reshape(rows, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    # rank within expert among the sorted copies
    counts = torch.zeros((rows, e), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, sorted_e, torch.ones_like(sorted_e))
    starts = torch.cumsum(counts, dim=1) - counts
    rank = torch.arange(n, device=dev) - torch.gather(starts, 1, sorted_e)
    keep = rank < cap
    slot = torch.where(keep, sorted_e * cap + rank, e * cap)  # drop bucket
    tok = torch.div(order, k, rounding_mode="floor")
    # slots are unique but for the drop bucket, which only gathers zeros:
    # the sums do not depend on the order of the adds
    row_base = (torch.arange(rows, device=dev) * (e * cap + 1))[:, None]
    src = torch.gather(h, 1, tok[..., None].expand(rows, n, d)) \
        * keep[..., None].to(h.dtype)
    buf = h.new_zeros((rows * (e * cap + 1), d))
    buf.index_add_(0, (row_base + slot).reshape(-1), src.reshape(-1, d))
    buf = buf.reshape(rows, e * cap + 1, d)[:, :-1].reshape(rows, e, cap, d)
    act = F.silu(summed(torch.einsum("recd,edf->recf", buf, we["w_gate"])))
    out = act * summed(torch.einsum("recd,edf->recf", buf, we["w_up"]))
    out = torch.einsum("recf,efd->recd", out, we["w_down"])
    out_flat = out.reshape(rows, e * cap, d)
    w_sorted = torch.gather(w.reshape(rows, n), 1, order)
    picked = torch.gather(out_flat, 1,
                          torch.where(keep, slot, 0)[..., None]
                          .expand(rows, n, d))
    contrib = picked * (w_sorted * keep).to(out.dtype)[..., None]
    # each token takes exactly k adds onto 0 (k = 2: a + b == b + a)
    y = out.new_zeros((rows * g, d))
    tok_base = (torch.arange(rows, device=dev) * g)[:, None]
    y.index_add_(0, (tok_base + tok).reshape(-1), contrib.reshape(-1, d))
    return y.reshape(rows, g, d)


def _route(h, router, k: int):
    """Top-k routing: (probs (.., E), top_w (.., k) renormalised, top_e
    (.., k)), the router in float32."""
    probs = torch.softmax(h.to(torch.float32) @ router, dim=-1)
    top_w, top_e = _top_k(probs, k)
    return probs, top_w / torch.sum(top_w, dim=-1, keepdim=True), top_e


def _dispatch_rows(h, top_e, top_w, we, e: int, k: int, g: int, cap: int,
                   summed=None):
    """`_dispatch` over (B, S, d) tokens cut into rows of g tokens (g
    divides S). Returns (B, S, d)."""
    bsz, s, d = h.shape
    rows = bsz * s // g
    hr = h.reshape(rows, g, d)
    er = top_e.reshape(rows, g, k)
    wr = top_w.reshape(rows, g, k)
    if rows > MOE_CHUNK and rows % MOE_CHUNK == 0:
        # chunks of MOE_CHUNK groups one after another bound the live
        # (E*cap, d) / (E, cap, d_ff) buffers, as the reference's lax.map;
        # under grad each chunk is recomputed in the backward, as the
        # reference's jax.checkpoint, so no chunk's buffers are saved
        def chunk(i):
            args = (hr[i:i + MOE_CHUNK], er[i:i + MOE_CHUNK],
                    wr[i:i + MOE_CHUNK], we, e, k, cap, summed)
            if torch.is_grad_enabled():
                return torch.utils.checkpoint.checkpoint(
                    _dispatch, *args, use_reentrant=False)
            return _dispatch(*args)
        y = torch.cat([chunk(i) for i in range(0, rows, MOE_CHUNK)])
    else:
        y = _dispatch(hr, er, wr, we, e, k, cap, summed)
    return y.reshape(bsz, s, d)


def _sharded_moe(h, router, we, e: int, k: int, g: int, cap: int):
    """The routing and the dispatch of DTensor tokens, each on its batch
    shard in a `local_map` region (the reference's per-row dispatch,
    which GSPMD keeps local): routing repeated on every model rank, the
    experts' d_ff split over "model" where it divides (the output then
    partial there). Tokens held whole by every dp rank, or a decode
    step's few rows, meet the experts where they lie
    (`_experts_where_they_lie`). Returns (y, probs, the first choice
    one-hot)."""
    mesh = h.device_mesh
    rows = policy.layout(mesh, h.shape[0])
    rep = policy.layout(mesh, None)

    def route(hl, rl):
        probs, top_w, top_e = _route(hl, rl, k)
        return probs, top_w, top_e, F.one_hot(top_e[..., 0], e).to(
            torch.float32)

    probs, top_w, top_e, first = policy.run_local(
        route, mesh, (h, router), (rows, rep), (rows,) * 4)
    if policy.fsdp_local(h, we["w_gate"]) or policy.moves_rows(
            h, we["w_gate"]):
        return (_experts_where_they_lie(h, top_e, top_w, we, e, k, g, cap,
                                        rows), probs, first)
    tp = policy.axis_sizes(mesh).get("model", 1)
    split = tp > 1 and we["w_gate"].shape[-1] % tp == 0
    up = policy.layout(mesh, None, heads_dim=2 if split else None)
    down = policy.layout(mesh, None, heads_dim=1 if split else None)
    from torch.distributed.tensor import Partial
    out = tuple(Partial() if split and name == "model" else pl
                for name, pl in zip(policy.axis_sizes(mesh), rows))

    def dispatch(hl, el, wl, wg, wu, wd):
        return _dispatch_rows(hl, el, wl, {"w_gate": wg, "w_up": wu,
                                           "w_down": wd}, e, k, g, cap)

    y = policy.run_local(dispatch, mesh,
                         (h, top_e, top_w, we["w_gate"], we["w_up"],
                          we["w_down"]), (rows, rows, rows, up, up, down),
                         out)
    return y, probs, first


def _experts_where_they_lie(h, top_e, top_w, we, e: int, k: int, g: int,
                            cap: int, rows):
    """The dispatch of tokens held whole by every dp rank (a batch that
    does not divide dp), or of a few rows split on dp whose tokens are
    fewer than the experts' weights (`policy.moves_rows`: a decode step),
    in a `run_local` region with the experts at their own placements,
    (E, d on dp, f on "model") and (E, f on "model", d on dp): each rank
    takes its slice of every row's d (the rows brought together from the
    dp ranks by an all-to-all), the gate and up products are summed over
    dp before the activation (a collective of the capacity slots' size),
    and the down product gives the rank's slice of d, a partial sum over
    "model"; the output is summed there and placed as the rows (`rows`,
    by an all-to-all on dp, or a gather for a batch of one). DTensor's
    placement of the dispatch region gathers every expert's weights over
    dp, and repeats the products on every dp rank where the batch does
    not divide them (mixtral-8x7b's batch-1 decode: 14.6x the
    reference's FLOPs on 16 x 16; its decode_32k: 5.9x the reference's
    collective bytes)."""
    from torch.distributed.nn.functional import all_reduce
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = h.device_mesh
    group = policy.dp_group(mesh)
    wg, wu, wd = we["w_gate"], we["w_up"], we["w_down"]
    rep = (Replicate(),) * mesh.ndim
    # h's d where the experts' d lies; the output's d too, partial where
    # the experts' d_ff is split
    h_pl = tuple(Shard(2) if pl == Shard(1) else Replicate()
                 for pl in wg.placements)
    out = tuple(Shard(2) if pl == Shard(2) else
                Partial() if pl == Shard(1) else Replicate()
                for pl in wd.placements)

    def dispatch(hl, el, wl, gl, ul, dl):
        return _dispatch_rows(hl, el, wl, {"w_gate": gl, "w_up": ul,
                                           "w_down": dl}, e, k, g, cap,
                              summed=lambda t: all_reduce(t, group=group))

    y = policy.run_local(
        dispatch, mesh, (h, top_e, top_w, wg, wu, wd),
        (h_pl, rep, rep, tuple(wg.placements), tuple(wu.placements),
         tuple(wd.placements)), out)
    return policy.settle(y, rows)


def _moe_ffn(p, x, cfg: ModelConfig):
    """Top-k MoE with per-group capacity by sort-based dispatch (the
    reference's `_moe_ffn`). x: (B, S, d). Returns (x + y, load-balance
    aux). EP-major experts on a mesh whose "model" axis is experts x
    shards take the expert-parallel path (`sharding.ep_moe`); elsewhere
    they are rebuilt into the logical layout."""
    bsz, s, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    # dispatch in groups of <= MOE_GROUP tokens, as the reference does
    g = s
    while g > MOE_GROUP:
        if s % (g // 2):
            break
        g //= 2
    # capacity >= k so single-token decode never drops an expert
    cap = max(k, int(math.ceil(k * g / e * cfg.moe_capacity_factor)))

    h = common.rms_norm(x, p["moe_norm"], cfg.norm_eps)
    if "ep_gate" in p["experts"]:
        mesh = policy.current_mesh()
        if mesh is not None and policy.axis_sizes(mesh).get("model", 1) \
                == e * cfg.moe_ep_shards:
            from repro_torch.sharding.ep_moe import ep_moe_ffn
            y, aux = ep_moe_ffn(p["experts"], p["router"], h, cfg, mesh)
            return x + y.to(x.dtype), aux
    we = _logical_experts(p["experts"], cfg)
    if policy.is_dtensor(h):
        y, probs, first = _sharded_moe(h, p["router"], we, e, k, g, cap)
    else:
        probs, top_w, top_e = _route(h, p["router"], k)   # (B, S, E / k)
        y = _dispatch_rows(h, top_e, top_w, we, e, k, g, cap)
        first = F.one_hot(top_e[..., 0], e).to(torch.float32)
    # load-balance aux (Switch-style): E * sum_e f_e * P_e
    frac = torch.mean(first, dim=(0, 1))
    mean_p = torch.mean(probs, dim=(0, 1))
    aux = e * torch.sum(frac * mean_p)
    return x + y.to(x.dtype), aux


def _apply_moe_block(p, x, ctx, cache, mode):
    cfg = ctx["cfg"]
    window = _attn_window(base.MOE, cfg)
    if mode == "decode":
        x, cache_a = attention.attn_decode(p["attn"], x, cache["attn"],
                                           ctx["pos"], cfg, window=window)
    else:
        x, cache_a = attention.attn_full(
            p["attn"], x, cfg, window=window, positions=ctx.get("positions"),
            make_cache=(mode == "prefill"),
            cache_len=ctx.get("cache_len", 0))
    x, aux = _moe_ffn(p, x, cfg)
    cache = {"attn": cache_a} if mode in ("prefill", "decode") else None
    return x, cache, {"moe_aux": aux}


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


def _heads_on_model(cfg: ModelConfig, hid) -> int:
    """The "model" ranks that split the mamba block's heads
    (`_mamba_local`): the "model" dim of DTensor `hid`'s mesh where it
    divides the heads, else 1."""
    if not policy.is_dtensor(hid):
        return 1
    tp = policy.axis_sizes(hid.device_mesh).get("model", 1)
    return tp if tp > 1 and cfg.ssm_num_heads % tp == 0 else 1


def _mamba_local(cfg: ModelConfig, p: dict, hid, tp: int):
    """The mixer from the input projection to the gated norm, each
    "model" rank's heads on that rank, in a `run_local` region: its
    columns of w_in (its heads' z, x and dt, and all of B and C, which
    every head reads; the weight gathered whole), of the conv, and of the
    per-head and per-channel parameters; the norm's sum of squares summed
    over "model". The split points of the (z, x, B, C, dt) product fall
    inside w_in's "model" shards, so DTensor would gather the product over
    "model" to slice it, its own plan of the product repeats it on every
    dp rank, and its backward of a norm over a split dim gathers the batch
    over dp. Each rank's B and C feed only its own heads, so the region's
    work is split over "model" and its inputs' gradients are partial sums
    there. Returns the normed y (B, L, d_inner), split on "model", and the
    conv's new state and the SSM's final state."""
    from torch.distributed.nn.functional import all_reduce
    from torch.distributed.tensor import Replicate
    d_inner = cfg.ssm_expand * cfg.d_model
    n, h, ph = cfg.ssm_state_dim, cfg.ssm_num_heads, cfg.ssm_head_dim
    dr, hr = d_inner // tp, h // tp
    mesh = hid.device_mesh
    r = mesh.get_local_rank("model")
    group = mesh.get_group("model")
    x0, h0, dt0 = r * dr, r * hr, 2 * d_inner + 2 * n + r * hr
    bsz, l = hid.shape[:2]
    f32 = torch.float32

    def body(hl, w, cw, cb, dt_bias, a_log, d_skip, gamma):
        bl = hl.shape[0]
        w = torch.cat([w[:, x0:x0 + dr], w[:, d_inner + x0:d_inner + x0 + dr],
                       w[:, 2 * d_inner:2 * d_inner + 2 * n],
                       w[:, dt0:dt0 + hr]], dim=1)
        conv = {k: torch.cat([v[..., x0:x0 + dr], v[..., d_inner:]], dim=-1)
                for k, v in (("w", cw), ("b", cb))}
        zx = hl @ w
        xbc, state = common.causal_conv_apply(conv, zx[..., dr:2 * dr + 2 * n])
        xbc = F.silu(xbc)
        dt = F.softplus(zx[..., -hr:].to(f32) + dt_bias[h0:h0 + hr])
        y, final = ops.ssm(xbc[..., :dr].reshape(bl, l, hr, ph).contiguous(),
                           dt.contiguous(), -torch.exp(a_log[h0:h0 + hr]),
                           xbc[..., dr:dr + n].contiguous(),
                           xbc[..., dr + n:].contiguous(), d_skip[h0:h0 + hr],
                           chunk=cfg.ssm_chunk)
        y = y.reshape(bl, l, dr) * F.silu(zx[..., :dr])
        # common.rms_norm over d_inner, its mean a sum over the ranks
        yf = y.to(f32)
        var = all_reduce((yf * yf).sum(-1, keepdim=True), group=group)
        y = (yf * torch.rsqrt(var / d_inner + cfg.norm_eps)
             * (1.0 + gamma[x0:x0 + dr].to(f32))).to(y.dtype)
        return y, state[..., :dr], state[..., dr:], final

    rows = policy.layout(mesh, bsz)
    heads = policy.layout(mesh, bsz, heads_dim=2)
    rep = (Replicate(),) * mesh.ndim
    args = (policy.summed_grad(hid), p["w_in"], p["conv"]["w"],
            p["conv"]["b"], p["dt_bias"],
            p["a_log"], p["d_skip"], p["norm_gate"])
    y, sx, sbc, final = policy.run_local(
        body, mesh, args, (rows,) + (rep,) * 7,
        (heads, heads, rows, policy.layout(mesh, bsz, heads_dim=1)))
    return y, {"conv": (sx, sbc), "ssm": final}


def _decode_on_heads(cfg: ModelConfig, p: dict, hid, cache) -> int:
    """The "model" ranks that split a decode step's heads in
    `_mamba_decode_local`, else 1: a token held whole by every dp rank
    (`policy.fsdp_local`), heads that divide "model", and the weights and
    caches split on "model" as the rules put them (w_in's and the conv
    state's columns, w_out's rows, the SSM state's heads)."""
    tp = _heads_on_model(cfg, hid)
    if tp == 1 or 2 * cfg.ssm_state_dim % tp \
            or not policy.fsdp_local(hid, p["w_in"]):
        return 1
    placed = (policy.split_on_model(p["w_in"], 1)
              and policy.split_on_model(p["w_out"], 0)
              and policy.split_on_model(cache["conv"], 2)
              and policy.split_on_model(cache["ssm"], 1))
    return tp if placed else 1


def _mamba_decode_local(cfg: ModelConfig, p: dict, hid, cache, tp: int):
    """A decode step of the mixer for a token held whole by every dp rank,
    each "model" rank's heads on that rank, in a `run_local` region where
    every weight and cache lies: the in-projection's columns of the
    rank's w_in shard (its rows of d on dp, the partial sums summed over
    dp); one all-to-all over "model" brings each rank the product's
    columns it needs (its chunk of the conv's channels, its heads' z and
    dt), the conv steps the rank's chunk of the conv state, and a second
    brings it its heads' x and all of B and C; the SSM steps the rank's
    heads of the state (and its part of their head_dim where the state is
    split there on dp, gathered after), the gated norm's sum of squares
    is summed over "model", and the out-projection gives the rank's
    slice of d on dp, a partial sum over "model". The split points of
    (z, x, B, C, dt) fall inside the shards, so DTensor gathers the
    product and the conv's output over "model" to slice them (zamba2-
    2.7b's batch-1 decode: 6.5x the reference's collective bytes).
    Returns the out-projection (B, 1, d) and the new conv and SSM
    states."""
    from torch.distributed._functional_collectives import (
        all_gather_single, all_reduce)
    from torch.distributed.tensor import Partial, Replicate, Shard
    d_inner = cfg.ssm_expand * cfg.d_model
    n, h, ph = cfg.ssm_state_dim, cfg.ssm_num_heads, cfg.ssm_head_dim
    conv_dim, width = d_inner + 2 * n, 2 * d_inner + 2 * n + h
    hr, dr, cr, zr = h // tp, d_inner // tp, conv_dim // tp, width // tp
    mesh = hid.device_mesh
    names = mesh.mesh_dim_names
    r = mesh.get_local_rank("model")
    model, dp = mesh.get_group("model"), policy.dp_group(mesh)
    (jd,) = [j for j, a in enumerate(names)
             if a in policy.fsdp_axes(tuple(names))]
    h0, x0 = r * hr, r * dr
    p_ways = mesh.size(jd) if cache["ssm"].placements[jd] == Shard(2) else 1
    pr = ph // p_ways
    p0 = mesh.get_local_rank(jd) * pr if p_ways > 1 else 0
    # the product's columns each rank needs: its chunk of the conv's
    # inputs, its heads' z and dt; then the conv's outputs: its heads' x,
    # and B and C
    zx_have = [(q * zr, (q + 1) * zr) for q in range(tp)]
    zx_need = [[(d_inner + q * cr, d_inner + (q + 1) * cr),
                (q * dr, (q + 1) * dr),
                (width - h + q * hr, width - h + (q + 1) * hr)]
               for q in range(tp)]
    conv_have = [(q * cr, (q + 1) * cr) for q in range(tp)]
    conv_need = [[(q * dr, (q + 1) * dr), (d_inner, conv_dim)]
                 for q in range(tp)]
    f32 = torch.float32

    def body(hl, w_in, conv_w, conv_b, dt_bias, a_log, d_skip, gamma,
             conv_state, state, w_out):
        bl = hl.shape[0]
        zx = all_reduce(hl @ w_in, "sum", dp)
        zx = policy.exchange_columns(zx, zx_have, zx_need, r, model)
        z, dt_raw = zx[..., cr:cr + dr], zx[..., cr + dr:]
        xbc, conv_state = common.causal_conv_apply(
            {"w": conv_w, "b": conv_b[r * cr:(r + 1) * cr]}, zx[..., :cr],
            conv_state)
        xbc = policy.exchange_columns(F.silu(xbc), conv_have, conv_need, r,
                                      model)
        xs = xbc[:, 0, :dr].reshape(bl, hr, ph)[..., p0:p0 + pr].to(f32)
        dt1 = F.softplus(dt_raw[:, 0].to(f32) + dt_bias[h0:h0 + hr])
        decay = torch.exp(dt1 * -torch.exp(a_log[h0:h0 + hr])[None])
        upd = torch.einsum("bhp,bn->bhpn", xs * dt1[..., None],
                           xbc[:, 0, dr:dr + n].to(f32))
        state = state * decay[..., None, None] + upd
        y = torch.einsum("bhpn,bn->bhp", state, xbc[:, 0, dr + n:].to(f32))
        y = y + xs * d_skip[h0:h0 + hr][None, :, None]
        if p_ways > 1:
            y = all_gather_single(y.contiguous(), 2, dp)
        y = y.reshape(bl, 1, dr).to(hl.dtype) * F.silu(z)
        # common.rms_norm over d_inner, its mean a sum over the ranks
        yf = y.to(f32)
        var = all_reduce((yf * yf).sum(-1, keepdim=True), "sum", model)
        y = (yf * torch.rsqrt(var / d_inner + cfg.norm_eps)
             * (1.0 + gamma[x0:x0 + dr].to(f32))).to(y.dtype)
        return y @ w_out, conv_state, state

    rep = (Replicate(),) * mesh.ndim
    on_model = tuple(Shard(1) if a == "model" else Replicate()
                     for a in names)
    rows = tuple(Shard(2) if pl == Shard(0) else Replicate()
                 for pl in p["w_in"].placements)
    out = tuple(Partial() if a == "model" else
                Shard(2) if pl == Shard(1) else Replicate()
                for a, pl in zip(names, p["w_out"].placements))
    conv_pl, ssm_pl = (tuple(cache[k].placements) for k in ("conv", "ssm"))
    return policy.run_local(
        body, mesh,
        (hid, p["w_in"], p["conv"]["w"], p["conv"]["b"], p["dt_bias"],
         p["a_log"], p["d_skip"], p["norm_gate"], cache["conv"],
         cache["ssm"], p["w_out"]),
        (rows, tuple(p["w_in"].placements), on_model, rep, rep, rep, rep,
         rep, conv_pl, ssm_pl, tuple(p["w_out"].placements)),
        (out, conv_pl, ssm_pl))


def _apply_mamba(p, x, ctx, cache, mode):
    cfg = ctx["cfg"]
    d_inner = cfg.ssm_expand * cfg.d_model
    n, h = cfg.ssm_state_dim, cfg.ssm_num_heads
    ph = cfg.ssm_head_dim
    bsz, l, _ = x.shape
    f32 = torch.float32

    hid = common.rms_norm(x, p["norm"], cfg.norm_eps)
    if mode == "decode":
        tp = _decode_on_heads(cfg, p, hid, cache)
        if tp > 1:
            y, conv, ssm = _mamba_decode_local(cfg, p, hid, cache, tp)
            x = policy.constrain_residual(x + policy.summed(y))
            return x, {"conv": conv, "ssm": ssm}, {}
    tp = _heads_on_model(cfg, hid) if mode != "decode" else 1
    if tp > 1:
        y, new_cache = _mamba_local(cfg, p, hid, tp)
        new_cache = ({"conv": torch.cat(new_cache["conv"], dim=-1),
                      "ssm": new_cache["ssm"]} if mode == "prefill" else None)
        # the out projection's partial sum summed here, in the residual's
        # dtype (the next norm would sum it in float32, and DTensor's
        # backward of that norm gathers the batch over dp)
        x = policy.constrain_residual(x + y @ policy.gathered(p["w_out"]))
        return x, new_cache, {}

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
    # on a mesh the residual is summed at each block's end: given the out
    # projection's partial sum, DTensor's plans of the next block's
    # products repeat them on every dp rank (a batch-1 decode: 5x)
    return policy.constrain_residual(x + y @ p["w_out"]), new_cache, {}


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
    window = cfg.long_context_window  # zamba2 shared attn is full by default
    if mode == "decode":
        # the residual summed between the parts, as at the mamba block's
        # end
        mm = (policy.local_matmul
              if policy.fsdp_local(x, lora_p["lora_a"]) else torch.matmul)
        x = policy.constrain_residual(
            x + mm(mm(x, lora_p["lora_a"]), lora_p["lora_b"]))
        x, cache_a = attention.attn_decode(shared["attn"], x, cache["attn"],
                                           ctx["pos"], cfg, window=window)
        x = common.mlp_apply(shared["mlp"], policy.constrain_residual(x),
                             cfg)
        return x, {"attn": cache_a}, {}
    # the weights gathered off dp first: on the model-replicated residual,
    # DTensor's own plan of a product with a weight split on dp repeats
    # it on every dp rank
    x = policy.summed_grad(x)
    x = x + ((x @ policy.gathered(lora_p["lora_a"]))
             @ policy.gathered(lora_p["lora_b"]))
    x, cache_a = attention.attn_full(
        shared["attn"], x, cfg, window=window,
        positions=ctx.get("positions"), make_cache=(mode == "prefill"),
        cache_len=ctx.get("cache_len", 0))
    # the attention's partial sum summed here, in the residual's dtype
    x = policy.constrain_residual(x)
    x = common.mlp_apply(shared["mlp"], x, cfg)
    return x, ({"attn": cache_a} if mode == "prefill" else None), {}


# ================================================================ cross attn
def _apply_cross(p, x, ctx, cache, mode):
    cfg = ctx["cfg"]
    if mode == "decode":
        x, _ = attention.attn_decode(p["attn"], x, cache["attn"], ctx["pos"],
                                     cfg, cross=True)
        x = common.mlp_apply(p["mlp"], x, cfg)
        return x, cache, {}
    states = ctx["cross_states"]
    x, _ = attention.attn_full(p["attn"], x, cfg, cross_states=states)
    cache = None
    if mode == "prefill":
        # the cross K/V depend only on the (static) cross states: built
        # once, without the bias, as the reference builds them
        cache = {"attn": {
            "k": attention.project_heads(states, p["attn"]["wk"]),
            "v": attention.project_heads(states, p["attn"]["wv"])}}
    x = common.mlp_apply(p["mlp"], x, cfg)
    return x, cache, {}


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


def _flat_step(out):
    """(y, (C, n, m)) as (y, C, n, m)."""
    y, (c, n, m) = out
    return y, c, n, m


def _on_rows(fn, rows, params, n_out: int, like):
    """fn(*rows, *params): a decode step of a recurrent cell. With
    DTensors, each rank steps its batch rows (dim 0 of every `rows`
    argument, on dp; the cached states gathered off "model", where the
    cache rules put them) in a `local_map` region, the parameters
    replicated; each output i is then placed as like[i] (the cache's
    layout), when like[i] is a DTensor. Every sLSTM step runs here, and
    the mLSTM's where its cache is plain, on one rank, or in a layout
    that `_mlstm_step_local` does not take (`_step_placements`)."""
    if not any(policy.is_dtensor(t) for t in rows):
        return tuple(fn(*rows, *params))
    mesh = next(t.device_mesh for t in rows if policy.is_dtensor(t))
    r = policy.layout(mesh, rows[0].shape[0])
    rep = policy.layout(mesh, None)
    out = policy.run_local(lambda *a: tuple(fn(*a)), mesh,
                           (*rows, *params),
                           (r,) * len(rows) + (rep,) * len(params),
                           (r,) * n_out)
    return tuple(policy.placed_like(o, t) if policy.is_dtensor(t) else o
                 for o, t in zip(out, like))


def _step_placements(cache) -> Optional[tuple]:
    """The mesh dims of a DTensor mLSTM cache by what they split: (the
    batch's, C's key dim's, C's value dim's) lists, where n lies as C on
    the batch and the key dim and m on the batch, and nothing else is
    split, on a mesh of more than one rank; None for another layout."""
    from torch.distributed.tensor import Replicate, Shard
    c, n, m = cache["c"], cache["n"], cache["m"]
    if not all(policy.is_dtensor(t) for t in (c, n, m)) \
            or c.device_mesh.size() == 1:
        return None
    dims = ([], [], [])
    for j, (pc, pn, pm) in enumerate(zip(c.placements, n.placements,
                                         m.placements)):
        if pc == Replicate():
            kind = None
        elif pc in (Shard(0), Shard(2), Shard(3)):
            kind = (0, 2, 3).index(pc.dim)
        else:
            return None
        want_n = Shard(0) if kind == 0 else Shard(2) if kind == 1 \
            else Replicate()
        want_m = Shard(0) if kind == 0 else Replicate()
        if (pn, pm) != (want_n, want_m):
            return None
        if kind is not None:
            dims[kind].append(j)
    return dims


def _mlstm_step_local(q, k, v, ig, fg, cache, dims):
    """One step of the mLSTM recurrence (`ref.mlstm_chunk_reference` at
    L = 1) with its state where the cache rules put it (`_step_placements`:
    C's key dim on "model" and its value dim on dp for a batch of one, the
    batch on dp and the key dim on "model" for a larger one), in a
    `run_local` region: q and k sliced to the rank's keys, v to its values;
    the numerator's and the denominator's sums over the keys summed over
    the mesh dims that split them; the output split as C's values are.
    Gathering C off "model" to step it whole on every rank moves 33.5 MB a
    layer at xlstm-350m's decode_32k on 16 x 16. Returns (y, C, n, m)."""
    from torch.distributed._functional_collectives import all_reduce
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache["c"].device_mesh
    rows, keys, vals = dims
    d = q.shape[-1]
    groups = [mesh.get_group(j) for j in keys]
    f32 = torch.float32

    def place(*by_kind):
        return tuple(by_kind[0] if j in rows else by_kind[1] if j in keys
                     else by_kind[2] if j in vals else Replicate()
                     for j in range(mesh.ndim))

    def body(ql, kl, vl, il, fl, c, n, m):
        qt, kt, vt = ql[:, 0].to(f32), kl[:, 0].to(f32), vl[:, 0].to(f32)
        log_f = F.logsigmoid(fl[:, 0].to(f32))
        m_new = torch.maximum(log_f + m, il[:, 0].to(f32))
        fdec = torch.exp(log_f + m - m_new)
        iamp = torch.exp(il[:, 0].to(f32) - m_new)
        scale = 1.0 / math.sqrt(d)
        c = c * fdec[..., None, None] + iamp[..., None, None] * torch.einsum(
            "bhd,bhe->bhde", kt * scale, vt)
        n = n * fdec[..., None] + iamp[..., None] * kt * scale
        num = torch.einsum("bhde,bhd->bhe", c, qt)
        dot = torch.einsum("bhd,bhd->bh", n, qt)
        for g in groups:
            num, dot = all_reduce(num, "sum", g), all_reduce(dot, "sum", g)
        den = torch.maximum(torch.abs(dot), torch.exp(-m_new))
        return (num / den[..., None])[:, None].to(ql.dtype), c, n, m_new

    r, s0 = Replicate(), Shard(0)
    qk = place(s0, Shard(3), r)
    return policy.run_local(
        body, mesh, (q, k, v, ig, fg, cache["c"], cache["n"], cache["m"]),
        (qk, qk, place(s0, r, Shard(3)), place(s0, r, r), place(s0, r, r),
         tuple(cache["c"].placements), tuple(cache["n"].placements),
         tuple(cache["m"].placements)),
        (place(s0, r, Shard(3)), tuple(cache["c"].placements),
         tuple(cache["n"].placements), tuple(cache["m"].placements)))


def _apply_mlstm(p, x, ctx, cache, mode):
    cfg = ctx["cfg"]
    d_inner = cfg.ssm_expand * cfg.d_model
    h = cfg.ssm_num_heads
    ph = d_inner // h
    bsz, l, _ = x.shape
    f32 = torch.float32

    hid = common.rms_norm(x, p["norm"], cfg.norm_eps)
    # a decode step's products where the (dp-only) weights lie, their
    # work split over "model" rather than repeated there
    mm = (policy.local_matmul if policy.decode_local(hid, p["w_up"])
          else torch.matmul)
    up = mm(hid, p["w_up"])
    xin, z = up[..., :d_inner], up[..., d_inner:]
    conv_state = cache["conv"] if mode == "decode" else None
    cx, conv_state = common.causal_conv_apply(p["conv"], xin, conv_state)
    cx = F.silu(cx)
    # cell inputs are dp-sharded on batch, replicated elsewhere (the mLSTM
    # matrix memory is computed locally per batch shard)
    bld = (policy.DP, None, None)
    q = policy.constrain(mm(cx, p["wq"]), bld).reshape(bsz, l, h, ph)
    k = policy.constrain(mm(cx, p["wk"]), bld).reshape(bsz, l, h, ph)
    v = policy.constrain(mm(xin, p["wv"]), bld).reshape(bsz, l, h, ph)
    gates = policy.constrain(mm(cx.to(f32), p["w_gates"]), bld) \
        + p["gate_bias"]
    ig, fg = gates[..., :h], gates[..., h:]

    dims = _step_placements(cache) if mode == "decode" else None
    if dims is not None:
        y, c, nvec, m = _mlstm_step_local(q, k, v, ig, fg, cache, dims)
        y = y.reshape(bsz, 1, d_inner)
        new_cache = {"conv": conv_state, "c": c, "n": nvec, "m": m}
    elif mode == "decode":
        # one step of the sequential recurrence from the cached state,
        # plain torch as the reference leaves it
        y, c, nvec, m = _on_rows(
            lambda *a: _flat_step(ref.mlstm_chunk_reference(*a)),
            (q, k, v, ig, fg, cache["c"], cache["n"], cache["m"]), (), 4,
            like=(None, cache["c"], cache["n"], cache["m"]))
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
    return x + mm(y, p["w_down"]), new_cache, {}


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


def _slstm_scan(cfg, xg, r_gates, gate_bias):
    """The sLSTM over a whole (B, L, 4d) sequence of gate
    preactivations from the zero state: (y (B, L, d), h, c, n, m). The
    reference's lax.scan over L as a loop of plain torch steps (no Pallas
    kernel there); r_gates cast to float32 once, not per step, which
    gives the same numbers."""
    bsz, l, d4 = xg.shape
    d = d4 // 4
    f32 = torch.float32
    step_p = {"r_gates": r_gates.to(f32), "gate_bias": gate_bias}
    state = tuple(torch.zeros((bsz, d), dtype=f32, device=xg.device)
                  for _ in range(3)) + (
        torch.full((bsz, d), -1e30, dtype=f32, device=xg.device),)

    def step(t, state, xg):
        state = _slstm_step(step_p, cfg, xg[:, t], state)
        return state, state[0]

    state, y = ref.walk(step, l, state, (xg,))
    return (y, *state)


def _apply_slstm(p, x, ctx, cache, mode):
    cfg = ctx["cfg"]
    d = cfg.d_model
    bsz, l, _ = x.shape
    f32 = torch.float32
    hid = common.rms_norm(x, p["norm"], cfg.norm_eps)
    conv_state = cache["conv"] if mode == "decode" else None
    cx, conv_state = common.causal_conv_apply(p["conv"], hid, conv_state)
    cx = F.silu(cx)
    # a decode step's products where the weights lie (as the mLSTM's)
    mm = (policy.local_matmul if policy.decode_local(cx, p["w_gates"])
          else torch.matmul)
    xg = mm(cx, p["w_gates"]).to(f32)                          # (B, L, 4d)

    if mode == "decode":
        state = (cache["h"], cache["c"], cache["n"], cache["m"])
        state = _on_rows(
            lambda x, *a: _slstm_step(
                {"r_gates": a[4], "gate_bias": a[5]}, cfg, x, a[:4]),
            (xg[:, 0], *state), (p["r_gates"], p["gate_bias"]), 4,
            like=state)
        y = state[0][:, None, :]
        new_cache = {"conv": conv_state, "h": state[0], "c": state[1],
                     "n": state[2], "m": state[3]}
    else:
        if policy.is_dtensor(xg):
            # the recurrence on each batch shard, repeated on every model
            # rank (the cell is dp-only, as the reference's rules)
            mesh = xg.device_mesh
            rows, rep = policy.layout(mesh, bsz), policy.layout(mesh, None)
            y, *state = policy.run_local(
                lambda *a: _slstm_scan(cfg, *a), mesh,
                (xg, p["r_gates"], p["gate_bias"]), (rows, rep, rep),
                (rows,) * 5)
        else:
            y, *state = _slstm_scan(cfg, xg, p["r_gates"], p["gate_bias"])
        new_cache = ({"conv": conv_state, "h": state[0], "c": state[1],
                      "n": state[2], "m": state[3]}
                     if mode == "prefill" else None)

    y = common.rms_norm(y.to(x.dtype), p["norm_out"], cfg.norm_eps)
    up = mm(y, p["w_up"])
    half = cfg.d_model
    # jax.nn.gelu defaults to the tanh approximation
    y = F.gelu(up[..., :half], approximate="tanh") * up[..., half:]
    return x + mm(y, p["w_down"]), new_cache, {}


# ================================================================= dispatch
_INIT = {
    base.ATTN: _init_attn_mlp,
    base.ATTN_LOCAL: _init_attn_mlp,
    base.ATTN_GLOBAL: _init_attn_mlp,
    base.MOE: _init_moe,
    base.MAMBA: _init_mamba,
    base.SHARED_ATTN: _init_shared_lora,
    base.CROSS: lambda generator, cfg: _init_attn_mlp(generator, cfg,
                                                      cross=True),
    base.SLSTM: _init_slstm,
    base.MLSTM: _init_mlstm,
}
_APPLY = {
    base.ATTN: lambda *a: _apply_attn_block(base.ATTN, *a),
    base.ATTN_LOCAL: lambda *a: _apply_attn_block(base.ATTN_LOCAL, *a),
    base.ATTN_GLOBAL: lambda *a: _apply_attn_block(base.ATTN_GLOBAL, *a),
    base.MOE: _apply_moe_block,
    base.MAMBA: _apply_mamba,
    base.SHARED_ATTN: _apply_shared_attn,
    base.CROSS: _apply_cross,
    base.SLSTM: _apply_slstm,
    base.MLSTM: _apply_mlstm,
}


def init_block(kind: str, generator: torch.Generator,
               cfg: ModelConfig) -> dict:
    return _INIT[kind](generator, cfg)


def apply_block(kind: str, p, x, ctx, cache, mode: str):
    return _APPLY[kind](p, x, ctx, cache, mode)


def empty_block_cache(kind: str, cfg: ModelConfig, batch: int,
                      cache_len: int, dtype: torch.dtype,
                      device: torch.device | str) -> dict:
    """Zero decode cache for one block."""
    if kind in (base.ATTN, base.ATTN_LOCAL, base.ATTN_GLOBAL, base.MOE,
                base.SHARED_ATTN):
        window = (cfg.long_context_window if kind == base.SHARED_ATTN
                  else _attn_window(kind, cfg))
        return {"attn": attention.empty_cache(batch, cfg, cache_len, window,
                                              dtype, device)}
    if kind == base.CROSS:
        shape = (batch, cfg.num_kv_heads, cfg.cross_attn_states,
                 cfg.head_dim)
        return {"attn": {"k": torch.zeros(shape, dtype=dtype, device=device),
                         "v": torch.zeros(shape, dtype=dtype,
                                          device=device)}}
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
    raise ValueError(kind)
