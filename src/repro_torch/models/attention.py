"""Self and cross attention with GQA, RoPE, sliding window, softcap and
KV caches.

Two paths, as in the reference:
  * full sequence (prefill): `kernels.ops.attention` (the CUDA flash
    kernel on the card, the plain oracle on the CPU);
  * cached decode (1 query token): a masked GEMV in plain torch, which
    the reference also leaves outside Pallas: it is bound by the cache
    read.

KV caches are linear (length = context) or ring buffers (length = sliding
window), in the model's dtype or, with `kv_cache_dtype="int8"`, as int8
with a float32 scale per (batch, head, slot). Keys are stored after RoPE
so decode never re-rotates. Decode writes the new token's K/V into the
cache in place (the reference returns an updated copy). Cross attention
(llama-vision, the encoder-decoder) reads a static cache of the cross
states' K/V built at prefill. Under an activation policy q, k and v take
the reference's constraint (batch on dp, heads on tp); without one it is
the identity.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.sharding import policy
from repro_torch.sharding.policy import DP, TP, constrain

NEG_INF = -1e30


def attn_init(generator: torch.Generator, cfg: ModelConfig,
              dtype: Optional[torch.dtype] = None,
              cross: bool = False) -> dict:
    dtype = dtype or common.torch_dtype(cfg.dtype)
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = generator.device
    p = {
        "norm": common.norm_init(d, dtype, dev),
        "wq": common.dense_init(generator, d, hq, hd, dtype=dtype),
        "wk": common.dense_init(generator, d, hkv, hd, dtype=dtype),
        "wv": common.dense_init(generator, d, hkv, hd, dtype=dtype),
        "wo": (common.dense_init(generator, hq * hd, d, dtype=dtype)
               .reshape(hq, hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq, hd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((hkv, hd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((hkv, hd), dtype=dtype, device=dev)
    if cross:
        # tanh-gated residual (llama-vision)
        p["gate_attn"] = torch.zeros((), dtype=dtype, device=dev)
    return p


def _hd_sharded(w, dim: int) -> bool:
    """A DTensor weight whose head_dim (its dim `dim`) is split on a mesh
    dim: the policy's fallback where the heads do not divide "model"."""
    if not policy.is_dtensor(w):
        return False
    from torch.distributed.tensor import Shard
    return any(pl == Shard(dim) for pl in w.placements)


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bld,dhe->bhle"): (B, L, d) @ (d, H, hd) -> (B, H, L, hd).
    With head_dim split on a mesh dim (`_hd_sharded`), the product runs
    over (d, hd * H) with head_dim outermost, so the split stays one even
    block per rank; einsum's (H * hd) would split inside heads. DTensor
    tokens run on local shards under autograd (`_local_heads`); tokens
    held whole by every dp rank, or a decode step's, meet the weight
    where it lies (`policy.local_einsum`)."""
    if policy.decode_local(x, w):
        return policy.local_einsum("bld,dhe->bhle", x, w)
    if (policy.is_dtensor(x) and torch.is_grad_enabled()
            and (x.requires_grad or w.requires_grad)):
        return _local_heads(x, w)
    if not _hd_sharded(w, 2):
        return torch.einsum("bld,dhe->bhle", x, w)
    d, h, e = w.shape
    y = x @ w.permute(0, 2, 1).reshape(d, e * h)
    return y.reshape(*x.shape[:2], e, h).permute(0, 3, 1, 2)


def project_out(y: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bhle,hed->bld"): (B, H, L, hd) @ (H, hd, d) -> (B, L, d),
    contracted over (hd, H) when head_dim is split (as `project_heads`).
    With heads or head_dim split on "model", under grad, it runs on local
    shards (`_local_out`); a decode step's y, or y whose query rows are
    split on "model" (`ops.attention` where the heads do not divide it),
    meets wo where it lies (`policy.local_einsum`): the rows stay split,
    the output split on the sequence there."""
    if policy.decode_local(y, wo) or policy.split_on_model(y, 2):
        return policy.local_einsum("bhle,hed->bld", y, wo)
    if (torch.is_grad_enabled() and wo.requires_grad
            and (policy.split_on_model(wo, 0)
                 or policy.split_on_model(wo, 1))):
        return _local_out(y, wo)
    if not _hd_sharded(wo, 1):
        return torch.einsum("bhle,hed->bld", y, wo)
    b, h, l, e = y.shape
    return (y.permute(0, 2, 3, 1).reshape(b, l, e * h)
            @ wo.permute(1, 0, 2).reshape(e * h, wo.shape[-1]))


def _local_out(y, wo):
    """`project_out` on local shards in a `local_map` region (row
    parallel): y with its batch on dp and its heads (or head_dim) on
    "model", wo with its heads (or head_dim) on "model" and its FSDP split
    of d_model gathered; the output a partial sum over "model". DTensor's
    backward of the einsum gathers y's heads and repeats the weight's
    gradient on every "model" rank (zamba2-2.7b's train step, 16 x 16:
    32x the forward's FLOPs; with head_dim split, qwen2-1.5b's: 8.5x).
    `policy.local_einsum` would plan the same shards, but it reduces its
    output's partial sums as it leaves the region, where this region
    leaves the sum over "model" to the residual."""
    from torch.distributed.tensor import Partial
    mesh = y.device_mesh
    rows = policy.layout(mesh, y.shape[0])
    out = tuple(Partial() if name == "model" else pl
                for name, pl in zip(mesh.mesh_dim_names, rows))
    dim = 0 if policy.split_on_model(wo, 0) else 1
    return policy.run_local(
        lambda yl, wl: torch.einsum("bhle,hed->bld", yl, wl), mesh, (y, wo),
        (policy.layout(mesh, y.shape[0], heads_dim=1 if dim == 0 else 3),
         policy.layout(mesh, None, heads_dim=dim)), out)


def _local_heads(x, w):
    """`project_heads` on local shards in a `local_map` region (column
    parallel): x with its batch on dp and its d_model gathered, w with its
    heads (or head_dim) split as placed and its FSDP split of d_model
    gathered; the output split as both. Given tokens split on d_model (the
    encoder-decoder's embedding), DTensor's einsum makes each rank a
    partial sum over the whole batch, and the backward's view of that
    gradient does not fit the local strides (seamless-m4t's train step on
    16 x 16); given tokens split on the sequence, its backward takes 8.5x
    the forward's FLOPs (mistral-large-123b's and mixtral-8x22b's train
    steps on 16 x 16). `policy.local_einsum` keeps the tokens as they lie
    and moves the weight instead: tokens split on the sequence over
    "model" would gather w's heads there, tokens split on d_model over dp
    would leave a partial sum over the whole batch."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    heads = (Shard(1), Shard(2))
    w_pl = (tuple(pl if pl in heads else Replicate() for pl in w.placements)
            if policy.is_dtensor(w) else (Replicate(),) * mesh.ndim)
    x_pl = policy.layout(mesh, x.shape[0])
    out = tuple(xp if xp == Shard(0) else
                Shard(1) if wp == Shard(1) else
                Shard(3) if wp == Shard(2) else Replicate()
                for xp, wp in zip(x_pl, w_pl))
    return policy.run_local(
        lambda xl, wl: torch.einsum("bld,dhe->bhle", xl, wl), mesh, (x, w),
        (x_pl, w_pl), out)


def _sequence_whole(x):
    """DTensor `x` with the split of its sequence (dim 1) over "model"
    gathered, once for the three projections that read it (DTensor's
    einsum gathers it for each)."""
    if not (policy.split_on_model(x, 1) and x.shape[1] > 1):
        return x
    from torch.distributed.tensor import Replicate, Shard
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if pl == Shard(1) else pl for pl in x.placements))


def _qkv(p: dict, x: torch.Tensor, states: Optional[torch.Tensor]):
    """x: (B, L, d) queries' source; states: the keys' and values' source
    (x when None). -> q (B, Hq, L, hd), k and v (B, Hkv, S, hd)."""
    x = _sequence_whole(x)
    kv_src = x if states is None else _sequence_whole(states)
    q = project_heads(x, p["wq"])
    k = project_heads(kv_src, p["wk"])
    v = project_heads(kv_src, p["wv"])
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    qkv_spec = (DP, TP, None, None)     # batch on data, heads on model
    return (constrain(q, qkv_spec), constrain(k, qkv_spec),
            constrain(v, qkv_spec))


def attn_full(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              window: Optional[int] = None,
              positions: Optional[torch.Tensor] = None,
              causal: bool = True,
              cross_states: Optional[torch.Tensor] = None,
              make_cache: bool = False,
              cache_len: int = 0):
    """Full-sequence attention. Returns (y, cache | None).

    positions: (L,) absolute positions for RoPE (self-attention only).
    With `cross_states` (B, S, d) the keys and values come from them,
    without RoPE, and every query sees every state."""
    h = common.rms_norm(x, p["norm"], cfg.norm_eps)
    q, k, v = _qkv(p, h, cross_states)
    if cross_states is None:
        l = x.shape[1]
        if positions is None:
            positions = torch.arange(l, device=x.device)
        q = common.rope(q, positions[None, None, :], cfg.rope_theta)
        k = common.rope(k, positions[None, None, :], cfg.rope_theta)
    y = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                      causal=causal and cross_states is None, window=window,
                      softcap=cfg.attn_logit_softcap)
    y = project_out(y, p["wo"])
    out = x + _gate(p, y)

    cache = None
    if make_cache:
        cache = _cache_from_prefill(k, v, window, cache_len,
                                    cfg.kv_cache_dtype)
    return out, cache


def _gate(p: dict, y: torch.Tensor) -> torch.Tensor:
    """tanh(gate_attn) * y for a gated cross-attention block, the gate
    taken in float32 and rounded to y's dtype; y itself otherwise."""
    if "gate_attn" not in p:
        return y
    return torch.tanh(p["gate_attn"].to(torch.float32)).to(y.dtype) * y


def _quantize(x: torch.Tensor):
    """Symmetric int8 quantisation over the last axis with a float32
    scale per (b, h, slot): max(amax, 1e-6) / 127, values rounded half to
    even and clipped to +-127."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _cache_from_prefill(k, v, window, cache_len, kv_dtype="native"):
    """Build a decode cache from prefill K/V: (B, Hkv, L, hd) -> slots."""
    b, hkv, l, hd = k.shape
    slots = min(window, cache_len) if window else cache_len
    kc = k.new_zeros((b, hkv, slots, hd))
    vc = v.new_zeros((b, hkv, slots, hd))
    if window and slots <= l:
        # ring buffer: last `slots` tokens, placed at their pos % slots
        idx = torch.arange(l - slots, l, device=k.device) % slots
        kc[:, :, idx] = k[:, :, l - slots:]
        vc[:, :, idx] = v[:, :, l - slots:]
    else:
        n = min(l, slots)
        kc[:, :, :n] = k[:, :, :n]
        vc[:, :, :n] = v[:, :, :n]
    if kv_dtype == "int8":
        kq, ks = _quantize(kc)
        vq, vs = _quantize(vc)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": kc, "v": vc}


def empty_cache(batch: int, cfg: ModelConfig, cache_len: int,
                window: Optional[int], dtype: torch.dtype,
                device: torch.device | str) -> dict:
    slots = min(window, cache_len) if window else cache_len
    shape = (batch, cfg.num_kv_heads, slots, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        i8, f32 = torch.int8, torch.float32
        return {"k": torch.zeros(shape, dtype=i8, device=device),
                "v": torch.zeros(shape, dtype=i8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=f32, device=device),
                "v_scale": torch.zeros(shape[:3], dtype=f32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p: dict, x: torch.Tensor, cache: dict, pos: int,
                cfg: ModelConfig, *, window: Optional[int] = None,
                cross: bool = False):
    """One decode step. x: (B, 1, d); pos: tokens already in context.
    Self-attention writes the new K/V into `cache`; cross-attention reads
    its static cache as it is. Returns (y, cache)."""
    h = common.rms_norm(x, p["norm"], cfg.norm_eps)
    if cross:
        # no RoPE and no bias on q, as in the reference
        q = project_heads(h, p["wq"])
        y = _cached_attention(q, cache["k"], cache["v"], pos, None, cfg,
                              full=True)
    else:
        q, k, v = _qkv(p, h, None)
        # filled on the device: a host tensor copied there would wait for
        # the queue to drain
        where = torch.full((1, 1, 1), pos, device=x.device)
        q = common.rope(q, where, cfg.rope_theta)
        k = common.rope(k, where, cfg.rope_theta)
        slots = cache["k"].shape[2]
        slot = pos % slots if window else pos
        if slot >= slots:
            raise ValueError(f"decode position {pos} is past the cache's "
                             f"{slots} slots; prefill with a larger max_len")
        if "k_scale" in cache:
            kq, ks = _quantize(k[:, :, 0])
            vq, vs = _quantize(v[:, :, 0])
            _write_slot(cache["k"], kq, slot)
            _write_slot(cache["v"], vq, slot)
            _write_slot(cache["k_scale"], ks, slot)
            _write_slot(cache["v_scale"], vs, slot)
        else:
            _write_slot(cache["k"], k[:, :, 0], slot)
            _write_slot(cache["v"], v[:, :, 0], slot)
        y = _cached_attention(q, cache["k"], cache["v"], pos, window, cfg,
                              full=False, k_scale=cache.get("k_scale"),
                              v_scale=cache.get("v_scale"))
    y = project_out(y, p["wo"])
    return x + _gate(p, y), cache


def _write_slot(cache_t: torch.Tensor, value: torch.Tensor,
                slot: int) -> None:
    """cache_t[:, :, slot] = value, in place. A DTensor cache is written
    on its local shard by the rank whose slots hold `slot` (the value
    placed as the cache, its slot dim excepted), so a slot-sharded cache
    is never gathered."""
    if not policy.is_dtensor(cache_t):
        cache_t[:, :, slot] = value.to(cache_t.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache_t.device_mesh
    placements = [Replicate() if pl == Shard(2) else pl
                  for pl in cache_t.placements]
    val = policy.replicated(value, mesh).redistribute(mesh, placements)
    local = cache_t.to_local()
    lo = _slot_offset(cache_t)
    if lo <= slot < lo + local.shape[2]:
        local[:, :, slot - lo] = val.to_local().to(local.dtype)


def _slot_dims(cache_t) -> list:
    """The mesh dims that split a DTensor cache's slots (its dim 2), in
    mesh order: two for context-parallel slots on ("pod", "data")."""
    from torch.distributed.tensor import Shard
    return [j for j, pl in enumerate(cache_t.placements) if pl == Shard(2)]


def _slot_offset(cache_t) -> int:
    """The first slot of this rank's shard of a DTensor cache: the slots
    are cut over the splitting mesh dims in mesh order (the first
    outermost, as DTensor nests its shards), so the shard's index is
    this rank's coordinate over those dims, first dim major."""
    mesh = cache_t.device_mesh
    index, ways = 0, 1
    for j in _slot_dims(cache_t):
        index = index * mesh.size(j) + mesh.get_local_rank(j)
        ways *= mesh.size(j)
    if cache_t.shape[2] % ways:
        raise ValueError(f"{cache_t.shape[2]} cache slots do not divide "
                         f"over {ways} ranks")
    return index * (cache_t.shape[2] // ways)


def _cached_attention(q, kc, vc, pos: Optional[int], window,
                      cfg: ModelConfig, *, full: bool,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None):
    """Decode attention (`_local_cached_attention`); a DTensor cache on
    each rank's shard (`_sharded_cached_attention`)."""
    if policy.is_dtensor(kc):
        return _sharded_cached_attention(q, kc, vc, pos, window, cfg,
                                         full=full, k_scale=k_scale,
                                         v_scale=v_scale)
    return _local_cached_attention(q, kc, vc, pos, window, cfg, full=full,
                                   k_scale=k_scale, v_scale=v_scale)


def _sharded_cached_attention(q, kc, vc, pos, window, cfg, *, full,
                              k_scale=None, v_scale=None):
    """Flash-decode over a DTensor cache, in a `local_map` region: each
    rank takes the cache's local shard as it lies (batch on dp, kv heads
    or slots on model, or slots on dp for a batch of one) and q placed
    alike (its heads with the kv heads; replicated where the slots are
    split); where the slots are split, the softmax's max and sum and the
    value sums are reduced over that group, so the cache stays where it
    is; slots split over several mesh dims (("pod", "data")) are reduced
    over each of their groups in turn. Where every dp rank holds the
    same q and cache shards (a batch of one whose slots lie on "model"),
    each computes its slice of the output's head_dim, and the output is
    split there on dp, as the reference's compiled plan splits it. Decode
    only (no gradient)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = kc.device_mesh
    cache_pl = tuple(kc.placements)
    q_pl = tuple(Replicate() if pl == Shard(2) else pl for pl in cache_pl)
    groups = tuple(mesh.get_group(j) for j in _slot_dims(kc))
    slot0, slots = _slot_offset(kc), kc.shape[2]
    scaled = k_scale is not None
    out_pl, cols = q_pl, None
    dp = policy.fsdp_axes(tuple(mesh.mesh_dim_names))
    for j, name in enumerate(mesh.mesh_dim_names):
        ways, hd = mesh.size(j), q.shape[-1]
        if (name in dp and ways > 1 and policy.dp_idle(q)
                and cache_pl[j] == Replicate() and hd % ways == 0):
            lo = mesh.get_local_rank(j) * (hd // ways)
            cols = (lo, lo + hd // ways)
            out_pl = out_pl[:j] + (Shard(3),) + out_pl[j + 1:]

    def body(ql, kl, vl, *scales):
        ks, vs = scales if scaled else (None, None)
        return _local_cached_attention(ql, kl, vl, pos, window, cfg,
                                       full=full, k_scale=ks, v_scale=vs,
                                       slot0=slot0, total_slots=slots,
                                       slot_groups=groups, cols=cols)

    args = (q, kc, vc) + ((k_scale, v_scale) if scaled else ())
    return policy.run_local(body, mesh, args,
                            (q_pl,) + (cache_pl,) * (len(args) - 1), out_pl)


def _local_cached_attention(q, kc, vc, pos: Optional[int], window,
                            cfg: ModelConfig, *, full: bool,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None,
                            slot0: int = 0,
                            total_slots: Optional[int] = None,
                            slot_groups: tuple = (),
                            cols: Optional[tuple] = None):
    """q: (B, Hq, 1, hd); kc/vc: (B, Hkv, S, hd). Masked GEMV decode
    attention with grouped contractions (no repeat of the KV heads); with
    `full` every slot is live (cross attention). Both contractions read
    their operands in the compute dtype (the cache's, bfloat16 for an
    int8 cache) and sum in float32 with a float32 result, as the
    reference's `preferred_element_type=float32` does (int8 values are
    exact in bfloat16, so an int8 cache goes to float32 directly). An int8
    cache's scales are folded in after the integer-weight contractions:
    k_scale into the logits, v_scale into the probabilities.

    With `slot_groups`, kc/vc are slots [slot0, slot0 + S) of
    `total_slots` split over the ranks of those process groups together:
    the softmax's max and sum and the output are reduced over each group
    in turn, which reduces them over all the ranks (flash-decode). With
    `cols` = (lo, hi) only head_dim columns [lo, hi) of the output are
    computed."""
    b, hq, _, hd = q.shape
    hkv = kc.shape[1]
    slots = total_slots or kc.shape[2]
    group = hq // hkv
    f32 = torch.float32
    compute = torch.bfloat16 if kc.dtype == torch.int8 else kc.dtype
    qf = q.to(compute).reshape(b, hkv, group, hd)
    logits = torch.einsum("bkge,bkse->bkgs", qf.to(f32),
                          kc.to(f32)) / (hd ** 0.5)
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, :]
    if cfg.attn_logit_softcap is not None:
        logits = common.softcap(logits, cfg.attn_logit_softcap)
    if not full:
        slot_idx = slot0 + torch.arange(kc.shape[2], device=q.device)
        if window:
            # ring buffer: valid slots are the last min(pos+1, slots)
            # writes
            n_valid = min(pos + 1, slots)
            age = (pos % slots - slot_idx + slots) % slots   # 0 = newest
            mask = age < n_valid
        else:
            mask = slot_idx <= pos
        logits = logits.masked_fill(~mask[None, None, None, :], NEG_INF)
    dist = torch.distributed
    if not slot_groups:
        probs = torch.softmax(logits, dim=-1)
    else:
        m = torch.amax(logits, dim=-1, keepdim=True)
        for g in slot_groups:
            dist.all_reduce(m, dist.ReduceOp.MAX, group=g)
        e = torch.exp(logits - m)
        total = torch.sum(e, dim=-1, keepdim=True)
        for g in slot_groups:
            dist.all_reduce(total, group=g)
        probs = e / total
    if v_scale is not None:
        probs = probs * v_scale[:, :, None, :]
    if cols is not None:
        vc = vc[..., cols[0]:cols[1]]
    out = torch.einsum("bkgs,bkse->bkge", probs.to(compute).to(f32),
                       vc.to(f32))
    for g in slot_groups:
        dist.all_reduce(out, group=g)
    return out.reshape(b, hq, 1, vc.shape[-1]).to(q.dtype)
