"""Expert-parallel MoE over all-to-all, as the reference's
(src/repro/sharding/ep_moe.py), on a DeviceMesh.

The baseline MoE is tensor-parallel: every rank computes every expert
with d_ff split over "model". Expert parallelism instead PLACES each
expert on a group of model-axis shards and moves the (much smaller) routed
token copies with all-to-all: compute goes where the weights live; only
the job payload travels.

Layout on the "model" axis (size M) with E experts, r = M / E:
  * weights are stored EP-major (configs.base.moe_ep_shards): shard s owns
    expert s // r's (d, f/r) slice, so no weight moves at use;
  * activations arrive sequence-sharded on "model" (batch on dp): each
    shard routes its own tokens;
  * `all_to_all_single` over the model group ships routed copies to the
    owner shards; the expert FFN output is partial over f/r and completed
    by a sum over the r-shard expert group (subgroups made once per
    mesh); a second all-to-all ships results back; the router-weighted
    combine is local.

Each rank's part runs on its local shards in a `local_map` region, with
process-group collectives in place of the reference's `lax.all_to_all`
and `psum`. EP is an inference layout (the experts are dp-replicated and
the collectives carry no gradient): it raises under grad.
"""
from __future__ import annotations

import math
import weakref

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.sharding import policy

# the r-shard expert subgroups of each mesh, made once per mesh
_GROUPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def ep_group_pairs(e: int, r: int):
    """Positions along "model" of each expert's r shards."""
    return [[i * r + j for j in range(r)] for i in range(e)]


def _expert_group(mesh, e: int, r: int):
    """This rank's r-shard expert group: every rank makes every group
    once (in the same order), as `dist.new_group` requires."""
    cache = _GROUPS.setdefault(mesh, {})
    if (e, r) not in cache:
        names = list(mesh.mesh_dim_names)
        grid = mesh.mesh.movedim(names.index("model"), -1)
        rows = grid.reshape(-1, grid.shape[-1]).tolist()
        groups = [[row[p] for p in pos] for row in rows
                  for pos in ep_group_pairs(e, r)]
        cache[(e, r)], _ = dist.new_subgroups_by_enumeration(groups)
    return cache[(e, r)]


def ep_moe_ffn(experts, router, h, cfg, mesh):
    """h: (B, S, d) normed MoE input (batch on dp, sequence on model).
    experts: {"ep_gate", "ep_up"} (E*r, d, f/r), {"ep_down"} (E*r, f/r,
    d). Returns the expert-FFN output placed as h, and the load-balance
    aux (each shard's, averaged over model and dp)."""
    from repro_torch.models.blocks import _route as route

    e = cfg.num_experts
    k = cfg.num_experts_per_tok
    sizes = policy.axis_sizes(mesh)
    m = sizes["model"]
    r = cfg.moe_ep_shards
    if m != e * r:
        raise ValueError(f"EP MoE needs model axis == experts x shards, "
                         f"got model={m}, experts={e}, shards={r}")
    if torch.is_grad_enabled() and any(
            getattr(t, "requires_grad", False)
            for t in (h, router, *experts.values())):
        raise RuntimeError("EP MoE is an inference layout (dp-replicated "
                           "expert storage): run it without grad")
    d = cfg.d_model
    dp_axes = policy.fsdp_axes(tuple(sizes))
    dp_total = math.prod(sizes[a] for a in dp_axes)
    bsz, s, _ = h.shape
    # decode (seq 1) cannot shard the sequence; batch 1 cannot shard dp:
    # those stay replicated
    seq_on_model = s % m == 0 and s >= m
    b_on_dp = bsz % dp_total == 0 and bsz >= dp_total
    t_loc = (bsz // dp_total if b_on_dp else bsz) * (s // m if seq_on_model
                                                     else s)
    # capacity per EXPERT GROUP: every copy goes to all r replicas of its
    # expert (each holds an f/r slice; the group sum completes the
    # product, so the replicas must see the same tokens)
    send_cap = max(1, int(math.ceil(k * t_loc / e
                                    * cfg.moe_capacity_factor)))
    model_group = mesh.get_group("model")
    r_group = _expert_group(mesh, e, r) if r > 1 else None
    dp_groups = [mesh.get_group(a) for a in dp_axes]

    from torch.distributed.tensor import Replicate, Shard
    h_pl = tuple(Shard(0) if a in dp_axes and b_on_dp and sizes[a] > 1
                 else Shard(1) if a == "model" and seq_on_model
                 else Replicate() for a in sizes)
    w_pl = tuple(Shard(0) if a == "model" else Replicate() for a in sizes)
    rep = (Replicate(),) * len(sizes)

    def run(h_loc, wg, wu, wd, rt):
        hf = h_loc.reshape(-1, d)                              # (T, d)
        t = hf.shape[0]
        probs, top_w, top_e = route(hf, rt, k)
        # destination EXPERT GROUP; the send block is replicated to all r
        # replica shards of the group (each computes its f/r slice)
        dest = top_e.reshape(-1)                               # (T*k,)
        order = torch.argsort(dest, stable=True)
        sorted_dest = dest[order]
        counts = torch.zeros(e, dtype=torch.int64, device=hf.device)
        counts.scatter_add_(0, sorted_dest, torch.ones_like(sorted_dest))
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(t * k, device=hf.device) - starts[sorted_dest]
        keep = rank < send_cap
        slot = torch.where(keep, sorted_dest * send_cap + rank,
                           e * send_cap)
        tok = torch.div(order, k, rounding_mode="floor")
        send = hf.new_zeros((e * send_cap + 1, d))
        send.index_add_(0, slot, hf[tok] * keep[:, None].to(hf.dtype))
        send = send[:-1].reshape(e, send_cap, d).repeat_interleave(r, 0)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send.contiguous(), group=model_group)
        work = recv.reshape(m * send_cap, d)                   # my jobs
        act = F.silu(work @ wg[0]) * (work @ wu[0])
        out = act @ wd[0]                                      # partial f/r
        if r_group is not None:
            dist.all_reduce(out, group=r_group)
        out = out.to(h_loc.dtype).contiguous()
        back = torch.empty_like(out)
        dist.all_to_all_single(back, out, group=model_group)
        # replicas return the same group-complete results; keep replica 0
        back = back.reshape(e, r, send_cap, d)[:, 0].reshape(
            e * send_cap, d)
        w_sorted = top_w.reshape(-1)[order]
        contrib = back[torch.where(keep, slot, 0)] \
            * (w_sorted * keep).to(back.dtype)[:, None]
        y = back.new_zeros((t, d))
        y.index_add_(0, tok, contrib)
        frac = torch.mean(F.one_hot(top_e[..., 0], e).to(torch.float32),
                          dim=0)
        aux = e * torch.sum(frac * torch.mean(probs, dim=0))
        for group in [model_group, *dp_groups]:
            dist.all_reduce(aux, group=group)
            aux = aux / dist.get_world_size(group)
        return y.reshape(h_loc.shape), aux

    h = policy.constrain(policy.replicated(h, mesh),
                         (policy.DP, policy.TP, None))
    return policy.run_local(
        run, mesh, (h, experts["ep_gate"], experts["ep_up"],
                    experts["ep_down"], router),
        (h_pl, w_pl, w_pl, w_pl, rep), (h_pl, rep))
