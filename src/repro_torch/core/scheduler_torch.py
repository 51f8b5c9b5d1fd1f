"""Batched schedule evaluation and search on a torch device (beyond-paper).

Port of `repro.core.scheduler_jax`. The paper's heuristic evaluates one
candidate schedule at a time in Python; here assignment batches and whole
tabu neighbourhoods are scored with tensor ops on the device the caller
names (DESIGN.md §3.2, §8):

  * each shared tier's FIFO order key (arrival, release, index) depends
    only on the JOB SET, never on the candidate assignment — so the sort
    happens once per instance, not once per candidate;
  * the single-server FIFO recurrence e_j = max(arr_j, e_{j-1}) + p_j is
    a prefix op: with P_j = cumsum(p) in queue order,
    e_j = cummax_k<=j(arr_k - P_{k-1}) + P_j. Non-members are masked
    transparent (p=0, arr=-inf). Multi-server tiers walk the queue with a
    free-slot vector identical to the Python simulator's heap.

Used for:
  * exact small-n optimum: all 3^n assignments scored in batches;
  * `tabu_search_batched`: B ward instances searched together by
    delta-evaluated steepest-descent rounds ("round" regime, DESIGN.md §12)
    — variable sizes padded with transparent phantom jobs, mixed fleets
    padded with +inf-busy phantom machines, per-instance convergence flags.

JAX's `lax.scan` and `lax.while_loop` become Python loops here, with the
same per-step accumulation order, so sums over queue positions match the
reference step for step; the round loop reads one flag per round from the
device. Everything is float32, as `_specs_to_np` packs it.

Machine encoding: 0 = cloud, 1 = edge, 2 = device (private). Queue ties
break by (arrival, release, job index), matching `simulate`.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.simulator import JobSpec
from repro_torch.core.tiers import CC, ED, ES

N_MACHINES = 3
INF = float("inf")


def _specs_to_np(jobs: Sequence[JobSpec]):
    """Host-side (numpy) spec arrays — no device transfers (batch padding
    assembles B instances without B round trips), one pass over the jobs."""
    flat = np.asarray(
        [(j.release, j.weight, j.proc[CC], j.proc[ES], j.proc[ED],
          j.trans[CC], j.trans[ES], j.trans.get(ED, 0.0)) for j in jobs],
        np.float32).reshape(-1, 8)
    return flat[:, 0], flat[:, 1], flat[:, 2:5], flat[:, 5:8]


def specs_to_tensors(jobs: Sequence[JobSpec], device=None):
    """-> release (n,), weight (n,), proc (n,3), trans (n,3) on device."""
    return tuple(torch.as_tensor(x, device=device)
                 for x in _specs_to_np(jobs))


def _lexsort2(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """Indices sorting by `major`, ties by `minor`, remaining ties by index
    (numpy's lexsort((minor, major)) along the last dim): two stable
    sorts, minor key first."""
    o1 = torch.argsort(minor, dim=-1, stable=True)
    o2 = torch.argsort(torch.gather(major, -1, o1), dim=-1, stable=True)
    return torch.gather(o1, -1, o2)


def _tier_setup(rel, proc, trans, m: int):
    """Assignment-independent per-tier constants: the FIFO queue order
    (arrival, release, index) and arrival/processing times in that
    order."""
    arr = rel + trans[:, m]
    order = _lexsort2(rel, arr)
    return order, arr[order], proc[:, m][order]


def _shared_ends_single(mask_s, arr_s, p_s, free0):
    """Completion times on a 1-machine tier for A assignments (rows), in
    queue order, via prefix ops: e = max(cummax(arr - P_prev), free0) + P.
    ``free0`` is the machine's initial free time."""
    p_eff = torch.where(mask_s, p_s, 0.0)
    csum = torch.cumsum(p_eff, dim=1)
    q = torch.where(mask_s, arr_s, -INF) - (csum - p_eff)
    e = torch.maximum(torch.cummax(q, dim=1).values, free0) + csum
    return torch.where(mask_s, e, 0.0)


def _shared_ends_multi(mask_s, arr_s, p_s, busy):
    """Multi-machine tier: FIFO dispatch to the earliest-free machine (the
    vectorised analogue of the simulator's free-time heap), one queue
    position per step. ``busy`` is the (cnt,) vector of initial machine
    free times."""
    A, n = mask_s.shape
    free = busy.to(arr_s.dtype).expand(A, -1).clone()
    rows = torch.arange(A, device=mask_s.device)
    ends = []
    for j in range(n):
        valid, arr, p = mask_s[:, j], arr_s[j], p_s[j]
        slot = torch.argmin(free, dim=1)
        e = torch.maximum(arr, free[rows, slot]) + p
        free[rows, slot] = torch.where(valid, e, free[rows, slot])
        ends.append(torch.where(valid, e, 0.0))
    return torch.stack(ends, dim=1)


def _normalize_busy(busy_until, machines_per_tier: Tuple[int, int]):
    """-> ((m_cloud,), (m_edge,)) float32 arrays of initial machine free
    times, sorted, zero-padded to the machine count. Accepts None or a
    (cloud_times, edge_times) pair with <= machine entries per tier.

    Raises ValueError (not assert — guards must survive ``python -O``) when
    a caller lists more occupied machines than the tier has servers."""
    busy_until = busy_until or ((), ())
    out = []
    for vals, m in zip(busy_until, machines_per_tier):
        v = sorted(float(x) for x in np.asarray(vals).reshape(-1))
        if len(v) > m:
            raise ValueError(f"busy_until lists {len(v)} occupied machines "
                             f"for a {m}-machine tier")
        out.append(np.asarray([0.0] * (m - len(v)) + v, np.float32))
    return tuple(out)


def evaluate_assignments(assign, rel, w, proc, trans,
                         machines_per_tier: Tuple[int, int] = (1, 1),
                         busy_until=None):
    """assign: (A, n) integer tensor in {0, 1, 2}. Returns a dict of (A,)
    metrics {weighted, unweighted, last} on the device of `rel`.

    The simple whole-assignment oracle of the delta evaluator.
    machines_per_tier: (cloud, edge) shared-machine counts — the analogue
    of `simulate(..., machines_per_tier=...)`. busy_until: optional
    (cloud_times, edge_times) initial machine free times."""
    dev = rel.device
    busy = [torch.as_tensor(x, device=dev)
            for x in _normalize_busy(busy_until, machines_per_tier)]
    assign = torch.as_tensor(assign, device=dev)
    dev_end = rel + trans[:, 2] + proc[:, 2]
    end = torch.where(assign == 2, dev_end, 0.0)       # private device tier
    for m, cnt, bz in zip((0, 1), machines_per_tier, busy):
        order, arr_s, p_s = _tier_setup(rel, proc, trans, m)
        mask_s = (assign == m)[:, order]
        if cnt == 1:
            e_s = _shared_ends_single(mask_s, arr_s, p_s, bz[0])
        else:
            e_s = _shared_ends_multi(mask_s, arr_s, p_s, bz)
        e_full = torch.empty_like(e_s)
        e_full[:, order] = e_s
        end = end + e_full
    resp = end - rel
    return {"weighted": torch.sum(w * resp, dim=1),
            "unweighted": torch.sum(resp, dim=1),
            "last": torch.amax(end, dim=1)}


def exact_optimum_device(jobs: Sequence[JobSpec],
                         objective: str = "weighted", batch: int = 65536,
                         machines_per_tier: Tuple[int, int] = (1, 1),
                         busy_until=None, device=None):
    """Enumerate all 3^n assignments on `device`. Practical to n ~ 14.
    Returns (best value, best assignment as an (n,) int array)."""
    n = len(jobs)
    rel, w, proc, trans = specs_to_tensors(jobs, device)
    total = N_MACHINES ** n
    powers = N_MACHINES ** np.arange(n)
    best_v, best_a = np.inf, None
    for lo in range(0, total, batch):
        codes = np.arange(lo, min(lo + batch, total))
        assign = (codes[:, None] // powers[None]) % N_MACHINES
        m = evaluate_assignments(assign, rel, w, proc, trans,
                                 machines_per_tier=machines_per_tier,
                                 busy_until=busy_until)
        vals = m[objective].cpu().numpy()
        i = int(np.argmin(vals))
        if vals[i] < best_v:
            best_v, best_a = float(vals[i]), assign[i].astype(np.int32)
    return best_v, best_a


# ---------------------------------------------- delta-evaluated tabu search
#
# DESIGN.md §3.2/§8: a single-move candidate perturbs only its source and
# destination tiers, so a tabu round never re-evaluates whole assignments.
# Per round, each shared tier computes the incumbent stat plus all
# "toggle job k's membership" stats in ONE walk over the tier's (hoisted)
# queue order. Candidate (k, m) is then scored from per-tier scalars: the
# toggled source stat, the toggled destination stat, and the incumbent's
# untouched third-tier stat.

_OBJ_IDX = {"weighted": 0, "unweighted": 1, "last": 2}


def _shift_right(x: torch.Tensor, fill: float) -> torch.Tensor:
    """x[..., :-1] shifted one place right along the last dim, `fill` in
    front."""
    return torch.cat([torch.full_like(x[..., :1], fill), x[..., :-1]], -1)


def _shift_left(x: torch.Tensor, fill: float) -> torch.Tensor:
    """x[..., 1:] shifted one place left along the last dim, `fill` at the
    end."""
    return torch.cat([x[..., 1:], torch.full_like(x[..., :1], fill)], -1)


def _suffix_cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running max from the right along the last dim."""
    return torch.flip(torch.cummax(torch.flip(x, [-1]), dim=-1).values,
                      [-1])


def _tier_rounds(mask_T, arr_T, p_T, w_T, rel_T, busy_T, ps, oi: int):
    """Incumbent + movable-position toggled stats of BOTH shared tiers of
    every instance.

    Inputs are stacked per-tier queue-order constants, shape (B, 2, n)
    (and (B, 2, m) machine free times — mixed fleets pad the smaller tier
    with +inf phantom machines, which FIFO dispatch never selects).
    ``ps`` (B, 2, S) lists the queue POSITIONS of each instance's movable
    jobs (DESIGN.md §12): column s of the toggle state tracks the queue
    with the job at queue position ps[..., s] toggled (member removed /
    non-member inserted).

    All-single-server fleets (m == 1) use the running cummax of
    q = arr − P_prev (the §3.2 prefix recurrence); multi-machine fleets
    walk the queue with per-column free-slot vectors (start =
    max(arrival, earliest free), exactly as `simulate`). Returns ((B, 2)
    incumbent stats, (B, 2, S) toggled stats aligned with ps)."""
    B, _, n = mask_T.shape
    m = busy_T.shape[2]
    S = ps.shape[2]

    def gat(x):                                 # (B, 2, n) -> (B, 2, S)
        return torch.gather(x, 2, ps)

    if m == 1:
        p_eff = torch.where(mask_T, p_T, 0.0)
        csum = torch.cumsum(p_eff, dim=2)
        q = torch.where(mask_T, arr_T, -INF) - (csum - p_eff)
        free0 = busy_T[:, :, :1]                # finite on 1-machine tiers
        delta = torch.where(mask_T, -p_T, p_T)  # toggle's suffix p shift
        q_self = torch.where(mask_T, -INF, arr_T - (csum - p_eff))
        cm = torch.cummax(q, dim=2).values      # M_j, the §3.2 prefix max
        e_inc = torch.maximum(cm, free0) + csum  # incumbent completions
        # A toggle at position s leaves the queue prefix untouched and
        # shifts the suffix cumsum by delta_s, so with
        # K_s = max(M_{s-1}, q'_s, f0) and G_s = K_s + delta_s the
        # toggled completion of j > s is
        #   e'_j = max(K_s, R_{s+1,j} - delta_s) + C_j + delta_s
        #        = max(G_s, R_{s+1,j}) + C_j
        # (R = range max of q). Everything but the 2D range max reduces
        # to O(n) prefix/suffix sums of incumbent quantities.
        cm_prev = _shift_right(cm, -INF)
        K = torch.maximum(torch.maximum(cm_prev, q_self), free0)
        G = K + delta

        if oi != 2:
            wsel = w_T if oi == 0 else torch.ones_like(w_T)
            wm = torch.where(mask_T, wsel, 0.0)
            contrib = wm * (e_inc - rel_T)
            stat = torch.sum(contrib, dim=2)
            cpre = torch.cumsum(contrib, dim=2)
            pre = cpre - contrib                       # sum over j < s
            lin = wm * (csum - rel_T)
            clin = torch.cumsum(lin, dim=2)
            suf_lin = clin[:, :, -1:] - clin           # sum over j > s
            wpre = torch.cumsum(wm, dim=2)             # sum over j <= s
            own = torch.where(mask_T, 0.0, wsel * (G + csum - rel_T))
            # T_s = sum_{j>s} wm_j max(G_s, R_{s+1,j}) for each movable
            # toggle position s = ps[..., col]: one walk over queue
            # positions with a (B, 2, S) state. For j <= s the unmasked
            # accumulator collects wm_j G_s (R is still -inf there),
            # subtracted afterwards via wpre.
            Gm = gat(G)
            R = torch.full((B, 2, S), -INF, device=p_T.device)
            acc = torch.zeros((B, 2, S), dtype=p_T.dtype, device=p_T.device)
            for j in range(n):
                R = torch.maximum(
                    R, torch.where(ps < j, q[:, :, j:j + 1], -INF))
                acc = acc + wm[:, :, j:j + 1] * torch.maximum(Gm, R)
            tog = gat(pre) + gat(own) + (acc - Gm * gat(wpre)) \
                + gat(suf_lin)
            return stat, tog

        # "last" objective: the same toggle decomposition holds under max
        # (DESIGN.md §12) — members before s keep their incumbent
        # completions, an inserted s completes at G_s + csum_s, and for
        # members j > s the max of e'_j = max(G_s, R_{s+1,j}) + C_j
        # splits into G_s + max_j C_j plus the max-plus exchange
        #   max_{j>s}(R_{s+1,j} + C_j) = max_{i>s}(q_i + SC_i),
        # SC = inclusive suffix cummax of member csum.
        e_mem = torch.where(mask_T, e_inc, -INF)
        pmax = _shift_right(torch.cummax(e_mem, dim=2).values, -INF)
        SC = _suffix_cummax(torch.where(mask_T, csum, -INF))
        SCx = _shift_left(SC, -INF)
        Hx = _shift_left(_suffix_cummax(q + SC), -INF)
        own = torch.where(mask_T, -INF, G + csum)
        tog = torch.maximum(torch.maximum(pmax, own),
                            torch.maximum(G + SCx, Hx))
        tog = torch.clamp(tog, min=0.0)        # empty-queue floor
        # max over the queue with an explicit -inf floor (an empty
        # reduction in the reference's `initial=-inf`)
        neg = torch.full_like(e_mem[:, :, :1], -INF)
        stat = torch.clamp(torch.amax(torch.cat([neg, e_mem], 2), dim=2),
                           min=0.0)
        return stat, gat(tog)

    slots = torch.arange(m, device=busy_T.device)
    # column S is a sentinel toggle position (n, never a queue index):
    # its row walks the untouched incumbent with identical arithmetic
    ps_ext = torch.cat([ps, torch.full_like(ps[:, :, :1], n)], dim=2)
    free = busy_T[:, :, None, :].expand(B, 2, S + 1, m).clone()
    acc = torch.zeros((B, 2, S + 1), dtype=p_T.dtype, device=p_T.device)
    for j in range(n):
        a_j, p_j = arr_T[:, :, j, None], p_T[:, :, j, None]
        w_j, rel_j = w_T[:, :, j, None], rel_T[:, :, j, None]
        live = mask_T[:, :, j, None] != (ps_ext == j)
        slot = torch.argmin(free, dim=3, keepdim=True)
        fmin = torch.gather(free, 3, slot)[..., 0]
        e = torch.maximum(a_j, fmin) + p_j
        free = torch.where((slots == slot) & live[..., None],
                           e[..., None], free)
        if oi == 2:
            acc = torch.maximum(acc, torch.where(live, e, 0.0))
        else:
            resp = e - rel_j
            acc = acc + torch.where(live, w_j * resp if oi == 0 else resp,
                                    0.0)
    return acc[:, :, S], acc[:, :, :S]


def _device_round(assign, dev_end, dev_resp, dev_wresp, oi: int):
    """Incumbent + toggled stats of the private device tier, O(B n):
    per-job contributions are constants, so sum objectives are one ± of a
    precomputed constant and "last" needs only the masked top-2."""
    member = assign == 2
    if oi == 2:
        iota = torch.arange(assign.shape[1], device=assign.device)
        ends = torch.where(member, dev_end, -INF)
        amax = torch.argmax(ends, dim=1)
        max1 = torch.gather(ends, 1, amax[:, None])[:, 0]
        is_max = iota == amax[:, None]
        rest = torch.where(is_max, -INF, ends)
        max2 = torch.amax(torch.cat([torch.full_like(rest[:, :1], -INF),
                                     rest], 1), dim=1)
        stat = torch.clamp(max1, min=0.0)
        tog = torch.where(
            member,
            torch.clamp(torch.where(is_max, max2[:, None], max1[:, None]),
                        min=0.0),
            torch.maximum(stat[:, None], dev_end))
        return stat, tog
    con = dev_wresp if oi == 0 else dev_resp
    stat = torch.sum(torch.where(member, con, 0.0), dim=1)
    return stat, stat[:, None] + torch.where(member, -con, con)


def _round_batched(assign, mov_idx, mov_ok, tc, dev, oi: int):
    """One delta-evaluated neighbourhood round for the whole batch.

    Returns ((B,) incumbent objectives, (B, S, 3) candidate values):
    entry (b, i, m) is the exact objective of instance b with job
    mov_idx[b, i] moved to machine m, assembled from the two affected
    tiers' toggled stats and the incumbent's third-tier stat. Only
    movable jobs get candidate slots (DESIGN.md §12). No-op moves and
    invalid padding slots (~mov_ok) score +inf. tc holds the stacked
    (B, 2, n) per-tier queue-order constants; dev the device-tier
    constants."""
    B, _ = assign.shape
    S = mov_idx.shape[1]
    mask_T = torch.gather(torch.stack([assign == 0, assign == 1], dim=1), 2,
                          tc["order"])
    # queue positions of the movable jobs on each tier — tog comes back
    # already aligned with the movable slots, no pos->job scatter needed
    ps = torch.gather(tc["pos"], 2, mov_idx[:, None, :].expand(B, 2, S))
    stat_T, tog_T = _tier_rounds(mask_T, tc["arr"], tc["p"], tc["w"],
                                 tc["rel"], tc["busy"], ps, oi)
    stat_d, tog_d = _device_round(assign, dev["end"], dev["resp"],
                                  dev["wresp"], oi)
    tog_d = torch.gather(tog_d, 1, mov_idx)                  # (B, S)
    a_mov = torch.gather(assign, 1, mov_idx)                 # (B, S)
    stats = torch.cat([stat_T, stat_d[:, None]], 1)          # (B, 3)
    tog = torch.cat([tog_T, tog_d[:, None, :]], 1)           # (B, 3, S)
    mr = torch.arange(N_MACHINES, device=assign.device)
    if oi == 2:
        total = torch.amax(stats, dim=1)
        src_t = torch.gather(tog, 1, a_mov[:, None, :])[:, 0, :]
        third = torch.clamp(3 - a_mov[:, :, None] - mr[None, None, :], 0, 2)
        stats_third = torch.gather(stats, 1,
                                   third.reshape(B, -1)).reshape(B, S, 3)
        vals = torch.maximum(torch.maximum(src_t[:, :, None],
                                           tog.transpose(1, 2)),
                             stats_third)
    else:
        total = stats[:, 0] + stats[:, 1] + stats[:, 2]
        d = tog - stats[:, :, None]             # per-tier toggle deltas
        src_d = torch.gather(d, 1, a_mov[:, None, :])[:, 0, :]
        vals = total[:, None, None] + src_d[:, :, None] + d.transpose(1, 2)
    vals = torch.where(mr[None, None, :] == a_mov[:, :, None], INF, vals)
    vals = torch.where(mov_ok[:, :, None], vals, INF)
    return total, vals


def _run_rounds(assign0, mov_idx, mov_ok, tc, dev, oi, max_moves, binds):
    """mode="round": steepest descent over the S x 3 single-move
    neighbourhood, one wide delta-evaluated round per iteration, accept
    each instance's best strictly improving move plus a second,
    exactly-composing move on the other shared tier when one improves
    (cloud/edge queues are disjoint and the private device tier is
    additive per job, so the pair composes exactly for sum objectives).
    The loop test reads one flag from the device per round."""
    B, _ = assign0.shape
    S = mov_idx.shape[1]
    d = assign0.device
    mr = torch.arange(N_MACHINES, device=d)

    assign = assign0
    totals = torch.full((B,), INF, device=d)
    active = torch.ones((B,), dtype=torch.bool, device=d)
    rnd = 0
    while rnd < max_moves and bool(active.any()):
        total, vals = _round_batched(assign, mov_idx, mov_ok, tc, dev, oi)
        flat = vals.reshape(B, -1)              # candidate (s, m) = s*3+m
        i1 = torch.argmin(flat, dim=1)          # first minimum on ties
        v1 = torch.gather(flat, 1, i1[:, None])[:, 0]
        s1 = i1 // N_MACHINES
        k1 = torch.gather(mov_idx, 1, s1[:, None])[:, 0]
        m1 = i1 % N_MACHINES
        improved = active & (v1 < total)
        src1 = assign[binds, k1]
        new_assign = assign.clone()
        new_assign[binds, k1] = torch.where(improved, m1, src1)
        # the carried value is the FRESH per-tier evaluation of the
        # incumbent whenever a ward converges (its last round rejects
        # every move, so `total` is its final assignment's exact score);
        # only a max_rounds cap can surface a delta-assembled value
        value = torch.where(improved, v1, total)
        if oi != 2:
            # paired acceptance: a second strictly-improving move whose
            # shared-tier footprint is disjoint from the first composes
            # EXACTLY for sum objectives — its standalone delta still
            # holds after the first move commits
            sh0 = (src1 == 0) | (m1 == 0)
            sh1 = (src1 == 1) | (m1 == 1)
            other = sh0.to(assign.dtype)       # 1 if sh0 else 0
            pairable = improved & ~(sh0 & sh1)
            a_slot = torch.gather(assign, 1, mov_idx)
            ok_src = (a_slot == other[:, None]) | (a_slot == 2)
            ok_dst = (mr[None, None, :] == other[:, None, None]) \
                | (mr[None, None, :] == 2)
            elig = ok_src[:, :, None] & ok_dst & (
                torch.arange(S, device=d)[None, :, None]
                != s1[:, None, None])
            flat2 = torch.where(elig.reshape(B, -1), flat, INF)
            i2 = torch.argmin(flat2, dim=1)
            v2 = torch.gather(flat2, 1, i2[:, None])[:, 0]
            s2 = i2 // N_MACHINES
            k2 = torch.gather(mov_idx, 1, s2[:, None])[:, 0]
            m2 = i2 % N_MACHINES
            accept2 = pairable & (v2 < total)
            new_assign[binds, k2] = torch.where(accept2, m2,
                                                new_assign[binds, k2])
            value = torch.where(accept2, value + (v2 - total), value)
        assign, totals, active = new_assign, value, improved
        rnd += 1
    if rnd == 0:
        # max_rounds == 0 (greedy probe): the loop never evaluated anything
        totals = _round_batched(assign, mov_idx, mov_ok, tc, dev, oi)[0]
    return assign, totals, rnd


def _tabu_run_batched(assign0, rel, w, proc, trans, mov_idx, mov_ok,
                      max_rounds: int, busy_c, busy_e, objective: str,
                      greedy_init: bool = False, mode: str = "round"):
    """Algorithm-2 search for B instances at once, on the device of the
    inputs (DESIGN.md §12).

    mode="round" — the movable-dominated regime: one steepest-descent
    round per iteration, all S toggles priced in one wide evaluation,
    accept each instance's best strictly improving move (plus a second,
    exactly-composing move on the other shared tier when one improves);
    `max_rounds` passes translate to a `max_rounds * S` move budget.
    Per-instance convergence flags let a converged ward idle while
    stragglers keep searching; machine counts are carried by the busy
    vector shapes (phantom machines = +inf)."""
    if mode != "round":
        raise NotImplementedError(
            f"mode={mode!r}: the background-heavy pass regime is not "
            f"ported yet (ROADMAP.md, queue 1, item 4: pass regime)")
    if greedy_init:
        raise NotImplementedError(
            "greedy initial assignment on the device is not ported yet "
            "(ROADMAP.md, queue 1, item 4: greedy init); pass `initial`")
    oi = _OBJ_IDX[objective]
    B, n = assign0.shape
    m_mm = max(busy_c.shape[1], busy_e.shape[1])

    def pad(bz):
        extra = torch.full((B, m_mm - bz.shape[1]), INF, dtype=bz.dtype,
                           device=bz.device)
        return torch.cat([bz, extra], dim=1)

    busy_T = torch.stack([pad(busy_c), pad(busy_e)], dim=1)  # (B, 2, m)
    parts = []
    for m in (0, 1):
        arr = rel + trans[:, :, m]
        order = _lexsort2(rel, arr)
        pos = torch.argsort(order, dim=1)       # job id -> queue position

        def gat(x, o=order):
            return torch.gather(x, 1, o)

        parts.append({"order": order, "pos": pos, "arr": gat(arr),
                      "p": gat(proc[:, :, m]), "w": gat(w),
                      "rel": gat(rel)})
    tc = {key: torch.stack([parts[0][key], parts[1][key]], dim=1)
          for key in parts[0]}                  # each (B, 2, n)
    tc["busy"] = busy_T
    dev_end = rel + trans[:, :, 2] + proc[:, :, 2]
    dev = {"end": dev_end, "resp": dev_end - rel,
           "wresp": w * (dev_end - rel)}
    binds = torch.arange(B, device=rel.device)
    S = mov_idx.shape[1]
    return _run_rounds(assign0, mov_idx, mov_ok, tc, dev, oi,
                       max_rounds * S, binds)


def _reservation_rows(resv):
    """Host-side kernel rows for one ward's {tier: [Reservation]} map
    (DESIGN.md §12) — the interval representation compiles into ordinary
    pinned rows appended AFTER the instance's jobs: arrival enters via
    trans = arrival − release (so queue key (arrival, release, index)
    ties break jobs-first, then reservation input order, exactly like
    `simulate`), the row occupies its tier's pool for ``proc`` and
    contributes weight*(end − release) to the objective, and movable
    stays False so no round ever prices a move on it. Returns the
    (K, 8) _specs_to_np-layout block plus the (K,) tier codes."""
    rows, tiers = [], []
    for m, tier in ((0, CC), (1, ES)):
        for r in (resv or {}).get(tier, ()):
            p = [0.0] * N_MACHINES
            t = [0.0] * N_MACHINES
            p[m] = float(r.proc)
            t[m] = float(r.arrival) - float(r.release)
            rows.append((float(r.release), float(r.weight), *p, *t))
            tiers.append(m)
    bad = sorted(set(resv or {}) - {CC, ES})
    if bad:
        raise ValueError(f"reservations may only name shared tiers "
                         f"[{CC!r}, {ES!r}], got {bad}")
    return (np.asarray(rows, np.float32).reshape(-1, 8),
            np.asarray(tiers, np.int32))


def _movable_slots(movable: np.ndarray, n_max: int):
    """Bucketed movable-slot index arrays for the batch (DESIGN.md §12):
    S = the max per-instance movable count rounded up to a multiple of 16
    (capped at n_max). Returns (mov_idx (B, S) int64 job ids, mov_ok
    (B, S) bool — padding slots point at job 0 and are masked +inf by the
    round)."""
    B = movable.shape[0]
    smax = int(movable.sum(axis=1).max()) if B else 0
    S = min(n_max, ((max(smax, 1) + 15) // 16) * 16)
    mov_idx = np.zeros((B, S), np.int64)
    mov_ok = np.zeros((B, S), bool)
    for b in range(B):
        idx = np.flatnonzero(movable[b])
        mov_idx[b, :len(idx)] = idx
        mov_ok[b, :len(idx)] = True
    return mov_idx, mov_ok


def _per_instance_mpt(machines_per_tier, B: int):
    """-> B (cloud, edge) machine-count pairs from one pair or a per-ward
    sequence."""
    if machines_per_tier is None:
        return [(1, 1)] * B
    seq = list(machines_per_tier)
    if len(seq) == 2 and all(isinstance(x, (int, np.integer)) for x in seq):
        return [(int(seq[0]), int(seq[1]))] * B
    if len(seq) != B:
        raise ValueError(f"machines_per_tier lists {len(seq)} fleets "
                         f"for {B} instances")
    return [(int(c), int(e)) for c, e in seq]


def tabu_search_batched(batch_jobs: Sequence[Sequence[JobSpec]],
                        initial: Sequence[Sequence[int]] | None = None,
                        *, max_rounds: int | None = None,
                        objective: str = "weighted",
                        machines_per_tier=(1, 1),
                        busy_until=None,
                        frozen=None,
                        reserved=None,
                        pad_to: int | None = None,
                        device=None):
    """Plan B independent ward instances together on `device` (default:
    the CPU). Counts its calls in `tabu_search_batched.calls`.

    batch_jobs: B job lists; sizes may differ — instances are padded to
    the largest with phantom jobs (p = 0, w = 0, masked transparent) that
    contribute exactly 0 to every objective and whose moves score +inf.
    machines_per_tier: one (cloud, edge) pair for the whole fleet or a
    per-ward sequence; mixed fleets are padded to the per-tier maximum
    with phantom machines whose initial busy time is +inf, so FIFO
    dispatch never selects them. busy_until: optional per-ward
    (cloud_times, edge_times) pairs.

    frozen: optional per-ward boolean masks (DESIGN.md §9) — a frozen job
    occupies its machine pool and counts toward the objective, but every
    move on it scores +inf. reserved: optional per-ward {tier:
    [Reservation]} maps (DESIGN.md §12), compiled into pinned rows after
    the ward's jobs. Both require an explicit ``initial``. pad_to: pad
    instances to at least this many job slots.

    Only the "round" regime is ported: a batch whose movable slots are
    fewer than half its padded rows (the reference's "pass" regime) and a
    call without ``initial`` (the device greedy init) raise
    NotImplementedError.

    Returns (objectives (B,) float ndarray, [per-ward (n_i,) int arrays])
    where objectives INCLUDE reservation contributions and assignments
    cover only the ward's own jobs."""
    tabu_search_batched.calls += 1
    B = len(batch_jobs)
    if B == 0:
        return np.zeros((0,)), []
    if reserved is None:
        reserved = [None] * B
    elif initial is None and any(r for r in reserved):
        raise ValueError("reservations require an explicit initial "
                         "assignment (greedy init ignores their "
                         "occupancy)")
    rsv = [_reservation_rows(r) for r in reserved]
    sizes = [len(jobs) for jobs in batch_jobs]
    rows = [nb + rr.shape[0] for nb, (rr, _) in zip(sizes, rsv)]
    n_max = max(rows)
    if pad_to is not None:
        n_max = max(n_max, int(pad_to))
    if frozen is not None and initial is None:
        raise ValueError("frozen jobs require an explicit initial "
                         "assignment (greedy init would reassign them)")
    mpts = _per_instance_mpt(machines_per_tier, B)
    m_max = (max(c for c, _ in mpts), max(e for _, e in mpts))
    if busy_until is None:
        busy_until = [None] * B
    if n_max == 0:
        return np.zeros((B,)), [np.zeros((0,), np.int64) for _ in range(B)]

    rel = np.zeros((B, n_max), np.float32)
    w = np.zeros((B, n_max), np.float32)
    proc = np.zeros((B, n_max, N_MACHINES), np.float32)
    trans = np.zeros((B, n_max, N_MACHINES), np.float32)
    movable = np.zeros((B, n_max), bool)
    assign0 = np.full((B, n_max), 2, np.int64)  # phantoms pinned to device
    busy_c = np.full((B, m_max[0]), np.inf, np.float32)
    busy_e = np.full((B, m_max[1]), np.inf, np.float32)
    for b, jobs in enumerate(batch_jobs):
        nb = sizes[b]
        bc, be = _normalize_busy(busy_until[b], mpts[b])
        busy_c[b, :mpts[b][0]] = bc
        busy_e[b, :mpts[b][1]] = be
        rr, rt = rsv[b]
        if nb:
            rel[b, :nb], w[b, :nb], proc[b, :nb], trans[b, :nb] = \
                _specs_to_np(jobs)
            movable[b, :nb] = True
            if frozen is not None and frozen[b] is not None:
                fr = np.asarray(list(frozen[b]), bool)
                if fr.shape != (nb,):
                    raise ValueError(f"ward {b}: frozen mask has shape "
                                     f"{fr.shape}, expected ({nb},)")
                movable[b, :nb] &= ~fr
            if initial is not None:
                assign0[b, :nb] = list(initial[b])
        if rt.shape[0]:
            hi = nb + rt.shape[0]
            rel[b, nb:hi] = rr[:, 0]
            w[b, nb:hi] = rr[:, 1]
            proc[b, nb:hi] = rr[:, 2:5]
            trans[b, nb:hi] = rr[:, 5:8]
            assign0[b, nb:hi] = rt
    mov_idx, mov_ok = _movable_slots(movable, n_max)
    if max_rounds is None:
        max_rounds = 50
    # regime dispatch (DESIGN.md §12): movable-dominated batches (movable
    # bucket at least half the padded rows) take the wide steepest-descent
    # rounds; background-heavy batches would take the reference's
    # width-1 passes, not ported yet
    mode = "round" if 2 * mov_idx.shape[1] >= n_max else "pass"

    def put(a):
        return torch.as_tensor(a, device=device)

    assign, totals, _ = _tabu_run_batched(
        put(assign0), put(rel), put(w), put(proc), put(trans), put(mov_idx),
        put(mov_ok), int(max_rounds), put(busy_c), put(busy_e), objective,
        greedy_init=initial is None, mode=mode)
    assign = assign.cpu().numpy()
    return (totals.cpu().numpy().astype(np.float64),
            [assign[b, :sizes[b]] for b in range(B)])


tabu_search_batched.calls = 0
