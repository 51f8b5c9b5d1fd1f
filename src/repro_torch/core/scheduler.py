"""Algorithm 2 — multi-job allocation heuristic (paper Section VI).

Pipeline:
  1. greedy initial solution: jobs in release order (tie: priority desc),
     each assigned to the machine minimising its completion time given the
     machine free-times so far ("the earliest released job gets the
     shortest response time");
  2. tabu-guarded neighbourhood search: repeatedly pick the
     earliest-completing non-tabu job, try moving it to every other
     machine, keep the move with the largest positive reduction of the
     weighted whole response time (paper lines 10-28);
  3. every candidate is scored with the incremental evaluator
     (simulator.ScheduleState) whose per-move cost is O(two machine
     queues); the returned Schedule is always a final exact re-simulation,
     so reported numbers always reflect C1-C5 semantics.

`search` dispatches between this Python path (small n) and the batched
device search (scheduler_torch.tabu_search_batched) above
DEVICE_SEARCH_THRESHOLD jobs on a CUDA device — see DESIGN.md §3.3.
`search_batched` plans many wards in one device search, and
`search_fleet` plans them against one shared cloud to a fixed point
(DESIGN.md §8-§9).

Also provides baseline strategies (Table VII comparison set), an exact
brute-force optimum for small n (the paper has none — we add it to measure
the heuristic's optimality gap), and `neighborhood_search_reference`, the
seed full-re-simulation implementation kept as a benchmark baseline and
parity oracle.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from repro_torch.core.simulator import (MACHINES, FleetSchedule, JobSpec,
                                        Reservation, Schedule, ScheduleState,
                                        _fleet_mpts, machine_free_times,
                                        simulate, simulate_fleet)
from repro_torch.core.tiers import CC, ED, ES
from repro_torch.device import resolve_device

# above this many jobs, `search` on a CUDA device takes the device search
DEVICE_SEARCH_THRESHOLD = 64

# batches at least this large dispatch to the single-call batched device
# search (DESIGN.md §8); smaller ones loop the per-instance `search`
BATCHED_SEARCH_MIN_WARDS = 4


# --------------------------------------------------------------- strategies
def all_on_tier(jobs: Sequence[JobSpec], tier: str,
                machines_per_tier: Mapping[str, int] | None = None
                ) -> Schedule:
    return simulate(jobs, [tier] * len(jobs),
                    machines_per_tier=machines_per_tier)


def per_job_optimal(jobs: Sequence[JobSpec],
                    machines_per_tier: Mapping[str, int] | None = None
                    ) -> Schedule:
    """Table VII row 2: each job on its own Algorithm-1-optimal tier,
    ignoring queueing."""
    assign = [min(MACHINES, key=lambda t: j.response_if_alone(t))
              for j in jobs]
    return simulate(jobs, assign, machines_per_tier=machines_per_tier)


# ------------------------------------------------------------------ greedy
def greedy_schedule(jobs: Sequence[JobSpec],
                    machines_per_tier: Mapping[str, int] | None = None,
                    busy_until: Mapping[str, Sequence[float]] | None = None
                    ) -> List[str]:
    """Initial feasible solution (Algorithm 2 step 1).

    Honors multi-server tiers (earliest-free machine per tier) and
    machines already busy at the start (``busy_until``, DESIGN.md §7) —
    the same greedy rule online scheduling commits on each arrival.
    """
    mpt = dict(machines_per_tier or {CC: 1, ES: 1})
    order = sorted(range(len(jobs)),
                   key=lambda i: (jobs[i].release, -jobs[i].weight, i))
    free = {t: machine_free_times(busy_until, t, mpt.get(t, 1))
            for t in (CC, ES)}
    for heap in free.values():
        heapq.heapify(heap)
    assign: List[str] = [""] * len(jobs)
    for i in order:
        job = jobs[i]
        best_t, best_end = None, float("inf")
        for tier in (ED, ES, CC):    # tie -> prefer lower tier
            arr = job.release + job.trans.get(tier, 0.0)
            start = arr if tier == ED else max(arr, free[tier][0])
            end = start + job.proc[tier]
            if end < best_end:
                best_t, best_end = tier, end
        assign[i] = best_t
        if best_t != ED:
            heapq.heapreplace(free[best_t], best_end)
    return assign


# ------------------------------------------------- Algorithm 2 (tabu search)
def neighborhood_search(jobs: Sequence[JobSpec],
                        initial: Sequence[str] | None = None,
                        max_count: int = 50,
                        objective: str = "weighted",
                        machines_per_tier: Mapping[str, int] | None = None,
                        busy_until: Mapping[str, Sequence[float]] | None
                        = None,
                        frozen: Sequence[bool] | None = None,
                        reserved: Mapping[str, Sequence[Reservation]] | None
                        = None) -> Schedule:
    """Paper Algorithm 2. objective: "weighted" (eq. 5) | "unweighted".

    Each candidate move is scored incrementally (only the two affected
    machine queues are re-simulated), and the incumbent objective is
    re-derived from the committed state after every accepted move — no
    running ``best -= v_max`` accumulator, so no float drift over long
    searches.

    machines_per_tier / busy_until describe the fleet the schedule will
    actually run on (multi-server tiers, machines pre-occupied by committed
    jobs) — the searched objective IS the commit objective (DESIGN.md §7).
    frozen: jobs the search must never reassign (they still occupy their
    queues and count toward the objective — DESIGN.md §9 background jobs);
    requires an explicit ``initial`` carrying their pinned tiers.
    reserved: {tier: [Reservation]} committed background occupancy merged
    into the shared queues (DESIGN.md §12) — queue-active and scored like
    frozen jobs, but never a move candidate, so a mostly-background
    instance searches only its own jobs. Requires an explicit ``initial``
    (the greedy initialiser ignores reservation occupancy).
    """
    if frozen is not None and any(frozen) and initial is None:
        raise ValueError("frozen jobs require an explicit initial "
                         "assignment carrying their pinned tiers")
    if reserved and any(reserved.values()) and initial is None:
        raise ValueError("reservations require an explicit initial "
                         "assignment (greedy init ignores their occupancy)")
    assign = list(initial or greedy_schedule(
        jobs, machines_per_tier=machines_per_tier, busy_until=busy_until))
    state = ScheduleState(jobs, assign, machines_per_tier=machines_per_tier,
                          busy_until=busy_until, reserved=reserved)
    best = state.score(objective)
    for _ in range(max_count):
        tabu_job = [bool(frozen[i]) if frozen is not None else False
                    for i in range(len(jobs))]
        improved_this_round = False
        for _inner in range(len(jobs)):
            # earliest-completing non-tabu job (paper line 15)
            cand = [i for i in range(len(jobs)) if not tabu_job[i]]
            if not cand:
                break
            k = min(cand, key=lambda i: state.end[i])
            tabu_job[k] = True
            # best move for job k across machines (paper lines 17-25)
            v_max, move = 0.0, None
            for tier in MACHINES:
                if tier == state.assign[k]:
                    continue
                v = best - state.try_move(k, tier, objective)
                if v > v_max:
                    v_max, move = v, tier
            if move is not None:
                state.apply_move(k, move)
                best = state.score(objective)
                improved_this_round = True
        if not improved_this_round:
            break
    return state.to_schedule()


def neighborhood_search_reference(jobs: Sequence[JobSpec],
                                  initial: Sequence[str] | None = None,
                                  max_count: int = 50,
                                  objective: str = "weighted") -> Schedule:
    """The seed implementation of Algorithm 2, kept verbatim as a benchmark
    baseline and parity oracle: every candidate move re-runs the full
    discrete-event simulation, and the incumbent objective is tracked by a
    running ``best -= v_max`` accumulator (which drifts on non-integer
    instances — fixed in `neighborhood_search`). O(rounds * n^2 * |tiers|)
    complete simulations; use only at small n."""
    assign = list(initial or greedy_schedule(jobs))

    def score(a: Sequence[str]) -> float:
        s = simulate(jobs, a)
        return s.weighted_sum if objective == "weighted" else s.unweighted_sum

    best = score(assign)
    for _ in range(max_count):
        tabu_job = [False] * len(jobs)
        improved_this_round = False
        for _inner in range(len(jobs)):
            sched = simulate(jobs, assign)
            ends = {id(e.job): e.end for e in sched.entries}
            cand = [i for i in range(len(jobs)) if not tabu_job[i]]
            if not cand:
                break
            k = min(cand, key=lambda i: ends[id(jobs[i])])
            tabu_job[k] = True
            v_max, move = 0.0, None
            for tier in MACHINES:
                if tier == assign[k]:
                    continue
                trial = list(assign)
                trial[k] = tier
                v = best - score(trial)
                if v > v_max:
                    v_max, move = v, tier
            if move is not None:
                assign[k] = move
                best -= v_max
                improved_this_round = True
        if not improved_this_round:
            break
    return simulate(jobs, assign)


# ------------------------------------------------------------- fast dispatch
def _bucket16(x: int) -> int:
    """§12 bucketing contract: the device search pads its rows to a
    multiple of 16 (minimum 16), as the reference does for its compiled
    shapes, so both backends search the same padded instance."""
    return ((max(int(x), 1) + 15) // 16) * 16


def search(jobs: Sequence[JobSpec],
           initial: Sequence[str] | None = None,
           max_count: int = 50,
           objective: str = "weighted",
           device_threshold: int | None = None,
           machines_per_tier: Mapping[str, int] | None = None,
           busy_until: Mapping[str, Sequence[float]] | None = None,
           frozen: Sequence[bool] | None = None,
           reserved: Mapping[str, Sequence[Reservation]] | None = None,
           device: str | torch.device | None = None) -> Schedule:
    """Size-dispatched Algorithm 2: the incremental Python tabu search for
    small instances, the batched device search (delta-evaluated n x 3
    neighbourhood rounds, `scheduler_torch.tabu_search_batched`) for large
    ones. Both return an exact C1-C5 Schedule.

    device: where the device search runs (default "cuda"; raises
    RuntimeError without a CUDA device unless device="cpu", as every
    entry point of the port does). device_threshold: job count above
    which the device search is taken. Default (None):
    DEVICE_SEARCH_THRESHOLD when the device is CUDA, never on the CPU —
    mirroring the reference's accelerator-only default.

    machines_per_tier / busy_until (DESIGN.md §7), frozen (DESIGN.md §9:
    immovable background jobs, initial required) and reserved
    (DESIGN.md §12: committed interval occupancy, initial required) are
    threaded through whichever backend runs, so both search the problem
    the schedule will actually be committed against.
    """
    n = len(jobs)
    device = resolve_device(device)
    if device_threshold is None:
        use_device = n > DEVICE_SEARCH_THRESHOLD and device.type == "cuda"
    else:
        use_device = n > device_threshold
    if not use_device:
        return neighborhood_search(jobs, initial=initial,
                                   max_count=max_count, objective=objective,
                                   machines_per_tier=machines_per_tier,
                                   busy_until=busy_until, frozen=frozen,
                                   reserved=reserved)
    from repro_torch.core import scheduler_torch
    if frozen is not None and any(frozen) and initial is None:
        raise ValueError("frozen jobs require an explicit initial "
                         "assignment carrying their pinned tiers")
    n_res = sum(len(v) for v in (reserved or {}).values())
    if n_res and initial is None:
        raise ValueError("reservations require an explicit initial "
                         "assignment (greedy init ignores their occupancy)")
    mpt = dict(machines_per_tier or {})
    mpt_dev = (int(mpt.get(CC, 1)), int(mpt.get(ES, 1)))
    assign0 = initial or greedy_schedule(
        jobs, machines_per_tier=machines_per_tier, busy_until=busy_until)
    busy_dev = tuple(machine_free_times(busy_until, t, m)
                     for t, m in zip((CC, ES), mpt_dev))
    _, assigns = scheduler_torch.tabu_search_batched(
        [jobs], [[MACHINES.index(t) for t in assign0]],
        max_rounds=max(max_count, 1), objective=objective,
        machines_per_tier=[mpt_dev], busy_until=[busy_dev],
        frozen=None if frozen is None else [list(frozen)],
        reserved=None if reserved is None else [reserved],
        pad_to=_bucket16(n + n_res), device=device)
    return simulate(jobs, [MACHINES[int(m)] for m in assigns[0]],
                    machines_per_tier=machines_per_tier,
                    busy_until=busy_until, reserved=reserved)


def search_batched(problems: Sequence[Sequence[JobSpec]],
                   max_count: int = 50,
                   objective: str = "weighted",
                   machines_per_tier=None,
                   busy_until=None,
                   min_batch: int | None = None,
                   device_threshold: int | None = None,
                   initial: Sequence[Sequence[str]] | None = None,
                   frozen: Sequence[Sequence[bool] | None] | None = None,
                   reserved=None,
                   device: str | torch.device | None = None
                   ) -> List[Schedule]:
    """Plan B independent ward instances in one batched device search
    (DESIGN.md §8) — the fleet-scale entry point used by
    `launch/serve.py --wards` and the batched clairvoyant baselines in
    `core/online.py`.

    problems: B job lists (sizes may differ — padded on the batched
    path with phantom jobs that contribute exactly 0 to every
    objective). machines_per_tier: one {tier: count} mapping for every
    ward or a per-ward sequence of mappings; busy_until: optional
    per-ward {tier: [free times]} sequence. min_batch: batches smaller
    than this loop the per-instance `search` instead (default
    BATCHED_SEARCH_MIN_WARDS — tiny fleets don't amortise a device
    search); pass 1 to force the batched path, a large value to force
    the sequential loop. device_threshold is forwarded to the sequential
    fallback's per-instance `search` calls, so small batches dispatch to
    the same backend their caller asked large ones to use (§3.3).
    device: where the device search runs (default "cuda"; raises
    RuntimeError without a CUDA device unless device="cpu").

    initial / frozen (DESIGN.md §9): optional per-ward warm-start tier
    lists and immovable-background masks, forwarded to whichever backend
    runs (frozen jobs require initial, as everywhere else).

    reserved (DESIGN.md §12): optional per-ward {tier: [Reservation]}
    maps of committed interval occupancy, forwarded to whichever backend
    runs; a ward with reservations needs an explicit initial. Returned
    objectives include reservation contributions.

    Every returned Schedule is a final exact `simulate` of its ward's
    best assignment against that ward's own fleet, so reported numbers
    are the reference evaluator's bit-for-bit (§3.1 invariant)."""
    device = resolve_device(device)
    B = len(problems)
    single = isinstance(machines_per_tier, Mapping) or machines_per_tier \
        is None
    mpts = [machines_per_tier] * B if single else list(machines_per_tier)
    busys = [None] * B if busy_until is None else list(busy_until)
    inits = [None] * B if initial is None else list(initial)
    frozens = [None] * B if frozen is None else list(frozen)
    reserveds = [None] * B if reserved is None else list(reserved)
    if len(mpts) != B or len(busys) != B or len(inits) != B \
            or len(frozens) != B or len(reserveds) != B:
        raise ValueError(f"{len(mpts)} fleets / {len(busys)} busy vectors "
                         f"/ {len(inits)} initials / {len(frozens)} frozen "
                         f"masks / {len(reserveds)} reservation maps "
                         f"for {B} wards")
    bad = [i for i, (rv, init) in enumerate(zip(reserveds, inits))
           if rv and any(rv.values()) and init is None]
    if bad:
        raise ValueError(f"reservations require an explicit initial "
                         f"assignment (greedy init ignores their "
                         f"occupancy); missing for wards {bad}")
    threshold = BATCHED_SEARCH_MIN_WARDS if min_batch is None else min_batch
    if B < threshold:
        return [search(jobs, max_count=max_count, objective=objective,
                       device_threshold=device_threshold, initial=init,
                       frozen=fr, reserved=rv, machines_per_tier=m,
                       busy_until=b, device=device)
                for jobs, m, b, init, fr, rv
                in zip(problems, mpts, busys, inits, frozens, reserveds)]
    from repro_torch.core import scheduler_torch
    if initial is None and frozen is not None \
            and any(fr is not None and any(fr) for fr in frozens):
        raise ValueError("frozen jobs require an explicit initial "
                         "assignment carrying their pinned tiers")
    if initial is not None:
        # the batched backend needs an initial for every ward or none —
        # fill the gaps with the greedy initial the solo path would use,
        # so mixed-initial calls behave the same on both dispatch paths
        inits = [init if init is not None else greedy_schedule(
            jobs, machines_per_tier=m, busy_until=b)
            for jobs, m, b, init in zip(problems, mpts, busys, inits)]
    pairs = [(int(dict(m or {}).get(CC, 1)), int(dict(m or {}).get(ES, 1)))
             for m in mpts]
    busy_pairs = [tuple(machine_free_times(b, t, mm)
                        for t, mm in zip((CC, ES), pair))
                  for b, pair in zip(busys, pairs)]
    # bucket the padded row count (§12) as the reference does, so both
    # backends search the same padded instance (and pick the same regime)
    raw_rows = max((len(jobs) + sum(len(v) for v in (rv or {}).values())
                    for jobs, rv in zip(problems, reserveds)), default=0)
    rows = _bucket16(raw_rows) if raw_rows else None
    _, assigns = scheduler_torch.tabu_search_batched(
        problems,
        None if initial is None else
        [[MACHINES.index(t) for t in init] for init in inits],
        max_rounds=max(max_count, 1),
        objective=objective, machines_per_tier=pairs,
        busy_until=busy_pairs,
        frozen=None if frozen is None else frozens,
        reserved=None if reserved is None else reserveds,
        pad_to=rows, device=device)
    return [simulate(jobs, [MACHINES[int(i)] for i in a],
                     machines_per_tier=m, busy_until=b, reserved=rv)
            for jobs, a, m, b, rv
            in zip(problems, assigns, mpts, busys, reserveds)]


# --------------------------------------------- contention-aware fleet search
@dataclass(frozen=True)
class FleetPlan:
    """Result of `search_fleet` (DESIGN.md §9).

    naive_reported is the objective B independent per-ward searches CLAIM
    (each ward scored against the full shared pool as if it were alone) —
    unachievable whenever wards overlap on the shared cloud. naive_fleet
    rescores those same plans on the real fleet; the ratio between the two
    is the contention gap this subsystem closes."""
    assignments: List[List[str]]     # final joint plan, per ward
    fleet: FleetSchedule             # fleet-true evaluation of the plan
    naive_fleet: FleetSchedule       # fleet-true eval of independent plans
    naive_assignments: List[List[str]]
    naive_reported: float            # what independent planning claimed
    sweeps: int                      # fixed-point sweeps run
    objective: str

    @property
    def contention_gap(self) -> float:
        """fleet-true / claimed objective of the independent plans (> 1
        means the per-ward numbers double-book the shared cloud)."""
        return self.naive_fleet.objective(self.objective) / max(
            self.naive_reported, 1e-9)

    @property
    def gap_closed(self) -> float:
        """Fraction of the contention gap recovered by the fixed-point
        search (0 = none, 1 = the final plan scores what the independent
        plans claimed)."""
        naive = self.naive_fleet.objective(self.objective)
        excess = naive - self.naive_reported
        if excess <= 0:
            return 1.0
        return (naive - self.fleet.objective(self.objective)) / excess


class _FleetEval:
    """Fleet-true trial evaluator for the §9 acceptance loop — the same
    C5 arithmetic as `simulate_fleet`, specialised to a FIXED fleet
    (jobs, pools, busy vectors) with only the assignment varying.

    `simulate_fleet` re-sorts every pool's merged queue and rebuilds
    ScheduledJob objects on each call; with the interval kernel making
    sweeps cheap, the acceptance loop's per-trial rescoring became the
    §9 bottleneck. This evaluator pre-sorts each pool's full cross-ward
    queue ONCE (filtering a sorted queue by the trial's assignment
    preserves queue order), then replays the exact `_fifo_pool` heap
    arithmetic per trial — same floats in the same accumulation order,
    so values are bit-identical to
    ``simulate_fleet(...).objective(objective)`` (pinned by
    tests/test_intervals.py), and the monotone acceptance decisions are
    exactly the ones the full evaluator would have made."""

    def __init__(self, ward_jobs, mpts, busy_until, ward_busy_until,
                 shared_tiers):
        B = len(ward_jobs)
        busys = [None] * B if ward_busy_until is None \
            else list(ward_busy_until)
        self._rel = [[j.release for j in jobs] for jobs in ward_jobs]
        self._w = [[j.weight for j in jobs] for jobs in ward_jobs]
        # the private tier never queues: precomputed ends, overwritten
        # per trial wherever the assignment routes a job to a pool
        self._ed = [[j.release + j.trans.get(ED, 0.0) + j.proc[ED]
                     for j in jobs] for jobs in ward_jobs]
        self._pools = []        # (tier, sorted records, initial frees)

        def pool(tier, wards_, free0):
            recs = sorted(
                (ward_jobs[b][i].release + ward_jobs[b][i].trans[tier],
                 ward_jobs[b][i].release, b, i,
                 ward_jobs[b][i].proc[tier])
                for b in wards_ for i in range(len(ward_jobs[b])))
            self._pools.append((tier, recs, free0))

        for tier in (CC, ES):
            if tier in shared_tiers:
                if B:
                    pool(tier, range(B),
                         machine_free_times(busy_until, tier,
                                            mpts[0].get(tier, 1)))
            else:
                for b in range(B):
                    pool(tier, (b,),
                         machine_free_times(busys[b], tier,
                                            mpts[b].get(tier, 1)))

    def __call__(self, assignments, objective: str) -> float:
        ends = [list(e) for e in self._ed]
        for tier, recs, free0 in self._pools:
            free = list(free0)
            heapq.heapify(free)
            for arr, _rel, b, i, proc in recs:
                if assignments[b][i] != tier:
                    continue
                avail = heapq.heappop(free)
                start = arr if arr > avail else avail
                end = start + proc
                heapq.heappush(free, end)
                ends[b][i] = end
        if objective == "last":
            return max((max(e, default=0.0) for e in ends), default=0.0)
        tot = 0.0
        if objective == "weighted":
            for rel, w, end in zip(self._rel, self._w, ends):
                s = 0.0
                for r, ww, e in zip(rel, w, end):
                    s += ww * (e - r)
                tot += s
        else:
            for rel, end in zip(self._rel, ends):
                s = 0.0
                for r, e in zip(rel, end):
                    s += e - r
                tot += s
        return tot


def _fleet_reservations(ward_jobs, incumbent, shared_tiers):
    """Per-ward reservation maps for one §9 sweep: ward b sees every
    OTHER ward's currently-committed shared-tier jobs as interval
    reservations (DESIGN.md §12) — same occupancy, same objective
    contribution, same queue ties as the frozen-phantom construction
    they replace, but O(1) carry width in the kernel instead of O(n)
    extra move candidates. Scan order (c, i) restricted per tier keeps
    the within-tier queue tie order identical to the phantom append
    order."""
    B = len(ward_jobs)
    out = []
    for b in range(B):
        m: Dict[str, List[Reservation]] = {}
        for c in range(B):
            if c == b:
                continue
            jobs_c, inc_c = ward_jobs[c], incumbent[c]
            for i, t in enumerate(inc_c):
                if t in shared_tiers:
                    j = jobs_c[i]
                    m.setdefault(t, []).append(Reservation(
                        arrival=j.release + j.trans.get(t, 0.0),
                        proc=j.proc[t], release=j.release,
                        weight=j.weight))
        out.append(m)
    return out


def _fleet_views(ward_jobs, mpts, busy_until, ward_busy_until, shared_tiers):
    """Per-ward (machines, busy) dicts for INDEPENDENT planning: every
    ward sees the full shared pool (and its initial occupancy) as its own
    — exactly the double-booking view `search_fleet` starts from."""
    views = []
    for b in range(len(ward_jobs)):
        busy: Dict[str, Sequence[float]] = {}
        for tier in (CC, ES):
            if tier in shared_tiers:
                vals = (busy_until or {}).get(tier, ())
            else:
                wb = ward_busy_until[b] if ward_busy_until else None
                vals = (wb or {}).get(tier, ())
            vals = list(vals)
            if vals:
                busy[tier] = vals
        views.append((mpts[b], busy or None))
    return views


def search_fleet(ward_jobs: Sequence[Sequence[JobSpec]],
                 machines_per_tier=None, *,
                 objective: str = "weighted",
                 max_count: int = 50,
                 max_sweeps: int = 8,
                 sweep_max_count: int = 2,
                 busy_until: Mapping[str, Sequence[float]] | None = None,
                 ward_busy_until=None,
                 shared_tiers: Tuple[str, ...] = (CC,),
                 min_batch: int | None = None,
                 device_threshold: int | None = None,
                 sweep_backend: str = "auto",
                 pad_bucket: int = 64,
                 background: str = "interval",
                 device: str | torch.device | None = None) -> FleetPlan:
    """Contention-aware multi-ward planning to a fixed point (DESIGN.md §9).

    Starts from B independent per-ward plans (`search_batched` — each
    ward optimises against the full shared cloud, silently
    double-booking it), rescores them with the fleet-true evaluator
    `simulate_fleet`, then runs Gauss–Seidel sweeps: each sweep replans
    every ward against the OTHER wards' currently-committed shared-tier
    jobs as interval reservations (DESIGN.md §12 — queue-active
    background occupancy the search prices but can never reassign, so
    ward b pays, and sees, the delay it inflicts on the rest of the
    fleet). A ward's proposal is then accepted only if it strictly
    improves the fleet-true objective, so the incumbent value is
    monotone decreasing over a finite assignment space and the
    iteration terminates (§9 termination argument); trial values come
    from the bit-identical `_FleetEval` replay, with one final
    `simulate_fleet` on the accepted plan (§3.1 invariant).

    machines_per_tier: one {tier: count} mapping for all wards or a
    per-ward sequence (shared-tier counts must agree — one pool).
    busy_until: initial free times of the SHARED pools; ward_busy_until:
    optional per-ward occupancy of the per-ward pools. sweep_max_count:
    tabu budget per replanning sweep (small — sweeps only need local
    repairs on top of the incumbent). pad_bucket: instance row slots
    (jobs + reservations) are padded to multiples of this, and the
    padding never shrinks across sweeps, so every sweep searches one
    shape while the background churns.

    sweep_backend: "batched" replans all wards in one
    `tabu_search_batched` device search per sweep; "python" loops the
    per-ward `search` (which dispatches on device_threshold). "auto"
    (default) picks batched whenever B >= min_batch. device: where the
    device searches run (default "cuda"; raises RuntimeError without a
    CUDA device unless device="cpu").

    background: "interval" (default) models other wards' committed jobs
    as reservations; "phantom" is the frozen-job construction, kept as
    the parity oracle for the interval representation — same objectives,
    same trajectories, O(n_aug) extra move-candidate rows per sweep.

    Returns a FleetPlan carrying the final joint plan, both fleet-true
    evaluations, the claimed (double-booked) objective, and the sweep
    count.
    """
    device = resolve_device(device)
    B = len(ward_jobs)
    if B == 0:
        empty = simulate_fleet([], [], shared_tiers=shared_tiers)
        return FleetPlan([], empty, empty, [], 0.0, 0, objective)
    mpts = _fleet_mpts(machines_per_tier, B, shared_tiers)
    views = _fleet_views(ward_jobs, mpts, busy_until, ward_busy_until,
                         shared_tiers)

    def fleet_eval(assignments) -> FleetSchedule:
        return simulate_fleet(ward_jobs, assignments,
                              machines_per_tier=mpts,
                              busy_until=busy_until,
                              ward_busy_until=ward_busy_until,
                              shared_tiers=shared_tiers)

    # 1) independent (double-booked) plans — the naive baseline
    naive = search_batched(list(ward_jobs), max_count=max_count,
                           objective=objective,
                           machines_per_tier=[v[0] for v in views],
                           busy_until=[v[1] for v in views],
                           min_batch=min_batch,
                           device_threshold=device_threshold, device=device)
    naive_assignments = [s.assignment() for s in naive]
    agg = max if objective == "last" else sum
    naive_reported = float(agg(s.objective(objective) for s in naive))
    naive_fleet = fleet_eval(naive_assignments)

    incumbent = [list(a) for a in naive_assignments]
    best_fleet = naive_fleet
    best = best_fleet.objective(objective)
    threshold = BATCHED_SEARCH_MIN_WARDS if min_batch is None else min_batch
    if sweep_backend not in ("auto", "batched", "python"):
        raise ValueError(f"unknown sweep_backend {sweep_backend!r}")
    if background not in ("interval", "phantom"):
        raise ValueError(f"unknown background {background!r}")
    batched_sweeps = sweep_backend == "batched" or (
        sweep_backend == "auto" and B >= threshold)
    if batched_sweeps:
        from repro_torch.core import scheduler_torch
        pairs = [(int(views[b][0].get(CC, 1)),
                  int(views[b][0].get(ES, 1))) for b in range(B)]
        busy_pairs = [tuple(machine_free_times(views[b][1], t, m)
                            for t, m in zip((CC, ES), pairs[b]))
                      for b in range(B)]
    trial_eval = _FleetEval(ward_jobs, mpts, busy_until, ward_busy_until,
                            shared_tiers)

    sweeps = 0
    changed = False
    pad_to = 0          # sticky across sweeps: one padded shape per run
    for _ in range(max_sweeps):
        proposals: List[List[str]] = []
        if background == "interval":
            # background of ward b: every other ward's shared-tier jobs,
            # committed as interval reservations (§12)
            resvs = _fleet_reservations(ward_jobs, incumbent, shared_tiers)
            if not batched_sweeps:
                for b in range(B):
                    plan = search(list(ward_jobs[b]), initial=incumbent[b],
                                  max_count=sweep_max_count,
                                  objective=objective,
                                  reserved=resvs[b] or None,
                                  device_threshold=device_threshold,
                                  machines_per_tier=views[b][0],
                                  busy_until=views[b][1], device=device)
                    proposals.append(plan.assignment())
            else:
                # bucket the padded ROW count (jobs + reservations) and
                # keep it STICKY across sweeps, as the reference does:
                # the regime (round or pass) is a function of it
                rows = max(len(ward_jobs[b])
                           + sum(len(v) for v in resvs[b].values())
                           for b in range(B))
                pad_to = max(pad_to, -(-rows // pad_bucket) * pad_bucket)
                _, assigns = scheduler_torch.tabu_search_batched(
                    [list(jobs) for jobs in ward_jobs],
                    [[MACHINES.index(t) for t in incumbent[b]]
                     for b in range(B)],
                    max_rounds=max(sweep_max_count, 1),
                    objective=objective, machines_per_tier=pairs,
                    busy_until=busy_pairs, reserved=resvs, pad_to=pad_to,
                    device=device)
                proposals = [[MACHINES[int(i)]
                              for i in assigns[b][:len(ward_jobs[b])]]
                             for b in range(B)]
        else:
            # frozen-phantom background — the §12 parity oracle: other
            # wards' shared-tier jobs appended as immovable rows
            bg = [[(ward_jobs[c][i], incumbent[c][i])
                   for c in range(B) if c != b
                   for i in range(len(ward_jobs[c]))
                   if incumbent[c][i] in shared_tiers]
                  for b in range(B)]
            aug_jobs = [list(ward_jobs[b]) + [j for j, _ in bg[b]]
                        for b in range(B)]
            aug_init = [incumbent[b] + [t for _, t in bg[b]]
                        for b in range(B)]
            frozen = [[False] * len(ward_jobs[b]) + [True] * len(bg[b])
                      for b in range(B)]
            if not batched_sweeps:
                for b in range(B):
                    plan = search(aug_jobs[b], initial=aug_init[b],
                                  max_count=sweep_max_count,
                                  objective=objective, frozen=frozen[b],
                                  device_threshold=device_threshold,
                                  machines_per_tier=views[b][0],
                                  busy_until=views[b][1], device=device)
                    proposals.append(plan.assignment()[:len(ward_jobs[b])])
            else:
                n_aug = max(len(jobs) for jobs in aug_jobs)
                pad_to = max(pad_to, -(-n_aug // pad_bucket) * pad_bucket)
                _, assigns = scheduler_torch.tabu_search_batched(
                    aug_jobs,
                    [[MACHINES.index(t) for t in init]
                     for init in aug_init],
                    max_rounds=max(sweep_max_count, 1),
                    objective=objective, machines_per_tier=pairs,
                    busy_until=busy_pairs, frozen=frozen, pad_to=pad_to,
                    device=device)
                proposals = [[MACHINES[int(i)]
                              for i in assigns[b][:len(ward_jobs[b])]]
                             for b in range(B)]
        sweeps += 1
        # Gauss–Seidel acceptance: commit each ward's proposal only if it
        # strictly improves the FLEET-TRUE objective given everything
        # already committed this sweep — monotone, hence terminating.
        # `trial_eval` replays `simulate_fleet`'s arithmetic bit-for-bit
        # at a fraction of its cost; the accepted plan is rescored by the
        # reference evaluator once, after the loop.
        improved = False
        for b in range(B):
            if proposals[b] == incumbent[b]:
                continue
            trial = list(incumbent)
            trial[b] = proposals[b]
            v = trial_eval(trial, objective)
            if v < best - 1e-9:
                incumbent, best = trial, v
                improved = changed = True
        if not improved:
            break
    if changed:
        best_fleet = fleet_eval(incumbent)

    return FleetPlan(assignments=[list(a) for a in incumbent],
                     fleet=best_fleet, naive_fleet=naive_fleet,
                     naive_assignments=naive_assignments,
                     naive_reported=naive_reported,
                     sweeps=sweeps, objective=objective)


# ------------------------------------------------------------- exact optimum
def exact_optimum(jobs: Sequence[JobSpec],
                  objective: str = "weighted",
                  machines_per_tier: Mapping[str, int] | None = None,
                  busy_until: Mapping[str, Sequence[float]] | None = None
                  ) -> Schedule:
    """Brute-force over all 3^n assignments (n <= ~12). The paper offers no
    optimality baseline; we use this to report the heuristic's gap."""
    n = len(jobs)
    if n > 12:
        # ValueError, not assert: a 3^n enumeration bomb must be refused
        # under ``python -O`` too
        raise ValueError(f"exact_optimum is 3^n; n={n} > 12 — use "
                         f"scheduler_torch.exact_optimum_device for larger n")
    best_s, best_v = None, float("inf")
    for combo in itertools.product(MACHINES, repeat=n):
        s = simulate(jobs, combo, machines_per_tier=machines_per_tier,
                     busy_until=busy_until)
        v = s.weighted_sum if objective == "weighted" else s.unweighted_sum
        if v < best_v:
            best_s, best_v = s, v
    return best_s


# -------------------------------------------------------------- comparison
def strategy_table(jobs: Sequence[JobSpec],
                   device_threshold: int | None = None,
                   machines_per_tier: Mapping[str, int] | None = None,
                   device: str | torch.device | None = None
                   ) -> Dict[str, Schedule]:
    """The paper's Table VII comparison set + our extras. "ours" goes
    through the size-dispatched `search`, so fleet-scale tables use the
    device search; `device` is passed to it (default "cuda"; raises
    without a CUDA device unless device="cpu"). machines_per_tier (from
    TierSpec.machines) sizes the shared tiers for every strategy."""
    mpt = machines_per_tier
    return {
        "ours (algorithm 2)": search(jobs, device_threshold=device_threshold,
                                     machines_per_tier=mpt, device=device),
        "per-job optimal layer": per_job_optimal(jobs, machines_per_tier=mpt),
        "all cloud": all_on_tier(jobs, CC, machines_per_tier=mpt),
        "all edge": all_on_tier(jobs, ES, machines_per_tier=mpt),
        "all device": all_on_tier(jobs, ED, machines_per_tier=mpt),
    }
