"""Discrete-event evaluator for multi-job schedules (paper Section V).

Semantics (constraints C1-C5, validated against the paper's Table VII —
see DESIGN.md §1):
  * arrival_at_machine = release + transmission  (C4: data ships ahead and
    queues; transmission overlaps other jobs' processing)
  * shared machines (cloud, edge) run one job at a time, non-preemptive
    (C1, C2), FIFO by arrival (tie: release, then job index)
  * the device tier is private — every job has its own end device, so
    device jobs never queue (paper Section V.A)
  * response of job i = E_i - R_i, weighted by priority w_i (eq. 5)
  * shared machines may start busy: ``busy_until`` gives each machine's
    initial free time (DESIGN.md §7 — online replanning scores candidate
    schedules against machines already occupied by committed jobs)
  * shared machines may carry RESERVED INTERVALS (``reserved``,
    DESIGN.md §12): committed background occupancy that enters the FIFO
    queue exactly like a frozen job — it holds a machine for its
    processing time at its queue position and its (weighted) response
    counts toward the objective — but is not part of the instance's
    jobs/assignment, so a search can never move it. Queue ties between a
    job and a reservation go to the job (a reservation behaves like a
    job appended after the instance's own jobs, which is how the frozen
    phantom-job construction it replaces ordered them).
"""
from __future__ import annotations

import bisect
import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Sequence, Tuple

from repro_torch.core.tiers import CC, ED, ES, TIER_ORDER

MACHINES = list(TIER_ORDER)          # ["cloud", "edge", "device"]


@dataclass(frozen=True)
class JobSpec:
    """Scheduler-facing view of a job: the (proc, trans) row per tier.

    Built either from a CostModel (core.problems.jobs_to_specs) or directly
    from a paper table (benchmarks/table7).
    """
    name: str
    release: float
    weight: float
    proc: Mapping[str, float]        # tier -> I_i
    trans: Mapping[str, float]       # tier -> D_i (device: 0)
    workload: str = ""               # originating workload (serving maps
                                     # schedule entries back to engines)
    deadline: float = float("inf")   # SLA budget on response = end - release
                                     # (relative, not absolute; metro traffic
                                     # scores miss-rate against it)

    def response_if_alone(self, tier: str) -> float:
        return self.proc[tier] + self.trans[tier]


@dataclass(frozen=True)
class Reservation:
    """Committed background occupancy on ONE shared tier (DESIGN.md §12).

    The interval-reservation replacement for frozen phantom jobs: a
    reservation is queue-active (it joins the tier's FIFO queue at
    (arrival, release) and holds a machine for ``proc``), contributes
    ``weight * (end - release)`` to the weighted objective (and its
    response/end to the unweighted/last objectives) so planners price the
    delay they inflict on it — but it is not a job of the instance, so no
    search can ever reassign it. Ties against real jobs at equal
    (arrival, release) dispatch the job first; ties among reservations
    keep list order — both exactly the order the frozen-phantom
    construction (jobs + appended background) produced.
    """
    arrival: float                   # when its data reaches the tier
    proc: float                      # processing time on the tier
    release: float                   # FIFO tiebreak + response baseline
    weight: float = 0.0              # objective contribution (0: occupancy
                                     # only)


def _resv_map(reserved, allowed=()) -> Dict[str, List[Tuple[int,
                                                            "Reservation"]]]:
    """-> {tier: [(input position, Reservation)]} in dispatch order
    (sorted by (arrival, release), stable — input order breaks ties),
    validating tier names. ``allowed``: tiers reservations may name
    (shared tiers only). Results keep the input position so callers can
    report timings aligned with the caller's lists."""
    out: Dict[str, List[Tuple[int, Reservation]]] = {}
    for tier, vals in (reserved or {}).items():
        if tier not in allowed:
            raise ValueError(
                f"reservations may only name shared tiers {list(allowed)}, "
                f"got {tier!r}")
        rs = list(enumerate(vals))
        if rs:
            out[tier] = sorted(rs, key=lambda kr: (kr[1].arrival,
                                                   kr[1].release, kr[0]))
    return out


@dataclass(frozen=True)
class ScheduledJob:
    job: JobSpec
    machine: str
    arrival: float
    start: float
    end: float

    @property
    def response(self) -> float:
        return self.end - self.job.release


def schedule_objective(sched, objective: str = "weighted") -> float:
    """One of the three reported objectives off a Schedule/FleetSchedule."""
    return {"weighted": sched.weighted_sum,
            "unweighted": sched.unweighted_sum,
            "last": sched.last_end}[objective]


@dataclass(frozen=True)
class Schedule:
    entries: List[ScheduledJob]
    weighted_sum: float              # eq. (5): sum w_i (E_i - R_i) — when
                                     # the instance carried reservations,
                                     # INCLUDES their contributions (the
                                     # objective a search prices, §12)
    unweighted_sum: float            # what the paper's Table VII reports
    last_end: float                  # "Last Response Time"
    # (arrival, start, end) per input reservation, {tier: list aligned
    # with the reserved= argument's input lists} — online fleet
    # replanning re-times other wards' commitments from this (§12)
    reserved_times: Dict[str, List[Tuple[float, float, float]]] | None \
        = None

    def assignment(self) -> List[str]:
        return [e.machine for e in self.entries]

    def objective(self, objective: str = "weighted") -> float:
        return schedule_objective(self, objective)


def machine_free_times(busy_until: Mapping[str, Sequence[float]] | None,
                       tier: str, machines: int) -> List[float]:
    """Initial per-machine free times for a shared tier, sorted ascending.

    ``busy_until[tier]`` may list fewer entries than there are machines —
    the rest start idle (free at t=0). More entries than machines is a
    caller bug (a tier cannot be running more jobs than it has servers) —
    reported as ValueError, not assert, so the guard survives
    ``python -O``.
    """
    vals = sorted(float(v) for v in (busy_until or {}).get(tier, ()))
    if len(vals) > machines:
        raise ValueError(
            f"busy_until[{tier!r}] lists {len(vals)} occupied machines "
            f"but the tier has only {machines}")
    return [0.0] * (machines - len(vals)) + vals


def _fifo_pool(items, free: List[float]):
    """FIFO dispatch of one machine POOL: ``items`` iterates (arrival,
    proc) in queue order, ``free`` is the pool's initial machine
    free-time vector (consumed). Yields (arrival, start, end) per item —
    the C5 semantics every evaluator in this module shares: each job pops
    the earliest-free machine and starts at max(arrival, free)."""
    heapq.heapify(free)
    for arr, proc in items:
        avail = heapq.heappop(free)
        start = arr if arr > avail else avail
        end = start + proc
        heapq.heappush(free, end)
        yield arr, start, end


def simulate(jobs: Sequence[JobSpec], assignment: Sequence[str],
             machines_per_tier: Mapping[str, int] | None = None,
             busy_until: Mapping[str, Sequence[float]] | None = None,
             reserved: Mapping[str, Sequence[Reservation]] | None = None
             ) -> Schedule:
    """Evaluate a fixed job->tier assignment under the C1-C5 semantics.

    busy_until: optional {tier: [machine free times]} — shared machines
    already occupied by previously committed jobs (DESIGN.md §7). A job
    cannot start on a machine before that machine's entry.
    reserved: optional {tier: [Reservation]} — committed background
    occupancy merged into the shared FIFO queues (DESIGN.md §12). The
    returned sums include reservation responses (jobs first in index
    order, then cloud reservations, then edge reservations — exactly the
    frozen-phantom accumulation order this replaces), and the returned
    ``reserved_times`` reports each reservation's (arrival, start, end)
    aligned with the input lists.
    """
    if len(jobs) != len(assignment):
        raise ValueError(f"{len(jobs)} jobs but {len(assignment)} "
                         f"assignment entries")
    machines_per_tier = machines_per_tier or {CC: 1, ES: 1}
    resv = _resv_map(reserved, allowed=(CC, ES))
    entries: List[ScheduledJob | None] = [None] * len(jobs)
    resv_times: Dict[str, List[Tuple[float, float, float]]] = {
        tier: [(0.0, 0.0, 0.0)] * len(rs) for tier, rs in resv.items()}

    # private tier: no queueing
    for idx, (job, tier) in enumerate(zip(jobs, assignment)):
        if tier == ED:
            arr = job.release + job.trans.get(ED, 0.0)
            entries[idx] = ScheduledJob(job, ED, arr, arr,
                                        arr + job.proc[ED])

    # shared tiers: FIFO by (arrival, release, kind, index) over a
    # free-time heap — kind 0 = the instance's own jobs, kind 1 =
    # reservations, so ties dispatch the job first (§12)
    for tier in (CC, ES):
        queue = sorted(
            [((jobs[i].release + jobs[i].trans[tier], jobs[i].release,
               0, i), i) for i, t in enumerate(assignment) if t == tier]
            + [((r.arrival, r.release, 1, k), ~pos)
               for k, (pos, r) in enumerate(resv.get(tier, ()))])
        free = machine_free_times(busy_until, tier,
                                  machines_per_tier.get(tier, 1))
        rs = resv.get(tier, ())
        timed = _fifo_pool(
            (((jobs[i].release + jobs[i].trans[tier], jobs[i].proc[tier])
              if i >= 0 else (key[0], rs[key[3]][1].proc))
             for key, i in queue), free)
        for (key, i), (arr, start, end) in zip(queue, timed):
            if i >= 0:
                entries[i] = ScheduledJob(jobs[i], tier, arr, start, end)
            else:
                resv_times[tier][~i] = (arr, start, end)

    done = [e for e in entries if e is not None]
    if len(done) != len(jobs):
        raise ValueError("assignment names an unknown tier: "
                         f"{sorted(set(assignment) - set(MACHINES))}")
    weighted = sum(e.job.weight * e.response for e in done)
    unweighted = sum(e.response for e in done)
    last = max(e.end for e in done) if done else 0.0
    # reservation contributions accumulate in INPUT order (cloud list,
    # then edge list) — the order the frozen-phantom construction appended
    # them, so objectives stay bit-identical to that path
    for tier in (CC, ES):
        for pos, r in enumerate((reserved or {}).get(tier) or ()):
            end = resv_times[tier][pos][2]
            resp = end - r.release
            weighted += r.weight * resp
            unweighted += resp
            if end > last:
                last = end
    return Schedule(entries=done, weighted_sum=weighted,
                    unweighted_sum=unweighted, last_end=last,
                    reserved_times=resv_times or None)


# --------------------------------------------------- fleet-true evaluation
@dataclass(frozen=True)
class FleetSchedule:
    """A joint multi-ward plan scored on the REAL fleet (DESIGN.md §9):
    shared tiers are one machine pool with a merged FIFO queue across all
    wards, so the per-ward numbers here are achievable simultaneously —
    unlike B independent `simulate` calls, which silently double-book the
    shared servers."""
    wards: List[Schedule]            # per-ward entries with fleet-true times
    weighted_sum: float              # fleet totals INCLUDE reservation
    unweighted_sum: float            # contributions (§12) — reservations
    last_end: float                  # belong to no ward's Schedule
    # (arrival, start, end) per input reservation for the SHARED pools /
    # the per-ward pools, aligned with the reserved=/ward_reserved= input
    reserved_times: Dict[str, List[Tuple[float, float, float]]] | None \
        = None
    ward_reserved_times: List[Dict[str, List[Tuple[float, float, float]]]] \
        | None = None

    def objective(self, objective: str = "weighted") -> float:
        return schedule_objective(self, objective)


def _fleet_mpts(machines_per_tier, B: int,
                shared_tiers: Tuple[str, ...]) -> List[Dict[str, int]]:
    """-> per-ward {tier: count} dicts from one mapping or a per-ward
    sequence; counts of a SHARED tier must agree across wards (there is
    exactly one pool)."""
    if machines_per_tier is None or isinstance(machines_per_tier, Mapping):
        mpts = [dict(machines_per_tier or {CC: 1, ES: 1})] * B
    else:
        mpts = [dict(m or {CC: 1, ES: 1}) for m in machines_per_tier]
        if len(mpts) != B:
            raise ValueError(f"machines_per_tier lists {len(mpts)} fleets "
                             f"for {B} wards")
        for tier in shared_tiers:
            counts = {m.get(tier, 1) for m in mpts}
            if len(counts) > 1:
                raise ValueError(
                    f"shared tier {tier!r} is one pool but wards disagree "
                    f"on its machine count: {sorted(counts)}")
    return mpts


def simulate_fleet(ward_jobs: Sequence[Sequence[JobSpec]],
                   ward_assignments: Sequence[Sequence[str]],
                   machines_per_tier=None,
                   busy_until: Mapping[str, Sequence[float]] | None = None,
                   ward_busy_until=None,
                   shared_tiers: Tuple[str, ...] = (CC,),
                   reserved: Mapping[str, Sequence[Reservation]] | None = None,
                   ward_reserved=None) -> FleetSchedule:
    """Evaluate a JOINT multi-ward plan under C1-C5 on the real fleet.

    Machine pools (DESIGN.md §9): every tier in ``shared_tiers`` (default:
    the metropolitan cloud) is ONE pool serving all wards through a single
    merged FIFO queue, ordered by (arrival, release, ward, index) — exactly
    the queue of the wards-concatenated single instance, so this is the
    ground truth that per-ward-independent planning double-books. Shared
    tiers not in ``shared_tiers`` (default: edge) are per-ward pools; the
    device tier stays private per job.

    machines_per_tier: one {tier: count} mapping for every ward or a
    per-ward sequence (shared-tier counts must agree — one pool).
    busy_until: {tier: [free times]} for the SHARED pools.
    ward_busy_until: optional per-ward {tier: [free times]} for the
    per-ward pools.
    shared_tiers: which of (cloud, edge) are metropolitan-shared; the
    private device tier cannot be shared.
    reserved: {tier: [Reservation]} committed background occupancy merged
    into the SHARED pools' queues (DESIGN.md §12); ward_reserved is the
    per-ward-pool analog (same channel split as busy_until). Reservation
    responses count toward the fleet totals (they belong to no ward) and
    their timings come back in ``reserved_times`` aligned with the input
    lists (shared tiers; per-ward pools report under ``ward_reserved_times``).
    """
    B = len(ward_jobs)
    if len(ward_assignments) != B:
        raise ValueError(f"{B} wards but {len(ward_assignments)} "
                         f"assignments")
    for b, (jobs, assign) in enumerate(zip(ward_jobs, ward_assignments)):
        if len(jobs) != len(assign):
            raise ValueError(f"ward {b}: {len(jobs)} jobs but "
                             f"{len(assign)} assignment entries")
    bad = set(shared_tiers) - set(_SHARED)
    if bad:
        raise ValueError(f"only cloud/edge tiers can be pooled: {bad}")
    mpts = _fleet_mpts(machines_per_tier, B, shared_tiers)
    busys = [None] * B if ward_busy_until is None else list(ward_busy_until)
    if len(busys) != B:
        raise ValueError(f"{len(busys)} ward busy vectors for {B} wards")
    # occupancy must arrive through the right channel — a busy_until entry
    # for a per-ward tier (or ward_busy_until for a pooled tier) would be
    # silently ignored and understate every response time
    stray = [t for t in (busy_until or {}) if t not in shared_tiers]
    if stray:
        raise ValueError(
            f"busy_until names non-shared tiers {stray}; per-ward pool "
            f"occupancy goes in ward_busy_until")
    stray = sorted({t for wb in busys for t in (wb or {})
                    if t in shared_tiers})
    if stray:
        raise ValueError(
            f"ward_busy_until names shared tiers {stray}; the shared "
            f"pools' occupancy goes in busy_until")
    # reservations use the same channel split: `reserved` may only name
    # the shared pools, `ward_reserved` only the per-ward pools
    resv = _resv_map(reserved, allowed=tuple(shared_tiers))
    wrs = [None] * B if ward_reserved is None else list(ward_reserved)
    if len(wrs) != B:
        raise ValueError(f"{len(wrs)} ward reservation maps for {B} wards")
    per_ward_shared = tuple(t for t in _SHARED if t not in shared_tiers)
    ward_resv = [_resv_map(wr, allowed=per_ward_shared) for wr in wrs]
    resv_times: Dict[str, List[Tuple[float, float, float]]] = {
        tier: [(0.0, 0.0, 0.0)] * len(rs) for tier, rs in resv.items()}
    ward_resv_times: List[Dict[str, List[Tuple[float, float, float]]]] = [
        {tier: [(0.0, 0.0, 0.0)] * len(rs) for tier, rs in rm.items()}
        for rm in ward_resv]

    entries: List[List[ScheduledJob | None]] = [
        [None] * len(jobs) for jobs in ward_jobs]

    # private tier: no queueing, per ward exactly as `simulate`
    for b, (jobs, assign) in enumerate(zip(ward_jobs, ward_assignments)):
        for i, (job, tier) in enumerate(zip(jobs, assign)):
            if tier == ED:
                arr = job.release + job.trans.get(ED, 0.0)
                entries[b][i] = ScheduledJob(job, ED, arr, arr,
                                             arr + job.proc[ED])

    def run_pool(tier: str, members, free: List[float],
                 rs=(), times=None) -> None:
        """members: (b, i) pairs; dispatches the pool's merged queue with
        the pool's reservations ``rs`` ([(input pos, Reservation)] in
        dispatch order — §12: a tie on (arrival, release) goes to the
        job). Writes reservation (arrival, start, end) into ``times`` at
        the input position."""
        recs = sorted(
            [((ward_jobs[b][i].release + ward_jobs[b][i].trans[tier],
               ward_jobs[b][i].release, 0, (b, i)), None)
             for b, i in members]
            + [((r.arrival, r.release, 1, k), (pos, r))
               for k, (pos, r) in enumerate(rs)])
        timed = _fifo_pool(
            ((key[0],
              rp[1].proc if rp is not None
              else ward_jobs[key[3][0]][key[3][1]].proc[tier])
             for key, rp in recs), free)
        for (key, rp), (arr, start, end) in zip(recs, timed):
            if rp is None:
                b, i = key[3]
                entries[b][i] = ScheduledJob(ward_jobs[b][i], tier, arr,
                                             start, end)
            else:
                times[rp[0]] = (arr, start, end)

    for tier in _SHARED:
        if tier in shared_tiers:
            if not mpts:                       # B == 0: nothing to pool
                continue
            run_pool(tier,
                     [(b, i) for b in range(B)
                      for i, t in enumerate(ward_assignments[b])
                      if t == tier],
                     machine_free_times(busy_until, tier,
                                        mpts[0].get(tier, 1)),
                     rs=resv.get(tier, ()),
                     times=resv_times.get(tier))
        else:
            for b in range(B):
                run_pool(tier,
                         [(b, i) for i, t in enumerate(ward_assignments[b])
                          if t == tier],
                         machine_free_times(busys[b], tier,
                                            mpts[b].get(tier, 1)),
                         rs=ward_resv[b].get(tier, ()),
                         times=ward_resv_times[b].get(tier))

    wards = []
    for b, jobs in enumerate(ward_jobs):
        done = [e for e in entries[b] if e is not None]
        if len(done) != len(jobs):
            raise ValueError(
                f"ward {b} assignment names an unknown tier: "
                f"{sorted(set(ward_assignments[b]) - set(MACHINES))}")
        wards.append(Schedule(
            entries=done,
            weighted_sum=sum(e.job.weight * e.response for e in done),
            unweighted_sum=sum(e.response for e in done),
            last_end=max((e.end for e in done), default=0.0)))
    w_tot = sum(s.weighted_sum for s in wards)
    u_tot = sum(s.unweighted_sum for s in wards)
    last = max((s.last_end for s in wards), default=0.0)
    # reservation contributions in input order: shared pools (cloud then
    # edge), then per-ward pools in ward order
    for tier in _SHARED:
        for pos, r in enumerate((reserved or {}).get(tier) or ()):
            end = resv_times[tier][pos][2]
            resp = end - r.release
            w_tot += r.weight * resp
            u_tot += resp
            if end > last:
                last = end
    for b, wr in enumerate(wrs):
        for tier in _SHARED:
            for pos, r in enumerate((wr or {}).get(tier) or ()):
                end = ward_resv_times[b][tier][pos][2]
                resp = end - r.release
                w_tot += r.weight * resp
                u_tot += resp
                if end > last:
                    last = end
    return FleetSchedule(
        wards=wards,
        weighted_sum=w_tot,
        unweighted_sum=u_tot,
        last_end=last,
        reserved_times=resv_times or None,
        ward_reserved_times=(ward_resv_times
                             if any(ward_resv_times) else None))


# ------------------------------------------------- incremental evaluation
_SHARED = (CC, ES)
_OBJ = {"weighted": 0, "unweighted": 1, "last": 2}


class ScheduleState:
    """Incremental evaluator over job->tier assignments (DESIGN.md §3.1).

    Moving one job between tiers only perturbs the two affected machine
    queues (C1-C5 are per-machine FIFO semantics), so this caches each
    tier's FIFO queue, per-job completion times, and per-tier objective
    sums. A single-move trial then costs O(|src queue| + |dst queue|) —
    and O(1) on the private device tier, whose per-job contributions are
    constants — instead of a full O(n log n) re-simulation. This is the
    hot path of the Algorithm-2 tabu search.

    Invariants (DESIGN.md §3.1): COMMITTED per-tier stats are always
    recomputed from the tier's full queue (never updated by +=/-= deltas),
    so the incumbent objective is drift-free; ``end`` always mirrors what
    ``simulate`` would produce for the current assignment. Only trial
    scores from ``try_move`` may use a single non-accumulated +/- of a
    precomputed constant (device tier), bounded by one rounding error.
    """

    def __init__(self, jobs: Sequence[JobSpec], assignment: Sequence[str],
                 machines_per_tier: Mapping[str, int] | None = None,
                 busy_until: Mapping[str, Sequence[float]] | None = None,
                 reserved: Mapping[str, Sequence[Reservation]] | None = None):
        if len(jobs) != len(assignment):
            raise ValueError(f"{len(jobs)} jobs but {len(assignment)} "
                             f"assignment entries")
        self.jobs = list(jobs)
        self.assign = list(assignment)
        self.machines = dict(machines_per_tier or {CC: 1, ES: 1})
        # reservations never move, so each shared tier keeps its dispatch-
        # ordered (arrival, release, proc, weight) rows once; _sim_shared
        # merges them into every FIFO pass (§12)
        self.reserved = {t: list(v) for t, v in (reserved or {}).items()}
        _rm = _resv_map(reserved, allowed=_SHARED)
        self._resv = {t: [(r.arrival, r.release, r.proc, r.weight)
                          for _, r in _rm.get(t, ())] for t in _SHARED}
        self.busy = {t: tuple(machine_free_times(busy_until, t,
                                                 self.machines.get(t, 1)))
                     for t in _SHARED}
        n = len(self.jobs)
        self.end: List[float] = [0.0] * n
        # per-job constants: releases, weights, per-tier proc, FIFO keys,
        # and the device tier's fixed completion/response contributions
        self._rel = [j.release for j in self.jobs]
        self._w = [j.weight for j in self.jobs]
        self._proc = {t: [j.proc[t] for j in self.jobs] for t in _SHARED}
        self._keys = {
            t: [(j.release + j.trans[t], j.release, i)
                for i, j in enumerate(self.jobs)] for t in _SHARED}
        self._dev_end = [j.release + j.trans.get(ED, 0.0) + j.proc[ED]
                         for j in self.jobs]
        self._dev_resp = [e - r for e, r in zip(self._dev_end, self._rel)]
        self._dev_wresp = [w * r for w, r in zip(self._w, self._dev_resp)]
        # shared tiers: sorted [(key, idx)] with key = (arrival, release, i)
        self._members: Dict[str, List[Tuple[Tuple[float, float, int], int]]]
        self._members = {
            tier: sorted((self._keys[tier][i], i)
                         for i, t in enumerate(self.assign) if t == tier)
            for tier in _SHARED}
        self._device: List[int] = sorted(
            i for i, t in enumerate(self.assign) if t == ED)
        self._stats: Dict[str, Tuple[float, float, float]] = {}
        for tier in _SHARED:
            ends, self._stats[tier] = self._sim_shared(
                tier, self._members[tier])
            for (_, i), e in zip(self._members[tier], ends):
                self.end[i] = e
        for i in self._device:
            self.end[i] = self._dev_end[i]
        self._stats[ED] = self._device_stats(self._device)

    # ------------------------------------------------------------ internals
    def _device_stats(self, members: Sequence[int]):
        w = sum(self._dev_wresp[i] for i in members)
        u = sum(self._dev_resp[i] for i in members)
        last = max((self._dev_end[i] for i in members), default=0.0)
        return w, u, last

    def _sim_shared(self, tier: str, members):
        """One FIFO pass over a shared tier's sorted queue.

        Returns (ends aligned with members, (weighted, unweighted, last)).
        Identical machine semantics to ``simulate``: a free-time heap of
        ``machines[tier]`` servers, start = max(arrival, earliest free);
        the single-server case runs heap-free. The tier's reservations are
        merged into the walk by (arrival, release) — a reservation at an
        exact (arrival, release) tie with a job dispatches after it — and
        their (weighted) responses accumulate into the stats in merged
        queue order, so the stats match the frozen-phantom queue this
        replaces bit-for-bit.
        """
        rel, wgt, proc = self._rel, self._w, self._proc[tier]
        m = self.machines.get(tier, 1)
        busy = self.busy[tier]
        rs = self._resv[tier]
        nr = len(rs)
        ri = 0
        ends: List[float] = []
        append = ends.append
        w = u = last = 0.0
        if m == 1:
            free = busy[0]
            for key, i in members:
                arr = key[0]
                while ri < nr and (rs[ri][0], rs[ri][1]) < (arr, key[1]):
                    ra, rr, rp, rw = rs[ri]
                    start = ra if ra > free else free
                    free = e = start + rp
                    resp = e - rr
                    w += rw * resp
                    u += resp
                    ri += 1
                start = arr if arr > free else free
                free = e = start + proc[i]
                append(e)
                resp = e - rel[i]
                w += wgt[i] * resp
                u += resp
            while ri < nr:
                ra, rr, rp, rw = rs[ri]
                start = ra if ra > free else free
                free = e = start + rp
                resp = e - rr
                w += rw * resp
                u += resp
                ri += 1
            last = free if (ends or nr) else 0.0
        else:
            heap = list(busy)
            heapq.heapify(heap)

            def dispatch(arr, p):
                avail = heapq.heappop(heap)
                start = arr if arr > avail else avail
                e = start + p
                heapq.heappush(heap, e)
                return e

            for key, i in members:
                arr = key[0]
                while ri < nr and (rs[ri][0], rs[ri][1]) < (arr, key[1]):
                    ra, rr, rp, rw = rs[ri]
                    e = dispatch(ra, rp)
                    resp = e - rr
                    w += rw * resp
                    u += resp
                    if e > last:
                        last = e
                    ri += 1
                e = dispatch(arr, proc[i])
                append(e)
                resp = e - rel[i]
                w += wgt[i] * resp
                u += resp
                if e > last:
                    last = e
            while ri < nr:
                ra, rr, rp, rw = rs[ri]
                e = dispatch(ra, rp)
                resp = e - rr
                w += rw * resp
                u += resp
                if e > last:
                    last = e
                ri += 1
        return ends, (w, u, last)

    def _shared_move_stats(self, tier: str, k: int, insert: bool):
        """(stats, members, ends) for tier with job k removed/inserted."""
        if insert:
            mem = list(self._members[tier])
            bisect.insort(mem, (self._keys[tier][k], k))
        else:
            mem = [m for m in self._members[tier] if m[1] != k]
        ends, stats = self._sim_shared(tier, mem)
        return stats, mem, ends

    def _device_move_val(self, k: int, insert: bool, oi: int) -> float:
        """Device-tier stat component after removing/inserting job k.

        O(1) for the sum objectives (per-job contributions are constants
        on the private tier); "last" removal rescans only when k held the
        maximum."""
        w, u, last = self._stats[ED]
        if oi == 0:
            return w + self._dev_wresp[k] if insert else w - self._dev_wresp[k]
        if oi == 1:
            return u + self._dev_resp[k] if insert else u - self._dev_resp[k]
        if insert:
            return last if last > self._dev_end[k] else self._dev_end[k]
        if self._dev_end[k] < last:
            return last
        return max((self._dev_end[i] for i in self._device if i != k),
                   default=0.0)

    # ------------------------------------------------------------------ api
    def score(self, objective: str = "weighted") -> float:
        """Current objective, recomputed from per-tier sums (drift-free)."""
        oi = _OBJ[objective]
        a, b, c = (self._stats[CC][oi], self._stats[ES][oi],
                   self._stats[ED][oi])
        return max(a, b, c) if oi == 2 else a + b + c

    def try_move(self, k: int, dst: str,
                 objective: str = "weighted") -> float:
        """Objective value if job k were moved to dst (no mutation).

        Costs one FIFO pass per affected shared queue; the device tier is
        O(1) (sum objectives)."""
        src = self.assign[k]
        if dst == src:
            return self.score(objective)
        oi = _OBJ[objective]
        vals = []
        for tier in (CC, ES, ED):
            if tier == src or tier == dst:
                if tier == ED:
                    vals.append(self._device_move_val(k, tier == dst, oi))
                else:
                    stats, _, _ = self._shared_move_stats(
                        tier, k, insert=(tier == dst))
                    vals.append(stats[oi])
            else:
                vals.append(self._stats[tier][oi])
        return max(vals) if oi == 2 else vals[0] + vals[1] + vals[2]

    def apply_move(self, k: int, dst: str) -> None:
        """Commit job k to dst, updating queues, ends, and tier stats.

        All committed stats are full-queue recomputations (drift-free)."""
        src = self.assign[k]
        if dst == src:
            return
        for tier, insert in ((src, False), (dst, True)):
            if tier in _SHARED:
                stats, mem, ends = self._shared_move_stats(tier, k, insert)
                self._stats[tier] = stats
                self._members[tier] = mem
                for (_, i), e in zip(mem, ends):
                    self.end[i] = e
            else:
                if insert:
                    bisect.insort(self._device, k)
                    self.end[k] = self._dev_end[k]
                else:
                    self._device.remove(k)
                self._stats[ED] = self._device_stats(self._device)
        self.assign[k] = dst

    def to_schedule(self) -> Schedule:
        """Exact Schedule for the current assignment (via ``simulate``, so
        reported sums match the reference evaluator bit-for-bit)."""
        return simulate(self.jobs, self.assign,
                        machines_per_tier=self.machines,
                        busy_until=self.busy,
                        reserved=self.reserved or None)
