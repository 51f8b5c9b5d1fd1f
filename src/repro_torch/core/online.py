"""Online (non-clairvoyant) scheduling — beyond-paper extension.

The paper's Algorithm 2 is offline: all release times are known up front.
In a real ER, jobs appear when patients deteriorate. This module provides
an event-driven online scheduler: at every job release it re-plans the
not-yet-started jobs with the paper's own machinery (Algorithm 1 costs +
greedy/tabu search), honouring commitments already made (running jobs are
non-preemptible, C2).

The replanned problem is the COMMITTED problem (DESIGN.md §7): each
replan hands `scheduler.search` the true fleet state — multi-server
tiers via `machines_per_tier` and the free time of every machine still
occupied by a started job via `busy_until` — and the plan's start/end
times are committed verbatim. The objective the search optimises is
therefore bit-for-bit the objective of the commits it produces
(`tests/test_online.py::test_replan_objective_parity`).

Transmission on replan (C4 under re-decision): a pending job's data
shipped toward its committed tier at release, so staying there keeps
arrival = release + transmission (clamped at `now` — data already in
flight counts); moving to any other tier re-ships from the device at
`now`, so arrival = now + transmission. New arrivals have no commitment
and ship wherever the plan puts them.

`competitive_ratio` measures the price of not knowing the future against
the clairvoyant offline optimum on the same instance.

Every entry point takes `device` (default "cuda"; raises RuntimeError
without a CUDA device unless device="cpu") and `device_threshold`, both
passed to each `scheduler.search*` call it makes.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Mapping, Sequence

import torch

from repro_torch.core import scheduler
from repro_torch.core.simulator import (MACHINES, JobSpec, Reservation,
                                        Schedule, ScheduledJob,
                                        machine_free_times, simulate)
from repro_torch.core.tiers import CC, ED, ES
from repro_torch.device import resolve_device

_SHARED = (CC, ES)


@dataclass
class _Commit:
    job: JobSpec
    machine: str
    arrival: float
    start: float
    end: float


def _replan_spec(job: JobSpec, commit: _Commit | None, now: float) -> JobSpec:
    """The job as the replan at time `now` sees it.

    Release is shifted to `now` (nothing can be decided earlier); the
    per-tier transmission becomes the REMAINING shipping time: the tier
    the job is already committed to keeps its in-flight data (arrival
    max(now, release + trans), i.e. remaining = max(0, arrival - now)),
    every other tier re-ships from scratch. Shifting every movable job's
    release by the same event time changes each candidate's objective by
    the same constant, so the argmin — and the committed starts/ends —
    are those of the true problem.
    """
    if commit is None or commit.machine == ED:
        return replace(job, release=now)
    trans = dict(job.trans)
    # commit.arrival is when the data actually reaches the committed tier
    # (it re-ships on every move, so release + trans would undercount)
    trans[commit.machine] = max(0.0, commit.arrival - now)
    return replace(job, release=now, trans=trans)


def _busy_vectors(commits: Sequence[_Commit | None], movable: Sequence[int],
                  now: float, machines_per_tier: Mapping[str, int]
                  ) -> Dict[str, List[float]]:
    """Free times of shared machines still occupied by surviving commits.

    Survivors all started at or before `now` (movable jobs are exactly
    those with a future start), so the ones still running at `now` overlap
    there — at most one per machine. Machines whose last job already ended
    are free immediately.
    """
    movable_set = set(movable)
    busy: Dict[str, List[float]] = {t: [] for t in _SHARED}
    for i, c in enumerate(commits):
        if c is None or i in movable_set or c.machine not in busy:
            continue
        if c.end > now:
            busy[c.machine].append(c.end)
    for tier in _SHARED:
        # ValueError, not assert: this guards real caller bugs (commit
        # bookkeeping gone wrong) and must survive ``python -O``
        if len(busy[tier]) > machines_per_tier.get(tier, 1):
            raise ValueError(f"more running jobs than machines on {tier}: "
                             f"{len(busy[tier])} > "
                             f"{machines_per_tier.get(tier, 1)}")
    return busy


def online_schedule(jobs: Sequence[JobSpec], *,
                    replan: str = "greedy",
                    device_threshold: int | None = None,
                    machines_per_tier: Mapping[str, int] | None = None,
                    trace: List[dict] | None = None,
                    device: str | torch.device | None = None) -> Schedule:
    """Event-driven scheduling: jobs become visible at their release.

    replan: "greedy" (assign on arrival, paper's greedy rule) |
            "tabu" (re-run the neighbourhood search over all visible,
            unstarted jobs at every release event).
    device_threshold: passed to scheduler.search — replans over more
    than this many movable jobs run on the device search (default: above
    64 jobs on a CUDA device only; see DESIGN.md §3.3). At real event
    rates the replan at each release is the hot path, so it dispatches
    through the same fast search as the offline planner.
    machines_per_tier: shared-server counts (TierSpec.machines); both
    replan modes honour multi-server fleets.
    trace: if a list is passed, one dict per tabu replan event is appended
    with the search-reported objective, the objective of the commits
    recorded, and the busy vectors used — the replan==commit invariant's
    audit trail (DESIGN.md §7).
    """
    device = resolve_device(device)
    mpt = dict(machines_per_tier or {CC: 1, ES: 1})
    order = sorted(range(len(jobs)), key=lambda i: (jobs[i].release, i))
    commits: List[_Commit | None] = [None] * len(jobs)
    # greedy mode: per-tier machine free times, maintained incrementally
    free = {t: machine_free_times(None, t, mpt.get(t, 1)) for t in _SHARED}
    pending: List[int] = []

    for idx in order:
        job = jobs[idx]
        now = job.release
        pending.append(idx)
        if replan == "tabu":
            # replan every job whose machine slot hasn't begun (C2: started
            # jobs are committed for good and only constrain availability)
            movable = [i for i in pending
                       if commits[i] is None or commits[i].start > now]
            shifted = [_replan_spec(jobs[i], commits[i], now)
                       for i in movable]
            busy = _busy_vectors(commits, movable, now, mpt)
            plan = scheduler.search(shifted, max_count=5,
                                    device_threshold=device_threshold,
                                    machines_per_tier=mpt, busy_until=busy,
                                    device=device)
            # commit the plan verbatim: the entries' starts/ends ARE the
            # schedule the search scored (plan.entries aligns with shifted)
            for entry, i in zip(plan.entries, movable):
                commits[i] = _Commit(jobs[i], entry.machine, entry.arrival,
                                     entry.start, entry.end)
            if trace is not None:
                committed = sum(
                    s.weight * (commits[i].end - s.release)
                    for s, i in zip(shifted, movable))
                trace.append({"now": now, "movable": list(movable),
                              "busy": busy, "reported": plan.weighted_sum,
                              "committed": committed})
            pending = movable
        else:
            # paper greedy on arrival — the same rule as the offline
            # initial solution, one event at a time (scheduler.greedy_schedule)
            tier = scheduler.greedy_schedule(
                [job], machines_per_tier=mpt,
                busy_until={t: free[t] for t in _SHARED})[0]
            arr = now + job.trans.get(tier, 0.0)
            if tier == ED:
                start = arr
            else:
                vec = free[tier]
                k = min(range(len(vec)), key=vec.__getitem__)
                start = max(arr, vec[k])
                vec[k] = start + job.proc[tier]
            commits[idx] = _Commit(job, tier, arr, start,
                                   start + job.proc[tier])

    entries = [ScheduledJob(c.job, c.machine, c.arrival, c.start, c.end)
               for c in commits]
    weighted = sum(e.job.weight * e.response for e in entries)
    unweighted = sum(e.response for e in entries)
    return Schedule(entries=entries, weighted_sum=weighted,
                    unweighted_sum=unweighted,
                    last_end=max(e.end for e in entries))


def online_schedule_fleet(ward_jobs: Sequence[Sequence[JobSpec]], *,
                          machines_per_tier: Mapping[str, int] | None = None,
                          max_count: int = 5,
                          device_threshold: int | None = None,
                          device: str | torch.device | None = None
                          ) -> List[Schedule]:
    """Ward-aware online replanning on a shared metropolitan cloud
    (DESIGN.md §9) — the online counterpart of `scheduler.search_fleet`.

    One global event stream over every ward's releases. At each release in
    ward b, ward b's unstarted jobs are replanned against the TRUE fleet
    state:

      * the shared cloud pool's busy vector collects machines still
        running ANY ward's started cloud job (cross-ward, so no two wards
        can ever double-book a cloud server);
      * every other ward's committed-but-unstarted cloud job enters the
        replan as an interval RESERVATION (DESIGN.md §12) — immovable
        (C2 belongs to its own ward), but fully present in the merged
        FIFO queue, so ward b pays the queueing delay it inflicts and
        vice versa;
      * reservations are re-timed (never re-decided) from the plan's
        ``reserved_times``, so each commitment's recorded start/end
        stays consistent with the merged queue as other wards' arrivals
        interleave.

    Per-ward edge pools and private devices replan exactly as the
    single-ward `online_schedule` (tabu mode). With B = 1 the background
    is empty every event and this IS `online_schedule(replan="tabu")`.
    Returns one Schedule of verbatim commits per ward."""
    device = resolve_device(device)
    mpt = dict(machines_per_tier or {CC: 1, ES: 1})
    B = len(ward_jobs)
    commits: List[List[_Commit | None]] = [
        [None] * len(jobs) for jobs in ward_jobs]
    pending: List[List[int]] = [[] for _ in range(B)]
    events = sorted((jobs[i].release, b, i)
                    for b, jobs in enumerate(ward_jobs)
                    for i in range(len(jobs)))

    for now, b, i in events:
        pending[b].append(i)
        movable = [j for j in pending[b]
                   if commits[b][j] is None or commits[b][j].start > now]
        movable_set = set(movable)
        shifted = [_replan_spec(ward_jobs[b][j], commits[b][j], now)
                   for j in movable]
        # fleet-wide cloud occupancy + other wards' unstarted cloud jobs
        cloud_busy: List[float] = []
        bg: List[tuple] = []
        for c in range(B):
            for j, cm in enumerate(commits[c]):
                if cm is None or cm.machine != CC or \
                        (c == b and j in movable_set):
                    continue
                if cm.start <= now:
                    if cm.end > now:
                        cloud_busy.append(cm.end)
                elif c != b:
                    bg.append((c, j))
        edge_busy = [cm.end for j, cm in enumerate(commits[b])
                     if cm is not None and cm.machine == ES
                     and j not in movable_set and cm.start <= now < cm.end]
        busy = {CC: cloud_busy, ES: edge_busy}
        if bg:
            bg_specs = [_replan_spec(ward_jobs[c][j], commits[c][j], now)
                        for c, j in bg]
            resv = {CC: [Reservation(
                arrival=s.release + s.trans.get(CC, 0.0), proc=s.proc[CC],
                release=s.release, weight=s.weight) for s in bg_specs]}
            initial = [commits[b][j].machine if commits[b][j] is not None
                       else ED for j in movable]
            plan = scheduler.search(shifted, initial=initial, reserved=resv,
                                    max_count=max_count,
                                    device_threshold=device_threshold,
                                    machines_per_tier=mpt, busy_until=busy,
                                    device=device)
        else:
            plan = scheduler.search(shifted, max_count=max_count,
                                    device_threshold=device_threshold,
                                    machines_per_tier=mpt, busy_until=busy,
                                    device=device)
        # ward b's movable jobs commit verbatim; reservations RE-TIME
        # (machine unchanged) so their commitments track the merged queue
        for entry, j in zip(plan.entries, movable):
            commits[b][j] = _Commit(ward_jobs[b][j], entry.machine,
                                    entry.arrival, entry.start, entry.end)
        if bg:
            for (arr, start, end), (c, j) in zip(plan.reserved_times[CC],
                                                 bg):
                cm = commits[c][j]
                commits[c][j] = _Commit(cm.job, cm.machine, arr, start, end)
        pending[b] = movable

    out = []
    for b in range(B):
        entries = [ScheduledJob(c.job, c.machine, c.arrival, c.start, c.end)
                   for c in commits[b]]
        out.append(Schedule(
            entries=entries,
            weighted_sum=sum(e.job.weight * e.response for e in entries),
            unweighted_sum=sum(e.response for e in entries),
            last_end=max((e.end for e in entries), default=0.0)))
    return out


def competitive_ratio(jobs: Sequence[JobSpec], replan: str = "tabu", *,
                      device_threshold: int | None = None,
                      machines_per_tier: Mapping[str, int] | None = None,
                      device: str | torch.device | None = None) -> float:
    """online / clairvoyant-offline weighted response ratio (>= ~1).

    The offline side goes through the size-dispatched `scheduler.search`,
    so fleet-scale ratios use the same device path as the replanner.
    """
    device = resolve_device(device)
    online = online_schedule(jobs, replan=replan,
                             device_threshold=device_threshold,
                             machines_per_tier=machines_per_tier,
                             device=device)
    offline = scheduler.search(jobs, device_threshold=device_threshold,
                               machines_per_tier=machines_per_tier,
                               device=device)
    return online.weighted_sum / max(offline.weighted_sum, 1e-9)


def competitive_ratio_fleet(ward_jobs: Sequence[Sequence[JobSpec]], *,
                            machines_per_tier: Mapping[str, int] | None
                            = None,
                            max_count: int = 5,
                            max_sweeps: int = 8,
                            device_threshold: int | None = None,
                            device: str | torch.device | None = None
                            ) -> Dict:
    """Online fleet replanning vs the clairvoyant fixed point
    (DESIGN.md §9): `online_schedule_fleet`'s committed fleet-true
    objective over `scheduler.search_fleet`'s — the multi-ward price of
    not knowing the future, on the same shared metropolitan cloud.

    Both sides are fleet-true (the online commits never double-book the
    cloud; the clairvoyant plan is scored by `simulate_fleet`), so the
    ratio is meaningfully >= ~1. Returns {"online", "clairvoyant",
    "ratio", "sweeps"}."""
    device = resolve_device(device)
    online_scheds = online_schedule_fleet(
        ward_jobs, machines_per_tier=machines_per_tier,
        max_count=max_count, device_threshold=device_threshold,
        device=device)
    online_total = sum(s.weighted_sum for s in online_scheds)
    plan = scheduler.search_fleet(
        ward_jobs, machines_per_tier=machines_per_tier,
        max_count=max_count * 10, max_sweeps=max_sweeps,
        device_threshold=device_threshold, device=device)
    clair = plan.fleet.weighted_sum
    return {"online": float(online_total), "clairvoyant": float(clair),
            "ratio": float(online_total / max(clair, 1e-9)),
            "sweeps": plan.sweeps}


def competitive_ratio_batch(instances: Sequence[Sequence[JobSpec]],
                            replans: Sequence[str] = ("greedy", "tabu"), *,
                            device_threshold: int | None = None,
                            machines_per_tier: Mapping[str, int] | None
                            = None,
                            min_batch: int | None = None,
                            device: str | torch.device | None = None
                            ) -> Dict[str, List[float]]:
    """Competitive ratios for a whole sweep of instances, with ONE
    batched clairvoyant baseline call shared by every replan mode.

    The offline optimum is the expensive side of a ratio sweep — it sees
    the full instance while the online replanner only ever optimises the
    visible suffix. `scheduler.search_batched` plans all instances in a
    single batched device search (DESIGN.md §8), so the sweep cost is one
    batched search plus the (inherently event-sequential) online runs.

    Returns {replan mode: [ratio per instance]}."""
    device = resolve_device(device)
    # device_threshold reaches BOTH sides of the ratio: the online
    # replanner below and the clairvoyant baseline's sequential fallback
    # (small batches loop per-instance `search`, which would otherwise
    # dispatch on a different backend than the online side — §3.3)
    offline = scheduler.search_batched(
        list(instances), machines_per_tier=machines_per_tier,
        min_batch=min_batch, device_threshold=device_threshold,
        device=device)
    out: Dict[str, List[float]] = {}
    for replan in replans:
        out[replan] = [
            online_schedule(jobs, replan=replan,
                            device_threshold=device_threshold,
                            machines_per_tier=machines_per_tier,
                            device=device)
            .weighted_sum / max(off.weighted_sum, 1e-9)
            for jobs, off in zip(instances, offline)]
    return out
