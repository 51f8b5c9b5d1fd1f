"""Lower bounds for the multi-job problem (paper eq. 6 + tighter extras)."""
from __future__ import annotations

from typing import Mapping, Sequence

from repro_torch.core.simulator import MACHINES, JobSpec
from repro_torch.core.tiers import CC, ED, ES


def paper_lower_bound(jobs: Sequence[JobSpec],
                      weighted: bool = True) -> float:
    """Eq. (6): every job takes its stand-alone minimum response time."""
    total = 0.0
    for j in jobs:
        best = min(j.response_if_alone(t) for t in MACHINES)
        total += (j.weight if weighted else 1.0) * best
    return total


def jobwise_last_bound(jobs: Sequence[JobSpec]) -> float:
    """Per-job last-completion bound: no schedule can finish before the
    latest of the jobs' own best-case completions (release + stand-alone
    minimum response)."""
    return max(j.release + min(j.response_if_alone(t) for t in MACHINES)
               for j in jobs)


def _forced_load_feasible(jobs: Sequence[JobSpec], tau: float,
                          machines: Mapping[str, int]) -> bool:
    """Can every job individually finish by `tau`, and does every shared
    tier have room for the jobs FORCED onto it?

    A job is forced onto shared tier T at level `tau` when no other tier
    could finish it by `tau` even running it alone (an optimistic test, so
    the forced set is a subset of the truly forced jobs — the predicate is
    a relaxation and the resulting bound stays valid). Forced jobs must
    all run on T's machines: total work after the earliest forced arrival
    on m machines needs earliest_arrival + work/m <= tau, and each forced
    job needs its own arrival + processing <= tau.
    """
    for j in jobs:
        if min(j.response_if_alone(t) for t in MACHINES) + j.release > tau:
            return False
    for tier in (CC, ES):
        m = machines.get(tier, 1)
        forced_arr, forced_work = [], 0.0
        for j in jobs:
            alone = {t: j.release + j.response_if_alone(t) for t in MACHINES}
            if all(alone[t] > tau for t in MACHINES if t != tier):
                arr = j.release + j.trans[tier]
                if arr + j.proc[tier] > tau:
                    return False
                forced_arr.append(arr)
                forced_work += j.proc[tier]
        if forced_arr and min(forced_arr) + forced_work / m > tau:
            return False
    return True


def load_lower_bound(jobs: Sequence[JobSpec],
                     machines_per_tier: Mapping[str, int] | None = None,
                     tol: float = 1e-6) -> float:
    """Machine-load last-completion bound: a horizon `tau` that no
    schedule can beat because some shared tier cannot absorb the
    processing it is forced to run — sum of forced processing after the
    earliest forced arrival, divided over the tier's machines — where a
    job avoids a machine entirely whenever any other tier could finish it
    alone by `tau`.

    Validity: feasibility at `tau` is a necessary condition for ANY
    assignment to finish by `tau` (the avoid-test ignores queueing, so it
    only under-forces), hence infeasibility at `tau` proves
    last_end > tau for every schedule. The predicate is NOT monotone in
    `tau` (raising the horizon can unforce a cheap early job while the
    expensive late ones stay forced), so bisection converges to *a*
    feasible/infeasible crossing, not necessarily the largest infeasible
    horizon; the returned value is the bisection's infeasible end (or the
    per-job bound when that is already feasible), so it is always a valid
    bound and always >= `jobwise_last_bound`.
    """
    machines = dict(machines_per_tier or {CC: 1, ES: 1})
    lo = jobwise_last_bound(jobs)
    if _forced_load_feasible(jobs, lo, machines):
        return lo
    # infeasible at the per-job bound: grow to a feasible upper horizon
    hi = max(lo, max(j.release for j in jobs) +
             sum(min(j.proc[t] + j.trans[t] for t in MACHINES)
                 for j in jobs))
    while not _forced_load_feasible(jobs, hi, machines):   # pragma: no cover
        hi *= 2.0
    for _ in range(80):
        if hi - lo <= tol:
            break
        mid = 0.5 * (lo + hi)
        if _forced_load_feasible(jobs, mid, machines):
            hi = mid
        else:
            lo = mid
    return lo
