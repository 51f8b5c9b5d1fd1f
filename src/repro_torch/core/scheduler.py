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

Also provides baseline strategies (Table VII comparison set), an exact
brute-force optimum for small n (the paper has none — we add it to measure
the heuristic's optimality gap), and `neighborhood_search_reference`, the
seed full-re-simulation implementation kept as a benchmark baseline and
parity oracle.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Mapping, Sequence

import torch

from repro_torch.core.simulator import (MACHINES, JobSpec, Reservation,
                                        Schedule, ScheduleState,
                                        machine_free_times, simulate)
from repro_torch.core.tiers import CC, ED, ES

# above this many jobs, `search` on a CUDA device takes the device search
DEVICE_SEARCH_THRESHOLD = 64


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

    device: where the device search runs (default "cuda" when torch sees
    a CUDA device, else the CPU). device_threshold: job count above which
    the device search is taken. Default (None): DEVICE_SEARCH_THRESHOLD
    when the device is CUDA, never on the CPU — mirroring the reference's
    accelerator-only default.

    machines_per_tier / busy_until (DESIGN.md §7), frozen (DESIGN.md §9:
    immovable background jobs, initial required) and reserved
    (DESIGN.md §12: committed interval occupancy, initial required) are
    threaded through whichever backend runs, so both search the problem
    the schedule will actually be committed against. On the device path,
    an instance whose movable jobs are fewer than half its padded rows
    needs the "pass" regime, which is not ported yet (NotImplementedError).
    """
    n = len(jobs)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
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
    device search. machines_per_tier (from TierSpec.machines) sizes the
    shared tiers for every strategy."""
    mpt = machines_per_tier
    return {
        "ours (algorithm 2)": search(jobs, device_threshold=device_threshold,
                                     machines_per_tier=mpt, device=device),
        "per-job optimal layer": per_job_optimal(jobs, machines_per_tier=mpt),
        "all cloud": all_on_tier(jobs, CC, machines_per_tier=mpt),
        "all edge": all_on_tier(jobs, ES, machines_per_tier=mpt),
        "all device": all_on_tier(jobs, ED, machines_per_tier=mpt),
    }
