"""Pluggable replanning policies for the metro engine (DESIGN.md §10).

The engine owns ground truth (fleet occupancy, FIFO dispatch, commit
times); a policy only answers "which tier should each movable job run
on?" at each decision event, through one `decide` call over the wards
the event touched. The engine hands every ward's subproblem in the same
shifted-spec form `online_schedule` replans (release moved to `now`,
remaining transmission on the committed tier), so search-based policies
optimise exactly the committed problem (DESIGN.md §7).

A decision is a tier name (cloud/edge/device) or the `SHED` sentinel:
a shed job is dropped — the engine marks it finished-missed with a
``shed`` event instead of ever running it (DESIGN.md §11). Shedding is
the admission-control escape valve for saturation: a job that cannot
meet any deadline anyway is cheaper missed *explicitly* than queued in
front of jobs that still can.

Four built-ins:

  * `GreedyPolicy` — commit-on-arrival with the paper's greedy rule
    against the RESERVED fleet view (queued commitments hold their
    machines); never revisits a decision.
  * `TabuPolicy` — `online_schedule(replan="tabu")`-style committed
    replanning of the affected ward. When one event touches several
    wards at once (a shared-cloud failure/recovery/scale event reaches
    every ward at the same event count), all their replans go through a
    single `scheduler.search_batched` call, so the sweep runs as one
    batched device search instead of looping ward by ward.
  * `FleetPolicy` — the contention-aware fixed point: every decision
    event replans ALL wards jointly via `scheduler.search_fleet`, so
    no two wards ever double-book the shared metropolitan cloud.
  * `SheddingPolicy` — a wrapper that delegates tier choice to any
    inner policy, then sheds lowest-weight-class movable jobs whose
    reserved backlog exceeds a deadline-derived horizon.
  * `HedgingPolicy` — a wrapper that delegates `decide` to any inner
    policy and additionally answers the engine's hedge watchdog
    (`hedge()` hook): when an in-flight job of the HEAVIEST weight
    class has overrun its expected runtime (fail-slow machine) or its
    committed end misses the deadline, pick the backup tier whose
    reserved queue finishes the job earliest — if that beats the
    committed projection by a margin (DESIGN.md §13).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence, Union

import torch

from repro_torch.core import scheduler
from repro_torch.core.simulator import JobSpec, Reservation
from repro_torch.core.tiers import CC, ED, ES
from repro_torch.device import resolve_device

# sentinel decision: drop the job instead of placing it on a tier (the
# engine validates decisions against tiers + SHED in one place)
SHED = "shed"
_INF = float("inf")


@dataclass
class ReplanRequest:
    """One ward's movable subproblem at a decision event."""
    ward: int
    movable: List[int]                  # ward-local job indices
    shifted: List[JobSpec]              # online-style replan specs
    current: List[Optional[str]]        # committed tier per movable job
    fresh: List[int]                    # positions in `movable` new this event
    busy: Dict[str, List[float]]        # started-occupancy per shared tier
    reserved: Dict[str, List[float]]    # per-machine frees incl. queued jobs
    machines_per_tier: Dict[str, int]
    # OTHER wards' unstarted cloud commitments (shifted), queue-active
    # but immovable for this ward
    background: List[JobSpec] = field(default_factory=list)


@dataclass
class HedgeRequest:
    """One in-flight job's hedge question at a watchdog event: the job
    as a fresh replan spec (release = now, full re-ship transmission,
    degraded-network factors priced in), where it currently runs and
    when the engine projects it to finish, plus the same fleet views a
    ReplanRequest carries."""
    ward: int
    job: JobSpec                        # fresh shifted spec (release=now)
    tier: str                           # committed (running) tier
    projected_end: float                # committed end under fail-slow
    busy: Dict[str, List[float]]
    reserved: Dict[str, List[float]]
    machines_per_tier: Dict[str, int]


class Policy(Protocol):
    """What the engine needs from a policy. `joint` policies replan every
    ward at every decision event; `replans_on_fleet_events` ones get a
    decide() call on failure/recovery/scale events (otherwise the engine
    just re-times the committed tiers around the changed capacity)."""
    name: str
    joint: bool
    replans_on_fleet_events: bool

    def decide(self, requests: Sequence[ReplanRequest], now: float
               ) -> List[List[str]]:
        """One decision list per request, aligned with its `movable`:
        each entry a tier name or `SHED` (drop the job, scored as an
        explicit deadline miss)."""
        ...                                               # pragma: no cover


@dataclass
class GreedyPolicy:
    """Paper greedy, one arrival at a time: the new job takes the machine
    minimising its completion given every reservation so far; existing
    commitments keep their tier (the engine re-times them around
    failures). The myopic baseline every replanner must beat."""
    name: str = "greedy"
    joint: bool = False
    replans_on_fleet_events: bool = False

    def decide(self, requests, now):
        out = []
        for req in requests:
            resv = {t: list(req.reserved.get(t, ())) for t in (CC, ES)}
            tiers = list(req.current)
            for pos in req.fresh:
                job = req.shifted[pos]
                tier = scheduler.greedy_schedule(
                    [job], machines_per_tier=req.machines_per_tier,
                    busy_until=resv)[0]
                tiers[pos] = tier
                if tier != ED:
                    vec = resv[tier]
                    k = min(range(len(vec)), key=vec.__getitem__)
                    arr = job.release + job.trans.get(tier, 0.0)
                    vec[k] = max(arr, vec[k]) + job.proc[tier]
            if any(t is None for t in tiers):
                raise ValueError("greedy saw a non-fresh uncommitted job")
            out.append(tiers)
        return out


@dataclass
class TabuPolicy:
    """Committed tabu replanning (`online_schedule(replan="tabu")`): every
    decision event re-searches the affected ward's movable jobs against
    the started-occupancy fleet state. Multi-ward events batch through
    `scheduler.search_batched` — the "replans batched across wards at
    matching event counts" path that closes the event-sequential ROADMAP
    item. device: where the searches run (default None means "cuda" and
    raises without a CUDA device; pass "cpu" for the plain path);
    device_threshold pins the single-ward dispatch (`scheduler.search`)."""
    max_count: int = 5
    device_threshold: Optional[int] = None
    min_batch: Optional[int] = None
    device: Union[str, torch.device, None] = None
    name: str = "tabu"
    joint: bool = False
    replans_on_fleet_events: bool = True

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @staticmethod
    def _reservations(req: ReplanRequest):
        """-> ({tier: [Reservation]} | None, initial | None) with the
        other wards' unstarted cloud commitments as interval reservations
        (DESIGN.md §12 — `online_schedule_fleet`'s view: ward-local
        decisions, fleet-true queueing, no frozen phantom rows for the
        kernel to carry)."""
        bg = list(req.background or ())
        if not bg:
            return None, None
        resv = {CC: [Reservation(arrival=s.release + s.trans.get(CC, 0.0),
                                 proc=s.proc[CC], release=s.release,
                                 weight=s.weight) for s in bg]}
        return resv, [t if t is not None else ED for t in req.current]

    def decide(self, requests, now):
        if len(requests) == 1:
            req = requests[0]
            resv, initial = self._reservations(req)
            plan = scheduler.search(
                list(req.shifted), initial=initial, reserved=resv,
                max_count=self.max_count,
                device_threshold=self.device_threshold,
                machines_per_tier=req.machines_per_tier,
                busy_until=req.busy, device=self.device)
            return [plan.assignment()]
        pairs = [self._reservations(req) for req in requests]
        if any(init is not None for _, init in pairs):
            # the batched backend wants initials for all wards or none
            inits = [init if init is not None
                     else [t if t is not None else ED for t in req.current]
                     for (_, init), req in zip(pairs, requests)]
        else:
            inits = None
        plans = scheduler.search_batched(
            [list(req.shifted) for req in requests],
            max_count=self.max_count,
            machines_per_tier=[req.machines_per_tier for req in requests],
            busy_until=[req.busy for req in requests],
            initial=inits,
            reserved=[resv for resv, _ in pairs]
            if any(resv is not None for resv, _ in pairs) else None,
            min_batch=self.min_batch,
            device_threshold=self.device_threshold, device=self.device)
        return [plan.assignment() for plan in plans]


@dataclass
class FleetPolicy:
    """Joint fixed-point replanning: all wards' movable jobs re-searched
    together by `scheduler.search_fleet`, so the shared cloud's merged
    FIFO queue is priced into every decision (DESIGN.md §9). Budgets are
    deliberately small — each event only needs local repair on top of
    the previous fixed point. device / device_threshold as for
    `TabuPolicy`."""
    max_count: int = 3
    max_sweeps: int = 2
    sweep_max_count: int = 2
    device_threshold: Optional[int] = None
    device: Union[str, torch.device, None] = None
    name: str = "fleet"
    joint: bool = True
    replans_on_fleet_events: bool = True

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def decide(self, requests, now):
        shared = requests[0].busy.get(CC, [])
        plan = scheduler.search_fleet(
            [req.shifted for req in requests],
            machines_per_tier=[req.machines_per_tier for req in requests],
            max_count=self.max_count, max_sweeps=self.max_sweeps,
            sweep_max_count=self.sweep_max_count,
            device_threshold=self.device_threshold,
            busy_until={CC: list(shared)} if shared else None,
            ward_busy_until=[{ES: req.busy.get(ES, [])}
                             for req in requests], device=self.device)
        return [list(a) for a in plan.assignments]


@dataclass
class SheddingPolicy:
    """Saturation-aware load shedding on top of any inner policy
    (DESIGN.md §11): tier choice is delegated to `inner`, then a
    movable job of the ward's LOWEST weight class is shed when the
    reserved backlog of the shared tier it was placed on exceeds a
    deadline-derived horizon — the earliest machine there frees more
    than ``shed_factor * deadline`` away, so queueing the job burns
    saturated capacity better spent on tighter-deadline classes.
    Only jobs strictly BELOW the heaviest weight seen so far are ever
    shed (never a life-critical class, never device placements): under
    mass-casualty saturation the policy chooses WHICH deadline to miss
    instead of letting overflowing queues miss the life-critical ones."""
    inner: Optional[Policy] = None              # default: GreedyPolicy
    shed_factor: float = 0.3
    name: str = "shed"

    def __post_init__(self):
        if self.inner is None:
            self.inner = GreedyPolicy()
        self._max_weight = float("-inf")

    @property
    def joint(self) -> bool:
        return self.inner.joint

    @property
    def replans_on_fleet_events(self) -> bool:
        return self.inner.replans_on_fleet_events

    def decide(self, requests, now):
        decisions = self.inner.decide(requests, now)
        for req in requests:
            for job in req.shifted:
                if job.weight > self._max_weight:
                    self._max_weight = job.weight
        for req, tiers in zip(requests, decisions):
            for pos, job in enumerate(req.shifted):
                tier = tiers[pos]
                if tier not in (CC, ES) or \
                        job.weight >= self._max_weight or \
                        not math.isfinite(job.deadline):
                    continue
                vec = req.reserved.get(tier)
                if not vec:
                    continue
                # how far away the earliest free machine of the placed
                # tier is with every queued commitment dispatched
                backlog = min(vec) - now
                if backlog > self.shed_factor * job.deadline:
                    tiers[pos] = SHED
        return decisions


@dataclass
class HedgingPolicy:
    """Deadline-aware hedging on top of any inner policy (DESIGN.md
    §13): `decide` is delegated untouched; the `hedge()` hook answers
    the engine's watchdog for in-flight stragglers. Mirroring
    `SheddingPolicy`'s class discipline in reverse, only jobs of the
    HEAVIEST weight class seen so far are ever hedged — backup attempts
    burn real machine-seconds, so the duplicate-execution budget is
    spent exclusively on the life-critical SLA. The backup tier is the
    one whose reserved view (every queued commitment dispatched)
    finishes the job earliest, and the hedge is declined unless that
    estimate beats the committed projection by `min_gain` time units —
    a backup that would lose the race is pure waste."""
    inner: Optional[Policy] = None              # default: GreedyPolicy
    min_gain: float = 2.0
    name: str = "hedge"

    def __post_init__(self):
        if self.inner is None:
            self.inner = GreedyPolicy()
        self._max_weight = float("-inf")

    @property
    def joint(self) -> bool:
        return self.inner.joint

    @property
    def replans_on_fleet_events(self) -> bool:
        return self.inner.replans_on_fleet_events

    def _see(self, jobs) -> None:
        for job in jobs:
            if job.weight > self._max_weight:
                self._max_weight = job.weight

    def decide(self, requests, now):
        for req in requests:
            self._see(req.shifted)
        return self.inner.decide(requests, now)

    def hedge(self, req: HedgeRequest, now: float) -> Optional[str]:
        self._see((req.job,))
        job = req.job
        if job.weight < self._max_weight:
            return None                 # hedge only the heaviest class
        best, best_end = None, req.projected_end - self.min_gain
        for tier in (ED, ES, CC):
            if tier == req.tier or job.proc.get(tier, _INF) == _INF:
                continue
            arr = now + job.trans.get(tier, 0.0)
            if tier == ED:
                end = arr + job.proc[ED]
            else:
                vec = req.reserved.get(tier) or []
                free = min(vec) if vec else now
                end = max(arr, free, now) + job.proc[tier]
            if end < best_end:
                best, best_end = tier, end
        return best


def make_policy(name: str, **kw) -> Policy:
    """Factory keyed by the names serve/benchmarks print."""
    try:
        cls = {"greedy": GreedyPolicy, "tabu": TabuPolicy,
               "fleet": FleetPolicy, "shed": SheddingPolicy,
               "hedge": HedgingPolicy}[name]
    except KeyError:
        raise ValueError(f"unknown metro policy {name!r}") from None
    return cls(**kw)
