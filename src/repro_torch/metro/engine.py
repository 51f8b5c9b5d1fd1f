"""Discrete-event metro traffic engine (DESIGN.md §10).

Event loop over job arrivals, completions, machine failures/recoveries
and elastic scale events for B hospital wards sharing one metropolitan
cloud pool (per-ward edge pools, private devices — the §9 fleet model,
now under streaming load instead of a finite scored-once job list).

Ground truth lives HERE, not in the policy: machines are explicit slots
with identity (so a failure can strike a specific machine and elastic
scale-down can retire one), and after every decision the engine replays
each pool's unstarted commitments through the same FIFO-by-arrival
dispatch `simulate` defines (C1–C5). Policies only pick tiers; the
replay prices their choices on the real fleet — a ward-local plan that
double-books the shared cloud gets delayed by the merged queue, exactly
as in `simulate_fleet`.

Commitment semantics follow `online_schedule` (DESIGN.md §7): a job
whose machine slot has begun (start <= now) is immutable (C2); every
other commitment may be re-tiered by the policy and is re-timed by the
replay. A *drain* failure (the default) never drops a running job — the
machine finishes it, then goes down for the repair duration, delaying
its queue successors. A *crash* failure (`kill_running=True`) kills the
struck machine's in-flight job: its commitment is invalidated, the
partial run's machine-seconds are recorded as wasted, and the job
returns to the pending set to be re-dispatched through the normal
decision path (retries count as fresh arrivals, so search policies may
fail it over to another tier). Policies may also return the SHED
sentinel for a movable job — the engine drops it with a ``shed`` event
and scores it as an explicit deadline miss (DESIGN.md §11). With B = 1
wards, no failures and the tabu policy, the engine's event sequence IS
`online_schedule(replan="tabu")` and the committed schedules match
bit-for-bit (tests/test_metro.py).

Degraded-network windows (`NetworkEvent`) multiply a shared tier's
transmission times while active: every decision made inside the window
prices the degraded uplink (the §7 shifted specs carry scaled
transmission for any tier the job would re-ship to), while data already
in flight toward a committed tier keeps its committed arrival.

Fail-slow windows (`SlowdownEvent`, DESIGN.md §13) degrade a machine
without killing anything: the struck slot serves `factor < 1` work
units per wall second for the window, in-flight completions and queued
successors are re-timed through the piecewise rate profile, and
`capacity_integral` discounts the forgone service. Tail tolerance rides
on top: with `hedge_factor` set and a policy exposing a `hedge()` hook
(see `HedgingPolicy`), a watchdog event fires when an in-flight job has
run `hedge_factor x` its committed proc time — or its committed end
already misses the deadline — and the policy may dispatch ONE backup
attempt on another tier. First completion wins; the loser is cancelled
at the winner's completion instant and its consumed machine-seconds are
scored as `hedge_waste`. Crash retries are bounded: `retry_backoff`
delays re-decision exponentially per attempt and `max_attempts` (global
or per-class) sheds-with-record instead of dispatching a storm. All
four knobs default OFF, reproducing the engine without them
event-for-event.

Completion events are scheduled from commitment end times and validated
lazily on pop (a replan that re-times a commitment simply strands the
stale event), the standard DES invalidation scheme — so the event log is
a deterministic function of (traces, fleet events, policy) and of the
`scheduler.search` dispatch: a search-based policy whose
`device_threshold` is unset takes the device search above
DEVICE_SEARCH_THRESHOLD jobs on CUDA and the Python search on the CPU,
and the two may legitimately commit different (equally exact) local
optima. Pin `device_threshold` on the policy to compare runs across
devices. Replans of four or more wards at one event always go through
the batched device search (`scheduler.search_batched`), whatever the
threshold.
"""
from __future__ import annotations

import heapq
import time
from dataclasses import dataclass, replace
from typing import (Dict, List, Mapping, Optional, Sequence, Set, Tuple,
                    Union)

from repro_torch.core import online
from repro_torch.core.simulator import JobSpec, Schedule, ScheduledJob
from repro_torch.core.tiers import CC, ED, ES
from repro_torch.metro.metrics import MetroMetrics
from repro_torch.metro.policies import SHED, HedgeRequest, Policy, ReplanRequest

_INF = float("inf")
# same-instant ordering: completions first (a machine freeing at t is
# visible to a replan at t), then fleet/network events (slowdown onsets
# with failures, window closes with recoveries), then hedge watchdogs
# (they must see the post-event fleet), then arrivals/backoff retries
(_P_COMPLETE, _P_FAIL, _P_SLOW, _P_SCALE, _P_RECOVER, _P_SLOWEND,
 _P_NET, _P_HEDGE, _P_ARRIVE) = range(9)
# decisions a policy may return per movable job (validated centrally
# in _decide — not ad hoc per commit branch)
_DECISIONS = frozenset((CC, ES, ED, SHED))


@dataclass(frozen=True)
class FailureEvent:
    """A machine in `tier`'s pool (ward-local for edge, fleet-wide for
    cloud) breaks at `time` for `duration`.

    Drain mode (default): the earliest-free machine is struck, finishes
    any running job, then stays down until repaired — nothing is lost.

    Crash mode (``kill_running=True``): the BUSIEST (latest-free)
    machine is struck and dies immediately; its in-flight job is LOST —
    the partial run is wasted machine-seconds, the commitment is
    invalidated and the job re-dispatches through the normal decision
    path (DESIGN.md §11)."""
    time: float
    tier: str = CC
    ward: Optional[int] = None           # None = the shared cloud pool
    duration: float = 10.0
    kill_running: bool = False


@dataclass(frozen=True)
class NetworkEvent:
    """Degraded-network window: transmission times toward `tier` are
    multiplied by `factor` during [time, time + duration). Overlapping
    windows compound. Decisions made inside the window price the
    degraded uplink; data already shipped toward a committed tier keeps
    its committed arrival (the in-flight contract, DESIGN.md §11)."""
    time: float
    duration: float = 30.0
    tier: str = CC
    factor: float = 4.0


@dataclass(frozen=True)
class SlowdownEvent:
    """Fail-slow window (DESIGN.md §13): the BUSIEST (latest-free)
    non-retired machine in `tier`'s pool runs at `factor` (< 1) of
    nominal speed during [time, time + duration). The struck machine's
    in-flight job keeps its placement (C2) but its completion — and
    every queued successor — is re-timed through the piecewise-constant
    rate profile; overlapping windows on one machine compound by factor
    product (like network factors). Unlike a failure nothing is lost:
    the machine delivers `factor` service units per wall second, and
    `capacity_integral` shaves the forgone (1 - factor) fraction off
    every up interval the window covers."""
    time: float
    tier: str = CC
    ward: Optional[int] = None           # None = the shared cloud pool
    duration: float = 20.0
    factor: float = 0.25


@dataclass(frozen=True)
class ScaleEvent:
    """Elastic capacity: delta > 0 adds machines to the pool at `time`;
    delta < 0 retires the earliest-free ones (each finishes its running
    job, then leaves the pool for good)."""
    time: float
    tier: str = CC
    ward: Optional[int] = None
    delta: int = 1


@dataclass
class _Commit:
    """One job's current commitment. Attribute names match
    `online._Commit` so `online._replan_spec` builds the replan view."""
    job: JobSpec
    machine: str
    arrival: float
    start: float
    end: float
    slot: int = -1
    planned_at: float = 0.0


class _Slot:
    """One machine with identity: when it joined the pool, until when it
    is down (inf = retired), its recorded outage intervals (exact
    utilisation accounting), and its fail-slow windows
    (t0, t1, factor)."""
    __slots__ = ("created", "down", "outages", "slowdowns", "retired_at")

    def __init__(self, created: float = 0.0):
        self.created = created
        self.down = created          # not dispatchable before it exists
        self.outages: List[Tuple[float, float]] = []
        self.slowdowns: List[Tuple[float, float, float]] = []
        self.retired_at: Optional[float] = None


def _rate_profile(windows: Sequence[Tuple[float, float, float]],
                  lo: float, hi: float):
    """Piecewise-constant service rate of one machine over [lo, hi):
    yields (seg_start, seg_end, rate) where rate is the product of every
    fail-slow factor whose window covers the segment. Cut points include
    all window boundaries inside (lo, hi), so each segment is entirely
    inside or outside each window."""
    pts = {lo, hi}
    for t0, t1, _ in windows:
        if lo < t0 < hi:
            pts.add(t0)
        if lo < t1 < hi:
            pts.add(t1)
    cuts = sorted(pts)
    for a, b in zip(cuts, cuts[1:]):
        f = 1.0
        for t0, t1, fac in windows:
            if t0 <= a and b <= t1:
                f *= fac
        yield a, b, f


def _work_done(windows: Sequence[Tuple[float, float, float]],
               t0: float, t1: float) -> float:
    """Service units a machine delivers over wall interval [t0, t1).
    With no fail-slow windows this is exactly `t1 - t0` (bit-identical
    to the pre-fail-slow wall-clock accounting)."""
    if t1 <= t0:
        return 0.0
    if not windows:
        return t1 - t0
    return sum(f * (b - a) for a, b, f in _rate_profile(windows, t0, t1))


def _finish_time(windows: Sequence[Tuple[float, float, float]],
                 start: float, work: float) -> float:
    """Wall-clock instant at which `work` service units started at
    `start` complete on a machine with the given fail-slow windows.
    Inverse of `_work_done`; exactly `start + work` when no window
    exists or all windows closed before `start`."""
    if not windows or start == _INF or work == _INF:
        return start + work
    hi = max(t1 for _, t1, _ in windows)
    if start >= hi:
        return start + work
    for a, b, f in _rate_profile(windows, start, hi):
        seg = f * (b - a)
        if work <= seg:
            return a + work / f
        work -= seg
    return hi + work


class _Pool:
    def __init__(self, tier: str, machines: int):
        if machines < 1:
            raise ValueError(f"{tier} pool needs >= 1 machine")
        self.tier = tier
        self.slots = [_Slot() for _ in range(machines)]
        # per-machine free times with every queued commitment dispatched —
        # the greedy policy's reserved view; refreshed by each replay
        self.reserved: List[float] = [0.0] * machines

    def capacity_integral(self, t_end: float) -> float:
        """Machine-seconds of SERVICE the pool could have delivered in
        [0, t_end]. Outage intervals may overlap (a crash can strike an
        already-down machine), so they are union-merged before
        subtracting; fail-slow windows then shave the forgone
        (1 - rate) fraction off every up segment they cover — the same
        union-merge treatment, so a window inside an outage is not
        double-subtracted (DESIGN.md §13)."""
        total = 0.0
        for s in self.slots:
            hi = min(s.retired_at if s.retired_at is not None else t_end,
                     t_end)
            span = max(0.0, hi - s.created)
            if span == 0.0:
                total += 0.0
                continue
            clipped = sorted(
                (max(d0, s.created), min(d1, hi))
                for d0, d1 in s.outages if min(d1, hi) > max(d0, s.created))
            merged: List[List[float]] = []
            for d0, d1 in clipped:
                if merged and d0 <= merged[-1][1]:
                    if d1 > merged[-1][1]:
                        merged[-1][1] = d1
                else:
                    merged.append([d0, d1])
            for d0, d1 in merged:
                span -= d1 - d0
            if s.slowdowns:
                for a, b, f in _rate_profile(s.slowdowns, s.created, hi):
                    if f >= 1.0:
                        continue
                    seg = b - a
                    for d0, d1 in merged:
                        ov = min(b, d1) - max(a, d0)
                        if ov > 0:
                            seg -= ov
                    span -= (1.0 - f) * max(0.0, seg)
            total += max(0.0, span)
        return total


@dataclass
class MetroResult:
    """One policy's run: verbatim committed schedules per ward, streaming
    metrics, exact per-tier utilisation, the deterministic event log, and
    the wall-clock throughput of the run. `trace` carries the flight
    recorder's `MetroTrace` when the run was traced (§15), `profile` the
    self-profiling summary dict when profiled — both None otherwise."""
    policy: str
    wards: List[Schedule]
    metrics: MetroMetrics
    utilization: Dict[str, float]
    event_log: List[tuple]
    events: int
    seconds: float
    trace: Optional[object] = None
    profile: Optional[dict] = None

    @property
    def events_per_s(self) -> float:
        return self.events / self.seconds if self.seconds > 0 else 0.0

    def summary(self) -> dict:
        out = self.metrics.summary(self.utilization)
        out.update(policy=self.policy, events=self.events,
                   seconds=self.seconds, events_per_s=self.events_per_s)
        return out


class MetroEngine:
    """See module docstring. One engine instance runs one policy over one
    set of ward traces; `run()` may be called once."""

    def __init__(self, ward_traces: Sequence[Sequence[JobSpec]],
                 policy: Policy, *,
                 machines_per_tier: Mapping[str, int] | None = None,
                 failures: Sequence[FailureEvent] = (),
                 scale_events: Sequence[ScaleEvent] = (),
                 network_events: Sequence[NetworkEvent] = (),
                 slowdowns: Sequence[SlowdownEvent] = (),
                 hedge_factor: Optional[float] = None,
                 retry_backoff: float = 0.0,
                 max_attempts: Union[int, Mapping[str, int], None] = None,
                 metrics: MetroMetrics | None = None):
        mpt = dict(machines_per_tier or {CC: 1, ES: 1})
        self.jobs: List[List[JobSpec]] = [list(t) for t in ward_traces]
        self.B = len(self.jobs)
        if self.B == 0:
            raise ValueError("metro engine needs at least one ward")
        self.policy = policy
        self.cloud = _Pool(CC, mpt.get(CC, 1))
        self.edges = [_Pool(ES, mpt.get(ES, 1)) for _ in range(self.B)]
        self.commits: List[List[Optional[_Commit]]] = [
            [None] * len(t) for t in self.jobs]
        self.finished: List[List[bool]] = [
            [False] * len(t) for t in self.jobs]
        self.pending: List[List[int]] = [[] for _ in range(self.B)]
        # per-job dispatch-loss count (crash kills); attempts = kills + 1
        self.kills: List[List[int]] = [[0] * len(t) for t in self.jobs]
        # hedge state: at most ONE backup attempt per job, ever — the
        # flag persists after resolution so a job is never re-hedged
        self.hedged: List[List[bool]] = [
            [False] * len(t) for t in self.jobs]
        self.hedges: Dict[Tuple[int, int], _Commit] = {}
        # jobs whose backup was promoted to THE commitment by a crash on
        # the primary: their eventual completion still scores as a hedge
        # win (the backup is the machine on the final schedule)
        self.promoted: Set[Tuple[int, int]] = set()
        self._hedge_fn = getattr(policy, "hedge", None)
        if hedge_factor is not None:
            if not hedge_factor > 1.0:
                raise ValueError(f"hedge_factor must be > 1 (a watchdog "
                                 f"at <= 1x proc would fire on healthy "
                                 f"runs), got {hedge_factor}")
            if self._hedge_fn is None:
                raise ValueError(
                    f"hedge_factor set but policy "
                    f"{getattr(policy, 'name', '?')!r} has no hedge() "
                    f"hook; wrap it in HedgingPolicy")
        self.hedge_factor = hedge_factor
        if retry_backoff < 0:
            raise ValueError(f"retry_backoff must be >= 0, "
                             f"got {retry_backoff}")
        self.retry_backoff = retry_backoff
        if isinstance(max_attempts, int):
            if max_attempts < 1:
                raise ValueError(f"max_attempts must be >= 1, "
                                 f"got {max_attempts}")
        elif max_attempts is not None:
            max_attempts = dict(max_attempts)
            bad = {k: v for k, v in max_attempts.items() if v < 1}
            if bad:
                raise ValueError(f"per-class max_attempts must be >= 1, "
                                 f"got {bad}")
        self.max_attempts = max_attempts
        # active degraded-network factors per shared tier
        self._net: Dict[str, List[float]] = {}
        self.metrics = metrics or MetroMetrics()
        self.event_log: List[tuple] = []
        self._heap: List[tuple] = []
        self._seq = 0
        self._events = 0
        self._t_end = 0.0
        self._ran = False
        # read-only invariant observer, attached by run(sanitize=True)
        self._san = None
        # read-only flight recorder / self-profiler, attached by
        # run(trace=True) / run(profile=True) — both None when off, so
        # the off path costs one attribute test per observation
        self._tracer = None
        self._prof = None
        for b, trace in enumerate(self.jobs):
            for i, job in enumerate(trace):
                self._push(job.release, _P_ARRIVE, ("arrive", b, i))
        for ev in failures:
            self._pool(ev.tier, ev.ward)      # validate tier/ward early
            self._push(ev.time, _P_FAIL, ("fail", ev))
        for ev in scale_events:
            self._pool(ev.tier, ev.ward)
            self._push(ev.time, _P_SCALE, ("scale", ev))
        for ev in slowdowns:
            self._pool(ev.tier, ev.ward)      # validate tier/ward early
            if not 0.0 < ev.factor < 1.0:
                raise ValueError(f"fail-slow factor must be in (0, 1) — "
                                 f"1 is healthy, 0 is a failure — "
                                 f"got {ev}")
            if not ev.duration > 0:
                raise ValueError(f"slowdown needs duration > 0, got {ev}")
            self._push(ev.time, _P_SLOW, ("slow", ev))
        for ev in network_events:
            if ev.tier not in (CC, ES):
                raise ValueError(f"network events degrade a shared tier's "
                                 f"uplink, got {ev.tier!r}")
            if not (ev.factor > 0 and ev.duration > 0):
                raise ValueError(f"network event needs factor > 0 and "
                                 f"duration > 0, got {ev}")
            self._push(ev.time, _P_NET, ("net", ev, True))
            self._push(ev.time + ev.duration, _P_NET, ("net", ev, False))

    # ------------------------------------------------------------ plumbing
    def _push(self, t: float, prio: int, payload: tuple) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (t, prio, self._seq, payload))

    def _log(self, rec: tuple) -> None:
        """Append one event-log record and mirror it to the flight
        recorder. The tracer only ever READS the record — the log bytes
        (and hence the run's CRC) are identical traced or not."""
        self.event_log.append(rec)
        if self._tracer is not None:
            self._tracer.on_log(rec)

    def _pool(self, tier: str, ward: Optional[int]) -> _Pool:
        if tier == CC:
            if ward is not None:
                raise ValueError("the cloud pool is shared: ward must be "
                                 "None for cloud fleet events")
            return self.cloud
        if tier == ES:
            if ward is None or not 0 <= ward < self.B:
                raise ValueError(f"edge fleet events need a ward in "
                                 f"[0, {self.B}), got {ward}")
            return self.edges[ward]
        raise ValueError(f"no machine pool on tier {tier!r}")

    def _pool_entries(self, pool: _Pool) -> List[
            Tuple[int, int, _Commit, bool]]:
        """Every attempt occupying `pool`: primary commitments plus live
        hedge backups, as (ward, index, commit, is_hedge). A backup is a
        first-class pool occupant — it queues, delays successors, and
        can be crash-killed like any commitment."""
        if pool.tier == CC:
            wards: Sequence[int] = range(self.B)
        else:
            wards = [self.edges.index(pool)]
        out = [(b, i, c, False) for b in wards
               for i, c in enumerate(self.commits[b])
               if c is not None and c.machine == pool.tier]
        ws = set(wards)
        out.extend((b, i, h, True) for (b, i), h in self.hedges.items()
                   if h.machine == pool.tier and b in ws)
        return out

    def _slot_frees(self, pool: _Pool, now: float) -> List[float]:
        """Per-slot next-free times from STARTED commitments + outages —
        what a replan at `now` may not dispatch before."""
        free = [max(s.down, 0.0) for s in pool.slots]
        for _, _, c, _ in self._pool_entries(pool):
            if c.start <= now and c.end > free[c.slot]:
                free[c.slot] = c.end
        return free

    def _busy_view(self, pool: _Pool, now: float) -> List[float]:
        """`busy_until` entries for the search policies: occupied-machine
        free times strictly beyond `now` (idle machines are implicit,
        matching `online._busy_vectors` / `machine_free_times`)."""
        return [f for f in self._slot_frees(pool, now) if f > now]

    def _watchdog(self, b: int, i: int, c: _Commit, now: float) -> None:
        """Arm the hedge watchdog for a (re)timed primary commitment:
        fires at `start + hedge_factor x proc` (elapsed-runtime trigger)
        or immediately at `start` when the committed end already misses
        the deadline (negative-slack trigger). Never armed when it could
        not fire before the committed end — a healthy run on a healthy
        machine completes first, so the heap stays quiet. Validated
        lazily on pop like completion events."""
        if self.hedge_factor is None:
            return
        if self.hedged[b][i] or (b, i) in self.hedges:
            return
        job = c.job
        t_w = c.start + self.hedge_factor * job.proc[c.machine]
        if c.end > job.release + job.deadline:
            t_w = c.start
        t_w = max(t_w, now)
        if t_w < c.end:
            self._push(t_w, _P_HEDGE, ("hedge", b, i, c.machine, c.start))

    def _attempt_cap(self, job: JobSpec) -> Optional[int]:
        cap = self.max_attempts
        if isinstance(cap, dict):
            return cap.get(job.workload)
        return cap

    def _elapsed_work(self, b: int, c: _Commit, now: float) -> float:
        """Service units a partially-run attempt consumed in
        [c.start, now) on its slot — wall seconds off fail-slow windows,
        scaled by the active rate inside them."""
        if c.machine == ED or c.slot < 0:
            return max(0.0, now - c.start)
        pool = self.cloud if c.machine == CC else self.edges[b]
        return _work_done(pool.slots[c.slot].slowdowns, c.start, now)

    # ------------------------------------------------------------- replay
    def _replay_pool(self, pool: _Pool, now: float) -> None:
        """Re-dispatch every unstarted commitment of one pool FIFO by
        (arrival, plan time, ward, index) over the slot free times —
        `simulate`'s C5 semantics with machine identity. Started jobs are
        untouched (C2); re-timed jobs get fresh completion events."""
        if self._prof is not None:
            _r0 = time.perf_counter()          # reprolint: disable=R002
        free = self._slot_frees(pool, now)
        queue = []
        for b, i, c, is_hedge in self._pool_entries(pool):
            if c.start > now:
                queue.append((max(now, c.arrival), c.planned_at, b, i,
                              is_hedge))
        queue.sort()
        heap = list(zip(free, range(len(free))))
        heapq.heapify(heap)
        for arr, _, b, i, is_hedge in queue:
            c = self.hedges[(b, i)] if is_hedge else self.commits[b][i]
            avail, k = heapq.heappop(heap)
            start = arr if arr > avail else avail
            end = _finish_time(pool.slots[k].slowdowns, start,
                               c.job.proc[pool.tier])
            if end == _INF:                          # pragma: no cover
                raise ValueError(f"{pool.tier} pool has no dispatchable "
                                 f"machine for {c.job.name}")
            heapq.heappush(heap, (end, k))
            if (start, end, k) != (c.start, c.end, c.slot):
                c.start, c.end, c.slot = start, end, k
                kind = "hcomplete" if is_hedge else "complete"
                self._push(end, _P_COMPLETE, (kind, b, i, end))
                if not is_hedge:
                    self._watchdog(b, i, c, now)
        pool.reserved = sorted(f for f, _ in heap)
        if self._prof is not None:
            self._prof.replay += (
                time.perf_counter() - _r0)     # reprolint: disable=R002
        if self._san is not None:
            if self._prof is not None:
                _s0 = time.perf_counter()      # reprolint: disable=R002
                self._san.check_pool(pool, now)
                self._prof.sanitize += (
                    time.perf_counter() - _s0)  # reprolint: disable=R002
            else:
                self._san.check_pool(pool, now)

    def _replay(self, now: float, edge_wards: Sequence[int] | None = None,
                cloud: bool = True) -> None:
        """Replay the pools an event could have touched: the shared cloud
        (any decision can move jobs on/off it) plus the edge pools of the
        decided/affected wards — never the B-1 untouched edge pools."""
        if cloud:
            self._replay_pool(self.cloud, now)
        for b in (range(self.B) if edge_wards is None else edge_wards):
            self._replay_pool(self.edges[b], now)

    # ------------------------------------------------------------ replans
    def _net_factor(self, tier: str) -> float:
        f = 1.0
        for x in self._net.get(tier, ()):
            f *= x
        return f

    def _shift_spec(self, job: JobSpec, commit: Optional[_Commit],
                    now: float) -> JobSpec:
        """`online._replan_spec` view, with active degraded-network
        factors applied to any shared tier the job would RE-ship to.
        The committed tier's remaining transmission stays untouched:
        that data is already in flight under its committed arrival."""
        spec = online._replan_spec(job, commit, now)
        if not self._net:
            return spec
        keep = commit.machine if commit is not None \
            and commit.machine in (CC, ES) else None
        trans = dict(spec.trans)
        changed = False
        for t in (CC, ES):
            f = self._net_factor(t)
            if f != 1.0 and t != keep and trans.get(t, 0.0) > 0.0:
                trans[t] = trans[t] * f
                changed = True
        return replace(spec, trans=trans) if changed else spec

    def _decide(self, wards: Sequence[int], now: float,
                fresh: Mapping[int, Sequence[int]] = ()) -> None:
        fresh = dict(fresh or {})
        cloud_busy = self._busy_view(self.cloud, now)
        # every ward's unstarted cloud commitments, shifted to `now`:
        # ward b's replan sees the other wards' entries as frozen
        # background (queue-active, immovable — DESIGN.md §9)
        cloud_queue: List[Tuple[int, int, JobSpec]] = []
        for c in range(self.B):
            for j, cm in enumerate(self.commits[c]):
                if cm is not None and cm.machine == CC and cm.start > now:
                    cloud_queue.append(
                        (c, j, self._shift_spec(self.jobs[c][j], cm, now)))
        # live backup attempts queue on the cloud too; they are immovable
        # for EVERY ward (their owner included), hence index -1 so they
        # land in the owner's background as well
        for (c, j), hm in self.hedges.items():
            if hm.machine == CC and hm.start > now:
                cloud_queue.append(
                    (c, -1, self._shift_spec(self.jobs[c][j], hm, now)))
        requests: List[ReplanRequest] = []
        for b in wards:
            movable = [i for i in self.pending[b]
                       if not self.finished[b][i]
                       and (self.commits[b][i] is None
                            or self.commits[b][i].start > now)]
            self.pending[b] = movable
            if not movable:
                continue
            shifted = [self._shift_spec(self.jobs[b][i],
                                        self.commits[b][i], now)
                       for i in movable]
            new = set(fresh.get(b, ()))
            mov = set(movable)
            requests.append(ReplanRequest(
                ward=b, movable=movable, shifted=shifted,
                current=[None if self.commits[b][i] is None
                         else self.commits[b][i].machine for i in movable],
                fresh=[p for p, i in enumerate(movable) if i in new],
                busy={CC: list(cloud_busy),
                      ES: self._busy_view(self.edges[b], now)},
                reserved={CC: list(self.cloud.reserved),
                          ES: list(self.edges[b].reserved)},
                machines_per_tier={CC: len(self.cloud.slots),
                                   ES: len(self.edges[b].slots)},
                background=[spec for c, j, spec in cloud_queue
                            if c != b or j not in mov]))
        if requests:
            if self._prof is not None:
                _p0 = time.perf_counter()      # reprolint: disable=R002
                decisions = self.policy.decide(requests, now)
                self._prof.policy += (
                    time.perf_counter() - _p0)  # reprolint: disable=R002
                self._prof.decide_calls += 1
            else:
                decisions = self.policy.decide(requests, now)
            if len(decisions) != len(requests):
                raise ValueError(f"policy returned {len(decisions)} plans "
                                 f"for {len(requests)} wards")
            for req, tiers in zip(requests, decisions):
                if len(tiers) != len(req.movable):
                    raise ValueError(
                        f"ward {req.ward}: {len(tiers)} tiers for "
                        f"{len(req.movable)} movable jobs")
                bad = sorted(set(t for t in tiers if t not in _DECISIONS))
                if bad:
                    raise ValueError(
                        f"ward {req.ward}: policy returned unknown "
                        f"decisions {bad}; expected a tier in "
                        f"{sorted(_DECISIONS - {SHED})} or {SHED!r}")
                for pos, i in enumerate(req.movable):
                    if tiers[pos] == SHED:
                        self._shed(req.ward, i, now)
                    else:
                        self._commit(req.ward, i, req.shifted[pos],
                                     tiers[pos], now)
        self._replay(now, edge_wards=[req.ward for req in requests])

    def _shed(self, b: int, i: int, now: float) -> None:
        """Drop a movable job on a SHED decision: finished-missed with an
        explicit `shed` event, never dispatched (DESIGN.md §11)."""
        job = self.jobs[b][i]
        self.finished[b][i] = True
        self.commits[b][i] = None
        self.metrics.record_shed(now, job.workload, job.weight)
        self._log(("shed", now, b, i, job.name))
        if self._san is not None:
            self._san.on_terminal(b, i, "shed")

    def _commit(self, b: int, i: int, shifted: JobSpec, tier: str,
                now: float) -> None:
        job = self.jobs[b][i]
        arrival = now + shifted.trans.get(tier, 0.0)
        if self._tracer is not None:
            self._tracer.on_commit(now, b, i, tier, arrival)
        if tier == ED:
            # private device: no queue, times final at commitment (C4)
            end = arrival + job.proc[ED]
            old = self.commits[b][i]
            if old is None or (old.machine, old.end) != (ED, end):
                self._push(end, _P_COMPLETE, ("complete", b, i, end))
            self.commits[b][i] = _Commit(job, ED, arrival, arrival, end,
                                         slot=-1, planned_at=now)
            # device runs never stretch, so only the negative-slack
            # trigger can arm here (projected deadline miss at commit)
            self._watchdog(b, i, self.commits[b][i], now)
            return
        # shared tiers (decision already validated in _decide): the replay
        # assigns slot and times (start > now placeholder keeps it in the
        # unstarted set)
        self.commits[b][i] = _Commit(job, tier, arrival, _INF, _INF,
                                     slot=-1, planned_at=now)

    # ------------------------------------------------------------- events
    def _on_arrive(self, now: float, b: int, i: int) -> None:
        self.pending[b].append(i)
        self._log(("arrive", now, b, i, self.jobs[b][i].name))
        wards = range(self.B) if self.policy.joint else [b]
        self._decide(wards, now, fresh={b: [i]})

    def _on_complete(self, now: float, b: int, i: int, end: float) -> None:
        c = self.commits[b][i]
        if c is None or self.finished[b][i] or c.end != end or \
                c.start > now:
            return                                   # stale (re-timed) event
        self._finish(now, b, i, c, hedge_win=False)

    def _on_hcomplete(self, now: float, b: int, i: int,
                      end: float) -> None:
        """A backup attempt finished first: promote it to THE commitment
        (the final schedule shows the winner), cancel the losing primary
        at this instant, and score the completion as a hedge win."""
        h = self.hedges.get((b, i))
        if h is None or self.finished[b][i] or h.end != end or \
                h.start > now:
            return                                   # stale (re-timed) event
        loser = self.commits[b][i]
        del self.hedges[(b, i)]
        self.commits[b][i] = h
        if loser is not None:                        # pragma: no branch
            self._cancel(now, b, i, loser, role="primary")
        self._finish(now, b, i, h, hedge_win=True)

    def _finish(self, now: float, b: int, i: int, c: _Commit,
                hedge_win: bool) -> None:
        self.finished[b][i] = True
        other = self.hedges.pop((b, i), None)
        if other is not None:
            # primary won the race: cancel the backup deterministically
            # at the winner's completion instant
            self._cancel(now, b, i, other)
        job = c.job
        response = c.end - job.release
        self.metrics.record(now, job.workload, response, job.deadline,
                            c.machine, job.proc[c.machine],
                            attempts=self.kills[b][i] + 1,
                            weight=job.weight,
                            hedged=self.hedged[b][i],
                            hedge_win=hedge_win or
                            (b, i) in self.promoted)
        self._log(
            ("complete", now, b, i, c.machine, c.start, c.end, response,
             int(response > job.deadline), self.kills[b][i] + 1))
        if self._san is not None:
            self._san.on_terminal(b, i, "complete")
        if self._tracer is not None:
            self._tracer.on_finish(now, b, i, c, hedge_win)

    def _cancel(self, now: float, b: int, i: int, loser: _Commit,
                role: str = "backup") -> None:
        """Deterministic cancellation rule (DESIGN.md §13): the losing
        attempt is cut at the WINNER's completion instant — never
        earlier, never by wall clock — its consumed service units are
        recorded as hedge waste, and its pool is replayed so queued
        successors reclaim the freed machine-seconds immediately.
        `role` names which side of the race lost (tracing only)."""
        wasted = self._elapsed_work(b, loser, now) \
            if loser.start <= now else 0.0
        if self._tracer is not None:
            self._tracer.on_hedge_cancel(now, b, i, loser, wasted, role)
        self.metrics.record_hedge_cancel(loser.machine, wasted)
        self._log(
            ("hedge_cancel", now, b, i, loser.machine, wasted))
        if loser.machine != ED:
            self._replay(now, edge_wards=[b] if loser.machine == ES
                         else (), cloud=loser.machine == CC)

    def _strike(self, pool: _Pool, now: float,
                latest: bool = False) -> Optional[int]:
        """Non-retired machine a fleet event takes: the earliest-free one
        for drains/scale-downs, the LATEST-free (busiest) one for crash
        failures (`latest=True` — a crash that spared the idlest machine
        would rarely kill anything). None when the pool has none left."""
        cand = [(f, k) for k, (f, s) in enumerate(
            zip(self._slot_frees(pool, now), pool.slots))
            if s.retired_at is None]
        if not cand:
            return None
        return (max(cand) if latest else min(cand))[1]

    def _on_fail(self, now: float, ev: FailureEvent) -> None:
        pool = self._pool(ev.tier, ev.ward)
        k = self._strike(pool, now, latest=ev.kill_running)
        ward_key = -1 if ev.ward is None else ev.ward
        kill_flag = int(ev.kill_running)
        if k is None:                      # every machine already retired
            self._log(("fail", now, ev.tier, ward_key, -1,
                                   now, kill_flag))
            return
        slot = pool.slots[k]
        killed: List[Tuple[int, int, _Commit, bool]] = []
        if ev.kill_running:
            # crash: the machine dies NOW; its in-flight attempt is lost
            base = now
            killed = [(b, i, c, is_hedge)
                      for b, i, c, is_hedge in self._pool_entries(pool)
                      if not self.finished[b][i] and c.slot == k
                      and c.start <= now < c.end]
        else:
            # drain: the machine finishes its running job first
            base = max(self._slot_frees(pool, now)[k], now)
        down_until = base + ev.duration
        slot.down = max(slot.down, down_until)
        slot.outages.append((base, down_until))
        self._log(("fail", now, ev.tier, ward_key, k,
                               down_until, kill_flag))
        fresh: Dict[int, List[int]] = {}
        for b, i, c, is_hedge in killed:
            wasted = self._elapsed_work(b, c, now)
            if is_hedge:
                # the crash took the backup attempt: the primary still
                # runs, so this is a cancellation, not a job loss
                del self.hedges[(b, i)]
                if self._tracer is not None:
                    self._tracer.on_hedge_cancel(now, b, i, c, wasted,
                                                 "backup")
                self.metrics.record_hedge_cancel(ev.tier, wasted)
                self._log(
                    ("hedge_cancel", now, b, i, ev.tier, wasted))
                continue
            self.kills[b][i] += 1
            self.metrics.record_kill(ev.tier, wasted)
            self._log(("kill", now, b, i, ev.tier, k, wasted,
                                   self.kills[b][i]))
            if self._tracer is not None:
                self._tracer.on_kill(now, b, i, c, wasted)
            backup = self.hedges.pop((b, i), None)
            if backup is not None:
                # the backup attempt survives the crash: promote it to
                # THE commitment — no re-decision, the race is resolved
                self.commits[b][i] = backup
                if backup.end < _INF:        # pragma: no branch
                    self._push(backup.end, _P_COMPLETE,
                               ("complete", b, i, backup.end))
                self._log(
                    ("hedge_promote", now, b, i, backup.machine))
                self.promoted.add((b, i))
                continue
            self.commits[b][i] = None
            cap = self._attempt_cap(c.job)
            if cap is not None and self.kills[b][i] + 1 > cap:
                # retries exhausted: shed-with-record, never another
                # dispatch (bounds crash-wave retry storms)
                self.finished[b][i] = True
                self.metrics.record_shed(now, c.job.workload,
                                         c.job.weight, exhausted=True)
                self._log(("giveup", now, b, i, c.job.name,
                                       self.kills[b][i]))
                if self._san is not None:
                    self._san.on_terminal(b, i, "giveup")
                continue
            if self.retry_backoff > 0.0:
                # exponential backoff: attempt n re-decides after
                # backoff * 2^(n-2), not in the crash instant
                delay = self.retry_backoff * (2.0 ** (self.kills[b][i]
                                                      - 1))
                self._push(now + delay, _P_ARRIVE, ("retry", b, i))
                continue
            if i not in self.pending[b]:
                self.pending[b].append(i)
            fresh.setdefault(b, []).append(i)
        self._push(down_until, _P_RECOVER, ("recover", ev.tier, ev.ward))
        self._after_fleet_event(ev.tier, ev.ward, now, fresh=fresh)

    def _on_retry(self, now: float, b: int, i: int) -> None:
        """A backed-off crash retry matures: the job re-enters the
        normal decision path as a fresh arrival."""
        if self.finished[b][i] or self.commits[b][i] is not None:
            return                               # pragma: no cover (safety)
        self._log(("retry", now, b, i, self.kills[b][i] + 1))
        if i not in self.pending[b]:
            self.pending[b].append(i)
        wards = range(self.B) if self.policy.joint else [b]
        self._decide(wards, now, fresh={b: [i]})

    def _on_slow(self, now: float, ev: SlowdownEvent) -> None:
        """A fail-slow window opens on the busiest machine: record the
        window, stretch the in-flight attempt's completion through the
        new rate profile (placement stays, C2), re-arm its watchdog, and
        replay so queued successors inherit the delay."""
        pool = self._pool(ev.tier, ev.ward)
        k = self._strike(pool, now, latest=True)
        ward_key = -1 if ev.ward is None else ev.ward
        until = now + ev.duration
        if k is None:                      # every machine already retired
            self._log(("slow", now, ev.tier, ward_key, -1,
                                   until, ev.factor))
            return
        slot = pool.slots[k]
        slot.slowdowns.append((now, until, ev.factor))
        self._log(("slow", now, ev.tier, ward_key, k, until,
                               ev.factor))
        for b, i, c, is_hedge in self._pool_entries(pool):
            if self.finished[b][i] or c.slot != k or \
                    not c.start <= now < c.end:
                continue
            end = _finish_time(slot.slowdowns, c.start,
                               c.job.proc[pool.tier])
            if end != c.end:
                c.end = end
                kind = "hcomplete" if is_hedge else "complete"
                self._push(end, _P_COMPLETE, (kind, b, i, end))
                if not is_hedge:
                    self._watchdog(b, i, c, now)
        self._push(until, _P_SLOWEND, ("slowend", ev.tier, ev.ward))
        self._after_fleet_event(ev.tier, ev.ward, now)

    def _on_slowend(self, now: float, tier: str,
                    ward: Optional[int]) -> None:
        """A fail-slow window closes. Timing needs no update — every
        commitment's end already prices the full window — but replanning
        policies get the same revisit hook a recovery grants."""
        self._log(("slowend", now, tier,
                               -1 if ward is None else ward))
        self._after_fleet_event(tier, ward, now)

    def _on_hedge(self, now: float, b: int, i: int, machine: str,
                  start: float) -> None:
        """The watchdog fired for a still-running primary: ask the
        policy's hedge() hook for a backup tier and, if granted,
        dispatch the backup attempt through the normal pool machinery.
        First completion wins; the loser is cancelled at that instant."""
        if self.finished[b][i] or self.hedged[b][i] or \
                (b, i) in self.hedges:
            return
        c = self.commits[b][i]
        if c is None or (c.machine, c.start) != (machine, start) or \
                not c.start <= now < c.end:
            return                               # stale watchdog
        job = c.job
        spec = self._shift_spec(job, None, now)
        req = HedgeRequest(
            ward=b, job=spec, tier=c.machine, projected_end=c.end,
            busy={CC: self._busy_view(self.cloud, now),
                  ES: self._busy_view(self.edges[b], now)},
            reserved={CC: list(self.cloud.reserved),
                      ES: list(self.edges[b].reserved)},
            machines_per_tier={CC: len(self.cloud.slots),
                               ES: len(self.edges[b].slots)})
        if self._prof is not None:
            _h0 = time.perf_counter()          # reprolint: disable=R002
            t = self._hedge_fn(req, now)
            self._prof.hedge_hook += (
                time.perf_counter() - _h0)     # reprolint: disable=R002
        else:
            t = self._hedge_fn(req, now)
        if t is None:
            return
        if t not in _DECISIONS - {SHED} or t == c.machine:
            raise ValueError(
                f"hedge policy returned {t!r}; expected a tier in "
                f"{sorted(_DECISIONS - {SHED})} other than the committed "
                f"{c.machine!r}, or None")
        self.hedged[b][i] = True
        self.metrics.record_hedge(t)
        self._log(("hedge", now, b, i, c.machine, t))
        if self._san is not None:
            self._san.on_hedge(b, i)
        arrival = now + spec.trans.get(t, 0.0)
        if t == ED:
            end = arrival + job.proc[ED]
            self.hedges[(b, i)] = _Commit(job, ED, arrival, arrival, end,
                                          slot=-1, planned_at=now)
            self._push(end, _P_COMPLETE, ("hcomplete", b, i, end))
        else:
            self.hedges[(b, i)] = _Commit(job, t, arrival, _INF, _INF,
                                          slot=-1, planned_at=now)
            self._replay(now, edge_wards=[b] if t == ES else (),
                         cloud=t == CC)
        if self._tracer is not None:
            self._tracer.on_hedge_dispatch(now, b, i, self.hedges[(b, i)])

    def _on_recover(self, now: float, tier: str,
                    ward: Optional[int]) -> None:
        self._log(("recover", now, tier,
                               -1 if ward is None else ward))
        self._after_fleet_event(tier, ward, now)

    def _on_scale(self, now: float, ev: ScaleEvent) -> None:
        pool = self._pool(ev.tier, ev.ward)
        if ev.delta == 0:
            raise ValueError("scale event with delta 0")
        if ev.delta > 0:
            for _ in range(ev.delta):
                pool.slots.append(_Slot(created=now))
        else:
            active = sum(1 for s in pool.slots if s.retired_at is None)
            if active + ev.delta < 1:
                raise ValueError(f"scale-down to {active + ev.delta} "
                                 f"machines on {ev.tier} at t={now}; a "
                                 f"pool keeps >= 1")
            for _ in range(-ev.delta):
                k = self._strike(pool, now)
                slot = pool.slots[k]
                slot.retired_at = max(self._slot_frees(pool, now)[k], now)
                slot.down = _INF
        self._log(("scale", now, ev.tier,
                               -1 if ev.ward is None else ev.ward,
                               ev.delta))
        self._after_fleet_event(ev.tier, ev.ward, now)

    def _after_fleet_event(self, tier: str, ward: Optional[int],
                           now: float,
                           fresh: Mapping[int, Sequence[int]] | None = None
                           ) -> None:
        """Capacity changed: replanning policies revisit every affected
        ward (all of them for the shared cloud — the matching-event-count
        batched replan); commit-and-hold policies just re-time. Crash
        kills pass `fresh` — those jobs lost their commitment and MUST be
        re-decided (through the normal decision path, as fresh arrivals)
        even by commit-and-hold policies. The replay runs first so the
        reserved views price the post-event fleet; started-occupancy busy
        views are replay-invariant, preserving the B=1 tabu parity."""
        if tier == CC:
            self._replay(now, edge_wards=())
        else:
            self._replay(now, edge_wards=[ward], cloud=False)
        fresh = dict(fresh or {})
        if self.policy.replans_on_fleet_events:
            affected = list(range(self.B)) \
                if tier == CC or self.policy.joint else [ward]
            self._decide(affected, now, fresh=fresh)
        elif fresh:
            self._decide(sorted(fresh), now, fresh=fresh)

    def _on_net(self, now: float, ev: NetworkEvent, on: bool) -> None:
        """A degraded-network window opens/closes: update the active
        factor set, log, and let replanning policies re-price movable
        jobs under the new uplink (commitments keep their arrivals —
        nothing already shipped is re-timed)."""
        factors = self._net.setdefault(ev.tier, [])
        if on:
            factors.append(ev.factor)
        else:
            factors.remove(ev.factor)
            if not factors:
                del self._net[ev.tier]
        self._log(("net", now, ev.tier, ev.factor, int(on)))
        if self.policy.replans_on_fleet_events:
            self._decide(range(self.B), now)

    # ---------------------------------------------------------------- run
    def run(self, sanitize: bool = False, trace: bool = False,
            profile: bool = False) -> MetroResult:
        """Drain the event heap. ``sanitize=True`` attaches the
        read-only `MetroSanitizer` (DESIGN.md §14): every replay,
        terminal event and hedge dispatch is validated against the
        engine invariants I1–I7 and a `SanitizerViolation` is raised on
        the first breach. ``trace=True`` attaches the flight recorder
        (`MetroTracer`, DESIGN.md §15): per-job spans and deadline-miss
        attribution land on ``MetroResult.trace``. ``profile=True`` arms
        the self-profiler: wall-clock phase timers (replay / policy /
        sanitizer / hedge hook / per-event-kind handlers) plus the
        number of batched device searches the run made
        (``device_searches``) land on ``MetroResult.profile``.
        All three observers are read-only — they never mutate state,
        push events or touch the event log, so armed runs hash
        bit-identically to bare ones."""
        if self._ran:
            raise ValueError("a MetroEngine instance runs once; build a "
                             "fresh one per policy")
        self._ran = True
        if sanitize:
            from repro_torch.metro.sanitizer import MetroSanitizer
            self._san = MetroSanitizer(self)
        if trace:
            from repro_torch.metro.tracing import MetroTracer
            self._tracer = MetroTracer(self)
        if profile:
            from repro_torch.core.scheduler_torch import \
                tabu_search_batched
            from repro_torch.metro.tracing import EngineProfile
            self._prof = EngineProfile(
                searches_before=tabu_search_batched.calls)
        prof = self._prof
        # bench-timing block: measures wall-clock THROUGHPUT of the run;
        # simulated time lives only in the event heap
        t0 = time.perf_counter()        # reprolint: disable=R002
        while self._heap:
            t, prio, _, payload = heapq.heappop(self._heap)
            if self._san is not None:
                self._san.on_event(t, payload)
            self._t_end = max(self._t_end, t)
            self._events += 1
            kind = payload[0]
            if prof is not None:
                _h0 = time.perf_counter()      # reprolint: disable=R002
            if kind == "complete":
                self._on_complete(t, *payload[1:])
            elif kind == "hcomplete":
                self._on_hcomplete(t, *payload[1:])
            elif kind == "arrive":
                self._on_arrive(t, *payload[1:])
            elif kind == "retry":
                self._on_retry(t, *payload[1:])
            elif kind == "fail":
                self._on_fail(t, payload[1])
            elif kind == "slow":
                self._on_slow(t, payload[1])
            elif kind == "slowend":
                self._on_slowend(t, *payload[1:])
            elif kind == "scale":
                self._on_scale(t, payload[1])
            elif kind == "net":
                self._on_net(t, *payload[1:])
            elif kind == "hedge":
                self._on_hedge(t, *payload[1:])
            else:
                self._on_recover(t, *payload[1:])
            if prof is not None:
                prof.add_handler(
                    kind,
                    time.perf_counter() - _h0)  # reprolint: disable=R002
        seconds = time.perf_counter() - t0   # reprolint: disable=R002

        if self._san is not None:
            self._san.at_exit(self._t_end)
        # close the in-progress metrics window so short runs report a
        # populated windowed snapshot (the §10 flush fix)
        self.metrics.flush()
        for b, flags in enumerate(self.finished):
            missing = [i for i, ok in enumerate(flags) if not ok]
            if missing:
                raise ValueError(f"ward {b}: jobs neither completed nor "
                                 f"shed: {missing[:5]} (event bug)")
        wards = []
        for b in range(self.B):
            # shed jobs have no commitment — the schedule holds only the
            # jobs that actually ran
            entries = [ScheduledJob(c.job, c.machine, c.arrival, c.start,
                                    c.end) for c in self.commits[b]
                       if c is not None]
            wards.append(Schedule(
                entries=entries,
                weighted_sum=sum(e.job.weight * e.response
                                 for e in entries),
                unweighted_sum=sum(e.response for e in entries),
                last_end=max((e.end for e in entries), default=0.0)))
        trace_obj = None
        if self._tracer is not None:
            trace_obj = self._tracer.finish()
        prof_out = None
        if prof is not None:
            from repro_torch.core.scheduler_torch import \
                tabu_search_batched
            prof.heap_pushes = self._seq
            prof_out = prof.summary(
                seconds, self._events,
                searches_after=tabu_search_batched.calls)
        return MetroResult(policy=getattr(self.policy, "name", "?"),
                           wards=wards, metrics=self.metrics,
                           utilization=self._utilization(),
                           event_log=self.event_log, events=self._events,
                           seconds=seconds, trace=trace_obj,
                           profile=prof_out)

    def _utilization(self) -> Dict[str, float]:
        t_end = self._t_end
        busy = self.metrics.busy_time
        cloud_cap = self.cloud.capacity_integral(t_end)
        edge_cap = sum(p.capacity_integral(t_end) for p in self.edges)
        out = {}
        if cloud_cap > 0:
            out["cloud"] = busy.get(CC, 0.0) / cloud_cap
        if edge_cap > 0:
            out["edge"] = busy.get(ES, 0.0) / edge_cap
        if t_end > 0:
            # devices are private/unbounded: report mean concurrency
            out["device_concurrency"] = busy.get(ED, 0.0) / t_end
        return out


def simulate_metro(ward_traces: Sequence[Sequence[JobSpec]],
                   policy: Policy, *,
                   machines_per_tier: Mapping[str, int] | None = None,
                   failures: Sequence[FailureEvent] = (),
                   scale_events: Sequence[ScaleEvent] = (),
                   network_events: Sequence[NetworkEvent] = (),
                   slowdowns: Sequence[SlowdownEvent] = (),
                   hedge_factor: Optional[float] = None,
                   retry_backoff: float = 0.0,
                   max_attempts: Union[int, Mapping[str, int],
                                       None] = None,
                   metrics: MetroMetrics | None = None,
                   sanitize: bool = False,
                   trace: bool = False,
                   profile: bool = False) -> MetroResult:
    """Build-and-run convenience wrapper (one engine per policy run)."""
    return MetroEngine(ward_traces, policy,
                       machines_per_tier=machines_per_tier,
                       failures=failures, scale_events=scale_events,
                       network_events=network_events,
                       slowdowns=slowdowns, hedge_factor=hedge_factor,
                       retry_backoff=retry_backoff,
                       max_attempts=max_attempts,
                       metrics=metrics).run(sanitize=sanitize,
                                            trace=trace, profile=profile)
