"""Patient-episode traffic generators for the metro engine (DESIGN.md §10).

A patient EPISODE is the paper's three-app cascade in clinical order —
short-of-breath alert, then the phenotype classification it triggers,
then the life-death threat assessment — released as a correlated burst
(each stage follows the previous by a small random lag). Episode start
times come from a nonhomogeneous Poisson process whose intensity carries
a diurnal swing plus optional mass-casualty surge windows; sampling is by
thinning, so a given `rng` yields a bit-identical trace.

Costs reuse `problems.metro_costs` (the Table VI metro regime the §9
contention benchmark is built on) scaled per stage: the life-death model
is tiny (paper Table IV: 7.5k FLOPs), the phenotype classifier heavy
(347k). Deadlines are per-workload-class response budgets carried on
`JobSpec.deadline`; one trace time unit reads as one minute.

Also provides the fleet-event streams the engine consumes — Poisson
machine failures (drain or crash mode) with repair times, degraded-
network windows, fail-slow slowdown windows, surge-following elastic
scale events — and the seeded chaos scenario-pack registry
(`SCENARIO_PACKS` / `make_scenario`): named (traces, failures, scales,
network, slowdowns) bundles that serve, the benchmarks and the
per-scenario regression floors all share, so a pack name plus a seed
pins one bit-identical chaos run (DESIGN.md §11).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.problems import metro_costs
from repro_torch.core.simulator import JobSpec
from repro_torch.core.tiers import CC, ES
from repro_torch.metro.engine import (FailureEvent, NetworkEvent, ScaleEvent,
                                SlowdownEvent)

DAY = 1440.0                      # minutes


@dataclass(frozen=True)
class EpisodeStage:
    """One app of the episode cascade: who it is, how urgent, how big."""
    workload: str                 # ICULSTMConfig name (serving engine key)
    short: str                    # job-name suffix
    weight: float                 # paper Table IV priority
    deadline: float               # response SLA budget (time units)
    cost_scale: float             # metro_costs scale (FLOPs-proportional)
    lag: Tuple[float, float]      # uniform delay after the previous stage


# Paper Table IV: alerts w=2 (105k FLOPs), phenotype w=1 (347k),
# life-death w=2 (7.5k). Deadlines tighten with clinical urgency.
EPISODE_STAGES: Tuple[EpisodeStage, ...] = (
    EpisodeStage("short-of-breath-alerts", "alert",
                 weight=2.0, deadline=35.0, cost_scale=0.6,
                 lag=(0.0, 0.0)),
    EpisodeStage("patient-phenotype-classification", "phenotype",
                 weight=1.0, deadline=120.0, cost_scale=1.4,
                 lag=(0.5, 2.0)),
    EpisodeStage("life-death-prediction", "threat",
                 weight=2.0, deadline=18.0, cost_scale=0.25,
                 lag=(0.5, 2.0)),
)


def intensity(t: float, base_rate: float, *, diurnal_amp: float = 0.5,
              day_offset: float = 8 * 60.0,
              surges: Sequence[Tuple[float, float, float]] = ()) -> float:
    """Episode arrival intensity at trace time t (episodes per unit).

    Diurnal swing peaks six hours after `day_offset` (start-of-trace
    clock time); each surge (t0, t1, boost) multiplies the rate by
    1 + boost inside its window — the ER mass-casualty regime."""
    lam = base_rate * (1.0 + diurnal_amp
                       * math.sin(2.0 * math.pi * (t + day_offset) / DAY))
    for t0, t1, boost in surges:
        if t0 <= t < t1:
            lam *= 1.0 + boost
    return max(lam, 0.0)


def episode_times(rng: np.random.Generator, horizon: float,
                  base_rate: float, **kw) -> List[float]:
    """Nonhomogeneous Poisson episode starts in [0, horizon) by thinning."""
    surges = kw.get("surges", ())
    # envelope over ALL surge windows at once: intensity() multiplies the
    # (1 + boost) factors of every window containing t, so overlapping
    # windows compound — the product is the only sound thinning bound
    boost = 1.0
    for _, _, b in surges:
        boost *= 1.0 + b
    lam_max = base_rate * (1.0 + kw.get("diurnal_amp", 0.5)) * boost
    if lam_max <= 0:
        raise ValueError(f"nonpositive peak intensity {lam_max}")
    out, t = [], 0.0
    while True:
        t += float(rng.exponential(1.0 / lam_max))
        if t >= horizon:
            return out
        if float(rng.uniform()) * lam_max <= intensity(t, base_rate, **kw):
            out.append(t)


def ward_trace(rng: np.random.Generator, ward: int, horizon: float, *,
               base_rate: float = 0.15, diurnal_amp: float = 0.5,
               day_offset: float = 8 * 60.0,
               surges: Sequence[Tuple[float, float, float]] = (),
               stages: Sequence[EpisodeStage] = EPISODE_STAGES
               ) -> List[JobSpec]:
    """One ward's job stream: every episode expands into the staged
    cascade (stages releasing past `horizon` still emit — an admitted
    patient is followed to the end). Sorted by release; stable job
    naming (`w<ward>p<episode>-<stage>`) keys the event log."""
    jobs: List[JobSpec] = []
    for ep, t0 in enumerate(episode_times(
            rng, horizon, base_rate, diurnal_amp=diurnal_amp,
            day_offset=day_offset, surges=surges)):
        t = t0
        for stage in stages:
            lo, hi = stage.lag
            t += float(rng.uniform(lo, hi)) if hi > lo else lo
            proc, trans = metro_costs(rng, scale=stage.cost_scale)
            jobs.append(JobSpec(
                name=f"w{ward}p{ep}-{stage.short}", release=t,
                weight=stage.weight, proc=proc, trans=trans,
                workload=stage.workload, deadline=stage.deadline))
    jobs.sort(key=lambda j: (j.release, j.name))
    return jobs


def metro_traces(rng: np.random.Generator, wards: int, horizon: float,
                 **kw) -> List[List[JobSpec]]:
    """Per-ward traces off one rng stream (ward draws are sequential, so
    the whole fleet's traffic is one seed)."""
    return [ward_trace(rng, b, horizon, **kw) for b in range(wards)]


def failure_events(rng: np.random.Generator, horizon: float, *,
                   tier: str = CC, ward: int | None = None,
                   mtbf: float = 60.0,
                   mttr: Tuple[float, float] = (8.0, 20.0),
                   kill_running: bool = False,
                   window: Tuple[float, float] | None = None
                   ) -> List[FailureEvent]:
    """Poisson machine failures on one pool: exponential inter-failure
    times (`mtbf`), uniform repair durations (`mttr`). Cloud failures
    (ward=None) hit the shared pool and so replan every ward at one
    event count — the batched-replan trigger (DESIGN.md §10).
    `kill_running=True` makes them crashes (in-flight job lost and
    retried, DESIGN.md §11); `window=(t0, t1)` confines the process to
    one chaos window instead of the whole [0, horizon)."""
    lo, hi = window if window is not None else (0.0, horizon)
    out, t = [], lo
    while True:
        t += float(rng.exponential(mtbf))
        if t >= hi:
            return out
        out.append(FailureEvent(time=t, tier=tier, ward=ward,
                                duration=float(rng.uniform(*mttr)),
                                kill_running=kill_running))


def network_events(rng: np.random.Generator, horizon: float, *,
                   tier: str = CC, windows: int = 2,
                   duration: Tuple[float, float] = (10.0, 25.0),
                   factor: Tuple[float, float] = (2.0, 5.0)
                   ) -> List[NetworkEvent]:
    """`windows` degraded-uplink windows on one shared tier: starts
    uniform over the horizon (sorted), durations and slowdown factors
    uniform over their ranges. Windows may overlap — the engine
    compounds their factors."""
    starts = sorted(float(rng.uniform(0.0, 0.85 * horizon))
                    for _ in range(windows))
    return [NetworkEvent(time=t, tier=tier,
                         duration=float(rng.uniform(*duration)),
                         factor=float(rng.uniform(*factor)))
            for t in starts]


def slowdown_events(rng: np.random.Generator, horizon: float, *,
                    tier: str = CC, ward: int | None = None,
                    windows: int = 3,
                    duration: Tuple[float, float] = (10.0, 25.0),
                    factor: Tuple[float, float] = (0.15, 0.4),
                    span: Tuple[float, float] | None = None
                    ) -> List[SlowdownEvent]:
    """`windows` fail-slow windows on one pool: starts uniform over the
    (optionally confined) span, durations and rate factors uniform over
    their ranges. Each strikes the busiest machine at its onset;
    overlapping windows on one machine compound (DESIGN.md §13)."""
    lo, hi = span if span is not None else (0.0, 0.85 * horizon)
    starts = sorted(float(rng.uniform(lo, hi)) for _ in range(windows))
    return [SlowdownEvent(time=t, tier=tier, ward=ward,
                          duration=float(rng.uniform(*duration)),
                          factor=float(rng.uniform(*factor)))
            for t in starts]


def default_scenario(seed: int, wards: int = 4, horizon: float = 120.0, *,
                     base_rate: float = 0.12,
                     surges: Sequence[Tuple[float, float, float]] | None
                     = None,
                     mtbf: float = 35.0, elastic: bool = True):
    """The canonical metro benchmark scenario (serve --metro and
    benchmarks/scheduler_scale.py share it): `wards` wards at a diurnal
    base rate with one mid-run mass-casualty surge, Poisson cloud
    machine failures, and elastic cloud capacity tracking the surge.
    -> (ward_traces, failure_events, scale_events)."""
    if surges is None:
        surges = ((0.375 * horizon, 0.625 * horizon, 3.0),)
    tr = metro_traces(np.random.default_rng(seed), wards, horizon,
                      base_rate=base_rate, surges=surges)
    fails = failure_events(np.random.default_rng(seed + 1), horizon,
                           mtbf=mtbf)
    scales = surge_scale_events(surges) if elastic else []
    return tr, fails, scales


def surge_scale_events(surges: Sequence[Tuple[float, float, float]], *,
                       tier: str = CC, machines: int = 1
                       ) -> List[ScaleEvent]:
    """Elastic capacity tracking the surge windows: +machines at each
    surge start, -machines at its end (the scaled-down servers retire
    once their running job drains)."""
    out: List[ScaleEvent] = []
    for t0, t1, _ in surges:
        out.append(ScaleEvent(time=t0, tier=tier, ward=None,
                              delta=machines))
        out.append(ScaleEvent(time=t1, tier=tier, ward=None,
                              delta=-machines))
    return out


# --------------------------------------------------------- scenario packs
@dataclass(frozen=True)
class Scenario:
    """One named chaos scenario: everything a MetroEngine run consumes,
    a pure function of (pack name, seed, wards, horizon)."""
    name: str
    traces: List[List[JobSpec]]
    failures: List[FailureEvent] = field(default_factory=list)
    scales: List[ScaleEvent] = field(default_factory=list)
    network: List[NetworkEvent] = field(default_factory=list)
    slowdowns: List[SlowdownEvent] = field(default_factory=list)

    @property
    def jobs(self) -> int:
        return sum(len(t) for t in self.traces)


def _pack_default(seed: int, wards: int, horizon: float) -> Scenario:
    tr, fails, scales = default_scenario(seed, wards, horizon)
    return Scenario("default", tr, fails, scales)


def _pack_edge_brownout(seed: int, wards: int, horizon: float) -> Scenario:
    """Every ward's edge pool takes CRASH failures through a mid-run
    brownout window at a heavy base rate: in-flight edge inference is
    lost and must retry — usually failing over to the (healthy) shared
    cloud."""
    tr = metro_traces(np.random.default_rng(seed), wards, horizon,
                      base_rate=0.3)
    fails: List[FailureEvent] = []
    for b in range(wards):
        fails += failure_events(
            np.random.default_rng(seed + 101 + b), horizon,
            tier=ES, ward=b, mtbf=0.2 * horizon, mttr=(6.0, 15.0),
            kill_running=True, window=(0.3 * horizon, 0.7 * horizon))
    fails.sort(key=lambda e: e.time)
    return Scenario("edge_brownout", tr, fails)


def _pack_mass_casualty_crash(seed: int, wards: int,
                              horizon: float) -> Scenario:
    """A mass-casualty surge (4x arrivals) colliding with crash failures
    on the shared cloud pool inside the surge window, while elastic
    capacity tracks the surge — the saturation regime load shedding is
    built for."""
    surges = ((0.35 * horizon, 0.7 * horizon, 4.0),)
    tr = metro_traces(np.random.default_rng(seed), wards, horizon,
                      base_rate=0.12, surges=surges)
    fails = failure_events(
        np.random.default_rng(seed + 1), horizon,
        mtbf=0.15 * horizon, mttr=(8.0, 18.0), kill_running=True,
        window=surges[0][:2])
    return Scenario("mass_casualty_crash", tr, fails,
                    scales=surge_scale_events(surges))


def _pack_degraded_network(seed: int, wards: int,
                           horizon: float) -> Scenario:
    """Cloud uplink degradation windows (transmission times scaled 2-5x)
    plus sparse drain failures at a heavy base rate: replans made inside
    a window must price the slow uplink and keep work at the edge."""
    tr = metro_traces(np.random.default_rng(seed), wards, horizon,
                      base_rate=0.3)
    fails = failure_events(np.random.default_rng(seed + 1), horizon,
                           mtbf=horizon, mttr=(8.0, 15.0))
    net = network_events(np.random.default_rng(seed + 2), horizon,
                         windows=2, duration=(0.1 * horizon,
                                              0.25 * horizon),
                         factor=(2.0, 5.0))
    return Scenario("degraded_network", tr, fails, network=net)


def _pack_diurnal_day(seed: int, wards: int, horizon: float) -> Scenario:
    """A full simulated day at low base rate with a strong diurnal swing
    and occasional drain failures — the long-haul streaming-metrics
    regime (windowed quantiles actually roll)."""
    tr = metro_traces(np.random.default_rng(seed), wards, horizon,
                      base_rate=0.035, diurnal_amp=0.8)
    fails = failure_events(np.random.default_rng(seed + 1), horizon,
                           mtbf=360.0, mttr=(10.0, 30.0))
    return Scenario("diurnal_day", tr, fails)


def _pack_fail_slow_tail(seed: int, wards: int,
                         horizon: float) -> Scenario:
    """Fail-slow machines without a single fail-stop event: deep
    slowdown windows (machines crawling at 3-8% speed — a failing disk
    or thermal throttle, not an outage) strike the ward edge pools,
    the workhorse tier, while the metropolitan cloud stays healthy.
    Nothing crashes and nothing is lost — in-flight edge work just
    silently stretches — which is exactly the regime deadline-aware
    hedging is built for: an unhedged run eats the stretched tail (a
    started commitment is immutable, C2, so replanning cannot save it),
    a hedged run races a healthy-tier backup against the straggler and
    cancels the loser (DESIGN.md §13)."""
    tr = metro_traces(np.random.default_rng(seed), wards, horizon,
                      base_rate=0.15)
    rng = np.random.default_rng(seed + 201)
    slows: List[SlowdownEvent] = []
    for b in range(wards):
        slows.extend(slowdown_events(
            rng, horizon, tier=ES, ward=b, windows=6,
            duration=(0.1 * horizon, 0.2 * horizon),
            factor=(0.03, 0.08)))
    slows.sort(key=lambda e: e.time)
    return Scenario("fail_slow_tail", tr, slowdowns=slows)


# name -> (build function, default wards, default horizon in trace minutes)
SCENARIO_PACKS: Dict[str, Tuple[
    Callable[[int, int, float], Scenario], int, float]] = {
    "default": (_pack_default, 4, 120.0),
    "edge_brownout": (_pack_edge_brownout, 4, 90.0),
    "mass_casualty_crash": (_pack_mass_casualty_crash, 4, 90.0),
    "degraded_network": (_pack_degraded_network, 4, 90.0),
    "diurnal_day": (_pack_diurnal_day, 2, DAY),
    "fail_slow_tail": (_pack_fail_slow_tail, 4, 180.0),
}


def make_scenario(name: str, seed: int = 0, *,
                  wards: Optional[int] = None,
                  horizon: Optional[float] = None) -> Scenario:
    """Build a registered chaos pack. `wards`/`horizon` default to the
    pack's canonical shape (the one the committed per-scenario floors
    were measured on); overriding them is fine for smokes but produces
    a different — still deterministic — run."""
    try:
        build, d_wards, d_horizon = SCENARIO_PACKS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario pack {name!r}; registered: "
            f"{sorted(SCENARIO_PACKS)}") from None
    return build(seed, wards if wards is not None else d_wards,
                 horizon if horizon is not None else d_horizon)
