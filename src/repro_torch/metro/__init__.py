"""Metro traffic engine (DESIGN.md §10): streaming patient-episode
simulation for metro-scale emergency load.

Three layers over the core scheduling machinery:

  * `traces`   — patient-episode generators (correlated bursts of the
    paper's three ICU apps) with diurnal/surge-modulated Poisson
    intensity per ward, per-workload-class SLA deadlines, machine
    failure / elastic-capacity / degraded-network event streams, and
    the seeded chaos scenario-pack registry (`make_scenario`);
  * `engine`   — a discrete-event loop over arrivals, completions,
    drain/crash failures, fail-slow slowdowns, recoveries, scale and
    network events, maintaining the true fleet occupancy (shared
    metropolitan cloud pool, per-ward edge pools, private devices) and
    driving a pluggable `Policy`; crash kills retry through the normal
    decision path with exponential backoff and a bounded attempt cap,
    SHED decisions drop jobs as explicit misses (DESIGN.md §11), and a
    hedge watchdog races backup attempts against stragglers with
    first-completion-wins cancellation (DESIGN.md §13);
  * `policies` — greedy commit-on-arrival, tabu committed replanning
    (`online_schedule`-style, batched across wards at matching event
    counts via `scheduler.search_batched`), the contention-aware
    fleet fixed point (`scheduler.search_fleet`), the saturation-aware
    shedding wrapper, and the deadline-aware hedging wrapper;
  * `metrics`  — streaming, windowed SLA metrics: p50/p95/p99/p99.9
    response (overall and per class), deadline miss-rate per workload
    class (shed jobs are explicit misses), crash-retry/wasted-work and
    hedge counters broken out per tier, per-tier utilisation, all O(1)
    memory over unbounded runs;
  * `tracing`  — the flight recorder (DESIGN.md §15): per-job span
    trees (decision/backoff/wait/transmit/service with fail-slow
    segment splits, hedge races, terminal outcomes) derived from the
    event stream with bit-identical CRCs, an exact additive
    deadline-miss attribution (blame table per class x tier), engine
    self-profiling, and JSONL / Chrome-trace (Perfetto) exporters.
"""
from repro_torch.metro.engine import (FailureEvent, MetroEngine, MetroResult,
                                NetworkEvent, ScaleEvent, SlowdownEvent,
                                simulate_metro)
from repro_torch.metro.metrics import MetroMetrics
from repro_torch.metro.policies import (SHED, FleetPolicy, GreedyPolicy,
                                  HedgeRequest, HedgingPolicy, Policy,
                                  SheddingPolicy, TabuPolicy, make_policy)
from repro_torch.metro.sanitizer import MetroSanitizer, SanitizerViolation
from repro_torch.metro.traces import SCENARIO_PACKS, Scenario, make_scenario
from repro_torch.metro.tracing import (TERMS, EngineProfile, MetroTrace,
                                 MetroTracer, Span)

__all__ = ["FailureEvent", "MetroEngine", "MetroResult", "NetworkEvent",
           "ScaleEvent", "SlowdownEvent", "simulate_metro", "MetroMetrics",
           "SHED", "FleetPolicy", "GreedyPolicy", "HedgeRequest",
           "HedgingPolicy", "Policy", "SheddingPolicy", "TabuPolicy",
           "make_policy", "MetroSanitizer", "SanitizerViolation",
           "SCENARIO_PACKS", "Scenario", "make_scenario",
           "TERMS", "EngineProfile", "MetroTrace", "MetroTracer", "Span"]
