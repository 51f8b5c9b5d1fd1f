"""Bridges between cost models / paper tables and scheduler JobSpecs,
plus arrival-scenario generators for the online scheduler (DESIGN.md §7)."""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.cost_model import CostModel, Job
from repro_torch.core.simulator import MACHINES, JobSpec
from repro_torch.core.tiers import CC, ED, ES


def jobs_to_specs(cost_model: CostModel, jobs: Sequence[Job],
                  normalize: float | None = None) -> List[JobSpec]:
    """Turn Jobs + a CostModel into scheduler rows.

    normalize: if set, divide all times by this quantum and round up to
    integers (paper constraint C3)."""
    specs = []
    for job in jobs:
        proc, trans = {}, {}
        for tier, (d, i) in cost_model.times(job).items():
            if normalize:
                d = math.ceil(d / normalize)
                i = max(1, math.ceil(i / normalize))
            proc[tier], trans[tier] = i, d
        specs.append(JobSpec(name=job.name or job.workload.name,
                             release=job.release, weight=job.priority,
                             proc=proc, trans=trans,
                             workload=job.workload.name))
    return specs


def table6_jobs() -> List[JobSpec]:
    """The paper's Table VI experimental job set, verbatim.

    Columns: release, weight, cloud (proc, trans), edge (proc, trans),
    device proc."""
    rows = [
        ("J1", 1, 2, 6, 56, 9, 11, 14),
        ("J2", 1, 2, 3, 32, 3, 6, 12),
        ("J3", 3, 1, 4, 12, 6, 2, 49),
        ("J4", 5, 1, 7, 23, 11, 5, 69),
        ("J5", 10, 2, 4, 27, 5, 5, 11),
        ("J6", 20, 2, 5, 70, 5, 14, 22),
        ("J7", 21, 2, 5, 70, 5, 14, 22),
        ("J8", 21, 1, 4, 12, 6, 2, 49),
        ("J9", 22, 1, 4, 12, 6, 2, 49),
        ("J10", 25, 1, 7, 23, 11, 5, 69),
    ]
    return [JobSpec(name=n, release=r, weight=w,
                    proc={CC: pc, ES: pe, ED: pd},
                    trans={CC: tc, ES: te, ED: 0.0})
            for (n, r, w, pc, tc, pe, te, pd) in rows]


# ---------------------------------------------- online arrival scenarios
# Cost ranges follow the paper's Table VI magnitudes (proc 1-30 units,
# cloud-heavy transmission); only the ARRIVAL PROCESS differs per scenario.
def _spec_at(rng: np.random.Generator, i: int, release: float) -> JobSpec:
    return JobSpec(
        name=f"J{i}", release=float(release),
        weight=float(rng.integers(1, 4)),
        proc={t: float(rng.integers(1, 30)) for t in MACHINES},
        trans={CC: float(rng.integers(0, 60)),
               ES: float(rng.integers(0, 15)), ED: 0.0})


def poisson_jobs(rng: np.random.Generator, n: int = 20,
                 rate: float = 0.2) -> List[JobSpec]:
    """Steady-state ward: memoryless arrivals at `rate` jobs per time unit
    (exponential inter-arrival times) — the baseline online scenario."""
    releases = np.cumsum(rng.exponential(1.0 / rate, size=n))
    return [_spec_at(rng, i, r) for i, r in enumerate(releases)]


def surge_jobs(rng: np.random.Generator, n: int = 20,
               quiet_rate: float = 0.05, surge_frac: float = 0.6,
               surge_width: float = 10.0) -> List[JobSpec]:
    """ER surge: a quiet Poisson background, then a mass-casualty burst —
    `surge_frac` of the jobs land inside one `surge_width`-wide window.
    Bursty arrivals are where naive replanning degrades hardest."""
    n_surge = int(round(n * surge_frac))
    background = np.cumsum(rng.exponential(1.0 / quiet_rate,
                                           size=n - n_surge))
    t0 = float(rng.uniform(0, max(background[-1], 1.0))) \
        if len(background) else 0.0
    burst = t0 + rng.uniform(0, surge_width, size=n_surge)
    releases = np.sort(np.concatenate([background, burst]))
    return [_spec_at(rng, i, r) for i, r in enumerate(releases)]


def quiet_jobs(rng: np.random.Generator, n: int = 12,
               rate: float = 0.02) -> List[JobSpec]:
    """Nightly quiet: sparse arrivals with long gaps — machines usually
    drain between events, so online should track the clairvoyant optimum
    closely (competitive ratio near 1)."""
    releases = np.cumsum(rng.exponential(1.0 / rate, size=n))
    return [_spec_at(rng, i, r) for i, r in enumerate(releases)]


ONLINE_SCENARIOS = {
    "poisson": poisson_jobs,
    "surge": surge_jobs,
    "quiet": quiet_jobs,
}


def metro_costs(rng: np.random.Generator, scale: float = 1.0
                ) -> tuple[Dict[str, float], Dict[str, float]]:
    """One (proc, trans) cost row in the paper's Table VI metro regime
    (cloud fast but far, edge moderate, device slow): proc_cloud 2-8,
    trans_cloud 10-40, proc_edge 4-14, trans_edge 1-8, proc_device 20-70.

    ``scale`` shrinks/grows the whole row (metro traces size the three
    episode stages with it — the life-death threat model is tiny, the
    phenotype classifier heavy). Draw order is part of the contract:
    `metro_jobs` consumers (the §9 contention benchmark) depend on
    bit-identical streams for a given rng state."""
    proc = {CC: scale * float(rng.integers(2, 9)),
            ES: scale * float(rng.integers(4, 15)),
            ED: scale * float(rng.integers(20, 71))}
    trans = {CC: scale * float(rng.integers(10, 41)),
             ES: scale * float(rng.integers(1, 9)), ED: 0.0}
    return proc, trans


def metro_jobs(rng: np.random.Generator, n: int = 100,
               horizon: float = 50.0) -> List[JobSpec]:
    """Cloud-attractive ward workload in the `metro_costs` regime.

    With these magnitudes the shared metropolitan cloud carries real load
    from every ward, which is exactly the regime where per-ward-independent
    planning double-books it — the contention benchmark's generator
    (DESIGN.md §9)."""
    out = []
    for i in range(n):
        release = float(rng.uniform(0, horizon))
        weight = float(rng.integers(1, 4))
        proc, trans = metro_costs(rng)
        out.append(JobSpec(name=f"J{i}", release=release, weight=weight,
                           proc=proc, trans=trans))
    return out


def patient_jobs(rng: np.random.Generator, patients: int,
                 horizon: float) -> List:
    """Random ICU patient jobs: each patient's end device releases one of
    the paper's three LSTM applications in [0, horizon) at a Table IV data
    size. THE scenario source for the serving driver and benchmarks
    (launch/serve.py binds `make_jobs` to this) — returns cost-model
    `Job`s, not JobSpecs; pair with a CostModel via `jobs_to_specs`."""
    # local imports: keep core.problems importable without the model zoo
    from repro_torch.configs.icu_lstm import DATA_SIZES, ICU_WORKLOADS
    from repro_torch.core.cost_model import Workload
    from repro_torch.data import icu

    jobs = []
    for pid in range(patients):
        wl_cfg = ICU_WORKLOADS[rng.integers(len(ICU_WORKLOADS))]
        size = int(DATA_SIZES[rng.integers(len(DATA_SIZES))])
        wl = Workload(name=wl_cfg.name, comp=wl_cfg.paper_flops,
                      unit_bytes=icu.record_bytes(wl_cfg),
                      priority=wl_cfg.priority)
        jobs.append(Job(workload=wl, size=size,
                        release=float(rng.uniform(0, horizon)),
                        name=f"patient{pid}-{wl_cfg.name.split('-')[0]}"))
    return jobs


def ward_batch(rng: np.random.Generator, wards: int,
               n_lo: int = 8, n_hi: int = 24,
               scenario: str = "poisson") -> List[List[JobSpec]]:
    """B independent ward instances for fleet-scale (batched) planning.

    Ward sizes are drawn uniformly from [n_lo, n_hi] — deliberately
    mixed, so consumers exercise the batched search's phantom-job padding
    (DESIGN.md §8). Each ward's arrivals come from the named
    ONLINE_SCENARIOS generator."""
    gen = ONLINE_SCENARIOS[scenario]
    return [gen(rng, n=int(rng.integers(n_lo, n_hi + 1)))
            for _ in range(wards)]
