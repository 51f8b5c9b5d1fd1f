"""Latency cost models (paper Section III).

Three interchangeable models, all exposing

    transmission_time(tier_id, job) -> D_i   (eq. 2)
    processing_time(tier_id, job)  -> I_i    (eq. 3)
    response_time(tier_id, job)    -> T_i    (eq. 4, = D_i + I_i)

* ``AnalyticCostModel`` — the paper's FLOPS-only model in physical seconds:
  I = lam2 * s * comp / AI_i, D = lam1 * (latency + s*bytes/bw).
* ``CalibratedCostModel`` — the paper's actual experimental procedure: unit
  costs are *measured* per (workload, tier) on a small dataset (this is how
  lam1/lam2 are folded in, Algorithm 1 steps 2-8), then scaled linearly in s.
  Table V is exactly linear in s, confirming this reading.
* ``RooflineCostModel`` — beyond-paper: processing time is the max of the
  compute and HBM roofline terms derived from the dry-run artifacts
  (launch/dryrun.py), not FLOPS alone. On TPUs decode is memory-bound, so
  the FLOPS-only model misranks tiers for decode jobs; see EXPERIMENTS.md.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.core.tiers import ED, TIER_ORDER, TierSpec


@dataclass(frozen=True)
class Workload:
    """A model/application whose inference jobs get placed on tiers."""
    name: str
    comp: float            # FLOPs per data unit (paper: model FLOPs)
    unit_bytes: float      # bytes per data unit
    priority: int = 1      # paper's w_i
    hbm_bytes: float = 0.0  # bytes moved per data unit (roofline model)


@dataclass(frozen=True)
class Job:
    workload: Workload
    size: float            # data units (paper Table IV "Data Size")
    release: float = 0.0   # R_i
    name: str = ""

    @property
    def priority(self) -> int:
        return self.workload.priority


class CostModel:
    def __init__(self, tiers: Mapping[str, TierSpec]):
        self.tiers = dict(tiers)

    def transmission_time(self, tier_id: str, job: Job) -> float:
        raise NotImplementedError

    def processing_time(self, tier_id: str, job: Job) -> float:
        raise NotImplementedError

    def response_time(self, tier_id: str, job: Job) -> float:
        return self.transmission_time(tier_id, job) + \
            self.processing_time(tier_id, job)

    def times(self, job: Job) -> Dict[str, Tuple[float, float]]:
        """{tier: (transmission D_i, processing I_i)} for every tier."""
        return {t: (self.transmission_time(t, job),
                    self.processing_time(t, job)) for t in self.tiers}


class AnalyticCostModel(CostModel):
    """Paper eq. (2)-(3) in physical units."""

    def __init__(self, tiers, lam1: float = 1.0, lam2: float = 1.0):
        super().__init__(tiers)
        self.lam1, self.lam2 = lam1, lam2

    def transmission_time(self, tier_id, job):
        tier = self.tiers[tier_id]
        if tier.private:          # assumption (a): data originates here
            return 0.0
        bytes_ = job.size * job.workload.unit_bytes
        return self.lam1 * (tier.net_latency + bytes_ / tier.net_bw)

    def processing_time(self, tier_id, job):
        tier = self.tiers[tier_id]
        return self.lam2 * job.size * job.workload.comp / tier.effective_flops


class CalibratedCostModel(CostModel):
    """Unit costs measured per (workload, tier), scaled linearly in size.

    unit_proc[(workload_name, tier)] and unit_trans[(workload_name, tier)]
    are per-data-unit measurements (the paper's small-dataset calibration);
    lam1/lam2 are already folded into them.
    """

    def __init__(self, tiers, unit_proc: Mapping[Tuple[str, str], float],
                 unit_trans: Mapping[Tuple[str, str], float]):
        super().__init__(tiers)
        self.unit_proc = dict(unit_proc)
        self.unit_trans = dict(unit_trans)

    @classmethod
    def from_measurements(cls, tiers, measurements):
        """measurements: {(workload_name, tier): (proc_total, trans_total,
        size)} from a calibration run; converts to unit costs."""
        up, ut = {}, {}
        for (w, t), (proc, trans, size) in measurements.items():
            up[(w, t)] = proc / size
            ut[(w, t)] = trans / size
        return cls(tiers, up, ut)

    def transmission_time(self, tier_id, job):
        if self.tiers[tier_id].private:
            return 0.0
        return job.size * self.unit_trans[(job.workload.name, tier_id)]

    def processing_time(self, tier_id, job):
        return job.size * self.unit_proc[(job.workload.name, tier_id)]


class RooflineCostModel(CostModel):
    """Beyond-paper: I_i = max(compute-term, memory-term) per tier.

    Needs workload.hbm_bytes (bytes moved per data unit, e.g. from the
    dry-run cost_analysis) and tier.hbm_bw.
    """

    def __init__(self, tiers, lam1: float = 1.0, lam2: float = 1.0):
        super().__init__(tiers)
        self.lam1, self.lam2 = lam1, lam2

    def transmission_time(self, tier_id, job):
        tier = self.tiers[tier_id]
        if tier.private:
            return 0.0
        bytes_ = job.size * job.workload.unit_bytes
        return self.lam1 * (tier.net_latency + bytes_ / tier.net_bw)

    def processing_time(self, tier_id, job):
        tier = self.tiers[tier_id]
        compute = job.size * job.workload.comp / tier.effective_flops
        memory = 0.0
        if job.workload.hbm_bytes and tier.hbm_bw:
            memory = job.size * job.workload.hbm_bytes / tier.hbm_bw
        return self.lam2 * max(compute, memory)
