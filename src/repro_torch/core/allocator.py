"""Algorithm 1 — optimal single-job tier allocation (paper Section IV).

Given a workload (model FLOPs per unit + data size), a cost model, and the
tier fleet, compute the estimated response time at every tier and pick the
argmin. This is the paper's core single-job contribution; Table V is this
algorithm run over 18 workloads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

from repro_torch.core.cost_model import CostModel, Job
from repro_torch.core.tiers import TIER_ORDER


@dataclass(frozen=True)
class Allocation:
    job: Job
    tier: str                                   # argmin tier
    response: float                             # T_min (eq. 4)
    per_tier: Dict[str, Tuple[float, float]]    # tier -> (D_i, I_i)

    @property
    def per_tier_response(self) -> Dict[str, float]:
        return {t: d + i for t, (d, i) in self.per_tier.items()}


def allocate_single(cost_model: CostModel, job: Job) -> Allocation:
    """Paper Algorithm 1: T_i = D_i + I_i per tier, return the argmin.

    Ties break toward the lower tier (device > edge > cloud) — computing
    near the user wins when equal, per the paper's Section VIII analysis.
    """
    per_tier = cost_model.times(job)
    best_tier, best_t = None, float("inf")
    # iterate device-first so ties keep the lowest tier
    for tier in reversed(TIER_ORDER):
        if tier not in per_tier:
            continue
        d, i = per_tier[tier]
        if d + i < best_t:
            best_tier, best_t = tier, d + i
    return Allocation(job=job, tier=best_tier, response=best_t,
                      per_tier=per_tier)
