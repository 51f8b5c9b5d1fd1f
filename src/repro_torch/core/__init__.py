# The paper's primary contribution: hierarchical cloud/edge/device workload
# allocation. tiers/cost_model/allocator implement Section III-IV
# (Algorithm 1); simulator/scheduler implement Section V-VI (Algorithm 2);
# scheduler_torch adds the batched device schedule search (beyond paper).
from repro_torch.core.allocator import Allocation, allocate_single  # noqa: F401
from repro_torch.core.cost_model import (AnalyticCostModel,  # noqa: F401
                                         CalibratedCostModel, Job,
                                         RooflineCostModel, Workload)
from repro_torch.core.simulator import (JobSpec, Schedule,  # noqa: F401
                                        simulate)
from repro_torch.core.tiers import (CC, ED, ES, TierSpec,  # noqa: F401
                                    paper_tiers, tpu_tiers)
