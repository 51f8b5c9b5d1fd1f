"""The paper's allocator on the TPU fleet and the 10 assigned LLM archs.

Where the ICU LSTMs are tiny (the device tier always wins under physical
constants), LLM inference exposes the paper's real trade-off surface:
prefill jobs are compute-bound (cloud pod wins despite DCN transfer),
decode jobs are latency/memory-bound (edge/device wins), and the
roofline cost model (beyond-paper) re-ranks tiers vs the FLOPS-only one.

    python -m repro_torch.examples.llm_fleet_allocation
    python -m repro_torch.examples.llm_fleet_allocation --device cpu

The reference's example (examples/llm_fleet_allocation.py) on the port's
`utils.flops` and `core.tiers.tpu_tiers`. The fleet is modelled, not
measured: the table is host arithmetic, and `--device` (default cuda) is
checked as every entry point checks it.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro_torch.core.allocator import allocate_single
from repro_torch.core.cost_model import (AnalyticCostModel, Job,
                                         RooflineCostModel, Workload)
from repro_torch.core.tiers import tpu_tiers
from repro_torch.device import resolve_device
from repro_torch.utils import flops as F


def job_for(arch, shape_name, kind):
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    seq = shape.seq_len
    comp = F.forward_flops(cfg, 1, seq, kind)
    bytes_in = seq * 4 if kind != "decode" else 64     # prompt vs one token
    # HBM bytes per request for the roofline model (decode: weights+KV read)
    hbm = F.param_bytes(cfg) * (1 if kind == "decode" else 0.1)
    return Job(Workload(f"{arch}:{shape_name}", comp=comp,
                        unit_bytes=bytes_in, hbm_bytes=hbm), size=1.0,
               name=f"{arch}:{shape_name}")


def main(argv=None):
    """Returns the number of jobs the two cost models place apart."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    resolve_device(ap.parse_args(argv).device)
    tiers = tpu_tiers(cloud_chips=512, edge_chips=16, device_chips=1)
    paper_cm = AnalyticCostModel(tiers)
    roof_cm = RooflineCostModel(tiers)

    print(f"{'job':44s} {'paper->':>8s} {'T_ms':>9s} {'roofline->':>11s} "
          f"{'T_ms':>9s}")
    disagreements = 0
    for arch in ARCH_NAMES:
        for shape_name, kind in (("prefill_32k", "prefill"),
                                 ("decode_32k", "decode")):
            job = job_for(arch, shape_name, kind)
            a1 = allocate_single(paper_cm, job)
            a2 = allocate_single(roof_cm, job)
            disagreements += a1.tier != a2.tier
            print(f"{job.name:44s} {a1.tier:>8s} {a1.response*1e3:9.3f} "
                  f"{a2.tier:>11s} {a2.response*1e3:9.3f}")
    print(f"\nFLOPS-only vs roofline cost model disagreements: "
          f"{disagreements}/20 — the memory term re-ranks decode jobs "
          f"(EXPERIMENTS.md §Beyond-paper)")
    return disagreements


if __name__ == "__main__":
    main()
