"""Hierarchical serving driver — the paper's technique as a first-class
feature.

Multi-patient ICU inference requests (the paper's three LSTM applications,
with priorities and release times) are placed on cloud/edge/device tiers by
core.scheduler (Algorithm 2) and then EXECUTED: the LSTM inferences really
run (the CUDA lstm_cell kernel on the GPU, its plain PyTorch version with
--device cpu), while tier compute-speed ratios and network transfer times
come from the calibrated cost model. The driver reports per-job response
times under our allocation vs the paper's four baseline strategies.

  python -m repro_torch.launch.serve --patients 100 --horizon 30 --seed 0
  python -m repro_torch.launch.serve --tiers tpu      # modelled TPU fleet
  python -m repro_torch.launch.serve --device cpu     # plain CPU path
"""
from __future__ import annotations

import argparse
import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.configs.icu_lstm import ICU_WORKLOADS
from repro_torch.core import scheduler
from repro_torch.core.cost_model import CalibratedCostModel
from repro_torch.core.lower_bound import paper_lower_bound
from repro_torch.core.problems import jobs_to_specs, patient_jobs
from repro_torch.core.tiers import CC, ED, ES, paper_tiers, tpu_tiers
from repro_torch.data import icu
from repro_torch.device import resolve_device
from repro_torch.models.lstm import ICULSTM
from repro_torch.serving.engine import ClassifierEngine


def calibrate(tiers, engines, unit_records: int = 16):
    """The paper's Algorithm 1 steps 2-8: measure a small dataset once,
    derive per-(workload, tier) unit costs. Processing time is measured on
    the engines' device and scaled by the tier FLOPS ratio; transmission
    uses the tier network function and the real record sizes. The warm-up
    call also builds the CUDA kernels on first use."""
    host_flops = tiers[ED].flops
    unit_proc, unit_trans = {}, {}
    for wl_cfg, engine in engines.items():
        x, _ = icu.generate(wl_cfg, unit_records, seed=1)
        engine.infer(x)                                    # warm up / build
        _, seconds = engine.infer(x)
        per_unit = seconds / unit_records
        rec_bytes = icu.record_bytes(wl_cfg)
        for tid, tier in tiers.items():
            unit_proc[(wl_cfg.name, tid)] = per_unit * host_flops / tier.flops
            unit_trans[(wl_cfg.name, tid)] = 0.0 if tier.private else (
                tier.net_latency + rec_bytes / tier.net_bw)
    return CalibratedCostModel(tiers, unit_proc, unit_trans)


# Each patient's end device releases one random ICU job in [0, horizon).
# The generator lives in core.problems so serve and benchmarks draw from
# ONE scenario library; the old name stays bound for callers/tests.
make_jobs = patient_jobs


def _setup_fleet(tiers_kind, cloud_machines, edge_machines, device):
    """Tier specs (with machine-count overrides), real models + engines
    on `device` (the compute that actually runs; each model's weights come
    from a torch.Generator seeded with crc32 of its name, stable across
    processes, so --seed really reproduces a run), and the calibrated cost
    model. -> (tiers, machines_per_tier, engines, cost_model)."""
    tiers = paper_tiers() if tiers_kind == "paper" else tpu_tiers()
    for tid, count in ((CC, cloud_machines), (ES, edge_machines)):
        if count is not None:
            tiers[tid] = dataclasses.replace(tiers[tid], machines=count)
    machines_per_tier = {tid: t.machines for tid, t in tiers.items()
                         if not t.private}
    engines = {}
    for wl_cfg in ICU_WORKLOADS:
        gen = torch.Generator().manual_seed(zlib.crc32(wl_cfg.name.encode()))
        model = ICULSTM(wl_cfg, generator=gen, device=device)
        engines[wl_cfg] = ClassifierEngine(model, device=device)
    return tiers, machines_per_tier, engines, calibrate(tiers, engines)


def _validate_quantum(quantum) -> None:
    """An explicit quantum must be a positive time unit. (``quantum or
    min(...)`` silently replaced an explicit 0.0 with the derived default —
    a ``None`` check keeps falsy-but-explicit values visible and rejected.)
    """
    if not quantum > 0:
        raise ValueError(f"quantum must be > 0, got {quantum!r}")


def run(patients=10, horizon=30.0, seed=0, tiers_kind="paper",
        execute=True, quantum=None, verbose=True, device_threshold=None,
        cloud_machines=None, edge_machines=None, device=None):
    """device: where the models and the device search run (default
    "cuda"; raises without a CUDA device unless device="cpu").
    device_threshold: fleets larger than this plan on the device search
    (scheduler.search dispatch; default: above 64 jobs on CUDA only).
    cloud_machines / edge_machines: override the shared-server count of a
    tier (TierSpec.machines is honored by every strategy)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tiers, machines_per_tier, engines, cost_model = _setup_fleet(
        tiers_kind, cloud_machines, edge_machines, dev)
    jobs = make_jobs(rng, patients, horizon)
    if quantum is None:
        quantum = min(
            min(cost_model.times(j)[t][1] for t in tiers) for j in jobs)
    _validate_quantum(quantum)
    specs = jobs_to_specs(cost_model, jobs, normalize=quantum)

    table = scheduler.strategy_table(specs,
                                     device_threshold=device_threshold,
                                     machines_per_tier=machines_per_tier,
                                     device=dev)
    lb = paper_lower_bound(specs)
    results = {}
    if verbose:
        print(f"{'strategy':26s} {'weighted':>9s} {'unweighted':>10s} "
              f"{'last':>6s}  (time unit = {quantum*1e3:.3f} ms)")
    for name, sched in table.items():
        results[name] = sched
        if verbose:
            print(f"{name:26s} {sched.weighted_sum:9.0f} "
                  f"{sched.unweighted_sum:10.0f} {sched.last_end:6.0f}")
    if verbose:
        print(f"{'lower bound (eq.6)':26s} {lb:9.0f}")

    if execute:
        ours = results["ours (algorithm 2)"]
        if verbose:
            print("\nexecuting our schedule (real LSTM inference per job):")
        for entry in sorted(ours.entries, key=lambda e: e.start):
            # the spec carries its workload name (no display-string parsing)
            wl_cfg = next(w for w in ICU_WORKLOADS
                          if w.name == entry.job.workload)
            x, _ = icu.generate(wl_cfg, 8, seed=int(entry.start) + 1)
            _, seconds = engines[wl_cfg].infer(x)
            if verbose:
                print(f"  {entry.job.name:32s} -> {entry.machine:6s} "
                      f"[start {entry.start:4.0f}, end {entry.end:4.0f}] "
                      f"real_infer {seconds*1e3:6.1f} ms")
    return results, lb


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--patients", type=int, default=10)
    ap.add_argument("--horizon", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiers", choices=("paper", "tpu"), default="paper")
    ap.add_argument("--no-execute", action="store_true")
    ap.add_argument("--device-threshold", type=int, default=None,
                    help="force the device search above this many jobs "
                         "(default: above 64 jobs on a CUDA device only)")
    ap.add_argument("--cloud-machines", type=int, default=None,
                    help="shared cloud servers (default: TierSpec.machines)")
    ap.add_argument("--edge-machines", type=int, default=None,
                    help="shared edge servers (default: TierSpec.machines)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for inference and the device search "
                         "(default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    return run(patients=args.patients, horizon=args.horizon, seed=args.seed,
               tiers_kind=args.tiers, execute=not args.no_execute,
               device_threshold=args.device_threshold,
               cloud_machines=args.cloud_machines,
               edge_machines=args.edge_machines, device=args.device)


if __name__ == "__main__":
    main()
