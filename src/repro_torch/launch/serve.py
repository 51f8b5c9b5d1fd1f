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
  python -m repro_torch.launch.serve --wards 32       # multi-hospital fleet:
                                                      # one batched device
                                                      # search plans every
                                                      # ward
  python -m repro_torch.launch.serve --wards 32 --contention
                                                      # plans against one
                                                      # shared cloud
"""
from __future__ import annotations

import argparse
import dataclasses
import time
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
from repro_torch.device import resolve_device, synchronize
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


def run_wards(wards=4, patients=10, horizon=30.0, seed=0,
              tiers_kind="paper", quantum=None, verbose=True,
              cloud_machines=None, edge_machines=None, min_batch=None,
              contention=False, max_sweeps=8, device=None):
    """Multi-hospital fleet mode: plan `wards` ward instances in ONE
    batched device search (scheduler.search_batched, DESIGN.md §8).

    The metropolitan cloud spec is shared — every ward sees the same
    cloud machine count — while each ward owns its edge servers and its
    patients' end devices. Calibration runs once (the cost model
    describes the shared hardware), and one quantum (the fleet-wide
    minimum) keeps every ward's time unit comparable. device: where the
    calibration models and the device searches run (default "cuda";
    raises without a CUDA device unless device="cpu").

    contention=False (default): planning is per-ward independent — a ward
    optimises against the full cloud fleet, so B wards silently
    double-book the shared cloud servers and the per-ward numbers are
    only achievable one ward at a time.

    contention=True (DESIGN.md §9): additionally rescore the independent
    plans with the fleet-true evaluator (`simulate_fleet` — one merged
    shared-cloud FIFO queue) and run `scheduler.search_fleet`'s
    contention-aware fixed-point sweeps; reports the naive claimed
    scores, the fleet-true scores, the contention gap, and the gap
    recovered.

    Returns (list of per-ward Schedules, wall seconds of the planning
    call) — in contention mode, the per-ward schedules of the fleet-true
    plan (entries carry merged-queue times) and a third element, the
    FleetPlan."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    tiers, machines_per_tier, _, cost_model = _setup_fleet(
        tiers_kind, cloud_machines, edge_machines, dev)

    ward_jobs = [make_jobs(rng, patients, horizon) for _ in range(wards)]
    if quantum is None:
        quantum = min(
            min(cost_model.times(j)[t][1] for t in tiers)
            for jobs in ward_jobs for j in jobs)
    _validate_quantum(quantum)
    ward_specs = [jobs_to_specs(cost_model, jobs, normalize=quantum)
                  for jobs in ward_jobs]

    if contention:
        # warm-up at the real shape (max_sweeps=0 plans nothing beyond the
        # naive stage), as the reference warms its compile cache, so the
        # timed call starts from the same state in both packages
        scheduler.search_fleet(
            ward_specs, machines_per_tier=machines_per_tier,
            min_batch=min_batch, max_count=1, max_sweeps=0, device=dev)
        synchronize(dev)
        t0 = time.perf_counter()
        plan = scheduler.search_fleet(
            ward_specs, machines_per_tier=machines_per_tier,
            min_batch=min_batch, max_sweeps=max_sweeps, device=dev)
        synchronize(dev)
        seconds = time.perf_counter() - t0
        if verbose:
            print(f"{'ward':>4s} {'jobs':>5s} {'naive':>9s} "
                  f"{'fleet-true':>10s}  (time unit = {quantum*1e3:.3f} ms)")
            for i, (naive_s, fleet_s) in enumerate(
                    zip(plan.naive_fleet.wards, plan.fleet.wards)):
                print(f"{i:4d} {len(fleet_s.entries):5d} "
                      f"{naive_s.weighted_sum:9.0f} "
                      f"{fleet_s.weighted_sum:10.0f}")
            print(f"independent plans claim   {plan.naive_reported:9.0f}")
            print(f"  ...but really score     "
                  f"{plan.naive_fleet.weighted_sum:9.0f} on the shared "
                  f"fleet (contention gap {plan.contention_gap:.3f}x)")
            print(f"fleet-true after {plan.sweeps} sweeps: "
                  f"{plan.fleet.weighted_sum:9.0f} "
                  f"({plan.gap_closed:.0%} of the gap recovered) "
                  f"in {seconds*1e3:.1f} ms")
        return plan.fleet.wards, seconds, plan

    # warm-up at the real (B, n_max, fleet) shape, as the reference does
    # before its timed call; the sequential fallback path skips it
    threshold = (scheduler.BATCHED_SEARCH_MIN_WARDS if min_batch is None
                 else min_batch)
    if wards >= threshold:
        scheduler.search_batched(ward_specs, max_count=1,
                                 machines_per_tier=machines_per_tier,
                                 min_batch=min_batch, device=dev)
    synchronize(dev)
    t0 = time.perf_counter()
    schedules = scheduler.search_batched(
        ward_specs, machines_per_tier=machines_per_tier,
        min_batch=min_batch, device=dev)
    synchronize(dev)
    seconds = time.perf_counter() - t0
    if verbose:
        print(f"{'ward':>4s} {'jobs':>5s} {'weighted':>9s} "
              f"{'unweighted':>10s} {'last':>6s}  "
              f"(time unit = {quantum*1e3:.3f} ms)")
        for i, s in enumerate(schedules):
            print(f"{i:4d} {len(s.entries):5d} {s.weighted_sum:9.0f} "
                  f"{s.unweighted_sum:10.0f} {s.last_end:6.0f}")
        total = sum(s.weighted_sum for s in schedules)
        print(f"fleet total weighted {total:.0f}; planned {wards} wards "
              f"in {seconds*1e3:.1f} ms ({wards/seconds:.1f} wards/s)")
    return schedules, seconds


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
    ap.add_argument("--wards", type=int, default=0,
                    help="multi-hospital mode: plan this many wards in one "
                         "batched device search (shared cloud, per-ward "
                         "edge/device fleets); 0 = single-ward mode")
    ap.add_argument("--contention", action="store_true",
                    help="with --wards: score plans on the REAL shared "
                         "cloud (merged FIFO queue) and run the "
                         "contention-aware fixed-point search; reports "
                         "naive vs fleet-true scores and the gap "
                         "(DESIGN.md §9)")
    args = ap.parse_args(argv)
    if args.contention and args.wards <= 0:
        ap.error("--contention requires --wards N (N > 0)")
    if args.wards > 0:
        return run_wards(wards=args.wards, patients=args.patients,
                         horizon=args.horizon, seed=args.seed,
                         tiers_kind=args.tiers,
                         cloud_machines=args.cloud_machines,
                         edge_machines=args.edge_machines,
                         contention=args.contention, device=args.device)
    return run(patients=args.patients, horizon=args.horizon, seed=args.seed,
               tiers_kind=args.tiers, execute=not args.no_execute,
               device_threshold=args.device_threshold,
               cloud_machines=args.cloud_machines,
               edge_machines=args.edge_machines, device=args.device)


if __name__ == "__main__":
    main()
