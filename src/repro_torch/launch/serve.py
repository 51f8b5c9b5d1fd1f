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
  python -m repro_torch.launch.serve --metro          # streaming metro load:
                                                      # hours of episodes vs
                                                      # failures, policy
                                                      # table
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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


def _trace_path(base: str, policy: str, multi: bool) -> str:
    """Per-policy trace file name: the given path verbatim for a single
    policy, `name.<policy>.ext` when several policies share one run."""
    if not multi:
        return base
    root, dot, ext = base.rpartition(".")
    return f"{root}.{policy}.{ext}" if dot else f"{base}.{policy}"


def run_metro(wards=None, hours=None, seed=0, cloud_machines=2,
              edge_machines=2, policies=("greedy", "tabu", "fleet"),
              verbose=True, device_threshold=None, scenario="default",
              check_determinism=False, hedge=False, hedge_factor=1.5,
              retry_backoff=0.0, max_attempts=None, sanitize=False,
              trace=None, trace_format="jsonl", postmortem=False,
              postmortem_out=None, metrics_out=None, device=None):
    """Metro traffic mode (DESIGN.md §10-§11): streaming patient-episode
    traffic over a ward fleet sharing one metropolitan cloud, replayed
    under each policy on identical traces, failures (drain or crash),
    fail-slow slowdown windows, degraded-network windows and
    elastic-capacity events. `scenario` names a chaos pack from
    `metro.traces.SCENARIO_PACKS`; `wards` and `hours` default to the
    pack's canonical shape. Prints the policy comparison (p50/p99
    response, SLA miss-rate overall / life-critical / shed, per-tier
    utilisation with the crash-retry and wasted-work counts broken out
    per tier, engine events/s) and returns {policy: summary dict}.

    device: where the search policies' device searches run (default
    "cuda"; raises without a CUDA device unless device="cpu"). Replans
    of four or more wards at one event go through the batched device
    search whatever `device_threshold` says; device_threshold pins the
    single-ward dispatch. Each summary's `device_searches` counts the
    batched device searches of that policy's run.

    hedge=True wraps every policy in the deadline-aware HedgingPolicy
    and arms the engine's straggler watchdog at `hedge_factor` x the
    committed proc time (DESIGN.md §13); the table gains hedge/win/
    hedge-waste columns. retry_backoff / max_attempts bound crash
    retries (exponential backoff, shed-with-record past the cap).

    sanitize=True arms the engine's runtime invariant sanitizer
    (DESIGN.md §14) on every run; the run fails on the first violation.
    The sanitizer is read-only, so sanitized event logs hash
    bit-identically.

    check_determinism=True replays every policy twice on a fresh engine
    and raises unless the event logs hash identically — the seeded-chaos
    determinism contract (DESIGN.md §11). The single-ward search is
    pinned to the Python path when no device_threshold is given. The
    verification rerun is UNTRACED, so with `trace` set the hash
    comparison doubles as a traced-vs-untraced CRC-parity check
    (DESIGN.md §15).

    trace=PATH arms the flight recorder (DESIGN.md §15) and writes each
    policy's span stream there — `trace_format` "jsonl" (one span per
    line) or "chrome" (trace-event JSON, opens in Perfetto); several
    policies write `name.<policy>.ext` each. postmortem=True prints the
    deadline-miss blame table plus the engine self-profile;
    postmortem_out=PATH exports the same as JSON. metrics_out=PATH dumps
    the full per-policy summary dicts as JSON.

    One trace time unit reads as one minute; episodes are the paper's
    three-app cascade with per-class response deadlines
    (metro.traces.EPISODE_STAGES)."""
    from repro_torch.core import scheduler_torch
    from repro_torch.metro import (HedgingPolicy, make_policy,
                                   simulate_metro, traces)

    dev = resolve_device(device)
    if check_determinism and device_threshold is None:
        device_threshold = 10 ** 9       # always the Python search path
    horizon = None if hours is None else hours * 60.0
    sc = traces.make_scenario(scenario, seed, wards=wards, horizon=horizon)
    wards = len(sc.traces)
    mpt = {CC: cloud_machines, ES: edge_machines}
    # fleet's joint fixed point gets small per-event budgets: each event
    # only needs local repair on top of the previous one (DESIGN.md §10).
    # greedy/shed never search, so only the replanning policies take the
    # device and the dispatch pin
    kwargs = {"fleet": dict(max_count=2, max_sweeps=1,
                            device_threshold=device_threshold, device=dev),
              "tabu": dict(device_threshold=device_threshold, device=dev)}

    want_trace = trace is not None or postmortem or \
        postmortem_out is not None
    want_profile = postmortem or postmortem_out is not None

    def one_run(name, traced=False):
        # a fresh policy per run: policies may carry stream state (the
        # shedding wrapper's running max weight, the hedging wrapper's)
        pol = make_policy(name, **kwargs.get(name, {}))
        eng_kw = {}
        if hedge:
            pol = HedgingPolicy(inner=pol)
            eng_kw["hedge_factor"] = hedge_factor
        return simulate_metro(
            sc.traces, pol, machines_per_tier=mpt, failures=sc.failures,
            scale_events=sc.scales, network_events=sc.network,
            slowdowns=sc.slowdowns, retry_backoff=retry_backoff,
            max_attempts=max_attempts, sanitize=sanitize,
            trace=traced, profile=traced and want_profile, **eng_kw)

    if verbose:
        kills = sum(f.kill_running for f in sc.failures)
        print(f"metro[{sc.name}]: {wards} wards, {sc.jobs} episode-stage "
              f"jobs, {len(sc.failures)} failures ({kills} crash), "
              f"{len(sc.slowdowns)} slowdown windows, "
              f"{len(sc.scales)} scale events, {len(sc.network)} network "
              f"windows, fleet {cloud_machines}c/{edge_machines}e per ward"
              + (f", hedging at {hedge_factor:g}x" if hedge else "")
              + f", device {dev}")
        hedge_cols = (f" {'hedge':>5s} {'win':>4s} {'hwaste':>6s}"
                      if hedge else "")
        print(f"{'policy':8s} {'p50':>6s} {'p95':>6s} {'p99':>6s} "
              f"{'p99.9':>6s} {'miss%':>6s} {'crit%':>6s} {'shed%':>6s} "
              f"{'cloud':>6s} {'rtry':>4s} {'waste':>6s} "
              f"{'edge':>6s} {'rtry':>4s} {'waste':>6s}"
              f"{hedge_cols} {'events/s':>9s} {'dsearch':>7s}")
    out = {}
    traced_runs = {}
    for name in policies:
        calls0 = scheduler_torch.tabu_search_batched.calls
        res = one_run(name, traced=want_trace)
        calls = scheduler_torch.tabu_search_batched.calls - calls0
        log_hash = zlib.crc32(repr(res.event_log).encode())
        if check_determinism:
            rerun_hash = zlib.crc32(repr(one_run(name).event_log).encode())
            if rerun_hash != log_hash:
                raise AssertionError(
                    f"metro[{sc.name}]/{name}: event log not "
                    f"deterministic across reruns ({log_hash:#x} vs "
                    f"{rerun_hash:#x})")
        s = res.summary()
        s["event_log_hash"] = log_hash
        # batched device searches of this policy's (first) run
        s["device_searches"] = calls
        out[name] = s
        if res.trace is not None:
            traced_runs[name] = res
        if verbose:
            util = s["utilization"]
            rbt, wbt = s["retries_by_tier"], s["wasted_by_tier"]
            hedge_cells = (f" {s['hedges']:5d} {s['hedge_wins']:4d} "
                           f"{s['hedge_waste']:6.1f}" if hedge else "")
            print(f"{name:8s} {s['p50']:6.1f} {s['p95']:6.1f} "
                  f"{s['p99']:6.1f} {s['p999']:6.1f} "
                  f"{s['miss_rate']:6.2%} "
                  f"{s['critical_miss_rate']:6.2%} {s['shed_rate']:6.2%} "
                  f"{util.get('cloud', 0.0):6.1%} "
                  f"{rbt.get('cloud', 0):4d} {wbt.get('cloud', 0.0):6.1f} "
                  f"{util.get('edge', 0.0):6.1%} "
                  f"{rbt.get('edge', 0):4d} {wbt.get('edge', 0.0):6.1f}"
                  f"{hedge_cells} "
                  f"{s['events_per_s']:9.0f} {calls:7d}")
    if verbose and check_determinism:
        print(f"determinism: {len(out)} policies x 2 runs, event logs "
              f"bit-identical")
    if verbose and "greedy" in out and "tabu" in out:
        # the ratio is vacuous when greedy itself misses nothing, and a
        # perfect tabu run is floored at half a missed job
        g, t = out["greedy"]["miss_rate"], out["tabu"]["miss_rate"]
        if g == 0:
            print("tabu-replan miss-rate improvement vs greedy: vacuous "
                  "(greedy missed no deadlines)")
        else:
            jobs_done = max(out["greedy"]["completions"], 1)
            print(f"tabu-replan miss-rate improvement vs greedy: "
                  f"{g / max(t, 0.5 / jobs_done):.2f}x")
    if trace is not None:
        multi = len(traced_runs) > 1
        for name, res in traced_runs.items():
            path = _trace_path(trace, name, multi)
            n = res.trace.write(path, trace_format)
            if verbose:
                unit = "events" if trace_format == "chrome" else "spans"
                print(f"trace[{name}]: {n} {unit} ({trace_format}) "
                      f"-> {path}")
    if postmortem and verbose:
        for name, res in traced_runs.items():
            print(res.trace.format_postmortem(
                name, res.profile, out[name]["device_searches"]))
    if postmortem_out is not None:
        report = {name: res.trace.postmortem_json(
            name, res.profile, out[name]["device_searches"])
            for name, res in traced_runs.items()}
        with open(postmortem_out, "w") as f:
            json.dump(report, f, indent=2)
        if verbose:
            print(f"postmortem JSON -> {postmortem_out}")
    if metrics_out is not None:
        with open(metrics_out, "w") as f:
            json.dump(out, f, indent=2)
        if verbose:
            print(f"metrics JSON -> {metrics_out}")
    return out


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
    ap.add_argument("--metro", action="store_true",
                    help="streaming metro traffic mode: hours of "
                         "patient-episode load over a shared-cloud ward "
                         "fleet with failures and elastic capacity, "
                         "compared across replanning policies "
                         "(DESIGN.md §10)")
    ap.add_argument("--metro-hours", type=float, default=None,
                    help="simulated hours of metro traffic (default: the "
                         "scenario pack's canonical horizon)")
    ap.add_argument("--scenario", default="default",
                    help="chaos scenario pack for --metro "
                         "(metro.traces.SCENARIO_PACKS: default, "
                         "edge_brownout, mass_casualty_crash, "
                         "degraded_network, diurnal_day, fail_slow_tail)")
    ap.add_argument("--hedge", action="store_true",
                    help="with --metro: wrap every policy in the "
                         "deadline-aware hedging wrapper and arm the "
                         "straggler watchdog (DESIGN.md §13)")
    ap.add_argument("--hedge-factor", type=float, default=1.5,
                    help="watchdog threshold: hedge once elapsed runtime "
                         "exceeds this multiple of the committed proc "
                         "time (default 1.5)")
    ap.add_argument("--retry-backoff", type=float, default=0.0,
                    help="base delay for exponential crash-retry backoff "
                         "(0 = immediate re-dispatch)")
    ap.add_argument("--max-attempts", type=int, default=None,
                    help="cap on attempts per job; past it the job is "
                         "shed-with-record (default: unbounded)")
    ap.add_argument("--metro-policies", default="greedy,tabu,fleet",
                    help="comma-separated policy list for --metro "
                         "(greedy, tabu, fleet, shed)")
    ap.add_argument("--check-determinism", action="store_true",
                    help="with --metro: run every policy twice and fail "
                         "unless the event logs are bit-identical "
                         "(DESIGN.md §11)")
    ap.add_argument("--sanitize", action="store_true",
                    help="with --metro: run the engine with the runtime "
                         "invariant sanitizer armed (DESIGN.md §14); "
                         "fails on the first violation")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="with --metro: arm the flight recorder and "
                         "write per-job span streams here (per-policy "
                         "suffix when several policies run — "
                         "DESIGN.md §15)")
    ap.add_argument("--trace-format", choices=("jsonl", "chrome"),
                    default="jsonl",
                    help="trace file format: jsonl spans, or Chrome "
                         "trace-event JSON for Perfetto/chrome://tracing")
    ap.add_argument("--postmortem", action="store_true",
                    help="with --metro: print the deadline-miss blame "
                         "table and the engine self-profile")
    ap.add_argument("--postmortem-out", default=None, metavar="PATH",
                    help="write the postmortem attribution report "
                         "(per-job terms, blame table, profile) as JSON")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="with --metro: dump the full per-policy "
                         "MetroMetrics.summary() dicts as JSON")
    args = ap.parse_args(argv)
    if args.contention and args.wards <= 0:
        ap.error("--contention requires --wards N (N > 0)")
    if args.metro:
        return run_metro(wards=args.wards or None, hours=args.metro_hours,
                         seed=args.seed,
                         cloud_machines=args.cloud_machines or 2,
                         edge_machines=args.edge_machines or 2,
                         policies=tuple(
                             p for p in args.metro_policies.split(",") if p),
                         device_threshold=args.device_threshold,
                         scenario=args.scenario,
                         check_determinism=args.check_determinism,
                         hedge=args.hedge, hedge_factor=args.hedge_factor,
                         retry_backoff=args.retry_backoff,
                         max_attempts=args.max_attempts,
                         sanitize=args.sanitize,
                         trace=args.trace, trace_format=args.trace_format,
                         postmortem=args.postmortem,
                         postmortem_out=args.postmortem_out,
                         metrics_out=args.metrics_out, device=args.device)
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
