"""The port's scheduler front end and serving driver against the JAX
reference's, on the CPU.

Calibration times real inference, so its costs depend on the host; the
table comparison pins one CalibratedCostModel built from fixed unit costs
in both packages, and pins the Python search backend on both sides (the
reference's `search` output depends on its dispatch state otherwise). The
fleet mode (`run_wards`) pins the cost model by replacing each package's
`serve.calibrate`; its wards reach the batched search, which is
deterministic in both packages."""
import numpy as np
import pytest
import torch

from repro.configs.icu_lstm import ICU_WORKLOADS as REF_WORKLOADS
from repro.core import cost_model as ref_cost
from repro.core import lower_bound as ref_lb
from repro.core import problems as ref_problems
from repro.core import scheduler as ref_scheduler
from repro.core import tiers as ref_tiers
from repro.launch import serve as ref_serve
from repro_torch.configs.icu_lstm import ICU_WORKLOADS
from repro_torch.core import cost_model as port_cost
from repro_torch.core import lower_bound as port_lb
from repro_torch.core import problems as port_problems
from repro_torch.core import scheduler as port_scheduler
from repro_torch.core import scheduler_torch
from repro_torch.core import tiers as port_tiers
from repro_torch.core.tiers import CC, ED, ES
from repro_torch.data import icu
from repro_torch.launch import serve

# seconds per data unit on the device tier, one per workload
UNIT_SECONDS = (2.0e-4, 3.0e-5, 6.0e-4)
# the fleet tests' end devices are 1000x slower, so the shared cloud
# carries load and independent ward plans double-book it
FLEET_UNIT_SECONDS = tuple(1000 * s for s in UNIT_SECONDS)
PYTHON_ONLY = 10 ** 9


def _pinned_model(cost_mod, workloads, tiers, unit_seconds=UNIT_SECONDS):
    up, ut = {}, {}
    for wl, sec in zip(workloads, unit_seconds):
        for tid, tier in tiers.items():
            up[(wl.name, tid)] = sec * tiers[ED].flops / tier.flops
            ut[(wl.name, tid)] = 0.0 if tier.private else (
                tier.net_latency + icu.record_bytes(wl) / tier.net_bw)
    return cost_mod.CalibratedCostModel(tiers, up, ut)


def _pinned_specs(tiers_mod, cost_mod, problems_mod, workloads, kind,
                  patients, seed):
    tiers = tiers_mod.paper_tiers() if kind == "paper" \
        else tiers_mod.tpu_tiers()
    cm = _pinned_model(cost_mod, workloads, tiers)
    jobs = problems_mod.patient_jobs(np.random.default_rng(seed), patients,
                                     30.0)
    quantum = min(min(cm.times(j)[t][1] for t in tiers) for j in jobs)
    return problems_mod.jobs_to_specs(cm, jobs, normalize=quantum)


@pytest.mark.parametrize("kind,patients,fleet", [
    ("paper", 12, (1, 1)), ("paper", 30, (2, 3)), ("tpu", 20, (1, 2))],
    ids=["paper-12", "paper-30-2x3", "tpu-20"])
def test_strategy_table_and_lower_bound_match_reference(kind, patients,
                                                        fleet):
    mpt = {CC: fleet[0], ES: fleet[1]}
    ref_specs = _pinned_specs(ref_tiers, ref_cost, ref_problems,
                              REF_WORKLOADS, kind, patients, seed=4)
    specs = _pinned_specs(port_tiers, port_cost, port_problems,
                          ICU_WORKLOADS, kind, patients, seed=4)
    ref = ref_scheduler.strategy_table(ref_specs, jax_threshold=PYTHON_ONLY,
                                       machines_per_tier=mpt)
    got = port_scheduler.strategy_table(specs, device_threshold=PYTHON_ONLY,
                                        machines_per_tier=mpt, device="cpu")
    assert list(got) == list(ref)
    for name in ref:
        assert got[name].assignment() == ref[name].assignment(), name
        assert (got[name].weighted_sum, got[name].unweighted_sum,
                got[name].last_end) == (ref[name].weighted_sum,
                                        ref[name].unweighted_sum,
                                        ref[name].last_end), name
    assert port_lb.paper_lower_bound(specs) == \
        ref_lb.paper_lower_bound(ref_specs)


def _check_invariants(results, lb, patients):
    """tests/test_system.py's end-to-end invariants."""
    ours = results["ours (algorithm 2)"]
    assert ours.weighted_sum >= lb - 1e-9
    for name, sched in results.items():
        assert ours.weighted_sum <= sched.weighted_sum + 1e-9, name
    assert len(ours.entries) == patients
    assert all(e.machine in (CC, ES, ED) for e in ours.entries)


def test_serve_run_end_to_end_on_cpu():
    results, lb = serve.run(patients=6, horizon=20.0, seed=3,
                            execute=True, verbose=False, device="cpu")
    _check_invariants(results, lb, 6)


def test_serve_run_takes_device_search_above_threshold():
    calls = scheduler_torch.tabu_search_batched.calls
    results, lb = serve.run(patients=20, horizon=20.0, seed=1,
                            execute=False, verbose=False, device="cpu",
                            device_threshold=10)
    assert scheduler_torch.tabu_search_batched.calls == calls + 1
    _check_invariants(results, lb, 20)


def test_serve_main_cli_on_cpu(capsys):
    serve.main(["--patients", "4", "--device", "cpu", "--no-execute",
                "--cloud-machines", "2", "--device-threshold", "100"])
    out = capsys.readouterr().out
    assert "ours (algorithm 2)" in out and "lower bound (eq.6)" in out


def test_validate_quantum_rejects_non_positive():
    with pytest.raises(ValueError, match="quantum"):
        serve._validate_quantum(0.0)


@pytest.fixture
def pinned_calibration(monkeypatch):
    """Both packages' `serve.calibrate` return the same fixed-cost model."""
    for mod, cost_mod, workloads in ((ref_serve, ref_cost, REF_WORKLOADS),
                                     (serve, port_cost, ICU_WORKLOADS)):
        monkeypatch.setattr(
            mod, "calibrate",
            lambda tiers, engines, unit_records=16, c=cost_mod, w=workloads:
            _pinned_model(c, w, tiers, FLEET_UNIT_SECONDS))


def test_run_wards_matches_reference(pinned_calibration):
    """Independent fleet mode: 4 wards (the batched search, greedy init)
    give identical per-ward Schedules in both packages."""
    kw = dict(wards=4, patients=8, horizon=20.0, seed=3, verbose=False,
              cloud_machines=1, edge_machines=1)
    ref, _ = ref_serve.run_wards(**kw)
    calls = scheduler_torch.tabu_search_batched.calls
    got, seconds = serve.run_wards(device="cpu", **kw)
    # the warm-up call and the timed one
    assert scheduler_torch.tabu_search_batched.calls == calls + 2
    assert seconds > 0 and len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g.assignment() == r.assignment()
        assert [(e.start, e.end) for e in g.entries] == \
            [(e.start, e.end) for e in r.entries]
        assert (g.weighted_sum, g.unweighted_sum, g.last_end) == \
            (r.weighted_sum, r.unweighted_sum, r.last_end)


def test_run_wards_contention_matches_reference(pinned_calibration):
    """Contention mode: the shared cloud is double-booked by the
    independent plans (gap > 1) and both packages' fixed-point sweeps
    return the same FleetPlan."""
    kw = dict(wards=4, patients=8, horizon=20.0, seed=3, verbose=False,
              cloud_machines=1, edge_machines=1, contention=True)
    _, _, ref = ref_serve.run_wards(**kw)
    wards, seconds, got = serve.run_wards(device="cpu", **kw)
    assert ref.contention_gap > 1.0 and ref.sweeps >= 1
    assert got.assignments == ref.assignments
    assert got.naive_assignments == ref.naive_assignments
    assert (got.naive_reported, got.sweeps) == (ref.naive_reported,
                                                ref.sweeps)
    for obj in ("weighted", "unweighted", "last"):
        assert got.fleet.objective(obj) == ref.fleet.objective(obj)
        assert got.naive_fleet.objective(obj) == \
            ref.naive_fleet.objective(obj)
    assert (got.contention_gap, got.gap_closed) == (ref.contention_gap,
                                                    ref.gap_closed)
    assert [w.weighted_sum for w in wards] == \
        [w.weighted_sum for w in got.fleet.wards]
    assert seconds > 0


@pytest.mark.parametrize("contention", [False, True],
                         ids=["independent", "contention"])
def test_serve_main_wards_cli_on_cpu(capsys, contention):
    serve.main(["--wards", "2", "--patients", "3", "--device", "cpu"]
               + (["--contention"] if contention else []))
    out = capsys.readouterr().out
    assert ("independent plans claim" in out) == contention
    assert ("fleet total weighted" in out) != contention


def test_contention_without_wards_is_an_error():
    with pytest.raises(SystemExit):
        serve.main(["--contention", "--device", "cpu"])


def test_run_wards_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.run_wards(wards=2, patients=3, verbose=False)
