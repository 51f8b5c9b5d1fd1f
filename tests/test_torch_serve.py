"""The port's scheduler front end and serving driver against the JAX
reference's, on the CPU.

Calibration times real inference, so its costs depend on the host; the
table comparison pins one CalibratedCostModel built from fixed unit costs
in both packages, and pins the Python search backend on both sides (the
reference's `search` output depends on its dispatch state otherwise)."""
import numpy as np
import pytest

from repro.configs.icu_lstm import ICU_WORKLOADS as REF_WORKLOADS
from repro.core import cost_model as ref_cost
from repro.core import lower_bound as ref_lb
from repro.core import problems as ref_problems
from repro.core import scheduler as ref_scheduler
from repro.core import tiers as ref_tiers
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
PYTHON_ONLY = 10 ** 9


def _pinned_specs(tiers_mod, cost_mod, problems_mod, workloads, kind,
                  patients, seed):
    tiers = tiers_mod.paper_tiers() if kind == "paper" \
        else tiers_mod.tpu_tiers()
    up, ut = {}, {}
    for wl, sec in zip(workloads, UNIT_SECONDS):
        for tid, tier in tiers.items():
            up[(wl.name, tid)] = sec * tiers[ED].flops / tier.flops
            ut[(wl.name, tid)] = 0.0 if tier.private else (
                tier.net_latency + icu.record_bytes(wl) / tier.net_bw)
    cm = cost_mod.CalibratedCostModel(tiers, up, ut)
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
