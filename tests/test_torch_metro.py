"""Parity of the port's metro engine (`repro_torch.metro`) with the JAX
reference's, both on the CPU: the trace generators, the B = 1 equivalence
with `online_schedule(replan="tabu")`, the event invariants of every
policy, drain failures, elastic scale, fail-slow windows, the hedge
lifecycle, bounded retries, the streaming metrics, and the entry points
(`make_policy`, `run_metro`, `serve --metro`) without a card.

Each case runs on both packages on the same seeded inputs and holds both
to the reference test's own expected values; event logs, schedules and
metrics must agree exactly. The single-ward search is pinned to Python on
both sides (tests/metro_parity.py).
"""
import numpy as np
import pytest
import torch

from metro_parity import (MPT, PKGS, PORT, REF, assert_same_run,
                          cloud_job, isolate_reference_dispatch,  # noqa: F401
                          on_both, policy, run_metro, timing_free)
from repro_torch.core.tiers import CC, ED, ES


def _scenario(M, seed=0, wards=2, horizon=60.0, **kw):
    return M.traces.default_scenario(seed, wards, horizon, **kw)


def _specs(jobs):
    return [(j.name, j.release, j.weight, dict(j.proc), dict(j.trans),
             j.workload, j.deadline) for j in jobs]


# ------------------------------------------------------------ the traces
@pytest.mark.parametrize("pack", sorted(PORT.traces.SCENARIO_PACKS))
def test_scenario_packs_match_reference(pack):
    ref, port = (M.traces.make_scenario(pack, 5) for M in PKGS)
    assert port.name == ref.name and port.jobs == ref.jobs
    assert [_specs(t) for t in port.traces] == \
        [_specs(t) for t in ref.traces]
    for field in ("failures", "scales", "network", "slowdowns"):
        assert [tuple(vars(e).values()) for e in getattr(port, field)] == \
            [tuple(vars(e).values()) for e in getattr(ref, field)], field


def test_trace_generators_match_reference():
    got = []
    for M in PKGS:
        T = M.traces
        ward = T.ward_trace(np.random.default_rng(3), 0, 90.0)
        times = T.episode_times(np.random.default_rng(0), 400.0, 0.2,
                                diurnal_amp=0.0,
                                surges=[(100.0, 200.0, 4.0)])
        got.append((_specs(ward), list(times),
                    T.intensity(10.0, 1.0, diurnal_amp=0.0,
                                surges=[(5.0, 15.0, 3.0)])))
    assert got[0] == got[1]
    ward, times, surged = got[1]
    assert surged == pytest.approx(4.0)
    assert sum(100.0 <= t < 200.0 for t in times) > len(times) / 2
    stages = {s.short: s for s in PORT.traces.EPISODE_STAGES}
    for name, _, weight, _, _, workload, deadline in ward:
        st = stages[name.split("-")[1]]
        assert (weight, deadline, workload) == \
            (st.weight, st.deadline, st.workload)


# ------------------------------------------------- parity with DESIGN.md §7
def test_b1_no_failure_tabu_matches_online_schedule():
    """With one ward, no failures and the tabu policy, the engine's event
    sequence is online_schedule(replan="tabu"), in both packages."""
    for seed in range(4):
        for mpt in ({CC: 1, ES: 1}, {CC: 2, ES: 3}):
            got = []
            for M in PKGS:
                jobs = M.problems.poisson_jobs(np.random.default_rng(seed),
                                               n=14, rate=0.3)
                online = M.online.online_schedule(
                    jobs, replan="tabu", machines_per_tier=mpt, **M.pin)
                metro = M.engine.simulate_metro(
                    [jobs], policy(M, "tabu"), machines_per_tier=mpt)
                assert [(e.machine, e.arrival, e.start, e.end)
                        for e in metro.wards[0].entries] == \
                    [(e.machine, e.arrival, e.start, e.end)
                     for e in online.entries]
                assert metro.wards[0].weighted_sum == online.weighted_sum
                got.append(metro)
            assert_same_run(*got)


# ------------------------------------------------------- event invariants
def _check_schedule_invariants(result, machines_per_tier):
    for sched in result.wards:
        for e in sched.entries:
            assert e.arrival >= e.job.release - 1e-9
            assert e.start >= e.arrival - 1e-9
            assert e.end == pytest.approx(e.start + e.job.proc[e.machine])

    def peak(spans):
        live = top = 0
        for _, d in sorted([(s, 1) for s, _ in spans]
                           + [(t, -1) for _, t in spans]):
            live += d
            top = max(top, live)
        return top

    assert peak([(e.start, e.end) for s in result.wards for e in s.entries
                 if e.machine == CC]) <= machines_per_tier[CC]
    for s in result.wards:
        assert peak([(e.start, e.end) for e in s.entries
                     if e.machine == ES]) <= machines_per_tier[ES]
    completes = [ev for ev in result.event_log if ev[0] == "complete"]
    assert len(completes) == sum(len(s.entries) for s in result.wards)
    for _, t, b, i, tier, start, end, response, missed, attempts \
            in completes:
        e = result.wards[b].entries[i]
        assert (tier, start, end) == (e.machine, e.start, e.end)
        assert t == end and start <= end
        assert response == pytest.approx(end - e.job.release)
        assert missed == int(response > e.job.deadline)
        assert attempts >= 1


@pytest.mark.parametrize("name", ["greedy", "tabu", "fleet"])
def test_event_order_invariants(name):
    kw = dict(max_count=2, max_sweeps=1) if name == "fleet" else {}

    def case(M):
        tr, fails, _ = _scenario(M, seed=11, wards=2, horizon=45.0,
                                 elastic=False)
        res = M.engine.simulate_metro(tr, policy(M, name, **kw),
                                      machines_per_tier=MPT, failures=fails)
        assert res.events > sum(len(t) for t in tr)
        return res

    res = on_both(case)
    _check_schedule_invariants(res, MPT)
    assert 0.0 <= res.metrics.miss_rate <= 1.0


def test_seed_determinism_and_policy_comparison():
    def case(M, name):
        tr, fails, scales = _scenario(M, seed=9, wards=2, horizon=50.0)
        kw = dict(max_count=2, max_sweeps=1) if name == "fleet" else {}
        res = M.engine.simulate_metro(tr, policy(M, name, **kw),
                                      machines_per_tier=MPT, failures=fails,
                                      scale_events=scales)
        assert res.metrics.completions == sum(len(t) for t in tr)
        return res

    out = {}
    for name in ("greedy", "tabu", "fleet"):
        out[name] = on_both(lambda M: case(M, name))
    again = case(PORT, "tabu")
    assert again.event_log == out["tabu"].event_log
    assert out["tabu"].metrics.total.mean <= \
        out["greedy"].metrics.total.mean * 1.05


# ------------------------------------------------------- failure semantics
def _drain_delays_successor(M):
    jobs = [cloud_job(M, "A", 0.0, proc_c=10.0),
            cloud_job(M, "B", 1.0, proc_c=5.0, trans_c=1.0)]
    fail = M.engine.FailureEvent(time=5.0, tier=CC, duration=10.0)
    res = M.engine.simulate_metro([jobs], M.policies.GreedyPolicy(),
                                  machines_per_tier={CC: 1, ES: 1},
                                  failures=[fail])
    a, b = res.wards[0].entries
    assert (a.start, a.end) == (2.0, 12.0)
    assert (b.start, b.end) == (22.0, 27.0)
    assert next(ev for ev in res.event_log if ev[0] == "fail")[5] == 22.0
    return res


def _tabu_around_failure(M):
    jobs = [M.JobSpec("A", 0.0, 1.0, {CC: 10.0, ES: 30.0, ED: 60.0},
                      {CC: 2.0, ES: 1.0, ED: 0.0}),
            M.JobSpec("B", 1.0, 1.0, {CC: 5.0, ES: 12.0, ED: 60.0},
                      {CC: 1.0, ES: 1.0, ED: 0.0})]
    fail = M.engine.FailureEvent(time=5.0, tier=CC, duration=30.0)
    kw = dict(machines_per_tier={CC: 1, ES: 1}, failures=[fail])
    greedy = M.engine.simulate_metro([jobs], M.policies.GreedyPolicy(), **kw)
    tabu = M.engine.simulate_metro([jobs], policy(M, "tabu"), **kw)
    assert tabu.wards[0].weighted_sum <= greedy.wards[0].weighted_sum
    assert tabu.wards[0].entries[0].end == greedy.wards[0].entries[0].end
    return tabu


def _elastic_scale_up(M):
    jobs = [cloud_job(M, "A", 0.0, proc_c=20.0),
            cloud_job(M, "B", 0.0, proc_c=20.0, trans_c=3.0)]
    up = M.engine.simulate_metro(
        [jobs], M.policies.GreedyPolicy(), machines_per_tier={CC: 1, ES: 1},
        scale_events=[M.engine.ScaleEvent(time=1.0, tier=CC, delta=1)])
    a, b = up.wards[0].entries
    assert b.start < a.end
    with pytest.raises(ValueError):
        M.engine.simulate_metro(
            [jobs], M.policies.GreedyPolicy(),
            machines_per_tier={CC: 1, ES: 1},
            scale_events=[M.engine.ScaleEvent(time=1.0, tier=CC, delta=-1)])
    return up


# ------------------------------------------------------- fail-slow windows
def _slowdown_stretches(M):
    jobs = [cloud_job(M, "A", 0.0, proc_c=10.0),
            cloud_job(M, "B", 0.0, proc_c=4.0, trans_c=3.0)]
    slow = M.engine.SlowdownEvent(time=5.0, tier=CC, duration=100.0,
                                  factor=0.5)
    res = M.engine.simulate_metro([jobs], M.policies.GreedyPolicy(),
                                  machines_per_tier={CC: 1, ES: 1},
                                  slowdowns=[slow])
    a, b = sorted(res.wards[0].entries, key=lambda e: e.start)
    assert (a.start, a.end) == (2.0, 19.0)
    assert (b.start, b.end) == (pytest.approx(19.0), pytest.approx(27.0))
    assert ("slow", 5.0, CC, -1, 0, 105.0, 0.5) in res.event_log
    return res


# ------------------------------------------------------ hedge lifecycle
class _HedgeTo:
    """Test policy: inner decisions untouched, hedge always to `tier`."""
    name = "hedge_to"
    joint = False
    replans_on_fleet_events = False

    def __init__(self, M, tier):
        self.inner = M.policies.GreedyPolicy()
        self.tier = tier

    def decide(self, requests, now):
        return self.inner.decide(requests, now)

    def hedge(self, req, now):
        return self.tier


def _hedge(M, proc_d, factor, tier=ED, failures=(), slowdowns=None,
           jobs=None):
    jobs = jobs or [cloud_job(M, "A", 0.0, proc_c=10.0, proc_d=proc_d)]
    slowdowns = slowdowns or [M.engine.SlowdownEvent(
        time=4.0, tier=CC, duration=100.0, factor=factor)]
    return M.engine.simulate_metro([jobs], _HedgeTo(M, tier),
                                   machines_per_tier={CC: 1, ES: 1},
                                   slowdowns=slowdowns,
                                   failures=list(failures),
                                   hedge_factor=1.5)


def _hedge_backup_wins(M):
    res = _hedge(M, proc_d=13.0, factor=0.1)
    (a,) = res.wards[0].entries
    assert (a.machine, a.start, a.end) == (ED, 17.0, 30.0)
    assert ("hedge", 17.0, 0, 0, CC, ED) in res.event_log
    cancel = next(e for e in res.event_log if e[0] == "hedge_cancel")
    assert cancel[:5] == ("hedge_cancel", 30.0, 0, 0, CC)
    m = res.metrics
    assert (m.hedges, m.hedge_wins, m.hedge_by_tier) == (1, 1, {ED: 1})
    assert m.hedge_waste == pytest.approx(4.6)
    return res


def _hedge_primary_wins(M):
    res = _hedge(M, proc_d=200.0, factor=0.5)
    (a,) = res.wards[0].entries
    assert (a.machine, a.end) == (CC, 20.0)
    assert (res.metrics.hedges, res.metrics.hedge_wins) == (1, 0)
    assert res.metrics.hedge_waste == pytest.approx(3.0)
    return res


def _crash_promotes_backup(M):
    crash = M.engine.FailureEvent(time=20.0, tier=CC, duration=5.0,
                                  kill_running=True)
    res = _hedge(M, proc_d=13.0, factor=0.1, failures=[crash])
    (a,) = res.wards[0].entries
    assert (a.machine, a.end) == (ED, 30.0)
    assert ("hedge_promote", 20.0, 0, 0, ED) in res.event_log
    m = res.metrics
    assert (m.retries, m.completions, m.hedge_wins) == (1, 1, 1)
    return res


def _crash_on_backup(M):
    job = M.JobSpec(name="A", release=0.0, weight=1.0,
                    proc={CC: 30.0, ES: 10.0, ED: 500.0},
                    trans={CC: 2.0, ES: 0.0, ED: 0.0})
    slow = M.engine.SlowdownEvent(time=2.0, tier=ES, ward=0,
                                  duration=100.0, factor=0.1)
    crash = M.engine.FailureEvent(time=20.0, tier=CC, duration=5.0,
                                  kill_running=True)
    res = _hedge(M, 0.0, 0.0, tier=CC, failures=[crash], slowdowns=[slow],
                 jobs=[job])
    (a,) = res.wards[0].entries
    assert a.machine == ES and a.end == pytest.approx(82.0)
    assert not any(e[0] == "kill" for e in res.event_log)
    m = res.metrics
    assert (m.retries, m.hedges, m.hedge_wins, m.completions) == (0, 1, 0, 1)
    return res


def _one_hedge_per_job(M):
    slows = [M.engine.SlowdownEvent(time=4.0, tier=CC, duration=100.0,
                                    factor=0.5),
             M.engine.SlowdownEvent(time=18.0, tier=CC, duration=50.0,
                                    factor=0.5)]
    res = _hedge(M, proc_d=200.0, factor=0.0, slowdowns=slows)
    assert res.metrics.hedges == 1
    assert sum(1 for e in res.event_log if e[0] == "hedge") == 1
    return res


# --------------------------------------------- bounded retries / backoff
def _retry_cap(M):
    jobs = [cloud_job(M, "A", 0.0, proc_c=10.0, deadline=30.0,
                       workload="alert")]
    crash = M.engine.FailureEvent(time=5.0, tier=CC, duration=10.0,
                                  kill_running=True)
    res = M.engine.simulate_metro([jobs], M.policies.GreedyPolicy(),
                                  machines_per_tier={CC: 1, ES: 1},
                                  failures=[crash], max_attempts=1)
    assert ("giveup", 5.0, 0, 0, "A", 1) in res.event_log
    m = res.metrics
    assert (m.completions, m.shed, m.retry_exhausted, m.finished) == \
        (0, 1, 1, 1)
    uncapped = M.engine.simulate_metro(
        [jobs], M.policies.GreedyPolicy(), machines_per_tier={CC: 1, ES: 1},
        failures=[crash], max_attempts={"phenotype": 1})
    assert (uncapped.metrics.completions,
            uncapped.metrics.retry_exhausted) == (1, 0)
    return res


def _retry_backoff(M):
    jobs = [cloud_job(M, "A", 0.0, proc_c=10.0)]
    crash = M.engine.FailureEvent(time=5.0, tier=CC, duration=10.0,
                                  kill_running=True)
    res = M.engine.simulate_metro([jobs], M.policies.GreedyPolicy(),
                                  machines_per_tier={CC: 1, ES: 1},
                                  failures=[crash], retry_backoff=3.0)
    assert ("retry", 8.0, 0, 0, 2) in res.event_log
    (a,) = res.wards[0].entries
    assert (a.start, a.end) == (15.0, 25.0)
    s = res.summary()
    assert s["retries_by_tier"] == {CC: 1}
    assert s["wasted_by_tier"][CC] == pytest.approx(3.0)
    return res


@pytest.mark.parametrize("case", [
    _drain_delays_successor, _tabu_around_failure, _elastic_scale_up,
    _slowdown_stretches, _hedge_backup_wins, _hedge_primary_wins,
    _crash_promotes_backup, _crash_on_backup, _one_hedge_per_job,
    _retry_cap, _retry_backoff], ids=lambda f: f.__name__[1:])
def test_engine_case_matches_reference(case):
    on_both(case)


def test_engine_rejects_what_the_reference_rejects():
    for M in PKGS:
        E, P = M.engine, M.policies
        tr, _, _ = _scenario(M, seed=1, wards=1, horizon=20.0)
        eng = E.MetroEngine(tr, P.GreedyPolicy(), machines_per_tier=MPT)
        eng.run()
        jobs = [[cloud_job(M, "A", 0.0, proc_c=1.0)]]
        bad = [
            (lambda: eng.run(), "runs once"),
            (lambda: E.MetroEngine(tr, P.GreedyPolicy(),
                                   machines_per_tier=MPT,
                                   failures=[E.FailureEvent(
                                       time=1.0, tier=CC, ward=0)]), None),
            (lambda: E.MetroEngine([], P.GreedyPolicy()), "at least one"),
            (lambda: E.MetroEngine(jobs, P.GreedyPolicy(),
                                   slowdowns=[E.SlowdownEvent(
                                       time=0.0, factor=1.0)]), "factor"),
            (lambda: E.MetroEngine(jobs, _HedgeTo(M, ED),
                                   hedge_factor=1.0), "hedge_factor"),
            (lambda: E.MetroEngine(jobs, P.GreedyPolicy(),
                                   hedge_factor=1.5), "hedge"),
            (lambda: E.MetroEngine(jobs, P.GreedyPolicy(),
                                   retry_backoff=-1.0), "retry_backoff"),
            (lambda: E.MetroEngine(jobs, P.GreedyPolicy(),
                                   max_attempts={"alert": 0}),
             "max_attempts"),
            (lambda: P.make_policy("nope"), "unknown metro policy")]
        for make, msg in bad:
            with pytest.raises(ValueError, match=msg):
                make()
        slow = E.SlowdownEvent(time=4.0, tier=CC, duration=100.0,
                               factor=0.1)
        with pytest.raises(ValueError, match="hedge policy returned"):
            E.simulate_metro([[cloud_job(M, "A", 0.0, proc_c=10.0)]],
                             _HedgeTo(M, CC),
                             machines_per_tier={CC: 1, ES: 1},
                             slowdowns=[slow], hedge_factor=1.5)


def test_capacity_integral_prices_slowdowns_and_outages():
    for M in PKGS:
        pool = M.engine._Pool(CC, 1)
        slot = pool.slots[0]
        slot.slowdowns = [(10.0, 20.0, 0.5)]
        got = [pool.capacity_integral(30.0)]
        for outages in ([(8.0, 22.0)], [(15.0, 40.0)]):
            slot.outages = outages
            got.append(pool.capacity_integral(30.0))
        assert got == [pytest.approx(25.0), pytest.approx(16.0),
                       pytest.approx(12.5)]
    win = [(5.0, 25.0, 0.5), (10.0, 15.0, 0.4)]
    for start, work in ((0.0, 3.0), (2.0, 10.0), (7.0, 4.0), (30.0, 5.0)):
        ends = [M.engine._finish_time(win, start, work) for M in PKGS]
        assert ends[0] == ends[1]
        assert PORT.engine._work_done(win, start, ends[1]) == \
            pytest.approx(work)


# -------------------------------------------------- HedgingPolicy gate
def _hedge_req(M, weight, projected_end, reserved_es=0.0):
    job = M.JobSpec(name="J", release=0.0, weight=weight,
                    proc={CC: 5.0, ES: 4.0, ED: 50.0},
                    trans={CC: 2.0, ES: 1.0, ED: 0.0})
    return M.policies.HedgeRequest(
        ward=0, job=job, tier=CC, projected_end=projected_end,
        busy={CC: [], ES: []}, reserved={CC: [0.0], ES: [reserved_es]},
        machines_per_tier={CC: 1, ES: 1})


def test_hedging_policy_gate_matches_reference():
    for M in PKGS:
        pol = M.policies.HedgingPolicy(min_gain=2.0)
        assert pol.hedge(_hedge_req(M, 1.0, 6.9), 0.0) is None
        assert pol.hedge(_hedge_req(M, 1.0, 7.1), 0.0) == ES
        assert pol.hedge(_hedge_req(M, 1.0, 7.1, reserved_es=50.0),
                         0.0) is None
        pol._see([M.JobSpec(name="H", release=0.0, weight=2.0,
                            proc={CC: 1.0}, trans={CC: 0.0})])
        assert pol.hedge(_hedge_req(M, 1.0, 100.0), 0.0) is None
        assert pol.hedge(_hedge_req(M, 2.0, 100.0), 0.0) == ES
        inner = policy(M, "tabu")
        wrapped = M.policies.HedgingPolicy(inner=inner)
        assert (wrapped.joint, wrapped.replans_on_fleet_events) == \
            (inner.joint, inner.replans_on_fleet_events)


# --------------------------------------------------------------- metrics
def test_streaming_metrics_match_reference():
    rng = np.random.default_rng(0)
    xs = [float(x) for x in rng.lognormal(2.0, 1.0, size=5000)]
    got = []
    for M in PKGS:
        Q = M.metrics.StreamingQuantiles
        sq, half = Q(), Q()
        for i, x in enumerate(xs):
            (sq if i % 2 == 0 else half).add(x)
        sq.merge(half)
        tail = Q(1.0, 100.0, 8)
        for x in (0.5, 0.9, 5.0, 50.0, 200.0):
            tail.add(x)
        m = M.metrics.MetroMetrics(window=10.0, keep_windows=3)
        for k in range(400):
            m.record(float(k), "threat" if k % 2 else "alert",
                     response=5.0 + (k % 7), deadline=8.0, tier=CC,
                     proc=1.0)
        m.record_shed(400.0, "alert")
        m.flush()
        got.append(([sq.quantile(q) for q in (0.5, 0.95, 0.99)],
                    sq.n, sq.max, sq.mean, tail.underflow, tail.overflow,
                    len(m.recent), m.miss_rate_by_class(), m.summary()))
    assert got[0] == got[1]
    quants, n, top, mean, under, over, recent, _, summary = got[1]
    assert n == len(xs) and (under, over) == (2, 1) and recent == 3
    for q, v in zip((0.5, 0.95, 0.99), quants):
        assert v == pytest.approx(float(np.quantile(xs, q)), rel=0.06)
    assert top == pytest.approx(max(xs))
    assert "p999" in summary and "recent_miss_rate" in summary


# ------------------------------------------------------------ entry points
def test_search_policies_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    P = PORT.policies
    for make in (lambda: P.make_policy("tabu"),
                 lambda: P.make_policy("fleet"),
                 lambda: P.TabuPolicy(device_threshold=10),
                 lambda: PORT.serve.run_metro(scenario="diurnal_day",
                                              verbose=False)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # greedy and the wrappers around it never search: no device needed
    assert P.make_policy("greedy").name == "greedy"
    assert P.make_policy("shed").name == "shed"
    assert P.make_policy("tabu", device="cpu").device == torch.device("cpu")


def test_run_metro_matches_reference_with_every_option(tmp_path):
    kw = dict(scenario="mass_casualty_crash", wards=2, hours=0.75,
              policies=("greedy", "tabu", "fleet", "shed"),
              check_determinism=True, sanitize=True, retry_backoff=0.5,
              max_attempts=3)
    ref, port = run_metro(REF, **kw), run_metro(PORT, **kw)
    assert list(port) == list(ref)
    for name in ref:
        assert timing_free(port[name]) == timing_free(ref[name])
        assert port[name]["device_searches"] == 0     # two wards only


def test_serve_metro_cli_on_the_cpu(tmp_path, capsys):
    out = PORT.serve.main([
        "--metro", "--device", "cpu", "--scenario", "degraded_network",
        "--metro-policies", "tabu", "--device-threshold", "1000000000",
        "--hedge", "--metrics-out", str(tmp_path / "m.json")])
    text = capsys.readouterr().out
    assert "metro[degraded_network]: 4 wards" in text and "dsearch" in text
    ref = run_metro(REF, scenario="degraded_network", policies=("tabu",),
                    hedge=True)
    assert timing_free(out["tabu"]) == timing_free(ref["tabu"])
    assert out["tabu"]["device_searches"] == 4
    assert (tmp_path / "m.json").exists()
