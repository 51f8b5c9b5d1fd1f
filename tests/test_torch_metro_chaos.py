"""Parity of the port's metro engine (`repro_torch.metro`,
`repro_torch.launch.serve.run_metro`) with the JAX reference's on the
chaos scenario packs, both on the CPU.

The yardstick is the event-log CRC the reference's benchmark committed in
BENCH_scheduler.json for each pack (`metro_scenarios.<pack>
.event_log_hash_tabu`, `metro_hedging.event_log_hash_{unhedged,hedged}`),
measured with the single-ward search pinned to Python, as here: port =
live reference = committed. The tabu replans of four wards at one event
go through each package's batched device search on non-integer
`metro_costs` instances; the port replays every such call the reference
makes and must return the same assignments. Then the reference's own
crash, shedding and network cases, each run on both packages.
"""
import copy
import functools
import json
from pathlib import Path

import pytest

from metro_parity import (PKGS, PORT, REF, assert_same_run, cloud_job, crc,
                          entries, isolate_reference_dispatch,  # noqa: F401
                          on_both, policy, run_metro, run_pack, timing_free,
                          to_port)
from repro_torch.core import scheduler_torch
from repro_torch.core.tiers import CC, ED, ES

BENCH = json.loads((Path(__file__).resolve().parents[1]
                    / "BENCH_scheduler.json").read_text())
CHAOS_PACKS = ("edge_brownout", "mass_casualty_crash", "degraded_network",
               "diurnal_day")
PACK_POLICIES = ("greedy", "tabu", "shed")
# the reference's batched (B >= 4) search_batched calls per pack under
# tabu at the canonical shape, all on the round regime
BATCHED_CALLS = {"mass_casualty_crash": 7, "degraded_network": 4}
# the default pack is cut to half an hour of its 2 h horizon to keep this
# file's time small; at 0.5 h fleet still makes ~100 batched searches
DEFAULT_HOURS = 0.5


def _call_key(args):
    return tuple(sorted(args.items()))


@functools.lru_cache(maxsize=None)
def _reference(key):
    """The reference's run_metro(**dict(key)) with every search_batched
    call of four or more wards recorded: (summaries, [(kwargs,
    assignments, weighted sums)])."""
    calls = []
    real = REF.scheduler.search_batched

    def spy(problems, **kw):
        args = copy.deepcopy(dict(kw, problems=problems))
        plans = real(problems, **kw)
        if len(problems) >= REF.scheduler.BATCHED_SEARCH_MIN_WARDS:
            calls.append((args, [p.assignment() for p in plans],
                          [p.weighted_sum for p in plans]))
        return plans

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(REF.scheduler, "search_batched", spy)
        out = run_metro(REF, **dict(key))
    return out, calls


def _both(**kw):
    ref, calls = _reference(_call_key(kw))
    port = run_metro(PORT, **kw)
    assert list(port) == list(ref)
    for name in ref:
        assert timing_free(port[name]) == timing_free(ref[name]), name
    return ref, port, calls


# ------------------------------------------------------- committed CRCs
@pytest.mark.parametrize("pack", CHAOS_PACKS)
def test_chaos_pack_crc_matches_reference_and_committed(pack):
    ref, port, calls = _both(scenario=pack, policies=PACK_POLICIES)
    want = BENCH["metro_scenarios"][pack]["event_log_hash_tabu"]
    assert port["tabu"]["event_log_hash"] == ref["tabu"]["event_log_hash"] \
        == want
    assert port["tabu"]["device_searches"] == len(calls) == \
        BATCHED_CALLS.get(pack, 0)
    for name in ("greedy", "shed"):
        assert port[name]["device_searches"] == 0


@pytest.mark.parametrize("hedged", [False, True],
                         ids=["unhedged", "hedged"])
def test_fail_slow_tail_crc_matches_reference_and_committed(hedged):
    ref, port, _ = _both(scenario="fail_slow_tail", policies=("tabu",),
                         hedge=hedged)
    key = "hedged" if hedged else "unhedged"
    want = BENCH["metro_hedging"][f"event_log_hash_{key}"]
    assert port["tabu"]["event_log_hash"] == ref["tabu"]["event_log_hash"] \
        == want


@pytest.mark.parametrize("pack", sorted(BATCHED_CALLS))
def test_batched_replans_match_reference_call_by_call(pack):
    """Every four-ward tabu replan the reference's run makes, replayed
    through the port's search_batched on the CPU: the same assignments
    and, from them, the same objectives."""
    _, calls = _reference(_call_key(dict(scenario=pack,
                                         policies=PACK_POLICIES)))
    assert len(calls) == BATCHED_CALLS[pack]
    before = scheduler_torch.tabu_search_batched.calls
    for args, want, sums in calls:
        kw = to_port(args)
        kw["device_threshold"] = kw.pop("jax_threshold")
        plans = PORT.scheduler.search_batched(device="cpu", **kw)
        assert [p.assignment() for p in plans] == want
        assert [p.weighted_sum for p in plans] == sums
        assert all(isinstance(t, str) for p in plans
                   for t in p.assignment())
    assert scheduler_torch.tabu_search_batched.calls - before == len(calls)


@pytest.mark.parametrize("name", ["tabu", "fleet"])
def test_default_pack_matches_reference(name):
    ref, port, _ = _both(scenario="default", policies=(name,),
                         hours=DEFAULT_HOURS)
    assert port[name]["event_log_hash"] == ref[name]["event_log_hash"]
    assert port[name]["device_searches"] > 0


# ------------------------------------------------------------ crash kills
def _crash_retry(M):
    jobs = [cloud_job(M, "A", 0.0, proc_c=10.0)]
    crash = M.engine.FailureEvent(time=5.0, tier=CC, duration=10.0,
                                  kill_running=True)
    res = M.engine.simulate_metro([jobs], M.policies.GreedyPolicy(),
                                  machines_per_tier={CC: 1, ES: 1},
                                  failures=[crash])
    (a,) = res.wards[0].entries
    assert (a.machine, a.start, a.end) == (CC, 15.0, 25.0)
    assert next(ev for ev in res.event_log if ev[0] == "kill") == \
        ("kill", 5.0, 0, 0, CC, 0, 3.0, 1)
    assert next(ev for ev in res.event_log if ev[0] == "fail") == \
        ("fail", 5.0, CC, -1, 0, 15.0, 1)
    m = res.metrics
    assert (m.retries, m.max_attempts, m.completions, m.shed) == (1, 2, 1, 0)
    assert m.wasted_seconds == pytest.approx(3.0)
    assert [ev[0] for ev in res.event_log] == \
        ["arrive", "fail", "kill", "recover", "complete"]
    return res


def _crash_failover(M):
    job = M.JobSpec(name="A", release=0.0, weight=1.0,
                    proc={CC: 10.0, ES: 12.0, ED: 100.0},
                    trans={CC: 2.0, ES: 1.0, ED: 0.0})
    crash = M.engine.FailureEvent(time=5.0, tier=CC, duration=50.0,
                                  kill_running=True)
    res = M.engine.simulate_metro([[job]], policy(M, "tabu"),
                                  machines_per_tier={CC: 1, ES: 1},
                                  failures=[crash])
    (a,) = res.wards[0].entries
    assert (a.machine, a.end) == (ES, 5.0 + 1.0 + 12.0)
    comp = next(ev for ev in res.event_log if ev[0] == "complete")
    assert comp[4] == ES and comp[-1] == 2
    return res


def _crash_busiest(M):
    jobs = [cloud_job(M, "A", 0.0, proc_c=20.0),
            cloud_job(M, "B", 0.0, proc_c=3.0, trans_c=1.0)]
    crash = M.engine.FailureEvent(time=10.0, tier=CC, duration=5.0,
                                  kill_running=True)
    res = M.engine.simulate_metro([jobs], M.policies.GreedyPolicy(),
                                  machines_per_tier={CC: 2, ES: 1},
                                  failures=[crash])
    kills = [ev for ev in res.event_log if ev[0] == "kill"]
    assert len(kills) == 1 and kills[0][2:4] == (0, 0)
    assert res.metrics.completions == 2
    return res


def _drain(M):
    jobs = [cloud_job(M, "A", 0.0, proc_c=10.0)]
    drain = M.engine.FailureEvent(time=5.0, tier=CC, duration=10.0)
    res = M.engine.simulate_metro([jobs], M.policies.GreedyPolicy(),
                                  machines_per_tier={CC: 1, ES: 1},
                                  failures=[drain])
    assert not any(ev[0] == "kill" for ev in res.event_log)
    (a,) = res.wards[0].entries
    assert (a.start, a.end) == (2.0, 12.0) and res.metrics.retries == 0
    return res


def _same_timestamp(M):
    E = M.engine
    res = E.simulate_metro([[cloud_job(M, "A", 0.0, proc_c=1.0)]],
                           M.policies.GreedyPolicy(),
                           machines_per_tier={CC: 2, ES: 1},
                           failures=[E.FailureEvent(time=5.0, duration=5.0),
                                     E.FailureEvent(time=10.0,
                                                    duration=3.0)],
                           scale_events=[E.ScaleEvent(time=10.0, delta=1)])
    assert [ev[0] for ev in res.event_log
            if ev[0] in ("fail", "scale", "recover") and ev[1] == 10.0] \
        == ["fail", "scale", "recover"]
    return res


class _ShedAll:
    """Degenerate policy: sheds every movable job (accounting probe)."""
    name = "shed_all"
    joint = False
    replans_on_fleet_events = False

    def __init__(self, shed):
        self.shed = shed

    def decide(self, requests, now):
        return [[self.shed] * len(req.movable) for req in requests]


def _shed_accounting(M):
    jobs = [cloud_job(M, "A", 0.0, proc_c=5.0, deadline=30.0, weight=2.0,
                       workload="alert"),
            cloud_job(M, "B", 1.0, proc_c=5.0, deadline=30.0, weight=1.0,
                       workload="phenotype")]
    res = M.engine.simulate_metro([jobs], _ShedAll(M.policies.SHED),
                                  machines_per_tier={CC: 1, ES: 1})
    m = res.metrics
    assert (m.completions, m.shed, m.finished) == (0, 2, 2)
    assert m.miss_rate == m.shed_rate == m.weighted_miss_rate == 1.0
    assert m.by_class == {"alert": [0, 0, 1], "phenotype": [0, 0, 1]}
    assert res.wards[0].entries == []
    assert [ev for ev in res.event_log if ev[0] == "shed"] == \
        [("shed", 0.0, 0, 0, "A"), ("shed", 1.0, 0, 1, "B")]
    return res


def _network_reroute(M):
    job = M.JobSpec(name="A", release=1.0, weight=1.0,
                    proc={CC: 5.0, ES: 20.0, ED: 200.0},
                    trans={CC: 2.0, ES: 1.0, ED: 0.0})
    net = M.engine.NetworkEvent(time=0.0, duration=10.0, tier=CC,
                                factor=10.0)
    res = M.engine.simulate_metro([[job]], M.policies.GreedyPolicy(),
                                  machines_per_tier={CC: 1, ES: 1},
                                  network_events=[net])
    (a,) = res.wards[0].entries
    assert (a.machine, a.arrival) == (ES, 2.0)
    assert [ev for ev in res.event_log if ev[0] == "net"] == \
        [("net", 0.0, CC, 10.0, 1), ("net", 10.0, CC, 10.0, 0)]
    return res


@pytest.mark.parametrize("case", [
    _crash_retry, _crash_failover, _crash_busiest, _drain, _same_timestamp,
    _shed_accounting, _network_reroute], ids=lambda f: f.__name__[1:])
def test_engine_case_matches_reference(case):
    on_both(case)


def test_shedding_policy_spares_the_life_critical_class():
    runs = {}
    for M in PKGS:
        _, runs[M.name, "shed"] = run_pack(
            M, "mass_casualty_crash", lambda M: M.policies.SheddingPolicy())
        _, runs[M.name, "greedy"] = run_pack(M, "mass_casualty_crash",
                                             "greedy")
    for name in ("shed", "greedy"):
        assert_same_run(runs["repro", name], runs["repro_torch", name])
    m = runs["repro_torch", "shed"].metrics
    w_max = max(m.class_weight.values())
    assert m.shed > 0
    assert all(shed == 0 for cls, (_, _, shed) in m.by_class.items()
               if m.class_weight[cls] >= w_max)
    assert m.critical_miss_rate < \
        runs["repro_torch", "greedy"].metrics.critical_miss_rate


def test_bad_decisions_and_network_events_rejected_like_the_reference():
    class _Mars:
        name, joint, replans_on_fleet_events = "mars", False, False

        def decide(self, requests, now):
            return [["mars"] * len(req.movable) for req in requests]

    for M in PKGS:
        jobs = [[cloud_job(M, "A", 0.0, proc_c=1.0)]]
        with pytest.raises(ValueError, match="mars"):
            M.engine.simulate_metro(jobs, _Mars(),
                                    machines_per_tier={CC: 1, ES: 1})
        for ev, msg in ((M.engine.NetworkEvent(time=0.0, tier=ED),
                         "shared tier"),
                        (M.engine.NetworkEvent(time=0.0, factor=0.0),
                         "factor")):
            with pytest.raises(ValueError, match=msg):
                M.engine.MetroEngine(jobs, M.policies.GreedyPolicy(),
                                     machines_per_tier={CC: 1, ES: 1},
                                     network_events=[ev])


def test_network_factors_compound_and_unwind():
    for M in PKGS:
        E = M.engine
        eng = E.MetroEngine([[cloud_job(M, "A", 0.0, proc_c=1.0)]],
                            M.policies.GreedyPolicy(),
                            machines_per_tier={CC: 1, ES: 1})
        e1 = E.NetworkEvent(time=0.0, duration=10.0, tier=CC, factor=2.0)
        e2 = E.NetworkEvent(time=1.0, duration=5.0, tier=CC, factor=3.0)
        eng._on_net(0.0, e1, True)
        eng._on_net(1.0, e2, True)
        assert (eng._net_factor(CC), eng._net_factor(ES)) == \
            (pytest.approx(6.0), 1.0)
        eng._on_net(6.0, e2, False)
        eng._on_net(10.0, e1, False)
        assert eng._net_factor(CC) == 1.0 and not eng._net


def test_capacity_integral_merges_overlaps_and_clips_retirement():
    got = []
    for M in PKGS:
        pool = M.engine._Pool(CC, 1)
        slot = pool.slots[0]
        slot.outages = [(2.0, 8.0), (5.0, 12.0), (18.0, 25.0)]
        slot.retired_at = 20.0
        vals = [pool.capacity_integral(30.0), pool.capacity_integral(6.0)]
        slot.outages.append((0.0, 50.0))
        vals.append(pool.capacity_integral(30.0))
        assert vals == [pytest.approx(8.0), pytest.approx(2.0), 0.0]
        got.append(vals)
    assert got[0] == got[1]


@pytest.mark.parametrize("pack", sorted(PORT.traces.SCENARIO_PACKS))
def test_every_pack_is_deterministic_and_crash_consistent(pack):
    runs = [run_pack(M, pack, "greedy", seed=3) for M in PKGS]
    (_, ref), (sc, port) = runs
    assert_same_run(ref, port)
    _, again = run_pack(PORT, pack, "greedy", seed=3)
    assert crc(again) == crc(port)
    m = port.metrics
    assert m.finished == sc.jobs
    assert sum(ev[0] == "kill" for ev in port.event_log) == m.retries
    if not any(f.kill_running for f in sc.failures):
        assert m.retries == 0 and m.wasted_seconds == 0.0
    assert sum(ev[0] == "net" for ev in port.event_log) == \
        2 * len(sc.network)


def test_search_policy_deterministic_on_crash_pack():
    (_, ref), (sc, port) = (run_pack(M, "edge_brownout", "tabu", seed=1,
                                     wards=2, horizon=40.0) for M in PKGS)
    assert_same_run(ref, port)
    _, again = run_pack(PORT, "edge_brownout", "tabu", seed=1, wards=2,
                        horizon=40.0)
    assert entries(again) == entries(port) and crc(again) == crc(port)
    assert port.metrics.finished == sc.jobs
    assert port.metrics.retries == sum(ev[0] == "kill"
                                       for ev in port.event_log)


def test_unknown_pack_rejected():
    for M in PKGS:
        with pytest.raises(ValueError, match="unknown scenario pack"):
            M.traces.make_scenario("nope")
