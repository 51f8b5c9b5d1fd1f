"""The reference's integer search cases (tests/test_availability.py,
tests/test_scheduler_fast.py) run on the port beside the reference, both
on the CPU: busy machine vectors through every evaluator layer, the
incremental ScheduleState, the FIFO tie-break, the pinned drift
objectives, the lower bounds, the size-dispatched search in both
backends, and initial/frozen masks through `search_batched`'s two paths.

Instances are integer-valued, so float32 sums are exact in any order:
the port's simulator, incremental state, device evaluator and searches
must give the reference's numbers bit for bit (DESIGN.md §8). The metro
engine's event-log CRCs ride on the same search.
"""
import itertools

import numpy as np
import pytest
import torch

from prop import sweep
from repro.core import lower_bound as ref_lb
from repro.core import online as ref_online
from repro.core import problems as ref_problems
from repro.core import scheduler as ref_scheduler
from repro.core import scheduler_jax
from repro.core import simulator as ref_sim
from repro_torch.core import lower_bound as port_lb
from repro_torch.core import online as port_online
from repro_torch.core import problems as port_problems
from repro_torch.core import scheduler as port_scheduler
from repro_torch.core import scheduler_torch
from repro_torch.core import simulator as port_sim
from repro_torch.core.tiers import CC, ED, ES

MACHINES = port_sim.MACHINES
MPT_GRID = ((1, 1), (2, 3))
OBJECTIVES = ("weighted", "unweighted", "last")


@pytest.fixture(autouse=True, scope="module")
def _isolate_compiled_shapes():
    """The reference's forced-JAX searches record their shapes in a
    module-global set that changes its later CPU dispatch; restore it."""
    saved = set(ref_scheduler._COMPILED_SHAPES)
    stats = dict(ref_scheduler._SHAPE_STATS)
    yield
    ref_scheduler._COMPILED_SHAPES.clear()
    ref_scheduler._COMPILED_SHAPES.update(saved)
    ref_scheduler._SHAPE_STATS.update(stats)


def _jobs(sim, rng, n, *, tie_heavy=False):
    """The reference tests' random integer instance, built with `sim`'s
    JobSpec; tie_heavy forces many simultaneous arrivals."""
    rel_hi, tc_hi, te_hi = (3, 2, 2) if tie_heavy else (30, 60, 15)
    return [sim.JobSpec(name=f"J{i}", release=float(rng.integers(0, rel_hi)),
                        weight=float(rng.integers(1, 4)),
                        proc={t: float(rng.integers(1, 30)) for t in MACHINES},
                        trans={CC: float(rng.integers(0, tc_hi)),
                               ES: float(rng.integers(0, te_hi)), ED: 0.0})
            for i in range(n)]


def _pair(seed, n, **kw):
    """The same instance in both packages."""
    return (_jobs(ref_sim, np.random.default_rng(seed), n, **kw),
            _jobs(port_sim, np.random.default_rng(seed), n, **kw))


def _busy(rng, mpt):
    return {t: sorted(float(rng.choice([0.0, rng.integers(1, 40)]))
                      for _ in range(m))
            for t, m in ((CC, mpt[0]), (ES, mpt[1]))}


def _sched(s):
    return ([(e.job.name, e.machine, e.arrival, e.start, e.end)
             for e in s.entries], s.weighted_sum, s.unweighted_sum,
            s.last_end)


# ------------------------------------------------------------ busy vectors
@pytest.mark.parametrize("mpt", MPT_GRID, ids=["1x1", "2x3"])
@pytest.mark.parametrize("tie_heavy", [False, True], ids=["spread", "ties"])
def test_evaluators_match_reference_with_busy_machines(mpt, tie_heavy):
    """simulate == ScheduleState == the device evaluator, in the port and
    in the reference, on random assignments of a busy fleet."""
    mptd = {CC: mpt[0], ES: mpt[1]}
    for case in range(6):
        seed = 100 * case + 7 * mpt[1] + tie_heavy
        rj, pj = _pair(seed, int(np.random.default_rng(seed).integers(3, 11)),
                       tie_heavy=tie_heavy)
        rng = np.random.default_rng(seed + 1)
        busy = _busy(rng, mpt)
        assigns = rng.integers(0, 3, size=(8, len(pj))).astype(np.int32)
        busy2 = (busy[CC], busy[ES])
        ref_m = scheduler_jax.evaluate_assignments(
            assigns, *scheduler_jax.specs_to_arrays(rj),
            machines_per_tier=mpt, busy_until=busy2)
        port_m = scheduler_torch.evaluate_assignments(
            torch.as_tensor(assigns, dtype=torch.long),
            *scheduler_torch.specs_to_tensors(pj, "cpu"),
            machines_per_tier=mpt, busy_until=busy2)
        for o in OBJECTIVES:
            assert np.asarray(port_m[o]).tolist() == \
                np.asarray(ref_m[o]).tolist()
        for ai in range(len(assigns)):
            a = [MACHINES[j] for j in assigns[ai]]
            s = port_sim.simulate(pj, a, machines_per_tier=mptd,
                                  busy_until=busy)
            assert _sched(s) == _sched(ref_sim.simulate(
                rj, a, machines_per_tier=mptd, busy_until=busy))
            st = port_sim.ScheduleState(pj, a, machines_per_tier=mptd,
                                        busy_until=busy)
            assert (st.score("weighted"), st.score("unweighted"),
                    st.score("last")) == (s.weighted_sum, s.unweighted_sum,
                                          s.last_end)
            assert float(port_m["weighted"][ai]) == s.weighted_sum


@pytest.mark.parametrize("busy", [None, {CC: [5.0, 17.0],
                                         ES: [0.0, 3.0, 21.0]}],
                         ids=["idle", "busy"])
def test_incremental_moves_match_reference(busy):
    """try_move / apply_move predict every objective exactly, as the
    reference's ScheduleState does, over random move sequences."""
    mptd = {CC: 2, ES: 3}
    for seed in range(8):
        rj, pj = _pair(seed, 8)
        rng = np.random.default_rng(seed + 50)
        start = [MACHINES[j] for j in rng.integers(0, 3, 8)]
        states = [sim.ScheduleState(jobs, list(start), machines_per_tier=mptd,
                                    busy_until=busy)
                  for sim, jobs in ((ref_sim, rj), (port_sim, pj))]
        for _ in range(12):
            k, dst = int(rng.integers(0, 8)), MACHINES[int(rng.integers(0, 3))]
            preds = [[st.try_move(k, dst, o) for o in OBJECTIVES]
                     for st in states]
            assert preds[0] == preds[1]
            for st in states:
                st.apply_move(k, dst)
            ref = port_sim.simulate(pj, states[1].assign,
                                    machines_per_tier=mptd, busy_until=busy)
            assert preds[1][0] == pytest.approx(ref.weighted_sum, abs=1e-6)
            assert states[1].end == states[0].end


def test_busy_semantics_match_reference():
    rj, pj = _pair(0, 6)
    for sim, jobs in ((ref_sim, rj), (port_sim, pj)):
        s = sim.simulate(jobs, [CC, CC, CC, ES, ES, ES],
                         machines_per_tier={CC: 2, ES: 1},
                         busy_until={CC: [100.0, 100.0], ES: [100.0]})
        assert all(e.start >= 100.0 for e in s.entries)
        two = [sim.JobSpec(name=f"J{i}", release=0.0, weight=1.0,
                           proc={CC: 10.0, ES: 10.0, ED: 99.0},
                           trans={CC: 0.0, ES: 0.0, ED: 0.0})
               for i in range(2)]
        s = sim.simulate(two, [CC, CC], machines_per_tier={CC: 2, ES: 1},
                         busy_until={CC: [0.0, 50.0]})
        assert sorted(e.start for e in s.entries) == [0.0, 10.0]
        assert sim.machine_free_times(None, CC, 2) == [0.0, 0.0]
        assert sim.machine_free_times({CC: [7.0]}, CC, 2) == [0.0, 7.0]
        with pytest.raises(ValueError):
            sim.machine_free_times({CC: [1.0, 2.0, 3.0]}, CC, 2)


def test_deterministic_tie_break_matches_reference():
    """Three jobs arriving at one instant on one machine run in (release,
    index) order in the simulator and the device evaluator."""
    for sim in (ref_sim, port_sim):
        jobs = [sim.JobSpec(name=n, release=r, weight=1.0,
                            proc={CC: p, ES: p, ED: 50.0},
                            trans={CC: t, ES: t, ED: 0.0})
                for n, r, p, t in (("A", 2.0, 5.0, 0.0), ("B", 0.0, 3.0, 2.0),
                                   ("C", 0.0, 7.0, 2.0))]
        for assign in ([CC] * 3, [ES] * 3):
            s = sim.simulate(jobs, assign)
            by_name = {e.job.name: e.start for e in s.entries}
            assert by_name == {"B": 2.0, "C": 5.0, "A": 12.0}
    enc = torch.as_tensor([[0, 0, 0], [1, 1, 1]])
    m = scheduler_torch.evaluate_assignments(
        enc, *scheduler_torch.specs_to_tensors(jobs, "cpu"))
    assert m["weighted"].tolist() == [s.weighted_sum] * 2


def test_greedy_respects_busy_and_fleet_like_the_reference():
    def check(rng):
        seed = int(rng.integers(0, 2 ** 31))
        rj, pj = _pair(seed, 8)
        mpt = {CC: 2, ES: 2}
        busy = {CC: [9.0, 0.0], ES: [4.0]}
        a = port_scheduler.greedy_schedule(pj, machines_per_tier=mpt,
                                           busy_until=busy)
        assert a == ref_scheduler.greedy_schedule(rj, machines_per_tier=mpt,
                                                  busy_until=busy)
    sweep(check, n_cases=6)


# ------------------------------------------------------ the drift fix
def test_pinned_objectives_match_reference():
    for problems, scheduler in ((ref_problems, ref_scheduler),
                                (port_problems, port_scheduler)):
        s = scheduler.neighborhood_search(problems.table6_jobs())
        assert (s.weighted_sum, s.unweighted_sum, s.last_end) == \
            (228.0, 150.0, 43.0)
    rng = np.random.default_rng(123)
    jobs = [port_sim.JobSpec(
        name=f"F{i}", release=float(rng.integers(0, 30)) * 0.1,
        weight=float(rng.integers(1, 4)) * 0.3,
        proc={t: float(rng.integers(1, 30)) * 0.1 for t in MACHINES},
        trans={CC: float(rng.integers(0, 60)) * 0.1,
               ES: float(rng.integers(0, 15)) * 0.1, ED: 0.0})
        for i in range(12)]
    s = port_scheduler.neighborhood_search(jobs)
    assert s.weighted_sum == 8.25 == \
        port_sim.simulate(jobs, s.assignment()).weighted_sum


def test_incremental_search_matches_reference_on_integer_instances():
    for seed in range(30):
        n = int(np.random.default_rng(seed).integers(3, 12))
        rj, pj = _pair(seed, n)
        a = port_scheduler.neighborhood_search(pj)
        assert a.weighted_sum == \
            port_scheduler.neighborhood_search_reference(pj).weighted_sum
        assert _sched(a) == _sched(ref_scheduler.neighborhood_search(rj))


def test_lower_bounds_match_reference():
    jobs = port_problems.table6_jobs()
    lb_job, lb = port_lb.jobwise_last_bound(jobs), port_lb.load_lower_bound(
        jobs)
    ref_jobs = ref_problems.table6_jobs()
    assert (lb_job, lb) == (ref_lb.jobwise_last_bound(ref_jobs),
                            ref_lb.load_lower_bound(ref_jobs))
    assert lb_job < lb <= port_scheduler.exact_optimum(jobs).last_end + 1e-6
    for seed in range(6):
        rj, pj = _pair(seed, 5)
        best = min(port_sim.simulate(pj, c).last_end
                   for c in itertools.product(MACHINES, repeat=5))
        got = (port_lb.jobwise_last_bound(pj), port_lb.load_lower_bound(pj),
               port_lb.load_lower_bound(pj, machines_per_tier={CC: 3, ES: 3}),
               port_lb.paper_lower_bound(pj))
        assert got == (ref_lb.jobwise_last_bound(rj),
                       ref_lb.load_lower_bound(rj),
                       ref_lb.load_lower_bound(
                           rj, machines_per_tier={CC: 3, ES: 3}),
                       ref_lb.paper_lower_bound(rj))
        assert got[0] - 1e-9 <= got[1] <= best + 1e-6 and got[2] <= got[1]


# ------------------------------------------------------- dispatched search
@pytest.mark.parametrize("threshold", [100, 2], ids=["python", "device"])
def test_search_with_busy_machines_matches_reference(threshold):
    """Both backends of `search` optimise the busy-fleet problem and
    return exact schedules scored against it, as the reference's do."""
    rj, pj = _pair(7, 9)
    mpt = {CC: 2, ES: 1}
    busy = {CC: [4.0, 9.0], ES: [2.0]}
    s = port_scheduler.search(pj, machines_per_tier=mpt, busy_until=busy,
                              device_threshold=threshold, device="cpu")
    ref = ref_scheduler.search(rj, machines_per_tier=mpt, busy_until=busy,
                               jax_threshold=threshold)
    assert _sched(s) == _sched(ref)
    assert s.weighted_sum == port_sim.simulate(
        pj, s.assignment(), machines_per_tier=mpt,
        busy_until=busy).weighted_sum
    blocked = port_scheduler.search(
        pj, machines_per_tier=mpt, busy_until={CC: [1e6, 1e6], ES: [1e6]},
        device_threshold=threshold, device="cpu")
    assert all(t == ED for t in blocked.assignment())


def test_device_search_matches_reference_and_nears_the_optimum():
    for seed in range(4):
        rj, pj = _pair(seed, 7)
        v, a = scheduler_torch.tabu_search_device(pj, device="cpu")
        rv, ra = scheduler_jax.tabu_search_jax(rj)
        assert (v, np.asarray(a).tolist()) == (float(rv),
                                               np.asarray(ra).tolist())
        opt = port_scheduler.exact_optimum(pj).weighted_sum
        assert v <= opt * 1.05 + 1e-6
        assert v == port_sim.simulate(
            pj, [MACHINES[int(i)] for i in a]).weighted_sum
    table = port_problems.table6_jobs()
    v, _ = scheduler_torch.tabu_search_device(table, device="cpu")
    assert v <= port_sim.simulate(
        table, port_scheduler.greedy_schedule(table)).weighted_sum


def test_online_replan_through_dispatcher_matches_reference():
    rj, pj = _pair(3, 12)
    for threshold in (10 ** 9, 4):
        s = port_online.online_schedule(pj, replan="tabu",
                                        device_threshold=threshold,
                                        device="cpu")
        assert _sched(s) == _sched(ref_online.online_schedule(
            rj, replan="tabu", jax_threshold=threshold))
        assert all(e.start >= e.job.release + e.job.trans[e.machine] - 1e-9
                   for e in s.entries)


# ----------------------------------------- batched initial/frozen threading
@pytest.mark.parametrize("min_batch", [99, 1], ids=["sequential", "batched"])
def test_mixed_initials_and_frozen_masks_match_reference(min_batch):
    """Per-ward initials with gaps, and frozen masks pinning background
    jobs, through both search_batched paths, as the reference's."""
    pairs = [_pair(s, 6) for s in range(4)]
    initial = [["cloud"] * 6, None, ["device"] * 6, None]
    got = [sched.search_batched([p[k] for p in pairs], max_count=3,
                                initial=initial, min_batch=min_batch, **kw)
           for k, (sched, kw) in enumerate(
               ((ref_scheduler, {"jax_threshold": 10 ** 9}),
                (port_scheduler, {"device_threshold": 10 ** 9,
                                  "device": "cpu"})))]
    assert [_sched(s) for s in got[1]] == [_sched(s) for s in got[0]]
    frozen = [[True, True, False, False, False, False]] * 2
    init = [["cloud", "cloud", "device", "device", "device", "device"]] * 2
    plans = port_scheduler.search_batched(
        [p[1] for p in pairs[:2]], max_count=3, initial=init, frozen=frozen,
        min_batch=min_batch, device_threshold=10 ** 9, device="cpu")
    ref = ref_scheduler.search_batched(
        [p[0] for p in pairs[:2]], max_count=3, initial=init, frozen=frozen,
        min_batch=min_batch, jax_threshold=10 ** 9)
    assert [_sched(s) for s in plans] == [_sched(s) for s in ref]
    assert all(p.assignment()[:2] == ["cloud", "cloud"] for p in plans)
    with pytest.raises(ValueError):
        port_scheduler.search_batched([p[1] for p in pairs[:2]],
                                      frozen=frozen, min_batch=1,
                                      device="cpu")
