"""Parity of the port's fleet planning (`repro_torch.core.scheduler`
`search_batched`, `search_fleet`, `_FleetEval`) with the JAX reference's,
both on the CPU.

Instances are integer-valued, so both packages must return identical
assignments and bit-identical objectives (DESIGN.md §8). The backend is
pinned on both sides: the reference's `search` dispatch depends on its
compiled-shape state, the port's on its device.
"""
import numpy as np
import pytest
import torch

from prop import sweep
from repro.core import problems as ref_problems
from repro.core import scheduler as ref_scheduler
from repro.core import simulator as ref_sim
from repro_torch.core import problems as port_problems
from repro_torch.core import scheduler as port_scheduler
from repro_torch.core import scheduler_torch
from repro_torch.core import simulator as port_sim
from repro_torch.core.tiers import CC, ED, ES

PYTHON_ONLY = 10 ** 9
OBJECTIVES = ("weighted", "unweighted", "last")
# the cloud-heavy wards of `test_search_fleet_matches_reference`, whose
# independent plans double-book the shared cloud for every objective
FLEET_SEED = 24


@pytest.fixture(autouse=True, scope="module")
def _isolate_compiled_shapes():
    """The reference's batched and forced-JAX calls record their shapes in
    a module-global set that changes its later CPU dispatch; restore it so
    later test modules keep their default dispatch."""
    saved = set(ref_scheduler._COMPILED_SHAPES)
    stats = dict(ref_scheduler._SHAPE_STATS)
    yield
    ref_scheduler._COMPILED_SHAPES.clear()
    ref_scheduler._COMPILED_SHAPES.update(saved)
    ref_scheduler._SHAPE_STATS.update(stats)


def _int_jobs(sim, rng, n):
    return [sim.JobSpec(name=f"J{i}", release=float(rng.integers(0, 30)),
                        weight=float(rng.integers(1, 4)),
                        proc={t: float(rng.integers(1, 30))
                              for t in (CC, ES, ED)},
                        trans={CC: float(rng.integers(0, 60)),
                               ES: float(rng.integers(0, 15)), ED: 0.0})
            for i in range(n)]


def _metro_wards(problems_mod, seed, B, n):
    """`metro_jobs` wards (the cloud-attractive regime of the reference's
    contention benchmark) with releases rounded to integers, so every
    cost is an integer."""
    rng = np.random.default_rng(seed)
    wards = []
    for _ in range(B):
        jobs = problems_mod.metro_jobs(rng, n=n)
        wards.append([type(j)(name=j.name, release=float(round(j.release)),
                              weight=j.weight, proc=j.proc, trans=j.trans,
                              workload=j.workload) for j in jobs])
    return wards


def _same_schedules(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.assignment() == r.assignment()
        assert (g.weighted_sum, g.unweighted_sum, g.last_end) == \
            (r.weighted_sum, r.unweighted_sum, r.last_end)
        assert [(e.arrival, e.start, e.end) for e in g.entries] == \
            [(e.arrival, e.start, e.end) for e in r.entries]


# ------------------------------------------------------------ search_batched
def _ward_fleets():
    mpts = [{CC: 1, ES: 1}, {CC: 2, ES: 3}, {CC: 1, ES: 2}, {CC: 3, ES: 1},
            {CC: 2, ES: 2}]
    busys = [None, {CC: [4.0], ES: [2.0, 9.0]}, None, {CC: [7.0]},
             {ES: [5.0]}]
    return mpts, busys


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_search_batched_matches_reference_on_the_batched_path(objective):
    """min_batch=1 forces the batched device search (greedy init) on
    both sides; ragged wards, per-ward fleets and busy vectors."""
    sizes = (9, 13, 5, 11, 7)
    mpts, busys = _ward_fleets()
    ref_p = [_int_jobs(ref_sim, np.random.default_rng(30 + i), n)
             for i, n in enumerate(sizes)]
    port_p = [_int_jobs(port_sim, np.random.default_rng(30 + i), n)
              for i, n in enumerate(sizes)]
    ref = ref_scheduler.search_batched(
        ref_p, max_count=5, objective=objective, machines_per_tier=mpts,
        busy_until=busys, min_batch=1)
    calls = scheduler_torch.tabu_search_batched.calls
    got = port_scheduler.search_batched(
        port_p, max_count=5, objective=objective, machines_per_tier=mpts,
        busy_until=busys, min_batch=1, device="cpu")
    assert scheduler_torch.tabu_search_batched.calls == calls + 1
    _same_schedules(got, ref)


@pytest.mark.parametrize("threshold", [PYTHON_ONLY, 0],
                         ids=["python", "device"])
def test_search_batched_sequential_fallback_matches_reference(threshold):
    """Below min_batch both packages loop their per-instance `search`,
    forwarding the pinned threshold: the Python search, or the solo
    device search."""
    mpts, busys = _ward_fleets()
    ref_p = [_int_jobs(ref_sim, np.random.default_rng(50 + i), 10)
             for i in range(3)]
    port_p = [_int_jobs(port_sim, np.random.default_rng(50 + i), 10)
              for i in range(3)]
    ref = ref_scheduler.search_batched(
        ref_p, machines_per_tier=mpts[:3], busy_until=busys[:3],
        min_batch=10, jax_threshold=threshold)
    calls = scheduler_torch.tabu_search_batched.calls
    got = port_scheduler.search_batched(
        port_p, machines_per_tier=mpts[:3], busy_until=busys[:3],
        min_batch=10, device_threshold=threshold, device="cpu")
    assert scheduler_torch.tabu_search_batched.calls == \
        calls + (3 if threshold == 0 else 0)
    _same_schedules(got, ref)


def test_search_batched_initial_frozen_reserved_match_reference():
    """Warm starts (one ward left to the greedy fill), frozen masks and
    per-ward reservations ride the batched path on both sides."""
    out = []
    for sim in (ref_sim, port_sim):
        rng = np.random.default_rng(77)
        problems = [_int_jobs(sim, rng, n) for n in (10, 7, 12, 9)]
        inits = [[sim.MACHINES[int(i)] for i in rng.integers(0, 3, len(p))]
                 for p in problems]
        inits[2] = None
        frozen = [list(rng.random(len(p)) < 0.3) for p in problems]
        frozen[2] = None
        resv = [{CC: [sim.Reservation(arrival=float(a), proc=float(p),
                                      release=float(r), weight=2.0)
                      for a, p, r in zip(rng.integers(5, 40, 2),
                                         rng.integers(1, 20, 2),
                                         rng.integers(0, 5, 2))]}
                for _ in problems]
        resv[2] = None
        out.append(dict(problems=problems, initial=inits, frozen=frozen,
                        reserved=resv))
    mpt = {CC: 2, ES: 1}
    ref = ref_scheduler.search_batched(
        out[0].pop("problems"), machines_per_tier=mpt, min_batch=1,
        **out[0])
    got = port_scheduler.search_batched(
        out[1].pop("problems"), machines_per_tier=mpt, min_batch=1,
        device="cpu", **out[1])
    _same_schedules(got, ref)


def test_search_batched_validates_like_the_reference():
    jobs = _int_jobs(port_sim, np.random.default_rng(0), 4)
    resv = [{CC: [port_sim.Reservation(arrival=3.0, proc=2.0, release=1.0,
                                       weight=1.0)]}]
    with pytest.raises(ValueError, match="reservations require"):
        port_scheduler.search_batched([jobs], reserved=resv, min_batch=1,
                                      device="cpu")
    with pytest.raises(ValueError, match="2 fleets"):
        port_scheduler.search_batched([jobs], machines_per_tier=[{}, {}],
                                      device="cpu")


# -------------------------------------------------------------- search_fleet
def _plans_equal(got, ref):
    assert got.assignments == ref.assignments
    assert got.naive_assignments == ref.naive_assignments
    assert got.naive_reported == ref.naive_reported
    assert got.sweeps == ref.sweeps
    assert got.objective == ref.objective
    for obj in OBJECTIVES:
        assert got.fleet.objective(obj) == ref.fleet.objective(obj)
        assert got.naive_fleet.objective(obj) == \
            ref.naive_fleet.objective(obj)
    assert got.contention_gap == ref.contention_gap
    assert got.gap_closed == ref.gap_closed


@pytest.mark.parametrize("objective,backend,background", [
    ("weighted", "python", "interval"), ("weighted", "python", "phantom"),
    ("weighted", "batched", "interval"), ("weighted", "batched", "phantom"),
    ("unweighted", "batched", "interval"), ("last", "batched", "interval")])
def test_search_fleet_matches_reference(objective, backend, background):
    """Four cloud-heavy wards of 10 jobs on a 2 + 1 fleet. Each batched
    sweep carries the other wards' cloud jobs (padded to 64 rows) against
    a movable bucket of 16, so it takes the pass regime; the naive stage
    takes the round regime from the greedy init. The python backend pins
    the per-ward `search` to the Python path on both sides."""
    ref_w = _metro_wards(ref_problems, FLEET_SEED, 4, 10)
    port_w = _metro_wards(port_problems, FLEET_SEED, 4, 10)
    mpt = {CC: 2, ES: 1}
    ref = ref_scheduler.search_fleet(
        ref_w, machines_per_tier=mpt, objective=objective,
        sweep_backend=backend, background=background,
        jax_threshold=PYTHON_ONLY)
    modes = []
    real = scheduler_torch._tabu_run_batched

    def spy(*args, **kwargs):
        modes.append(kwargs["mode"])
        return real(*args, **kwargs)

    scheduler_torch._tabu_run_batched = spy
    try:
        got = port_scheduler.search_fleet(
            port_w, machines_per_tier=mpt, objective=objective,
            sweep_backend=backend, background=background,
            device_threshold=PYTHON_ONLY, device="cpu")
    finally:
        scheduler_torch._tabu_run_batched = real
    _plans_equal(got, ref)
    assert ref.contention_gap > 1.0 and ref.sweeps >= 1
    assert modes[0] == "round"
    if backend == "batched":
        assert set(modes[1:]) == {"pass"} and len(modes) == 1 + got.sweeps
    else:
        assert len(modes) == 1


def test_search_fleet_python_backend_on_the_device_search():
    """The python sweep backend with the per-ward device search forced
    (threshold 0): each ward's padded rows hold the other wards' cloud
    jobs, so the solo device searches take the pass regime too."""
    ref_w = _metro_wards(ref_problems, 9, 3, 8)
    port_w = _metro_wards(port_problems, 9, 3, 8)
    mpt = {CC: 2, ES: 1}
    ref = ref_scheduler.search_fleet(ref_w, machines_per_tier=mpt,
                                     sweep_backend="python", max_sweeps=3,
                                     jax_threshold=0)
    got = port_scheduler.search_fleet(port_w, machines_per_tier=mpt,
                                      sweep_backend="python", max_sweeps=3,
                                      device_threshold=0, device="cpu")
    _plans_equal(got, ref)


def test_search_fleet_independent_stage_is_search_batched():
    """search_fleet's naive stage IS search_batched (max_sweeps=0)."""
    wards = _metro_wards(port_problems, 8, 4, 8)
    mpt = {CC: 2, ES: 1}
    plan = port_scheduler.search_fleet(wards, machines_per_tier=mpt,
                                       max_sweeps=0, device="cpu")
    direct = port_scheduler.search_batched(wards, machines_per_tier=mpt,
                                           device="cpu")
    assert plan.naive_assignments == [s.assignment() for s in direct]
    assert plan.sweeps == 0


def test_search_fleet_validates_and_handles_empty():
    wards = _metro_wards(port_problems, 1, 2, 3)
    for kw in ({"sweep_backend": "gpu"}, {"background": "frozen"}):
        with pytest.raises(ValueError, match="unknown"):
            port_scheduler.search_fleet(wards, device="cpu", **kw)
    plan = port_scheduler.search_fleet([], device="cpu")
    assert plan.assignments == [] and plan.sweeps == 0


@pytest.mark.parametrize("entry", ["search_batched", "search_fleet"])
def test_fleet_entry_points_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device runs")
    wards = _metro_wards(port_problems, 2, 2, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(port_scheduler, entry)(wards)


# ---------------------------------------------------------------- _FleetEval
def test_fleet_eval_matches_simulate_fleet_bitwise():
    """The port's _FleetEval replays its `simulate_fleet`'s arithmetic:
    every random trial plan scores bit-identically on all objectives, and
    identically to the reference's evaluator on the same plan."""
    def check(rng):
        B = int(rng.integers(1, 4))
        sizes = [int(rng.integers(1, 8)) for _ in range(B)]
        seed = int(rng.integers(2 ** 31))
        wards = [_int_jobs(port_sim, np.random.default_rng(seed + b), n)
                 for b, n in enumerate(sizes)]
        ref_wards = [_int_jobs(ref_sim, np.random.default_rng(seed + b), n)
                     for b, n in enumerate(sizes)]
        shared = (CC,) if rng.integers(2) else (CC, ES)
        mpt = {CC: int(rng.integers(1, 3)), ES: int(rng.integers(1, 3))}
        busy = ({CC: [float(rng.integers(0, 15))]}
                if rng.integers(2) else None)
        wbusy = ([{ES: [float(rng.integers(0, 15))]} for _ in range(B)]
                 if (ES not in shared and rng.integers(2)) else None)
        mpts = port_sim._fleet_mpts(mpt, B, shared)
        ev = port_scheduler._FleetEval(wards, mpts, busy, wbusy, shared)
        ref_ev = ref_scheduler._FleetEval(
            ref_wards, ref_sim._fleet_mpts(mpt, B, shared), busy, wbusy,
            shared)
        for _ in range(5):
            plan = [[port_sim.MACHINES[int(rng.integers(3))] for _ in jobs]
                    for jobs in wards]
            sim = port_sim.simulate_fleet(
                wards, plan, machines_per_tier=mpts, busy_until=busy,
                ward_busy_until=wbusy, shared_tiers=shared)
            for obj in OBJECTIVES:
                assert ev(plan, obj) == sim.objective(obj)
                assert ev(plan, obj) == ref_ev(plan, obj)
    sweep(check, n_cases=12, seed=90)
