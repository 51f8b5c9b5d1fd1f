"""Parity of the port's online scheduler (`repro_torch.core.online`) with
the JAX reference's, both on the CPU: the integer cases of
tests/test_online.py, the ward-aware fleet hook of tests/test_fleet.py
and the batched competitive ratios, each with the search backend pinned
on both sides (the Python search, or the device search forced by a
threshold of 0)."""
import numpy as np
import pytest
import torch

from repro.core import online as ref_online
from repro.core import problems as ref_problems
from repro.core import scheduler as ref_scheduler
from repro.core import simulator as ref_sim
from repro_torch.core import online as port_online
from repro_torch.core import problems as port_problems
from repro_torch.core import simulator as port_sim
from repro_torch.core.tiers import CC, ED, ES

PYTHON_ONLY = 10 ** 9
FLEETS = ({CC: 1, ES: 1}, {CC: 2, ES: 3})
BACKENDS = pytest.mark.parametrize("threshold", [PYTHON_ONLY, 0],
                                   ids=["python", "device"])


@pytest.fixture(autouse=True, scope="module")
def _isolate_compiled_shapes():
    """The reference's forced-JAX replans record their shapes in a
    module-global set that changes its later CPU dispatch; restore it so
    later test modules keep their default dispatch."""
    saved = set(ref_scheduler._COMPILED_SHAPES)
    stats = dict(ref_scheduler._SHAPE_STATS)
    yield
    ref_scheduler._COMPILED_SHAPES.clear()
    ref_scheduler._COMPILED_SHAPES.update(saved)
    ref_scheduler._SHAPE_STATS.update(stats)


def _random_jobs(sim, rng, n=8):
    """tests/test_online.py's integer instances."""
    return [sim.JobSpec(name=f"J{i}", release=float(rng.integers(0, 40)),
                        weight=float(rng.integers(1, 3)),
                        proc={t: float(rng.integers(1, 30))
                              for t in (CC, ES, ED)},
                        trans={CC: float(rng.integers(0, 60)),
                               ES: float(rng.integers(0, 15)), ED: 0.0})
            for i in range(n)]


def _both(seed, n=8):
    return (_random_jobs(ref_sim, np.random.default_rng(seed), n),
            _random_jobs(port_sim, np.random.default_rng(seed), n))


def _entries(sched):
    return [(e.job.name, e.machine, e.arrival, e.start, e.end)
            for e in sched.entries]


def _same(got, ref):
    assert _entries(got) == _entries(ref)
    assert (got.weighted_sum, got.unweighted_sum, got.last_end) == \
        (ref.weighted_sum, ref.unweighted_sum, ref.last_end)


@BACKENDS
@pytest.mark.parametrize("mpt", FLEETS, ids=["1x1", "2x3"])
@pytest.mark.parametrize("replan", ["greedy", "tabu"])
def test_online_schedule_matches_reference(replan, mpt, threshold):
    """Identical commits, and for tabu replans an identical audit trail
    (reported == committed at every event, DESIGN.md §7), over seeded
    instances of 5-10 jobs."""
    for seed in range(4):
        n = int(np.random.default_rng(seed).integers(5, 11))
        ref_jobs, port_jobs = _both(seed, n)
        ref_trace, port_trace = [], []
        ref = ref_online.online_schedule(
            ref_jobs, replan=replan, jax_threshold=threshold,
            machines_per_tier=mpt, trace=ref_trace)
        got = port_online.online_schedule(
            port_jobs, replan=replan, device_threshold=threshold,
            machines_per_tier=mpt, trace=port_trace, device="cpu")
        _same(got, ref)
        assert port_trace == ref_trace
        assert all(ev["reported"] == ev["committed"] for ev in port_trace)


@BACKENDS
def test_online_schedule_fleet_matches_reference(threshold):
    """The ward-aware hook on a shared cloud (tests/test_fleet.py's
    TestOnlineFleet instances): other wards' unstarted cloud jobs enter
    each replan as reservations; identical commits per ward."""
    mpt = {CC: 2, ES: 1}
    ref_rng, port_rng = np.random.default_rng(9), np.random.default_rng(9)
    ref_w = [ref_problems.metro_jobs(ref_rng, n=8) for _ in range(4)]
    port_w = [port_problems.metro_jobs(port_rng, n=8) for _ in range(4)]
    ref = ref_online.online_schedule_fleet(ref_w, machines_per_tier=mpt,
                                           jax_threshold=threshold)
    got = port_online.online_schedule_fleet(
        port_w, machines_per_tier=mpt, device_threshold=threshold,
        device="cpu")
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        _same(g, r)


def test_online_schedule_fleet_single_ward_is_tabu_online():
    """B = 1 has an empty background at every event, so the hook IS
    online_schedule(replan="tabu")."""
    jobs = port_problems.metro_jobs(np.random.default_rng(200), n=8)
    mpt = {CC: 2, ES: 1}
    solo = port_online.online_schedule(jobs, replan="tabu",
                                       machines_per_tier=mpt, device="cpu")
    fleet = port_online.online_schedule_fleet([jobs], machines_per_tier=mpt,
                                              device="cpu")[0]
    _same(fleet, solo)


@pytest.mark.parametrize("min_batch", [1, 99], ids=["batched", "sequential"])
def test_competitive_ratio_batch_matches_reference(min_batch):
    """One batched clairvoyant baseline (or the per-instance loop) shared
    by both replan modes; the Python search is pinned on the online side
    and on the sequential baseline."""
    ref_i, port_i = zip(*(_both(40 + i) for i in range(4)))
    mpt = {CC: 2, ES: 3}
    ref = ref_online.competitive_ratio_batch(
        list(ref_i), jax_threshold=PYTHON_ONLY, machines_per_tier=mpt,
        min_batch=min_batch)
    got = port_online.competitive_ratio_batch(
        list(port_i), device_threshold=PYTHON_ONLY, machines_per_tier=mpt,
        min_batch=min_batch, device="cpu")
    assert got == ref


@BACKENDS
def test_competitive_ratios_match_reference(threshold):
    ref_jobs, port_jobs = _both(5, n=10)
    assert port_online.competitive_ratio(
        port_jobs, replan="tabu", device_threshold=threshold,
        device="cpu") == ref_online.competitive_ratio(
            ref_jobs, replan="tabu", jax_threshold=threshold)
    mpt = {CC: 2, ES: 1}
    ref_w = [ref_problems.metro_jobs(np.random.default_rng(60 + i), n=6)
             for i in range(3)]
    port_w = [port_problems.metro_jobs(np.random.default_rng(60 + i), n=6)
              for i in range(3)]
    assert port_online.competitive_ratio_fleet(
        port_w, machines_per_tier=mpt, max_sweeps=3,
        device_threshold=threshold, device="cpu") == \
        ref_online.competitive_ratio_fleet(
            ref_w, machines_per_tier=mpt, max_sweeps=3,
            jax_threshold=threshold)


@pytest.mark.parametrize("entry", ["online_schedule", "online_schedule_fleet",
                                   "competitive_ratio",
                                   "competitive_ratio_batch"])
def test_online_entry_points_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device runs")
    jobs = _random_jobs(port_sim, np.random.default_rng(0), 4)
    arg = [jobs] if entry in ("online_schedule_fleet",
                              "competitive_ratio_batch") else jobs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(port_online, entry)(arg)
