"""Parity of the port's device search (`repro_torch.core.scheduler_torch`)
with the JAX reference (`repro.core.scheduler_jax`), both on the CPU.

Instances are integer-valued, so float32 sums are exact in any order and
the two searches must return identical assignments and bit-identical
objectives (DESIGN.md §8), in both regimes ("round": movable-dominated
batches; "pass": background-heavy ones), with an explicit initial and with
the device greedy init. Shapes repeat across cases, so the reference
compiles one kernel per (shape, objective, fleet).
"""
import zlib

import numpy as np
import pytest
import torch

from repro.core import scheduler as ref_scheduler
from repro.core import scheduler_jax
from repro.core import simulator as ref_sim
from repro_torch.core import scheduler as port_scheduler
from repro_torch.core import scheduler_torch
from repro_torch.core import simulator as port_sim
from repro_torch.core.tiers import CC, ED, ES

N = 24
FLEETS = ((1, 1), (2, 3))
OBJECTIVES = ("weighted", "unweighted", "last")


@pytest.fixture(autouse=True, scope="module")
def _isolate_compiled_shapes():
    """The reference's `search` with jax_threshold=0 records its shape in
    a module-global fast-path set that changes its later CPU dispatch;
    restore it so later test modules keep their default dispatch."""
    saved = set(ref_scheduler._COMPILED_SHAPES)
    stats = dict(ref_scheduler._SHAPE_STATS)
    yield
    ref_scheduler._COMPILED_SHAPES.clear()
    ref_scheduler._COMPILED_SHAPES.update(saved)
    ref_scheduler._SHAPE_STATS.update(stats)


def _int_jobs(sim, rng, n):
    """Tie-heavy integer instance built with `sim`'s JobSpec."""
    return [sim.JobSpec(name=f"J{i}", release=float(rng.integers(0, 20)),
                        weight=float(rng.integers(1, 4)),
                        proc={t: float(rng.integers(1, 25))
                              for t in (CC, ES, ED)},
                        trans={CC: float(rng.integers(0, 40)),
                               ES: float(rng.integers(0, 10)), ED: 0.0})
            for i in range(n)]


def _busy(rng, fleet):
    return tuple([float(rng.integers(0, 30)) for _ in range(m)]
                 for m in fleet)


@pytest.mark.parametrize("busy", [False, True], ids=["idle", "busy"])
@pytest.mark.parametrize("fleet", FLEETS, ids=["1x1", "2x3"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_tabu_search_batched_matches_jax(objective, fleet, busy):
    rng = np.random.default_rng(
        zlib.crc32(f"{objective}{fleet}{busy}".encode()))
    B = 3
    seeds = [int(rng.integers(2**31)) for _ in range(B)]
    ref_jobs = [_int_jobs(ref_sim, np.random.default_rng(s), N)
                for s in seeds]
    port_jobs = [_int_jobs(port_sim, np.random.default_rng(s), N)
                 for s in seeds]
    init = [[int(x) for x in rng.integers(0, 3, N)] for _ in range(B)]
    busy_until = [_busy(rng, fleet) for _ in range(B)] if busy else None

    ref_v, ref_a = scheduler_jax.tabu_search_batched(
        ref_jobs, init, objective=objective, machines_per_tier=fleet,
        busy_until=busy_until)
    calls = scheduler_torch.tabu_search_batched.calls
    port_v, port_a = scheduler_torch.tabu_search_batched(
        port_jobs, init, objective=objective, machines_per_tier=fleet,
        busy_until=busy_until, device="cpu")
    assert scheduler_torch.tabu_search_batched.calls == calls + 1
    for b in range(B):
        np.testing.assert_array_equal(port_a[b], np.asarray(ref_a[b]))
    np.testing.assert_array_equal(port_v, np.asarray(ref_v))


@pytest.mark.parametrize("fleet", FLEETS, ids=["1x1", "2x3"])
def test_evaluate_assignments_matches_simulate(fleet):
    """The whole-assignment oracle against the port's own simulator, the
    single source of truth for a schedule's cost (DESIGN.md §1)."""
    rng = np.random.default_rng(7)
    jobs = _int_jobs(port_sim, rng, 10)
    busy = _busy(rng, fleet)
    assign = rng.integers(0, 3, (16, 10))
    rel, w, proc, trans = scheduler_torch.specs_to_tensors(jobs, "cpu")
    got = scheduler_torch.evaluate_assignments(
        assign, rel, w, proc, trans, machines_per_tier=fleet,
        busy_until=busy)
    mpt = {CC: fleet[0], ES: fleet[1]}
    for i, a in enumerate(assign):
        s = port_sim.simulate(jobs, [port_sim.MACHINES[k] for k in a],
                              machines_per_tier=mpt,
                              busy_until={CC: busy[0], ES: busy[1]})
        assert float(got["weighted"][i]) == s.weighted_sum
        assert float(got["unweighted"][i]) == s.unweighted_sum
        assert float(got["last"][i]) == s.last_end


@pytest.mark.parametrize("fleet", FLEETS, ids=["1x1", "2x3"])
def test_evaluate_assignments_matches_jax(fleet):
    rng = np.random.default_rng(11)
    seed = int(rng.integers(2**31))
    ref_jobs = _int_jobs(ref_sim, np.random.default_rng(seed), 12)
    port_jobs = _int_jobs(port_sim, np.random.default_rng(seed), 12)
    assign = rng.integers(0, 3, (32, 12)).astype(np.int32)
    busy = _busy(rng, fleet)
    ref = scheduler_jax.evaluate_assignments(
        assign, *scheduler_jax.specs_to_arrays(ref_jobs),
        machines_per_tier=fleet, busy_until=busy)
    got = scheduler_torch.evaluate_assignments(
        assign, *scheduler_torch.specs_to_tensors(port_jobs, "cpu"),
        machines_per_tier=fleet, busy_until=busy)
    for key in OBJECTIVES:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(ref[key]))


def test_exact_optimum_device_matches_exact_optimum():
    jobs = _int_jobs(port_sim, np.random.default_rng(3), 6)
    best_v, best_a = scheduler_torch.exact_optimum_device(jobs,
                                                          device="cpu")
    exact = port_scheduler.exact_optimum(jobs)
    assert best_v == exact.weighted_sum
    s = port_sim.simulate(jobs, [port_sim.MACHINES[k] for k in best_a])
    assert s.weighted_sum == best_v


def test_round_regime_keeps_first_minimum_on_ties():
    """Identical jobs make every candidate move tie; the port must pick
    the same (first) one as the reference's argmin."""
    def jobs(sim):
        return [sim.JobSpec(name=f"J{i}", release=0.0, weight=1.0,
                            proc={CC: 2.0, ES: 2.0, ED: 9.0},
                            trans={CC: 1.0, ES: 1.0, ED: 0.0})
                for i in range(8)]
    init = [[2] * 8]
    ref_v, ref_a = scheduler_jax.tabu_search_batched(
        [jobs(ref_sim)], init, machines_per_tier=(2, 3))
    port_v, port_a = scheduler_torch.tabu_search_batched(
        [jobs(port_sim)], init, machines_per_tier=(2, 3), device="cpu")
    np.testing.assert_array_equal(port_a[0], np.asarray(ref_a[0]))
    assert float(port_v[0]) == float(ref_v[0])


def test_lexsort_matches_numpy():
    rng = np.random.default_rng(5)
    minor = rng.integers(0, 3, (4, 30)).astype(np.float32)
    major = rng.integers(0, 4, (4, 30)).astype(np.float32)
    got = scheduler_torch._lexsort2(torch.from_numpy(minor),
                                    torch.from_numpy(major)).numpy()
    for b in range(4):
        np.testing.assert_array_equal(got[b],
                                      np.lexsort((minor[b], major[b])))


def test_search_device_path_matches_reference():
    """`search` with the device path forced on both sides (threshold 0)
    returns the reference's schedule."""
    seed = 21
    ref_jobs = _int_jobs(ref_sim, np.random.default_rng(seed), N)
    port_jobs = _int_jobs(port_sim, np.random.default_rng(seed), N)
    mpt = {CC: 2, ES: 3}
    ref = ref_scheduler.search(ref_jobs, jax_threshold=0,
                               machines_per_tier=mpt)
    calls = scheduler_torch.tabu_search_batched.calls
    got = port_scheduler.search(port_jobs, device_threshold=0,
                                machines_per_tier=mpt, device="cpu")
    assert scheduler_torch.tabu_search_batched.calls == calls + 1
    assert got.assignment() == ref.assignment()
    assert got.weighted_sum == ref.weighted_sum


def test_search_default_dispatch_stays_in_python_on_cpu():
    jobs = _int_jobs(port_sim, np.random.default_rng(2), 80)
    calls = scheduler_torch.tabu_search_batched.calls
    port_scheduler.search(jobs, device="cpu")
    assert scheduler_torch.tabu_search_batched.calls == calls


@pytest.mark.parametrize("entry", ["search", "strategy_table"])
def test_no_device_raises_without_a_card(entry):
    """With no `device`, `search` and `strategy_table` take "cuda", as
    every entry point of the port does, and raise where torch sees no
    CUDA device rather than dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device runs")
    jobs = _int_jobs(port_sim, np.random.default_rng(4), N)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(port_scheduler, entry)(jobs, device_threshold=0)


@pytest.mark.parametrize("entry", ["tabu_search_batched",
                                   "exact_optimum_device",
                                   "tabu_search_device",
                                   "stochastic_search"])
def test_device_search_raises_without_a_card(entry):
    """The device search's own entry points take "cuda" when `device` is
    omitted, as every entry point of the port does, and raise where torch
    sees no CUDA device rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the default device runs")
    jobs = _int_jobs(port_sim, np.random.default_rng(4), 6)
    call = {"tabu_search_batched":
            lambda: scheduler_torch.tabu_search_batched([jobs]),
            "exact_optimum_device":
            lambda: scheduler_torch.exact_optimum_device(jobs),
            "tabu_search_device":
            lambda: scheduler_torch.tabu_search_device(jobs),
            "stochastic_search":
            lambda: scheduler_torch.stochastic_search(jobs, 0, [2] * 6)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call[entry]()


# ------------------------------------------------- frozen, reserved, padded
def _reservations(pkg_sim, rng, per_tier=3):
    """`per_tier` integer reservations on each shared tier."""
    return {tier: [pkg_sim.Reservation(
        arrival=float(rel + rng.integers(0, 40)),
        proc=float(rng.integers(1, 25)), release=float(rel),
        weight=float(rng.integers(0, 4)))
        for rel in rng.integers(0, 20, per_tier)] for tier in (CC, ES)}


def _batch_case(seed, sizes, fleet, busy, frozen_share=0.3, resv=True,
                initial=True):
    """One ragged batch built twice from the same draws, once with each
    package's JobSpec/Reservation: (reference kwargs, port kwargs)."""
    out = []
    for pkg_sim in (ref_sim, port_sim):
        rng = np.random.default_rng(seed)
        jobs = [_int_jobs(pkg_sim, rng, n) for n in sizes]
        kw = {"machines_per_tier": fleet}
        if initial:
            kw["initial"] = [[int(x) for x in rng.integers(0, 3, n)]
                             for n in sizes]
            kw["frozen"] = [list(rng.random(n) < frozen_share)
                            for n in sizes]
        if resv:
            kw["reserved"] = [_reservations(pkg_sim, rng) for _ in sizes]
        if busy:
            kw["busy_until"] = [_busy(rng, fleet) for _ in sizes]
        out.append((jobs, kw))
    return out


def _assert_batched_parity(ref_case, port_case, objective, **extra):
    (ref_jobs, ref_kw), (port_jobs, port_kw) = ref_case, port_case
    ref_v, ref_a = scheduler_jax.tabu_search_batched(
        ref_jobs, objective=objective, **ref_kw, **extra)
    port_v, port_a = scheduler_torch.tabu_search_batched(
        port_jobs, objective=objective, device="cpu", **port_kw, **extra)
    assert len(port_a) == len(ref_a)
    for b in range(len(ref_a)):
        np.testing.assert_array_equal(port_a[b], np.asarray(ref_a[b]))
    np.testing.assert_array_equal(port_v, np.asarray(ref_v))


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("busy", [False, True], ids=["idle", "busy"])
@pytest.mark.parametrize("fleet", FLEETS, ids=["1x1", "2x3"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_round_regime_ragged_frozen_reserved_padded(objective, fleet, busy,
                                                    seed):
    """The round regime on ragged wards (24/17/9 jobs), 30 % of each
    ward frozen, 3 + 3 reservations per ward, padded to 40 rows: the
    movable bucket (32) is at least half the rows, so both packages take
    the round regime."""
    ref_case, port_case = _batch_case(
        zlib.crc32(f"round{objective}{fleet}{busy}{seed}".encode()),
        (24, 17, 9), fleet, busy)
    _assert_batched_parity(ref_case, port_case, objective, pad_to=40)


@pytest.mark.parametrize("initial", [True, False],
                         ids=["explicit", "greedy"])
@pytest.mark.parametrize("busy", [False, True], ids=["idle", "busy"])
@pytest.mark.parametrize("fleet", FLEETS, ids=["1x1", "2x3"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_pass_regime_matches_jax(objective, fleet, busy, initial):
    """The background-heavy pass regime: ragged wards of at most 16 jobs
    padded to 64 rows (4 x the movable bucket of 16). With an explicit
    initial, 30 % of each ward is frozen and 3 + 3 reservations ride
    along; without one, both packages start from the device greedy
    init."""
    ref_case, port_case = _batch_case(
        zlib.crc32(f"pass{objective}{fleet}{busy}{initial}".encode()),
        (16, 11, 6), fleet, busy, resv=initial, initial=initial)
    _assert_batched_parity(ref_case, port_case, objective, pad_to=64)


@pytest.mark.parametrize("busy", [False, True], ids=["idle", "busy"])
@pytest.mark.parametrize("fleet", FLEETS, ids=["1x1", "2x3"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_greedy_init_matches_jax(objective, fleet, busy):
    """`initial=None` in the round regime: the device greedy init, then
    the search, on ragged wards."""
    ref_case, port_case = _batch_case(
        zlib.crc32(f"greedy{objective}{fleet}{busy}".encode()),
        (24, 17, 9), fleet, busy, resv=False, initial=False)
    _assert_batched_parity(ref_case, port_case, objective)


def test_greedy_probe_matches_greedy_schedule():
    """max_rounds=0 returns the greedy initial, and the device greedy is
    the port's `greedy_schedule`, on random fleets with some machines
    busy — the analogue of TestPhantomPadding's greedy probe."""
    for seed in range(10):
        rng = np.random.default_rng(400 + seed)
        jobs = _int_jobs(port_sim, rng, int(rng.integers(2, 15)))
        mpt = (int(rng.integers(1, 4)), int(rng.integers(1, 4)))
        busy = tuple([float(rng.choice([0.0, float(rng.integers(1, 40))]))
                      for _ in range(int(rng.integers(0, m + 1)))]
                     for m in mpt)
        py = port_scheduler.greedy_schedule(
            jobs, machines_per_tier={CC: mpt[0], ES: mpt[1]},
            busy_until={CC: busy[0], ES: busy[1]})
        _, assigns = scheduler_torch.tabu_search_batched(
            [jobs], max_rounds=0, machines_per_tier=[mpt],
            busy_until=[busy], device="cpu")
        assert [port_sim.MACHINES[int(i)] for i in assigns[0]] == py, seed


def test_phantom_padding_contributes_zero():
    """A ward padded next to a larger one returns its solo objective."""
    small = _int_jobs(port_sim, np.random.default_rng(1), 4)
    big = _int_jobs(port_sim, np.random.default_rng(2), 15)
    for objective in OBJECTIVES:
        vals, assigns = scheduler_torch.tabu_search_batched(
            [small, big], objective=objective, device="cpu")
        v_solo, _ = scheduler_torch.tabu_search_device(
            small, objective=objective, device="cpu")
        assert vals[0] == v_solo
        assert len(assigns[0]) == 4


@pytest.mark.parametrize("fleet", FLEETS, ids=["1x1", "2x3"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_tabu_search_device_matches_tabu_search_jax(objective, fleet):
    """The B = 1 wrapper, with a busy fleet, frozen jobs and reservations
    (padded to a pass-regime shape by the reservations' rows)."""
    out = []
    for pkg_sim in (ref_sim, port_sim):
        rng = np.random.default_rng(zlib.crc32(
            f"solo{objective}{fleet}".encode()))
        jobs = _int_jobs(pkg_sim, rng, 12)
        out.append((jobs, dict(
            initial=[int(x) for x in rng.integers(0, 3, 12)],
            frozen=list(rng.random(12) < 0.3),
            reserved=_reservations(pkg_sim, rng, per_tier=12),
            busy_until=_busy(rng, fleet), machines_per_tier=fleet,
            objective=objective)))
    ref_v, ref_a = scheduler_jax.tabu_search_jax(out[0][0], **out[0][1])
    port_v, port_a = scheduler_torch.tabu_search_device(
        out[1][0], device="cpu", **out[1][1])
    assert port_v == ref_v
    np.testing.assert_array_equal(port_a, np.asarray(ref_a))


def test_stochastic_search_keeps_its_promises():
    """torch cannot replay jax.random, so the port's stochastic search is
    held to what it promises (TestStochasticFleet's analogue): it scores
    the fleet it is given (its value is the exact simulator's under that
    fleet and occupancy), it never returns worse than the initial, and it
    keeps the best of each iteration — from one seed, more iterations
    never give a worse result."""
    jobs = _int_jobs(port_sim, np.random.default_rng(5), 12)
    mpt = (2, 3)
    busy = ([6.0, 14.0], [3.0])
    fleet = {CC: mpt[0], ES: mpt[1]}
    initial = np.full(len(jobs), 2)               # every job on its device
    init_v = port_sim.simulate(
        jobs, [port_sim.MACHINES[int(i)] for i in initial],
        machines_per_tier=fleet,
        busy_until={CC: busy[0], ES: busy[1]}).weighted_sum
    prev = init_v
    for iters in (0, 1, 5, 30):
        v, a = scheduler_torch.stochastic_search(
            jobs, 0, initial, iters=iters, pop=64, machines_per_tier=mpt,
            busy_until=busy, device="cpu")
        exact = port_sim.simulate(
            jobs, [port_sim.MACHINES[int(i)] for i in a],
            machines_per_tier=fleet, busy_until={CC: busy[0], ES: busy[1]})
        assert v == exact.weighted_sum
        assert v <= prev
        prev = v
    assert prev < init_v
