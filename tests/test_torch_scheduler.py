"""Parity of the port's device search (`repro_torch.core.scheduler_torch`)
with the JAX reference (`repro.core.scheduler_jax`), both on the CPU.

Instances are integer-valued, so float32 sums are exact in any order and
the two searches must return identical assignments and bit-identical
objectives (DESIGN.md §8). The instance size is fixed (n = 24, no padding
beyond it), so the reference compiles one kernel per (objective, fleet).
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


def test_unported_regimes_raise():
    jobs = _int_jobs(port_sim, np.random.default_rng(0), 8)
    with pytest.raises(NotImplementedError, match="greedy init"):
        scheduler_torch.tabu_search_batched([jobs], device="cpu")
    with pytest.raises(NotImplementedError, match="pass regime"):
        # 8 movable jobs padded to 64 rows: the background-heavy regime
        scheduler_torch.tabu_search_batched([jobs], [[2] * 8], pad_to=64,
                                            device="cpu")


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
