"""The two metro packages side by side, for the port's parity tests.

`REF` is the JAX reference (`repro`), `PORT` the PyTorch port
(`repro_torch`); each is a namespace with the same names, so one test body
drives both. Every search-based policy is pinned the same way on both
sides: the single-ward search to the Python path (the reference's
`jax_threshold`, the port's `device_threshold`), the port's device search
on the CPU. Replans of four or more wards still go through each package's
batched device search, as in the reference's own benchmark.
"""
import dataclasses
import zlib
from types import SimpleNamespace

import pytest

import repro.core.online
import repro.core.problems
import repro.core.scheduler
import repro.core.simulator
import repro.launch.serve
import repro.metro.engine
import repro.metro.metrics
import repro.metro.policies
import repro.metro.sanitizer
import repro.metro.traces
import repro.metro.tracing
import repro_torch.core.online
import repro_torch.core.problems
import repro_torch.core.scheduler
import repro_torch.core.simulator
import repro_torch.launch.serve
import repro_torch.metro.engine
import repro_torch.metro.metrics
import repro_torch.metro.policies
import repro_torch.metro.sanitizer
import repro_torch.metro.traces
import repro_torch.metro.tracing
from repro_torch.core.tiers import CC, ED, ES

PYTHON_ONLY = 10 ** 9
MPT = {CC: 2, ES: 2}


def _package(root, pin):
    mods = {name: getattr(root.core, name) for name in
            ("online", "problems", "scheduler", "simulator")}
    mods.update({name: getattr(root.metro, name) for name in
                 ("engine", "metrics", "policies", "sanitizer", "traces",
                  "tracing")})
    return SimpleNamespace(name=root.__name__, serve=root.launch.serve,
                           JobSpec=root.core.simulator.JobSpec, pin=pin,
                           **mods)


REF = _package(repro, {"jax_threshold": PYTHON_ONLY})
PORT = _package(repro_torch, {"device_threshold": PYTHON_ONLY,
                              "device": "cpu"})
PKGS = (REF, PORT)


@pytest.fixture(autouse=True, scope="module")
def isolate_reference_dispatch():
    """The reference's batched searches record their shapes in a
    module-global cache that changes its later single-ward dispatch;
    restore it so later test modules in the worker keep their dispatch."""
    saved = set(repro.core.scheduler._COMPILED_SHAPES)
    stats = dict(repro.core.scheduler._SHAPE_STATS)
    yield
    repro.core.scheduler._COMPILED_SHAPES.clear()
    repro.core.scheduler._COMPILED_SHAPES.update(saved)
    repro.core.scheduler._SHAPE_STATS.update(stats)


def policy(M, name, **kw):
    """`make_policy(name)` of package M, with the search pinned."""
    if name in ("tabu", "fleet"):
        kw = {**M.pin, **kw}
    return M.policies.make_policy(name, **kw)


def run_pack(M, pack, pol, seed=0, wards=None, horizon=None, mpt=MPT,
             **kw):
    """simulate_metro of a scenario pack under policy `pol` (a name, or a
    function of the package that builds one)."""
    sc = M.traces.make_scenario(pack, seed, wards=wards, horizon=horizon)
    p = policy(M, pol) if isinstance(pol, str) else pol(M)
    res = M.engine.simulate_metro(
        sc.traces, p, machines_per_tier=mpt, failures=sc.failures,
        scale_events=sc.scales, network_events=sc.network,
        slowdowns=sc.slowdowns, **kw)
    return sc, res


def run_metro(M, **kw):
    """serve.run_metro of package M, quiet and pinned."""
    return M.serve.run_metro(verbose=False, **M.pin, **kw)


def crc(result) -> int:
    return zlib.crc32(repr(result.event_log).encode())


def entries(result):
    """Every ward's committed schedule as plain tuples."""
    return [[(e.job.name, e.machine, e.arrival, e.start, e.end)
             for e in s.entries] for s in result.wards]


def assert_same_run(ref, port):
    """Two MetroResults with the same event log, schedules and metrics."""
    assert port.event_log == ref.event_log
    assert entries(port) == entries(ref)
    assert [s.weighted_sum for s in port.wards] == \
        [s.weighted_sum for s in ref.wards]
    assert port.metrics.summary(port.utilization) == \
        ref.metrics.summary(ref.utilization)
    assert port.events == ref.events


def on_both(case):
    """Run `case(M)` on the reference and the port; the two MetroResults
    must agree event for event. -> the port's."""
    ref, port = (case(M) for M in PKGS)
    assert_same_run(ref, port)
    return port


def cloud_job(M, name, release, proc_c, trans_c=2.0, proc_d=500.0,
              deadline=float("inf"), weight=1.0, workload=""):
    """A job of package M only the cloud can run sensibly (edge and,
    unless proc_d says otherwise, device prohibitive)."""
    return M.JobSpec(name=name, release=release, weight=weight,
                     proc={CC: proc_c, ES: 500.0, ED: proc_d},
                     trans={CC: trans_c, ES: 0.0, ED: 0.0},
                     deadline=deadline, workload=workload)


def timing_free(summary: dict) -> dict:
    """A run_metro summary without its clock readings and without the
    counter each package names after its own search cache."""
    return {k: v for k, v in summary.items()
            if k not in ("seconds", "events_per_s", "compiled_shapes",
                         "device_searches")}


def to_port(x):
    """A reference value with every JobSpec and Reservation rebuilt as the
    port's (containers copied, scalars kept)."""
    if isinstance(x, repro.core.simulator.JobSpec):
        return repro_torch.core.simulator.JobSpec(
            **{f.name: to_port(getattr(x, f.name))
               for f in dataclasses.fields(x)})
    if isinstance(x, repro.core.simulator.Reservation):
        return repro_torch.core.simulator.Reservation(
            **{f.name: getattr(x, f.name) for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: to_port(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_port(v) for v in x)
    return x
