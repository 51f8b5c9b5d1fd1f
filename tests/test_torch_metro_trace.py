"""Parity of the port's metro flight recorder (`repro_torch.metro.tracing`,
`repro_torch.metro.sanitizer`) with the JAX reference's, both on the CPU:
the traced/untraced CRC parity over every chaos pack, span streams and
the exact deadline-miss attribution, the JSONL and Chrome exports, the
postmortem report, and the engine self-profile, whose shape-cache counters
the port replaces with `device_searches` (the batched device searches of
the run).
"""
import dataclasses
import json

import pytest

from metro_parity import (MPT, PKGS, PORT, REF, assert_same_run, crc,
                          isolate_reference_dispatch,  # noqa: F401
                          policy, run_metro, run_pack)
from repro_torch.core import scheduler_torch
from repro_torch.core.tiers import CC

ALL_PACKS = ("default", "edge_brownout", "mass_casualty_crash",
             "degraded_network", "diurnal_day", "fail_slow_tail")


def _tabu(hedged):
    def make(M):
        pol = policy(M, "tabu")
        return M.policies.HedgingPolicy(inner=pol) if hedged else pol
    return make


def _run(M, pack="edge_brownout", wards=2, horizon=45.0, hedged=False,
         **kw):
    if hedged:
        kw["hedge_factor"] = 1.5
    return run_pack(M, pack, _tabu(hedged), wards=wards, horizon=horizon,
                    **kw)[1]


def _spans(res):
    return [dataclasses.astuple(sp) for sp in res.trace.spans]


@pytest.fixture(scope="module")
def brownout():
    return {M.name: _run(M, trace=True) for M in PKGS}


@pytest.fixture(scope="module")
def tail():
    # the pack's canonical shape: reduced horizons never enter the deep
    # slowdown windows, so no hedge race would fire
    return {M.name: _run(M, "fail_slow_tail", wards=None, horizon=None,
                         hedged=True, trace=True, profile=True,
                         retry_backoff=0.5, max_attempts=4) for M in PKGS}


@pytest.mark.parametrize("pack", ALL_PACKS)
def test_traced_run_is_bit_identical(pack):
    hedged = pack == "fail_slow_tail"
    ref = _run(REF, pack, horizon=30.0, hedged=hedged)
    base = _run(PORT, pack, horizon=30.0, hedged=hedged)
    traced = _run(PORT, pack, horizon=30.0, hedged=hedged, trace=True,
                  profile=True, sanitize=True)
    assert_same_run(ref, base)
    assert crc(traced) == crc(base) == crc(ref)
    assert traced.metrics.summary(traced.utilization) == \
        base.metrics.summary(base.utilization)
    assert base.trace is None and base.profile is None


@pytest.mark.parametrize("which", ["brownout", "tail"])
def test_spans_and_attribution_match_reference(which, request):
    runs = request.getfixturevalue(which)
    ref, port = runs["repro"], runs["repro_torch"]
    assert_same_run(ref, port)
    assert _spans(port) == _spans(ref)
    assert port.trace.rows == ref.trace.rows
    assert port.trace.blame_table() == ref.trace.blame_table()
    roots = [sp for sp in port.trace.spans if sp.name == "root"]
    assert len(roots) == port.metrics.completions + port.metrics.shed
    by_id = {sp.span: sp for sp in port.trace.spans}
    for sp in port.trace.spans:
        assert sp.t1 >= sp.t0
        if sp.parent is not None:
            assert by_id[sp.parent].t0 <= sp.t0 <= sp.t1 <= \
                by_id[sp.parent].t1
    for r in port.trace.attribution(missed_only=False):
        assert sum(r["terms"].values()) == pytest.approx(r["response"],
                                                         abs=1e-6)


def test_hedge_races_and_retries_are_traced(tail):
    port = tail["repro_torch"]
    assert port.metrics.hedges > 0
    spans = port.trace.spans
    attempts = {}
    for sp in spans:
        if sp.cat == "attempt" and sp.name == "attempt":
            attempts.setdefault(sp.trace, []).append(sp.attrs["outcome"])
    for rec in port.event_log:
        if rec[0] == "complete":
            got = attempts[f"w{rec[2]}j{rec[3]}"]
            assert len(got) == rec[9] and got.count("complete") == 1


def test_sanitizer_matches_reference_on_a_crash_pack():
    """The armed sanitizer sees the same started attempts in both
    packages, each one visible in the trace on its (machine, slot); a
    breach raises SanitizerViolation."""
    started = {}
    for M in PKGS:
        sc = M.traces.make_scenario("mass_casualty_crash", 0, wards=2,
                                    horizon=45.0)
        eng = M.engine.MetroEngine(
            sc.traces, policy(M, "tabu"), machines_per_tier=MPT,
            failures=sc.failures, scale_events=sc.scales,
            network_events=sc.network, slowdowns=sc.slowdowns)
        res = eng.run(sanitize=True, trace=True)
        started[M.name] = dict(eng._san._started)
        occupancy = {}
        for sp in res.trace.spans:
            if sp.cat == "attempt" and "machine" in sp.attrs:
                occupancy.setdefault(sp.trace, []).append(
                    (sp.attrs["machine"], sp.attrs.get("slot")))
        for (b, i, _, _), (machine, slot, _) in started[M.name].items():
            assert (machine, slot) in occupancy.get(f"w{b}j{i}", [])
        with pytest.raises(M.sanitizer.SanitizerViolation, match="I9"):
            eng._san._fail("I9", "probe")
    assert started["repro_torch"] == started["repro"] != {}


def test_exports_match_reference(tmp_path, brownout, tail):
    for label, runs in (("brownout", brownout), ("tail", tail)):
        for fmt in ("jsonl", "chrome"):
            text = {}
            for name, res in runs.items():
                path = tmp_path / f"{label}.{name}.{fmt}"
                n = res.trace.write(str(path), fmt)
                text[name] = path.read_text()
            assert text["repro_torch"] == text["repro"], (label, fmt)
            if fmt == "jsonl":
                lines = text["repro_torch"].splitlines()
                assert n == len(lines) == len(runs["repro_torch"].trace.spans)
            else:
                doc = json.loads(text["repro_torch"])
                assert n == len(doc["traceEvents"])
                assert {"M", "X"} <= {e["ph"] for e in doc["traceEvents"]}
    for M in PKGS:
        with pytest.raises(ValueError, match="unknown trace format"):
            M.tracing.MetroTrace(spans=[], rows=[]).write(
                str(tmp_path / "x"), "protobuf")


def test_postmortem_reports_device_searches(tail):
    ref, port = tail["repro"], tail["repro_torch"]
    assert port.trace.format_postmortem("tabu") == \
        ref.trace.format_postmortem("tabu")
    text = port.trace.format_postmortem("tabu", port.profile, 3)
    assert text.startswith("postmortem[tabu]")
    assert "engine profile:" in text and "  device searches: 3" in text
    pm = port.trace.postmortem_json("tabu", port.profile, 3)
    want = ref.trace.postmortem_json("tabu")
    assert pm["device_searches"] == 3 and "compiled_shapes" not in pm
    assert {k: v for k, v in pm.items() if k not in
            ("profile", "device_searches")} == \
        {k: v for k, v in want.items() if k not in
         ("profile", "compiled_shapes")}
    assert json.dumps(pm)


def test_engine_profile_counts_device_searches(tail):
    prof = tail["repro_torch"].profile
    assert prof["events"] == tail["repro_torch"].events
    assert prof["decide_calls"] > 0 and prof["heap_pushes"] >= prof["events"]
    assert prof["device_searches"] == 0            # no four-ward replan
    assert "compiled_shapes_delta" not in prof
    ref_prof = tail["repro"].profile
    assert set(ref_prof) - set(prof) == {"compiled_shapes",
                                         "compiled_shapes_delta"}
    assert set(prof) - set(ref_prof) == {"device_searches"}
    # a run whose cloud failures replan four wards at once
    before = scheduler_torch.tabu_search_batched.calls
    _, res = run_pack(PORT, "degraded_network", "tabu", profile=True)
    assert res.profile["device_searches"] == 4 == \
        scheduler_torch.tabu_search_batched.calls - before


def test_metrics_flush_matches_reference(brownout):
    got = []
    for M in PKGS:
        m = M.metrics.MetroMetrics(window=60.0)
        m.record(10.0, "c", response=25.0, deadline=20.0, tier=CC, proc=5.0)
        m.record_shed(30.0, "c")
        assert not m.recent
        m.flush()
        m.flush()
        got.append(m.summary())
    assert got[0] == got[1]
    assert (got[1]["recent_windows"], got[1]["recent_finished"]) == (1, 2)
    res = brownout["repro_torch"]
    s = res.metrics.summary(res.utilization)
    assert s["recent_windows"] >= 1 and s["recent_finished"] > 0


def test_serve_metro_trace_postmortem_and_metrics_files(tmp_path, capsys):
    """`serve --metro --trace --postmortem` on the port writes the same
    span files as the reference's run_metro; the postmortem JSON carries
    device_searches where the reference's carries its shape cache."""
    kw = dict(scenario="edge_brownout", wards=2, hours=0.75,
              policies=("greedy", "tabu"))
    paths = {}
    for M in PKGS:
        d = tmp_path / M.name
        d.mkdir()
        paths[M.name] = d
        run_metro(M, trace=str(d / "t.json"), trace_format="chrome",
                  postmortem_out=str(d / "pm.json"), **kw)
    for name in ("greedy", "tabu"):
        assert (paths["repro_torch"] / f"t.{name}.json").read_text() == \
            (paths["repro"] / f"t.{name}.json").read_text()
    pm = json.loads((paths["repro_torch"] / "pm.json").read_text())
    assert set(pm) == {"greedy", "tabu"}
    assert all(v["device_searches"] == 0 for v in pm.values())
    out = PORT.serve.main([
        "--metro", "--device", "cpu", "--device-threshold", "1000000000",
        "--scenario", "edge_brownout", "--wards", "2", "--metro-hours",
        "0.75", "--metro-policies", "tabu", "--trace",
        str(tmp_path / "cli.jsonl"), "--postmortem", "--check-determinism",
        "--sanitize", "--metrics-out", str(tmp_path / "m.json")])
    text = capsys.readouterr().out
    assert "postmortem[tabu]" in text and "device searches: 0" in text
    assert "bit-identical" in text
    assert json.loads((tmp_path / "m.json").read_text())["tabu"][
        "event_log_hash"] == out["tabu"]["event_log_hash"]
    assert (tmp_path / "cli.jsonl").read_text().count("\n") > 0
