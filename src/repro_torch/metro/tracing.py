"""Metro flight recorder (DESIGN.md §15): per-job span tracing,
deadline-miss attribution, and engine self-profiling.

The metrics layer (§10) reports *that* deadlines were missed; this module
records *why*. A `MetroTracer` is a read-only observer the engine consults
when run with ``MetroEngine.run(trace=True)`` (serve ``--trace PATH``):
every job gets one ROOT span covering release → terminal, with child
spans for each attempt phase —

  * ``decision``  — instant marker at the attempt's first policy verdict;
  * ``backoff``   — a crash-retry's exponential-backoff gap;
  * ``wait``      — time between entering the attempt (or re-shipping)
                    and the data being shipped, plus queue wait between
                    data arrival at the tier and service start;
  * ``transmit``  — the uplink window of the commit that actually shipped
                    the data (the in-flight contract: a replan that keeps
                    the tier keeps the original ship instant);
  * ``service``   — slot occupancy [start, end), split into ``service_seg``
                    children at every fail-slow rate-change boundary of
                    the serving slot's `_rate_profile`;
  * ``attempt``   — one per dispatch (crash kills start a NEW attempt,
                    matching the sanitizer's I3 attempt keys), including
                    hedge backups; losers get a ``hedge_loser`` span cut
                    at the winner's completion instant.

Everything is derived from the engine's existing event stream plus
read-only peeks at its commitment state: the tracer never mutates engine
state, never pushes events and never touches the event log, so traced
runs produce BIT-IDENTICAL event-log CRCs to untraced runs (hard-gated by
the ``metro_observability`` bench section). Span/trace identifiers are
deterministic seeded counters in event order — no wall clock, no uuid
(reprolint R002/R003 clean).

Deadline-miss attribution: for every finished job the tracer derives an
EXACT additive decomposition of its response time,

    response = retry_waste + wait + transmit + service + slowdown

where ``retry_waste`` is the time lost before the final attempt entered
the decision path (killed attempts + backoff gaps; for a winning hedge
backup, the straggler window before the backup dispatched),
``transmit`` is the final ship's uplink window, ``wait`` is requeue +
queue time, ``service`` the nominal proc on the serving tier, and
``slowdown`` the fail-slow inflation ``(end - start) - proc`` separated
via the slot's piecewise rate profile. The five terms telescope, so they
sum to the measured response to float rounding (tested at 1e-9).
`blame_table()` aggregates missed/shed jobs per (class, tier) and names
the dominant term — the postmortem report `serve --metro --postmortem`
prints and exports.

Exporters: `to_jsonl` (one span object per line) and `to_chrome`
(Chrome trace-event JSON): wards as process rows, machine slots as
thread rows carrying the service occupancy (non-overlapping by engine
invariant I2) and fleet outage/fail-slow windows, jobs as nestable async
tracks — a metro run opens directly in Perfetto.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.tiers import CC, ED, ES

_INF = float("inf")
# attribution decomposition, in reporting order (DESIGN.md §15)
TERMS = ("retry_waste", "wait", "transmit", "service", "slowdown")
# Chrome trace-event timestamps are microseconds; one trace time unit
# (a simulated minute) renders as one second of trace time
_CHROME_US = 1e6


@dataclass
class Span:
    """One flight-recorder span. `trace` keys the job (``w<ward>j<idx>``,
    or ``fleet`` for pool-level outage/slowdown windows); `span`/`parent`
    are deterministic per-run counters (event order, no wall clock)."""
    trace: str
    span: int
    parent: Optional[int]
    name: str                       # root/attempt/wait/transmit/service/...
    cat: str                        # job | attempt | phase | fleet
    t0: float
    t1: float
    ward: int = -1
    attrs: dict = field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return {"trace": self.trace, "span": self.span,
                "parent": self.parent, "name": self.name, "cat": self.cat,
                "t0": self.t0, "t1": self.t1, "ward": self.ward,
                "attrs": self.attrs}


class _JobState:
    """Per-job tracer bookkeeping between hooks."""
    __slots__ = ("release", "root", "attempt", "attempt_t", "decided",
                 "ship_t", "tier", "arrival", "kill_t", "hedge_t",
                 "hedge_tier", "promoted")

    def __init__(self, release: float, root: int):
        self.release = release
        self.root = root
        self.attempt = 0              # crash-kill count so far
        self.attempt_t = release      # entry instant of the live attempt
        self.decided: Optional[float] = None
        self.ship_t: Optional[float] = None  # when the live data shipped
        self.tier: Optional[str] = None
        self.arrival: Optional[float] = None
        self.kill_t: Optional[float] = None  # open backoff gap start
        self.hedge_t: Optional[float] = None
        self.hedge_tier: Optional[str] = None
        self.promoted = False


class MetroTracer:
    """Read-only flight recorder attached by ``MetroEngine.run`` when
    tracing is armed. One instance observes one run; `finish()` freezes
    it into the `MetroTrace` carried on the `MetroResult`."""

    def __init__(self, engine):
        self.eng = engine
        self._seq = 0                              # deterministic span ids
        self.spans: List[Span] = []
        self.rows: List[dict] = []                 # attribution rows
        self._jobs: Dict[Tuple[int, int], _JobState] = {}
        self._open_roots: Dict[Tuple[int, int], Span] = {}

    # ----------------------------------------------------------- plumbing
    def _span(self, trace: str, parent: Optional[int], name: str,
              cat: str, t0: float, t1: float, ward: int = -1,
              **attrs) -> Span:
        self._seq += 1
        sp = Span(trace, self._seq, parent, name, cat, t0, t1, ward,
                  dict(attrs))
        self.spans.append(sp)
        return sp

    @staticmethod
    def _tid(b: int, i: int) -> str:
        return f"w{b}j{i}"

    def _state(self, b: int, i: int) -> _JobState:
        return self._jobs[(b, i)]

    # -------------------------------------------------- event-log mirror
    def on_log(self, rec: tuple) -> None:
        """Mirror of the engine's event log (called right after every
        append). Kinds that carry everything the tracer needs are handled
        here; kinds that need commitment state use the direct hooks."""
        kind = rec[0]
        if kind == "arrive":
            _, t, b, i, name = rec
            if (b, i) not in self._jobs:           # pragma: no branch
                job = self.eng.jobs[b][i]
                root = self._span(self._tid(b, i), None, "root", "job",
                                  t, t, ward=b, episode=name,
                                  wclass=job.workload or "unclassified",
                                  weight=job.weight,
                                  deadline=job.deadline)
                self._jobs[(b, i)] = _JobState(t, root.span)
                self._open_roots[(b, i)] = root
        elif kind == "retry":
            _, t, b, i, _attempt = rec
            st = self._state(b, i)
            if st.kill_t is not None and t > st.kill_t:
                self._span(self._tid(b, i), st.root, "backoff", "phase",
                           st.kill_t, t, ward=b, attempt=st.attempt)
            st.kill_t = None
            st.attempt_t = t
        elif kind in ("shed", "giveup"):
            t, b, i = rec[1], rec[2], rec[3]
            self._finalize_dropped(kind, t, b, i)
        elif kind == "hedge_promote":
            _, t, b, i, machine = rec
            st = self._state(b, i)
            st.promoted = True
            self._span(self._tid(b, i), st.root, "hedge_promote",
                       "phase", t, t, ward=b, machine=machine)
        elif kind == "fail":
            _, t, tier, ward, k, down_until, kill_flag = rec
            if k >= 0:
                self._span("fleet", None, "outage", "fleet", t,
                           down_until, ward=ward, tier=tier, slot=k,
                           crash=bool(kill_flag))
        elif kind == "slow":
            _, t, tier, ward, k, until, factor = rec
            if k >= 0:
                self._span("fleet", None, "fail_slow", "fleet", t, until,
                           ward=ward, tier=tier, slot=k, rate=factor)
        elif kind == "net":
            _, t, tier, factor, on = rec
            self._span("fleet", None, "net_window", "fleet", t, t,
                       tier=tier, factor=factor, opening=bool(on))
        elif kind == "scale":
            _, t, tier, ward, delta = rec
            self._span("fleet", None, "scale", "fleet", t, t, ward=ward,
                       tier=tier, delta=delta)
        # complete / hcomplete / kill / hedge / hedge_cancel / recover /
        # slowend need no mirror: the direct hooks (or nothing) cover them

    # ------------------------------------------------------ direct hooks
    def on_commit(self, now: float, b: int, i: int, tier: str,
                  arrival: float) -> None:
        """A (re)commit of the primary attempt: track the first decision
        instant of the live attempt and the SHIP record — the commit
        whose uplink window the final transmit span reports. A replan
        that keeps the tier keeps its in-flight ship instant; a re-tier
        (or an arrival clamped forward past already-arrived data)
        re-ships from `now`."""
        st = self._state(b, i)
        if st.decided is None:
            st.decided = now
            self._span(self._tid(b, i), st.root, "decision", "phase",
                       now, now, ward=b, tier=tier, attempt=st.attempt)
        if tier != st.tier or arrival != st.arrival:
            st.ship_t, st.tier, st.arrival = now, tier, arrival

    def on_kill(self, now: float, b: int, i: int, commit,
                wasted: float) -> None:
        """A crash killed the in-flight primary attempt: close its
        attempt span and open the next attempt's bookkeeping."""
        st = self._state(b, i)
        sp = self._span(self._tid(b, i), st.root, "attempt", "attempt",
                        st.attempt_t, now, ward=b, attempt=st.attempt,
                        machine=commit.machine, slot=commit.slot,
                        outcome="killed", wasted=wasted)
        if commit.start <= now:
            self._span(self._tid(b, i), sp.span, "service", "phase",
                       commit.start, now, ward=b, machine=commit.machine,
                       slot=commit.slot, partial=True)
        st.attempt += 1
        st.attempt_t = now
        st.kill_t = now
        st.decided = None
        st.ship_t = st.tier = st.arrival = None

    def on_hedge_dispatch(self, now: float, b: int, i: int,
                          backup) -> None:
        st = self._state(b, i)
        st.hedge_t, st.hedge_tier = now, backup.machine
        self._span(self._tid(b, i), st.root, "hedge", "phase", now, now,
                   ward=b, backup=backup.machine)

    def on_hedge_cancel(self, now: float, b: int, i: int, loser,
                        wasted: float, role: str) -> None:
        """The losing attempt of a hedge race (or a crash-killed backup)
        was cancelled at `now`: record the loser span, cut at the
        winner's instant per the §13 cancellation rule."""
        st = self._state(b, i)
        started = loser.start <= now
        t0 = loser.start if started else \
            (st.hedge_t if role == "backup" and st.hedge_t is not None
             else loser.planned_at)
        self._span(self._tid(b, i), st.root, "hedge_loser", "attempt",
                   min(t0, now), now, ward=b, machine=loser.machine,
                   slot=loser.slot, role=role, started=started,
                   wasted=wasted, outcome="cancelled")

    def on_finish(self, now: float, b: int, i: int, commit,
                  hedge_win: bool) -> None:
        """The job completed on `commit` (primary, or the winning/
        promoted backup): emit the final attempt's phase spans, close the
        root, and derive the exact attribution decomposition."""
        st = self._state(b, i)
        job = commit.job
        win_backup = hedge_win or st.promoted
        if win_backup:
            # the backup's whole life runs from its dispatch instant; the
            # pre-dispatch window is time lost to the straggling primary
            entry = st.hedge_t if st.hedge_t is not None else st.attempt_t
            ship_t = entry
        else:
            entry = st.attempt_t
            ship_t = st.ship_t if st.ship_t is not None \
                and st.tier == commit.machine else commit.planned_at
        arrival, start, end = commit.arrival, commit.start, commit.end
        proc = job.proc[commit.machine]
        terms = {
            "retry_waste": entry - st.release,
            "wait": (ship_t - entry) + (start - arrival),
            "transmit": arrival - ship_t,
            "service": proc,
            "slowdown": (end - start) - proc,
        }
        tid = self._tid(b, i)
        sp = self._span(tid, st.root, "attempt", "attempt", entry, end,
                        ward=b, attempt=st.attempt,
                        machine=commit.machine, slot=commit.slot,
                        outcome="complete", hedge_win=win_backup)
        if ship_t > entry:
            self._span(tid, sp.span, "wait", "phase", entry, ship_t,
                       ward=b, phase="requeue")
        if arrival > ship_t:
            self._span(tid, sp.span, "transmit", "phase", ship_t,
                       arrival, ward=b, tier=commit.machine)
        if start > arrival:
            self._span(tid, sp.span, "wait", "phase", arrival, start,
                       ward=b, phase="queue")
        svc = self._span(tid, sp.span, "service", "phase", start, end,
                         ward=b, machine=commit.machine,
                         slot=commit.slot, proc=proc,
                         slowdown=terms["slowdown"])
        windows = self._slot_windows(b, commit)
        if windows and end > start:
            # split service at every fail-slow rate-change boundary so
            # the straggler window is visible inside the span, not just
            # as a summary number
            from repro_torch.metro.engine import _rate_profile
            segs = [(a, z, f)
                    for a, z, f in _rate_profile(windows, start, end)]
            if len(segs) > 1 or (segs and segs[0][2] != 1.0):
                for a, z, f in segs:
                    self._span(tid, svc.span, "service_seg", "phase",
                               a, z, ward=b, rate=f)
        root = self._open_roots.pop((b, i))
        root.t1 = now
        root.attrs.update(outcome="complete",
                          missed=bool(end - st.release > job.deadline))
        self._row(b, i, job, commit.machine, "complete",
                  end - st.release, terms, hedge_win=win_backup)

    # -------------------------------------------------------- finalizing
    def _slot_windows(self, b: int, commit):
        if commit.machine == ED or commit.slot < 0:
            return ()
        pool = self.eng.cloud if commit.machine == CC \
            else self.eng.edges[b]
        if not 0 <= commit.slot < len(pool.slots):  # pragma: no cover
            return ()
        return pool.slots[commit.slot].slowdowns

    def _finalize_dropped(self, kind: str, now: float, b: int,
                          i: int) -> None:
        """A shed or retry-exhausted giveup: the job never completed, so
        its 'response' is the drop instant — all of it waiting or lost
        to retries, none of it service."""
        st = self._state(b, i)
        job = self.eng.jobs[b][i]
        terms = {"retry_waste": st.attempt_t - st.release,
                 "wait": now - st.attempt_t,
                 "transmit": 0.0, "service": 0.0, "slowdown": 0.0}
        root = self._open_roots.pop((b, i))
        root.t1 = now
        root.attrs.update(outcome=kind, missed=True)
        self._row(b, i, job, "none", kind, now - st.release, terms,
                  hedge_win=False)

    def _row(self, b: int, i: int, job, tier: str, outcome: str,
             response: float, terms: dict, hedge_win: bool) -> None:
        eng = self.eng
        dominant = max(TERMS, key=lambda k: terms[k])
        self.rows.append({
            "ward": b, "index": i, "job": job.name,
            "wclass": job.workload or "unclassified",
            "weight": job.weight, "tier": tier, "outcome": outcome,
            "release": job.release, "deadline": job.deadline,
            "response": response,
            "missed": outcome != "complete" or response > job.deadline,
            "attempts": eng.kills[b][i] + 1,
            "hedged": eng.hedged[b][i], "hedge_win": hedge_win,
            "terms": terms, "dominant": dominant,
        })

    def finish(self) -> "MetroTrace":
        return MetroTrace(spans=self.spans, rows=self.rows)


@dataclass
class MetroTrace:
    """Frozen flight-recorder output carried on `MetroResult.trace`."""
    spans: List[Span]
    rows: List[dict]

    # ---------------------------------------------------------- analysis
    def attribution(self, missed_only: bool = True) -> List[dict]:
        """Per-job response-time decompositions (module docstring), in
        event order. ``missed_only`` keeps missed/shed/giveup jobs."""
        return [r for r in self.rows if r["missed"] or not missed_only]

    def blame_table(self) -> List[dict]:
        """Deadline-miss blame aggregated per (class, tier): counts, mean
        decomposition terms and the dominant term by total time — the
        postmortem table. Sorted by total missed time, heaviest first."""
        agg: Dict[Tuple[str, str], dict] = {}
        for r in self.attribution(missed_only=True):
            key = (r["wclass"], r["tier"])
            row = agg.get(key)
            if row is None:
                row = agg[key] = {
                    "wclass": key[0], "tier": key[1], "misses": 0,
                    "shed": 0, "response": 0.0,
                    "terms": {t: 0.0 for t in TERMS}}
            row["misses"] += 1
            row["shed"] += int(r["outcome"] != "complete")
            row["response"] += r["response"]
            for t in TERMS:
                row["terms"][t] += r["terms"][t]
        out = []
        for row in sorted(agg.values(), key=lambda x: -x["response"]):
            n = row["misses"]
            out.append({
                "wclass": row["wclass"], "tier": row["tier"],
                "misses": n, "shed": row["shed"],
                "mean_response": row["response"] / n,
                "mean_terms": {t: row["terms"][t] / n for t in TERMS},
                "total_terms": dict(row["terms"]),
                "dominant": max(TERMS, key=lambda t: row["terms"][t]),
            })
        return out

    def format_postmortem(self, policy: str = "?",
                          profile: Optional[dict] = None,
                          device_searches: Optional[int] = None) -> str:
        """Human-readable postmortem block (serve --metro --postmortem):
        the blame table plus the engine self-profile and the run's
        batched device-search count when available."""
        lines = [f"postmortem[{policy}]: {len(self.attribution())} "
                 f"missed/shed jobs of {len(self.rows)} finished"]
        table = self.blame_table()
        if table:
            lines.append(
                f"  {'class':28s} {'tier':6s} {'miss':>5s} {'shed':>5s} "
                f"{'resp':>7s} " +
                " ".join(f"{t:>11s}" for t in TERMS) + "  dominant")
            for row in table:
                lines.append(
                    f"  {row['wclass']:28s} {row['tier']:6s} "
                    f"{row['misses']:5d} {row['shed']:5d} "
                    f"{row['mean_response']:7.1f} " +
                    " ".join(f"{row['mean_terms'][t]:11.2f}"
                             for t in TERMS) +
                    f"  {row['dominant']}")
        else:
            lines.append("  no deadline misses — nothing to attribute")
        if profile:
            busy = {k: v for k, v in profile.items()
                    if isinstance(v, float) and k != "seconds_total"}
            lines.append(
                "  engine profile: " +
                " ".join(f"{k}={v*1e3:.1f}ms"
                         for k, v in sorted(busy.items(),
                                            key=lambda kv: -kv[1])) +
                f" (total {profile.get('seconds_total', 0.0)*1e3:.1f}ms, "
                f"{profile.get('events', 0)} events)")
        if device_searches is not None:
            lines.append(f"  device searches: {device_searches}")
        return "\n".join(lines)

    def postmortem_json(self, policy: str = "?",
                        profile: Optional[dict] = None,
                        device_searches: Optional[int] = None) -> dict:
        return {"policy": policy, "finished": len(self.rows),
                "missed": self.attribution(missed_only=True),
                "blame": self.blame_table(),
                "profile": profile or {},
                "device_searches": device_searches}

    # ---------------------------------------------------------- exporters
    def to_jsonl(self, path: str) -> int:
        """One span object per line; -> span count."""
        with open(path, "w") as f:
            for sp in self.spans:
                f.write(json.dumps(sp.to_dict()) + "\n")
        return len(self.spans)

    def to_chrome(self, path: str) -> int:
        """Chrome trace-event JSON (opens directly in Perfetto/
        chrome://tracing): wards as process rows, machine slots as
        thread rows (service occupancy + fleet outage/fail-slow
        windows), jobs as nestable async tracks. -> event count."""
        ev: List[dict] = []

        def meta(name, pid, tid=None, label=""):
            rec = {"ph": "M", "name": name, "pid": pid,
                   "args": {"name": label}}
            if tid is not None:
                rec["tid"] = tid
            ev.append(rec)

        meta("process_name", 0, label="cloud pool")
        wards = {sp.ward for sp in self.spans if sp.ward >= 0}
        for b in sorted(wards):
            meta("process_name", 1 + b, label=f"ward {b}")

        def pool_pid(tier, ward):
            return 0 if tier == CC else 1 + ward

        named_tids = set()

        def slot_tid(pid, slot, windows=False):
            tid = (1000 if windows else 0) + slot
            if (pid, tid) not in named_tids:
                named_tids.add((pid, tid))
                meta("thread_name", pid, tid,
                     f"slot {slot}" + (" windows" if windows else ""))
            return tid

        for sp in self.spans:
            if sp.cat == "fleet":
                tier = sp.attrs.get("tier")
                if sp.name in ("outage", "fail_slow"):
                    pid = pool_pid(tier, sp.ward)
                    ev.append({
                        "ph": "X", "pid": pid,
                        "tid": slot_tid(pid, sp.attrs["slot"],
                                        windows=True),
                        "name": sp.name, "cat": "fleet",
                        "ts": sp.t0 * _CHROME_US,
                        "dur": max(sp.duration, 0.0) * _CHROME_US,
                        "args": sp.attrs})
                else:
                    ev.append({"ph": "i", "pid": 0, "tid": 0, "s": "g",
                               "name": sp.name, "cat": "fleet",
                               "ts": sp.t0 * _CHROME_US,
                               "args": sp.attrs})
                continue
            # service occupancy rides the machine-slot thread rows; the
            # engine's I2 invariant guarantees they never overlap per slot
            if sp.name in ("service", "hedge_loser") and \
                    sp.attrs.get("machine") in (CC, ES) and \
                    sp.attrs.get("slot", -1) >= 0 and \
                    (sp.name != "hedge_loser" or sp.attrs["started"]):
                pid = pool_pid(sp.attrs["machine"], sp.ward)
                ev.append({
                    "ph": "X", "pid": pid,
                    "tid": slot_tid(pid, sp.attrs["slot"]),
                    "name": sp.trace, "cat": "occupancy",
                    "ts": sp.t0 * _CHROME_US,
                    "dur": max(sp.duration, 0.0) * _CHROME_US,
                    "args": sp.attrs})
            # every job span is an async b/e pair under its ward row —
            # async tracks nest by timestamp, so concurrent jobs never
            # collide the way same-tid X slices would
            pid = 1 + sp.ward if sp.ward >= 0 else 0
            base = {"pid": pid, "tid": 0, "id": sp.trace, "cat": sp.cat,
                    "name": f"{sp.trace}:{sp.name}"
                    if sp.name == "root" else sp.name}
            if sp.duration <= 0.0:
                ev.append({"ph": "n", "ts": sp.t0 * _CHROME_US,
                           "args": sp.attrs, **base})
            else:
                ev.append({"ph": "b", "ts": sp.t0 * _CHROME_US,
                           "args": sp.attrs, **base})
                ev.append({"ph": "e", "ts": sp.t1 * _CHROME_US, **base})
        with open(path, "w") as f:
            json.dump({"traceEvents": ev,
                       "displayTimeUnit": "ms",
                       "otherData": {"source": "repro.metro.tracing",
                                     "time_unit": "1 trace minute = 1s"}},
                      f)
        return len(ev)

    def write(self, path: str, fmt: str = "jsonl") -> int:
        if fmt == "chrome":
            return self.to_chrome(path)
        if fmt == "jsonl":
            return self.to_jsonl(path)
        raise ValueError(f"unknown trace format {fmt!r}; "
                         f"expected 'jsonl' or 'chrome'")


class EngineProfile:
    """Engine self-profiling accumulators (armed by
    ``MetroEngine.run(profile=True)``): wall-clock phase timers for the
    replay, policy calls, the sanitizer and the hedge hook, per-event-kind
    handler times, heap/bookkeeping residual, and the number of batched
    device searches (`scheduler_torch.tabu_search_batched.calls`) made
    during the run. Pure measurement — the
    profiler never influences event timing (simulated time lives in the
    heap), so profiled runs stay bit-identical."""

    __slots__ = ("replay", "policy", "sanitize", "hedge_hook",
                 "handlers", "heap_pushes", "decide_calls",
                 "searches_before")

    def __init__(self, searches_before: int = 0):
        self.replay = 0.0
        self.policy = 0.0
        self.sanitize = 0.0
        self.hedge_hook = 0.0
        self.handlers: Dict[str, float] = {}
        self.heap_pushes = 0
        self.decide_calls = 0
        self.searches_before = searches_before

    def add_handler(self, kind: str, dt: float) -> None:
        self.handlers[kind] = self.handlers.get(kind, 0.0) + dt

    def summary(self, seconds_total: float, events: int,
                searches_after: Optional[int] = None) -> dict:
        handled = sum(self.handlers.values())
        out = {
            "seconds_total": seconds_total,
            "events": events,
            "replay": self.replay,
            "policy": self.policy,
            "sanitize": self.sanitize,
            "hedge_hook": self.hedge_hook,
            "heap_and_dispatch": max(0.0, seconds_total - handled),
            "handlers_by_kind": dict(sorted(self.handlers.items())),
            "heap_pushes": self.heap_pushes,
            "decide_calls": self.decide_calls,
        }
        if searches_after is not None:
            out["device_searches"] = searches_after - self.searches_before
        return out
