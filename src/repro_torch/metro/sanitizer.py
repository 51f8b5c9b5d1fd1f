"""Metro-engine sanitizer (DESIGN.md §14): runtime validation of the
invariants the DES promises but never asserts.

The engine's correctness story rests on properties that are argued in
docstrings and exercised indirectly by parity tests, yet nothing checks
them while a run is in flight. `MetroSanitizer` is a READ-ONLY observer
the engine consults when run with ``MetroEngine.run(sanitize=True)``:

  I1  C5 FIFO-by-arrival per pool — replaying a pool's unstarted
      commitments in (arrival, plan time, ward, index) order must yield
      non-decreasing start times, each at or after its (now-clamped)
      arrival.
  I2  No slot double-booking — per machine slot, the [start, end)
      service intervals of all attempts (primaries and hedge backups,
      finished history included) never overlap; no attempt starts
      before its slot existed, and no unstarted attempt is scheduled
      while its slot is down.
  I3  Started jobs immutable (C2) — once an attempt's start passes
      `now`, its (machine, slot, start) never changes again for that
      attempt while the job is live; only its END may stretch
      (fail-slow re-timing, §13). Attempts are keyed by the crash-kill
      count so a legitimate re-dispatch after a kill is a NEW attempt,
      not a mutation, and terminal jobs are exempt (a hedge win
      replaces the primary commitment with the winning backup so the
      final schedule reports the serving machine).
  I4  Event-time monotonicity — heap pops never go backwards in time,
      and every event-log record carries the pop instant.
  I5  At most one hedge per job, ever — even across crash promotions.
  I6  Every job completed-or-shed exactly once at exit (terminal
      events: complete / shed / giveup), independently recounted from
      the sanitizer's own terminal bookkeeping, not the engine's
      `finished` flags.
  I7  Capacity sanity — each pool's `capacity_integral` is bounded by
      its raw slot-seconds (outage/slowdown discounts only ever shave
      capacity), and the service the metrics charged per shared tier
      never exceeds the capacity that existed to deliver it.

Violations raise `SanitizerViolation` (a ValueError — survives
``python -O``, R001-clean) naming the invariant.

Cost model: I3–I5 are O(1) dict bookkeeping per observation; I1/I2
piggyback on `_replay_pool`, whose own sort already costs
O(E log E) in the pool's entries, so sanitizing adds a constant factor
— measured < 1.2x wall-clock on the chaos packs (DESIGN.md §14), well
inside the < 2x budget. The sanitizer never pushes events, never
mutates engine state and never touches the event log, so sanitized
runs produce bit-identical event-log CRCs to unsanitized ones.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.tiers import CC, ES

_INF = float("inf")
_EPS = 1e-9


class SanitizerViolation(ValueError):
    """An engine invariant (I1–I7, module docstring) was broken."""


class MetroSanitizer:
    """Read-only invariant checker attached by `MetroEngine.run` when
    ``sanitize=True``. One instance observes one run."""

    def __init__(self, engine):
        self.eng = engine
        self._last_t = -_INF
        # I3: (ward, index, is_hedge, attempt#) -> (machine, slot, start)
        self._started: Dict[Tuple[int, int, bool, int],
                            Tuple[str, int, float]] = {}
        # I6: (ward, index) -> terminal kind
        self._terminal: Dict[Tuple[int, int], str] = {}
        # I5: (ward, index) -> hedge dispatch count
        self._hedges: Dict[Tuple[int, int], int] = {}
        self.checks = 0          # observation count (tests/overhead)

    # ------------------------------------------------------------ helpers
    def _fail(self, inv: str, msg: str) -> None:
        raise SanitizerViolation(f"sanitizer[{inv}]: {msg}")

    def _pool_label(self, pool) -> str:
        if pool.tier == CC:
            return "cloud"
        try:
            return f"edge[{self.eng.edges.index(pool)}]"
        except ValueError:                       # pragma: no cover
            return pool.tier

    # ------------------------------------------------------------- events
    def on_event(self, t: float, payload: tuple) -> None:
        """I4: the event heap pops in non-decreasing time order."""
        self.checks += 1
        if t < self._last_t - _EPS:
            self._fail("I4-monotonic",
                       f"event {payload[0]!r} popped at t={t} after "
                       f"t={self._last_t}")
        self._last_t = max(self._last_t, t)

    def on_hedge(self, b: int, i: int) -> None:
        """I5: one hedge dispatch per job, ever."""
        self.checks += 1
        n = self._hedges.get((b, i), 0) + 1
        self._hedges[(b, i)] = n
        if n > 1:
            self._fail("I5-single-hedge",
                       f"job ({b}, {i}) hedged {n} times")

    def on_terminal(self, b: int, i: int, kind: str) -> None:
        """I6 bookkeeping: complete / shed / giveup, exactly once."""
        self.checks += 1
        prev = self._terminal.get((b, i))
        if prev is not None:
            self._fail("I6-terminal",
                       f"job ({b}, {i}) reached terminal {kind!r} after "
                       f"already terminating as {prev!r}")
        self._terminal[(b, i)] = kind

    # -------------------------------------------------------- pool checks
    def check_pool(self, pool, now: float) -> None:
        """I1 (FIFO), I2 (no double-booking), I3 (C2) for one pool —
        called by the engine at the end of every `_replay_pool`."""
        self.checks += 1
        eng = self.eng
        label = self._pool_label(pool)
        n_slots = len(pool.slots)
        per_slot: Dict[int, List[Tuple[float, float, Tuple]]] = {}
        queue: List[Tuple[Tuple, float, float]] = []
        for b, i, c, is_hedge in eng._pool_entries(pool):
            who = (b, i, "hedge" if is_hedge else "primary")
            if not c.start <= c.end:
                self._fail("I2-interval",
                           f"{label} {who}: start {c.start} > end "
                           f"{c.end}")
            if c.start == _INF:
                self._fail("I2-unplaced",
                           f"{label} {who}: commitment still has "
                           f"placeholder times after replay")
            if not 0 <= c.slot < n_slots:
                self._fail("I2-slot",
                           f"{label} {who}: slot {c.slot} outside "
                           f"[0, {n_slots})")
            slot = pool.slots[c.slot]
            if c.start < slot.created - _EPS:
                self._fail("I2-created",
                           f"{label} {who}: starts at {c.start} before "
                           f"slot {c.slot} existed ({slot.created})")
            per_slot.setdefault(c.slot, []).append((c.start, c.end, who))
            if c.start > now:
                # unstarted: replay may not dispatch into a down window
                if c.start < slot.down - _EPS:
                    self._fail("I2-down",
                               f"{label} {who}: start {c.start} inside "
                               f"slot {c.slot} down-until {slot.down}")
                queue.append(((max(now, c.arrival), c.planned_at, b, i,
                               is_hedge), c.start, c.arrival))
            elif not eng.finished[b][i]:
                # I3: snapshot/verify (machine, slot, start) per attempt.
                # Terminal jobs are exempt: a hedge WIN replaces the
                # primary commitment with the winning backup so the
                # final schedule reports the machine that actually
                # served the job (§13) — reporting, not occupancy.
                key = (b, i, is_hedge, eng.kills[b][i])
                val = (c.machine, c.slot, c.start)
                seen = self._started.get(key)
                if seen is None:
                    self._started[key] = val
                elif seen != val:
                    self._fail("I3-immutable",
                               f"{label} {who}: started attempt mutated "
                               f"from {seen} to {val} (C2)")
        # I2: per-slot intervals must not overlap
        for k, spans in per_slot.items():
            spans.sort()
            for (s0, e0, w0), (s1, e1, w1) in zip(spans, spans[1:]):
                if s1 < e0 - _EPS:
                    self._fail("I2-overlap",
                               f"{label} slot {k}: {w0} [{s0}, {e0}) "
                               f"overlaps {w1} [{s1}, {e1}) "
                               f"(double-booking)")
        # I1: FIFO-by-arrival — dispatch order must yield monotone starts
        queue.sort()
        prev_start, prev_key = -_INF, None
        for key, start, arrival in queue:
            if start < max(now, arrival) - _EPS:
                self._fail("I1-fifo",
                           f"{label} job {key[2:4]}: start {start} "
                           f"before its replay arrival "
                           f"{max(now, arrival)}")
            if start < prev_start - _EPS:
                self._fail("I1-fifo",
                           f"{label}: FIFO inversion — job {key[2:4]} "
                           f"(arrival {key[0]}) starts at {start}, "
                           f"before job {prev_key[2:4]} (earlier "
                           f"arrival {prev_key[0]}) at {prev_start}")
            prev_start, prev_key = start, key
        # the reserved view the replay just refreshed stays sorted
        if list(pool.reserved) != sorted(pool.reserved) or \
                len(pool.reserved) != n_slots:
            self._fail("I1-reserved",
                       f"{label}: reserved view inconsistent "
                       f"({len(pool.reserved)} entries for {n_slots} "
                       f"slots)")

    # --------------------------------------------------------------- exit
    def at_exit(self, t_end: float) -> None:
        """I6 (every job terminal exactly once) and I7 (capacity
        bounds), checked once after the heap drains."""
        eng = self.eng
        for b, trace in enumerate(eng.jobs):
            for i in range(len(trace)):
                if (b, i) not in self._terminal:
                    self._fail("I6-terminal",
                               f"job ({b}, {i}) never completed, shed "
                               f"or gave up")
        pools = [eng.cloud] + list(eng.edges)
        for pool in pools:
            cap = pool.capacity_integral(t_end)
            raw = sum(
                max(0.0, min(s.retired_at if s.retired_at is not None
                             else t_end, t_end) - s.created)
                for s in pool.slots)
            if not -_EPS <= cap <= raw + _EPS:
                self._fail("I7-capacity",
                           f"{self._pool_label(pool)}: capacity_integral "
                           f"{cap} outside [0, slot-seconds {raw}]")
        busy = eng.metrics.busy_time
        for tier, label, cap in (
                (CC, "cloud", eng.cloud.capacity_integral(t_end)),
                (ES, "edge", sum(p.capacity_integral(t_end)
                                 for p in eng.edges))):
            used = busy.get(tier, 0.0)
            if used > cap + _EPS * max(1.0, cap):
                self._fail("I7-capacity",
                           f"{label}: {used} machine-seconds of service "
                           f"charged against {cap} available")
