"""Streaming SLA metrics for metro traffic runs (DESIGN.md §10).

Everything here is O(1) memory in the number of completions: response
times land in fixed log-spaced histograms (quantiles are read back by
bucket interpolation, so a p99 is accurate to one bucket width — ~5%
relative with the default 256 buckets over [0.01, 1e5]), per-class
deadline misses / sheds / crash retries are counters, and "recent"
statistics come from a ring of per-window histograms that folds closed
windows into the totals. A SHED job counts as an explicit deadline
miss (it never ran) and a crash kill accumulates the wasted
machine-seconds of the lost partial run (DESIGN.md §11).
Long runs therefore hold `bins + windows * bins` integers regardless of
how many episodes stream through.

All state is plain ints/floats updated in event order, so two runs of
the same seeded engine produce bit-identical summaries (the metro
determinism invariant, tests/test_metro.py).
"""
from __future__ import annotations

import math
from collections import deque
from typing import Deque, Dict, List

_UNCLASSED = "unclassified"


class StreamingQuantiles:
    """Fixed log-bucket histogram with quantile read-back.

    add() is O(1); quantile(q) interpolates inside the bucket holding the
    q-th observation. Values below `lo` land in bucket 0, values above
    `hi` in the overflow bucket (whose upper edge is the running max, so
    a pathological tail still reports a finite p99). The clamping is NOT
    silent: `underflow`/`overflow` count every observation outside
    [lo, hi], so a fail-slow-stretched tail that escapes the range is
    visible in summary() rather than faking an in-range quantile."""

    def __init__(self, lo: float = 1e-2, hi: float = 1e5, bins: int = 256):
        if not (lo > 0 and hi > lo and bins > 1):
            raise ValueError(f"bad histogram shape lo={lo} hi={hi} "
                             f"bins={bins}")
        self.lo, self.hi, self.bins = lo, hi, bins
        self._scale = bins / math.log(hi / lo)
        self.counts = [0] * (bins + 1)          # +1: overflow bucket
        self.n = 0
        self.max = 0.0
        self.sum = 0.0
        self.underflow = 0             # observations strictly below lo
        self.overflow = 0              # observations strictly above hi

    def _bucket(self, x: float) -> int:
        if x <= self.lo:
            return 0
        if x >= self.hi:
            return self.bins
        return min(self.bins - 1,
                   int(math.log(x / self.lo) * self._scale))

    def _edges(self, b: int) -> tuple:
        if b >= self.bins:
            return self.hi, max(self.max, self.hi)
        return (self.lo * math.exp(b / self._scale),
                self.lo * math.exp((b + 1) / self._scale))

    def add(self, x: float) -> None:
        self.counts[self._bucket(x)] += 1
        self.n += 1
        self.sum += x
        if x > self.max:
            self.max = x
        if x < self.lo:
            self.underflow += 1
        elif x > self.hi:
            self.overflow += 1

    def merge(self, other: "StreamingQuantiles") -> None:
        if (other.lo, other.hi, other.bins) != (self.lo, self.hi, self.bins):
            raise ValueError("histogram shapes differ")
        self.counts = [a + b for a, b in zip(self.counts, other.counts)]
        self.n += other.n
        self.sum += other.sum
        self.max = max(self.max, other.max)
        self.underflow += other.underflow
        self.overflow += other.overflow

    def quantile(self, q: float) -> float:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.n == 0:
            return 0.0
        rank = q * (self.n - 1)
        seen = 0
        for b, c in enumerate(self.counts):
            if c and seen + c > rank:
                left, right = self._edges(b)
                frac = (rank - seen + 0.5) / c
                return left + (right - left) * frac
            seen += c
        return self.max                                  # pragma: no cover

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0


class _Window:
    """One closed (or the open) time window's counters."""

    def __init__(self, start: float, hist_shape):
        self.start = start
        self.hist = StreamingQuantiles(*hist_shape)
        self.completions = 0
        self.misses = 0
        self.sheds = 0


class MetroMetrics:
    """Windowed streaming metrics sink the metro engine feeds.

    record() takes one completion; busy time per tier accumulates for the
    utilisation report (the engine supplies the capacity integrals, since
    only it knows the failure/scale timeline). `window` is the roll width
    in trace time units; `keep_windows` bounds the recent-statistics ring.
    """

    def __init__(self, window: float = 60.0, keep_windows: int = 8,
                 hist_lo: float = 1e-2, hist_hi: float = 1e5,
                 hist_bins: int = 256):
        if window <= 0:
            raise ValueError(f"window must be > 0, got {window}")
        self._shape = (hist_lo, hist_hi, hist_bins)
        self.window = window
        self.total = StreamingQuantiles(*self._shape)
        self.completions = 0
        self.misses = 0
        self.shed = 0                  # jobs dropped by SHED decisions
        self.retries = 0               # crash kills (lost in-flight jobs)
        self.wasted_seconds = 0.0      # machine-seconds lost to kills
        self.max_attempts = 1          # worst dispatch count of any job
        self.retry_exhausted = 0       # sheds from the max_attempts cap
        self.retries_by_tier: Dict[str, int] = {}
        self.wasted_by_tier: Dict[str, float] = {}
        self.hedges = 0                # backup attempts dispatched
        self.hedge_wins = 0            # completions where the backup won
        self.hedge_waste = 0.0         # machine-seconds of cancelled work
        self.hedge_waste_by_tier: Dict[str, float] = {}
        self.hedge_by_tier: Dict[str, int] = {}   # backup target tiers
        # per-class response histograms for the p99/p99.9 tail report
        self.class_hist: Dict[str, StreamingQuantiles] = {}
        self.weighted_finished = 0.0   # sum of weight over completed + shed
        self.weighted_missed = 0.0     # ... over missed + shed
        # class -> [completed, missed, shed]
        self.by_class: Dict[str, List[int]] = {}
        self.class_weight: Dict[str, float] = {}     # class -> job weight
        self.busy_time: Dict[str, float] = {}        # tier -> sum of proc
        self.recent: Deque[_Window] = deque(maxlen=max(1, keep_windows))
        self._open: _Window | None = None
        self.last_time = 0.0

    # ------------------------------------------------------------- feeding
    def _roll(self, now: float) -> None:
        start = math.floor(now / self.window) * self.window
        if self._open is None:
            self._open = _Window(start, self._shape)
        elif start > self._open.start:
            self.recent.append(self._open)
            self._open = _Window(start, self._shape)

    def record(self, now: float, wclass: str, response: float,
               deadline: float, tier: str, proc: float, *,
               attempts: int = 1, weight: float = 1.0,
               hedged: bool = False, hedge_win: bool = False) -> None:
        """One job completion at sim time `now`. `attempts` counts
        dispatches (1 = never crash-killed); `weight` feeds the
        weighted miss-rate alongside the per-class counters. `hedged`
        marks a job that ever dispatched a backup attempt; `hedge_win`
        marks the backup finishing first."""
        self._roll(now)
        missed = response > deadline
        self.total.add(response)
        self.completions += 1
        if hedge_win:
            self.hedge_wins += 1
        self.busy_time[tier] = self.busy_time.get(tier, 0.0) + proc
        if attempts > self.max_attempts:
            self.max_attempts = attempts
        self.weighted_finished += weight
        cls = wclass or _UNCLASSED
        self.class_weight[cls] = max(self.class_weight.get(cls, weight),
                                     weight)
        hist = self.class_hist.get(cls)
        if hist is None:
            hist = self.class_hist[cls] = StreamingQuantiles(*self._shape)
        hist.add(response)
        row = self.by_class.setdefault(cls, [0, 0, 0])
        row[0] += 1
        if missed:
            row[1] += 1
            self.misses += 1
            self.weighted_missed += weight
        w = self._open
        w.hist.add(response)
        w.completions += 1
        w.misses += int(missed)
        if now > self.last_time:
            self.last_time = now

    def record_shed(self, now: float, wclass: str, weight: float = 1.0,
                    exhausted: bool = False) -> None:
        """One job dropped — by a SHED decision, or (`exhausted=True`)
        because its crash-retry budget ran out (the max_attempts cap):
        an explicit deadline miss (no response sample)."""
        self._roll(now)
        self.shed += 1
        if exhausted:
            self.retry_exhausted += 1
        self.weighted_finished += weight
        self.weighted_missed += weight
        cls = wclass or _UNCLASSED
        self.class_weight[cls] = max(self.class_weight.get(cls, weight),
                                     weight)
        row = self.by_class.setdefault(cls, [0, 0, 0])
        row[2] += 1
        self._open.misses += 1
        self._open.sheds += 1
        if now > self.last_time:
            self.last_time = now

    def record_kill(self, tier: str, wasted: float) -> None:
        """A crash failure killed an in-flight job: `wasted` machine-
        seconds of partial work on `tier` are lost and the job retries."""
        self.retries += 1
        self.wasted_seconds += wasted
        self.retries_by_tier[tier] = self.retries_by_tier.get(tier, 0) + 1
        self.wasted_by_tier[tier] = \
            self.wasted_by_tier.get(tier, 0.0) + wasted

    def record_hedge(self, tier: str) -> None:
        """A backup attempt was dispatched onto `tier`."""
        self.hedges += 1
        self.hedge_by_tier[tier] = self.hedge_by_tier.get(tier, 0) + 1

    def record_hedge_cancel(self, tier: str, wasted: float) -> None:
        """The losing attempt of a hedge race was cancelled on `tier`
        after consuming `wasted` machine-seconds (0 if never started)."""
        self.hedge_waste += wasted
        self.hedge_waste_by_tier[tier] = \
            self.hedge_waste_by_tier.get(tier, 0.0) + wasted

    def flush(self) -> None:
        """Close the in-progress window into the ring. The engine calls
        this once at exit: without it a run shorter than one roll width
        never lands a window in `recent`, so the windowed snapshot of a
        short run reads all-zeros even though jobs finished. Idempotent
        (the window moves, nothing is double-counted), and a later
        record() simply opens a fresh window."""
        if self._open is not None:
            self.recent.append(self._open)
            self._open = None

    # ------------------------------------------------------------ reading
    @property
    def finished(self) -> int:
        """Jobs accounted for: completed + explicitly shed."""
        return self.completions + self.shed

    @property
    def miss_rate(self) -> float:
        """Deadline misses over all finished jobs; a shed job IS a miss."""
        return (self.misses + self.shed) / self.finished \
            if self.finished else 0.0

    @property
    def shed_rate(self) -> float:
        return self.shed / self.finished if self.finished else 0.0

    @property
    def hedge_rate(self) -> float:
        """Backup attempts dispatched per finished job."""
        return self.hedges / self.finished if self.finished else 0.0

    @property
    def weighted_miss_rate(self) -> float:
        return self.weighted_missed / self.weighted_finished \
            if self.weighted_finished else 0.0

    @property
    def critical_miss_rate(self) -> float:
        """Miss rate over the HEAVIEST weight class(es) only — the
        life-critical SLA the shedding policy protects by sacrificing
        lighter classes (DESIGN.md §11)."""
        if not self.by_class:
            return 0.0
        w_max = max(self.class_weight.values())
        done = miss = 0
        for c, (d, m, s) in self.by_class.items():
            if self.class_weight[c] >= w_max:
                done += d + s
                miss += m + s
        return miss / done if done else 0.0

    def miss_rate_by_class(self) -> Dict[str, float]:
        return {c: ((m + s) / (d + s) if d + s else 0.0)
                for c, (d, m, s) in sorted(self.by_class.items())}

    def recent_quantile(self, q: float) -> float:
        """Quantile over the last `keep_windows` closed windows plus the
        open one — the live-dashboard view of the tail."""
        merged = StreamingQuantiles(*self._shape)
        for w in self.recent:
            merged.merge(w.hist)
        if self._open is not None:
            merged.merge(self._open.hist)
        return merged.quantile(q)

    def _recent_counts(self) -> tuple:
        """(finished, misses, windows) over the ring + open window; a
        shed job finished (and missed) in its window, like miss_rate."""
        windows = list(self.recent)
        if self._open is not None:
            windows.append(self._open)
        done = sum(w.completions + w.sheds for w in windows)
        miss = sum(w.misses for w in windows)
        return done, miss, len(windows)

    def summary(self, utilization: Dict[str, float] | None = None) -> dict:
        """Flat report dict (serve's policy table / the metro benchmark)."""
        r_done, r_miss, r_windows = self._recent_counts()
        return {
            "recent_windows": r_windows,
            "recent_finished": r_done,
            "recent_misses": r_miss,
            "recent_miss_rate": r_miss / r_done if r_done else 0.0,
            "recent_p99": self.recent_quantile(0.99),
            "completions": self.completions,
            "shed": self.shed,
            "shed_rate": self.shed_rate,
            "retries": self.retries,
            "retry_exhausted": self.retry_exhausted,
            "retries_by_tier": dict(sorted(self.retries_by_tier.items())),
            "wasted_machine_seconds": self.wasted_seconds,
            "wasted_by_tier": dict(sorted(self.wasted_by_tier.items())),
            "max_attempts": self.max_attempts,
            "hedges": self.hedges,
            "hedge_rate": self.hedge_rate,
            "hedge_wins": self.hedge_wins,
            "hedge_waste": self.hedge_waste,
            "hedge_by_tier": dict(sorted(self.hedge_by_tier.items())),
            "hedge_waste_by_tier":
                dict(sorted(self.hedge_waste_by_tier.items())),
            "p50": self.total.quantile(0.50),
            "p95": self.total.quantile(0.95),
            "p99": self.total.quantile(0.99),
            "p999": self.total.quantile(0.999),
            "p99_by_class": {c: h.quantile(0.99)
                             for c, h in sorted(self.class_hist.items())},
            "p999_by_class": {c: h.quantile(0.999)
                              for c, h in sorted(self.class_hist.items())},
            "tail_underflow": self.total.underflow,
            "tail_overflow": self.total.overflow,
            "mean_response": self.total.mean,
            "max_response": self.total.max,
            "miss_rate": self.miss_rate,
            "weighted_miss_rate": self.weighted_miss_rate,
            "critical_miss_rate": self.critical_miss_rate,
            "miss_by_class": self.miss_rate_by_class(),
            "busy_time": dict(sorted(self.busy_time.items())),
            "utilization": dict(sorted((utilization or {}).items())),
        }
