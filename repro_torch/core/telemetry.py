"""Incremental serving telemetry: flat-memory sketches for open-ended runs.

The closed-workload paths accumulate raw per-call latency lists
(``Metrics.t_hp_initial`` et al.) and post-process them with
``np.percentile`` — fine for 1296 frames, unbounded for a firehose.  This
module provides the streaming engine's telemetry substrate (DESIGN.md §14):
every structure here is **fixed-size by construction**, so a soak run of
millions of requests holds the same few tens of kilobytes of telemetry at
request 10^7 as at request 10^3 (the RSS-flatness gate in
``benchmarks/soak.py`` leans on this).

* :class:`LogHistogram` — a log-bucketed quantile sketch (HDR-histogram
  style): geometric bucket edges with growth factor ``g`` over a fixed
  ``[lo, hi)`` range, counts in one preallocated int64 array.  Recording is
  O(log buckets) (one ``searchsorted``); quantile queries are one cumsum
  over the fixed array.  **Error bound**: a value is returned as its
  bucket's geometric midpoint, so every quantile estimate is within a
  multiplicative ``sqrt(g)`` of some true sample in that quantile's bucket
  — relative error ≤ ``sqrt(g) - 1`` (≈ 1% at the default g = 1.02),
  independent of how many values were recorded.  Min/max/sum/count are
  tracked exactly.
* :class:`RingSampler` — a fixed-capacity ring of ``(t, value)`` samples
  (queue depths, RSS readings): keeps the most recent ``capacity``.
* :class:`SloTracker` — per-task-type attained/missed SLO counters
  (bounded by the number of task types).
* :class:`BoundedSeries` — a list-compatible sink used to cap the
  ``Metrics`` latency lists on the streaming path: ``append`` feeds a
  sketch plus a bounded recent-window deque instead of growing a list.
* :class:`StreamTelemetry` — the composite the streaming engine records
  into, with a JSON-friendly ``snapshot()``.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Any, Iterable, Optional

import numpy as np


class LogHistogram:
    """Fixed-size log-bucketed quantile sketch over ``[lo, hi)``.

    Values below ``lo`` land in the underflow bucket (reported as ``lo``),
    values at or above ``hi`` in the overflow bucket (reported as ``hi``) —
    both still count toward quantile ranks, so saturation shows up as a
    pinned tail rather than a silent drop.
    """

    __slots__ = ("lo", "hi", "growth", "_edges", "_counts", "count",
                 "total", "vmin", "vmax")

    def __init__(self, lo: float = 1e-7, hi: float = 1e5,
                 growth: float = 1.02) -> None:
        if not (lo > 0.0 and hi > lo and growth > 1.0):
            raise ValueError("LogHistogram requires 0 < lo < hi, growth > 1")
        self.lo, self.hi, self.growth = lo, hi, growth
        n = int(math.ceil(math.log(hi / lo) / math.log(growth)))
        # interior bucket edges lo*g^1 .. lo*g^(n-1); bucket 0 = underflow
        # [0, lo), bucket n+1 = overflow [hi, inf)
        self._edges = lo * np.power(growth, np.arange(n + 1))
        self._counts = np.zeros(n + 2, dtype=np.int64)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    @property
    def nbytes(self) -> int:
        """Fixed allocation size (proven flat in tests/test_telemetry.py)."""
        return self._edges.nbytes + self._counts.nbytes

    def record(self, value: float) -> None:
        idx = int(np.searchsorted(self._edges, value, side="right"))
        self._counts[idx] += 1
        self.count += 1
        self.total += value
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value

    def record_many(self, values: Iterable[float]) -> None:
        arr = np.asarray(list(values) if not isinstance(values, np.ndarray)
                         else values, dtype=np.float64)
        if arr.size == 0:
            return
        idx = np.searchsorted(self._edges, arr, side="right")
        np.add.at(self._counts, idx, 1)
        self.count += int(arr.size)
        self.total += float(arr.sum())
        self.vmin = min(self.vmin, float(arr.min()))
        self.vmax = max(self.vmax, float(arr.max()))

    def quantile(self, q: float) -> float:
        """The bucket-midpoint estimate of the ``q``-quantile (0 <= q <= 1);
        0.0 for an empty sketch.  Exact min/max are used for the extreme
        buckets so q=0/q=1 report true extremes."""
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        cum = np.cumsum(self._counts)
        idx = int(np.searchsorted(cum, rank, side="right"))
        return self._bucket_value(idx)

    def quantiles(self, qs: Iterable[float]) -> list[float]:
        if self.count == 0:
            return [0.0 for _ in qs]
        cum = np.cumsum(self._counts)
        return [self._bucket_value(int(np.searchsorted(
            cum, q * (self.count - 1), side="right"))) for q in qs]

    def _bucket_value(self, idx: int) -> float:
        edges = self._edges
        if idx <= 0:                       # underflow [0, lo)
            return min(self.lo, max(self.vmin, 0.0))
        if idx >= len(edges):              # overflow [hi, inf)
            return max(self.hi, self.vmax)
        # geometric midpoint of [edges[idx-1], edges[idx]) — clamp into the
        # exactly-tracked extremes so tiny samples don't over-report
        mid = math.sqrt(edges[idx - 1] * edges[idx])
        return float(min(max(mid, self.vmin), self.vmax))

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def merge(self, other: "LogHistogram") -> None:
        """Fold another sketch with identical geometry into this one."""
        if (other.lo, other.hi, other.growth) != \
                (self.lo, self.hi, self.growth):
            raise ValueError("cannot merge LogHistograms with different "
                             "geometry (lo/hi/growth)")
        self._counts += other._counts
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    def snapshot(self) -> dict[str, float]:
        p50, p99, p999 = self.quantiles((0.50, 0.99, 0.999))
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": p50,
            "p99": p99,
            "p999": p999,
            "max": self.vmax if self.count else 0.0,
        }


class RingSampler:
    """Fixed-capacity ring buffer of ``(t, value)`` samples."""

    __slots__ = ("_t", "_v", "_n", "_i", "capacity", "total_samples")

    def __init__(self, capacity: int = 512) -> None:
        if capacity <= 0:
            raise ValueError("RingSampler capacity must be positive")
        self.capacity = capacity
        self._t = np.zeros(capacity, dtype=np.float64)
        self._v = np.zeros(capacity, dtype=np.float64)
        self._n = 0                   # live sample count (<= capacity)
        self._i = 0                   # next write slot
        self.total_samples = 0        # lifetime count (overwrites included)

    def sample(self, t: float, value: float) -> None:
        self._t[self._i] = t
        self._v[self._i] = value
        self._i = (self._i + 1) % self.capacity
        self._n = min(self._n + 1, self.capacity)
        self.total_samples += 1

    def values(self) -> np.ndarray:
        """Live samples' values, oldest first."""
        if self._n < self.capacity:
            return self._v[:self._n].copy()
        return np.concatenate((self._v[self._i:], self._v[:self._i]))

    def times(self) -> np.ndarray:
        if self._n < self.capacity:
            return self._t[:self._n].copy()
        return np.concatenate((self._t[self._i:], self._t[:self._i]))

    def __len__(self) -> int:
        return self._n

    def snapshot(self) -> dict[str, float]:
        v = self.values()
        if v.size == 0:
            return {"count": 0, "mean": 0.0, "max": 0.0, "last": 0.0}
        return {
            "count": self.total_samples,
            "mean": float(v.mean()),
            "max": float(v.max()),
            "last": float(v[-1]),
        }


class SloTracker:
    """Per-task-type SLO attainment: attained (completed before deadline)
    vs missed (failed at admission, shed, or overran).  Bounded by the
    number of task types in the workload."""

    __slots__ = ("_counts",)

    def __init__(self) -> None:
        self._counts: dict[str, list[int]] = {}   # type -> [attained, missed]

    def record(self, task_type: Optional[str], attained: bool) -> None:
        row = self._counts.setdefault(task_type or "default", [0, 0])
        row[0 if attained else 1] += 1

    def attainment(self, task_type: Optional[str] = None) -> float:
        row = self._counts.get(task_type or "default")
        if row is None or (row[0] + row[1]) == 0:
            return 0.0
        return row[0] / (row[0] + row[1])

    def snapshot(self) -> dict[str, dict[str, float]]:
        out = {}
        for t, (ok, miss) in sorted(self._counts.items()):
            total = ok + miss
            out[t] = {
                "attained": ok,
                "missed": miss,
                "attainment_pct": round(100.0 * ok / total, 2) if total
                else 0.0,
            }
        return out


class BoundedSeries:
    """A list-compatible latency sink with O(1) memory.

    The scheduler appends wall-clock samples to ``Metrics`` list fields
    (``t_hp_initial`` …); on the streaming path those lists are swapped for
    this: ``append`` feeds a :class:`LogHistogram` and a bounded
    recent-window deque.  ``len``/``bool`` reflect the lifetime count;
    iteration yields only the recent window (so ``statistics.mean`` over it
    is a windowed mean — the exact lifetime mean is ``.mean()``).
    """

    __slots__ = ("sketch", "recent")

    def __init__(self, sketch: Optional[LogHistogram] = None,
                 window: int = 256) -> None:
        self.sketch = sketch if sketch is not None else LogHistogram()
        self.recent: deque = deque(maxlen=window)

    def append(self, value: float) -> None:
        self.sketch.record(value)
        self.recent.append(value)

    def extend(self, values: Iterable[float]) -> None:
        for v in values:
            self.append(v)

    def mean(self) -> float:
        return self.sketch.mean

    def __len__(self) -> int:
        return self.sketch.count

    def __bool__(self) -> bool:
        return self.sketch.count > 0

    def __iter__(self):
        return iter(self.recent)


class StreamTelemetry:
    """The streaming engine's composite telemetry (DESIGN.md §14).

    * ``admission`` — wall-clock seconds per admission decision (HP
      per-request; LP batched, recorded as the batch's amortised share).
    * ``e2e`` — *virtual-time* end-to-end latency of completed requests
      (completion − arrival, includes queueing delay).
    * ``queue_depth`` — sampled once per admission window.
    * ``slo`` — per-task-type attainment over all terminal requests.
    * shed counters by reason (``queue_full`` / ``expired``) plus degrade
      and backpressure-signal counters.

    Everything is fixed-size; ``snapshot()`` is JSON-ready.
    """

    def __init__(self, *, depth_samples: int = 512) -> None:
        # admission latencies are wall-clock seconds: 100 ns .. 100 s
        self.admission = LogHistogram(lo=1e-7, hi=1e2)
        # e2e latencies are virtual seconds: 1 ms .. ~28 h
        self.e2e = LogHistogram(lo=1e-3, hi=1e5)
        self.queue_depth = RingSampler(depth_samples)
        self.slo = SloTracker()
        self.shed_queue_full = 0
        self.shed_expired = 0
        self.degraded = 0
        self.soft_signals = 0
        self.offered = 0
        self.admitted_hp = 0
        self.admitted_lp = 0
        self.windows = 0
        # Churn plane (DESIGN.md §16): recovery latency of re-placed
        # orphans — virtual seconds from the device-loss instant to the
        # replacement slot's start (how long the orphaned work stalls).
        # Fixed-size like every other sketch; empty without churn.
        self.recovery_delay = LogHistogram(lo=1e-4, hi=1e5)
        self.devices_failed = 0
        self.devices_drained = 0
        self.devices_rejoined = 0
        self.orphans_seen = 0
        self.orphans_recovered = 0

    @property
    def shed_total(self) -> int:
        return self.shed_queue_full + self.shed_expired

    def snapshot(self) -> dict[str, Any]:
        out = {
            "offered": self.offered,
            "admitted_hp": self.admitted_hp,
            "admitted_lp": self.admitted_lp,
            "windows": self.windows,
            "shed_total": self.shed_total,
            "shed_queue_full": self.shed_queue_full,
            "shed_expired": self.shed_expired,
            "degraded": self.degraded,
            "soft_signals": self.soft_signals,
            "admission_latency_s": self.admission.snapshot(),
            "e2e_latency_s": self.e2e.snapshot(),
            "queue_depth": self.queue_depth.snapshot(),
            "slo": self.slo.snapshot(),
        }
        if self.devices_failed or self.devices_drained or self.devices_rejoined:
            # Present only under churn: churn-free snapshots keep their
            # historic key set (byte-compared by the zero-churn
            # differential in tests/test_accounting_invariants.py).
            out["churn"] = {
                "devices_failed": self.devices_failed,
                "devices_drained": self.devices_drained,
                "devices_rejoined": self.devices_rejoined,
                "orphans_seen": self.orphans_seen,
                "orphans_recovered": self.orphans_recovered,
                "recovery_delay_s": self.recovery_delay.snapshot(),
            }
        return out
