"""Time-slotted resource calendars for the shared link and device cores.

The controller allocates variable-length time-slots on every resource such
that no two tasks hold the same resource simultaneously (paper §3, "network
state").  The link is a unit-capacity resource; each edge device is a
capacity-C resource (C = 4 cores on the RPi2B).

Array-backed skyline rewrite (DESIGN.md §11)
--------------------------------------------
The seed implementation (kept as :mod:`repro.core.calendar_reference`)
answered every probe with an O(n) sweep over a flat reservation list.  PR 1
replaced it with coalesced piecewise-constant *skylines* stored in Python
lists, which made probes O(log n + window) but left two scaling sinks:

* every reservation still paid O(n) ``list.insert``/``del`` surgery on the
  breakpoint lists, and
* the LP algorithm still probed devices one at a time in Python — a full
  feasibility scan at 256+ devices was hundreds of interpreted method calls.

This module stores each skyline in **preallocated NumPy arrays** with
capacity doubling (``times``/``vals``, valid prefix length ``n``) and a
**buffered mutation log**: ``add`` appends a delta in O(1) and the next
query applies the whole buffer at once — a handful of deltas are spliced
in place (an O(n) C-level ``memmove`` instead of Python list surgery), a
large buffer (e.g. a pre-load burst) is merged in ONE vectorized rebuild
(``np.unique`` + ``np.add.at`` + ``cumsum``).  Queries are
``np.searchsorted`` point location plus C-level slice reductions, with a
per-segment prefix-sum array making ``integral`` O(1) after location.

On top of the per-device skylines sits :class:`_ProbePlane` — the
network-wide probe plane.  It mirrors every device's skyline into padded
2-D arrays (rows refreshed lazily via per-device dirty marks) so ONE
vectorized pass answers, for ALL devices at once:

* ``fits_mask(t1, t2, cores)``   — who can host this window,
* ``free_cores(t1, t2)``         — stacked free-core vector,
* ``loads(t1, t2)``              — stacked window loads (even spreading),
* ``earliest_fit(dur, t, c)``    — stacked first-fit starts (skip hints).

The scheduler consumes these vectors instead of looping devices in Python;
`argsort`/`argmin` replaces per-device comparisons.

Exactness contract (tests/test_calendar_equivalence.py,
tests/test_skyline_fuzz.py, tests/test_scenario_replay.py):

* all query answers are bit-identical to walking the coalesced skyline
  (returned instants are *existing breakpoints* or the query's own bounds,
  never derived arithmetic), so scheduling decisions replay byte-identical
  through the golden scenarios;
* ``times[:n]`` is strictly increasing with ``times[0] == -inf``; no two
  adjacent ``vals`` are equal (coalesced); the final segment always decays
  to 0 because every reservation is finite;
* after ``gc(now)``, answers are only defined for query windows with
  ``t >= now`` — this is also what makes :meth:`NetworkState.gc`'s lazy
  per-device skip exact: a device with no reservation ending at or before
  ``now`` is left untouched (its un-collapsed history is invisible to any
  legal query);
* EPS semantics match the reference: sub-EPS overlaps are ignored by
  queries, and ``earliest_slot`` accepts a gap of ``duration - EPS``.
"""
from __future__ import annotations

import enum
import heapq
import itertools
import math
from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, Optional

import numpy as np

from .task import Priority, Task

EPS = 1e-9
_INF = math.inf
_EMPTY_F = np.empty(0, dtype=np.float64)


class DeviceLifecycle(enum.Enum):
    """Churn lifecycle of one edge device (DESIGN.md §16).

    UP devices accept new placements.  DRAINING devices finish their
    in-flight reservations but take no new work.  DOWN devices are gone:
    the transition cleared their calendar and every in-flight reservation
    became an *orphan* (returned by :meth:`NetworkState.fail_device` for
    the recovery pass).  The integer values are the checkpoint encoding
    (checkpoint/lifecycle.py) — never reorder them.
    """

    UP = 0
    DRAINING = 1
    DOWN = 2


@dataclass
class Reservation:
    t1: float
    t2: float
    amount: int                    # cores (devices) or 1 (link)
    tag: object = None             # task id / message descriptor

    def overlaps(self, t1: float, t2: float) -> bool:
        return self.t1 < t2 - EPS and t1 < self.t2 - EPS


class _StepFn:
    """Coalesced piecewise-constant usage-over-time (the skyline).

    The live segments occupy ``times[lo:lo+n]`` / ``vals[lo:lo+n]`` of
    preallocated buffers — a *gap* layout with slack on BOTH sides.
    ``vals[lo+i]`` is the usage on ``[times[lo+i], times[lo+i+1])``; the
    last segment extends to +inf and ``times[lo]`` is always the −inf
    sentinel.  ``floor`` is the horizon set by :meth:`gc`: updates and
    queries are clamped to it, so collapsed history can never corrupt live
    segments.

    Why a gap layout: skyline mutations cluster near the *front* of the
    live window (new reservations start near controller time; gc trims
    exactly there).  An insert shifts whichever side is shorter — near the
    front that is a handful of elements instead of the whole tail — and
    :meth:`gc` collapses history by just advancing ``lo`` (O(1)).

    Mutations (``add``) buffer into ``_log`` and are applied by the next
    query: a small buffer is spliced segment-by-segment (C memmove of the
    short side), a big one (e.g. a pre-load burst) is merged in a single
    vectorized rebuild (``np.unique`` + ``np.add.at`` + ``cumsum``).
    """

    __slots__ = ("times", "vals", "lo", "n", "floor", "_log", "_aux_ok",
                 "_prefix")

    def __init__(self) -> None:
        self.times = np.full(16, _INF)
        self.vals = np.zeros(16, dtype=np.int64)
        self.lo = 4
        self.times[4] = -_INF
        self.n = 1
        self.floor = -_INF
        self._log: list[tuple[float, float, int]] = []
        self._aux_ok = False
        self._prefix = _EMPTY_F

    def _view(self) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = self.lo, self.lo + self.n
        return self.times[lo:hi], self.vals[lo:hi]

    # -- updates --------------------------------------------------------- #
    def add(self, t1: float, t2: float, amount: int) -> None:
        """Add ``amount`` to the usage over [t1, t2) (negative to remove).
        O(1): buffered; applied by the next query/gc.

        A delta that exactly inverts one still buffered annihilates it
        instead — reserve-then-cancel churn (preemption victims, probe
        rollbacks) then never touches the arrays at all."""
        if t1 < self.floor:
            t1 = self.floor
        if t2 <= t1:
            return
        log = self._log
        if log:
            inv = (t1, t2, -amount)
            for k in range(len(log) - 1, max(len(log) - 9, -1), -1):
                if log[k] == inv:
                    del log[k]
                    return
        log.append((t1, t2, amount))

    def _flush(self) -> None:
        log = self._log
        if not log:
            return
        self._log = []
        self._aux_ok = False
        # Splice small buffers in place; a buffer big relative to the live
        # segment count (e.g. a pre-load burst) amortises better through the
        # single vectorized rebuild, whose cost is O((n + k) log(n + k)).
        if len(log) <= max(8, self.n // 16):
            for t1, t2, amount in log:
                self._apply_one(t1, t2, amount)
        else:
            self._rebuild(log)

    def _regap(self) -> None:
        """Re-centre the live window (and grow the buffers when cramped)."""
        n = self.n
        cap = self.times.shape[0]
        while cap < 2 * (n + 8):
            cap *= 2
        t = np.full(cap, _INF)
        v = np.zeros(cap, dtype=np.int64)
        lo = (cap - n) // 2
        t[lo : lo + n] = self.times[self.lo : self.lo + n]
        v[lo : lo + n] = self.vals[self.lo : self.lo + n]
        self.times, self.vals, self.lo = t, v, lo

    def _cut(self, t: float) -> int:
        """Ensure a breakpoint at exactly t; return its (global) index."""
        lo, n = self.lo, self.n
        times, vals = self.times, self.vals
        i = lo + int(times[lo : lo + n].searchsorted(t, side="right")) - 1
        if times[i] == t:
            return i
        hi = lo + n
        if i - lo < n // 2:                   # head side is shorter: shift it
            times[lo - 1 : i] = times[lo : i + 1]
            vals[lo - 1 : i] = vals[lo : i + 1]
            times[i] = t
            vals[i] = vals[i - 1]
            self.lo = lo - 1
            self.n = n + 1
            return i
        times[i + 2 : hi + 1] = times[i + 1 : hi]     # overlap-safe memmove
        vals[i + 2 : hi + 1] = vals[i + 1 : hi]
        times[i + 1] = t
        vals[i + 1] = vals[i]
        self.n = n + 1
        return i + 1

    def _delete_at(self, j: int) -> None:
        lo, n = self.lo, self.n
        if j - lo < n // 2:                   # shift the (shorter) head right
            self.times[lo + 1 : j + 1] = self.times[lo:j]
            self.vals[lo + 1 : j + 1] = self.vals[lo:j]
            self.lo = lo + 1
        else:
            hi = lo + n
            self.times[j : hi - 1] = self.times[j + 1 : hi]
            self.vals[j : hi - 1] = self.vals[j + 1 : hi]
            self.times[hi - 1] = _INF
        self.n = n - 1

    def _apply_one(self, t1: float, t2: float, amount: int) -> None:
        if self.lo < 2 or self.lo + self.n + 2 > self.times.shape[0]:
            self._regap()                     # room for two new breakpoints
        lo, n = self.lo, self.n
        times, vals = self.times, self.vals
        j = lo + int(times[lo : lo + n].searchsorted(t1, side="right"))
        # Fast path 1 — the interval lies strictly inside one segment (the
        # usual shape of a fresh reservation landing in a gap): splice both
        # breakpoints with a single shift; no coalescing is possible.
        if times[j - 1] != t1 and (j == lo + n or t2 < times[j]):
            v = int(vals[j - 1])
            hi = lo + n
            if j - lo <= n // 2:              # shift the (shorter) head
                times[lo - 2 : j - 2] = times[lo:j]
                vals[lo - 2 : j - 2] = vals[lo:j]
                self.lo = lo - 2
                j -= 2
            else:                             # shift the tail
                times[j + 2 : hi + 2] = times[j:hi]
                vals[j + 2 : hi + 2] = vals[j:hi]
            times[j] = t1
            times[j + 1] = t2
            vals[j] = v + amount
            vals[j + 1] = v
            self.n = n + 2
            return
        # Fast path 2 — the interval is exactly one existing segment (the
        # usual shape of a cancellation): adjust in place, then drop the
        # breakpoints that coalesce away.
        if times[j - 1] == t1 and j < lo + n and times[j] == t2:
            p = j - 1                         # the adjusted segment
            vals[p] += amount
            if vals[p + 1] == vals[p]:
                lo_pre = self.lo
                self._delete_at(p + 1)
                p += self.lo - lo_pre         # head-delete moved p right
            if self.lo < p and vals[p - 1] == vals[p]:
                self._delete_at(p)
            return
        i1 = self._cut(t1)
        lo_mid = self.lo
        i2 = self._cut(t2)                    # t2 > t1 => i2 > i1
        i1 -= lo_mid - self.lo                # 2nd cut's head-insert moved i1
        self.vals[i1:i2] += amount
        # Re-coalesce: only the two boundary pairs can merge — interior
        # neighbours moved by the same amount keep their inequality.
        if self.lo < i2 < self.lo + self.n and \
                self.vals[i2] == self.vals[i2 - 1]:
            lo_pre = self.lo
            self._delete_at(i2)
            i1 += self.lo - lo_pre            # head-delete moved i1 right
        if self.lo < i1 < self.lo + self.n and \
                self.vals[i1] == self.vals[i1 - 1]:
            self._delete_at(i1)

    def _rebuild(self, log: list[tuple[float, float, int]]) -> None:
        """Apply a whole mutation buffer in one vectorized merge."""
        old_t, old_v = self._view()
        t1s = np.fromiter((e[0] for e in log), np.float64, len(log))
        t2s = np.fromiter((e[1] for e in log), np.float64, len(log))
        amts = np.fromiter((e[2] for e in log), np.int64, len(log))
        bp = np.unique(np.concatenate((old_t, t1s, t2s)))
        base = old_v[np.searchsorted(old_t, bp, side="right") - 1]
        delta = np.zeros(bp.shape[0] + 1, dtype=np.int64)
        np.add.at(delta, np.searchsorted(bp, t1s), amts)
        np.subtract.at(delta, np.searchsorted(bp, t2s), amts)
        vals = base + np.cumsum(delta[:-1])
        keep = np.empty(bp.shape[0], dtype=bool)
        keep[0] = True
        np.not_equal(vals[1:], vals[:-1], out=keep[1:])
        bp, vals = bp[keep], vals[keep]
        m = bp.shape[0]
        cap = self.times.shape[0]
        while cap < 2 * (m + 8):
            cap *= 2
        t = np.full(cap, _INF)
        v = np.zeros(cap, dtype=np.int64)
        lo = (cap - m) // 2
        t[lo : lo + m] = bp
        v[lo : lo + m] = vals
        self.times, self.vals, self.lo, self.n = t, v, lo, m

    def gc(self, now: float) -> None:
        """Collapse all history before ``now`` into the sentinel segment —
        O(log n): the dead head is skipped by advancing ``lo``."""
        if now <= self.floor:
            return
        self._flush()
        self.floor = now
        lo, n = self.lo, self.n
        times = self.times
        i = lo + int(times[lo : lo + n].searchsorted(now, side="right")) - 1
        if i > lo:
            times[i] = -_INF        # segment covering ``now`` -> new sentinel
            self.lo = i
            self.n = n - (i - lo)
            self._aux_ok = False

    # -- queries --------------------------------------------------------- #
    def max_over(self, t1: float, t2: float) -> int:
        """Max usage over [t1, t2); 0 for empty windows."""
        if t2 <= t1:
            return 0
        self._flush()
        t, v = self._view()
        i1 = int(t.searchsorted(t1, side="right")) - 1
        i2 = int(t.searchsorted(t2, side="left"))
        return int(v[i1:i2].max())

    def exceeds(self, t1: float, t2: float, limit: int) -> bool:
        """True iff usage ever exceeds ``limit`` on [t1, t2)."""
        if t2 <= t1:
            return False
        self._flush()
        t, v = self._view()
        i1 = int(t.searchsorted(t1, side="right")) - 1
        i2 = int(t.searchsorted(t2, side="left"))
        return bool(v[i1:i2].max() > limit)

    def _aux(self) -> np.ndarray:
        """Per-segment prefix sums of usage mass (``integral`` in O(1)).

        ``_prefix[j]`` is the total usage-seconds of (window-local) segments
        0..j-1.  The sentinel segment (start −inf) and the final segment
        (end +inf, usage 0 by invariant) contribute 0, keeping the sums
        finite; boundary segments of a query window are corrected exactly
        in `integral`.
        """
        if self._aux_ok:
            return self._prefix
        t, v = self._view()
        n = self.n
        c = np.zeros(n)
        if n > 2:
            c[1 : n - 1] = v[1 : n - 1] * (t[2:] - t[1 : n - 1])
        self._prefix = np.concatenate(([0.0, 0.0], np.cumsum(c[1:])))
        self._aux_ok = True
        return self._prefix

    def integral(self, t1: float, t2: float) -> float:
        """Usage-seconds over [t1, t2) (the ``load`` of the window)."""
        if t2 <= t1:
            return 0.0
        self._flush()
        t, v = self._view()
        i1 = int(t.searchsorted(t1, side="right")) - 1
        i2 = int(t.searchsorted(t2, side="left"))
        if i2 - i1 == 1:                       # window inside one segment
            return float(v[i1] * (t2 - t1))
        p = self._aux()
        return float(
            v[i1] * (t[i1 + 1] - t1)                   # left boundary clip
            + (p[i2 - 1] - p[i1 + 1])                  # full interior segs
            + v[i2 - 1] * (t2 - t[i2 - 1])             # right boundary clip
        )

    def window_profile(self, t1: float, t2: float) -> tuple[np.ndarray, np.ndarray]:
        """The skyline restricted to [t1, t2): parallel ``(starts, vals)``
        arrays where ``vals[i]`` holds on ``[starts[i], starts[i+1])`` and
        the last segment runs to ``t2``.  ``starts[0] == t1`` exactly; an
        empty window returns two empty arrays.  Feeds the preemption
        plane's incremental refit grid (scheduler ``_HPWindowGrid``)."""
        if t2 <= t1:
            return _EMPTY_F, np.empty(0, dtype=np.int64)
        self._flush()
        t, v = self._view()
        i1 = int(t.searchsorted(t1, side="right")) - 1
        i2 = int(t.searchsorted(t2, side="left"))
        starts = t[i1:i2].copy()
        starts[0] = t1
        return starts, v[i1:i2].copy()

    def first_fit(self, duration: float, not_before: float, limit: int) -> float:
        """Earliest t >= not_before with usage <= limit over [t, t+duration).

        A *run* of consecutive segments all at or below ``limit`` hosts the
        slot if its total span reaches ``duration - EPS``; candidate starts
        are ``t`` itself and the first segment after each blocked one.

        The common case — the slot fits within the first few segments past
        ``not_before`` — resolves in a short scalar walk; only a genuinely
        congested horizon falls through to the vectorized run search.
        """
        if limit < 0:
            return _INF                        # cores can never fit
        self._flush()
        times, vals = self._view()
        n = self.n
        t = not_before if not_before > self.floor else self.floor
        i = int(times.searchsorted(t, side="right")) - 1
        # scalar fast path over the next few segments
        cand = t
        for _ in range(6):
            if vals[i] > limit:
                i += 1
                if i >= n:                    # unreachable: tail is free
                    return float(cand)
                cand = float(times[i])
            else:
                seg_end = float(times[i + 1]) if i + 1 < n else _INF
                if seg_end - cand >= duration - EPS:
                    return float(cand)
                i += 1
                if i >= n:
                    return float(cand)
        # vectorized run search over the whole tail (recomputes the walked
        # prefix — correctness needs the run containing ``t`` intact)
        i = int(times.searchsorted(t, side="right")) - 1
        v = vals[i:n]
        bad = np.flatnonzero(v > limit)
        if bad.size == 0:                      # whole tail free (ends +inf)
            return t
        if bad[0] != 0 and times[i + bad[0]] - t >= duration - EPS:
            return t                           # fits in the current run
        starts = times[i + bad + 1]            # run starts after each block
        ends = np.empty(bad.size)
        ends[:-1] = times[i + bad[1:]]
        ends[-1] = _INF                        # final run extends forever
        ok = ends - starts >= duration - EPS
        if bad.size > 1:                       # adjacent blocks: not a run
            ok[:-1] &= bad[1:] != bad[:-1] + 1
        return float(starts[int(np.argmax(ok))])


class LinkCalendar:
    """Unit-capacity calendar for the shared wireless link.

    ``earliest_slot`` is an O(log n + runs) skyline probe; ``gc`` retires
    only the slots that expired since the previous call (expiry min-heap).
    """

    def __init__(self) -> None:
        self._starts: list[float] = []          # sorted by t1, parallel to
        self._res: list[Reservation] = []       # the live reservation list
        self._expiry: list[tuple[float, int, Reservation]] = []
        self._seq = itertools.count()
        self._sky = _StepFn()

    def __len__(self) -> int:
        return len(self._res)

    def reservations(self) -> Iterable[Reservation]:
        return iter(self._res)

    def earliest_slot(self, duration: float, not_before: float) -> float:
        """Earliest t >= not_before such that [t, t+duration) is free."""
        return self._sky.first_fit(duration, not_before, 0)

    def usage_segments(self, t1: float, t2: float) -> tuple[np.ndarray, np.ndarray]:
        """Raw link-occupancy segments over [t1, t2) as ``(starts, vals)``
        arrays — NO EPS shrink, same contract as
        :meth:`DeviceCalendar.usage_segments`.  Zero-valued segments are
        free link time; the placement oracle (core/oracle.py) reads these
        to price transfer feasibility."""
        return self._sky.window_profile(t1, t2)

    def reserve(self, t1: float, t2: float, tag: object = None) -> Reservation:
        r = Reservation(t1, t2, 1, tag)
        idx = bisect_left(self._starts, t1)
        self._starts.insert(idx, t1)
        self._res.insert(idx, r)
        self._sky.add(t1, t2, 1)
        heapq.heappush(self._expiry, (t2, next(self._seq), r))
        return r

    def reserve_earliest(
        self, duration: float, not_before: float, tag: object = None
    ) -> Reservation:
        t1 = self.earliest_slot(duration, not_before)
        return self.reserve(t1, t1 + duration, tag)

    def _locate(self, res: Reservation) -> int:
        """Index of ``res`` in the live list, -1 if absent (O(log n + dups))."""
        idx = bisect_left(self._starts, res.t1)
        while idx < len(self._res) and self._starts[idx] == res.t1:
            if self._res[idx] is res or self._res[idx] == res:
                return idx
            idx += 1
        return -1

    def cancel(self, res: Reservation) -> None:
        """Remove a reservation; cancelling twice (or a foreign/expired slot)
        is a no-op."""
        idx = self._locate(res)
        if idx < 0:
            return
        r = self._res[idx]
        del self._res[idx]
        del self._starts[idx]
        self._sky.add(r.t1, r.t2, -1)

    def gc(self, now: float) -> None:
        """Retire slots with t2 <= now.  Amortised O(log n) per dead slot."""
        heap = self._expiry
        while heap and heap[0][0] <= now:
            _, _, r = heapq.heappop(heap)
            idx = self._locate(r)
            if idx >= 0 and self._res[idx].t2 <= now:
                del self._res[idx]
                del self._starts[idx]
        self._sky.gc(now)


class _LPMirror:
    """Array mirror of one device's LP-tagged reservations — the preemption
    plane's conflict-candidate columns.

    The HP eviction loop used to rebuild a Python list of conflicting LP
    reservations per iteration (O(reservations) interpreted work per
    victim).  This mirror keeps the candidates as stacked NumPy columns
    (``t1`` / ``t2`` / ``amount`` over rows ``[0, m)`` plus a parallel
    ``tasks`` ref list), so conflict enumeration is ONE overlap mask and
    victim ranking ONE masked argmin per iteration.

    Exactness contract (tests/test_preemption_plane.py):

    * rows preserve the ``DeviceCalendar._res`` dict's insertion order — a
      re-reserved tag moves to the END, exactly like the dict — so a masked
      first-tie argmin reproduces ``min()``-over-iteration tie-breaks
      bit-for-bit;
    * the mirror is synced by the calendar's own mutation hooks (reserve /
      release / truncate / gc), never rebuilt per admission; removal only
      clears the ``alive`` bit, keeping surviving rows' order stable
      (compaction runs between admissions, in :meth:`compact`);
    * task deadlines are NOT mirrored — they are gathered live per
      admission, because callers may legally mutate ``task.deadline`` after
      reserving.
    """

    __slots__ = ("t1", "t2", "amount", "alive", "tasks", "rows", "m", "dead")

    def __init__(self, cap: int = 16) -> None:
        self.t1 = np.empty(cap)
        self.t2 = np.empty(cap)
        self.amount = np.empty(cap, dtype=np.int64)
        self.alive = np.zeros(cap, dtype=bool)
        self.tasks: list[Optional[Task]] = []   # parallel refs, len == m
        self.rows: dict[int, int] = {}          # task_id -> row
        self.m = 0                              # append cursor
        self.dead = 0

    @staticmethod
    def tracks(tag: object) -> bool:
        return isinstance(tag, Task) and tag.priority == Priority.LOW

    def add(self, r: Reservation) -> None:
        m = self.m
        if m == self.t1.shape[0]:
            grow = max(16, m)
            self.t1 = np.concatenate((self.t1, np.empty(grow)))
            self.t2 = np.concatenate((self.t2, np.empty(grow)))
            self.amount = np.concatenate(
                (self.amount, np.empty(grow, dtype=np.int64)))
            self.alive = np.concatenate(
                (self.alive, np.zeros(grow, dtype=bool)))
        task: Task = r.tag
        self.t1[m], self.t2[m], self.amount[m] = r.t1, r.t2, r.amount
        self.alive[m] = True
        self.tasks.append(task)
        self.rows[task.task_id] = m
        self.m = m + 1

    def discard(self, tag: object) -> None:
        if not isinstance(tag, Task):
            return
        row = self.rows.pop(tag.task_id, None)
        if row is None:
            return
        self.alive[row] = False
        self.tasks[row] = None
        self.dead += 1

    def truncate(self, tag: object, t_end: float) -> None:
        if not isinstance(tag, Task):
            return
        row = self.rows.get(tag.task_id)
        if row is not None:
            self.t2[row] = t_end

    def gc(self, now: float) -> None:
        """Drop rows whose reservations the calendar's gc retired
        (``t2 <= now``) — one vectorized sweep, not per-row Python."""
        if not self.m:
            return
        for row in np.flatnonzero(self.alive[: self.m]
                                  & (self.t2[: self.m] <= now)):
            task = self.tasks[row]
            self.rows.pop(task.task_id, None)
            self.tasks[row] = None
            self.alive[row] = False
            self.dead += 1

    def compact(self) -> None:
        """Squeeze out dead rows (order-preserving); amortised O(1) — runs
        only from the accessor, never inside an eviction loop."""
        if self.dead <= 32 or self.dead * 2 <= self.m:
            return
        keep = np.flatnonzero(self.alive[: self.m])
        n = keep.shape[0]
        self.t1[:n] = self.t1[keep]
        self.t2[:n] = self.t2[keep]
        self.amount[:n] = self.amount[keep]
        self.alive[:n] = True
        self.alive[n:] = False
        self.tasks = [self.tasks[i] for i in keep]
        self.rows = {t.task_id: i for i, t in enumerate(self.tasks)}
        self.m, self.dead = n, 0


class DeviceCalendar:
    """Capacity-C calendar for one edge device's cores.

    Core-usage queries go through the array skyline; ``completion_times``
    reads a searchsorted window of the sorted ``_t2s`` array; reservation
    identity (reserve / release / truncate by tag) stays a dict, which the
    preemption path also uses to enumerate conflict candidates.

    ``_t2s`` is copy-on-write: every mutation allocates a fresh array, so a
    reference taken by :meth:`NetworkState.iter_completion_times` is an
    immutable snapshot for free.  ``_notify`` (wired by ``NetworkState``)
    marks the device dirty for the probe plane on every mutation.
    """

    def __init__(self, device: int, capacity: int = 4) -> None:
        self.device = device
        self.capacity = capacity
        self.lifecycle = DeviceLifecycle.UP
        self._res: dict[object, Reservation] = {}
        self._sky = _StepFn()
        self._t2s: np.ndarray = _EMPTY_F        # sorted completion times
        self._expiry: list[tuple[float, int, object]] = []
        self._seq = itertools.count()
        self._notify: Optional[Callable[[int], None]] = None
        self._expiry_sink: Optional[list] = None     # NetworkState's gc heap
        self._lp: Optional[_LPMirror] = None         # preemption-plane mirror

    def __len__(self) -> int:
        return len(self._res)

    @property
    def is_up(self) -> bool:
        """True when the device accepts new placements (UP — DRAINING and
        DOWN devices are both closed to admission)."""
        return self.lifecycle is DeviceLifecycle.UP

    def reservations(self) -> Iterable[Reservation]:
        return self._res.values()

    def _touch(self) -> None:
        cb = self._notify
        if cb is not None:
            cb(self.device)

    # -- queries (all O(log n + slice)) ----------------------------------- #
    def max_usage(self, t1: float, t2: float) -> int:
        # Shrink by EPS so sub-EPS boundary overlaps are ignored, matching
        # Reservation.overlaps() in the reference implementation.
        return self._sky.max_over(t1 + EPS, t2 - EPS)

    def free_cores(self, t1: float, t2: float) -> int:
        return self.capacity - self.max_usage(t1, t2)

    def fits(self, t1: float, t2: float, cores: int) -> bool:
        return not self._sky.exceeds(t1 + EPS, t2 - EPS, self.capacity - cores)

    def load(self, t1: float, t2: float) -> float:
        """Reserved core-seconds overlapping [t1, t2) (for even spreading)."""
        return self._sky.integral(t1, t2)

    def earliest_fit(self, duration: float, not_before: float, cores: int) -> float:
        """Earliest t >= not_before where ``cores`` fit for ``duration``."""
        return self._sky.first_fit(duration, not_before, self.capacity - cores)

    def usage_segments(self, t1: float, t2: float) -> tuple[np.ndarray, np.ndarray]:
        """Raw core-usage segments over [t1, t2) as ``(starts, vals)``
        arrays — NO EPS shrink; callers pick their own window semantics.
        The preemption plane's refit grid (scheduler ``_HPWindowGrid``)
        builds on this with its left bound already EPS-shifted and an
        extended right horizon, so a max over its segments equals
        :meth:`max_usage` of any EPS-shrunk window inside the span."""
        return self._sky.window_profile(t1, t2)

    def lp_mirror(self) -> _LPMirror:
        """The device's LP-reservation mirror (preemption plane), built
        lazily by backfilling from the live reservation dict in insertion
        order; once built, the mutation hooks keep it in sync."""
        lp = self._lp
        if lp is None:
            lp = self._lp = _LPMirror()
            for r in self._res.values():
                if _LPMirror.tracks(r.tag):
                    lp.add(r)
        else:
            lp.compact()
        return lp

    def completion_times(self, after: float, before: float) -> list[float]:
        a = self._t2s
        lo = int(a.searchsorted(after + EPS, side="right"))
        hi = int(a.searchsorted(before - EPS, side="left"))
        if hi <= lo:
            return []
        return [t for t, _ in itertools.groupby(a[lo:hi].tolist())]

    # -- updates ---------------------------------------------------------- #
    def _t2s_insert(self, t2: float) -> None:  # replint: disable=dirty-notify (caller notifies)
        # manual splice: np.insert/np.delete carry ~10x Python overhead
        a = self._t2s
        i = int(a.searchsorted(t2))
        b = np.empty(a.shape[0] + 1)
        b[:i] = a[:i]
        b[i] = t2
        b[i + 1 :] = a[i:]
        self._t2s = b

    def _t2s_remove(self, t2: float) -> None:  # replint: disable=dirty-notify (caller notifies)
        a = self._t2s
        i = int(a.searchsorted(t2))
        if i < a.shape[0] and a[i] == t2:
            b = np.empty(a.shape[0] - 1)
            b[:i] = a[:i]
            b[i:] = a[i + 1 :]
            self._t2s = b

    def reserve(self, t1: float, t2: float, cores: int, tag: object) -> Reservation:
        prev = self._res.pop(tag, None)
        if prev is not None:                    # re-reserving a tag replaces it
            self._remove_interval(prev)
        r = Reservation(t1, t2, cores, tag)
        self._res[tag] = r
        if self._lp is not None and _LPMirror.tracks(tag):
            self._lp.add(r)
        self._sky.add(t1, t2, cores)
        self._t2s_insert(t2)
        heapq.heappush(self._expiry, (t2, next(self._seq), tag))
        if self._expiry_sink is not None:
            heapq.heappush(self._expiry_sink, (t2, self.device))
        self._touch()
        return r

    def _remove_interval(self, r: Reservation) -> None:  # replint: disable=dirty-notify (caller notifies)
        if self._lp is not None:
            self._lp.discard(r.tag)
        self._sky.add(r.t1, r.t2, -r.amount)
        self._t2s_remove(r.t2)

    def release(self, tag: object) -> Optional[Reservation]:
        r = self._res.pop(tag, None)
        if r is not None:
            self._remove_interval(r)
            self._touch()
        return r

    def get(self, tag: object) -> Optional[Reservation]:
        return self._res.get(tag)

    def truncate(self, tag: object, t_end: float) -> None:
        """Shorten a reservation (early completion / violation).  Truncating
        to (or before) its start removes it entirely."""
        r = self._res.get(tag)
        if r is None:
            return
        if t_end <= r.t1 + EPS:
            self._res.pop(tag)
            self._remove_interval(r)
            self._touch()
            return
        if t_end >= r.t2:
            return
        self._sky.add(t_end, r.t2, -r.amount)
        self._t2s_remove(r.t2)
        self._t2s_insert(t_end)
        r.t2 = t_end
        if self._lp is not None:
            self._lp.truncate(tag, t_end)
        heapq.heappush(self._expiry, (t_end, next(self._seq), tag))
        if self._expiry_sink is not None:
            heapq.heappush(self._expiry_sink, (t_end, self.device))
        self._touch()

    def gc(self, now: float) -> None:
        """Retire reservations with t2 <= now; O(log n) per retirement.

        In-flight reservations straddling ``now`` keep their full remaining
        interval; their pre-``now`` history is collapsed by the skyline."""
        heap, res = self._expiry, self._res
        while heap and heap[0][0] <= now:
            t2, _, tag = heapq.heappop(heap)
            r = res.get(tag)
            if r is None:
                continue
            if r.t2 <= now:
                del res[tag]
            elif r.t2 != t2:
                # stale entry (tag was truncated/re-reserved); re-index
                heapq.heappush(heap, (r.t2, next(self._seq), tag))
        a = self._t2s
        lo = int(a.searchsorted(now, side="right"))
        if lo:
            self._t2s = a[lo:].copy()
        self._sky.gc(now)
        if self._lp is not None:
            self._lp.gc(now)
        self._touch()

    def clear(self) -> None:
        """Wipe every reservation (device loss, or a rejoin after one):
        fresh skyline, empty expiry heap, dropped mirrors.  Stale entries
        this device left in the ``NetworkState`` gc heap stay behind and
        resolve as no-ops when popped."""
        self._res.clear()
        self._sky = _StepFn()
        self._t2s = _EMPTY_F
        self._expiry = []
        self._lp = None
        self._touch()


class _ProbePlane:
    """The network-wide probe plane: every device skyline mirrored into
    padded 2-D arrays so one vectorized pass answers a probe for ALL
    devices at once.

    ``times`` is (D, W+1) — one +inf spare column so "next breakpoint"
    gathers never run off the row; ``vals`` is (D, W); rows are refreshed
    lazily from the per-device dirty set maintained by ``NetworkState``.
    Padding (+inf times, 0 vals) is self-neutralising in every query, so no
    per-row trimming is needed.

    Exactness: every vector entry is bit-identical to the corresponding
    scalar ``DeviceCalendar`` query — returned instants are existing
    breakpoints or the probe's own bounds, window maxima are integer
    reductions over the same segments (tests/test_probe_plane.py,
    tests/test_skyline_fuzz.py).
    """

    def __init__(self, state: "NetworkState") -> None:
        self._state = state
        self._d = len(state.devices)
        self.capacity = np.fromiter((dev.capacity for dev in state.devices),
                                    np.int64, self._d)
        self._w = 8                             # skyline columns
        self._t = 8                             # completion-time columns
        self._ff_cache: dict[tuple, tuple] = {}
        self._bc: dict[int, np.ndarray] = {}    # cores -> blocked-count prefix
        self._alloc()

    def _alloc(self) -> None:
        d, w, t = self._d, self._w, self._t
        self.alive = np.fromiter(
            (dev.lifecycle is DeviceLifecycle.UP
             for dev in self._state.devices), np.bool_, d)
        self.times = np.full((d, w + 1), _INF)  # +1 spare col: "next" gathers
        self.vals = np.zeros((d, w), dtype=np.int64)
        self.prefix = np.zeros((d, w + 1))      # per-row usage-mass prefixes
        self.t2pad = np.full((d, t), _INF)      # per-device completion times
        self.nseg = np.ones(d, dtype=np.int64)  # live segments per row
        self._rowmax = np.full(d, -_INF)        # last breakpoint per row
        self._tmax = -_INF                      # ... and its global max
        self._col = np.arange(w)
        self._rows = np.arange(d)
        self._bc.clear()

    @staticmethod
    def _round_up(need: int, have: int) -> int:
        while have < need:
            have += max(8, have // 2)           # 1.5x growth, 8-col floor
        return have

    def _row_prefix(self, idx: int, n: int) -> None:
        """Per-row usage-mass prefix (``loads`` in O(1) after location).

        ``prefix[d, j]`` is the total usage-seconds of (row-local) segments
        0..j-1; the sentinel segment (start −inf) and the final segment
        (end +inf, usage 0 by invariant) contribute 0, keeping the sums
        finite — query boundary segments are corrected exactly in `loads`.
        """
        trow = self.times[idx]
        with np.errstate(invalid="ignore"):      # 0 * inf at the two ends
            c = self.vals[idx, :n] * (trow[1 : n + 1] - trow[:n])
        c[0] = 0.0
        c[n - 1] = 0.0
        p = self.prefix[idx]
        np.cumsum(c, out=p[1 : n + 1])
        p[n + 1 :] = p[n]

    def _refresh(self) -> None:
        dirty = self._state._dirty
        if not dirty:
            return
        devices = self._state.devices
        need_w = need_t = 0
        for idx in dirty:  # replint: disable=determinism-set-iter (max-reduction over rows; order-independent)
            dev = devices[idx]
            sf = dev._sky
            sf._flush()
            if sf.n > need_w:
                need_w = sf.n
            if dev._t2s.shape[0] > need_t:
                need_t = dev._t2s.shape[0]
        if need_w > self._w or need_t > self._t:
            self._w = self._round_up(need_w, self._w)
            self._t = self._round_up(need_t, self._t)
            self._alloc()
            dirty = range(self._d)               # every row needs a rebuild
        times, vals, t2pad = self.times, self.vals, self.t2pad
        for idx in dirty:
            dev = devices[idx]
            self.alive[idx] = dev.lifecycle is DeviceLifecycle.UP
            sf = dev._sky
            st, sv = sf._view()
            n = sf.n
            times[idx, :n] = st
            times[idx, n:] = _INF
            vals[idx, :n] = sv
            vals[idx, n:] = 0
            self.nseg[idx] = n
            self._rowmax[idx] = st[n - 1]
            self._row_prefix(idx, n)
            for cores, bc in self._bc.items():   # keep limit tables in sync
                np.cumsum(vals[idx] > self.capacity[idx] - cores,
                          out=bc[idx, 1:])
            t2s = dev._t2s
            m = t2s.shape[0]
            t2pad[idx, :m] = t2s
            t2pad[idx, m:] = _INF
        self._tmax = float(self._rowmax.max())
        self._ff_cache.clear()
        self._state._dirty.clear()

    def _count_below(self, x: float, strict: bool) -> np.ndarray:
        """Per-row count of breakpoints below ``x`` (the location pass).

        Probe windows start near the gc'd front of every row, so the count
        almost always resolves within the first few columns — try a short
        front slice first and widen to the full mirror only when some row
        saturates it."""
        if x > self._tmax:              # beyond every breakpoint: all count
            return self.nseg
        t = self.times
        k = 16
        if k < t.shape[1]:
            head = t[:, :k]
            c = np.count_nonzero(head < x if strict else head <= x, axis=1)
            sat = np.flatnonzero(c == k)
            if sat.size == 0:
                return c
            if sat.size <= 32:          # escalate just the saturated rows
                side = "left" if strict else "right"
                for r in sat:
                    c[r] = t[r].searchsorted(x, side=side)
                return c
        return np.count_nonzero(t < x if strict else t <= x, axis=1)

    def _blocked_counts(self, cores: int) -> np.ndarray:
        """``bc[d, j]``: how many of row d's first j segments cannot host
        ``cores`` more cores.  A window fits iff its count delta is zero —
        integer-exact, O(1) per row after location."""
        bc = self._bc.get(cores)
        if bc is None:
            bc = np.zeros((self._d, self._w + 1), dtype=np.int64)
            np.cumsum(self.vals > (self.capacity - cores)[:, None],
                      axis=1, out=bc[:, 1:])
            self._bc[cores] = bc
        return bc

    # -- vectorized probes ------------------------------------------------ #
    def max_usage(self, t1: float, t2: float) -> np.ndarray:
        """Stacked ``DeviceCalendar.max_usage`` (EPS-shrunk window).

        After the location pass, the reduction runs only over the column
        strip any device's window actually touches — typically a handful of
        columns, not the full mirror width."""
        a, b = t1 + EPS, t2 - EPS
        if b <= a:
            return np.zeros(self._d, dtype=np.int64)
        w = self._w
        i1 = self._count_below(a, strict=False) - 1
        i2 = self._count_below(b, strict=True)
        j0, j1 = int(i1.min()), int(i2.max())
        col = self._col[j0:j1]
        mask = (col >= i1[:, None]) & (col < i2[:, None])
        return np.where(mask, self.vals[:, j0:j1], 0).max(axis=1)

    def free_cores(self, t1: float, t2: float) -> np.ndarray:
        return self.capacity - self.max_usage(t1, t2)

    def fits_mask(self, t1: float, t2: float, cores: int) -> np.ndarray:
        """Stacked ``DeviceCalendar.fits`` — integer-exact via the per-cores
        blocked-count prefixes: a window hosts ``cores`` more cores iff it
        spans zero blocked segments.  Non-UP rows are masked out: admission
        must never place onto a DRAINING/DOWN device (with every device UP
        the mask is all-ones, so churn-free answers are bit-identical)."""
        a, b = t1 + EPS, t2 - EPS
        if b <= a:
            return self.alive.copy()
        i1 = self._count_below(a, strict=False) - 1
        i2 = self._count_below(b, strict=True)
        bc = self._blocked_counts(cores)
        rows = self._rows
        return (bc[rows, i2] == bc[rows, i1]) & self.alive

    def loads(self, t1: float, t2: float) -> np.ndarray:
        """Stacked ``DeviceCalendar.load`` over [t1, t2): locate the window
        per row, then the per-row usage-mass prefixes answer the interior in
        O(1) — only the two boundary segments need exact clipping."""
        if t2 <= t1:
            return np.zeros(self._d)
        rows = self._rows
        t = self.times
        i1 = self._count_below(t1, strict=False) - 1
        i2m = self._count_below(t2, strict=True) - 1  # last segment in window
        v = self.vals
        p = self.prefix
        v1 = v[rows, i1]
        with np.errstate(invalid="ignore"):      # 0*inf in discarded branch
            single = v1 * (t2 - t1)              # window inside one segment
            full = (v1 * (t[rows, i1 + 1] - t1)          # left boundary clip
                    + (p[rows, i2m] - p[rows, i1 + 1])   # full interior segs
                    + v[rows, i2m] * (t2 - t[rows, i2m]))  # right clip
            return np.where(i2m == i1, single, full)

    def earliest_fit(self, duration: float, not_before: float,
                     cores: int) -> np.ndarray:
        """Stacked ``DeviceCalendar.earliest_fit`` (first-fit run search).

        Requires ``not_before`` at or after every device's gc horizon — the
        scheduler only probes at or after controller time, which satisfies
        it by construction.  The (cores, duration)-keyed tables — blocked
        mask, each run's end, and the feasible run-start columns — survive
        until the next mutation, so the LP sweep's repeated skip-hint probes
        pay only the location pass.
        """
        w, col, rows = self._w, self._col, self._rows
        t = self.times[:, :w]
        key = (cores, duration)
        tab = self._ff_cache.get(key)
        if tab is None:
            limit = (self.capacity - cores)[:, None]
            bad = self.vals > limit
            # next blocked segment at or after each column (w = "none")
            idx = np.where(bad, col, w)
            nb = np.minimum.accumulate(idx[:, ::-1], axis=1)[:, ::-1]
            run_end = np.take_along_axis(self.times, nb, axis=1)
            prev_bad = np.zeros_like(bad)
            prev_bad[:, 1:] = bad[:, :-1]
            with np.errstate(invalid="ignore"):  # inf-inf in padded columns
                ok_col = ~bad & prev_bad & (run_end - t >= duration - EPS)
            tab = self._ff_cache[key] = (bad, run_end, ok_col)
        bad, run_end, ok_col = tab
        i0 = self._count_below(not_before, strict=False) - 1
        # candidate 1: ``not_before`` itself, inside its (good) run
        use_t = ~bad[rows, i0] & (run_end[rows, i0] - not_before
                                  >= duration - EPS)
        # candidate 2: the first feasible run start past ``not_before``
        ok = ok_col & (col > i0[:, None])
        j = ok.argmax(axis=1)
        res = np.where(use_t, not_before, t[rows, j])
        # rows that can never host ``cores`` (capacity too small) have no
        # candidate at all — match the scalar first_fit's +inf guard
        # instead of leaking the argmax-of-nothing -inf sentinel.  Non-UP
        # rows are masked to +inf the same way: a DRAINING/DOWN device
        # never offers a start instant to admission.
        return np.where((self.capacity < cores) | ~self.alive, _INF, res)

    # -- completion-time plane -------------------------------------------- #
    def completion_array(self, after: float, before: float) -> np.ndarray:
        """Sorted unique completion points in (after, before), network-wide,
        in one vectorized select + ``np.unique`` merge."""
        return _unique_window(self.t2pad, after, before)


def _unique_window(t2pad: np.ndarray, after: float, before: float) -> np.ndarray:
    """Sorted unique values of ``t2pad`` strictly inside the EPS-shrunk
    window (after + EPS, before - EPS) — exclusive on both sides, exactly
    like the per-device bisect windows (+inf padding is never selected)."""
    pts = t2pad[(t2pad > after + EPS) & (t2pad < before - EPS)]
    if pts.size == 0:
        return pts
    return np.unique(pts)


@dataclass
class ProbeWindow:
    """One ``probe_plane(t1, t2)`` snapshot: stacked per-device vectors."""

    t1: float
    t2: float
    free_cores: np.ndarray                      # (D,) ints
    loads: np.ndarray                           # (D,) usage-seconds
    _capacity: np.ndarray
    alive: Optional[np.ndarray] = None          # (D,) bool (None: all UP)

    def fits(self, cores: int) -> np.ndarray:
        """(D,) bool mask: which devices can host ``cores`` over the window
        (non-UP devices never fit)."""
        mask = self.free_cores >= cores
        if self.alive is not None:
            mask &= self.alive
        return mask


@dataclass
class NetworkState:
    """The controller's perception of all network resources (paper §3)."""

    n_devices: int
    capacity: int = 4
    link: LinkCalendar = field(default_factory=LinkCalendar)
    devices: list[DeviceCalendar] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.devices:
            self.devices = [
                DeviceCalendar(d, self.capacity) for d in range(self.n_devices)
            ]
        self._dirty: set[int] = set(range(len(self.devices)))
        self._plane: Optional[_ProbePlane] = None
        # Global device-expiry heap: every reservation/truncation registers
        # (t2, device), so gc touches only devices that actually have
        # something to retire — O(expirations), not O(devices).
        self._expiry: list[tuple[float, int]] = []
        for d in self.devices:
            d._notify = self._dirty.add
            d._expiry_sink = self._expiry
            if d._expiry:               # pre-populated device handed in
                heapq.heappush(self._expiry, (d._expiry[0][0], d.device))

    def probe_plane(self, t1: Optional[float] = None,
                    t2: Optional[float] = None):
        """The vectorized network-wide probe plane.

        Without arguments, returns the (lazily refreshed) :class:`_ProbePlane`
        for window-parameterised probes — ``fits_mask`` / ``free_cores`` /
        ``loads`` / ``earliest_fit`` each answer for every device in one
        vectorized pass.  With a window, returns a :class:`ProbeWindow`
        snapshot carrying the stacked free-core and load vectors for
        [t1, t2).
        """
        plane = self._plane
        if plane is None:
            plane = self._plane = _ProbePlane(self)
        plane._refresh()
        if t1 is None:
            return plane
        return ProbeWindow(t1, t2, plane.free_cores(t1, t2),
                           plane.loads(t1, t2), plane.capacity, plane.alive)

    def completion_times(self, after: float, before: float) -> list[float]:
        """Sorted unique completion time-points in (after, before), network
        wide — the LP algorithm's §4 search grid, merged in one vectorized
        select + ``np.unique`` over the probe plane's completion mirror."""
        plane = self.probe_plane()
        return plane.completion_array(after, before).tolist()

    def iter_completion_times(self, after: float, before: float) -> Iterator[float]:
        """Lazy variant of :meth:`completion_times`: same sorted unique
        points, but all windowing/merge work is deferred until a point is
        actually consumed — the LP sweep usually allocates at the first
        time-point, so most grids cost O(D) reference grabs and nothing
        else.

        The snapshot is taken at CALL time: the per-device ``_t2s`` arrays
        are copy-on-write (every mutation allocates a fresh array), so
        holding the references IS an immutable capture — reservations
        committed while iterating can never perturb the grid (the seed's
        snapshot semantics)."""
        snap = [d._t2s for d in self.devices]

        def merge() -> Iterator[float]:
            pts = np.concatenate(snap) if snap else _EMPTY_F
            pts = pts[(pts > after + EPS) & (pts < before - EPS)]
            if pts.size:
                yield from np.unique(pts).tolist()

        return merge()

    def total_allocated_tasks(self) -> int:
        return sum(len(d) for d in self.devices)

    # -- device lifecycle (churn plane, DESIGN.md §16) ------------------ #
    def alive_mask(self) -> np.ndarray:
        """(D,) bool: which devices accept new placements (UP only)."""
        return np.fromiter(
            (d.lifecycle is DeviceLifecycle.UP for d in self.devices),
            np.bool_, len(self.devices))

    def lifecycle_codes(self) -> np.ndarray:
        """(D,) int8 lifecycle codes (the checkpoint encoding —
        checkpoint/lifecycle.py round-trips this array)."""
        return np.fromiter(
            (d.lifecycle.value for d in self.devices),
            np.int8, len(self.devices))

    def apply_lifecycle_codes(self, codes) -> None:
        """Restore per-device lifecycles from :meth:`lifecycle_codes`.

        A device restored as DOWN gets its calendar cleared (a DOWN device
        by invariant holds no reservations); every changed device is
        dirty-marked so the probe plane's alive mask refreshes."""
        codes = np.asarray(codes)
        if codes.shape != (len(self.devices),):
            raise ValueError(
                f"lifecycle codes shape {codes.shape} != "
                f"({len(self.devices)},)")
        for dev, code in zip(self.devices, codes.tolist()):
            lc = DeviceLifecycle(int(code))
            if lc is dev.lifecycle:
                continue
            if lc is DeviceLifecycle.DOWN:
                dev.clear()
            dev.lifecycle = lc
            self._dirty.add(dev.device)

    def fail_device(self, idx: int, now: float) -> list[Task]:
        """Hard-fail device ``idx``: mark it DOWN, clear its calendar, and
        return every in-flight task it was hosting (the *orphans*, sorted
        by task id for a deterministic recovery order).

        Finished work is retired first (``gc``), so only reservations still
        running at — or starting after — ``now`` orphan.  Link slots,
        dispatcher exec events, and terminal accounting for the orphans are
        the policy layer's job (scheduler ``fail_device`` / policy
        ``fail_device``); this method only mutates the calendar plane."""
        dev = self.devices[idx]
        dev.gc(now)
        orphans = [r.tag for r in dev.reservations()
                   if isinstance(r.tag, Task)]
        dev.clear()
        dev.lifecycle = DeviceLifecycle.DOWN
        self._dirty.add(idx)
        orphans.sort(key=lambda t: t.task_id)
        return orphans

    def drain_device(self, idx: int) -> None:
        """Gracefully drain device ``idx``: no new placements, but every
        in-flight reservation runs to completion (no orphans)."""
        dev = self.devices[idx]
        if dev.lifecycle is DeviceLifecycle.DOWN:
            raise ValueError(f"device {idx} is DOWN; rejoin before draining")
        dev.lifecycle = DeviceLifecycle.DRAINING
        self._dirty.add(idx)

    def rejoin_device(self, idx: int) -> None:
        """Bring device ``idx`` back to UP.  A DOWN device rejoins with a
        cleared calendar (its pre-failure reservations were orphaned at the
        failure); cancelling a drain keeps the calendar — nothing was lost."""
        dev = self.devices[idx]
        if dev.lifecycle is DeviceLifecycle.DOWN:
            dev.clear()                 # defensive: fail_device cleared it
        dev.lifecycle = DeviceLifecycle.UP
        self._dirty.add(idx)

    def gc(self, now: float) -> None:
        """Garbage-collect every resource to ``now``.

        Lazy per-device skip via the global expiry heap: a device with no
        registered expiry at or before ``now`` provably has nothing to
        retire (every ``_t2s``/dead-dict entry has a matching heap key), so
        it is left untouched — its un-collapsed history is invisible to
        queries at or after ``now``.  This turns the former O(D)
        per-admission sweep into O(devices-with-expirations)."""
        self.link.gc(now)
        heap = self._expiry
        if not heap or heap[0][0] > now:
            return
        devices = self.devices
        seen: set[int] = set()
        while heap and heap[0][0] <= now:
            _, idx = heapq.heappop(heap)
            seen.add(idx)
        for idx in sorted(seen):       # pinned order: heap re-pushes below
            d = devices[idx]
            d.gc(now)
            # Re-register the device's next expiry: keeps it tracked even
            # when its remaining reservations predate attachment to this
            # NetworkState (duplicates are deduped by ``seen``).
            if d._expiry:
                heapq.heappush(heap, (d._expiry[0][0], idx))
