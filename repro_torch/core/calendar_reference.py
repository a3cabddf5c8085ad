"""The seed's O(n)-per-query resource calendars, kept frozen as a reference.

This module is the pre-optimisation implementation of ``repro.core.calendar``
(linear sweeps over flat reservation lists).  It is retained for two reasons:

1. **Differential testing** — ``tests/test_calendar_equivalence.py`` replays
   randomized reservation sequences against both implementations and asserts
   identical answers for ``fits`` / ``max_usage`` / ``free_cores`` / ``load``
   / ``earliest_slot`` / ``completion_times``.
2. **Measured speedups** — ``benchmarks/scheduler_micro.py`` times the same
   admission workload on both network states, so the O(log n) rewrite's
   speedup is reported as a number, not asserted in prose (DESIGN.md §2.3).

Do not use these classes in production paths; they scale as O(total
reservations) per probe and O(total reservations) per ``gc``.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Iterable, Optional

from .calendar import EPS, Reservation


class ReferenceLinkCalendar:
    """Seed unit-capacity link calendar (O(n) scans)."""

    def __init__(self) -> None:
        self._starts: list[float] = []
        self._res: list[Reservation] = []

    def __len__(self) -> int:
        return len(self._res)

    def earliest_slot(self, duration: float, not_before: float) -> float:
        """Earliest t >= not_before such that [t, t+duration) is free."""
        t = not_before
        idx = bisect.bisect_left(self._starts, t)
        # A reservation starting before t may still cover it.
        if idx > 0 and self._res[idx - 1].t2 > t + EPS:
            t = self._res[idx - 1].t2
        for r in self._res[idx:]:
            if r.t1 >= t + duration - EPS:
                break
            t = max(t, r.t2)
        return t

    def reserve(self, t1: float, t2: float, tag: object = None) -> Reservation:
        r = Reservation(t1, t2, 1, tag)
        idx = bisect.bisect_left(self._starts, t1)
        self._starts.insert(idx, t1)
        self._res.insert(idx, r)
        return r

    def reserve_earliest(
        self, duration: float, not_before: float, tag: object = None
    ) -> Reservation:
        t1 = self.earliest_slot(duration, not_before)
        return self.reserve(t1, t1 + duration, tag)

    def cancel(self, res: Reservation) -> None:
        try:
            idx = self._res.index(res)
        except ValueError:
            return
        del self._res[idx]
        del self._starts[idx]

    def gc(self, now: float) -> None:
        keep = [r for r in self._res if r.t2 > now]
        self._res = keep
        self._starts = [r.t1 for r in keep]


class ReferenceDeviceCalendar:
    """Seed capacity-C device calendar (O(n) sweeps per probe)."""

    def __init__(self, device: int, capacity: int = 4) -> None:
        self.device = device
        self.capacity = capacity
        self._res: dict[object, Reservation] = {}

    def __len__(self) -> int:
        return len(self._res)

    def reservations(self) -> Iterable[Reservation]:
        return self._res.values()

    def usage_profile(self, t1: float, t2: float) -> list[tuple[float, int]]:
        """Sweep-line (time, cores-in-use) change points within [t1, t2)."""
        events: list[tuple[float, int]] = []
        for r in self._res.values():
            if r.overlaps(t1, t2):
                events.append((max(r.t1, t1), r.amount))
                events.append((min(r.t2, t2), -r.amount))
        events.sort()
        return events

    def max_usage(self, t1: float, t2: float) -> int:
        cur = peak = 0
        for _, delta in self.usage_profile(t1, t2):
            cur += delta
            peak = max(peak, cur)
        return peak

    def free_cores(self, t1: float, t2: float) -> int:
        return self.capacity - self.max_usage(t1, t2)

    def fits(self, t1: float, t2: float, cores: int) -> bool:
        return self.max_usage(t1, t2) + cores <= self.capacity

    def reserve(self, t1: float, t2: float, cores: int, tag: object) -> Reservation:
        r = Reservation(t1, t2, cores, tag)
        self._res[tag] = r
        return r

    def release(self, tag: object) -> Optional[Reservation]:
        return self._res.pop(tag, None)

    def get(self, tag: object) -> Optional[Reservation]:
        return self._res.get(tag)

    def truncate(self, tag: object, t_end: float) -> None:
        """Shorten a reservation (early completion / violation)."""
        r = self._res.get(tag)
        if r is None:
            return
        if t_end <= r.t1 + EPS:
            self._res.pop(tag)
        else:
            r.t2 = min(r.t2, t_end)

    def load(self, t1: float, t2: float) -> float:
        """Reserved core-seconds overlapping [t1, t2) (for even spreading)."""
        total = 0.0
        for r in self._res.values():
            if r.overlaps(t1, t2):
                total += (min(r.t2, t2) - max(r.t1, t1)) * r.amount
        return total

    def completion_times(self, after: float, before: float) -> list[float]:
        return sorted(
            {r.t2 for r in self._res.values() if after + EPS < r.t2 < before - EPS}
        )

    def gc(self, now: float) -> None:
        dead = [tag for tag, r in self._res.items() if r.t2 <= now]
        for tag in dead:
            del self._res[tag]


@dataclass
class ReferenceNetworkState:
    """Seed network state over the reference calendars."""

    n_devices: int
    capacity: int = 4
    link: ReferenceLinkCalendar = field(default_factory=ReferenceLinkCalendar)
    devices: list[ReferenceDeviceCalendar] = field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.devices:
            self.devices = [
                ReferenceDeviceCalendar(d, self.capacity) for d in range(self.n_devices)
            ]

    def completion_times(self, after: float, before: float) -> list[float]:
        pts: set[float] = set()
        for dev in self.devices:
            pts.update(dev.completion_times(after, before))
        return sorted(pts)

    def iter_completion_times(self, after: float, before: float):
        """Same sorted unique points as :meth:`completion_times` — eager
        under the hood (the seed structures have no incremental merge), but
        the iterator form lets the scheduler call one grid API for both
        network-state implementations."""
        return iter(self.completion_times(after, before))

    def total_allocated_tasks(self) -> int:
        return sum(len(d) for d in self.devices)

    def gc(self, now: float) -> None:
        self.link.gc(now)
        for d in self.devices:
            d.gc(now)
