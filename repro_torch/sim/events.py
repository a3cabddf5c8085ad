"""Minimal discrete-event engine (heap of timestamped callbacks)."""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Optional


class Event:
    __slots__ = ("time", "seq", "fn", "cancelled")

    def __init__(self, time: float, seq: int, fn: Callable[[], None]) -> None:
        self.time = time
        self.seq = seq
        self.fn = fn
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def __lt__(self, other: "Event") -> bool:
        return (self.time, self.seq) < (other.time, other.seq)


class EventQueue:
    def __init__(self) -> None:
        self._heap: list[Event] = []
        self._seq = itertools.count()
        self.now = 0.0

    def push(self, time: float, fn: Callable[[], None]) -> Event:
        if time < self.now:
            time = self.now
        ev = Event(time, next(self._seq), fn)
        heapq.heappush(self._heap, ev)
        return ev

    def run(self, until: Optional[float] = None) -> None:
        while self._heap:
            ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            if until is not None and ev.time > until:
                heapq.heappush(self._heap, ev)   # keep it for the next run()
                self.now = until
                return
            self.now = ev.time
            ev.fn()
