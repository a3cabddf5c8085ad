"""Seeded churn injection: device failure / drain / rejoin event streams.

The churn plane (DESIGN.md §16) turns the static device fleet into a
lossy one: devices hard-fail (calendar lost, in-flight work orphaned),
drain (no new admissions, in-flight work runs out) and rejoin (cleared
calendar, admissible again).  This module generates those lifecycle
events as a *deterministic, precomputed schedule* — two runs with the
same :class:`ChurnConfig` produce the identical event list, and a config
with every rate at zero produces the empty list **without constructing a
generator at all**, so a churn-free run consumes zero randomness and
stays bit-identical to a run that never imported this module (the
zero-churn differential in ``tests/test_accounting_invariants.py`` pins
this).

Failures and drains arrive as a merged Poisson process at ``fail_rate +
drain_rate`` events per virtual second over ``[start, start+duration)``,
each picking a uniformly random currently-UP victim; ``max_down_frac``
caps the simultaneously-lost fraction (a capped draw still consumes its
random numbers, so the cap changes *which* events fire, never the
stream's alignment).  With ``rejoin=True`` every lost device schedules
its rejoin ``rejoin_delay`` seconds later — rejoins are emitted even
past the horizon so the fleet converges back to fully-UP.  Link
degradation is a third Poisson stream of ``link_rate`` events per
second, each occupying the shared link for ``link_duration`` seconds
(drivers reserve a duty-cycle slot on the link calendar — offloads queue
behind it, exactly like a burst of competing transfers).
"""
from __future__ import annotations

import heapq
import math
import random
import zlib
from dataclasses import dataclass
from typing import Iterator, Sequence


@dataclass(frozen=True)
class ChurnEvent:
    """One lifecycle event at virtual time ``t``.

    ``kind`` is one of ``"fail"``, ``"drain"``, ``"rejoin"`` (``device``
    is the target) or ``"link"`` (``device`` is a per-event sequence
    number; ``duration`` is the degradation slot length in seconds).
    """

    t: float
    kind: str
    device: int
    duration: float = 0.0


@dataclass(frozen=True)
class ChurnConfig:
    """A seeded churn schedule (all rates in events per virtual second)."""

    name: str = "churn"
    n_devices: int = 64
    fail_rate: float = 0.0          # hard failures / s (network-wide)
    drain_rate: float = 0.0         # graceful drains / s (network-wide)
    rejoin: bool = True             # lost devices come back
    rejoin_delay: float = 2.0       # seconds from loss to rejoin
    link_rate: float = 0.0          # link-degradation events / s
    link_duration: float = 0.05     # seconds the link stays occupied
    start: float = 0.0              # first instant churn may fire
    duration: float = 10.0          # churn window length
    max_down_frac: float = 0.5      # cap on simultaneously-lost fraction
    seed: int = 0

    def __post_init__(self) -> None:
        if self.n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        for f in ("fail_rate", "drain_rate", "link_rate"):
            if getattr(self, f) < 0.0:
                raise ValueError(f"{f} must be >= 0")
        if self.rejoin_delay <= 0.0:
            raise ValueError("rejoin_delay must be positive")
        if self.link_duration < 0.0:
            raise ValueError("link_duration must be >= 0")
        if self.duration < 0.0:
            raise ValueError("duration must be >= 0")
        if not (0.0 < self.max_down_frac <= 1.0):
            raise ValueError("max_down_frac must be in (0, 1]")

    @property
    def enabled(self) -> bool:
        return self.fail_rate > 0.0 or self.drain_rate > 0.0 \
            or self.link_rate > 0.0


def churn_schedule(cfg: ChurnConfig) -> list[ChurnEvent]:
    """Precompute the full time-sorted event list for ``cfg``.

    Returns ``[]`` for a disabled config without touching any RNG.
    """
    if not cfg.enabled:
        return []
    # name-salted seed, crc32 not hash() (stable across PYTHONHASHSEED) —
    # the same per-stream independence trick sim/traces.py uses
    rng = random.Random(cfg.seed ^ zlib.crc32(cfg.name.encode()))
    events: list[ChurnEvent] = []
    # UP pool with O(1) swap-pop removal (a list, not a set: the replint
    # determinism rule bans set iteration in decision paths, and victim
    # draws must not depend on set ordering anyway)
    up = list(range(cfg.n_devices))
    pos = {d: i for i, d in enumerate(up)}
    n_down = 0
    max_down = max(1, int(cfg.n_devices * cfg.max_down_frac))
    rejoins: list[tuple[float, int]] = []       # heap of (t, device)
    total = cfg.fail_rate + cfg.drain_rate
    end = cfg.start + cfg.duration
    inf = math.inf
    t_churn = cfg.start + rng.expovariate(total) if total > 0.0 else inf
    t_link = (cfg.start + rng.expovariate(cfg.link_rate)
              if cfg.link_rate > 0.0 else inf)
    link_seq = 0
    while True:
        t_rej = rejoins[0][0] if rejoins else inf
        tc = t_churn if t_churn < end else inf
        tl = t_link if t_link < end else inf
        if t_rej <= tc and t_rej <= tl:
            if not rejoins:
                break                            # every stream exhausted
            tr, dev = heapq.heappop(rejoins)
            events.append(ChurnEvent(t=tr, kind="rejoin", device=dev))
            pos[dev] = len(up)
            up.append(dev)
            n_down -= 1
        elif tc <= tl:
            # merged fail/drain arrival; a draw suppressed by the down-cap
            # (or an empty UP pool) still consumes its random numbers
            is_fail = rng.random() < cfg.fail_rate / total
            i = rng.randrange(len(up)) if up else -1
            if i >= 0 and n_down < max_down:
                dev = up[i]
                last = up[-1]
                up[i] = last
                pos[last] = i
                up.pop()
                del pos[dev]
                n_down += 1
                events.append(ChurnEvent(
                    t=t_churn, kind="fail" if is_fail else "drain",
                    device=dev))
                if cfg.rejoin:
                    heapq.heappush(
                        rejoins, (t_churn + cfg.rejoin_delay, dev))
            t_churn += rng.expovariate(total)
        else:
            events.append(ChurnEvent(
                t=t_link, kind="link", device=link_seq,
                duration=cfg.link_duration))
            link_seq += 1
            t_link += rng.expovariate(cfg.link_rate)
    return events


class ChurnInjector:
    """A precomputed, replayable churn event stream.

    Thin iterable over :func:`churn_schedule` — drivers either iterate it
    (``StreamingEngine.run(churn=...)``) or index ``.events`` directly
    (``run_large_n`` pushes them onto its event heap).  Disabled configs
    yield nothing and consumed zero randomness.
    """

    def __init__(self, cfg: ChurnConfig) -> None:
        self.cfg = cfg
        self.events: list[ChurnEvent] = churn_schedule(cfg)

    def __iter__(self) -> Iterator[ChurnEvent]:
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    @property
    def enabled(self) -> bool:
        return bool(self.events)

    def counts(self) -> dict[str, int]:
        """Event counts by kind (diagnostics / test assertions)."""
        out = {"fail": 0, "drain": 0, "rejoin": 0, "link": 0}
        for ev in self.events:
            out[ev.kind] += 1
        return out


def merge_schedules(
        schedules: Sequence[Sequence[ChurnEvent]]) -> list[ChurnEvent]:
    """Merge several time-sorted event lists into one (stable by t)."""
    return list(heapq.merge(*schedules, key=lambda ev: ev.t))
