"""Open-ended arrival traces for the streaming engine.

The closed-workload generators (``sim/traces.py``, ``sim/scenarios.py``)
materialise a whole experiment's arrivals up front.  A soak run can't:
this module yields :class:`~repro.serving.stream.StreamArrival` records
**lazily** from a seeded generator, so a 10^6-request trace costs O(1)
memory and two runs with the same :class:`FirehoseConfig` produce the
identical arrival sequence (the streaming determinism test leans on
this).

Arrival process: a network-wide Poisson stream at ``rate`` arrivals per
virtual second, optionally modulated by a square-wave burst (``rate *
(1 + burstiness)`` during the first ``burst_duty`` of every
``burst_period`` — a crude on/off MMPP that exercises backpressure and
shedding without changing the long-run offered load much).  Each arrival
independently draws its device, priority class, LP set size and task
type from the config's distributions.  Deadlines stay relative (or
profile-derived) — the engine makes them absolute against its workload
profiles at offer time.
"""
from __future__ import annotations

import random
import zlib
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

from ..core.task import Priority

# NOTE: ``serving.stream`` is imported inside :func:`firehose`, not here —
# stream.py imports ``sim.events`` (and importing any ``sim`` submodule
# runs ``sim/__init__``, which imports this module), so a module-level
# import would be circular whichever side is loaded first.


@dataclass(frozen=True)
class FirehoseConfig:
    """A seeded, unbounded arrival stream (all rates in virtual seconds)."""

    name: str = "firehose"
    n_devices: int = 64
    rate: float = 100.0                 # network-wide arrivals / s
    lp_fraction: float = 0.4            # P(arrival is an LP request set)
    lp_set_sizes: Sequence[int] = (1, 2, 3, 4)
    task_mix: Sequence[tuple[Optional[str], float]] = ((None, 1.0),)
    burstiness: float = 0.0             # extra rate multiplier in bursts
    burst_period: float = 4.0           # seconds per on/off cycle
    burst_duty: float = 0.25            # burst fraction of each cycle
    hp_rel_deadline: Optional[float] = None   # None -> profile-derived
    lp_rel_deadline: Optional[float] = None   # None -> profile-derived
    seed: int = 0

    def __post_init__(self) -> None:
        if self.n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        if self.rate <= 0.0:
            raise ValueError("rate must be positive")
        if not (0.0 <= self.lp_fraction <= 1.0):
            raise ValueError("lp_fraction must be in [0, 1]")
        if not self.lp_set_sizes or min(self.lp_set_sizes) < 1:
            raise ValueError("lp_set_sizes must be non-empty, all >= 1")
        if self.burstiness < 0.0:
            raise ValueError("burstiness must be >= 0")


def firehose(cfg: FirehoseConfig,
             limit: Optional[int] = None) -> Iterator["StreamArrival"]:
    """Yield arrivals forever (or up to ``limit``) — O(1) memory, fully
    determined by ``cfg`` (including its seed)."""
    from ..serving.stream import StreamArrival  # lazy: see module note

    # name-salted seed, crc32 not hash() (stable across PYTHONHASHSEED) —
    # the same per-stream independence trick sim/traces.py uses
    rng = random.Random(cfg.seed ^ zlib.crc32(cfg.name.encode()))
    types = [t for t, _ in cfg.task_mix]
    weights = [w for _, w in cfg.task_mix]
    sizes = tuple(cfg.lp_set_sizes)
    t = 0.0
    n = 0
    while limit is None or n < limit:
        rate = cfg.rate
        if cfg.burstiness > 0.0:
            phase = (t % cfg.burst_period) / cfg.burst_period
            if phase < cfg.burst_duty:
                rate *= 1.0 + cfg.burstiness
        t += rng.expovariate(rate)
        task_type = types[0] if len(types) == 1 \
            else rng.choices(types, weights)[0]
        device = rng.randrange(cfg.n_devices)
        if rng.random() < cfg.lp_fraction:
            yield StreamArrival(
                t=t, device=device, priority=Priority.LOW,
                n_tasks=rng.choice(sizes), task_type=task_type,
                rel_deadline=cfg.lp_rel_deadline)
        else:
            yield StreamArrival(
                t=t, device=device, priority=Priority.HIGH,
                task_type=task_type, rel_deadline=cfg.hp_rel_deadline)
        n += 1
