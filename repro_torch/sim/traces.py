"""Trace-file generation (paper §5, Table 4).

Each trace entry holds one value per device per frame:
  -1   no object detected
   0   high-priority task only
   1-4 high-priority task followed by an LP request of that many DNN tasks

The paper does not publish the exact distributions, so they are fitted to
Table 4's potential-task counts (see DESIGN.md §7):
  uniform     : P(v) = 1/6 for v in {-1, 0, 1, 2, 3, 4}
                -> E[LP] = 10/6 per entry = 8640 over 5184 entries (exact),
                   P(HP) = 5/6 -> 4320 (exact)
  weighted X  : family P(-1) = P(0) = 0.05, P(X) = b, P(other in 1..4) = c,
                with (b, c) solved per X so that E[LP per device-frame]
                matches Table 4 *exactly*:
                  X=1: b=0.4535, c=0.1488   (9296 potential LP)
                  X=2: b=0.5988, c=0.1004   (10372)
                  X=3: b=0.6045, c=0.0985   (12973)
                  X=4: b=0.4446, c=0.1518   (13941)
                All satisfy the paper's "devices will predominantly
                generate X tasks" (b >> c).

Beyond the paper (used by the large-N scenario suite, sim/scenarios.py):
  ratio_P     : HP:LP mix sweep.  P(-1) = 0.05; of the detected frames, a
                fraction P/100 spawns an LP set (sizes 1..4 uniform) and the
                rest stay HP-only:
                  P(0) = 0.95 * (1 - P/100),   P(k in 1..4) = 0.95 * P/400.
                ratio_0 is an HP-only stream, ratio_100 makes every detected
                frame spawn stage-3 work.
"""
from __future__ import annotations

from dataclasses import dataclass

import zlib

import numpy as np

VALUES = (-1, 0, 1, 2, 3, 4)

# (b, c) per weighted-X, fitted to Table 4 potential-LP counts with
# P(-1)=P(0)=0.05:  b + 3c = 0.9  and  b*X + c*(10-X) = table4_X / 5184.
_WEIGHTED_BC = {
    1: (0.4535, 0.14883),
    2: (0.5988, 0.10040),
    3: (0.6045, 0.09850),
    4: (0.4446, 0.15180),
}


@dataclass(frozen=True)
class TraceConfig:
    name: str
    n_frames: int = 1296
    n_devices: int = 4
    seed: int = 0

    def probabilities(self) -> np.ndarray:
        if self.name == "uniform":
            return np.full(6, 1.0 / 6.0)
        if self.name.startswith("weighted_"):
            x = int(self.name.split("_")[1])
            assert 1 <= x <= 4
            b, c = _WEIGHTED_BC[x]
            p = np.full(6, c)
            p[0] = p[1] = 0.05          # -1 and 0
            p[1 + x] = b
            p /= p.sum()                # exact normalisation
            return p
        if self.name.startswith("ratio_"):
            pct = float(self.name.split("_")[1])
            assert 0.0 <= pct <= 100.0
            f = pct / 100.0
            p = np.empty(6)
            p[0] = 0.05                 # -1: nothing detected
            p[1] = 0.95 * (1.0 - f)     # 0: HP only
            p[2:] = 0.95 * f / 4.0      # 1..4: HP + LP set
            p /= p.sum()
            return p
        raise ValueError(f"unknown trace: {self.name}")


#: Human-readable description of the accepted trace names (for errors).
TRACE_FAMILIES = "uniform, weighted_1..weighted_4, ratio_P (0 <= P <= 100)"


def validate_trace_name(name: str) -> None:
    """Raise an early ValueError naming the accepted families for an
    unknown trace string (instead of failing deep inside generation)."""
    try:
        TraceConfig(name).probabilities()
    except (ValueError, AssertionError, KeyError, IndexError):
        raise ValueError(
            f"unknown trace {name!r}; expected one of: {TRACE_FAMILIES}"
        ) from None


def generate_trace(cfg: TraceConfig) -> np.ndarray:
    """Return an int array of shape [n_frames, n_devices]."""
    # zlib.crc32, NOT hash(): str hash is PYTHONHASHSEED-randomised per
    # process, which silently made every scenario a different draw per run.
    name_salt = zlib.crc32(cfg.name.encode()) % (2 ** 16)
    rng = np.random.default_rng(cfg.seed + name_salt)
    p = cfg.probabilities()
    idx = rng.choice(6, size=(cfg.n_frames, cfg.n_devices), p=p)
    return np.asarray(VALUES, dtype=np.int64)[idx]


def generate_type_trace(cfg: TraceConfig, weights) -> np.ndarray:
    """Task-type assignment for a mixed workload: an object array of shape
    [n_frames, n_devices] of task-type names drawn from ``weights``
    ((type, probability) pairs — ``WorkloadSpec.mix_weights()``).

    Seeded independently of :func:`generate_trace` (distinct salt), so a
    workload's type stream never perturbs the value stream: the same
    (trace, seed) pair generates identical frame values whether the
    scenario runs the paper's single model or a mixed fleet.
    """
    types = [t for t, _ in weights]
    p = np.asarray([w for _, w in weights], dtype=float)
    if len(types) == 0 or p.sum() <= 0:
        raise ValueError("generate_type_trace: empty or zero-weight mix")
    p /= p.sum()
    name_salt = zlib.crc32(("types:" + cfg.name).encode()) % (2 ** 16)
    rng = np.random.default_rng(cfg.seed + name_salt)
    idx = rng.choice(len(types), size=(cfg.n_frames, cfg.n_devices), p=p)
    return np.asarray(types, dtype=object)[idx]


def potential_counts(trace: np.ndarray) -> dict[str, int]:
    """Reproduce Table 4: potential HP/LP task counts for a trace."""
    return {
        "potential_low_priority": int(trace[trace > 0].sum()),
        "potential_high_priority": int((trace >= 0).sum()),
        "frames": int(trace.shape[0]),
        "device_frames": int(trace.size),
    }
