"""Per-(phase, parallel-degree) step-time cost model.

Port of the JAX package's ``serving/cost_model.py``.  The paper derives task
resource requirements from offline benchmarks of each (task type x core
configuration) and pads slots with the benchmark std-dev (§3, §5).  Here
step times per model-parallel degree come either from

  * ``measure``: real timed executions of the prefill and serve steps on
    the chosen device, or
  * ``analytic``: roofline-derived per-degree estimates,

and the scheduler pads with the measured std-dev.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..models import model as M
from ..models.config import ModelConfig
from ..training.steps import make_prefill_step, make_serve_step


@dataclass
class PhaseCost:
    mean_s: float
    std_s: float

    @property
    def padded(self) -> float:
        return self.mean_s + self.std_s


@dataclass
class CostModel:
    """Step times per model-parallel degree (the 2-core/4-core analogue)."""

    prefill: dict[int, PhaseCost] = field(default_factory=dict)
    decode: dict[int, PhaseCost] = field(default_factory=dict)

    def _cost(self, table: dict[int, PhaseCost], degree: int,
              phase: str) -> PhaseCost:
        try:
            return table[degree]
        except KeyError:
            raise ValueError(
                f"no {phase} cost measured for parallel degree {degree}; "
                f"available degrees: {sorted(table) or 'none'}"
            ) from None

    def lp_exec_time(self, degree: int, n_tokens: int) -> float:
        return self._cost(self.decode, degree, "decode").mean_s * n_tokens

    def lp_slot_time(self, degree: int, n_tokens: int) -> float:
        d = self._cost(self.decode, degree, "decode")
        return (d.mean_s + d.std_s) * n_tokens

    def hp_exec_time(self, degree: int = 1) -> float:
        return self._cost(self.prefill, degree, "prefill").mean_s

    def hp_slot_time(self, degree: int = 1) -> float:
        return self._cost(self.prefill, degree, "prefill").padded

    @property
    def degrees(self) -> tuple[int, ...]:
        return tuple(sorted(self.decode))


def measure_cost_model(
    cfg: ModelConfig,
    *,
    batch: int = 1,
    prompt_len: int = 32,
    cache_len: int = 128,
    degrees: tuple[int, ...] = (2, 4),
    reps: int = 5,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> CostModel:
    """Time the real prefill and serve steps on ``device``.

    Both steps run once untimed first (on a card that first call builds
    and loads the kernels).  Each timed call is fenced by
    ``torch.cuda.synchronize`` on CUDA, so a rep is the step's full
    latency, not its enqueue.  Model-parallel degree on one device is
    emulated by its compute split: the measured time anchors degree 2 and
    every doubling multiplies it by the paper's 2-core:4-core ratio of
    16.862:2*11.611."""
    degrees = tuple(degrees)
    if not degrees:
        raise ValueError("degrees must be a non-empty sequence")
    bad = [d for d in degrees if not isinstance(d, int) or d < 1]
    if bad:
        raise ValueError(
            f"invalid parallel degree(s) {bad}: degrees must be positive "
            "integers"
        )
    if len(set(degrees)) != len(degrees):
        raise ValueError(f"duplicate parallel degrees in {degrees}")
    dev = resolve_device(device)
    params = M.init_params(cfg, seed, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=dev)
    batch_d = {"tokens": tokens}

    pre = make_prefill_step(cfg, cache_len, device=dev)
    srv = make_serve_step(cfg, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    nxt, caches = pre(params, batch_d)
    srv(params, caches, nxt[:, None], prompt_len)
    sync()

    def timeit(fn, *a):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*a)
            sync()
            ts.append(time.perf_counter() - t0)
        return float(np.mean(ts)), float(np.std(ts))

    p_mean, p_std = timeit(pre, params, batch_d)
    d_mean, d_std = timeit(srv, params, caches, nxt[:, None], prompt_len)

    # paper-calibrated parallel efficiency: every doubling of the degree
    # multiplies the step time by t(4) / t(2) = 11.611 / 16.862; the
    # measured single-device time anchors degree 2 (the paper's minimum
    # horizontal split), other degrees follow the curve.
    eff_ratio = 11.611 / 16.862
    cm = CostModel()
    cm.prefill[1] = PhaseCost(p_mean, p_std)
    for deg in sorted(degrees):
        scale = eff_ratio ** math.log2(deg / 2.0)
        cm.decode[deg] = PhaseCost(d_mean * scale, d_std * scale)
    return cm


def analytic_cost_model(
    roofline_terms: dict[int, float],
    *,
    prefill_s: float,
    std_frac: float = 0.05,
) -> CostModel:
    """Build a CostModel from roofline-derived per-degree decode times."""
    cm = CostModel()
    cm.prefill[1] = PhaseCost(prefill_s, prefill_s * std_frac)
    for deg, t in roofline_terms.items():
        cm.decode[deg] = PhaseCost(t, t * std_frac)
    return cm
