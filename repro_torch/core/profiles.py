"""Workload profiles: per-(task type x core configuration) resource demands.

The paper derives every task's resource requirement from offline benchmarks
of each (task type x core configuration) and pads the reserved slots with the
benchmark std-dev (§3, §5).  The seed reproduction collapsed that table to
three global constants (``t_hp`` / ``t_lp_2core`` / ``t_lp_4core`` on
``NetworkConfig``), which froze every scenario into the paper's single
waste-classification model.  This module restores the table:

* :class:`TaskProfile` — one task type's benchmarked demands: stage-2 (HP)
  exec mean + slot padding, per-core-configuration stage-3 (LP) exec means +
  paddings, input/output transfer sizes, and optional per-type deadlines.
* :class:`WorkloadSpec` — a named mapping of task *types* to profiles plus
  arrival mix weights, with constructors from the paper's constants
  (``from_paper_constants`` — the default, bit-for-bit identical to the seed
  behaviour) and from a measured/analytic serving cost model
  (``from_cost_model`` — how ``serving/cost_model.py`` step times reach the
  scheduler).
* a small registry (``register_workload`` / ``get_workload``) so scenario
  configs can name a workload the way they name traces and policies.

Everything downstream (scheduler, policies, sim, serving engine) asks
``NetworkConfig.profile(task_type)`` for durations instead of reading the
three globals; ``task_type=None`` resolves to the spec's default profile, so
the paper's single-model world needs no annotations anywhere.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional

#: The default task type: the paper's waste-classification pipeline.
PAPER_TYPE = "paper"


@dataclass(frozen=True)
class VariantSpec:
    """One degraded rung of a task type's variant ladder (DESIGN.md §17).

    A rung swaps the model for a cheaper variant of itself: lower benchmark
    accuracy, faster per-core-configuration exec stats, and (optionally)
    smaller transfer sizes.  Rung costs must be monotone non-increasing down
    the ladder — enforced by :class:`TaskProfile` at construction — so every
    skip-hint lower bound that holds for a rung also holds for the rungs
    below it.  ``input_bytes``/``output_bytes`` of ``None`` inherit the base
    profile's sizes.
    """

    accuracy: float
    lp_exec: Mapping[int, float]         # cores -> stage-3 exec mean, seconds
    lp_pad: Mapping[int, float]          # cores -> stage-3 slot padding
    input_bytes: Optional[int] = None    # None -> inherit the base profile
    output_bytes: Optional[int] = None   # None -> inherit the base profile


@dataclass(frozen=True, eq=False)
class TaskProfile:
    """Offline-benchmarked resource demands for one task type.

    ``lp_exec`` / ``lp_pad`` map a core configuration (the paper's 2-/4-core
    horizontal split; the TPU adaptation's model-parallel degree) to the
    benchmarked stage-3 execution mean and its slot padding (std-dev).
    ``input_bytes`` sizes the offload input transfer; ``output_bytes`` the
    completion state-update message.  ``lp_deadline`` optionally overrides
    the workload-level relative deadline for this type's LP sets (None =
    use the scenario's frame period), giving mixed workloads per-model
    deadlines.
    """

    name: str
    hp_exec: float                       # stage-2 exec mean (1 core), seconds
    hp_pad: float                        # HP slot padding (benchmark std-dev)
    lp_exec: Mapping[int, float]         # cores -> stage-3 exec mean, seconds
    lp_pad: Mapping[int, float]          # cores -> stage-3 slot padding
    input_bytes: int = 21500             # offload input transfer size
    output_bytes: int = 550              # completion state-update size
    hp_deadline_slack: float = 0.45      # HP deadline beyond detect+proc
    lp_deadline: Optional[float] = None  # per-type relative LP deadline
    #: Benchmarked model accuracy in (0, 1] — weights the oracle's goodput
    #: tiebreak and the quality report's accuracy-weighted goodput metric.
    #: The paper's single-model world keeps the neutral 1.0.
    accuracy: float = 1.0
    #: Degradation ladder (DESIGN.md §17): ordered cheaper rungs BELOW this
    #: profile.  This profile itself is variant 0, so an empty tuple (the
    #: default) is the ladder-free world — bit-identical to every committed
    #: golden.  Rung ``i`` resolves through :meth:`variant_profile` to a
    #: derived profile named ``"{name}@{i}"``.
    variants: tuple[VariantSpec, ...] = ()

    def __post_init__(self) -> None:
        if not self.lp_exec:
            raise ValueError(
                f"profile {self.name!r} declares no LP core configurations"
            )
        if set(self.lp_pad) != set(self.lp_exec):
            raise ValueError(
                f"profile {self.name!r}: lp_pad core configs "
                f"{sorted(self.lp_pad)} != lp_exec core configs "
                f"{sorted(self.lp_exec)}"
            )
        object.__setattr__(self, "lp_exec",
                           dict(sorted(self.lp_exec.items())))
        object.__setattr__(self, "lp_pad",
                           {c: self.lp_pad[c] for c in self.lp_exec})
        object.__setattr__(self, "variants", tuple(self.variants))
        object.__setattr__(self, "_ladder", self._build_ladder())

    def _build_ladder(self) -> tuple["TaskProfile", ...]:
        """Derive one full :class:`TaskProfile` per rung, validating that
        accuracy and cost are monotone non-increasing down the ladder and
        that rungs keep the base core-configuration set (so an in-place
        degrade-shrink can always re-use the victim's core count)."""
        derived: list[TaskProfile] = []
        prev: TaskProfile = self
        for i, v in enumerate(self.variants, start=1):
            if not (0.0 < v.accuracy <= 1.0):
                raise ValueError(
                    f"profile {self.name!r} variant {i}: accuracy "
                    f"{v.accuracy} outside (0, 1]"
                )
            if v.accuracy > prev.accuracy:
                raise ValueError(
                    f"profile {self.name!r} variant {i}: accuracy "
                    f"{v.accuracy} exceeds the rung above ({prev.accuracy}) "
                    "— ladders must be monotone non-increasing"
                )
            if set(v.lp_exec) != set(self.lp_exec):
                raise ValueError(
                    f"profile {self.name!r} variant {i}: core configs "
                    f"{sorted(v.lp_exec)} != base configs "
                    f"{sorted(self.lp_exec)} — rungs must benchmark the "
                    "base profile's core configurations"
                )
            vp = TaskProfile(
                name=f"{self.name}@{i}",
                hp_exec=self.hp_exec,
                hp_pad=self.hp_pad,
                lp_exec=dict(v.lp_exec),
                lp_pad=dict(v.lp_pad),
                input_bytes=(self.input_bytes if v.input_bytes is None
                             else v.input_bytes),
                output_bytes=(self.output_bytes if v.output_bytes is None
                              else v.output_bytes),
                hp_deadline_slack=self.hp_deadline_slack,
                lp_deadline=self.lp_deadline,
                accuracy=v.accuracy,
            )
            for cores in vp.core_options:
                if vp.lp_slot_time(cores) > prev.lp_slot_time(cores):
                    raise ValueError(
                        f"profile {self.name!r} variant {i}: slot time at "
                        f"{cores} cores ({vp.lp_slot_time(cores):.3f}s) "
                        f"exceeds the rung above "
                        f"({prev.lp_slot_time(cores):.3f}s) — ladders must "
                        "be monotone non-increasing"
                    )
            if vp.input_bytes > self.input_bytes:
                raise ValueError(
                    f"profile {self.name!r} variant {i}: input_bytes "
                    f"{vp.input_bytes} exceeds the base {self.input_bytes} "
                    "— a degraded transfer may not grow"
                )
            derived.append(vp)
            prev = vp
        return tuple(derived)

    @property
    def n_variants(self) -> int:
        """Ladder depth including variant 0 (this profile itself)."""
        return 1 + len(self.variants)

    @property
    def ladder(self) -> tuple["TaskProfile", ...]:
        """The full ladder, variant 0 (self) first."""
        return (self,) + self._ladder

    def variant_profile(self, variant: int = 0) -> "TaskProfile":
        """The profile for one ladder rung.  Variant 0 is this profile;
        indices past the bottom clamp to the last rung.  Ladder-free
        profiles answer every index with themselves — which is exactly the
        legacy one-bit ``Task.degraded`` semantics (same exec stats, the
        upgrade pass pinned off)."""
        if variant <= 0 or not self._ladder:
            return self
        return self._ladder[min(variant, len(self._ladder)) - 1]

    @property
    def core_options(self) -> tuple[int, ...]:
        """Viable core configurations, minimum first (§3.2)."""
        return tuple(self.lp_exec)

    def lp_proc_time(self, cores: int) -> float:
        try:
            return self.lp_exec[cores]
        except KeyError:
            raise ValueError(
                f"profile {self.name!r}: unsupported LP core configuration "
                f"{cores}; benchmarked configs: {list(self.lp_exec)}"
            ) from None

    def lp_slot_time(self, cores: int) -> float:
        return self.lp_proc_time(cores) + self.lp_pad[cores]

    @property
    def hp_slot_time(self) -> float:
        return self.hp_exec + self.hp_pad

    def hp_deadline(self, request_time: float) -> float:
        return request_time + self.hp_exec + self.hp_deadline_slack

    @property
    def min_lp_slot_time(self) -> float:
        """Minimum-configuration slot duration (skip-hint lower bounds)."""
        return self.lp_slot_time(self.core_options[0])


@dataclass
class WorkloadSpec:
    """A named set of task-type profiles plus their arrival mix.

    ``mix`` holds relative arrival weights per task type (only meaningful
    for mixed workloads; single-profile specs never consult it).  The
    ``default_type`` profile answers every un-annotated task
    (``task_type=None``), which is how the paper's single-model scenarios
    run unchanged.
    """

    name: str
    profiles: dict[str, TaskProfile] = field(default_factory=dict)
    default_type: str = PAPER_TYPE
    mix: dict[str, float] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if not self.profiles:
            raise ValueError(f"workload {self.name!r} has no profiles")
        if self.default_type not in self.profiles:
            raise ValueError(
                f"workload {self.name!r}: default_type "
                f"{self.default_type!r} not among profiles "
                f"{sorted(self.profiles)}"
            )
        for t in self.mix:
            if t not in self.profiles:
                raise ValueError(
                    f"workload {self.name!r}: mix weight for unknown task "
                    f"type {t!r}; profiles: {sorted(self.profiles)}"
                )

    # ------------------------------------------------------------------ #
    def profile(self, task_type: Optional[str] = None) -> TaskProfile:
        """The profile for ``task_type`` (None -> the default profile)."""
        if task_type is None:
            task_type = self.default_type
        try:
            return self.profiles[task_type]
        except KeyError:
            raise ValueError(
                f"workload {self.name!r}: unknown task type {task_type!r}; "
                f"available: {', '.join(sorted(self.profiles))}"
            ) from None

    @property
    def task_types(self) -> tuple[str, ...]:
        return tuple(sorted(self.profiles))

    @property
    def is_mixed(self) -> bool:
        return len(self.profiles) > 1

    @property
    def min_lp_slot_time(self) -> float:
        """Network-wide minimum-config slot duration lower bound (valid for
        every task type AND every ladder rung — degraded variants only ever
        get cheaper; used by the scheduler's skip-hint pruning)."""
        return min(v.min_lp_slot_time
                   for p in self.profiles.values() for v in p.ladder)

    @property
    def has_ladder(self) -> bool:
        """True when any profile carries degraded rungs (DESIGN.md §17)."""
        return any(p.n_variants > 1 for p in self.profiles.values())

    @property
    def max_input_bytes_type(self) -> str:
        """Task type with the largest offload input (worst-case transfer —
        the conservative bound for round-level time-point skipping)."""
        return max(self.profiles,
                   key=lambda t: (self.profiles[t].input_bytes, t))

    def mix_weights(self) -> tuple[tuple[str, float], ...]:
        """(task_type, probability) pairs, normalised, deterministic order.
        No weights at all -> uniform.  A partial mix must leave residual
        probability (< 1 total) for the omitted types, which share it
        equally; a partial mix that already spends >= 1 raises, so an
        omitted type can never be silently dropped from the arrival
        stream."""
        types = self.task_types
        if not self.mix:
            w = {t: 1.0 for t in types}
        else:
            missing = [t for t in types if t not in self.mix]
            w = {t: float(self.mix[t]) for t in types if t in self.mix}
            if any(v < 0.0 for v in w.values()):
                raise ValueError(
                    f"workload {self.name!r}: negative mix weight"
                )
            explicit = sum(w.values())
            if missing:
                residual = 1.0 - explicit
                if residual <= 0.0:
                    raise ValueError(
                        f"workload {self.name!r}: mix spends {explicit} "
                        f"leaving no residual probability for unweighted "
                        f"task type(s) {missing}; weight them explicitly "
                        "or keep the explicit weights below 1.0"
                    )
                for t in missing:
                    w[t] = residual / len(missing)
            elif explicit <= 0.0:
                raise ValueError(f"workload {self.name!r}: mix sums to zero")
        total = sum(w.values())
        return tuple((t, w[t] / total) for t in types)

    def with_profile(self, profile: TaskProfile,
                     weight: float = 1.0) -> "WorkloadSpec":
        """A new spec with ``profile`` added (or replaced) under its name."""
        profiles = dict(self.profiles)
        profiles[profile.name] = profile
        mix = dict(self.mix) if self.mix else {
            t: w for t, w in self.mix_weights()
        }
        mix[profile.name] = weight
        return WorkloadSpec(self.name, profiles, self.default_type, mix)

    # ------------------------------------------------------------------ #
    # Constructors                                                       #
    # ------------------------------------------------------------------ #
    @classmethod
    def from_paper_constants(
        cls,
        *,
        t_hp: float = 0.980,
        hp_pad_s: float = 0.050,
        t_lp_2core: float = 16.862,
        t_lp_4core: float = 11.611,
        lp_pad_s: float = 0.400,
        input_bytes: int = 21500,
        output_bytes: int = 550,
        hp_deadline_slack: float = 0.45,
        name: str = PAPER_TYPE,
    ) -> "WorkloadSpec":
        """The paper's single-model workload (§5 benchmark table).  Built
        from the same constants ``NetworkConfig`` carries, so the default
        spec reproduces the seed's timing model bit-for-bit."""
        profile = TaskProfile(
            name=name,
            hp_exec=t_hp,
            hp_pad=hp_pad_s,
            lp_exec={2: t_lp_2core, 4: t_lp_4core},
            lp_pad={2: lp_pad_s, 4: lp_pad_s},
            input_bytes=input_bytes,
            output_bytes=output_bytes,
            hp_deadline_slack=hp_deadline_slack,
        )
        return cls(name=name, profiles={name: profile}, default_type=name)

    @classmethod
    def from_cost_model(
        cls,
        cost,                                   # serving.cost_model.CostModel
        *,
        lp_tokens: int,
        name: str = "serve",
        degrees: Optional[tuple[int, ...]] = None,
        input_bytes: int = 21500,
        output_bytes: int = 550,
        hp_deadline_slack: Optional[float] = None,
        lp_deadline: Optional[float] = None,
    ) -> "WorkloadSpec":
        """Build a single-type spec from a measured or analytic serving cost
        model (duck-typed: anything with ``prefill``/``decode`` per-degree
        :class:`PhaseCost` maps works).  The LP task is a ``lp_tokens``-token
        decode; per-degree slot padding is that degree's measured std-dev
        scaled by the token count — the paper's per-configuration padding
        rather than the seed's single global pad."""
        degs = tuple(degrees) if degrees is not None else tuple(sorted(cost.decode))
        if not degs:
            raise ValueError("cost model exposes no decode degrees")
        missing = [d for d in degs if d not in cost.decode]
        if missing:
            raise ValueError(
                f"cost model has no decode degree(s) {missing}; measured "
                f"degrees: {sorted(cost.decode)}"
            )
        prefill = cost.prefill[min(cost.prefill)]
        profile = TaskProfile(
            name=name,
            hp_exec=prefill.mean_s,
            hp_pad=prefill.std_s,
            lp_exec={d: cost.decode[d].mean_s * lp_tokens for d in degs},
            lp_pad={d: cost.decode[d].std_s * lp_tokens for d in degs},
            input_bytes=input_bytes,
            output_bytes=output_bytes,
            hp_deadline_slack=(prefill.mean_s * 0.5
                               if hp_deadline_slack is None
                               else hp_deadline_slack),
            lp_deadline=lp_deadline,
        )
        return cls(name=name, profiles={name: profile}, default_type=name)


# ====================================================================== #
# Registry                                                               #
# ====================================================================== #
_WORKLOADS: dict[str, Callable[[], WorkloadSpec]] = {}


def register_workload(name: str, factory: Callable[[], WorkloadSpec]) -> None:
    if name in _WORKLOADS:
        raise ValueError(f"workload {name!r} already registered")
    _WORKLOADS[name] = factory


def registered_workloads() -> tuple[str, ...]:
    return tuple(sorted(_WORKLOADS))


def get_workload(name: str) -> WorkloadSpec:
    try:
        factory = _WORKLOADS[name]
    except KeyError:
        raise ValueError(
            f"unknown workload {name!r}; registered workloads: "
            + ", ".join(registered_workloads())
        ) from None
    return factory()


def validate_workload_name(name: str) -> None:
    if name not in _WORKLOADS:
        raise ValueError(
            f"unknown workload {name!r}; registered workloads: "
            + ", ".join(registered_workloads())
        )


# ---------------------------------------------------------------------- #
# Built-in workloads                                                     #
# ---------------------------------------------------------------------- #
def _mixed_edge() -> WorkloadSpec:
    """A heterogeneous edge fleet: the paper's waste-classification model
    interleaved with a lightweight mobile classifier and a heavy detection
    transformer, each with its own benchmark table, transfer sizes and LP
    deadline (the DNN-partitioning setting in PAPERS.md: per-model profiles,
    not one global constant)."""
    paper = get_workload(PAPER_TYPE).profile()
    mobile = TaskProfile(
        name="mobile_lite",
        hp_exec=0.310, hp_pad=0.020,
        # light classifier: near-linear 2->4 scaling, tiny transfers
        lp_exec={2: 5.730, 4: 3.105}, lp_pad={2: 0.150, 4: 0.150},
        input_bytes=9200, output_bytes=550,
        hp_deadline_slack=0.30,
        lp_deadline=12.5,                 # tighter than the 18.86 s frame
        accuracy=0.81,                    # light model: cheaper but weaker
    )
    detr = TaskProfile(
        name="detr_heavy",
        hp_exec=1.450, hp_pad=0.080,
        # heavy detection head: poor 2->4 scaling, large feature-map input
        lp_exec={2: 26.410, 4: 19.884}, lp_pad={2: 0.600, 4: 0.600},
        input_bytes=64500, output_bytes=1100,
        hp_deadline_slack=0.70,
        lp_deadline=42.0,                 # looser: batch-analytics tier
        accuracy=0.94,                    # heavy head: strongest model
    )
    return WorkloadSpec(
        name="mixed_edge",
        profiles={p.name: p for p in (paper, mobile, detr)},
        default_type=PAPER_TYPE,
        mix={PAPER_TYPE: 0.5, "mobile_lite": 0.3, "detr_heavy": 0.2},
    )


def _paper_ladder() -> WorkloadSpec:
    """The paper's pipeline with a two-rung degradation ladder (DESIGN.md
    §17): variant 0 is the published benchmark table bit-for-bit; the rungs
    below are a distilled and a heavily-quantized variant of the same model
    (faster, smaller inputs, lower accuracy — the imprecise-computation
    setting of Yao et al. in PAPERS.md).  The scenario of choice for the
    ``degrade_storm`` family and the quality report's ladder column."""
    from dataclasses import replace

    base = WorkloadSpec.from_paper_constants().profile()
    laddered = replace(base, variants=(
        # distilled: ~55% of the base exec, keeps most of the accuracy
        VariantSpec(accuracy=0.92,
                    lp_exec={2: 9.120, 4: 6.270},
                    lp_pad={2: 0.250, 4: 0.250},
                    input_bytes=12800),
        # int8-quantized: ~25% of the base exec, accuracy floor
        VariantSpec(accuracy=0.78,
                    lp_exec={2: 4.310, 4: 2.985},
                    lp_pad={2: 0.150, 4: 0.150},
                    input_bytes=6400),
    ))
    return WorkloadSpec(name="paper_ladder",
                        profiles={laddered.name: laddered},
                        default_type=PAPER_TYPE)


def _mixed_edge_ladder() -> WorkloadSpec:
    """``mixed_edge`` with ladders on the two heavy types: the paper model
    gets the ``paper_ladder`` rungs, the detection transformer a single
    pruned rung; the already-light mobile classifier stays single-variant
    (mixed ladder depths exercise the clamp-to-bottom path)."""
    from dataclasses import replace

    spec = _mixed_edge()
    paper = _paper_ladder().profile()
    detr = replace(spec.profiles["detr_heavy"], variants=(
        VariantSpec(accuracy=0.87,
                    lp_exec={2: 14.820, 4: 10.450},
                    lp_pad={2: 0.350, 4: 0.350},
                    input_bytes=32200),
    ))
    profiles = dict(spec.profiles)
    profiles[paper.name] = paper
    profiles[detr.name] = detr
    return WorkloadSpec(name="mixed_edge_ladder", profiles=profiles,
                        default_type=spec.default_type, mix=dict(spec.mix))


register_workload(PAPER_TYPE, WorkloadSpec.from_paper_constants)
register_workload("mixed_edge", _mixed_edge)
register_workload("paper_ladder", _paper_ladder)
register_workload("mixed_edge_ladder", _mixed_edge_ladder)
