"""Victim selection shared by the preemption mechanism and the baselines.

Every discipline that preempts — the paper's scheduler (§4) and the
workstealer baselines (§8 "rash" processor sharing) — ranks candidate
victims by the same two policies:

* ``farthest_deadline``  the paper's rule: evict the conflicting LP task
                         whose deadline is farthest away (it has the most
                         slack to be reallocated elsewhere).
* ``weakest_set``        the §8 future-work proposal: prefer the victim
                         whose request set is least likely to complete
                         anyway (fewest healthy siblings), tie-break by
                         farthest deadline.

Two equivalent forms live here so the scalar disciplines and the
vectorized preemption plane provably agree:

* :func:`victim_sort_key` / :func:`select_victim` — the scalar rule; a
  smaller key is a more preferred victim, and ``min()`` keeps the FIRST
  minimum in iteration order (dict insertion order for the calendars, the
  running-dict order for the workstealers).
* :func:`rank_victims` — the one-pass vectorized equivalent over stacked
  candidate columns.  ``np.argmin`` also returns the first minimum, so as
  long as rows are stored in the same iteration order the two forms pick
  bit-identical victims (tests/test_preemption_plane.py fuzzes this).
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np

from .task import Task, TaskState

#: Task states that count as "on track" for a request set's health (the
#: numerator of ``weakest_set``'s set-health fraction).
GOOD_STATES = (TaskState.COMPLETED, TaskState.ALLOCATED, TaskState.RUNNING)


def plan_shrink(victim: Task, profile, hp_t1: float, hp_t2: float,
                now: float, eps: float = 1e-9) -> Optional[float]:
    """Degrade-instead-of-evict (DESIGN.md §17): the new reservation end if
    this conflict victim can be shrunk in place, else None (fall back to
    eviction).

    A shrink downgrades the victim to the NEXT rung of its type's variant
    ladder at its CURRENT core count.  Ladder validation guarantees the
    rung's slot at the same cores is no longer than the previous rung's, so
    the downgraded footprint is a pure truncation of the existing
    reservation — it always fits, and applying it via the calendar's
    ``truncate`` keeps the preemption plane's LP mirror row in place (a
    re-reserve would append a new row behind the eviction loop's column
    views).  Viability rules:

    * the victim holds a future slot (``ALLOCATED``, start after ``now``) —
      a RUNNING victim's execution was sized by its admitted rung and
      cannot be resized mid-flight, so it falls back to eviction;
    * a deeper rung exists (ladder-free profiles never shrink);
    * the truncation strictly reduces the victim's footprint inside the
      contested HP window ``[hp_t1, hp_t2)`` — equal-length rungs (the
      ladder allows non-strict monotonicity) shrink nothing and must not
      stall the eviction loop.

    What this does NOT guarantee: that the freed tail alone makes the HP
    window fit — the loop re-checks and keeps selecting victims, so a
    shrunk victim may still be evicted later in the same admission.
    """
    if victim.state is not TaskState.ALLOCATED or victim.t_start <= now + eps:
        return None
    nxt = victim.variant + 1
    if nxt >= profile.n_variants:
        return None
    rung = profile.variant_profile(nxt)
    new_end = victim.t_start + rung.lp_slot_time(victim.cores)
    if new_end >= min(victim.t_end, hp_t2) - eps:
        return None                     # no strict footprint reduction
    if new_end > victim.deadline:
        return None                     # defensive; t_end <= deadline anyway
    return new_end


def victim_sort_key(
    task: Task, policy: str,
    set_health: Optional[Callable[[Task], float]] = None,
) -> tuple:
    """Scalar victim key: smaller = preferred victim (used with min())."""
    if policy == "weakest_set":
        health = set_health(task) if set_health is not None else 1.0
        return (health, -task.deadline)
    return (-task.deadline,)


def select_victim(
    tasks: Iterable[Task], policy: str = "farthest_deadline",
    set_health: Optional[Callable[[Task], float]] = None,
) -> Task:
    """Most-preferred victim; ties keep the FIRST candidate in iteration
    order (``min()`` semantics — the contract the vectorized ranking
    reproduces)."""
    return min(tasks, key=lambda t: victim_sort_key(t, policy, set_health))


def rank_victims(
    mask: np.ndarray, deadlines: np.ndarray,
    healths: Optional[np.ndarray] = None,
) -> int:
    """One-pass vectorized victim ranking over stacked candidate columns.

    ``mask`` selects the live conflicting rows (must be non-empty);
    ``deadlines`` is the per-row deadline column; ``healths`` the per-row
    set-health column for ``weakest_set`` (None = ``farthest_deadline``).
    Returns the row index of the victim, with exactly ``min()``'s
    first-tie semantics: among the healthiest-tie rows (if any), the
    farthest deadline wins, and remaining ties go to the LOWEST row index
    (np.argmin returns the first minimum).
    """
    key = np.where(mask, -deadlines, np.inf)
    if healths is not None:
        h = np.where(mask, healths, np.inf)
        key = np.where(h == h.min(), key, np.inf)
    return int(np.argmin(key))
