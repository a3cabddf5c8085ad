"""repro_torch.analysis — the AST-based invariant lint plane ("replint")
of the port, retargeted at ``repro_torch/``.

The JAX package's lint plane (``src/repro/analysis``), with its engine,
pragma and baseline semantics and its rules, scoped to the port's paths.
It certifies statically the bug classes that the golden replays, fuzz
differentials and accounting-invariant suites catch at run time: a rule
engine walks every module's AST and reports invariant violations with
file:line precision.  Pure ``ast``: it imports neither torch nor jax.

Rule families:

* ``mirror-sync`` / ``dirty-notify`` — writes to skyline / probe-plane /
  ``_LPMirror`` buffers outside the calendar mutation API, and calendar
  mutation paths missing the dirty-mark notification.
* ``terminal-state`` — terminal ``TaskState`` assignments outside the
  designated settle helpers.
* ``determinism-wallclock`` / ``determinism-rng`` / ``determinism-set-iter``
  — wall-clock reads, unseeded RNG, and unordered set iteration inside the
  ``core/`` + ``sim/`` decision paths.
* ``torch-free-boundary`` — module-level torch or jax imports in the
  planes the port keeps torch-free (``core/``, ``sim/``, ``analysis/``,
  ``serving/stream.py``, the lazy ``serving/__init__.py``).

The JAX package's ``pallas-index`` has no counterpart: the port has no
Pallas (``rules/kernel_rules.py`` says why).

Suppression is explicit and line-scoped: ``# replint: disable=<rule>`` on
the flagged line, or an entry in the port's baseline file
(``repro_torch/analysis/baseline.json``) carrying a one-line
justification.  Run as ``python -m repro_torch.analysis [--gate]`` from
the repo root; the gate fails on any unbaselined finding and on stale
baseline entries.
"""
from .engine import (
    Finding,
    Module,
    Report,
    Rule,
    default_rules,
    finding_key,
    load_baseline,
    run_analysis,
)
from .rules.determinism import SetIterRule, UnseededRngRule, WallClockRule
from .rules.kernel_rules import TorchImportRule
from .rules.mirror_sync import DirtyNotifyRule, MirrorWriteRule
from .rules.terminal_state import SETTLE_HELPERS, TerminalStateRule

__all__ = [
    "Finding",
    "Module",
    "Report",
    "Rule",
    "default_rules",
    "finding_key",
    "load_baseline",
    "run_analysis",
    "MirrorWriteRule",
    "DirtyNotifyRule",
    "TerminalStateRule",
    "SETTLE_HELPERS",
    "WallClockRule",
    "UnseededRngRule",
    "SetIterRule",
    "TorchImportRule",
]
