"""Terminal-accounting rule: every terminal ``TaskState`` assignment must
happen inside a designated settle helper.

The Metrics partition invariant (tests/test_accounting_invariants.py:
every generated task lands in exactly one terminal summary bucket) can
only hold if every transition into a terminal state flows through a code
path that bumps — or feeds a ``Decision``/result list that downstream
bumps — the matching partition counter.  PR 6 flushed five silent leaks
out of exactly this shape: a ``task.state = TaskState.FAILED`` on a path
no counter ever saw.

``SETTLE_HELPERS`` is the audited registry: the functions whose
terminal transitions the accounting-invariant suite certifies end-to-end.
A NEW terminal assignment anywhere else is a finding — either route it
through a helper, extend the registry (and the accounting suite) in the
same change, or pragma the line with a justification.

Deliberately NOT certified: indirection (``setattr(task, "state", ...)``,
``state`` aliased through a variable) — the accounting-invariant suite
remains the runtime backstop; and non-terminal states (PENDING /
ALLOCATED / RUNNING / PREEMPTED transitions carry no partition counter).
"""
from __future__ import annotations

import ast
from typing import Iterator, Mapping, Optional

from ..engine import Finding, Module, Rule

TERMINAL_STATES = frozenset({"COMPLETED", "FAILED", "VIOLATED"})

#: relpath -> function qualnames audited as settle paths by
#: tests/test_accounting_invariants.py (directly bumping a partition
#: counter, or filling the Decision/result failure lists that
#: PolicyDispatcher._account_lp / submit_hp account downstream).
SETTLE_HELPERS: dict[str, frozenset[str]] = {
    "repro_torch/core/policy.py": frozenset({
        "PolicyDispatcher.submit_hp",
        "PolicyDispatcher._account_lp",
        "PolicyDispatcher._violate",
        "PolicyDispatcher.task_finished",
        "CalendarPolicy.fail_device",
        "EDFOnlyPolicy.decide_lp_batch",
        "EDFOnlyPolicy.reallocate",
    }),
    "repro_torch/core/scheduler.py": frozenset({
        "PreemptionAwareScheduler._reallocate_victims",
        "PreemptionAwareScheduler.allocate_low_priority",
        "PreemptionAwareScheduler.allocate_low_priority_batch",
        "PreemptionAwareScheduler.reallocate",
        "PreemptionAwareScheduler.settle_hp_orphans",
    }),
    "repro_torch/core/workstealer.py": frozenset({
        "WorkstealingPolicy._kill_if_late",
        "WorkstealingPolicy._kick",
        "WorkstealingPolicy.finalize",
    }),
}


def _terminal_refs(node: ast.AST) -> Optional[str]:
    """First ``TaskState.<TERMINAL>`` reference inside an expression
    (covers conditional values like ``A if late else B``)."""
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Attribute) and sub.attr in TERMINAL_STATES
                and isinstance(sub.value, ast.Name)
                and sub.value.id == "TaskState"):
            return sub.attr
    return None


class TerminalStateRule(Rule):
    name = "terminal-state"
    description = (
        "terminal TaskState assignments outside the designated settle "
        "helpers (transitions the Metrics partition cannot have counted)"
    )

    def __init__(self,
                 settle: Optional[Mapping[str, frozenset[str]]] = None) -> None:
        self.settle = dict(SETTLE_HELPERS if settle is None else settle)

    def check(self, mod: Module) -> Iterator[Finding]:
        allowed = self.settle.get(mod.rel, frozenset())
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            if node.value is None:
                continue
            state = _terminal_refs(node.value)
            if state is None:
                continue
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Attribute) and t.attr == "state":
                    qual = mod.qualname(node.lineno)
                    if qual not in allowed:
                        where = qual or "<module>"
                        yield Finding(
                            self.name, mod.rel, node.lineno, node.col_offset,
                            f"terminal assignment TaskState.{state} in "
                            f"{where}, which is not a designated settle "
                            "helper — the Metrics partition cannot have "
                            "counted this transition; route it through a "
                            "settle helper or extend SETTLE_HELPERS plus "
                            "tests/test_accounting_invariants.py together",
                            qual)
