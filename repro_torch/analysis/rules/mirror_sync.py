"""Mirror-sync rules: the calendar's derived planes (array skyline, probe
plane, ``_LPMirror``) stay exact only if every buffer mutation flows
through the calendar mutation API (reserve / release / truncate / gc) and
every mutation path raises the probe plane's dirty mark.

Two rules:

* ``mirror-sync`` — outside the owning module, no direct writes to the
  protected buffer attributes and no mutator calls on a skyline/mirror
  reached through them.  A reservation spliced straight into ``dev._sky``
  (or a cleared ``_dirty`` set) leaves the probe plane answering from a
  stale mirror — the bug class PR 4/5 could only catch by fuzz
  differentials.
* ``dirty-notify`` — inside the owning module, any method of a
  dirty-mark-wired class (one defining ``_touch``) that mutates the
  probe-mirrored buffers (``_sky`` / ``_t2s``) must call ``self._touch()``
  in its own body.  Helpers whose callers notify carry a line pragma with
  the justification.

What these deliberately do NOT certify: reads (any module may query), and
aliasing through locals (``sky = dev._sky; sky.add(...)`` evades the
receiver-chain scan — the fuzz differentials remain the backstop for
exotic flows).
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..engine import Finding, Module, Rule

#: Buffer/wiring attributes owned by core/calendar.py.
PROTECTED_ATTRS = frozenset({
    "_sky", "_lp", "_t2s", "_dirty", "_notify", "_expiry", "_expiry_sink",
})

#: Method names that mutate a skyline / mirror / set they are called on.
MUTATORS = frozenset({
    "add", "append", "clear", "compact", "discard", "extend", "gc",
    "insert", "pop", "remove", "truncate", "update",
})

OWNER = "repro_torch/core/calendar.py"


def _chain_has_protected(node: ast.AST) -> bool:
    """True if a Name/Attribute/Subscript chain traverses a protected attr."""
    while True:
        if isinstance(node, ast.Attribute):
            if node.attr in PROTECTED_ATTRS:
                return True
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        else:
            return False


class MirrorWriteRule(Rule):
    name = "mirror-sync"
    description = (
        "direct writes to skyline/probe-plane/_LPMirror buffers outside "
        "the calendar mutation API"
    )

    def __init__(self, owner: str = OWNER) -> None:
        self.owner = owner

    def applies_to(self, rel: str) -> bool:
        return rel != self.owner

    def check(self, mod: Module) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if _chain_has_protected(t):
                        yield Finding(
                            self.name, mod.rel, t.lineno, t.col_offset,
                            "direct write through a protected calendar "
                            "buffer attribute — mutate via the calendar "
                            "API (reserve/release/truncate/gc) so the "
                            "skyline, _LPMirror and probe plane stay in "
                            "sync", mod.qualname(t.lineno))
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    if _chain_has_protected(t):
                        yield Finding(
                            self.name, mod.rel, t.lineno, t.col_offset,
                            "delete through a protected calendar buffer "
                            "attribute — use the calendar mutation API",
                            mod.qualname(t.lineno))
            elif isinstance(node, ast.Call):
                func = node.func
                if (isinstance(func, ast.Attribute)
                        and func.attr in MUTATORS
                        and _chain_has_protected(func.value)):
                    yield Finding(
                        self.name, mod.rel, node.lineno, node.col_offset,
                        f"mutator call .{func.attr}() on a protected "
                        "calendar buffer — mutate via the calendar API "
                        "(reserve/release/truncate/gc), never the raw "
                        "skyline/mirror", mod.qualname(node.lineno))


def _is_self_attr(node: ast.AST, attr: str) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == attr
            and isinstance(node.value, ast.Name) and node.value.id == "self")


class DirtyNotifyRule(Rule):
    name = "dirty-notify"
    description = (
        "calendar mutation paths must raise the probe plane's dirty mark "
        "(self._touch()) in the mutating method's own body"
    )

    #: Probe-mirrored buffers: the plane re-reads these on a dirty mark.
    MIRRORED = ("_sky", "_t2s")
    #: self-methods that splice the mirrored buffers.
    SPLICERS = ("_t2s_insert", "_t2s_remove")

    def __init__(self, owner: str = OWNER) -> None:
        self.owner = owner

    def applies_to(self, rel: str) -> bool:
        return rel == self.owner

    def check(self, mod: Module) -> Iterator[Finding]:
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = [n for n in cls.body
                       if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
            if not any(m.name == "_touch" for m in methods):
                continue                      # not a dirty-mark-wired class
            for m in methods:
                if m.name in ("_touch", "__init__"):
                    continue
                mutates = touches = False
                for node in ast.walk(m):
                    if isinstance(node, ast.Call):
                        f = node.func
                        if _is_self_attr(f, "_touch"):
                            touches = True
                        elif (isinstance(f, ast.Attribute)
                              and f.attr in MUTATORS
                              and any(_is_self_attr(f.value, a)
                                      for a in self.MIRRORED)):
                            mutates = True
                        elif any(_is_self_attr(f, s) for s in self.SPLICERS):
                            mutates = True
                    elif isinstance(node, (ast.Assign, ast.AugAssign,
                                           ast.AnnAssign)):
                        targets = (node.targets if isinstance(node, ast.Assign)
                                   else [node.target])
                        for t in targets:
                            base = t.value if isinstance(t, ast.Subscript) else t
                            if any(_is_self_attr(base, a)
                                   for a in self.MIRRORED):
                                mutates = True
                if mutates and not touches:
                    yield Finding(
                        self.name, mod.rel, m.lineno, m.col_offset,
                        f"{cls.name}.{m.name} mutates a probe-mirrored "
                        "buffer (_sky/_t2s) without calling self._touch() "
                        "— the probe plane would keep answering from a "
                        "stale mirror; notify here, or pragma the def "
                        "line if every caller notifies",
                        f"{cls.name}.{m.name}")
