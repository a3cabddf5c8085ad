"""Determinism rules for the ``core/`` + ``sim/`` decision paths.

The golden replays, the placement-oracle differentials and the paired
perf gates all assume a scheduling decision is a pure function of
(scenario config, seed).  Three rule classes guard the classic leaks:

* ``determinism-wallclock`` — ANY wall-clock read (``time.time``,
  ``time.perf_counter``, ``datetime.now``, ...).  Telemetry timing is
  legitimate but must be *attested*: every existing site is baselined
  with a justification, so a new clock read cannot silently feed a
  decision.
* ``determinism-rng`` — unseeded generators (``np.random.default_rng()``
  / ``random.Random()`` with no seed) and the module-level global-state
  draws (``np.random.normal(...)``, ``random.shuffle(...)``,
  ``random.seed(...)``): cross-test global state even when seeded.
* ``determinism-set-iter`` — iterating a set in a ``for`` loop or
  comprehension.  CPython's set order is an implementation detail (value
  hashing for ints, randomized for strs); a decision loop over a set is
  ordered by accident.  Wrap in ``sorted(...)``.  The checker is
  syntactic + lightly flow-aware: it tracks locals whose latest lexical
  assignment is a set expression / set-annotated, ``self.<attr>`` sets
  annotated anywhere in the class, and locals aliasing an attribute name
  that is set-annotated anywhere in the module.

Deliberately NOT certified: set iteration reached through function
returns or cross-module attributes, dict-ordering assumptions, and
randomness threaded through injected generator objects (seeded by
construction elsewhere) — the same-seed replay suites remain the runtime
backstop.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional, Sequence

from ..engine import Finding, Module, Rule

DECISION_PATHS: tuple[str, ...] = ("repro_torch/core/", "repro_torch/sim/")

WALL_CLOCK = frozenset({
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns", "time.process_time",
    "time.process_time_ns", "time.localtime", "time.gmtime", "time.ctime",
    "time.asctime",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
})

NP_GLOBAL_DRAWS = frozenset({
    "beta", "binomial", "choice", "exponential", "gamma", "geometric",
    "lognormal", "normal", "permutation", "poisson", "rand", "randint",
    "randn", "random", "random_sample", "seed", "shuffle",
    "standard_normal", "uniform",
})

PY_GLOBAL_DRAWS = frozenset({
    "betavariate", "choice", "choices", "expovariate", "gauss",
    "getrandbits", "normalvariate", "randint", "random", "randrange",
    "sample", "seed", "shuffle", "triangular", "uniform",
})


class _DecisionPathRule(Rule):
    paths: tuple[str, ...] = DECISION_PATHS

    def __init__(self, paths: Optional[Sequence[str]] = None) -> None:
        if paths is not None:
            self.paths = tuple(paths)

    def applies_to(self, rel: str) -> bool:
        return rel.startswith(self.paths)


class WallClockRule(_DecisionPathRule):
    name = "determinism-wallclock"
    description = "wall-clock reads inside core/ and sim/ decision paths"

    def check(self, mod: Module) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            origin = mod.resolve(node.func)
            if origin in WALL_CLOCK:
                yield Finding(
                    self.name, mod.rel, node.lineno, node.col_offset,
                    f"wall-clock read {origin}() in a decision-path module "
                    "— thread simulated time through explicitly; timing "
                    "telemetry must be baselined with a justification "
                    "attesting it never feeds a decision",
                    mod.qualname(node.lineno))


class UnseededRngRule(_DecisionPathRule):
    name = "determinism-rng"
    description = ("unseeded or global-state RNG inside core/ and sim/ "
                   "decision paths")

    def check(self, mod: Module) -> Iterator[Finding]:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            origin = mod.resolve(node.func)
            if origin is None:
                continue
            msg = None
            if origin == "numpy.random.default_rng" and not node.args:
                msg = ("np.random.default_rng() without a seed — derive "
                       "the seed from the scenario config")
            elif origin == "random.Random" and not node.args:
                msg = ("random.Random() without a seed — derive the seed "
                       "from the scenario config")
            elif (origin.startswith("numpy.random.")
                  and origin.rsplit(".", 1)[1] in NP_GLOBAL_DRAWS):
                msg = (f"global-state numpy RNG call {origin}() — use a "
                       "seeded np.random.default_rng(...) Generator")
            elif (origin.startswith("random.")
                  and origin.count(".") == 1
                  and origin.rsplit(".", 1)[1] in PY_GLOBAL_DRAWS):
                msg = (f"global-state RNG call {origin}() — use a seeded "
                       "random.Random(...) instance")
            if msg:
                yield Finding(self.name, mod.rel, node.lineno,
                              node.col_offset, msg,
                              mod.qualname(node.lineno))


def _is_set_annotation(node: Optional[ast.AST]) -> bool:
    if isinstance(node, ast.Subscript):
        node = node.value
    return isinstance(node, ast.Name) and node.id in ("set", "Set", "frozenset")


def _is_set_expr(node: Optional[ast.AST]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in ("set", "frozenset")):
        return True
    if isinstance(node, ast.IfExp):
        return _is_set_expr(node.body) or _is_set_expr(node.orelse)
    return False


def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class SetIterRule(_DecisionPathRule):
    name = "determinism-set-iter"
    description = ("unordered set iteration inside core/ and sim/ "
                   "decision paths")

    MESSAGE = ("iteration over a set — CPython set order is an "
               "implementation detail, so any order-sensitive effect is "
               "ordered by accident; iterate sorted(...) (or pragma with "
               "a justification if provably order-independent)")

    def check(self, mod: Module) -> Iterator[Finding]:
        # Pass 1 (module-wide): attribute NAMES that are set-typed anywhere
        # (``self._dirty: set[int] = ...``) — used both for ``self.X``
        # iteration and for locals aliasing ``<expr>._dirty``.
        set_attrs: set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.AnnAssign):
                attr = _self_attr(node.target)
                if attr and _is_set_annotation(node.annotation):
                    set_attrs.add(attr)
            elif isinstance(node, ast.Assign):
                if _is_set_expr(node.value):
                    for t in node.targets:
                        attr = _self_attr(t)
                        if attr:
                            set_attrs.add(attr)

        funcs = [n for n in ast.walk(mod.tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for func in funcs:
            yield from self._check_function(mod, func, set_attrs)

    def _own_nodes(self, func: ast.AST) -> Iterator[ast.AST]:
        """Walk a function body without descending into nested defs
        (nested functions are visited as functions of their own)."""
        stack = list(ast.iter_child_nodes(func))
        while stack:
            node = stack.pop()
            yield node
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                stack.extend(ast.iter_child_nodes(node))

    def _check_function(self, mod: Module, func: ast.AST,
                        set_attrs: set[str]) -> Iterator[Finding]:
        # Lexically ordered local assignments: name -> [(lineno, is_set)].
        assigns: dict[str, list[tuple[int, bool]]] = {}

        def record(name: str, lineno: int, is_set: bool) -> None:
            assigns.setdefault(name, []).append((lineno, is_set))

        for node in self._own_nodes(func):
            if isinstance(node, ast.Assign):
                is_set = (_is_set_expr(node.value)
                          or (isinstance(node.value, ast.Attribute)
                              and node.value.attr in set_attrs))
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        record(t.id, node.lineno, is_set)
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                               ast.Name):
                record(node.target.id, node.lineno,
                       _is_set_annotation(node.annotation)
                       or _is_set_expr(node.value))
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                # loop targets rebind — treat as non-set
                for t in ast.walk(node.target):
                    if isinstance(t, ast.Name):
                        record(t.id, node.lineno, False)

        def latest_is_set(name: str, lineno: int) -> bool:
            best = None
            for ln, is_set in assigns.get(name, ()):
                if ln <= lineno and (best is None or ln >= best[0]):
                    best = (ln, is_set)
            return bool(best and best[1])

        def iter_is_set(expr: ast.AST, lineno: int) -> bool:
            if _is_set_expr(expr):
                return True
            if isinstance(expr, ast.Name):
                return latest_is_set(expr.id, lineno)
            attr = _self_attr(expr)
            if attr is not None:
                return attr in set_attrs
            return False

        for node in self._own_nodes(func):
            iters: list[ast.AST] = []
            if isinstance(node, (ast.For, ast.AsyncFor)):
                iters.append(node.iter)
            elif isinstance(node, (ast.ListComp, ast.DictComp,
                                   ast.GeneratorExp)):
                # SetComp is exempt by construction: its output is itself
                # an unordered set, so the source set's order cannot leak
                # (a list/dict/generator output preserves — and therefore
                # leaks — iteration order).
                iters.extend(gen.iter for gen in node.generators)
            for expr in iters:
                if iter_is_set(expr, expr.lineno):
                    yield Finding(self.name, mod.rel, expr.lineno,
                                  expr.col_offset, self.MESSAGE,
                                  mod.qualname(expr.lineno))
