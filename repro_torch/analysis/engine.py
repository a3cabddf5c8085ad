"""Rule engine: module loading, pragma/baseline semantics, deterministic
reports.

Design contract (tests/test_replint.py):

* a ``# replint: disable=<rule>[,<rule>...]`` pragma suppresses findings of
  the named rules on THAT physical line only (a finding's line is its AST
  node's ``lineno`` — multi-clause rules anchor findings where the pragma
  should go, e.g. the ``def`` line for method-granular rules);
* baseline keys are content-addressed, not line-addressed —
  ``rule::path::<normalized line text>::<occurrence>`` — so unrelated edits
  above a grandfathered finding do not invalidate the entry;
* stale baseline entries (keys no current finding matches) are reported and
  fail ``--gate``: a fixed finding must also retire its justification;
* the JSON report is byte-deterministic: relative posix paths, sorted
  findings, sorted keys, no timestamps or absolute paths.
"""
from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, Optional, Sequence

# Rule list terminates at the first token that is not a rule name, so a
# justification can follow: ``# replint: disable=rule-a,rule-b (why)``.
PRAGMA_RE = re.compile(
    r"#\s*replint:\s*disable=([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)")


@dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to the line a pragma would go on."""

    rule: str
    path: str          # posix path relative to the analysis root
    line: int          # 1-indexed
    col: int           # 0-indexed
    message: str
    symbol: str = ""   # enclosing function qualname when known

    def sort_key(self) -> tuple:
        return (self.path, self.line, self.col, self.rule, self.message)


class Module:
    """A parsed source module plus the lookups rules share: pragma map,
    import table, and line -> enclosing-function qualname."""

    def __init__(self, root: Path, path: Path) -> None:
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.source = path.read_text()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=str(path))
        self.pragmas: dict[int, set[str]] = {}
        for lineno, text in enumerate(self.lines, 1):
            m = PRAGMA_RE.search(text)
            if m:
                self.pragmas[lineno] = {
                    r.strip() for r in m.group(1).split(",") if r.strip()
                }
        self._imports: Optional[dict[str, str]] = None
        self._spans: Optional[list[tuple[int, int, str]]] = None

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed(self, finding: Finding) -> bool:
        disabled = self.pragmas.get(finding.line)
        return bool(disabled) and (finding.rule in disabled or "all" in disabled)

    # -- import table ------------------------------------------------------ #
    @property
    def imports(self) -> dict[str, str]:
        """Local name -> dotted origin (``np`` -> ``numpy``,
        ``perf_counter`` -> ``time.perf_counter``)."""
        if self._imports is None:
            table: dict[str, str] = {}
            for node in ast.walk(self.tree):
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        table[alias.asname or alias.name.split(".")[0]] = (
                            alias.name if alias.asname else alias.name.split(".")[0]
                        )
                        if alias.asname is None and "." in alias.name:
                            # ``import a.b`` binds ``a``; record the root
                            table[alias.name.split(".")[0]] = alias.name.split(".")[0]
                elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                    for alias in node.names:
                        table[alias.asname or alias.name] = f"{node.module}.{alias.name}"
            self._imports = table
        return self._imports

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted origin of a Name/Attribute chain through the import table
        (``_time.perf_counter`` -> ``time.perf_counter``); None when the
        chain's base is not an imported name."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.imports.get(node.id)
        if base is None:
            return None
        return ".".join([base] + list(reversed(parts)))

    # -- enclosing qualnames ----------------------------------------------- #
    def qualname(self, lineno: int) -> str:
        """Innermost enclosing function qualname (``Class.method``), or ""
        at module level."""
        if self._spans is None:
            spans: list[tuple[int, int, str]] = []

            def walk(node: ast.AST, stack: list[str]) -> None:
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                          ast.ClassDef)):
                        if not isinstance(child, ast.ClassDef):
                            spans.append((child.lineno,
                                          child.end_lineno or child.lineno,
                                          ".".join(stack + [child.name])))
                        walk(child, stack + [child.name])
                    else:
                        walk(child, stack)

            walk(self.tree, [])
            self._spans = spans
        best = ""
        best_len = None
        for lo, hi, name in self._spans:
            if lo <= lineno <= hi and (best_len is None or hi - lo <= best_len):
                best, best_len = name, hi - lo
        return best


class Rule:
    """Base rule: subclasses set ``name``/``description``, scope themselves
    via :meth:`applies_to` (posix relpath from the analysis root, e.g.
    ``repro/core/scheduler.py``) and yield :class:`Finding`s from
    :meth:`check`."""

    name = ""
    description = ""

    def applies_to(self, rel: str) -> bool:
        return True

    def check(self, mod: Module) -> Iterator[Finding]:
        raise NotImplementedError


def default_rules() -> list[Rule]:
    """The shipped rule set, in stable catalog order: the JAX package's
    (DESIGN.md §15) without ``pallas-index`` (the port has no Pallas), with
    ``torch-free-boundary`` in the place of ``jax-free-boundary``."""
    from .rules.determinism import SetIterRule, UnseededRngRule, WallClockRule
    from .rules.kernel_rules import TorchImportRule
    from .rules.mirror_sync import DirtyNotifyRule, MirrorWriteRule
    from .rules.terminal_state import TerminalStateRule

    return [
        MirrorWriteRule(),
        DirtyNotifyRule(),
        TerminalStateRule(),
        WallClockRule(),
        UnseededRngRule(),
        SetIterRule(),
        TorchImportRule(),
    ]


# -------------------------------------------------------------------------- #
# Baseline                                                                   #
# -------------------------------------------------------------------------- #
def norm_text(text: str) -> str:
    return " ".join(text.split())


def finding_key(finding: Finding, line_text: str, occurrence: int) -> str:
    """Content-addressed baseline key: stable across unrelated line shifts,
    disambiguated among identical lines by in-file occurrence order."""
    return "::".join([finding.rule, finding.path, norm_text(line_text),
                      str(occurrence)])


def load_baseline(path: Path) -> dict[str, str]:
    """Baseline file: ``{finding key: one-line justification}``."""
    data = json.loads(Path(path).read_text())
    if not isinstance(data, dict) or not all(
        isinstance(k, str) and isinstance(v, str) for k, v in data.items()
    ):
        raise ValueError(
            f"{path}: baseline must be a JSON object mapping finding keys "
            "to one-line justification strings"
        )
    return data


@dataclass
class Report:
    """Outcome of one analysis run.  ``findings`` are actionable (neither
    pragma-suppressed nor baselined); the gate passes iff it is empty AND
    no baseline entry went stale."""

    root_label: str
    rules: list[str]
    files_scanned: int
    findings: list[tuple[Finding, str]] = field(default_factory=list)
    baselined: list[tuple[Finding, str, str]] = field(default_factory=list)
    suppressed: list[Finding] = field(default_factory=list)
    stale_baseline: list[str] = field(default_factory=list)

    @property
    def gate_ok(self) -> bool:
        return not self.findings and not self.stale_baseline

    def to_dict(self) -> dict:
        def row(f: Finding, key: str) -> dict:
            return {
                "rule": f.rule, "path": f.path, "line": f.line, "col": f.col,
                "symbol": f.symbol, "message": f.message, "key": key,
            }

        return {
            "version": 1,
            "root": self.root_label,
            "rules": sorted(self.rules),
            "files_scanned": self.files_scanned,
            "gate_ok": self.gate_ok,
            "counts": {
                "findings": len(self.findings),
                "baselined": len(self.baselined),
                "suppressed": len(self.suppressed),
                "stale_baseline": len(self.stale_baseline),
            },
            "findings": [row(f, k) for f, k in self.findings],
            "baselined": [dict(row(f, k), justification=j)
                          for f, k, j in self.baselined],
            "suppressed": [row(f, "") for f in self.suppressed],
            "stale_baseline": sorted(self.stale_baseline),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True) + "\n"


# -------------------------------------------------------------------------- #
# Runner                                                                     #
# -------------------------------------------------------------------------- #
def iter_py_files(root: Path) -> list[Path]:
    return sorted(p for p in root.rglob("*.py") if p.is_file())


def run_analysis(
    root: Path,
    rules: Optional[Sequence[Rule]] = None,
    files: Optional[Iterable[Path]] = None,
    baseline: Optional[dict[str, str]] = None,
    root_label: str = "",
) -> Report:
    """Run ``rules`` over every ``*.py`` under ``root`` (or just ``files``).

    Paths/relpaths are computed against ``root`` — pointing ``root`` at a
    fixture tree shaped like ``src/`` (``repro/core/...``) exercises the
    exact same scoping as the real repo.
    """
    root = Path(root).resolve()
    active = list(rules) if rules is not None else default_rules()
    baseline = dict(baseline or {})
    todo = (iter_py_files(root) if files is None
            else sorted(Path(f).resolve() for f in files))

    raw: list[Finding] = []
    suppressed: list[Finding] = []
    n_files = 0
    for path in todo:
        rel = path.relative_to(root).as_posix()
        n_files += 1
        try:
            mod = Module(root, path)
        except SyntaxError as exc:
            raw.append(Finding("parse-error", rel, exc.lineno or 1, 0,
                               f"syntax error: {exc.msg}"))
            continue
        for rule in active:
            if not rule.applies_to(rel):
                continue
            for f in rule.check(mod):
                (suppressed if mod.suppressed(f) else raw).append(f)

    raw.sort(key=Finding.sort_key)
    suppressed.sort(key=Finding.sort_key)

    # Content-addressed keys (occurrence-indexed among identical lines),
    # then split against the baseline.
    line_cache: dict[str, list[str]] = {}
    occ: dict[tuple[str, str, str], int] = {}
    report = Report(root_label=root_label or root.name,
                    rules=[r.name for r in active], files_scanned=n_files)
    matched: set[str] = set()
    for f in raw:
        if f.path not in line_cache:
            try:
                line_cache[f.path] = (root / f.path).read_text().splitlines()
            except OSError:
                line_cache[f.path] = []
        lines = line_cache[f.path]
        text = lines[f.line - 1] if 1 <= f.line <= len(lines) else ""
        ident = (f.rule, f.path, norm_text(text))
        n = occ.get(ident, 0)
        occ[ident] = n + 1
        key = finding_key(f, text, n)
        if key in baseline:
            matched.add(key)
            report.baselined.append((f, key, baseline[key]))
        else:
            report.findings.append((f, key))
    report.suppressed = suppressed
    report.stale_baseline = sorted(set(baseline) - matched)
    return report
