"""Self-test of the port's lint plane (``repro_torch.analysis``), the twin
of tests/test_replint.py retargeted at ``repro_torch/``.

* fixture corpus: tests/data/replint_corpus/repro/ copied at test time to
  ``repro_torch/`` (only read, never changed), plus a torch fixture the
  test writes, so path-scoped rules see the port's relpaths;
* pragma/baseline semantics: line-scoped suppression, content-addressed
  occurrence-indexed keys, stale-entry reporting, byte-deterministic JSON;
* the real gate over ``repro_torch/`` with the port's baseline, and seeded
  injection into a copy of ``repro_torch/``.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import (
    TorchImportRule,
    TerminalStateRule,
    WallClockRule,
    default_rules,
    run_analysis,
)
from repro_torch.analysis.__main__ import main as cli_main

REPO = Path(__file__).parent.parent
PORT = REPO / "repro_torch"
CORPUS = Path(__file__).parent / "data" / "replint_corpus" / "repro"
BASELINE = PORT / "analysis" / "baseline.json"
JAX_BASELINE = REPO / "replint_baseline.json"

RULES = ["mirror-sync", "dirty-notify", "terminal-state",
         "determinism-wallclock", "determinism-rng", "determinism-set-iter",
         "torch-free-boundary"]

TORCH_FIXTURE = '''\
"""Fixture: the runtime planes must import without torch."""
import torch                               # BAD: module-level
from typing import TYPE_CHECKING

try:
    from torch import nn                   # BAD: try does not defer
except ImportError:
    nn = None

if TYPE_CHECKING:
    import torch.nn.functional as F        # good: type-only


def run(x):
    import torch.distributed               # good: deferred
    return torch.distributed, x
'''


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The JAX corpus laid out as ``repro_torch/``, plus the torch
    fixture."""
    root = tmp_path_factory.mktemp("corpus")
    shutil.copytree(CORPUS, root / "repro_torch")
    (root / "repro_torch" / "sim" / "torch_bad.py").write_text(TORCH_FIXTURE)
    return root


def corpus_report(root, **kw):
    return run_analysis(root, root_label="corpus", **kw)


def by_file(report):
    out = {}
    for f, _key in report.findings:
        out.setdefault(f.path, []).append((f.rule, f.line))
    return {path: sorted(rows) for path, rows in out.items()}


# --------------------------------------------------------------------------- #
# Rule polarities over the fixture corpus                                     #
# --------------------------------------------------------------------------- #
EXPECTED = {
    "repro_torch/core/calendar.py": [("dirty-notify", 13),
                                     ("dirty-notify", 16)],
    "repro_torch/core/mirror_bad.py": [("mirror-sync", ln)
                                       for ln in (5, 6, 7, 8, 9)],
    "repro_torch/core/terminal_bad.py": [("terminal-state", 6),
                                         ("terminal-state", 7)],
    "repro_torch/core/policy.py": [("terminal-state", 11)],
    "repro_torch/core/determinism_bad.py": [
        ("determinism-rng", 16), ("determinism-rng", 17),
        ("determinism-rng", 18), ("determinism-rng", 19),
        ("determinism-set-iter", 20), ("determinism-set-iter", 23),
        ("determinism-set-iter", 26),
        ("determinism-wallclock", 14), ("determinism-wallclock", 15),
    ],
    "repro_torch/sim/pragma_cases.py": [("determinism-wallclock", 7)],
    "repro_torch/serving/stream.py": [
        ("torch-free-boundary", 2), ("torch-free-boundary", 3),
        ("torch-free-boundary", 6),
    ],
    "repro_torch/sim/torch_bad.py": [
        ("torch-free-boundary", 2), ("torch-free-boundary", 6),
    ],
}

GOOD_FILES = [
    "repro_torch/core/mirror_good.py",
    "repro_torch/core/determinism_good.py",
    "repro_torch/kernels/pallas_good.py",
    "repro_torch/serving/__init__.py",
    "repro_torch/viz/plots.py",
    # the JAX package's pallas-index fixture: the port has no such rule,
    # and kernels/ is outside the torch-free planes
    "repro_torch/kernels/pallas_bad.py",
]


def test_corpus_findings_exact(corpus):
    report = corpus_report(corpus)
    assert by_file(report) == {p: sorted(rows)
                               for p, rows in EXPECTED.items()}
    assert not report.gate_ok


@pytest.mark.parametrize("rel", GOOD_FILES)
def test_good_fixtures_are_clean(corpus, rel):
    report = corpus_report(corpus, files=[corpus / rel])
    assert not report.findings, report.findings


def test_shipped_rules_are_the_jax_catalog_retargeted():
    """The JAX catalog in its order, without ``pallas-index``, with
    ``torch-free-boundary`` where ``jax-free-boundary`` was."""
    assert [r.name for r in default_rules()] == RULES


def test_every_rule_fires_in_the_corpus(corpus):
    report = corpus_report(corpus)
    fired = {f.rule for f, _ in report.findings} | {
        f.rule for f in report.suppressed}
    assert fired == {r.name for r in default_rules()}


def test_torch_rule_scope_is_the_torch_free_planes():
    rule = TorchImportRule()
    for rel in ("repro_torch/core/scheduler.py", "repro_torch/sim/chaos.py",
                "repro_torch/analysis/engine.py",
                "repro_torch/serving/stream.py",
                "repro_torch/serving/__init__.py"):
        assert rule.applies_to(rel), rel
    for rel in ("repro_torch/serving/engine.py",
                "repro_torch/kernels/_build.py",
                "repro_torch/models/model.py", "repro/core/scheduler.py"):
        assert not rule.applies_to(rel), rel


def test_settle_registry_override(corpus):
    """The audited registry is constructor-overridable (corpus calendars /
    forks can certify their own settle helpers)."""
    rule = TerminalStateRule(settle={
        "repro_torch/core/terminal_bad.py": frozenset({"leak"}),
    })
    report = corpus_report(corpus, rules=[rule])
    assert by_file(report) == {"repro_torch/core/policy.py": [
        ("terminal-state", 8), ("terminal-state", 11)]}


# --------------------------------------------------------------------------- #
# Pragma semantics                                                            #
# --------------------------------------------------------------------------- #
def test_pragma_scopes_to_flagged_line_only(corpus):
    report = corpus_report(
        corpus, files=[corpus / "repro_torch/sim/pragma_cases.py"],
        rules=[WallClockRule()])
    assert [(f.rule, f.line) for f, _ in report.findings] == [
        ("determinism-wallclock", 7)]
    assert sorted(f.line for f in report.suppressed) == [6, 12]


def test_pragma_wrong_rule_does_not_suppress(tmp_path):
    mod = tmp_path / "repro_torch" / "core" / "m.py"
    mod.parent.mkdir(parents=True)
    mod.write_text(textwrap.dedent("""\
        import time

        def f():
            return time.time()  # replint: disable=determinism-rng (wrong rule)
    """))
    report = run_analysis(tmp_path, rules=[WallClockRule()])
    assert [f.line for f, _ in report.findings] == [4]
    assert not report.suppressed


# --------------------------------------------------------------------------- #
# Baseline semantics                                                          #
# --------------------------------------------------------------------------- #
def test_baseline_grandfathers_and_gate_passes(corpus):
    first = corpus_report(corpus)
    baseline = {key: "grandfathered for the corpus round-trip test"
                for _f, key in first.findings}
    second = corpus_report(corpus, baseline=baseline)
    assert not second.findings
    assert len(second.baselined) == len(first.findings)
    assert not second.stale_baseline
    assert second.gate_ok


def test_stale_baseline_entry_fails_gate(corpus):
    first = corpus_report(corpus)
    baseline = {key: "ok" for _f, key in first.findings}
    gone = "determinism-wallclock::repro_torch/core/gone.py::x = time.time()::0"
    baseline[gone] = "this finding was fixed but the entry was not retired"
    report = corpus_report(corpus, baseline=baseline)
    assert report.stale_baseline == [gone]
    assert not report.findings
    assert not report.gate_ok


def test_baseline_keys_survive_line_shifts(tmp_path):
    """Content-addressed keys: inserting unrelated lines above a
    grandfathered finding must not invalidate its baseline entry."""
    mod = tmp_path / "repro_torch" / "core" / "m.py"
    mod.parent.mkdir(parents=True)
    body = "import time\n\ndef f():\n    return time.time()\n"
    mod.write_text(body)
    key = run_analysis(tmp_path, rules=[WallClockRule()]).findings[0][1]
    mod.write_text("# an unrelated comment\n# another\n" + body)
    shifted = run_analysis(tmp_path, rules=[WallClockRule()],
                           baseline={key: "attested"})
    assert not shifted.findings
    assert not shifted.stale_baseline
    assert shifted.gate_ok


def test_identical_lines_get_occurrence_indexed_keys(tmp_path):
    mod = tmp_path / "repro_torch" / "core" / "m.py"
    mod.parent.mkdir(parents=True)
    mod.write_text(textwrap.dedent("""\
        import time

        def f():
            t = time.time()
            t = time.time()
            return t
    """))
    report = run_analysis(tmp_path, rules=[WallClockRule()])
    keys = [key for _f, key in report.findings]
    assert len(keys) == 2 and keys[0] != keys[1]
    assert keys[0].endswith("::0") and keys[1].endswith("::1")
    # baselining ONE occurrence leaves the other a live finding
    partial = run_analysis(tmp_path, rules=[WallClockRule()],
                           baseline={keys[0]: "first occurrence attested"})
    assert [key for _f, key in partial.findings] == [keys[1]]
    assert not partial.stale_baseline


def test_parse_error_is_a_finding(tmp_path):
    mod = tmp_path / "repro_torch" / "core" / "broken.py"
    mod.parent.mkdir(parents=True)
    mod.write_text("def f(:\n")
    report = run_analysis(tmp_path)
    assert [f.rule for f, _ in report.findings] == ["parse-error"]
    assert not report.gate_ok


# --------------------------------------------------------------------------- #
# Deterministic report                                                        #
# --------------------------------------------------------------------------- #
def test_json_report_is_byte_deterministic(corpus, tmp_path):
    a = corpus_report(corpus).to_json()
    b = corpus_report(corpus).to_json()
    assert a == b
    # ... and independent of the absolute root the tree is scanned from
    clone = tmp_path / "elsewhere"
    shutil.copytree(corpus, clone)
    c = run_analysis(clone, root_label="corpus").to_json()
    assert c == a
    # no absolute paths leak into the report
    assert str(corpus) not in a and str(tmp_path) not in c
    payload = json.loads(a)
    assert payload["gate_ok"] is False
    assert payload["rules"] == sorted(RULES)
    assert payload["counts"]["findings"] == sum(map(len, EXPECTED.values()))
    assert payload["counts"]["suppressed"] == 3


# --------------------------------------------------------------------------- #
# The real tree: zero unbaselined findings                                    #
# --------------------------------------------------------------------------- #
def test_port_gate_is_clean_with_its_baseline():
    baseline = json.loads(BASELINE.read_text())
    report = run_analysis(REPO, files=PORT.rglob("*.py"), baseline=baseline,
                          root_label="repro_torch")
    assert not report.findings, "\n".join(
        f"{f.path}:{f.line}: {f.rule}: {f.message}"
        for f, _ in report.findings)
    assert not report.stale_baseline
    assert report.gate_ok
    assert len(report.baselined) == 14
    # the baseline carries ONLY attested timing telemetry
    assert all(f.rule == "determinism-wallclock"
               for f, _k, _j in report.baselined)
    assert all(f.path.startswith("repro_torch/")
               for f, _k, _j in report.baselined)


def test_port_baseline_is_the_jax_baseline_renamed():
    """The 14 sites are in verbatim copies of the JAX modules, so the keys
    match one for one under the path rename, with the same
    justifications."""
    jax = json.loads(JAX_BASELINE.read_text())
    port = json.loads(BASELINE.read_text())
    assert port == {k.replace("::repro/", "::repro_torch/", 1): v
                    for k, v in jax.items()}
    assert len(port) == 14


# --------------------------------------------------------------------------- #
# CLI + seeded injection                                                      #
# --------------------------------------------------------------------------- #
def _cli(*args, **kw):
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], capture_output=True, text=True,
                          env=dict(os.environ), cwd=REPO, **kw)


def test_cli_list_rules():
    proc = _cli("--list-rules")
    assert proc.returncode == 0
    listed = [line.split(":", 1)[0] for line in proc.stdout.splitlines()]
    assert listed == RULES


def test_cli_gate_passes_on_the_port_within_budget():
    proc = _cli("--gate", "--budget-s", "10")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert " 0 finding(s), 14 baselined" in proc.stdout
    assert "0 stale baseline" in proc.stdout


def test_cli_default_scan_is_the_port_only(tmp_path, capsys):
    """With no paths the CLI scans ``<root>/repro_torch/`` alone: neither
    ``src/`` nor ``tests/`` nor ``chip_smoke.py``."""
    out = tmp_path / "r.json"
    assert cli_main(["--json", str(out)]) == 0
    payload = json.loads(out.read_text())
    paths = {row["path"] for key in ("baselined", "suppressed")
             for row in payload[key]}
    assert paths and all(p.startswith("repro_torch/") for p in paths)
    assert payload["files_scanned"] == len(list(PORT.rglob("*.py")))
    assert payload["root"] == "repro_torch"
    capsys.readouterr()


def test_cli_budget_exceeded_exits_2():
    proc = _cli("--budget-s", "0")
    assert proc.returncode == 2
    assert "budget exceeded" in proc.stderr


def test_cli_unknown_rule_exits_2():
    proc = _cli("--rules", "pallas-index")
    assert proc.returncode == 2
    assert "unknown rule(s): pallas-index" in proc.stderr


def test_cli_json_report_is_stable_across_runs(tmp_path):
    out1, out2 = tmp_path / "r1.json", tmp_path / "r2.json"
    assert _cli("--json", str(out1)).returncode == 0
    assert _cli("--json", str(out2)).returncode == 0
    assert out1.read_bytes() == out2.read_bytes()


@pytest.fixture()
def port_clone(tmp_path):
    clone = tmp_path / "repo"
    shutil.copytree(PORT, clone / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return clone


def _clone_gate(clone):
    return _cli("--gate", "--root", str(clone), "--baseline", str(BASELINE))


def test_injection_clean_clone_passes(port_clone):
    proc = _clone_gate(port_clone)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("rel,snippet,rule", [
    ("repro_torch/core/scheduler.py",
     "\n\ndef _injected_probe():\n    import time\n    return time.time()\n",
     "determinism-wallclock"),
    ("repro_torch/sim/scenarios.py",
     "\n\ndef _injected_clobber(dev):\n    dev._sky.clear()\n",
     "mirror-sync"),
    ("repro_torch/core/task.py",
     "\n\ndef _injected_settle(task):\n"
     "    task.state = TaskState.FAILED\n",
     "terminal-state"),
    ("repro_torch/core/metrics.py",
     "\n\ndef _injected_order(seen):\n    pending = set(seen)\n"
     "    return [s for s in pending]\n",
     "determinism-set-iter"),
    ("repro_torch/serving/stream.py",
     "\nimport torch\n",
     "torch-free-boundary"),
])
def test_injection_gate_fails(port_clone, rel, snippet, rule):
    """Seeded injection: the gate MUST fail when a known-bad pattern is
    introduced anywhere in the scanned tree."""
    target = port_clone / rel
    target.write_text(target.read_text() + snippet)
    proc = _clone_gate(port_clone)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert rule in proc.stdout
