"""Import-boundary rule of the port.

* ``torch-free-boundary`` — module-level imports of ``torch`` or ``jax``
  in the planes the port keeps torch-free (``core/``, ``sim/``,
  ``analysis/``, ``serving/stream.py`` and the lazy
  ``serving/__init__.py``): a single top-level ``import torch`` there makes
  every soak / chaos / lint consumer pay the full torch import, and the
  port imports jax nowhere.  Function-level (deferred) imports and
  ``if TYPE_CHECKING:`` blocks are allowed.  It is the JAX package's
  ``jax-free-boundary`` over the port's planes.

The JAX package's ``pallas-index`` (a bare int in a ``pl.load`` /
``pl.store`` / ``pl.swap`` index tuple) has no counterpart: the port has
no Pallas.  Its kernels are CUDA sources reached through ctypes, and each
wrapper checks what it hands them at run time (``kernels/_build.py``
``check_inputs``: device, dtype, contiguity, shapes).
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional, Sequence

from ..engine import Finding, Module, Rule

#: Modules that must stay importable without torch (and never import jax).
TORCH_FREE_PREFIXES: tuple[str, ...] = ("repro_torch/core/",
                                        "repro_torch/sim/",
                                        "repro_torch/analysis/")
TORCH_FREE_FILES: frozenset[str] = frozenset({
    "repro_torch/serving/stream.py",
    "repro_torch/serving/__init__.py",
})
#: Top-level packages such a module may not import at module level.
FORBIDDEN = ("torch", "jax")


class TorchImportRule(Rule):
    name = "torch-free-boundary"
    description = ("module-level torch or jax import in a module the "
                   "port's runtime planes keep torch-free")

    def __init__(self, prefixes: Optional[Sequence[str]] = None,
                 files: Optional[Sequence[str]] = None) -> None:
        self.prefixes = tuple(TORCH_FREE_PREFIXES if prefixes is None
                              else prefixes)
        self.files = frozenset(TORCH_FREE_FILES if files is None else files)

    def applies_to(self, rel: str) -> bool:
        return rel.startswith(self.prefixes) or rel in self.files

    def _module_level(self, body: Sequence[ast.stmt]) -> Iterator[ast.stmt]:
        """Statements executed at import time: recurse into module-level
        control flow and class bodies, skip function bodies and
        ``if TYPE_CHECKING:`` blocks."""
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if isinstance(stmt, ast.If):
                test = stmt.test
                if (isinstance(test, ast.Name)
                        and test.id == "TYPE_CHECKING") or (
                        isinstance(test, ast.Attribute)
                        and test.attr == "TYPE_CHECKING"):
                    continue
                yield from self._module_level(stmt.body)
                yield from self._module_level(stmt.orelse)
                continue
            yield stmt
            if isinstance(stmt, ast.ClassDef):
                yield from self._module_level(stmt.body)
            elif isinstance(stmt, ast.Try):
                yield from self._module_level(stmt.body)
                yield from self._module_level(stmt.orelse)
                yield from self._module_level(stmt.finalbody)
                for handler in stmt.handlers:
                    yield from self._module_level(handler.body)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                yield from self._module_level(stmt.body)

    def check(self, mod: Module) -> Iterator[Finding]:
        for stmt in self._module_level(mod.tree.body):
            names: list[str] = []
            if isinstance(stmt, ast.Import):
                names = [a.name for a in stmt.names]
            elif isinstance(stmt, ast.ImportFrom) and stmt.module:
                names = [stmt.module]
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    yield Finding(
                        self.name, mod.rel, stmt.lineno, stmt.col_offset,
                        f"module-level import of {name!r} in a torch-free "
                        "module — the runtime planes must import without "
                        "torch (and the port without jax); defer the "
                        "import into the function that needs it",
                        mod.qualname(stmt.lineno))
                    break
