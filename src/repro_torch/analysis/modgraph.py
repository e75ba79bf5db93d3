"""Static import graph over ``src/repro_torch`` for the analyzer's ``--diff``
mode (the port of ``src/repro/analysis/modgraph.py``).

The trace layer's cost is running: every entry point builds a service or
its operands and runs its call under a dispatch mode -- seconds each, more
for the entries over ranks.  On a PR that touches only, say, ``models/``,
none of that running can change its answer.  ``--diff`` prunes it: an
entry point is AFFECTED by a change set iff some changed module is
import-reachable from the entry's registered root modules
(``dispatch.EntryPoint.roots``, defaulting to the builder's own module).
Reachability over the *static import graph* is a sound over-approximation
of "the run could differ": python can only execute what it (transitively)
imports, and no path loads plugins dynamically.  The CUDA libraries are
the one thing no import reaches: the CLI counts a changed file under
``kernels/csrc/`` as a change of ``repro_torch.kernels.build``, which loads
them.  The pruning is deliberately conservative the other way too: entries
rooted in ``repro_torch.analysis.entries`` reach most of the tree, so
core/service PRs still run everything.

Pure-AST: no imports are executed, so building the graph is milliseconds
and safe to run before torch is even imported.
"""
from __future__ import annotations

import ast
from pathlib import Path

_PKG = "repro_torch"


def module_name(path: Path, src_root: Path) -> str | None:
  """Dotted module name of ``path`` under ``src_root`` (None if outside or
  not a python file).  ``src_root`` is the directory holding the
  ``repro_torch`` package (i.e. ``<repo>/src``)."""
  try:
    rel = path.resolve().relative_to(src_root.resolve())
  except ValueError:
    return None
  if rel.suffix != ".py":
    return None
  parts = list(rel.with_suffix("").parts)
  if parts[-1] == "__init__":
    parts = parts[:-1]
  if not parts or parts[0] != _PKG:
    return None
  return ".".join(parts)


def _local_imports(path: Path, mod: str) -> set[str]:
  """Modules of the ``repro_torch`` package imported by ``path`` (static
  AST)."""
  try:
    tree = ast.parse(path.read_text(), filename=str(path))
  except (SyntaxError, OSError):
    return set()
  out: set[str] = set()
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for a in node.names:
        if a.name == _PKG or a.name.startswith(_PKG + "."):
          out.add(a.name)
    elif isinstance(node, ast.ImportFrom):
      if node.level:  # relative import: resolve against this module
        base = mod.split(".")
        # level 1 = this module's package (which IS ``mod`` for an
        # __init__), each extra level pops one more component
        up = node.level - 1 if path.name == "__init__.py" else node.level
        pkg = base[:len(base) - up] if up <= len(base) else []
        target = ".".join(pkg + ([node.module] if node.module else []))
      else:
        target = node.module or ""
      if target == _PKG or target.startswith(_PKG + "."):
        out.add(target)
        # ``from repro_torch.pkg import name`` may bind the submodule
        # ``repro_torch.pkg.name`` -- include both candidates; nonexistent ones
        # drop out when the graph is restricted to real modules
        for a in node.names:
          out.add(f"{target}.{a.name}")
  return out


def build_graph(src_root: Path) -> dict[str, set[str]]:
  """module -> set of imported local modules, over every ``repro_torch`` file
  under ``src_root``.  Importing any module also 'imports' its ancestor
  packages (python executes their ``__init__``s), so package edges are
  implicit in the closure below."""
  src_root = Path(src_root)
  mods: dict[str, Path] = {}
  for p in (src_root / _PKG).rglob("*.py"):
    m = module_name(p, src_root)
    if m:
      mods[m] = p
  graph: dict[str, set[str]] = {}
  for m, p in mods.items():
    deps = set()
    for d in _local_imports(p, m):
      # keep only modules that actually exist, plus every ancestor package
      # on the way (their __init__ runs on import)
      parts = d.split(".")
      for i in range(1, len(parts) + 1):
        anc = ".".join(parts[:i])
        if anc in mods:
          deps.add(anc)
    deps.discard(m)
    graph[m] = deps
  return graph


def reachable(graph: dict[str, set[str]], roots) -> set[str]:
  """Transitive import closure of ``roots`` (roots included when real)."""
  seen: set[str] = set()
  stack = [r for r in roots if r in graph]
  while stack:
    m = stack.pop()
    if m in seen:
      continue
    seen.add(m)
    stack.extend(graph.get(m, ()))
  return seen


def affected_entries(entry_roots: dict[str, tuple[str, ...]],
                     changed_modules: set[str],
                     src_root: Path) -> dict[str, bool]:
  """entry name -> whether its import closure meets the changed set.

  Entries whose roots aren't in the graph (builders defined outside
  ``src/repro_torch``, e.g. in a test) are conservatively marked affected.
  """
  graph = build_graph(src_root)
  out: dict[str, bool] = {}
  for name, roots in entry_roots.items():
    known = [r for r in roots if r in graph]
    if len(known) < len([r for r in roots if r]):
      out[name] = True  # unknown root: can't prove it unaffected
      continue
    out[name] = bool(reachable(graph, known) & changed_modules)
  return out
