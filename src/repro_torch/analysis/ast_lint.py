"""AST-level hazard lint (rules T4, T5, T6, T8) over Python source, stdlib
``ast`` only (the port's counterpart of ``src/repro/analysis/ast_lint.py``).

T4  no kernel build, library load or ``torch.compile`` *call* inside a
    function body: ``build.build``, ``ctypes.CDLL`` /
    ``ctypes.cdll.LoadLibrary``, ``torch.utils.cpp_extension.load*`` and
    ``torch.compile`` belong at module level, in ``kernels/build.py`` (whose
    ``entry`` caches every library it loads), in a ``_compile*`` function
    or in a process's ``main``.  A build made per call reruns ``nvcc`` or
    reloads a library on every call (the counterpart of the reference's
    R4, a ``jax.jit`` per call).

T5  no host read-back inside a ``for`` / ``while`` body of a hot-path
    module (``HOT_PATH_DIRS``, ``HOT_PATH_FILES``): ``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``torch.cuda.synchronize()``,
    ``torch.equal`` / ``torch.allclose``, and a device predicate read as a
    Python bool (``bool(t.any())``, ``if t.all():``, a ``while`` test of
    that form).  Each one stalls the host until the card drains, once per
    iteration.  ``int(...)`` and ``float(...)`` are not flagged: in the
    service they read numpy arrays, and the trace layer's T1 counts the
    tensor case.  A comprehension is not a loop body here.  (The
    counterpart of the reference's R6, a Python branch on a tracer, and of
    the lazy greedy's counted ``lazy_syncs``.)

T6  no TF32 or reduced-precision switch turned on: an assignment to
    ``...allow_tf32``, ``...allow_fp16_reduced_precision_reduction`` or
    ``...allow_bf16_reduced_precision_reduction`` of anything but
    ``False``, to ``...fp32_precision`` of anything but ``"ieee"``, or
    ``torch.set_float32_matmul_precision`` with anything but
    ``"highest"``.  The parity paths hold float32 products in full float32
    (``repro_torch.no_tf32``); the trace layer reads the switches at every
    matmul-family op as well.

T8  no ``torch.sum`` / ``Tensor.sum`` / ``.mean`` over the last axis
    (``dim=-1``) in a ``FIXED_ORDER_FILES`` module outside
    ``objectives._row_sum``: on CUDA ``torch.sum`` splits a row among
    threads by the shape of the whole tensor, so a shard's sum differs in
    its last bits between the stacked batch of m shards and the m / world
    a rank of a process mesh holds.  These modules must give both layouts
    the same bits; ``_row_sum`` sums in an order that depends on the row's
    length alone.
"""
from __future__ import annotations

import ast
from pathlib import Path

from .findings import Finding

__all__ = ["lint_file", "lint_paths", "FIXED_ORDER_FILES", "HOT_PATH_DIRS",
           "HOT_PATH_FILES"]

# T5: modules whose loops run on the selection and serving paths
HOT_PATH_DIRS = ("src/repro_torch/core/", "src/repro_torch/service/",
                 "src/repro_torch/serve/")
HOT_PATH_FILES = frozenset({
    "src/repro_torch/kernels/ops.py",
    "src/repro_torch/data/selection.py",
})

# T8: modules whose per-shard sums must not depend on how many shards one
# tensor holds (the stacked engines and the ranks of a process mesh give the
# same bits).  The counterpart of the reference's SHARD_MAP_CONTEXT_FILES.
FIXED_ORDER_FILES = frozenset({
    "src/repro_torch/core/objectives.py",
    "src/repro_torch/core/greedi.py",
    "src/repro_torch/service/store.py",
})
_ROW_SUM_FUNCS = frozenset({"_row_sum"})

# T4
_BUILD_FILES = frozenset({"src/repro_torch/kernels/build.py"})
_BUILD_HOIST_PREFIXES = ("_compile",)
_BUILD_ALLOWED_FUNCS = frozenset({"main"})
_BUILD_CALLS = frozenset({
    "build.build", "ctypes.CDLL", "ctypes.cdll.LoadLibrary",
    "torch.compile", "torch.utils.cpp_extension.load",
    "torch.utils.cpp_extension.load_inline", "cpp_extension.load",
    "cpp_extension.load_inline",
})
# names a ``from X import Y [as Z]`` binds to one of the calls above
_BUILD_FROM = {
    ("ctypes", "CDLL"), ("torch", "compile"),
    ("torch.utils.cpp_extension", "load"),
    ("torch.utils.cpp_extension", "load_inline"),
}

# T5
_READBACK_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_SYNC_CALLS = frozenset({"torch.cuda.synchronize", "torch.equal",
                         "torch.allclose"})
_PREDICATES = frozenset({"any", "all"})

# T6
_PRECISION_FLAGS = ("allow_tf32", "allow_fp16_reduced_precision_reduction",
                    "allow_bf16_reduced_precision_reduction")


def _dotted(node: ast.AST) -> str:
  """'torch.cuda.synchronize' for Attribute chains, 'f' for a bare Name,
  '' otherwise."""
  parts = []
  while isinstance(node, ast.Attribute):
    parts.append(node.attr)
    node = node.value
  if isinstance(node, ast.Name):
    parts.append(node.id)
    return ".".join(reversed(parts))
  return ""


def _build_aliases(tree: ast.Module) -> set[str]:
  """Names bound at module level to a build or load call (T4)."""
  out: set[str] = set()
  for node in tree.body:
    if isinstance(node, ast.ImportFrom):
      for alias in node.names:
        if (node.module, alias.name) in _BUILD_FROM:
          out.add(alias.asname or alias.name)
  return out


def _is_predicate(node: ast.AST) -> bool:
  """``t.any()`` / ``t.all()`` (possibly under ``not``)."""
  if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
    node = node.operand
  return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
          and node.func.attr in _PREDICATES and not node.args)


def _const(node: ast.AST):
  return node.value if isinstance(node, ast.Constant) else ...


def _last_axis(node: ast.Call, positional: int) -> bool:
  """Whether the call's dim (keyword ``dim`` / ``axis`` or positional
  argument ``positional``) is the literal -1."""
  for kw in node.keywords:
    if kw.arg in ("dim", "axis"):
      return _is_minus_one(kw.value)
  if len(node.args) > positional:
    return _is_minus_one(node.args[positional])
  return False


def _is_minus_one(node: ast.AST) -> bool:
  if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
    return _const(node.operand) == 1
  if isinstance(node, (ast.Tuple, ast.List)):
    return any(_is_minus_one(e) for e in node.elts)
  return _const(node) == -1


class _Linter(ast.NodeVisitor):

  def __init__(self, rel: str, build_aliases: set[str]):
    self.rel = rel
    self.build_aliases = build_aliases
    self.hot = rel.startswith(HOT_PATH_DIRS) or rel in HOT_PATH_FILES
    self.fixed_order = rel in FIXED_ORDER_FILES
    self.build_file = rel in _BUILD_FILES
    self.stack: list[str] = []  # enclosing function names, innermost last
    self.loops = [0]            # loop depth of each enclosing scope
    self.findings: list[Finding] = []

  def _add(self, rule: str, node: ast.AST, msg: str, hint: str) -> None:
    self.findings.append(Finding(rule=rule, file=self.rel, line=node.lineno,
                                 msg=msg, hint=hint))

  # -- scopes: decorators and defaults evaluate in the ENCLOSING scope, so
  # they are visited before the function is pushed; a function body starts
  # outside any loop (defining a function in a loop runs none of its body)
  def _visit_func(self, node):
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
      for dec in node.decorator_list:
        self.visit(dec)
      name, body = node.name, node.body
    else:
      name, body = "<lambda>", [node.body]
    for default in list(node.args.defaults) + [
        d for d in node.args.kw_defaults if d is not None]:
      self.visit(default)
    self.stack.append(name)
    self.loops.append(0)
    for stmt in body:
      self.visit(stmt)
    self.loops.pop()
    self.stack.pop()

  visit_FunctionDef = _visit_func
  visit_AsyncFunctionDef = _visit_func
  visit_Lambda = _visit_func

  def _in_loop(self, stmts) -> None:
    self.loops[-1] += 1
    for s in stmts:
      self.visit(s)
    self.loops[-1] -= 1

  def visit_For(self, node):
    # the iterable is evaluated once, before the loop
    self.visit(node.target)
    self.visit(node.iter)
    self._in_loop(node.body)
    for s in node.orelse:
      self.visit(s)

  visit_AsyncFor = visit_For

  def visit_While(self, node):
    # the test runs every iteration
    self.loops[-1] += 1
    self.visit(node.test)
    if self.hot and _is_predicate(node.test):
      self._t5(node.test, "while test on a device predicate")
    self.loops[-1] -= 1
    self._in_loop(node.body)
    for s in node.orelse:
      self.visit(s)

  def visit_If(self, node):
    if self.hot and self.loops[-1] and _is_predicate(node.test):
      self._t5(node.test, "if test on a device predicate")
    self.generic_visit(node)

  def _t5(self, node: ast.AST, what: str) -> None:
    fn = self.stack[-1] if self.stack else "<module>"
    self._add("T5", node,
              f"host sync ({what}) inside a loop body of '{fn}' in a "
              "hot-path module (one stall per iteration)",
              "keep the value on the device (torch.where, a masked "
              "reduction), or read it back once after the loop")

  # -- T6: switches set by assignment -----------------------------------
  def visit_Assign(self, node):
    for tgt in node.targets:
      self._check_switch(tgt, node.value, node)
    self.generic_visit(node)

  def _check_switch(self, tgt: ast.AST, value: ast.AST, node) -> None:
    if not isinstance(tgt, ast.Attribute):
      return
    if tgt.attr in _PRECISION_FLAGS and _const(value) is not False:
      self._add("T6", node,
                f"{_dotted(tgt) or tgt.attr} turned on (float32 products "
                "lose bits the parity paths hold)",
                "leave it False (repro_torch.no_tf32)")
    elif tgt.attr == "fp32_precision" and _const(value) != "ieee":
      self._add("T6", node,
                f"{_dotted(tgt) or tgt.attr} set off 'ieee' (TF32 "
                "products)", "leave float32 precision at 'ieee'")

  # -- T4 / T5 / T6 / T8 calls -------------------------------------------
  def visit_Call(self, node: ast.Call):
    d = _dotted(node.func)
    if (self.stack and not self.build_file
        and (d in _BUILD_CALLS or d in self.build_aliases)):
      fn = self.stack[-1]
      if not (fn.startswith(_BUILD_HOIST_PREFIXES)
              or fn in _BUILD_ALLOWED_FUNCS):
        self._add("T4", node,
                  f"{d} called inside function body '{fn}' (a kernel build "
                  "or library load per call)",
                  "build at module level, through kernels/build.entry "
                  "(cached), or in a _compile*() function called once")
    if self.hot and self.loops[-1]:
      meth = node.func.attr if isinstance(node.func, ast.Attribute) else ""
      if meth in _READBACK_METHODS and not node.args:
        self._t5(node, f".{meth}()")
      elif d in _SYNC_CALLS:
        self._t5(node, f"{d}()")
      elif d == "bool" and len(node.args) == 1 and _is_predicate(
          node.args[0]):
        self._t5(node, "bool() of a device predicate")
    if d.endswith("set_float32_matmul_precision") and node.args:
      if _const(node.args[0]) != "highest":
        self._add("T6", node,
                  "float32 matmul precision set below 'highest' (TF32 "
                  "or bf16 products)", "leave it at 'highest'")
    if self.fixed_order and not (set(self.stack) & _ROW_SUM_FUNCS):
      self._check_t8(node, d)
    self.generic_visit(node)

  def _check_t8(self, node: ast.Call, d: str) -> None:
    if d in ("torch.sum", "torch.mean"):
      hit = _last_axis(node, 1)
    elif (isinstance(node.func, ast.Attribute)
          and node.func.attr in ("sum", "mean")
          and not d.startswith(("np.", "numpy."))):
      hit = _last_axis(node, 0)
    else:
      return
    if hit:
      fn = self.stack[-1] if self.stack else "<module>"
      self._add("T8", node,
                f"{d or node.func.attr} over the last axis in '{fn}' of a "
                "fixed-order module (on CUDA its order follows the whole "
                "tensor's shape)",
                "route the row sum through objectives._row_sum")


def lint_file(path: Path, repo_root: Path) -> list[Finding]:
  rel = str(path.relative_to(repo_root)) if path.is_absolute() else str(path)
  try:
    tree = ast.parse(path.read_text(), filename=str(path))
  except SyntaxError as e:
    return [Finding(rule="parse", file=rel, line=e.lineno or 0,
                    msg=f"syntax error: {e.msg}")]
  linter = _Linter(rel, _build_aliases(tree))
  linter.visit(tree)
  return linter.findings


def lint_paths(paths: list[Path], repo_root: Path) -> list[Finding]:
  findings: list[Finding] = []
  for p in sorted(paths):
    findings.extend(lint_file(p, repo_root))
  return findings
