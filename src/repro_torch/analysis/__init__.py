"""Static and dispatch-trace hazard analysis of the port (the counterpart
of ``src/repro/analysis``).

Two layers (rule catalog in docs/analysis_torch.md):

- trace layer (``trace_check``): runs each registered entry point once on
  concrete operands under a ``TorchDispatchMode`` and reads its aten ops.
  T1 host syncs above the entry's declared sync budget, T3 row reductions
  over pad-and-mask blocks that never consumed a declared validity mask,
  T4 a kernel build or library load in a warm call, T6 a float32 matmul
  run with TF32 on; over the ranks of a process mesh, T2 ranks whose
  sequences of ``ProcessMesh`` collectives differ (the deadlock class) and
  T7 a sum over the ranks of an operand that is the same on every rank.
- AST layer (``ast_lint``): pure-syntax checks over the source (stdlib
  ``ast``), nothing run.
  T4 a kernel build / library load / ``torch.compile`` inside a function
  body, T5 host read-backs inside a loop of a hot-path module, T6 TF32 or
  reduced-precision switches turned on, T8 a last-axis sum in a
  fixed-order module not routed through ``objectives._row_sum``.

Suppress a finding with ``# repro: allow(<rule>): justification`` on the
same line or the line above -- the justification is required.
"""
from repro_torch.analysis.findings import (  # noqa: F401
    Finding,
    apply_suppressions,
    format_finding,
    load_baseline,
    new_findings,
    write_baseline,
)
from repro_torch.analysis.ast_lint import lint_file, lint_paths  # noqa: F401

_TRACE_NAMES = ("check_entry", "run_entry", "check_ranked")


def __getattr__(name):
  # the trace layer imports the package's kernels and mesh; load it lazily
  # so --ast-only (and plain findings / lint users) run nothing of it
  if name in _TRACE_NAMES:
    from repro_torch.analysis import trace_check
    return getattr(trace_check, name)
  raise AttributeError(name)
