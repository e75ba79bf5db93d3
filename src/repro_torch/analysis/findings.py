"""Finding model, suppression comments, and the committed-baseline gate
(the port's own copy of ``src/repro/analysis/findings.py``: the port
imports nothing of the reference package).

A finding is one rule violation at one source location.  Suppressions are
in-source comments of the form::

    # repro: allow(T5): one read-back per rescan is the contract because ...

on the same line as the flagged code or on the line directly above it.  The
justification after the colon is REQUIRED -- a bare ``# repro: allow(T5)``
does not suppress (the analyzer reports the original finding plus a nudge to
write the reason down).  This keeps every suppression reviewable: the "why"
lives next to the "what".

The baseline file (``analysis_baseline_torch.json``) freezes the set of
known findings so the gate fails only on *new* ones.  The committed
baseline is empty -- the port starts clean -- but the mechanism lets a
future PR land with a triaged-but-not-yet-fixed finding without turning
the gate red for everyone.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

__all__ = [
    "Finding",
    "scan_suppressions",
    "apply_suppressions",
    "load_baseline",
    "write_baseline",
    "new_findings",
    "format_finding",
]

_ALLOW_RE = re.compile(
    r"#\s*repro:\s*allow\(\s*(?P<rule>[A-Za-z0-9_]+)\s*\)\s*(?::\s*(?P<why>\S.*))?"
)


@dataclasses.dataclass(frozen=True)
class Finding:
  """One rule violation.

  ``entry`` names the entry point a trace-layer finding came from (empty
  for AST findings); it is informational and not part of the baseline
  identity, so a hazard reachable from several entry points is one finding, not many.
  """

  rule: str        # "T1".."T8"
  file: str        # repo-relative path
  line: int        # 1-based; 0 if the location could not be recovered
  msg: str         # one-line statement of the violation
  hint: str = ""   # one-line fix hint
  entry: str = ""  # entry point of a trace-layer finding

  def key(self) -> tuple:
    return (self.rule, self.file, self.line, self.msg)


def scan_suppressions(path: Path) -> dict[int, tuple[str, str]]:
  """Map line number -> (rule, justification) for every allow-comment.

  A comment suppresses findings on its own line and on the following line
  (covering both trailing-comment and own-line-above styles).
  """
  out: dict[int, tuple[str, str]] = {}
  try:
    text = path.read_text()
  except OSError:
    return out
  for i, raw in enumerate(text.splitlines(), start=1):
    m = _ALLOW_RE.search(raw)
    if m:
      out[i] = (m.group("rule"), (m.group("why") or "").strip())
  return out


def apply_suppressions(
    findings: list[Finding], repo_root: Path
) -> tuple[list[Finding], list[Finding]]:
  """Split findings into (active, suppressed) using in-source allow-comments.

  A finding at file:L is suppressed by a matching-rule comment at line L or
  L-1 *with a non-empty justification*.  A matching comment with no
  justification leaves the finding active and appends a reminder to its hint.
  """
  cache: dict[str, dict[int, tuple[str, str]]] = {}
  active: list[Finding] = []
  suppressed: list[Finding] = []
  for f in findings:
    if f.file not in cache:
      cache[f.file] = scan_suppressions(repo_root / f.file)
    sup = cache[f.file]
    hit = None
    for ln in (f.line, f.line - 1):
      ent = sup.get(ln)
      if ent is not None and ent[0] == f.rule:
        hit = ent
        break
    if hit is None:
      active.append(f)
    elif hit[1]:
      suppressed.append(f)
    else:
      active.append(
          dataclasses.replace(
              f, hint=(f.hint + " [allow() found but justification missing — "
                       "write one after a colon]").strip()))
  return active, suppressed


def load_baseline(path: Path) -> set[tuple]:
  try:
    payload = json.loads(path.read_text())
  except FileNotFoundError:
    return set()
  return {
      (e["rule"], e["file"], int(e["line"]), e["msg"])
      for e in payload.get("findings", [])
  }


def write_baseline(path: Path, findings: list[Finding]) -> None:
  payload = {
      "findings": [
          {"rule": f.rule, "file": f.file, "line": f.line, "msg": f.msg}
          for f in sorted(findings, key=Finding.key)
      ]
  }
  path.write_text(json.dumps(payload, indent=2) + "\n")


def new_findings(findings: list[Finding], baseline: set[tuple]) -> list[Finding]:
  return [f for f in findings if f.key() not in baseline]


def format_finding(f: Finding) -> str:
  loc = f"{f.file}:{f.line}" if f.line else f.file
  via = f"  [via {f.entry}]" if f.entry else ""
  hint = f"\n    hint: {f.hint}" if f.hint else ""
  return f"{loc}: {f.rule}: {f.msg}{via}{hint}"
