"""CLI: ``python -m repro_torch.analysis [paths] --baseline
analysis_baseline_torch.json [--device cpu|cuda] [--ranks N]``.

Exit status: 0 when every finding is suppressed or already in the baseline,
1 on new unsuppressed findings, 2 on analyzer errors (an entry point that
fails to run is a broken entry registration, not a clean bill; so is a
missing card when the default device is asked for).

The trace layer runs on the card unless ``--device cpu`` is passed; it
never falls back to the CPU.  Entries that need ranks (``needs_ranks``)
run only with ``--ranks`` at least that many: each group of them is one
``torch.distributed.run`` launch of gloo ranks on this host
(``trace_check.check_ranked``); the summary line names every entry it
skipped.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

_CSRC = "src/repro_torch/kernels/csrc/"


def _changed_files(ref: str | None, explicit: list[str] | None,
                   root: Path) -> list[Path]:
  """The change set of a --diff run: an explicit file list, or the git diff
  of the working tree vs ``ref`` plus untracked files (so the mode sees
  exactly what a PR would ship)."""
  out: list[Path] = []
  if explicit is not None:
    out.extend((root / f) if not Path(f).is_absolute() else Path(f)
               for f in explicit)
  if ref is not None:
    import subprocess
    for cmd in (["git", "diff", "--name-only", ref],
                ["git", "ls-files", "--others", "--exclude-standard"]):
      res = subprocess.run(cmd, cwd=root, capture_output=True, text=True)
      if res.returncode != 0:
        raise SystemExit(f"--diff: {' '.join(cmd)} failed: "
                         f"{res.stderr.strip()}")
      out.extend(root / line for line in res.stdout.splitlines() if line)
  return out


def _changed_modules(changed: list[Path], root: Path) -> set[str]:
  from repro_torch.analysis import modgraph
  src_root = root / "src"
  mods = {m for m in (modgraph.module_name(p, src_root) for p in changed)
          if m is not None}
  # the CUDA sources are reached through the module that builds and loads
  # them, not through an import
  for p in changed:
    try:
      rel = str(p.resolve().relative_to(root))
    except ValueError:
      continue
    if rel.startswith(_CSRC):
      mods.add("repro_torch.kernels.build")
  return mods


def _trace(args, root: Path, changed_modules, report: dict, findings: list,
           seen: set) -> tuple[list, list, int]:
  """Run the registered entries; returns (skipped, pruned, status)."""
  from repro_torch import resolve_device
  from repro_torch.analysis import entries as _entries  # noqa: F401
  from repro_torch.analysis import trace_check
  from repro_torch.kernels import dispatch

  try:
    dev = resolve_device(args.device)
  except RuntimeError as e:
    print(f"ERROR: {e} (the trace layer never falls back to the CPU)",
          file=sys.stderr)
    return [], [], 2
  affected = None
  if changed_modules is not None:
    from repro_torch.analysis import modgraph
    affected = modgraph.affected_entries(
        {ep.name: ep.roots for ep in dispatch.entry_points()},
        changed_modules, root / "src")

  def add(fs):
    for f in fs:
      if f.key() not in seen:  # one finding per hazard, not per entry
        seen.add(f.key())
        findings.append(f)

  skipped, pruned, ranked = [], [], {}
  for ep in dispatch.entry_points():
    if affected is not None and not affected.get(ep.name, True):
      pruned.append(ep.name)
    elif ep.needs_ranks > args.ranks:
      skipped.append(f"{ep.name} (needs {ep.needs_ranks} ranks, "
                     f"--ranks {args.ranks})")
    elif ep.needs_ranks > 1:
      ranked.setdefault(ep.needs_ranks, []).append(ep.name)
    else:
      try:
        run = trace_check.run_entry(ep, dev, repo_root=root)
      except Exception as e:  # a broken entry is an analyzer error
        traceback.print_exc()
        print(f"ERROR running entry {ep.name}: {type(e).__name__}: {e}",
              file=sys.stderr)
        return skipped, pruned, 2
      report[ep.name] = dict(
          syncs=run.syncs, debug_syncs=run.debug_syncs, budget=run.budget,
          builds=run.builds, seconds=run.seconds, sync_sites=run.sync_sites)
      add(run.findings)
  for world, names in sorted(ranked.items()):
    fs, recs = trace_check.check_ranked(names, world, device=dev.type,
                                        repo_root=root)
    for name, rec in recs.items():
      report[name] = dict(
          syncs=rec.get("syncs"), debug_syncs=rec.get("debug_syncs"),
          budget=rec.get("budget"), seconds=rec.get("seconds"), ranks=world,
          sync_sites=rec.get("sync_sites"))
      if rec["errors"] and not rec["diverged"]:
        print(rec.get("traceback", ""), file=sys.stderr)
        print(f"ERROR running entry {name} over {world} ranks: "
              f"{rec['errors']}", file=sys.stderr)
        return skipped, pruned, 2
    add(fs)
  return skipped, pruned, 0


def main(argv: list[str] | None = None) -> int:
  ap = argparse.ArgumentParser(
      prog="python -m repro_torch.analysis",
      description="dispatch-trace + AST hazard analyzer of the port (rules "
      "T1-T8, docs/analysis_torch.md)")
  ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                  help="files/directories to AST-lint (default: "
                  "src/repro_torch)")
  ap.add_argument("--baseline", type=Path, default=None,
                  help="known-findings file; fail only on NEW findings")
  ap.add_argument("--write-baseline", action="store_true",
                  help="write the current findings to --baseline and exit 0")
  ap.add_argument("--device", default="cuda",
                  help="device of the trace layer's runs: cuda (default; "
                  "raises without a card) or cpu")
  ap.add_argument("--ranks", type=int, default=1,
                  help="most gloo ranks an entry may run over; entries "
                  "needing more are skipped and named")
  ap.add_argument("--ast-only", action="store_true",
                  help="skip the trace layer (runs nothing, no device)")
  ap.add_argument("--repo-root", type=Path, default=Path.cwd())
  ap.add_argument("--diff", metavar="REF", default=None,
                  help="O(PR) mode: AST-lint only files changed vs the git "
                  "ref (working tree + untracked included) and run only "
                  "entry points whose import closure reaches a changed "
                  "module (repro_torch.analysis.modgraph)")
  ap.add_argument("--diff-files", nargs="*", default=None, metavar="FILE",
                  help="like --diff but with an explicit changed-file list "
                  "(no git needed)")
  ap.add_argument("--json", type=Path, default=None,
                  help="write each entry's sync counts and seconds here")
  args = ap.parse_args(argv)
  t0 = time.perf_counter()

  from repro_torch.analysis import ast_lint, findings as F

  root = args.repo_root.resolve()
  files: list[Path] = []
  for p in args.paths:
    pp = (root / p).resolve() if not Path(p).is_absolute() else Path(p)
    if pp.is_dir():
      files.extend(pp.rglob("*.py"))
    elif pp.suffix == ".py":
      files.append(pp)

  # --diff: restrict the whole run to the change set.  The AST layer lints
  # only changed files; the trace layer prunes entry points through the
  # static import graph (an entry whose closure misses every changed module
  # cannot run differently than it did on the base ref).
  changed_modules: set[str] | None = None
  if args.diff is not None or args.diff_files is not None:
    changed = _changed_files(args.diff, args.diff_files, root)
    changed_set = {p.resolve() for p in changed}
    files = [f for f in files if f.resolve() in changed_set]
    changed_modules = _changed_modules(changed, root)
  all_findings = ast_lint.lint_paths(files, root)

  skipped: list[str] = []
  pruned: list[str] = []
  report: dict = {}
  if not args.ast_only:
    seen = {f.key() for f in all_findings}
    skipped, pruned, status = _trace(args, root, changed_modules, report,
                                     all_findings, seen)
    if status:
      return status

  active, suppressed = F.apply_suppressions(all_findings, root)

  if args.write_baseline:
    if args.baseline is None:
      print("--write-baseline needs --baseline", file=sys.stderr)
      return 2
    F.write_baseline(args.baseline, active)
    print(f"wrote {len(active)} finding(s) to {args.baseline}")
    return 0

  baseline = F.load_baseline(args.baseline) if args.baseline else set()
  new = F.new_findings(active, baseline)
  known = len(active) - len(new)

  for f in sorted(new, key=F.Finding.key):
    print(F.format_finding(f))
  tail = (f"{len(new)} new finding(s), {known} baselined, "
          f"{len(suppressed)} suppressed")
  if not args.ast_only:
    tail += f"; {len(report)} entry point(s) run on {args.device}"
  if skipped:
    tail += f"; {len(skipped)} entry point(s) skipped: {', '.join(skipped)}"
  if pruned:
    tail += (f"; {len(pruned)} entry point(s) unreachable from the "
             f"diff: {', '.join(pruned)}")
  print(tail)
  if args.json is not None:
    args.json.write_text(json.dumps(dict(
        entries=report, new=[F.format_finding(f) for f in new],
        suppressed=len(suppressed), skipped=skipped, pruned=pruned,
        seconds=time.perf_counter() - t0), indent=1) + "\n")
  return 1 if new else 0


if __name__ == "__main__":
  sys.exit(main())
