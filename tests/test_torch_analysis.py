"""Tests for the port's hazard analyzer ``repro_torch.analysis`` (rules
T1-T8).

Each fixture in tests/torch_analysis_fixtures/ must trip exactly its own
rule and its clean twin nothing; the rank rules (T2, T7) run in one launch
of 2 gloo ranks.  The port's findings / suppression / baseline machinery
must answer as the reference's does on the same files, T3 and the
reference's R3 must agree on the same unmasked reduction, the port must
register every entry name the reference registers, ``--diff`` must prune,
and the committed tree must pass the CPU gate with no new finding and
without loading JAX or the reference package.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import ast_lint  # noqa: E402
from repro_torch.analysis import findings as F  # noqa: E402
from repro_torch.analysis import trace_check  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "torch_analysis_fixtures"
PKG = "tests.torch_analysis_fixtures"


def _env():
  return dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")


def _bug_lines(path: Path) -> set[int]:
  return {i for i, ln in enumerate(path.read_text().splitlines(), start=1)
          if "BUG" in ln}


def _trace(fx, fn, **kw):
  return trace_check.check_entry(fn, fx.args(), entry=f"fx:{fn.__name__}",
                                 repo_root=REPO, **kw)


def _case_t1(fx):
  bad = _trace(fx, fx.bad_scores, sync_budget=fx.BUDGET)
  good = _trace(fx, fx.good_scores, sync_budget=fx.BUDGET)
  assert "3 host sync(s)" in bad[0].msg and "budget 1" in bad[0].msg
  return bad, good


def _case_t3(fx):
  kw = dict(mask_positions=(1,), row_sizes=(fx.N_ROWS,))
  return _trace(fx, fx.bad_total_gain, **kw), _trace(fx, fx.good_total_gain,
                                                     **kw)


def _case_t4(fx):
  def run(fn):
    return trace_check.check_entry(fn, (torch.ones(3),), entry="fx:t4",
                                   repo_root=REPO)
  return run(fx.handle_request), run(fx.clean_request)


def _case_t6(fx):
  return _trace(fx, fx.bad_gram), _trace(fx, fx.good_gram)


# rule -> (fixture module, trace-layer case or None for an AST-only rule,
# whether the AST layer flags the fixture's BUG lines too, the module set
# of ast_lint the fixture is linted as a member of)
CASES = {
    "T1": ("fixture_t1_sync", _case_t1, False, None),
    "T3": ("fixture_t3_reduction", _case_t3, False, None),
    "T4": ("fixture_t4_build", _case_t4, True, None),
    "T5": ("fixture_t5_loop_sync", None, True, "HOT_PATH_FILES"),
    "T6": ("fixture_t6_tf32", _case_t6, True, None),
    "T8": ("fixture_t8_rowsum", None, True, "FIXED_ORDER_FILES"),
}


@pytest.mark.parametrize("rule", sorted(CASES))
def test_fixture_trips_only_its_rule(rule, monkeypatch):
  """The fixture's buggy function trips exactly ``rule``, at its BUG lines;
  its clean twin (and the allowed hoist points beside it) trip nothing."""
  import importlib
  name, case, ast_flags, member_of = CASES[rule]
  path = FIXTURES / f"{name}.py"
  bugs = _bug_lines(path)
  if member_of is not None:
    monkeypatch.setattr(ast_lint, member_of, getattr(ast_lint, member_of) |
                        {str(path.relative_to(REPO))})
  lint = ast_lint.lint_file(path, REPO)
  if ast_flags:
    assert lint and {f.rule for f in lint} == {rule}, lint
    assert {f.line for f in lint} <= bugs, (lint, bugs)
  else:
    assert lint == [], lint
  if case is not None:
    bad, good = case(importlib.import_module(f"{PKG}.{name}"))
    assert bad and {f.rule for f in bad} == {rule}, bad
    assert all(f.file == str(path.relative_to(REPO)) for f in bad), bad
    assert {f.line for f in bad} <= bugs, (bad, bugs)
    assert good == [], good
  assert lint or case is not None


def test_rank_rules_over_two_gloo_ranks():
  """One launch of 2 gloo ranks: T7 on the replicated sum (and not on its
  rank-varying twin), T2 at the collective only rank 1 issues (and not on
  ranks that agree).  The divergent entry runs last and ends the group."""
  from tests.torch_analysis_fixtures import fixture_ranks as fx
  found, recs = trace_check.check_ranked(
      fx.ENTRIES, 2, repo_root=REPO, imports=[f"{PKG}.fixture_ranks"])
  path = FIXTURES / "fixture_ranks.py"
  bugs = _bug_lines(path)
  by = {}
  for f in found:
    by.setdefault(f.entry, set()).add((f.rule, f.line))
  assert {r for r, _ in by["fx:t7_replicated"]} == {"T7"}, by
  assert {r for r, _ in by["fx:t2_divergent"]} == {"T2"}, by
  assert {ln for v in by.values() for _, ln in v} <= bugs, (by, bugs)
  assert "fx:t7_sharded" not in by and "fx:t2_agree" not in by, by
  for name in ("fx:t7_replicated", "fx:t7_sharded", "fx:t2_agree"):
    assert recs[name]["errors"] == {}, recs[name]
  assert recs["fx:t2_divergent"]["diverged"]


# ------------------------------------------- the reference's own machinery


SRC = """def f(x):
    a = g(x)  # repro: allow(T5)
    b = g(x)  # repro: allow(T5): one read-back, by contract
    # repro: allow(T4): loaded once by the caller
    c = h(x)
    # repro: allow(R4): wrong rule, must not suppress T4
    d = h(x)
    return a, b, c, d
"""


def test_findings_match_the_reference(tmp_path):
  """scan_suppressions, apply_suppressions, the baseline round trip (each
  side reading the other's file) and format_finding answer as the
  reference's on the same temporary files."""
  from repro.analysis import findings as RF
  p = tmp_path / "mod.py"
  p.write_text(SRC)
  assert F.scan_suppressions(p) == RF.scan_suppressions(p)
  assert F.scan_suppressions(tmp_path / "missing.py") == {}
  raw = [("T5", "mod.py", 2, "m2", "h", ""), ("T5", "mod.py", 3, "m3", "", ""),
         ("T4", "mod.py", 5, "m5", "", "e"), ("T4", "mod.py", 7, "m7", "", ""),
         ("T8", "mod.py", 8, "m8", "hint", "entry")]
  mine = [F.Finding(*r) for r in raw]
  ref = [RF.Finding(*r) for r in raw]
  got = F.apply_suppressions(mine, tmp_path)
  want = RF.apply_suppressions(ref, tmp_path)
  for g, w in zip(got, want):
    assert [(f.key(), f.hint) for f in g] == [(f.key(), f.hint) for f in w]
  assert [f.line for f in got[1]] == [3, 5]
  assert "justification missing" in got[0][0].hint
  assert [F.format_finding(f) for f in mine] == [RF.format_finding(f)
                                                 for f in ref]
  F.write_baseline(tmp_path / "mine.json", mine[:2])
  RF.write_baseline(tmp_path / "ref.json", ref[:2])
  assert (tmp_path / "mine.json").read_text() == (tmp_path /
                                                  "ref.json").read_text()
  assert F.load_baseline(tmp_path / "ref.json") == RF.load_baseline(
      tmp_path / "mine.json")
  base = F.load_baseline(tmp_path / "mine.json")
  assert F.new_findings(mine, base) == mine[2:]
  assert F.load_baseline(tmp_path / "none.json") == set()


def test_t3_and_r3_agree_on_the_same_reduction(subrun):
  """The same unmasked row reduction, once in torch (T3, this process) and
  once in jnp (R3, the reference's fixture through the subrun fixture):
  both flag it, both spare the masked twin."""
  from tests.torch_analysis_fixtures import fixture_t3_reduction as tfx
  bad, good = _case_t3(tfx)
  assert [f.rule for f in bad] == ["T3"] and good == []
  out = subrun("""
      import sys
      from pathlib import Path
      sys.path.insert(0, {repo!r})
      import jax, jax.numpy as jnp
      from repro.analysis import check_entry
      from tests.analysis_fixtures import fixture_unmasked_reduction as fx
      from tests.torch_analysis_fixtures import fixture_t3_reduction as tfx
      assert (fx.N_ROWS, fx.D) == (tfx.N_ROWS, tfx.D)
      args = (jax.ShapeDtypeStruct((fx.N_ROWS, fx.D), jnp.float32),
              jax.ShapeDtypeStruct((fx.N_ROWS,), jnp.int32),
              jax.ShapeDtypeStruct((fx.D,), jnp.float32))
      kw = dict(mask_positions=(1,), row_sizes=(fx.N_ROWS,),
                repo_root=Path({repo!r}))
      bad = check_entry(fx.bad_total_gain, args, entry="fx:bad", **kw)
      good = check_entry(fx.good_total_gain, args, entry="fx:good", **kw)
      print("RULES", sorted({{f.rule for f in bad}}), len(good))
      """.format(repo=str(REPO)), 1)
  assert "RULES ['R3'] 0" in out, out


def test_port_registers_every_reference_entry():
  """Every entry name the reference registers (29), and the two rank
  entries of the port's own."""
  from repro.analysis import entries as _ref_entries  # noqa: F401
  from repro.kernels import dispatch as rdispatch

  from repro_torch.analysis import entries as _entries  # noqa: F401
  from repro_torch.kernels import dispatch
  ref = {ep.name for ep in rdispatch.entry_points()}
  mine = {ep.name: ep for ep in dispatch.entry_points()
          if not ep.name.startswith("fx:")}  # the rank fixture's entries
  assert len(ref) == 29
  assert ref <= set(mine), sorted(ref - set(mine))
  assert set(mine) - ref == {"dist:greedi_sharded_fast", "dist:store_append"}
  assert {n for n, ep in mine.items() if ep.needs_ranks > 1} == set(
      mine) - ref
  assert all(ep.roots and all(ep.roots) for ep in mine.values())


# --------------------------------------------------------------- --diff


def test_modgraph_reachability_and_affected():
  from repro_torch.analysis import modgraph
  src = REPO / "src"
  g = modgraph.build_graph(src)
  r = modgraph.reachable(g, ["repro_torch.service.store"])
  assert "repro_torch.kernels.dispatch" in r
  assert "repro_torch.analysis.entries" not in r
  assert not any(m == "repro" or m.startswith("repro.") for m in g)
  aff = modgraph.affected_entries(
      {"kernels": ("repro_torch.kernels.ops",), "unknown": ("not.a.module",)},
      {"repro_torch.service.store"}, src)
  assert aff == {"kernels": False, "unknown": True}


def test_diff_prunes_entries_and_counts_cuda_sources():
  """A serve/-only change set runs no entry (exit 0, every name listed as
  unreachable); a change under kernels/csrc/ reaches every oracle entry
  through kernels.build."""
  from repro_torch.analysis import __main__ as cli
  from repro_torch.analysis import modgraph
  from repro_torch.kernels import dispatch
  out = subprocess.run(
      [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch",
       "--baseline", "analysis_baseline_torch.json", "--device", "cpu",
       "--ranks", "2", "--diff-files", "src/repro_torch/serve/serve_step.py"],
      cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
  assert out.returncode == 0, f"\n{out.stdout}\n{out.stderr}"
  assert "31 entry point(s) unreachable from the diff" in out.stdout
  assert "0 entry point(s) run" in out.stdout
  mods = cli._changed_modules(
      [REPO / "src/repro_torch/kernels/csrc/facility.cu"], REPO)
  assert mods == {"repro_torch.kernels.build"}
  aff = modgraph.affected_entries(
      {ep.name: ep.roots for ep in dispatch.entry_points()}, mods,
      REPO / "src")
  assert aff["oracle:facility_gain"] and aff["service:store_append"]


def test_diff_lints_only_changed_files(tmp_path):
  bug = ("import ctypes\n"
         "def handle_request(x):\n"
         "    return ctypes.CDLL(None)\n")
  (tmp_path / "changed.py").write_text(bug)
  (tmp_path / "unchanged.py").write_text(bug.replace("handle_request",
                                                     "other_request"))
  out = subprocess.run(
      [sys.executable, "-m", "repro_torch.analysis", str(tmp_path),
       "--ast-only", "--repo-root", str(tmp_path),
       "--diff-files", str(tmp_path / "changed.py")],
      cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
  assert out.returncode == 1, f"\n{out.stdout}\n{out.stderr}"
  assert "handle_request" in out.stdout and "other_request" not in out.stdout


# ------------------------------------------------------------- the gates


def test_cpu_gate_clean_and_loads_no_jax():
  """The CPU gate: every entry on the CPU, the rank entries over 2 gloo
  ranks, no new finding; the run loads neither JAX nor the reference."""
  code = """
import sys
from repro_torch.analysis.__main__ import main
rc = main(["src/repro_torch", "--baseline", "analysis_baseline_torch.json",
           "--device", "cpu", "--ranks", "2"])
print("RC", rc)
print("BAD", sorted(m for m in sys.modules if m.split(".")[0] in ("jax",
                                                                  "repro")))
"""
  out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=600)
  assert out.returncode == 0, f"\n{out.stdout}\n{out.stderr}"
  assert "0 new finding(s)" in out.stdout, out.stdout
  assert "31 entry point(s) run on cpu" in out.stdout, out.stdout
  assert "RC 0" in out.stdout and "BAD []" in out.stdout, out.stdout
  assert "skipped" not in out.stdout


def test_baseline_committed_empty_and_allows_have_reasons():
  assert F.load_baseline(REPO / "analysis_baseline_torch.json") == set()
  n = 0
  for p in (REPO / "src" / "repro_torch").rglob("*.py"):
    if p.parent.name == "analysis":  # its docs spell the syntax out
      continue
    for rule, why in F.scan_suppressions(p).values():
      n += 1
      assert rule.startswith("T") and why, (p, rule)
  assert n > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device "
                    "is the card where there is one")
def test_default_device_refuses_without_a_card(capsys):
  """Without ``--device cpu`` the trace layer asks for the card and exits
  2 where there is none: it never falls back to the CPU."""
  from repro_torch.analysis.__main__ import main
  assert main(["src/repro_torch", "--repo-root", str(REPO)]) == 2
  assert "CUDA is not available" in capsys.readouterr().err


@pytest.mark.cuda
def test_cuda_analysis_sweep():
  """The card sweep: every entry on the CUDA routes, T1 by the dispatch
  count and the sync debug mode, T4 and T6, the rank entries over 2 gloo
  ranks on the card: no new finding."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the sweep runs the CUDA routes")
  out = subprocess.run(
      [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch",
       "--baseline", "analysis_baseline_torch.json", "--ranks", "2"],
      cwd=REPO, env=_env(), capture_output=True, text=True, timeout=900)
  assert out.returncode == 0, f"\n{out.stdout}\n{out.stderr}"
  assert "0 new finding(s)" in out.stdout


@pytest.mark.cuda
def test_cuda_row_norms_layout_independent():
  """The last-axis sums the analyzer allows in the fixed-order modules
  (``objectives._sq_norm`` and the 0/1 mask counts) give each row the same
  bits whether one tensor holds all m shards or a rank's m / world of
  them (T8's suppressions rest on this)."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the layouts differ only on the card")
  from repro_torch.core.objectives import _sq_norm
  g = torch.Generator(device="cuda").manual_seed(0)
  for n, d in ((16, 16), (128, 64), (4096, 768), (16384, 16)):
    x = torch.randn(16, n, d, device="cuda", generator=g)
    mask = (torch.rand(16, n, device="cuda", generator=g) > 0.3).float()
    full, counts = _sq_norm(x), torch.sum(mask, dim=-1)
    for per in (1, 2, 4, 8):
      for r in range(16 // per):
        part = slice(r * per, (r + 1) * per)
        assert torch.equal(_sq_norm(x[part].contiguous()), full[part])
        assert torch.equal(torch.sum(mask[part].contiguous(), dim=-1),
                           counts[part])


# -------------------------------------------------- what the triage fixed


@pytest.mark.parametrize("deadline", [5.0, 0.1, 3, 1e40, -1e40, 1e-46, None,
                                      "float64"])
def test_liveness_deadline_filled_on_the_device_keeps_its_bits(deadline):
  """``greedi._prep_liveness`` fills a number deadline in on the device
  (the host tensor it made before was a blocking copy, one host sync every
  GreeDi call on the card: T1 by the card's sync debug mode); the float32
  deadline keeps the bits a tensor made from the number had."""
  from repro_torch.core.greedi import _prep_liveness
  if deadline == "float64":
    deadline = torch.tensor(0.3, dtype=torch.float64)
  _, got = _prep_liveness(torch.zeros(4), deadline, 4, "cpu")
  want = torch.as_tensor(float("inf") if deadline is None else
                         deadline).to(torch.float32)
  assert got.dtype == torch.float32 and got.shape == ()
  assert torch.equal(got, want)
  _, none = _prep_liveness(None, deadline, 4, "cpu")
  assert torch.equal(none, torch.tensor(float("inf")))


@pytest.mark.cuda
def test_cuda_greedi_makes_no_host_sync():
  """The standard GreeDi engines on the card, with and without liveness
  ages: no host sync in a call by the card's sync debug mode (the
  deadline was a blocking host-to-device copy before)."""
  import warnings
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: host syncs exist only on the card")
  from repro_torch.core import greedi as GD
  from repro_torch.core import objectives as O
  g = torch.Generator(device="cuda").manual_seed(0)
  x = torch.randn(512, 16, device="cuda", generator=g)
  ages = torch.tensor([0.0, 1.0, 2.0, 0.5], device="cuda")
  runs = (lambda a: GD.greedi_sharded_fast(
      x, m=4, kappa=8, k_final=8, kernel="linear", liveness_age=a,
      liveness_deadline=5.0),
          lambda a: GD.greedi_sharded(
      x, m=4, kappa=8, k_final=8, objective=O.FacilityLocation(
          kernel="linear"), liveness_age=a, liveness_deadline=5.0))
  for run in runs:
    for a in (ages, None):
      run(a)
      torch.cuda.synchronize()
      torch.cuda.set_sync_debug_mode("warn")
      try:
        with warnings.catch_warnings(record=True) as caught:
          warnings.simplefilter("always")
          run(a)
      finally:
        torch.cuda.set_sync_debug_mode("default")
      assert not [w for w in caught if "synchroniz" in str(w.message)]
