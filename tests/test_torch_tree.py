"""The port's accumulation-tree merge and ``greedi_hierarchical`` against
the JAX package (the oracles of tests/test_greedi_tree.py,
tests/test_greedi.py and tests/test_greedi_indices.py).

The level structure (factors, branch, peak rows, the ValueErrors) is
compared directly; ``tree_branch = m`` must give the flat merge's bits in
both engines (the port runs the flat merge as the one-level tree).  The
protocol runs against the reference's ``shard_map`` paths on 8 forced host
devices in one subprocess, on the same numpy inputs: ``sel_gids`` equal,
values and ``stage1_values`` within 1e-5 relative.  The corpora are unit
rows of a few separated clusters, so no greedy step is a near-tie.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import greedi as JG  # noqa: E402
from repro_torch import no_tf32  # noqa: E402
from repro_torch.core import greedi as TG  # noqa: E402
from repro_torch.core import objectives as TO  # noqa: E402

no_tf32()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clustered(seed, n, d, clusters=16, spread=0.05):
  """Unit rows around ``clusters`` random unit centres (numpy seed)."""
  r = np.random.default_rng(seed)
  c = r.normal(size=(clusters, d))
  x = c[r.integers(0, clusters, size=n)] + spread * r.normal(size=(n, d))
  return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


# ---------------------------------------------------------------------------
# the level structure, against the reference's helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,b", [(64, 4), (8, 2), (8, 8), (12, 4), (1, 1),
                                 (16, 4), (16, 16), (12, 8)])
def test_tree_factors_match_reference(m, b):
  try:
    want = JG._tree_factors(m, b)
  except ValueError as e:
    with pytest.raises(ValueError, match="does not factor"):
      TG._tree_factors(m, b)
    assert "does not factor" in str(e)
    return
  assert TG._tree_factors(m, b) == want
  plan = TG._merge_plan(m, "tree", b)
  assert tuple(lv.c for lv in plan) == want
  assert plan[-1].size == m and plan[-1].root
  assert not any(lv.root for lv in plan[:-1])


@pytest.mark.parametrize("m,b", [(64, None), (4, None), (8, 64), (8, 2),
                                 (1, None)])
def test_norm_branch_matches_reference(m, b):
  assert TG._norm_branch(m, b) == JG._norm_branch(m, b)


def test_norm_branch_rejects_one():
  for mod in (JG, TG):
    with pytest.raises(ValueError, match="tree_branch"):
      mod._norm_branch(8, 1)


@pytest.mark.parametrize("m,kappa,merge,b", [
    (64, 8, "flat", None), (64, 8, "tree", 4), (64, 8, "tree", 64),
    (12, 8, "tree", 4), (16, 64, "tree", 4), (16, 64, "tree", 16)])
def test_merge_peak_rows_match_reference(m, kappa, merge, b):
  assert (TG.merge_peak_rows(m, kappa, merge=merge, tree_branch=b)
          == JG.merge_peak_rows(m, kappa, merge=merge, tree_branch=b))


def test_tree_errors_and_validation():
  f = torch.tensor(_clustered(0, 64, 4))
  obj = TO.FacilityLocation()
  with pytest.raises(ValueError, match="merge"):
    TG.merge_peak_rows(8, 8, merge="ring")
  with pytest.raises(ValueError, match="merge"):
    TG.greedi_sharded_fast(f, m=4, kappa=2, k_final=2, merge="ring")
  with pytest.raises(ValueError, match="merge"):
    TG.greedi_sharded(f, m=4, kappa=2, k_final=2, objective=obj,
                      merge="ring")
  with pytest.raises(ValueError, match="mode"):
    TG.greedi_sharded_fast(f, m=4, kappa=2, k_final=2, mode="bogus")
  with pytest.raises(ValueError, match="does not factor"):
    TG.greedi_sharded_fast(torch.tensor(_clustered(0, 96, 4)), m=12,
                           kappa=2, k_final=2, merge="tree", tree_branch=8)
  with pytest.raises(ValueError, match="tree_branch"):
    TG.greedi_sharded(f, m=4, kappa=2, k_final=2, objective=obj,
                      merge="tree", tree_branch=1)
  from repro_torch.service import SelectionService
  with pytest.raises(ValueError, match="does not factor"):
    SelectionService(m=12, d=4, kappa=2, k_final=2, capacity=96,
                     merge="tree", tree_branch=8, device="cpu")
  # m = 1: the tree is the flat merge and still runs
  r = TG.greedi_sharded_fast(f[:16], m=1, kappa=2, k_final=2, merge="tree")
  assert bool(r.sel_valid.any())


def test_tree_quality():
  """A 3-level tree (m = 8, b = 2) stays near the centralized greedy (the
  reference's 0.85) and selects unique, valid gids in both engines."""
  f = torch.tensor(_clustered(1, 256, 12))
  obj = TO.FacilityLocation()
  _, v_c = TG.centralized_greedy(f, 8, objective=obj, init_for=obj.init)
  for r in (TG.greedi_sharded(f, m=8, kappa=8, k_final=8, objective=obj,
                              merge="tree", tree_branch=2),
            TG.greedi_sharded_fast(f, m=8, kappa=8, k_final=8, merge="tree",
                                   tree_branch=2)):
    assert bool(r.sel_valid.all()) and float(r.value / v_c) > 0.85
    sel = r.sel_gids.tolist()
    assert len(set(sel)) == 8 and min(sel) >= 0


# ---------------------------------------------------------------------------
# b = m is the flat merge, bit for bit (port only)
# ---------------------------------------------------------------------------


def _assert_same_bits(flat, tree):
  for name in ("sel_gids", "sel_valid", "value", "value_merged",
               "value_best_single", "stage1_values", "alive"):
    assert torch.equal(getattr(flat, name), getattr(tree, name)), name
  assert torch.equal(flat.sel_feats[flat.sel_valid],
                     tree.sel_feats[tree.sel_valid])


@pytest.mark.parametrize("engine", ["generic", "generic_u", "fast",
                                    "fast_rbf_holes"])
def test_tree_b_eq_m_bit_identical(engine):
  f = torch.tensor(np.random.default_rng(0).normal(size=(256, 12)),
                   dtype=torch.float32)
  gids = torch.arange(256)
  gids[::11] = -1
  if engine.startswith("generic"):
    obj = TO.FacilityLocation()
    run = lambda **kw: TG.greedi_sharded(  # noqa: E731
        f, m=8, kappa=8, k_final=10, objective=obj,
        u_subset_eval=engine == "generic_u", **kw)
  else:
    kw0 = (dict(kernel="rbf", kernel_kwargs=(("h", 2.0),), gids=gids)
           if engine == "fast_rbf_holes" else {})
    run = lambda **kw: TG.greedi_sharded_fast(  # noqa: E731
        f, m=8, kappa=8, k_final=10, **kw0, **kw)
  flat = run()
  _assert_same_bits(flat, run(merge="tree", tree_branch=8))
  _assert_same_bits(flat, run(merge="tree", tree_branch=64))
  tree = run(merge="tree", tree_branch=2)
  assert tree.stage1_values.shape == (2,)
  sel = tree.sel_gids[tree.sel_valid]
  assert len(set(sel.tolist())) == len(sel) > 0


def test_service_tree_epoch():
  """SelectionService(merge="tree"): b = m epochs select what the flat
  service selects, bit for bit; a multi-level tree serves valid epochs;
  the merged block's peak rows are b * kappa."""
  from repro_torch.service import SelectionService
  feats = torch.tensor(np.random.default_rng(0).normal(size=(512, 8)),
                       dtype=torch.float32)
  mk = dict(m=8, d=8, kappa=6, k_final=10, capacity=512, device="cpu")
  svcs = [SelectionService(**mk),
          SelectionService(merge="tree", tree_branch=8, **mk),
          SelectionService(merge="tree", tree_branch=2, **mk)]
  assert [s.merge_peak_rows for s in svcs] == [48, 48, 12]
  res = []
  for s in svcs:
    s.append(feats)
    res.append(s.epoch())
  assert np.array_equal(res[0].sel_gids, res[1].sel_gids)
  assert res[0].stats.value == res[1].stats.value
  sel = res[2].sel_gids
  assert sel.size == 10 and (sel >= 0).all() and np.unique(sel).size == 10
  assert res[2].stats.warm and res[2].stats.rescans.sum() > 0
  second = svcs[2].epoch()
  assert second.sel_gids.size == 10


def test_cli_merge_tree(tmp_path, capsys):
  """``--merge-tree B`` in the one-shot sharded and service modes: B = the
  shard count writes the flat merge's coreset, the done line says
  ``merge=treeB``."""
  from repro_torch.launch import select as cli
  common = ["--device", "cpu", "--n", "1024", "--d", "16", "--k", "8",
            "--no-coverage"]
  sels = {}
  for flags in ([], ["--merge-tree", "4"], ["--merge-tree", "2"]):
    out = tmp_path / f"sel{len(flags)}{''.join(flags)}.npy"
    cli.main([*common, "--mesh", "4", *flags, "--out", str(out)])
    sels[tuple(flags)] = np.load(out)
  cli.main([*common, "--mesh", "4", "--epochs", "2", "--append-frac", "0.25",
            "--merge-tree", "2"])
  done = [ln for ln in capsys.readouterr().out.splitlines()
          if ln.startswith("[select] done")]
  assert ["merge=flat" in done[0], "merge=tree4" in done[1],
          "merge=tree2" in done[2], "merge=tree2" in done[3]] == [True] * 4
  assert "mode=service" in done[3]
  np.testing.assert_array_equal(sels[()], sels[("--merge-tree", "4")])
  t2 = sels[("--merge-tree", "2")]
  assert len(t2) == 8 and len(set(t2.tolist())) == 8


# ---------------------------------------------------------------------------
# liveness through the tree (port only; the reference's own invariants)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,dead", [("leaf", [5]), ("interior", [2]),
                                       ("subtree", [4, 5, 6, 7])])
def test_tree_liveness_kills(name, dead):
  """Kill a leaf, an interior node (a subtree's first shard, its default
  Thm-10 holder) and a whole root-child subtree: the dead shards are
  reported in ``alive``, and neither their candidates nor their
  evaluation mass reach any level (scrambling their rows changes
  nothing)."""
  f = _clustered(2, 256, 12)
  npp = 256 // 8
  ages = torch.zeros(8)
  ages[dead] = 9.9
  kw = dict(m=8, kappa=6, k_final=10, liveness_age=ages,
            liveness_deadline=1.0, merge="tree", tree_branch=2)
  r = TG.greedi_sharded_fast(torch.tensor(f), **kw)
  assert not bool(r.alive[dead].any()) and int(r.alive.sum()) == 8 - len(dead)
  dead_rows = np.concatenate([np.arange(i * npp, (i + 1) * npp)
                              for i in dead])
  sel = r.sel_gids[r.sel_valid].numpy()
  assert sel.size and not np.isin(sel, dead_rows).any()
  f2 = f.copy()
  f2[dead_rows] = 1e3 * np.arange(len(dead_rows) * 12).reshape(-1, 12)
  r2 = TG.greedi_sharded_fast(torch.tensor(f2), **kw)
  assert torch.equal(r.sel_gids, r2.sel_gids) and torch.equal(r.value,
                                                              r2.value)
  # the generic engine selects what the fast one does under the same kills
  g = TG.greedi_sharded(torch.tensor(f), objective=TO.FacilityLocation(),
                        **kw)
  assert torch.equal(g.sel_gids, r.sel_gids)
  # Thm 10 inside the tree: a dead holder's subtree re-elects its next
  # alive member, so the value stays finite and positive
  u = TG.greedi_sharded(torch.tensor(f), objective=TO.FacilityLocation(),
                        u_subset_eval=True, **kw)
  assert np.isfinite(float(u.value)) and float(u.value) > 0


# ---------------------------------------------------------------------------
# the protocol against the reference's shard_map paths (8 host devices)
# ---------------------------------------------------------------------------


def test_tree_and_hierarchical_match_reference(subrun):
  """One subprocess, 8 forced host devices, each case against the
  reference on the same inputs: a 3-level tree (m = 8, b = 2) in the
  generic engine with an interior node dead (the liveness collective at
  every level), the port's fast engine selecting the same; and
  ``greedi_hierarchical`` over 2 pods x 4 with stragglers and hole rows,
  above 0.8 of the centralized greedy."""
  out = subrun(r"""
import jax, jax.numpy as jnp, numpy as np, torch
from repro.core import greedi as JG, objectives as JO
from repro.util import make_mesh
from repro_torch import no_tf32
from repro_torch.core import greedi as TG, objectives as TO
no_tf32()

def clustered(seed, n, d, clusters=16, spread=0.05):
  r = np.random.default_rng(seed)
  c = r.normal(size=(clusters, d))
  x = c[r.integers(0, clusters, size=n)] + spread * r.normal(size=(n, d))
  return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

def same(tr, jr, what):
  assert np.array_equal(tr.sel_gids.numpy(), np.asarray(jr.sel_gids)), (
      what, tr.sel_gids.tolist(), np.asarray(jr.sel_gids).tolist())
  assert np.array_equal(tr.alive.numpy(), np.asarray(jr.alive)), what
  for name in ("value", "value_merged", "value_best_single",
               "stage1_values"):
    np.testing.assert_allclose(getattr(tr, name).numpy(),
                               np.asarray(getattr(jr, name)), rtol=1e-5,
                               err_msg=f"{what} {name}")

mesh8 = make_mesh((8,), ("data",))
f = clustered(1, 256, 12)
jf, tf = jnp.asarray(f), torch.tensor(f)
jo, to = JO.FacilityLocation(kernel="linear"), TO.FacilityLocation()
_, v_c = TG.centralized_greedy(tf, 8, objective=to, init_for=to.init)
ages = np.zeros(8, np.float32)
ages[2] = 9.9   # an interior node: the first shard of subtrees {2, 3}, ...
kw = dict(kappa=8, k_final=8, merge="tree", tree_branch=2,
          liveness_deadline=1.0)
jr = JG.greedi_sharded(jf, mesh=mesh8, objective=jo,
                       liveness_age=jnp.asarray(ages), **kw)
tr = TG.greedi_sharded(tf, m=8, objective=to,
                       liveness_age=torch.tensor(ages), **kw)
same(tr, jr, "generic b=2, shard 2 dead")
assert tr.stage1_values.shape == (2,)   # one value per root child
trf = TG.greedi_sharded_fast(tf, m=8, liveness_age=torch.tensor(ages), **kw)
assert np.array_equal(trf.sel_gids.numpy(), tr.sel_gids.numpy())
np.testing.assert_allclose(trf.value.numpy(), tr.value.numpy(), rtol=1e-5)
print("TREE_OK")

mesh24 = make_mesh((2, 4), ("pod", "data"))
keep = np.array([True, False, True, True, True, True, False, False])
gids = np.arange(256)
gids[::7] = -1
jr = JG.greedi_hierarchical(jf, mesh=mesh24, kappa=8, k_final=8,
                            objective=jo, straggler_keep=jnp.asarray(keep),
                            gids=jnp.asarray(gids))
tr = TG.greedi_hierarchical(tf, pods=2, per_pod=4, kappa=8, k_final=8,
                            objective=to, straggler_keep=torch.tensor(keep),
                            gids=torch.tensor(gids))
same(tr, jr, "hierarchical")
assert tr.stage1_values.shape == (2,)   # one value per pod
assert float(tr.value / v_c) > 0.8
g = tr.sel_gids[tr.sel_valid].numpy()
assert (g >= 0).all() and len(set(g)) == len(g) == 8
assert not np.isin(g, np.arange(0, 256, 7)).any()
np.testing.assert_allclose(f[g], tr.sel_feats[tr.sel_valid].numpy(),
                           atol=1e-6)
print("HIER_OK")
""", n_devices=8)
  assert "TREE_OK" in out and "HIER_OK" in out


def test_hierarchical_port_invariants():
  """``greedi_hierarchical`` without stragglers stays near the
  centralized greedy (the reference's 0.85); dead shards' rows are
  immaterial (scrambled, the result is the same); gids map to rows."""
  f = _clustered(1, 256, 12)
  obj = TO.FacilityLocation()
  tf = torch.tensor(f)
  _, v_c = TG.centralized_greedy(tf, 8, objective=obj, init_for=obj.init)
  r = TG.greedi_hierarchical(tf, pods=2, per_pod=4, kappa=8, k_final=8,
                             objective=obj)
  assert float(r.value / v_c) > 0.85
  g = r.sel_gids[r.sel_valid].numpy()
  np.testing.assert_allclose(f[g], r.sel_feats[r.sel_valid].numpy(),
                             atol=1e-6)
  keep = torch.tensor([True, False, True, True, True, True, False, False])
  f_bad = f.copy()
  f_bad[32:64] = 9.0
  f_bad[192:] = -7.0
  a = TG.greedi_hierarchical(tf, pods=2, per_pod=4, kappa=8, k_final=8,
                             objective=obj, straggler_keep=keep)
  b = TG.greedi_hierarchical(torch.tensor(f_bad), pods=2, per_pod=4,
                             kappa=8, k_final=8, objective=obj,
                             straggler_keep=keep)
  assert torch.equal(a.sel_gids, b.sel_gids) and torch.equal(a.value,
                                                              b.value)
  assert bool((a.r1_rescans == 0).all())   # standard round 1
