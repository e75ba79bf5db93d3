"""The port's GP active-set path (information gain, DPP log-det) through
greedy, GreeDi, the naive baselines and the generic sharded engine, against
the JAX reference on the same inputs.

The reference draws its randomness (the partition, the U subset, the
baselines' random picks) with ``jax.random``; the port receives those draws
as explicit arguments.  Selected ids are compared only after
``_assert_separated`` has checked that no greedy step of the run has a
near-tie: every step's top-2 gain gap is either exactly 0 (an exact tie,
which both sides break to the lowest index, as at the first rbf step where
every candidate has cond = 1 + sigma^2) or above 1e-4 relative.  Values are
held within 1e-5 relative (f32).

The generic ``greedi_sharded`` is held against the port's own
``greedi_reference`` on the same partition (information gain does not
depend on the evaluation set, so the two protocols select alike), against
``greedi_sharded_fast`` for facility location, and in one subprocess on 4
forced host devices against the reference's ``shard_map`` engine with
holes, a dead shard, liveness and the Thm-10 subset.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.common import parkinsons_like, tiny_images_like  # noqa: E402
from repro.core import greedi as JG  # noqa: E402
from repro.core import objectives as JO  # noqa: E402
from repro.core.greedy import greedy as j_greedy  # noqa: E402
from repro.core.partition import random_partition  # noqa: E402
from repro_torch import interop, no_tf32  # noqa: E402
from repro_torch.core import bounds  # noqa: E402
from repro_torch.core import greedi as TG  # noqa: E402
from repro_torch.core import objectives as TO  # noqa: E402
from repro_torch.core.greedy import greedy as t_greedy  # noqa: E402
from repro_torch.core.partition import partition_gids  # noqa: E402
from repro_torch.core.partition import random_partition as t_partition  # noqa: E402,E501
from repro_torch.data import selection as TS  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
no_tf32()  # full-FP32 products in the plain versions, as on the card

D = 8


def _data(n, seed, scale=1.0):
  r = np.random.default_rng(seed)
  return (scale * r.normal(size=(n, D)) / np.sqrt(D)).astype(np.float32)


def _ig(k_max, kernel="rbf", sigma=0.7):
  # h = 1.5: at h = 0.75 most of these points lie in each other's far
  # field, where conds differ by less than f32 noise late in a run
  kw = (("h", 1.5),) if kernel == "rbf" else ()
  return (JO.InformationGain(k_max=k_max, kernel=kernel, kernel_kwargs=kw,
                             sigma=sigma, backend="ref"),
          TO.InformationGain(k_max=k_max, kernel=kernel, kernel_kwargs=kw,
                             sigma=sigma))


def _dpp(k_max):
  return (JO.LogDetDPP(k_max=k_max, kernel="linear", kernel_kwargs=(),
                       backend="ref"),
          TO.LogDetDPP(k_max=k_max, kernel="linear", kernel_kwargs=()))


def _inits(jobj, tobj, d):
  return (lambda ef, em: jobj.init_d(d)), (lambda ef, em: tobj.init_d(d))


def _assert_separated(obj, state, cands, k, mask):
  """No step of a (batched) greedy run over ``cands`` has a near-tie: the
  top-2 feasible gain gap is exactly 0 or above 1e-4 relative."""
  sel = torch.zeros(mask.shape, dtype=torch.bool)
  for _ in range(k):
    ok = mask & ~sel
    g = torch.where(ok, obj.gains(state, cands), -1e30)
    top = torch.topk(g, 2, dim=-1)
    live = ok.sum(-1) >= 2
    gap = (top.values[..., 0] - top.values[..., 1]) / top.values[..., 0].abs()
    near = live & (gap > 0) & (gap <= 1e-4)
    assert not bool(near.any()), f"near-tie, gap {gap[near].tolist()}"
    i = torch.argmax((g == g.max(-1, keepdim=True).values).to(torch.int8),
                     dim=-1)   # the lowest index of the maximum
    feat = torch.gather(cands, -2, i[..., None, None].expand(
        *i.shape, 1, cands.shape[-1])).squeeze(-2)
    state = obj.update(state, feat)
    sel = sel.scatter(-1, i[..., None], True)


def _reference_partition(rng, feats, m):
  r_part, _, _, r_u = JG.greedi_keys(rng)
  _, _, perm = random_partition(r_part, jnp.asarray(feats), m)
  return np.asarray(perm), r_u


@pytest.mark.parametrize("name,kernel", [("ig", "rbf"), ("ig", "linear"),
                                         ("dpp", "linear")])
def test_greedy_trajectory_matches_jax(name, kernel):
  """Greedy over one candidate block, fused select and two-pass steps:
  equal ids, values within 1e-5; the DPP runs with stop_nonpositive."""
  k = 10
  x = _data(128, 0)
  if name == "dpp":
    x = 2.0 * x  # norms above 1: positive log-det gains for a while
    jobj, tobj = _dpp(13)
  else:
    jobj, tobj = _ig(13, kernel)
  stop = name == "dpp"
  tx = torch.tensor(x)
  _assert_separated(tobj, tobj.init_d(D), tx, k,
                    torch.ones(128, dtype=torch.bool))
  jr = j_greedy(jobj, jobj.init_d(D), jnp.asarray(x), k,
                stop_nonpositive=stop)
  for use_select in (True, False):
    tr = t_greedy(tobj, tobj.init_d(D), tx, k, stop_nonpositive=stop,
                  use_select=use_select)
    np.testing.assert_array_equal(tr.idx.numpy(), np.asarray(jr.idx))
    np.testing.assert_allclose(tr.values.numpy(), np.asarray(jr.values),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr.gains.numpy(), np.asarray(jr.gains),
                               rtol=1e-5, atol=1e-6)
  if name == "dpp":  # the run stopped early: its tail is no-ops
    assert (np.asarray(jr.idx) == -1).any()


@pytest.mark.parametrize("name", ["ig", "dpp"])
def test_greedi_reference_and_centralized_match_jax(name):
  """greedi_reference with the reference's partition, and the centralized
  greedy: equal sel_gids, values within 1e-5; the Thm-4 floor holds."""
  n, m, k = 200, 4, 6
  x = _data(n, 0)
  if name == "dpp":
    x = 2.0 * x
    jobj, tobj = _dpp(8)
  else:
    jobj, tobj = _ig(8)
  stop = name == "dpp"
  jinit, tinit = _inits(jobj, tobj, D)
  rng = jax.random.PRNGKey(2)
  perm, _ = _reference_partition(rng, x, m)
  tx = torch.tensor(x)
  parts, pmask, _ = t_partition(None, tx, m, perm=interop.perm(perm))
  _assert_separated(tobj, tobj.broadcast(tobj.init_d(D), m), parts, k,
                    pmask)
  _assert_separated(tobj, tobj.init_d(D), tx, k,
                    torch.ones(n, dtype=torch.bool))
  r1 = t_greedy(tobj, tobj.broadcast(tobj.init_d(D), m), parts, k,
                cand_mask=pmask, stop_nonpositive=stop)
  _assert_separated(tobj, tobj.init_d(D), r1.feats.reshape(-1, D), k,
                    (r1.idx >= 0).reshape(-1))
  jr = JG.greedi_reference(rng, jnp.asarray(x), m=m, kappa=k, k_final=k,
                           objective=jobj, init_for=jinit,
                           stop_nonpositive=stop)
  tr = interop.to_numpy(TG.greedi_reference(
      None, tx, m=m, kappa=k, k_final=k, objective=tobj, init_for=tinit,
      stop_nonpositive=stop, perm=interop.perm(perm)))
  np.testing.assert_array_equal(tr.sel_gids, np.asarray(jr.sel_gids))
  for f in ("value", "value_merged", "value_best_single", "stage1_values"):
    np.testing.assert_allclose(getattr(tr, f), np.asarray(getattr(jr, f)),
                               rtol=1e-5, atol=1e-6)
  jc, jv = JG.centralized_greedy(jnp.asarray(x), k, objective=jobj,
                                 init_for=jinit, stop_nonpositive=stop)
  tc, tv = TG.centralized_greedy(tx, k, objective=tobj, init_for=tinit,
                                 stop_nonpositive=stop)
  np.testing.assert_array_equal(tc.idx.numpy(), np.asarray(jc.idx))
  np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
  if name == "ig":  # Thm 4 (monotone objectives): f(A_gd) >= floor * OPT
    assert float(tr.value) >= bounds.thm4_bound(m, k) * float(tv) - 1e-6


def test_thm4_floor_over_seeds():
  """The port of test_greedi.py's Thm-4 check for information gain, on
  the port's own generator path: the floor holds for every seed."""
  k, m = 6, 4
  r = np.random.default_rng(12)
  x = r.normal(size=(96, D)).astype(np.float32)
  x /= np.linalg.norm(x, axis=1, keepdims=True)
  tobj = TO.InformationGain(k_max=k, kernel="rbf", sigma=0.7)
  tx = torch.tensor(x)
  _, v_c = TG.centralized_greedy(tx, k, objective=tobj,
                                 init_for=lambda ef, em: tobj.init_d(D))
  floor = bounds.thm4_bound(m, k)
  for s in range(3):
    res = TG.greedi_reference(torch.Generator().manual_seed(s), tx, m=m,
                              kappa=k, k_final=k, objective=tobj,
                              init_for=lambda ef, em: tobj.init_d(D))
    assert float(res.value) >= floor * float(v_c) - 1e-6, s
    g = res.sel_gids[res.sel_valid].numpy()
    assert len(set(g.tolist())) == len(g) and ((g >= 0) & (g < 96)).all()


def test_baselines_match_jax_with_injected_draws():
  """random/random, random/greedy, greedy/merge and greedy/max with the
  reference's partition and random picks: values within 1e-5."""
  n, m, k = 150, 5, 4
  x = _data(n, 5)
  jobj, tobj = _ig(k)
  jinit, tinit = _inits(jobj, tobj, D)
  rng = jax.random.PRNGKey(7)
  want = JG.baselines(rng, jnp.asarray(x), m=m, k=k, objective=jobj,
                      init_for=jinit)
  # the reference's draws, taken the way baselines() takes them
  r_part, r_a, r_b = jax.random.split(rng, 3)
  _, pmask, perm = random_partition(r_part, jnp.asarray(x), m)
  npp = pmask.shape[1]
  rr_idx = jax.random.choice(r_a, n, (k,), replace=False)

  def pick_rand(key, mask_row):
    pr = jax.random.uniform(key, (npp,)) - jnp.where(mask_row, 0.0, 1e9)
    return jax.lax.top_k(pr, min(k, npp))[1]
  rand_idx = jax.vmap(pick_rand)(jax.random.split(r_b, m), pmask)
  got = TG.baselines(None, torch.tensor(x), m=m, k=k, objective=tobj,
                     init_for=tinit, perm=interop.perm(perm),
                     rr_idx=np.array(rr_idx), rand_idx=np.array(rand_idx))
  assert sorted(got) == sorted(want)
  for key in want:
    np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5,
                               err_msg=key)
  # the port's own draws: valid values below the centralized greedy's
  own = TG.baselines(torch.Generator().manual_seed(0), torch.tensor(x), m=m,
                     k=k, objective=tobj, init_for=tinit)
  _, v_c = TG.centralized_greedy(torch.tensor(x), k, objective=tobj,
                                 init_for=tinit)
  for key, v in own.items():
    assert 0.0 < float(v) <= float(v_c) + 1e-5, key


def _sharded_layout(x, perm, m):
  tx = torch.tensor(x)
  parts, _, tperm = t_partition(None, tx, m, perm=interop.perm(perm))
  npp = parts.shape[1]
  return parts.reshape(m * npp, x.shape[1]), partition_gids(tperm)


@pytest.mark.parametrize("n", [200, 197])
def test_generic_sharded_equals_reference_for_ig(n):
  """Information gain does not depend on the evaluation set, so the
  generic engine over stacked shards selects what greedi_reference selects
  on the same partition, with holes (n = 197 on 4 shards) and under the
  Thm-10 subset alike."""
  m, k = 4, 6
  x = _data(n, 6)
  _, tobj = _ig(8)
  perm, _ = _reference_partition(jax.random.PRNGKey(3), x, m)
  tx = torch.tensor(x)
  parts, pmask, _ = t_partition(None, tx, m, perm=interop.perm(perm))
  _assert_separated(tobj, tobj.broadcast(tobj.init_d(D), m), parts, k,
                    pmask)
  ref = TG.greedi_reference(None, tx, m=m, kappa=k, k_final=k,
                            objective=tobj,
                            init_for=lambda ef, em: tobj.init_d(D),
                            perm=interop.perm(perm))
  feats_sh, gids = _sharded_layout(x, perm, m)
  for u_subset in (False, True):
    got = TG.greedi_sharded(feats_sh, m=m, kappa=k, k_final=k,
                            objective=tobj, gids=gids,
                            u_subset_eval=u_subset)
    np.testing.assert_array_equal(got.sel_gids.numpy(), ref.sel_gids.numpy())
    for f in ("value", "value_merged", "value_best_single",
              "stage1_values"):
      np.testing.assert_allclose(getattr(got, f).numpy(),
                                 getattr(ref, f).numpy(), rtol=1e-5)
    assert got.alive.all()
    g = got.sel_gids[got.sel_gids >= 0].numpy()
    assert len(set(g.tolist())) == len(g) and (g < n).all()


def test_generic_sharded_stragglers_and_liveness():
  """A heartbeat past its deadline drops its shard exactly as
  straggler_keep does: the dead shard's rows are never selected, it
  reports -inf in stage1_values, and ``alive`` says so.  With no stragglers
  the liveness collective keeps everyone."""
  n, m, k = 200, 4, 5
  x = _data(n, 8)
  _, tobj = _ig(8)
  perm, _ = _reference_partition(jax.random.PRNGKey(4), x, m)
  feats_sh, gids = _sharded_layout(x, perm, m)
  common = dict(m=m, kappa=k, k_final=k, objective=tobj, gids=gids)
  keep = torch.tensor([True, False, True, True])
  a = TG.greedi_sharded(feats_sh, straggler_keep=keep, **common)
  b = TG.greedi_sharded(feats_sh, liveness_age=torch.tensor([0., 5., 0., 1.]),
                        liveness_deadline=2.0, **common)
  c = TG.greedi_sharded(feats_sh, liveness_age=torch.tensor([0., 5., 0., 1.]),
                        liveness_deadline=2.0,
                        straggler_keep=torch.tensor([True, True, False,
                                                     True]), **common)
  everyone = TG.greedi_sharded(feats_sh, liveness_age=torch.zeros(m),
                               liveness_deadline=2.0, **common)
  assert a.alive.tolist() == b.alive.tolist() == [True, False, True, True]
  assert c.alive.tolist() == [True, False, False, True]
  assert everyone.alive.all()
  np.testing.assert_array_equal(a.sel_gids.numpy(), b.sel_gids.numpy())
  assert a.stage1_values[1] == -torch.inf
  dead_rows = set(np.asarray(perm)[1].tolist())
  assert not dead_rows & set(a.sel_gids.tolist())
  assert not (dead_rows | set(np.asarray(perm)[2].tolist())) & set(
      c.sel_gids.tolist())
  # the tree merge (ported since): b = m is the flat merge, bit for bit;
  # a two-level tree keeps the dead shard out as well
  tree = TG.greedi_sharded(feats_sh, straggler_keep=keep, merge="tree",
                           tree_branch=m, **common)
  assert torch.equal(tree.sel_gids, a.sel_gids)
  assert torch.equal(tree.value, a.value)
  two = TG.greedi_sharded(feats_sh, straggler_keep=keep, merge="tree",
                          tree_branch=2, **common)
  sel = two.sel_gids[two.sel_valid].tolist()
  assert len(set(sel)) == len(sel) == k and not dead_rows & set(sel)
  # the lazy round 1 (ported since) selects what the standard one does
  lazy = TG.greedi_sharded(feats_sh, straggler_keep=keep, mode="lazy",
                           **common)
  np.testing.assert_array_equal(lazy.sel_gids.numpy(), a.sel_gids.numpy())
  assert (lazy.r1_rescans > 0).all() and not a.r1_rescans.any()


@pytest.mark.parametrize("keep", [None, [True] * 3 + [False] + [True] * 4])
def test_generic_sharded_equals_fast_for_facility_location(keep):
  """Facility location through the generic engine (data/selection.py with
  fast=False) selects what the cached-similarity engine selects, on the
  well-separated corpus of tests/test_torch_greedi.py."""
  x = np.asarray(tiny_images_like(250, 16, clusters=6, seed=7))
  perm, _ = _reference_partition(jax.random.PRNGKey(1), x, 8)
  tx = torch.tensor(x)
  kw = dict(m=8, kappa=4, k_final=4, perm=interop.perm(perm),
            straggler_keep=None if keep is None else torch.tensor(keep))
  fast = TS.greedi_select_indices_sharded(None, tx, **kw)
  generic = TS.greedi_select_indices_sharded(None, tx, fast=False, **kw)
  np.testing.assert_array_equal(generic, fast)
  feats_sh, gids = _sharded_layout(x, perm, 8)
  rk = {k: v for k, v in kw.items() if k != "perm"}
  a = TG.greedi_sharded_fast(feats_sh, gids=gids, **rk)
  b = TG.greedi_sharded(feats_sh, gids=gids,
                        objective=TO.FacilityLocation(), **rk)
  for f in ("value", "value_merged", "value_best_single"):
    np.testing.assert_allclose(float(getattr(b, f)), float(getattr(a, f)),
                               rtol=1e-5)


def test_ig_padded_candidates_never_selected():
  """The rule of test_partition_padding.py: a zero (padded) candidate row
  has positive rbf information gain, yet greedy with the partition mask
  never picks it."""
  n, m = 30, 4
  x = _data(n, 9)
  perm, _ = _reference_partition(jax.random.PRNGKey(5), x, m)
  parts, pmask, _ = t_partition(None, torch.tensor(x), m,
                                perm=interop.perm(perm))
  i = int(torch.argmin(pmask.sum(1)))
  assert not bool(pmask[i].all())
  tobj = TO.InformationGain(k_max=8, kernel="rbf", sigma=0.5)
  g = tobj.gains(tobj.init_d(D), parts[i])
  assert float(g[int(torch.argmin(pmask[i].to(torch.int8)))]) > 0.0
  r = t_greedy(tobj, tobj.init_d(D), parts[i], 8, cand_mask=pmask[i])
  sel = r.idx[r.idx >= 0]
  assert pmask[i][sel].all()


def test_generic_sharded_matches_jax_sharded(subrun):
  """The stacked generic engine against the reference's shard_map engine
  on 4 forced host devices: information gain with holes, a dead shard by
  liveness and the Thm-10 subset held by the first alive shard (facility
  location through the generic engine is held against the fast engine
  above, and that one against the reference's in
  tests/test_torch_greedi.py)."""
  out = subrun("""
import jax, jax.numpy as jnp, numpy as np, torch
from repro.core import greedi as JG
from repro.core import objectives as JO
from repro.core.partition import partition_gids, random_partition
from repro.util import make_mesh
from repro_torch import interop, no_tf32
from repro_torch.core import greedi as TG
from repro_torch.core import objectives as TO
no_tf32()
mesh = make_mesh((4,), ("data",))
n = 197  # 4 shards of 50 rows, 3 holes
f = jnp.asarray(np.random.default_rng(6).normal(size=(n, 8)) / np.sqrt(8),
                jnp.float32)
kw = (("h", 1.5),)
jo = JO.InformationGain(k_max=8, kernel="rbf", kernel_kwargs=kw, sigma=0.7)
to = TO.InformationGain(k_max=8, kernel="rbf", kernel_kwargs=kw, sigma=0.7)
r_part, r_sel, _, _ = JG.greedi_keys(jax.random.PRNGKey(3))
parts, _, perm = random_partition(r_part, f, 4)
npp = parts.shape[1]
fsh = parts.reshape(4 * npp, f.shape[1])
gids = partition_gids(perm)
age = [0., 3., 0., 0.]  # shard 1 missed the deadline
jr = JG.greedi_sharded(fsh, mesh=mesh, kappa=3, k_final=3, objective=jo,
                       rng=r_sel, gids=gids, liveness_age=jnp.asarray(age),
                       liveness_deadline=1.0, u_subset_eval=True)
tr = interop.to_numpy(TG.greedi_sharded(
    interop.features(fsh), m=4, kappa=3, k_final=3, objective=to,
    gids=interop.gids(gids), liveness_age=torch.tensor(age),
    liveness_deadline=1.0, u_subset_eval=True))
assert np.array_equal(tr.sel_gids, np.asarray(jr.sel_gids)), (
    tr.sel_gids, np.asarray(jr.sel_gids))
assert np.array_equal(tr.alive, np.asarray(jr.alive))
assert tr.alive.tolist() == [True, False, True, True]
for k in ("value", "value_merged", "value_best_single", "stage1_values"):
  np.testing.assert_allclose(getattr(tr, k), np.asarray(getattr(jr, k)),
                             rtol=1e-5, err_msg=k)
print("GENERIC_PARITY")
""", 4)
  assert "GENERIC_PARITY" in out
