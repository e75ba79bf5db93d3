"""The port's hereditary constraints (Sec. 5) and greedy modes against the
JAX reference.

Each constraint's masks and states are held against the reference's step
by step, with a leading partition axis on the port's state (the reference
runs one partition at a time).  ``greedy`` in modes ``standard``,
``random``, ``stochastic`` and ``cost_benefit`` under every constraint,
``best_of_knapsack`` and ``greedy_over_partitions`` run the max-cut
objective over one-hot candidates, two partitions stacked on the port's
side, each partition cutting the subgraph its nodes induce.  The random
modes get the reference's draws (rank tables for RandomGreedy, keep tables
for the stochastic greedy, each built from the reference greedy's key
chain ``rng, r_step = split(rng)``), and the port must pick exactly the
reference's ids, values within 1e-5 relative.

Before ids are compared, ``_assert_separated`` replays the reference's
trajectory in float64 and requires every step's ranked scores (the top
min(k, n) in mode random, the top 2 otherwise) to be exactly equal or more
than 1e-4 apart relative.  The reference's own oracles of
tests/test_greedy.py (matroid rank reached then no-ops, the budget
respected, best-of-two at least the plain greedy) run on the port too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.common import social_graph  # noqa: E402
from repro.core import constraints as JC  # noqa: E402
from repro.core.greedy import best_of_knapsack as j_best_of_knapsack  # noqa: E402,E501
from repro.core.greedy import greedy as j_greedy  # noqa: E402
from repro.core.greedy import greedy_over_partitions as j_over  # noqa: E402
from repro.core import objectives as JO  # noqa: E402
from repro_torch import interop, no_tf32  # noqa: E402
from repro_torch.core import constraints as TC  # noqa: E402
from repro_torch.core import greedy as TGR  # noqa: E402
from repro_torch.core import objectives as TO  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
no_tf32()

GAP = 1e-4
N_PARTS = 3  # matroid groups


def _systems(J):
  """The same constraint of each kind in package ``J`` (reference or
  port)."""
  pm = J.PartitionMatroid(num_parts=N_PARTS, caps=(2, 3, 1))
  pm2 = J.PartitionMatroid(num_parts=2, caps=(3, 2), meta_key="src")
  kn = J.Knapsack(2.5)
  return {"cardinality": J.Cardinality(4), "matroid": pm, "knapsack": kn,
          "intersection": J.Intersection((pm, kn)),
          "psystem": J.PSystem(p=2, matroids=(pm, pm2))}


def _meta(n, seed):
  r = np.random.default_rng(seed)
  return {"part": r.integers(0, N_PARTS, n).astype(np.int32),
          "src": r.integers(0, 2, n).astype(np.int32),
          "cost": r.uniform(0.2, 1.0, n).astype(np.float32)}


def _leaves(state):
  if isinstance(state, tuple):
    return [x for s in state for x in _leaves(s)]
  return [np.asarray(state)]


@pytest.mark.parametrize("kind", ["cardinality", "matroid", "knapsack",
                                  "intersection", "psystem"])
def test_constraint_masks_and_states_match_reference(kind):
  """Two partitions with their own item attributes, stacked on the port's
  side; every step's mask and state equal the reference's, partition by
  partition (float32 knapsack sums bit for bit)."""
  n, P = 30, 2
  jc, tc = _systems(JC)[kind], _systems(TC)[kind]
  metas = [_meta(n, s) for s in range(P)]
  tmeta = {k: torch.tensor(np.stack([m[k] for m in metas])) for k in metas[0]}
  jstates = [jc.init() for _ in range(P)]
  tstate = TC.init_batched(tc, (P,))
  r = np.random.default_rng(1)
  for _ in range(6):
    tmask = tc.mask(tstate, tmeta)
    for p in range(P):
      jmask = np.asarray(jc.mask(jstates[p], {k: jnp.asarray(v) for k, v
                                              in metas[p].items()}))
      assert tmask[p].tolist() == jmask.tolist()
    choice = np.array([r.integers(0, n) for _ in range(P)])
    tstate = tc.update(tstate, TC.slice_meta(tmeta, torch.tensor(choice)))
    for p in range(P):
      jstates[p] = jc.update(jstates[p], JC.slice_meta(
          {k: jnp.asarray(v) for k, v in metas[p].items()},
          jnp.asarray(choice[p])))
      for a, b in zip(_leaves(jax.tree.map(np.asarray, jstates[p])),
                      [x[p].numpy() for x in _leaves_t(tstate)]):
        np.testing.assert_array_equal(b, a)
  assert tc.rho() == jc.rho()
  if kind == "psystem":
    assert tc.tau() == jc.tau()


def _leaves_t(state):
  if isinstance(state, tuple):
    return [x for s in state for x in _leaves_t(s)]
  return [state]


def test_constraint_shared_meta_and_unbatched_state():
  """Attributes shared by every partition (an (n,) meta under a (P, ...)
  state) and the unbatched state give the same masks."""
  n = 25
  meta = _meta(n, 3)
  tmeta = {k: torch.tensor(v) for k, v in meta.items()}
  for kind, tc in _systems(TC).items():
    one = tc.init()
    both = TC.init_batched(tc, (2,))
    for i in (3, 7, 11):
      idx = torch.tensor(i)
      one = tc.update(one, TC.slice_meta(tmeta, idx))
      both = tc.update(both, TC.slice_meta(tmeta, torch.tensor([i, i])))
      m1, m2 = tc.mask(one, tmeta), tc.mask(both, tmeta)
      assert m2.shape == (2, n), kind
      assert m2[0].tolist() == m1.tolist() == m2[1].tolist(), kind


# ---------------------------------------------------------------------------
# greedy modes over two stacked partitions of a social graph's cut
# ---------------------------------------------------------------------------


def _rank_table(key, k, kk):
  row = jax.jit(lambda r: jax.vmap(
      lambda v: jax.random.randint(r, (), 0, v))(jnp.arange(1, kk + 1)))
  rows, rng = [], key
  for _ in range(k):
    rng, r_step = jax.random.split(rng)
    rows.append(np.asarray(row(r_step)))
  return np.stack(rows)


def _keep_table(key, k, n, p):
  rows, rng = [], key
  for _ in range(k):
    rng, r_step = jax.random.split(rng)
    rows.append(np.asarray(jax.random.bernoulli(r_step, p, (n,))))
  return np.stack(rows)


def _assert_separated(w_loc, nodes, idx, mode, kk, jc, meta, keep=None):
  """Replay the reference's trajectory (candidate rows ``idx``, -1 = no-op)
  over one partition's local weights in float64 under the reference
  constraint ``jc``; every step's ranked scores must be exactly equal or
  more than GAP apart relative (the top kk in mode random, the top 2
  otherwise), and no gain that decides a stop within GAP of 0 unless 0."""
  w64 = w_loc.astype(np.float64)
  x = np.zeros(w64.shape[0])
  sel = np.zeros(len(nodes), bool)
  jmeta = {k: jnp.asarray(v) for k, v in meta.items()}
  cst = jc.init()
  scale = float(np.abs(w64).sum(1).max())
  for t, i in enumerate(idx):
    g = (w64 @ (1.0 - 2.0 * x))[nodes]
    score = g / np.maximum(meta["cost"].astype(np.float64), 1e-12) if (
        mode == "cost_benefit") else g
    feas = ~sel & np.asarray(jc.mask(cst, jmeta))
    if keep is not None:
      feas &= keep[t] if (keep[t] & feas).any() else True
    top = np.sort(score[feas])[::-1][:kk if mode == "random" else 2]
    for a, b in zip(top[:-1], top[1:]):
      assert a == b or a - b > GAP * max(abs(a), abs(b), 1e-3 * scale), (
          "near-tie", t, a, b)
    if i >= 0:
      assert g[i] == 0.0 or abs(g[i]) > GAP * scale
      x[nodes[i]] = 1.0
      sel[i] = True
      cst = jc.update(cst, JC.slice_meta(jmeta, jnp.asarray(i)))


CASES = [(mode, kind) for mode in ("standard", "random", "stochastic",
                                   "cost_benefit")
         for kind in ("matroid", "knapsack", "intersection", "psystem")]


def _two_partitions(n, seed):
  w = social_graph(n, seed=seed)
  perm = np.random.default_rng(seed).permutation(n).reshape(2, n // 2)
  return w, perm


@pytest.mark.parametrize("mode,kind", CASES)
def test_greedy_modes_match_reference(mode, kind):
  """Two partitions of a 120-node social graph's cut, each on its induced
  subgraph with its own attributes, RandomGreedy-style stops on nonpositive
  gains: the port's one stacked run picks exactly the reference's ids per
  partition under the reference's draws."""
  n, k, P = 120, 6, 2
  w, perm = _two_partitions(n, 11)
  npp = n // P
  jobj, tobj = JO.GraphCut(), TO.GraphCut()
  jc, tc = _systems(JC)[kind], _systems(TC)[kind]
  metas = [_meta(npp, 20 + p) for p in range(P)]
  frac = 0.5
  keys = jax.random.split(jax.random.PRNGKey(3), P)
  j_ids, j_vals, tables = [], [], []
  for p in range(P):
    ind = np.zeros(n, np.float32)
    ind[perm[p]] = 1.0
    w_loc = w * ind[:, None] * ind[None, :]
    meta = {k2: jnp.asarray(v) for k2, v in metas[p].items()}
    r = j_greedy(jobj, jobj.init_w(jnp.asarray(w_loc)),
                   jnp.eye(n)[perm[p]], k, constraint=jc, meta=meta,
                   rng=keys[p], mode=mode, sample_frac=frac,
                   stop_nonpositive=True)
    keep = None
    if mode == "random":
      tables.append(_rank_table(keys[p], k, min(k, npp)))
    elif mode == "stochastic":
      keep = _keep_table(keys[p], k, npp, frac)
      tables.append(keep)
    _assert_separated(w_loc, perm[p], np.asarray(r.idx), mode,
                      min(k, npp), jc, metas[p], keep)
    j_ids.append(np.asarray(r.idx))
    j_vals.append(np.asarray(r.values))

  tw = torch.tensor(w)
  tobj.init_w(tw)
  ind = torch.zeros(P, n).scatter_(1, torch.tensor(perm),
                                   torch.ones(P, npp))
  draws = None
  if mode == "random":
    draws = interop.rank_table(np.stack(tables))
  elif mode == "stochastic":
    draws = interop.keep_table(np.stack(tables))
  tmeta = {k2: torch.tensor(np.stack([m[k2] for m in metas]))
           for k2 in metas[0]}
  got = TGR.greedy(tobj, tobj.init_induced(tw, ind), torch.eye(n)[perm], k,
                   constraint=tc, meta=tmeta, mode=mode, draws=draws,
                   stop_nonpositive=True)
  assert got.idx.tolist() == [ids.tolist() for ids in j_ids]
  np.testing.assert_allclose(got.values.numpy(), np.stack(j_vals),
                             rtol=1e-5, atol=1e-5)


def test_stochastic_empty_sample_falls_back_to_all():
  """A keep table that misses every feasible item falls back to the full
  feasible set (the reference's rule), per partition: an all-False table
  selects what the standard greedy selects."""
  n, k = 60, 5
  w = social_graph(n, seed=2)
  obj = TO.GraphCut()
  st = obj.broadcast(obj.init_w(torch.tensor(w)), 2)
  eye = torch.eye(n).expand(2, n, n)
  none = torch.zeros(2, k, n, dtype=torch.bool)
  a = TGR.greedy(obj, st, eye, k, mode="stochastic", draws=none)
  b = TGR.greedy(obj, st, eye, k, mode="standard", use_select=False)
  assert torch.equal(a.idx, b.idx)
  # one partition's sample hits, the other's misses
  some = none.clone()
  some[0, :, : n // 2] = True
  c = TGR.greedy(obj, st, eye, k, mode="stochastic", draws=some)
  assert torch.equal(c.idx[1], b.idx[1])
  assert bool((c.idx[0] < n // 2).all())


def test_own_stochastic_draws_valid():
  table = TGR.draw_table("stochastic", torch.Generator().manual_seed(0),
                         (2,), 4, 50, sample_frac=0.3)
  assert table.shape == (2, 4, 50) and table.dtype == torch.bool
  assert 0.1 < float(table.float().mean()) < 0.5
  with pytest.raises(ValueError, match="sample_frac"):
    TGR.draw_table("stochastic", None, (), 4, 50)
  with pytest.raises(ValueError, match="draws of shape"):
    TGR.greedy(TO.GraphCut(), TO.GraphCut().init_w(torch.zeros(5, 5)),
               torch.eye(5), 3, mode="random",
               draws=torch.zeros(3, 2, dtype=torch.int64))


def test_best_of_knapsack_matches_reference():
  """best_of_knapsack (plain and cost-benefit greedy under the budget, the
  better of the two) on two stacked partitions: the reference's ids."""
  n, k, P = 120, 8, 2
  w, perm = _two_partitions(n, 12)
  npp = n // P
  jobj, tobj = JO.GraphCut(), TO.GraphCut()
  costs = [_meta(npp, 40 + p)["cost"] for p in range(P)]
  budget = 2.5
  want = []
  for p in range(P):
    ind = np.zeros(n, np.float32)
    ind[perm[p]] = 1.0
    w_loc = w * ind[:, None] * ind[None, :]
    meta = {"cost": jnp.asarray(costs[p])}
    for mode in ("standard", "cost_benefit"):
      r = j_greedy(jobj, jobj.init_w(jnp.asarray(w_loc)),
                     jnp.eye(n)[perm[p]], k, constraint=JC.Knapsack(budget),
                     meta=meta, mode=mode)
      _assert_separated(w_loc, perm[p], np.asarray(r.idx), mode, 2,
                        JC.Knapsack(budget), {"cost": costs[p]})
    r = j_best_of_knapsack(jobj, jobj.init_w(jnp.asarray(w_loc)),
                             jnp.eye(n)[perm[p]], k, meta=meta,
                             budget=budget)
    want.append(r)
  tw = torch.tensor(w)
  tobj.init_w(tw)
  ind = torch.zeros(P, n).scatter_(1, torch.tensor(perm),
                                   torch.ones(P, npp))
  got = TGR.best_of_knapsack(tobj, tobj.init_induced(tw, ind),
                             torch.eye(n)[perm], k,
                             meta={"cost": torch.tensor(np.stack(costs))},
                             budget=budget)
  assert got.idx.tolist() == [np.asarray(r.idx).tolist() for r in want]
  np.testing.assert_allclose(got.values.numpy(),
                             np.stack([np.asarray(r.values) for r in want]),
                             rtol=1e-5, atol=1e-5)


def _fl_feats(seed, n=30, d=6):
  r = np.random.default_rng(seed)
  f = r.normal(size=(n, d)).astype(np.float32)
  return f / np.linalg.norm(f, axis=1, keepdims=True)


def test_reference_oracles_on_the_port():
  """tests/test_greedy.py's oracles: the matroid rank reached, then no-ops;
  the knapsack budget respected and best-of-two at least the plain
  greedy under the same budget."""
  feats = torch.tensor(_fl_feats(5, n=24))
  obj = TO.FacilityLocation(kernel="linear")
  pm = TC.PartitionMatroid(num_parts=3, caps=(2, 2, 2))
  meta = {"part": torch.arange(24) % 3}
  r = TGR.greedy(obj, obj.init(feats), feats, 9, constraint=pm, meta=meta)
  sel = r.idx[r.idx >= 0]
  counts = torch.bincount(meta["part"][sel], minlength=3)
  assert bool((counts <= 2).all()) and len(sel) == 6

  feats = torch.tensor(_fl_feats(6, n=30))
  costs = torch.tensor(np.random.default_rng(7).uniform(
      0.2, 1.0, 30).astype(np.float32))
  r = TGR.best_of_knapsack(obj, obj.init(feats), feats, 15,
                           meta={"cost": costs}, budget=2.5)
  sel = r.idx[r.idx >= 0]
  assert float(costs[sel].sum()) <= 2.5 + 1e-5
  plain = TGR.greedy(obj, obj.init(feats), feats, 15,
                     constraint=TC.Knapsack(2.5), meta={"cost": costs})
  assert float(obj.value(r.state)) >= float(obj.value(plain.state)) - 1e-6


def test_greedy_over_partitions_matches_reference():
  """The stacked form of the reference's vmap over an (m, n/m, d) stack:
  RandomGreedy on each partition's induced cut, the reference's draws."""
  n, m, k = 120, 3, 5
  w, _ = _two_partitions(n, 13)
  perm = np.random.default_rng(13).permutation(n).reshape(m, n // m)
  npp = n // m
  eye = np.eye(n, dtype=np.float32)
  wj = jnp.asarray(w)
  jobj = JO.GraphCut()

  def j_init(part_feats):
    ind = jnp.sum(part_feats, axis=0)
    return jobj.init_w(wj * ind[:, None] * ind[None, :])

  # the reference vmaps one key over the partitions: keys are explicit
  # per call, so run it with rng=None's default key for each partition
  jr = j_over(j_init, jobj, jnp.asarray(eye[perm]), k,
                                  mode="random", stop_nonpositive=True)
  ids = np.asarray(jr.idx)
  table = _rank_table(jax.random.PRNGKey(0), k, min(k, npp))
  for p in range(m):
    ind = np.zeros(n, np.float32)
    ind[perm[p]] = 1.0
    _assert_separated(w * ind[:, None] * ind[None, :], perm[p], ids[p],
                      "random", min(k, npp), JC.Cardinality(k),
                      {"_n": np.zeros(npp, np.float32)})
  tw = torch.tensor(w)
  tobj = TO.GraphCut()
  tobj.init_w(tw)

  def t_init(parts):
    return tobj.init_induced(tw, parts.sum(dim=-2))

  got = TGR.greedy_over_partitions(
      t_init, tobj, torch.tensor(eye[perm]), k, mode="random",
      draws=interop.rank_table(np.broadcast_to(table, (m, k, min(k, npp)))),
      stop_nonpositive=True)
  assert got.idx.tolist() == ids.tolist()
  np.testing.assert_allclose(got.values.numpy(), np.asarray(jr.values),
                             rtol=1e-5, atol=1e-5)
