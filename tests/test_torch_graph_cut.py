"""The port's graph-cut path (Sec. 5 / 6.3) against the JAX reference.

Inputs are made with numpy from a seed and handed to both packages.  The
kernels' plain versions are held against ``repro.kernels.ops`` (Pallas in
interpret mode) and ``repro.kernels.ref`` over the reference's own sweep
(rtol 1e-5, atol 1e-4 n, the rule of tests/test_kernels.py); ``GraphCut``
and its local-evaluation state against the reference's objective; and
RandomGreedy, ``greedi_reference`` (Fig. 9 settings) and the example's
Alg. 3 flow under the reference's own draws: the port gets the
reference's partition and rank tables built from the reference's key chain
(``rng, r_step = split(rng)`` per step, ``randint(r_step, (), 0, v)`` for
v = 1..kk) and must pick exactly the reference's ids, values within 1e-5.

Equal ids are only meaningful where no ranked list has a near-tie: a
RandomGreedy step picks by rank among the top kk gains, so two gains
closer than float32 noise anywhere in that list may swap.  ``_assert_
separated`` replays every step of the reference's trajectory in float64
and requires each adjacent pair of the ranked top-kk list to be exactly
equal (equal values rank by index in both packages) or more than 1e-4
apart relative, before ids are compared.
"""
import math
import os
import runpy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.common import social_graph  # noqa: E402
from repro.core import constraints as JC  # noqa: E402
from repro.core import greedi as JG  # noqa: E402
from repro.core import objectives as JO  # noqa: E402
from repro.core.greedy import greedy as j_greedy  # noqa: E402
from repro.core.partition import random_partition  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import interop, no_tf32  # noqa: E402
from repro_torch.core import constraints as TC  # noqa: E402
from repro_torch.core import greedi as TG  # noqa: E402
from repro_torch.core import objectives as TO  # noqa: E402
from repro_torch.core.greedy import draw_table, greedy  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.kernels import dispatch, ops, ref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
no_tf32()

GAP = 1e-4


def _weights(n, seed, density=None):
  """Symmetric nonnegative weights with a zero diagonal (numpy f32): dense
  |normal| as the reference's sweep, or exponential weights on a random
  fraction ``density`` of the pairs."""
  r = np.random.default_rng(seed)
  w = np.abs(r.normal(size=(n, n)))
  if density is not None:
    w = r.exponential(size=(n, n)) * (r.uniform(size=(n, n)) < density)
  w = 0.5 * (w + w.T)
  np.fill_diagonal(w, 0.0)
  return w.astype(np.float32)


def _close(got, want, n):
  np.testing.assert_allclose(np.asarray(got, np.float32),
                             np.asarray(want, np.float32), rtol=1e-5,
                             atol=1e-4 * n)


# ---------------------------------------------------------------------------
# kernels: the plain versions against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [16, 100, 256, 300, 513])
@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_graph_cut_gain_matches_reference(n, frac):
  w = _weights(n, n)
  x = (np.random.default_rng(n + 1).uniform(size=n) < frac).astype(np.float32)
  got = ops.graph_cut_gain(torch.tensor(w), torch.tensor(x)).numpy()
  _close(got, jops.graph_cut_gain(jnp.asarray(w), jnp.asarray(x)), n)
  _close(got, jref.graph_cut_gain_ref(jnp.asarray(w), jnp.asarray(x)), n)
  # a batch of selection vectors over the shared W, row by row
  xs = (np.random.default_rng(n + 2).uniform(size=(3, n)) < frac).astype(
      np.float32)
  got = ops.graph_cut_gain(torch.tensor(w), torch.tensor(xs)).numpy()
  for p in range(3):
    _close(got[p], jref.graph_cut_gain_ref(jnp.asarray(w),
                                           jnp.asarray(xs[p])), n)


@pytest.mark.parametrize("n", [100, 513])
def test_graph_cut_gain_bf16_weights(n):
  """bf16 W is read exactly into float32, as the reference's astype does."""
  w = _weights(n, n + 7)
  x = (np.random.default_rng(n).uniform(size=n) < 0.4).astype(np.float32)
  got = ops.graph_cut_gain(torch.tensor(w).to(torch.bfloat16),
                           torch.tensor(x)).numpy()
  want = jref.graph_cut_gain_ref(jnp.asarray(w, jnp.bfloat16), jnp.asarray(x))
  _close(got, want, n)


@pytest.mark.parametrize("n", [16, 100, 300, 513])
def test_graph_cut_select_matches_reference(n):
  r = np.random.default_rng(n + 3)
  w = _weights(n, n + 3)
  xs = (r.uniform(size=(4, n)) < 0.3).astype(np.float32)
  oks = r.uniform(size=(4, n)) < 0.6
  tw = torch.tensor(w)
  best, idx = ops.graph_cut_select(tw, torch.tensor(xs), torch.tensor(oks))
  jb, ji = jops.graph_cut_select_batched(jnp.asarray(w), jnp.asarray(xs),
                                         jnp.asarray(oks))
  assert idx.tolist() == np.asarray(ji).tolist()
  _close(best.numpy(), jb, n)
  tb, ti = ops.graph_cut_select_batched(tw, torch.tensor(xs),
                                        torch.tensor(oks))
  assert torch.equal(ti, idx) and torch.equal(tb, best)
  for p in range(4):
    b1, i1 = ops.graph_cut_select(tw, torch.tensor(xs[p]),
                                  torch.tensor(oks[p]))
    jb1, ji1 = jops.graph_cut_select(jnp.asarray(w), jnp.asarray(xs[p]),
                                     jnp.asarray(oks[p]))
    assert int(i1) == int(ji1) and i1.dim() == 0
    _close(b1.numpy(), jb1, n)


def test_graph_cut_select_edges():
  """Nothing feasible gives (NEG, 0); exact ties (binary weights, empty
  selection: the gain is the degree) go to the lowest node."""
  n = 300
  r = np.random.default_rng(5)
  w = (r.uniform(size=(n, n)) < 0.05).astype(np.float32)
  w = np.maximum(w, w.T)
  np.fill_diagonal(w, 0.0)
  x = np.zeros((2, n), np.float32)
  none = np.zeros((2, n), bool)
  best, idx = ops.graph_cut_select(torch.tensor(w), torch.tensor(x),
                                   torch.tensor(none))
  jb, ji = jops.graph_cut_select_batched(jnp.asarray(w), jnp.asarray(x),
                                         jnp.asarray(none))
  assert idx.tolist() == [0, 0] == np.asarray(ji).tolist()
  assert torch.equal(best, torch.full((2,), ref.NEG))
  deg = w.sum(1)
  top = np.flatnonzero(deg == deg.max())
  assert len(top) >= 1
  # the best degree again at a lower and a higher node: copy its row
  ok = np.ones((2, n), bool)
  j = int(top[0])
  w2 = w.copy()
  for other in (j // 2, (j + n) // 2):
    if other != j:
      w2[other] = w2[j]
      w2[:, other] = w2[:, j]
      w2[other, other] = 0.0
  w2[j, :] = w2[:, j]
  best, idx = ops.graph_cut_select(torch.tensor(w2), torch.tensor(x),
                                   torch.tensor(ok))
  jb, ji = jops.graph_cut_select_batched(jnp.asarray(w2), jnp.asarray(x),
                                         jnp.asarray(ok))
  assert idx.tolist() == np.asarray(ji).tolist()
  deg2 = w2.sum(1)
  assert int(idx[0]) == int(np.flatnonzero(deg2 == deg2.max())[0])
  assert (deg2 == deg2.max()).sum() >= 2


def test_graph_cut_local_indicator_matches_masked_copy():
  """ind * (1 - 2x) over the shared W gives, on every node of a partition,
  the reference's gains over the masked copy W * ind ind^T."""
  n = 257
  r = np.random.default_rng(9)
  w = _weights(n, 11)
  ind = (r.uniform(size=(3, n)) < 0.35).astype(np.float32)
  x = ((r.uniform(size=(3, n)) < 0.3) * ind).astype(np.float32)
  got = ops.graph_cut_gain(torch.tensor(w), torch.tensor(x),
                           torch.tensor(ind)).numpy()
  for p in range(3):
    w_loc = w * ind[p][:, None] * ind[p][None, :]
    want = np.asarray(jops.graph_cut_gain(jnp.asarray(w_loc),
                                          jnp.asarray(x[p])))
    on = ind[p] > 0
    _close(got[p][on], want[on], n)


@pytest.mark.parametrize("x_kind", ["f32", "bool", "u8"])
@pytest.mark.parametrize("ind_kind", ["none", "shared", "expanded",
                                      "per_partition"])
def test_operands_contract_matches_reference(x_kind, ind_kind):
  """The kernels read x and the indicator where they lie: float32, bool or
  uint8, each with its own stride between the P vectors (0 for a vector
  shared by all P, as ``GraphCut.broadcast``'s expanded indicator).  The
  plain reading of that contract (``columns``: vector p starts p * ps
  elements in) times W equals the reference's gains of every p."""
  from repro_torch.kernels import graph_cut_gain as gc
  n, P = 300, 3
  r = np.random.default_rng(21)
  w = _weights(n, 21)
  x = r.uniform(size=(P, n)) < 0.3
  ind = r.uniform(size=(P, n)) < 0.6
  tx = torch.tensor(x)
  tx = {"f32": tx.float(), "bool": tx, "u8": tx.to(torch.uint8)}[x_kind]
  tind, ind_rows = {
      "none": (None, np.ones((P, n), bool)),
      "shared": (torch.tensor(ind[0]).float(), np.repeat(ind[:1], P, 0)),
      "expanded": (torch.tensor(ind[0]).float().expand(P, n),
                   np.repeat(ind[:1], P, 0)),
      "per_partition": (torch.tensor(ind).to(torch.uint8), ind)}[ind_kind]
  o = gc.operands("graph_cut_gain", torch.tensor(w), tx, ind=tind)
  assert o.n_part == P and o.batch == P and o.pb == 4
  assert (o.x.ps, o.x.u8) == (n, int(x_kind != "f32"))
  if tind is not None:
    assert o.ind.ps == (n if ind_kind == "per_partition" else 0)
    assert o.ind.u8 == int(ind_kind == "per_partition")
  got = (gc.columns(o) @ torch.tensor(w).T).numpy()
  for p in range(P):
    xp = x[p].astype(np.float32)
    want = jops.graph_cut_gain(jnp.asarray(w * ind_rows[p][:, None]
                                           * ind_rows[p][None, :]),
                               jnp.asarray(xp))
    on = ind_rows[p]
    _close(got[p][on], np.asarray(want)[on], n)
  # the registered plain path agrees with the contract's reading
  torch.testing.assert_close(torch.tensor(got),
                             ops.graph_cut_gain(torch.tensor(w), tx, tind))


def test_operands_refuse_what_the_kernel_does_not_read():
  from repro_torch.kernels import graph_cut_gain as gc
  w = torch.tensor(_weights(64, 3))
  with pytest.raises(TypeError, match="float32, bool or uint8"):
    gc.operands("g", w, torch.zeros(64, dtype=torch.float64))
  with pytest.raises(ValueError, match="contiguous along its n"):
    gc.operands("g", w, torch.zeros(64, 2).T)
  with pytest.raises(ValueError, match="length"):
    gc.operands("g", w, torch.zeros(63))
  with pytest.raises(ValueError, match="batch sizes differ"):
    gc.operands("g", w, torch.zeros(2, 64), ind=torch.ones(3, 64))
  o = gc.operands("g", w, torch.zeros(64), node_ok=torch.ones(64) > 0)
  assert o.batch is None and (o.x.ps, o.ok.ps, o.ok.u8) == (0, 0, 1)
  assert o.x.wide == 1 and gc.cbuf(o) is None


def test_registry_graph_cut_backends():
  n = 40
  w = torch.tensor(_weights(n, 2))
  x = torch.zeros(2, n)
  ok = torch.ones(2, n, dtype=torch.bool)
  for resolve, args in ((dispatch.resolve, (w, x)),
                        (dispatch.resolve_select, (w, x, ok)),
                        (dispatch.resolve_select_batched, (w, x, ok))):
    with pytest.raises(ValueError, match="backend 'cuda' needs CUDA"):
      resolve("graph_cut_gain", "cuda")(*args)
    a = resolve("graph_cut_gain", "ref")(*args)
    b = resolve("graph_cut_gain", "auto")(*args)
    for u, v in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
      torch.testing.assert_close(u, v)


# ---------------------------------------------------------------------------
# GraphCut and its states
# ---------------------------------------------------------------------------


def test_init_w_symmetrizes_in_place_bit_for_bit():
  r = np.random.default_rng(4)
  for n in (7, 300, 4100):  # one block, and a ragged block edge past 4096
    raw = r.exponential(size=(n, n)).astype(np.float32)
    t = torch.tensor(raw)
    st = TO.GraphCut().init_w(t)
    assert st.w is t  # in place
    want = np.asarray(JO.GraphCut().init_w(jnp.asarray(raw)).w)
    assert np.array_equal(t.numpy(), want)
    again = t.clone()
    TO.GraphCut().init_w(again)  # idempotent
    assert torch.equal(again, t)


@pytest.mark.parametrize("node_order", [False, True])
def test_graph_cut_objective_matches_reference(node_order):
  """init_w / gains / select / update / value step by step over eye(n)."""
  n = 96
  w = _weights(n, 3, density=0.1)
  jobj = JO.GraphCut(assume_node_order=node_order)
  tobj = TO.GraphCut(assume_node_order=node_order)
  js = jobj.init_w(jnp.asarray(w))
  ts = tobj.init_w(torch.tensor(w))
  jeye, teye = jnp.eye(n), torch.eye(n)
  feas = np.random.default_rng(1).uniform(size=n) < 0.8
  for _ in range(6):
    _close(tobj.gains(ts, teye).numpy(), jobj.gains(js, jeye), n)
    jb, ji = jobj.select(js, jeye, jnp.asarray(feas))
    tb, ti = tobj.select(ts, teye, torch.tensor(feas))
    assert int(ti) == int(ji)
    _close(tb.numpy(), jb, n)
    js = jobj.update(js, jeye[int(ji)])
    ts = tobj.update(ts, teye[int(ti)])
    _close(tobj.value(ts).numpy(), jobj.value(js), n)
    feas[int(ji)] = False
  np.testing.assert_array_equal(ts.in_s.numpy(), np.asarray(js.in_s))
  # the reference's state, carried across mid-run, gives the same gains
  carried = interop.cut_state(jax.tree.map(np.asarray, js))
  _close(tobj.gains(carried, teye).numpy(), jobj.gains(js, jeye), n)
  assert float(carried.value) == float(js.value)


def test_local_state_matches_reference_init_local():
  """The port's shared-W local state (node indicators of a ragged
  partition, holes as zero rows) against the reference's init_local, one
  masked W per partition: gains over every partition's candidate rows,
  then values after the same updates."""
  n, m = 203, 4
  w = _weights(n, 8, density=0.08)
  eye = np.eye(n, dtype=np.float32)
  _, _, perm = random_partition(jax.random.PRNGKey(3), jnp.asarray(eye), m)
  perm = np.asarray(perm)
  jobj, tobj = JO.GraphCut(), TO.GraphCut()

  def j_init_local(ef, em):
    ind = jnp.sum(ef * em[:, None], axis=0)
    return jobj.init_w(jnp.asarray(w) * ind[:, None] * ind[None, :])

  tw = torch.tensor(w)
  tobj.init_w(tw)
  parts, pmask, _ = TG.random_partition(None, torch.tensor(eye), m,
                                        perm=interop.perm(perm))

  def t_init_local(ef, em):
    return tobj.init_induced(tw, (em.unsqueeze(-2) @ ef).squeeze(-2))

  ts = t_init_local(parts, pmask.float())
  assert ts.ind.shape == (m, n) and ts.w is tw
  upd = ts
  for j in (0, 5, 9):
    upd = tobj.update(upd, parts[:, j])
  for i in range(m):
    ef = jnp.asarray(parts[i].numpy())
    js = j_init_local(ef, jnp.asarray(pmask[i].numpy(), jnp.float32))
    _close(tobj.gains(ts, parts)[i].numpy(), jobj.gains(js, ef), n)
    for j in (0, 5, 9):
      js = jobj.update(js, ef[j])
    _close(upd.value[i].numpy(), jobj.value(js), n)
    _close(tobj.gains(upd, parts)[i].numpy(), jobj.gains(js, ef), n)


# ---------------------------------------------------------------------------
# RandomGreedy, GreeDi and Alg. 3 under the reference's draws
# ---------------------------------------------------------------------------


def _rank_table(key, k, kk):
  """(k, kk) ranks from the reference greedy's key chain: step t splits
  ``rng, r_step = split(rng)`` and draws randint(r_step, (), 0, v)."""
  row = jax.jit(lambda r: jax.vmap(
      lambda v: jax.random.randint(r, (), 0, v))(jnp.arange(1, kk + 1)))
  rows, rng = [], key
  for _ in range(k):
    rng, r_step = jax.random.split(rng)
    rows.append(np.asarray(row(r_step)))
  return np.stack(rows)


def _assert_separated(w, cand_nodes, cand_ok, idx, kk, *, ind=None,
                      parts=None, caps=None, keep=None):
  """Replay a greedy trajectory (candidate-row ids ``idx``, -1 = no-op) in
  float64 and require every step's ranked top-kk feasible gains (within
  the step's sample when ``keep`` is given) to be pairwise exactly equal
  or more than GAP apart relative, and no chosen gain within GAP of 0
  unless exactly 0."""
  w64 = w.astype(np.float64)
  x = np.zeros(w.shape[0])
  sel = np.zeros(len(cand_nodes), bool)
  counts = None if caps is None else np.zeros(len(caps), int)
  scale = float(np.abs(w64).sum(1).max())
  for t, i in enumerate(idx):
    c = 1.0 - 2.0 * x
    if ind is not None:
      c = c * ind
    g = np.where(cand_nodes >= 0, (w64 @ c)[np.maximum(cand_nodes, 0)], 0.0)
    feas = cand_ok & ~sel
    if counts is not None:
      feas &= counts[parts] < np.asarray(caps)[parts]
    if keep is not None and (keep[t] & feas).any():
      feas &= keep[t]
    top = np.sort(g[feas])[::-1][:kk]
    for a, b in zip(top[:-1], top[1:]):
      assert a == b or a - b > GAP * max(abs(a), abs(b), 1e-3 * scale), (
          "near-tie in the ranked list", a, b)
    if i >= 0:
      assert g[i] == 0.0 or abs(g[i]) > GAP * scale
      x[cand_nodes[i]] = 1.0
      sel[i] = True
      if counts is not None:
        counts[parts[i]] += 1


def test_random_greedy_matches_reference_draws():
  """Centralized RandomGreedy with stop_nonpositive on a social graph:
  the reference's ranks give the reference's ids."""
  n, k = 160, 40
  w = social_graph(n, seed=4)
  jobj, tobj = JO.GraphCut(), TO.GraphCut()
  key = jax.random.PRNGKey(7)
  jr = j_greedy(jobj, jobj.init_w(jnp.asarray(w)), jnp.eye(n), k,
                mode="random", rng=key, stop_nonpositive=True)
  ids = np.asarray(jr.idx)
  _assert_separated(w, np.arange(n), np.ones(n, bool), ids, min(k, n))
  table = _rank_table(key, k, min(k, n))
  tr = greedy(tobj, tobj.init_w(torch.tensor(w)), torch.eye(n), k,
              mode="random", draws=interop.rank_table(table),
              stop_nonpositive=True)
  assert tr.idx.tolist() == ids.tolist()
  np.testing.assert_allclose(tr.values.numpy(), np.asarray(jr.values),
                             rtol=1e-5)
  assert int((ids >= 0).sum()) > 0


def test_random_greedy_own_draws_are_valid():
  """The port's own draws (a generator, no table): ranks within range, a
  valid non-monotone run that stops before selecting everything (the
  reference's oracle of tests/test_greedy.py), and no host sync needed
  to build the table."""
  n = 24
  r = np.random.default_rng(2)
  w = np.abs(r.normal(size=(n, n))).astype(np.float32)
  obj = TO.GraphCut()
  st0 = obj.init_w(torch.tensor(w))
  res = greedy(obj, st0, torch.eye(n), n, mode="random",
               rng=torch.Generator().manual_seed(0), stop_nonpositive=True)
  n_sel = int((res.idx >= 0).sum())
  assert 0 < n_sel < n
  assert float(obj.value(res.state)) > 0
  table = draw_table("random", torch.Generator().manual_seed(1), (3,), 5, 7)
  assert table.shape == (3, 5, 5) and table.dtype == torch.int64
  assert bool(((table >= 0) & (table < torch.arange(1, 6))).all())


def _fig9_reference(w, key, m, k):
  """The reference's Fig. 9 GreeDi (local evaluation, RandomGreedy) with
  its round trajectories, partition and draw tables."""
  n = w.shape[0]
  obj = JO.GraphCut()
  eye = jnp.eye(n, dtype=jnp.float32)
  wj = jnp.asarray(w)

  def init_local(ef, em):
    ind = jnp.sum(ef * em[:, None], axis=0)
    return obj.init_w(wj * ind[:, None] * ind[None, :])

  def init_global(ef, em):
    return obj.init_w(wj)

  res = JG.greedi_reference(key, eye, m=m, kappa=k, k_final=k,
                            objective=obj, init_for=init_local,
                            local_eval=True, mode="random",
                            stop_nonpositive=True)
  r_part, r_sel, r_r2, _ = JG.greedi_keys(key)
  parts, pmask, perm = random_partition(r_part, eye, m)
  keys = jax.random.split(r_sel, m)
  npp = parts.shape[1]
  r1_ids, r1_tables = [], []
  for i in range(m):
    r = j_greedy(obj, init_local(parts[i], pmask[i].astype(jnp.float32)),
                 parts[i], k, cand_mask=pmask[i], rng=keys[i],
                 mode="random", stop_nonpositive=True)
    r1_ids.append(np.asarray(r.idx))
    r1_tables.append(_rank_table(keys[i], k, min(k, npp)))
  perm = np.asarray(perm)
  bn = np.concatenate([np.where(ids >= 0, perm[i][np.maximum(ids, 0)], -1)
                       for i, ids in enumerate(r1_ids)])
  r2 = j_greedy(obj, init_global(None, None), eye[np.maximum(bn, 0)], k,
                cand_mask=jnp.asarray(bn >= 0), rng=r_r2, mode="random",
                stop_nonpositive=True)
  return dict(res=res, perm=perm, pmask=np.asarray(pmask), r1_ids=r1_ids,
              r1_tables=np.stack(r1_tables), bn=bn,
              r2_ids=np.asarray(r2.idx),
              r2_table=_rank_table(r_r2, k, min(k, m * k)),
              init_global=init_global)


def test_greedi_fig9_random_matches_reference():
  """greedi_reference at the Fig. 9 settings (local evaluation,
  RandomGreedy, stop_nonpositive) on a small social graph, the reference's
  partition and draws injected: the same sel_gids, values within 1e-5;
  the returned f(S) equals its replay on the whole graph."""
  n, m, k = 202, 4, 10  # ragged: 51 rows a partition, 2 holes
  w = social_graph(n, seed=2)
  ref_run = _fig9_reference(w, jax.random.PRNGKey(0), m, k)
  perm, pmask = ref_run["perm"], ref_run["pmask"]
  for i in range(m):
    ind = np.zeros(n)
    ind[perm[i][perm[i] >= 0]] = 1.0
    _assert_separated(w, perm[i], pmask[i], ref_run["r1_ids"][i],
                      min(k, perm.shape[1]), ind=ind)
  bn = ref_run["bn"]
  _assert_separated(w, bn, bn >= 0, ref_run["r2_ids"], min(k, m * k))

  obj = TO.GraphCut()
  tw = torch.tensor(w)
  obj.init_w(tw)

  def init_local(ef, em):
    return obj.init_induced(tw, (em.unsqueeze(-2) @ ef).squeeze(-2))

  def init_global(ef, em):
    return obj.init_induced(tw)

  got = TG.greedi_reference(None, torch.eye(n), m=m, kappa=k, k_final=k,
                            objective=obj, init_for=init_local,
                            local_eval=True, mode="random",
                            stop_nonpositive=True, perm=interop.perm(perm),
                            r1_draws=interop.rank_table(
                                ref_run["r1_tables"]),
                            r2_draws=interop.rank_table(
                                ref_run["r2_table"]))
  want = ref_run["res"]
  assert got.sel_gids.tolist() == np.asarray(want.sel_gids).tolist()
  for a, b in ((got.value, want.value), (got.value_merged, want.value_merged),
               (got.value_best_single, want.value_best_single),
               (got.stage1_values, want.stage1_values)):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
  replay = obj.value(TG.set_value_feats(obj, init_global(None, None),
                                        got.sel_feats, got.sel_valid))
  np.testing.assert_allclose(float(replay), float(got.value), rtol=1e-5)
  # the reference's own replay on the whole graph (benchmarks/fig9_maxcut)
  jobj = JO.GraphCut()
  jrep = jobj.value(JG.set_value_feats(
      jobj, ref_run["init_global"](None, None), want.sel_feats,
      want.sel_valid))
  np.testing.assert_allclose(float(replay), float(jrep), rtol=1e-5)


def _keep_table(key, k, n, p):
  """(k, n) stochastic-greedy samples from the reference greedy's key
  chain: bernoulli(r_step, p, (n,)) per step."""
  rows, rng = [], key
  for _ in range(k):
    rng, r_step = jax.random.split(rng)
    rows.append(np.asarray(jax.random.bernoulli(r_step, p, (n,))))
  return np.stack(rows)


def test_greedi_stochastic_matches_reference():
  """greedi_reference in mode="stochastic" (global evaluation) with the
  reference's partition and per-round samples: the same sel_gids."""
  n, m, k, frac = 161, 4, 6, 0.4  # ragged: 3 holes
  w = social_graph(n, seed=5)
  key = jax.random.PRNGKey(2)
  jobj = JO.GraphCut()
  wj = jnp.asarray(w)
  eye = jnp.eye(n, dtype=jnp.float32)
  init = lambda ef, em: jobj.init_w(wj)  # noqa: E731
  want = JG.greedi_reference(key, eye, m=m, kappa=k, k_final=k,
                             objective=jobj, init_for=init, mode="stochastic",
                             sample_frac=frac, stop_nonpositive=True)
  r_part, r_sel, r_r2, _ = JG.greedi_keys(key)
  parts, pmask, perm = random_partition(r_part, eye, m)
  perm = np.asarray(perm)
  keys = jax.random.split(r_sel, m)
  npp = perm.shape[1]
  t1 = np.stack([_keep_table(keys[i], k, npp, frac) for i in range(m)])
  r1 = []
  for i in range(m):
    r = j_greedy(jobj, init(None, None), parts[i], k, cand_mask=pmask[i],
                 rng=keys[i], mode="stochastic", sample_frac=frac,
                 stop_nonpositive=True)
    _assert_separated(w, perm[i], np.asarray(pmask[i]), np.asarray(r.idx),
                      2, keep=t1[i])
    r1.append(np.where(np.asarray(r.idx) >= 0,
                       perm[i][np.maximum(np.asarray(r.idx), 0)], -1))
  bn = np.concatenate(r1)
  t2 = _keep_table(r_r2, k, m * k, frac)
  r2 = j_greedy(jobj, init(None, None), eye[np.maximum(bn, 0)], k,
                cand_mask=jnp.asarray(bn >= 0), rng=r_r2, mode="stochastic",
                sample_frac=frac, stop_nonpositive=True)
  _assert_separated(w, bn, bn >= 0, np.asarray(r2.idx), 2, keep=t2)
  tobj = TO.GraphCut()
  tw = torch.tensor(w)
  tobj.init_w(tw)
  got = TG.greedi_reference(None, torch.eye(n), m=m, kappa=k, k_final=k,
                            objective=tobj,
                            init_for=lambda ef, em: tobj.init_induced(tw),
                            mode="stochastic", stop_nonpositive=True,
                            perm=interop.perm(perm),
                            r1_draws=interop.keep_table(t1),
                            r2_draws=interop.keep_table(t2))
  assert got.sel_gids.tolist() == np.asarray(want.sel_gids).tolist()
  np.testing.assert_allclose(float(got.value), float(want.value), rtol=1e-5)


def test_centralized_random_and_node_order_match_reference():
  """centralized_greedy in mode="random" under the reference's draws, and
  in mode="standard" with assume_node_order (the fused node-space select)
  against the reference's and against the port's two-pass path."""
  n, k = 180, 20
  w = social_graph(n, seed=3)
  key = jax.random.PRNGKey(5)
  jobj = JO.GraphCut()
  wj = jnp.asarray(w)
  jr, jv = JG.centralized_greedy(jnp.eye(n), k, objective=jobj,
                                 init_for=lambda ef, em: jobj.init_w(wj),
                                 rng=key, mode="random",
                                 stop_nonpositive=True)
  ids = np.asarray(jr.idx)
  _assert_separated(w, np.arange(n), np.ones(n, bool), ids, min(k, n))
  tw = torch.tensor(w)
  tobj = TO.GraphCut()
  tobj.init_w(tw)
  tr, tv = TG.centralized_greedy(
      torch.eye(n), k, objective=tobj,
      init_for=lambda ef, em: tobj.init_induced(tw), mode="random",
      draws=interop.rank_table(_rank_table(key, k, min(k, n))),
      stop_nonpositive=True)
  assert tr.idx.tolist() == ids.tolist()
  np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)

  fused = TO.GraphCut(assume_node_order=True)
  jfused = JO.GraphCut(assume_node_order=True)
  jr, jv = JG.centralized_greedy(jnp.eye(n), k, objective=jfused,
                                 init_for=lambda ef, em: jfused.init_w(wj),
                                 stop_nonpositive=True)
  ids = np.asarray(jr.idx)
  _assert_separated(w, np.arange(n), np.ones(n, bool), ids, 2)
  a, va = TG.centralized_greedy(torch.eye(n), k, objective=fused,
                                init_for=lambda ef, em: fused.init_induced(tw),
                                stop_nonpositive=True)
  b, vb = TG.centralized_greedy(torch.eye(n), k, objective=fused,
                                init_for=lambda ef, em: fused.init_induced(tw),
                                stop_nonpositive=True, use_select=False)
  assert a.idx.tolist() == b.idx.tolist() == ids.tolist()
  np.testing.assert_allclose(float(va), float(jv), rtol=1e-5)


def test_example_alg3_flow_matches_reference():
  """The example's Alg. 3 (RandomGreedy under a partition matroid on every
  partition's induced subgraph, then on the merged B; the better of that
  and the best single machine, on the whole graph) with the reference
  example's partition and keys: the same ids and cuts."""
  ex = runpy.run_path(os.path.join(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__))), "examples", "maxcut_constrained_torch.py"),
                      run_name="example")
  n, n_comm, m = 128, 4, 4
  k = 2 * n_comm
  w = social_graph(n, seed=4)
  comm = np.arange(n) % n_comm
  obj = JO.GraphCut()
  matroid = JC.PartitionMatroid(num_parts=n_comm, caps=(2,) * n_comm)
  eye = jnp.eye(n, dtype=jnp.float32)
  wj = jnp.asarray(w)
  rc = j_greedy(obj, obj.init_w(wj), eye, k, constraint=matroid,
                meta={"part": jnp.asarray(comm)}, mode="random",
                rng=jax.random.PRNGKey(0), stop_nonpositive=True)
  parts = np.asarray(jax.random.permutation(jax.random.PRNGKey(1),
                                            n)).reshape(m, n // m)
  sols = []
  for i in range(m):
    ind = jnp.zeros((n,)).at[parts[i]].set(1.0)
    r = j_greedy(obj, obj.init_w(wj * ind[:, None] * ind[None, :]),
                 eye[parts[i]], k, constraint=matroid,
                 meta={"part": jnp.asarray(comm[parts[i]])}, mode="random",
                 rng=jax.random.PRNGKey(10 + i), stop_nonpositive=True)
    ids = np.asarray(r.idx)
    ind_np = np.zeros(n)
    ind_np[parts[i]] = 1.0
    _assert_separated(w, parts[i], np.ones(n // m, bool), ids, k,
                      ind=ind_np, parts=comm[parts[i]], caps=(2,) * n_comm)
    sols.append(ids)
  b_idx = np.concatenate([p[np.maximum(ids, 0)] for ids, p in
                          zip(sols, parts)])
  b_valid = np.concatenate([ids >= 0 for ids in sols])
  rb = j_greedy(obj, obj.init_w(wj), eye[b_idx], k, constraint=matroid,
                meta={"part": jnp.asarray(comm[b_idx])},
                cand_mask=jnp.asarray(b_valid), mode="random",
                rng=jax.random.PRNGKey(2), stop_nonpositive=True)
  _assert_separated(w, np.arange(n), np.ones(n, bool), np.asarray(rc.idx),
                    k, parts=comm, caps=(2,) * n_comm)
  _assert_separated(w, b_idx, b_valid, np.asarray(rb.idx), k,
                    parts=comm[b_idx], caps=(2,) * n_comm)

  tw = torch.tensor(w)
  tobj = TO.GraphCut()
  tobj.init_w(tw)
  draws = dict(
      central=_rank_table(jax.random.PRNGKey(0), k, k),
      r1=np.stack([_rank_table(jax.random.PRNGKey(10 + i), k, k)
                   for i in range(m)]),
      merged=_rank_table(jax.random.PRNGKey(2), k, k))
  out = ex["alg3"](tw, torch.tensor(comm),
                   TC.PartitionMatroid(num_parts=n_comm, caps=(2,) * n_comm),
                   m, k, obj=tobj, perm=interop.perm(parts),
                   draws={key: interop.rank_table(v)
                          for key, v in draws.items()})
  assert out["centralized_ids"].tolist() == [
      int(i) for i in np.asarray(rc.idx) if i >= 0]
  assert out["r1_ids"].tolist() == [
      [int(p[i]) if i >= 0 else -1 for i in ids]
      for ids, p in zip(sols, parts)]
  v_b = float(obj.value(rb.state))
  np.testing.assert_allclose(out["v_merged"], v_b, rtol=1e-5)
  np.testing.assert_allclose(out["v_centralized"],
                             float(obj.value(rc.state)), rtol=1e-5)
  singles = [float(obj.value(JG.set_value_feats(
      obj, obj.init_w(wj), eye[p[np.maximum(ids, 0)]],
      jnp.asarray(ids >= 0)))) for ids, p in zip(sols, parts)]
  np.testing.assert_allclose(out["v_best_single"], max(singles), rtol=1e-5)
  counts = np.bincount(comm[out["ids"].numpy()], minlength=n_comm)
  assert (counts <= 2).all()
  assert out["ratio"] >= out["thm12_floor"]
  assert math.isclose(out["thm12_floor"], 1 / math.e / min(m, k))


def test_graph_generators():
  """The social graph is the reference's to the bit; the Chung-Lu graph
  has exactly the asked edges, symmetric, no self-loops, weights > 0."""
  from benchmarks.common import social_graph as j_social
  assert np.array_equal(graphs.social_graph(150, seed=3),
                        j_social(150, seed=3))
  w = graphs.chung_lu_graph(500, 1200, seed=1, device="cpu")
  assert torch.equal(w, w.T) and float(w.diagonal().abs().sum()) == 0.0
  assert int((w > 0).sum()) == 2 * 1200
  deg = (w > 0).sum(1)
  assert int(deg.max()) > 4 * float(deg.float().mean())  # skewed degrees
