"""The port's saturated coverage (kernels 4-5, the objective, the greedy
loops and GreeDi) against the JAX reference on the same numpy inputs.

On the CPU the port's wrappers take their plain versions; they are held
against ``repro.kernels.ops`` (Pallas in interpret mode) and
``repro.kernels.ref`` over the sweep of tests/test_kernels.py.  Tolerances:
f32 within 1e-5 relative (2e-5 for the kernel sweep, the rule of
tests/test_kernels.py), bf16 within 3e-2, each relative to the largest
magnitude of the expected values; top-1 indices equal.

Selected ids are compared only after ``_assert_separated`` has checked that
no greedy step of the run has a near-tie: every step's top-2 gain gap is
exactly 0 or above 1e-4 relative (ROADMAP.md, port faults).  The lazy
greedy is held against the port's standard greedy and against the
reference's ``mode="lazy"``; the CUDA kernels against their plain versions
by tests/test_torch_cuda.py and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import greedi as JG  # noqa: E402
from repro.core import objectives as JO  # noqa: E402
from repro.core.greedy import greedy as j_greedy  # noqa: E402
from repro.core.partition import random_partition  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import interop, no_tf32  # noqa: E402
from repro_torch.core import greedi as TG  # noqa: E402
from repro_torch.core import greedy as TGR  # noqa: E402
from repro_torch.core import objectives as TO  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
no_tf32()  # full-FP32 products in the plain versions, as on the card

SHAPES = [(64, 64, 16), (100, 70, 17), (33, 300, 96)]  # ragged vs tiles
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
TOL = 1e-5
D = 12


def _close(got, want, tol):
  got = np.asarray(got, np.float32)
  want = np.asarray(want, np.float32)
  np.testing.assert_allclose(got, want, rtol=tol,
                             atol=tol * (float(np.abs(want).max()) + 1e-6))


def _cov_inputs(ne, nc, d, seed=0):
  """Eval rows, candidates, a cover between 0 and past the cap (some rows
  saturated), caps, a mask with dead rows, ok with masked candidates."""
  r = np.random.default_rng(seed)
  ev = r.normal(size=(ne, d)).astype(np.float32)
  cd = r.normal(size=(nc, d)).astype(np.float32)
  cap = np.abs(r.normal(size=(ne,))).astype(np.float32) * d
  cover = (cap * r.uniform(0.0, 1.3, size=(ne,))).astype(np.float32)
  mask = (r.uniform(size=(ne,)) > 0.1).astype(np.float32)
  ok = r.uniform(size=(nc,)) > 0.3
  return ev, cd, cover, cap, mask, ok


def _corpus(n, seed, d=D):
  """Nonnegative rows of varied norms (coverage mass, as the CLI's abs)."""
  r = np.random.default_rng(seed)
  x = np.abs(r.normal(size=(n, d))) * r.uniform(0.5, 1.5, size=(n, 1))
  return (x / np.sqrt(d)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("ne,nc,d", SHAPES)
def test_coverage_kernels_match_reference(ne, nc, d, kernel, dtype):
  """coverage_gain and coverage_select against the reference's wrappers
  (Pallas, interpret mode) and plain versions; masked candidates never
  win."""
  ev, cd, cover, cap, mask, ok = _cov_inputs(ne, nc, d, seed=ne + nc)
  jd, td, tol = DTYPES[dtype]
  jev, jcd = jnp.asarray(ev, jd), jnp.asarray(cd, jd)
  tev, tcd = torch.tensor(ev).to(td), torch.tensor(cd).to(td)
  t = torch.tensor
  got = ops.coverage_gain(tev, tcd, t(cover), t(cap), t(mask), kernel=kernel)
  _close(got.numpy(), jops.coverage_gain(jev, jcd, cover, cap, mask,
                                         kernel=kernel), tol)
  _close(got.numpy(), jref.coverage_gain_ref(jev, jcd, cover, cap, mask,
                                             kernel=kernel), tol)
  best, idx = ops.coverage_select(tev, tcd, t(cover), t(cap), t(mask), t(ok),
                                  kernel=kernel)
  jb, ji = jops.coverage_select(jev, jcd, cover, cap, mask, ok, kernel=kernel)
  rb, ri = jref.coverage_select_ref(jev, jcd, cover, cap, mask, ok,
                                    kernel=kernel)
  assert int(idx) == int(ji) == int(ri)
  assert ok[int(idx)]
  _close(float(best), float(jb), tol)
  _close(float(best), float(rb), tol)


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_coverage_select_infeasible_ties_and_saturation(kernel):
  """Nothing feasible -> (NEG, 0); duplicated candidates tie and the lowest
  index wins; rows with cover >= cap add 0; cap = +inf, cover = 0 is the
  facility gain at cov = 0 of the relu'd similarity."""
  ev, cd, cover, cap, mask, _ = _cov_inputs(90, 40, 8, seed=3)
  t = torch.tensor
  none = np.zeros((40,), bool)
  best, idx = ops.coverage_select(t(ev), t(cd), t(cover), t(cap), t(mask),
                                  t(none), kernel=kernel)
  jb, ji = jops.coverage_select(ev, cd, cover, cap, mask, none, kernel=kernel)
  neg = float(np.float32(ref.NEG))
  assert (float(best), int(idx)) == (float(jb), int(ji)) == (neg, 0)

  # ties: +-10 sign vectors make every similarity (and so every gain) an
  # exact number in any summation order
  r = np.random.default_rng(3)
  cd = np.where(r.uniform(size=(40, 8)) > 0.5, 10.0, -10.0).astype(np.float32)
  ev = cd[r.integers(0, 40, size=90)]
  zero = np.zeros((90,), np.float32)
  big = np.full((90,), 1e4, np.float32)
  ones = np.ones((90,), np.float32)
  g = np.asarray(jref.coverage_gain_ref(ev, cd, zero, big, ones,
                                        kernel=kernel))
  j = int(np.argmax(g))
  cd[(j + 7) % 40] = cd[j]
  cd[(j + 3) % 40] = cd[j]
  g = np.asarray(jref.coverage_gain_ref(ev, cd, zero, big, ones,
                                        kernel=kernel))
  want = int(np.flatnonzero(g == g.max())[0])
  ok = np.ones((40,), bool)
  best, idx = ops.coverage_select(t(ev), t(cd), t(zero), t(big), t(ones),
                                  t(ok), kernel=kernel)
  jb, ji = jops.coverage_select(ev, cd, zero, big, ones, ok, kernel=kernel)
  assert int(idx) == int(ji) == want
  assert float(best) == float(jb) == float(g.max())

  # saturated rows (cover >= cap) contribute nothing
  ev, cd, _, cap, mask, _ = _cov_inputs(50, 30, 8, seed=4)
  sat = np.zeros((50,), bool)
  sat[::3] = True
  cover = np.where(sat, cap * 1.5, 0.0).astype(np.float32)
  got = ops.coverage_gain(t(ev), t(cd), t(cover), t(cap), t(mask),
                          kernel=kernel)
  live = np.where(sat, 0.0, mask).astype(np.float32)
  want = ops.coverage_gain(t(ev), t(cd), t(cover), t(cap), t(live),
                           kernel=kernel)
  _close(got.numpy(), want.numpy(), 2e-5)

  # cap = +inf, cover = 0: the facility gain (cov 0) of relu(sim)
  inf = np.full((50,), np.inf, np.float32)
  got = ops.coverage_gain(t(ev), t(cd), t(zero[:50]), t(inf), t(mask),
                          kernel=kernel)
  want = ops.facility_gain(t(ev), t(cd), t(zero[:50]), t(mask),
                           kernel=kernel)
  _close(got.numpy(), want.numpy(), 2e-5)


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_coverage_partition_and_query_axes(kernel):
  """A leading partition axis with every operand batched, and the batched
  query form (per-query cover, mask and ok over one shared block and a
  shared cap), equal the reference per entry."""
  r = np.random.default_rng(5)
  P, ne, nc, d = 3, 70, 50, 12
  ev = r.normal(size=(P, ne, d)).astype(np.float32)
  cd = r.normal(size=(P, nc, d)).astype(np.float32)
  cap = np.abs(r.normal(size=(P, ne))).astype(np.float32) * 4
  cover = (cap * r.uniform(0, 1.2, size=(P, ne))).astype(np.float32)
  mask = (r.uniform(size=(P, ne)) > 0.2).astype(np.float32)
  ok = r.uniform(size=(P, nc)) > 0.3
  t = torch.tensor
  g = ops.coverage_gain(t(ev), t(cd), t(cover), t(cap), t(mask),
                        kernel=kernel)
  b, i = ops.coverage_select(t(ev), t(cd), t(cover), t(cap), t(mask), t(ok),
                             kernel=kernel)
  for p in range(P):
    _close(g[p].numpy(), jref.coverage_gain_ref(
        ev[p], cd[p], cover[p], cap[p], mask[p], kernel=kernel), 2e-5)
    jb, ji = jops.coverage_select(ev[p], cd[p], cover[p], cap[p], mask[p],
                                  ok[p], kernel=kernel)
    assert int(i[p]) == int(ji)
    _close(float(b[p]), float(jb), 2e-5)
  # the reference's coverage_select_batched: B queries, cap and block shared
  jb, ji = jops.coverage_select_batched(ev[0], cd[0], cover, cap[0], mask,
                                        ok, kernel=kernel)
  b, i = ops.coverage_select(t(ev[0]), t(cd[0]), t(cover), t(cap[0]),
                             t(mask), t(ok), kernel=kernel)
  np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
  _close(b.numpy(), np.asarray(jb), 2e-5)


def _objs(kernel="linear", kw=(), alpha=0.25):
  return (JO.SaturatedCoverage(kernel=kernel, kernel_kwargs=kw, alpha=alpha,
                               backend="ref"),
          TO.SaturatedCoverage(kernel=kernel, kernel_kwargs=kw, alpha=alpha))


@pytest.mark.parametrize("kernel,kw", [("linear", ()),
                                       ("rbf", (("h", 1.0),))])
def test_objective_methods_match_jax(kernel, kw):
  """init (total and cap), gains, select, update, value and partial_stats
  against the JAX objective, also from a state carried across; the
  ``total`` argument is honored."""
  x = _corpus(150, 1)
  mask = (np.random.default_rng(2).uniform(size=150) > 0.1).astype(
      np.float32)
  jo, to = _objs(kernel, kw)
  js = jo.init(jnp.asarray(x), jnp.asarray(mask))
  ts = to.init(torch.tensor(x), torch.tensor(mask))
  _close(ts.cap.numpy(), js.cap, TOL)
  cands = x[:60]
  for step in range(4):
    _close(to.gains(ts, torch.tensor(cands)).numpy(),
           jo.gains(js, jnp.asarray(cands)), TOL)
    ok = np.arange(60) % 5 != step
    tb, ti = to.select(ts, torch.tensor(cands), torch.tensor(ok))
    jb, ji = jo.select(js, jnp.asarray(cands), jnp.asarray(ok))
    assert int(ti) == int(ji)
    _close(float(tb), float(jb), TOL)
    part, live = to.partial_stats(ts, torch.tensor(cands))
    jpart, jlive = jo.partial_stats(js, jnp.asarray(cands))
    _close(part.numpy(), jpart, TOL)
    assert float(live) == float(jlive)
    js = jo.update(js, jnp.asarray(cands[int(ji)]))
    ts = to.update(ts, torch.tensor(cands[int(ji)]))
    _close(ts.cover.numpy(), js.cover, TOL)
    _close(float(to.value(ts)), float(jo.value(js)), TOL)
  # a reference state carried into the port continues identically
  ts2 = interop.satcov_state(jax.tree.map(np.asarray, js))
  _close(to.gains(ts2, torch.tensor(cands)).numpy(),
         jo.gains(js, jnp.asarray(cands)), TOL)
  # an explicit total is honored
  total = np.full((150,), 3.0, np.float32)
  ts = to.init(torch.tensor(x), torch.tensor(mask), total=torch.tensor(total))
  js = jo.init(jnp.asarray(x), jnp.asarray(mask), total=jnp.asarray(total))
  _close(ts.cap.numpy(), js.cap, TOL)


@pytest.mark.parametrize("kernel,kw", [("linear", ()),
                                       ("rbf", (("h", 1.0),))])
def test_chunked_total_matches_dense(monkeypatch, kernel, kw):
  """The total pass in candidate chunks (ragged last chunk, a partition
  axis) equals the reference's dense sim(eval, eval) row sums."""
  x = _corpus(2 * 130, 3).reshape(2, 130, D)
  mask = (np.random.default_rng(4).uniform(size=(2, 130)) > 0.2).astype(
      np.float32)
  jo, to = _objs(kernel, kw)
  monkeypatch.setattr(TO, "_TOTAL_CHUNK", 48)
  got = to.total(torch.tensor(x), torch.tensor(mask))
  for p in range(2):
    sim = np.maximum(np.asarray(JO.KERNELS[kernel](
        jnp.asarray(x[p]), jnp.asarray(x[p]), **dict(kw))), 0.0)
    _close(got[p].numpy(), (sim * mask[p][None, :]).sum(1), TOL)
    js = jo.init(jnp.asarray(x[p]), jnp.asarray(mask[p]))
    _close(0.25 * got[p].numpy(), js.cap, TOL)


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
                     dim=-1)
    feat = torch.gather(cands, -2, i[..., None, None].expand(
        *i.shape, 1, cands.shape[-1])).squeeze(-2)
    state = obj.update(state, feat)
    sel = sel.scatter(-1, i[..., None], True)


def test_standard_greedy_matches_jax():
  """The fused select step and the two-pass step against the reference's
  greedy: equal ids, values and gains within 1e-5."""
  x = _corpus(200, 5)
  jo, to = _objs()
  tx = torch.tensor(x)
  _assert_separated(to, to.init(tx), tx, 10, torch.ones(200, dtype=torch.bool))
  jr = j_greedy(jo, jo.init(jnp.asarray(x)), jnp.asarray(x), 10)
  for use_select in (True, False):
    tr = TGR.greedy(to, to.init(tx), tx, 10, use_select=use_select)
    np.testing.assert_array_equal(tr.idx.numpy(), np.asarray(jr.idx))
    np.testing.assert_allclose(tr.values.numpy(), np.asarray(jr.values),
                               rtol=TOL)
    np.testing.assert_allclose(tr.gains.numpy(), np.asarray(jr.gains),
                               rtol=TOL)


@pytest.mark.parametrize("objective", ["satcov", "facility"])
def test_lazy_greedy_cold_and_warm(objective):
  """The tile-bound lazy greedy, cold and warm-started, over a batch of
  partitions (ragged: the last tile is padded) with masked rows: the
  standard greedy's ids and values, the reference's mode="lazy" per
  partition, rescans > 0; loose bounds cost rescans, never a pick."""
  P, n, k, tile = 3, 150, 8, 32
  x = _corpus(P * n, 6).reshape(P, n, D)
  mask = np.random.default_rng(7).uniform(size=(P, n)) > 0.1
  if objective == "satcov":
    jo, to = _objs()
  else:
    jo = JO.FacilityLocation(backend="ref")
    to = TO.FacilityLocation()
  tx, tm = torch.tensor(x), torch.tensor(mask)
  st = to.init(tx, tm.float())
  _assert_separated(to, st, tx, k, tm)
  std = TGR.greedy(to, st, tx, k, cand_mask=tm)
  cold = TGR.greedy(to, st, tx, k, cand_mask=tm, mode="lazy", lazy_tile=tile)
  # warm: exact empty-set gains inflated, and a looser 2x + 1 bound
  g0 = to.gains(st, tx)
  for wb in (g0 * (1 + 1e-3) + 1e-6, 2 * g0 + 1):
    warm = TGR.greedy(to, st, tx, k, cand_mask=tm, mode="lazy",
                      lazy_tile=tile, warm_bounds=wb)
    np.testing.assert_array_equal(warm.idx.numpy(), std.idx.numpy())
    np.testing.assert_allclose(warm.values.numpy(), std.values.numpy(),
                               rtol=TOL)
    assert (warm.rescans > 0).all()
  np.testing.assert_array_equal(cold.idx.numpy(), std.idx.numpy())
  np.testing.assert_allclose(cold.values.numpy(), std.values.numpy(),
                             rtol=TOL)
  assert (cold.rescans > 0).all() and not std.rescans.any()
  # pruning: fewer tiles than a full rescan of every later step
  assert (cold.rescans < (k - 1) * (-(-n // tile))).all()
  for p in range(P):
    js0 = jo.init(jnp.asarray(x[p]), jnp.asarray(mask[p], jnp.float32))
    jr = j_greedy(jo, js0, jnp.asarray(x[p]), k,
                  cand_mask=jnp.asarray(mask[p]), mode="lazy", lazy_tile=tile)
    np.testing.assert_array_equal(cold.idx[p].numpy(), np.asarray(jr.idx))
    np.testing.assert_allclose(cold.values[p].numpy(), np.asarray(jr.values),
                               rtol=TOL)
    assert int(cold.rescans[p]) > 0 and int(jr.rescans) > 0


def test_lazy_falls_back_for_non_monotone():
  """The DPP log-det is not monotone: mode="lazy" runs the standard
  greedy (no rescans), as the reference falls back."""
  r = np.random.default_rng(8)
  x = torch.tensor((2.0 * r.normal(size=(64, 6)) / np.sqrt(6)).astype(
      np.float32))
  to = TO.LogDetDPP(k_max=6, kernel="linear", kernel_kwargs=())
  std = TGR.greedy(to, to.init_d(6), x, 6, stop_nonpositive=True)
  lazy = TGR.greedy(to, to.init_d(6), x, 6, stop_nonpositive=True,
                    mode="lazy")
  np.testing.assert_array_equal(lazy.idx.numpy(), std.idx.numpy())
  assert int(lazy.rescans) == 0


@pytest.mark.parametrize("local_eval", [False, True])
def test_greedi_reference_matches_jax(local_eval):
  """greedi_reference with SaturatedCoverage on the reference's partition
  (standard and lazy rounds), and the centralized greedy: equal ids,
  values within 1e-5."""
  n, m, k = 240, 4, 5
  x = _corpus(n, 9)
  rng = jax.random.PRNGKey(2)
  r_part, _, _, _ = JG.greedi_keys(rng)
  _, _, perm = random_partition(r_part, jnp.asarray(x), m)
  perm = np.asarray(perm)
  jo, to = _objs()
  tx = torch.tensor(x)
  parts = tx[torch.tensor(perm.reshape(-1))].reshape(m, -1, D)
  st = to.init(parts) if local_eval else to.broadcast(to.init(tx), m)
  _assert_separated(to, st, parts, k, torch.ones(parts.shape[:2],
                                                 dtype=torch.bool))
  # two-argument init: the reference passes a third (the candidates) to an
  # init that takes one, and SaturatedCoverage.init's third is ``total``
  j_init = lambda ef, em: jo.init(ef, em)  # noqa: E731
  jr = JG.greedi_reference(rng, jnp.asarray(x), m=m, kappa=k, k_final=k,
                           objective=jo, init_for=j_init,
                           local_eval=local_eval)
  for mode in ("standard", "lazy"):
    tr = interop.to_numpy(TG.greedi_reference(
        None, tx, m=m, kappa=k, k_final=k, objective=to, init_for=to.init,
        local_eval=local_eval, perm=interop.perm(perm), mode=mode))
    np.testing.assert_array_equal(tr.sel_gids, np.asarray(jr.sel_gids))
    for name in ("value", "value_merged", "value_best_single",
                 "stage1_values"):
      np.testing.assert_allclose(getattr(tr, name),
                                 np.asarray(getattr(jr, name)), rtol=TOL,
                                 err_msg=name)
  jc, jv = JG.centralized_greedy(jnp.asarray(x), k, objective=jo,
                                 init_for=j_init)
  tc, tv = TG.centralized_greedy(tx, k, objective=to, init_for=to.init,
                                 mode="lazy")
  np.testing.assert_array_equal(tc.idx.numpy(), np.asarray(jc.idx))
  np.testing.assert_allclose(float(tv), float(jv), rtol=TOL)
