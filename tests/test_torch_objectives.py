"""The port's remaining objectives against the JAX reference on the CPU:
the ``neg_sq_dist`` similarity and the generic gains of facility location,
saturated coverage, information gain and the DPP log-det (rtol 1e-5);
``FacilityLocationPre`` against ``FacilityLocation`` and the reference's
``FacilityLocationPre`` through ``centralized_greedy`` and
``greedi_reference`` (equal ids on well-separated data, values within
1e-5); the 2-, 3- and ``*args``-arity ``init_for``; ``Modular`` (greedy
and GreeDi optimal, warm-lazy equal to cold); ``set_value`` with a mask;
the cold ``neg_sq_dist`` service and the maintainers' None cases; and
``examples/quickstart_torch.py --device cpu``.

Inputs are numpy arrays from a seed, handed to both packages.  Rows of
the ``neg_sq_dist`` cases are scaled small (norm about 0.3) so that the
information-gain and DPP conditional variances stay away from their
1e-12 floor (-|x - y|^2 is not a positive kernel).
"""
import os
import runpy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.common import tiny_images_like  # noqa: E402
from repro.core import greedi as JG  # noqa: E402
from repro.core import objectives as JO  # noqa: E402
from repro.core.greedy import greedy as j_greedy  # noqa: E402
from repro.core.partition import random_partition  # noqa: E402
from repro.service import SelectionService as JService  # noqa: E402
from repro.util import make_mesh  # noqa: E402
from repro_torch import interop, no_tf32  # noqa: E402
from repro_torch.core import bounds  # noqa: E402
from repro_torch.core import greedi as TG  # noqa: E402
from repro_torch.core import objectives as TO  # noqa: E402
from repro_torch.core.greedy import greedy as t_greedy  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.service import SelectionService as TService  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
no_tf32()  # full-FP32 products in the plain versions, as on the card

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
D = 8


def _small(seed, *shape):
  """Rows of norm about 0.3: neg_sq_dist values of a few hundredths."""
  r = np.random.default_rng(seed)
  return (r.normal(size=shape) * 0.1).astype(np.float32)


def _objs(name):
  """(reference, port) objective pair of a generic-path case."""
  if name == "facility":
    kw = dict(kernel="neg_sq_dist", baseline=-0.05)
    return JO.FacilityLocation(**kw), TO.FacilityLocation(**kw)
  if name == "coverage":
    return (JO.SaturatedCoverage(kernel="neg_sq_dist"),
            TO.SaturatedCoverage(kernel="neg_sq_dist"))
  kw = dict(k_max=6, kernel="neg_sq_dist", kernel_kwargs=())
  if name == "info_gain":
    return JO.InformationGain(**kw), TO.InformationGain(**kw)
  # -|x - y|^2 is not a positive kernel: a unit ridge keeps the DPP's
  # conditional variances off their 1e-12 floor
  return (JO.LogDetDPP(jitter=1.0, **kw), TO.LogDetDPP(jitter=1.0, **kw))


def _init(name, obj, x, mask, np_mod):
  if name in ("info_gain", "dpp"):
    return obj.init_d(D)
  return obj.init(x, mask)


def test_neg_sq_dist_matches_reference():
  x, y = _small(0, 40, D), _small(1, 3, 25, D)
  got = TO.KERNELS["neg_sq_dist"](torch.tensor(x), torch.tensor(y))
  want = np.stack([np.asarray(JO.neg_sq_dist(jnp.asarray(x),
                                             jnp.asarray(y[p])))
                   for p in range(3)])
  np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=1e-7)
  # the in-place block and the column of an update carry the same bits
  assert torch.equal(TO._sim_block(torch.tensor(x), torch.tensor(y),
                                   "neg_sq_dist", 0.75), got)
  col = TO._sim_column(torch.tensor(x), torch.tensor(y[0, :2]),
                       "neg_sq_dist", 0.75)
  np.testing.assert_allclose(col.numpy(), got[0, :, :2].T.numpy(),
                             rtol=TOL, atol=1e-7)


@pytest.mark.parametrize("name", ["facility", "coverage", "info_gain",
                                  "dpp"])
def test_generic_gains_match_reference(name):
  """Gains, select and value of the generic path after two updates, for
  one state and for a broadcast state over a batch of candidate blocks."""
  x, c = _small(2, 60, D), _small(3, 3, 20, D)
  mask = (np.random.default_rng(4).uniform(size=60) < 0.8).astype(
      np.float32)
  jo, to = _objs(name)
  js = _init(name, jo, jnp.asarray(x), jnp.asarray(mask), jnp)
  ts = _init(name, to, torch.tensor(x), torch.tensor(mask), torch)
  for i in (3, 7):
    js = jo.update(js, jnp.asarray(x[i]))
    ts = to.update(ts, torch.tensor(x[i]))
  np.testing.assert_allclose(float(to.value(ts)), float(jo.value(js)),
                             rtol=TOL, atol=1e-7)
  ok = np.ones(20, bool)
  ok[5] = False
  for p in range(3):
    want = np.asarray(jo.gains(js, jnp.asarray(c[p])))
    got = to.gains(ts, torch.tensor(c[p]))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=1e-7)
    b, i = to.select(ts, torch.tensor(c[p]), torch.tensor(ok))
    jb, ji = jo.select(js, jnp.asarray(c[p]), jnp.asarray(ok))
    assert int(i) == int(ji)
    np.testing.assert_allclose(float(b), float(jb), rtol=TOL, atol=1e-7)
  if name in ("facility", "coverage"):
    tb = to.broadcast(ts, 3)
    got = to.gains(tb, torch.tensor(c))
    for p in range(3):
      np.testing.assert_allclose(
          got[p].numpy(), np.asarray(jo.gains(js, jnp.asarray(c[p]))),
          rtol=TOL, atol=1e-7)
    part, live = to.partial_stats(ts, torch.tensor(c[0]))
    jpart, jlive = jo.partial_stats(js, jnp.asarray(c[0]))
    np.testing.assert_allclose(part.numpy(), np.asarray(jpart), rtol=TOL,
                               atol=1e-7)
    assert float(live) == float(jlive)


@pytest.mark.parametrize("kernel,kw", [("linear", ()),
                                       ("rbf", (("h", 0.75),))])
def test_generic_path_equals_the_fused_plain_versions(kernel, kw,
                                                      monkeypatch):
  """The generic machinery on a fused similarity: the chunked cuBLAS
  block through ``relu_colsum`` (facility) and the reference formula
  (coverage) against the fused kernels' plain versions, with the byte
  budget cut so a call takes several candidate chunks; a chunk's columns
  carry the one-chunk call's bits."""
  r = np.random.default_rng(5)
  x = torch.tensor(r.normal(size=(2, 50, D)).astype(np.float32))
  c = torch.tensor(r.normal(size=(37, D)).astype(np.float32))
  cov = torch.tensor(np.abs(r.normal(size=(2, 50))).astype(np.float32))
  cap = cov * 3.0
  mask = torch.tensor((r.uniform(size=(2, 50)) < 0.7).astype(np.float32))
  h = dict(kw).get("h", 0.75)
  one = TO._generic_facility(x, c, cov, mask, kernel, h, ref.relu_colsum_ref)
  want = ref.facility_gain_ref(x, c, cov, mask, kernel=kernel, h=h)
  np.testing.assert_allclose(one.numpy(), want.numpy(), rtol=TOL, atol=1e-6)
  cw = TO._generic_coverage(x, c, cov, cap, mask, kernel, h)
  cw_want = ref.coverage_gain_ref(x, c, cov, cap, mask, kernel=kernel, h=h)
  np.testing.assert_allclose(cw.numpy(), cw_want.numpy(), rtol=TOL,
                             atol=1e-6)
  monkeypatch.setattr(TO, "_GENERIC_BLOCK_BYTES", 4 * 2 * 50 * 8)
  assert TO._chunk_cols(2, 50) == 8
  chunked = TO._generic_facility(x, c, cov, mask, kernel, h,
                                 ref.relu_colsum_ref)
  np.testing.assert_allclose(chunked.numpy(), one.numpy(), rtol=1e-6,
                             atol=1e-7)
  np.testing.assert_allclose(
      TO._generic_coverage(x, c, cov, cap, mask, kernel, h).numpy(),
      cw.numpy(), rtol=1e-6, atol=1e-7)


def _partition(rng, feats, m):
  r_part, _, _, _ = JG.greedi_keys(rng)
  _, _, perm = random_partition(r_part, jnp.asarray(feats), m)
  return np.asarray(perm)


def _pre_init(obj):
  return lambda ef, em, cf: obj.init(ef, em, cf)


@pytest.mark.parametrize("kernel,kw,baseline", [
    ("linear", (), 0.0), ("rbf", (("h", 1.5),), 0.0),
    ("neg_sq_dist", (), -1.0)])
def test_facility_pre_matches_facility_and_reference(kernel, kw, baseline):
  """Centralized greedy and GreeDi (global and local evaluation) with the
  cached similarity block: the port's FacilityLocationPre selects what its
  FacilityLocation and the reference's FacilityLocationPre select.  The
  corpus is one on which the reference's own FacilityLocationPre and
  FacilityLocation agree (checked first): on seed 8 one machine's local
  neg_sq_dist round 1 has a near-tie, and there the reference's two
  objectives part themselves (stage-1 values 8 % apart)."""
  f = np.asarray(tiny_images_like(256, 16, clusters=8, seed=9))
  opts = dict(kernel=kernel, kernel_kwargs=kw, baseline=baseline)
  jpre, tpre = JO.FacilityLocationPre(**opts), TO.FacilityLocationPre(**opts)
  tfl = TO.FacilityLocation(**opts)
  tx = torch.tensor(f)
  jr, jv = JG.centralized_greedy(jnp.asarray(f), 8, objective=jpre,
                                 init_for=_pre_init(jpre))
  tr, tv = TG.centralized_greedy(tx, 8, objective=tpre,
                                 init_for=_pre_init(tpre))
  fr, fv = TG.centralized_greedy(tx, 8, objective=tfl, init_for=tfl.init)
  np.testing.assert_array_equal(tr.idx.numpy(), np.asarray(jr.idx))
  np.testing.assert_array_equal(fr.idx.numpy(), np.asarray(jr.idx))
  np.testing.assert_allclose([float(tv), float(fv)], float(jv), rtol=TOL)
  rng = jax.random.PRNGKey(1)
  perm = _partition(rng, f, 8)
  jfl = JO.FacilityLocation(**opts)
  for local_eval in (False, True):
    jg = JG.greedi_reference(rng, jnp.asarray(f), m=8, kappa=4, k_final=4,
                             objective=jpre, init_for=_pre_init(jpre),
                             local_eval=local_eval)
    jf = JG.greedi_reference(rng, jnp.asarray(f), m=8, kappa=4, k_final=4,
                             objective=jfl, init_for=jfl.init,
                             local_eval=local_eval)
    np.testing.assert_allclose(np.asarray(jf.stage1_values),
                               np.asarray(jg.stage1_values), rtol=TOL)
    for obj, init in ((tpre, _pre_init(tpre)), (tfl, tfl.init)):
      tg = interop.to_numpy(TG.greedi_reference(
          None, tx, m=8, kappa=4, k_final=4, objective=obj, init_for=init,
          local_eval=local_eval, perm=interop.perm(perm)))
      np.testing.assert_array_equal(tg.sel_gids, np.asarray(jg.sel_gids))
      for field in ("value", "value_merged", "value_best_single",
                    "stage1_values"):
        np.testing.assert_allclose(getattr(tg, field),
                                   np.asarray(getattr(jg, field)), rtol=TOL)


def test_facility_pre_gains_and_lazy_fallback():
  """The cached block answers for the cached candidates whatever slice
  ``gains`` is handed; dead eval rows carry nothing; ``mode="lazy"`` falls
  back to standard (no rescans)."""
  f = _small(6, 40, D) * 10
  mask = np.ones(40, np.float32)
  mask[::4] = 0.0
  jpre, tpre = JO.FacilityLocationPre(), TO.FacilityLocationPre()
  js = jpre.init(jnp.asarray(f), jnp.asarray(mask), jnp.asarray(f[:30]))
  ts = tpre.init(torch.tensor(f), torch.tensor(mask), torch.tensor(f[:30]))
  assert tuple(ts.sim.shape) == (40, 30)
  for i in (2, 9):
    js = jpre.update(js, jnp.asarray(f[i]))
    ts = tpre.update(ts, torch.tensor(f[i]))
  g = tpre.gains(ts, torch.tensor(f[:5]))
  np.testing.assert_allclose(g.numpy(), np.asarray(jpre.gains(js, None)),
                             rtol=TOL, atol=1e-7)
  np.testing.assert_allclose(float(tpre.value(ts)), float(jpre.value(js)),
                             rtol=TOL)
  r = t_greedy(tpre, tpre.init(torch.tensor(f)), torch.tensor(f), 5,
               mode="lazy")
  s = t_greedy(tpre, tpre.init(torch.tensor(f)), torch.tensor(f), 5)
  assert torch.equal(r.idx, s.idx) and not r.rescans.any()


def test_init_arity_dispatch():
  """2-argument and 3-argument (precompute) init_for both work and agree;
  a ``*args`` callable counts as 3-argument; an error raised inside the
  user's init propagates (no probe-and-retry)."""
  f = torch.tensor(np.asarray(tiny_images_like(96, 16, clusters=6, seed=3)))
  fl = TO.FacilityLocation()
  _, v2 = TG.centralized_greedy(f, 6, objective=fl, init_for=fl.init)
  pre = TO.FacilityLocationPre()
  _, v3 = TG.centralized_greedy(f, 6, objective=pre,
                                init_for=lambda ef, em, cand: pre.init(
                                    ef, em, cand))
  np.testing.assert_allclose(float(v2), float(v3), rtol=TOL)
  _, v4 = TG.centralized_greedy(f, 6, objective=pre,
                                init_for=lambda *a: pre.init(*a))
  np.testing.assert_allclose(float(v3), float(v4), rtol=1e-6)
  assert TG._init_arity(lambda a, b: 0) == 2
  assert TG._init_arity(lambda a, b, c=None: 0) == 3
  assert TG._init_arity(lambda *a: 0) == 3
  # SaturatedCoverage.init's levels are keyword-only: a 2-argument init
  assert TG._init_arity(TO.SaturatedCoverage().init) == 2

  def bad_init3(ef, em, cand):
    raise TypeError("boom in precompute init")

  with pytest.raises(TypeError, match="boom in precompute init"):
    TG.centralized_greedy(f, 4, objective=fl, init_for=bad_init3)


def test_modular_greedy_and_greedi_are_optimal():
  """Greedy on a modular f returns the top-k by weight; GreeDi's value is
  the centralized one (the reference's tests); the ids match the
  reference's under its partition."""
  r = np.random.default_rng(8)
  feats = r.normal(size=(96, 6)).astype(np.float32)
  wv = r.normal(size=6).astype(np.float32)
  obj = TO.Modular()
  st0 = obj.init_w(torch.tensor(wv))
  res = t_greedy(obj, st0, torch.tensor(feats[:20]), 5)
  want = np.sort(np.maximum(feats[:20] @ wv, 0.0))[-5:].sum()
  np.testing.assert_allclose(float(obj.value(res.state)), want, rtol=TOL)
  init = lambda ef, em: obj.init_w(torch.tensor(wv))  # noqa: E731
  _, v_c = TG.centralized_greedy(torch.tensor(feats), 6, objective=obj,
                                 init_for=init)
  jobj = JO.Modular()
  rng = jax.random.PRNGKey(2)
  jr = JG.greedi_reference(rng, jnp.asarray(feats), m=4, kappa=6, k_final=6,
                           objective=jobj,
                           init_for=lambda ef, em: jobj.init_w(
                               jnp.asarray(wv)))
  tr = TG.greedi_reference(None, torch.tensor(feats), m=4, kappa=6,
                           k_final=6, objective=obj, init_for=init,
                           perm=interop.perm(_partition(rng, feats, 4)))
  np.testing.assert_allclose(float(tr.value), float(v_c), rtol=TOL)
  np.testing.assert_allclose(float(tr.value), float(jr.value), rtol=TOL)
  assert sorted(tr.sel_gids.tolist()) == sorted(np.asarray(
      jr.sel_gids).tolist())


def _warm_cases():
  r = np.random.default_rng(9)
  f = np.abs(r.normal(size=(220, 12))).astype(np.float32)
  f = f * r.uniform(0.5, 1.5, size=(220, 1)).astype(np.float32)
  w = np.abs(r.normal(size=12)).astype(np.float32)
  g = (f * 0.05).astype(np.float32)
  mod_j, mod_t = JO.Modular(), TO.Modular()
  nsd = dict(kernel="neg_sq_dist", baseline=-0.5)
  fl_j, fl_t = JO.FacilityLocation(**nsd), TO.FacilityLocation(**nsd)
  return {
      "modular": (mod_j, mod_j.init_w(jnp.asarray(w)), mod_t,
                  mod_t.init_w(torch.tensor(w)), f),
      "facility_neg_sq_dist": (fl_j, fl_j.init(jnp.asarray(g)), fl_t,
                               fl_t.init(torch.tensor(g)), g),
  }


@pytest.mark.parametrize("name", ["modular", "facility_neg_sq_dist"])
def test_warm_lazy_bit_identical_to_cold(name):
  """mode="lazy" seeded with the exact empty-set gains, loose
  over-estimates, +inf (unseen items) and a mix selects what the cold
  lazy run selects, which is the reference's cold lazy selection (the
  reference's test_warm_lazy_bit_identical_to_cold cases)."""
  jo, js0, to, ts0, feats = _warm_cases()[name]
  tf = torch.tensor(feats)
  cold = t_greedy(to, ts0, tf, 8, mode="lazy")
  jcold = j_greedy(jo, js0, jnp.asarray(feats), 8, mode="lazy")
  np.testing.assert_array_equal(cold.idx.numpy(), np.asarray(jcold.idx))
  exact0 = to.gains(ts0, tf).float()
  bounds_ = {
      "carried": exact0,
      "loose": exact0 + 0.37,
      "fresh_items": torch.full_like(exact0, torch.inf),
      "mixed": torch.where(torch.arange(220) % 3 == 0, torch.inf,
                           exact0 + 0.1),
  }
  for label, wb in bounds_.items():
    warm = t_greedy(to, ts0, tf, 8, mode="lazy", warm_bounds=wb)
    assert warm.idx.tolist() == cold.idx.tolist(), (name, label)
    np.testing.assert_allclose(warm.values.numpy(), cold.values.numpy(),
                               rtol=TOL, atol=1e-6)


def test_set_value_with_a_mask():
  f = np.asarray(tiny_images_like(64, 16, clusters=4, seed=1))
  idx = np.array([3, 17, 40, 5, 63])
  mask = np.array([True, False, True, True, False])
  cases = [(JO.FacilityLocation(), TO.FacilityLocation(), "init"),
           (JO.FacilityLocation(kernel="neg_sq_dist", baseline=-1.0),
            TO.FacilityLocation(kernel="neg_sq_dist", baseline=-1.0), "init"),
           (JO.Modular(), TO.Modular(), "w")]
  w = np.linspace(-1, 1, 16).astype(np.float32)
  for jo, to, how in cases:
    if how == "w":
      js0, ts0 = jo.init_w(jnp.asarray(w)), to.init_w(torch.tensor(w))
    else:
      js0, ts0 = jo.init(jnp.asarray(f)), to.init(torch.tensor(f))
    want = JO.set_value(jo, js0, jnp.asarray(f), jnp.asarray(idx),
                        jnp.asarray(mask))
    got = TO.set_value(to, ts0, torch.tensor(f), torch.tensor(idx),
                       torch.tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)
    full = TO.set_value(to, ts0, torch.tensor(f), idx[mask])
    np.testing.assert_allclose(float(full), float(want), rtol=TOL)


def test_generic_sharded_engine_agrees_with_reference_path():
  """The k-medoid surrogate (neg_sq_dist, baseline -1 on unit rows)
  through the port's generic ``greedi_sharded`` (four stacked shards) and
  its ``greedi_reference`` with local evaluation on the same partition:
  the same coreset and value, at or above the Thm-4 floor of the
  centralized greedy; the fast engine refuses the similarity."""
  f = np.asarray(tiny_images_like(256, 16, clusters=8, seed=4))
  obj = TO.FacilityLocation(kernel="neg_sq_dist", baseline=-1.0)
  tx = torch.tensor(f)
  perm = torch.randperm(256, generator=torch.Generator().manual_seed(0))
  perm = perm.reshape(4, 64)
  ref_r = TG.greedi_reference(None, tx, m=4, kappa=6, k_final=6,
                              objective=obj, init_for=obj.init,
                              local_eval=True, perm=perm)
  sh = TG.greedi_sharded(tx[perm.reshape(-1)], m=4, kappa=6, k_final=6,
                         objective=obj, gids=perm.reshape(-1))
  assert sorted(sh.sel_gids.tolist()) == sorted(ref_r.sel_gids.tolist())
  np.testing.assert_allclose(float(sh.value), float(ref_r.value), rtol=TOL)
  _, v_c = TG.centralized_greedy(tx, 6, objective=obj, init_for=obj.init)
  assert float(sh.value) >= bounds.thm4_bound(4, 6) * float(v_c)
  # the cached-similarity engine caches through ``pairwise``, which has no
  # neg_sq_dist: it refuses, naming it (tests/test_greedi_indices.py)
  with pytest.raises(ValueError, match="pairwise"):
    TG.greedi_sharded_fast(tx, m=4, kappa=4, k_final=4, kernel="neg_sq_dist")


def test_maintainers_gate_and_neg_sq_dist_service_runs_cold():
  """``bound_maintainer_for`` is None where the reference's gates say so;
  a ``neg_sq_dist`` service runs cold (no table, no sieve), answers
  queries from its last epoch, refuses the exact tier, and selects what
  an explicitly cold service and the reference's service select on the
  same partition."""
  for obj in (TO.FacilityLocation(kernel="neg_sq_dist"),
              TO.FacilityLocation(baseline=-0.5), TO.Modular(),
              TO.FacilityLocationPre(), TO.GraphCut(),
              TO.SaturatedCoverage(kernel="neg_sq_dist"),
              TO.InformationGain(k_max=4, kernel="neg_sq_dist",
                                 kernel_kwargs=())):
    assert TO.bound_maintainer_for(obj) is None, obj
  assert TO.bound_maintainer_for(TO.FacilityLocation(baseline=0.2))
  r = np.random.default_rng(6)
  x = r.normal(size=(150, 16))
  f = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
  kw = dict(d=16, kappa=4, k_final=4, capacity=256, append_block=64,
            kernel="neg_sq_dist", seed=0)
  # the phantom exemplar at the origin (baseline -1 on unit rows): at
  # baseline 0 every neg_sq_dist gain is 0 and only tie-breaks would pick
  objs = (JO.FacilityLocation(kernel="neg_sq_dist", baseline=-1.0),
          TO.FacilityLocation(kernel="neg_sq_dist", baseline=-1.0))
  r_part, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 0))
  _, _, perm = random_partition(r_part, jnp.zeros((256, 1)), 1)
  perm = torch.as_tensor(np.asarray(perm).astype(np.int64))
  sels = []
  for warm in (True, False):
    svc = TService(m=1, warm_start=warm, device="cpu", objective=objs[1],
                   **kw)
    assert not svc.warm and not svc.sieve_enabled
    svc.append(f)
    res = svc.epoch(perm=perm)
    assert not res.stats.warm and (svc.store.ubound == 0.0).all()
    sels.append(res.sel_gids.tolist())
    svc.append(f[:10] * 0.5)
    q = svc.query()
    assert q.source == "epoch" and q.appends_since_epoch == 1
    assert q.sel_gids.tolist() == res.sel_gids.tolist()
    with pytest.raises(ValueError, match="fused"):
      svc.query_batch([None], tier="exact")
  assert sels[0] == sels[1]
  jsvc = JService(make_mesh((1,), ("data",)), objective=objs[0], **kw)
  jsvc.append(f)
  assert sels[0] == jsvc.epoch().sel_gids.tolist()


def test_quickstart_example_on_the_cpu(capsys):
  ns = runpy.run_path(os.path.join(REPO, "examples", "quickstart_torch.py"),
                      run_name="example")
  ratio = ns["main"](["--device", "cpu"])
  out = capsys.readouterr().out
  assert "centralized greedy" in out and "baseline greedy/max" in out
  assert ratio >= bounds.thm4_bound(8, 32)
