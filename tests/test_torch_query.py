"""The port's query path (``CorpusStore.query_sieves`` / ``_batch`` /
``query_exact_batch``, ``SelectionService.query`` / ``query_batch``,
``QueryBatcher``, the three query-batched selects, the CLI's query flags
and the pipeline's heartbeat acks) against the reference on the same
numpy inputs.

The merges start from one identical sieve state (the reference's, carried
across by ``interop.sieve_state``); seeded queries get the reference's
jitter draw (``jax.random.uniform(PRNGKey(seed), (N,))``).  Ids must be
equal and scores within 1e-6 relative.  A batched answer must select what
the same request selects alone.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import objectives as JO  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.service import CorpusStore as JStore  # noqa: E402
from repro.service import SelectionService as JService  # noqa: E402
from repro.util import make_mesh  # noqa: E402
from repro_torch import interop, no_tf32  # noqa: E402
from repro_torch.core import objectives as TO  # noqa: E402
from repro_torch.data.pipeline import (EmbeddedCorpus,  # noqa: E402
                                       batches_from_epochs,
                                       batches_from_indices)
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.service import (CorpusStore, HeartbeatBoard,  # noqa: E402
                                 QueryBatcher, QueryRequest,
                                 SelectionService)

jax.config.update("jax_platform_name", "cpu")
no_tf32()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, K, AB, MC = 16, 8, 64, 16


def _unit(seed, n, d=D):
  r = np.random.default_rng(seed)
  x = r.normal(size=(n, d))
  return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _u(seed, n):
  """The reference merge's jitter uniforms for ``seed``."""
  return np.asarray(jax.random.uniform(jax.random.PRNGKey(int(seed)), (n,),
                                       jnp.float32))


def _pair(kernel, n=240, tile=None):
  """A reference store and a port store over the same rows; the port's
  sieve set to the reference's."""
  kw = (("h", 1.5),) if kernel == "rbf" else ()
  obj_j = JO.FacilityLocation(kernel=kernel, kernel_kwargs=kw)
  obj_t = TO.FacilityLocation(kernel=kernel, kernel_kwargs=kw)
  js = JStore(make_mesh((1,), ("data",)), d=D, capacity=256, append_block=AB,
              kernel=kernel, kernel_kwargs=kw,
              maintainer=JO.bound_maintainer_for(obj_j), sieve_k=K,
              query_batch_tile=tile)
  ts = CorpusStore(m=1, d=D, capacity=256, append_block=AB, kernel=kernel,
                   kernel_kwargs=kw, maintainer=TO.bound_maintainer_for(obj_t),
                   sieve_k=K, query_batch_tile=tile, device="cpu")
  f = _unit(7, n)
  js.append(f)
  ts.append(f)
  ts.set_sieve_state(interop.sieve_state(js.sieve_state_host()))
  return js, ts


def _requests(g0, b):
  ks = np.array([1 + (i * 3) % K for i in range(b)])
  ex = np.full((b, MC), -1, np.int64)
  for i in range(b):
    ex[i, :i % 4] = g0[:i % 4]
  seeds = np.array([(i * 5) % 7 for i in range(b)])
  return ks, ex, seeds


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_query_sieves_matches_reference(kernel):
  """From one state: default, k < sieve_k, exclusions and seeded merges
  as the reference's; then a ragged batch (11 requests on a tile of 4:
  two full tiles and one padded) equal to the reference's batch and to
  each request's own merge."""
  js, ts = _pair(kernel, tile=4)
  n = js.sieve_thresholds * K
  g0, s0 = js.query_sieves()
  g1, s1 = ts.query_sieves()
  np.testing.assert_array_equal(g1, g0)
  np.testing.assert_allclose(s1, s0, rtol=1e-6)
  assert (g0 >= 0).sum() >= 6
  excl = np.full((MC,), -1, np.int64)
  excl[:2] = g0[:2]
  for k, seed in ((3, 0), (K, 5), (5, 9)):
    a = js.query_sieves(k=k, exclude_gids=excl.astype(np.int32), seed=seed)
    b = ts.query_sieves(k=k, exclude_gids=excl, seed=seed, jitter=_u(seed, n))
    np.testing.assert_array_equal(b[0], a[0])
    np.testing.assert_allclose(b[1], a[1], rtol=1e-6)
    assert not set(g0[:2]) & set(b[0].tolist())
  ks, ex, seeds = _requests(g0, 11)
  jit = np.stack([_u(s, n) for s in seeds])
  ga, sa = js.query_sieves_batch(ks, ex.astype(np.int32),
                                 seeds.astype(np.int32))
  gb, sb = ts.query_sieves_batch(ks, ex, seeds, jitter=jit)
  np.testing.assert_array_equal(gb, ga)
  np.testing.assert_allclose(sb, sa, rtol=1e-6, atol=1e-7)
  assert ts.query_batch_calls == 3 and ts.query_batch_queries == 11
  for i in range(11):
    g, s = ts.query_sieves(k=ks[i], exclude_gids=ex[i], seed=seeds[i],
                           jitter=jit[i])
    np.testing.assert_array_equal(gb[i], g)
    np.testing.assert_allclose(sb[i], s, rtol=1e-6, atol=1e-7)


def test_query_exact_batch_matches_reference():
  """The exact tier (batched greedy facility location over the block)
  with per-tenant exclusions: ids, gains and visible counts as the
  reference's."""
  js, ts = _pair("linear", n=200)
  g0 = js.query_sieves()[0]
  ks, ex, _ = _requests(g0, 5)
  ga, sa, na = js.query_exact_batch(ks, ex.astype(np.int32), k_cap=K)
  gb, sb, nb = ts.query_exact_batch(ks, ex, k_cap=K)
  np.testing.assert_array_equal(gb, ga)
  np.testing.assert_allclose(sb, sa, rtol=1e-5, atol=1e-6)
  np.testing.assert_array_equal(nb, na)
  assert nb.tolist() == [200 - (i % 4) for i in range(5)]
  assert ((gb >= 0).sum(1) == ks).all()


@pytest.mark.parametrize("name", ["facility_gain", "coverage_gain",
                                  "info_gain_cond"])
def test_batched_selects_match_reference(name):
  """The three registered query-batched selects (B per-query states over
  one shared block) against the reference's ``*_select_batched``."""
  r = np.random.default_rng(8)
  b, ne, nc, k = 3, 40, 30, 4
  ev = np.abs(_unit(9, ne))
  cd = np.abs(_unit(10, nc))
  ok = r.uniform(size=(b, nc)) > 0.3
  t = torch.as_tensor
  if name == "facility_gain":
    cov = r.uniform(0, 0.5, size=(b, ne)).astype(np.float32)
    mask = (r.uniform(size=(b, ne)) > 0.2).astype(np.float32)
    want = jops.facility_select_batched(ev, cd, cov, mask, ok, force_xla=True)
    args = (t(ev), t(cd), t(cov), t(mask), t(ok))
  elif name == "coverage_gain":
    cover = r.uniform(0, 0.5, size=(b, ne)).astype(np.float32)
    cap = np.full((ne,), 0.8, np.float32)
    mask = (r.uniform(size=(b, ne)) > 0.2).astype(np.float32)
    want = jops.coverage_select_batched(ev, cd, cover, cap, mask, ok,
                                        force_xla=True)
    args = (t(ev), t(cd), t(cover), t(cap), t(mask), t(ok))
  else:
    sel = np.stack([_unit(11 + i, k) for i in range(b)])
    kss = np.exp(-np.maximum((sel ** 2).sum(-1)[:, :, None] - 2 * sel @ sel.
                             transpose(0, 2, 1) + (sel ** 2).sum(-1)[:, None],
                             0) / 0.75 ** 2) + np.eye(k)
    linv = np.linalg.inv(np.linalg.cholesky(kss)).astype(np.float32)
    want = jops.info_select_batched(sel, linv, cd, ok, kernel="rbf",
                                    force_xla=True)
    args = (t(sel), t(linv), t(cd), t(ok))
  kw = dict(kernel="rbf") if name == "info_gain_cond" else {}
  for backend in ("auto", "ref"):
    best, idx = dispatch.resolve_select_batched(name, backend)(*args, **kw)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(best.numpy(), np.asarray(want[0]), rtol=1e-5)
  assert set(dispatch.select_batched_names()) >= {
      "facility_gain", "coverage_gain", "info_gain_cond", "graph_cut_gain"}
  with pytest.raises(ValueError):
    dispatch.resolve_select_batched(name, "auto")(*args[:-1], args[-1][0],
                                                  **kw)


def _service(**kw):
  base = dict(m=1, d=D, kappa=K, k_final=K, capacity=512, seed=0,
              append_block=AB, device="cpu")
  base.update(kw)
  return SelectionService(**base)


def _svc_with_docs(n=256, seed=0, **kw):
  svc = _service(**kw)
  svc.append(_unit(seed, n))
  return svc


def _assert_parity(svc, reqs):
  batched = svc.query_batch(reqs)
  seq = [svc.query(r.k, seed=r.seed, exclude_gids=r.exclude_gids or None)
         for r in reqs]
  for i, (rb, rs) in enumerate(zip(batched, seq)):
    assert rb.source == rs.source, (i, rb.source, rs.source)
    np.testing.assert_array_equal(rb.sel_gids, rs.sel_gids, err_msg=str(i))
    assert np.isclose(rb.value_estimate, rs.value_estimate, rtol=1e-5,
                      atol=1e-7), (i, rb, rs)
  return batched


def _heterogeneous(svc, b):
  base = svc.query()
  return [QueryRequest(k=1 + (i % K), seed=i % 3, exclude_gids=tuple(
      int(g) for g in base.sel_gids[:i % 4])) for i in range(b)]


def test_service_query_matches_reference_service():
  """The facility service (one shard, its default sieve) beside the
  reference's on the same appends and epoch partition: the sieve answer
  after an append, the epoch's answer right after the epoch, and the
  seeded sieve answer (the reference's jitter) after the next append
  from the reset grid."""
  f = _unit(12, 300)
  kw = dict(d=D, kappa=K, k_final=K, capacity=256, append_block=AB, seed=3)
  js = JService(make_mesh((1,), ("data",)), **kw)
  ts = SelectionService(m=1, device="cpu", **kw)
  n = ts.store.sieve_thresholds * K
  js.append(f[:200])
  ts.append(f[:200])
  a, b = js.query(), ts.query()
  assert a.source == b.source == "sieve"
  np.testing.assert_array_equal(b.sel_gids, a.sel_gids)
  np.testing.assert_allclose(b.value_estimate, a.value_estimate, rtol=1e-6)
  r_part, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(3), 0))
  from repro.core.partition import random_partition
  perm = np.asarray(random_partition(r_part, jnp.zeros((256, 1)), 1)[2])
  je, te = js.epoch(), ts.epoch(perm=interop.perm(perm))
  np.testing.assert_array_equal(te.sel_gids, je.sel_gids)
  for s_j, s_t in zip(js.store.sieve_state_host(),
                      ts.store.sieve_state_host()):
    np.testing.assert_allclose(s_t, s_j, rtol=1e-6)
  a, b = js.query(5), ts.query(5)
  assert a.source == b.source == "epoch"
  np.testing.assert_array_equal(b.sel_gids, a.sel_gids)
  js.append(f[200:])
  ts.append(f[200:])
  a = js.query(seed=4, exclude_gids=[int(te.sel_gids[0])])
  b = ts.query(seed=4, exclude_gids=[int(te.sel_gids[0])], jitter=_u(4, n))
  assert a.source == b.source == "sieve"
  assert b.appends_since_epoch == a.appends_since_epoch == 1
  np.testing.assert_array_equal(b.sel_gids, a.sel_gids)
  np.testing.assert_allclose(b.value_estimate, a.value_estimate, rtol=1e-6)


def test_service_query_routing_and_staleness():
  """A sieve answer after every append, the epoch's answer while nothing
  is stale, nested k prefixes, a fresh grid seeded with the epoch's
  picks; an empty append is not staleness."""
  svc = _svc_with_docs(100)
  q = svc.query()
  assert q.source == "sieve" and q.appends_since_epoch == 1
  assert 0 < len(q.sel_gids) <= K and (q.sel_gids < 100).all()
  r = svc.epoch()
  assert svc.appends_since_epoch == 0
  q2 = svc.query()
  assert q2.source == "epoch"
  assert set(q2.sel_gids.tolist()) == set(r.sel_gids.tolist())
  assert q2.value_estimate == pytest.approx(r.stats.value)
  q2s = svc.query(seed=1)  # a seed forces the merge over the reset grid
  assert q2s.source == "sieve" and set(q2s.sel_gids.tolist()) <= set(
      r.sel_gids.tolist())
  svc.append(np.zeros((0, D), np.float32))
  assert svc.appends_since_epoch == 0
  svc.append(_unit(1, 40))
  q3 = svc.query()
  assert q3.source == "sieve" and q3.appends_since_epoch == 1
  np.testing.assert_array_equal(svc.query(3).sel_gids, q3.sel_gids[:3])
  assert svc.store.query_count == 4


def test_service_query_errors_and_fallback():
  """Errors the reference raises, and the service without a sieve: no
  answer before an epoch, the (stale) epoch answer after it."""
  svc = _svc_with_docs()
  for bad in ([QueryRequest(k=K + 1)], [QueryRequest(k=0)],
              [QueryRequest(exclude_gids=(-3,))],
              [QueryRequest(exclude_gids=tuple(range(MC + 1)))]):
    with pytest.raises(ValueError):
      svc.query_batch(bad)
  with pytest.raises(ValueError):
    svc.query_batch([QueryRequest()], tier="fast")
  with pytest.raises(ValueError):
    svc.query(K + 1)
  cold = _svc_with_docs(warm_start=False)
  assert not cold.sieve_enabled
  with pytest.raises(RuntimeError):
    cold.query()
  r = cold.epoch()
  cold.append(_unit(1, 40))
  q = cold.query()
  assert q.source == "epoch" and q.appends_since_epoch == 1
  assert set(q.sel_gids.tolist()) == set(r.sel_gids.tolist())
  with pytest.raises(RuntimeError):
    cold.query(seed=2)
  with pytest.raises(ValueError):
    _svc_with_docs(objective="info_gain").query_batch([QueryRequest()],
                                                      tier="exact")


@pytest.mark.parametrize("stage", ["pre_epoch", "post_append"])
def test_query_batch_matches_sequential(stage):
  """A heterogeneous batch (k, seeds, exclusions) selects what the same
  requests select one by one: before any epoch, and after an epoch and an
  append; ints and None are k-only / default shorthands; the batch runs
  tile by tile past the tile and reads back once a tile."""
  svc = _svc_with_docs(query_batch_tile=4)
  if stage == "post_append":
    svc.epoch()
    svc.append(_unit(5, 64))
  calls = svc.store.query_batch_calls
  _assert_parity(svc, _heterogeneous(svc, 11))
  assert svc.store.query_batch_calls - calls == 3
  res = svc.query_batch([None, 3])
  np.testing.assert_array_equal(res[1].sel_gids, res[0].sel_gids[:3])
  hide = tuple(int(g) for g in res[0].sel_gids[:3])
  for r in svc.query_batch([QueryRequest(exclude_gids=hide),
                            QueryRequest(seed=2, exclude_gids=hide)]):
    assert not set(hide) & set(r.sel_gids.tolist())


def test_seeded_queries_never_repeat_a_gid():
  """A document admitted into several buckets comes back once, whatever
  the seed jitter."""
  svc = _svc_with_docs()
  dup = np.random.default_rng(3).standard_normal((4, D)).astype(np.float32)
  svc.append(np.repeat(dup, 8, axis=0))
  for seed in range(4):
    q = svc.query(seed=seed)
    assert len(set(q.sel_gids.tolist())) == len(q.sel_gids), (seed, q)


def test_exact_tier_through_the_service():
  """``tier="exact"``: the host greedy over each tenant's visible rows,
  values over the visible count."""
  svc = _svc_with_docs(48)
  reqs = [QueryRequest(k=4), QueryRequest(k=6, exclude_gids=(0, 5, 7))]
  res = svc.query_batch(reqs, tier="exact")
  feats = svc.store.feats[:48].numpy()
  for r, req in zip(res, reqs):
    vis = np.array([i not in req.exclude_gids for i in range(48)])
    sims = np.maximum(feats @ feats.T, 0.0)
    cov, ok, sel = np.zeros(48, np.float32), vis.copy(), []
    for _ in range(req.k):
      tot = ((np.maximum(sims, cov[None]) - cov[None]) * vis[None]).sum(1)
      j = int(np.argmax(np.where(ok, tot, -1.0)))
      sel.append(j)
      ok[j] = False
      cov = np.maximum(cov, sims[j])
    assert r.source == "exact"
    np.testing.assert_array_equal(r.sel_gids, sel)
    want = float((cov * vis).sum() / vis.sum())
    assert r.value_estimate == pytest.approx(want, rel=1e-5)


def test_query_batcher():
  """The micro-batcher drains in batches of at most ``max_batch``, every
  answer the sequential one; a bad request fails its own future; a closed
  batcher refuses requests."""
  svc = _svc_with_docs()
  reqs = _heterogeneous(svc, 10)
  seq = [svc.query(r.k, seed=r.seed, exclude_gids=r.exclude_gids or None)
         for r in reqs]
  with QueryBatcher(svc, max_batch=4, max_delay_s=0.05) as qb:
    got = [f.result(timeout=60) for f in [qb.submit(r) for r in reqs]]
  for rs, rb in zip(seq, got):
    np.testing.assert_array_equal(rs.sel_gids, rb.sel_gids)
  assert qb.stats.submitted == qb.stats.served == 10
  assert qb.stats.batches >= 3 and 0 < qb.stats.max_occupancy <= 4
  assert qb.stats.mean_occupancy == pytest.approx(10 / qb.stats.batches)
  with pytest.raises(RuntimeError):
    qb.submit()
  with QueryBatcher(svc, max_batch=2, max_delay_s=0.01) as qb:
    bad = qb.submit(QueryRequest(k=K + 5))
    with pytest.raises(ValueError):
      bad.result(timeout=60)


def test_pipeline_tokens_and_heartbeat_acks():
  """Tokens from each document's cluster band, the same whichever batch
  asks; cluster ids are the features' mixture components; every batch
  fetch beats the board (one shard, or all)."""
  c = EmbeddedCorpus(n_docs=64, feat_dim=D, vocab=256, seq_len=6, seed=2,
                     device="cpu")
  assign = c.cluster_assignments()
  f = c.features()
  assert assign.shape == (64,) and int(assign.max()) < c.n_clusters
  # each row is nearest its own center among the drawn ones
  centers = torch.stack([f[assign == a].mean(0) for a in assign.unique()])
  near = (f @ centers.T).argmax(1)
  assert (assign.unique()[near] == assign).float().mean() > 0.9
  t1 = c.tokens_for(np.array([3, 9, 3]))
  t2 = c.tokens_for([9])
  assert t1["tokens"].shape == (3, 6) and t1["mask"].shape == (3, 6)
  torch.testing.assert_close(t1["tokens"][0], t1["tokens"][2])
  torch.testing.assert_close(t1["tokens"][1], t2["tokens"][0])
  torch.testing.assert_close(t1["labels"][:, :-1], t1["tokens"][:, 1:])
  band = 256 // c.n_clusters
  lo = assign[[3, 9, 3]][:, None] * band
  assert ((t1["tokens"] >= lo) & (t1["tokens"] < lo + band)).all()
  clock = [0.0]
  board = HeartbeatBoard(2, clock=lambda: clock[0])
  clock[0] = 5.0
  list(batches_from_indices(c, np.arange(10), 4, 3, board=board, shard=1))
  np.testing.assert_array_equal(board.ages(), [5.0, 0.0])
  clock[0] = 7.0
  out = list(batches_from_epochs(c, [np.arange(4), np.arange(4, 12)], 5, 2,
                                 board=board))
  assert len(out) == 4 and all(b["tokens"].shape == (5, 6) for b in out)
  np.testing.assert_array_equal(board.ages(), [0.0, 0.0])
  assert set(out[2]["tokens"].flatten().tolist()) <= set(
      c.tokens_for(np.arange(4, 12))["tokens"].flatten().tolist())


def test_cli_query_flags_on_the_cpu():
  """``--query-every`` and ``--query-batch`` in service mode on the CPU:
  a sieve answer after each appended block, and the batched-vs-sequential
  check before and after the epochs."""
  env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
  run = subprocess.run(
      [sys.executable, "-m", "repro_torch.launch.select", "--device", "cpu",
       "--n", "800", "--d", "16", "--k", "8", "--mesh", "4", "--epochs",
       "2", "--append-frac", "0.25", "--query-every", "100",
       "--query-batch", "9", "--no-coverage"], env=env, capture_output=True,
      text=True, timeout=300)
  assert run.returncode == 0, run.stderr
  lines = run.stdout.splitlines()
  queries = [ln for ln in lines if ln.startswith("[select] query ")]
  assert len(queries) == 2 and all("source=sieve" in q for q in queries)
  batches = [ln for ln in lines if ln.startswith("[select] query_batch ")]
  assert len(batches) == 2 and all("parity=ok" in b for b in batches)
  assert "stage=pre-epoch" in batches[0] and "stage=post-epoch" in batches[1]
  assert "mode=service" in lines[-1]
