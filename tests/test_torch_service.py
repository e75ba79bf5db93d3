"""The port's selection-service epoch path (``repro_torch.service``) against
the reference's ``repro.service`` on the same appends and partitions.

The reference draws epoch t's partition inside its compiled epoch from
``split(fold_in(PRNGKey(seed), t))[0]``; the tests draw that permutation
with JAX and hand it to the port's ``epoch(perm=...)``.  Selected ids must
be equal on these corpora (nonnegative rows of varied norms, a few
documents per shard), values within 1e-5 relative, the bound table within
the reference store's own tolerance (rtol 2e-6 against float64), and a
warm-started service selects what a cold one selects.  The reference's
``test_service_four_shard_acceptance`` fails on this tree and is not used
as an oracle.
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
from repro.core.partition import random_partition  # noqa: E402
from repro.service import CorpusStore as JStore  # noqa: E402
from repro.service import SelectionService as JService  # noqa: E402
from repro.service.heartbeat import HeartbeatBoard as JBoard  # noqa: E402
from repro.util import make_mesh  # noqa: E402
from repro_torch import interop, no_tf32  # noqa: E402
from repro_torch.core import objectives as TO  # noqa: E402
from repro_torch.service import CorpusStore as TStore  # noqa: E402
from repro_torch.service import SelectionService as TService  # noqa: E402
from repro_torch.service.heartbeat import HeartbeatBoard as TBoard  # noqa: E402,E501

jax.config.update("jax_platform_name", "cpu")
no_tf32()  # full-FP32 products in the plain versions, as on the card

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 16


def _feats(seed, n, d=D):
  """Nonnegative rows of varied norms: coverage mass for saturated
  coverage, and distinct prior gains for information gain (unit rows would
  tie every empty-set gain to an ulp)."""
  r = np.random.default_rng(seed)
  x = np.abs(r.normal(size=(n, d))) * r.uniform(0.5, 1.5, size=(n, 1))
  return (x / np.sqrt(d)).astype(np.float32)


def _unit(seed, n, d=D):
  r = np.random.default_rng(seed)
  x = r.normal(size=(n, d))
  return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _ref_perm(seed, t, cap, m):
  """The reference service's epoch-t partition permutation, (m, cap/m)."""
  r_part, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                  t))
  _, _, perm = random_partition(r_part, jnp.zeros((cap, 1)), m)
  return torch.as_tensor(np.asarray(perm).astype(np.int64))


def _maint():
  return (JO.bound_maintainer_for(JO.FacilityLocation()),
          TO.bound_maintainer_for(TO.FacilityLocation()))


def test_heartbeat_board_matches_reference():
  t = [100.0]
  clock = lambda: t[0]  # noqa: E731
  jb, tb = JBoard(4, clock=clock), TBoard(4, clock=clock)
  steps = [("age", None), ("beat", 2), ("tick", 3.0), ("fail", 1),
           ("age", None), ("beat", None), ("tick", 1.5), ("fail", 3),
           ("beat", 1)]
  for op, arg in steps:
    if op == "tick":
      t[0] += arg
    elif op != "age":
      getattr(jb, op)(arg)
      getattr(tb, op)(arg)
    np.testing.assert_array_equal(tb.ages(), jb.ages())
  assert tb.m == jb.m == 4
  assert np.isinf(tb.ages()[3]) and tb.ages()[1] == 0.0


def test_store_table_matches_reference_and_float64():
  """Chunked appends (a ragged last chunk, growth in between): the port's
  float64 table equals the reference's double-float ``ubound`` within its
  tolerance and the host float64 sum; holes carry nothing."""
  f = _unit(1, 300)
  jm, tm = _maint()
  js = JStore(make_mesh((1,), ("data",)), d=D, capacity=128, append_block=64,
              maintainer=jm)
  ts = TStore(m=1, d=D, capacity=128, append_block=64, maintainer=tm,
              device="cpu")
  for part in (f[:100], f[100:]):
    js.append(part)
    ts.append(part)
  assert (ts.capacity, ts.growths, ts.n_docs) == (js.capacity, js.growths,
                                                  js.n_docs)
  live = ts.gids.numpy() >= 0
  np.testing.assert_array_equal(live, np.asarray(js.gids) >= 0)
  np.testing.assert_allclose(ts.ubound, js.ubound, rtol=2e-6, atol=1e-5)
  want = np.maximum(f.astype(np.float64) @ f.astype(np.float64).T, 0.0).sum(0)
  np.testing.assert_allclose(ts.ubound[live], want, rtol=2e-6, atol=1e-5)
  assert (ts.ubound[~live] == 0.0).all()
  torch.testing.assert_close(interop.bound_table(js.ubound)[live],
                             ts.table[live], rtol=2e-6, atol=1e-5)


def test_store_shards_reduce_like_the_reference():
  """m = 4 stacked shards: the per-shard sums and their total reproduce the
  single-shard table (f32 summation order) and the float64 reference."""
  f = _unit(2, 300)
  _, tm = _maint()
  tables = {}
  for m in (1, 4):
    st = TStore(m=m, d=D, capacity=256, append_block=64, maintainer=tm,
                device="cpu")
    st.append(f[:120])
    st.append(f[120:])
    tables[m] = st.ubound[st.gids.numpy() >= 0]
  np.testing.assert_allclose(tables[4], tables[1], rtol=1e-5, atol=1e-5)
  want = np.maximum(f.astype(np.float64) @ f.astype(np.float64).T, 0.0).sum(0)
  np.testing.assert_allclose(tables[4], want, rtol=2e-6, atol=1e-5)


def test_store_growth_carries_the_table_bit_for_bit():
  f = _unit(5, 200)
  _, tm = _maint()
  st = TStore(m=4, d=D, capacity=256, append_block=64, maintainer=tm,
              device="cpu")
  st.append(f)
  cap0 = st.capacity
  snap = (st.feats.clone(), st.gids.clone(), st.ubound.copy())
  st.reserve(1000)                       # 256 -> 512 -> 1024
  assert st.growths == 2 and st.capacity == 1024
  assert torch.equal(st.feats[:cap0], snap[0])
  assert torch.equal(st.gids[:cap0], snap[1])
  np.testing.assert_array_equal(st.ubound[:cap0], snap[2])
  assert (st.gids[cap0:] == -1).all() and (st.ubound[cap0:] == 0.0).all()
  st.append(f[:50] * 0.5)
  assert int((st.gids >= 0).sum()) == 250


def test_store_duplicate_gids_raise_before_any_write():
  """The reference store's contract (tests/test_store.py): duplicates
  within an append, against explicit and auto ids, and split across
  chunks of one append, all raise before any row lands."""
  _, tm = _maint()
  st = TStore(m=2, d=D, capacity=256, append_block=64, maintainer=tm,
              device="cpu")
  f = _unit(3, 200)
  st.append(f[:40])                                   # auto gids 0..39
  st.append(f[40:60], gids=np.arange(1000, 1020))
  snap_n, snap_ub = st.n_docs, st.ubound.copy()
  snap_g = st.gids.clone()
  with pytest.raises(ValueError, match="within append"):
    st.append(f[60:63], gids=np.array([7000, 7000, 7001]))
  with pytest.raises(ValueError, match="already in the corpus"):
    st.append(f[60:62], gids=np.array([1005, 7000]))
  with pytest.raises(ValueError, match="already in the corpus"):
    st.append(f[60:62], gids=np.array([3, 7000]))
  gids = np.arange(5000, 5130)
  gids[100] = gids[0]                    # chunk 1 repeats chunk 0
  with pytest.raises(ValueError, match="within append"):
    st.append(f[60:190], gids=gids)
  gids = np.arange(5000, 5130)
  gids[100] = 3                          # chunk 1 clashes with an auto id
  with pytest.raises(ValueError, match="already in the corpus"):
    st.append(f[60:190], gids=gids)
  assert st.n_docs == snap_n
  np.testing.assert_array_equal(st.ubound, snap_ub)
  assert torch.equal(st.gids, snap_g)
  st.append(f[60:80], gids=np.arange(7000, 7020))
  st.append(np.zeros((0, D), np.float32))
  st.append(f[80:85])                    # auto ids continue past 7019
  assert st.n_docs == 85 and int(st.gids[84]) == 7024


def test_maintainer_gates_run_cold():
  """The sum-form maintainer refuses a similarity its bound pass does not
  implement and a negative facility baseline; information gain gets the
  prior maintainer bound to its sigma; a service whose objective has no
  maintainer reports cold epochs, keeps no table, and selects what an
  explicitly cold service selects."""
  import types
  sumform = TO.SumFormBoundMaintainer()
  assert not sumform.supports(types.SimpleNamespace(kernel="neg_sq_dist"))
  assert sumform.supports(TO.SaturatedCoverage())
  assert TO.bound_maintainer_for(TO.FacilityLocation(baseline=-0.5)) is None
  assert TO.bound_maintainer_for(TO.FacilityLocation(baseline=0.2))
  ig = TO.bound_maintainer_for(TO.InformationGain(k_max=4, sigma=0.5))
  assert ig is not None and ig.sigma == 0.5
  assert TO.bound_maintainer_for(TO.LogDetDPP(k_max=4)) is None
  f = _unit(6, 150)
  sels = []
  for warm in (True, False):
    svc = TService(m=2, d=D, kappa=4, k_final=4, capacity=256,
                   append_block=64, warm_start=warm, device="cpu",
                   objective=TO.FacilityLocation(baseline=-0.5))
    assert not svc.warm
    svc.append(f)
    r = svc.epoch(perm=_ref_perm(0, 0, 256, 2))
    assert not r.stats.warm and (svc.store.ubound == 0.0).all()
    sels.append(r.sel_gids.tolist())
  assert sels[0] == sels[1]


def _run(svc, t_svc, appends, seed, m, kill=None):
  """Append, run an epoch on both services per append, a second epoch
  after the last; returns the port's results and the reference's."""
  out = []
  for i, part in enumerate(appends):
    svc.append(part)
    t_svc.append(part)
    n_ep = 2 if i == len(appends) - 1 else 1
    for _ in range(n_ep):
      if kill is not None and i == len(appends) - 1:
        svc.board.fail(kill)
        t_svc.board.fail(kill)
      perm = _ref_perm(seed, t_svc._epoch_idx, t_svc.capacity, m)
      out.append((t_svc.epoch(perm=perm), svc.epoch()))
  return out


def _assert_epochs_match(out):
  for tr, jr in out:
    assert tr.sel_gids.tolist() == jr.sel_gids.tolist()
    np.testing.assert_allclose(tr.stats.value, jr.stats.value, rtol=1e-5)
    np.testing.assert_array_equal(tr.stats.alive, np.asarray(jr.stats.alive))
    assert tr.stats.warm == jr.stats.warm
    assert tr.stats.capacity == jr.stats.capacity
    assert tr.stats.n_live == jr.stats.n_live


@pytest.mark.parametrize("objective", ["facility", "saturated_coverage",
                                       "info_gain"])
def test_service_epochs_match_reference(objective):
  """One shard (the reference's 1-device mesh): two appends with a growth
  between, three epochs; ids, value, alive and warm as the reference's,
  the bound tables alike, and a cold port service selects the same.  The
  facility run keeps the reference's default standing sieve, which only
  reads the epochs' results."""
  f = _feats(11, 420)
  kw = dict(d=D, kappa=6, k_final=6, capacity=256, append_block=64, seed=3,
            objective=objective)
  appends = (f[:200], f[200:])
  jsvc = JService(make_mesh((1,), ("data",)),
                  sieve=objective == "facility", **kw)
  tsvc = TService(m=1, device="cpu", **kw)
  out = _run(jsvc, tsvc, appends, 3, 1)
  _assert_epochs_match(out)
  assert tsvc.growths == jsvc.growths == 1
  assert all(tr.stats.warm for tr, _ in out)
  np.testing.assert_allclose(tsvc.store.ubound, jsvc.store.ubound,
                             rtol=2e-6, atol=1e-5)
  cold = TService(m=1, device="cpu", warm_start=False, **kw)
  cold_out = []
  for part in appends:
    cold.append(part)
    cold_out.append(cold.epoch(perm=_ref_perm(3, cold._epoch_idx,
                                              cold.capacity, 1)))
  cold_out.append(cold.epoch(perm=_ref_perm(3, 2, cold.capacity, 1)))
  assert [r.sel_gids.tolist() for r in cold_out] == [
      tr.sel_gids.tolist() for tr, _ in out]
  assert not any(r.stats.warm for r in cold_out)


def test_service_own_partitions_and_restart():
  """Without an injected perm the service draws its own partition per
  epoch: a permutation of the block rows, new every epoch, the same for a
  restarted service that replays the same appends."""
  f = _feats(12, 300)
  runs = []
  for _ in range(2):
    svc = TService(m=4, d=D, kappa=4, k_final=6, capacity=256,
                   append_block=64, seed=7, device="cpu",
                   objective="saturated_coverage")
    svc.append(f)
    p0, p1 = svc.epoch_perm(0), svc.epoch_perm(1)
    assert sorted(p0.tolist()) == list(range(svc.capacity))
    assert not torch.equal(p0, p1)
    runs.append([svc.epoch().sel_gids.tolist() for _ in range(2)])
  assert runs[0] == runs[1] and len(runs[0][0]) == 6


def test_service_matches_reference_on_four_shards(subrun):
  """On a 4-device mesh against the reference's shard_map service, for the
  three objectives: an append, a growth, three epochs, shard 2 killed
  before the last two, so liveness comes from the heartbeat ages."""
  out = subrun(r"""
import numpy as np, jax, jax.numpy as jnp, torch
from repro.core.partition import random_partition
from repro.service import SelectionService as JService
from repro.util import make_mesh
from repro_torch import no_tf32
from repro_torch.service import SelectionService as TService
no_tf32()
mesh = make_mesh((4,), ("data",))
r = np.random.default_rng(21)
x = np.abs(r.normal(size=(330, 16))) * r.uniform(0.5, 1.5, size=(330, 1))
f = (x / 4.0).astype(np.float32)

def ref_perm(t, cap):
  rp, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(5), t))
  _, _, p = random_partition(rp, jnp.zeros((cap, 1)), 4)
  return torch.as_tensor(np.asarray(p).astype(np.int64))

for obj in ("facility", "saturated_coverage", "info_gain"):
  kw = dict(d=16, kappa=4, k_final=6, capacity=128, append_block=64,
            seed=5, objective=obj, deadline=1e6)
  js = JService(mesh, sieve=False, **kw)
  ts = TService(m=4, device="cpu", **kw)
  res = []
  for i, part in enumerate((f[:150], f[150:])):
    js.append(part)
    ts.append(part)
    for _ in range(1 if i == 0 else 2):
      if i == 1:
        js.board.fail(2)
        ts.board.fail(2)
      a = ts.epoch(perm=ref_perm(ts._epoch_idx, ts.capacity))
      b = js.epoch()
      assert a.sel_gids.tolist() == b.sel_gids.tolist(), (obj, a.sel_gids,
                                                          b.sel_gids)
      np.testing.assert_allclose(a.stats.value, b.stats.value, rtol=1e-5)
      assert a.stats.alive.tolist() == np.asarray(b.stats.alive).tolist()
      assert a.stats.warm == b.stats.warm
      res.append(a.stats.alive.tolist())
  assert res[-1] == [True, True, False, True], res
  assert ts.growths == js.growths == 2
  np.testing.assert_allclose(ts.store.ubound, js.store.ubound, rtol=2e-6,
                             atol=1e-5)
  print("SERVICE4", obj)
""", 4)
  for obj in ("facility", "saturated_coverage", "info_gain"):
    assert f"SERVICE4 {obj}" in out


def test_cli_service_mode_on_the_cpu(tmp_path):
  """``python -m repro_torch.launch.select --device cpu --mesh 4 --epochs 3``
  with a held-back append: one epoch line per epoch (warm, rescans), one
  append line, and k unique in-range ids written."""
  out_path = tmp_path / "sel.npy"
  env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
  run = subprocess.run(
      [sys.executable, "-m", "repro_torch.launch.select", "--device", "cpu",
       "--n", "1000", "--d", "16", "--k", "8", "--mesh", "4", "--epochs",
       "3", "--append-frac", "0.25", "--objective", "saturated_coverage",
       "--out", str(out_path)], env=env, capture_output=True, text=True,
      timeout=300)
  assert run.returncode == 0, run.stderr
  lines = run.stdout.splitlines()
  epochs = [ln for ln in lines if ln.startswith("[select] epoch ")]
  assert len(epochs) == 3 and all("warm=true" in ln for ln in epochs)
  assert all(int(ln.split("rescans=")[1].split()[0]) > 0 for ln in epochs)
  assert sum(ln.startswith("[select] append ") for ln in lines) == 1
  assert "mode=service" in lines[-1] and "objective=saturated_coverage" in (
      lines[-1])
  sel = np.load(out_path)
  assert len(sel) == 8 and len(set(sel.tolist())) == 8
  assert sel.min() >= 0 and sel.max() < 1000
