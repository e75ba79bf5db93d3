"""The port's selection service over processes (``SelectionService`` /
``CorpusStore`` with ``mesh=``) against the stacked service, and against
the JAX reference's service, on the CPU (gloo).

Ranks are started with ``python -m torch.distributed.run --standalone``
(its own free port, so files run side by side under xdist) on a script in
``tmp_path``: one launch at world 2 and one at world 4, m = 8 shards (4 and
2 a rank), each rank writing an ``.npz`` of every check and rank 0 also
running every call stacked.  The ranks must hold the stacked service's
bits: the block, gids and float64 table across three growths (each rank
only its shards' rows), the standing sieves after every append and after
each epoch's reset, ``query`` / ``query_batch`` answers with seeds and
exclusions, warm and cold epochs of facility location, saturated coverage
and information gain (flat and ``merge="tree"``), liveness with rank 1's
shards failed, the exact tier, the epoch perm (the same on every rank), a
``QueryBatcher`` on one rank (no collective in its drains).  One launch at
world 4 runs the reference's four-shard inputs against the JAX service on
4 forced host devices (ids equal, values within 1e-5; the sieve answer's
f(S) where the reference's sieve holds a near-tie).
"""
import json
import os
import subprocess
import sys
import textwrap
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
CONFIGS = ("fl_warm", "fl_cold_tree2", "satcov_warm_tree2", "satcov_cold",
           "ig_warm", "ig_cold_tree2")
SIEVED = ("fl_warm", "satcov_warm_tree2")

# One script, every case; ``python script.py OUT [INPUTS]`` under torchrun.
# Without INPUTS it drives CONFIGS over m = 8 shards (rank 0 also stacked);
# with INPUTS (the JAX run's perms) the reference's four-shard inputs.
RANK_SCRIPT = r'''
import sys

import numpy as np
import torch

from repro_torch import interop, no_tf32
from repro_torch.core.partition import (partition_gids, repartition,
                                        shard_live_counts)
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.service import QueryBatcher, QueryRequest, SelectionService

no_tf32()
M, D = 8, 12
CUTS = (0, 90, 200, 300)   # three appends: capacity 64 -> 512, 3 growths
CONFIGS = {
    "fl_warm": ("facility", True, {}),
    "fl_cold_tree2": ("facility", False, dict(merge="tree", tree_branch=2)),
    "satcov_warm_tree2": ("saturated_coverage", True,
                          dict(merge="tree", tree_branch=2)),
    "satcov_cold": ("saturated_coverage", False, {}),
    "ig_warm": ("info_gain", True, {}),
    "ig_cold_tree2": ("info_gain", False, dict(merge="tree", tree_branch=2)),
}


def corpus(n, seed, d=D):
  """Nonnegative rows of varied norms (coverage mass; distinct prior
  gains for information gain)."""
  r = np.random.default_rng(seed)
  x = np.abs(r.normal(size=(n, d))) * r.uniform(0.5, 1.5, size=(n, 1))
  return (x / np.sqrt(d)).astype(np.float32)


def host(x):
  return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def padded(ids, k=6):
  out = np.full((k,), -1, np.int64)
  out[:len(ids)] = ids
  return out


def requests(ids):
  return [QueryRequest(k=1 + i % 6, seed=i % 3, exclude_gids=tuple(
      int(g) for g in ids[:i % 3])) for i in range(5)]


def answers(rec, key, results):
  rec[key + "/ids"] = np.stack([padded(r.sel_gids) for r in results])
  rec[key + "/val"] = np.array([r.value_estimate for r in results])
  rec[key + "/src"] = np.array([r.source for r in results])


def fail_rank1(svc, world):
  per = M // world
  for s in range(per, 2 * per):
    if s in svc.board.shards:
      svc.board.fail(s)


def drive(name, svc, rec, world, mesh):
  st = svc.store
  f = corpus(300, 11)
  t = 0
  for a, (lo, hi) in enumerate(zip(CUTS, CUTS[1:])):
    svc.append(f[lo:hi])
    p = f"{name}/a{a}"
    rec[p + "/feats"], rec[p + "/gids"], rec[p + "/table"] = (
        host(st.feats), host(st.gids), host(st.table))
    rec[p + "/cap"] = np.array(st.capacity)
    if st.sieve_enabled:
      for i, x in enumerate(st.sieve_state):
        rec[f"{p}/pool{i}"] = host(x)
      for i, x in enumerate(st._sieve):
        rec[f"{p}/local{i}"] = host(x)
      q = svc.query()
      answers(rec, p + "/q", [q, svc.query(4, seed=3,
                                           exclude_gids=q.sel_gids[:2])])
      answers(rec, p + "/qb", svc.query_batch(requests(q.sel_gids)))
      if a == 1 and name == "fl_warm":
        # a batcher on the last rank alone: the sieve tier makes no
        # collective, so the other ranks are not waited for
        rank = world - 1 if mesh is not None else None
        if mesh is None or mesh.rank == rank:
          before = (0, 0) if mesh is None else (mesh.gathers,
                                                mesh.exchanges)
          with QueryBatcher(svc, max_batch=2, max_delay_s=0.05) as qb:
            futs = [qb.submit(r) for r in requests(q.sel_gids)]
            got = [fu.result(timeout=60) for fu in futs]
          answers(rec, "batcher", got)
          if mesh is not None:
            rec["batcher/collectives"] = np.array(
                [mesh.gathers - before[0], mesh.exchanges - before[1]])
          else:
            answers(rec, "batcher_alone", [
                svc.query(r.k, seed=r.seed, exclude_gids=r.exclude_gids)
                for r in requests(q.sel_gids)])
    for e in range({0: 1, 1: 0, 2: 2}[a]):
      if a == 2 and e == 1:
        fail_rank1(svc, world)
      rec[f"{name}/perm{t}"] = host(svc.epoch_perm())
      r = svc.epoch()
      s = r.stats
      p = f"{name}/e{t}"
      rec[p + "/ids"] = r.sel_gids
      rec[p + "/value"] = np.array(s.value)
      rec[p + "/alive"] = s.alive
      rec[p + "/warm"] = np.array(s.warm)
      rec[p + "/rescans"] = s.rescans
      rec[p + "/n_live"] = np.array(s.n_live)
      if st.sieve_enabled:
        for i, x in enumerate(st.sieve_state):
          rec[f"{p}/pool{i}"] = host(x)
        answers(rec, p + "/q", [svc.query(), svc.query(seed=2)])
      t += 1
  if name == "fl_warm":
    answers(rec, f"{name}/exact", svc.query_batch(
        requests(rec[f"{name}/e2/ids"]), tier="exact"))


def kw_of(name):
  obj, warm, merge = CONFIGS[name]
  return dict(m=M, d=D, kappa=4, k_final=6, capacity=64, append_block=32,
              seed=5, deadline=1e6, objective=obj, warm_start=warm,
              device="cpu", **merge)


def slabs(rec, mesh):
  """``core/partition.py`` over a rank's rows: a padded perm (252 rows in
  8 parts of 32, 4 holes) and gids with holes of their own."""
  n = 252
  f = torch.as_tensor(corpus(n, 3))
  perm = torch.as_tensor(np.concatenate([
      np.random.default_rng(4).permutation(n), -np.ones(4, np.int64)]))
  gids = torch.where(torch.arange(n) % 7 == 0, -1, torch.arange(n) + 1000)
  if mesh is not None:
    own = slice(mesh.rank * n // mesh.world, (mesh.rank + 1) * n // mesh.world)
    f, gids = f[own], gids[own]
  parts, mask, p = repartition(None, f, M, perm=perm, mesh=mesh)
  g = partition_gids(p, gids, mesh=mesh)
  rec["slab/parts"], rec["slab/mask"], rec["slab/perm"] = (
      host(parts), host(mask), host(p))
  rec["slab/gids"] = host(g)
  rec["slab/live"] = host(shard_live_counts(g >= 0, M, mesh=mesh))


def jax_inputs(inputs, mesh, rec):
  """The reference's four-shard inputs: appends, epoch 0 under the JAX
  run's perm, an append, a sieve query, epoch 1."""
  r = np.random.default_rng(21)
  x = np.abs(r.normal(size=(330, 16))) * r.uniform(0.5, 1.5, size=(330, 1))
  f = (x / 4.0).astype(np.float32)
  svc = SelectionService(m=4, d=16, kappa=4, k_final=6, capacity=128,
                         append_block=64, seed=5, objective="facility",
                         deadline=1e6, device="cpu", mesh=mesh)
  svc.append(f[:150])
  e0 = svc.epoch(perm=torch.as_tensor(inputs["perm0"]))
  svc.append(f[150:])
  q = svc.query()
  e1 = svc.epoch(perm=torch.as_tensor(inputs["perm1"]))
  for i, e in enumerate((e0, e1)):
    rec[f"e{i}/ids"] = e.sel_gids
    rec[f"e{i}/value"] = np.array(e.stats.value)
    rec[f"e{i}/alive"] = e.stats.alive
  rec["q/ids"] = q.sel_gids
  rec["q/val"] = np.array(q.value_estimate)
  rec["q/src"] = np.array(q.source)
  rec["growths"] = np.array(svc.growths)
  # the reference store's sieves carried across, whole, into every rank
  svc.store.set_sieve_state(interop.sieve_state(
      [inputs[f"state{i}"] for i in range(6)]))
  rec["carried/ids"], rec["carried/scores"] = svc.store.query_sieves(k=6)


def main():
  out_dir = sys.argv[1]
  inputs = np.load(sys.argv[2]) if len(sys.argv) > 2 else None
  if inputs is not None:
    mesh = ProcessMesh.from_env(4, "gloo", "cpu")
    rec = {}
    jax_inputs(inputs, mesh, rec)
    np.savez(f"{out_dir}/rank{mesh.rank}.npz", **rec)
    mesh.close()
    return
  mesh = ProcessMesh.from_env(M, "gloo", "cpu")
  rec, stacked = {}, {}
  for name in CONFIGS:
    drive(name, SelectionService(mesh=mesh, **kw_of(name)), rec, mesh.world,
          mesh)
    if mesh.rank == 0:
      drive(name, SelectionService(**kw_of(name)), stacked, mesh.world, None)
  slabs(rec, mesh)
  if mesh.rank == 0:
    slabs(stacked, None)
  rec["first"] = np.array(mesh.first)
  rec["collectives"] = np.array([mesh.gathers, mesh.exchanges,
                                 mesh.exchange_bytes])
  np.savez(f"{out_dir}/rank{mesh.rank}.npz", **rec)
  if stacked:
    np.savez(f"{out_dir}/stacked.npz", **stacked)
  mesh.close()


main()
'''

# the reference's service on 4 forced host devices, the inputs of
# tests/test_torch_service.py::test_service_matches_reference_on_four_shards
JAX_SCRIPT = """
import numpy as np, jax, jax.numpy as jnp
from repro.core.partition import random_partition
from repro.service import SelectionService as JService
from repro.util import make_mesh
mesh = make_mesh((4,), ("data",))
r = np.random.default_rng(21)
x = np.abs(r.normal(size=(330, 16))) * r.uniform(0.5, 1.5, size=(330, 1))
f = (x / 4.0).astype(np.float32)

def ref_perm(t, cap):
  rp, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(5), t))
  _, _, p = random_partition(rp, jnp.zeros((cap, 1)), 4)
  return np.asarray(p).astype(np.int64)

js = JService(mesh, d=16, kappa=4, k_final=6, capacity=128, append_block=64,
              seed=5, objective="facility", deadline=1e6)
out = {{}}
js.append(f[:150])
out["perm0"] = ref_perm(0, js.capacity)
e0 = js.epoch()
js.append(f[150:])
state = js.store.sieve_state_host()
out["carried/ids"], out["carried/scores"] = (
    np.asarray(x) for x in js.store.query_sieves(k=6))
for i, x in enumerate(state):
  out[f"state{{i}}"] = np.asarray(x)
q = js.query()
out["perm1"] = ref_perm(1, js.capacity)
e1 = js.epoch()
for i, e in enumerate((e0, e1)):
  out[f"e{{i}}/ids"] = np.asarray(e.sel_gids)
  out[f"e{{i}}/value"] = np.asarray(e.stats.value)
  out[f"e{{i}}/alive"] = np.asarray(e.stats.alive)
out["q/ids"] = np.asarray(q.sel_gids)
out["q/val"] = np.asarray(q.value_estimate)
out["q/src"] = np.asarray(q.source)
out["growths"] = np.asarray(js.growths)
out["sieve_gain"], out["sieve_gid"], out["sieve_jtop"] = (
    state[1], state[0], state[5])
out["sieve_T"] = np.asarray(js.store.sieve_thresholds)
np.savez({result!r}, **out)
print("JAX_DONE")
"""


def launch(tmp_path, world: int, inputs=None):
  """Start ``world`` ranks of RANK_SCRIPT on the CPU; returns the Popen and
  the directory the ranks write to."""
  out = tmp_path / f"world{world}{'_jax' if inputs else ''}"
  out.mkdir()
  script = tmp_path / "ranks.py"
  if not script.exists():
    script.write_text(RANK_SCRIPT)
  env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
             OMP_NUM_THREADS="1")
  cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(world), str(script), str(out)]
  if inputs:
    cmd.append(str(inputs))
  return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True), out


def finish(proc, out, world):
  """Wait for a launch; raise with its output unless every rank exited 0;
  returns the ranks' results."""
  log, _ = proc.communicate(timeout=300)
  assert proc.returncode == 0, log
  return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  """Both worlds and the JAX parity launch side by side: {world: (ranks'
  results, rank 0's stacked results)} and "jax": (ranks, the JAX run's)."""
  tmp = tmp_path_factory.mktemp("service_dist")
  started = {w: launch(tmp, w) for w in WORLDS}
  result = tmp / "jax.npz"
  env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
             XLA_FLAGS="--xla_force_host_platform_device_count=4")
  jax_run = subprocess.run(
      [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT.format(
          result=str(result)))], env=env, capture_output=True, text=True,
      timeout=600)
  assert jax_run.returncode == 0, jax_run.stdout + jax_run.stderr
  want = dict(np.load(result))
  np.savez(tmp / "perms.npz", perm0=want["perm0"], perm1=want["perm1"],
           **{f"state{i}": want[f"state{i}"] for i in range(6)})
  jax_ranks = launch(tmp, 4, tmp / "perms.npz")
  done = {w: (finish(*started[w], w),
              dict(np.load(started[w][1] / "stacked.npz"))) for w in WORLDS}
  done["jax"] = (finish(*jax_ranks, 4), want)
  return done


def _same(got, want, what):
  assert got.dtype == want.dtype and got.shape == want.shape, (
      what, got.dtype, want.dtype, got.shape, want.shape)
  np.testing.assert_array_equal(got, want, err_msg=what)


def _every_rank(runs, world, prefix):
  """Every rank's entries under ``prefix`` against the stacked run's, bit
  for bit; returns how many were compared."""
  ranks, stacked = runs[world]
  keys = [k for k in stacked if k.startswith(prefix)]
  for r, got in enumerate(ranks):
    for k in keys:
      _same(got[k], stacked[k], f"world {world} rank {r} {k}")
  return len(keys)


@pytest.mark.parametrize("world", WORLDS)
def test_appends_across_growths_hold_the_stacked_block(runs, world):
  """Each rank holds only its shards' rows of the block, gids and float64
  table (m // world shards of capacity / m rows), and together they are
  the stacked store's, bit for bit, after each append (3 growths)."""
  ranks, stacked = runs[world]
  per = 8 // world
  for name in CONFIGS:
    for a in range(3):
      p = f"{name}/a{a}"
      cap = int(stacked[p + "/cap"])
      for f in ("feats", "gids", "table"):
        for r, got in enumerate(ranks):
          assert got[f"{p}/{f}"].shape[0] == cap // 8 * per, (p, f, r)
        _same(np.concatenate([got[f"{p}/{f}"] for got in ranks]),
              stacked[f"{p}/{f}"], f"world {world} {p}/{f}")
    assert int(stacked[f"{name}/a2/cap"]) == 512
  assert stacked["fl_warm/a2/table"].dtype == np.float64
  assert (stacked["fl_warm/a2/table"] > 0).sum() == 300


@pytest.mark.parametrize("world", WORLDS)
def test_sieve_state_after_every_append_and_reset(runs, world):
  """Every rank's query pool is the stacked sieve state after every append
  and after each epoch's reset, and its own part is its shards' rows."""
  ranks, stacked = runs[world]
  per = 8 // world
  for name in SIEVED:
    for a in range(3):
      for i in range(6):
        p = f"{name}/a{a}"
        want = stacked[f"{p}/pool{i}"]
        for r, got in enumerate(ranks):
          _same(got[f"{p}/pool{i}"], want, f"{p}/pool{i} rank {r}")
          rows = want.shape[0] // 8
          first = int(got["first"])
          _same(got[f"{p}/local{i}"],
                want[first * rows:(first + per) * rows],
                f"{p}/local{i} rank {r}")
    for t in range(3):
      assert _every_rank(runs, world, f"{name}/e{t}/pool") == 6
    assert (stacked[f"{name}/a2/pool3"] > 0).sum() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_queries_answer_the_stacked_bits_on_every_rank(runs, world):
  """``query`` (default and seeded with exclusions) and ``query_batch``
  of five heterogeneous requests after every append, and the queries after
  each epoch: ids, values and sources bit for bit on every rank."""
  ranks, stacked = runs[world]
  for name in SIEVED:
    n = sum(_every_rank(runs, world, f"{name}/a{a}/q") for a in range(3))
    n += sum(_every_rank(runs, world, f"{name}/e{t}/q") for t in range(3))
    assert n == 3 * 6 + 3 * 3
    assert set(stacked[f"{name}/a2/qb/src"].tolist()) == {"sieve"}
    assert stacked[f"{name}/e2/q/src"].tolist() == ["epoch", "sieve"]
    excl = stacked[f"{name}/a1/q/ids"][0][:2]
    assert not set(excl) & set(stacked[f"{name}/a1/q/ids"][1].tolist())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_epochs_match_the_stacked_service(runs, world, name):
  """Warm and cold epochs (facility location, saturated coverage,
  information gain; flat and tree b = 2): ids, f(S), alive, warm and the
  rescans bit for bit on every rank; warm reported only with bounds."""
  ranks, stacked = runs[world]
  assert _every_rank(runs, world, f"{name}/e") >= 3 * 6
  for t in range(3):
    ids = stacked[f"{name}/e{t}/ids"]
    # A_max may return a root child's block: kappa = 4 rows under the tree
    assert 4 <= len(ids) <= 6 and len(set(ids.tolist())) == len(ids)
    assert bool(stacked[f"{name}/e{t}/warm"]) == name.endswith(
        ("warm", "warm_tree2"))
  if name.endswith(("warm", "warm_tree2")):
    assert stacked[f"{name}/e1/rescans"].sum() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_liveness_with_one_ranks_shards_failed(runs, world):
  """Rank 1 fails its own shards before the last epoch: every rank's
  ``alive`` is the stacked service's, those shards dead, and no id of the
  answer lies on them."""
  ranks, stacked = runs[world]
  per = 8 // world
  want = [not per <= s < 2 * per for s in range(8)]
  for name in CONFIGS:
    assert stacked[f"{name}/e2/alive"].tolist() == want
    assert stacked[f"{name}/e1/alive"].all()
    for r, got in enumerate(ranks):
      _same(got[f"{name}/e2/alive"], stacked[f"{name}/e2/alive"],
            f"{name} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_exact_tier_answers_the_stacked_bits(runs, world):
  """``query_batch(tier="exact")`` (the block gathered once a call, the
  stacked greedy on every rank): ids and values bit for bit."""
  ranks, stacked = runs[world]
  assert _every_rank(runs, world, "fl_warm/exact") == 3
  assert set(stacked["fl_warm/exact/src"].tolist()) == {"exact"}
  assert (stacked["fl_warm/exact/ids"] >= 0).sum() == sum(
      1 + i % 6 for i in range(5))


@pytest.mark.parametrize("world", WORLDS)
def test_epoch_perm_is_the_same_on_every_rank(runs, world):
  """``epoch_perm`` draws one permutation on every rank: each rank's is
  the stacked service's, a permutation of the capacity's rows."""
  ranks, stacked = runs[world]
  assert _every_rank(runs, world, "fl_warm/perm") == 3
  for name in CONFIGS:
    for t, cap in enumerate((128, 512, 512)):
      perm = stacked[f"{name}/perm{t}"]
      assert sorted(perm.tolist()) == list(range(cap))
      for got in ranks:
        _same(got[f"{name}/perm{t}"], perm, f"{name} perm{t}")


@pytest.mark.parametrize("world", WORLDS)
def test_query_batcher_on_one_rank(runs, world):
  """A ``QueryBatcher`` on the last rank alone, while the others wait at
  their next collective: each request answers what it answers alone
  through the stacked service, and its drains made no collective."""
  ranks, stacked = runs[world]
  got = ranks[-1]
  assert got["batcher/collectives"].tolist() == [0, 0]
  assert all("batcher/ids" not in r for r in ranks[:-1])
  np.testing.assert_array_equal(got["batcher/ids"],
                                stacked["batcher_alone/ids"])
  np.testing.assert_allclose(got["batcher/val"], stacked["batcher_alone/val"],
                             rtol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_partition_slabs_of_a_global_perm(runs, world):
  """``repartition`` / ``partition_gids`` over a rank's rows give its slab
  of the stacked partition (a padded perm, gid holes composed to -1) and
  ``shard_live_counts`` gathers every shard's count."""
  ranks, stacked = runs[world]
  per = 8 // world
  for r, got in enumerate(ranks):
    first = int(got["first"])
    for f in ("parts", "mask", "perm"):
      _same(got[f"slab/{f}"], stacked[f"slab/{f}"][first:first + per],
            f"rank {r} {f}")
    _same(got["slab/gids"],
          stacked["slab/gids"].reshape(8, -1)[first:first + per].reshape(-1),
          f"rank {r} gids")
    _same(got["slab/live"], stacked["slab/live"], f"rank {r} live")
  assert (stacked["slab/perm"] < 0).sum() == 4
  assert stacked["slab/live"].sum() == 252 - 36


@pytest.mark.parametrize("world", WORLDS)
def test_rows_move_through_the_exchange(runs, world):
  """Growths and epochs moved rows with all-to-alls, and every rank made
  the same number of collectives."""
  ranks, _ = runs[world]
  counts = [got["collectives"] for got in ranks]
  assert all(c[1] > 0 and c[2] > 0 for c in counts), counts
  assert len({(int(c[0]), int(c[1])) for c in counts}) == 1, counts


def test_ranks_match_the_jax_service(runs):
  """World 4 on the reference's four-shard inputs against the JAX
  ``SelectionService`` on 4 forced host devices, under its perms: equal
  epoch ids and alive, values within 1e-5; the sieve answer's ids equal,
  or (an admission within 1e-6 of its threshold in the reference's sieve)
  its f(S) within 1e-5; the reference store's sieves carried into every
  rank (``interop.sieve_state``, ``set_sieve_state``) merge to the
  reference's answer."""
  ranks, want = runs["jax"]
  assert int(want["growths"]) == 2
  for r, got in enumerate(ranks):
    assert int(got["growths"]) == 2
    np.testing.assert_array_equal(got["carried/ids"], want["carried/ids"])
    np.testing.assert_allclose(got["carried/scores"], want["carried/scores"],
                               rtol=1e-6)
    for t in range(2):
      np.testing.assert_array_equal(got[f"e{t}/ids"], want[f"e{t}/ids"],
                                    err_msg=f"rank {r} e{t}")
      np.testing.assert_array_equal(got[f"e{t}/alive"],
                                    want[f"e{t}/alive"])
      np.testing.assert_allclose(got[f"e{t}/value"], want[f"e{t}/value"],
                                 rtol=1e-5)
    assert str(got["q/src"]) == str(want["q/src"]) == "sieve"
    for other in ranks:
      _same(other["q/ids"], got["q/ids"], "sieve ids across ranks")
  t = int(want["sieve_T"])
  tau = np.exp((want["sieve_jtop"][0] - (t - 1) + np.arange(t)) *
               np.log1p(0.5))
  rel = np.abs(want["sieve_gain"] / np.tile(tau, 4)[:, None] - 1.0)[
      want["sieve_gid"] >= 0]
  got_ids = ranks[0]["q/ids"]
  want_ids = np.asarray(want["q/ids"])
  want_ids = want_ids[want_ids >= 0]
  if (rel < 1e-6).any() and not np.array_equal(got_ids, want_ids):
    r = np.random.default_rng(21)
    x = np.abs(r.normal(size=(330, 16))) * r.uniform(0.5, 1.5, size=(330, 1))
    f = (x / 4.0).astype(np.float32)

    def f_of(ids):
      return float(np.maximum(f @ f[ids].T, 0.0).max(axis=1).mean())
    assert abs(f_of(got_ids) - f_of(want_ids)) <= 1e-5 * f_of(want_ids)
  else:
    np.testing.assert_array_equal(got_ids, want_ids)
    np.testing.assert_allclose(ranks[0]["q/val"], want["q/val"], rtol=1e-5)


# ---------------------------------------------------------------------------
# the error paths: no quiet retreat
# ---------------------------------------------------------------------------


def _mesh(world=4, rank=1, m=8):
  """A rank's view of the layout, without a process group (nothing below
  makes a collective)."""
  from repro_torch.launch.mesh import ProcessMesh
  return ProcessMesh(world, rank, m, torch.device("cpu"), "gloo")


def test_shards_must_split_and_match_the_mesh():
  """m % world != 0 raises, a store or service whose m is not the mesh's
  raises, and so does a device of another kind than the mesh's; a rank's
  store holds its shards' rows only."""
  from repro_torch.service import CorpusStore, SelectionService
  with pytest.raises(ValueError, match="do not split over 4 ranks"):
    _mesh(m=6)
  with pytest.raises(ValueError, match="m=4 but the mesh has 8 shards"):
    CorpusStore(m=4, d=8, device="cpu", mesh=_mesh())
  with pytest.raises(ValueError, match="m=4 but the mesh has 8 shards"):
    SelectionService(m=4, d=8, kappa=2, k_final=2, device="cpu",
                     mesh=_mesh())
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    CorpusStore(m=8, d=8, mesh=_mesh())   # the default device is cuda
  svc = SelectionService(m=8, d=8, kappa=2, k_final=3, capacity=256,
                         append_block=64, device="cpu", mesh=_mesh())
  st = svc.store
  assert st.feats.shape == (64, 8) and st.table.shape == (64,)
  assert st.sieve_state.gid.shape == (8 * st.sieve_thresholds, 3)
  assert st._sieve.gid.shape == (2 * st.sieve_thresholds, 3)
  assert list(svc.board.shards) == [2, 3] and svc.board.ages().shape == (2,)


def test_a_beat_for_another_ranks_shard_is_refused():
  """A rank's board beats its own shards; a beat or failure for another
  rank's shard raises naming the owner, and the sidecar answers such a
  ``POST /healthz`` with 409 (the same error), never a silent drop; the
  exact tier cannot ride a ``QueryBatcher`` on a rank."""
  from repro_torch import obs
  from repro_torch.service import (HeartbeatBoard, QueryBatcher,
                                   SelectionService)
  t = [10.0]
  board = HeartbeatBoard(8, clock=lambda: t[0], mesh=_mesh())
  t[0] += 2.0
  board.beat(3)
  assert board.ages().tolist() == [2.0, 0.0]
  with pytest.raises(ValueError, match="shard 5 is held by rank 2"):
    board.beat(5)
  with pytest.raises(ValueError, match="shard 0 is held by rank 0"):
    board.fail(0)
  with pytest.raises(ValueError, match="outside the service"):
    board.beat(8)
  board.fail(2)
  assert board.ages()[0] == np.inf
  with obs.Sidecar(board=board, registry=obs.Registry()) as side:
    req = urllib.request.Request(side.url + "/healthz?shard=6", data=b"",
                                 method="POST")
    with pytest.raises(urllib.error.HTTPError) as err:
      urllib.request.urlopen(req, timeout=10)
    assert err.value.code == 409
    assert "held by rank 3" in json.loads(err.value.read())["error"]
    ok = urllib.request.Request(side.url + "/healthz?shard=2", data=b"",
                                method="POST")
    assert urllib.request.urlopen(ok, timeout=10).status == 200
    health = json.loads(urllib.request.urlopen(side.url + "/healthz",
                                               timeout=10).read())
    assert health["shards"]["first"] == 2 and health["shards"]["m"] == 2
  assert board.ages()[0] == 0.0
  svc = SelectionService(m=8, d=8, kappa=2, k_final=3, device="cpu",
                         mesh=_mesh())
  with pytest.raises(ValueError, match="exact tier is a collective"):
    QueryBatcher(svc, tier="exact")
