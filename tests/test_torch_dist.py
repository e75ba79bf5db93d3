"""The port's ``torch.distributed`` backend against its stacked engines and
against the JAX reference's mesh, on the CPU (gloo).

Ranks are started with ``python -m torch.distributed.run --standalone``
(its own free port, so files run side by side under xdist) on a script in
``tmp_path``; each launch runs every case for its world size and each rank
writes an ``.npz``.  With m = 8 shards at world 2 and 4 (4 and 2 shards a
rank) the ranks must select the stacked port's ``sel_gids`` bit for bit
and return its ``alive``, with ``stage1_values`` and the values within
1e-5 relative: the fast engine (standard and lazy, flat and tree b = 2),
the generic engine (facility location, saturated coverage, information
gain; lazy with ``warm_bounds``; ``u_subset_eval``), ``greedi_hierarchical``
at 2 pods x 4 (a pod inside one rank at world 2, across two at world 4),
liveness with one rank's shards past the deadline, and ``straggler_keep``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
VALUES = ("stage1_values", "value", "value_merged", "value_best_single")

# One script, every case; ``python script.py OUT [INPUTS]`` under torchrun.
# Without INPUTS it runs CASES on its own corpora (rank 0 also runs them
# stacked); with INPUTS (an npz the test wrote) the JAX-parity cases.
RANK_SCRIPT = r'''
import dataclasses
import sys

import numpy as np
import torch

from repro_torch import no_tf32
from repro_torch.core import greedi as TG
from repro_torch.core import objectives as TO
from repro_torch.launch.mesh import ProcessMesh

no_tf32()
M, D, K = 8, 16, 4
FIELDS = ("sel_gids", "sel_valid", "alive", "stage1_values", "value",
          "value_merged", "value_best_single", "r1_rescans")


def corpus(n, seed, clusters=6):
  g = np.random.default_rng(seed)
  c = g.normal(size=(clusters, D))
  f = c[g.integers(0, clusters, n)] / np.sqrt(D) + 0.3 * g.normal(
      size=(n, D)) / np.sqrt(D)
  return f / np.linalg.norm(f, axis=1, keepdims=True)


def layout(n, seed):
  """A random partition of n rows over M shards, shard-contiguous, holes
  (gid -1) past a ragged n: (rows (M * npp, D) float32, gids)."""
  f = corpus(n, seed)
  npp = -(-n // M)
  perm = np.concatenate([np.random.default_rng(seed + 1).permutation(n),
                         -np.ones(M * npp - n, np.int64)])
  rows = np.where(perm[:, None] >= 0, f[np.maximum(perm, 0)], 0.0)
  return torch.tensor(rows, dtype=torch.float32), torch.tensor(perm)


def own(x, mesh, m=M):
  """The rank's entries of a shard-contiguous tensor (all of it stacked)."""
  if mesh is None:
    return x
  return x.reshape(m, -1, *x.shape[1:])[mesh.shards].reshape(
      -1, *x.shape[1:])


def cases(world):
  f1, g1 = layout(250, 7)
  f2, g2 = layout(193, 9)
  # rank 1's shards miss the deadline
  per = M // world
  ages = torch.tensor([3.0 if per <= s < 2 * per else 0.0
                       for s in range(M)])
  keep = torch.tensor([s != 3 for s in range(M)])
  fl = TO.FacilityLocation()
  sc = TO.SaturatedCoverage()
  ig = TO.InformationGain(k_max=K, kernel="rbf", kernel_kwargs=(("h", 1.5),),
                          sigma=0.7)
  st0 = fl.init(f1.reshape(M, -1, D), (g1 >= 0).float().reshape(M, -1))
  warm = (2 * fl.gains(st0, f1.reshape(M, -1, D)) + 1).reshape(-1)
  kw = dict(m=M, kappa=K, k_final=K)

  def fast(feats, gids, **extra):
    return lambda mesh: TG.greedi_sharded_fast(
        own(feats, mesh), gids=own(gids, mesh), mesh=mesh, **kw, **extra)

  def generic(obj, feats, gids, **extra):
    wb = extra.pop("warm_bounds", None)
    return lambda mesh: TG.greedi_sharded(
        own(feats, mesh), objective=obj, gids=own(gids, mesh), mesh=mesh,
        warm_bounds=None if wb is None else own(wb, mesh), **kw, **extra)

  def live(mesh):
    return dict(liveness_age=own(ages, mesh), liveness_deadline=1.0)

  return {
      "fast_flat": fast(f1, g1),
      "fast_lazy_rbf": fast(f2, g2, kernel="rbf",
                            kernel_kwargs=(("h", 0.9),), mode="lazy"),
      "fast_tree2": fast(f1, g1, merge="tree", tree_branch=2),
      "fast_lazy_tree2": fast(f1, g1, mode="lazy", merge="tree",
                              tree_branch=2),
      "fast_liveness": lambda mesh: fast(f1, g1, **live(mesh))(mesh),
      "fast_straggler": fast(f2, g2, straggler_keep=keep),
      "generic_fl": generic(fl, f1, g1),
      "generic_fl_lazy_warm_tree2": generic(fl, f1, g1, mode="lazy",
                                            warm_bounds=warm, merge="tree",
                                            tree_branch=2),
      "generic_fl_u_subset_liveness": lambda mesh: generic(
          fl, f1, g1, u_subset_eval=True, **live(mesh))(mesh),
      "generic_satcov_straggler": generic(sc, f1.abs(), g1,
                                          straggler_keep=keep),
      "generic_ig_u_subset_tree2": lambda mesh: generic(
          ig, f2, g2, u_subset_eval=True, merge="tree", tree_branch=2,
          **live(mesh))(mesh),
      "hierarchical_2x4": lambda mesh: TG.greedi_hierarchical(
          own(f1, mesh), pods=2, per_pod=4, kappa=K, k_final=K, objective=fl,
          gids=own(g1, mesh), mesh=mesh),
      "hierarchical_2x4_straggler": lambda mesh: TG.greedi_hierarchical(
          own(f2, mesh), pods=2, per_pod=4, kappa=K, k_final=K, objective=fl,
          gids=own(g2, mesh), straggler_keep=keep, mesh=mesh),
  }


def jax_cases(inputs):
  """The JAX-parity cases from the test's inputs: the fast engine over the
  reference's partitions, and information gain with liveness and Thm 10."""
  out = {}
  for name in sorted({k.split("/")[0] for k in inputs}):
    feats = torch.tensor(inputs[f"{name}/feats"])
    gids = torch.tensor(inputs[f"{name}/gids"]).to(torch.int64)
    m = int(inputs[f"{name}/m"])
    if name.startswith("ig"):
      obj = TO.InformationGain(k_max=8, kernel="rbf",
                               kernel_kwargs=(("h", 1.5),), sigma=0.7)
      age = torch.tensor(inputs[f"{name}/age"])
      out[name] = lambda mesh, f=feats, g=gids, m=m, o=obj, a=age: (
          TG.greedi_sharded(own(f, mesh, m), m=m, kappa=3, k_final=3,
                            objective=o, gids=own(g, mesh, m),
                            liveness_age=own(a, mesh, m),
                            liveness_deadline=1.0, u_subset_eval=True,
                            mesh=mesh))
    else:
      kernel = str(inputs[f"{name}/kernel"])
      kkw = (("h", 0.9),) if kernel == "rbf" else ()
      keep = inputs[f"{name}/keep"]
      out[name] = lambda mesh, f=feats, g=gids, m=m, k=kernel, kk=kkw, s=(
          None if keep.size == 0 else torch.tensor(keep)): (
              TG.greedi_sharded_fast(own(f, mesh, m), m=m, kappa=4,
                                     k_final=4, kernel=k, kernel_kwargs=kk,
                                     gids=own(g, mesh, m),
                                     straggler_keep=s, mesh=mesh))
  return out


def fields(prefix, r):
  return {f"{prefix}/{f}": getattr(r, f).cpu().numpy() for f in FIELDS}


def main():
  out_dir = sys.argv[1]
  inputs = np.load(sys.argv[2]) if len(sys.argv) > 2 else None
  base = ProcessMesh.from_env(M, "gloo", "cpu")
  todo = cases(base.world) if inputs is None else jax_cases(inputs)
  res, stacked = {}, {}
  for name, run in todo.items():
    m = M if inputs is None else int(inputs[f"{name}/m"])
    mesh = dataclasses.replace(base, m=m, gathers=0, gather_bytes=0)
    res.update(fields(name, run(mesh)))
    res[f"{name}/gathers"] = np.array(mesh.gathers)
    if base.rank == 0 and inputs is None:
      stacked.update(fields(name, run(None)))
  np.savez(f"{out_dir}/rank{base.rank}.npz", **res)
  if stacked:
    np.savez(f"{out_dir}/stacked.npz", **stacked)
  base.close()


main()
'''


def launch(tmp_path, world: int, inputs=None, timeout: int = 300):
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
  proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
  return proc, out, timeout


def finish(proc, out, timeout):
  """Wait for a launch; raise with its output unless every rank exited 0;
  returns the ranks' results."""
  log, _ = proc.communicate(timeout=timeout)
  assert proc.returncode == 0, log
  return [dict(np.load(out / f"rank{r}.npz"))
          for r in range(len(list(out.glob("rank*.npz"))))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
  """Both worlds launched side by side: {world: (ranks' results, rank 0's
  stacked results)}."""
  tmp = tmp_path_factory.mktemp("dist")
  started = {w: launch(tmp, w) for w in WORLDS}
  return {w: (finish(*started[w]), dict(np.load(started[w][1] /
                                                "stacked.npz")))
          for w in WORLDS}


CASES = ("fast_flat", "fast_lazy_rbf", "fast_tree2", "fast_lazy_tree2",
         "fast_liveness", "fast_straggler", "generic_fl",
         "generic_fl_lazy_warm_tree2", "generic_fl_u_subset_liveness",
         "generic_satcov_straggler", "generic_ig_u_subset_tree2",
         "hierarchical_2x4", "hierarchical_2x4_straggler")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", CASES)
def test_ranks_select_the_stacked_ids(runs, world, case):
  """Every rank returns the stacked engine's ids and alive mask bit for bit,
  its values within 1e-5, after collectives of its own."""
  ranks, stacked = runs[world]
  assert len(ranks) == world
  for r, got in enumerate(ranks):
    assert got[f"{case}/gathers"] > 0, (case, r)
    for f in ("sel_gids", "sel_valid", "alive", "r1_rescans"):
      np.testing.assert_array_equal(got[f"{case}/{f}"],
                                    stacked[f"{case}/{f}"],
                                    err_msg=f"{case} rank {r} {f}")
    for f in VALUES:
      np.testing.assert_allclose(got[f"{case}/{f}"], stacked[f"{case}/{f}"],
                                 rtol=1e-5, err_msg=f"{case} rank {r} {f}")
  sel = stacked[f"{case}/sel_gids"]
  sel = sel[sel >= 0]
  assert len(sel) == 4 and len(set(sel.tolist())) == 4
  if "liveness" in case:
    per = 8 // world
    want = [not per <= s < 2 * per for s in range(8)]
    assert stacked[f"{case}/alive"].tolist() == want
  if "straggler" in case:
    assert not stacked[f"{case}/alive"][3]


# the cases of tests/test_torch_greedi.py (the fast engine on the
# reference's partitions) and tests/test_torch_greedi_ig.py (information
# gain with liveness and Thm 10)
JAX_CASES = [  # n, kernel, clusters, corpus seed, straggler_keep
    (250, "linear", 6, 7, None),
    (255, "linear", 6, 7, [True] * 3 + [False] + [True] * 4),
    (193, "rbf", 6, 9, None),
]

JAX_SCRIPT = """
import jax, jax.numpy as jnp, numpy as np
from repro.core import greedi as JG
from repro.core import objectives as JO
from repro.util import make_mesh
inp = dict(np.load({inputs!r}))
out = {{}}
mesh8 = make_mesh((8,), ("data",))
mesh4 = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("data",))
for name in sorted({{k.split("/")[0] for k in inp}}):
  f, g = jnp.asarray(inp[name + "/feats"]), jnp.asarray(inp[name + "/gids"])
  r_sel = JG.greedi_keys(jax.random.PRNGKey(1))[1]
  if name.startswith("ig"):
    kw = (("h", 1.5),)
    jo = JO.InformationGain(k_max=8, kernel="rbf", kernel_kwargs=kw,
                            sigma=0.7)
    r = JG.greedi_sharded(f, mesh=mesh4, kappa=3, k_final=3, objective=jo,
                          rng=r_sel, gids=g,
                          liveness_age=jnp.asarray(inp[name + "/age"]),
                          liveness_deadline=1.0, u_subset_eval=True)
  else:
    kernel = str(inp[name + "/kernel"])
    keep = inp[name + "/keep"]
    r = JG.greedi_sharded_fast(
        f, mesh=mesh8, kappa=4, k_final=4, kernel=kernel,
        kernel_kwargs=(("h", 0.9),) if kernel == "rbf" else (), rng=r_sel,
        gids=g, straggler_keep=None if keep.size == 0 else jnp.asarray(keep))
  for k in ("sel_gids", "alive", "stage1_values", "value", "value_merged",
            "value_best_single"):
    out[name + "/" + k] = np.asarray(getattr(r, k))
np.savez({result!r}, **out)
print("JAX_DONE")
"""


def test_ranks_match_the_jax_mesh(tmp_path, subrun):
  """The ranks at world 4 against ``JG.greedi_sharded[_fast]`` on 8 forced
  host devices, on the reference's partitions: equal ``sel_gids`` and
  ``alive``, values within 1e-5."""
  import jax
  import jax.numpy as jnp

  from benchmarks.common import tiny_images_like
  from repro.core import greedi as JG
  from repro.core.partition import partition_gids, random_partition
  inputs = {}
  for i, (n, kernel, clusters, seed, keep) in enumerate(JAX_CASES):
    f = tiny_images_like(n, 16, clusters=clusters, seed=seed)
    parts, _, perm = random_partition(JG.greedi_keys(jax.random.PRNGKey(1))[0],
                                      f, 8)
    inputs.update({f"fast{i}/feats": np.asarray(parts.reshape(-1, 16)),
                   f"fast{i}/gids": np.asarray(partition_gids(perm)),
                   f"fast{i}/m": np.array(8), f"fast{i}/kernel": kernel,
                   f"fast{i}/keep": np.array([] if keep is None else keep)})
  f = jnp.asarray(np.random.default_rng(6).normal(size=(197, 8)) / np.sqrt(8),
                  jnp.float32)
  parts, _, perm = random_partition(JG.greedi_keys(jax.random.PRNGKey(3))[0],
                                    f, 4)
  inputs.update({"ig/feats": np.asarray(parts.reshape(-1, 8)),
                 "ig/gids": np.asarray(partition_gids(perm)),
                 "ig/m": np.array(4),
                 "ig/age": np.array([0.0, 3.0, 0.0, 0.0], np.float32)})
  np.savez(tmp_path / "inputs.npz", **inputs)
  started = launch(tmp_path, 4, tmp_path / "inputs.npz")
  out = subrun(JAX_SCRIPT.format(inputs=str(tmp_path / "inputs.npz"),
                                 result=str(tmp_path / "jax.npz")),
               n_devices=8)
  assert "JAX_DONE" in out
  ranks = finish(*started)
  want = dict(np.load(tmp_path / "jax.npz"))
  names = sorted({k.split("/")[0] for k in inputs})
  assert len(ranks) == 4 and names == ["fast0", "fast1", "fast2", "ig"]
  for r, got in enumerate(ranks):
    for name in names:
      for f in ("sel_gids", "alive"):
        np.testing.assert_array_equal(got[f"{name}/{f}"],
                                      want[f"{name}/{f}"],
                                      err_msg=f"{name} rank {r} {f}")
      for f in VALUES:
        np.testing.assert_allclose(got[f"{name}/{f}"], want[f"{name}/{f}"],
                                   rtol=1e-5, err_msg=f"{name} rank {r} {f}")
  assert want["ig/alive"].tolist() == [True, False, True, True]
  assert not want["fast1/alive"][3]


# ---------------------------------------------------------------------------
# the error paths: no quiet retreat
# ---------------------------------------------------------------------------


def test_shards_must_split_over_the_ranks(monkeypatch):
  """m % world != 0 raises before any process group is joined."""
  from repro_torch.launch import mesh as M
  monkeypatch.setenv("RANK", "0")
  monkeypatch.setenv("WORLD_SIZE", "4")
  with pytest.raises(ValueError, match="do not split over 4 ranks"):
    M.ProcessMesh.from_env(6, "gloo", "cpu")
  with pytest.raises(ValueError, match="do not split"):
    M.ProcessMesh(4, 1, 10, torch.device("cpu"), "gloo")
  assert M.shards_of(8, 4, 3) == (6, 2)


def test_backend_and_device_are_never_switched(monkeypatch):
  """nccl without cards (or on the CPU) raises, an unknown backend raises,
  gloo on the CPU stays on the CPU."""
  from repro_torch.launch import mesh as M
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    M.mesh_device("nccl", "cuda", 0, 2)
  with pytest.raises(ValueError, match="nccl carries CUDA tensors only"):
    M.mesh_device("nccl", "cpu", 0, 2)
  with pytest.raises(ValueError, match="not in"):
    M.mesh_device("mpi", "cpu", 0, 2)
  with pytest.raises(RuntimeError, match="CUDA is not available"):
    M.mesh_device("gloo", "cuda", 0, 2)
  assert M.mesh_device("gloo", "cpu", 1, 2) == torch.device("cpu")
  monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
  monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
  with pytest.raises(RuntimeError, match="one rank on each card"):
    M.mesh_device("nccl", "cuda", 1, 2)


def test_cli_refuses_the_reference_path_and_joins_for_epochs_under_torchrun(
    monkeypatch):
  """Under torchrun (RANK / WORLD_SIZE set) the reference path raises,
  naming why, before any group is joined, and the service mode
  (``--epochs``) is no longer refused: it goes on to join the group, as
  the sharded mode does (the ranks' runs: tests/test_torch_dist_cli.py);
  outside torchrun ``--dist-backend`` raises instead of running
  stacked."""
  from repro_torch.launch import mesh as M
  from repro_torch.launch import select as cli
  with pytest.raises(SystemExit, match="needs the ranks of a torchrun"):
    cli.main(["--device", "cpu", "--mesh", "4", "--dist-backend", "gloo"])
  monkeypatch.setenv("RANK", "0")
  monkeypatch.setenv("WORLD_SIZE", "2")
  base = ["--device", "cpu", "--n", "256", "--d", "8", "--k", "4"]

  class Joined(Exception):
    pass

  def join(cls, m, backend, device="cuda"):
    raise Joined((m, backend, device))

  monkeypatch.setattr(M.ProcessMesh, "from_env", classmethod(join))
  with pytest.raises(Joined) as joined:
    cli.main([*base, "--mesh", "4", "--epochs", "2"])
  assert joined.value.args[0] == (4, "gloo", "cpu")
  with pytest.raises(SystemExit, match="pass --mesh N"):
    cli.main(base)
