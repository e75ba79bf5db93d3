"""The port's kernel layer against the JAX reference's.

On the CPU the port's wrappers take their plain PyTorch versions; they are
held here against ``repro.kernels.ops`` (Pallas in interpret mode) and
``repro.kernels.ref`` on the same numpy inputs.  Tolerances: f32 within
2e-5 and bf16 within 3e-2, each relative to the largest magnitude of the
expected values (the rule of tests/test_kernels.py); top-1 indices equal.
The CUDA kernels themselves are held against the plain versions on the card
by tests/test_torch_cuda.py and by ``chip_smoke.py``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import no_tf32  # noqa: E402
from repro_torch.kernels import dispatch, ops, ref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
no_tf32()  # full-FP32 products in the plain versions, as on the card

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(64, 64, 16), (100, 70, 17), (33, 300, 96)]  # ragged vs tiles
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _both(a, dtype):
  """The same numpy values as a JAX array and a torch CPU tensor."""
  jd, td, _ = DTYPES[dtype]
  return jnp.asarray(a, jd), torch.tensor(a).to(td)


def _close(got, want, tol):
  got = np.asarray(got, np.float32)
  want = np.asarray(want, np.float32)
  np.testing.assert_allclose(got, want, rtol=tol,
                             atol=tol * (float(np.abs(want).max()) + 1e-6))


def _inputs(ne, nc, d, seed=0):
  r = np.random.default_rng(seed)
  ev = r.normal(size=(ne, d)).astype(np.float32)
  cd = r.normal(size=(nc, d)).astype(np.float32)
  cov = np.abs(r.normal(size=(ne,))).astype(np.float32)
  mask = (r.uniform(size=(ne,)) > 0.1).astype(np.float32)
  ok = r.uniform(size=(nc,)) > 0.3
  return ev, cd, cov, mask, ok


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("ne,nc,d", SHAPES)
def test_pairwise_matches_reference(ne, nc, d, kernel, dtype):
  ev, cd, *_ = _inputs(ne, nc, d)
  (jx, tx), (jy, ty) = _both(ev, dtype), _both(cd, dtype)
  got = ops.pairwise(tx, ty, kernel=kernel).numpy()
  tol = DTYPES[dtype][2]
  _close(got, jops.pairwise(jx, jy, kernel=kernel), tol)
  _close(got, jref.pairwise_ref(jx, jy, kernel=kernel), tol)


@pytest.mark.parametrize("layout", ["batched", "shared_y", "shared_x"])
@pytest.mark.parametrize("d", [6, 22, 64, 130])
def test_pairwise_batch_layouts_match_reference(d, layout):
  """The batch layouts the pairwise kernel takes (both operands batched, a
  shared y block as for s2, a shared x block), at widths off and on its TMA
  path (d = 64) and past it (130), ragged against its 256 x 128 tiles,
  equal the reference per batch entry, linear and rbf."""
  r = np.random.default_rng(10 + d)
  B, nx, ny = 3, 70, 45
  x = r.normal(size=(B, nx, d)).astype(np.float32) / np.sqrt(d)
  y = r.normal(size=(B, ny, d)).astype(np.float32) / np.sqrt(d)
  tx = torch.tensor(x[0] if layout == "shared_x" else x)
  ty = torch.tensor(y[0] if layout == "shared_y" else y)
  for kernel in ("linear", "rbf"):
    got = ops.pairwise(tx, ty, kernel=kernel)
    assert got.shape == (B, nx, ny)
    for b in range(B):
      xb = x[0] if layout == "shared_x" else x[b]
      yb = y[0] if layout == "shared_y" else y[b]
      _close(got[b].numpy(), jref.pairwise_ref(xb, yb, kernel=kernel), 2e-5)


@pytest.mark.parametrize("count", [0, 2, 6])
def test_info_gain_live_through_the_registry(count):
  """``live`` reaches the plain versions through every backend of the
  registry ("ref" and "auto" agree), and ``ref.live_linv`` is the mask the
  kernels apply: tril with the rows and columns at or past the count
  zeroed, per partition."""
  r = np.random.default_rng(20 + count)
  junk = torch.tensor(r.normal(size=(2, 6, 6)).astype(np.float32))
  live = torch.tensor([count, 6 - count])
  masked = ref.live_linv(junk, live)
  for p, c in enumerate((count, 6 - count)):
    want = np.tril(junk[p].numpy())
    want[c:, :] = 0.0
    want[:, c:] = 0.0
    np.testing.assert_array_equal(masked[p].numpy(), want)
  sel = torch.tensor(r.normal(size=(2, 6, 5)).astype(np.float32))
  cand = torch.tensor(r.normal(size=(40, 5)).astype(np.float32))
  ok = torch.ones(2, 40, dtype=torch.bool)
  kw = dict(kernel="rbf", h=0.9, ridge=0.3, live=live)
  want = ref.info_gain_cond_ref(sel, masked, cand, kernel="rbf", h=0.9,
                                ridge=0.3)
  for backend in ("ref", "auto"):
    torch.testing.assert_close(
        dispatch.resolve("info_gain_cond", backend)(sel, junk, cand, **kw),
        want)
    b, i = dispatch.resolve_select("info_gain_cond", backend)(sel, junk, cand,
                                                              ok, **kw)
    wb, wi = ref.masked_top1(want, ok, floor=0.0)
    torch.testing.assert_close(b, wb)
    assert torch.equal(i, wi)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("ne,nc,d", SHAPES)
def test_facility_gain_matches_reference(ne, nc, d, kernel, dtype):
  ev, cd, cov, mask, _ = _inputs(ne, nc, d, seed=1)
  (jev, tev), (jcd, tcd) = _both(ev, dtype), _both(cd, dtype)
  got = ops.facility_gain(tev, tcd, torch.tensor(cov), torch.tensor(mask),
                          kernel=kernel).numpy()
  tol = DTYPES[dtype][2]
  _close(got, jops.facility_gain(jev, jcd, cov, mask, kernel=kernel), tol)
  _close(got, jref.facility_gain_ref(jev, jcd, cov, mask, kernel=kernel), tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("ne,nc,d", SHAPES)
def test_facility_select_matches_reference(ne, nc, d, kernel, dtype):
  """Masked candidates never win; best and index match the reference."""
  ev, cd, cov, mask, ok = _inputs(ne, nc, d, seed=2)
  (jev, tev), (jcd, tcd) = _both(ev, dtype), _both(cd, dtype)
  best, idx = ops.facility_select(tev, tcd, torch.tensor(cov),
                                  torch.tensor(mask), torch.tensor(ok),
                                  kernel=kernel)
  jb, ji = jops.facility_select(jev, jcd, cov, mask, ok, kernel=kernel)
  rb, ri = jref.facility_select_ref(jev, jcd, cov, mask, ok, kernel=kernel)
  assert int(idx) == int(ji) == int(ri)
  assert ok[int(idx)]
  tol = DTYPES[dtype][2]
  _close(float(best), float(jb), tol)
  _close(float(best), float(rb), tol)


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_facility_select_all_infeasible_and_ties(kernel):
  """Nothing feasible -> (NEG, 0); duplicated candidate rows tie and the
  lowest index wins, as in the reference."""
  ev, cd, cov, mask, _ = _inputs(90, 40, 8, seed=3)
  none = np.zeros((40,), bool)
  best, idx = ops.facility_select(torch.tensor(ev), torch.tensor(cd),
                                  torch.tensor(cov), torch.tensor(mask),
                                  torch.tensor(none), kernel=kernel)
  jb, ji = jops.facility_select(ev, cd, cov, mask, none, kernel=kernel)
  neg = float(np.float32(ref.NEG))
  assert (float(best), int(idx)) == (float(jb), int(ji)) == (neg, 0)

  # ties: +-10 sign vectors make every similarity exact (an identical row
  # gives 800 or exp(0) = 1, any other a multiple of 100 or exactly 0), so
  # the gains are exact integers in any summation order; the best
  # candidate is duplicated at two more indices and the lowest one wins
  r = np.random.default_rng(3)
  cd = np.where(r.uniform(size=(40, 8)) > 0.5, 10.0, -10.0).astype(np.float32)
  ev = cd[r.integers(0, 40, size=90)]
  cov = np.zeros((90,), np.float32)
  mask = np.ones((90,), np.float32)
  g = np.asarray(jref.facility_gain_ref(ev, cd, cov, mask, kernel=kernel))
  j = int(np.argmax(g))
  cd[(j + 7) % 40] = cd[j]
  cd[(j + 3) % 40] = cd[j]
  g = np.asarray(jref.facility_gain_ref(ev, cd, cov, mask, kernel=kernel))
  want = int(np.flatnonzero(g == g.max())[0])
  ok = np.ones((40,), bool)
  best, idx = ops.facility_select(torch.tensor(ev), torch.tensor(cd),
                                  torch.tensor(cov), torch.tensor(mask),
                                  torch.tensor(ok), kernel=kernel)
  jb, ji = jops.facility_select(ev, cd, cov, mask, ok, kernel=kernel)
  assert int(idx) == int(ji) == want
  assert float(best) == float(jb) == float(g.max())


def test_masked_top1_matches_reference():
  r = np.random.default_rng(4)
  s = np.round(r.normal(size=(5, 33)), 1).astype(np.float32)  # many ties
  ok = r.uniform(size=(5, 33)) > 0.4
  ok[2] = False
  best, idx = ref.masked_top1(torch.tensor(s), torch.tensor(ok))
  for p in range(5):
    jb, ji = jref.masked_top1(s[p], ok[p])
    assert (float(best[p]), int(idx[p])) == (float(jb), int(ji))


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_batched_partitions_match_per_partition_reference(kernel):
  """A leading partition axis (the reference's vmap written out), with the
  eval set batched or shared, equals the reference call per partition."""
  r = np.random.default_rng(5)
  P, ne, nc, d = 3, 70, 50, 12
  ev = r.normal(size=(P, ne, d)).astype(np.float32)
  cd = r.normal(size=(P, nc, d)).astype(np.float32)
  cov = np.abs(r.normal(size=(P, ne))).astype(np.float32)
  mask = (r.uniform(size=(P, ne)) > 0.2).astype(np.float32)
  ok = r.uniform(size=(P, nc)) > 0.3
  t = torch.tensor
  g = ops.facility_gain(t(ev), t(cd), t(cov), t(mask), kernel=kernel)
  b, i = ops.facility_select(t(ev), t(cd), t(cov), t(mask), t(ok),
                             kernel=kernel)
  gs = ops.facility_gain(t(ev[0]), t(cd), t(cov), t(mask[0]), kernel=kernel)
  s = ops.pairwise(t(ev), t(cd[0]), kernel=kernel)
  for p in range(P):
    _close(g[p].numpy(), jref.facility_gain_ref(ev[p], cd[p], cov[p],
                                                mask[p], kernel=kernel), 2e-5)
    jb, ji = jops.facility_select(ev[p], cd[p], cov[p], mask[p], ok[p],
                                  kernel=kernel)
    assert int(i[p]) == int(ji)
    _close(float(b[p]), float(jb), 2e-5)
    _close(gs[p].numpy(), jref.facility_gain_ref(ev[0], cd[p], cov[p],
                                                 mask[0], kernel=kernel),
           2e-5)
    _close(s[p].numpy(), jref.pairwise_ref(ev[p], cd[0], kernel=kernel),
           2e-5)


def test_registry_backends():
  """The registry carries the reference's names; "cuda" on CPU tensors
  raises instead of falling back; "ref" and "auto" run the plain version."""
  assert dispatch.names() == ("bound_update", "coverage_gain", "facility_gain",
                              "flash_attention", "graph_cut_gain",
                              "info_gain_cond", "pairwise", "relu_colsum",
                              "sieve_update")
  assert dispatch.select_names() == ("coverage_gain", "facility_gain",
                                     "graph_cut_gain", "info_gain_cond")
  assert dispatch.select_batched_names() == ("coverage_gain", "facility_gain",
                                             "graph_cut_gain",
                                             "info_gain_cond")
  w = torch.rand(12, 12)
  xs = torch.zeros(3, 12)
  oks = torch.ones(3, 12, dtype=torch.bool)
  with pytest.raises(ValueError, match="backend 'cuda' needs CUDA"):
    dispatch.resolve("graph_cut_gain", "cuda")(w, xs)
  with pytest.raises(ValueError, match="backend 'cuda' needs CUDA"):
    dispatch.resolve_select_batched("graph_cut_gain", "cuda")(w, xs, oks)
  for a, b in zip(dispatch.resolve_select_batched("graph_cut_gain", "ref")(
      w, xs, oks), dispatch.resolve_select_batched("graph_cut_gain",
                                                   "auto")(w, xs, oks)):
    torch.testing.assert_close(a, b)
  x = torch.randn(20, 8)
  y = torch.randn(10, 8)
  cov = torch.zeros(20)
  mask = torch.ones(20)
  ok = torch.ones(10, dtype=torch.bool)
  for name, args in (("pairwise", (x, y)),
                     ("facility_gain", (x, y, cov, mask))):
    with pytest.raises(ValueError, match="backend 'cuda' needs CUDA"):
      dispatch.resolve(name, "cuda")(*args)
    torch.testing.assert_close(dispatch.resolve(name, "ref")(*args),
                               dispatch.resolve(name, "auto")(*args))
  with pytest.raises(ValueError, match="backend 'cuda' needs CUDA"):
    dispatch.resolve_select("facility_gain", "cuda")(x, y, cov, mask, ok)
  sel, linv = torch.randn(4, 8), torch.tril(torch.randn(4, 4))
  with pytest.raises(ValueError, match="backend 'cuda' needs CUDA"):
    dispatch.resolve("info_gain_cond", "cuda")(sel, linv, y)
  with pytest.raises(ValueError, match="backend 'cuda' needs CUDA"):
    dispatch.resolve_select("info_gain_cond", "cuda")(sel, linv, y, ok)
  torch.testing.assert_close(
      dispatch.resolve("info_gain_cond", "ref")(sel, linv, y),
      dispatch.resolve("info_gain_cond", "auto")(sel, linv, y))
  for a, b in zip(dispatch.resolve_select("info_gain_cond", "ref")(
      sel, linv, y, ok), dispatch.resolve_select("info_gain_cond", "auto")(
          sel, linv, y, ok)):
    torch.testing.assert_close(a, b)
  cap = torch.full((20,), 2.0)
  with pytest.raises(ValueError, match="backend 'cuda' needs CUDA"):
    dispatch.resolve("coverage_gain", "cuda")(x, y, cov, cap, mask)
  with pytest.raises(ValueError, match="backend 'cuda' needs CUDA"):
    dispatch.resolve_select("coverage_gain", "cuda")(x, y, cov, cap, mask, ok)
  with pytest.raises(ValueError, match="backend 'cuda' needs CUDA"):
    dispatch.resolve("bound_update", "cuda")(x, y, mask, ok.float())
  torch.testing.assert_close(
      dispatch.resolve("coverage_gain", "ref")(x, y, cov, cap, mask),
      dispatch.resolve("coverage_gain", "auto")(x, y, cov, cap, mask))
  for a, b in zip(dispatch.resolve_select("coverage_gain", "ref")(
      x, y, cov, cap, mask, ok), dispatch.resolve_select(
          "coverage_gain", "auto")(x, y, cov, cap, mask, ok)):
    torch.testing.assert_close(a, b)
  for a, b in zip(dispatch.resolve("bound_update", "ref")(
      x, y, mask, ok.float()), dispatch.resolve("bound_update", "auto")(
          x, y, mask, ok.float())):
    torch.testing.assert_close(a, b)
  q, kv = torch.randn(1, 4, 9, 32), torch.randn(1, 2, 9, 32)
  with pytest.raises(ValueError, match="backend 'cuda' needs CUDA"):
    dispatch.resolve("flash_attention", "cuda")(q, kv, kv)
  torch.testing.assert_close(
      dispatch.resolve("flash_attention", "ref")(q, kv, kv, causal=False),
      dispatch.resolve("flash_attention", "auto")(q, kv, kv, causal=False))
  s3, c2 = torch.rand(2, 20, 10), torch.rand(2, 20)
  with pytest.raises(ValueError, match="backend 'cuda' needs CUDA"):
    dispatch.resolve("relu_colsum", "cuda")(s3, c2)
  assert torch.equal(dispatch.resolve("relu_colsum", "ref")(s3, c2),
                     dispatch.resolve("relu_colsum", "auto")(s3, c2))
  rows, tau = torch.randn(6, 8), torch.ones(2)
  sieve = (torch.full((2, 3), -1), torch.zeros(2, 3), torch.zeros(2, 3, 8),
           torch.zeros(2, dtype=torch.int64))
  sieve_args = (rows, torch.ones(6), torch.arange(6), torch.ones(
      6, dtype=torch.bool), tau, *sieve)
  with pytest.raises(ValueError, match="backend 'cuda' needs CUDA"):
    dispatch.resolve("sieve_update", "cuda")(*sieve_args)
  for a, b in zip(dispatch.resolve("sieve_update", "ref")(*sieve_args),
                  dispatch.resolve("sieve_update", "auto")(*sieve_args)):
    assert torch.equal(a, b)
  with pytest.raises(ValueError, match="backend 'cuda' needs CUDA"):
    dispatch.resolve_select_batched("facility_gain", "cuda")(
        x, y, cov.expand(3, -1), mask.expand(3, -1), ok.expand(3, -1))
  with pytest.raises(ValueError, match="not in"):
    dispatch.resolve("pairwise", "pallas")
  assert ops.launch_counts() == {"pairwise": 0, "facility_gain": 0,
                                 "facility_select": 0, "coverage_gain": 0,
                                 "coverage_select": 0, "info_gain_cond": 0,
                                 "info_select": 0, "graph_cut_gain": 0,
                                 "graph_cut_select": 0, "flash_attention": 0,
                                 "relu_colsum": 0, "sieve_admit": 0}


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
def test_bound_update_matches_reference(kernel):
  """The append-time bound pass against the reference's ``bound_update``
  (padding rows and hole columns masked), and its stacked-shard form
  against the reference per shard."""
  r = np.random.default_rng(9)
  new = r.normal(size=(40, 12)).astype(np.float32)
  block = r.normal(size=(4, 30, 12)).astype(np.float32)
  nv = (r.uniform(size=40) > 0.2).astype(np.float32)
  bv = (r.uniform(size=(4, 30)) > 0.3).astype(np.float32)
  t = torch.tensor
  add, sums = ops.bound_update(t(new), t(block), t(nv), t(bv), kernel=kernel)
  for s in range(4):
    ja, js = jops.bound_update(new, block[s], nv, bv[s], kernel=kernel)
    _close(add[s].numpy(), ja, 2e-5)
    _close(sums[s].numpy(), js, 2e-5)
  ja, js = jops.bound_update(new, block.reshape(-1, 12), nv, bv.reshape(-1),
                             kernel=kernel)
  a1, s1 = ops.bound_update(t(new), t(block.reshape(-1, 12)), t(nv),
                            t(bv.reshape(-1)), kernel=kernel)
  _close(a1.numpy(), ja, 2e-5)
  _close(s1.numpy(), js, 2e-5)
  _close(sums.sum(0).numpy(), js, 2e-5)


def test_port_imports_neither_jax_nor_reference():
  """In a fresh interpreter, importing every module of the port (the
  selection service's with its query path, the graph-cut path's, the LM
  serving path's, the training path's with its compressed all-reduce,
  ``obs``, the process and training meshes of the ``torch.distributed``
  backend, the dry run and the kernels' meta routes among them) and the
  port's examples, examples/active_set_gp_torch.py,
  examples/maxcut_constrained_torch.py, examples/quickstart_torch.py,
  examples/train_with_selection_torch.py and
  examples/selection_service_torch.py, loads no JAX and no module of the
  reference package."""
  code = r"""
import importlib, pkgutil, sys
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
  importlib.import_module(mod.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro.") or m == "benchmarks"
             or m.startswith("benchmarks."))
print("LOADED", len([m for m in sys.modules if m.startswith("repro_torch")]))
print("BAD", bad)
for name in ("repro_torch.service.service", "repro_torch.service.store",
             "repro_torch.service.heartbeat", "repro_torch.kernels.autotune",
             "repro_torch.kernels.coverage_gain",
             "repro_torch.kernels.graph_cut_gain", "repro_torch.data.graphs",
             "repro_torch.kernels.flash_attention", "repro_torch.configs",
             "repro_torch.configs.qwen3_4b", "repro_torch.models.registry",
             "repro_torch.models.transformer", "repro_torch.serve.serve_step",
             "repro_torch.service.batching", "repro_torch.kernels.sieve",
             "repro_torch.data.pipeline", "repro_torch.interop",
             "repro_torch.obs", "repro_torch.obs.metrics",
             "repro_torch.obs.export", "repro_torch.obs.trace",
             "repro_torch.obs.sidecar", "repro_torch.train",
             "repro_torch.train.optimizer", "repro_torch.train.train_step",
             "repro_torch.train.checkpoint", "repro_torch.launch.train",
             "repro_torch.launch.mesh", "repro_torch.train.compression",
             "repro_torch.launch.dryrun", "repro_torch.kernels.meta",
             "repro_torch.analysis", "repro_torch.analysis.findings",
             "repro_torch.analysis.ast_lint",
             "repro_torch.analysis.trace_check",
             "repro_torch.analysis.entries", "repro_torch.analysis.modgraph",
             "repro_torch.analysis.__main__"):
  assert name in sys.modules, name
"""
  env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
  out = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
  assert out.returncode == 0, out.stderr
  assert "BAD []" in out.stdout, out.stdout
  assert int(out.stdout.split("LOADED")[1].split()[0]) >= 45, out.stdout
  # the port's examples, imported without running them
  for name in ("active_set_gp_torch.py", "maxcut_constrained_torch.py",
               "quickstart_torch.py", "train_with_selection_torch.py",
               "selection_service_torch.py"):
    example = os.path.join(REPO, "examples", name)
    with_example = code.replace(
        "import repro_torch\n",
        "import repro_torch, runpy\n"
        f"runpy.run_path({example!r}, run_name='example')\n")
    assert with_example != code
    out = subprocess.run([sys.executable, "-c", with_example], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
