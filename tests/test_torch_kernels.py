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
  assert dispatch.names() == ("facility_gain", "pairwise")
  assert dispatch.select_names() == ("facility_gain",)
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
  with pytest.raises(ValueError, match="not in"):
    dispatch.resolve("pairwise", "pallas")
  assert ops.launch_counts() == {"pairwise": 0, "facility_gain": 0,
                                 "facility_select": 0}


def test_port_imports_neither_jax_nor_reference():
  """In a fresh interpreter, importing every module of the port loads no
  JAX and no module of the reference package."""
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
"""
  env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
  out = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
  assert out.returncode == 0, out.stderr
  assert "BAD []" in out.stdout, out.stdout
  assert int(out.stdout.split("LOADED")[1].split()[0]) >= 15, out.stdout
