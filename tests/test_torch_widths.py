"""The port's pairwise, facility and coverage kernels' plain versions
against the JAX reference at the widths the persistent TMA kernels take by
a padded copy or by streaming (d = 22: rows not a multiple of 16 bytes;
130: past the resident band and not a multiple of 16 bytes; 768: streamed,
a sentence-embedding width), at small n.

On the CPU the port's wrappers take their plain versions; they are held
against ``repro.kernels.ops`` (Pallas in interpret mode) and
``repro.kernels.ref`` on the same numpy inputs.  Tolerances: f32 within
2e-5 and bf16 within 3e-2, each relative to the largest magnitude of the
expected values (the rule of tests/test_kernels.py); top-1 indices equal.
The kernels themselves are held against the plain versions at these widths
on the card (tests/test_torch_cuda.py, ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import no_tf32  # noqa: E402
from repro_torch.kernels import ops, ring  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
no_tf32()  # full-FP32 products in the plain versions, as on the card

WIDTHS = [22, 130, 768]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
NE, NC = 40, 37  # ragged against the kernels' 128-row tiles


def _close(got, want, tol):
  got = np.asarray(got, np.float32)
  want = np.asarray(want, np.float32)
  np.testing.assert_allclose(got, want, rtol=tol,
                             atol=tol * (float(np.abs(want).max()) + 1e-6))


def _inputs(d, seed):
  """Unit-scale rows (so rbf at h = 0.75 is not all zeros), a cov / cover
  on the similarity scale, caps, a mask with dead rows, an ok with masked
  candidates."""
  r = np.random.default_rng(seed)
  ev = (r.normal(size=(NE, d)) / np.sqrt(d)).astype(np.float32)
  cd = (r.normal(size=(NC, d)) / np.sqrt(d)).astype(np.float32)
  cap = np.abs(r.normal(size=(NE,))).astype(np.float32) * 4
  cover = (cap * r.uniform(0.0, 1.3, size=(NE,))).astype(np.float32)
  cov = np.abs(r.normal(size=(NE,))).astype(np.float32) * 0.2
  mask = (r.uniform(size=(NE,)) > 0.1).astype(np.float32)
  ok = r.uniform(size=(NC,)) > 0.3
  return ev, cd, cov, cover, cap, mask, ok


def _both(a, dtype):
  jd, td, _ = DTYPES[dtype]
  return jnp.asarray(a, jd), torch.tensor(a).to(td)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("d", WIDTHS)
def test_pairwise_at_wide_and_padded_widths(d, kernel, dtype):
  ev, cd, *_ = _inputs(d, seed=d)
  (jx, tx), (jy, ty) = _both(ev, dtype), _both(cd, dtype)
  got = ops.pairwise(tx, ty, kernel=kernel).numpy()
  tol = DTYPES[dtype][2]
  _close(got, jops.pairwise(jx, jy, kernel=kernel), tol)
  _close(got, jref.pairwise_ref(jx, jy, kernel=kernel), tol)
  # what the card's wrapper hands the kernel at this width: the same
  # values, in rows pitched to 16 bytes where d is not
  f = ring.features("pairwise", tx)
  assert f.copied == ((d * tx.element_size()) % 16 != 0)
  assert torch.equal(f.t[..., :d], tx)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("d", WIDTHS)
def test_facility_at_wide_and_padded_widths(d, kernel, dtype):
  ev, cd, cov, _, _, mask, ok = _inputs(d, seed=d + 1)
  (jev, tev), (jcd, tcd) = _both(ev, dtype), _both(cd, dtype)
  tol = DTYPES[dtype][2]
  t = torch.tensor
  got = ops.facility_gain(tev, tcd, t(cov), t(mask), kernel=kernel).numpy()
  _close(got, jops.facility_gain(jev, jcd, cov, mask, kernel=kernel), tol)
  _close(got, jref.facility_gain_ref(jev, jcd, cov, mask, kernel=kernel),
         tol)
  best, idx = ops.facility_select(tev, tcd, t(cov), t(mask), t(ok),
                                  kernel=kernel)
  jb, ji = jops.facility_select(jev, jcd, cov, mask, ok, kernel=kernel)
  rb, ri = jref.facility_select_ref(jev, jcd, cov, mask, ok, kernel=kernel)
  assert int(idx) == int(ji) == int(ri)
  assert ok[int(idx)]
  _close(float(best), float(jb), tol)
  _close(float(best), float(rb), tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("d", WIDTHS)
def test_coverage_at_wide_and_padded_widths(d, kernel, dtype):
  ev, cd, _, cover, cap, mask, ok = _inputs(d, seed=d + 2)
  (jev, tev), (jcd, tcd) = _both(np.abs(ev), dtype), _both(np.abs(cd), dtype)
  tol = DTYPES[dtype][2]
  t = torch.tensor
  got = ops.coverage_gain(tev, tcd, t(cover), t(cap), t(mask),
                          kernel=kernel).numpy()
  _close(got, jops.coverage_gain(jev, jcd, cover, cap, mask, kernel=kernel),
         tol)
  _close(got, jref.coverage_gain_ref(jev, jcd, cover, cap, mask,
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
