"""The fast engine's lazy round 1 and the relu column sums it rests on.

``relu_colsum_ref`` (the plain version of ``csrc/colsum.cu``) is held to the
reference's expression, ``jnp.sum(jnp.maximum(s - cov[:, None], 0),
axis=0)``, within 1e-5 relative, in full and gathered calls; a column's
bits in a gathered call equal its bits in the full pass, which is what
lets ``greedi_sharded_fast(mode="lazy")`` select what the standard round 1
selects bit for bit: the same ``sel_gids``, ``value`` and
``stage1_values``, for linear and rbf, flat and tree merges, with hole
rows.  The port's lazy run is also held to the reference's ``mode="lazy"``
under ``shard_map`` on 4 forced host devices (ids equal, values within
1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro_torch import no_tf32  # noqa: E402
from repro_torch.core import greedi as TG  # noqa: E402
from repro_torch.core import greedy as TGY  # noqa: E402
from repro_torch.kernels import colsum, ops, ref  # noqa: E402

no_tf32()


@pytest.mark.parametrize("m,nl,nc", [(3, 100, 70), (2, 257, 300),
                                     (1, 16384 + 77, 9), (4, 33000, 3)])
def test_relu_colsum_ref_matches_reference_expression(m, nl, nc):
  """Full and gathered calls against the reference's expression (one
  chunk, several chunks and a ragged tail); gathered bits equal the full
  pass's; hole rows (zero rows, cov 0) add nothing."""
  r = np.random.default_rng(nl)
  s = r.normal(size=(m, nl, nc)).astype(np.float32)
  cov = np.abs(r.normal(size=(m, nl))).astype(np.float32)
  holes = r.uniform(size=(m, nl)) < 0.1
  s[holes] = 0.0
  cov[holes] = 0.0
  cols = r.integers(0, nc, size=(m, 5))
  want = np.stack([np.asarray(jnp.sum(jnp.maximum(
      jnp.asarray(s[b]) - jnp.asarray(cov[b])[:, None], 0.0), axis=0))
                   for b in range(m)])
  ts, tc = torch.tensor(s), torch.tensor(cov)
  full = ops.relu_colsum(ts, tc)          # CPU tensors: the plain version
  got = ref.relu_colsum_ref(ts, tc, torch.tensor(cols))
  np.testing.assert_allclose(full.numpy(), want, rtol=1e-5,
                             atol=1e-5 * np.abs(want).max())
  np.testing.assert_allclose(got.numpy(), np.take_along_axis(want, cols, 1),
                             rtol=1e-5, atol=1e-5 * np.abs(want).max())
  assert torch.equal(got, torch.gather(full, 1, torch.tensor(cols)))
  assert colsum.chunks(nl) == -(-nl // ref.colsum_chunk_rows(nl))
  assert colsum.chunks(nl) <= ref.COLSUM_MAX_CHUNKS


def test_colsum_chunks_depend_on_nl_alone():
  for nl in (1, 255, 256, 16384, 16385, 100000):
    ch = ref.colsum_chunk_rows(nl)
    assert ch % ref.COLSUM_CHUNK == 0 and -(-nl // ch) <= 64
  assert ref.colsum_chunk_rows(16384) == 256


def _assert_same(std, lz, what):
  for name in ("sel_gids", "sel_valid", "value", "value_merged",
               "value_best_single", "stage1_values"):
    assert torch.equal(getattr(std, name), getattr(lz, name)), (what, name)


@pytest.mark.parametrize("kernel", ["linear", "rbf"])
@pytest.mark.parametrize("merge", ["flat", "tree"])
def test_fast_lazy_bit_identical_to_standard(kernel, merge):
  """Lazy round 1 over 4 shards of 1024 rows (4 tiles of 256 columns a
  shard) selects what the standard round 1 selects, bit for bit, with
  hole rows; it rescans, one host sync an iteration, and holes stay out."""
  r = np.random.default_rng(5)
  f = torch.tensor(r.normal(size=(4096, 16)), dtype=torch.float32)
  gids = torch.arange(4096)
  gids[::5] = -1
  kw = dict(m=4, kappa=12, k_final=16, kernel=kernel, gids=gids,
            kernel_kwargs=(("h", 3.0),) if kernel == "rbf" else (),
            merge=merge, tree_branch=2 if merge == "tree" else None)
  std = TG.greedi_sharded_fast(f, **kw)
  syncs = TGY.lazy_syncs
  lz = TG.greedi_sharded_fast(f, mode="lazy", **kw)
  _assert_same(std, lz, (kernel, merge))
  assert bool((lz.r1_rescans > 0).all()) and bool((std.r1_rescans == 0).all())
  # one sync an iteration: at least one rescan and the stop test a step
  assert TGY.lazy_syncs - syncs >= 2 * (12 - 1)
  assert int(lz.r1_rescans.max()) < 11 * 4   # pruned: not every tile
  assert not bool((lz.sel_gids[lz.sel_valid] < 0).any())


def test_fast_lazy_more_steps_than_rows():
  """kappa past a shard's live rows: the lazy steps past them find nothing
  feasible and are no-ops, as in the standard round 1."""
  r = np.random.default_rng(6)
  f = torch.tensor(r.normal(size=(64, 8)), dtype=torch.float32)
  gids = torch.arange(64)
  gids[:12] = -1                 # shard 0 keeps 4 live rows of 16
  std = TG.greedi_sharded_fast(f, m=4, kappa=10, k_final=12, gids=gids)
  lz = TG.greedi_sharded_fast(f, m=4, kappa=10, k_final=12, gids=gids,
                              mode="lazy")
  _assert_same(std, lz, "kappa > rows")
  sel = lz.sel_gids[lz.sel_valid].tolist()
  assert len(set(sel)) == len(sel) and min(sel) >= 12


def test_select_indices_sharded_passes_mode_and_merge():
  """data/selection: mode, merge and tree_branch reach the engines; lazy
  and b = m select the standard flat coreset."""
  from repro_torch.data import selection as TS
  f = torch.tensor(np.random.default_rng(7).normal(size=(1000, 16)),
                   dtype=torch.float32)
  runs = [TS.greedi_select_indices_sharded(
      torch.Generator().manual_seed(3), f, m=4, kappa=8, k_final=8, **kw)
          for kw in ({}, dict(mode="lazy"),
                     dict(merge="tree", tree_branch=4),
                     dict(mode="lazy", merge="tree", tree_branch=2,
                          fast=False))]
  np.testing.assert_array_equal(runs[0], runs[1])
  np.testing.assert_array_equal(runs[0], runs[2])
  assert len(runs[3]) == 8 and len(set(runs[3].tolist())) == 8


def test_fast_lazy_matches_reference(subrun):
  """The port's lazy fast engine against the reference's ``mode="lazy"``
  on 4 forced host devices, the same numpy inputs (linear, hole rows):
  ``sel_gids`` equal, values and ``stage1_values`` within 1e-5, both
  rescanning (the reference's tile differs from the card's, so the counts
  are not compared)."""
  out = subrun(r"""
import jax, jax.numpy as jnp, numpy as np, torch
from repro.core import greedi as JG
from repro.util import make_mesh
from repro_torch import no_tf32
from repro_torch.core import greedi as TG
no_tf32()
mesh = make_mesh((4,), ("data",))
r = np.random.default_rng(3)
f = r.normal(size=(2048, 16)).astype(np.float32)
gids = np.where(np.arange(2048) % 5 == 0, -1, np.arange(2048))
jr = JG.greedi_sharded_fast(jnp.asarray(f), mesh=mesh, kappa=12, k_final=16,
                            gids=jnp.asarray(gids), mode="lazy")
tr = TG.greedi_sharded_fast(torch.tensor(f), m=4, kappa=12, k_final=16,
                            gids=torch.tensor(gids), mode="lazy")
assert np.array_equal(tr.sel_gids.numpy(), np.asarray(jr.sel_gids)), (
    tr.sel_gids.tolist(), np.asarray(jr.sel_gids).tolist())
for name in ("value", "value_merged", "value_best_single", "stage1_values"):
  np.testing.assert_allclose(getattr(tr, name).numpy(),
                             np.asarray(getattr(jr, name)), rtol=1e-5)
assert (tr.r1_rescans.numpy() > 0).all()
assert (np.asarray(jr.r1_rescans) > 0).all()
sel = tr.sel_gids[tr.sel_valid].numpy()
assert not np.isin(sel, np.arange(0, 2048, 5)).any()
print("LAZY_REF_OK")
""", n_devices=4)
  assert "LAZY_REF_OK" in out
