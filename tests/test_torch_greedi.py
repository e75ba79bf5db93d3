"""The port's GreeDi paths against the JAX reference on the same partition.

The reference draws the partition (``greedi_keys`` + ``random_partition``)
and the port receives it as an explicit ``perm``: ``sel_gids`` must be
equal, values and ``stage1_values`` within 1e-5 relative.  The stacked fast
engine is compared with the reference's ``shard_map`` path on 8 forced host
devices in one subprocess, including ragged n and a dead shard.

Equal ids are only meaningful where no greedy step has a near-tie: two
gains closer than float32 noise may swap order between any two summation
orders.  The corpora below are chosen well separated (a few clusters per
machine, kappa no larger than the clusters it can cover), and
``_assert_well_separated`` checks that before ids are compared: every
step's top-2 gain gap, in both rounds, exceeds 1e-4 relative.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.common import tiny_images_like  # noqa: E402
from repro.core import greedi as JG  # noqa: E402
from repro.core import objectives as JO  # noqa: E402
from repro.core.partition import random_partition  # noqa: E402
from repro_torch import interop, no_tf32  # noqa: E402
from repro_torch.core import greedi as TG  # noqa: E402
from repro_torch.core import objectives as TO  # noqa: E402
from repro_torch.core.partition import random_partition as t_partition  # noqa: E402,E501
from repro_torch.data import selection as TS  # noqa: E402

jax.config.update("jax_platform_name", "cpu")
no_tf32()  # full-FP32 products in the plain versions, as on the card

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_partition(rng, feats, m):
  r_part, _, _, r_u = JG.greedi_keys(rng)
  _, _, perm = random_partition(r_part, jnp.asarray(feats), m)
  return np.asarray(perm), r_u


def _min_top2_gap(obj, state, cands, k, mask):
  """Smallest relative gap between the best and second-best feasible gain
  over the k steps of a (batched) greedy run."""
  gaps = []
  sel = torch.zeros(mask.shape, dtype=torch.bool)
  for _ in range(k):
    ok = mask & ~sel
    g = torch.where(ok, obj.gains(state, cands), -1.0)
    top = torch.topk(g, 2, dim=-1)
    live = ok.sum(-1) >= 2
    gap = (top.values[..., 0] - top.values[..., 1]) / top.values[..., 0]
    gaps.append(torch.where(live, gap, torch.inf).min())
    i = top.indices[..., 0]
    feat = torch.gather(cands, -2, i[..., None, None].expand(
        *i.shape, 1, cands.shape[-1])).squeeze(-2)
    state = obj.update(state, feat)
    sel = sel.scatter(-1, i[..., None], True)
  return float(min(gaps))


def _assert_well_separated(f, perm, m, kappa, k_final, kernel, kw,
                           local_eval=True, keep=None):
  """Both rounds of GreeDi on this corpus and partition are free of
  near-ties (see the module doc), so selected ids can be compared."""
  obj = TO.FacilityLocation(kernel=kernel, kernel_kwargs=kw)
  tf = interop.features(f)
  parts, pmask, _ = t_partition(None, tf, m, perm=interop.perm(perm))
  st = obj.init(parts, pmask.float()) if local_eval else obj.broadcast(
      obj.init(tf), m)
  assert _min_top2_gap(obj, st, parts, kappa, pmask) > 1e-4
  r1 = TG.greedy(obj, st, parts, kappa, cand_mask=pmask)
  alive = torch.ones(m, dtype=torch.bool) if keep is None else torch.tensor(
      keep)
  bmask = (r1.idx >= 0) & alive[:, None]
  # round 2 evaluates over the live rows of the alive machines
  st2 = obj.init(parts[alive].reshape(-1, f.shape[1]),
                 pmask[alive].reshape(-1).float())
  assert _min_top2_gap(obj, st2, r1.feats.reshape(-1, f.shape[1]),
                       k_final, bmask.reshape(-1)) > 1e-4


@pytest.mark.parametrize("kernel,kw,local_eval,final_subset", [
    ("linear", (), False, None),
    ("linear", (), True, None),
    ("rbf", (("h", 0.9),), True, None),
    ("linear", (), False, 100),
])
def test_greedi_reference_matches_jax(kernel, kw, local_eval, final_subset):
  f = np.asarray(tiny_images_like(256, 16, clusters=8, seed=8))
  rng = jax.random.PRNGKey(1)
  perm, r_u = _reference_partition(rng, f, 8)
  _assert_well_separated(f, perm, 8, 4, 4, kernel, kw, local_eval)
  jo = JO.FacilityLocation(kernel=kernel, kernel_kwargs=kw, backend="pallas")
  to = TO.FacilityLocation(kernel=kernel, kernel_kwargs=kw)
  jr = JG.greedi_reference(rng, jnp.asarray(f), m=8, kappa=4, k_final=4,
                           objective=jo, init_for=jo.init,
                           local_eval=local_eval, final_subset=final_subset)
  u_idx = None
  if final_subset is not None:  # the reference's draw of U
    u_idx = np.array(jax.random.choice(r_u, 256, (final_subset,),
                                         replace=False))
  tr = interop.to_numpy(TG.greedi_reference(
      None, interop.features(f), m=8, kappa=4, k_final=4, objective=to,
      init_for=to.init, local_eval=local_eval, final_subset=final_subset,
      perm=interop.perm(perm), u_idx=u_idx))
  np.testing.assert_array_equal(tr.sel_gids, np.asarray(jr.sel_gids))
  np.testing.assert_array_equal(tr.sel_valid, np.asarray(jr.sel_valid))
  np.testing.assert_allclose(tr.sel_feats, np.asarray(jr.sel_feats),
                             atol=1e-7)
  for name in ("value", "value_merged", "value_best_single",
               "stage1_values"):
    np.testing.assert_allclose(getattr(tr, name),
                               np.asarray(getattr(jr, name)), rtol=1e-5)


def test_select_indices_and_coverage_match_jax():
  """data/selection: both port paths return the reference's coreset in the
  reference's order; coverage_ratio agrees within 1e-5."""
  f = np.asarray(tiny_images_like(300, 16, clusters=8, seed=8))
  rng = jax.random.PRNGKey(2)
  perm, _ = _reference_partition(rng, f, 4)
  _assert_well_separated(f, perm, 4, 6, 6, "linear", ())
  from repro.data import selection as JS
  want = JS.greedi_select_indices(rng, jnp.asarray(f), m=4, kappa=6,
                                  k_final=6)
  tf = interop.features(f)
  got = TS.greedi_select_indices(None, tf, m=4, kappa=6, k_final=6,
                                 perm=interop.perm(perm))
  two = TS.greedi_select_indices(None, tf, m=4, kappa=6, k_final=6,
                                 perm=interop.perm(perm), use_select=False)
  fast = TS.greedi_select_indices_sharded(None, tf, m=4, kappa=6, k_final=6,
                                          perm=interop.perm(perm))
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(two, want)
  assert set(fast.tolist()) == set(want.tolist())
  np.testing.assert_allclose(
      TS.coverage_ratio(tf, got, 6),
      JS.coverage_ratio(jnp.asarray(f), want, 6), rtol=1e-5)


def test_port_generator_path_is_valid():
  """The port's own torch.Generator draw (no injected perm): k unique,
  in-range ids, and the reference and fast paths agree on the coreset for
  the same generator state (they derive the same partition)."""
  f = interop.features(tiny_images_like(250, 16, clusters=6, seed=7))
  a = TS.greedi_select_indices(torch.Generator().manual_seed(4), f, m=8,
                               kappa=4, k_final=4)
  b = TS.greedi_select_indices_sharded(torch.Generator().manual_seed(4), f,
                                       m=8, kappa=4, k_final=4)
  assert len(a) == 4 and len(set(a.tolist())) == 4
  assert ((a >= 0) & (a < 250)).all()
  assert set(a.tolist()) == set(b.tolist())


SHARDED_CASES = [  # n, kernel, clusters, corpus seed, straggler_keep
    (250, "linear", 6, 7, None),
    (255, "linear", 6, 7, [True] * 3 + [False] + [True] * 4),
    (193, "rbf", 6, 9, None),
]


def test_sharded_fast_matches_jax_sharded(subrun):
  """The stacked fast engine against the reference's shard_map fast engine
  on 8 forced host devices: ragged n (hole rows), linear and rbf, and a
  dead shard (straggler_keep)."""
  for n, kernel, clusters, seed, keep in SHARDED_CASES:
    f = np.asarray(tiny_images_like(n, 16, clusters=clusters, seed=seed))
    perm, _ = _reference_partition(jax.random.PRNGKey(1), f, 8)
    kw = (("h", 0.9),) if kernel == "rbf" else ()
    _assert_well_separated(f, perm, 8, 4, 4, kernel, kw, keep=keep)
  out = subrun(f"""
import jax, jax.numpy as jnp, numpy as np, torch
from benchmarks.common import tiny_images_like
from repro.core import greedi as JG
from repro.core.partition import partition_gids, random_partition
from repro.util import make_mesh
from repro_torch import interop
from repro_torch.core import greedi as TG
mesh = make_mesh((8,), ("data",))
for n, kernel, clusters, seed, keep in {SHARDED_CASES!r}:
  f = tiny_images_like(n, 16, clusters=clusters, seed=seed)
  r_part, r_sel, _, _ = JG.greedi_keys(jax.random.PRNGKey(1))
  parts, _, perm = random_partition(r_part, f, 8)
  npp = parts.shape[1]
  fsh = parts.reshape(8 * npp, 16)
  gids = partition_gids(perm)
  kw = (("h", 0.9),) if kernel == "rbf" else ()
  jr = JG.greedi_sharded_fast(
      fsh, mesh=mesh, kappa=4, k_final=4, kernel=kernel, kernel_kwargs=kw,
      rng=r_sel, gids=gids,
      straggler_keep=None if keep is None else jnp.asarray(keep))
  tr = interop.to_numpy(TG.greedi_sharded_fast(
      interop.features(fsh), m=8, kappa=4, k_final=4, kernel=kernel,
      kernel_kwargs=kw, gids=interop.gids(gids),
      straggler_keep=None if keep is None else torch.tensor(keep)))
  assert np.array_equal(tr.sel_gids, np.asarray(jr.sel_gids)), (
      n, kernel, keep, tr.sel_gids, np.asarray(jr.sel_gids))
  assert np.array_equal(tr.alive, np.asarray(jr.alive))
  for name in ("value", "value_merged", "value_best_single",
               "stage1_values"):
    np.testing.assert_allclose(getattr(tr, name),
                               np.asarray(getattr(jr, name)), rtol=1e-5)
  g = tr.sel_gids[tr.sel_gids >= 0]
  assert len(set(g.tolist())) == len(g) and (g < n).all()
print("STACKED_PARITY")
""", n_devices=8)
  assert "STACKED_PARITY" in out


def test_cli_writes_a_valid_coreset(tmp_path):
  """python -m repro_torch.launch.select on the CPU: both modes write k
  unique, in-range indices and end with one done line."""
  env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
  for mode in (["--mesh", "4"], ["--m", "4"]):
    out = tmp_path / f"sel{mode[0]}.npy"
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.select", "--device", "cpu",
         "--n", "1024", "--d", "16", "--k", "8", *mode, "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    sel = np.load(out)
    assert len(sel) == 8 and len(set(sel.tolist())) == 8
    assert ((sel >= 0) & (sel < 1024)).all()
    done = [ln for ln in p.stdout.splitlines()
            if ln.startswith("[select] done")]
    assert len(done) == 1 and "coverage=" in done[0], p.stdout


def test_cli_no_fast_selects_what_the_fast_engine_selects(tmp_path, capsys):
  """``--mesh 4 --no-fast`` runs facility location through the generic
  engine and writes the coreset the fast engine writes (same partition)."""
  from repro_torch.launch import select as cli
  sels = {}
  for flags in ([], ["--no-fast"]):
    out = tmp_path / f"sel{len(flags)}.npy"
    cli.main(["--device", "cpu", "--n", "1024", "--d", "16", "--k", "8",
              "--mesh", "4", "--no-coverage", *flags, "--out", str(out)])
    sels[bool(flags)] = np.load(out)
  done = [ln for ln in capsys.readouterr().out.splitlines()
          if ln.startswith("[select] done")]
  assert ["engine=fast" in done[0], "engine=generic" in done[1]] == [True,
                                                                      True]
  np.testing.assert_array_equal(sels[True], sels[False])
  assert len(set(sels[True].tolist())) == 8
