"""Protocol- and service-level entry points of the hazard analyzer (the port
of ``src/repro/analysis/entries.py``).

The oracle families register their entries next to their wrappers in
``kernels/ops.py``; this module adds the surfaces above them, under the
reference's names: the GreeDi engines (``greedi_sharded`` / ``_fast`` /
``greedi_hierarchical``) and the selection service's epoch, append and
query calls, all on m stacked shards, and two entries over a process mesh
of 2 gloo ranks for the rank rules (T2, T7): ``dist:greedi_sharded_fast``
and ``dist:store_append``.

Shapes are representative, not exhaustive, and the pad-and-mask row sizes
(N = 512 corpus / capacity, 128 rows a shard, 64 an append chunk, 32
merged candidates) are distinct from the feature width (16) and from each
other, so the T3 rule's size matching is unambiguous.  The tree and
hierarchical entries take kappa = 12: with 2-child levels 2 * 8 would be
the feature width.  Operands are made from a numpy seed on the device the
analyzer asks for; about a tenth of the corpus rows are holes (gid -1).

Sync budgets (T1, host syncs in one call):

* every oracle entry, and ``service:store_append`` / ``dist:store_append``
  (one append chunk): 0, the store's stated contract;
* ``service:store_query`` / ``_query_batch`` / ``_query_exact``: 1, one
  read-back a query tile (one tile here);
* the greedy engines, measured on these operands and explained where they
  are registered below (``_BUDGETS``).

To register a new entry point: build a ``dispatch.TraceSpec`` (fn +
operands + mask-arg positions + row sizes + sync budget) in a builder
taking the device (and the rank's ``ProcessMesh`` for an entry over
ranks) and ``dispatch.register_entry_point(name, builder,
needs_ranks=...)``.  See docs/analysis_torch.md.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import greedi as GD
from repro_torch.core import objectives as O
from repro_torch.kernels import dispatch

# representative protocol shapes (see module docstring)
_N, _D, _M, _KAPPA, _KF, _AB = 512, 16, 4, 8, 8, 64
_NPP = _N // _M
_ROWS = (_N, _NPP, _M * _KAPPA)
_DEADLINE = 5.0

# Host syncs one call of each greedy engine makes on these operands (T1),
# measured (the same on the CPU and on the card):
#
# * the standard round 1 and every merge level are fused select steps on
#   the device: 0 syncs;
# * the lazy round 1 (``core/greedy._greedy_lazy``, ``greedi.
#   _fast_r1_lazy``) reads one device predicate a pass of its rescan loop
#   -- "has any partition a tile left whose bound beats its best?" -- so it
#   syncs once a pass (``greedy.lazy_syncs`` counts them): one pass for each
#   tile a step rescans, plus the pass that ends the step.  Here a shard's
#   128 rows are one tile, so a step is two passes: 2 * kappa (kappa 8:
#   16; the tree entries' kappa 12: 24; the warm bounds or the prior gains
#   seed step 0's bounds).  The fast engine's cached-column lazy round 1
#   takes step 0 as one full column pass that seeds its bounds, with no
#   read-back: 2 * (kappa - 1) = 22.  The count depends on the operands:
#   new operands are measured anew.
_BUDGETS = {
    "greedi:sharded_standard": 0,
    "greedi:sharded_lazy_warm": 16,
    "greedi:sharded_fast": 0,
    "greedi:sharded_tree": 0,
    "greedi:sharded_fast_tree_lazy": 22,
    "greedi:hierarchical": 0,
    "service:epoch_facility": 16,
    "service:epoch_tree": 24,
    "service:epoch_info_gain": 16,
    "dist:greedi_sharded_fast": 0,
}


def _corpus(seed: int, n: int = _N, holes: float = 0.1):
  """(feats (n, d) unit rows, gids (n,) int64 with about ``holes`` of the
  rows -1) as numpy."""
  g = np.random.default_rng(seed)
  x = g.standard_normal((n, _D))
  x /= np.linalg.norm(x, axis=1, keepdims=True)
  gids = np.where(g.uniform(size=n) < holes, -1, np.arange(n))
  return x.astype(np.float32), gids.astype(np.int64)


def _fl_bounds(x: np.ndarray, gids: np.ndarray, m: int) -> np.ndarray:
  """Each row's empty-set facility-location gain under its shard's linear
  local evaluation (mean over the shard's live rows of relu(x_e . x_j)),
  inflated a little: valid warm bounds for the lazy round 1."""
  xs, ok = x.reshape(m, -1, _D), (gids >= 0).reshape(m, -1)
  s = np.maximum(np.einsum("bed,bjd->bej", xs, xs), 0.0) * ok[:, :, None]
  b = s.sum(axis=1) / np.maximum(ok.sum(axis=1, keepdims=True), 1)
  return (b * 1.01 + 1e-6).reshape(-1).astype(np.float32)


def _t(a, dev, dtype=None) -> torch.Tensor:
  return torch.as_tensor(np.asarray(a), device=dev, dtype=dtype)


def _ages(dev) -> torch.Tensor:
  return _t(np.array([0.0, 1.0, 2.0, 0.5], np.float32), dev)


def _greedi_spec(mode: str, warm: bool, name: str, dev) -> dispatch.TraceSpec:
  x, gids = _corpus(1)
  obj = O.FacilityLocation(kernel="linear")

  def run(feats, gids, wb, ages):
    return GD.greedi_sharded(
        feats, m=_M, kappa=_KAPPA, k_final=_KF, objective=obj, gids=gids,
        mode=mode, warm_bounds=wb if warm else None, liveness_age=ages,
        liveness_deadline=_DEADLINE)

  return dispatch.TraceSpec(
      fn=run, args=(_t(x, dev), _t(gids, dev), _t(_fl_bounds(x, gids, _M),
                                                    dev), _ages(dev)),
      mask_args=(1,), row_sizes=_ROWS, sync_budget=_BUDGETS[name])


def _greedi_fast_spec(dev) -> dispatch.TraceSpec:
  x, gids = _corpus(2)

  def run(feats, gids, ages):
    return GD.greedi_sharded_fast(
        feats, m=_M, kappa=_KAPPA, k_final=_KF, kernel="linear", gids=gids,
        liveness_age=ages, liveness_deadline=_DEADLINE)

  return dispatch.TraceSpec(
      fn=run, args=(_t(x, dev), _t(gids, dev), _ages(dev)), mask_args=(1,),
      row_sizes=_ROWS, sync_budget=_BUDGETS["greedi:sharded_fast"])


def _greedi_tree_spec(fast: bool, dev) -> dispatch.TraceSpec:
  # merge="tree" with tree_branch=2 over 4 shards: two levels of 2-child
  # merges; kappa=12 so 2 * kappa is not the feature width
  kappa = 12
  x, gids = _corpus(3)
  obj = O.FacilityLocation(kernel="linear")

  if fast:
    # mode="lazy" so the sweep also covers the cached-column lazy round 1
    def run(feats, gids, ages):
      return GD.greedi_sharded_fast(
          feats, m=_M, kappa=kappa, k_final=_KF, kernel="linear", gids=gids,
          liveness_age=ages, liveness_deadline=_DEADLINE, mode="lazy",
          merge="tree", tree_branch=2)
    name = "greedi:sharded_fast_tree_lazy"
  else:
    def run(feats, gids, ages):
      return GD.greedi_sharded(
          feats, m=_M, kappa=kappa, k_final=_KF, objective=obj, gids=gids,
          liveness_age=ages, liveness_deadline=_DEADLINE, merge="tree",
          tree_branch=2)
    name = "greedi:sharded_tree"

  return dispatch.TraceSpec(
      fn=run, args=(_t(x, dev), _t(gids, dev), _ages(dev)), mask_args=(1,),
      row_sizes=(_N, _NPP, 2 * kappa), sync_budget=_BUDGETS[name])


def _greedi_hier_spec(dev) -> dispatch.TraceSpec:
  # 2 pods x 2 shards; kappa=12: the per-pod merge is 2 * kappa rows, and
  # 2 * 8 would be the feature width
  kappa = 12
  x, gids = _corpus(4)
  obj = O.FacilityLocation(kernel="linear")

  def run(feats, gids):
    return GD.greedi_hierarchical(
        feats, pods=2, per_pod=2, kappa=kappa, k_final=_KF, objective=obj,
        gids=gids)

  return dispatch.TraceSpec(
      fn=run, args=(_t(x, dev), _t(gids, dev)), mask_args=(1,),
      row_sizes=(_N, _NPP, 4 * kappa, 2 * kappa),
      sync_budget=_BUDGETS["greedi:hierarchical"])


def _service(dev, objective: str = "facility", n: int = 448, mesh=None,
             **kw):
  """A service of capacity N holding ``n`` documents (gids 0..n-1)."""
  from repro_torch.service.service import SelectionService
  svc = SelectionService(
      m=_M, d=_D, kappa=kw.pop("kappa", _KAPPA), k_final=_KF, capacity=_N,
      append_block=_AB, objective=objective, seed=0, device=dev, mesh=mesh,
      **kw)
  x, _ = _corpus(5, n=n, holes=0.0)
  if objective != "facility":
    x = np.abs(x)  # coverage mass / distinct prior gains
  svc.append(x)
  return svc


def _epoch_spec(name: str, dev, objective: str = "facility",
                **kw) -> dispatch.TraceSpec:
  """``SelectionService._epoch``: the repartition, the warm bounds and
  GreeDi, without the host read-back of its results (the counterpart of
  the reference's ``_epoch_raw``)."""
  svc = _service(dev, objective, **kw)
  st = svc.store
  perm = svc.epoch_perm(0)

  def run(perm, ages, gids):
    del gids  # the store's resident gid column: the taint root
    return svc._epoch(perm, ages, _DEADLINE)

  return dispatch.TraceSpec(
      fn=run, args=(perm, _ages(st.device), st.gids), mask_args=(2,),
      row_sizes=(_N, _NPP, 2 * svc._kappa if svc._merge == "tree"
                 else _M * _KAPPA), sync_budget=_BUDGETS[name])


def _chunk(seed: int, dev) -> torch.Tensor:
  x, _ = _corpus(seed, n=_AB, holes=0.0)
  return _t(x, dev)


def _store_append_spec(dev) -> dispatch.TraceSpec:
  svc = _service(dev, n=256)
  st = svc.store

  def run(chunk, gids):
    del gids  # the resident gid column: the taint root
    st.append(chunk)

  # one chunk: the bound pass over the block and the sieve admission
  return dispatch.TraceSpec(
      fn=run, args=(_chunk(6, dev), st.gids), mask_args=(1,),
      row_sizes=(_NPP, _AB), sync_budget=0)


def _query_svc(dev):
  svc = _service(dev)
  st = svc.store
  excl = np.full((st.query_mask_cap,), -1, np.int64)
  excl[:3] = (5, 17, 40)
  return svc, st, excl


def _store_query_spec(dev) -> dispatch.TraceSpec:
  svc, st, excl = _query_svc(dev)
  n = st.sieve_state.gid.numel()

  def run(sieve_gid, k, excl, seed):
    del sieve_gid  # the pooled sieves' gids: the taint root
    return st.query_sieves(k, exclude_gids=excl, seed=seed)

  # a seeded query: the tie-break jitter path too
  return dispatch.TraceSpec(
      fn=run, args=(st.sieve_state.gid, _KF - 2, excl, 3), mask_args=(0,),
      row_sizes=(n,), sync_budget=1)


def _store_query_batch_spec(dev) -> dispatch.TraceSpec:
  svc, st, excl = _query_svc(dev)
  n = st.sieve_state.gid.numel()
  b = min(5, st.query_batch_tile)   # one query tile
  ks = 1 + np.arange(b) % _KF
  ex = np.tile(excl, (b, 1))
  ex[::2] = -1
  seeds = np.arange(b) % 3

  def run(sieve_gid, ks, ex, seeds):
    del sieve_gid
    return st.query_sieves_batch(ks, ex, seeds)

  return dispatch.TraceSpec(
      fn=run, args=(st.sieve_state.gid, ks, ex, seeds), mask_args=(0,),
      row_sizes=(n,), sync_budget=1)


def _store_query_exact_spec(dev) -> dispatch.TraceSpec:
  svc, st, excl = _query_svc(dev)
  b = min(4, st.query_batch_tile)   # one query tile
  ex = np.tile(excl, (b, 1))

  def run(gids, ks, ex):
    del gids  # the resident gid column: the taint root
    return st.query_exact_batch(ks, ex, _KF)

  return dispatch.TraceSpec(
      fn=run, args=(st.gids, np.full((b,), _KF), ex), mask_args=(0,),
      row_sizes=(_N,), sync_budget=1)


# ---------------------------------------------------------------------------
# over ranks: build(device, mesh) with the rank's ProcessMesh (m = world)
# ---------------------------------------------------------------------------


def _rank_rows(a: np.ndarray, mesh) -> np.ndarray:
  """The rank's contiguous rows of a shard-contiguous (m * npp, ...)
  array under ``mesh``."""
  per = a.shape[0] // mesh.m
  return a[mesh.first * per:(mesh.first + mesh.m_local) * per]


def _dist_fast_spec(dev, mesh) -> dispatch.TraceSpec:
  mesh = dataclasses.replace(mesh, m=_M)
  x, gids = _corpus(2)
  ages = _ages(dev)[mesh.shards]

  def run(feats, gids, ages):
    return GD.greedi_sharded_fast(
        feats, m=_M, kappa=_KAPPA, k_final=_KF, kernel="linear", gids=gids,
        liveness_age=ages, liveness_deadline=_DEADLINE, mesh=mesh)

  return dispatch.TraceSpec(
      fn=run, args=(_t(_rank_rows(x, mesh), dev),
                    _t(_rank_rows(gids, mesh), dev), ages),
      mask_args=(1,), row_sizes=_ROWS,
      sync_budget=_BUDGETS["dist:greedi_sharded_fast"])


def _dist_append_spec(dev, mesh) -> dispatch.TraceSpec:
  svc = _service(dev, n=256, mesh=dataclasses.replace(mesh, m=_M))
  st = svc.store

  def run(chunk, gids):
    del gids
    st.append(chunk)

  # every rank passes the same chunk and keeps its shards' rows of it
  return dispatch.TraceSpec(
      fn=run, args=(_chunk(6, dev), st.gids), mask_args=(1,),
      row_sizes=(_NPP, _AB), sync_budget=0)


def register_all() -> None:
  """Idempotent registration of the protocol, service and rank entries."""
  ep = functools.partial(dispatch.register_entry_point, roots=(__name__,))
  ep("greedi:sharded_standard", functools.partial(
      _greedi_spec, "standard", False, "greedi:sharded_standard"))
  ep("greedi:sharded_lazy_warm", functools.partial(
      _greedi_spec, "lazy", True, "greedi:sharded_lazy_warm"))
  ep("greedi:sharded_fast", _greedi_fast_spec)
  ep("greedi:sharded_tree", functools.partial(_greedi_tree_spec, False))
  ep("greedi:sharded_fast_tree_lazy", functools.partial(_greedi_tree_spec,
                                                        True))
  ep("greedi:hierarchical", _greedi_hier_spec)
  ep("service:epoch_facility", functools.partial(
      _epoch_spec, "service:epoch_facility"))
  ep("service:epoch_tree", functools.partial(
      _epoch_spec, "service:epoch_tree", kappa=12, merge="tree",
      tree_branch=2))
  ep("service:epoch_info_gain", functools.partial(
      _epoch_spec, "service:epoch_info_gain", objective="info_gain"))
  ep("service:store_append", _store_append_spec)
  ep("service:store_query", _store_query_spec)
  ep("service:store_query_batch", _store_query_batch_spec)
  ep("service:store_query_exact", _store_query_exact_spec)
  ep("dist:greedi_sharded_fast", _dist_fast_spec, needs_ranks=2)
  ep("dist:store_append", _dist_append_spec, needs_ranks=2)


register_all()
