"""GreeDi training-data coreset selection as global document indices (the
port of ``src/repro/data/selection.py``).

``greedi_select_indices`` runs the reference protocol (partitions as a
leading axis); ``greedi_select_indices_sharded`` lays the randomly
partitioned ground set out shard-contiguously and runs the cached-similarity
fast engine (or, with ``fast=False``, the generic engine) over m stacked
logical shards on one card, or with ``mesh=`` over the ranks of a process
group, threading the partition permutation through as ``gids`` so the
returned ids refer to the original document order.  Given the same
partition both paths select the same coreset.  Both take the generator
that ``greedi_keys`` splits, or an explicit ``perm``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import greedi as GD
from repro_torch.core import objectives as O
from repro_torch.core.partition import partition_gids, random_partition


def greedi_select_indices(rng: torch.Generator | None, feats: torch.Tensor,
                          *, m: int, kappa: int, k_final: int,
                          kernel: str = "linear", kernel_kwargs: tuple = (),
                          local_eval: bool = True, mode: str = "standard",
                          sample_frac: float | None = None,
                          backend: str | None = None, use_select: bool = True,
                          perm: torch.Tensor | None = None,
                          r1_draws: torch.Tensor | None = None,
                          r2_draws: torch.Tensor | None = None) -> np.ndarray:
  """GreeDi (Alg. 2) returning global indices of the selected coreset.

  ``use_select=False`` runs each greedy step as the gains oracle plus a
  masked top-1 instead of the fused select oracle (same selection).
  ``sample_frac`` is the stochastic mode's inclusion probability;
  ``perm`` and the draw tables ``r1_draws`` / ``r2_draws`` go to
  ``greedi_reference`` (drawn from ``rng`` when None).
  """
  obj = O.FacilityLocation(kernel=kernel, kernel_kwargs=kernel_kwargs)
  r = GD.greedi_reference(rng, feats, m=m, kappa=kappa, k_final=k_final,
                          objective=obj, init_for=obj.init,
                          local_eval=local_eval, mode=mode,
                          sample_frac=sample_frac, backend=backend,
                          use_select=use_select, perm=perm,
                          r1_draws=r1_draws, r2_draws=r2_draws)
  sel = r.sel_gids.cpu().numpy()
  return sel[sel >= 0]


def greedi_select_indices_sharded(rng: torch.Generator | None,
                                  feats: torch.Tensor, *, m: int, kappa: int,
                                  k_final: int, kernel: str = "linear",
                                  kernel_kwargs: tuple = (),
                                  straggler_keep: torch.Tensor | None = None,
                                  backend: str | None = None,
                                  mode: str = "standard",
                                  merge: str = "flat",
                                  tree_branch: int | None = None,
                                  perm: torch.Tensor | None = None,
                                  fast: bool = True,
                                  mesh=None) -> np.ndarray:
  """GreeDi over m logical shards returning global indices.

  The ground set is randomly partitioned with the same generator schedule
  as ``greedi_reference`` (``greedi_keys``), each shard receives one
  partition laid out contiguously, and the permutation rides along as the
  ``gids`` input.  A non-divisible n is padded with hole rows (gids = -1).
  ``fast=False`` runs facility location through the generic engine
  ``greedi_sharded`` instead of the cached-similarity one (same
  selection).  ``mode`` is round 1's ("standard" | "lazy": the same
  selection on both engines; the fast engine's lazy mode prunes the
  cached similarity columns); ``merge`` "flat" or "tree" with
  ``tree_branch`` children a node (``tree_branch = m`` is flat, bit for
  bit).  With ``mesh`` (a ``launch.mesh.ProcessMesh``) every rank draws
  the same partition from the same generator state and runs its own
  shards' rows; every rank returns the same ids, the stacked run's.
  """
  r_part = GD.greedi_keys(rng)[0] if perm is None else None
  parts, _, perm = random_partition(r_part, feats, m, perm=perm)
  gids = partition_gids(perm)
  if mesh is not None:
    parts = parts[mesh.shards]
    gids = gids.reshape(m, -1)[mesh.shards].reshape(-1)
  d = parts.shape[2]
  common = dict(m=m, kappa=kappa, k_final=k_final,
                straggler_keep=straggler_keep, backend=backend, gids=gids,
                mode=mode, merge=merge, tree_branch=tree_branch, mesh=mesh)
  rows = parts.reshape(-1, d)
  if fast:
    r = GD.greedi_sharded_fast(rows, kernel=kernel,
                               kernel_kwargs=kernel_kwargs, **common)
  else:
    obj = O.FacilityLocation(kernel=kernel, kernel_kwargs=kernel_kwargs)
    r = GD.greedi_sharded(rows, objective=obj, **common)
  sel = r.sel_gids.cpu().numpy()
  return sel[sel >= 0]


def coverage_ratio(feats: torch.Tensor, selected: np.ndarray, k: int,
                   kernel: str = "linear", kernel_kwargs: tuple = (),
                   backend: str | None = None) -> float:
  """f(coreset) / f(centralized greedy), the paper's headline metric."""
  obj = O.FacilityLocation(kernel=kernel, kernel_kwargs=kernel_kwargs)
  st0 = obj.init(feats)
  sel_feats = feats[torch.as_tensor(selected, device=feats.device)]
  v_sel = obj.value(GD.set_value_feats(
      obj, st0, sel_feats,
      torch.ones(sel_feats.shape[:1], dtype=torch.bool,
                 device=feats.device)))
  _, v_c = GD.centralized_greedy(feats, k, objective=obj, init_for=obj.init,
                                 backend=backend)
  return float(v_sel / v_c)
