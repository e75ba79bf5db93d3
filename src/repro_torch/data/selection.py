"""GreeDi training-data coreset selection as global document indices (the
port of ``src/repro/data/selection.py``).

``greedi_select_indices`` runs the reference protocol (partitions as a
leading axis); ``greedi_select_indices_sharded`` lays the randomly
partitioned ground set out shard-contiguously and runs the cached-similarity
fast engine over m stacked logical shards on one card, threading the
partition permutation through as ``gids`` so the returned ids refer to the
original document order.  Given the same partition both paths select the
same coreset.  Both take the generator that ``greedi_keys`` splits, or an
explicit ``perm``.
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
                          backend: str | None = None, use_select: bool = True,
                          perm: torch.Tensor | None = None) -> np.ndarray:
  """GreeDi (Alg. 2) returning global indices of the selected coreset.

  ``use_select=False`` runs each greedy step as the gains oracle plus a
  masked top-1 instead of the fused select oracle (same selection).
  """
  obj = O.FacilityLocation(kernel=kernel, kernel_kwargs=kernel_kwargs)
  r = GD.greedi_reference(rng, feats, m=m, kappa=kappa, k_final=k_final,
                          objective=obj, init_for=obj.init,
                          local_eval=local_eval, mode=mode, backend=backend,
                          use_select=use_select, perm=perm)
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
                                  perm: torch.Tensor | None = None
                                  ) -> np.ndarray:
  """GreeDi over m stacked logical shards returning global indices.

  The ground set is randomly partitioned with the same generator schedule
  as ``greedi_reference`` (``greedi_keys``), each shard receives one
  partition laid out contiguously, and the permutation rides along as the
  ``gids`` input.  A non-divisible n is padded with hole rows (gids = -1).
  """
  r_part = GD.greedi_keys(rng)[0] if perm is None else None
  parts, _, perm = random_partition(r_part, feats, m, perm=perm)
  npp, d = parts.shape[1:]
  r = GD.greedi_sharded_fast(
      parts.reshape(m * npp, d), m=m, kappa=kappa, k_final=k_final,
      kernel=kernel, kernel_kwargs=kernel_kwargs,
      straggler_keep=straggler_keep, backend=backend,
      gids=partition_gids(perm), mode=mode, merge=merge)
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
