"""Cardinality, the constraint of the coreset path (the port of the
``Cardinality`` part of ``src/repro/core/constraints.py``).

A constraint exposes

    state = c.init()
    mask  = c.mask(state, meta)     # (..., n) bool: feasible to add item i
    state = c.update(state, meta_i) # account for the chosen item

``meta`` is a dict of per-item attribute tensors aligned with the candidate
axis.  A state may carry a leading partition axis; the greedy loop
broadcasts ``init()`` to it.  The matroid, knapsack and p-system
constraints come with the remaining objectives (ROADMAP.md, modules to
port, item 7).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Cardinality:
  """|S| <= k (the uniform matroid)."""
  k: int

  def init(self, device=None) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)

  def mask(self, state: torch.Tensor, meta: dict) -> torch.Tensor:
    n = _n_items(meta)
    return (state < self.k).unsqueeze(-1).expand(*state.shape, n)

  def update(self, state: torch.Tensor, meta_i: dict) -> torch.Tensor:
    return state + 1


def _n_items(meta: dict) -> int:
  for v in meta.values():
    return v.shape[-1]
  raise ValueError("constraint meta must contain at least one tensor "
                   "(use default_meta(n) for attribute-free items)")


def slice_meta(meta: dict, i: torch.Tensor) -> dict:
  """Attributes of the chosen items ``i`` (an index per partition)."""
  return {k: v.index_select(-1, i.reshape(-1)).reshape(i.shape)
          for k, v in meta.items()}


def default_meta(n: int, device=None) -> dict:
  return {"_n": torch.zeros((n,), dtype=torch.float32, device=device)}
