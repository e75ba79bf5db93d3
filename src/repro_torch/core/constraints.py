"""Hereditary constraint systems (Sec. 5) as mask-based state machines (the
port of ``src/repro/core/constraints.py``).

A constraint exposes

    state = c.init()
    mask  = c.mask(state, meta)     # (..., n) bool: feasible to add item i
    state = c.update(state, meta_i) # account for the chosen item

``meta`` is a dict of per-item attribute tensors aligned with the candidate
axis (partition ids, costs, ...), each (n,) or, with the candidates, (P, n).
A state may carry a leading partition axis; the greedy loop broadcasts
``init()`` to it (``init_batched``).  Heredity is what Theorem 12 needs:
every subset of a feasible set is feasible, which mask-based systems satisfy
by construction (masks only shrink as items are added).  The states are the
reference's: int64 counts in place of int32, the knapsack's spent budget in
float32, so its budget masks come out the same.
"""
from __future__ import annotations

import dataclasses
import math

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

  def rho(self) -> int:
    """Largest feasible set size (rho(zeta) of Thm 12)."""
    return self.k


@dataclasses.dataclass(frozen=True)
class PartitionMatroid:
  """At most caps[p] items from each part; ``meta_key`` selects the item
  attribute holding part ids (so several matroids can constrain the same
  ground set through different groupings, e.g. topic x source)."""
  num_parts: int
  caps: tuple  # length num_parts
  meta_key: str = "part"

  def init(self, device=None) -> torch.Tensor:
    return torch.zeros((self.num_parts,), dtype=torch.int64, device=device)

  def _caps(self, device) -> torch.Tensor:
    return torch.as_tensor(self.caps, dtype=torch.int64, device=device)

  def mask(self, state: torch.Tensor, meta: dict) -> torch.Tensor:
    part = meta[self.meta_key].to(torch.int64)
    lead = state.shape[:-1]
    if part.dim() - 1 < len(lead):  # ids shared by every partition
      part = part.expand(*lead, part.shape[-1])
    count = torch.gather(state, -1, part)
    return count < self._caps(state.device)[part]

  def update(self, state: torch.Tensor, meta_i: dict) -> torch.Tensor:
    i = meta_i[self.meta_key].to(torch.int64).unsqueeze(-1)
    return state.scatter_add(-1, i, torch.ones_like(i))

  def rho(self) -> int:
    return int(sum(self.caps))


@dataclasses.dataclass(frozen=True)
class Knapsack:
  """sum of costs <= budget; meta key ``cost``."""
  budget: float
  min_cost: float = 1e-3  # for the rho bound ceil(R / min_cost)

  def init(self, device=None) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)

  def mask(self, state: torch.Tensor, meta: dict) -> torch.Tensor:
    # float32 like the reference: the remaining budget rounds the same way
    return meta["cost"].to(torch.float32) <= (self.budget
                                              - state).unsqueeze(-1)

  def update(self, state: torch.Tensor, meta_i: dict) -> torch.Tensor:
    return state + meta_i["cost"].to(torch.float32)

  def rho(self) -> int:
    return math.ceil(self.budget / self.min_cost)


@dataclasses.dataclass(frozen=True)
class Intersection:
  """Intersection of hereditary systems (e.g. p matroids, a p-system and d
  knapsacks)."""
  systems: tuple

  def init(self, device=None) -> tuple:
    return tuple(s.init(device) for s in self.systems)

  def mask(self, state: tuple, meta: dict) -> torch.Tensor:
    m = self.systems[0].mask(state[0], meta)
    for s, st in zip(self.systems[1:], state[1:]):
      m = m & s.mask(st, meta)
    return m

  def update(self, state: tuple, meta_i: dict) -> tuple:
    return tuple(s.update(st, meta_i) for s, st in zip(self.systems, state))

  def rho(self) -> int:
    return min(s.rho() for s in self.systems)


@dataclasses.dataclass(frozen=True)
class PSystem:
  """Explicit p-independence system: the intersection of p partition
  matroids presented as one system (Sec. 5.1); the greedy 1/(p+1)
  guarantee (Fisher et al. 1978) and Thm 12's tau / min(m, rho) then apply
  with tau = 1/(p+1)."""
  p: int
  matroids: tuple  # tuple[PartitionMatroid, ...] with len == p

  def init(self, device=None) -> tuple:
    return tuple(m.init(device) for m in self.matroids)

  def mask(self, state: tuple, meta: dict) -> torch.Tensor:
    out = self.matroids[0].mask(state[0], meta)
    for m, st in zip(self.matroids[1:], state[1:]):
      out = out & m.mask(st, meta)
    return out

  def update(self, state: tuple, meta_i: dict) -> tuple:
    return tuple(m.update(st, meta_i) for m, st in zip(self.matroids, state))

  def rho(self) -> int:
    return min(m.rho() for m in self.matroids)

  def tau(self) -> float:
    """Greedy's guarantee on this system (Fisher et al. 1978)."""
    return 1.0 / (self.p + 1)


def init_batched(constraint, batch: tuple, device=None):
  """``constraint.init()`` with a leading ``batch`` axis on every leaf (one
  copy per partition)."""

  def lead(s):
    if isinstance(s, tuple):
      return tuple(lead(x) for x in s)
    return s.expand(tuple(batch) + tuple(s.shape)).clone()

  return lead(constraint.init(device))


def _n_items(meta: dict) -> int:
  for v in meta.values():
    return v.shape[-1]
  raise ValueError("constraint meta must contain at least one tensor "
                   "(use default_meta(n) for attribute-free items)")


def slice_meta(meta: dict, i: torch.Tensor) -> dict:
  """Attributes of the chosen items ``i`` (an index per partition): a
  gather along each partition's own row of a (P, n) attribute, an index
  into a shared (n,) one."""
  out = {}
  for k, v in meta.items():
    if v.dim() > i.dim():
      out[k] = torch.gather(v, -1, i.unsqueeze(-1)).squeeze(-1)
    else:
      out[k] = v.index_select(-1, i.reshape(-1)).reshape(i.shape)
  return out


def default_meta(n: int, device=None) -> dict:
  return {"_n": torch.zeros((n,), dtype=torch.float32, device=device)}
