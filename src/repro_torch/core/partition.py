"""Random partitioning of the ground set, GreeDi step 1 (the port of
``src/repro/core/partition.py``).

Random draws take a ``torch.Generator``; every function that partitions
also accepts an explicit ``perm``, so a caller (or a test) can hand in the
partition another implementation drew.  Indices are int64, PyTorch's index
type; -1 marks the padding past a non-divisible n.
"""
from __future__ import annotations

import torch


def random_partition(rng: torch.Generator | None, feats: torch.Tensor,
                     m: int, *, perm: torch.Tensor | None = None):
  """Uniformly-at-random partition into m equal parts (padded if needed).

  Returns (parts (m, npp, d), mask (m, npp) bool, perm (m, npp) int64 with
  -1 padding).  ``perm`` given as (m, npp) or (m*npp,) replaces the draw
  from ``rng``; the draw runs on the generator's device and moves to
  ``feats``'s.
  """
  n, d = feats.shape
  npp = -(-n // m)  # ceil
  if perm is None:
    if rng is None:
      raise ValueError("random_partition needs a generator or a perm")
    p = torch.randperm(n, generator=rng, device=rng.device)
    pad = torch.full((m * npp - n,), -1, dtype=torch.int64, device=rng.device)
    perm = torch.cat([p, pad])
  perm = torch.as_tensor(perm, device=feats.device).to(torch.int64)
  if perm.numel() != m * npp:
    raise ValueError(f"perm has {perm.numel()} entries, expected "
                     f"m * ceil(n / m) = {m * npp}")
  perm = perm.reshape(m, npp)
  mask = perm >= 0
  parts = feats[perm.clamp_min(0).reshape(-1)].reshape(m, npp, d)
  parts = torch.where(mask.unsqueeze(-1), parts, 0.0)
  return parts, mask, perm


def repartition(rng: torch.Generator | None, feats: torch.Tensor, m_new: int,
                *, perm: torch.Tensor | None = None):
  """Elastic re-partition: the number of logical partitions is decoupled
  from the hardware, so re-partitioning between GreeDi runs (the selection
  service does it every epoch) is a fresh ``random_partition`` -- the
  guarantees only need uniformity.  ``perm`` replaces the draw, as there."""
  return random_partition(rng, feats, m_new, perm=perm)


def partition_gids(perm: torch.Tensor,
                   gids: torch.Tensor | None = None) -> torch.Tensor:
  """Global ids of the shard-contiguous layout a partition perm induces.

  ``perm`` is the (m, npp) permutation from ``random_partition`` (-1 =
  padding).  ``gids`` optionally maps permuted row positions to document
  ids, itself allowing -1 holes.  Returns the flat (m*npp,) int64 gids, with
  holes from both sources composed to -1.
  """
  p = perm.reshape(-1).to(torch.int64)
  if gids is None:
    return p
  g = gids.to(torch.int64)[p.clamp_min(0)]
  return torch.where(p >= 0, g, -1)


def shard_live_counts(valid: torch.Tensor, m: int) -> torch.Tensor:
  """(m,) float32 live-row counts per shard of a shard-contiguous layout
  (``valid`` is the flat (m*npp,) liveness mask, gids >= 0)."""
  return torch.sum(valid.reshape(m, -1), dim=1).to(torch.float32)
