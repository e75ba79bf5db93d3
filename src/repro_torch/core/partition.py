"""Random partitioning of the ground set, GreeDi step 1 (the port of
``src/repro/core/partition.py``).

Random draws take a ``torch.Generator``; every function that partitions
also accepts an explicit ``perm``, so a caller (or a test) can hand in the
partition another implementation drew.  Indices are int64, PyTorch's index
type; -1 marks the padding past a non-divisible n.

Over the ranks of a ``launch.mesh.ProcessMesh`` (``mesh=``) every rank
holds its own consecutive rows of the ground set (rank r the r-th
``n / world``) and takes its slab of the global perm -- the
``m_local`` partitions of its shards -- whose rows come from their owners
through ``ProcessMesh.fetch_rows``.  Every rank must pass the same perm
(or draw it from a generator seeded alike on the same kind of device), so
the slabs tile the one partition the stacked call makes.
"""
from __future__ import annotations

import torch


def random_partition(rng: torch.Generator | None, feats: torch.Tensor,
                     m: int, *, perm: torch.Tensor | None = None, mesh=None):
  """Uniformly-at-random partition into m equal parts (padded if needed).

  Returns (parts (m, npp, d), mask (m, npp) bool, perm (m, npp) int64 with
  -1 padding).  ``perm`` given as (m, npp) or (m*npp,) replaces the draw
  from ``rng``; the draw runs on the generator's device and moves to
  ``feats``'s.  With ``mesh`` ``feats`` is the rank's own rows of the
  ground set and the three come back for the rank's slab, (m_local, npp,
  ...), the perm still holding global row indices.
  """
  n, d = feats.shape
  if mesh is not None:
    if m != mesh.m:
      raise ValueError(f"m={m} but the mesh has {mesh.m} shards")
    n *= mesh.world
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
  if mesh is not None:
    perm = perm[mesh.shards]
  mask = perm >= 0
  parts, = partition_rows(perm, [feats], mesh)
  parts = torch.where(mask.unsqueeze(-1), parts.reshape(*perm.shape, d), 0.0)
  return parts, mask, perm


def partition_rows(perm: torch.Tensor, rows, mesh=None) -> list:
  """Each tensor of ``rows`` (a leading row axis, shard-contiguous) at the
  row positions ``perm`` names, flattened to (perm.numel(), ...); -1
  entries take row 0 (the caller masks them).  Stacked this is an index;
  with ``mesh`` the tensors are the rank's own rows, ``perm`` (global row
  indices) its slab, and every tensor's rows come in one
  ``ProcessMesh.fetch_rows``."""
  p = perm.reshape(-1).to(torch.int64).clamp_min(0)
  if mesh is None:
    return [x[p] for x in rows]
  return mesh.fetch_rows(list(rows), p)


def repartition(rng: torch.Generator | None, feats: torch.Tensor, m_new: int,
                *, perm: torch.Tensor | None = None, mesh=None):
  """Elastic re-partition: the number of logical partitions is decoupled
  from the hardware, so re-partitioning between GreeDi runs (the selection
  service does it every epoch) is a fresh ``random_partition`` -- the
  guarantees only need uniformity.  ``perm`` and ``mesh`` as there."""
  return random_partition(rng, feats, m_new, perm=perm, mesh=mesh)


def partition_gids(perm: torch.Tensor, gids: torch.Tensor | None = None,
                   mesh=None) -> torch.Tensor:
  """Global ids of the shard-contiguous layout a partition perm induces.

  ``perm`` is the (m, npp) permutation from ``random_partition`` (-1 =
  padding), with ``mesh`` the rank's slab of it.  ``gids`` optionally maps
  permuted row positions to document ids (with ``mesh`` the rank's own
  rows of them), itself allowing -1 holes.  Returns the flat int64 gids,
  with holes from both sources composed to -1.
  """
  p = perm.reshape(-1).to(torch.int64)
  if gids is None:
    return p
  g, = partition_rows(p, [gids.to(torch.int64)], mesh)
  return torch.where(p >= 0, g, -1)


def shard_live_counts(valid: torch.Tensor, m: int, mesh=None) -> torch.Tensor:
  """(m,) float32 live-row counts per shard of a shard-contiguous layout
  (``valid`` is the flat (m*npp,) liveness mask, gids >= 0); with
  ``mesh`` ``valid`` is the rank's slab and the counts are gathered."""
  if mesh is None:
    return torch.sum(valid.reshape(m, -1), dim=1).to(torch.float32)
  local = torch.sum(valid.reshape(mesh.m_local, -1), dim=1)
  return mesh.all_gather(local.to(torch.float32))
