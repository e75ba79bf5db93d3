"""The process mesh of the ``torch.distributed`` backend (the port's
counterpart of ``src/repro/launch/mesh.py`` and ``repro.util.make_mesh``
for the selection path).

The reference runs GreeDi's m shards over a device mesh under
``shard_map``.  The port runs them either stacked on one card (the
default: the shard axis is a leading tensor axis) or over the ranks of a
process group, each rank holding ``m_local = m // world`` contiguous
shards, the first of them ``rank * m_local``.  A ``ProcessMesh`` is one
rank's view of that layout; ``core.greedi``'s engines take it as
``mesh=`` and gather the shard axis through it.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.select --mesh 16 --n-docs 262144

The backend is explicit and nothing switches it, or the device, quietly:

  * ``nccl`` puts one rank on each card (``cuda:LOCAL_RANK``) and raises
    when the node has fewer cards than ranks;
  * ``gloo`` runs on the CPU (``device="cpu"``) or on CUDA tensors, every
    rank of the node on the card ``device`` names (``cuda`` is the current
    one), so several ranks may share one card.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch import resolve_device

BACKENDS = ("nccl", "gloo")


def _env_int(name: str) -> int:
  if name not in os.environ:
    raise RuntimeError(f"{name} is not set: start the ranks with "
                       "python -m torch.distributed.run (torchrun)")
  return int(os.environ[name])


def under_torchrun() -> bool:
  """Whether this process is a rank that torchrun started (it sets
  ``RANK`` and ``WORLD_SIZE``)."""
  return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def shards_of(m: int, world: int, rank: int) -> tuple[int, int]:
  """(first shard, shard count) of ``rank``: m // world contiguous shards.
  Raises unless the shards split evenly over the ranks."""
  if world < 1 or not 0 <= rank < world:
    raise ValueError(f"rank {rank} outside a world of {world}")
  if m < 1 or m % world:
    raise ValueError(f"{m} shards do not split over {world} ranks "
                     "(m % world must be 0)")
  per = m // world
  return rank * per, per


def mesh_device(backend: str, device: str | torch.device, local_rank: int,
                local_world: int) -> torch.device:
  """The device a rank computes on under ``backend`` (the rule in the
  module docstring).  Raises on an unknown backend, on nccl with a CPU
  device, and on nccl with fewer cards than ranks on the node."""
  if backend not in BACKENDS:
    raise ValueError(f"backend {backend!r} not in {BACKENDS}")
  dev = torch.device(device)
  if backend == "nccl":
    if dev.type != "cuda":
      raise ValueError(f"nccl carries CUDA tensors only, got device {dev}; "
                       "use --dist-backend gloo on the CPU")
    resolve_device("cuda")
    cards = torch.cuda.device_count()
    if cards < local_world:
      raise RuntimeError(f"nccl puts one rank on each card: {local_world} "
                         f"ranks on this node, {cards} cards; use gloo to "
                         "share a card")
    return torch.device("cuda", local_rank)
  dev = resolve_device(dev)
  if dev.type == "cuda" and dev.index is None:
    dev = torch.device("cuda", torch.cuda.current_device())
  return dev


@dataclasses.dataclass
class ProcessMesh:
  """One rank's view of m shards over a process group.

  ``gathers`` and ``gather_bytes`` count the collectives the engines made
  through this mesh and the bytes this rank received in them.
  """
  world: int
  rank: int
  m: int
  device: torch.device
  backend: str
  group: object = None
  gathers: int = 0
  gather_bytes: int = 0

  def __post_init__(self):
    self.first, self.m_local = shards_of(self.m, self.world, self.rank)

  @property
  def shards(self) -> slice:
    """This rank's shards as a slice of the shard axis."""
    return slice(self.first, self.first + self.m_local)

  @classmethod
  def from_env(cls, m: int, backend: str,
               device: str | torch.device = "cuda") -> "ProcessMesh":
    """The mesh of a rank torchrun started: ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` from the environment, the
    process group from ``MASTER_ADDR`` / ``MASTER_PORT``.  Everything is
    checked before the group is joined."""
    world, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    shards_of(m, world, rank)
    dev = mesh_device(backend, device, local_rank, local_world)
    if dev.type == "cuda":
      torch.cuda.set_device(dev)
    if not dist.is_initialized():
      dist.init_process_group(backend, rank=rank, world_size=world)
    return cls(world, rank, m, dev, backend, dist.group.WORLD)

  def close(self) -> None:
    """Leave the process group (every rank calls it once, at the end)."""
    if dist.is_initialized():
      dist.destroy_process_group()
