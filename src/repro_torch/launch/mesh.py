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

import numpy as np
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


def pack_rows(tensors) -> torch.Tensor:
  """The rows of tensors with one leading length as one (n, bytes) uint8
  tensor (each tensor's row bytes side by side): one collective carries
  rows of several dtypes, and ``unpack_rows`` gives back every bit."""
  flat = []
  for t in tensors:
    f = t.reshape(t.shape[0], -1)
    if f.numel() and f.stride(-1) != 1:  # an expanded size-1 axis
      f = f.clone(memory_format=torch.contiguous_format)
    flat.append(f.contiguous())
  return torch.cat([f.view(torch.uint8) if f.dtype != torch.bool
                    else f.to(torch.uint8) for f in flat], dim=1)


def unpack_rows(packed: torch.Tensor, like) -> list:
  """Inverse of ``pack_rows``: tensors shaped as ``like``'s (rows, then
  their trailing shapes and dtypes) from an (n, bytes) uint8 tensor."""
  out, off = [], 0
  for t in like:
    tail = tuple(t.shape[1:])
    width = int(np.prod(tail, dtype=np.int64)) * t.element_size()
    part = packed[:, off:off + width].clone(
        memory_format=torch.contiguous_format)  # aligned for the view
    off += width
    if t.dtype == torch.bool:
      out.append(part.to(torch.bool).reshape(-1, *tail))
    else:
      out.append(part.view(t.dtype).reshape(-1, *tail))
  return out


@dataclasses.dataclass
class ProcessMesh:
  """One rank's view of m shards over a process group.

  ``gathers`` and ``gather_bytes`` count the all-gathers made through this
  mesh (the engines' shard-axis gathers, ``all_gather``, ``max``) and the
  bytes this rank received in them; ``exchanges`` and ``exchange_bytes``
  the all-to-alls of ``exchange`` / ``fetch_rows`` and the bytes this
  rank received from the other ranks in them.
  """
  world: int
  rank: int
  m: int
  device: torch.device
  backend: str
  group: object = None
  gathers: int = 0
  gather_bytes: int = 0
  exchanges: int = 0
  exchange_bytes: int = 0

  def __post_init__(self):
    self.first, self.m_local = shards_of(self.m, self.world, self.rank)

  @property
  def shards(self) -> slice:
    """This rank's shards as a slice of the shard axis."""
    return slice(self.first, self.first + self.m_local)

  def all_gather(self, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order (the list
    form of ``all_gather``, which gloo also carries for CUDA tensors; bool
    goes over as uint8).  Every rank must call it with the same shape."""
    flag = x.dtype == torch.bool
    src = (x.to(torch.uint8) if flag else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(self.world)]
    dist.all_gather(parts, src, group=self.group)
    self.gathers += 1
    self.gather_bytes += (self.world - 1) * src.numel() * src.element_size()
    out = torch.cat(parts)
    return out.to(torch.bool) if flag else out

  def max(self, x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks (exact in any order)."""
    return self.all_gather(x.reshape(1, *x.shape)).amax(dim=0)

  def exchange(self, parts, sizes=None) -> list:
    """All-to-all: ``parts[j]`` (rows of one dtype and trailing shape) goes
    to rank j; returns the rows each rank sent this one, in rank order.
    ``sizes`` (rows from each rank), when the caller knows them, saves the
    all-to-all of the counts.  One ``all_to_all_single`` carries the rows
    (gloo takes CUDA tensors in it, not in the list form); nothing is ever
    gathered whole."""
    if len(parts) != self.world:
      raise ValueError(f"exchange of {len(parts)} parts over a world of "
                       f"{self.world}")
    send = [int(p.shape[0]) for p in parts]
    src = torch.cat(parts).contiguous()
    if sizes is None:
      got = torch.empty((self.world,), dtype=torch.int64, device=src.device)
      self._all_to_all(got, torch.tensor(send, dtype=torch.int64,
                                         device=src.device), None, None)
      sizes = got.tolist()
    sizes = [int(s) for s in sizes]
    out = torch.empty((sum(sizes), *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    self._all_to_all(out, src, sizes, send)
    return list(torch.split(out, sizes))

  def _all_to_all(self, out, src, out_sizes, in_sizes) -> None:
    dist.all_to_all_single(out, src, output_split_sizes=out_sizes,
                           input_split_sizes=in_sizes, group=self.group)
    self.exchanges += 1
    row = out[0].numel() * out.element_size() if out.shape[0] else 0
    mine = (out.shape[0] // self.world if out_sizes is None
            else out_sizes[self.rank])
    self.exchange_bytes += (out.shape[0] - mine) * row

  def fetch_rows(self, local, want: torch.Tensor) -> list:
    """Rows of shard-contiguous tensors by global row index: every rank
    holds ``rows = local[0].shape[0]`` consecutive rows of each tensor in
    ``local`` (rank r rows r * rows .. (r + 1) * rows - 1), and gets the
    rows ``want`` (int64, any order, in range) names, every bit as its
    owner holds it.  One exchange of the requested indices (after the
    all-to-all of their counts), then one of the rows, every tensor's
    packed into one payload; no rank holds more than it asked for."""
    rows = int(local[0].shape[0])
    want = want.reshape(-1).to(torch.int64)
    owner = torch.div(want, rows, rounding_mode="floor")
    order = torch.argsort(owner, stable=True)
    asked = torch.bincount(owner, minlength=self.world).tolist()
    if len(asked) != self.world:
      raise ValueError(f"fetch_rows: an index past the {self.world * rows} "
                       "rows of the mesh")
    requests = self.exchange(list(torch.split(want[order], asked)))
    packed = pack_rows(local)
    served = [packed[r - self.rank * rows] for r in requests]
    back = torch.cat(self.exchange(served, sizes=asked))
    out = torch.empty_like(back)
    out[order] = back
    return unpack_rows(out, local)

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
