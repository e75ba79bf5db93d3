"""The process meshes of the ``torch.distributed`` backend (the port's
counterpart of ``src/repro/launch/mesh.py`` and ``repro.util.make_mesh``):
``ProcessMesh`` for the selection path and ``TrainMesh`` for training.

The reference runs GreeDi's m shards over a device mesh under
``shard_map``.  The port runs them either stacked on one card (the
default: the shard axis is a leading tensor axis) or over the ranks of a
process group, each rank holding ``m_local = m // world`` contiguous
shards, the first of them ``rank * m_local``.  A ``ProcessMesh`` is one
rank's view of that layout; ``core.greedi``'s engines take it as
``mesh=`` and gather the shard axis through it.

    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.select --mesh 16 --n-docs 262144

A ``TrainMesh`` is a rank's view of a D x M ("data", "model") mesh for
``launch/train.py --mesh DxM``, or of a P x D x M ("pod", "data",
"model") one (``make_host_mesh``; the dry run's ``make_production_mesh``
is one with no processes behind it): its groups are ``ProcessMesh``es,
whose ``sum`` / ``sum_`` (the list-form all-gather, then the float32 sum
in rank order) give every member the same bits, and whose
``reduce_scatter`` (an all-to-all, then the same fold) gives a member the
same bits of its slice.

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
# the largest flat bucket a rank gathers at once in ``ProcessMesh.sum_`` (all
# ranks' parts together): a whole gradient never goes over in one gather
BUCKET_BYTES = 256 << 20


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


def fold_sum(parts, div: int = 1) -> torch.Tensor:
  """``parts[0] + parts[1] + ...`` in that order, accumulated in float32
  (float64 parts in float64), then ``/ div`` (the rank-ordered sum every
  rank of a group computes)."""
  acc = parts[0].to(torch.promote_types(parts[0].dtype, torch.float32),
                    copy=True)
  for p in parts[1:]:
    acc.add_(p)
  return acc.div_(div) if div != 1 else acc


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

  def gather_parts(self, x: torch.Tensor) -> list:
    """Every rank's ``x`` in rank order, one tensor each (the list form of
    ``all_gather``, which gloo also carries for CUDA tensors; bool goes
    over as uint8, 16-bit types as their bytes: gloo has no bfloat16 or
    int16).  Every rank must call it with the same shape."""
    if self.world == 1:  # a group of one rank: no collective
      return [x]
    flag = x.dtype == torch.bool
    raw = x.element_size() == 2
    src = x.contiguous()
    src = (src.to(torch.uint8) if flag else
           src.reshape(-1).view(torch.uint8) if raw else src)
    parts = [torch.empty_like(src) for _ in range(self.world)]
    dist.all_gather(parts, src, group=self.group)
    self.gathers += 1
    self.gather_bytes += (self.world - 1) * src.numel() * src.element_size()
    if flag:
      return [p.to(torch.bool) for p in parts]
    if raw:
      return [p.view(x.dtype).reshape(x.shape) for p in parts]
    return parts

  def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    return torch.cat(self.gather_parts(x), dim=dim)

  def sum(self, x: torch.Tensor, div: int = 1) -> torch.Tensor:
    """The sum of ``x`` over the ranks in rank order (``fold_sum`` of the
    gathered parts: float32 accumulation, ``/ div``), cast back to x's
    dtype.  Every rank gets the same bits, and a one-process run that folds
    the same tensors with ``fold_sum`` gets them too."""
    if self.world == 1 and div == 1:
      return x
    return fold_sum(self.gather_parts(x), div).to(x.dtype)

  def sum_(self, tensors, div: int = 1) -> None:
    """``sum`` of every tensor of ``tensors`` (contiguous), written back in
    place: the tensors of one dtype are packed into flat buckets of at most
    ``BUCKET_BYTES`` (a tensor larger than a bucket is cut), so a whole
    gradient goes over in a few gathers and no rank ever holds a world-size
    copy of it.  The sums are elementwise, so the bucketing leaves every
    bit as ``sum`` would give it."""
    if self.world == 1 and div == 1:
      return
    by_dtype: dict = {}
    for t in tensors:
      by_dtype.setdefault(t.dtype, []).append(t)
    for dtype, ts in by_dtype.items():
      per = max(1, BUCKET_BYTES // (dtype.itemsize * self.world))
      pieces, fill = [], 0
      for t in ts:
        flat = t.view(-1)
        for s in range(0, flat.numel(), per):
          piece = flat[s:s + per]
          if fill + piece.numel() > per:
            self._sum_pieces(pieces, div)
            pieces, fill = [], 0
          pieces.append(piece)
          fill += piece.numel()
      if pieces:
        self._sum_pieces(pieces, div)

  def _sum_pieces(self, pieces, div: int) -> None:
    out = self.sum(torch.cat(pieces) if len(pieces) > 1 else pieces[0],
                   div)
    off = 0
    for p in pieces:
      p.copy_(out[off:off + p.numel()])
      off += p.numel()

  def _swap(self, x: torch.Tensor, dim: int) -> torch.Tensor:
    """(world, *rest): chunk i of ``x`` along ``dim`` comes from rank i,
    every rank sending its chunk j to rank j (one ``all_to_all_single`` of
    equal splits; 16-bit types and bool go over as bytes)."""
    n = x.shape[dim]
    if n % self.world:
      raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                       f"{self.world} ranks")
    src = x.movedim(dim, 0).reshape(self.world, n // self.world,
                                    *x.movedim(dim, 0).shape[1:])
    shape = src.shape
    flag = x.dtype == torch.bool
    src = src.contiguous().reshape(self.world, -1)
    src = (src.to(torch.uint8) if flag else
           src.view(torch.uint8) if x.element_size() == 2 else src)
    out = torch.empty_like(src)
    self._all_to_all(out, src, None, None)
    out = (out.to(torch.bool) if flag else
           out.view(x.dtype) if x.element_size() == 2 else out)
    return out.reshape(shape)

  def reduce_scatter(self, x: torch.Tensor, dim: int = 0,
                     div: int = 1) -> torch.Tensor:
    """This rank's chunk (its index along ``dim``, of ``world`` equal ones)
    of ``sum(x, div)``: every rank's chunk ``rank`` folded in rank order
    (``fold_sum``: float32 accumulation, ``/ div``), cast back to x's
    dtype.  The same bits as ``sum`` then the slice, for 1 / world of the
    bytes.  Gloo has no reduce-scatter: it is an all-to-all."""
    if self.world == 1:
      return x if div == 1 else fold_sum([x], div).to(x.dtype)
    parts = self._swap(x, dim)
    return fold_sum(list(parts), div).to(x.dtype).movedim(0, dim)

  def all_to_all(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Chunk j of ``x`` along ``dim`` (``world`` equal ones) to rank j; the
    chunks this rank receives, in rank order along ``dim`` (every bit
    moved as it is; the inverse is the same call)."""
    if self.world == 1:
      return x
    parts = self._swap(x, dim)
    return parts.reshape(-1, *parts.shape[2:]).movedim(0, dim)

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


# ---------------------------------------------------------------------------
# the training mesh: ([pod,] data, model) over the ranks of a process group
# ---------------------------------------------------------------------------

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def parse_mesh(spec: str) -> tuple[int, int]:
  """``"DxM"`` or ``"D"`` (the reference's ``--mesh``; a 1-D mesh is
  ("data",) alone) -> (D, M)."""
  try:
    dims = tuple(int(s) for s in spec.lower().split("x"))
  except ValueError:
    dims = ()
  if len(dims) not in (1, 2) or min(dims) < 1:
    raise ValueError(f"--mesh {spec!r}: expected D or DxM with positive "
                     "sizes (e.g. 4x2)")
  return (dims[0], dims[1] if len(dims) == 2 else 1)


def _axes(entry) -> tuple:
  """A spec entry (None, an axis name or a tuple of them) as a tuple."""
  if entry is None:
    return ()
  return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _subsets(names: tuple) -> list[tuple]:
  """Every non-empty tuple of ``names`` in mesh order, the one-axis ones
  first (model, data, pod), then the wider ones: the order every rank
  makes the groups in."""
  one = [(a,) for a in reversed(names)]
  wide = [tuple(a for i, a in enumerate(names) if bits >> i & 1)
          for bits in range(1, 1 << len(names))]
  return one + [t for t in wide if len(t) > 1]


@dataclasses.dataclass
class TrainMesh:
  """One rank's view of a D x M training mesh over ("data", "model"), or of
  a P x D x M one over ("pod", "data", "model") (the port's
  ``make_host_mesh(shape, axes)``).  Rank r sits at (r // M, r % M), or
  (r // (D M), r // M % D, r % M): the reference's row-major device order.

  ``dp`` is the rank's data group over every data axis (("pod", "data"):
  the P x D ranks that hold the same model shard, pod-major), ``tp`` its
  model group (the M ranks of one data replica, in model order), ``world``
  spans all of them, and ``group(axes)`` any other tuple of axes a spec
  holds (the pod group, the data group inside a pod, ...), its ranks in
  row-major order over those axes.  Each is a ``ProcessMesh`` (one "shard"
  a rank), whose ``sum`` / ``sum_`` are the rank-ordered sums,
  ``reduce_scatter`` the rank-ordered sum's slice and ``all_gather`` /
  ``gather_parts`` the gathers; ``dist.all_reduce`` is never used, so
  every member of a group ends with the same bits.  Every rank creates
  every group, in the same order.
  """
  data: int
  model: int
  rank: int
  device: torch.device
  backend: str
  dp: ProcessMesh
  tp: ProcessMesh
  world: ProcessMesh
  pod: int | None = None   # None: no pod axis
  groups: dict = dataclasses.field(default_factory=dict)

  @property
  def axis_names(self) -> tuple:
    return AXES if self.pod is None else POD_AXES

  @property
  def shape(self) -> dict:
    sizes = {"data": self.data, "model": self.model}
    return sizes if self.pod is None else {"pod": self.pod, **sizes}

  @property
  def dp_size(self) -> int:
    """The data ranks a model shard is replicated over (P x D)."""
    return self.data * (self.pod or 1)

  @property
  def coords(self) -> dict:
    """This rank's index on each axis."""
    out, r = {}, self.rank
    for a in reversed(self.axis_names):
      out[a] = r % self.shape[a]
      r //= self.shape[a]
    return {a: out[a] for a in self.axis_names}

  def group(self, axes) -> ProcessMesh:
    """The group of a tuple of axes (a name or a tuple, as specs spell
    it; in mesh order)."""
    axes = _axes(axes)
    if axes == ("model",):
      return self.tp
    if axes == tuple(a for a in self.axis_names if a in ("pod", "data")):
      return self.dp
    if axes == self.axis_names:
      return self.world
    if axes in self.groups:
      return self.groups[axes]
    raise ValueError(f"axes {axes}: not a tuple of {self.axis_names} in "
                     "mesh order")

  @property
  def gathers(self) -> int:
    return sum(g.gathers for g in self._all_groups())

  @property
  def gather_bytes(self) -> int:
    return sum(g.gather_bytes for g in self._all_groups())

  def _all_groups(self) -> list:
    seen, out = set(), []
    for g in (self.dp, self.tp, self.world, *self.groups.values()):
      if g is not None and id(g) not in seen:
        seen.add(id(g))
        out.append(g)
    return out

  # ---- leaves laid out by a spec (one entry per dim: None or axes) -----
  def splits(self, spec, ndim: int) -> list[tuple[int, tuple]]:
    """(dim, axes) of every dim ``spec`` splits over mesh axes whose sizes
    multiply past 1, in dim order; raises for an axis the mesh lacks."""
    hits = []
    for dim, entry in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
      axes = _axes(entry)
      for a in axes:
        if a not in self.axis_names:
          raise ValueError(f"spec {spec}: axis {a!r} not in "
                           f"{self.axis_names}")
      if axes and self._size(axes) > 1:
        hits.append((dim, axes))
    return hits

  def _size(self, axes) -> int:
    n = 1
    for a in axes:
      n *= self.shape[a]
    return n

  def _index(self, axes) -> int:
    """This rank's row-major index over ``axes``."""
    i = 0
    for a in axes:
      i = i * self.shape[a] + self.coords[a]
    return i

  def local(self, full: torch.Tensor, spec) -> torch.Tensor:
    """This rank's part of a whole leaf laid out by ``spec`` (a view)."""
    for dim, axes in self.splits(spec, full.dim()):
      n, size = full.shape[dim], self._size(axes)
      if n % size:
        raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split "
                         f"over {axes} = {size}")
      per = n // size
      full = full.narrow(dim, self._index(axes) * per, per)
    return full

  def local_shape(self, shape, spec) -> tuple:
    shape = list(shape)
    for dim, axes in self.splits(spec, len(shape)):
      shape[dim] //= self._size(axes)
    return tuple(shape)

  def whole(self, part: torch.Tensor, spec) -> torch.Tensor:
    """The whole leaf from every rank's part (a gather over each split
    dim's group; a collective of those groups)."""
    for dim, axes in self.splits(spec, part.dim()):
      part = self.group(axes).all_gather(part, dim=dim)
    return part

  # ---- set-up ----------------------------------------------------------
  @classmethod
  def from_env(cls, shape, backend: str,
               device: str | torch.device = "cuda") -> "TrainMesh":
    """The mesh of a rank torchrun started (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``; the group from ``MASTER_ADDR`` /
    ``MASTER_PORT``).  ``shape`` is (D, M) or (P, D, M), whose product must
    be the world size; that, the backend and the device are checked before
    the group is joined."""
    dims = tuple(shape)
    world, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
    if int(np.prod(dims)) != world:
      raise ValueError(f"a {'x'.join(map(str, dims))} mesh needs "
                       f"{int(np.prod(dims))} ranks, this launch has {world}")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = mesh_device(backend, device, local_rank, local_world)
    if dev.type == "cuda":
      torch.cuda.set_device(dev)
    if not dist.is_initialized():
      dist.init_process_group(backend, rank=rank, world_size=world)
    *pod, data, model = dims
    return cls.over(data, model, rank, dev, backend,
                    pod=pod[0] if pod else None)

  @classmethod
  def over(cls, data: int, model: int, rank: int, device, backend: str,
           pod: int | None = None):
    """The mesh over the joined default group (every rank calls it with
    the same shape): the groups of every tuple of axes (``_subsets``'
    order: the model groups, the data groups, the pod groups, then the
    wider ones), each made by every rank in that order; a group of one
    rank makes no collective and a group of the whole world is the
    default group."""
    mesh = cls(data, model, rank, device, backend, None, None, None, pod)
    names, world = mesh.axis_names, mesh._size(mesh.axis_names)
    groups = {}
    for axes in _subsets(names):
      rest = [a for a in names if a not in axes]
      mine = None
      for outer in np.ndindex(*[mesh.shape[a] for a in rest]):
        fixed = dict(zip(rest, outer))
        ranks = []
        for inner in np.ndindex(*[mesh.shape[a] for a in axes]):
          c = {**fixed, **dict(zip(axes, inner))}
          r = 0
          for a in names:
            r = r * mesh.shape[a] + c[a]
          ranks.append(r)
        if len(ranks) == world:
          handle = dist.group.WORLD
        elif len(ranks) == 1:
          handle = None
        else:
          handle = dist.new_group(ranks)
        if rank in ranks:
          mine = ProcessMesh(len(ranks), ranks.index(rank), len(ranks),
                             device, backend, handle)
      groups[axes] = mine
    mesh.groups = groups
    mesh.tp = groups[("model",)]
    mesh.dp = groups[tuple(a for a in names if a in ("pod", "data"))]
    mesh.world = groups[names]
    return mesh

  def close(self) -> None:
    """Leave the process group (every rank calls it once, at the end)."""
    if dist.is_initialized():
      dist.destroy_process_group()


def make_host_mesh(shape=(4, 2), axes=AXES, *, rank: int | None = None,
                   backend: str = "gloo", device="cpu") -> TrainMesh:
  """The reference's ``make_host_mesh(shape, axes)`` over the joined
  default group: ("data", "model") or ("pod", "data", "model") with the
  reference's shapes (``rank`` defaults to this process's)."""
  shape, axes = tuple(shape), tuple(axes)
  if axes not in (AXES, POD_AXES) or len(shape) != len(axes):
    raise ValueError(f"axes {axes} with shape {shape}: the port's meshes "
                     f"are {AXES} and {POD_AXES}")
  if rank is None:
    rank = dist.get_rank()
  *pod, data, model = shape
  return TrainMesh.over(data, model, rank, torch.device(device), backend,
                        pod=pod[0] if pod else None)


def production_shape(*, multi_pod: bool = False) -> tuple[tuple, tuple]:
  """The reference's ``make_production_mesh`` (shape, axes): 16 x 16 over
  ("data", "model"), or 2 x 16 x 16 over ("pod", "data", "model")."""
  return ((2, 16, 16), POD_AXES) if multi_pod else ((16, 16), AXES)


def virtual_mesh(shape, group_factory, rank: int = 0) -> TrainMesh:
  """Rank ``rank``'s view of a (D, M) or (P, D, M) mesh with no processes
  behind it: ``group_factory(world, rank, axes)`` builds each group (the
  dry run's counting groups)."""
  *pod, data, model = tuple(shape)
  mesh = TrainMesh(data, model, rank, torch.device("meta"), "counting",
                   None, None, None, pod[0] if pod else None)
  axes = mesh.axis_names
  for sub in _subsets(axes):
    mesh.groups[sub] = group_factory(mesh._size(sub), mesh._index(sub), sub)
  mesh.tp = mesh.groups[("model",)]
  mesh.dp = mesh.groups[tuple(a for a in axes if a != "model")]
  mesh.world = mesh.groups[axes]
  return mesh


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0,
                         group_factory=None) -> TrainMesh:
  """Rank ``rank``'s view of the reference's production mesh.  Its 256 or
  512 ranks exist only in the dry run, so ``group_factory(world, rank,
  axes)`` builds each group (``launch.dryrun``'s counting groups); there
  is no process group behind it."""
  if group_factory is None:
    raise ValueError("the production mesh has no processes behind it: "
                     "pass group_factory (launch.dryrun.CountingGroup)")
  return virtual_mesh(production_shape(multi_pod=multi_pod)[0],
                      group_factory, rank)


def dp_axes_of(mesh) -> tuple:
  """The data axes of a mesh (the reference's ``dp_axes_of``)."""
  return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def dp_size_of(mesh) -> int:
  """The product of the data axes' sizes (the reference's
  ``dp_size_of``)."""
  n = 1
  for a in dp_axes_of(mesh):
    n *= mesh.shape[a]
  return n
