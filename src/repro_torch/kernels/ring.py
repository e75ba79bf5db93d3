"""The shape rule of the persistent TMA kernels ``csrc/pairwise.cu`` and
``csrc/facility.cu`` (their shared ring, ``csrc/ring.cuh``), and the
operand preparation their wrappers share.

Both kernels stream 128-byte boxes of the feature width d through a ring
of TMA loads in shared memory.  ``plan`` is the rule, a pure function of
the kernel, d, the item size and the number of per-row vectors:

  * ``mode``: "resident" when d fits in ``MAX_RESIDENT_BOXES`` boxes (the
    band operand stays in shared memory for a work unit, each stage carries
    every box of a tile), else "streamed" (each stage carries one box of d
    of both operands, so any d fits);
  * ``stages``: the ring's depth, the most that fits beside the rest
    (resident: the kernels' fixed counts);
  * ``smem``: the dynamic shared memory of the launch, the formula of the
    kernel's ``smem_bytes`` (the card tests hold the two together);
  * ``pitch``: the row pitch of a padded copy, d rounded up to 16 bytes.

TMA reads rows whose pitch, base and batch stride are multiples of 16
bytes.  ``features`` and ``vector`` hand an operand over as it is when it
meets that, and otherwise as a copy into a pitched buffer (features: d
rounded up to 16 bytes, the tail never read, since the map's width is the
true d and TMA fills past it with zeros; batched vectors: rows rounded up
to 4 floats).  The copy moves data only; the products stay in the kernel.
"""
from __future__ import annotations

import collections
from typing import NamedTuple

import torch

SMEM_MAX = 232448      # dynamic shared memory a block can use (227 KB)
BOX = 128              # bytes of d a TMA box holds (the 128-byte swizzle)
BAND = 256             # rows of the band operand (x / the candidate band)
TILE = 128             # rows of the streamed tile (y / the eval tile)
MAX_RESIDENT_BOXES = 2  # boxes of d the resident mode takes
ALIGN = 16             # TMA's alignment of bases, pitches and strides

# launches of the pairwise and facility-family kernels by (kernel, ring
# mode), counted by their wrappers beside their own launch counts
mode_launches: collections.Counter = collections.Counter()

# csrc/pairwise.cu: each warp's 32 x 64 output staging; the rbf norms
PW_OUT_BYTES = 8 * 2 * 32 * 128
PW_NORM_BYTES = 8 * (32 + TILE) * 4
PW_RESIDENT_STAGES = 2
# csrc/facility.cu: a tile's per-row vector; the band's norms, top-1 scratch
FL_VEC_BYTES = TILE * 4
FL_RESIDENT_STAGES = 3


def pairwise_smem(boxes: int, stages: int, streamed: bool) -> int:
  """``csrc/pairwise.cu`` smem_bytes: alignment slack, the output staging,
  the ring, two barriers a stage and the band's pair, the norms."""
  ring = (stages * (BAND + TILE) * BOX if streamed
          else boxes * (BAND + stages * TILE) * BOX)
  return 1024 + PW_OUT_BYTES + ring + 8 * (2 + 2 * stages) + PW_NORM_BYTES


def facility_smem(boxes: int, stages: int, streamed: bool, nv: int) -> int:
  """``csrc/facility.cu`` smem_bytes with ``nv`` per-row vectors: alignment
  slack, the ring, the stages' vectors, the band's norms, the top-1
  scratch, two barriers a stage and the band's pair."""
  ring = (stages * (BAND + TILE) * BOX if streamed
          else boxes * (BAND + stages * TILE) * BOX)
  return (1024 + ring + stages * nv * FL_VEC_BYTES + BAND * 4 + 16 * 8
          + 8 * (2 + 2 * stages))


class Ring(NamedTuple):
  """The ring plan of one call (see the module docstring)."""
  mode: str     # "resident" or "streamed"
  boxes: int    # 128-byte boxes of d
  stages: int   # ring stages
  smem: int     # dynamic shared memory of the launch, bytes
  pitch: int    # row pitch of a padded copy, elements

  @property
  def streamed(self) -> bool:
    return self.mode == "streamed"


def plan(kernel: str, d: int, itemsize: int, nv: int = 2) -> Ring:
  """The ring of ``kernel`` ("pairwise" or "facility"; ``nv`` per-row
  vectors for the latter: 2 facility location, 3 saturated coverage) at
  width d of ``itemsize``-byte features."""
  if kernel not in ("pairwise", "facility"):
    raise ValueError(f"ring.plan: unknown kernel {kernel!r}")
  if d < 1 or itemsize not in (2, 4):
    raise ValueError(f"ring.plan: d={d}, itemsize={itemsize}")
  per_box = BOX // itemsize
  boxes = -(-d // per_box)
  pitch = -(-d * itemsize // ALIGN) * ALIGN // itemsize

  def smem(stages, streamed):
    if kernel == "pairwise":
      return pairwise_smem(boxes, stages, streamed)
    return facility_smem(boxes, stages, streamed, nv)

  if boxes <= MAX_RESIDENT_BOXES:
    stages = PW_RESIDENT_STAGES if kernel == "pairwise" else FL_RESIDENT_STAGES
    return Ring("resident", boxes, stages, smem(stages, False), pitch)
  stages = 2
  while smem(stages + 1, True) <= SMEM_MAX:
    stages += 1
  return Ring("streamed", boxes, stages, smem(stages, True), pitch)


class Feat(NamedTuple):
  """A feature operand as the kernel takes it."""
  t: torch.Tensor  # the operand or its padded copy
  ld: int          # elements between rows
  bs: int          # elements between batch entries; 0 = shared
  copied: bool     # a padded copy was made


def _aligned(t: torch.Tensor) -> bool:
  return t.data_ptr() % ALIGN == 0


def features(name: str, t: torch.Tensor) -> Feat:
  """(n, d) or (B, n, d) features as a TMA map reads them: as they are
  when their rows are contiguous and the base, the row pitch and (for a
  batch axis with a stride) the batch stride are multiples of 16 bytes;
  otherwise a copy into a buffer whose rows are d rounded up to 16 bytes.
  A batch axis of stride 0 (an expanded tensor) or of length 1 reads as
  shared.  Rows must have stride 1 along d."""
  n, d = t.shape[-2:]
  esz = t.element_size()
  if d > 1 and t.stride(-1) != 1:
    raise ValueError(f"{name}: features must have contiguous rows (stride 1 "
                     f"along d), got shape {tuple(t.shape)} strides "
                     f"{t.stride()}")
  shared = t.dim() == 2 or t.shape[0] == 1 or t.stride(0) == 0
  pitch = -(-d * esz // ALIGN) * ALIGN // esz
  ld = t.stride(-2) if n > 1 else pitch
  bs = 0 if shared else t.stride(0)
  if (_aligned(t) and ld >= d and ld * esz % ALIGN == 0
      and bs * esz % ALIGN == 0):
    return Feat(t, ld, bs, False)
  src = t[0] if t.dim() == 3 and shared else t
  buf = src.new_empty((*src.shape[:-1], pitch))
  buf[..., :d].copy_(src)
  return Feat(buf, pitch, 0 if src.dim() == 2 else n * pitch, True)


def pitched(t: torch.Tensor) -> torch.Tensor:
  """Features that ``features`` takes as they are: ``t`` itself where it
  already does (and on the CPU), else a view of its padded copy with
  ``t``'s shape.  A caller that hands the same rows to every step of a
  selection pads them once this way instead of once a call."""
  if not t.is_cuda:
    return t
  f = features("pitched", t)
  if not f.copied:
    return t
  return f.t[..., :t.shape[-1]].expand(t.shape)


def gather_rows(t: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
  """``t``'s rows ``ids`` along dim -2 (``torch.gather``) in ``t``'s row
  pitch: rows of a ``pitched`` tensor come out pitched, so the kernels
  read them without a copy."""
  d, ld = t.shape[-1], t.stride(-2)
  end = t.storage_offset() + ld + sum(  # the wide view's end, elements
      (s - 1) * st for s, st in zip(t.shape[:-1], t.stride()[:-1]))
  if (t.stride(-1) != 1 or ld <= d or t.numel() == 0
      or end * t.element_size() > t.untyped_storage().nbytes()):
    return torch.gather(t, -2, ids.unsqueeze(-1).expand(*ids.shape, d))
  wide = t.as_strided((*t.shape[:-1], ld), t.stride(), t.storage_offset())
  return torch.gather(wide, -2, ids.unsqueeze(-1).expand(*ids.shape, ld)
                      )[..., :d]


class Vec(NamedTuple):
  """A per-row float32 vector operand as the kernel takes it."""
  t: torch.Tensor
  bs: int          # elements between partitions; 0 = shared
  copied: bool


def vector(t: torch.Tensor) -> Vec:
  """A contiguous float32 (n,) or (P, n) vector as a TMA map reads it: a
  16-byte aligned base and, with a partition axis, rows a multiple of 16
  bytes apart; otherwise a copy whose rows are n rounded up to 4 floats."""
  n = t.shape[-1]
  bs = t.stride(0) if t.dim() == 2 and t.shape[0] > 1 else 0
  if _aligned(t) and bs * 4 % ALIGN == 0:
    return Vec(t, bs, False)
  src = t[0] if t.dim() == 2 and bs == 0 else t
  pitch = -(-n // 4) * 4
  buf = src.new_empty((*src.shape[:-1], pitch))
  buf[..., :n].copy_(src)
  return Vec(buf, pitch if src.dim() == 2 else 0, True)
