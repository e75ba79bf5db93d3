"""Pairwise similarity blocks: the port of the TPU kernel
``src/repro/kernels/pairwise.py`` ``pairwise_pallas``.

The CUDA kernel is ``csrc/pairwise.cu``: persistent blocks of an FP32 FFMA
tile product, the operands streamed through a ring of TMA loads (the x band
resident beside the y ring while d fits 2 boxes of 128 bytes, both streamed
box by box past that: ``ring.plan``), the rbf transform fused into the
epilogue and the finished tiles written by asynchronous TMA stores (see the
header there for its bound and design).  Every width and alignment runs
on it: ``operands`` hands rows TMA cannot read (a pitch or base off 16
bytes) over as a padded copy.  Its plain version is ``ref.pairwise_ref``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref, ring

launches = 0  # launches of csrc/pairwise.cu through this wrapper


class PWOperands(NamedTuple):
  """Checked kernel operands of one call and its ring plan."""
  x: ring.Feat
  y: ring.Feat
  batch: int | None  # None: neither operand is batched
  nx: int
  ny: int
  d: int
  ring: ring.Ring

  @property
  def copies(self) -> tuple[str, ...]:
    """The operands handed over as a padded copy."""
    return tuple(k for k, f in (("x", self.x), ("y", self.y)) if f.copied)


def operands(x: torch.Tensor, y: torch.Tensor) -> PWOperands:
  """Validate the operands, settle the batch layout and the ring plan, and
  copy any operand TMA cannot read as it is (``ring.features``; once when
  ``y is x``)."""
  build.check_feats("pairwise", x, y, rows_only=True)
  batch = build.batch_of("pairwise", (x, 2), (y, 2))
  nx, d = x.shape[-2:]
  ny, dy = y.shape[-2:]
  if dy != d:
    raise ValueError(f"pairwise: feature widths differ ({d} vs {dy})")
  b = 1 if batch is None else batch
  if max(nx, ny, b) >= 2**31:
    raise ValueError(f"pairwise: nx={nx}, ny={ny}, batch={b} past 2^31")
  fx = ring.features("pairwise", x)
  fy = fx if y is x else ring.features("pairwise", y)
  return PWOperands(fx, fy, batch, nx, ny, d,
                    ring.plan("pairwise", d, x.element_size()))


def pairwise(x: torch.Tensor, y: torch.Tensor, *, kernel: str = "rbf",
             h: float = 0.75) -> torch.Tensor:
  """Similarity matrix float32: (nx, d) x (ny, d) -> (nx, ny).

  Either operand may carry a leading batch axis, (B, n, d); a 2-D operand
  next to a batched one is shared by every batch entry, and the result is
  (B, nx, ny).  Tensors on the CPU take the plain version; CUDA tensors
  launch the kernel (bf16 or f32 inputs, f32 out) or raise.
  """
  if x.is_meta or y.is_meta:  # the dry run: kernels.meta
    from repro_torch.kernels import meta
    return meta.pairwise(x, y, kernel == "rbf")
  if not (x.is_cuda or y.is_cuda):
    return ref.pairwise_ref(x, y, kernel=kernel, h=h)
  global launches
  build.check_kernel("pairwise", kernel)
  build.check_width("pairwise", kernel, h)
  o = operands(x, y)
  b = 1 if o.batch is None else o.batch
  shape = (o.nx, o.ny) if o.batch is None else (b, o.nx, o.ny)
  out = torch.empty(shape, dtype=torch.float32, device=x.device)
  if out.numel() == 0:
    return out
  with torch.cuda.device(x.device):
    fn = build.entry("sm90_pairwise")
    err = fn(o.x.t.data_ptr(), o.y.t.data_ptr(), out.data_ptr(), b, o.nx,
             o.ny, o.d, o.x.ld, o.y.ld, o.x.bs, o.y.bs,
             int(x.dtype == torch.bfloat16), int(kernel == "rbf"),
             float(h * h), int(o.ring.streamed), build.stream_of(x))
  build.check(err, "sm90_pairwise")
  launches += 1
  ring.mode_launches[("pairwise", o.ring.mode)] += 1
  return out


def sim_mismatches(hh: float, device) -> int:
  """How many non-negative finite float32 values of the squared distance
  give a different rbf value (in any bit) from the kernels' division-free
  quotient (``csrc/sm90.cuh`` ``sim_rn``) than from ``tile.cuh``'s
  ``sim_of`` at width ``hh`` = h * h: an exhaustive check on the card, not
  a launch of the pairwise kernel."""
  blocks = 8 * torch.cuda.get_device_properties(device).multi_processor_count
  counts = torch.zeros(blocks, dtype=torch.int32, device=device)
  with torch.cuda.device(counts.device):
    err = build.entry("sm90_sim_mismatches")(
        float(hh), counts.data_ptr(), blocks, build.stream_of(counts))
  build.check(err, "sm90_sim_mismatches")
  return int(counts.sum())
