"""Pairwise similarity blocks: the port of the TPU kernel
``src/repro/kernels/pairwise.py`` ``pairwise_pallas``.

The CUDA kernel is ``csrc/pairwise.cu``: persistent blocks of an FP32 FFMA
tile product, the y tiles streamed through a ring of TMA loads beside a
resident x band, the rbf transform fused into the epilogue and the finished
tiles written by asynchronous TMA stores; operands TMA does not take (rows
not a multiple of 16 bytes, d past 2 boxes of 128 bytes, misaligned bases)
go to the same file's tile kernel, one 128 x 128 tile a block (see the
header there for its bound and design).  Its plain version is
``ref.pairwise_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0  # launches of csrc/pairwise.cu through this wrapper


def pairwise(x: torch.Tensor, y: torch.Tensor, *, kernel: str = "rbf",
             h: float = 0.75) -> torch.Tensor:
  """Similarity matrix float32: (nx, d) x (ny, d) -> (nx, ny).

  Either operand may carry a leading batch axis, (B, n, d); a 2-D operand
  next to a batched one is shared by every batch entry, and the result is
  (B, nx, ny).  Tensors on the CPU take the plain version; CUDA tensors
  launch the kernel (bf16 or f32 inputs, f32 out) or raise.
  """
  if not (x.is_cuda or y.is_cuda):
    return ref.pairwise_ref(x, y, kernel=kernel, h=h)
  global launches
  build.check_kernel("pairwise", kernel)
  build.check_width("pairwise", kernel, h)
  build.check_feats("pairwise", x, y)
  batch = build.batch_of("pairwise", (x, 2), (y, 2))
  nx, d = x.shape[-2:]
  ny, dy = y.shape[-2:]
  if dy != d:
    raise ValueError(f"pairwise: feature widths differ ({d} vs {dy})")
  b = 1 if batch is None else batch
  if max(nx, ny, b) >= 2**31:
    raise ValueError(f"pairwise: nx={nx}, ny={ny}, batch={b} past 2^31")
  shape = (nx, ny) if batch is None else (b, nx, ny)
  out = torch.empty(shape, dtype=torch.float32, device=x.device)
  if out.numel() == 0:
    return out
  with torch.cuda.device(x.device):
    if not takes_tma(x, y) and (-(-nx // build.TILE) > build.MAX_GRID or
                                b > build.MAX_GRID):
      raise ValueError(f"pairwise: grid too large for nx={nx}, batch={b} "
                       "(operands the TMA path does not take)")
    fn = build.entry("sm90_pairwise")
    err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), b, nx, ny, d,
             build.batch_stride(x, 2), build.batch_stride(y, 2),
             int(x.dtype == torch.bfloat16), int(kernel == "rbf"),
             float(h * h), build.stream_of(x))
  build.check(err, "sm90_pairwise")
  launches += 1
  return out


def takes_tma(x: torch.Tensor, y: torch.Tensor) -> bool:
  """Whether these operands take the persistent kernel, which loads them
  by TMA (the resident x band and the y ring), rather than the tile
  kernel: d * itemsize a multiple of 16 bytes, at most 2 boxes of 128
  bytes of d, 16-byte aligned bases."""
  fn = build.entry("sm90_pairwise_tma")
  return bool(fn(x.data_ptr(), y.data_ptr(), x.shape[-1],
                 int(x.dtype == torch.bfloat16)))


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
