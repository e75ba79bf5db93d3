"""Pairwise similarity blocks: the port of the TPU kernel
``src/repro/kernels/pairwise.py`` ``pairwise_pallas``.

The CUDA kernel is ``csrc/pairwise.cu`` (an FP32 FFMA tile product with the
rbf transform fused into the epilogue; see the header there for its bound
and design).  Its plain version is ``ref.pairwise_ref``.
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
  build.check_feats("pairwise", x, y)
  batch = build.batch_of("pairwise", (x, 2), (y, 2))
  nx, d = x.shape[-2:]
  ny, dy = y.shape[-2:]
  if dy != d:
    raise ValueError(f"pairwise: feature widths differ ({d} vs {dy})")
  b = 1 if batch is None else batch
  if -(-nx // build.TILE) > build.MAX_GRID or b > build.MAX_GRID:
    raise ValueError(f"pairwise: grid too large for nx={nx}, batch={b}")
  shape = (nx, ny) if batch is None else (b, nx, ny)
  out = torch.empty(shape, dtype=torch.float32, device=x.device)
  if out.numel() == 0:
    return out
  with torch.cuda.device(x.device):
    fn = build.entry("sm90_pairwise")
    err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), b, nx, ny, d,
             build.batch_stride(x, 2), build.batch_stride(y, 2),
             int(x.dtype == torch.bfloat16), int(kernel == "rbf"),
             float(h * h), build.stream_of(x))
  build.check(err, "sm90_pairwise")
  launches += 1
  return out
