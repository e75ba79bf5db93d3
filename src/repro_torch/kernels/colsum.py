"""Masked relu column sums of a cached similarity block, the step of the
cached-similarity GreeDi engine (``core/greedi.greedi_sharded_fast``):

    out[b, c] = sum_i relu(s[b, i, col(b, c)] - cov[b, i])

over every column of s (a full pass: the standard round-1 step, the
round-2 and tree-level gains) or over the (m, t) column ids of a lazy
rescan.  No TPU kernel has this job: the reference computes it inline
(``src/repro/core/greedi.py:964``).

The CUDA kernel is ``csrc/colsum.cu`` (see the header there for its bound
and design): the rows split into chunks whose size depends on nl alone
(``ref.colsum_chunk_rows``), each chunk summed in ascending row order, the
chunks' sums added in ascending order in a second stage, no atomics.  A
column's sum therefore has the same bits in a full pass and in any
gathered call, which is what lets the lazy round 1 select exactly what the
standard one selects; it also equals the plain version
``ref.relu_colsum_ref`` in every bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0  # calls of csrc/colsum.cu through this wrapper (two kernels
              # a call when the rows span more than one chunk)


def chunks(nl: int) -> int:
  """Row chunks of a call over nl eval rows (stage 2 runs when > 1)."""
  return -(-nl // ref.colsum_chunk_rows(nl))


def relu_colsum(s: torch.Tensor, cov: torch.Tensor,
                cols: torch.Tensor | None = None) -> torch.Tensor:
  """Relu column sums float32, (m, nc) or, with (m, t) int64 ``cols``, (m,
  t).

  ``s`` is (m, nl, nc) float32 with contiguous rows and any row pitch and
  shard stride (a ``ring.pitched`` view reads as it is); ``cov`` is (m,
  nl); column ids lie in [0, nc) (one outside gives NaN in its sum).  Tensors on the CPU take the plain version; CUDA tensors
  launch the kernel or raise.
  """
  if s.is_meta:  # the dry run: kernels.meta
    from repro_torch.kernels import meta
    return meta.relu_colsum(s, cov, cols)
  if not s.is_cuda:
    return ref.relu_colsum_ref(s, cov, cols)
  global launches
  if s.dtype != torch.float32 or s.dim() != 3:
    raise ValueError(f"relu_colsum: s must be (m, nl, nc) float32, got "
                     f"{tuple(s.shape)} {s.dtype}")
  m, nl, nc = s.shape
  if nc > 1 and s.stride(2) != 1:
    raise ValueError(f"relu_colsum: s must have contiguous rows, got "
                     f"strides {s.stride()}")
  if cov.device != s.device or tuple(cov.shape) != (m, nl):
    raise ValueError(f"relu_colsum: cov of shape {tuple(cov.shape)} on "
                     f"{cov.device}, expected ({m}, {nl}) on {s.device}")
  cov = cov.to(torch.float32).contiguous()
  if cols is None:
    t, cols_bs = nc, 0
  else:
    if (cols.device != s.device or cols.dtype != torch.int64
        or cols.dim() != 2 or cols.shape[0] != m):
      raise ValueError(f"relu_colsum: cols must be ({m}, t) int64 on "
                       f"{s.device}, got {tuple(cols.shape)} {cols.dtype} "
                       f"on {cols.device}")
    if cols.shape[1] > 1 and cols.stride(1) != 1:
      cols = cols.contiguous()
    t, cols_bs = cols.shape[1], cols.stride(0)
  out = torch.empty((m, t), dtype=torch.float32, device=s.device)
  if out.numel() == 0:
    return out
  if nl == 0:
    return out.zero_()
  ch = ref.colsum_chunk_rows(nl)
  n_ch = chunks(nl)
  if m > build.MAX_GRID or n_ch > build.MAX_GRID:
    raise ValueError(f"relu_colsum: {m} shards or {n_ch} chunks exceed the "
                     "grid")
  part = (None if n_ch == 1 else
          torch.empty((m, n_ch, t), dtype=torch.float32, device=s.device))
  ld = s.stride(1) if nl > 1 else nc
  bs = s.stride(0) if m > 1 else 0
  with torch.cuda.device(s.device):
    fn = build.entry("sm90_relu_colsum")
    err = fn(s.data_ptr(), cov.data_ptr(), build.ptr(cols), build.ptr(part),
             out.data_ptr(), m, nl, nc, t, ld, bs, cols_bs, ch,
             build.stream_of(s))
  build.check(err, "sm90_relu_colsum")
  launches += 1
  return out
