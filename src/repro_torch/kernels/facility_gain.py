"""Facility-location marginal gains: the port of the TPU kernel
``src/repro/kernels/facility_gain.py`` ``facility_gain_pallas``.

For every candidate j (per partition when batched)

    gain[j] = sum_i mask_i * max(sim(e_i, c_j) - cov_i, 0)

The CUDA kernel is ``csrc/facility.cu`` (stage 1 keeps the similarity tile
in registers and reduces it to column sums; stage 2 sums the eval-axis
chunks in a fixed order; see the header there for its bound and design).
Its plain version is ``ref.facility_gain_ref``.  The wrapper needs no
padding: the kernel masks ragged edges itself.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

launches = 0  # launches of csrc/facility.cu's gains through this wrapper


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
  return torch.cuda.get_device_properties(index).multi_processor_count


def eval_chunks(n_blocks: int, ne: int, device: torch.device) -> int:
  """How many fixed eval-axis ranges stage 1 splits into: 1 when candidate
  tiles x partitions already give every SM several blocks, else enough
  ranges for about four blocks per SM (at most one per eval tile).  A pure
  function of the shapes and the card, so the summation order -- and with
  it every result bit -- is fixed for a given call."""
  target = 4 * _sm_count(device.index if device.index is not None
                         else torch.cuda.current_device())
  if n_blocks >= target:
    return 1
  return max(1, min(-(-target // n_blocks), -(-ne // build.TILE)))


class FLOperands(NamedTuple):
  """Checked kernel operands of the facility and coverage kernels."""
  ev: torch.Tensor
  cd: torch.Tensor
  cov: torch.Tensor
  mask: torch.Tensor
  ok: torch.Tensor | None
  batch: int | None   # None: no operand is batched
  n_part: int
  ne: int
  nc: int
  d: int
  chunks: int
  cap: torch.Tensor | None = None  # saturated coverage only


def operands(name: str, eval_feats, cand_feats, cov, eval_mask,
             cand_ok=None, cap=None) -> FLOperands:
  """Validate the facility (or, with ``cap``, the saturated-coverage)
  kernels' operands and settle the batch layout.

  eval_feats (ne, d) | (P, ne, d); cand_feats (nc, d) | (P, nc, d);
  cov (the coverage's cover), cap, eval_mask (ne,) | (P, ne); cand_ok
  (nc,) | (P, nc).  Unbatched operands are shared by every partition
  (batch stride 0).
  """
  build.check_feats(name, eval_feats, cand_feats)
  dev = eval_feats.device
  ne, d = eval_feats.shape[-2:]
  nc, dc = cand_feats.shape[-2:]
  if dc != d:
    raise ValueError(f"{name}: feature widths differ ({d} vs {dc})")
  if ne < 1 or nc < 1:
    raise ValueError(f"{name}: needs at least one eval row and one "
                     f"candidate, got ne={ne}, nc={nc}")
  pairs = [(eval_feats, 2), (cand_feats, 2), (cov, 1), (eval_mask, 1)]
  if cand_ok is not None:
    pairs.append((cand_ok, 1))
  if cap is not None:
    pairs.append((cap, 1))
  for t, rank in pairs[2:]:
    if t.dim() not in (rank, rank + 1):
      raise ValueError(f"{name}: vector operand of shape {tuple(t.shape)}")
  batch = build.batch_of(name, *pairs)
  n_part = 1 if batch is None else batch
  if n_part > build.MAX_GRID:
    raise ValueError(f"{name}: {n_part} partitions exceed the grid")
  n_blocks = -(-nc // build.TILE) * n_part
  ok = None if cand_ok is None else build.vec(name, cand_ok, nc, dev)
  return FLOperands(eval_feats, cand_feats, build.vec(name, cov, ne, dev),
                    build.vec(name, eval_mask, ne, dev), ok, batch, n_part,
                    ne, nc, d, eval_chunks(n_blocks, ne, dev),
                    None if cap is None else build.vec(name, cap, ne, dev))


def facility_gain(eval_feats: torch.Tensor, cand_feats: torch.Tensor,
                  cov: torch.Tensor, eval_mask: torch.Tensor, *,
                  kernel: str = "linear", h: float = 0.75) -> torch.Tensor:
  """Unnormalized facility-location gains float32, (nc,) or (P, nc).

  Tensors on the CPU take the plain version; CUDA tensors launch the
  kernel or raise.
  """
  if not (eval_feats.is_cuda or cand_feats.is_cuda):
    return ref.facility_gain_ref(eval_feats, cand_feats, cov, eval_mask,
                                 kernel=kernel, h=h)
  global launches
  build.check_kernel("facility_gain", kernel)
  o = operands("facility_gain", eval_feats, cand_feats, cov, eval_mask)
  dev = o.ev.device
  part = torch.empty((o.chunks, o.n_part, o.nc), dtype=torch.float32,
                     device=dev)
  gains = torch.empty((o.n_part, o.nc), dtype=torch.float32, device=dev)
  with torch.cuda.device(dev):
    fn = build.entry("sm90_facility_gain")
    err = fn(o.ev.data_ptr(), o.cd.data_ptr(), o.cov.data_ptr(),
             o.mask.data_ptr(), part.data_ptr(), gains.data_ptr(), o.n_part,
             o.ne, o.nc, o.d, build.batch_stride(o.ev, 2),
             build.batch_stride(o.cd, 2), build.batch_stride(o.cov, 1),
             build.batch_stride(o.mask, 1), o.chunks,
             int(o.ev.dtype == torch.bfloat16), int(kernel == "rbf"),
             float(h * h), build.stream_of(o.ev))
  build.check(err, "sm90_facility_gain")
  launches += 1
  return gains if o.batch is not None else gains[0]
