"""Fused facility-location select step: the port of the TPU kernel
``src/repro/kernels/select_top1.py`` ``facility_select_pallas``.

The greedy step only needs the masked top-1 of the facility gains, so the
kernel returns (best gain, index) per partition: candidates with ``ok`` false
score ``NEG``, the larger gain wins, ties go to the lowest index, and with no
feasible candidate the answer is (NEG, 0).  The CUDA kernel is
``csrc/facility.cu`` (the gains body with a top-1 epilogue and a
deterministic second stage in place of the TPU's sequential running best;
see the header there).  Its plain version is ``ref.facility_select_ref``.

The other select kernels of the TPU module (saturated coverage, information
gain, graph cut) belong to objectives that are not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.facility_gain import operands

launches = 0  # launches of csrc/facility.cu's select through this wrapper


def facility_select(eval_feats: torch.Tensor, cand_feats: torch.Tensor,
                    cov: torch.Tensor, eval_mask: torch.Tensor,
                    cand_ok: torch.Tensor, *, kernel: str = "linear",
                    h: float = 0.75):
  """Fused top-1 facility gain -> (best float32, int64 index), each () or
  (P,) when an operand carries a partition axis.

  Tensors on the CPU take the plain version; CUDA tensors launch the
  kernel or raise.
  """
  if not (eval_feats.is_cuda or cand_feats.is_cuda):
    return ref.facility_select_ref(eval_feats, cand_feats, cov, eval_mask,
                                   cand_ok, kernel=kernel, h=h)
  global launches
  build.check_kernel("facility_select", kernel)
  o = operands("facility_select", eval_feats, cand_feats, cov, eval_mask,
               cand_ok)
  dev = o.ev.device
  n_tiles = -(-o.nc // build.TILE)
  if o.chunks == 1:
    part = None
    tile_best = torch.empty((o.n_part, n_tiles), dtype=torch.float32,
                            device=dev)
    tile_idx = torch.empty((o.n_part, n_tiles), dtype=torch.int32,
                           device=dev)
  else:
    part = torch.empty((o.chunks, o.n_part, o.nc), dtype=torch.float32,
                       device=dev)
    tile_best = tile_idx = None
  best = torch.empty((o.n_part,), dtype=torch.float32, device=dev)
  idx = torch.empty((o.n_part,), dtype=torch.int32, device=dev)
  with torch.cuda.device(dev):
    fn = build.entry("sm90_facility_select")
    err = fn(o.ev.data_ptr(), o.cd.data_ptr(), o.cov.data_ptr(),
             o.mask.data_ptr(), o.ok.data_ptr(), build.ptr(part),
             build.ptr(tile_best), build.ptr(tile_idx), best.data_ptr(),
             idx.data_ptr(), o.n_part, o.ne, o.nc, o.d,
             build.batch_stride(o.ev, 2),
             build.batch_stride(o.cd, 2), build.batch_stride(o.cov, 1),
             build.batch_stride(o.mask, 1), build.batch_stride(o.ok, 1),
             o.chunks, int(o.ev.dtype == torch.bfloat16),
             int(kernel == "rbf"), float(h * h), build.stream_of(o.ev))
  build.check(err, "sm90_facility_select")
  launches += 1
  idx = idx.to(torch.int64)
  if o.batch is None:
    return best[0], idx[0]
  return best, idx
