"""Saturated-coverage marginal gains: the port of the TPU kernel
``src/repro/kernels/coverage_gain.py`` ``coverage_gain_pallas``.

For every candidate j (per partition when batched), Lin & Bilmes'

    gain[j] = sum_i mask_i * [min(cover_i + s_ij, cap_i) - min(cover_i, cap_i)]

with s_ij = max(sim(e_i, c_j), 0).  The CUDA kernel is the coverage
epilogue of ``csrc/facility.cu`` (the facility kernel's tile product on
either of its paths, fixed-order reductions and eval-axis chunks, with the
saturation clamp in place of the facility relu; see the header there).
Its plain version is ``ref.coverage_gain_ref``.  Each operand may carry
the partition axis or be shared by every partition (batch stride 0), the
cap included.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.facility_gain import operands

launches = 0  # launches of csrc/facility.cu's coverage gains


def coverage_gain(eval_feats: torch.Tensor, cand_feats: torch.Tensor,
                  cover: torch.Tensor, cap: torch.Tensor,
                  eval_mask: torch.Tensor, *, kernel: str = "linear",
                  h: float = 0.75) -> torch.Tensor:
  """Unnormalized saturated-coverage gains float32, (nc,) or (P, nc).

  Tensors on the CPU take the plain version; CUDA tensors launch the
  kernel or raise.
  """
  if not (eval_feats.is_cuda or cand_feats.is_cuda):
    return ref.coverage_gain_ref(eval_feats, cand_feats, cover, cap,
                                 eval_mask, kernel=kernel, h=h)
  global launches
  build.check_kernel("coverage_gain", kernel)
  build.check_width("coverage_gain", kernel, h)
  o = operands("coverage_gain", eval_feats, cand_feats, cover, eval_mask,
               cap=cap)
  dev = o.ev.device
  part = torch.empty((o.plan.chunks, o.n_part, o.nc), dtype=torch.float32,
                     device=dev)
  gains = torch.empty((o.n_part, o.nc), dtype=torch.float32, device=dev)
  with torch.cuda.device(dev):
    fn = build.entry("sm90_coverage_gain")
    err = fn(o.ev.data_ptr(), o.cd.data_ptr(), o.cov.data_ptr(),
             o.cap.data_ptr(), o.mask.data_ptr(), part.data_ptr(),
             gains.data_ptr(), o.n_part, o.ne, o.nc, o.d,
             build.batch_stride(o.ev, 2), build.batch_stride(o.cd, 2),
             build.batch_stride(o.cov, 1), build.batch_stride(o.cap, 1),
             build.batch_stride(o.mask, 1), o.plan.chunks,
             int(o.ev.dtype == torch.bfloat16), int(kernel == "rbf"),
             float(h * h), build.stream_of(o.ev))
  build.check(err, "sm90_coverage_gain")
  launches += 1
  return gains if o.batch is not None else gains[0]
