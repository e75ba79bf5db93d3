"""Saturated-coverage marginal gains: the port of the TPU kernel
``src/repro/kernels/coverage_gain.py`` ``coverage_gain_pallas``.

For every candidate j (per partition when batched), Lin & Bilmes'

    gain[j] = sum_i mask_i * [min(cover_i + s_ij, cap_i) - min(cover_i, cap_i)]

with s_ij = max(sim(e_i, c_j), 0).  The CUDA kernel is the coverage
epilogue of ``csrc/facility.cu`` (the facility kernel's tile product in
either ring mode, fixed-order reductions and eval-axis chunks, with the
saturation clamp in place of the facility relu; see the header there).
Its plain version is ``ref.coverage_gain_ref``.  Each operand may carry
the partition axis or be shared by every partition (batch stride 0), the
cap included.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref, ring
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
  dev = eval_feats.device
  part = torch.empty((o.plan.chunks, o.n_part, o.nc), dtype=torch.float32,
                     device=dev)
  gains = torch.empty((o.n_part, o.nc), dtype=torch.float32, device=dev)
  with torch.cuda.device(dev):
    fn = build.entry("sm90_coverage_gain")
    err = fn(*o.head(), part.data_ptr(), gains.data_ptr(), *o.dims(),
             o.plan.chunks, int(eval_feats.dtype == torch.bfloat16),
             int(kernel == "rbf"), float(h * h), int(o.ring.streamed),
             build.stream_of(eval_feats))
  build.check(err, "sm90_coverage_gain")
  launches += 1
  ring.mode_launches[("coverage_gain", o.ring.mode)] += 1
  return gains if o.batch is not None else gains[0]
