"""The kernels' meta routes: what a kernel wrapper does with tensors on
the ``meta`` device, where ``launch.dryrun`` runs a rank's code with
shapes alone.

Each route is a ``torch.library`` custom op whose fake implementation
gives the output's shape and dtype and whose FLOP formula is registered
with ``torch.utils.flop_counter``, so a ``FlopCounterMode`` counts the
kernel by the operation counts ``chip_smoke.py``'s bounds use: causal
attention 4 B H dh x the L (L + 1) / 2 live pairs (L^2 without the mask),
a similarity block 2 nx ny d (plus the rbf transform's 6 nx ny and the
norms' 2 (nx + ny) d), a facility / coverage gain pass (2 d + 3) ne nc
over its candidates, the relu column sums 3 rows x cols.  The plain
version is never traced on meta: it would count (and, at a 32k prefill,
materialise) the (L x L) scores.  A meta route is not a launch: the
wrappers' counts stay as they are.  The real implementations raise, since
only meta tensors reach the ops.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula


def _only_meta(name):
  raise RuntimeError(f"repro_torch::{name} is the dry run's meta route; a "
                     "real tensor goes to the kernel wrapper")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> torch.Tensor:
  _only_meta("flash_attention")


@flash_attention.register_fake
def _(q, k, v, causal):
  return torch.empty_like(q, memory_format=torch.contiguous_format)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, *args, out_shape=None,
                 **kwargs) -> int:
  b, h, length, dh = q_shape
  pairs = length * (length + 1) // 2 if causal else length * length
  return 4 * b * h * dh * pairs


@torch.library.custom_op("repro_torch::pairwise", mutates_args=())
def pairwise(x: torch.Tensor, y: torch.Tensor, rbf: bool) -> torch.Tensor:
  _only_meta("pairwise")


@pairwise.register_fake
def _(x, y, rbf):
  batch = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
  return x.new_empty((*batch, x.shape[-2], y.shape[-2]),
                     dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.pairwise)
def _pairwise_flops(x_shape, y_shape, rbf, *args, out_shape=None,
                    **kwargs) -> int:
  nx, d = x_shape[-2:]
  ny = y_shape[-2]
  b = 1
  for s in out_shape[:-2]:
    b *= s
  flops = 2 * b * nx * ny * d
  if rbf:
    flops += 2 * b * (nx + ny) * d + 6 * b * nx * ny
  return flops


@torch.library.custom_op("repro_torch::gain_pass", mutates_args=())
def gain_pass(cand: torch.Tensor, evals: torch.Tensor, rbf: bool,
              select: bool) -> list[torch.Tensor]:
  _only_meta("gain_pass")


@gain_pass.register_fake
def _(cand, evals, rbf, select):
  lead = torch.broadcast_shapes(cand.shape[:-2], evals.shape[:-2])
  if select:
    return [cand.new_empty(lead, dtype=torch.float32),
            cand.new_empty(lead, dtype=torch.int64)]
  return [cand.new_empty((*lead, cand.shape[-2]), dtype=torch.float32)]


@register_flop_formula(torch.ops.repro_torch.gain_pass)
def _gain_flops(cand_shape, evals_shape, rbf, select, *args, out_shape=None,
                **kwargs) -> int:
  nc, d = cand_shape[-2:]
  ne = evals_shape[-2]
  parts = 1
  for s in torch.broadcast_shapes(cand_shape[:-2], evals_shape[:-2]):
    parts *= s
  flops = (2 * d + 3) * parts * ne * nc
  if rbf:
    flops += 6 * parts * ne * nc + 2 * parts * (ne + nc) * d
  return flops


@torch.library.custom_op("repro_torch::relu_colsum", mutates_args=())
def relu_colsum(block: torch.Tensor, cov: torch.Tensor,
                cols: torch.Tensor | None) -> torch.Tensor:
  _only_meta("relu_colsum")


@relu_colsum.register_fake
def _(block, cov, cols):
  shape = (block.shape[0], block.shape[2]) if cols is None else cols.shape
  return block.new_empty(shape, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.relu_colsum)
def _colsum_flops(block_shape, cov_shape, cols_shape, *args, out_shape=None,
                  **kwargs) -> int:
  n = 1
  for s in out_shape:
    n *= s
  return 3 * block_shape[1] * n
