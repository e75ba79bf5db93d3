"""Plain PyTorch versions of the ported kernels (the port of kernels/ref.py).

These are the semantics every CUDA kernel in this package must reproduce.
The wrappers use them for tensors on the CPU, and the tests and
``chip_smoke.py`` hold the kernels against them on the card.  Every function
takes an optional leading batch axis; a 2-D operand next to a batched one is
shared by every batch entry.
"""
from __future__ import annotations

import torch

NEG = -1e30  # masked-gain floor shared with the select kernels / greedy loops


def masked_top1(scores: torch.Tensor, ok: torch.Tensor, floor: float = NEG):
  """Lowest-index argmax of the masked scores over the last axis.

  Returns (best masked score float32, int64 index), each with the leading
  axes of ``scores``.  With no feasible entry the result is (floor, 0).
  Written as a max followed by the least index attaining it, so ties never
  depend on ``torch.argmax``'s tie rule.
  """
  masked = torch.where(ok.bool(), scores.float(), floor)
  best = masked.max(dim=-1).values
  n = masked.shape[-1]
  iota = torch.arange(n, device=scores.device).expand_as(masked)
  idx = torch.where(masked == best.unsqueeze(-1), iota,
                    torch.full_like(iota, n)).min(dim=-1).values
  return best, idx


def _dot(ev: torch.Tensor, cd: torch.Tensor) -> torch.Tensor:
  """ev (..., ne, d) against cd (..., nc, d) -> (..., ne, nc)."""
  return ev @ cd.transpose(-1, -2)


def _sim(ev: torch.Tensor, cd: torch.Tensor, kernel: str,
         h: float) -> torch.Tensor:
  if kernel == "linear":
    return _dot(ev, cd)
  if kernel == "rbf":
    e2 = torch.sum(ev * ev, dim=-1, keepdim=True)
    c2 = torch.sum(cd * cd, dim=-1, keepdim=True)
    d2 = torch.clamp_min(e2 - 2.0 * _dot(ev, cd) + c2.transpose(-1, -2), 0.0)
    return torch.exp(-d2 / (h * h))
  raise ValueError(kernel)


def pairwise_ref(x: torch.Tensor, y: torch.Tensor, *, kernel: str = "rbf",
                 h: float = 0.75) -> torch.Tensor:
  """Full similarity matrix (..., nx, ny) float32."""
  return _sim(x.float(), y.float(), kernel, h)


def facility_gain_ref(eval_feats: torch.Tensor, cand_feats: torch.Tensor,
                      cov: torch.Tensor, eval_mask: torch.Tensor, *,
                      kernel: str = "linear", h: float = 0.75) -> torch.Tensor:
  """Unnormalized marginal coverage gains (..., nc) float32.

  gain[j] = sum_i mask_i * max(sim(e_i, c_j) - cov_i, 0)
  """
  sim = _sim(eval_feats.float(), cand_feats.float(), kernel, h)
  inc = torch.clamp_min(sim - cov.float().unsqueeze(-1), 0.0)
  return (eval_mask.float().unsqueeze(-2) @ inc).squeeze(-2)


def facility_select_ref(eval_feats: torch.Tensor, cand_feats: torch.Tensor,
                        cov: torch.Tensor, eval_mask: torch.Tensor,
                        cand_ok: torch.Tensor, *, kernel: str = "linear",
                        h: float = 0.75):
  gains = facility_gain_ref(eval_feats, cand_feats, cov, eval_mask,
                            kernel=kernel, h=h)
  return masked_top1(gains, cand_ok)
