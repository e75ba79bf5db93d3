"""Facility location as a fixed-shape state machine (the port of the
``FacilityLocation`` part of ``src/repro/core/objectives.py``).

The interface is the reference's:

    state = obj.init(eval_feats, eval_mask)      # f restricted to the eval set
    gains = obj.gains(state, cand_feats)         # f(S+v) - f(S), every v
    best, idx = obj.select(state, cand_feats, feasible)   # fused top-1 step
    state = obj.update(state, chosen_feat)       # S <- S + {v*}
    value = obj.value(state)                     # f(S)

A ``jax.vmap`` over GreeDi's partitions becomes a leading partition axis
written out: ``cov``/``value`` may carry one (P, ...) axis, and the
evaluation features/mask either carry it too or are shared by every
partition.  Gains and select route through kernels/dispatch.py by the
``backend`` field ("cuda" | "ref" | "auto").
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.kernels import dispatch
# The masked-gain floor and the lowest-index masked argmax are defined ONCE,
# in kernels/ref.py, and re-exported as the core layer's select path.
from repro_torch.kernels.ref import NEG, masked_top1  # noqa: F401


def _kernel_h(kernel_kwargs: tuple) -> float:
  """Bandwidth for the fused oracles (ignored by the linear kernel)."""
  return float(dict(kernel_kwargs).get("h", 0.75))


def _sim_column(eval_feats: torch.Tensor, feat: torch.Tensor, kernel: str,
                h: float) -> torch.Tensor:
  """sim(e_i, feat) for every eval row: eval_feats ((P,) ne, d) against
  feat ((P,) d) -> ((P,) ne).  The formulas of objectives.py linear_kernel
  and rbf_kernel."""
  if eval_feats.dim() == 2 and feat.dim() == 2:  # shared eval set
    dot = feat @ eval_feats.T
  else:
    dot = (eval_feats @ feat.unsqueeze(-1)).squeeze(-1)
  if kernel == "linear":
    return dot
  x2 = torch.sum(eval_feats * eval_feats, dim=-1)
  y2 = torch.sum(feat * feat, dim=-1, keepdim=True)
  d2 = torch.clamp_min(x2 - 2.0 * dot + y2, 0.0)
  return torch.exp(-d2 / (h * h))


class FLState(NamedTuple):
  """cov[i] = max_{s in S} sim(i, s), clipped below at the phantom baseline."""
  cov: torch.Tensor          # ((P,) n_eval) current best similarity
  eval_feats: torch.Tensor   # ((P,) n_eval, d), shared when 2-D
  eval_mask: torch.Tensor    # ((P,) n_eval) 1.0 for live eval rows
  value: torch.Tensor        # ((P,)) f(S)


@dataclasses.dataclass(frozen=True)
class FacilityLocation:
  """f(S) = mean_i [ max_{s in S} sim(e_i, s) - baseline ]_+ over the live
  eval rows, with a linear or rbf similarity (``kernel_kwargs=(("h", h),)``).
  Monotone, nonnegative, decomposable (Sec. 4.5 of the paper).
  """
  kernel: str = "linear"
  kernel_kwargs: tuple = ()
  baseline: float = 0.0
  backend: str = "auto"

  def __post_init__(self):
    if self.kernel not in dispatch.FUSED_SIMS:
      raise NotImplementedError(
          f"FacilityLocation kernel {self.kernel!r}: the port implements "
          f"{dispatch.FUSED_SIMS}; other similarities come with the "
          "remaining objectives (ROADMAP.md, modules to port, item 7)")

  @property
  def h(self) -> float:
    return _kernel_h(self.kernel_kwargs)

  def init(self, eval_feats: torch.Tensor,
           eval_mask: torch.Tensor | None = None) -> FLState:
    if eval_mask is None:
      eval_mask = torch.ones(eval_feats.shape[:-1], dtype=eval_feats.dtype,
                             device=eval_feats.device)
    cov = torch.full(eval_feats.shape[:-1], self.baseline,
                     dtype=eval_feats.dtype, device=eval_feats.device)
    value = torch.zeros(eval_feats.shape[:-2], dtype=eval_feats.dtype,
                        device=eval_feats.device)
    return FLState(cov, eval_feats, eval_mask, value)

  def broadcast(self, state: FLState, n_part: int) -> FLState:
    """The same state for each of ``n_part`` partitions: cov and value get a
    leading axis, the evaluation set stays shared (stride 0 in the kernels).
    The counterpart of vmapping over a closed-over state."""
    return FLState(state.cov.expand(n_part, -1).clone(), state.eval_feats,
                   state.eval_mask, state.value.expand(n_part).clone())

  def _denom(self, state: FLState) -> torch.Tensor:
    return torch.clamp_min(torch.sum(state.eval_mask, dim=-1), 1.0)

  def gains(self, state: FLState, cand_feats: torch.Tensor) -> torch.Tensor:
    fn = dispatch.resolve("facility_gain", self.backend)
    g = fn(state.eval_feats, cand_feats, state.cov, state.eval_mask,
           kernel=self.kernel, h=self.h)
    return g / self._denom(state).unsqueeze(-1)

  def select(self, state: FLState, cand_feats: torch.Tensor,
             feasible: torch.Tensor):
    """Fused select step: (best normalized gain, int64 candidate index)."""
    fn = dispatch.resolve_select("facility_gain", self.backend)
    best, idx = fn(state.eval_feats, cand_feats, state.cov, state.eval_mask,
                   feasible, kernel=self.kernel, h=self.h)
    return best / self._denom(state), idx

  def update(self, state: FLState, feat: torch.Tensor) -> FLState:
    sim = _sim_column(state.eval_feats, feat, self.kernel, self.h)
    new_cov = torch.maximum(state.cov, sim)
    gain = torch.sum((new_cov - state.cov) * state.eval_mask, dim=-1)
    return FLState(new_cov, state.eval_feats, state.eval_mask,
                   state.value + gain / self._denom(state))

  def value(self, state: FLState) -> torch.Tensor:
    return state.value

  def partial_stats(self, state: FLState, cand_feats: torch.Tensor):
    """(sum-of-gains ((P,) nc), live count ((P,))): summing both over shards
    reproduces the global objective exactly."""
    fn = dispatch.resolve("facility_gain", self.backend)
    part = fn(state.eval_feats, cand_feats, state.cov, state.eval_mask,
              kernel=self.kernel, h=self.h)
    return part, torch.sum(state.eval_mask, dim=-1)
