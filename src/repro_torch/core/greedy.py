"""The standard greedy loop (the port of ``greedy`` in
``src/repro/core/greedy.py``, ``mode="standard"``).

Each step recomputes every candidate's marginal gain.  Through the
objective's fused ``select`` oracle the step is ONE kernel launch that
returns only (best gain, index); ``use_select=False`` takes the two-pass
path instead: the full gains vector from the ``gains`` oracle, then
``masked_top1``.  Both pick the lowest index among equal gains.

``jax.vmap`` over GreeDi's partitions becomes a leading partition axis: with
``cand_feats`` of shape (P, n, d) and a state carrying a (P, ...) axis, one
launch per step serves every partition.  The step loop makes no host sync
(no ``.item()``, no ``.cpu()``, no Python branch on a device value): a step
that finds nothing feasible is a no-op chosen by ``torch.where``, exactly
like the reference's masked ``fori_loop`` body.

The values trajectory is f(S_0) + cumsum(realized gains), computed once
after the loop (no-op steps record gain 0).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import constraints as C
from repro_torch.core.objectives import masked_top1


def with_backend(objective, backend: str | None):
  """Return ``objective`` with its gain-oracle backend overridden.

  No-op for ``backend=None`` and for objectives without a ``backend`` field,
  so callers can thread the override unconditionally.
  """
  if backend is None or not dataclasses.is_dataclass(objective):
    return objective
  if not any(f.name == "backend" for f in dataclasses.fields(objective)):
    return objective
  return dataclasses.replace(objective, backend=backend)


class GreedyResult(NamedTuple):
  idx: torch.Tensor     # ((P,) k) int64 selected candidate indices, -1 no-op
  feats: torch.Tensor   # ((P,) k, d) selected feature rows (0 for no-ops)
  gains: torch.Tensor   # ((P,) k) realized marginal gains
  state: Any            # final objective state
  values: torch.Tensor  # ((P,) k) f(S_t) trajectory
  rescans: torch.Tensor  # ((P,)) int32 lazy-mode rescans: 0 in this mode


def where_state(take: torch.Tensor, new, old):
  """Field by field ``torch.where(take, new, old)`` over a state NamedTuple
  (``take`` has the state's leading partition shape).  Fields the update
  returned unchanged are kept as they are."""
  fields = []
  for a, b in zip(new, old):
    if a is b:
      fields.append(b)
    else:
      t = take.reshape(take.shape + (1,) * (b.dim() - take.dim()))
      fields.append(torch.where(t, a, b))
  return type(old)(*fields)


def _rows(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
  """x[..., i, :] for one index per leading entry: x ((P,) n, d), i ((P,))
  -> ((P,) d), by a gather (no host sync)."""
  d = x.shape[-1]
  g = i.reshape(i.shape + (1, 1)).expand(*i.shape, 1, d)
  return torch.gather(x, -2, g).squeeze(-2)


def greedy(objective, state0, cand_feats: torch.Tensor, k_steps: int, *,
           cand_mask: torch.Tensor | None = None, constraint=None,
           meta: dict | None = None, mode: str = "standard",
           backend: str | None = None,
           use_select: bool = True) -> GreedyResult:
  """Select up to ``k_steps`` items from ``cand_feats`` maximizing
  ``objective``.

  Args:
    objective: an objective from core/objectives.py.
    state0: initial objective state (binds the evaluation set); it carries
      a leading partition axis when ``cand_feats`` does.
    cand_feats: (n, d) or (P, n, d) candidate rows.
    k_steps: number of greedy steps.
    cand_mask: ((P,) n) bool, False rows are never selectable (padding).
    constraint: hereditary system from core/constraints.py (None = plain
      cardinality k_steps).
    meta: per-item attribute tensors for the constraint.
    mode: only "standard" is ported.
    backend: optional gain-oracle backend override ("cuda" | "ref" |
      "auto") applied to the objective for this run.
    use_select: route each step through the objective's fused ``select``
      oracle; False takes the two-pass gains + ``masked_top1`` path.
  """
  if mode != "standard":
    raise NotImplementedError(
        f"greedy mode {mode!r}: the port runs mode='standard'; lazy, "
        "stochastic, random and cost_benefit come later (ROADMAP.md, "
        "modules to port, items 2 and 5)")
  objective = with_backend(objective, backend)
  n, d = cand_feats.shape[-2:]
  batch = cand_feats.shape[:-2]
  dev = cand_feats.device
  if cand_mask is None:
    cand_mask = torch.ones((*batch, n), dtype=torch.bool, device=dev)
  if meta is None:
    meta = C.default_meta(n, device=dev)
  if constraint is None:
    constraint = C.Cardinality(k_steps)
  select_path = use_select and hasattr(objective, "select")

  state = state0
  selected = torch.zeros((*batch, n), dtype=torch.bool, device=dev)
  cstate = constraint.init(dev).expand(batch).clone()
  idx, feats, gains = [], [], []
  for _ in range(k_steps):
    feasible = (~selected) & cand_mask & constraint.mask(cstate, meta)
    if select_path:
      chosen_gain, chosen = objective.select(state, cand_feats, feasible)
      chosen_gain = chosen_gain.float()
    else:
      g = objective.gains(state, cand_feats).float()
      _, chosen = masked_top1(g, feasible)
      chosen_gain = torch.gather(g, -1, chosen.unsqueeze(-1)).squeeze(-1)
    take = feasible.any(dim=-1)

    feat = _rows(cand_feats, chosen)
    state = where_state(take, objective.update(state, feat), state)
    cstate = torch.where(take, constraint.update(
        cstate, C.slice_meta(meta, chosen)), cstate)
    hit = torch.gather(selected, -1, chosen.unsqueeze(-1)) | take.unsqueeze(-1)
    selected = selected.scatter(-1, chosen.unsqueeze(-1), hit)
    idx.append(torch.where(take, chosen, -1))
    feats.append(torch.where(take.unsqueeze(-1), feat, 0.0))
    gains.append(torch.where(take, chosen_gain, 0.0))

  if k_steps == 0:
    idx = torch.zeros((*batch, 0), dtype=torch.int64, device=dev)
    feats = cand_feats.new_zeros((*batch, 0, d))
    gains = torch.zeros((*batch, 0), dtype=torch.float32, device=dev)
  else:
    idx = torch.stack(idx, dim=-1)
    feats = torch.stack(feats, dim=-2).to(cand_feats.dtype)
    gains = torch.stack(gains, dim=-1)
  values = objective.value(state0).float().unsqueeze(-1) + torch.cumsum(
      gains, dim=-1)
  return GreedyResult(idx, feats, gains, state, values,
                      torch.zeros(batch, dtype=torch.int32, device=dev))

