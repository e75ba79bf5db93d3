"""The greedy loops (the port of ``greedy``, ``best_of_knapsack`` and
``greedy_over_partitions`` in ``src/repro/core/greedy.py``).

* ``standard`` recomputes every candidate's marginal gain each step.
  Through the objective's fused ``select`` oracle the step is ONE kernel
  launch that returns only (best gain, index); ``use_select=False`` takes
  the two-pass path instead: the full gains vector from the ``gains``
  oracle, then ``masked_top1``.  Both pick the lowest index among equal
  gains.
* ``lazy`` is Minoux's lazy greedy at tile granularity (``_greedy_lazy``):
  stale gains are upper bounds by submodularity, each step sorts the
  candidates by bound and refreshes bound-sorted tiles until the next
  tile's head bound cannot beat the running best.  Exactly ``standard``'s
  selection (up to f32 near-ties, whose gains the two modes sum in
  different orders); objectives that declare ``monotone = False`` or
  ``supports_lazy = False`` fall back to ``standard``.
* ``random`` is RandomGreedy (Buchbinder et al. 2014) for non-monotone f:
  each step picks uniformly among the top min(k, n) feasible gains.
* ``stochastic`` is "lazier than lazy" (Mirzasoleiman et al. 2015): each
  step scores only a random subset, each item kept with ``sample_frac``.
* ``cost_benefit`` is the knapsack greedy by gain / cost (Sec. 5.2);
  ``best_of_knapsack`` takes the better of it and ``standard``.

Randomness comes from explicit draw tables (``draws``), as the partition
comes from an explicit ``perm``: the reference's ``jax.random`` bits cannot
be reproduced, so a test builds the table from the reference's own key
chain, and the port's own path fills it from a ``torch.Generator`` before
the loop (``draw_table``).  The step loop makes no host sync (no
``.item()``, no ``.cpu()``, no Python branch on a device value, no
``torch.randint`` with a device bound): a step that finds nothing feasible
is a no-op chosen by ``torch.where``, like the reference's masked
``fori_loop`` body.

``jax.vmap`` over GreeDi's partitions becomes a leading partition axis: with
``cand_feats`` of shape (P, n, d) and a state carrying a (P, ...) axis, one
launch per step (per rescan, in lazy mode) serves every partition.

The values trajectory is f(S_0) + cumsum(realized gains), computed once
after the loop (no-op steps record gain 0).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import constraints as C
from repro_torch.core.objectives import NEG, masked_top1
from repro_torch.kernels import autotune, ring

MODES = ("standard", "lazy", "random", "stochastic", "cost_benefit")

# host syncs of the lazy rescan loops since the last reset: one per rescan
# iteration (all partitions together), the loop's only device-to-host reads
lazy_syncs = 0


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
  rescans: torch.Tensor  # ((P,)) int32 tiles rescanned by mode="lazy" over
  #                        all steps (0 in standard mode, where every step
  #                        scans all n); pruning = rescans / (steps * tiles)


def where_state(take: torch.Tensor, new, old):
  """Field by field ``torch.where(take, new, old)`` over a state NamedTuple,
  nested states included (``take`` has the state's leading partition shape,
  or none).  Fields the update returned unchanged are kept as they are."""
  if new is old:
    return old
  if isinstance(old, tuple):
    fields = [where_state(take, a, b) for a, b in zip(new, old)]
    return type(old)(*fields) if hasattr(old, "_fields") else tuple(fields)
  t = take.reshape(take.shape + (1,) * (old.dim() - take.dim()))
  return torch.where(t, new, old)


def kernel_rows(objective, cand_feats: torch.Tensor) -> torch.Tensor:
  """``cand_feats`` as the objective's kernels read them with no copy a
  call (its ``kernel_rows``, where it has one), taken once a run."""
  fn = getattr(objective, "kernel_rows", None)
  return cand_feats if fn is None else fn(cand_feats)


def _rows(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
  """x[..., i, :] for one index per leading entry: x ((P,) n, d), i ((P,))
  -> ((P,) d), by a gather (no host sync)."""
  d = x.shape[-1]
  g = i.reshape(i.shape + (1, 1)).expand(*i.shape, 1, d)
  return torch.gather(x, -2, g).squeeze(-2)


class _Trace(NamedTuple):
  """The loop's carried selection: the objective and constraint states,
  the selected mask, and the per-step outputs collected so far."""
  state: Any
  cstate: torch.Tensor
  selected: torch.Tensor
  idx: list
  feats: list
  gains: list


def _apply(objective, tr: _Trace, cand_feats, meta, constraint, chosen,
           chosen_gain, feasible, stop_nonpositive) -> _Trace:
  """Take candidate ``chosen`` (an index per partition) when anything is
  feasible (and, with ``stop_nonpositive``, its gain is positive); a step
  that takes nothing is a no-op recorded as (-1, zeros, 0)."""
  take = feasible.any(dim=-1)
  if stop_nonpositive:
    take = take & (chosen_gain > 0.0)
  feat = _rows(cand_feats, chosen)
  state = where_state(take, objective.update(tr.state, feat), tr.state)
  cstate = where_state(take, constraint.update(
      tr.cstate, C.slice_meta(meta, chosen)), tr.cstate)
  hit = torch.gather(tr.selected, -1, chosen.unsqueeze(-1)) | take.unsqueeze(
      -1)
  selected = tr.selected.scatter(-1, chosen.unsqueeze(-1), hit)
  return _Trace(state, cstate, selected,
                tr.idx + [torch.where(take, chosen, -1)],
                tr.feats + [torch.where(take.unsqueeze(-1), feat, 0.0)],
                tr.gains + [torch.where(take, chosen_gain, 0.0)])


def _result(objective, state0, tr: _Trace, k_steps, batch, d, dtype, dev,
            rescans) -> GreedyResult:
  if k_steps == 0:
    idx = torch.zeros((*batch, 0), dtype=torch.int64, device=dev)
    feats = torch.zeros((*batch, 0, d), dtype=dtype, device=dev)
    gains = torch.zeros((*batch, 0), dtype=torch.float32, device=dev)
  else:
    idx = torch.stack(tr.idx, dim=-1)
    feats = torch.stack(tr.feats, dim=-2).to(dtype)
    gains = torch.stack(tr.gains, dim=-1)
  values = objective.value(state0).float().unsqueeze(-1) + torch.cumsum(
      gains, dim=-1)
  return GreedyResult(idx, feats, gains, tr.state, values, rescans)


def draw_table(mode: str, rng: torch.Generator | None, batch: tuple,
               k_steps: int, n: int, *, sample_frac: float | None = None,
               device=None) -> torch.Tensor | None:
  """The port's own draws for ``mode``, made before the loop.

  * ``random``: a ((P,) k, kk) int64 table of ranks, kk = min(k, n); step t
    picks rank ``table[t, v - 1]`` among its v feasible top entries, with
    ``table[t, v - 1] = floor(u_t * v)`` for one uniform u_t per step.
  * ``stochastic``: a ((P,) k, n) bool keep table, each entry True with
    probability ``sample_frac``.
  * any other mode: None.

  ``rng`` None means a generator seeded 0 on ``device`` (the reference
  defaults to ``PRNGKey(0)``).
  """
  if mode not in ("random", "stochastic"):
    return None
  if rng is None:
    rng = torch.Generator(device=device).manual_seed(0)
  if mode == "random":
    kk = min(k_steps, n)
    u = torch.rand((*batch, k_steps, 1), generator=rng,
                   device=rng.device).to(device)
    v = torch.arange(1, kk + 1, device=device)
    return torch.minimum(torch.floor(u * v).to(torch.int64), v - 1)
  if sample_frac is None:
    raise ValueError("stochastic mode needs sample_frac")
  keep = torch.rand((*batch, k_steps, n), generator=rng, device=rng.device)
  return (keep < sample_frac).to(device)


def _check_draws(mode, draws, batch, k_steps, n) -> torch.Tensor:
  want = ((*batch, k_steps, min(k_steps, n)) if mode == "random"
          else (*batch, k_steps, n))
  if tuple(draws.shape) != want:
    raise ValueError(f"greedy mode {mode!r}: draws of shape "
                     f"{tuple(draws.shape)}, expected {want}")
  return draws


def greedy(objective, state0, cand_feats: torch.Tensor, k_steps: int, *,
           cand_mask: torch.Tensor | None = None, constraint=None,
           meta: dict | None = None, mode: str = "standard",
           rng: torch.Generator | None = None,
           sample_frac: float | None = None,
           draws: torch.Tensor | None = None,
           stop_nonpositive: bool = False, backend: str | None = None,
           use_select: bool = True, lazy_tile: int | None = None,
           warm_bounds: torch.Tensor | None = None) -> GreedyResult:
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
    meta: per-item attribute tensors for the constraint (and ``cost`` for
      mode="cost_benefit").
    mode: "standard" | "lazy" | "random" | "stochastic" | "cost_benefit".
      "lazy" is the tile-bound lazy greedy (monotone objectives only,
      others fall back to "standard").
    rng: generator of the port's own draws (``draw_table``) when
      ``draws`` is not given.
    sample_frac: stochastic mode's per-step inclusion probability; the
      canonical choice is (1/k) ln(1/eps).
    draws: explicit draw table of mode "random" (((P,) k, min(k, n)) int
      ranks) or "stochastic" (((P,) k, n) bool keeps); see ``draw_table``.
    stop_nonpositive: treat steps whose best gain is <= 0 as no-ops
      (required for non-monotone objectives; harmless for monotone ones).
    backend: optional gain-oracle backend override ("cuda" | "ref" |
      "auto") applied to the objective for this run.
    use_select: route standard steps through the objective's fused
      ``select`` oracle; False takes the two-pass gains + ``masked_top1``
      path.  Lazy rescans always use the gains oracle (the refreshed tile's
      gains are the new bounds).
    lazy_tile: rescore tile of mode="lazy" (default ``autotune.lazy_tile``).
    warm_bounds: optional ((P,) n) upper bounds on every candidate's
      empty-set gain (the selection service's carried table); mode="lazy"
      then seeds its bounds from them and skips the step-0 full pass.  The
      selection is the cold run's as long as they really are upper bounds.
      Ignored by every other mode.
  """
  if mode not in MODES:
    raise ValueError(f"greedy mode {mode!r} not in {MODES}")
  objective = with_backend(objective, backend)
  if mode == "lazy" and not (getattr(objective, "monotone", True)
                             and getattr(objective, "supports_lazy", True)):
    mode = "standard"  # the lazy bounds hold only for monotone f
  k_max = getattr(objective, "k_max", None)
  if k_max is not None and k_steps > k_max:
    raise ValueError(f"greedy: {k_steps} steps exceed the objective's "
                     f"k_max = {k_max} selection buffer")
  n, d = cand_feats.shape[-2:]
  batch = cand_feats.shape[:-2]
  dev = cand_feats.device
  if cand_mask is None:
    cand_mask = torch.ones((*batch, n), dtype=torch.bool, device=dev)
  if meta is None:
    meta = C.default_meta(n, device=dev)
  if constraint is None:
    constraint = C.Cardinality(k_steps)
  if mode == "cost_benefit" and "cost" not in meta:
    raise ValueError("cost_benefit mode needs meta['cost']")
  if mode == "lazy":
    return _greedy_lazy(objective, state0, cand_feats, k_steps,
                        cand_mask=cand_mask, constraint=constraint,
                        meta=meta, stop_nonpositive=stop_nonpositive,
                        tile=lazy_tile, warm_bounds=warm_bounds)
  if draws is None:
    draws = draw_table(mode, rng, tuple(batch), k_steps, n,
                       sample_frac=sample_frac, device=dev)
  elif mode in ("random", "stochastic"):
    draws = torch.as_tensor(draws, device=dev)
    draws = _check_draws(mode, draws.to(torch.int64 if mode == "random"
                                        else torch.bool), batch, k_steps, n)
  select_path = (mode == "standard" and use_select
                 and hasattr(objective, "select"))
  kk = min(k_steps, n)
  cand_feats = kernel_rows(objective, cand_feats)

  tr = _Trace(state0, C.init_batched(constraint, tuple(batch), dev),
              torch.zeros((*batch, n), dtype=torch.bool, device=dev),
              [], [], [])
  for t in range(k_steps):
    feasible = (~tr.selected) & cand_mask & constraint.mask(tr.cstate, meta)
    if select_path:
      chosen_gain, chosen = objective.select(tr.state, cand_feats, feasible)
      chosen_gain = chosen_gain.float()
    else:
      g = objective.gains(tr.state, cand_feats).float()
      score = (g / torch.clamp_min(meta["cost"].to(torch.float32), 1e-12)
               if mode == "cost_benefit" else g)
      if mode == "stochastic":
        keep = draws[..., t, :]
        # never mask out everything: fall back to the full set when the
        # sample misses every feasible item (the reference's rule)
        hit = (keep & feasible).any(dim=-1, keepdim=True)
        feasible = feasible & (keep | ~hit)
      if mode == "random":
        masked = torch.where(feasible, score, NEG)
        # the top kk, lower index first among equal values (lax.top_k's
        # order; torch.topk promises none for ties)
        top_vals, top_idx = torch.sort(masked, dim=-1, descending=True,
                                       stable=True)
        top_vals, top_idx = top_vals[..., :kk], top_idx[..., :kk]
        num_valid = torch.clamp_min((top_vals > NEG / 2).sum(dim=-1), 1)
        rank = torch.gather(draws[..., t, :], -1,
                            (num_valid - 1).unsqueeze(-1))
        chosen = torch.gather(top_idx, -1, rank).squeeze(-1)
      else:
        _, chosen = masked_top1(score, feasible)
      chosen_gain = torch.gather(g, -1, chosen.unsqueeze(-1)).squeeze(-1)
    tr = _apply(objective, tr, cand_feats, meta, constraint, chosen,
                chosen_gain, feasible, stop_nonpositive)
  return _result(objective, state0, tr, k_steps, batch, d, cand_feats.dtype,
                 dev, torch.zeros(batch, dtype=torch.int32, device=dev))


def best_of_knapsack(objective, state0, cand_feats: torch.Tensor,
                     k_steps: int, *, meta: dict, budget: float,
                     cand_mask: torch.Tensor | None = None,
                     backend: str | None = None) -> GreedyResult:
  """max(plain greedy, cost-benefit greedy) under a knapsack: the
  (1 - 1/sqrt(e))-approximation of Krause & Guestrin (2005b) (Sec. 5.2).
  Per partition when the candidates carry a partition axis; ties go to the
  plain greedy, as in the reference."""
  kn = C.Knapsack(budget)
  a = greedy(objective, state0, cand_feats, k_steps, cand_mask=cand_mask,
             constraint=kn, meta=meta, mode="standard", backend=backend)
  b = greedy(objective, state0, cand_feats, k_steps, cand_mask=cand_mask,
             constraint=kn, meta=meta, mode="cost_benefit", backend=backend)
  obj = with_backend(objective, backend)
  pick_a = obj.value(a.state) >= obj.value(b.state)
  return GreedyResult(*(where_state(pick_a, x, y) for x, y in zip(a, b)))


def greedy_over_partitions(objective_init, objective,
                           feats_parts: torch.Tensor, k_steps: int, **kw):
  """The greedy loop over an (m, n/m, d) partition stack, all partitions in
  one batched run (the reference vmaps over them).

  Single-device form of GreeDi round 1 (tests and the paper-figure runs).
  ``objective_init`` maps the whole stack to the initial state with a
  leading partition axis (binding local evaluation for the decomposable
  mode); ``kw`` goes to ``greedy`` (draw tables then carry the partition
  axis too).
  """
  return greedy(objective, objective_init(feats_parts), feats_parts,
                k_steps, **kw)


def _pad_last(x: torch.Tensor, n: int, value, dim: int = -1) -> torch.Tensor:
  """``x`` padded with ``value`` to length n along ``dim``."""
  pad = n - x.shape[dim]
  if pad == 0:
    return x
  shape = list(x.shape)
  shape[dim] = pad
  return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                  device=x.device)], dim=dim)


def _greedy_lazy(objective, state0, cand_feats: torch.Tensor, k_steps: int,
                 *, cand_mask, constraint, meta, stop_nonpositive: bool,
                 tile: int | None,
                 warm_bounds: torch.Tensor | None) -> GreedyResult:
  """Tile-bound lazy greedy (mode="lazy"; the port of ``_greedy_lazy`` in
  src/repro/core/greedy.py): exact, but rescans few tiles.

  ``stale[i]`` holds the last gain computed for candidate i, an upper bound
  on its current gain by submodularity.  Cold, step 0 is one full gains
  pass that selects and seeds ``stale``; with ``warm_bounds`` ``stale`` is
  seeded from them (padding and holes enter at NEG) and step 0 is a rescan
  like every later step.  A step sorts the feasible candidates by bound
  (descending, stable: equal bounds keep candidate order) and rescans
  tiles of that order: gather the tile's rows, refresh their gains in one
  ``gains`` call, and go on while the next tile's head bound is >= the
  running best; score ties go to the lowest candidate index, so the pick
  is ``standard``'s.

  The reference runs one ``while_loop`` per partition.  Here the P
  partitions rescan together: each gathers its own bound-sorted tile into
  one batched (P, tile, d) ``gains`` call, each stops on its own head test
  (a stopped partition's tile is still scored but changes nothing), and
  the loop ends when no partition goes on -- one host sync per rescan
  iteration (``lazy_syncs``).  ``rescans`` counts each partition's own
  tiles, as the reference's does.
  """
  global lazy_syncs
  n, d = cand_feats.shape[-2:]
  batch = cand_feats.shape[:-2]
  dev = cand_feats.device
  if tile is None:
    tile = autotune.lazy_tile(n, d)
  tile = max(min(tile, autotune.floor_pow2(n, cap=tile)), 1)
  npad = -(-n // tile) * tile
  nt = npad // tile
  cand_pad = kernel_rows(objective, _pad_last(cand_feats, npad, 0.0, dim=-2))
  mask_pad = _pad_last(cand_mask, npad, False)
  meta_pad = {k: _pad_last(v, npad, 0) for k, v in meta.items()}
  int_max = torch.iinfo(torch.int64).max
  rescans = torch.zeros(batch, dtype=torch.int32, device=dev)
  tr = _Trace(state0, C.init_batched(constraint, tuple(batch), dev),
              torch.zeros((*batch, npad), dtype=torch.bool, device=dev),
              [], [], [])
  if k_steps == 0:
    return _result(objective, state0, tr, 0, batch, d, cand_feats.dtype,
                   dev, rescans)

  if warm_bounds is None:
    # step 0: one full pass selects AND seeds the bounds (not a rescan)
    feasible = mask_pad & constraint.mask(tr.cstate, meta_pad)
    stale = _pad_last(objective.gains(state0, cand_pad[..., :n, :]).float(),
                      npad, NEG)
    best, bidx = masked_top1(stale, feasible)
    tr = _apply(objective, tr, cand_pad, meta_pad, constraint, bidx, best,
                feasible, stop_nonpositive)
    t_start = 1
  else:
    stale = _pad_last(warm_bounds.to(device=dev, dtype=torch.float32), npad,
                      NEG)
    t_start = 0

  ar = torch.arange(tile, device=dev)
  for _ in range(t_start, k_steps):
    feasible = (~tr.selected) & mask_pad & constraint.mask(tr.cstate,
                                                           meta_pad)
    pri = torch.where(feasible, stale, NEG)
    sorted_pri, order = torch.sort(pri, dim=-1, descending=True, stable=True)
    p = torch.zeros(batch, dtype=torch.int64, device=dev)
    best = torch.full(batch, -torch.inf, dtype=torch.float32, device=dev)
    bidx = torch.full(batch, int_max, dtype=torch.int64, device=dev)
    while True:
      head = torch.gather(sorted_pri, -1,
                          (p * tile).clamp_max(npad - 1).unsqueeze(-1))[..., 0]
      go = (p < nt) & (head >= best)
      lazy_syncs += 1
      # repro: allow(T5): one read-back a rescan pass is the lazy greedy's contract (greedy.lazy_syncs; the entries' sync budgets)
      if not bool(go.any()):
        break
      pos = (p.clamp_max(nt - 1) * tile).unsqueeze(-1) + ar
      ids = torch.gather(order, -1, pos)                       # ((P,) tile)
      rows = ring.gather_rows(cand_pad, ids)  # in cand_pad's pitch
      g = objective.gains(tr.state, rows).float()
      stale = torch.where(go.unsqueeze(-1), stale.scatter(-1, ids, g), stale)
      gm = torch.where(torch.gather(feasible, -1, ids), g, NEG)
      tb = gm.max(dim=-1).values
      gi = torch.where(gm == tb.unsqueeze(-1), ids, int_max).min(dim=-1).values
      better = go & ((tb > best) | ((tb == best) & (gi < bidx)))
      best = torch.where(better, tb, best)
      bidx = torch.where(better, gi, bidx)
      p = p + go
      rescans = rescans + go.to(torch.int32)
    tr = _apply(objective, tr, cand_pad, meta_pad, constraint,
                bidx.clamp(0, npad - 1), best, feasible, stop_nonpositive)
  return _result(objective, state0, tr, k_steps, batch, d, cand_feats.dtype,
                 dev, rescans)
