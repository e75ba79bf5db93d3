"""GreeDi, the paper's two-round distributed protocol (the port of
``src/repro/core/greedi.py``: the reference path, the centralized baseline,
the naive baselines of Sec. 6, the generic sharded engine and the
cached-similarity fast engine, both with the flat merge).

  * ``greedi_reference``    -- one process, the m partitions as a leading
    tensor axis (the reference vmaps over them).  Global and local
    (decomposable, Sec. 4.5) evaluation, and the Thm-10 subset U.
  * ``greedi_sharded``      -- the generic engine for any objective with
    ``init``/``partial_stats``/``update``/``value`` (facility location,
    information gain) over m stacked logical shards: round 1 is the greedy
    loop on every shard at once, round 2 the distributed greedy whose
    per-step gains are the shards' weighted partial sums.
  * ``greedi_sharded_fast`` -- the production selection path for facility
    location, with m *stacked* logical shards on one card: what the
    reference runs under ``shard_map`` over m devices runs here with the
    shards as a leading axis, an ``all_gather`` is a reshape and a ``psum``
    is a sum over that axis.  Round 1 caches every shard's local similarity
    block through the ``pairwise`` oracle; the merge caches one cross block
    against the merged candidates, and round 2 runs the shared
    ``_dist_greedy_core`` over it.

Index tracking: every path threads global ground-set ids through both
rounds and returns them as ``GreediResult.sel_gids`` (-1 = no-op step).
Rows with ``gids = -1`` are holes -- never candidates, never evaluation
mass -- so any n shards cleanly.  ``straggler_keep`` drops machines from
the merge AND from the evaluation weight.

Randomness: the protocol's generators come from ``greedi_keys``; every
entry point also takes an explicit ``perm`` (and ``u_idx`` for the Thm-10
subset), so a caller can inject the partition another implementation drew.

Liveness: the sharded engines take per-machine heartbeat ages and a
deadline; with the shards stacked on one card the liveness collective is
the vector ``age <= deadline``, ANDed with ``straggler_keep`` and returned
as ``GreediResult.alive``.

``greedi_reference`` and ``centralized_greedy`` run every greedy mode:
"standard", "lazy", and the random modes of Sec. 5 ("random", RandomGreedy
for non-monotone objectives such as the graph cut; "stochastic"), whose
draws come as explicit tables or from the generators ``greedi_keys``
returns.  The generic ``greedi_sharded`` runs round 1 in "standard" or
"lazy"; its lazy round 1 also takes ``warm_bounds``, the selection
service's carried table (service/service.py).

Not ported yet (ROADMAP.md): the accumulation-tree merge, the fast
engine's lazy round 1, ``greedi_hierarchical``, and the
``torch.distributed`` collective backend (liveness across processes with
it).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.greedy import (draw_table, greedy, kernel_rows,
                                     where_state, with_backend)
from repro_torch.core.objectives import _kernel_h, masked_top1
from repro_torch.core.partition import random_partition, shard_live_counts
from repro_torch.kernels import dispatch

_LATER = "is not ported yet (ROADMAP.md, modules to port, item 5)"

# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def set_value_feats(objective, state0, sel_feats: torch.Tensor,
                    valid: torch.Tensor):
  """Replay updates for an explicit selected-feature block -> final state.

  ``sel_feats`` is ((P,) k, d) and ``valid`` ((P,) k); with a leading P the
  state carries it too (``FacilityLocation.broadcast``).
  """
  state = state0
  for t in range(sel_feats.shape[-2]):
    state = where_state(valid[..., t], objective.update(
        state, sel_feats[..., t, :]), state)
  return state


def _take_k(x: torch.Tensor, k: int, fill) -> torch.Tensor:
  """First k rows of a machine's kappa-row block, padded when kappa < k
  (the A_max arm must match round 2's (k_final, ...) shapes)."""
  if x.shape[0] >= k:
    return x[:k]
  pad = torch.full((k - x.shape[0], *x.shape[1:]), fill, dtype=x.dtype,
                   device=x.device)
  return torch.cat([x, pad], dim=0)


def _first_argmax(v: torch.Tensor) -> torch.Tensor:
  """Lowest index of the maximum of a 1-D tensor (jnp.argmax's rule)."""
  return masked_top1(v, torch.ones_like(v, dtype=torch.bool))[1]


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
  """x[i] for a 0-d device index, without a host sync."""
  return x.index_select(0, i.reshape(1))[0]


def _repeat_state(state, reps: int):
  """Each partition's state ``reps`` times in a row: a leading axis of P
  becomes P * reps, entry s * reps + i holding partition s's state."""
  if isinstance(state, torch.Tensor):
    return state.repeat_interleave(reps, dim=0)
  return type(state)(*(_repeat_state(x, reps) for x in state))


def _prep_liveness(liveness_age, liveness_deadline, m: int, device):
  """The liveness inputs as ((m,) float32 ages, () float32 deadline).

  ``liveness_age=None`` means no detection: ages 0 against an infinite
  deadline, so every machine passes and ``straggler_keep`` alone decides.
  """
  if liveness_age is None:
    return (torch.zeros((m,), dtype=torch.float32, device=device),
            torch.tensor(float("inf"), device=device))
  age = torch.as_tensor(liveness_age, device=device).to(torch.float32)
  if age.shape != (m,):
    raise ValueError(f"liveness_age of shape {tuple(age.shape)}, "
                     f"expected ({m},)")
  deadline = float("inf") if liveness_deadline is None else liveness_deadline
  return age, torch.as_tensor(deadline, device=device).to(torch.float32)


def _liveness_collective(age: torch.Tensor,
                         deadline: torch.Tensor) -> torch.Tensor:
  """The deadline-based liveness collective, stacked form: every shard
  contributes the bit "my last heartbeat landed within the deadline", and
  the gathered (m,) vector IS the straggler mask.  With the m shards
  stacked on one card the gather is the vector itself."""
  return age <= deadline


def _alive(straggler_keep, liveness_age, liveness_deadline, m: int,
           device) -> torch.Tensor:
  """``straggler_keep`` ANDed with the liveness collective: (m,) bool."""
  keep = (torch.ones((m,), dtype=torch.bool, device=device)
          if straggler_keep is None
          else torch.as_tensor(straggler_keep, device=device).to(torch.bool))
  age, deadline = _prep_liveness(liveness_age, liveness_deadline, m, device)
  return keep & _liveness_collective(age, deadline)


def greedi_keys(rng: torch.Generator):
  """The protocol's independent generators: (partition, round-1, round-2,
  U-subset), each seeded from one draw of ``rng``.

  Exposed so callers that partition outside the protocol (the sharded
  selection path in data/selection.py) derive the exact same partition as
  ``greedi_reference`` from the same generator state.
  """
  seeds = torch.randint(0, 2**62, (4,), generator=rng, device=rng.device)
  return tuple(torch.Generator(device=rng.device).manual_seed(int(s))
               for s in seeds.tolist())


class GreediResult(NamedTuple):
  sel_feats: torch.Tensor      # (k_final, d) the returned solution A_gd
  sel_valid: torch.Tensor      # (k_final,) bool
  value: torch.Tensor          # f(A_gd) under the final evaluation
  value_merged: torch.Tensor   # f(A_B^gc) (round-2 solution)
  value_best_single: torch.Tensor  # f(A_max^gc) (best single machine)
  stage1_values: torch.Tensor  # (m,) f(A_i) under final evaluation
  sel_gids: torch.Tensor       # (k_final,) int64 global ids, -1 = no-op
  alive: torch.Tensor          # (m,) bool machines the protocol used
  r1_rescans: torch.Tensor     # (m,) int32 lazy rescans (0: standard mode)


# ---------------------------------------------------------------------------
# THE distributed-greedy core, stacked form
# ---------------------------------------------------------------------------


class _Engine(NamedTuple):
  """What a sharded variant plugs into the shared distributed-greedy loop.

  Gain and value quantities are *local, unnormalized* per-shard
  contributions with a leading shard axis; the core sums them over the
  shards (the reference's psum), weighted by each shard's evaluation
  weight.
  """
  state0: Any
  # state -> (m, nc) per-shard partial marginal gains of every candidate
  partial_gains: Callable[[Any], torch.Tensor]
  # (state, chosen column (), chosen feature row (d,), take ()) -> new state
  apply_update: Callable[[Any, torch.Tensor, torch.Tensor, torch.Tensor], Any]
  # state -> (m,) per-shard partial objective value
  partial_value: Callable[[Any], torch.Tensor]
  cands: torch.Tensor   # (nc, d) candidate block, shared by the shards
  cmask: torch.Tensor   # (nc,) bool selectable
  cgids: torch.Tensor   # (nc,) int64 global ids of the candidates


def _objective_engine(objective, local_feats: torch.Tensor,
                      cands: torch.Tensor, cmask: torch.Tensor,
                      cgids: torch.Tensor,
                      eval_mask: torch.Tensor | None = None,
                      state0=None) -> _Engine:
  """Engine over a generic objective exposing partial_stats/update/value,
  the m shards stacked: ``local_feats`` (m, nl, d) binds each shard's
  evaluation rows and ``eval_mask`` (m, nl) marks the live ones (holes
  carry 0), so the partial value is each shard's mean times its live
  count and hole rows move nothing.  ``state0`` is
  ``objective.init(local_feats, eval_mask)`` when the caller has it."""
  m = local_feats.shape[0]
  cands = kernel_rows(objective, cands)
  if eval_mask is None:
    eval_mask = local_feats.new_ones(local_feats.shape[:-1])
  # count in f32: a low-precision mask dtype would round counts past 256
  n_live = torch.sum(eval_mask.to(torch.float32), dim=-1)     # (m,)

  def partial_gains(state):
    return objective.partial_stats(state, cands)[0]

  def apply_update(state, j, feat, take):
    del j
    return where_state(take, objective.update(state, feat.expand(m, -1)),
                       state)

  def partial_value(state):
    return objective.value(state) * n_live

  if state0 is None:
    state0 = objective.init(local_feats, eval_mask)
  return _Engine(state0, partial_gains, apply_update, partial_value, cands,
                 cmask, cgids)


def _dist_greedy_core(engine: _Engine, steps: int, weight: torch.Tensor,
                      denom: torch.Tensor, feat_dtype):
  """Distributed greedy over the engine's candidate block, m shards
  stacked on one device.

  Per step: sum the weighted per-shard partial gains over the shard axis,
  then one ``masked_top1`` over gains and feasibility (the same tie rule as
  the fused select oracles).  ``weight`` is each shard's evaluation weight
  (0 for dead machines); ``denom`` the weighted live-row count.  Returns
  (sel_feats (steps, d), sel_valid (steps,), sel_gids (steps,), value ()).
  """
  cands, cmask, cgids = engine.cands, engine.cmask, engine.cgids
  nc = cands.shape[0]
  state = engine.state0
  selmask = torch.zeros((nc,), dtype=torch.bool, device=cands.device)
  outf, outv, outg = [], [], []
  for _ in range(steps):
    gains = torch.sum(engine.partial_gains(state) * weight[:, None],
                      dim=0) / denom
    feasible = cmask & ~selmask
    _, chosen = masked_top1(gains, feasible)
    take = feasible.any()
    feat = _pick(cands, chosen)
    state = engine.apply_update(state, chosen, feat, take)
    selmask = selmask.scatter(0, chosen.reshape(1),
                              (_pick(selmask, chosen) | take).reshape(1))
    outf.append(torch.where(take, feat, 0.0).to(feat_dtype))
    outv.append(take)
    outg.append(torch.where(take, _pick(cgids, chosen), -1))
  val = torch.sum(engine.partial_value(state) * weight) / denom
  return (torch.stack(outf), torch.stack(outv), torch.stack(outg), val)


# ---------------------------------------------------------------------------
# reference implementation (one process, partitions as a leading axis)
# ---------------------------------------------------------------------------


def _round_draws(mode, draws, rng, batch, k_steps, n, sample_frac, device):
  """A round's draw table: the given one, or the port's own from ``rng``
  (None for the modes that draw nothing)."""
  if mode not in ("random", "stochastic") or draws is not None:
    return draws
  return draw_table(mode, rng, batch, k_steps, n, sample_frac=sample_frac,
                    device=device)


def greedi_reference(rng: torch.Generator | None, feats: torch.Tensor, *,
                     m: int, kappa: int, k_final: int, objective, init_for,
                     local_eval: bool = False,
                     final_subset: int | None = None,
                     mode: str = "standard",
                     sample_frac: float | None = None,
                     stop_nonpositive: bool = False,
                     backend: str | None = None,
                     use_select: bool = True,
                     perm: torch.Tensor | None = None,
                     u_idx: torch.Tensor | None = None,
                     r1_draws: torch.Tensor | None = None,
                     r2_draws: torch.Tensor | None = None) -> GreediResult:
  """Algorithm 2 (GreeDi) on one device.

  Args:
    rng: generator for the partition (and U, and the draws of the random
      modes); may be None when ``perm`` (``u_idx`` with ``final_subset``,
      the draw tables with mode "random" or "stochastic") are given.
    init_for: callable (eval_feats, eval_mask) -> objective state; it
      receives (m, npp, d) / (m, npp) blocks under ``local_eval``.  For
      set-only objectives (information gain, DPP) it may ignore its inputs
      and return an unbatched state: every partition gets its own copy.
    local_eval: round-1 machines evaluate f on their local partition only
      (the decomposable mode of Sec. 4.5).
    final_subset: if given, round 2 and the final comparison evaluate f on
      a random subset U of this size (Thm 10); else on the full ground set.
    mode: the greedy mode of both rounds ("standard", "lazy", "random",
      "stochastic"; ``sample_frac`` with "stochastic").
    backend: optional gain-oracle backend override for both rounds.
    use_select: fused select step (True) or gains + masked_top1 (False).
    stop_nonpositive: greedy steps whose best gain is <= 0 are no-ops
      (non-monotone objectives).
    perm: explicit (m, ceil(n/m)) partition with -1 padding, replacing the
      draw from ``rng``.
    u_idx: explicit (final_subset,) indices of U.
    r1_draws: round 1's draw table, one per partition ((m, kappa, ...), see
      ``greedy.draw_table``); by default drawn from the round-1 generator
      of ``greedi_keys``.
    r2_draws: round 2's table ((k_final, ...)); by default drawn from the
      round-2 generator.
  """
  objective = with_backend(objective, backend)
  n, d = feats.shape
  npp = -(-n // m)
  drawn = mode in ("random", "stochastic")
  need_keys = (perm is None or (final_subset is not None and u_idx is None)
               or (drawn and (r1_draws is None or r2_draws is None)))
  r_part, r_sel, r_r2, r_u = greedi_keys(rng) if need_keys else (None,) * 4
  parts, pmask, perm = random_partition(r_part, feats, m, perm=perm)

  # ---- round 1: one greedy per machine, all machines in one batch -------
  if local_eval:
    st0 = init_for(parts, pmask.to(parts.dtype))
  else:
    st0 = init_for(feats, feats.new_ones((n,)))
  r1 = greedy(objective, objective.broadcast(st0, m), parts, kappa,
              cand_mask=pmask, mode=mode, stop_nonpositive=stop_nonpositive,
              use_select=use_select,
              draws=_round_draws(mode, r1_draws, r_sel, (m,), kappa, npp,
                                 sample_frac, feats.device))
  valid1 = r1.idx >= 0
  gid1 = torch.gather(perm, 1, r1.idx.clamp_min(0))
  gid1 = torch.where(valid1, gid1, -1)                      # (m, kappa)

  # ---- final evaluation objective ---------------------------------------
  if final_subset is not None:
    if u_idx is None:
      u_idx = torch.randperm(n, generator=r_u,
                             device=r_u.device)[:final_subset]
    u_idx = torch.as_tensor(u_idx, device=feats.device).to(torch.int64)
    eval_feats = feats[u_idx]
  else:
    eval_feats = feats
  st_final0 = init_for(eval_feats, eval_feats.new_ones(eval_feats.shape[:1]))

  # ---- A_max: best single-machine solution under final evaluation -------
  stage1_vals = objective.value(set_value_feats(
      objective, objective.broadcast(st_final0, m), r1.feats, valid1))
  best_i = _first_argmax(stage1_vals)

  # ---- round 2: greedy over the merged candidates ------------------------
  B = r1.feats.reshape(m * kappa, d)
  bmask = valid1.reshape(m * kappa)
  bgids = gid1.reshape(m * kappa)
  r2 = greedy(objective, st_final0, B, k_final, cand_mask=bmask, mode=mode,
              stop_nonpositive=stop_nonpositive, use_select=use_select,
              draws=_round_draws(mode, r2_draws, r_r2, (), k_final,
                                 m * kappa, sample_frac, feats.device))
  r2_gids = torch.where(r2.idx >= 0, bgids[r2.idx.clamp_min(0)], -1)
  v_merged = objective.value(r2.state)
  v_best_single = _pick(stage1_vals, best_i)

  use_merged = v_merged >= v_best_single
  # A_max may hold kappa > k_final items: its first k_final are the greedy
  # prefix, which is exactly A_max^gc[k_final].
  alt_feats = _take_k(_pick(r1.feats, best_i), k_final, 0.0)
  alt_valid = _take_k(_pick(valid1, best_i), k_final, False)
  alt_gids = _take_k(_pick(gid1, best_i), k_final, -1)
  return GreediResult(
      torch.where(use_merged, r2.feats, alt_feats),
      torch.where(use_merged, r2.idx >= 0, alt_valid),
      torch.maximum(v_merged, v_best_single), v_merged, v_best_single,
      stage1_vals, torch.where(use_merged, r2_gids, alt_gids),
      torch.ones((m,), dtype=torch.bool, device=feats.device),
      r1.rescans)


def centralized_greedy(feats: torch.Tensor, k: int, *, objective, init_for,
                       mode: str = "standard", stop_nonpositive: bool = False,
                       backend: str | None = None, use_select: bool = True,
                       rng: torch.Generator | None = None,
                       sample_frac: float | None = None,
                       draws: torch.Tensor | None = None):
  """Plain greedy over the whole ground set -> (GreedyResult, f(S)).  The
  random modes take ``draws`` or draw from ``rng``, as ``greedy`` does."""
  objective = with_backend(objective, backend)
  st0 = init_for(feats, feats.new_ones(feats.shape[:1]))
  r = greedy(objective, st0, feats, k, mode=mode, rng=rng,
             sample_frac=sample_frac, draws=draws,
             stop_nonpositive=stop_nonpositive, use_select=use_select)
  return r, objective.value(r.state)


# ---------------------------------------------------------------------------
# naive baselines of Sec. 6
# ---------------------------------------------------------------------------


def baselines(rng: torch.Generator | None, feats: torch.Tensor, *, m: int,
              k: int, objective, init_for, stop_nonpositive: bool = False,
              backend: str | None = None, perm: torch.Tensor | None = None,
              rr_idx: torch.Tensor | None = None,
              rand_idx: torch.Tensor | None = None) -> dict:
  """random/random, random/greedy, greedy/merge, greedy/max (paper Sec. 6).

  The draws are explicit arguments, so a caller can inject another
  implementation's: ``perm`` the (m, npp) partition, ``rr_idx`` the (k,)
  random/random picks, ``rand_idx`` the (m, min(k, npp)) per-machine
  random picks of random/greedy.  What is not given is drawn from the
  generators ``greedi_keys`` splits off ``rng``.
  """
  objective = with_backend(objective, backend)
  n, d = feats.shape
  dev = feats.device
  need = perm is None or rr_idx is None or rand_idx is None
  r_part, r_a, r_b, _ = greedi_keys(rng) if need else (None,) * 4
  parts, pmask, _ = random_partition(r_part, feats, m, perm=perm)
  npp = parts.shape[1]
  ones = torch.ones((n,), dtype=feats.dtype, device=dev)
  st_full0 = init_for(feats, ones)
  out = {}

  # -- random/random: k random out of (m x k random) == k random overall
  if rr_idx is None:
    rr_idx = torch.randperm(n, generator=r_a, device=r_a.device)[:k]
  rr_idx = torch.as_tensor(rr_idx, device=dev).to(torch.int64)
  st = set_value_feats(objective, st_full0, feats[rr_idx],
                       torch.ones((k,), dtype=torch.bool, device=dev))
  out["random/random"] = objective.value(st)

  # -- random/greedy: k random per machine, then greedy over the mk pool
  if rand_idx is None:
    pr = torch.rand((m, npp), generator=r_b, device=r_b.device).to(dev)
    pr = pr - torch.where(pmask, 0.0, 1e9)
    rand_idx = torch.topk(pr, min(k, npp), dim=1).indices
  rand_idx = torch.as_tensor(rand_idx, device=dev).to(torch.int64)
  pool = torch.gather(parts, 1, rand_idx[..., None].expand(-1, -1, d))
  pool_mask = torch.gather(pmask, 1, rand_idx)
  r = greedy(objective, st_full0, pool.reshape(-1, d), k,
             cand_mask=pool_mask.reshape(-1),
             stop_nonpositive=stop_nonpositive)
  out["random/greedy"] = objective.value(r.state)

  # -- greedy/merge: ceil(k/m) greedy per machine, merged as-is
  kpm = -(-k // m)
  r1 = greedy(objective, objective.broadcast(init_for(feats, ones), m),
              parts, kpm, cand_mask=pmask, stop_nonpositive=stop_nonpositive)
  merged = r1.feats.reshape(m * kpm, d)[:k]
  mvalid = (r1.idx >= 0).reshape(m * kpm)[:k]
  out["greedy/merge"] = objective.value(
      set_value_feats(objective, st_full0, merged, mvalid))

  # -- greedy/max: greedy k per machine, report the best single solution
  rk = greedy(objective, objective.broadcast(init_for(feats, ones), m),
              parts, k, cand_mask=pmask, stop_nonpositive=stop_nonpositive)
  vals = objective.value(set_value_feats(
      objective, objective.broadcast(st_full0, m), rk.feats, rk.idx >= 0))
  out["greedy/max"] = torch.max(vals)
  return out


# ---------------------------------------------------------------------------
# the generic engine, m stacked shards
# ---------------------------------------------------------------------------


def greedi_sharded(feats: torch.Tensor, *, m: int, kappa: int, k_final: int,
                   objective, straggler_keep: torch.Tensor | None = None,
                   u_subset_eval: bool = False, backend: str | None = None,
                   gids: torch.Tensor | None = None, mode: str = "standard",
                   warm_bounds: torch.Tensor | None = None,
                   liveness_age: torch.Tensor | None = None,
                   liveness_deadline: float | None = None,
                   merge: str = "flat",
                   tree_branch: int | None = None) -> GreediResult:
  """GreeDi over m stacked logical shards for any objective exposing
  init/partial_stats/update/value (the reference's ``greedi_sharded`` with
  the flat merge); round-2 gains are the shards' weighted partial sums.

  Args:
    feats: (m * npp, d) shard-contiguous ground set (shard b owns rows
      b*npp .. (b+1)*npp - 1); rows with ``gids = -1`` are holes, never
      candidates and never evaluation mass.
    objective: facility location or information gain.
    straggler_keep: optional (m,) bool; False machines are dropped at the
      merge and carry no evaluation weight.
    u_subset_eval: Thm-10 mode -- round 2 and A_max evaluate on ONE
      machine's partition, held by the first alive shard.
    backend: optional gain-oracle backend override for both rounds.
    gids: optional (m * npp,) global ids of the rows (default arange).
    mode: round-1 greedy mode, "standard" (the fused select step) or
      "lazy" (tile-bound lazy rescans; the same selection).  Round 2 is
      the distributed greedy either way.
    warm_bounds: optional (m * npp,) upper bounds on each row's empty-set
      gain under its shard's local evaluation, for the lazy round 1
      (mode="lazy"; standard ignores them): step 0 skips its full pass.
      The selection service's warm start (its validity lives with the
      objective's bound maintainer, core/objectives.py).
    liveness_age, liveness_deadline: optional (m,) heartbeat ages and
      their deadline; the liveness collective turns them into the
      straggler mask (ANDed with ``straggler_keep``), returned as
      ``GreediResult.alive``.
    merge, tree_branch: only "flat" and None are ported.

  A_max replays every machine's block on every shard's evaluation rows at
  once (m * m states in one batch), then sums the shards' partial values.
  The shards' initial state is built once and serves round 1, A_max and
  round 2 (saturated coverage's ``init`` is a full pass over the shard).
  """
  if merge != "flat" or tree_branch is not None:
    raise NotImplementedError(
        f"greedi_sharded merge {merge!r}: the accumulation-tree merge "
        f"{_LATER}")
  objective = with_backend(objective, backend)
  n, d = feats.shape
  if n % m:
    raise ValueError(f"{n} rows do not split into {m} equal shards")
  nl = n // m
  dev = feats.device
  keep = _alive(straggler_keep, liveness_age, liveness_deadline, m, dev)
  if gids is None:
    gids = torch.arange(n, device=dev)
  local = feats.reshape(m, nl, d)
  local_gids = torch.as_tensor(gids, device=dev).to(torch.int64).reshape(
      m, nl)
  local_valid = local_gids >= 0                       # pad-and-mask holes
  evalw = local_valid.to(feats.dtype)
  n_live = shard_live_counts(local_valid, m)

  # ---- round 1: the local greedy of every shard, one batch ---------------
  st0 = objective.init(local, evalw)
  wb = (None if warm_bounds is None else torch.as_tensor(
      warm_bounds, device=dev).to(torch.float32).reshape(m, nl))
  r1 = greedy(objective, st0, local, kappa, cand_mask=local_valid,
              mode=mode, warm_bounds=wb)
  took = r1.idx >= 0
  valid = took & keep[:, None]
  gsel = torch.where(took, torch.gather(local_gids, 1, r1.idx.clamp_min(0)),
                     -1)

  # ---- merge: the candidate blocks of every shard (the all_gather) -------
  Bflat = r1.feats.reshape(m * kappa, d)
  Bmask = valid.reshape(m * kappa)
  Bgflat = gsel.reshape(m * kappa)
  # evaluation weight of each shard: the full set, or the Thm-10 U subset
  # held by the first ALIVE shard; zero for dead machines
  u_holder = _first_argmax(keep.to(torch.float32))
  w = keep.to(torch.float32)
  if u_subset_eval:
    w = w * (torch.arange(m, device=dev) == u_holder).to(torch.float32)
  denom = torch.clamp_min(torch.sum(n_live * w), 1.0)

  # ---- A_max: machine i's block replayed on shard s's rows, all (s, i) ---
  st_all = _repeat_state(st0, m)                              # (m*m, ...)
  blocks = r1.feats.repeat(m, 1, 1)                           # entry s*m+i
  bvalid = valid.repeat(m, 1)
  part_vals = objective.value(set_value_feats(objective, st_all, blocks,
                                              bvalid)).reshape(m, m)
  stage1_vals = torch.sum(part_vals * (n_live * w)[:, None], dim=0) / denom
  stage1_vals = torch.where(keep, stage1_vals, -torch.inf)
  best_i = _first_argmax(stage1_vals)

  # ---- round 2: the distributed greedy over the merged block -------------
  engine = _objective_engine(objective, local, Bflat, Bmask, Bgflat,
                             eval_mask=evalw, state0=st0)
  merged_feats, merged_valid, merged_gids, v_merged = _dist_greedy_core(
      engine, k_final, w, denom, feats.dtype)

  v_best_single = _pick(stage1_vals, best_i)
  use_merged = v_merged >= v_best_single
  return GreediResult(
      torch.where(use_merged, merged_feats,
                  _take_k(_pick(r1.feats, best_i), k_final, 0.0)),
      torch.where(use_merged, merged_valid,
                  _take_k(_pick(valid, best_i), k_final, False)),
      torch.maximum(v_merged, v_best_single), v_merged, v_best_single,
      stage1_vals,
      torch.where(use_merged, merged_gids,
                  _take_k(_pick(gsel, best_i), k_final, -1)),
      keep, r1.rescans)


# ---------------------------------------------------------------------------
# the cached-similarity fast engine, m stacked shards
# ---------------------------------------------------------------------------

_ROW_CHUNK = 4096  # eval rows per step of the plain relu-reduce


def _relu_colsum(s: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
  """sum_i relu(s[:, i, j] - cov[:, i]) over the eval rows of a cached
  similarity block: s (m, nl, nc), cov (m, nl) -> (m, nc).

  The reference's masked relu-reduce in plain PyTorch.  Row chunks bound
  the temporary at (m, 4096, nc) floats instead of a copy of s (16 GiB for
  the round-1 block at 16 x 16384 rows); the plain version's cost is a
  target of a later kernel (PERF.md).
  """
  out = None
  for r0 in range(0, s.shape[1], _ROW_CHUNK):
    inc = s[:, r0:r0 + _ROW_CHUNK] - cov[:, r0:r0 + _ROW_CHUNK, None]
    part = inc.clamp_min_(0.0).sum(dim=1)
    out = part if out is None else out + part
  return out


def _column(s: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
  """s[b, :, j[b]] per shard b: s (m, nl, nc), j (m,) -> (m, nl)."""
  m, nl, _ = s.shape
  return torch.gather(s, 2, j.reshape(m, 1, 1).expand(m, nl, 1))[..., 0]


def greedi_sharded_fast(feats: torch.Tensor, *, m: int, kappa: int,
                        k_final: int, kernel: str = "linear",
                        kernel_kwargs: tuple = (),
                        straggler_keep: torch.Tensor | None = None,
                        backend: str | None = None,
                        gids: torch.Tensor | None = None,
                        mode: str = "standard",
                        merge: str = "flat",
                        liveness_age: torch.Tensor | None = None,
                        liveness_deadline: float | None = None
                        ) -> GreediResult:
  """Cached-similarity GreeDi for facility location over m stacked shards
  (the reference's ``greedi_sharded_fast`` with the flat merge).

    * round 1 caches each shard's (n/m x n/m) similarity block once through
      the ``pairwise`` oracle (one launch for all shards); each greedy step
      is then a masked relu-reduce over the cached block;
    * the merge gathers the (m, kappa, d) candidate blocks (a reshape) and
      caches S2 = sim(local eval, merged B), again one launch for all
      shards with the merged block shared;
    * A_max needs no replay: f(A_i) = mean_e max over machine i's columns of
      S2;
    * round 2 runs ``_dist_greedy_core`` over the cached S2 columns.

  Args:
    feats: (m * npp, d) shard-contiguous ground set (shard b owns rows
      b*npp .. (b+1)*npp - 1).
    m: number of stacked logical shards.
    straggler_keep: optional (m,) bool; False machines contribute neither
      candidates nor evaluation mass.
    backend: ``pairwise`` backend override ("cuda" | "ref" | "auto").
    gids: optional (m * npp,) global ids of the rows (default arange); -1
      marks a hole.
    liveness_age, liveness_deadline: as in ``greedi_sharded``.
  """
  if mode != "standard":
    raise NotImplementedError(
        f"greedi_sharded_fast mode {mode!r}: lazy round 1 {_LATER}")
  if merge != "flat":
    raise NotImplementedError(
        f"greedi_sharded_fast merge {merge!r}: the accumulation-tree merge "
        f"{_LATER}")
  if kernel not in dispatch.FUSED_SIMS:
    raise ValueError(f"greedi_sharded_fast caches similarities through the "
                     f"'pairwise' oracle and supports {dispatch.FUSED_SIMS}, "
                     f"got {kernel!r}")
  sim = dispatch.resolve("pairwise", backend or "auto")
  h = _kernel_h(kernel_kwargs)
  n, d = feats.shape
  if n % m:
    raise ValueError(f"{n} rows do not split into {m} equal shards")
  nl = n // m
  dev = feats.device
  keep = _alive(straggler_keep, liveness_age, liveness_deadline, m, dev)
  if gids is None:
    gids = torch.arange(n, device=dev)
  local = feats.reshape(m, nl, d)
  local_gids = torch.as_tensor(gids, device=dev).to(torch.int64).reshape(
      m, nl)
  local_valid = local_gids >= 0                       # pad-and-mask holes
  vrow = local_valid.to(torch.float32)
  n_live = shard_live_counts(local_valid, m)
  w = keep.to(torch.float32)

  # ---- round 1: local greedy over each shard's cached similarity block --
  # hole EVAL rows are zeroed out of the block so they carry no coverage
  # mass (an rbf kernel gives a zero feature row sim > 0); in place, the
  # block is the run's largest tensor
  s11 = sim(local, local, kernel=kernel, h=h)         # (m, nl, nl) f32
  s11.mul_(vrow[:, :, None])
  cov = torch.zeros((m, nl), dtype=torch.float32, device=dev)
  selmask = torch.zeros((m, nl), dtype=torch.bool, device=dev)
  sel_idx, took = [], []
  for _ in range(kappa):
    gains = _relu_colsum(s11, cov)
    feasible = ~selmask & local_valid
    _, j = masked_top1(gains, feasible)
    take = feasible.any(dim=1)
    cov = torch.where(take[:, None], torch.maximum(cov, _column(s11, j)), cov)
    hit = torch.gather(selmask, 1, j[:, None]) | take[:, None]
    selmask = selmask.scatter(1, j[:, None], hit)
    sel_idx.append(j)
    took.append(take)
  del s11
  sel_idx = torch.stack(sel_idx, dim=1)               # (m, kappa)
  took = torch.stack(took, dim=1)
  sel = torch.gather(local, 1, sel_idx[..., None].expand(m, kappa, d))
  # steps past the live local rows find nothing feasible: invalidate them
  # like the reference does, so kappa > live rows leaks no duplicates
  gsel = torch.where(took, torch.gather(local_gids, 1, sel_idx), -1)
  valid = keep[:, None] & took

  # ---- merge + ONE cross-similarity block --------------------------------
  denom = torch.clamp_min(torch.sum(n_live * w), 1.0)
  Bflat = sel.reshape(m * kappa, d)
  Bmask = valid.reshape(m * kappa)
  Bgflat = gsel.reshape(m * kappa)
  s2 = sim(local, Bflat, kernel=kernel, h=h)          # (m, nl, m*kappa)
  s2.mul_(vrow[:, :, None])

  # ---- A_max: no replay needed -------------------------------------------
  # invalid candidate columns (padding past a machine's live rows, or rows
  # of a dead machine) carry no coverage in f(A_i)
  s2_pos = torch.clamp_min(s2, 0.0) * Bmask.to(torch.float32)
  per_machine = s2_pos.reshape(m, nl, m, kappa).amax(dim=3)   # (m, nl, m)
  del s2_pos
  stage1_vals = torch.sum(per_machine.sum(dim=1) * w[:, None],
                          dim=0) / denom
  stage1_vals = torch.where(keep, stage1_vals, -torch.inf)
  best_i = _first_argmax(stage1_vals)

  # ---- round 2: the shared core over the cached columns ------------------
  engine = _Engine(
      state0=torch.zeros((m, nl), dtype=torch.float32, device=dev),
      partial_gains=lambda c: _relu_colsum(s2, c),
      apply_update=lambda c, j, feat, take: torch.where(
          take, torch.maximum(c, s2.index_select(2, j.reshape(1))[..., 0]),
          c),
      partial_value=lambda c: c.sum(dim=1),
      cands=Bflat, cmask=Bmask, cgids=Bgflat)
  merged_feats, merged_valid, merged_gids, v_merged = _dist_greedy_core(
      engine, k_final, w, denom, feats.dtype)

  v_best_single = _pick(stage1_vals, best_i)
  use_merged = v_merged >= v_best_single
  return GreediResult(
      torch.where(use_merged, merged_feats,
                  _take_k(_pick(sel, best_i), k_final, 0.0)),
      torch.where(use_merged, merged_valid,
                  _take_k(_pick(valid, best_i), k_final, False)),
      torch.maximum(v_merged, v_best_single), v_merged, v_best_single,
      stage1_vals,
      torch.where(use_merged, merged_gids,
                  _take_k(_pick(gsel, best_i), k_final, -1)),
      keep, torch.zeros((m,), dtype=torch.int32, device=dev))
