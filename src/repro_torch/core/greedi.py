"""GreeDi, the paper's two-round distributed protocol (the port of
``src/repro/core/greedi.py``: the reference path, the centralized baseline,
the naive baselines of Sec. 6, the generic sharded engine, the
cached-similarity fast engine and the three-level hierarchical variant).

  * ``greedi_reference``    -- one process, the m partitions as a leading
    tensor axis (the reference vmaps over them).  Global and local
    (decomposable, Sec. 4.5) evaluation, and the Thm-10 subset U.
  * ``greedi_sharded``      -- the generic engine for any objective with
    ``init``/``partial_stats``/``update``/``value`` (facility location,
    saturated coverage, information gain) over m stacked logical shards:
    round 1 is the greedy loop on every shard at once, each merge level a
    distributed greedy whose per-step gains are the shards' weighted
    partial sums.
  * ``greedi_sharded_fast`` -- the production selection path for facility
    location, with m *stacked* logical shards on one card: what the
    reference runs under ``shard_map`` over m devices runs here with the
    shards as a leading axis, an ``all_gather`` is a reshape and a ``psum``
    is a sum over that axis.  Round 1 caches every shard's local similarity
    block through the ``pairwise`` oracle and takes each greedy step as a
    ``relu_colsum`` pass over it (every column, or bound-sorted column
    tiles in the lazy mode); each merge level caches one cross block
    against its candidates and runs the shared ``_dist_greedy_core`` over
    it.
  * ``greedi_hierarchical`` -- shard -> pod -> global over pods x per_pod
    stacked shards.

Merges: "flat" merges all m round-1 blocks at once; "tree" is the
accumulation tree, ceil(log_b m) levels of b-child merges, the groups of a
level (its subtrees) run as one batched loop over a leading group axis.
``tree_branch = m`` is the flat merge, bit for bit.

Index tracking: every path threads global ground-set ids through both
rounds and returns them as ``GreediResult.sel_gids`` (-1 = no-op step).
Rows with ``gids = -1`` are holes -- never candidates, never evaluation
mass -- so any n shards cleanly.  ``straggler_keep`` drops machines from
the merge AND from the evaluation weight.

Initial states: ``greedi_reference``, ``centralized_greedy`` and
``baselines`` build them with the caller's ``init_for``; one that takes
three positional arguments (``_init_arity``) also receives the candidate
block the state will score, the precompute path of
``FacilityLocationPre`` (``_call_init``).  The sharded engines call
``objective.init`` themselves, as the reference's do.

Randomness: the protocol's generators come from ``greedi_keys``; every
entry point also takes an explicit ``perm`` (and ``u_idx`` for the Thm-10
subset), so a caller can inject the partition another implementation drew.

Liveness: the sharded engines take per-machine heartbeat ages and a
deadline; the liveness collective gathers every shard's bit ``age <=
deadline`` into the (m,) straggler mask, ANDed with ``straggler_keep``
and returned as ``GreediResult.alive``.

The shard axis: by default the m shards are stacked on this process (a
leading tensor axis).  With ``mesh=`` (a ``launch.mesh.ProcessMesh``) the
sharded engines and ``greedi_hierarchical`` run over the ranks of a
process group instead, each rank holding its ``m_local`` contiguous shards
(``feats``, ``gids``, ``warm_bounds`` and ``liveness_age`` are the rank's
own rows).  Every read across the shard axis goes through one small
object (``_Stacked`` or ``_Ranks``): ``gather`` turns a rank's (m_local,
...) slab into the full (m, ...) tensor, the same bits on every rank, and
``mine`` takes the rank's rows of a full one.  The stacked arithmetic then
runs on the full tensors as it is, so every rank takes the same
``masked_top1`` without a broadcast and selects the stacked run's ids bit
for bit.  A psum is such a gather followed by the stacked sum, never an
``all_reduce``, whose order would depend on the ring.

``greedi_reference`` and ``centralized_greedy`` run every greedy mode:
"standard", "lazy", and the random modes of Sec. 5 ("random", RandomGreedy
for non-monotone objectives such as the graph cut; "stochastic"), whose
draws come as explicit tables or from the generators ``greedi_keys``
returns.  The sharded engines run round 1 in "standard" or "lazy"; the
generic engine's lazy round 1 also takes ``warm_bounds``, the selection
service's carried table (service/service.py).
"""
from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import greedy as _greedy
from repro_torch.core.greedy import (_pad_last, _rows, draw_table, greedy,
                                     kernel_rows, where_state, with_backend)
from repro_torch.core.objectives import NEG, _kernel_h, masked_top1
from repro_torch.core.partition import random_partition, shard_live_counts
from repro_torch.kernels import autotune, dispatch, facility_gain

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


def _init_arity(init_for) -> int:
  """Positional arity of a user ``init_for``: 3 when it takes the
  candidate block (a precompute path such as ``FacilityLocationPre``),
  else 2.  Read from the signature, never by calling and retrying, so a
  TypeError raised inside the user's function propagates.  A ``*args``
  callable is taken at its word and receives the candidate block."""
  try:
    sig = inspect.signature(init_for)
  except (TypeError, ValueError):  # builtins without inspectable signatures
    return 2
  n = 0
  for p in sig.parameters.values():
    if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
      n += 1
    elif p.kind is p.VAR_POSITIONAL:
      return 3
  return n


def _call_init(init_for, eval_feats: torch.Tensor, eval_mask: torch.Tensor,
               cand_feats: torch.Tensor):
  """``init_for(eval_feats, eval_mask[, cand_feats])`` by its arity."""
  if _init_arity(init_for) >= 3:
    return init_for(eval_feats, eval_mask, cand_feats)
  return init_for(eval_feats, eval_mask)


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


# ---------------------------------------------------------------------------
# the shard axis: stacked on this process, or over the ranks of a mesh
# ---------------------------------------------------------------------------


class _Stacked:
  """Every shard on this process: a gather is the tensor itself and the
  process's rows are all of them."""

  def __init__(self, m: int):
    self.m = self.m_local = m

  def gather(self, x: torch.Tensor) -> torch.Tensor:
    return x

  def mine(self, x: torch.Tensor) -> torch.Tensor:
    return x


class _Ranks:
  """The shards over the ranks of a ``launch.mesh.ProcessMesh``: ``gather``
  concatenates every rank's (m_local, ...) slab into the (m, ...) tensor in
  rank order (the list form of ``all_gather``, which gloo also carries for
  CUDA tensors), ``mine`` takes the rank's rows of an (m, ...) tensor."""

  def __init__(self, mesh):
    self.mesh = mesh
    self.m, self.m_local = mesh.m, mesh.m_local

  def gather(self, x: torch.Tensor) -> torch.Tensor:
    if x.shape[0] != self.m_local:
      raise ValueError(f"gather of a slab of {x.shape[0]} shards, this rank "
                       f"holds {self.m_local}")
    return self.mesh.all_gather(x)

  def mine(self, x: torch.Tensor) -> torch.Tensor:
    return x[self.mesh.shards]


def _rank_plans(engine):
  """Run an engine under its mesh's kernel plans: a rank's facility and
  coverage calls carry m / world of the stacked call's partitions and take
  the stacked call's work plan (``facility_gain.plan_for_parts``), so
  every gain sums in the stacked order."""

  @functools.wraps(engine)
  def run(*args, mesh=None, **kwargs):
    if mesh is None:
      return engine(*args, **kwargs)
    with facility_gain.plan_for_parts(mesh.world):
      return engine(*args, mesh=mesh, **kwargs)

  return run


def _shard_axis(mesh, m: int):
  """The shard axis of an engine call: stacked without a mesh, else over
  its ranks (``m`` must be the mesh's)."""
  if mesh is None:
    return _Stacked(m)
  if m != mesh.m:
    raise ValueError(f"m={m} but the mesh has {mesh.m} shards")
  return _Ranks(mesh)


def _prep_liveness(liveness_age, liveness_deadline, m: int, device):
  """The liveness inputs as ((m,) float32 ages, () float32 deadline).

  ``liveness_age=None`` means no detection: ages 0 against an infinite
  deadline, so every machine passes and ``straggler_keep`` alone decides.
  A number deadline is filled in on the device: a tensor made from it on
  the host would be a blocking copy, one host sync a call.
  """
  if liveness_age is None:
    return (torch.zeros((m,), dtype=torch.float32, device=device),
            torch.full((), float("inf"), dtype=torch.float32, device=device))
  age = torch.as_tensor(liveness_age, device=device).to(torch.float32)
  if age.shape != (m,):
    raise ValueError(f"liveness_age of shape {tuple(age.shape)}, "
                     f"expected ({m},)")
  deadline = float("inf") if liveness_deadline is None else liveness_deadline
  if isinstance(deadline, torch.Tensor):
    return age, deadline.to(device=device, dtype=torch.float32)
  # filled in float64, then rounded as a float32 tensor made from it would
  # be (a deadline past the float32 range is +inf)
  return age, torch.full((), float(deadline), dtype=torch.float64,
                         device=device).to(torch.float32)


def _liveness_collective(age: torch.Tensor, deadline: torch.Tensor,
                         axis) -> torch.Tensor:
  """The deadline-based liveness collective: every shard contributes the
  bit "my last heartbeat landed within the deadline", and the gathered (m,)
  vector IS the straggler mask.  With the m shards stacked on one card the
  gather is the vector itself."""
  return axis.gather(age <= deadline)


def _alive(straggler_keep, liveness_age, liveness_deadline, axis,
           device) -> torch.Tensor:
  """``straggler_keep`` (an (m,) operator input) ANDed with the liveness
  collective over each shard's own age ((m_local,)): (m,) bool."""
  keep = (torch.ones((axis.m,), dtype=torch.bool, device=device)
          if straggler_keep is None
          else torch.as_tensor(straggler_keep, device=device).to(torch.bool))
  age, deadline = _prep_liveness(liveness_age, liveness_deadline,
                                 axis.m_local, device)
  return keep & _liveness_collective(age, deadline, axis)


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
# the merge plan: flat, or the accumulation tree over the stacked shards
# ---------------------------------------------------------------------------


def _norm_branch(m: int, tree_branch: int | None) -> int:
  """The tree's branching factor: default 8, clamped to the shard count
  (b >= m is the one-level tree, which is the flat merge)."""
  b = 8 if tree_branch is None else int(tree_branch)
  if b < 2 and m > 1:
    raise ValueError(f"tree_branch must be >= 2, got {b}")
  return max(min(b, m), 1)


def _tree_factors(m: int, b: int) -> tuple[int, ...]:
  """Inner-to-outer child counts of the accumulation tree over ``m``
  shards: ``b`` children at every level and one final (possibly smaller)
  outer factor, so the product is exactly m and the depth ceil(log_b m)."""
  factors = []
  rem = m
  while rem > b:
    if rem % b:
      raise ValueError(
          f"mesh size {m} does not factor into tree_branch={b} levels "
          f"(need m = b^t * c with c <= b); pick a branch factor whose "
          "powers divide the mesh, or use merge='flat'")
    factors.append(b)
    rem //= b
  factors.append(rem)
  return tuple(factors)


class _Level(NamedTuple):
  """One merge level over the stacked shards: the m shards reshaped into
  m // size groups of ``size`` consecutive combined indices (a subtree),
  each merging the blocks of its ``c`` children."""
  c: int       # children a group merges
  size: int    # shards a group spans
  root: bool   # the last level: one group of all m shards


def _merge_plan(m: int, merge: str,
                tree_branch: int | None) -> tuple[_Level, ...]:
  """The merge levels, inner first: "flat" is one level of one group over
  all m shards; "tree" one level per factor of ``_tree_factors`` (the
  stacked counterpart of the reference's re-viewed mesh: a level's group
  is the subtree its psums span, its children the groups of the level
  below, the shards themselves at the first).  b >= m gives the flat
  plan itself, so its bits are the flat merge's."""
  if merge == "flat":
    return (_Level(m, m, True),)
  if merge != "tree":
    raise ValueError(f"merge must be 'flat' or 'tree', got {merge!r}")
  factors = _tree_factors(m, _norm_branch(m, tree_branch))
  levels, size = [], 1
  for i, c in enumerate(factors):
    size *= c
    levels.append(_Level(c, size, i == len(factors) - 1))
  return tuple(levels)


def merge_peak_rows(m: int, kappa: int, *, merge: str = "flat",
                    tree_branch: int | None = None) -> int:
  """Peak merged-candidate rows a shard holds under the merge: the largest
  block any level gathers.  Flat gathers all m kappa-blocks at once (m *
  kappa rows); the tree at most its widest level's child count (<=
  tree_branch) of them."""
  if merge == "flat":
    return m * kappa
  if merge != "tree":
    raise ValueError(f"merge must be 'flat' or 'tree', got {merge!r}")
  return max(_tree_factors(m, _norm_branch(m, tree_branch))) * kappa


def _group_sum(x: torch.Tensor, size: int) -> torch.Tensor:
  """The reference's psum over a subtree, stacked: x (m, ...) summed over
  each group of ``size`` consecutive shards -> (m // size, ...)."""
  return torch.sum(x.reshape(-1, size, *x.shape[1:]), dim=1)


def _first_alive(keep: torch.Tensor, size: int) -> torch.Tensor:
  """(m // size,) combined index of each group's first alive shard (its
  first shard when none is alive): the Thm-10 U-holder, re-elected per
  subtree from the liveness mask."""
  sub = keep.reshape(-1, size).to(torch.float32)
  first = masked_top1(sub, torch.ones_like(sub, dtype=torch.bool))[1]
  return torch.arange(0, keep.shape[0], size, device=keep.device) + first


def _level_weight(keep: torch.Tensor, size: int,
                  u_subset_eval: bool) -> torch.Tensor:
  """(m,) evaluation weight of each shard at a level: its liveness, times
  (under Thm 10) whether it holds its subtree's U subset."""
  w = keep.to(torch.float32)
  if u_subset_eval:
    holder = _first_alive(keep, size).repeat_interleave(size)
    w = w * (torch.arange(keep.shape[0], device=keep.device)
             == holder).to(torch.float32)
  return w


# ---------------------------------------------------------------------------
# THE distributed-greedy core, stacked form with a group axis
# ---------------------------------------------------------------------------


class _Engine(NamedTuple):
  """What a sharded variant plugs into the shared distributed-greedy loop.

  Gain and value quantities are *local, unnormalized* per-shard
  contributions with a leading shard axis; the core gathers them and sums
  them over each group's shards (the reference's psum over a subtree),
  weighted by each shard's evaluation weight.  A group's shards share its
  candidate block.  The state holds the process's m_local shards.
  """
  state0: Any
  # state -> (m_local, nc) per-shard partial marginal gains of its group's
  # block
  partial_gains: Callable[[Any], torch.Tensor]
  # (state, chosen column (m_local,), its feature row (m_local, d), take
  # (m_local,)) -> new state; every shard gets its group's choice
  apply_update: Callable[[Any, torch.Tensor, torch.Tensor, torch.Tensor], Any]
  # state -> (m,) every shard's partial objective value, gathered
  partial_value: Callable[[Any], torch.Tensor]
  cands: torch.Tensor   # (G, nc, d) candidate block of each group
  cmask: torch.Tensor   # (G, nc) bool selectable
  cgids: torch.Tensor   # (G, nc) int64 global ids of the candidates


def _shard_cands(cands: torch.Tensor, size: int, axis) -> torch.Tensor:
  """Each of the process's shards' candidate block: the one shared block
  (nc, d) for one group, else (m_local, nc, d) with every group's block
  repeated over its shards."""
  if cands.shape[0] == 1:
    return cands[0]
  return axis.mine(cands.repeat_interleave(size, dim=0))


def _objective_engine(objective, local_feats: torch.Tensor,
                      cands: torch.Tensor, cmask: torch.Tensor,
                      cgids: torch.Tensor, size: int, axis,
                      eval_mask: torch.Tensor | None = None,
                      state0=None) -> _Engine:
  """Engine over a generic objective exposing partial_stats/update/value:
  ``local_feats`` (m_local, nl, d) binds each of the process's shards'
  evaluation rows and ``eval_mask`` (m_local, nl) marks the live ones
  (holes carry 0), so the partial value is each shard's mean times its
  live count and hole rows move nothing.  ``cands`` (G, nc, d) holds each
  group of ``size`` shards' block.  ``state0`` is
  ``objective.init(local_feats, eval_mask)`` when the caller has it."""
  rows = kernel_rows(objective, _shard_cands(cands, size, axis))
  if eval_mask is None:
    eval_mask = local_feats.new_ones(local_feats.shape[:-1])
  # count in f32: a low-precision mask dtype would round counts past 256
  # repro: allow(T8): a count of 0/1 mask entries, exact in float32 in any order
  n_live = torch.sum(eval_mask.to(torch.float32), dim=-1)     # (m_local,)

  def partial_gains(state):
    return objective.partial_stats(state, rows)[0]

  def apply_update(state, j, feat, take):
    del j
    return where_state(take, objective.update(state, feat), state)

  def partial_value(state):
    return axis.gather(objective.value(state) * n_live)

  if state0 is None:
    state0 = objective.init(local_feats, eval_mask)
  return _Engine(state0, partial_gains, apply_update, partial_value, cands,
                 cmask, cgids)


def _dist_greedy_core(engine: _Engine, steps: int, weight: torch.Tensor,
                      denom: torch.Tensor, feat_dtype, size: int, axis):
  """Distributed greedy of G = m // size independent groups over their
  candidate blocks, all groups in one batched loop.

  Per step: gather the shards' partial gains over ``axis`` (one all-gather
  a step over ranks, nothing stacked), sum each group's weighted gains
  over its shards, then one ``masked_top1`` per group over gains and
  feasibility (the same tie rule as the fused select oracles); every
  process holds the same gains, so every process takes the same choice.
  ``weight`` (m,) is each shard's evaluation weight (0 for dead machines);
  ``denom`` (G,) each group's weighted live-row count.  One group of all m
  shards is the flat merge.  Returns (sel_feats (G, steps, d), sel_valid
  (G, steps), sel_gids (G, steps), value (G,)), the same on every process.
  """
  cands, cmask, cgids = engine.cands, engine.cmask, engine.cgids
  g_n, nc = cmask.shape
  state = engine.state0
  selmask = torch.zeros((g_n, nc), dtype=torch.bool, device=cands.device)
  outf, outv, outg = [], [], []
  for _ in range(steps):
    gains = _group_sum(axis.gather(engine.partial_gains(state)) *
                       weight[:, None], size) / denom[:, None]
    feasible = cmask & ~selmask
    _, chosen = masked_top1(gains, feasible)                  # (G,)
    take = feasible.any(dim=1)
    feat = _rows(cands, chosen)                               # (G, d)
    state = engine.apply_update(
        state, axis.mine(chosen.repeat_interleave(size)),
        axis.mine(feat.repeat_interleave(size, dim=0)),
        axis.mine(take.repeat_interleave(size)))
    hit = torch.gather(selmask, 1, chosen[:, None]) | take[:, None]
    selmask = selmask.scatter(1, chosen[:, None], hit)
    outf.append(torch.where(take[:, None], feat, 0.0).to(feat_dtype))
    outv.append(take)
    outg.append(torch.where(take, torch.gather(cgids, 1, chosen[:, None])[
        :, 0], -1))
  val = _group_sum(engine.partial_value(state) * weight, size) / denom
  return (torch.stack(outf, dim=1), torch.stack(outv, dim=1),
          torch.stack(outg, dim=1), val)


def _block_values(objective, st0, blocks: torch.Tensor,
                  bvalid: torch.Tensor, m: int) -> torch.Tensor:
  """objective.value of each of the c blocks (c, k, d) replayed on each of
  the m shards' evaluation rows (``st0`` has the leading shard axis), all
  m * c states in one batch: (m, c)."""
  c = blocks.shape[0]
  st_all = _repeat_state(st0, c)                              # entry s*c+i
  vals = objective.value(set_value_feats(
      objective, st_all, blocks.repeat(m, 1, 1), bvalid.repeat(m, 1)))
  return vals.reshape(m, c)


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
      A 3-argument callable also receives the candidate block the state
      will score (round 1: the (m, npp, d) partitions; round 2: the
      (m * kappa, d) merged block), the precompute path of
      ``FacilityLocationPre``.
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
    st0 = _call_init(init_for, parts, pmask.to(parts.dtype), parts)
  else:
    st0 = _call_init(init_for, feats, feats.new_ones((n,)), parts)
  r1 = greedy(objective, objective.broadcast(st0, m), parts, kappa,
              cand_mask=pmask, mode=mode, stop_nonpositive=stop_nonpositive,
              use_select=use_select,
              draws=_round_draws(mode, r1_draws, r_sel, (m,), kappa, npp,
                                 sample_frac, feats.device))
  # the round-1 states (FacilityLocationPre's (m, ne, npp) cache among
  # them) are not needed past here
  del st0
  r1 = r1._replace(state=None)
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
  st_final0 = _call_init(init_for, eval_feats,
                         eval_feats.new_ones(eval_feats.shape[:1]),
                         r1.feats.reshape(m * kappa, d))

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
  st0 = _call_init(init_for, feats, feats.new_ones(feats.shape[:1]), feats)
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
  generators ``greedi_keys`` splits off ``rng``.  A 3-argument
  ``init_for`` receives the candidate block of each greedy run (the
  random pool, the partitions; the ground set for the replays).
  """
  objective = with_backend(objective, backend)
  n, d = feats.shape
  dev = feats.device
  need = perm is None or rr_idx is None or rand_idx is None
  r_part, r_a, r_b, _ = greedi_keys(rng) if need else (None,) * 4
  parts, pmask, _ = random_partition(r_part, feats, m, perm=perm)
  npp = parts.shape[1]
  ones = torch.ones((n,), dtype=feats.dtype, device=dev)
  st_full0 = _call_init(init_for, feats, ones, feats)
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
  pool = pool.reshape(-1, d)
  pool_mask = torch.gather(pmask, 1, rand_idx)
  r = greedy(objective, _call_init(init_for, feats, ones, pool), pool, k,
             cand_mask=pool_mask.reshape(-1),
             stop_nonpositive=stop_nonpositive)
  out["random/greedy"] = objective.value(r.state)

  # -- greedy/merge: ceil(k/m) greedy per machine, merged as-is
  kpm = -(-k // m)
  st_parts0 = objective.broadcast(_call_init(init_for, feats, ones, parts),
                                  m)
  r1 = greedy(objective, st_parts0, parts, kpm, cand_mask=pmask,
              stop_nonpositive=stop_nonpositive)
  merged = r1.feats.reshape(m * kpm, d)[:k]
  mvalid = (r1.idx >= 0).reshape(m * kpm)[:k]
  out["greedy/merge"] = objective.value(
      set_value_feats(objective, st_full0, merged, mvalid))

  # -- greedy/max: greedy k per machine, report the best single solution
  rk = greedy(objective, st_parts0, parts, k, cand_mask=pmask,
              stop_nonpositive=stop_nonpositive)
  vals = objective.value(set_value_feats(
      objective, objective.broadcast(st_full0, m), rk.feats, rk.idx >= 0))
  out["greedy/max"] = torch.max(vals)
  return out


# ---------------------------------------------------------------------------
# the generic engine, m stacked shards
# ---------------------------------------------------------------------------


def _shard_layout(feats: torch.Tensor, m: int, gids, dev):
  """The stacked shard view of a shard-contiguous ground set: (local (m,
  nl, d), local gids (m, nl) int64, live mask (m, nl), live counts (m,))."""
  n, d = feats.shape
  if n % m:
    raise ValueError(f"{n} rows do not split into {m} equal shards")
  if gids is None:
    gids = torch.arange(n, device=dev)
  local_gids = torch.as_tensor(gids, device=dev).to(torch.int64).reshape(
      m, n // m)
  local_valid = local_gids >= 0                       # pad-and-mask holes
  return (feats.reshape(m, n // m, d), local_gids, local_valid,
          shard_live_counts(local_valid, m))


def _finish(v_merged, merged, stage1_vals, children, k_final: int, alive,
            rescans) -> GreediResult:
  """Alg. 2's last step: the merged solution or the best root child's
  block (its first k_final rows), whichever is worth more.  ``merged`` and
  ``children`` are (feats, valid, gids) triples, the children's with a
  leading child axis."""
  best_i = _first_argmax(stage1_vals)
  v_best_single = _pick(stage1_vals, best_i)
  use_merged = v_merged >= v_best_single
  feats, valid, gids = (
      torch.where(use_merged, mine,
                  _take_k(_pick(child, best_i), k_final, fill))
      for mine, child, fill in zip(merged, children, (0.0, False, -1)))
  return GreediResult(feats, valid, torch.maximum(v_merged, v_best_single),
                      v_merged, v_best_single, stage1_vals, gids, alive,
                      rescans)


@_rank_plans
def greedi_sharded(feats: torch.Tensor, *, m: int, kappa: int, k_final: int,
                   objective, straggler_keep: torch.Tensor | None = None,
                   u_subset_eval: bool = False, backend: str | None = None,
                   gids: torch.Tensor | None = None, mode: str = "standard",
                   warm_bounds: torch.Tensor | None = None,
                   liveness_age: torch.Tensor | None = None,
                   liveness_deadline: float | None = None,
                   merge: str = "flat",
                   tree_branch: int | None = None,
                   mesh=None) -> GreediResult:
  """GreeDi over m logical shards for any objective exposing
  init/partial_stats/update/value (the reference's ``greedi_sharded``);
  the merge levels' gains are the shards' weighted partial sums.

  Args:
    feats: (m * npp, d) shard-contiguous ground set (shard b owns rows
      b*npp .. (b+1)*npp - 1); rows with ``gids = -1`` are holes, never
      candidates and never evaluation mass.  With ``mesh`` the rank's own
      (m_local * npp, d) rows, and ``gids``, ``warm_bounds`` and
      ``liveness_age`` its own entries too.
    objective: facility location, saturated coverage or information gain.
    straggler_keep: optional (m,) bool; False machines are dropped at the
      merge and carry no evaluation weight.
    u_subset_eval: Thm-10 mode -- the merge levels and A_max evaluate on
      ONE machine's partition per subtree, held by its first alive shard
      (re-elected from the liveness mask at every level).
    backend: optional gain-oracle backend override for both rounds.
    gids: optional (m * npp,) global ids of the rows (default arange).
    mode: round-1 greedy mode, "standard" (the fused select step) or
      "lazy" (tile-bound lazy rescans; the same selection).  The merge
      levels run the distributed greedy either way.
    warm_bounds: optional (m * npp,) upper bounds on each row's empty-set
      gain under its shard's local evaluation, for the lazy round 1
      (mode="lazy"; standard ignores them): step 0 skips its full pass.
      The selection service's warm start (its validity lives with the
      objective's bound maintainer, core/objectives.py).
    liveness_age, liveness_deadline: optional (m,) heartbeat ages and
      their deadline; the liveness collective turns them into the
      straggler mask (ANDed with ``straggler_keep``), returned as
      ``GreediResult.alive``.
    merge: "flat" (all m kappa-blocks merged at once) or "tree" (the
      accumulation tree: ceil(log_b m) levels, each group of a level runs
      the distributed greedy over its children's blocks, so the largest
      merged block is b * kappa rows instead of m * kappa).  ``tree_branch
      = m`` (any b >= m) is a one-level tree and gives the flat merge's
      bits; otherwise ``stage1_values`` has one entry per root child.
    tree_branch: children per tree node (merge="tree"; default 8); m must
      factor as b^t * c with c <= b.
    mesh: a ``launch.mesh.ProcessMesh`` to run the shards over its ranks
      (the module docstring); the result is the same on every rank and the
      stacked run's.

  A_max replays every root child's block on every shard's evaluation rows
  at once (m * c states in one batch), then sums the shards' partial
  values; a child counts while any shard of its subtree is alive.  The
  shards' initial state is built once and serves round 1, A_max and every
  merge level (saturated coverage's ``init`` is a full pass over the
  shard).
  """
  plan = _merge_plan(m, merge, tree_branch)
  objective = with_backend(objective, backend)
  dev = feats.device
  axis = _shard_axis(mesh, m)
  keep = _alive(straggler_keep, liveness_age, liveness_deadline, axis, dev)
  local, local_gids, local_valid, n_live = _shard_layout(
      feats, axis.m_local, gids, dev)
  n_live = axis.gather(n_live)
  evalw = local_valid.to(feats.dtype)

  # ---- round 1: the local greedy of every shard, one batch ---------------
  st0 = objective.init(local, evalw)
  wb = (None if warm_bounds is None else torch.as_tensor(
      warm_bounds, device=dev).to(torch.float32).reshape(axis.m_local, -1))
  r1 = greedy(objective, st0, local, kappa, cand_mask=local_valid,
              mode=mode, warm_bounds=wb)
  took = r1.idx >= 0
  gsel = torch.where(took, torch.gather(local_gids, 1, r1.idx.clamp_min(0)),
                     -1)

  # ---- merge levels: each group's distributed greedy over its children --
  # one block per child (shard), gathered once: the levels' blocks are the
  # same on every process from here on
  q = tuple(axis.gather(x) for x in (r1.feats,
                                     took & axis.mine(keep)[:, None], gsel))
  for lv in plan:
    kprev = q[0].shape[1]
    w = _level_weight(keep, lv.size, u_subset_eval)
    denom = torch.clamp_min(_group_sum(n_live * w, lv.size), 1.0)   # (G,)
    if lv.root:
      # ---- A_max: each root child's block replayed on every shard ------
      part_vals = axis.gather(_block_values(
          objective, st0, q[0], q[1], axis.m_local))              # (m, c)
      stage1_vals = torch.sum(part_vals * (n_live * w)[:, None],
                              dim=0) / denom
      child_keep = keep.reshape(lv.c, -1).any(dim=1)
      stage1_vals = torch.where(child_keep, stage1_vals, -torch.inf)
      children = q
    blocks = tuple(x.reshape(m // lv.size, lv.c * kprev, *x.shape[2:])
                   for x in q)
    engine = _objective_engine(objective, local, *blocks, lv.size, axis,
                               eval_mask=evalw, state0=st0)
    *q, v_merged = _dist_greedy_core(
        engine, k_final if lv.root else kappa, w, denom, feats.dtype,
        lv.size, axis)
  return _finish(v_merged[0], tuple(x[0] for x in q), stage1_vals,
                 children, k_final, keep, axis.gather(r1.rescans))


# ---------------------------------------------------------------------------
# the cached-similarity fast engine, m stacked shards
# ---------------------------------------------------------------------------


def _column(s: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
  """s[b, :, j[b]] per shard b: s (m, nl, nc), j (m,) -> (m, nl)."""
  m, nl, _ = s.shape
  return torch.gather(s, 2, j.reshape(m, 1, 1).expand(m, nl, 1))[..., 0]


def _fast_r1_standard(s11: torch.Tensor, local_valid: torch.Tensor,
                      kappa: int, colsum):
  """Round 1 of the fast engine, every step a full column pass over the
  cached block: (sel_idx (m, kappa), took (m, kappa))."""
  m, nl = local_valid.shape
  cov = torch.zeros((m, nl), dtype=torch.float32, device=s11.device)
  selmask = torch.zeros((m, nl), dtype=torch.bool, device=s11.device)
  sel_idx, took = [], []
  for _ in range(kappa):
    gains = colsum(s11, cov)
    feasible = ~selmask & local_valid
    _, j = masked_top1(gains, feasible)
    take = feasible.any(dim=1)
    cov = torch.where(take[:, None], torch.maximum(cov, _column(s11, j)), cov)
    hit = torch.gather(selmask, 1, j[:, None]) | take[:, None]
    selmask = selmask.scatter(1, j[:, None], hit)
    sel_idx.append(j)
    took.append(take)
  return torch.stack(sel_idx, dim=1), torch.stack(took, dim=1)


def _fast_r1_lazy(s11: torch.Tensor, local_valid: torch.Tensor, kappa: int,
                  d: int, colsum):
  """Round 1 of the fast engine with tile-bound lazy pruning over the
  cached similarity columns (``mode="lazy"``; the port of
  ``_fast_r1_lazy`` in src/repro/core/greedi.py).

  ``stale[b, j]`` holds column j's last computed gain sum_i relu(s11[b, i,
  j] - cov[b, i]), an upper bound on its current gain: cov only grows, so
  every term shrinks, and ``colsum`` adds the terms of a column in one
  fixed order whichever columns a call takes, so the bound holds in
  floating point too.  Step 0 is one full pass that selects and seeds
  ``stale``.  Every later step sorts the bounds (descending, stable: equal
  bounds keep column order) and rescans bound-sorted column tiles of s11
  (``autotune.lazy_tile`` columns, gathered by the kernel from the ids)
  while the next tile's head bound is >= the running best, score ties to
  the lowest column: the standard step's pick, bit for bit.

  The m shards rescan together, as ``core/greedy._greedy_lazy`` does: one
  batched rescan an iteration, each shard stopping on its own head test (a
  stopped shard's tile is still summed but changes nothing), one host sync
  an iteration (``greedy.lazy_syncs``).  Columns, not rows: hole rows are
  zeroed out of s11 and rbf bits are not symmetric, so s11 is read along
  its columns.  Returns (sel_idx (m, kappa), took (m, kappa), rescans (m,)
  int32).
  """
  m, nl = local_valid.shape
  dev = s11.device
  rescans = torch.zeros((m,), dtype=torch.int32, device=dev)
  tile = autotune.lazy_tile(nl, d)
  tile = max(min(tile, autotune.floor_pow2(nl, cap=tile)), 1)
  npad = -(-nl // tile) * tile
  nt = npad // tile
  valid_pad = _pad_last(local_valid, npad, False)
  int_max = torch.iinfo(torch.int64).max

  # step 0: one full column pass selects AND seeds the bounds
  cov = torch.zeros((m, nl), dtype=torch.float32, device=dev)
  g0 = colsum(s11, cov)
  _, j = masked_top1(g0, local_valid)
  take = local_valid.any(dim=1)
  cov = torch.where(take[:, None], torch.maximum(cov, _column(s11, j)), cov)
  selmask = torch.zeros((m, npad), dtype=torch.bool, device=dev).scatter(
      1, j[:, None], take[:, None])
  stale = _pad_last(g0, npad, NEG)
  sel_idx, took = [j], [take]

  ar = torch.arange(tile, device=dev)
  for _ in range(1, kappa):
    feasible = ~selmask & valid_pad
    pri = torch.where(feasible, stale, NEG)
    sorted_pri, order = torch.sort(pri, dim=-1, descending=True, stable=True)
    p = torch.zeros((m,), dtype=torch.int64, device=dev)
    best = torch.full((m,), -torch.inf, dtype=torch.float32, device=dev)
    bidx = torch.full((m,), int_max, dtype=torch.int64, device=dev)
    while True:
      head = torch.gather(sorted_pri, 1,
                          (p * tile).clamp_max(npad - 1)[:, None])[:, 0]
      go = (p < nt) & (head >= best)
      _greedy.lazy_syncs += 1
      # repro: allow(T5): one read-back a rescan pass is the lazy greedy's contract (greedy.lazy_syncs; the entries' sync budgets)
      if not bool(go.any()):
        break
      ids = torch.gather(order, 1, p.clamp_max(nt - 1)[:, None] * tile + ar)
      g = colsum(s11, cov, ids.clamp_max(nl - 1))  # pad slots: infeasible
      stale = torch.where(go[:, None], stale.scatter(1, ids, g), stale)
      gm = torch.where(torch.gather(feasible, 1, ids), g, NEG)
      tb = gm.max(dim=1).values
      gi = torch.where(gm == tb[:, None], ids, int_max).min(dim=1).values
      better = go & ((tb > best) | ((tb == best) & (gi < bidx)))
      best = torch.where(better, tb, best)
      bidx = torch.where(better, gi, bidx)
      p = p + go
      rescans = rescans + go.to(torch.int32)
    take = feasible.any(dim=1)
    j = torch.where(take, bidx.clamp(0, nl - 1), 0)
    cov = torch.where(take[:, None], torch.maximum(cov, _column(s11, j)), cov)
    hit = torch.gather(selmask, 1, j[:, None]) | take[:, None]
    selmask = selmask.scatter(1, j[:, None], hit)
    sel_idx.append(j)
    took.append(take)
  return torch.stack(sel_idx, dim=1), torch.stack(took, dim=1), rescans


def _cached_engine(s2: torch.Tensor, colsum, blocks, axis) -> _Engine:
  """Engine over a cached (m_local, nl, nc) cross-similarity block: the
  gains are relu column sums of s2, an update takes each shard's chosen
  column.  ``blocks`` are the groups' (cands, cmask, cgids), s2's columns
  in their order.  The value sums the gathered coverage, so its bits are
  the stacked sum's."""
  m, nl, _ = s2.shape
  return _Engine(
      state0=torch.zeros((m, nl), dtype=torch.float32, device=s2.device),
      partial_gains=lambda cov: colsum(s2, cov),
      apply_update=lambda cov, j, feat, take: torch.where(
          take[:, None], torch.maximum(cov, _column(s2, j)), cov),
      partial_value=lambda cov: axis.gather(cov).sum(dim=1),
      cands=blocks[0], cmask=blocks[1], cgids=blocks[2])


@_rank_plans
def greedi_sharded_fast(feats: torch.Tensor, *, m: int, kappa: int,
                        k_final: int, kernel: str = "linear",
                        kernel_kwargs: tuple = (),
                        straggler_keep: torch.Tensor | None = None,
                        backend: str | None = None,
                        gids: torch.Tensor | None = None,
                        mode: str = "standard",
                        merge: str = "flat",
                        tree_branch: int | None = None,
                        liveness_age: torch.Tensor | None = None,
                        liveness_deadline: float | None = None,
                        mesh=None) -> GreediResult:
  """Cached-similarity GreeDi for facility location over m logical shards
  (the reference's ``greedi_sharded_fast``).

    * round 1 caches each shard's (n/m x n/m) similarity block once through
      the ``pairwise`` oracle (one launch for all shards); each greedy step
      is then a masked relu column sum over the cached block (the
      ``relu_colsum`` oracle), every column ("standard") or bound-sorted
      column tiles (``mode="lazy"``, ``_fast_r1_lazy``: the same
      selection, bit for bit);
    * each merge level gathers its groups' candidate blocks (a reshape) and
      caches one (nl, c * kprev) cross block sim(local eval, the group's
      block) per shard, again one ``pairwise`` launch; its distributed
      greedy runs ``_dist_greedy_core`` over the cached columns.  The flat
      merge is one level of one group, the block (nl, m * kappa);
    * A_max needs no replay: f(A_i) = mean_e max over root child i's
      columns of the root level's block.

  Args:
    feats: (m * npp, d) shard-contiguous ground set (shard b owns rows
      b*npp .. (b+1)*npp - 1); with ``mesh`` the rank's own (m_local *
      npp, d) rows, and ``gids`` and ``liveness_age`` its own entries.
    m: number of logical shards.
    straggler_keep: optional (m,) bool; False machines contribute neither
      candidates nor evaluation mass.
    backend: backend of the ``pairwise`` and ``relu_colsum`` oracles
      ("cuda" | "ref" | "auto").
    gids: optional (m * npp,) global ids of the rows (default arange); -1
      marks a hole.
    mode: "standard" or "lazy" (round 1).
    merge, tree_branch: as in ``greedi_sharded`` (b = m gives flat's bits).
    liveness_age, liveness_deadline: as in ``greedi_sharded``.
    mesh: as in ``greedi_sharded``: a rank caches s11 and s2 for its own
      shards only (m_local / m of the stacked memory); round 1, lazy host
      syncs included, stays local.
  """
  if mode not in ("standard", "lazy"):
    raise ValueError(f"mode must be 'standard' or 'lazy', got {mode!r}")
  if kernel not in dispatch.FUSED_SIMS:
    raise ValueError(f"greedi_sharded_fast caches similarities through the "
                     f"'pairwise' oracle and supports {dispatch.FUSED_SIMS}, "
                     f"got {kernel!r}")
  plan = _merge_plan(m, merge, tree_branch)
  sim = dispatch.resolve("pairwise", backend or "auto")
  colsum = dispatch.resolve("relu_colsum", backend or "auto")
  h = _kernel_h(kernel_kwargs)
  d = feats.shape[1]
  dev = feats.device
  axis = _shard_axis(mesh, m)
  keep = _alive(straggler_keep, liveness_age, liveness_deadline, axis, dev)
  local, local_gids, local_valid, n_live = _shard_layout(
      feats, axis.m_local, gids, dev)
  n_live = axis.gather(n_live)
  m_local = axis.m_local
  vrow = local_valid.to(torch.float32)
  w = keep.to(torch.float32)

  # ---- round 1: local greedy over each shard's cached similarity block --
  # hole EVAL rows are zeroed out of the block so they carry no coverage
  # mass (an rbf kernel gives a zero feature row sim > 0); in place, the
  # block is the run's largest tensor
  s11 = sim(local, local, kernel=kernel, h=h)         # (m, nl, nl) f32
  s11.mul_(vrow[:, :, None])
  if mode == "lazy":
    sel_idx, took, rescans = _fast_r1_lazy(s11, local_valid, kappa, d,
                                           colsum)
  else:
    sel_idx, took = _fast_r1_standard(s11, local_valid, kappa, colsum)
    rescans = torch.zeros((m_local,), dtype=torch.int32, device=dev)
  del s11
  sel = torch.gather(local, 1, sel_idx[..., None].expand(m_local, kappa, d))
  # steps past the live local rows find nothing feasible: invalidate them
  # like the reference does, so kappa > live rows leaks no duplicates
  gsel = torch.where(took, torch.gather(local_gids, 1, sel_idx), -1)

  # ---- merge levels: one cached cross block each -------------------------
  # one block per child (shard), gathered once
  q = tuple(axis.gather(x) for x in (sel, axis.mine(keep)[:, None] & took,
                                     gsel))
  for lv in plan:
    kprev = q[0].shape[1]
    denom = torch.clamp_min(_group_sum(n_live * w, lv.size), 1.0)   # (G,)
    blocks = tuple(x.reshape(m // lv.size, lv.c * kprev, *x.shape[2:])
                   for x in q)
    s2 = sim(local, _shard_cands(blocks[0], lv.size, axis), kernel=kernel,
             h=h)
    s2.mul_(vrow[:, :, None])                   # (m_local, nl, c * kprev)
    if lv.root:
      # ---- A_max: no replay needed ---------------------------------------
      # invalid candidate columns (padding past a machine's live rows, or
      # rows of a dead machine) carry no coverage in f(A_i)
      s2_pos = torch.clamp_min(s2, 0.0) * blocks[1].to(torch.float32)
      per_child = axis.gather(s2_pos.reshape(
          m_local, s2.shape[1], lv.c, kprev).amax(dim=3))    # (m, nl, c)
      del s2_pos
      stage1_vals = torch.sum(per_child.sum(dim=1) * w[:, None],
                              dim=0) / denom
      child_keep = keep.reshape(lv.c, -1).any(dim=1)
      stage1_vals = torch.where(child_keep, stage1_vals, -torch.inf)
      children = q
    *q, v_merged = _dist_greedy_core(
        _cached_engine(s2, colsum, blocks, axis),
        k_final if lv.root else kappa, w, denom, feats.dtype, lv.size, axis)
    del s2
  return _finish(v_merged[0], tuple(x[0] for x in q), stage1_vals,
                 children, k_final, keep, axis.gather(rescans))


# ---------------------------------------------------------------------------
# three-level GreeDi: shard -> pod -> global
# ---------------------------------------------------------------------------


@_rank_plans
def greedi_hierarchical(feats: torch.Tensor, *, pods: int, per_pod: int,
                        kappa: int, k_final: int, objective,
                        straggler_keep: torch.Tensor | None = None,
                        backend: str | None = None,
                        gids: torch.Tensor | None = None,
                        mode: str = "standard", mesh=None) -> GreediResult:
  """Three-level GreeDi over pods x per_pod logical shards (the
  reference's ``greedi_hierarchical`` over a (pod, data) mesh), pod-major
  like the shard layout: pod p holds shards p * per_pod .. (p + 1) *
  per_pod - 1.

    * level 1: every shard greedily selects kappa from its partition;
    * level 2: each pod's distributed greedy over its shards' blocks picks
      kappa (gains summed over the pod's shards);
    * level 3: the distributed greedy over the pods' blocks, over all
      shards, picks k_final.

  Both merge levels are ``_dist_greedy_core``, the pods of level 2 one
  batched loop.  ``straggler_keep`` ((pods * per_pod,) bool) masks dead
  shards out of the candidates AND the evaluation weight at every level.
  The best pod-level solution, evaluated over all the alive data, is kept
  beside the global one and the better is returned (Alg. 2's max(A_max,
  A_B)); ``stage1_values`` holds the pods' values (-inf for a pod that
  selected nothing), ``value_best_single`` the best pod's.  With ``mesh``
  (as in ``greedi_sharded``) a pod may sit inside one rank or span
  several: the levels run on the gathered blocks either way.
  """
  objective = with_backend(objective, backend)
  m = pods * per_pod
  dev = feats.device
  axis = _shard_axis(mesh, m)
  keep = _alive(straggler_keep, None, None, axis, dev)
  local, local_gids, local_valid, n_live = _shard_layout(
      feats, axis.m_local, gids, dev)
  n_live = axis.gather(n_live)
  evalw = local_valid.to(feats.dtype)
  w = keep.to(torch.float32)
  nl_w = n_live * w
  denom_pod = torch.clamp_min(_group_sum(nl_w, per_pod), 1.0)   # (pods,)
  denom_all = torch.clamp_min(_group_sum(nl_w, m), 1.0)         # (1,)

  # ---- level 1: the shard-local greedy -----------------------------------
  st0 = objective.init(local, evalw)
  r1 = greedy(objective, st0, local, kappa, cand_mask=local_valid,
              mode=mode)
  took = r1.idx >= 0
  g1 = torch.where(took, torch.gather(local_gids, 1, r1.idx.clamp_min(0)),
                   -1)

  # ---- level 2: each pod's merge and distributed greedy ------------------
  blocks = tuple(axis.gather(x).reshape(pods, per_pod * kappa, *x.shape[2:])
                 for x in (r1.feats, took & axis.mine(keep)[:, None], g1))
  pod_f, pod_v, pod_g, _ = _dist_greedy_core(
      _objective_engine(objective, local, *blocks, per_pod, axis,
                        eval_mask=evalw, state0=st0),
      kappa, w, denom_pod, feats.dtype, per_pod, axis)

  # ---- level 3: the pods' blocks, one distributed greedy over all --------
  blocks = tuple(x.reshape(1, pods * kappa, *x.shape[2:])
                 for x in (pod_f, pod_v, pod_g))
  glob_f, glob_v, glob_g, glob_val = _dist_greedy_core(
      _objective_engine(objective, local, *blocks, m, axis, eval_mask=evalw,
                        state0=st0),
      k_final, w, denom_all, feats.dtype, m, axis)

  # ---- the best pod-level solution, evaluated over all the alive data ----
  part_vals = axis.gather(_block_values(
      objective, st0, pod_f, pod_v, axis.m_local))              # (m, pods)
  pod_vals = torch.sum(part_vals * nl_w[:, None], dim=0) / denom_all
  pod_vals = torch.where(pod_v.any(dim=1), pod_vals, -torch.inf)
  return _finish(glob_val[0], (glob_f[0], glob_v[0], glob_g[0]), pod_vals,
                 (pod_f, pod_v, pod_g), k_final, keep,
                 axis.gather(r1.rescans))
