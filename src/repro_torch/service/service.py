"""Multi-epoch GreeDi over a growing corpus: the epoch path of the
selection service (the port of ``src/repro/service/service.py``).

``CorpusStore`` (service/store.py) owns the data plane: the pad-and-mask
block on the device and the objective's warm-bound table, updated on every
append.  ``SelectionService`` owns the m shards, the heartbeat board and
the epoch schedule.  Each epoch draws a fresh uniform partition of the
block (``core/partition.repartition``) and runs the generic
``greedi_sharded`` with ``mode="lazy"`` over the m shards stacked on the
card.  With a maintained table round 1 is WARM-STARTED: the table divided
by each shard's live count bounds every document's empty-set gain under
any partition (``BoundMaintainer.epoch_bounds``), so the lazy step 0 skips
its full pass and selects what a cold run selects -- for every objective
with a registered maintainer (facility location, saturated coverage,
information gain).  Objectives without one run cold lazy, which is always
exact.

Floating point: the carried bounds are upper bounds mathematically, but the
table and a fresh gains pass sum in different orders, so an un-inflated
bound could undershoot by a few ulps and stop a rescan one tile early.
Every epoch therefore inflates the bounds by ``_BOUND_SLACK_REL`` and
``_BOUND_SLACK_ABS`` (the reference's constants): slack costs some
pruning, never correctness.

Straggler detection is a protocol output: the ``HeartbeatBoard`` ages and
the deadline go into the liveness collective, and the mask comes back as
``EpochStats.alive``.

Randomness: the reference draws epoch t's partition inside its jit from
``fold_in(PRNGKey(seed), t)``.  ``epoch(perm=...)`` takes that
permutation explicitly (the tests pass the reference's); without one it is
drawn from a device generator seeded from ``seed`` and the epoch index, so
a restarted service that replays the same appends repeats its epochs.

Epochs merge flat or through the accumulation tree (``merge="tree"``,
``tree_branch`` children a node; ``tree_branch = m`` is flat, bit for bit).

Over the ranks of a ``launch.mesh.ProcessMesh`` (``mesh=``) each rank holds
its ``m // world`` shards of the store and of the heartbeat board, every
rank makes the same calls (SPMD), and every epoch, sieve answer and
exact-tier answer is the stacked service's, bit for bit, on every rank.  An
epoch fetches the rank's slab of the repartitioned block, gids and table
entries from their owners in one ``ProcessMesh.fetch_rows``, runs
``greedi_sharded(mesh=)`` on it (the rank's own heartbeat ages into the
liveness collective) and returns the same ``EpochResult`` on every rank.
The partition perm is drawn on each rank from the same seed (a device
generator gives the same draw on every card of a kind); ``query`` and
``query_batch`` answer from the rank's replica of the pooled sieves and
make no collective, so any rank serves queries alone.

Queries between epochs: with the standing sieves on (``sieve=True``, the
default, for an objective whose maintainer supports them) ``query``
answers "which k documents now?" after any append by merging the store's
threshold buckets, never touching the corpus block; with nothing appended
since the last epoch it returns that epoch's selection.  ``query_batch``
answers a batch of tenant requests (``QueryRequest``: k, seed, excluded
ids) with one merge call a query tile, each request selecting what it
would select alone; ``tier="exact"`` runs the batched exact greedy over
the resident block instead.  ``service/batching.QueryBatcher`` turns
requests that arrive one at a time into such batches.

Observability (``repro_torch.obs``): ``epoch``, ``query`` and
``query_batch`` are the spans ``service.epoch`` (epoch, warm),
``service.query`` (k, then tier, stale) and ``service.query_batch`` (tier,
batch, stale), whose wall clocks are the stats' ``wall_s``; each feeds the
reference's series (epochs, the epoch wall histogram, value, alive shards,
live documents, capacity, warm, transfer bytes; queries by tier,
staleness, the query wall histogram).  The device-fed epoch diagnostics,
per-shard live evaluation rows and per-shard peak merged rows, are
computed on the device every epoch and read, with the rescans, only while
``obs.enabled()`` (``repro_epoch_eval_mass``, ``repro_merge_peak_rows`` /
``_bytes``, ``repro_lazy_tile_rescans_total``).

No counterpart here: the reference's ``retrace_count`` and its
``repro_epoch_retraces`` gauge (there is no compiled epoch function to
retrace; ``EpochStats`` has no ``retraces``, and the port sets no such
gauge).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import greedi as GD
from repro_torch.core import objectives as O
from repro_torch.core.objectives import NEG
from repro_torch.core.partition import partition_rows, shard_live_counts
from repro_torch.kernels.dispatch import FUSED_SIMS
from repro_torch.service.heartbeat import HeartbeatBoard
from repro_torch.service.store import CorpusStore

# relative / absolute inflation of the carried bounds each epoch (the
# reference's service/service.py constants)
_BOUND_SLACK_REL = 1e-3
_BOUND_SLACK_ABS = 1e-6

# named service objectives; "info_gain" is built with the service's step
# budget as k_max (its state is a fixed-size Cholesky factor)
_OBJECTIVES = {
    "facility": O.FacilityLocation,
    "saturated_coverage": O.SaturatedCoverage,
}


@dataclasses.dataclass(frozen=True)
class EpochStats:
  """Per-epoch stats streamed to the trainer alongside the ids."""
  epoch: int            # epoch index (monotone over the service lifetime)
  n_live: int           # live documents at selection time
  capacity: int         # current pad-and-mask block capacity
  value: float          # f(selection) over the alive data
  alive: np.ndarray     # (m,) protocol-derived liveness mask
  warm: bool            # whether warm bounds with signal were in effect
  wall_s: float         # wall clock of the epoch (device-synced)
  rescans: np.ndarray   # (m,) round-1 lazy tiles rescanned per shard


class EpochResult(NamedTuple):
  sel_gids: np.ndarray  # selected document ids, filtered (no -1 no-ops)
  stats: EpochStats
  raw: Any              # the full GreediResult (tensors on the device)


class QueryResult(NamedTuple):
  """Answer of ``SelectionService.query``, fresh after every append.

  ``value_estimate`` is, for a "sieve" answer, the sieve's own surrogate
  (the picks' redundancy-discounted admission gains summed, over the live
  documents): not f(selection).  For "epoch" and "exact" answers it is the
  exact value.
  """
  sel_gids: np.ndarray     # selected ids, filtered (no -1 padding)
  value_estimate: float
  source: str              # "sieve" | "epoch" (the last epoch's) | "exact"
  appends_since_epoch: int  # appends a "sieve" answer folds in and an
                            # "epoch" answer does not reflect
  wall_s: float            # host wall clock of the query (of the whole
                           # batch for ``query_batch``: each request's
                           # latency)


@dataclasses.dataclass(frozen=True)
class QueryRequest:
  """One tenant's request for ``SelectionService.query_batch``: ``k`` the
  coreset size (None: the service's ``k_final``), ``seed`` the tie-break
  decorrelation (0: none; a default request answers as ``query()``), and
  ``exclude_gids`` the ids this tenant must never get back (at most
  ``store.query_mask_cap``)."""
  k: int | None = None
  seed: int = 0
  exclude_gids: tuple = ()


class SelectionService:
  """Multi-epoch GreeDi over a device-resident growing ground set, m
  stacked shards on one device.

  Args:
    m: GreeDi machines (stacked logical shards).
    d: feature dimension of the corpus embeddings.
    kappa: per-machine round-1 proposals.
    k_final: coreset size per epoch.
    capacity: initial block capacity (rounded up to a multiple of m);
      doubles on overflow.
    kernel / kernel_kwargs / backend: similarity kernel and gain-oracle
      backend.  A passed objective instance's own kernel and backend win
      (the backend when ``backend`` is None), so the bound pass and the
      epochs run the same configuration.
    objective: "facility" (default), "saturated_coverage", "info_gain", or
      an objective instance with the sharded-protocol surface.
    mode: round-1 greedy mode; "lazy" (default) enables the warm start,
      "standard" runs the fused select step.
    warm_start: keep the bound table and thread it into round 1 (lazy mode
      and an objective with a maintainer only; selections are the same
      either way).
    deadline: liveness deadline in seconds; None disables detection.
    seed: seed of the per-epoch partitions drawn when ``epoch`` is given
      no ``perm``.
    append_block: rows per append chunk of the store.
    sieve: keep the store's standing sieves of depth ``k_final`` (needs a
      maintainer that supports them: facility location and saturated
      coverage in lazy mode with warm starts), so ``query`` answers fresh
      between epochs.
    query_mask_cap / query_batch_tile: the store's per-query exclusion
      capacity and the lanes of one batched query call (None: autotuned).
    merge / tree_branch: the epochs' merge (core/greedi.py): "flat" merges
      all m round-1 blocks at once, "tree" through the accumulation tree
      with ``tree_branch`` children a node, so the largest merged block is
      b * kappa rows instead of m * kappa (``merge_peak_rows``).  Checked
      here: m must factor into the tree's levels.
    device: ``cuda`` by default (raises when CUDA is missing unless ``cpu``
      is asked for); with a mesh of the mesh device's type.
    mesh: a ``launch.mesh.ProcessMesh`` of m shards to run them over its
      ranks (the module docstring); None stacks all m on one device.
  """

  def __init__(self, *, m: int, d: int, kappa: int, k_final: int,
               capacity: int = 4096, kernel: str = "linear",
               kernel_kwargs: tuple = (), backend: str | None = None,
               mode: str = "lazy", warm_start: bool = True,
               deadline: float | None = None, seed: int = 0,
               append_block: int = 1024, feat_dtype=torch.float32,
               objective: str | Any = "facility", sieve: bool = True,
               query_mask_cap: int = 16, query_batch_tile: int | None = None,
               merge: str = "flat", tree_branch: int | None = None,
               device="cuda", mesh=None):
    self._m = m
    self._mesh = mesh
    self._d = d
    self._kappa = kappa
    self._k_final = k_final
    self._mode = mode
    self._deadline = deadline
    self._seed = seed
    self._merge = merge
    self._tree_branch = tree_branch
    # validates merge / tree_branch at construction (m must factor) and
    # fixes the largest merged block an epoch gathers
    self.merge_peak_rows = GD.merge_peak_rows(m, kappa, merge=merge,
                                              tree_branch=tree_branch)
    if isinstance(objective, str):
      if objective == "info_gain":
        # one state serves round 1 (kappa steps), round 2 (k_final) and the
        # A_max replay (kappa)
        objective = O.InformationGain(k_max=max(kappa, k_final),
                                      kernel=kernel,
                                      kernel_kwargs=kernel_kwargs)
      elif objective in _OBJECTIVES:
        objective = _OBJECTIVES[objective](kernel=kernel,
                                           kernel_kwargs=kernel_kwargs)
      else:
        raise ValueError(f"objective {objective!r} not in "
                         f"{sorted(_OBJECTIVES) + ['info_gain']} "
                         "(or pass an instance)")
    self._objective = objective
    kernel = getattr(objective, "kernel", kernel)
    kernel_kwargs = getattr(objective, "kernel_kwargs", kernel_kwargs)
    if backend is None:
      backend = getattr(objective, "backend", None)
    self._backend = backend
    self._maintainer = (O.bound_maintainer_for(objective)
                        if warm_start and mode == "lazy" else None)
    self._warm = self._maintainer is not None
    self._epoch_idx = 0
    self._appends_since_epoch = 0
    self._last_epoch: EpochResult | None = None
    self.store = CorpusStore(
        m=m, d=d, capacity=capacity, append_block=append_block,
        kernel=kernel, kernel_kwargs=kernel_kwargs, backend=backend,
        maintainer=self._maintainer, sieve_k=k_final if sieve else 0,
        query_mask_cap=query_mask_cap, query_batch_tile=query_batch_tile,
        feat_dtype=feat_dtype, device=device, mesh=mesh)
    self.board = HeartbeatBoard(m, mesh=mesh)

  # ---- public surface ------------------------------------------------------

  @property
  def n_docs(self) -> int:
    return self.store.n_docs

  @property
  def capacity(self) -> int:
    return self.store.capacity

  @property
  def growths(self) -> int:
    return self.store.growths

  @property
  def warm(self) -> bool:
    """Whether warm bounds are configured (lazy mode and a maintainer)."""
    return self._warm

  @property
  def objective(self):
    return self._objective

  @property
  def mesh(self):
    """The ``ProcessMesh`` the shards run over (None: stacked)."""
    return self._mesh

  @property
  def sieve_enabled(self) -> bool:
    """Whether the store keeps standing sieves, i.e. ``query`` answers
    fresh after every append."""
    return self.store.sieve_enabled

  @property
  def appends_since_epoch(self) -> int:
    return self._appends_since_epoch

  def append(self, feats, gids=None) -> None:
    """Grow the ground set through the store: the new rows land in the
    resident block and, with a maintainer, one bound pass per chunk keeps
    the table valid (and the standing sieves admit the rows).  Duplicate
    explicit gids raise ``ValueError`` before anything is written."""
    n_before = self.store.n_docs
    self.store.append(feats, gids)
    if self.store.n_docs > n_before:
      self._appends_since_epoch += 1

  def _norm_k(self, k: int | None) -> int:
    k = self._k_final if k is None else int(k)
    if not 0 < k <= self._k_final:
      raise ValueError(f"k must be in (0, {self._k_final}], got {k}")
    return k

  def _norm_excl(self, exclude_gids) -> np.ndarray | None:
    """A tenant's exclusion list as a (query_mask_cap,) -1-padded array
    (None when empty)."""
    if exclude_gids is None:
      return None
    a = np.asarray(exclude_gids, np.int64).ravel()
    if a.size == 0:
      return None
    if (a < 0).any():
      raise ValueError("exclude_gids must be >= 0")
    mc = self.store.query_mask_cap
    if a.size > mc:
      raise ValueError(
          f"at most {mc} excluded gids per query (store query_mask_cap; "
          f"got {a.size})")
    out = np.full((mc,), -1, np.int64)
    out[:a.size] = a
    return out

  def _epoch_answers(self, excl, seed: int) -> bool:
    """Whether a request is answered by the last epoch: no filter, no seed,
    an epoch run, and nothing appended since (or no sieve to do better)."""
    return (excl is None and seed == 0 and self._last_epoch is not None
            and (self._appends_since_epoch == 0
                 or not self.store.sieve_enabled))

  def _need_sieve(self, what: str) -> None:
    if not self.store.sieve_enabled:
      raise RuntimeError(
          f"{what} needs a standing sieve (an objective with a sum-form "
          "bound maintainer) or at least one completed epoch (and masked / "
          "seeded queries always need the sieve)")

  def query(self, k: int | None = None, *, seed: int = 0,
            exclude_gids=None, jitter=None) -> QueryResult:
    """Give me k representatives now, without running the protocol.

    With the standing sieve on, the answer reflects every append so far:
    the store merges its buckets on the device and reads back the (k,)
    winners once.  With nothing appended since the last epoch the epoch's
    selection is returned as it is; without a sieve the last epoch's
    selection is the answer (stale by ``appends_since_epoch`` appends).
    ``exclude_gids`` hides up to ``store.query_mask_cap`` ids and ``seed``
    != 0 decorrelates tie-breaks (``jitter``: its uniforms, as in
    ``CorpusStore.query_sieves``); either one needs the sieve.
    """
    k = self._norm_k(k)
    with obs.span("service.query", k=k) as sp:
      excl = self._norm_excl(exclude_gids)
      stale = self._appends_since_epoch
      if self._epoch_answers(excl, seed):
        le = self._last_epoch
        src, sel, val = "epoch", le.sel_gids[:k], float(le.stats.value)
      else:
        self._need_sieve("query()")
        gids, scores = self.store.query_sieves(k=k, exclude_gids=excl,
                                               seed=seed, jitter=jitter)
        slots = gids[:k]
        sel = slots[slots >= 0]
        # only live winner slots count (k can exceed the live winners)
        val = float(scores[:k][slots >= 0].sum()) / max(self.store.n_docs,
                                                         1)
        src = "sieve"
      sp.add(tier=src, stale=stale)
    self._feed_query_metrics(src, 1, stale, sp.wall_s, path="single")
    return QueryResult(sel, val, src, stale, sp.wall_s)

  def query_batch(self, requests, tier: str = "sieve") -> list[QueryResult]:
    """Answer a batch of tenant requests with one merge call a query tile
    instead of one a request.

    ``requests`` are ``QueryRequest`` (an int is a k-only shorthand, None
    all defaults).  Routing mirrors ``query()``: default requests take the
    last epoch's answer when nothing is stale, the rest drain through the
    batched sieve merge, so each request selects what it would select
    alone.  Every result's ``wall_s`` is the whole batch's.

    ``tier="exact"`` runs every request through the exact tier instead: a
    batched greedy facility-location pass over the resident block (one
    batched select a pick serves all tenants), values exact over each
    tenant's visible rows.  Facility location with a fused similarity only;
    under a mesh a collective (every rank calls it with the same requests).
    """
    if tier not in ("sieve", "exact"):
      raise ValueError(f"tier must be 'sieve' or 'exact', got {tier!r}")
    reqs = [r if isinstance(r, QueryRequest)
            else QueryRequest() if r is None else QueryRequest(k=int(r))
            for r in requests]
    with obs.span("service.query_batch", tier=tier, batch=len(reqs)) as sp:
      stale = self._appends_since_epoch
      sp.add(stale=stale)
      answers = self._answer_batch(reqs, tier)
    for src in sorted(set(a[0] for a in answers)):
      self._feed_query_metrics(src, sum(1 for a in answers if a[0] == src),
                               stale, sp.wall_s, path="batch")
    return [QueryResult(sel, val, src, stale, sp.wall_s)
            for src, sel, val in answers]

  def _answer_batch(self, reqs, tier: str) -> list:
    """(source, ids, value) for every request of a batch (``query_batch``'s
    routing)."""
    norm = [(self._norm_k(r.k), self._norm_excl(r.exclude_gids or None),
             int(r.seed)) for r in reqs]
    mc = self.store.query_mask_cap

    def pack_excl(sub):
      return (np.stack([e if e is not None else np.full((mc,), -1, np.int64)
                        for e in sub]) if sub
              else np.zeros((0, mc), np.int64))

    if tier == "exact":
      if not isinstance(self._objective, O.FacilityLocation):
        raise ValueError(
            "tier='exact' supports the facility-location objective only "
            f"(got {type(self._objective).__name__})")
      if getattr(self._objective, "kernel", None) not in FUSED_SIMS:
        raise ValueError(f"tier='exact' needs a fused similarity kernel "
                         f"({FUSED_SIMS})")
      ks = np.array([k for k, _, _ in norm], np.int64)
      g, s, nvis = self.store.query_exact_batch(
          ks, pack_excl([e for _, e, _ in norm]), k_cap=self._k_final)
      answers = []
      for i, (k, _, _) in enumerate(norm):
        slots = g[i, :k]
        val = float(s[i, :k][slots >= 0].sum()) / max(float(nvis[i]), 1.0)
        answers.append(("exact", slots[slots >= 0], val))
    else:
      answers = [None] * len(reqs)
      batch_idx = []
      for i, (k, excl, seed) in enumerate(norm):
        if self._epoch_answers(excl, seed):
          le = self._last_epoch
          answers[i] = ("epoch", le.sel_gids[:k], float(le.stats.value))
        else:
          self._need_sieve("query_batch()")
          batch_idx.append(i)
      if batch_idx:
        ks = np.array([norm[i][0] for i in batch_idx], np.int64)
        sd = np.array([norm[i][2] for i in batch_idx], np.int64)
        g, s = self.store.query_sieves_batch(
            ks, pack_excl([norm[i][1] for i in batch_idx]), sd)
        nd = max(self.store.n_docs, 1)
        for j, i in enumerate(batch_idx):
          slots = g[j, :norm[i][0]]
          val = float(s[j, :norm[i][0]][slots >= 0].sum()) / nd
          answers[i] = ("sieve", slots[slots >= 0], val)
    return answers

  def epoch_perm(self, epoch: int | None = None) -> torch.Tensor:
    """The (capacity,) partition permutation this service draws for epoch
    ``epoch`` (default: the next one) when ``epoch`` gets no ``perm``; the
    same on every rank of a mesh (each draws it from the same seed on its
    own device, a generator of one device kind giving the same draw)."""
    t = self._epoch_idx if epoch is None else epoch
    dev = self.store.device
    g = torch.Generator(device=dev).manual_seed(
        (self._seed * 1_000_003 + t) % (2**63))
    return torch.randperm(self.store.capacity, generator=g, device=dev)

  def _epoch(self, perm: torch.Tensor, ages: torch.Tensor,
             deadline: float):
    """Re-partition the block, derive the warm bounds, run GreeDi.
    Returns the GreediResult and the device-fed diagnostics: each shard's
    live evaluation rows under this partition and its peak merged rows
    ((m,) int64 each, on the device).  Under a mesh the rank's slab of the
    partition (its m_local shards' rows, gids and table entries) comes in
    one ``fetch_rows``; ``ages`` are its own shards'."""
    st, mesh = self.store, self._mesh
    m = self._m
    npp = st.capacity // m
    ml = m if mesh is None else mesh.m_local
    # cap is a multiple of m: the perm has no padding of its own, and the
    # only holes are the block's gid = -1 rows
    slab = perm.reshape(m, npp)
    if mesh is not None:
      slab = slab[mesh.shards]
    feats_sh, gids_sh, table_sh = partition_rows(
        slab, [st.feats, st.gids, st.table], mesh)
    wb = None
    if self._warm:
      valid_sh = gids_sh >= 0
      nv = shard_live_counts(valid_sh, ml).to(torch.float64)
      wb = torch.where(valid_sh, table_sh, NEG)
      # sum-form table -> per-shard mean-form empty-set bounds, inflated by
      # the slack that covers f32 summation-order noise
      wb = self._maintainer.epoch_bounds(wb, nv.repeat_interleave(npp))
      wb = (wb * (1.0 + _BOUND_SLACK_REL) + _BOUND_SLACK_ABS).to(
          torch.float32)
    r = GD.greedi_sharded(
        feats_sh, m=m, kappa=self._kappa,
        k_final=self._k_final, objective=self._objective,
        backend=self._backend, gids=gids_sh, mode=self._mode,
        warm_bounds=wb, liveness_age=ages, liveness_deadline=deadline,
        merge=self._merge, tree_branch=self._tree_branch, mesh=mesh)
    eval_mass = shard_live_counts(gids_sh >= 0, m, mesh).to(torch.int64)
    merge_rows = torch.full((m,), self.merge_peak_rows, dtype=torch.int64,
                            device=st.device)
    return r, eval_mass, merge_rows

  def epoch(self, perm: torch.Tensor | None = None) -> EpochResult:
    """Run one selection epoch: re-partition, select, return ids + stats.

    ``perm`` is the epoch's (capacity,) or (m, capacity/m) permutation of
    the block rows; by default ``epoch_perm()``.
    """
    st = self.store
    dev = st.device
    perm = torch.as_tensor(self.epoch_perm() if perm is None else perm)
    ages = torch.as_tensor(self.board.ages(), dtype=torch.float32)
    # host-to-device bytes: the ages, and an injected host permutation
    h2d = sum(t.nbytes for t in (perm, ages) if t.device != dev)
    perm = perm.to(device=dev, dtype=torch.int64)
    ages = ages.to(dev)
    deadline = float("inf") if self._deadline is None else self._deadline
    # "warm" means bounds with signal were threaded: a configured-warm
    # service whose table is still all zeros ran this epoch effectively cold
    warm_eff = self._warm and st.bounds_populated
    if dev.type == "cuda":
      torch.cuda.synchronize(dev)
    with obs.span("service.epoch", epoch=self._epoch_idx,
                  warm=warm_eff) as sp:
      r, eval_mass, merge_rows = self._epoch(perm, ages, deadline)
      if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    host = [x.cpu().numpy() for x in (r.sel_valid, r.sel_gids, r.value,
                                      r.alive, r.r1_rescans)]
    sv, sel_all, value, alive, rescans = host
    sel = sel_all[sv]
    keep = sel >= 0
    sel = sel[keep]
    stats = EpochStats(epoch=self._epoch_idx, n_live=st.n_docs,
                       capacity=st.capacity, value=float(value),
                       alive=alive, warm=warm_eff, wall_s=sp.wall_s,
                       rescans=rescans)
    self._feed_epoch_metrics(
        stats, eval_mass, merge_rows, h2d_bytes=h2d,
        d2h_bytes=sum(a.nbytes for a in host) if dev.type != "cpu" else 0)
    self._epoch_idx += 1
    result = EpochResult(sel, stats, r)
    # the epoch's selection seeds the fresh sieve grid, re-derived from the
    # whole corpus' standing gains: queries between epochs start from (at
    # least) the refined selection
    if st.sieve_enabled:
      st.reset_sieves(r.sel_feats.float().cpu().numpy()[sv][keep], sel)
    self._appends_since_epoch = 0
    self._last_epoch = result
    return result

  def _feed_query_metrics(self, tier: str, n: int, stale: int,
                          wall_s: float, path: str) -> None:
    reg = obs.REGISTRY
    reg.counter("repro_queries_total",
                "queries answered, by serving tier").inc(n, tier=tier)
    reg.gauge("repro_query_staleness_appends",
              "appends since the last epoch at answer time").set(stale)
    reg.histogram("repro_query_wall_seconds",
                  "query wall clock (batch: whole drained batch)").observe(
                      wall_s, path=path)

  def _feed_epoch_metrics(self, stats: EpochStats, eval_mass, merge_rows,
                          *, h2d_bytes: int, d2h_bytes: int) -> None:
    """Feed the registry after an epoch: host values always; the
    device-fed per-shard eval mass and merge rows, and the rescans, only
    while obs is enabled (one device-to-host copy)."""
    reg = obs.REGISTRY
    reg.counter("repro_epochs_total", "selection epochs run").inc()
    xfer = reg.counter("repro_transfer_bytes_total",
                       "host<->device bytes moved, by path")
    xfer.inc(h2d_bytes, path="epoch_h2d")
    xfer.inc(d2h_bytes, path="epoch_d2h")
    reg.histogram("repro_epoch_wall_seconds",
                  "device-synced epoch wall clock").observe(stats.wall_s)
    reg.gauge("repro_epoch_value", "f(selection) of the last epoch").set(
        stats.value)
    reg.gauge("repro_alive_shards",
              "shards the liveness collective kept last epoch").set(
                  int(stats.alive.sum()))
    reg.gauge("repro_corpus_live_docs", "live documents").set(stats.n_live)
    reg.gauge("repro_corpus_capacity", "pad-and-mask capacity").set(
        stats.capacity)
    reg.gauge("repro_epoch_warm", "1 when warm bounds carried signal").set(
        int(stats.warm))
    if not obs.enabled():
      return
    em, rows = torch.stack([eval_mass, merge_rows]).cpu().numpy()
    row_bytes = self._d * self.store.feats.element_size()
    for i in range(em.shape[0]):
      reg.gauge("repro_epoch_eval_mass",
                "per-shard live evaluation rows (device-fed)").set(
                    int(em[i]), shard=i)
      reg.gauge("repro_merge_peak_rows",
                "per-shard peak merged-candidate rows gathered by the "
                "epoch merge (device-fed; b*kappa tree vs m*kappa flat)"
                ).set(int(rows[i]), shard=i)
      reg.gauge("repro_merge_peak_bytes",
                "per-shard peak merged-candidate bytes (rows * d * "
                "itemsize)").set(int(rows[i]) * row_bytes, shard=i)
    reg.counter("repro_lazy_tile_rescans_total",
                "round-1 lazy tiles rescanned (device-fed)").inc(
                    int(stats.rescans.sum()))

  def selections(self, n_epochs: int) -> Iterator[np.ndarray]:
    """Yield ``sel_gids`` for ``n_epochs`` epochs."""
    for _ in range(n_epochs):
      yield self.epoch().sel_gids
