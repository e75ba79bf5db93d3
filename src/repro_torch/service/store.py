"""Device-resident corpus block with a maintained warm-bound table (the port
of the data plane of ``src/repro/service/store.py``).

The block is one ``(capacity, d)`` feature tensor, its ``(capacity,)`` gids
(-1 = hole) and the ``(capacity,)`` bound table, all on the service's
device.  The reference shards them row-wise over a mesh of m devices;
here the m shards are stacked on one card, and shard s owns rows
``s * capacity/m .. (s+1) * capacity/m - 1`` -- the same layout, so the
per-shard arithmetic of the bound pass is the reference's.

* ``append`` writes the new rows in ``append_block`` chunks at the end of
  the live rows, after the host-side duplicate-gid checks have passed for
  the whole batch (nothing is written when one fails).  With a maintainer,
  each chunk runs one (append_block x capacity) bound pass over the block
  as (m, capacity/m) shards (``BoundMaintainer.append_update``): every
  older document's entry gains the new rows' relu similarity mass, and
  each new row's entry is its own sum over the block, summed per shard and
  then over the shards, as the reference's shard-local sums and psum.
* growth doubles the capacity on the device; the block, the gids and the
  table are carried over bit for bit.
* The table is native float64 on the device.  The reference keeps a
  double-float (hi, lo) pair of f32 words because its device has no f64;
  both keep f32 summation drift far below the epoch's bound slack.

Select-on-append (the standing sieves): when the maintainer supports it
(``supports_sieve``, the sum-form tables), each shard also keeps T =
O(log Delta / eps) threshold buckets of up to ``sieve_k`` members, (m * T,
k) ids and gains, (m * T, k, d) float32 features and (m * T,) counts,
with the running max singleton gain Delta and the grid's top exponent
``jtop`` per shard.  Every append chunk, after its bound pass, folds the
chunk's summed ``sums`` (the admission gains) into Delta, rolls the
buckets down when the grid top moved (a gather over the bucket axis, so
no host sync), and streams the chunk's rows through ``ops.sieve_update``
for the shards the chunk lands on (the others' update is a no-op in the
reference): two ``pairwise`` sweeps and one ``csrc/sieve.cu`` scan.
Growth leaves the sieve state as it is (its shapes do not depend on the
capacity).

Over the ranks of a ``launch.mesh.ProcessMesh`` (``mesh=``) the layout is
the same, and a rank allocates only its ``m // world`` contiguous shards'
rows of the block, the gids and the table, and their standing sieves; the
calls are SPMD (every rank calls ``append``, ``reserve``, ``reset_sieves``
and ``query_exact_batch`` with the same arguments) and every result is the
stacked store's, bit for bit:

* an append chunk writes the rows its shards own; the bound pass runs over
  them, and the per-shard partial ``sums`` are gathered and summed over the
  shards in stacked order (never an ``all_reduce``, whose order follows
  the ring), so Delta and the grid are the same on every rank and the
  admission scan runs for the rank's shards among those the chunk lands
  on;
* growth remaps flat rows to shards, so rows change ranks: they move
  through ``ProcessMesh.fetch_rows`` (block, gids and table in one
  exchange), bit for bit;
* every rank keeps a replica of the pooled sieve state (the query pool),
  refreshed by one all-gather at the end of each ``append`` call and set
  by ``reset_sieves`` / ``set_sieve_state``, so the sieve tier makes no
  collective: any rank answers a query alone (a ``QueryBatcher``'s worker
  thread included);
* the exact tier gathers the block once a call and runs the stacked greedy
  on it (bit for bit; its work is not split over the ranks, so it is a
  collective every rank calls);
* ``reset_sieves`` re-grids from the max over the ranks' tables and looks
  the epoch's picks up with one all-gather of the ranks' (hit, entry)
  pairs.

The query surface merges the standing buckets into a coreset without
touching the corpus block:

* ``query_sieves`` / ``query_sieves_batch``: the m * T * k pooled members
  through a k-step MMR greedy (the admission score against the picks so
  far), per query tile of ``query_batch_tile`` lanes: one ``pairwise``
  call a pick for the whole tile, and one read-back of the tile's ids and
  scores.  Per query: ``k`` (picks past it are masked; greedy prefixes
  nest), a -1-padded exclusion list of ``query_mask_cap`` ids, and a seed
  whose tie-break jitter multiplies each score by 1 + 1e-4 u (seed 0: by
  exactly 1).  The reference draws u with ``jax.random``; here it is an
  explicit ``jitter`` argument, or drawn from a ``torch.Generator`` seeded
  with the seed.
* ``query_exact_batch``: the exact tier, a batched greedy facility
  location over the resident block, one batched facility select a pick
  (per-tenant visibility on the batch axis).
* ``reset_sieves``: the epoch hand-off, clearing the buckets, re-gridding
  from the table's max and seeding shard 0's buckets with the epoch's
  selection on the host.

Metrics (``repro_torch.obs``, the reference's names): every append chunk
counts its chunk, rows and host-to-device bytes and sets the growth gauge;
the standing sieves' admissions and considered rows of a chunk are
computed on the device every time (the admissions as the change of the
bucket counts across the scan, no output of ``csrc/sieve.cu``) and, with
the sieve grid's top exponent, read to the host only while
``obs.enabled()``, so with obs off an append chunk still makes no host
sync.  The query tiers count their transfer bytes by path.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.core.objectives import _kernel_h
from repro_torch.kernels import autotune, dispatch
from repro_torch.kernels.ref import NEG
from repro_torch.launch.mesh import pack_rows, unpack_rows

_JTOP_COLD = -(1 << 30)  # sieve grid sentinel: no positive gain seen yet
# relative tie-break jitter of seeded queries: big enough to decorrelate
# near-equal candidates across tenants, small enough never to reorder
# admission scores with a real gap (the reference's constant)
_QUERY_JITTER = 1e-4


def _sieve_n_thresholds(sieve_k: int, eps: float) -> int:
  """Bucket count covering the SieveStreaming grid [Delta/(2k), Delta]."""
  return int(np.ceil(np.log(2 * sieve_k) / np.log1p(eps))) + 1


def _np_sim(a: np.ndarray, b: np.ndarray, kernel: str, h: float) -> np.ndarray:
  """Host similarity of the epoch-reset sieve replay (kernels/ref._sim in
  numpy float32)."""
  a = a.astype(np.float32)
  b = b.astype(np.float32)
  if kernel == "linear":
    return a @ b.T
  d2 = np.maximum(np.sum(a * a, axis=-1)[:, None] - 2.0 * (a @ b.T)
                  + np.sum(b * b, axis=-1)[None, :], 0.0)
  return np.exp(-d2 / (h * h))


class SieveState(NamedTuple):
  """The standing sieves of all m shards, bucket p of shard s at row s * T
  + p: ids (m * T, k) int64 (-1 = empty), admission gains (m * T, k)
  float32, member features (m * T, k, d) float32, counts (m * T,) int64,
  and the running Delta (m,) float32 and grid top exponent jtop (m,)
  int64 (``_JTOP_COLD`` before any positive gain)."""
  gid: torch.Tensor
  gain: torch.Tensor
  feat: torch.Tensor
  count: torch.Tensor
  delta: torch.Tensor
  jtop: torch.Tensor


class CorpusStore:
  """Pad-and-mask corpus block with maintained warm bounds, m stacked shards.

  Args:
    m: shards of the block (the service's GreeDi machines).
    d: feature dimension.
    capacity: initial block capacity, rounded up to a multiple of m;
      doubles on overflow (``append`` grows automatically, ``reserve``
      pre-grows).
    append_block: rows per append chunk (one bound pass each).
    kernel / kernel_kwargs / backend: similarity and oracle backend of the
      maintainer's bound pass (unused when ``maintainer`` is None).
    maintainer: the objective's bound maintainer
      (``core.objectives.bound_maintainer_for``) or None to keep no table.
    sieve_k: standing-sieve depth (bucket size, the largest query coreset);
      0 disables the sieve.  Needs a maintainer with ``supports_sieve``
      (its sums are the admission gains); otherwise the store keeps none.
    sieve_eps: geometric grid ratio of the threshold sieve (1 + eps).
    query_mask_cap: per-query exclusion-list capacity of the query paths.
    query_batch_tile: lanes of one batched query call; None takes
      ``kernels/autotune.query_tile`` for the device.  Ragged batches pad
      up to it, bigger ones run tile by tile.
    feat_dtype: storage dtype of the feature rows.
    device: where the block lives; ``cuda`` by default (raises when CUDA is
      missing unless ``cpu`` is asked for).  With a mesh it must be of the
      mesh device's type, and the block lives on ``mesh.device``.
    mesh: a ``launch.mesh.ProcessMesh`` of m shards to hold this rank's
      shards only (the module docstring); None stacks all m here.
  """

  def __init__(self, *, m: int, d: int, capacity: int = 4096,
               append_block: int = 1024, kernel: str = "linear",
               kernel_kwargs: tuple = (), backend: str | None = None,
               maintainer=None, sieve_k: int = 0, sieve_eps: float = 0.5,
               query_mask_cap: int = 16, query_batch_tile: int | None = None,
               feat_dtype=torch.float32, device="cuda", mesh=None):
    self._dev = resolve_device(device)
    self._mesh = mesh
    self._first, self._m_local = 0, m
    if mesh is not None:
      if mesh.m != m:
        raise ValueError(f"m={m} but the mesh has {mesh.m} shards")
      if mesh.device.type != self._dev.type:
        raise ValueError(f"device {self._dev} but the mesh computes on "
                         f"{mesh.device}")
      self._dev = mesh.device
      self._first, self._m_local = mesh.first, mesh.m_local
    self._m = m
    self._d = d
    self._append_block = append_block
    self._kernel = kernel
    self._h = _kernel_h(kernel_kwargs)
    self._backend = backend
    self._maintainer = maintainer
    self._feat_dtype = feat_dtype
    self._cap = self._round_capacity(max(capacity, append_block))
    self._n = 0
    self._next_gid = 0
    # duplicate-id bookkeeping, host-side and O(ids the caller chose):
    # auto-allocated ids are contiguous watermark ranges (merged), explicit
    # ids go in a set
    self._auto_ranges: list[tuple[int, int]] = []
    self._explicit_gids: set[int] = set()
    self._growths = 0
    self._bounds_seen = False
    # whether a bound pass has written a nonzero entry: the table holds
    # sums of nonnegative terms, so it is nonzero exactly where some new
    # row's (global) sum was, and every rank sees the same flag
    self._nonzero = torch.zeros((), dtype=torch.bool, device=self._dev)
    self._sieve_k = 0
    self._sieve_eps = float(sieve_eps)
    if sieve_k and getattr(maintainer, "supports_sieve", False):
      self._sieve_k = int(sieve_k)
    self._sieve_T = (_sieve_n_thresholds(self._sieve_k, self._sieve_eps)
                     if self._sieve_k else 0)
    # log1p(eps) as float32: the reference's weakly typed Python float
    # meets float32 arrays, so its grid arithmetic runs in float32
    self._log1pe = torch.tensor(np.log1p(self._sieve_eps),
                                dtype=torch.float32, device=self._dev)
    self._mask_cap = int(query_mask_cap)
    self._qb_tile = (int(query_batch_tile) if query_batch_tile
                     else autotune.query_tile(self._dev.type))
    self._query_count = 0
    self._query_batch_calls = 0
    self._query_batch_queries = 0
    # host<->device bytes of the current query call (transfer metrics)
    self._h2d_bytes = 0
    self._d2h_bytes = 0
    self._alloc(self._cap)
    self._alloc_sieve()

  # ---- placement -----------------------------------------------------------

  def _round_capacity(self, cap: int) -> int:
    """Smallest multiple of m >= cap (the block splits into m shards)."""
    return -(-cap // self._m) * self._m

  def _span(self, cap: int) -> tuple[int, int]:
    """(first global row, rows) this process holds at capacity ``cap``."""
    npp = cap // self._m
    return self._first * npp, self._m_local * npp

  def _overlap(self, n0: int, cb: int) -> tuple[int, int]:
    """The global rows [g0, g1) of rows n0 .. n0 + cb - 1 this process
    holds (g1 <= g0: none)."""
    lo, rows = self._span(self._cap)
    return max(n0, lo), min(n0 + cb, lo + rows)

  def _alloc(self, cap: int) -> None:
    rows = self._span(cap)[1]
    self._feats = torch.zeros((rows, self._d), dtype=self._feat_dtype,
                              device=self._dev)
    self._gids = torch.full((rows,), -1, dtype=torch.int64, device=self._dev)
    self._table = torch.zeros((rows,), dtype=torch.float64, device=self._dev)

  def _alloc_sieve(self) -> None:
    """The empty standing sieves: shapes independent of the capacity, so
    growth leaves them as they are.  Features are float32 whatever the
    block's dtype, as in the reference."""
    self._sieve = self._pool_state = None
    if not self._sieve_k:
      return
    t, k, dev = self._sieve_T, self._sieve_k, self._dev

    def empty(m):
      return SieveState(
          torch.full((m * t, k), -1, dtype=torch.int64, device=dev),
          torch.zeros((m * t, k), dtype=torch.float32, device=dev),
          torch.zeros((m * t, k, self._d), dtype=torch.float32, device=dev),
          torch.zeros((m * t,), dtype=torch.int64, device=dev),
          torch.zeros((m,), dtype=torch.float32, device=dev),
          torch.full((m,), _JTOP_COLD, dtype=torch.int64, device=dev))

    self._sieve = empty(self._m_local)
    if self._mesh is not None:
      self._pool_state = empty(self._m)

  @property
  def _pool(self) -> SieveState | None:
    """The pooled sieve state of all m shards the query tiers merge: the
    state itself when stacked, a rank's replica under a mesh."""
    return self._sieve if self._mesh is None else self._pool_state

  def _mine(self, state: SieveState) -> SieveState:
    """This rank's shards of an all-shard sieve state."""
    t, a, b = self._sieve_T, self._first, self._first + self._m_local
    return SieveState(*(x[a * t:b * t] for x in state[:4]),
                      *(x[a:b] for x in state[4:]))

  def _refresh_pool(self) -> None:
    """The query pool from every rank's sieves: one all-gather of each
    shard's state packed as bytes, unpacked bit for bit."""
    sv, ml, m = self._sieve, self._m_local, self._m
    parts = [x.reshape(ml, -1) for x in sv]
    full = unpack_rows(self._mesh.all_gather(pack_rows(parts)), parts)
    self._pool_state = SieveState(*(
        f.reshape(m * x.shape[0] // ml, *x.shape[1:])
        for f, x in zip(full, sv)))

  def _grow(self) -> None:
    """Double the capacity on the device; every value, the table's
    included, is copied as it is.  Under a mesh the flat rows map to other
    shards at the new capacity: a rank fetches the rows of its new span
    from their old owners (one ``fetch_rows``)."""
    new_cap = self._round_capacity(self._cap * 2)
    lo, rows = self._span(new_cap)
    have = max(min(lo + rows, self._cap) - lo, 0)
    held = [self._feats, self._gids, self._table]
    if self._mesh is not None:
      want = torch.arange(lo, lo + have, device=self._dev)
      held = self._mesh.fetch_rows(held, want)

    def _pad(x, fill):
      tail = torch.full((rows - have, *x.shape[1:]), fill, dtype=x.dtype,
                        device=x.device)
      return torch.cat([x[:have], tail])

    self._feats = _pad(held[0], 0)
    self._gids = _pad(held[1], -1)
    self._table = _pad(held[2], 0)
    self._cap = new_cap
    self._growths += 1

  # ---- public surface ------------------------------------------------------

  @property
  def device(self) -> torch.device:
    return self._dev

  @property
  def n_docs(self) -> int:
    return self._n

  @property
  def capacity(self) -> int:
    return self._cap

  @property
  def growths(self) -> int:
    return self._growths

  @property
  def feats(self) -> torch.Tensor:
    """(capacity, d) resident feature block (a rank's rows under a mesh:
    (capacity / m * m_local, d), its shards')."""
    return self._feats

  @property
  def gids(self) -> torch.Tensor:
    """(capacity,) int64 resident gids; -1 rows are holes (a rank's rows
    under a mesh)."""
    return self._gids

  @property
  def table(self) -> torch.Tensor:
    """(capacity,) float64 resident bound table: what an epoch reads (a
    rank's rows under a mesh)."""
    return self._table

  @property
  def ubound(self) -> np.ndarray:
    """Host copy of ``table`` (tests and diagnostics; an epoch reads
    ``table`` on the device)."""
    return self._table.cpu().numpy()

  @property
  def bounds_populated(self) -> bool:
    """True iff the table carries signal: a maintainer exists and some
    entry is nonzero.  A cold store reports False, so a cold epoch is not
    reported as warm.  The one-bit device read is cached once True (the
    table only accumulates); every rank of a mesh reads the same bit."""
    if self._maintainer is None or self._n == 0:
      return False
    if not self._bounds_seen:
      self._bounds_seen = bool(self._nonzero)
    return self._bounds_seen

  def reserve(self, n_total: int) -> None:
    """Pre-grow so ``n_total`` documents fit without mid-append growth."""
    while n_total > self._cap:
      self._grow()

  def _check_gids(self, gids, b: int):
    """The ids of a b-row append: auto ids above the watermark, or the
    caller's, which must be unique within the batch and against every id
    in the block.  Raises ValueError before anything is written."""
    if gids is None:
      return np.arange(self._next_gid, self._next_gid + b, dtype=np.int64)
    gids = np.asarray(gids, np.int64)
    if gids.shape != (b,) or (gids < 0).any():
      raise ValueError(f"gids must be {b} ids >= 0, got shape {gids.shape}")
    uniq, counts = np.unique(gids, return_counts=True)
    if uniq.size != b:
      raise ValueError(
          f"duplicate gids within append: {uniq[counts > 1].tolist()}")
    # the auto ranges are disjoint and start-sorted (the watermark only
    # moves up and adjacent ranges merge), so one searchsorted finds each
    # id's candidate range; explicit ids are one set intersection
    clash = set(map(int, uniq.tolist())) & self._explicit_gids
    if self._auto_ranges:
      starts = np.fromiter((s for s, _ in self._auto_ranges), np.int64,
                           len(self._auto_ranges))
      ends = np.fromiter((e for _, e in self._auto_ranges), np.int64,
                         len(self._auto_ranges))
      idx = np.searchsorted(starts, uniq, side="right") - 1
      in_auto = (idx >= 0) & (uniq < ends[np.maximum(idx, 0)])
      clash |= set(map(int, uniq[in_auto].tolist()))
    if clash:
      raise ValueError(f"gids already in the corpus: {sorted(clash)}")
    return gids

  def append(self, feats, gids=None) -> None:
    """Write documents into the resident block, ``append_block`` rows at a
    time (one bound pass per chunk).

    ``feats`` is (b, d), a tensor (on any device) or an array.  ``gids``
    default to consecutive ids; explicit gids must be unique within the
    batch and against every id already in the block, else ``ValueError``
    is raised before any row is written.  The id bookkeeping is committed
    after every chunk has landed.
    """
    # a copy from pageable host memory is issued without a stream sync (the
    # source is staged before the call returns), so an append reads nothing
    # back and waits for nothing; a pinned source is copied blocking, since
    # an asynchronous DMA would still read it after the call returns
    feats = torch.as_tensor(feats)
    crossed = feats.device.type == "cpu" and self._dev.type != "cpu"
    feats = feats.to(device=self._dev, dtype=self._feat_dtype,
                     non_blocking=not feats.is_pinned())
    if feats.dim() != 2 or feats.shape[1] != self._d:
      raise ValueError(f"append: rows of width {self._d} expected, got "
                       f"shape {tuple(feats.shape)}")
    b = feats.shape[0]
    auto = gids is None
    start = self._next_gid
    gids = self._check_gids(gids, b)
    self.reserve(self._n + b)
    ab = self._append_block
    gids_dev = self._h2d(gids)
    self._h2d_bytes = 0  # the ids are fed with their chunk's rows below
    row_bytes = self._d * feats.element_size() if crossed else 0
    lo = self._span(self._cap)[0]
    for off in range(0, b, ab):
      chunk = feats[off:off + ab]
      cb = chunk.shape[0]
      n0 = self._n
      g0, g1 = self._overlap(n0, cb)
      if g1 > g0:  # the chunk's rows this process holds
        self._feats[g0 - lo:g1 - lo] = chunk[g0 - n0:g1 - n0]
        self._gids[g0 - lo:g1 - lo] = gids_dev[off + g0 - n0:off + g1 - n0]
      diag = None
      if self._maintainer is not None:
        sums = self._bound_pass(chunk, n0)
        if self._sieve is not None:
          diag = self._sieve_pass(chunk, gids_dev[off:off + cb], sums, n0)
      self._n += cb
      self._feed_append_metrics(
          cb, diag, cb * (row_bytes + (8 if self._dev.type != "cpu" else 0)))
    if self._mesh is not None and self._sieve is not None and b:
      self._refresh_pool()
    # every chunk landed: commit the id bookkeeping
    if auto:
      self._next_gid = start + b
      if b:
        if self._auto_ranges and self._auto_ranges[-1][1] == start:
          self._auto_ranges[-1] = (self._auto_ranges[-1][0], start + b)
        else:
          self._auto_ranges.append((start, start + b))
    else:
      self._explicit_gids.update(int(g) for g in gids.tolist())
      self._next_gid = max(self._next_gid, int(gids.max()) + 1 if b else 0)

  def _bound_pass(self, chunk: torch.Tensor, n0: int) -> torch.Tensor:
    """One chunk's (append_block x capacity) pass over the already written
    block, so the new rows' mutual and self terms count once: older rows
    gain the chunk's mass, the chunk's rows get their own sums, which are
    returned (float32, the sieve's admission gains).  The last chunk of an
    append is not padded to ``append_block`` (the reference's padding rows
    carry no mass)."""
    cb, ml = chunk.shape[0], self._m_local
    rvalid = torch.ones((cb,), dtype=torch.float32, device=self._dev)
    block = self._feats.view(ml, self._cap // self._m, self._d)
    bvalid = (self._gids >= 0).view(ml, -1)
    add, sums = self._maintainer.append_update(
        chunk.contiguous(), block, rvalid, bvalid, kernel=self._kernel,
        h=self._h, backend=self._backend)
    if not getattr(self._maintainer, "sums_global", False):
      if self._mesh is not None:
        sums = self._mesh.all_gather(sums)  # (m, cb), in shard order
      sums = sums.sum(dim=0)  # the shards' partial sums (the psum)
    self._table += add.reshape(-1).to(torch.float64)
    g0, g1 = self._overlap(n0, cb)
    if g1 > g0:
      lo = self._span(self._cap)[0]
      self._table[g0 - lo:g1 - lo] = sums[g0 - n0:g1 - n0].to(torch.float64)
    self._nonzero |= (sums != 0.0).any()
    return sums

  def _sieve_pass(self, chunk: torch.Tensor, rgids: torch.Tensor,
                  sums: torch.Tensor, n0: int) -> torch.Tensor:
    """The standing-sieve update of one chunk (the reference's
    ``sieve_body``), with no host sync: fold the chunk's gains into Delta,
    re-grid (roll the buckets down by the grid top's move, open fresh top
    buckets), then admit the chunk's rows into the shards they land on.
    Which shards those are follows from n0, the chunk's rows and the shard
    size alone, so the host knows them without a read-back; the other
    shards' update is a no-op (under a mesh: a rank scans its shards
    among them, if any).  Returns the chunk's device-fed diagnostics,
    (admissions, rows considered) summed over the process's shards: the
    bucket counts' growth across the scan and the rows offered."""
    sv, ml, t, k = self._sieve, self._m_local, self._sieve_T, self._sieve_k
    dev, cb, npp = self._dev, chunk.shape[0], self._cap // self._m
    # Delta folds every row of the chunk (the reference's padding rows add
    # 0.0), the same on every shard, so the sieves stay mergeable
    delta = torch.maximum(sv.delta[0], sums.max().clamp_min(0.0))
    has = delta > 0.0
    jtop = torch.where(has, torch.ceil(
        torch.log(delta.clamp_min(1e-30)) / self._log1pe).to(torch.int64),
                       _JTOP_COLD)
    # slot p holds threshold (1+eps)^(jtop - (T-1) + p): when the top moves
    # up by `shift`, the `shift` lowest buckets roll out and fresh top ones
    # open, every surviving bucket's contents kept
    shift = (jtop - sv.jtop[0]).clamp(0, t)
    ar = torch.arange(t, device=dev)
    src = (ar + shift) % t
    cleared = ar >= t - shift

    def roll(x, fill):
      x = x.view(ml, t, *x.shape[1:])
      mask = cleared.view(1, t, *(1,) * (x.dim() - 2))
      return torch.where(mask, fill, x[:, src]).view(ml * t, *x.shape[2:])

    gid, gain = roll(sv.gid, -1), roll(sv.gain, 0.0)
    feat, cnt = roll(sv.feat, 0.0), roll(sv.count, 0)
    expo = (jtop - (t - 1) + ar).to(torch.float32)
    tau = torch.exp(expo * self._log1pe)
    # the shards the chunk lands on, and of those this process's
    s0 = max(n0 // npp, self._first)
    s1 = min((n0 + cb - 1) // npp + 1, self._first + ml)
    diag = torch.zeros((2,), dtype=torch.int64, device=dev)
    if s1 > s0:
      pos = (n0 + torch.arange(cb, device=dev))[None, :] - (
          torch.arange(s0, s1, device=dev)[:, None] * npp)
      active = (pos >= 0) & (pos < npp) & has
      lo, hi = (s0 - self._first) * t, (s1 - self._first) * t
      update = dispatch.resolve("sieve_update", self._backend or "auto")
      g2, w2, f2, c2 = update(
          chunk, sums, rgids, active, tau, gid[lo:hi].view(-1, t, k),
          gain[lo:hi].view(-1, t, k), feat[lo:hi].view(-1, t, k, self._d),
          cnt[lo:hi].view(-1, t), kernel=self._kernel, h=self._h)
      diag = torch.stack([c2.sum() - cnt[lo:hi].sum(), active.sum()])
      gid[lo:hi] = g2.view(-1, k)
      gain[lo:hi] = w2.view(-1, k)
      feat[lo:hi] = f2.view(-1, k, self._d)
      cnt[lo:hi] = c2.view(-1)
    self._sieve = SieveState(gid, gain, feat, cnt, delta.expand(ml).clone(),
                             jtop.expand(ml).clone())
    return diag

  # ---- metric feeds --------------------------------------------------------

  def _feed_transfer(self) -> None:
    """Count the host<->device bytes of the query call that just ran
    (always on; host ints) and start the next count from zero."""
    xfer = obs.REGISTRY.counter("repro_transfer_bytes_total",
                                "host<->device bytes moved, by path")
    if self._h2d_bytes:
      xfer.inc(self._h2d_bytes, path="query_h2d")
    if self._d2h_bytes:
      xfer.inc(self._d2h_bytes, path="query_d2h")
    self._h2d_bytes = self._d2h_bytes = 0

  def _feed_append_metrics(self, rows_written: int, diag,
                           h2d_bytes: int) -> None:
    """Feed the registry after one append chunk.  The chunk, row and byte
    counters are host ints (always on); ``diag``, the chunk's device-fed
    (admissions, considered) pair, and the sieve grid's top exponent are
    read to the host (one copy) only while obs is enabled."""
    reg = obs.REGISTRY
    reg.counter("repro_append_chunks_total",
                "fixed-shape append chunks written").inc()
    reg.counter("repro_append_rows_total",
                "document rows appended").inc(rows_written)
    reg.counter("repro_transfer_bytes_total",
                "host<->device bytes moved, by path").inc(
                    h2d_bytes, path="append_h2d")
    reg.gauge("repro_store_growths", "capacity doublings so far").set(
        self._growths)
    if not obs.enabled() or diag is None:
      return
    admitted, considered, jtop = torch.cat(
        [diag, self._sieve.jtop[:1]]).tolist()
    reg.counter("repro_sieve_admissions_total",
                "sieve bucket admissions (device-fed)").inc(
                    max(admitted, 0))
    reg.counter("repro_sieve_rejections_total",
                "sieve rows considered but not admitted (device-fed)").inc(
                    max(considered - admitted, 0))
    if jtop != _JTOP_COLD:
      reg.gauge("repro_sieve_grid_level",
                "sieve threshold-grid top exponent jtop (device-fed)").set(
                    jtop)

  # ---- standing-sieve surface ----------------------------------------------

  @property
  def sieve_enabled(self) -> bool:
    return self._sieve_k > 0

  @property
  def sieve_k(self) -> int:
    return self._sieve_k

  @property
  def sieve_thresholds(self) -> int:
    """Bucket count T = O(log Delta / eps) (0 when the sieve is off)."""
    return self._sieve_T

  @property
  def sieve_state_bytes(self) -> int:
    """Device bytes held by the standing sieves of the process's shards
    (a rank's query pool not counted)."""
    if self._sieve is None:
      return 0
    return sum(x.numel() * x.element_size() for x in self._sieve)

  @property
  def sieve_state(self) -> SieveState | None:
    """The standing sieves of all m shards on the device (a rank's query
    pool under a mesh; None when the sieve is off)."""
    return self._pool

  @property
  def query_mask_cap(self) -> int:
    """Per-query exclusion-list capacity of the query paths."""
    return self._mask_cap

  @property
  def query_batch_tile(self) -> int:
    """Lanes of one batched query call (one read-back each)."""
    return self._qb_tile

  @property
  def query_count(self) -> int:
    """Single queries merged so far (``query_sieves``)."""
    return self._query_count

  @property
  def query_batch_calls(self) -> int:
    """Batched merge calls so far (one a query tile)."""
    return self._query_batch_calls

  @property
  def query_batch_queries(self) -> int:
    """Requests answered through the batched merge so far."""
    return self._query_batch_queries

  def sieve_state_host(self):
    """Host copy of (gid, gain, feat, count, delta, jtop) with the
    reference's dtypes (int32 ids, counts and exponents): tests only."""
    if self._sieve is None:
      raise RuntimeError("sieve disabled on this store")
    out = []
    for x in self._pool:
      # repro: allow(T5): tests only, a host copy of the six sieve arrays; no serving path calls it
      a = x.cpu().numpy()
      out.append(a.astype(np.int32) if a.dtype == np.int64 else a)
    return tuple(out)

  def set_sieve_state(self, state: SieveState) -> None:
    """Replace the standing sieves of all m shards (``interop.sieve_state``
    carries a reference store's across); shapes must be this store's
    ``sieve_state``'s.  Under a mesh every rank is given the whole state
    and keeps its shards' part and the pool (no collective)."""
    if self._sieve is None:
      raise RuntimeError("sieve disabled on this store")
    new = []
    for mine, x in zip(self._pool, state):
      if tuple(x.shape) != tuple(mine.shape):
        raise ValueError(f"sieve state of shape {tuple(x.shape)}, this "
                         f"store holds {tuple(mine.shape)}")
      new.append(x.to(device=self._dev, dtype=mine.dtype).clone())
    self._set_all(SieveState(*new))

  def _set_all(self, state: SieveState) -> None:
    """Install an all-shard sieve state: the process's shards' part, and
    the pool under a mesh."""
    if self._mesh is None:
      self._sieve = state
    else:
      self._pool_state = state
      self._sieve = SieveState(*(x.clone() for x in self._mine(state)))

  def _h2d(self, a) -> torch.Tensor:
    """A host array on the device, copied without a stream sync unless it
    lies in pinned memory (see ``append``); its bytes are counted for the
    transfer metrics."""
    t = torch.as_tensor(np.asarray(a))
    if self._dev.type != "cpu":
      self._h2d_bytes += t.nbytes
    return t.to(self._dev, non_blocking=not t.is_pinned())

  def _excl(self, exclude, b: int | None) -> torch.Tensor:
    """-1-padded exclusion lists as int64 on the device, (mask_cap,) or (b,
    mask_cap); None: no filter."""
    shape = (self._mask_cap,) if b is None else (b, self._mask_cap)
    if exclude is None:
      return torch.full(shape, -1, dtype=torch.int64, device=self._dev)
    e = self._h2d(np.asarray(exclude, np.int64))
    if tuple(e.shape) != shape:
      raise ValueError(f"exclusion lists of shape {tuple(e.shape)}, "
                       f"expected {shape} (query_mask_cap "
                       f"{self._mask_cap})")
    return e

  def _jitter_mult(self, seeds: np.ndarray, jitter, n: int) -> torch.Tensor:
    """(B, n) float32 score multipliers: 1 + 1e-4 u for a lane with a
    nonzero seed, exactly 1 otherwise.  ``jitter`` gives u, (B, n) or (n,)
    (the tests pass the reference's ``jax.random.uniform(PRNGKey(seed),
    (n,))``); without it u is drawn from a generator seeded with the
    lane's seed."""
    b = seeds.shape[0]
    if jitter is not None:
      u = self._h2d(np.array(jitter, np.float32)).expand(b, n)
    else:
      u = torch.zeros((b, n), dtype=torch.float32, device=self._dev)
      for i, sd in enumerate(seeds.tolist()):
        if sd:
          g = torch.Generator(device=self._dev).manual_seed(int(sd))
          u[i] = torch.rand((n,), generator=g, device=self._dev)
    on = self._h2d(seeds != 0)[:, None]
    return torch.where(on, 1.0 + _QUERY_JITTER * u, 1.0)

  def _merge(self, kq: torch.Tensor, excl: torch.Tensor,
             mult: torch.Tensor | None):
    """The sieve merge of one query tile of B lanes: every bucket of every
    shard pools into N = m * T * k candidates, and a k-step greedy MMR pass
    re-applies the admission score (standing gain times relu(1 - the
    largest redundancy to the picks so far)) over the pool, at least as
    good as the best single bucket, which carries the sieve guarantee.  A
    gid admitted into several buckets is masked by gid once picked, so no
    document comes back twice.  ``kq`` (B,) masks picks past each lane's
    k; ``excl`` (B, mask_cap) hides ids; ``mult`` (B, N) is the seed
    jitter (None: all seeds 0).  One ``pairwise`` call a pick for the
    whole tile; the (N, N) block is never formed.  Returns (B, k) ids and
    scores on the device."""
    sv, k = self._pool, self._sieve_k
    n = sv.gid.numel()
    b = kq.shape[0]
    gt = sv.gid.reshape(n)
    wt = sv.gain.reshape(n)
    ft = sv.feat.reshape(n, self._d)
    linear = self._kernel == "linear"
    if linear:
      # repro: allow(T8): the pooled sieves have one shape on every rank and in the stacked store
      nsq = torch.clamp_min(torch.sum(ft * ft, dim=-1), 1e-12)
    # masked out: holes, excluded ids, and (growing) the ids picked so far
    blocked = (gt < 0)[None, :] | (gt[None, :, None] == excl[:, None, :]).any(
        dim=-1)
    redmax = torch.zeros((b, n), dtype=torch.float32, device=self._dev)
    out_g = torch.full((b, k), -1, dtype=torch.int64, device=self._dev)
    out_s = torch.zeros((b, k), dtype=torch.float32, device=self._dev)
    pair = dispatch.resolve("pairwise", self._backend or "auto")
    for i in range(k):
      score = wt * torch.clamp_min(1.0 - redmax, 0.0)
      if mult is not None:
        score = score * mult
      score.masked_fill_(blocked, NEG)
      best, j = torch.max(score, dim=1)  # the first of equal maxima
      take = (best > 0.0) & (kq > i)
      gj = gt[j]
      out_g[:, i] = torch.where(take, gj, -1)
      out_s[:, i] = torch.where(take, best, 0.0)
      blocked |= take[:, None] & (gt[None, :] == gj[:, None])
      simj = pair(ft, ft[j], kernel=self._kernel, h=self._h).T   # (b, n)
      if linear:
        simj = torch.clamp_min(simj, 0.0) / torch.sqrt(nsq[None, :]
                                                       * nsq[j][:, None])
      redmax = torch.where(take[:, None], torch.maximum(redmax, simj),
                           redmax)
    return out_g, out_s

  def _read_back(self, g: torch.Tensor, s: torch.Tensor):
    """(ids int64, scores float32) on the host in one device-to-host copy."""
    both = torch.stack([g.to(torch.float64), s.to(torch.float64)]).cpu()
    if self._dev.type != "cpu":
      self._d2h_bytes += both.nbytes
    return both[0].numpy().astype(np.int64), both[1].numpy().astype(
        np.float32)

  def query_sieves(self, k: int | None = None, exclude_gids=None,
                   seed: int = 0, jitter=None):
    """Merge the standing sieves into a (sieve_k,) coreset: host (gids,
    scores), gid -1 past the end.  The merge reads only the sieve state,
    never the corpus block, and reads back once.

    ``k`` masks picks past the requested size (the same as slicing: greedy
    prefixes nest); ``exclude_gids`` is a (query_mask_cap,) -1-padded
    exclusion list; ``seed`` != 0 applies the tie-break jitter, whose
    uniforms ``jitter`` (N,) may give (N = m * T * k)."""
    if self._sieve is None:
      raise RuntimeError("sieve disabled on this store")
    self._h2d_bytes = self._d2h_bytes = 0
    kq = self._sieve_k if k is None else int(k)
    seeds = np.array([int(seed)], np.int64)
    n = self._pool.gid.numel()
    mult = self._jitter_mult(seeds, jitter, n) if seed else None
    g, s = self._merge(self._h2d(np.array([kq], np.int64)),
                       self._excl(exclude_gids, None)[None], mult)
    self._query_count += 1
    g, s = self._read_back(g, s)
    self._feed_transfer()
    return g[0], s[0]

  def query_sieves_batch(self, ks, exclude, seeds, jitter=None):
    """Batched sieve merge: one merge call a query tile answers a whole
    heterogeneous batch.

    ``ks`` (B,) coreset sizes, ``exclude`` (B, query_mask_cap) -1-padded
    exclusion lists, ``seeds`` (B,) tie-break seeds (0: none); ``jitter``
    optionally the (B, N) uniforms of the seeded lanes.  Ragged batches pad
    up to ``query_batch_tile`` with k = 0 lanes, bigger ones run tile by
    tile.  Returns host (B, sieve_k) gids / scores; each lane selects what
    ``query_sieves`` selects at the same (k, exclusions, seed)."""
    if self._sieve is None:
      raise RuntimeError("sieve disabled on this store")
    self._h2d_bytes = self._d2h_bytes = 0
    ks = np.asarray(ks, np.int64).reshape(-1)
    seeds = np.asarray(seeds, np.int64).reshape(-1)
    b = ks.shape[0]
    excl = np.asarray(exclude, np.int64).reshape(b, -1)
    if excl.shape != (b, self._mask_cap) or seeds.shape != (b,):
      raise ValueError(f"exclude {excl.shape} / seeds {seeds.shape} do not "
                       f"match {b} requests of mask cap {self._mask_cap}")
    n = self._pool.gid.numel()
    if jitter is not None:
      jitter = np.broadcast_to(np.asarray(jitter, np.float32), (b, n))
    bq = self._qb_tile
    out_g, out_s = [], []
    for off in range(0, b, bq):
      nb = min(bq, b - off)
      pad = bq - nb
      kc = np.pad(ks[off:off + nb], (0, pad))  # k = 0: padding picks none
      ec = np.pad(excl[off:off + nb], ((0, pad), (0, 0)),
                  constant_values=-1)
      sc = np.pad(seeds[off:off + nb], (0, pad))
      jc = None if jitter is None else np.pad(jitter[off:off + nb],
                                              ((0, pad), (0, 0)))
      mult = self._jitter_mult(sc, jc, n) if sc.any() else None
      g, s = self._merge(self._h2d(kc), self._excl(ec, bq), mult)
      g, s = self._read_back(g, s)
      out_g.append(g[:nb])
      out_s.append(s[:nb])
      self._query_batch_calls += 1
    self._query_batch_queries += b
    self._feed_transfer()
    if not out_g:
      k = self._sieve_k
      return np.zeros((0, k), np.int64), np.zeros((0, k), np.float32)
    return np.concatenate(out_g), np.concatenate(out_s)

  def _exact_tile(self, feats: torch.Tensor, gids: torch.Tensor,
                  kq: torch.Tensor, excl: torch.Tensor, k_cap: int):
    """The exact tier on one query tile: k_cap greedy facility-location
    steps over the block (``feats``, ``gids``), each ONE batched facility
    select (the block shared, per-lane coverage, visibility and candidates
    on the batch axis) and one ``pairwise`` call for the picks' columns."""
    backend = self._backend or "auto"
    sel_b = dispatch.resolve_select_batched("facility_gain", backend)
    pair = dispatch.resolve("pairwise", backend)
    f32 = feats.float()
    cap, b = f32.shape[0], kq.shape[0]
    hidden = (gids[None, :, None] == excl[:, None, :]).any(dim=-1)
    vis = ((gids >= 0)[None, :] & ~hidden).to(torch.float32)   # (b, cap)
    nvis = vis.sum(dim=1)
    cov = torch.zeros((b, cap), dtype=torch.float32, device=self._dev)
    okf = vis.clone()
    out_g = torch.full((b, k_cap), -1, dtype=torch.int64, device=self._dev)
    out_s = torch.zeros((b, k_cap), dtype=torch.float32, device=self._dev)
    ar = torch.arange(cap, device=self._dev)
    for i in range(k_cap):
      best, idx = sel_b(f32, f32, cov, vis, okf, kernel=self._kernel,
                        h=self._h)
      take = (best > 0.0) & (kq > i)
      sim = pair(f32[idx], f32, kernel=self._kernel, h=self._h)  # (b, cap)
      cov = torch.where(take[:, None], torch.maximum(cov, sim), cov)
      okf = torch.where(take[:, None] & (ar[None, :] == idx[:, None]), 0.0,
                        okf)
      out_g[:, i] = torch.where(take, gids[idx], -1)
      out_s[:, i] = torch.where(take, best, 0.0)
    return out_g, out_s, nvis

  def query_exact_batch(self, ks, exclude, k_cap: int):
    """Exact-tier batched query over the resident block (facility
    location): the request surface of ``query_sieves_batch`` without
    seeds (the exact greedy is deterministic).  Returns host (B, k_cap)
    gids / scores (the greedy gains over each tenant's visible rows) and
    the (B,) visible-row counts ``nvis`` (the value normalizer); one
    read-back a query tile.  Under a mesh a collective: the block is
    gathered once a call (one all-gather of every rank's rows and gids)
    and every rank runs the stacked greedy on it."""
    ks = np.asarray(ks, np.int64).reshape(-1)
    b = ks.shape[0]
    excl = np.asarray(exclude, np.int64).reshape(b, -1)
    if excl.shape != (b, self._mask_cap):
      raise ValueError(f"exclude {excl.shape} does not match {b} requests "
                       f"of mask cap {self._mask_cap}")
    bq, k_cap = self._qb_tile, int(k_cap)
    self._h2d_bytes = self._d2h_bytes = 0
    block = [self._feats, self._gids]
    if self._mesh is not None:
      block = unpack_rows(self._mesh.all_gather(pack_rows(block)), block)
    out_g, out_s, out_n = [], [], []
    for off in range(0, b, bq):
      nb = min(bq, b - off)
      pad = bq - nb
      kc = np.pad(ks[off:off + nb], (0, pad))
      ec = np.pad(excl[off:off + nb], ((0, pad), (0, 0)),
                  constant_values=-1)
      g, s, nv = self._exact_tile(*block, self._h2d(kc), self._excl(ec, bq),
                                  k_cap)
      # repro: allow(T5): one read-back a query tile is the exact tier's contract
      both = torch.cat([g.to(torch.float64), s.to(torch.float64),
                        nv.to(torch.float64)[:, None]], dim=1).cpu().numpy()
      if self._dev.type != "cpu":
        self._d2h_bytes += both.nbytes
      out_g.append(both[:nb, :k_cap].astype(np.int64))
      out_s.append(both[:nb, k_cap:2 * k_cap].astype(np.float32))
      out_n.append(both[:nb, 2 * k_cap].astype(np.float32))
    self._feed_transfer()
    if not out_g:
      return (np.zeros((0, k_cap), np.int64),
              np.zeros((0, k_cap), np.float32), np.zeros((0,), np.float32))
    return (np.concatenate(out_g), np.concatenate(out_s),
            np.concatenate(out_n))

  def _gather_bounds(self, gids_q: np.ndarray) -> np.ndarray:
    """Table entries of the given gids (0.0 for unknown ids) as float32,
    the rounding of the reference's f32 ``hi`` word.  Under a mesh each
    rank looks the ids up in its rows, and one all-gather of the ranks'
    (hit, entry) pairs gives every rank the holder's entry."""
    q = self._h2d(np.asarray(gids_q, np.int64))
    eq = self._gids[None, :] == q[:, None]
    hit = eq.any(dim=1)
    at = eq.to(torch.uint8).argmax(dim=1)
    vals = torch.where(hit, self._table[at], 0.0)
    if self._mesh is not None:
      pairs = self._mesh.all_gather(torch.stack([hit.to(torch.float64),
                                                 vals])[None])
      hits = pairs[:, 0] > 0.0                       # (world, q)
      owner = hits.to(torch.uint8).argmax(dim=0)
      vals = torch.where(hits.any(dim=0), pairs[owner, 1, torch.arange(
          q.shape[0], device=self._dev)], 0.0)
    return vals.to(torch.float32).cpu().numpy()

  def reset_sieves(self, sel_feats=None, sel_gids=None) -> None:
    """Epoch hand-off: clear the sieves and re-grid from the table.

    The new Delta is the table's largest standing singleton gain, rounded
    to float32 as the reference reads it from its f32 ``hi`` word (one
    scalar read-back), so the grid reflects the whole corpus.  The epoch's
    selection (``sel_feats`` / ``sel_gids``, padding already dropped)
    seeds the fresh buckets through the admission rule, replayed on the
    host on shard 0's buckets with the rows' table entries as gains: a
    query right after an epoch answers with at least the epoch's picks.
    Under a mesh every rank takes the max over the ranks' tables and
    replays the same seeding, so each holds the whole new state (its
    shards' part and the pool) without a gather of the sieves.
    """
    if self._sieve is None:
      return
    m, t, k, d = self._m, self._sieve_T, self._sieve_k, self._d
    eps = self._sieve_eps
    top = self._table.max()
    if self._mesh is not None:
      top = self._mesh.max(top)
    delta = float(np.float32(top.item()))
    sgid = np.full((m * t, k), -1, np.int64)
    sgain = np.zeros((m * t, k), np.float32)
    sfeat = np.zeros((m * t, k, d), np.float32)
    scnt = np.zeros((m * t,), np.int64)
    if delta > 0.0:
      jtop = int(np.ceil(np.log(delta) / np.log1p(eps)))
      tau = np.exp((jtop - (t - 1) + np.arange(t)) * np.log1p(eps))
      if sel_feats is not None and len(sel_feats):
        if isinstance(sel_feats, torch.Tensor):
          sel_feats = sel_feats.float().cpu().numpy()
        sel_feats = np.asarray(sel_feats, np.float32)
        sel_gids = np.asarray(sel_gids, np.int64)
        gains = self._gather_bounds(sel_gids)
        for v, g, gid in zip(sel_feats, gains, sel_gids):
          # ref.sieve_admit_ref on shard 0's buckets
          red = np.zeros((t,), np.float32)
          for p in range(t):
            c = int(scnt[p])
            if c:
              sim = _np_sim(v[None], sfeat[p, :c], self._kernel, self._h)[0]
              if self._kernel == "linear":
                vsq = max((v.astype(np.float32) ** 2).sum(), 1e-12)
                msq = np.maximum(np.sum(
                    sfeat[p, :c].astype(np.float32) ** 2, axis=-1), 1e-12)
                sim = np.maximum(sim, 0.0) / np.sqrt(vsq * msq)
              red[p] = max(float(np.max(sim)), 0.0)
          score = float(g) * np.maximum(1.0 - red, 0.0)
          admit = (score >= tau) & (scnt[:t] < k) & (gid >= 0)
          for p in np.nonzero(admit)[0]:
            sgid[p, scnt[p]] = gid
            sgain[p, scnt[p]] = score[p]
            sfeat[p, scnt[p]] = v
            scnt[p] += 1
    else:
      jtop = _JTOP_COLD
    dev = self._dev
    self._set_all(SieveState(
        torch.as_tensor(sgid, device=dev), torch.as_tensor(sgain, device=dev),
        torch.as_tensor(sfeat, device=dev), torch.as_tensor(scnt, device=dev),
        torch.full((m,), max(delta, 0.0), dtype=torch.float32, device=dev),
        torch.full((m,), jtop, dtype=torch.int64, device=dev)))
