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

Not ported yet (ROADMAP.md): the standing sieves (``sieve_k``,
``sieve_update``), ``query_sieves``, ``query_sieves_batch``,
``query_exact_batch`` and ``reset_sieves``, and the obs metric feeds.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.objectives import _kernel_h


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
    feat_dtype: storage dtype of the feature rows.
    device: where the block lives; ``cuda`` by default (raises when CUDA is
      missing unless ``cpu`` is asked for).
  """

  def __init__(self, *, m: int, d: int, capacity: int = 4096,
               append_block: int = 1024, kernel: str = "linear",
               kernel_kwargs: tuple = (), backend: str | None = None,
               maintainer=None, feat_dtype=torch.float32, device="cuda"):
    self._dev = resolve_device(device)
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
    self._alloc(self._cap)

  # ---- placement -----------------------------------------------------------

  def _round_capacity(self, cap: int) -> int:
    """Smallest multiple of m >= cap (the block splits into m shards)."""
    return -(-cap // self._m) * self._m

  def _alloc(self, cap: int) -> None:
    self._feats = torch.zeros((cap, self._d), dtype=self._feat_dtype,
                              device=self._dev)
    self._gids = torch.full((cap,), -1, dtype=torch.int64, device=self._dev)
    self._table = torch.zeros((cap,), dtype=torch.float64, device=self._dev)

  def _grow(self) -> None:
    """Double the capacity on the device; every value, the table's
    included, is copied as it is."""
    new_cap = self._round_capacity(self._cap * 2)
    pad = new_cap - self._cap

    def _pad(x, fill):
      tail = torch.full((pad, *x.shape[1:]), fill, dtype=x.dtype,
                        device=x.device)
      return torch.cat([x, tail])

    self._feats = _pad(self._feats, 0)
    self._gids = _pad(self._gids, -1)
    self._table = _pad(self._table, 0)
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
    """(capacity, d) resident feature block."""
    return self._feats

  @property
  def gids(self) -> torch.Tensor:
    """(capacity,) int64 resident gids; -1 rows are holes."""
    return self._gids

  @property
  def table(self) -> torch.Tensor:
    """(capacity,) float64 resident bound table: what an epoch reads."""
    return self._table

  @property
  def ubound(self) -> np.ndarray:
    """(capacity,) float64 host copy of the bound table (tests and
    diagnostics; an epoch reads ``table`` on the device)."""
    return self._table.cpu().numpy()

  @property
  def bounds_populated(self) -> bool:
    """True iff the table carries signal: a maintainer exists and some
    entry is nonzero.  A cold store reports False, so a cold epoch is not
    reported as warm.  The one-bit device read is cached once True (the
    table only accumulates)."""
    if self._maintainer is None or self._n == 0:
      return False
    if not self._bounds_seen:
      self._bounds_seen = bool((self._table != 0.0).any())
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
    feats = torch.as_tensor(feats).to(device=self._dev,
                                      dtype=self._feat_dtype)
    if feats.dim() != 2 or feats.shape[1] != self._d:
      raise ValueError(f"append: rows of width {self._d} expected, got "
                       f"shape {tuple(feats.shape)}")
    b = feats.shape[0]
    auto = gids is None
    start = self._next_gid
    gids = self._check_gids(gids, b)
    self.reserve(self._n + b)
    ab = self._append_block
    gids_dev = torch.as_tensor(gids, device=self._dev)
    for off in range(0, b, ab):
      chunk = feats[off:off + ab]
      cb = chunk.shape[0]
      n0 = self._n
      self._feats[n0:n0 + cb] = chunk
      self._gids[n0:n0 + cb] = gids_dev[off:off + cb]
      if self._maintainer is not None:
        self._bound_pass(chunk, n0)
      self._n += cb
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

  def _bound_pass(self, chunk: torch.Tensor, n0: int) -> None:
    """One chunk's (append_block x capacity) pass over the already written
    block, so the new rows' mutual and self terms count once: older rows
    gain the chunk's mass, the chunk's rows get their own sums.  The last
    chunk of an append is not padded to ``append_block`` (the reference's
    padding rows carry no mass)."""
    cb, m = chunk.shape[0], self._m
    rvalid = torch.ones((cb,), dtype=torch.float32, device=self._dev)
    block = self._feats.view(m, self._cap // m, self._d)
    bvalid = (self._gids >= 0).view(m, -1)
    add, sums = self._maintainer.append_update(
        chunk.contiguous(), block, rvalid, bvalid, kernel=self._kernel,
        h=self._h, backend=self._backend)
    if not getattr(self._maintainer, "sums_global", False):
      sums = sums.sum(dim=0)  # the shards' partial sums (the psum)
    self._table += add.reshape(-1).to(torch.float64)
    self._table[n0:n0 + cb] = sums.to(torch.float64)
