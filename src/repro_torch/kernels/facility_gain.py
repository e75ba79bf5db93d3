"""Facility-location marginal gains: the port of the TPU kernel
``src/repro/kernels/facility_gain.py`` ``facility_gain_pallas``.

For every candidate j (per partition when batched)

    gain[j] = sum_i mask_i * max(sim(e_i, c_j) - cov_i, 0)

The CUDA kernel is ``csrc/facility.cu`` (stage 1 keeps the similarity tile
in registers and reduces it to per-candidate sums; stage 2 sums the
eval-axis chunks in a fixed order; see the header there for its bound and
design).  Stage 1 is one persistent kernel for every width: a 256-row
candidate band against eval tiles streamed through a TMA ring, the band
resident while d fits 2 boxes of 128 bytes and streamed box by box beside
the eval tile past that (``ring.plan``).  ``operands`` checks the
operands, hands those TMA cannot read as they are over as padded copies
(``ring.features`` / ``ring.vector``) and gives the ring and the work plan;
``plan`` is the work plan as a pure function of the shapes.  Its plain
version is ``ref.facility_gain_ref``.  The kernel masks ragged edges
itself.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref, ring

launches = 0  # launches of csrc/facility.cu's gains through this wrapper

# how many times its partitions a call's work plan is made for (see
# ``plan_for_parts``)
_PLAN_PARTS = contextvars.ContextVar("facility_plan_parts", default=1)


@contextlib.contextmanager
def plan_for_parts(scale: int):
  """Make every call's work plan inside the block for ``scale`` times the
  partitions the call has.  A rank of a process mesh runs m / world of the
  m partitions a stacked call would; the plan's eval-axis chunks follow
  the count of candidate bands over all partitions, and with them the
  order in which a candidate's gain is summed, so a rank takes the stacked
  call's plan (``scale`` = world) to give the stacked bits."""
  token = _PLAN_PARTS.set(int(scale))
  try:
    yield
  finally:
    _PLAN_PARTS.reset(token)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
  return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
  """Streaming multiprocessors of a CUDA device (132 on an H100 SXM)."""
  return _sm_count(device.index if device.index is not None
                   else torch.cuda.current_device())


UNIT_COST = 0.25  # a work unit's band load and final reduction, in eval
                  # tiles' worth of products (the plan's cost model)


@functools.lru_cache(maxsize=4096)
def eval_chunks(n_bands: int, ne: int, slots: int) -> int:
  """How many fixed eval-axis ranges stage 1 splits into, for ``n_bands``
  candidate bands (of all partitions) over ``ne`` eval rows on a card that
  runs ``slots`` stage-1 blocks at once.

  Each range holds ceil(tiles / chunks) eval tiles of ``build.TILE`` rows,
  every range at least one (chunks is rounded down to fit), and a work unit
  is one band over one range.  The count is the one that minimises the
  modelled time, waves x (tiles a unit + ``UNIT_COST``), among those that
  give every slot a unit where the shape allows (up to 8 units a slot; a
  larger count is taken only when it is modelled more than 1 % faster).
  A pure function of the shapes and the card, so the summation order --
  and with it every result bit -- is fixed for a given call."""
  tiles = -(-ne // build.TILE)
  need = min(slots, n_bands * tiles)  # units that give every slot work
  best, best_cost = 1, None
  for c in range(1, min(tiles, -(-8 * slots // n_bands)) + 1):
    per = -(-tiles // c)
    chunks = -(-tiles // per)  # c rounded down so that no range is empty
    units = n_bands * chunks
    if units < need:
      continue
    cost = -(-units // slots) * (per + UNIT_COST)
    if best_cost is None or cost < 0.99 * best_cost:
      best, best_cost = chunks, cost
  return best


class Plan(NamedTuple):
  """The work plan of one call: units of (partition, candidate band, eval
  chunk), chunk c holding eval tiles [c * per_chunk, (c + 1) * per_chunk)
  of the ``tiles``."""
  band: int       # candidate rows a band (ring.BAND)
  bands: int      # bands a partition
  tiles: int      # eval tiles of build.TILE rows
  chunks: int     # eval-axis ranges, every one non-empty
  per_chunk: int  # eval tiles a range (the last may hold fewer)
  units: int      # work units: partitions x bands x chunks


def plan(n_part: int, ne: int, nc: int, n_sm: int, scale: int = 1) -> Plan:
  """The plan of a call with these shapes on a card of ``n_sm`` SMs, one
  persistent block an SM; the same in both ring modes.  The chunks are
  those of a call with ``scale`` times the partitions."""
  bands = -(-nc // ring.BAND)
  tiles = -(-ne // build.TILE)
  chunks = eval_chunks(bands * n_part * scale, ne, n_sm)
  per = -(-tiles // chunks)
  return Plan(ring.BAND, bands, tiles, chunks, per, n_part * bands * chunks)


class FLOperands(NamedTuple):
  """Checked kernel operands of the facility and coverage kernels."""
  ev: ring.Feat
  cd: ring.Feat
  cov: ring.Vec     # the facility coverage, or the coverage's cover
  mask: ring.Vec
  ok: torch.Tensor | None
  batch: int | None   # None: no operand is batched
  n_part: int
  ne: int
  nc: int
  d: int
  ring: ring.Ring
  plan: Plan
  cap: ring.Vec | None = None  # saturated coverage only

  @property
  def path(self) -> str:
    """The ring mode of the call: "resident" or "streamed"."""
    return self.ring.mode

  @property
  def copies(self) -> tuple[str, ...]:
    """The operands handed over as a padded copy."""
    return tuple(k for k in ("ev", "cd", "cov", "mask", "cap")
                 if getattr(self, k) is not None and getattr(self, k).copied)

  def _vecs(self) -> tuple:
    return (self.cov,) + (() if self.cap is None else (self.cap,)) + (
        self.mask,)

  def head(self) -> tuple:
    """The C entries' leading pointers: ev, cd, cov [, cap], mask."""
    return (self.ev.t.data_ptr(), self.cd.t.data_ptr(),
            *(v.t.data_ptr() for v in self._vecs()))

  def dims(self) -> tuple:
    """The C entries' (n_part, ne, nc, d, ev_ld, cd_ld, ev_bs, cd_bs,
    cov_bs [, cap_bs], mask_bs)."""
    return (self.n_part, self.ne, self.nc, self.d, self.ev.ld, self.cd.ld,
            self.ev.bs, self.cd.bs, *(v.bs for v in self._vecs()))


def operands(name: str, eval_feats, cand_feats, cov, eval_mask,
             cand_ok=None, cap=None) -> FLOperands:
  """Validate the facility (or, with ``cap``, the saturated-coverage)
  kernels' operands, settle the batch layout, the ring and the work plan,
  and copy any feature or vector TMA cannot read as it is.

  eval_feats (ne, d) | (P, ne, d); cand_feats (nc, d) | (P, nc, d);
  cov (the coverage's cover), cap, eval_mask (ne,) | (P, ne); cand_ok
  (nc,) | (P, nc).  Unbatched operands are shared by every partition
  (batch stride 0).  CUDA tensors only.
  """
  build.check_feats(name, eval_feats, cand_feats, rows_only=True)
  dev = eval_feats.device
  ne, d = eval_feats.shape[-2:]
  nc, dc = cand_feats.shape[-2:]
  if dc != d:
    raise ValueError(f"{name}: feature widths differ ({d} vs {dc})")
  if ne < 1 or nc < 1:
    raise ValueError(f"{name}: needs at least one eval row and one "
                     f"candidate, got ne={ne}, nc={nc}")
  pairs = [(eval_feats, 2), (cand_feats, 2), (cov, 1), (eval_mask, 1)]
  if cand_ok is not None:
    pairs.append((cand_ok, 1))
  if cap is not None:
    pairs.append((cap, 1))
  for t, rank in pairs[2:]:
    if t.dim() not in (rank, rank + 1):
      raise ValueError(f"{name}: vector operand of shape {tuple(t.shape)}")
  batch = build.batch_of(name, *pairs)
  n_part = 1 if batch is None else batch
  if n_part > build.MAX_GRID:
    raise ValueError(f"{name}: {n_part} partitions exceed the grid")
  if max(ne, nc) >= 2**30:
    raise ValueError(f"{name}: ne={ne}, nc={nc} past 2^30")
  ok = None if cand_ok is None else build.vec(name, cand_ok, nc, dev)

  def vector(t):
    return ring.vector(build.vec(name, t, ne, dev))

  rp = ring.plan("facility", d, eval_feats.element_size(),
                 2 if cap is None else 3)
  return FLOperands(ring.features(name, eval_feats),
                    ring.features(name, cand_feats), vector(cov),
                    vector(eval_mask), ok, batch, n_part, ne, nc, d, rp,
                    plan(n_part, ne, nc, sm_count(dev), _PLAN_PARTS.get()),
                    None if cap is None else vector(cap))


def facility_gain(eval_feats: torch.Tensor, cand_feats: torch.Tensor,
                  cov: torch.Tensor, eval_mask: torch.Tensor, *,
                  kernel: str = "linear", h: float = 0.75) -> torch.Tensor:
  """Unnormalized facility-location gains float32, (nc,) or (P, nc).

  Tensors on the CPU take the plain version; CUDA tensors launch the
  kernel or raise.
  """
  if eval_feats.is_meta or cand_feats.is_meta:  # the dry run
    from repro_torch.kernels import meta
    return meta.gain_pass(cand_feats, eval_feats, kernel == "rbf", False)[0]
  if not (eval_feats.is_cuda or cand_feats.is_cuda):
    return ref.facility_gain_ref(eval_feats, cand_feats, cov, eval_mask,
                                 kernel=kernel, h=h)
  global launches
  build.check_kernel("facility_gain", kernel)
  build.check_width("facility_gain", kernel, h)
  o = operands("facility_gain", eval_feats, cand_feats, cov, eval_mask)
  dev = eval_feats.device
  part = torch.empty((o.plan.chunks, o.n_part, o.nc), dtype=torch.float32,
                     device=dev)
  gains = torch.empty((o.n_part, o.nc), dtype=torch.float32, device=dev)
  with torch.cuda.device(dev):
    fn = build.entry("sm90_facility_gain")
    err = fn(*o.head(), part.data_ptr(), gains.data_ptr(), *o.dims(),
             o.plan.chunks, int(eval_feats.dtype == torch.bfloat16),
             int(kernel == "rbf"), float(h * h), int(o.ring.streamed),
             build.stream_of(eval_feats))
  build.check(err, "sm90_facility_gain")
  launches += 1
  ring.mode_launches[("facility_gain", o.ring.mode)] += 1
  return gains if o.batch is not None else gains[0]
